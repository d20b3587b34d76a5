"""PID actuator plugin (port of the JAX package's ``plugins/
pid.py``, C's ``mujoco.pid``, ``plugin/actuator/pid.cc``).

For each of the instance's actuators, ``error = ctrl - actuator_length`` and
``force = kp error - kd actuator_velocity + ki integral``.  The integral
lives in an activation slot, advanced by the step's own integration of
``act`` through ``act_dot = (clip(integral + error h, ±imax) - act) / h``;
``imax`` in MJCF is a force, the integral's clamp ``imax / ki``.  With
``slewmax`` the setpoint is rate-limited against a second slot holding the
previous ctrl, in each lane whose time is past 0.

Only ``dyntype="none"`` plugin actuators, as in the JAX package; others are
refused by name.  The slots are written out of place (``support.assemble``),
so that ``torch.func`` transforms batch them.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.plugins import registry


def put_columns(m, key: str, x: torch.Tensor, idx: np.ndarray,
                vals: torch.Tensor) -> torch.Tensor:
  """``x`` (B, n) with its columns ``idx`` (host) replaced by ``vals``,
  out of place."""
  rest = np.setdiff1d(np.arange(x.shape[-1]), idx)
  return support.assemble(m, key, [(rest, x[:, m.const(rest)]), (idx, vals)])


class PidInstance(registry.PluginInstance):

  def __init__(self, f, instance: int, attrs):
    attrs = registry.require(attrs, ("kp", "ki", "kd", "imax", "slewmax"),
                             "mujoco.pid")
    self.kp = float(attrs["kp"] or 0.0)
    self.ki = float(attrs["ki"] or 0.0)
    self.kd = float(attrs["kd"] or 0.0)
    imax_force = attrs["imax"]
    self.imax = (float(imax_force) / self.ki
                 if (imax_force and self.ki) else None)
    self.slewmax = float(attrs["slewmax"]) if attrs["slewmax"] else None
    if self.slewmax is not None and self.slewmax < 0:
      raise NotImplementedError(
          "unsupported by the PyTorch port: pid plugin slewmax < 0")
    plugin = np.asarray(f["actuator_plugin"])
    acts = np.nonzero(plugin == instance)[0] if int(f["nu"]) else []
    if not len(acts):
      raise NotImplementedError(
          f"unsupported by the PyTorch port: pid plugin instance {instance} "
          "drives no actuator")
    expected = (1 if self.ki else 0) + (1 if self.slewmax is not None else 0)
    for i in acts:
      if int(f["actuator_dyntype"][i]) != 0:
        raise NotImplementedError(
            "unsupported by the PyTorch port: pid plugin with dyntype other "
            "than none (a filtered setpoint)")
      if int(f["actuator_actnum"][i]) != expected:
        raise NotImplementedError(
            f"unsupported by the PyTorch port: pid actuator {i} with actdim "
            f"{int(f['actuator_actnum'][i])}, not {expected}")
    self.acts = np.asarray(acts, np.int64)
    self.actadr = np.asarray(f["actuator_actadr"])[self.acts].astype(np.int64)
    self.slew_adr = self.actadr + (1 if self.ki else 0)

  def _ctrl(self, m, d, ctrl):
    """The clamped, slew-limited setpoint of each actuator (C's GetCtrl)."""
    c = ctrl[:, m.const(self.acts)]
    if self.slewmax is not None:
      prev = d.act[:, m.const(self.slew_adr)]
      h = m.opt.timestep
      lo, hi = prev - self.slewmax * h, prev + self.slewmax * h
      c = torch.where((d.time > 0)[:, None],
                      torch.minimum(torch.maximum(c, lo), hi), c)
    return c

  def _integral(self, m, d, err):
    intg = d.act[:, m.const(self.actadr)] + err * m.opt.timestep
    if self.imax is not None:
      intg = torch.clamp(intg, -self.imax, self.imax)
    return intg

  def act_dot(self, m, d, ctrl, act_dot):
    if not (self.ki or self.slewmax is not None):
      return None
    c = self._ctrl(m, d, ctrl)
    h = m.opt.timestep
    idx, vals = [], []
    if self.ki:
      err = c - d.actuator_length[:, m.const(self.acts)]
      idx.append(self.actadr)
      vals.append((self._integral(m, d, err)
                   - d.act[:, m.const(self.actadr)]) / h)
    if self.slewmax is not None:
      idx.append(self.slew_adr)
      vals.append((c - d.act[:, m.const(self.slew_adr)]) / h)
    return put_columns(m, ("pid_act_dot", self.acts.tobytes()), act_dot,
                       np.concatenate(idx), torch.cat(vals, dim=1))

  def actuator_force(self, m, d, ctrl, force):
    ai = m.const(self.acts)
    c = self._ctrl(m, d, ctrl)
    err = c - d.actuator_length[:, ai]
    frc = self.kp * err - self.kd * d.actuator_velocity[:, ai]
    if self.ki:
      frc = frc + self.ki * self._integral(m, d, err)
    return put_columns(m, ("pid_force", self.acts.tobytes()), force,
                       self.acts, frc)


registry.register_plugin("mujoco.pid", PidInstance)
