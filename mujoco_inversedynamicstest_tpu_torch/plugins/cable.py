"""Discrete-elastic-rod cable plugin (port of
the JAX package's ``plugins/cable.py``, C's
``mujoco.elasticity.cable``, ``plugin/elasticity/cable.cc``).

Each segment body after the first carries a ball joint; the rod's
curvature there is the rotation vector of ``body_quat ⊗ qpos_quat``.  The
elastic moment is ``-K (ω - ω0) / L`` with the per-axis stiffness
``K = [G J, E Iy, E Iz]`` of the segment's cross-section (computed on the
host), the reference curvature ``ω0`` (zero when ``flat``) and the segment
length ``L`` at qpos0.  Each joint's moment acts on its two bodies; the
torques enter ``qfrc_passive`` through the rotational body Jacobians
(``support.apply_ft`` with zero force): one contraction over the chain.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import math, support
from mujoco_inversedynamicstest_tpu_torch.plugins import registry


def _section_stiffness(f, body: int, G: float, E: float) -> np.ndarray:
  """[G J, E Iy, E Iz] from the body's first geom (cable.cc:178-199)."""
  g = int(f["body_geomadr"][body])
  gt = int(f["geom_type"][g])
  size = np.asarray(f["geom_size"], np.float64)[g]
  if gt in (3, 5):  # CAPSULE, CYLINDER
    J = np.pi * size[0] ** 4 / 2.0
    Iy = Iz = np.pi * size[0] ** 4 / 4.0
  elif gt == 6:  # BOX
    h, w = size[1], size[2]
    a, b = max(h, w), min(h, w)
    J = a * b ** 3 * (16.0 / 3.0 - 3.36 * b / a * (1 - b ** 4 / a ** 4 / 12))
    Iy = (2 * w) ** 3 * 2 * h / 12.0
    Iz = (2 * h) ** 3 * 2 * w / 12.0
  else:
    J = Iy = Iz = 0.0
  return np.array([J * G, Iy * E, Iz * E])


def _quat_sub_np(qa: np.ndarray, qb: np.ndarray) -> np.ndarray:
  """Rotation vector of qb⁻¹ qa (``mju_subQuat``), host float64."""
  w = qb[0] * qa[0] + qb[1:] @ qa[1:]
  v = qb[0] * qa[1:] - qa[0] * qb[1:] - np.cross(qb[1:], qa[1:])
  if w < 0:
    w, v = -w, -v
  s = np.linalg.norm(v)
  if s < 1e-15:
    return 2.0 * v
  return v * (2.0 * np.arctan2(s, w) / s)


class CableInstance(registry.PluginInstance):
  """The chain's static data and the passive-force hook."""

  def __init__(self, f, instance: int, attrs):
    attrs = registry.require(attrs, ("twist", "bend", "flat", "vmax"),
                             "mujoco.elasticity.cable")
    G = float(attrs["twist"] or 0.0)
    E = float(attrs["bend"] or 0.0)
    flat = attrs["flat"].strip().lower() == "true"
    bodies = np.nonzero(np.asarray(f["body_plugin"]) == instance)[0]
    bodies = bodies[bodies > 0]
    if not len(bodies) or np.any(np.diff(bodies) != 1):
      raise NotImplementedError(
          "unsupported by the PyTorch port: cable plugin bodies that are not "
          "contiguous")
    n = len(bodies)
    # the quaternion of each later body's ball joint: qposadr + dofnum - 3
    self.qadr = np.array([
        int(f["jnt_qposadr"][int(f["body_jntadr"][b])])
        + int(f["body_dofnum"][b]) - 3 for b in bodies[1:]], np.int64)
    body_quat = np.asarray(f["body_quat"], np.float64)[bodies]
    qpos0 = np.asarray(f["qpos0"], np.float64)
    omega0 = np.zeros((n, 3))
    if not flat:
      for b in range(1, n):
        a = self.qadr[b - 1]
        omega0[b] = _quat_sub_np(body_quat[b], qpos0[a:a + 4])
    xpos0 = np.asarray(f["body_xpos0"], np.float64)[bodies]
    K = np.stack([_section_stiffness(f, int(b), G, E) for b in bodies])
    L = np.r_[0.0, np.linalg.norm(xpos0[1:] - xpos0[:-1], axis=1)]
    self.n = n
    self.bodies = bodies.astype(np.int64)
    self._body_quat = body_quat[1:]
    self._omega0 = omega0[1:]
    self._K = K[1:]
    self._L = np.maximum(L[1:], 1e-30)

  def passive(self, m, d):
    """qfrc_passive of the rod (the mjPLUGIN_PASSIVE compute)."""
    if self.n < 2:
      return None
    qj = d.qpos[:, m.const(self.qadr[:, None] + np.arange(4))]
    quat = math.quat_mul(m.const(self._body_quat), qj)       # (B, n-1, 4)
    ident = m.const(np.array([1.0, 0.0, 0.0, 0.0])).expand_as(quat)
    omega = math.quat_sub(quat, ident)
    tmp = (-(m.const(self._K) * (omega - m.const(self._omega0)))
           / m.const(self._L)[:, None])
    pull = math.rotate(tmp, math.quat_conj(quat))
    # body b takes its own joint's moment in its frame and minus the next
    # joint's (cable.cc:224-247)
    pad = torch.nn.functional.pad
    lfrc = pad(pull, (0, 0, 1, 0)) + pad(-tmp, (0, 0, 0, 1))  # (B, n, 3)
    b = m.const(self.bodies)
    torque = math.rotate(lfrc, d.xquat[:, b])
    return support.apply_ft(m, d, torch.zeros_like(torque), torque,
                            d.xpos[:, b], self.bodies)


registry.register_plugin("mujoco.elasticity.cable", CableInstance)
