"""Forward dynamics pipeline and the integrators.

Port of ``mujoco_inversedynamicstest_tpu/ops/forward.py`` (``mj_fwdPosition``,
``mj_fwdVelocity``, ``mj_fwdActuation``, ``mj_fwdAcceleration``,
``mj_forward``, ``mj_Euler``, ``mj_RungeKutta``, ``mj_implicit``,
``mjd_smooth_vel``, ``mj_step``) for a fleet, with the sensor stages of
``ops/sensor.py``: every ``Data`` tensor carries the leading fleet
dimension.  The port has no activations (``put_model`` refuses ``na > 0``)
and no in-step control callback.
"""

from __future__ import annotations

import torch
from torch import func

from mujoco_inversedynamicstest_tpu_torch.models.io import mocap_bodies
from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    IntegratorType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import linalg, math, passive
from mujoco_inversedynamicstest_tpu_torch.ops import sensor, smooth, solver
from mujoco_inversedynamicstest_tpu_torch.ops import support

# mjMAXVAL: state-validity bound
_MAXVAL = 1e10


def fwd_position(m: Model, d: Data) -> Data:
  """Position-dependent stage (``mj_fwdPosition``); the same stages make
  up ``mj_invPosition``."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.crb(m, d)
  d = smooth.factor_m(m, d)
  d = collision.collision(m, d)
  d = constraint.make_constraint(m, d)
  return smooth.transmission(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  """Velocity-dependent stage (``mj_fwdVelocity``)."""
  if m.nu:
    d = d.replace(actuator_velocity=math.matvec(d.actuator_moment, d.qvel))
  d = smooth.com_vel(m, d)
  d = passive.passive(m, d)
  d = constraint.reference_constraint(m, d)
  return d.replace(qfrc_bias=smooth.rne(m, d, flg_acc=False))


def fwd_actuation(m: Model, d: Data) -> Data:
  """Actuator forces (``mj_fwdActuation``) for the actuators ``put_model``
  accepts: no activation dynamics, FIXED gain, no bias."""
  zero = d.qvel.new_zeros((d.batch, m.nv))
  if not m.nu or m.opt.disableflags & DisableBit.ACTUATION:
    return d.replace(qfrc_actuator=zero,
                     actuator_force=d.qvel.new_zeros((d.batch, m.nu)))
  ctrl = d.ctrl
  if not m.opt.disableflags & DisableBit.CLAMPCTRL:
    rng = m.actuator_ctrlrange
    ctrl = torch.where(m.const(m.actuator_ctrllimited.astype(bool)),
                       torch.minimum(torch.maximum(ctrl, rng[:, 0]), rng[:, 1]),
                       ctrl)
  # a lane with any non-finite control zeroes all its controls
  bad = ~torch.all(torch.isfinite(ctrl), dim=-1, keepdim=True)
  ctrl = torch.where(bad, 0.0, ctrl)
  force = m.actuator_gainprm[:, 0] * ctrl
  rng = m.actuator_forcerange
  force = torch.where(m.const(m.actuator_forcelimited.astype(bool)),
                      torch.minimum(torch.maximum(force, rng[:, 0]), rng[:, 1]),
                      force)
  return d.replace(
      qfrc_actuator=math.matvec(d.actuator_moment.transpose(1, 2), force),
      actuator_force=force)


def fwd_acceleration(m: Model, d: Data) -> Data:
  """Smooth acceleration (``mj_fwdAcceleration``)."""
  qfrc = (d.qfrc_passive - d.qfrc_bias + d.qfrc_applied + d.qfrc_actuator
          + support.xfrc_accumulate(m, d))
  return d.replace(qfrc_smooth=qfrc, qacc_smooth=smooth.solve_m(m, d, qfrc))


def forward(m: Model, d: Data, skip_sensor: bool = False) -> Data:
  """Full forward dynamics (``mj_forward``), with each sensor stage after
  the stage it reads unless ``skip_sensor`` (``mj_forwardSkip``'s
  skipsensor)."""
  d = fwd_position(m, d)
  if not skip_sensor:
    d = sensor.sensor_pos(m, d)
  d = fwd_velocity(m, d)
  if not skip_sensor:
    d = sensor.sensor_vel(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  d = solver.fwd_constraint(m, d)
  if not skip_sensor:
    d = sensor.sensor_acc(m, d)
  return d


def _advance(m: Model, d: Data, qacc: torch.Tensor,
             qvel_for_pos: torch.Tensor | None = None) -> Data:
  """State advance (``mj_advance``): qvel += h qacc, then qpos by the new
  qvel, or by ``qvel_for_pos`` where given (RK4's weighted velocity)."""
  h = m.opt.timestep
  qvel = d.qvel + qacc * h
  qpos = support.integrate_pos(
      m, d.qpos, qvel if qvel_for_pos is None else qvel_for_pos, h)
  return d.replace(qvel=qvel, qpos=qpos, time=d.time + h)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (``mj_Euler``):
  solves (M + h diag(damping)) qacc = qfrc_smooth + qfrc_constraint."""
  qacc = d.qacc
  if m.has_dof_damping and not m.opt.disableflags & DisableBit.EULERDAMP:
    mh = d.qM + torch.diag(m.opt.timestep * m.dof_damping)
    qacc = linalg.chol_solve(linalg.chol_factor(mh),
                             d.qfrc_smooth + d.qfrc_constraint)
  return _advance(m, d, qacc)


# the fixed RK4 tableau of mj_RungeKutta: A's rows and B
_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rungekutta4(m: Model, d: Data) -> Data:
  """Explicit RK4 (``mj_RungeKutta(m, d, 4)``) of every lane.

  ``d`` holds a completed forward pass (stage 1).  Stages 2-4 are
  ``forward``s of the fleet without sensors (C's ``mj_forwardSkip(...,
  skipsensor=1)``), so sensordata, cacc and cfrc_* stay stage 1's; each
  solve starts from
  ``d.qacc_warmstart``: C's stage forwards all start from the warm start
  the step began with, since its ``mj_forward`` does not write one (``step``
  hands that one over).  The result holds the last stage's forward fields,
  as C leaves mjData: its qacc, qacc_warmstart (= that qacc), solver
  counts, contacts and constraint forces, with qpos, qvel and time
  advanced by the tableau's weights.  (The JAX package keeps the first
  stage's fields, and warm-starts the stages from its qacc.)
  """
  h = m.opt.timestep
  qpos0, qvel0, warm = d.qpos, d.qvel, d.qacc_warmstart
  vels, accs = [qvel0], [d.qacc]
  for a in _RK4_A:
    dqvel = sum(w * v for w, v in zip(a, vels))
    dqacc = sum(w * v for w, v in zip(a, accs))
    qvel = qvel0 + dqacc * h
    d = forward(m, d.replace(qpos=support.integrate_pos(m, qpos0, dqvel, h),
                             qvel=qvel, qacc_warmstart=warm),
                skip_sensor=True)
    vels.append(qvel)
    accs.append(d.qacc)
  dqvel = sum(w * v for w, v in zip(_RK4_B, vels))
  dqacc = sum(w * v for w, v in zip(_RK4_B, accs))
  return _advance(m, d.replace(qpos=qpos0, qvel=qvel0), dqacc,
                  qvel_for_pos=dqvel)


def smooth_vel_deriv(m: Model, d: Data, flg_bias: bool = True,
                     flg_actuation: bool = True) -> torch.Tensor:
  """qDeriv = d(qfrc_passive - qfrc_bias + qfrc_actuator)/dqvel, (B, nv,
  nv): one Jacobian a lane (``mjd_smooth_vel``).

  ``torch.func.vmap`` over ``torch.func.jvp`` of ``fwd_velocity`` (and
  ``fwd_actuation``) of the B lanes, the nv unit tangents the vmapped
  dimension: the JAX package's ``jax.jacfwd``.  ``flg_bias=False`` drops
  the RNE (Coriolis) term, IMPLICITFAST's approximation.  ``d`` must hold a
  completed position stage.
  """

  def f(qvel):
    dd = fwd_velocity(m, d.replace(qvel=qvel))
    out = dd.qfrc_passive
    if flg_bias:
      out = out - dd.qfrc_bias
    if flg_actuation:
      out = out + fwd_actuation(m, dd).qfrc_actuator
    return out

  eye = torch.eye(m.nv, dtype=d.qvel.dtype, device=d.qvel.device)
  cols = func.vmap(lambda e: func.jvp(f, (d.qvel,), (e,))[1])(
      eye[:, None, :].expand(m.nv, d.batch, m.nv))
  return cols.permute(1, 2, 0)


def implicit(m: Model, d: Data) -> Data:
  """Implicit-in-velocity integrators (``mj_implicit``): solves (M -
  h qDeriv) qacc = qfrc_smooth + qfrc_constraint.  IMPLICIT takes the full
  qDeriv and a dense LU solve (``torch.linalg.solve``, the JAX package's
  ``jnp.linalg.solve``); IMPLICITFAST drops the Coriolis term and
  symmetrizes, so the Cholesky kernels factor and solve it."""
  full = m.opt.integrator == IntegratorType.IMPLICIT
  qderiv = smooth_vel_deriv(m, d, flg_bias=full)
  mh = d.qM - m.opt.timestep * qderiv
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  if full:
    qacc = torch.linalg.solve(mh, qfrc)
  else:
    mh = 0.5 * (mh + mh.transpose(1, 2))
    qacc = linalg.chol_solve(linalg.chol_factor(mh), qfrc)
  return _advance(m, d, qacc)


def _check_reset(m: Model, d: Data) -> Data:
  """Per-lane reset of diverged states (``mj_checkPos``/``mj_checkVel``):
  a lane with a non-finite or huge qpos/qvel returns to qpos0 with zero
  velocity, controls and applied forces, eq_active0 and the mocap bodies'
  model poses (``mj_resetData``); the other lanes are untouched."""
  if m.opt.disableflags & DisableBit.AUTORESET:
    return d
  bad_pos = ~torch.all(torch.isfinite(d.qpos), dim=-1) | torch.any(
      torch.abs(d.qpos) > _MAXVAL, dim=-1)
  bad_vel = ~torch.all(torch.isfinite(d.qvel), dim=-1) | torch.any(
      torch.abs(d.qvel) > _MAXVAL, dim=-1)
  bad = bad_pos | bad_vel

  def rst(x, v):
    return torch.where(bad.reshape((-1,) + (1,) * (x.ndim - 1)), v, x)

  reset = {}
  if m.neq:
    reset["eq_active"] = rst(d.eq_active, m.const(m.eq_active0 != 0))
  if m.nmocap:
    mocap = m.const(mocap_bodies(m))
    reset["mocap_pos"] = rst(d.mocap_pos, m.body_pos[mocap])
    reset["mocap_quat"] = rst(d.mocap_quat, m.body_quat[mocap])
  return d.replace(
      qpos=rst(d.qpos, m.qpos0),
      qvel=rst(d.qvel, 0.0),
      ctrl=rst(d.ctrl, 0.0),
      qacc_warmstart=rst(d.qacc_warmstart, 0.0),
      qfrc_applied=rst(d.qfrc_applied, 0.0),
      xfrc_applied=rst(d.xfrc_applied, 0.0),
      warning=d.warning + torch.stack([bad_pos, bad_vel], -1).to(
          d.warning.dtype),
      **reset,
  )


def step(m: Model, d: Data) -> Data:
  """One simulation step of every lane (``mj_step``), by the model's
  integrator."""
  d = _check_reset(m, d)
  warm = d.qacc_warmstart
  d = forward(m, d)
  integrator = IntegratorType(m.opt.integrator)
  if integrator == IntegratorType.EULER:
    return euler(m, d)
  if integrator == IntegratorType.RK4:
    return rungekutta4(m, d.replace(qacc_warmstart=warm))
  return implicit(m, d)


def step_n(m: Model, d: Data, n: int) -> Data:
  """``n`` steps of every lane: what ``n`` calls of ``step`` return."""
  for _ in range(n):
    d = step(m, d)
  return d
