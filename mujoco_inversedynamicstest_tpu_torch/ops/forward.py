"""Forward dynamics pipeline and the Euler integrator.

Port of ``mujoco_inversedynamicstest_tpu/ops/forward.py`` (``mj_fwdPosition``,
``mj_fwdVelocity``, ``mj_fwdActuation``, ``mj_fwdAcceleration``,
``mj_forward``, ``mj_Euler``, ``mj_step``) for a fleet: every ``Data``
tensor carries the leading fleet dimension.
"""

from __future__ import annotations

import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import linalg, math, passive
from mujoco_inversedynamicstest_tpu_torch.ops import smooth, solver, support

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


def forward(m: Model, d: Data) -> Data:
  """Full forward dynamics (``mj_forward``, without sensors)."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  return solver.fwd_constraint(m, d)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (``mj_Euler``):
  solves (M + h diag(damping)) qacc = qfrc_smooth + qfrc_constraint."""
  qacc = d.qacc
  if m.has_dof_damping and not m.opt.disableflags & DisableBit.EULERDAMP:
    mh = d.qM + torch.diag(m.opt.timestep * m.dof_damping)
    qacc = linalg.chol_solve(linalg.chol_factor(mh),
                             d.qfrc_smooth + d.qfrc_constraint)
  h = m.opt.timestep
  qvel = d.qvel + qacc * h
  return d.replace(qvel=qvel, qpos=support.integrate_pos(m, d.qpos, qvel, h),
                   time=d.time + h)


def _check_reset(m: Model, d: Data) -> Data:
  """Per-lane reset of diverged states (``mj_checkPos``/``mj_checkVel``):
  a lane with a non-finite or huge qpos/qvel returns to qpos0 with zero
  velocity, controls and applied forces; the other lanes are untouched."""
  if m.opt.disableflags & DisableBit.AUTORESET:
    return d
  bad_pos = ~torch.all(torch.isfinite(d.qpos), dim=-1) | torch.any(
      torch.abs(d.qpos) > _MAXVAL, dim=-1)
  bad_vel = ~torch.all(torch.isfinite(d.qvel), dim=-1) | torch.any(
      torch.abs(d.qvel) > _MAXVAL, dim=-1)
  bad = bad_pos | bad_vel

  def rst(x, v):
    return torch.where(bad.reshape((-1,) + (1,) * (x.ndim - 1)), v, x)

  return d.replace(
      qpos=rst(d.qpos, m.qpos0),
      qvel=rst(d.qvel, 0.0),
      ctrl=rst(d.ctrl, 0.0),
      qacc_warmstart=rst(d.qacc_warmstart, 0.0),
      qfrc_applied=rst(d.qfrc_applied, 0.0),
      xfrc_applied=rst(d.xfrc_applied, 0.0),
      warning=d.warning + torch.stack([bad_pos, bad_vel], -1).to(
          d.warning.dtype),
  )


def step(m: Model, d: Data) -> Data:
  """One simulation step of every lane (``mj_step``, Euler)."""
  d = _check_reset(m, d)
  return euler(m, forward(m, d))
