"""Passive forces: joint and tendon springs, dof and tendon dampers,
gravity compensation.

Port of ``mujoco_inversedynamicstest_tpu/ops/passive.py`` without the fluid
and flex terms (``put_model`` refuses models that need them).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    JointType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import math, support


def _spring(m: Model, d: Data) -> torch.Tensor:
  """Joint springs toward ``qpos_spring``."""
  qfrc = d.qpos.new_zeros((d.batch, m.nv))
  jt = m.jnt_type
  scalar = np.nonzero((jt == JointType.HINGE) | (jt == JointType.SLIDE))[0]
  free = np.nonzero(jt == JointType.FREE)[0]
  ball = np.nonzero(jt == JointType.BALL)[0]
  if scalar.size:
    padr = m.const(m.jnt_qposadr[scalar])
    k = m.jnt_stiffness[m.const(scalar)]
    qfrc.index_add_(1, m.const(m.jnt_dofadr[scalar]),
                    -k * (d.qpos[:, padr] - m.qpos_spring[padr]))
  if free.size:
    pidx = m.const(m.jnt_qposadr[free][:, None] + np.arange(3)[None])
    vidx = m.const((m.jnt_dofadr[free][:, None] + np.arange(3)[None]).ravel())
    k = m.jnt_stiffness[m.const(free)][:, None]
    qfrc.index_add_(1, vidx, (-k * (d.qpos[:, pidx] - m.qpos_spring[pidx])
                              ).reshape(d.batch, -1))
  for jids, off in ((ball, 0), (free, 3)):
    if not jids.size:
      continue
    pidx = m.const(m.jnt_qposadr[jids][:, None] + off + np.arange(4)[None])
    vidx = m.const((m.jnt_dofadr[jids][:, None] + off
                    + np.arange(3)[None]).ravel())
    k = m.jnt_stiffness[m.const(jids)][:, None]
    dif = math.quat_sub(math.normalize_quat(d.qpos[:, pidx]),
                        m.qpos_spring[pidx])
    qfrc.index_add_(1, vidx, (-k * dif).reshape(d.batch, -1))
  return qfrc


def gravcomp(m: Model, d: Data) -> torch.Tensor:
  """Gravity compensation ``-gravity * mass * body_gravcomp`` applied at
  each body's CoM (``mj_gravcomp``)."""
  force = -m.opt.gravity * (m.body_mass * m.body_gravcomp)[:, None]
  force = force.expand(d.batch, m.nbody, 3)
  return support.jac_transpose(m, d, d.xipos, force, torch.zeros_like(force))


def _tendon_forces(m: Model, d: Data):
  """Tendon spring (toward the ``lengthspring`` deadband [lower, upper],
  zero inside it) and damper forces along each tendon, (B, ntendon)."""
  length = d.ten_length
  lower, upper = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
  spring = m.tendon_stiffness * torch.where(
      length > upper, upper - length,
      torch.where(length < lower, lower - length, 0.0))
  return spring, -m.tendon_damping * d.ten_velocity


def passive(m: Model, d: Data) -> Data:
  """All passive forces (``mj_passive``).  Gravity compensation of the
  dofs of ``jnt_actgravcomp`` joints goes to qfrc_actuator instead
  (``fwd_actuation``), as C routes it."""
  flags = m.opt.disableflags
  zero = d.qpos.new_zeros((d.batch, m.nv))
  qfrc_spring = zero if flags & DisableBit.SPRING else _spring(m, d)
  qfrc_damper = zero if flags & DisableBit.DAMPER else -m.dof_damping * d.qvel
  if m.ntendon:
    spring, damper = _tendon_forces(m, d)
    jt = d.ten_J.transpose(1, 2)
    if not flags & DisableBit.SPRING:
      qfrc_spring = qfrc_spring + math.matvec(jt, spring)
    if not flags & DisableBit.DAMPER:
      qfrc_damper = qfrc_damper + math.matvec(jt, damper)
  qfrc_gravcomp = zero
  to_passive = zero
  if m.has_gravcomp and not flags & DisableBit.GRAVITY:
    qfrc_gravcomp = gravcomp(m, d)
    to_passive = qfrc_gravcomp
    actgrav = m.jnt_actgravcomp[m.dof_jntid] != 0
    if actgrav.any():
      to_passive = torch.where(m.const(actgrav), 0.0, qfrc_gravcomp)
  return d.replace(
      qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
      qfrc_gravcomp=qfrc_gravcomp,
      qfrc_passive=qfrc_spring + qfrc_damper + to_passive)
