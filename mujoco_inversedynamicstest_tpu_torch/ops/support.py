"""Support operations: Jacobian-transpose products and qpos integration.

Port of the parts of ``mujoco_inversedynamicstest_tpu/ops/support.py`` the
slice reaches (``jac``/``jac_all_bodies`` as used by ``xfrc_accumulate`` and
gravity compensation, and ``integrate_pos``).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    JointType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import math


def jac_transpose(m: Model, d: Data, points: torch.Tensor,
                  force: torch.Tensor, torque: torch.Tensor) -> torch.Tensor:
  """Sum over bodies of ``jacp(point_b)ᵀ f_b + jacr(point_b)ᵀ t_b``.

  ``points``, ``force``, ``torque``: (B, nbody, 3), one point per body.
  The point Jacobian of ``mj_jac`` (JAX ``support.jac``) for dof i is
  ``[cdof_ang_i x (p - com_root) + cdof_lin_i ; cdof_ang_i]`` on the dofs
  that move the body, so the product contracts each dof's ``cdof`` with the
  6-vector ``[(p - com_root) x f + t ; f]`` without forming the (nbody, nv,
  3) Jacobians.
  """
  off = points - d.subtree_com[:, m.const(m.body_rootid)]
  u = torch.cat([math.cross(off, force) + torque, force], dim=-1)
  rows = u @ d.cdof.transpose(1, 2)                       # (B, nbody, nv)
  return torch.sum(torch.where(m.const(m.tree.body_dof_mask), rows, 0.0),
                   dim=1)


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Joint-space projection of all ``xfrc_applied`` body wrenches
  (``mj_xfrcAccumulate``), applied at each body's CoM."""
  return jac_transpose(m, d, d.xipos, d.xfrc_applied[..., :3],
                       d.xfrc_applied[..., 3:])


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt: float) -> torch.Tensor:
  """Integrates qpos by qvel * dt, quaternion-aware (``mj_integratePos``)."""
  jt = m.jnt_type
  qpos = qpos.clone()
  scalar = np.nonzero((jt == JointType.HINGE) | (jt == JointType.SLIDE))[0]
  ball = np.nonzero(jt == JointType.BALL)[0]
  free = np.nonzero(jt == JointType.FREE)[0]
  if scalar.size:
    padr = m.const(m.jnt_qposadr[scalar])
    qpos[:, padr] = qpos[:, padr] + dt * qvel[:, m.const(m.jnt_dofadr[scalar])]
  for jids, off in ((ball, 0), (free, 3)):
    if not jids.size:
      continue
    pidx = m.const(m.jnt_qposadr[jids][:, None] + off + np.arange(4)[None])
    vidx = m.const(m.jnt_dofadr[jids][:, None] + off + np.arange(3)[None])
    qpos[:, pidx] = math.quat_integrate(qpos[:, pidx], qvel[:, vidx], dt)
  if free.size:
    pidx = m.const(m.jnt_qposadr[free][:, None] + np.arange(3)[None])
    vidx = m.const(m.jnt_dofadr[free][:, None] + np.arange(3)[None])
    qpos[:, pidx] = qpos[:, pidx] + dt * qvel[:, vidx]
  return qpos
