"""Support operations: Jacobian-transpose products and qpos integration.

Port of the parts of ``mujoco_inversedynamicstest_tpu/ops/support.py`` the
slice reaches (``jac``/``jac_all_bodies`` as used by ``xfrc_accumulate`` and
gravity compensation, ``integrate_pos`` and ``differentiate_pos``).
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


def joint_groups(m: Model) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Ids of the hinge-or-slide, ball and free joints."""

  def groups():
    jt = m.jnt_type
    return (np.nonzero((jt == JointType.HINGE) | (jt == JointType.SLIDE))[0],
            np.nonzero(jt == JointType.BALL)[0],
            np.nonzero(jt == JointType.FREE)[0])

  return m.memo("joint_groups", groups)


def _assemble(m: Model, key: str, pieces) -> torch.Tensor:
  """Builds a (..., n) tensor out of place from ``pieces``, pairs of a host
  index array and the values (..., len) or (..., rows, cols) that go there;
  together the index arrays cover 0..n-1 once.  Out of place, so that
  ``torch.func`` transforms can batch it."""
  inv = m.memo(("assemble", key), lambda: m.const(np.argsort(
      np.concatenate([idx.ravel() for idx, _ in pieces]))))
  vals = [v.flatten(-2) if idx.ndim == 2 else v for idx, v in pieces]
  lead = torch.broadcast_shapes(*(v.shape[:-1] for v in vals))
  return torch.cat([v.expand(lead + v.shape[-1:]) for v in vals],
                   dim=-1)[..., inv]


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt: float) -> torch.Tensor:
  """Integrates qpos by qvel * dt, quaternion-aware (``mj_integratePos``).

  Any leading dimensions; written out of place.
  """
  if not m.njnt:
    return qpos
  scalar, ball, free = joint_groups(m)
  qposadr, dofadr = m.jnt_qposadr, m.jnt_dofadr
  pieces = []
  if scalar.size:
    padr = qposadr[scalar]
    pieces.append((padr, qpos[..., m.const(padr)]
                   + dt * qvel[..., m.const(dofadr[scalar])]))
  for jids, off in ((ball, 0), (free, 3)):
    if not jids.size:
      continue
    pidx = qposadr[jids][:, None] + off + np.arange(4)[None]
    vidx = dofadr[jids][:, None] + off + np.arange(3)[None]
    pieces.append((pidx, math.quat_integrate(
        qpos[..., m.const(pidx)], qvel[..., m.const(vidx)], dt)))
  if free.size:
    pidx = qposadr[free][:, None] + np.arange(3)[None]
    vidx = dofadr[free][:, None] + np.arange(3)[None]
    pieces.append((pidx, qpos[..., m.const(pidx)]
                   + dt * qvel[..., m.const(vidx)]))
  return _assemble(m, "qpos", pieces)


def differentiate_pos(m: Model, qpos1: torch.Tensor, qpos2: torch.Tensor,
                      dt: float) -> torch.Tensor:
  """Finite-differences two qpos into a velocity, (qpos2 - qpos1) / dt
  (``mj_differentiatePos``); quaternion segments use the local-frame log
  map.  (..., nq) -> (..., nv), broadcasting the leading dimensions;
  written out of place, so that ``torch.func.vmap``/``hessian`` can run it
  (the iLQR cost's quadratization does).
  """
  if not m.njnt:
    return (qpos2 - qpos1)[..., :0]
  scalar, ball, free = joint_groups(m)
  qposadr, dofadr = m.jnt_qposadr, m.jnt_dofadr
  pieces = []
  if scalar.size:
    padr = m.const(qposadr[scalar])
    pieces.append((dofadr[scalar], (qpos2[..., padr] - qpos1[..., padr]) / dt))
  for jids, off in ((ball, 0), (free, 3)):
    if not jids.size:
      continue
    pidx = m.const(qposadr[jids][:, None] + off + np.arange(4)[None])
    vidx = dofadr[jids][:, None] + off + np.arange(3)[None]
    pieces.append((vidx, math.quat_sub(qpos2[..., pidx], qpos1[..., pidx])
                   / dt))
  if free.size:
    pidx = m.const(qposadr[free][:, None] + np.arange(3)[None])
    vidx = dofadr[free][:, None] + np.arange(3)[None]
    pieces.append((vidx, (qpos2[..., pidx] - qpos1[..., pidx]) / dt))
  return _assemble(m, "qvel", pieces)
