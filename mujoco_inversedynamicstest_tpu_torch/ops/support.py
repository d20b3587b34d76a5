"""Support operations: point Jacobians, their products, qpos integration,
and the state-vector API.

Port of ``mujoco_inversedynamicstest_tpu/ops/support.py``: ``jac`` and
``jac_dot`` (the equality rows), the Jacobian-transpose product of
``jac_all_bodies`` as ``xfrc_accumulate`` and gravity compensation use it,
``apply_ft``, ``integrate_pos``, ``differentiate_pos``, ``full_m``,
``object_velocity``, and ``state_size``/``get_state``/``set_state``
(``mj_stateSize``/``mj_getState``/``mj_setState``) in the installed
mujoco's ``mjtState`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    JointType,
    Model,
    StateFlag,
)
from mujoco_inversedynamicstest_tpu_torch.ops import math


def jac(m: Model, d: Data, point: torch.Tensor, body: np.ndarray):
  """Point Jacobians (``mj_jac``) of K world points, each attached to a
  body: ``point`` (B, K, 3), ``body`` (K,) host ids.  Returns ``(jacp,
  jacr)``, each (B, K, nv, 3): on the dofs that move the body, ``jacp_i =
  cdof_lin_i + cdof_ang_i x (point - subtree_com_root)`` and ``jacr_i =
  cdof_ang_i``; zero elsewhere."""
  mask = m.const(m.tree.body_dof_mask[body])[..., None]    # (K, nv, 1)
  offset = point - d.subtree_com[:, m.const(m.body_rootid[body])]
  ang = d.cdof[:, None, :, :3]
  jacp = d.cdof[:, None, :, 3:] + math.cross(ang, offset[:, :, None])
  return (torch.where(mask, jacp, 0.0),
          torch.where(mask, ang.expand_as(jacp), 0.0))


def _quat_dofs(m: Model) -> np.ndarray:
  """(nv,) the rotational dofs of ball and free joints."""
  jt = m.jnt_type[m.dof_jntid]
  off = np.arange(m.nv) - m.jnt_dofadr[m.dof_jntid]
  return (jt == JointType.BALL) | ((jt == JointType.FREE) & (off >= 3))


def jac_dot(m: Model, d: Data, point: torch.Tensor, body: np.ndarray):
  """Time derivatives of the point Jacobians of ``jac`` for body-fixed
  points (``mj_jacDot``), from a completed velocity stage: each dof's
  ``cdof_dot``, except the rotational dofs of ball and free joints, which
  take ``cvel x_m cdof`` with their body's whole velocity; plus, in the
  translational rows, ``cdof_ang x`` the point's velocity.  Same shapes as
  ``jac``."""
  mask = m.const(m.tree.body_dof_mask[body])[..., None]
  offset = point - d.subtree_com[:, m.const(m.body_rootid[body])]
  cdd = torch.where(m.const(_quat_dofs(m)[:, None]),
                    math.motion_cross(d.cvel[:, m.const(m.dof_bodyid)],
                                      d.cdof), d.cdof_dot)
  ang = cdd[:, None, :, :3]
  cv = d.cvel[:, m.const(body)]
  v_point = cv[..., 3:] + math.cross(cv[..., :3], offset)
  jacp = (cdd[:, None, :, 3:] + math.cross(ang, offset[:, :, None])
          + math.cross(d.cdof[:, None, :, :3], v_point[:, :, None]))
  return (torch.where(mask, jacp, 0.0),
          torch.where(mask, ang.expand_as(jacp), 0.0))


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
  return apply_at_bodies(m, d, points, np.arange(m.nbody), force, torque)


def apply_at_bodies(m: Model, d: Data, points: torch.Tensor,
                    bodies: np.ndarray, force: torch.Tensor,
                    torque: torch.Tensor) -> torch.Tensor:
  """``jac_transpose`` of K points (B, K, 3) on the host ``bodies`` (K,),
  which may repeat: the sum of ``jacpᵀ f + jacrᵀ t`` over the K."""
  off = points - d.subtree_com[:, m.const(m.body_rootid[bodies])]
  u = torch.cat([math.cross(off, force) + torque, force], dim=-1)
  rows = u @ d.cdof.transpose(1, 2)                       # (B, K, nv)
  return torch.sum(torch.where(m.const(m.tree.body_dof_mask[bodies]), rows,
                               0.0), dim=1)


def apply_ft(m: Model, d: Data, force: torch.Tensor, torque: torch.Tensor,
             point: torch.Tensor, body: np.ndarray) -> torch.Tensor:
  """Generalized forces (B, nv) of Cartesian forces and torques at body
  points (``mj_applyFT``): ``force``, ``torque``, ``point`` (B, K, 3),
  ``body`` (K,) host ids; the sum over the K of ``jacpᵀ f + jacrᵀ t``."""
  jacp, jacr = jac(m, d, point, body)
  return (torch.einsum("bkvc,bkc->bv", jacp, force)
          + torch.einsum("bkvc,bkc->bv", jacr, torque))


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


def assemble(m: Model, key: str, pieces) -> torch.Tensor:
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
  return assemble(m, "qpos", pieces)


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
  return assemble(m, "qvel", pieces)


def full_m(m: Model, d: Data) -> torch.Tensor:
  """The dense mass matrix (``mj_fullM``), (B, nv, nv): ``qM`` is dense
  already."""
  del m
  return d.qM


def object_velocity(m: Model, d: Data, body: np.ndarray,
                    point: torch.Tensor) -> torch.Tensor:
  """6D velocities [ang, lin] in world coordinates of points fixed to
  bodies (``mj_objectVelocity`` with ``flg_local = 0``): ``point`` (B, K,
  3), ``body`` (K,) host ids -> (B, K, 6).  (The JAX version takes a
  ``flg_local`` it does not read.)"""
  offset = point - d.subtree_com[:, m.const(m.body_rootid[body])]
  return math.transform_motion(d.cvel[:, m.const(body)], offset)


# ---------------------------------------------------------------------------
# state vector API
# ---------------------------------------------------------------------------

# (flag, Data field, size) in mj_getState's order; HISTORY, USERDATA and
# PLUGIN are empty on every model put_model accepts
_STATE_FIELDS = (
    (StateFlag.TIME, "time", lambda m: 1),
    (StateFlag.QPOS, "qpos", lambda m: m.nq),
    (StateFlag.QVEL, "qvel", lambda m: m.nv),
    (StateFlag.ACT, "act", lambda m: m.na),
    (StateFlag.HISTORY, None, lambda m: 0),
    (StateFlag.WARMSTART, "qacc_warmstart", lambda m: m.nv),
    (StateFlag.CTRL, "ctrl", lambda m: m.nu),
    (StateFlag.QFRC_APPLIED, "qfrc_applied", lambda m: m.nv),
    (StateFlag.XFRC_APPLIED, "xfrc_applied", lambda m: 6 * m.nbody),
    (StateFlag.EQ_ACTIVE, "eq_active", lambda m: m.neq),
    (StateFlag.MOCAP_POS, "mocap_pos", lambda m: 3 * m.nmocap),
    (StateFlag.MOCAP_QUAT, "mocap_quat", lambda m: 4 * m.nmocap),
    (StateFlag.USERDATA, None, lambda m: 0),
    (StateFlag.PLUGIN, None, lambda m: 0),
)


def _check_spec(spec: int) -> None:
  if spec & ~int(StateFlag.INTEGRATION):
    raise ValueError(f"invalid state spec {int(spec)}")


def state_size(m: Model, spec: int) -> int:
  """Size of a state vector of the components ``spec`` (``mj_stateSize``);
  ``spec`` is an ``mjtState`` integer or a ``StateFlag``."""
  _check_spec(spec)
  return sum(size(m) for flag, _, size in _STATE_FIELDS if spec & flag)


def get_state(m: Model, d: Data,
              spec: int = StateFlag.FULLPHYSICS) -> torch.Tensor:
  """The state vectors (B, ``state_size(m, spec)``) of every lane
  (``mj_getState``), in the dtype of ``qpos``; ``eq_active`` as 0 / 1."""
  _check_spec(spec)
  parts = [d.time[:, None].to(d.qpos.dtype) if field == "time"
           else getattr(d, field).reshape(d.batch, -1).to(d.qpos.dtype)
           for flag, field, size in _STATE_FIELDS
           if spec & flag and field and size(m)]
  return torch.cat(parts, dim=-1) if parts else d.qpos[:, :0]


def set_state(m: Model, d: Data, state: torch.Tensor,
              spec: int = StateFlag.FULLPHYSICS) -> Data:
  """Writes state vectors (B, ``state_size(m, spec)``) into the lanes of
  ``d`` (``mj_setState``); each field keeps its dtype, ``eq_active``
  becomes bool again."""
  _check_spec(spec)
  if state.shape != (d.batch, state_size(m, spec)):
    raise ValueError(f"state of shape {tuple(state.shape)}: {d.batch} lanes "
                     f"of spec {int(spec)} need ({d.batch}, "
                     f"{state_size(m, spec)})")
  updates, adr = {}, 0
  for flag, field, size in _STATE_FIELDS:
    n = size(m)
    if not spec & flag or not field or not n:
      continue
    chunk = state[:, adr:adr + n]
    adr += n
    cur = getattr(d, field)
    if field == "time":
      updates[field] = chunk[:, 0].to(cur.dtype)
    elif field == "eq_active":
      updates[field] = chunk > 0.5
    else:
      updates[field] = chunk.reshape(cur.shape).to(cur.dtype)
  return d.replace(**updates)
