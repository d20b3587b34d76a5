"""Quaternion and spatial algebra primitives (port of ``ops/math.py``).

All functions act on the trailing axis and broadcast over leading axes, so
they serve the fleet dimension without wrappers.  Conventions follow the
JAX package: quaternions are (w, x, y, z); motion vectors are
``[angular, linear]``, force vectors ``[torque, force]``; compact inertias
are ``[Ixx, Iyy, Izz, Ixy, Ixz, Iyz, h0, h1, h2, m]``.
"""

from __future__ import annotations

import torch

# mjMINVAL
MINVAL = 1e-15


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Broadcasting cross product over the trailing axis of length 3."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Batched matrix-vector product: (..., m, n) @ (..., n) -> (..., m)."""
  return (a @ x[..., None])[..., 0]


def norm_safe(x: torch.Tensor, dim: int = -1, keepdim: bool = False):
  """L2 norm with the argument floored at MINVAL^2."""
  sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
  return torch.sqrt(torch.clamp(sq, min=MINVAL * MINVAL))


def normalize(x: torch.Tensor) -> torch.Tensor:
  return x / norm_safe(x, keepdim=True)


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
  """Normalizes a quaternion; degenerate inputs become the identity."""
  n = norm_safe(q, keepdim=True)
  unit = torch.zeros_like(q)
  unit[..., 0] = 1.0
  return torch.where(n < MINVAL, unit, q / n)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product."""
  uw, ux, uy, uz = u.unbind(-1)
  vw, vx, vy, vz = v.unbind(-1)
  return torch.stack([
      uw * vw - ux * vx - uy * vy - uz * vz,
      uw * vx + ux * vw + uy * vz - uz * vy,
      uw * vy - ux * vz + uy * vw + uz * vx,
      uw * vz + ux * vy - uy * vx + uz * vw,
  ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
  """Rotates ``vec`` by ``quat``: v + 2w (u x v) + 2 u x (u x v)."""
  w = quat[..., 0:1]
  u = quat[..., 1:4]
  uxv = cross(u, vec)
  return vec + 2.0 * (w * uxv + cross(u, uxv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> rotation matrix (..., 3, 3)."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = torch.stack([
      1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
      2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
      2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
  ], dim=-1)
  return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  half = 0.5 * angle
  return torch.cat([torch.cos(half)[..., None],
                    axis * torch.sin(half)[..., None]], dim=-1)


def _small_angle_eps(dtype) -> float:
  return 1e-8 if dtype == torch.float32 else 1e-16


def quat_exp(vel: torch.Tensor) -> torch.Tensor:
  """Exponential map of a rotation 3-vector, Taylor-guarded at zero."""
  s2 = torch.sum(vel * vel, dim=-1, keepdim=True)
  small = s2 < _small_angle_eps(vel.dtype)
  angle = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
  sinc_h = torch.where(small, 0.5 - s2 / 48.0, torch.sin(angle / 2) / angle)
  cos_h = torch.where(small, 1.0 - s2 / 8.0, torch.cos(angle / 2))
  return torch.cat([cos_h, vel * sinc_h], dim=-1)


def quat_integrate(quat: torch.Tensor, vel: torch.Tensor, dt) -> torch.Tensor:
  """quat * exp(vel * dt), renormalized (``mju_quatIntegrate``)."""
  return normalize_quat(quat_mul(quat, quat_exp(vel * dt)))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Rotation 3-vector of qb^-1 * qa (``mju_subQuat``)."""
  qdif = quat_mul(quat_conj(qb), qa)
  qdif = qdif * torch.where(qdif[..., 0:1] < 0, -1.0, 1.0)
  v = qdif[..., 1:4]
  w = qdif[..., 0]
  s2 = torch.sum(v * v, dim=-1)
  small = s2 < _small_angle_eps(qdif.dtype)
  s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
  k_exact = 2.0 * torch.atan2(s, w) / s
  k_taylor = 2.0 / w - 2.0 * s2 / (3.0 * w**3)
  return v * torch.where(small, k_taylor, k_exact)[..., None]


def motion_cross(vel: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """vel x_m v (``mju_crossMotion``)."""
  w, u = vel[..., :3], vel[..., 3:]
  vw, vu = v[..., :3], v[..., 3:]
  return torch.cat([cross(w, vw), cross(w, vu) + cross(u, vw)], dim=-1)


def force_cross(vel: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """vel x_f f (``mju_crossForce``)."""
  w, u = vel[..., :3], vel[..., 3:]
  ft, fl = f[..., :3], f[..., 3:]
  return torch.cat([cross(w, ft) + cross(u, fl), cross(w, fl)], dim=-1)


def inert_mul(ci: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Compact spatial inertia times motion vector (``mju_mulInertVec``)."""
  w, u = v[..., :3], v[..., 3:]
  h = ci[..., 6:9]
  m = ci[..., 9:10]
  ixx, iyy, izz, ixy, ixz, iyz = ci[..., :6].unbind(-1)
  w0, w1, w2 = w.unbind(-1)
  iw = torch.stack([
      ixx * w0 + ixy * w1 + ixz * w2,
      ixy * w0 + iyy * w1 + iyz * w2,
      ixz * w0 + iyz * w1 + izz * w2,
  ], dim=-1)
  return torch.cat([iw + cross(h, u), m * u - cross(h, w)], dim=-1)


def transform_motion(v: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
  """A motion vector moved to a new origin, old origin + ``offset``
  (``mju_transformSpatial``, flg_force = 0): [w, u - offset x w]."""
  w, u = v[..., :3], v[..., 3:]
  return torch.cat([w, u - cross(offset, w)], dim=-1)


def transform_force(f: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
  """A force vector [torque, force] moved to a new origin, old origin +
  ``offset`` (``mju_transformSpatial``, flg_force = 1): [t - offset x f,
  f]."""
  t, frc = f[..., :3], f[..., 3:]
  return torch.cat([t - cross(offset, frc), frc], dim=-1)


def mat_t_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """matᵀ v for (..., 3, 3) and (..., 3) by products and sums: on the card
  a batched matmul of many 3 x 3 matrices runs as a slow cuBLAS gemv."""
  return (v[..., None] * mat).sum(-2)


def rotate_spatial_t(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Both 3-vector halves of a spatial vector ``v`` (..., 6) expressed in
  the frame ``mat`` (..., 3, 3): [matᵀ v[:3], matᵀ v[3:]]."""
  return mat_t_vec(mat[..., None, :, :], v.unflatten(-1, (2, 3))).flatten(-2)


def local_to_global(parent_pos, parent_quat, pos, quat):
  """Composes a local frame into its parent frame -> (world pos, mat)."""
  wpos = parent_pos + rotate(pos, parent_quat)
  return wpos, quat_to_mat(quat_mul(parent_quat, quat))
