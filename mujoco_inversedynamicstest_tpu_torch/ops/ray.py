"""Ray tests against primitive geom shapes, batched.

Port of the primitive part of ``mujoco_inversedynamicstest_tpu/ops/ray.py``
(``mju_rayGeom`` and the six shapes it dispatches to): every argument
broadcasts over leading dimensions, so one call tests every (lane, site,
contact) ray against shapes of one type.  "No hit" is +inf (C returns -1).
Scene casting (``mj_ray``), meshes, height fields, flex and skin are not
ported.
"""

from __future__ import annotations

import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType
from mujoco_inversedynamicstest_tpu_torch.ops.math import MINVAL, mat_t_vec

_INF = float("inf")


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _ray_map(pos, mat, pnt, vec):
  """The ray in the shape's local frame: (matᵀ (pnt - pos), matᵀ vec)."""
  return mat_t_vec(mat, pnt - pos), mat_t_vec(mat, vec)


def _ray_quad(a, b, c):
  """Roots of a x² + 2 b x + c = 0 (``ray_quad``): the smallest
  non-negative one, and both, each +inf where the determinant is below
  MINVAL (the smallest one also where neither is non-negative)."""
  det = b * b - a * c
  ok = det >= MINVAL
  sdet = torch.sqrt(torch.clamp(det, min=0.0))
  sa = torch.where(torch.abs(a) < MINVAL, 1.0, a)
  x0 = torch.where(ok, (-b - sdet) / sa, _INF)
  x1 = torch.where(ok, (-b + sdet) / sa, _INF)
  x = torch.where(x0 >= 0, x0, torch.where(x1 >= 0, x1, _INF))
  return x, x0, x1


def _ray_plane(pos, mat, size, pnt, vec):
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
  facing = lvec[..., 2] <= -MINVAL
  x = -lpnt[..., 2] / torch.where(facing, lvec[..., 2], -1.0)
  p0 = lpnt[..., 0] + x * lvec[..., 0]
  p1 = lpnt[..., 1] + x * lvec[..., 1]
  inside = (((size[..., 0] <= 0) | (torch.abs(p0) <= size[..., 0]))
            & ((size[..., 1] <= 0) | (torch.abs(p1) <= size[..., 1])))
  return torch.where(facing & (x >= 0) & inside, x, _INF)


def _ray_sphere_raw(pos, r2, pnt, vec):
  dif = pnt - pos
  return _ray_quad(_dot(vec, vec), _dot(vec, dif), _dot(dif, dif) - r2)[0]


def _ray_sphere(pos, mat, size, pnt, vec):
  return _ray_sphere_raw(pos, size[..., 0] * size[..., 0], pnt, vec)


def _round_side(lpnt, lvec, radius, half):
  """The round side of a cylinder of ``radius`` between z = ±``half``:
  the smallest non-negative root, +inf where it misses the side."""
  a = lvec[..., 0] ** 2 + lvec[..., 1] ** 2
  b = lvec[..., 0] * lpnt[..., 0] + lvec[..., 1] * lpnt[..., 1]
  c = lpnt[..., 0] ** 2 + lpnt[..., 1] ** 2 - radius ** 2
  sol = _ray_quad(a, b, c)[0]
  zed = lpnt[..., 2] + sol * lvec[..., 2]
  return torch.where(torch.isfinite(sol) & (torch.abs(zed) <= half), sol,
                     _INF)


def _ray_capsule(pos, mat, size, pnt, vec):
  r, half = size[..., 0], size[..., 1]
  bound = _ray_sphere_raw(pos, (r + half) ** 2, pnt, vec)
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
  x = _round_side(lpnt, lvec, r, half)
  # both caps at once (last axis: the cap spheres' centres z = c, top and
  # bottom), each root accepted on its own half, beyond z = c
  c = torch.stack([half, -half], dim=-1)
  ldif_z = lpnt[..., 2:3] - c
  b = (lvec[..., 0] * lpnt[..., 0] + lvec[..., 1] * lpnt[..., 1])[..., None]
  cc = (lpnt[..., 0] ** 2 + lpnt[..., 1] ** 2)[..., None]
  _, x0, x1 = _ray_quad(_dot(lvec, lvec)[..., None],
                        b + lvec[..., 2:3] * ldif_z,
                        cc + ldif_z ** 2 - (r ** 2)[..., None])
  cap = torch.cat([x0, x1], dim=-1)                   # (..., 4)
  c = torch.cat([c, c], dim=-1)
  beyond = (lpnt[..., 2:3] + cap * lvec[..., 2:3] - c) * c >= 0
  cap = torch.where(torch.isfinite(cap) & (cap >= 0) & beyond, cap, _INF)
  x = torch.minimum(x, cap.amin(-1))
  return torch.where(torch.isfinite(bound), x, _INF)


def _ray_ellipsoid(pos, mat, size, pnt, vec):
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
  s = 1.0 / (size * size)
  x, _, _ = _ray_quad(_dot(s * lvec, lvec), _dot(s * lvec, lpnt),
                      _dot(s * lpnt, lpnt) - 1.0)
  return x


def _ray_cylinder(pos, mat, size, pnt, vec):
  r, half = size[..., 0], size[..., 1]
  bound = _ray_sphere_raw(pos, r ** 2 + half ** 2, pnt, vec)
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
  x = _round_side(lpnt, lvec, r, half)
  # both flat ends at once (last axis)
  vz = lvec[..., 2:3]
  axial = torch.abs(vz) > MINVAL
  sol = (torch.stack([-half, half], dim=-1) - lpnt[..., 2:3]
         ) / torch.where(axial, vz, 1.0)
  p0 = lpnt[..., 0:1] + sol * lvec[..., 0:1]
  p1 = lpnt[..., 1:2] + sol * lvec[..., 1:2]
  ok = axial & (sol >= 0) & (p0 * p0 + p1 * p1 <= (r ** 2)[..., None])
  x = torch.minimum(x, torch.where(ok, sol, _INF).amin(-1))
  return torch.where(torch.isfinite(bound), x, _INF)


def _ray_box(pos, mat, size, pnt, vec):
  bound = _ray_sphere_raw(pos, _dot(size, size), pnt, vec)
  lpnt, lvec = _ray_map(pos, mat, pnt, vec)
  # all six faces at once: axis i (second-last axis) at -size and +size
  # (last axis); the face's other two axes are i + 1 and i + 2 mod 3, got
  # by rolling (no index tensor: a host index would copy to the card and
  # wait for it)
  along = torch.abs(lvec) > MINVAL
  sol = (torch.stack([-size, size], dim=-1) - lpnt[..., None]
         ) / torch.where(along, lvec, 1.0)[..., None]
  ok = along[..., None] & (sol >= 0)
  for shift in (-1, -2):
    p = lpnt.roll(shift, -1)[..., None] + sol * lvec.roll(shift, -1)[..., None]
    ok = ok & (torch.abs(p) <= size.roll(shift, -1)[..., None])
  x = torch.where(ok, sol, _INF).flatten(-2).amin(-1)
  return torch.where(torch.isfinite(bound), x, _INF)


_RAY_FUNC = {
    GeomType.PLANE: _ray_plane,
    GeomType.SPHERE: _ray_sphere,
    GeomType.CAPSULE: _ray_capsule,
    GeomType.ELLIPSOID: _ray_ellipsoid,
    GeomType.CYLINDER: _ray_cylinder,
    GeomType.BOX: _ray_box,
}


def ray_geom(pos: torch.Tensor, mat: torch.Tensor, size: torch.Tensor,
             pnt: torch.Tensor, vec: torch.Tensor,
             geomtype: int) -> torch.Tensor:
  """Distance along ``vec`` from ``pnt`` to a shape of type ``geomtype``
  at (``pos``, ``mat``) of half-sizes ``size`` (``mju_rayGeom``), +inf
  where the ray misses it.  A ray that starts inside a closed shape hits
  its surface on the way out.  Shapes (..., 3), (..., 3, 3), (..., 3),
  (..., 3), (..., 3), broadcast against each other."""
  return _RAY_FUNC[GeomType(int(geomtype))](pos, mat, size, pnt, vec)
