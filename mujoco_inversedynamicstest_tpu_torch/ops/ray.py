"""Ray casting, batched.

Port of ``mujoco_inversedynamicstest_tpu/ops/ray.py``: ``ray_geom``
(``mju_rayGeom`` and the six shapes it dispatches to), whose arguments
broadcast over leading dimensions, so one call tests every (lane, site,
contact) ray against shapes of one type, "no hit" being +inf; the scene
cast ``ray`` (``mj_ray``) of many rays a lane, one batched test a geom type
(meshes by their whole surface, height fields by ``hfield.ray_hfield``),
"no hit" being -1 as in C; and ``ray_flex`` and ``ray_skin``
(``mju_rayFlex``, ``mju_raySkin``).  Like C's ``mj_ray``, the scene cast
skips flexes.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    GeomType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import math
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


def _ray_triangles(tv: torch.Tensor, pnt: torch.Tensor,
                   vec: torch.Tensor) -> torch.Tensor:
  """Distances (..., T) along ``vec`` from ``pnt`` (..., 3) to triangles
  ``tv`` (..., T, 3, 3), +inf where the ray misses one or runs parallel to
  its plane (Möller-Trumbore; C's ``ray_triangle`` in its barycentric
  form).  Every triangle is tested: the replacement of C's BVH walk."""
  eps = 1e-12
  v0 = tv[..., 0, :]
  e1, e2 = tv[..., 1, :] - v0, tv[..., 2, :] - v0
  lvec = vec[..., None, :]
  h = math.cross(lvec, e2)
  a = _dot(e1, h)
  f = 1.0 / torch.where(torch.abs(a) < eps, 1.0, a)
  s = pnt[..., None, :] - v0
  u = f * _dot(s, h)
  q = math.cross(s, e1)
  v = f * _dot(q, lvec)
  t = f * _dot(e2, q)
  ok = (torch.abs(a) >= eps) & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t >= 0)
  return torch.where(ok, t, _INF)


def _mesh_table(m: Model, gids: np.ndarray) -> tuple:
  """The triangles of the mesh geoms ``gids`` padded to one count, (G,
  T, 3, 3) on the device (a pad triangle is degenerate: never hit)."""
  tris = [m.mesh_tris[int(m.geom_dataid[g])] for g in gids]
  out = np.zeros((len(gids), max(len(t) for t in tris), 3, 3))
  for k, t in enumerate(tris):
    out[k, :len(t)] = t
  return m.const(out)


def _ray_mesh(m: Model, d: Data, gids: np.ndarray, pnt, vec):
  """Distances (B, R, G) of R rays a lane to the mesh geoms ``gids``
  (``mj_rayMesh``): the nearest triangle of each mesh's whole surface,
  where the ray meets the geom's bounding box."""
  if not m.mesh_tris:
    raise NotImplementedError(
        "ray at a MESH geom needs Model.mesh_tris, which put_model builds "
        "when the model has a rangefinder")
  tv = m.memo(("ray_mesh", gids.tobytes()), lambda: _mesh_table(m, gids))
  g = m.const(gids)
  pos, mat = d.geom_xpos[:, None, g], d.geom_xmat[:, None, g]
  size = m.geom_size[g]
  p, v = pnt[:, :, None], vec[:, :, None]
  bound = _ray_box(pos, mat, size, p, v)
  lpnt, lvec = _ray_map(pos, mat, p, v)
  x = _ray_triangles(tv, lpnt, lvec).amin(-1)
  return torch.where(torch.isfinite(bound), x, _INF)


def _candidates(m: Model, geomgroup, flg_static: bool,
                bodyexclude: np.ndarray):
  """The scene cast's host tables: the geoms it tests (C's, visible, in
  ``geomgroup``, and movable unless ``flg_static``) by type, in the order
  of their type and id; which of them each ray may hit (not on its
  ``bodyexclude``); their ids in that order."""
  include = m.geom_visible.copy()
  if not flg_static:
    include &= m.body_weldid[m.geom_bodyid[:m.ngeom_mj]] != 0
  if geomgroup is not None:
    grp = np.clip(m.geom_group, 0, len(geomgroup) - 1)
    include &= np.asarray(geomgroup, bool)[grp]
  cand = np.nonzero(include)[0]
  types = m.geom_type[cand]
  by_type = tuple((int(t), cand[types == t]) for t in np.unique(types))
  ids = np.concatenate([g for _, g in by_type]) if by_type else cand
  allow = m.geom_bodyid[ids][None, :] != bodyexclude[:, None]
  return by_type, m.const(allow), m.const(ids)


def ray(m: Model, d: Data, pnt: torch.Tensor, vec: torch.Tensor,
        geomgroup=None, flg_static: bool = True, bodyexclude=-1):
  """The nearest geom hit by each of R rays a lane (``mj_ray``): ``pnt``,
  ``vec`` (B, R, 3) in the world frame, ``bodyexclude`` one body or (R,)
  host ids, a body each ray does not see (-1: none).  Returns the
  distances (B, R), -1 where a ray hits nothing, and the geoms (B, R), -1
  likewise.  The geoms tested are static: C's geoms (not flexes, nor the
  port's flex vertex spheres) that are visible, in ``geomgroup`` (a host
  mask by group, None: every group), and movable unless ``flg_static``.
  Each geom type is one batched test of every ray against every geom of
  the type; ties go to the geom of the lower type, then the lower id, as
  in the JAX package."""
  bex = np.broadcast_to(np.asarray(bodyexclude, np.int64), pnt.shape[1:2])
  key = ("ray_candidates", None if geomgroup is None
         else np.asarray(geomgroup, bool).tobytes(), bool(flg_static),
         bex.tobytes())
  by_type, allow, ids = m.memo(key, lambda: _candidates(
      m, geomgroup, flg_static, bex))
  bsz, nray = pnt.shape[:2]
  if not by_type:
    return (pnt.new_full((bsz, nray), -1.0),
            torch.full((bsz, nray), -1, dtype=torch.int64,
                       device=pnt.device))
  dists = []
  for t, gids in by_type:
    if t == GeomType.MESH:
      dists.append(_ray_mesh(m, d, gids, pnt, vec))
    elif t == GeomType.HFIELD:
      from mujoco_inversedynamicstest_tpu_torch.ops import hfield

      dists.append(torch.stack([hfield.ray_hfield(m, d, int(g), pnt, vec)
                                for g in gids], dim=-1))
    elif GeomType(t) in _RAY_FUNC:
      g = m.const(gids)
      dists.append(_RAY_FUNC[GeomType(t)](
          d.geom_xpos[:, None, g], d.geom_xmat[:, None, g], m.geom_size[g],
          pnt[:, :, None], vec[:, :, None]))
    else:
      raise NotImplementedError(
          f"unsupported by the PyTorch port: ray at geom type "
          f"{GeomType(t).name}")
  dist = torch.cat(dists, dim=-1) if len(dists) > 1 else dists[0]
  dist = torch.where(allow, dist, _INF)
  best = torch.argmin(dist, dim=-1, keepdim=True)
  x = torch.take_along_dim(dist, best, dim=-1)[..., 0]
  hit = torch.isfinite(x)
  return (torch.where(hit, x, -1.0),
          torch.where(hit, ids[best[..., 0]], -1))


def _mat_z(axis: torch.Tensor) -> torch.Tensor:
  """Rotations (..., 3, 3) whose z column is the unit ``axis`` (...,
  3)."""
  c = (torch.abs(axis[..., 2]) < 0.9).to(axis.dtype)
  up = torch.stack([1.0 - c, torch.zeros_like(c), c], dim=-1)
  x = math.cross(up, axis)
  x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                      min=1e-12)
  return torch.stack([x, math.cross(axis, x), axis], dim=-1)


def _nearest_of(pnt, vec, dist, corners, ids):
  """Each candidate's nearest corner (..., K) to its hit point, by id:
  ``corners`` (..., K, C, 3), ``ids`` (K, C) host or device ints."""
  hit = pnt[..., None, :] + vec[..., None, :] * torch.where(
      torch.isfinite(dist), dist, 0.0)[..., None]
  near = torch.argmin(torch.linalg.vector_norm(
      corners - hit[..., None, :], dim=-1), dim=-1)
  ids = torch.as_tensor(ids, device=dist.device)
  return torch.take_along_dim(ids.expand(near.shape + ids.shape[-1:]),
                              near[..., None], dim=-1)[..., 0]


def _first_hit(dists: list, vids: list):
  best = torch.cat(dists, dim=-1)
  k = torch.argmin(best, dim=-1, keepdim=True)
  x = torch.take_along_dim(best, k, dim=-1)[..., 0]
  vid = torch.take_along_dim(torch.cat(vids, dim=-1), k, dim=-1)[..., 0]
  hit = torch.isfinite(x)
  return torch.where(hit, x, -1.0), torch.where(hit, vid, -1)


def ray_flex(m: Model, d: Data, flexid: int, pnt: torch.Tensor,
             vec: torch.Tensor, flg_vert: bool = False, flg_edge: bool = False,
             flg_face: bool = True, flg_skin: bool = True,
             flex_layer: int = 0):
  """The nearest intersection of one ray a lane (``pnt``, ``vec`` (B, 3))
  with a flex, and the flex's vertex nearest to it, by its id within the
  flex (``mju_rayFlex``): the distances (B,) and vertices (B,), -1 where
  the ray misses.  Faces are flat triangles (a dim-2 flex's elements, or
  the four faces of a dim-3 flex's elements of the outer layer under
  ``flg_skin``, else of ``flex_layer``), edges capsules of the flex's
  radius, vertices spheres of it; edges are tested where drawn or under
  ``flg_skin`` on a dim-2 or dim-3 flex, vertices where drawn and the
  edges are not, faces where drawn or under ``flg_skin``."""
  fx = m.flex
  f = int(flexid)
  dim = int(fx.dim[f])
  va, vn = int(fx.vertadr[f]), int(fx.vertnum[f])
  verts = d.flexvert_xpos[:, va:va + vn]
  radius = fx.radius[f]
  p, v = pnt[:, None], vec[:, None]
  dists, vids = [], []
  if flg_edge or (dim > 1 and flg_skin):
    ea, en = int(fx.edgeadr[f]), int(fx.edgenum[f])
    edge = fx.edge[ea:ea + en] - va
    v1, v2 = verts[:, m.const(edge[:, 0])], verts[:, m.const(edge[:, 1])]
    dif = v2 - v1
    length = torch.linalg.vector_norm(dif, dim=-1)
    mat = _mat_z(dif / torch.clamp(length, min=1e-12)[..., None])
    size = torch.stack([radius.expand_as(length), 0.5 * length,
                        radius.expand_as(length)], dim=-1)
    de = ray_geom(0.5 * (v1 + v2), mat, size, p, v, GeomType.CAPSULE)
    hit = p + v * torch.where(torch.isfinite(de), de, 0.0)[..., None]
    first = (torch.linalg.vector_norm(v1 - hit, dim=-1)
             < torch.linalg.vector_norm(v2 - hit, dim=-1))
    dists.append(de)
    vids.append(torch.where(first, m.const(edge[:, 0]), m.const(edge[:, 1])))
  elif flg_vert and not (dim > 1 and flg_skin):
    dists.append(_ray_sphere_raw(verts, radius * radius, p, v))
    vids.append(torch.arange(vn, device=pnt.device).expand(pnt.shape[0], vn))
  if dim > 1 and (flg_face or flg_skin):
    ea, en = int(fx.elemadr[f]), int(fx.elemnum[f])
    elem = fx.elem[ea:ea + en, :dim + 1] - va
    if dim == 3:
      layer = fx.elemlayer[ea:ea + en]
      elem = elem[layer == 0] if flg_skin else elem[layer == flex_layer]
      tri = np.concatenate([elem[:, [0, 1, 2]], elem[:, [0, 1, 3]],
                            elem[:, [0, 2, 3]], elem[:, [1, 2, 3]]])
    else:
      tri = elem
    if len(tri):
      tris = verts[:, m.const(tri)]                       # (B, T, 3, 3)
      dt = _ray_triangles(tris, pnt, vec)
      dists.append(dt)
      vids.append(_nearest_of(pnt, vec, dt, tris, tri))
  if not dists:
    return pnt.new_full(pnt.shape[:1], -1.0), torch.full(
        pnt.shape[:1], -1, dtype=torch.int64, device=pnt.device)
  return _first_hit(dists, vids)


def ray_skin(face: np.ndarray, vert: torch.Tensor, pnt: torch.Tensor,
             vec: torch.Tensor):
  """The nearest intersection of one ray a lane (``pnt``, ``vec`` (B, 3))
  with a skin's triangles (``face`` (F, 3) host ids of the posed vertices
  ``vert`` (B, V, 3)), and the hit triangle's vertex nearest to it
  (``mju_raySkin``): the distances (B,), -1 on a miss, and the vertices
  (B,)."""
  face = np.asarray(face, np.int64)
  tris = vert[:, torch.as_tensor(face, device=vert.device)]
  dt = _ray_triangles(tris, pnt, vec)
  return _first_hit([dt], [_nearest_of(pnt, vec, dt, tris, face)])
