"""Height-field narrowphase, batched.

Port of ``mujoco_inversedynamicstest_tpu/ops/hfield.py``, the narrowphase
and the ray cast ``ray_hfield``.  The field spans
``x in [-size0, size0]`` over ``ncol`` samples and ``y in [-size1, size1]``
over ``nrow``; ``data[r, c]`` is the normalized height at ``(dx c - size0,
dy r - size1)`` scaled by ``size2``, and a base of depth ``size3`` hangs
below z = 0.  Each cell splits into two triangles along its
(c, r) -> (c+1, r+1) diagonal, as C's ``engine_ray.c`` orders them.

Each narrowphase reads the triangles of a window of cells under the
object, a fixed (rows, cols) per pair group from the objects' bounding
radius (``subgrid_cells``), placed lane by lane by a gather:

* sphere, capsule: the exact closest point of each triangle, the
  penetration sign from the triangle's face normal;
* box, mesh hull: the support-function descent of ``ops/ccd.py`` between
  each cell's triangular prism (the top triangle down to the base) and the
  hull, one contact a prism.  C collides such a hull with the prisms by its
  CCD as well (``mjc_ConvexHField``), with its own contact selection
  (ROADMAP §3).

The 4 deepest contacts within the margin are kept, coincident ones once.
The grid is host data, built once a model like a hull (``HFieldGrid``),
with its vertex table on the device made once (``Model.const``).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import ccd
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex as cc
from mujoco_inversedynamicstest_tpu_torch.ops import math

_BIG = 1e10
HFIELD_NSLOT = 4


class HFieldGrid:
  """One height field's vertex grid (host numpy, the field's frame)."""

  def __init__(self, nrow: int, ncol: int, size: np.ndarray,
               data: np.ndarray):
    self.nrow, self.ncol = int(nrow), int(ncol)
    self.size = np.asarray(size, np.float64)
    self.dx = 2.0 * self.size[0] / (self.ncol - 1)
    self.dy = 2.0 * self.size[1] / (self.nrow - 1)
    xs = self.dx * np.arange(self.ncol) - self.size[0]
    ys = self.dy * np.arange(self.nrow) - self.size[1]
    z = np.asarray(data, np.float64).reshape(self.nrow, self.ncol
                                             ) * self.size[2]
    self.vert = np.stack(
        np.broadcast_arrays(xs[None, :], ys[:, None], z), axis=-1)

  def cell_tris(self) -> np.ndarray:
    """Every cell's two top triangles, ((nrow-1) (ncol-1) 2, 3, 3), in the
    order of ``_gather_subgrid_tris``."""
    v = self.vert
    tri_a = np.stack([v[:-1, :-1], v[1:, 1:], v[:-1, 1:]], axis=2)
    tri_b = np.stack([v[:-1, :-1], v[1:, 1:], v[1:, :-1]], axis=2)
    return np.concatenate([tri_a, tri_b], axis=2).reshape(-1, 3, 3)

  def bound(self) -> float:
    """Radius of the field's bounding sphere about its frame's origin."""
    s = self.size
    return float(np.sqrt(s[0] ** 2 + s[1] ** 2 + max(s[2], s[3]) ** 2))


def hfield_grids(size, nrow, ncol, adr, data) -> tuple:
  """``HFieldGrid`` per height field, from the snapshot arrays."""
  return tuple(
      HFieldGrid(r, c, s, data[int(a):int(a) + int(r) * int(c)])
      for s, r, c, a in zip(size, nrow, ncol, adr))


def subgrid_cells(grid: HFieldGrid, rbound: float, cap: int = 12
                  ) -> Tuple[int, int]:
  """Static (rows, cols) of the cell window under an object of bounding
  radius ``rbound``, at most ``cap`` a side."""
  nc = int(np.ceil(2.0 * rbound / grid.dx)) + 1
  nr = int(np.ceil(2.0 * rbound / grid.dy)) + 1
  if min(nc, grid.ncol - 1) > cap or min(nr, grid.nrow - 1) > cap:
    warnings.warn(
        f"hfield contact window capped at {cap}x{cap} cells but the "
        f"object's bounding radius {rbound:.3g} spans "
        f"{min(nr, grid.nrow - 1)}x{min(nc, grid.ncol - 1)} cells "
        f"(dx={grid.dx:.3g}, dy={grid.dy:.3g}); rim contacts outside the "
        "window will be missed.  Use a coarser hfield or smaller geoms.")
  nc = max(1, min(nc, grid.ncol - 1, cap))
  nr = max(1, min(nr, grid.nrow - 1, cap))
  return nr, nc


def _gather_subgrid_tris(grid: HFieldGrid, vert, lpos, nr: int, nc: int):
  """Triangles (..., 2 nr nc, 3, 3) of the (nr, nc)-cell window centred
  under the field-frame point ``lpos`` (..., 3); ``vert`` is the grid's
  vertex table (nrow ncol, 3) on the device.  Each cell gives its two
  triangles in turn."""
  cmin = torch.floor((lpos[..., 0] + grid.size[0]) / grid.dx
                     - 0.5 * nc + 0.5).long()
  rmin = torch.floor((lpos[..., 1] + grid.size[1]) / grid.dy
                     - 0.5 * nr + 0.5).long()
  cmin = torch.clamp(cmin, 0, grid.ncol - 1 - nc)
  rmin = torch.clamp(rmin, 0, grid.nrow - 1 - nr)
  rs = rmin[..., None] + torch.arange(nr + 1, device=lpos.device)
  cs = cmin[..., None] + torch.arange(nc + 1, device=lpos.device)
  idx = rs[..., :, None] * grid.ncol + cs[..., None, :]   # (..., nr+1, nc+1)
  sub = vert[idx]                                         # (..., nr+1, nc+1, 3)
  v00, v10 = sub[..., :-1, :-1, :], sub[..., :-1, 1:, :]
  v01, v11 = sub[..., 1:, :-1, :], sub[..., 1:, 1:, :]
  tri_a = torch.stack([v00, v11, v10], dim=-2)
  tri_b = torch.stack([v00, v11, v01], dim=-2)
  tris = torch.cat([tri_a, tri_b], dim=-2)               # (..., nr, nc, 6, 3)
  return tris.reshape(tris.shape[:-4] + (2 * nr * nc, 3, 3))


def _tri_normal_up(tv):
  """Upward (+z) unit normal of triangles (..., 3, 3)."""
  n = cc._cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :])
  n = n * torch.sign(n[..., 2:3] + 1e-30)
  return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                         min=1e-15)


def _select_slots(dist, pos, nrm, margin, nslot: int = HFIELD_NSLOT):
  """The ``nslot`` deepest candidates (..., T) within the margin, the
  lower candidate first in a tie; a candidate at the point of a deeper one
  (two triangles sharing the contact edge or vertex) is dropped."""
  dist = torch.where(dist <= margin[..., None], dist, _BIG)
  idx = torch.sort(dist, dim=-1, stable=True).indices[..., :nslot]
  d = torch.take_along_dim(dist, idx, dim=-1)
  p = torch.take_along_dim(pos, idx[..., None], dim=-2)
  n = torch.take_along_dim(nrm, idx[..., None], dim=-2)
  pd = torch.linalg.vector_norm(p[..., :, None, :] - p[..., None, :, :],
                                dim=-1)
  earlier = torch.tril(torch.ones(nslot, nslot, dtype=torch.bool,
                                  device=d.device), diagonal=-1)
  dup = torch.any((pd < 1e-7) & earlier, dim=-1)
  return torch.where(dup, _BIG, d), p, n


def _to_world(p1, m1, d, p, n):
  """Field-frame slots to world: (dist, pos, normal, yhint)."""
  mm = m1[..., None, :, :]
  pos = ccd._mv(mm, p) + p1[..., None, :]
  return d, pos, ccd._mv(mm, n), torch.zeros_like(pos)


def _margin(margin, like):
  return torch.as_tensor(margin, dtype=like.dtype, device=like.device
                         ).expand(like.shape[:-1])


def make_hfield_sphere(grid: HFieldGrid, vert, nr: int, nc: int):
  """HFIELD-SPHERE: each triangle's exact closest point, 4 slots."""

  def fn(p1, m1, s1, p2, m2, s2, margin):
    lpos = ccd._mtv(m1, p2 - p1)
    r = s2[..., 0].expand(lpos.shape[:-1])[..., None]
    tv = _gather_subgrid_tris(grid, vert, lpos, nr, nc)   # (..., T, 3, 3)
    lp = lpos[..., None, :]
    q = cc._closest_pt_tri(lp, tv[..., 0, :], tv[..., 1, :], tv[..., 2, :])
    nf = _tri_normal_up(tv)
    u = lp - q
    lu = torch.linalg.vector_norm(u, dim=-1)
    sd = ccd._dot(lp - tv[..., 0, :], nf)
    # the closest point lies inside the face iff |u| is the plane distance
    interior = lu - torch.abs(sd) < 1e-9
    above = sd >= 0
    # inside a face: the signed depth along its normal (a centre below the
    # surface too); at an edge or vertex a contact only from above
    n = torch.where((interior | (lu <= 1e-12))[..., None], nf,
                    u / torch.clamp(lu, min=1e-12)[..., None])
    dist = torch.where(interior, sd - r, lu - r)
    dist = torch.where(interior | above, dist, _BIG)
    pos = q + n * (0.5 * dist)[..., None]
    return _to_world(p1, m1, *_select_slots(dist, pos, n,
                                            _margin(margin, lpos)))

  return fn


def make_hfield_capsule(grid: HFieldGrid, vert, nr: int, nc: int):
  """HFIELD-CAPSULE: per triangle the best of the two end points against
  the face and the segment against the three edges, 4 slots."""

  def fn(p1, m1, s1, p2, m2, s2, margin):
    lpos = ccd._mtv(m1, p2 - p1)
    laxis = ccd._mtv(m1, m2[..., :, 2])
    shape = lpos.shape[:-1]
    r = s2[..., 0].expand(shape)[..., None]
    hl = s2[..., 1].expand(shape)[..., None]
    e1 = lpos + laxis * hl
    e2 = lpos - laxis * hl
    tv = _gather_subgrid_tris(grid, vert, lpos, nr, nc)
    t = [tv[..., i, :] for i in range(3)]
    nf = _tri_normal_up(tv)
    a1, a2 = e1[..., None, :], e2[..., None, :]
    cands = [(a1.expand_as(t[0]), cc._closest_pt_tri(a1, *t)),
             (a2.expand_as(t[0]), cc._closest_pt_tri(a2, *t))]
    for i in range(3):
      cands.append(cc._closest_seg_seg(a1, a2 - a1, t[i], t[(i + 1) % 3]
                                       - t[i]))
    ps = torch.stack([c[0] for c in cands], dim=-2)       # (..., T, 5, 3)
    qs = torch.stack([c[1] for c in cands], dim=-2)
    u = ps - qs
    lu = torch.linalg.vector_norm(u, dim=-1)
    # face-interior candidates take the signed plane distance, so that a
    # penetrating feature wins over the shallow end of a crossing capsule
    sd = ccd._dot(ps - t[0][..., None, :], nf[..., None, :])
    interior = lu - torch.abs(sd) < 1e-9
    above = sd >= 0
    rr = r[..., None]
    dist_c = torch.where(interior, sd - rr,
                         torch.where(above, lu - rr, _BIG))
    k = torch.argmin(dist_c, dim=-1)
    u_k, q_k = cc._take(u, k), cc._take(qs, k)
    l_k = cc._take(lu, k, -1)
    n = torch.where((cc._take(interior, k, -1) | (l_k <= 1e-12))[..., None],
                    nf, u_k / torch.clamp(l_k, min=1e-12)[..., None])
    dist = cc._take(dist_c, k, -1)
    pos = q_k + n * (0.5 * dist)[..., None]
    return _to_world(p1, m1, *_select_slots(dist, pos, n,
                                            _margin(margin, lpos)))

  return fn


def make_hfield_convex(grid: HFieldGrid, vert, hull_vert, is_box2: bool,
                       nr: int, nc: int):
  """HFIELD-{BOX,MESH}: the staged support descent between each window
  cell's prism and the hull (``hull_vert`` (V, 3), a box's unit corners
  scaled by its half-sizes), one contact a prism, 4 slots."""
  zbot = -float(grid.size[3])

  def fn(p1, m1, s1, p2, m2, s2, margin):
    vl = hull_vert
    if is_box2:
      vl = vl * s2[..., None, :]
    # hull vertices in the field's frame
    hv = ccd._mtv(m1[..., None, :, :], ccd._mv(m2[..., None, :, :], vl)
                  + (p2 - p1)[..., None, :])               # (..., V, 3)
    hull_c = torch.mean(hv, dim=-2)
    lpos = ccd._mtv(m1, p2 - p1)
    tv = _gather_subgrid_tris(grid, vert, lpos, nr, nc)   # (..., T, 3, 3)
    bot = torch.cat([tv[..., :2], torch.full_like(tv[..., 2:], zbot)],
                    dim=-1)
    supp_prism = ccd.hull_support_fn(torch.cat([tv, bot], dim=-2))
    supp_hull = ccd.hull_support_fn(hv[..., None, :, :])
    nf = _tri_normal_up(tv)
    up = torch.zeros_like(nf)
    up = torch.cat([up[..., :2], torch.ones_like(up[..., 2:])], dim=-1)
    dc = math.normalize(hull_c[..., None, :] - torch.mean(tv, dim=-2))
    seeds = torch.stack([nf, up, dc], dim=-2)
    dist, u, wa = ccd.support_descent_staged(supp_prism, supp_hull, seeds)
    pos = 0.5 * (wa + supp_hull(-u))
    return _to_world(p1, m1, *_select_slots(dist, pos, u,
                                            _margin(margin, lpos)))

  return fn


def make_narrowphase(m, grp):
  """The narrowphase of an (HFIELD, other) pair group, over the field's
  vertex table and the hull's on the model's device (made once)."""
  grid = m.hfield_grid[grp.did1]
  vert = m.const(grid.vert.reshape(-1, 3))
  t2 = int(grp.types[1])
  rb = float(np.max(m.geom_rbound_np[np.asarray(grp.geom2)]))
  nr, nc = subgrid_cells(grid, rb)
  if t2 == 2:                               # SPHERE
    return make_hfield_sphere(grid, vert, nr, nc)
  if t2 == 3:                               # CAPSULE
    return make_hfield_capsule(grid, vert, nr, nc)
  if t2 == 6:                               # BOX
    return make_hfield_convex(grid, vert, m.const(cc.BOX_HULL.vert),
                              True, nr, nc)
  if t2 == 7:                               # MESH
    return make_hfield_convex(grid, vert,
                              m.const(m.mesh_hull[grp.did2].vert),
                              False, nr, nc)
  raise NotImplementedError(
      f"unsupported by the PyTorch port: collision pair HFIELD-{t2}")


# (HFIELD, other) -> slots: SPHERE, CAPSULE, BOX, MESH
HFIELD_SLOTS = {(1, 2): HFIELD_NSLOT, (1, 3): HFIELD_NSLOT,
                (1, 6): HFIELD_NSLOT, (1, 7): HFIELD_NSLOT}


def ray_hfield(m, d, g: int, pnt: torch.Tensor,
               vec: torch.Tensor) -> torch.Tensor:
  """Distances (B, R) of R rays a lane (``pnt``, ``vec`` (B, R, 3)) to the
  height-field geom ``g`` (``mj_rayHfield``): the nearest of every top
  triangle and of the base box below z = 0, +inf on a miss."""
  from mujoco_inversedynamicstest_tpu_torch.ops import ray

  did = int(m.geom_dataid[g])
  grid = m.hfield_grid[did]
  tris = m.memo(("hfield_tris", did), lambda: m.const(grid.cell_tris()))
  half = 0.5 * float(grid.size[3])
  pos, mat = d.geom_xpos[:, None, g], d.geom_xmat[:, None, g]
  base = m.const(np.array([grid.size[0], grid.size[1], half]))
  x_base = ray._ray_box(pos - mat[..., :, 2] * half, mat, base, pnt, vec)
  lpnt, lvec = ray._ray_map(pos, mat, pnt, vec)
  x_top = ray._ray_triangles(tris, lpnt, lvec).amin(-1)
  return torch.minimum(x_base, x_top)
