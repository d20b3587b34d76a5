"""Host mesh -> voxel signed-distance grid, and its device sampler.

Port of the JAX package's ``ops/meshsdf.py``, the analog of
C's ``mujoco.sdf.sdflib`` octree (``plugin/sdf/sdflib.cc``): a dense voxel
grid built once on the host with numpy and scipy (``mesh_sdf_grid``, the
same arithmetic as the JAX package's, so the grids are equal), sampled on
the device by trilinear interpolation (``sample_grid``, one gather of the
eight corners for points of any batch shape).

Outside the grid's box the point is projected into the box and the
Euclidean excess added to the boundary sample, C's ``boxProjection``
(sdflib.cc:34).  Negative inside: a flood fill from the grid's corner
through the voxels off the surface gives the sign, and voxels within a
voxel diagonal of the surface take the nearest triangle's side.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SdfGrid(NamedTuple):
  """A dense signed-distance voxel grid (host-built, device-sampled)."""
  values: np.ndarray   # (nx, ny, nz) signed distances at voxel centers
  lo: np.ndarray       # (3,) world position of voxel (0,0,0) center
  spacing: np.ndarray  # (3,) voxel pitch
  # box used by the outside-projection composition (center, halfsize)
  box_center: np.ndarray
  box_half: np.ndarray


def _point_tri_dist(p, a, b, c):
  """Distance + closest point from points (n,3) to one triangle."""
  ab, ac, ap = b - a, c - a, p - a
  d1 = ap @ ab
  d2 = ap @ ac
  bp = p - b
  d3 = bp @ ab
  d4 = bp @ ac
  cp = p - c
  d5 = cp @ ab
  d6 = cp @ ac
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom = np.maximum(va + vb + vc, 1e-30)
  v = np.clip(vb / denom, 0.0, 1.0)
  w = np.clip(vc / denom, 0.0, 1.0)
  # keep the face candidate INSIDE the triangle (v+w <= 1): a plane
  # point beyond edge bc would under-report the distance; the true
  # closest for those regions is the bc edge candidate below
  s = np.maximum(v + w, 1.0)
  v, w = v / s, w / s
  q = a + v[:, None] * ab + w[:, None] * ac          # face region
  # edge/vertex regions
  t_ab = np.clip(d1 / np.maximum(ab @ ab, 1e-30), 0, 1)
  t_ac = np.clip(d2 / np.maximum(ac @ ac, 1e-30), 0, 1)
  bc = c - b
  t_bc = np.clip(bp @ bc / np.maximum(bc @ bc, 1e-30), 0, 1)
  cands = np.stack([
      q,
      a + t_ab[:, None] * ab,
      a + t_ac[:, None] * ac,
      b + t_bc[:, None] * bc,
  ])                                                  # (4, n, 3)
  d2s = np.sum((cands - p[None]) ** 2, axis=2)
  k = np.argmin(d2s, axis=0)
  best = cands[k, np.arange(len(p))]
  return np.sqrt(d2s[k, np.arange(len(p))]), best


def mesh_sdf_grid(verts: np.ndarray, faces: np.ndarray, res: int = 48,
                  margin_frac: float = 0.12) -> SdfGrid:
  """Builds the signed voxel grid of a triangle mesh (host, numpy)."""
  from scipy.spatial import cKDTree

  verts = np.asarray(verts, np.float64).reshape(-1, 3)
  faces = np.asarray(faces, np.int64).reshape(-1, 3)
  lo0, hi0 = verts.min(0), verts.max(0)
  pad = margin_frac * float((hi0 - lo0).max())
  lo, hi = lo0 - pad, hi0 + pad
  shape = np.full(3, int(res))
  spacing = (hi - lo) / (shape - 1)
  xs = [lo[i] + spacing[i] * np.arange(shape[i]) for i in range(3)]
  gx, gy, gz = np.meshgrid(*xs, indexing="ij")
  pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

  # nearest-face candidates from a centroid KD-tree (octree-build analog)
  tri = verts[faces]                                  # (F, 3, 3)
  centroids = tri.mean(axis=1)
  tree = cKDTree(centroids)
  tri_rad = np.linalg.norm(tri - centroids[:, None], axis=2).max(axis=1)
  kq = min(16, len(faces))
  _, cand = tree.query(pts, k=kq, workers=-1)
  cand = np.atleast_2d(cand.reshape(len(pts), -1))

  dist = np.full(len(pts), np.inf)
  closest = np.zeros((len(pts), 3))
  closest_face = np.zeros(len(pts), np.int64)
  # evaluate candidate faces grouped by face id (vectorized per face)
  order = np.argsort(cand, axis=None)
  flat_faces = cand.ravel()[order]
  flat_pts = np.repeat(np.arange(len(pts)), kq)[order]
  bounds = np.searchsorted(flat_faces,
                           np.arange(len(faces) + 1))
  for fidx in np.unique(flat_faces):
    sl = slice(bounds[fidx], bounds[fidx + 1])
    pid = flat_pts[sl]
    dd, qq = _point_tri_dist(pts[pid], tri[fidx, 0], tri[fidx, 1],
                             tri[fidx, 2])
    better = dd < dist[pid]
    upd = pid[better]
    dist[upd] = dd[better]
    closest[upd] = qq[better]
    closest_face[upd] = fidx

  # sign: flood fill from the corner through non-shell voxels; shell
  # voxels (within a voxel diagonal of the surface) sign by the nearest
  # face's outward normal
  from scipy import ndimage

  diag = float(np.linalg.norm(spacing))
  shell = (dist < diag).reshape(shape)
  outside_seed = np.zeros(tuple(shape), bool)
  outside_seed[0, 0, 0] = True
  outside = ndimage.binary_propagation(outside_seed, mask=~shell)
  inside = (~outside & ~shell).reshape(-1)

  fnrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
  fnrm /= np.maximum(np.linalg.norm(fnrm, axis=1, keepdims=True), 1e-30)
  shell_flat = shell.reshape(-1)
  side = np.einsum("nc,nc->n", pts - closest, fnrm[closest_face])
  sign = np.where(shell_flat, np.where(side < 0, -1.0, 1.0),
                  np.where(inside, -1.0, 1.0))

  values = (sign * dist).reshape(tuple(shape))
  return SdfGrid(
      values=values.astype(np.float64),
      lo=lo, spacing=spacing,
      box_center=0.5 * (lo + hi), box_half=0.5 * (hi - lo),
  )


def sample_grid(values_flat: torch.Tensor, shape, lo: torch.Tensor,
                spacing: torch.Tensor, box_center: torch.Tensor,
                box_half: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Trilinear sample of the grid at local points ``x`` (..., 3): the
  flattened values (nx ny nz,) of a grid of host ``shape``; outside the
  box, the boundary sample plus the Euclidean excess (C's
  ``boxProjection``, sdflib.cc:34,121)."""
  return sample_grid_and_grad(values_flat, shape, lo, spacing, box_center,
                              box_half, x, grad=False)[0]


def sample_grid_and_grad(values_flat: torch.Tensor, shape, lo: torch.Tensor,
                spacing: torch.Tensor, box_center: torch.Tensor,
                box_half: torch.Tensor, x: torch.Tensor, grad: bool = True):
  """``sample_grid``'s value and, where ``grad``, its gradient in ``x``
  as ``jax.grad`` takes it (None otherwise): the trilinear slopes over the
  spacing where the point lies inside the box along an axis (half of it
  on the box's face), plus the excess's."""
  r = x - box_center
  q = torch.abs(r) - box_half
  pos = torch.maximum(q, torch.zeros_like(q))
  norm = torch.sqrt(torch.sum(pos * pos, dim=-1) + 1e-30)
  within = torch.all(q <= 0, dim=-1)
  excess = torch.where(within, 0.0, norm)
  xin = box_center + torch.minimum(torch.maximum(r, -box_half), box_half)
  u = (xin - lo) / spacing
  nx, ny, nz = (int(s) for s in shape)
  i0 = torch.floor(u).to(torch.int64)
  ix, iy, iz = (torch.clamp(i0[..., k], 0, n - 2)
                for k, n in enumerate((nx, ny, nz)))
  f = u - torch.stack([ix, iy, iz], dim=-1)
  base = ix * (ny * nz) + iy * nz + iz

  def v(dx, dy, dz):
    return values_flat[base + (dx * ny * nz + dy * nz + dz)]

  fx, fy, fz = f.unbind(-1)
  c00 = v(0, 0, 0) * (1 - fx) + v(1, 0, 0) * fx
  c10 = v(0, 1, 0) * (1 - fx) + v(1, 1, 0) * fx
  c01 = v(0, 0, 1) * (1 - fx) + v(1, 0, 1) * fx
  c11 = v(0, 1, 1) * (1 - fx) + v(1, 1, 1) * fx
  c0 = c00 * (1 - fy) + c10 * fy
  c1 = c01 * (1 - fy) + c11 * fy
  value = c0 * (1 - fz) + c1 * fz + excess
  if not grad:
    return value, None
  dx = lambda dy, dz: v(1, dy, dz) - v(0, dy, dz)
  gx = ((dx(0, 0) * (1 - fy) + dx(1, 0) * fy) * (1 - fz)
        + (dx(0, 1) * (1 - fy) + dx(1, 1) * fy) * fz)
  gy = (c10 - c00) * (1 - fz) + (c11 - c01) * fz
  gz = c1 - c0
  inside = (torch.where(r > -box_half, 1.0, torch.where(r == -box_half, 0.5,
                                                         0.0))
            * torch.where(r < box_half, 1.0, torch.where(r == box_half, 0.5,
                                                          0.0))).to(x.dtype)
  g = torch.stack([gx, gy, gz], dim=-1) / spacing * inside
  slope = torch.where(r >= 0, 1.0, -1.0).to(x.dtype)
  g_excess = torch.where(within[..., None], 0.0, pos * slope / norm[..., None])
  return value, g + g_excess
