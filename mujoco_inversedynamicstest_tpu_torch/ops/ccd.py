"""Support-function convex collision: direction-descent CCD, batched.

Port of the JAX package's ``ops/ccd.py``.  The signed
separation of two convex support sets is the minimum over unit directions
``u`` of

    h(u) = max_{x in A} u.x  +  max_{y in B} (-u).y  + pad,

``-distance`` when the sets are apart and ``+depth`` when they overlap; the
contact normal is the minimizing ``u``.  It is found by projected
subgradient descent with a geometric angle schedule from a few seeds, the
best iterate kept: fixed trip counts, no branches.

Every function takes tensors of any leading shape (lanes times pairs).  A
support function ``supp(u)`` takes directions ``u`` (..., 3) or, for a fan
of seeds, (..., S, 3); the geom's tensors broadcast over the seed axis.
Each loop is a Python loop of a fixed count over whole batches, each choice
a ``torch.where``, each selection an ``argmin`` and a gather: nothing is
read back to the host and nothing is written in place, so
``torch.func.vmap`` over ``torch.func.jvp`` runs through it.

Each convex pair gives one contact.  That is C MuJoCo's count under
``mjDSBL_MULTICCD``; by default C 3.10 runs multi-contact CCD and gives up
to 5 on flat-faced pairs (ROADMAP §3).
"""

from __future__ import annotations

import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType
from mujoco_inversedynamicstest_tpu_torch.ops import math

_BIG = 1e10


def _dot(a, b):
  return torch.sum(a * b, dim=-1)


def _mtv(mat, v):
  """mat^T v as products and sums (no batched matmul)."""
  return torch.sum(mat * v[..., :, None], dim=-2)


def _mv(mat, v):
  """mat v as products and sums."""
  return torch.sum(mat * v[..., None, :], dim=-1)


def _like(x, u, extra: int = 0):
  """``x`` (..., k[, k]) with a unit axis inserted before its last
  ``1 + extra`` axes until it broadcasts against ``u`` (..., [S,] 3)."""
  while x.dim() < u.dim() + extra:
    x = x.unsqueeze(-2 - extra)
  return x


# --------------------------------------------------------------------------
# support functions
# --------------------------------------------------------------------------


def geom_support_fn(gtype, p, mat, size):
  """World-frame support function of an analytic convex geom at ``p``
  (..., 3), ``mat`` (..., 3, 3), ``size`` (..., 3): the farthest point of
  the geom along world direction ``u`` (``mjccd_support``)."""
  gtype = int(gtype)
  size = size.expand(p.shape)

  def parts(u):
    return _like(p, u), _like(mat, u, 1), _like(size, u)

  if gtype == GeomType.CYLINDER:

    def supp(u):
      pp, mm, ss = parts(u)
      a = mm[..., :, 2]
      ca = _dot(u, a)
      perp = u - ca[..., None] * a
      lp = math.norm_safe(perp)
      rad = torch.where((lp > 1e-9)[..., None],
                        ss[..., 0:1] * perp / torch.clamp(
                            lp, min=math.MINVAL)[..., None],
                        torch.zeros_like(perp))
      return pp + (torch.sign(ca) * ss[..., 1])[..., None] * a + rad
  elif gtype == GeomType.ELLIPSOID:

    def supp(u):
      pp, mm, ss = parts(u)
      w = ss * _mtv(mm, u)
      lw = torch.clamp(math.norm_safe(w), min=math.MINVAL)
      return pp + _mv(mm, ss * w / lw[..., None])
  elif gtype == GeomType.SPHERE:

    def supp(u):
      pp, _, ss = parts(u)
      return pp + ss[..., 0:1] * u
  elif gtype == GeomType.CAPSULE:

    def supp(u):
      pp, mm, ss = parts(u)
      a = mm[..., :, 2]
      return (pp + (torch.sign(_dot(u, a)) * ss[..., 1])[..., None] * a
              + ss[..., 0:1] * u)
  elif gtype == GeomType.BOX:

    def supp(u):
      pp, mm, ss = parts(u)
      return pp + _mv(mm, torch.sign(_mtv(mm, u)) * ss)
  else:
    raise NotImplementedError(f"support fn for geom type {gtype}")
  return supp


def hull_support_fn(vert):
  """Support of a convex vertex cloud ``vert`` (..., V, 3): the vertex of
  largest ``u``-projection (the first of a tie)."""

  def supp(u):
    v = _like(vert, u, 1)
    k = torch.argmax(torch.sum(v * u[..., None, :], dim=-1), dim=-1)
    return torch.take_along_dim(
        v.expand(u.shape[:-1] + v.shape[-2:]), k[..., None, None],
        dim=-2)[..., 0, :]

  return supp


# --------------------------------------------------------------------------
# direction descent
# --------------------------------------------------------------------------


def _descend(supp_a, supp_b, u0, pad, thetas):
  """One descent per seed of ``u0`` (..., [S,] 3) along the angle schedule
  ``thetas``; the best (h, u) of each seed, the start included."""

  def h_of(u):
    return _dot(u, supp_a(u) - supp_b(-u)) + pad

  u, best_u = u0, u0
  best_h = h_of(u0)
  for theta in thetas:
    w = supp_a(u) - supp_b(-u)
    g = w - _dot(w, u)[..., None] * u
    gn = torch.clamp(math.norm_safe(g), min=math.MINVAL)
    u = math.normalize(u - (theta / gn)[..., None] * g)
    h = h_of(u)
    better = h < best_h
    best_h = torch.where(better, h, best_h)
    best_u = torch.where(better[..., None], u, best_u)
  return best_h, best_u


def _pick(hs, us):
  """The seed of least h (the first of a tie): (h, u)."""
  k = torch.argmin(hs, dim=-1)
  h = torch.take_along_dim(hs, k[..., None], dim=-1)[..., 0]
  u = torch.take_along_dim(us, k[..., None, None], dim=-2)[..., 0, :]
  return h, u


def support_descent(supp_a, supp_b, seeds, pad: float = 0.0,
                    iters: int = 18, theta0: float = 0.5):
  """Signed separation of two convex support sets by direction descent
  from every seed of ``seeds`` (..., S, 3) over the full schedule; the best
  over all seeds and iterates wins.  Returns (dist, normal, wa): the
  contact distance (negative when penetrating), the A -> B normal and A's
  witness point along it."""
  thetas = [theta0 * 0.7 ** i for i in range(iters)]
  h, u = _pick(*_descend(supp_a, supp_b, seeds, pad, thetas))
  return -h, u, supp_a(u)


def support_descent_staged(supp_a, supp_b, seeds, pad: float = 0.0,
                           coarse: int = 5, fine: int = 14):
  """Two-stage variant: a short coarse descent from every seed picks the
  winning basin, one fine descent refines it (the hot-path
  configuration of the geom-geom narrowphase)."""
  hs, us = _descend(supp_a, supp_b, seeds, pad,
                    [0.4 * 0.55 ** i for i in range(coarse)])
  hk, uk = _pick(hs, us)
  h1, u1 = _descend(supp_a, supp_b, uk, pad,
                    [0.12 * 0.62 ** i for i in range(fine)])
  better = h1 < hk
  h = torch.where(better, h1, hk)
  u = torch.where(better[..., None], u1, uk)
  return -h, u, supp_a(u)


# --------------------------------------------------------------------------
# smooth-surface normal restoration (mjc_fixNormal)
# --------------------------------------------------------------------------


def ellipsoid_normal(pos, size, nrm0):
  """Surface normal of an ellipsoid of half-axes ``size`` at or near the
  local point ``pos`` (both (..., 3)): ``mjc_fixNormal``'s ellipsoid
  branch, 30 ray-projection steps for a point inside and 30 Newton steps
  on the QCQP's lambda for one outside, both computed, one kept."""
  s2inv = 1.0 / (size * size)
  c = torch.sum(pos * pos * s2inv, dim=-1) - 1.0
  inside = c <= 0

  nrm = math.normalize(nrm0)
  for _ in range(30):
    a = torch.sum(nrm * nrm * s2inv, dim=-1)
    b = torch.sum(pos * nrm * s2inv, dim=-1)
    det = torch.clamp(b * b - a * c, min=0.0)
    x = (-b + torch.sqrt(det)) / torch.clamp(a, min=math.MINVAL)
    newn = math.normalize((pos + x[..., None] * nrm) * s2inv)
    ok = (det >= math.MINVAL) & (a >= math.MINVAL) & (x >= 0)
    nrm = torch.where(ok[..., None], newn, nrm)

  s2 = size * size
  ps2 = pos * pos * s2
  la = torch.zeros_like(c)
  for _ in range(30):
    r = 1.0 / (s2 + la[..., None])
    val = torch.sum(ps2 * r * r, dim=-1) - 1.0
    deriv = -2.0 * torch.sum(ps2 * r * r * r, dim=-1)
    delta = -val / torch.clamp(deriv, max=-math.MINVAL)
    la = torch.where(val >= 1e-6, la + delta, la)
  n_out = math.normalize(pos / (s2 + la[..., None]))
  return torch.where(inside[..., None], nrm, n_out)


def fix_normal_smooth(gtype, p, mat, size, pos, nrm):
  """A CCD contact normal ``nrm`` (oriented away from the geom) snapped to
  the analytic surface normal of a smooth geom at the contact point
  ``pos`` (``mjc_fixNormal``): the radial normal on a cylinder's wall,
  the ellipsoid's own normal; any other geom's normal is kept."""
  pl = _mtv(mat, pos - p)
  nl = _mtv(mat, nrm)
  gtype = int(gtype)
  if gtype == GeomType.CYLINDER:
    r, hl = size[..., 0], size[..., 1]
    dst1 = torch.abs(hl - torch.abs(pl[..., 2]))
    dst2 = torch.abs(r - torch.linalg.vector_norm(pl[..., :2], dim=-1))
    keep = (torch.abs(pl[..., 2]) > 0.95 * hl) | (dst1 < 0.25 * dst2)
    radial = math.normalize(torch.cat([pl[..., :2], 0.0 * pl[..., 2:]],
                                      dim=-1))
    fixed = torch.where(keep[..., None], nl, radial)
  elif gtype == GeomType.ELLIPSOID:
    fixed = ellipsoid_normal(pl, size, nl)
  else:
    return nrm
  return _mv(mat, fixed)
