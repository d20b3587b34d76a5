"""Cylinder, ellipsoid and SDF plugin narrowphases, batched.

Port of ``mujoco_inversedynamicstest_tpu/ops/collision_sdf.py``:
closed forms where they exist (plane-ellipsoid, sphere-cylinder), and the
support-function descent of ``ops/ccd.py`` for every other pair of the
table (sphere, capsule, ellipsoid, cylinder and box against an ellipsoid;
capsule, cylinder and box against a cylinder).  Each pair gives one
contact, C MuJoCo's count under ``mjDSBL_MULTICCD`` (ROADMAP §3).

Every narrowphase has the signature of ``ops/collision.py``: positions
(..., 3), frames (..., 3, 3), sizes (..., 3) and the pair's margin (...,),
returning (dist, pos, normal, yhint) with one slot; an empty slot has
``dist = 1e10``.

SDF plugin geoms (``GeomType.SDF``, C's ``mjc_SDF``) collide by the JAX
module's clearance descent (``make_plugin_narrowphase``): from Halton
points in the two boxes' intersection, a fixed-budget gradient descent on
the clearance ``f1 + f2 + |max(f1, f2)|`` with a line search over 12
step sizes, all lanes, pairs, inits and step sizes one batch and the
iterations the only loop; then the four deepest distinct contacts.  The
JAX package takes ``jax.grad`` of the distances; here the plane's, the
sphere's, the torus's, the bowl's and the sdflib grid's gradients are
written out (``plugins/sdf.py``, ``ops/meshsdf.py``) and the others' are
``torch.func`` gradients, all by ``jax.grad``'s rules at ties.
``_sdf_pair_kernel`` is the same descent over two primitives (on no path
of either package's ``collision``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import ccd
from mujoco_inversedynamicstest_tpu_torch.ops import math

_BIG = 1e10


# --------------------------------------------------------------------------
# local-frame signed distance functions
# --------------------------------------------------------------------------


def sdf_sphere(x, size):
  return math.norm_safe(x) - size[..., 0]


def sdf_capsule(x, size):
  z = torch.minimum(torch.maximum(x[..., 2], -size[..., 1]), size[..., 1])
  return math.norm_safe(torch.cat([x[..., :2], (x[..., 2] - z)[..., None]],
                                  dim=-1)) - size[..., 0]


def sdf_cylinder(x, size):
  """Exact cylinder SDF (2-D rounded-box construction, safe norms)."""
  a = torch.stack([math.norm_safe(x[..., :2]) - size[..., 0],
                   torch.abs(x[..., 2]) - size[..., 1]], dim=-1)
  return (math.norm_safe(torch.clamp(a, min=0.0))
          + torch.clamp(torch.amax(a, dim=-1), max=0.0))


def sdf_ellipsoid(x, size):
  """First-order scaled-space approximation (exact on the surface)."""
  k0 = math.norm_safe(x / size)
  k1 = math.norm_safe(x / (size * size))
  return k0 * (k0 - 1.0) / torch.clamp(k1, min=math.MINVAL)


def sdf_box(x, size):
  """Exact box SDF."""
  q = torch.abs(x) - size
  return (math.norm_safe(torch.clamp(q, min=0.0))
          + torch.clamp(torch.amax(q, dim=-1), max=0.0))


# --------------------------------------------------------------------------
# closed forms
# --------------------------------------------------------------------------


def _slot(dist, pos, nrm, margin):
  dist = torch.where(dist <= margin, dist, _BIG)
  return (dist[..., None], pos[..., None, :], nrm[..., None, :],
          torch.zeros_like(pos)[..., None, :])


def plane_ellipsoid(p1, m1, s1, p2, m2, s2, margin):
  """The ellipsoid's support point along the plane's inward normal."""
  n = m1[..., :, 2]
  n_l = ccd._mtv(m2, n)
  sp_l = -(s2 * s2 * n_l) / torch.clamp(
      math.norm_safe(s2 * n_l), min=math.MINVAL)[..., None]
  sp = ccd._mv(m2, sp_l) + p2
  dist = ccd._dot(sp - p1, n)
  return _slot(dist, sp - (0.5 * dist)[..., None] * n, n, margin)


def sphere_cylinder(p1, m1, s1, p2, m2, s2, margin):
  """The cylinder's closest point to the sphere's centre (exact)."""
  r_s = s1[..., 0]
  x = ccd._mtv(m2, p1 - p2)
  rad = math.norm_safe(x[..., :2])
  unit = torch.stack([torch.ones_like(rad), torch.zeros_like(rad)], dim=-1)
  rdir = torch.where((rad > math.MINVAL)[..., None],
                     x[..., :2] / rad[..., None], unit)
  z = x[..., 2:3]
  q_out = torch.cat([rdir * torch.minimum(rad, s2[..., 0])[..., None],
                     torch.minimum(torch.maximum(z, -s2[..., 1:2]),
                                   s2[..., 1:2])], dim=-1)
  inside = (rad <= s2[..., 0]) & (torch.abs(x[..., 2]) <= s2[..., 1])
  d_side = s2[..., 0] - rad
  d_cap = s2[..., 1] - torch.abs(x[..., 2])
  q_side = torch.cat([rdir * s2[..., 0:1], z], dim=-1)
  q_cap = torch.cat([x[..., :2], torch.sign(z) * s2[..., 1:2]], dim=-1)
  q_in = torch.where((d_side < d_cap)[..., None], q_side, q_cap)
  q = torch.where(inside[..., None], q_in, q_out)

  delta = x - q
  dn = math.norm_safe(delta)
  n_l = torch.where(inside[..., None], -delta, delta) / dn[..., None]
  dist = torch.where(inside, -dn, dn) - r_s
  nrm = -ccd._mv(m2, n_l)
  pos = 0.5 * ((p1 + nrm * r_s[..., None]) + (ccd._mv(m2, q) + p2))
  return _slot(dist, pos, nrm, margin)


# --------------------------------------------------------------------------
# support-descent pairs
# --------------------------------------------------------------------------


def _feature_seeds(t: int, mat, dc):
  """Descent seeds of one geom: its cap or face normals and, for a round
  geom, the radial direction, each signed toward ``dc``.  A degenerate
  radial seed (``dc`` along the axis) falls back to ``dc``."""

  def signed(a):
    return a * torch.where(ccd._dot(a, dc) >= 0, 1.0, -1.0)[..., None]

  if t in (3, 5):                        # capsule, cylinder
    a = mat[..., :, 2]
    radial = dc - ccd._dot(dc, a)[..., None] * a
    rn = math.norm_safe(radial)
    return [signed(a), torch.where(
        (rn > 1e-9)[..., None],
        radial / torch.clamp(rn, min=math.MINVAL)[..., None], dc)]
  if t in (4, 6):                        # ellipsoid, box
    return [signed(mat[..., :, i]) for i in range(3)]
  return []


def support_pair(t1: int, t2: int):
  """One-slot narrowphase of geom types ``t1``, ``t2`` by the staged
  support descent from the centre line and each geom's feature seeds;
  the contact point is the midpoint of the two witness points (C's
  native-CCD convention)."""

  def fn(p1, m1, s1, p2, m2, s2, margin):
    supp1 = ccd.geom_support_fn(t1, p1, m1, s1)
    supp2 = ccd.geom_support_fn(t2, p2, m2, s2)
    dc = math.normalize(p2 - p1)
    seeds = torch.stack([dc] + _feature_seeds(t1, m1, dc)
                        + _feature_seeds(t2, m2, dc), dim=-2)
    dist, u, wa = ccd.support_descent_staged(supp1, supp2, seeds)
    return _slot(dist, 0.5 * (wa + supp2(-u)), u, margin)

  return fn


# (type1, type2) -> narrowphase; GeomType values: PLANE 0, SPHERE 2,
# CAPSULE 3, ELLIPSOID 4, CYLINDER 5, BOX 6
SDF_NARROWPHASE = {
    (0, 4): plane_ellipsoid,
    (2, 4): support_pair(2, 4),
    (2, 5): sphere_cylinder,
    (3, 4): support_pair(3, 4),
    (3, 5): support_pair(3, 5),
    (4, 4): support_pair(4, 4),
    (4, 5): support_pair(4, 5),
    (4, 6): support_pair(4, 6),
    (5, 5): support_pair(5, 5),
    (5, 6): support_pair(5, 6),
}
SDF_SLOTS = {key: 1 for key in SDF_NARROWPHASE}


_SDF = {2: sdf_sphere, 3: sdf_capsule, 4: sdf_ellipsoid, 5: sdf_cylinder,
        6: sdf_box}


# --------------------------------------------------------------------------
# the clearance descent
# --------------------------------------------------------------------------


def _plane_vg(y, size):
  return y[..., 2], torch.zeros_like(y) + y.new_tensor([0.0, 0.0, 1.0])


def _sphere_vg(y, size):
  """The sphere's distance and gradient (``jax.grad`` of ``sdf_sphere``:
  zero where the norm's floor holds)."""
  sq = torch.sum(y * y, dim=-1, keepdim=True)
  n = torch.sqrt(torch.clamp(sq, min=math.MINVAL * math.MINVAL))
  return n[..., 0] - size[..., 0], torch.where(sq > math.MINVAL * math.MINVAL,
                                               y / n, 0.0)


def _primitive_vg(t: int):
  """(distance, gradient) at local points of a primitive of type ``t``:
  written out for the plane and the sphere, ``torch.func`` of the distance
  for the others."""
  from mujoco_inversedynamicstest_tpu_torch.plugins.sdf import value_and_grad

  if t == 0:
    return _plane_vg
  if t == 2:
    return _sphere_vg
  return lambda y, size: value_and_grad(lambda z: _SDF[t](z, size), y)


def _lead(t: torch.Tensor, x: torch.Tensor, tail: int) -> torch.Tensor:
  """``t`` of shape (B, P) + ``tail`` trailing dims, viewed against the
  points ``x`` (B, P, ..., 3): ones for x's extra dims."""
  extra = x.ndim - 3
  return t.reshape(t.shape[:2] + (1,) * extra + t.shape[2:])


def _size(s: torch.Tensor, xw: torch.Tensor) -> torch.Tensor:
  """A pair's sizes, (P, 3) or a capped group's (B, P, 3), against the
  points ``xw`` (B, P, ..., 3)."""
  if s.ndim == 2:
    s = s[None]
  return _lead(s, xw, 1)


class _Side(NamedTuple):
  """One geom of a pair as functions of world points (B, P, ..., 3): its
  distance, and its distance with the world gradient."""
  value: Callable
  value_and_grad: Callable


def _side(p, mat, local_v, local_vg, rm=None, pm=None) -> _Side:
  """The geom at ``p``, ``mat`` (B, P, ...) whose distance in its local
  frame is ``local_v(y)`` / ``local_vg(y)``; with ``rm``, ``pm`` evaluated
  in its mesh's frame, y = rm matᵀ (x - p) + pm (C's undoTransformation)."""

  def local(xw):
    y = ccd._mtv(_lead(mat, xw, 2), xw - _lead(p, xw, 1))
    return y if rm is None else ccd._mv(rm, y) + pm

  def vg(xw):
    v, g = local_vg(local(xw))
    if rm is not None:
      g = ccd._mtv(rm, g)
    return v, ccd._mv(_lead(mat, xw, 2), g)

  return _Side(lambda xw: local_v(local(xw)), vg)


def _clearance(side1: _Side, side2: _Side):
  """phi = f1 + f2 + |max(f1, f2)| and its value with its gradient, by
  ``jax.grad``'s rules (a tie of the maximum splits, |.| has slope +1 at
  0)."""
  from mujoco_inversedynamicstest_tpu_torch.plugins.sdf import abs_slope

  def value(xw):
    a, b = side1.value(xw), side2.value(xw)
    return a + b + torch.abs(torch.maximum(a, b))

  def value_and_grad(xw):
    (a, ga), (b, gb) = side1.value_and_grad(xw), side2.value_and_grad(xw)
    mx = torch.maximum(a, b)
    dmx = torch.where((a > b)[..., None], ga, torch.where(
        (a < b)[..., None], gb, 0.5 * (ga + gb)))
    return (a + b + torch.abs(mx),
            ga + gb + abs_slope(mx)[..., None] * dmx)

  return value, value_and_grad


def _descend(phi, phi_vg, x0, niter: int = 8, n_ls: int = 10):
  """Fixed-budget gradient descent on a pointwise ``phi`` (``phi_vg`` its
  value with its gradient) from the points x0 (..., 3), each with its own
  line search over ``n_ls`` geometric step sizes from 1e-4 to 2 (the JAX
  package's ``_descend``): a point moves to its best candidate where that
  lowers phi.  The points and the step sizes are one batch; the ``niter``
  iterations are the only loop."""
  alphas = torch.as_tensor(np.geomspace(1e-4, 2.0, n_ls), dtype=x0.dtype,
                           device=x0.device)
  x = x0
  for _ in range(niter):
    val, g = phi_vg(x)
    cands = x[..., None, :] - alphas[:, None] * g[..., None, :]
    vals = phi(cands)
    k = torch.argmin(vals, dim=-1, keepdim=True)
    best = torch.take_along_dim(vals, k, dim=-1)[..., 0]
    xk = torch.take_along_dim(cands, k[..., None], dim=-2)[..., 0, :]
    x = torch.where((best < val)[..., None], xk, x)
  return x


def _primitive_side(t: int, p, mat, size) -> _Side:
  vg = _primitive_vg(t)
  fn = sdf_plane if t == 0 else _SDF[t]
  return _side(p, mat, lambda y: fn(y, _size(size, y)),
               lambda y: vg(y, _size(size, y)))


def _sdf_pair_kernel(t1: int, t2: int, inits):
  """Narrowphase of two primitives by the clearance descent (the JAX
  package's ``_sdf_pair_kernel``): ``inits(p1, m1, s1, p2, m2, s2) ->
  (B, P, k, 3)`` world starting points, one slot each."""

  def fn(p1, m1, s1, p2, m2, s2, margin):
    side1 = _primitive_side(t1, p1, m1, s1)
    side2 = _primitive_side(t2, p2, m2, s2)
    x = _descend(*_clearance(side1, side2), inits(p1, m1, s1, p2, m2, s2))
    (d1, g1), (d2, g2) = side1.value_and_grad(x), side2.value_and_grad(x)
    dist = d1 + d2
    dist = torch.where(dist <= margin[..., None], dist, _BIG)
    return dist, x, math.normalize(g1 - g2), torch.zeros_like(x)

  return fn


# --------------------------------------------------------------------------
# SDF plugin geoms (mjGEOM_SDF; C's mjc_SDF, engine_collision_sdf.c:660)
# --------------------------------------------------------------------------

# the descent's inits a pair: C seeds ``opt.sdf_initpoints`` Halton points in
# the boxes' intersection (mjc_SDF:754); the JAX package a fixed Halton set
# of 12 scaled into the world boxes' intersection, whatever the option
_SDF_PLUGIN_NINIT = 12
_SDF_PLUGIN_NSLOT = 4
SDF_PLUGIN_SLOTS = _SDF_PLUGIN_NSLOT


def _halton(n: int, base: int):
  out = []
  for i in range(1, n + 1):
    f, r, x = 1.0, 0.0, i
    while x > 0:
      f /= base
      r += f * (x % base)
      x //= base
    out.append(r)
  return out


def _halton_unit(n: int) -> np.ndarray:
  return np.stack([_halton(n, 2), _halton(n, 3), _halton(n, 5)], axis=1)


def sdf_plane(x, size):
  return x[..., 2]


def make_plugin_narrowphase(m, grp):
  """Narrowphase of a pair group whose second geom is an SDF plugin geom
  (the JAX package's ``make_plugin_narrowphase``, a re-design of C's
  ``mjc_SDF``): Halton inits in the world boxes' intersection, the
  clearance descent (12 iterations, 12 step sizes), the contact at the
  midsurface with normal normalize(n1 - n2) of the two unit gradients
  (mjSDFTYPE_MIDSURFACE), and the deepest distinct contacts, four slots.
  A contact needs penetration (dist <= 0, no margin, as C's
  ``addContact``).  Its depth is ``f1 + f2``, the JAX package's, where C
  reports ``max(f1, f2)`` (ROADMAP §3).  Each geom's box is the compiled
  ``geom_aabb`` of the group's first pair, and a mesh-backed SDF is
  evaluated in its mesh's frame (C's undoTransformation)."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType
  from mujoco_inversedynamicstest_tpu_torch.plugins import sdflib

  t1 = GeomType(grp.types[0])
  g1, g2 = int(grp.geom1[0]), int(grp.geom2[0])
  plugins = m.plugins
  inst_of = lambda g: plugins.hooks[int(plugins.geom[g])]
  inst2 = inst_of(g2)
  if any(inst_of(int(g)) is not inst2 for g in grp.geom2):
    raise NotImplementedError(
        "unsupported by the PyTorch port: an SDF pair group over more than "
        "one plugin instance")

  def recenter(g):
    did = int(m.geom_dataid[g])
    if did >= 0:
      return (m.const(sdflib.quat_mat_np(plugins.mesh_quat[did])),
              m.const(plugins.mesh_pos[did]))
    return m.const(np.eye(3)), m.const(np.zeros(3))

  frame2 = recenter(g2)
  inst1 = inst_of(g1) if t1 == GeomType.SDF else None
  frame1 = recenter(g1) if inst1 is not None else None
  units = m.const(_halton_unit(_SDF_PLUGIN_NINIT))
  aabb1, aabb2 = m.const(plugins.geom_aabb[g1]), m.const(
      plugins.geom_aabb[g2])
  earlier = m.const(np.tril(np.ones((_SDF_PLUGIN_NINIT,) * 2, bool), k=-1))

  def fn(p1, m1, s1, p2, m2, s2, margin):
    side2 = _side(p2, m2, inst2.sdf, inst2.sdf_and_grad, *frame2)
    if inst1 is not None:
      side1 = _side(p1, m1, inst1.sdf, inst1.sdf_and_grad, *frame1)
    else:
      side1 = _primitive_side(int(t1), p1, m1, s1)

    # the world boxes' intersection (mjc_SDF:691-721, in the world frame)
    def world_box(p, r, ab):
      c = p + ccd._mv(r, ab[:3])
      half = ccd._mv(torch.abs(r), ab[3:])
      return c - half, c + half

    lo1, hi1 = world_box(p1, m1, aabb1)
    lo2, hi2 = world_box(p2, m2, aabb2)
    lo, hi = torch.maximum(lo1, lo2), torch.minimum(hi1, hi2)
    overlap = torch.all(hi >= lo, dim=-1)
    width = torch.clamp(hi - lo, min=0.0)
    inits = lo[..., None, :] + units * width[..., None, :]   # (B, P, I, 3)

    x = _descend(*_clearance(side1, side2), inits, niter=12, n_ls=12)
    (d1, g1v), (d2, g2v) = side1.value_and_grad(x), side2.value_and_grad(x)
    dists = d1 + d2
    nrms = math.normalize(math.normalize(g1v) - math.normalize(g2v))
    valid = (dists <= 0.0) & overlap[..., None]

    # the deepest first; a candidate that converged to a point already kept
    # is dropped (C's isknown)
    order = torch.argsort(torch.where(valid, dists, _BIG), dim=-1,
                          stable=True)
    take = lambda a: torch.take_along_dim(
        a, order.reshape(order.shape + (1,) * (a.ndim - order.ndim)), dim=2)
    dists, poss, nrms, valid = take(dists), take(x), take(nrms), take(valid)
    scale = torch.clamp(torch.amax(width, dim=-1), min=1e-6)
    close = (torch.linalg.vector_norm(poss[..., :, None, :]
                                      - poss[..., None, :, :], dim=-1)
             < 1e-4 * scale[..., None, None])
    dup = torch.any(close & earlier & valid[..., None, :], dim=-1)
    valid = valid & ~dup
    # the first NSLOT valid candidates, the last candidate where fewer
    # (jnp.nonzero(size=k, fill_value=NINIT - 1))
    first = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    first = first[..., :_SDF_PLUGIN_NSLOT]
    keep = torch.where(torch.take_along_dim(valid, first, dim=-1), first,
                       _SDF_PLUGIN_NINIT - 1)
    out_d = torch.where(torch.take_along_dim(valid, keep, dim=-1),
                        torch.take_along_dim(dists, keep, dim=-1), _BIG)
    kk = keep[..., None]
    pos = torch.take_along_dim(poss, kk, dim=-2)
    return (out_d, pos, torch.take_along_dim(nrms, kk, dim=-2),
            torch.zeros_like(pos))

  return fn
