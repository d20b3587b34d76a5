"""Cylinder and ellipsoid narrowphase, batched.

Port of ``mujoco_inversedynamicstest_tpu/ops/collision_sdf.py:36-285``:
closed forms where they exist (plane-ellipsoid, sphere-cylinder), and the
support-function descent of ``ops/ccd.py`` for every other pair of the
table (sphere, capsule, ellipsoid, cylinder and box against an ellipsoid;
capsule, cylinder and box against a cylinder).  Each pair gives one
contact, C MuJoCo's count under ``mjDSBL_MULTICCD`` (ROADMAP §3).

Every narrowphase has the signature of ``ops/collision.py``: positions
(..., 3), frames (..., 3, 3), sizes (..., 3) and the pair's margin (...,),
returning (dist, pos, normal, yhint) with one slot; an empty slot has
``dist = 1e10``.

The JAX module's clearance descent (``_descend``, ``_sdf_pair_kernel``) is
on no path of the JAX package's ``collision`` and waits with the SDF plugins
(ROADMAP queue 1, item 4); the signed distance functions below are its
building blocks and the plugins'.
"""

from __future__ import annotations

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
