"""Collision detection: static pair table + batched narrowphase.

Port of ``mujoco_inversedynamicstest_tpu/ops/collision.py`` for the
primitive pairs (plane with sphere, capsule, box and cylinder; sphere with
sphere, capsule and box; capsule-capsule), the convex pairs of
``ops/collision_convex.py`` (plane, sphere, capsule, box and mesh against a
box or a mesh hull), the cylinder and ellipsoid pairs of
``ops/collision_sdf.py``, the height-field pairs of ``ops/hfield.py``
(with a sphere, a capsule, a box or a mesh), the SDF plugin geoms (a
plane, a sphere, a capsule, a box or another SDF against an SDF:
``collision_sdf.make_plugin_narrowphase``, four slots, grouped by the SDF
geom), and the flex element contacts of ``ops/flexcol.py``, whose slots
follow the geom pairs'.  The candidate
pairs are the explicit ``<pair>``s and
the pairs enumerated statically from contype/conaffinity, body and parent
filters and excludes; every contact slot exists every step and
``dist >= includemargin`` marks it inactive.  MJX's contact budget (the
``max_geom_pairs`` and ``max_contact_points`` numerics) bounds the slots,
which each lane then fills with its own nearest pairs.
Any other pair kind (a height field with an ellipsoid, a cylinder or
another height field; an SDF with an ellipsoid, a cylinder, a mesh or a
height field) is refused by its name when the model is loaded.

Every narrowphase takes ``(pos1, mat1, size1, pos2, mat2, size2, margin)``
of a group's pairs, positions (B, P, 3), frames (B, P, 3, 3), sizes (P, 3)
and the pair's margin (P,), and returns (dist, pos, normal, yhint) with a
fixed slot count; empty slots have ``dist = 1e10``.
"""

from __future__ import annotations

import functools
import math as pymath
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Contact,
    Data,
    DisableBit,
    GeomType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex as cc
from mujoco_inversedynamicstest_tpu_torch.ops import collision_sdf as csdf
from mujoco_inversedynamicstest_tpu_torch.ops import flexcol, hfield
from mujoco_inversedynamicstest_tpu_torch.ops import math
from mujoco_inversedynamicstest_tpu_torch.ops.hull import HullSpec

_BIG = 1e10
# a convex group is run in chunks of lanes where its edge-pair axes would
# pass this many bytes (three tensors of (B, P, Ea, Eb, 3) live at once)
CONVEX_CHUNK_BYTES = 10 * 2**30

# contact slots per convex pair
_CONVEX_SLOTS = {
    (GeomType.PLANE, GeomType.MESH): cc.PLANE_MESH_SLOTS,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.CAPSULE, GeomType.MESH): 2,
    (GeomType.BOX, GeomType.BOX): 4,
    (GeomType.BOX, GeomType.MESH): 4,
    (GeomType.MESH, GeomType.MESH): 4,
}
# cylinder and ellipsoid pairs (ops/collision_sdf.py), height-field pairs
# (ops/hfield.py)
_SDF_SLOTS = {(GeomType(a), GeomType(b)): k
              for (a, b), k in csdf.SDF_SLOTS.items()}
_HFIELD_SLOTS = {(GeomType(a), GeomType(b)): k
                 for (a, b), k in hfield.HFIELD_SLOTS.items()}
# SDF plugin geoms (ops/collision_sdf.py make_plugin_narrowphase)
_SDF_PLUGIN_SLOTS = {(GeomType(t), GeomType.SDF): csdf.SDF_PLUGIN_SLOTS
                     for t in (GeomType.PLANE, GeomType.SPHERE,
                               GeomType.CAPSULE, GeomType.BOX, GeomType.SDF)}


class PairGroup(NamedTuple):
  """Same-type geom pairs sharing one condim and, for the convex pairs,
  one hull topology (mesh ids ``did1``/``did2``, -1 for a box or a
  primitive), all static.  ``ipair`` is each pair's explicit ``<pair>``
  (-1 for a pair of the contype/conaffinity rule); ``npair_run`` pairs of
  each lane go to the narrowphase, all of them unless ``max_geom_pairs``
  caps the group."""
  types: Tuple[int, int]
  geom1: np.ndarray
  geom2: np.ndarray
  nslot: int
  condim: int
  did1: int = -1
  did2: int = -1
  ipair: np.ndarray = None
  npair_run: int = 0


class ContactLayout(NamedTuple):
  """Static contact-slot layout of a model.

  ``dim`` is the condim of each slot the rows see.  Without a budget that
  selects lane by lane, ``geom1``/``geom2`` are each slot's geoms; with one
  (``lane_slots``) they are -1 and the geoms are lane data of
  ``Data.contact``.  ``reduce_groups`` holds, per condim, the candidate
  slots (of ``ncon_full``) and how many of them ``max_contact_points``
  keeps; it is empty without that numeric."""
  groups: Tuple[PairGroup, ...]
  ncon: int
  dim: np.ndarray           # condim per slot
  geom1: np.ndarray         # per slot
  geom2: np.ndarray
  ncon_full: int = 0
  reduce_groups: tuple = ()
  lane_slots: bool = False
  # flex element contact groups (ops/flexcol.py), after the geom pairs
  elem_groups: tuple = ()


def _dist_pos(p1, nrm, p2, r):
  """Plane (point p1, normal nrm) against a sphere (p2, r)."""
  dist = torch.sum((p2 - p1) * nrm, dim=-1) - r
  return dist, p2 - nrm * (r + 0.5 * dist)[..., None]


def _plane_sphere(p1, m1, s1, p2, m2, s2, margin):
  nrm = m1[..., :, 2]
  dist, pos = _dist_pos(p1, nrm, p2, s2[..., 0])
  return dist[..., None], pos[..., None, :], nrm[..., None, :], torch.zeros_like(
      pos)[..., None, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2, margin):
  nrm = m1[..., :, 2]
  axis = m2[..., :, 2]
  seg = axis * s2[..., 1:2]
  d1, c1 = _dist_pos(p1, nrm, p2 + seg, s2[..., 0])
  d2, c2 = _dist_pos(p1, nrm, p2 - seg, s2[..., 0])
  return (torch.stack([d1, d2], -1), torch.stack([c1, c2], -2),
          torch.stack([nrm, nrm], -2), torch.stack([axis, axis], -2))


def _sphere_sphere_raw(p1, r1, p2, r2, fallback_n):
  dif = p2 - p1
  length = math.norm_safe(dif)
  dist = length - r1 - r2
  n = torch.where((length < math.MINVAL)[..., None], fallback_n,
                  dif / length[..., None])
  pos = p1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _one_slot(dist, pos, n):
  return (dist[..., None], pos[..., None, :], n[..., None, :],
          torch.zeros_like(pos)[..., None, :])


def _sphere_sphere(p1, m1, s1, p2, m2, s2, margin):
  fb = math.normalize(math.cross(m1[..., :, 2], m2[..., :, 2]))
  return _one_slot(*_sphere_sphere_raw(p1, s1[..., 0], p2, s2[..., 0], fb))


def _sphere_capsule(p1, m1, s1, p2, m2, s2, margin):
  axis = m2[..., :, 2]
  x = torch.sum(axis * (p1 - p2), dim=-1)
  x = torch.minimum(torch.maximum(x, -s2[..., 1]), s2[..., 1])
  near = p2 + axis * x[..., None]
  fb = math.normalize(math.cross(m1[..., :, 2], axis))
  return _one_slot(*_sphere_sphere_raw(p1, s1[..., 0], near, s2[..., 0], fb))


def _capsule_capsule(p1, m1, s1, p2, m2, s2, margin):
  """Closest points of the two segments (generic path of
  ``mjraw_CapsuleCapsule``; exactly parallel capsules give one contact)."""
  a1 = m1[..., :, 2] * s1[..., 1:2]
  a2 = m2[..., :, 2] * s2[..., 1:2]
  dif = p1 - p2
  dot = lambda a, b: torch.sum(a * b, dim=-1)
  ma, mb, mc = dot(a1, a1), -dot(a1, a2), dot(a2, a2)
  u, v = -dot(a1, dif), dot(a2, dif)
  det = ma * mc - mb * mb
  par = torch.abs(det) < math.MINVAL
  det_safe = torch.where(par, 1.0, det)

  x1 = (mc * u - mb * v) / det_safe
  x2 = (ma * v - mb * u) / det_safe
  x2 = torch.where(x1 > 1, (v - mb) / mc,
                   torch.where(x1 < -1, (v + mb) / mc, x2))
  x1 = torch.clamp(x1, -1, 1)
  x1 = torch.where(x2 > 1, torch.clamp((u - mb) / ma, -1, 1),
                   torch.where(x2 < -1, torch.clamp((u + mb) / ma, -1, 1), x1))
  x2 = torch.clamp(x2, -1, 1)
  x1 = torch.where(par, 1.0, x1)
  x2 = torch.where(par, torch.clamp((v - mb) / mc, -1, 1), x2)

  q1 = p1 + a1 * x1[..., None]
  q2 = p2 + a2 * x2[..., None]
  fb = math.normalize(math.cross(m1[..., :, 2], m2[..., :, 2]))
  return _one_slot(*_sphere_sphere_raw(q1, s1[..., 0], q2, s2[..., 0], fb))


@functools.lru_cache(maxsize=None)
def _box_signs(dtype, device) -> torch.Tensor:
  """The 8 corners of the unit box, (8, 3), made once a device."""
  return torch.tensor([[(1.0 if i & 1 else -1.0), (1.0 if i & 2 else -1.0),
                        (1.0 if i & 4 else -1.0)] for i in range(8)],
                      dtype=dtype, device=device)


def _plane_box(p1, m1, s1, p2, m2, s2, margin):
  """All 8 corners; the 4 with the smallest plane distance among those
  pointing down and within the margin (C's ``mjc_PlaneBox`` keeps at most
  4 bottom corners)."""
  nrm = m1[..., :, 2]
  dist0 = torch.sum((p2 - p1) * nrm, dim=-1)
  corners = (_box_signs(p1.dtype, p1.device) * s2[..., None, :]) @ m2.transpose(-1, -2)  # (..., 8, 3)
  ldist = (corners @ nrm[..., None])[..., 0]
  cdist = dist0[..., None] + ldist
  valid = (ldist <= 0) & (cdist <= margin[..., None])
  score = torch.where(valid, cdist, _BIG)
  _, idx = torch.topk(-score, 4, dim=-1)
  dist = torch.where(torch.take_along_dim(valid, idx, dim=-1),
                     torch.take_along_dim(cdist, idx, dim=-1), _BIG)
  pos = (torch.take_along_dim(corners, idx[..., None], dim=-2)
         + p2[..., None, :] - nrm[..., None, :] * (dist[..., None] * 0.5))
  n = nrm[..., None, :].expand_as(pos)
  return dist, pos, n, torch.zeros_like(pos)


def _plane_cylinder(p1, m1, s1, p2, m2, s2, margin):
  """Nearest rim point, the axially opposite rim point and two flanking
  side points (C's ``mjc_PlaneCylinder``), each gated by its own margin
  test and by C's early exit on the first point."""
  nrm = m1[..., :, 2]
  axis = m2[..., :, 2]
  r, hh = s2[..., 0], s2[..., 1]
  prjaxis = torch.sum(nrm * axis, dim=-1)
  # axis points towards the plane
  axis = torch.where((prjaxis > 0)[..., None], -axis, axis)
  prjaxis = -torch.abs(prjaxis)

  dist0 = torch.sum((p2 - p1) * nrm, dim=-1)

  # radial direction: -normal with the axis component removed
  vec = axis * prjaxis[..., None] - nrm
  len_sqr = torch.sum(vec * vec, dim=-1)
  vec_disk = m2[..., :, 0] * r[..., None]  # disk parallel to plane
  scl = r / torch.sqrt(torch.clamp(len_sqr, min=1e-30))
  vec = torch.where((len_sqr >= 1e-24)[..., None], vec * scl[..., None],
                    vec_disk)

  prjvec = torch.sum(vec * nrm, dim=-1)
  haxis = axis * hh[..., None]
  prjaxis_h = prjaxis * hh

  d1 = dist0 + prjaxis_h + prjvec          # nearest rim point
  d2 = dist0 - prjaxis_h + prjvec          # opposite rim point
  prjvec1 = -prjvec * 0.5
  d34 = dist0 + prjaxis_h + prjvec1        # flanking pair (shared depth)

  half = lambda d: nrm * (d * 0.5)[..., None]
  pos1 = p2 + vec + haxis - half(d1)
  pos2 = p2 + vec - haxis - half(d2)
  side = math.cross(vec, axis)
  side = side / torch.clamp(torch.linalg.norm(side, dim=-1),
                            min=1e-15)[..., None]
  side = side * (r * (pymath.sqrt(3.0) / 2))[..., None]
  base34 = p2 + haxis - vec * 0.5 - half(d34)

  gate1 = d1 <= margin                      # C's early exit
  gate34 = gate1 & (d34 <= margin)
  dist = torch.stack([
      torch.where(gate1, d1, _BIG),
      torch.where(gate1 & (d2 <= margin), d2, _BIG),
      torch.where(gate34, d34, _BIG),
      torch.where(gate34, d34, _BIG),
  ], dim=-1)
  pos = torch.stack([pos1, pos2, base34 + side, base34 - side], dim=-2)
  n = nrm[..., None, :].expand_as(pos)
  return dist, pos, n, torch.zeros_like(pos)


def _sphere_box(p1, m1, s1, p2, m2, s2, margin):
  """C's ``mjraw_SphereBox``: the outside branch from the clamped centre,
  the inside branch through the nearest face.  Inside, the normal (sphere
  to box) points into the box from that face, and the point lies half the
  overlap inward from the centre, as in C; the JAX package's inside branch
  has both with the opposite sign (ROADMAP §3)."""
  r = s1[..., 0]
  m2t = m2.transpose(-1, -2)
  center = math.matvec(m2t, p1 - p2)
  clamped = torch.minimum(torch.maximum(center, -s2), s2)
  tmp = clamped - center
  d_out = math.norm_safe(tmp)

  # outside branch
  n_out_local = tmp / d_out[..., None]
  deepest = center + n_out_local * r[..., None]
  pos_out = 0.5 * (clamped + deepest)
  dist_out = d_out - r

  # inside branch: nearest face, +x,+y,+z,-x,-y,-z
  face_dists = torch.cat([s2 - center, s2 + center], dim=-1)
  k = torch.argmin(face_dists, dim=-1)
  closest = torch.take_along_dim(face_dists, k[..., None], dim=-1)[..., 0]
  sign = torch.where(k < 3, 1.0, -1.0).to(p1.dtype)
  axis = (torch.arange(3, device=k.device) == (k % 3)[..., None]).to(
      p1.dtype) * sign[..., None]
  pos_in = center - axis * ((r - closest) / 2)[..., None]
  dist_in = -closest - r

  inside = d_out <= math.MINVAL
  dist = torch.where(inside, dist_in, dist_out)
  pos_local = torch.where(inside[..., None], pos_in, pos_out)
  n_local = torch.where(inside[..., None], -axis, n_out_local)
  return _one_slot(dist, math.matvec(m2, pos_local) + p2,
                   math.matvec(m2, n_local))


_NARROWPHASE = {
    (GeomType.PLANE, GeomType.SPHERE): (_plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (_plane_capsule, 2),
    (GeomType.PLANE, GeomType.BOX): (_plane_box, 4),
    (GeomType.PLANE, GeomType.CYLINDER): (_plane_cylinder, 4),
    (GeomType.SPHERE, GeomType.SPHERE): (_sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (_sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.BOX): (_sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (_capsule_capsule, 1),
}


# the pairs of a closed-form narrowphase, whose nearest contact at margin =
# distmax is C's mj_geomDistance: the distance sensors' pairs.  The descent
# and hull pairs stop where their contact search does, which C's distance
# routines do not: validate_model refuses distance sensors over them
DISTANCE_PAIRS = frozenset(_NARROWPHASE)


def geom_distance(m: Model, d: Data, geom1: np.ndarray, geom2: np.ndarray,
                  distmax: torch.Tensor):
  """Smallest signed distances (B, K) between K geom pairs (host ids) and
  the segments (B, K, 6) from the first geom's surface to the second's
  (``mj_geomDistance``): each pair's narrowphase at margin ``distmax``
  (K,), its nearest contact, the first of equal ones; where none lies
  within ``distmax``, ``distmax`` and zeros.  One call a pair kind."""
  types = m.geom_type
  flip = types[geom1] > types[geom2]
  a, b = np.where(flip, geom2, geom1), np.where(flip, geom1, geom2)
  kinds = np.stack([types[a], types[b]], axis=1)
  order, dists, fromtos = [], [], []
  for kind in np.unique(kinds, axis=0):
    ks = np.nonzero((kinds == kind).all(1))[0]
    key = (GeomType(int(kind[0])), GeomType(int(kind[1])))
    if key not in DISTANCE_PAIRS:
      raise NotImplementedError(
          f"unsupported by the PyTorch port: geom distance over the pair "
          f"{key[0].name}-{key[1].name}")
    ga, gb, kk = m.const(a[ks]), m.const(b[ks]), m.const(ks)
    margin = distmax[kk]
    dist, pos, nrm, _ = _NARROWPHASE[key][0](
        d.geom_xpos[:, ga], d.geom_xmat[:, ga], m.geom_size[ga],
        d.geom_xpos[:, gb], d.geom_xmat[:, gb], m.geom_size[gb], margin)
    j = torch.argmin(dist, dim=-1, keepdim=True)
    dmin = torch.take_along_dim(dist, j, dim=-1)[..., 0]
    p = torch.take_along_dim(pos, j[..., None], dim=-2)[..., 0, :]
    # the normal from the first geom to the second
    n = torch.take_along_dim(nrm, j[..., None], dim=-2)[..., 0, :] * m.const(
        np.where(flip[ks], -1.0, 1.0))[:, None]
    found = dmin < margin
    half = (0.5 * dmin)[..., None] * n
    dists.append(torch.where(found, dmin, margin))
    fromtos.append(torch.where(found[..., None],
                               torch.cat([p - half, p + half], dim=-1), 0.0))
    order.append(ks)
  inv = m.const(np.argsort(np.concatenate(order)))
  return torch.cat(dists, dim=1)[:, inv], torch.cat(fromtos, dim=1)[:, inv]


def _nslot(key) -> int:
  if key in _NARROWPHASE:
    return _NARROWPHASE[key][1]
  for table in (_CONVEX_SLOTS, _SDF_SLOTS, _HFIELD_SLOTS, _SDF_PLUGIN_SLOTS):
    if key in table:
      return table[key]
  raise NotImplementedError(
      f"unsupported by the PyTorch port: collision pair "
      f"{key[0].name}-{key[1].name}")


def device_hull(m: Model, spec: HullSpec) -> HullSpec:
  """The hull's tables on the model's device, made once."""
  return HullSpec(*(m.const(a) for a in spec))


def _group_narrowphase(m: Model, grp: PairGroup) -> Callable:
  """The narrowphase of a pair group: a primitive, or for the convex keys
  a closure over the group's hulls (``ops/collision_convex.py``)."""
  if grp.types in _NARROWPHASE:
    return _NARROWPHASE[grp.types][0]
  if grp.types in _SDF_SLOTS:
    return csdf.SDF_NARROWPHASE[(int(grp.types[0]), int(grp.types[1]))]

  def build():
    t1, t2 = grp.types
    if t2 == GeomType.SDF:
      return csdf.make_plugin_narrowphase(m, grp)
    if t1 == GeomType.HFIELD:
      return hfield.make_narrowphase(m, grp)
    if t1 == GeomType.PLANE:        # a mesh: a box is a primitive pair
      # C's rule reads the mesh geom's bounding radius, the mesh's own
      rbound = np.unique(m.geom_rbound_np[grp.geom2])
      if len(rbound) != 1:
        raise NotImplementedError(
            "unsupported by the PyTorch port: geoms of one mesh with "
            f"different bounding radii {rbound}")
      return cc.make_plane_mesh(m.mesh_graph[grp.did2], float(rbound[0]))

    def hull_of(did, t):
      spec = cc.BOX_HULL if t == GeomType.BOX else m.mesh_hull[did]
      return device_hull(m, spec), t == GeomType.BOX

    if t1 == GeomType.SPHERE:
      return cc.make_sphere_convex(*hull_of(grp.did2, t2))
    if t1 == GeomType.CAPSULE:
      return cc.make_capsule_convex(*hull_of(grp.did2, t2))
    return cc.make_convex_convex(*hull_of(grp.did1, t1),
                                 *hull_of(grp.did2, t2))

  # an SDF group's box is its first pair's (the JAX package's rule)
  first = (int(grp.geom1[0]),) if grp.types[1] == GeomType.SDF else ()
  return m.memo(("narrowphase", grp.types, grp.did1, grp.did2) + first,
                build)


def _lane_chunks(m: Model, grp: PairGroup, batch: int, itemsize: int) -> int:
  """How many lane chunks a group runs in: one, unless the edge-pair axes
  of a hull-hull group would pass ``CONVEX_CHUNK_BYTES``."""
  t1, t2 = grp.types
  if t1 not in (GeomType.BOX, GeomType.MESH):
    return 1
  nedge = lambda did, t: len(cc.BOX_HULL.edge if t == GeomType.BOX
                             else m.mesh_hull[did].edge)
  nbytes = (3 * batch * grp.npair_run * nedge(grp.did1, t1)
            * nedge(grp.did2, t2) * 3 * itemsize)
  return max(1, min(batch, -(-nbytes // CONVEX_CHUNK_BYTES)))


def _build_layout(m: Model) -> ContactLayout:
  empty = np.zeros(0, np.int64)
  if m.opt.disableflags & (DisableBit.CONTACT | DisableBit.CONSTRAINT):
    return ContactLayout((), 0, empty, empty, empty)

  # explicit <pair>s first, with their own condim; they bypass every filter
  raw = [(int(a), int(b), k, int(c)) for k, (a, b, c) in enumerate(
      zip(m.pair_geom1, m.pair_geom2, m.pair_dim))]
  ng = m.ngeom
  tri1, tri2 = np.triu_indices(ng, k=1)
  b1, b2 = m.geom_bodyid[tri1], m.geom_bodyid[tri2]
  w1, w2 = m.body_weldid[b1], m.body_weldid[b2]
  keep = (b1 != b2) & (w1 != w2)
  if len(m.exclude_signature):
    # C's exclude_signature holds body ids, (body1 << 16) + body2, and C
    # tests it against the bodies of the geoms (the JAX package tests weld
    # ids)
    sig = (b1 << 16) + b2
    gis = (b2 << 16) + b1
    keep &= ~np.isin(sig, m.exclude_signature) & ~np.isin(
        gis, m.exclude_signature)
  if not m.opt.disableflags & DisableBit.FILTERPARENT:
    pw1 = m.body_weldid[m.body_parentid[w1]]
    pw2 = m.body_weldid[m.body_parentid[w2]]
    keep &= ~(((w1 == pw2) & (w1 != 0)) | ((w2 == pw1) & (w2 != 0)))
  keep &= ((m.geom_contype[tri1] & m.geom_conaffinity[tri2])
           | (m.geom_contype[tri2] & m.geom_conaffinity[tri1])) != 0
  if m.flex is not None and m.flex.nvert and np.any(m.geom_flexid >= 0):
    keep &= _flex_vertex_pairs(m, tri1, tri2)
  if len(m.pair_geom1):
    # a geom pair that a <pair> names collides once, as the <pair>
    ex1 = np.concatenate([m.pair_geom1, m.pair_geom2])
    ex2 = np.concatenate([m.pair_geom2, m.pair_geom1])
    keep &= ~np.isin(tri1 * ng + tri2, ex1 * ng + ex2)
  p1, p2 = m.geom_priority[tri1], m.geom_priority[tri2]
  cd = np.where(p1 > p2, m.geom_condim[tri1],
                np.where(p2 > p1, m.geom_condim[tri2],
                         np.maximum(m.geom_condim[tri1], m.geom_condim[tri2])))
  raw += [(int(g1), int(g2), -1, int(c))
          for g1, g2, c in zip(tri1[keep], tri2[keep], cd[keep])]

  by_key = {}
  for g1, g2, ip, c in raw:
    if m.geom_type[g1] > m.geom_type[g2]:
      g1, g2 = g2, g1
    key = (GeomType(int(m.geom_type[g1])), GeomType(int(m.geom_type[g2])))
    _nslot(key)
    # each convex group has one static hull topology, each height-field
    # group one grid, each SDF group one SDF geom (its plugin, mesh frame
    # and box)
    did = lambda g: (int(m.geom_dataid[g]) if m.geom_type[g] in (
        GeomType.MESH, GeomType.HFIELD) else int(g)
                     if m.geom_type[g] == GeomType.SDF else -1)
    by_key.setdefault((key, did(g1), did(g2), c), []).append((g1, g2, ip))

  elem_groups = flexcol.build_elem_groups(m)
  if m.flex is not None:
    _refuse_flex_margins(m, raw, elem_groups)
  groups, slot_dim = [], []
  for key, did1, did2, condim in sorted(by_key):
    pairs = np.array(by_key[(key, did1, did2, condim)], np.int64)
    nslot = _nslot(key)
    run = len(pairs)
    if m.max_geom_pairs > 0:
      run = min(run, m.max_geom_pairs)
    groups.append(PairGroup(key, pairs[:, 0], pairs[:, 1], nslot, condim,
                            did1, did2, pairs[:, 2], run))
    slot_dim += [condim] * (run * nslot)
  for eg in elem_groups:
    slot_dim += [eg.condim] * (eg.npair_run * eg.nslot)
  full_dim = np.array(slot_dim, np.int64)
  # a flex element slot's geoms and bodies are lane data
  lane_slots = bool(elem_groups) or any(g.npair_run < len(g.geom1)
                                        for g in groups)

  # max_contact_points keeps the nearest slots of each condim
  reduce_groups, dim = (), full_dim
  if m.max_contact_points > 0 and len(full_dim):
    reduce_groups = tuple(
        (int(c), idx, min(len(idx), m.max_contact_points))
        for c in np.unique(full_dim)
        for idx in (np.nonzero(full_dim == c)[0],))
    dim = np.concatenate([np.full(k, c, np.int64)
                          for c, _, k in reduce_groups])
    if all(k == len(idx) for _, idx, k in reduce_groups):
      reduce_groups, dim = (), full_dim
    lane_slots |= bool(reduce_groups)

  if lane_slots:
    slot_g1 = slot_g2 = np.full(len(dim), -1, np.int64)
  else:
    slot_g1 = np.concatenate([empty] + [np.repeat(g.geom1, g.nslot)
                                        for g in groups])
    slot_g2 = np.concatenate([empty] + [np.repeat(g.geom2, g.nslot)
                                        for g in groups])
  return ContactLayout(tuple(groups), len(dim), dim, slot_g1, slot_g2,
                       len(full_dim), reduce_groups, lane_slots, elem_groups)


def _flex_vertex_pairs(m: Model, tri1: np.ndarray,
                       tri2: np.ndarray) -> np.ndarray:
  """Which candidate geom pairs the flex vertex geoms keep: none of one
  flex with itself (its self-collision is element pairs), and none of a
  flex vertex with a geom that collides with the flex's elements."""
  f1, f2 = m.geom_flexid[tri1], m.geom_flexid[tri2]
  keep = ~((f1 >= 0) & (f1 == f2))
  one_flex = (f1 >= 0) != (f2 >= 0)
  partner = np.where(f1 >= 0, m.geom_type[tri2], m.geom_type[tri1])
  dim = m.flex.dim[np.maximum(np.where(f1 >= 0, f1, f2), 0)]
  elem_level = np.isin(partner, flexcol.ELEM_PARTNER_TYPES) & (dim >= 1)
  elem_level &= ~np.isin(partner, flexcol.SMOOTH_PARTNER_TYPES) | (dim == 2)
  return keep & ~(one_flex & elem_level)


def _refuse_flex_margins(m: Model, raw: list, elem_groups: tuple) -> None:
  """Refuses a contact margin or gap on a geom that collides with a flex
  (its vertex geoms or its elements): C 3.10's rule for mixing them with
  a flex's is not the JAX package's, and the port follows neither
  unchecked."""
  gflex = m.geom_flexid
  partners = [g for g1, g2, _, _ in raw for g in (g1, g2)
              if (gflex[g1] >= 0) != (gflex[g2] >= 0) and gflex[g] < 0]
  partners += [int(g) for eg in elem_groups
               if eg.kind in ("geom_elem", "plane_vert")
               for g in np.unique(eg.pair_geom)]
  if not partners:
    return
  partners = np.unique(partners)
  if (np.any(m.geom_margin.cpu().numpy()[partners] != 0)
      or np.any(m.geom_gap.cpu().numpy()[partners] != 0)):
    raise NotImplementedError(
        "unsupported by the PyTorch port: a contact margin or gap on a geom "
        "that collides with a flex")


def contact_layout(m: Model) -> ContactLayout:
  """The static candidate pair set and contact slots of ``m``."""
  return m.memo("contact_layout", lambda: _build_layout(m))


def make_frame(normal: torch.Tensor, yhint: torch.Tensor) -> torch.Tensor:
  """Contact frame from its normal (``mju_makeFrame``); rows [n, t1, t2]."""
  n = math.normalize(normal)
  have_hint = math.norm_safe(yhint) >= 0.5
  ey = torch.zeros_like(n)
  ey[..., 1] = 1.0
  ez = torch.zeros_like(n)
  ez[..., 2] = 1.0
  y_default = torch.where(torch.abs(n[..., 1:2]) < 0.5, ey, ez)
  y = torch.where(have_hint[..., None], yhint, y_default)
  y = math.normalize(y - n * torch.sum(n * y, dim=-1, keepdim=True))
  return torch.stack([n, y, math.cross(n, y)], dim=-2)


def mix_params(m: Model, p1: np.ndarray, p2: np.ndarray, s1, s2, sr1, sr2,
               si1, si2, f1, f2):
  """``mj_contactParam``'s mixing of two sides' parameters, per pair:
  (friction5, solref, solimp).  p: priorities (host), s: solmix, sr:
  solref, si: solimp, f: friction (3); the higher priority's own, else
  solmix-weighted solref (the smaller of two where either is direct) and
  solimp, the larger friction."""
  mix = torch.where(
      (s1 >= math.MINVAL) & (s2 >= math.MINVAL),
      s1 / torch.clamp(s1 + s2, min=math.MINVAL),
      torch.where((s1 < math.MINVAL) & (s2 < math.MINVAL), 0.5,
                  torch.where(s1 < math.MINVAL, 0.0, 1.0)))
  use1 = m.const(p1 > p2)[:, None]
  use2 = m.const(p1 < p2)[:, None]
  mix = torch.where(use1[:, 0], 1.0, torch.where(use2[:, 0], 0.0, mix))
  mix = mix[:, None]
  both_std = ((sr1[:, 0] > 0) & (sr2[:, 0] > 0))[:, None]
  solref = torch.where(use1, sr1, torch.where(use2, sr2, torch.where(
      both_std, mix * sr1 + (1 - mix) * sr2, torch.minimum(sr1, sr2))))
  solimp = torch.where(use1, si1, torch.where(
      use2, si2, mix * si1 + (1 - mix) * si2))
  fri3 = torch.where(use1, f1, torch.where(use2, f2, torch.maximum(f1, f2)))
  return fri3[:, m.const(np.array([0, 0, 1, 2, 2]))], solref, solimp


def _pair_params(m: Model, grp: PairGroup):
  """Mixed contact parameters of a pair group (``mj_contactParam``):
  (margin, friction5, solref, solreffriction, solimp), each per pair.  An
  explicit ``<pair>`` gives its own margin, friction, solref,
  solreffriction and solimp; a mixed pair has no solreffriction (0, 0).
  As in C MuJoCo 3.10, a contact's includemargin is its margin: no gap is
  subtracted."""
  g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
  friction5, solref, solimp = mix_params(
      m, m.geom_priority[grp.geom1], m.geom_priority[grp.geom2],
      m.geom_solmix[g1], m.geom_solmix[g2], m.geom_solref[g1],
      m.geom_solref[g2], m.geom_solimp[g1], m.geom_solimp[g2],
      m.geom_friction[g1], m.geom_friction[g2])
  # C 3.10 adds the two geoms' margins and makes a row of every contact
  # within the margin, whatever the gap (the JAX package takes the larger
  # margin and subtracts the larger gap: ROADMAP §3)
  margin = m.geom_margin[g1] + m.geom_margin[g2]
  solreffriction = torch.zeros_like(solref)
  is_pair = grp.ipair >= 0
  if np.any(is_pair):
    sel = m.const(is_pair)
    ip = m.const(np.where(is_pair, grp.ipair, 0))
    pick = lambda own, mixed: torch.where(
        sel.reshape((-1,) + (1,) * (mixed.ndim - 1)), own[ip], mixed)
    margin = pick(m.pair_margin, margin)
    friction5 = pick(m.pair_friction, friction5)
    solref, solimp = pick(m.pair_solref, solref), pick(m.pair_solimp, solimp)
    solreffriction = pick(m.pair_solreffriction, solreffriction)
  return margin, friction5, solref, solreffriction, solimp


def group_params(m: Model) -> tuple:
  """Each pair group's ``_pair_params``, computed once."""
  return m.memo("group_params", lambda: tuple(
      _pair_params(m, g) for g in contact_layout(m).groups))


def elem_params(m: Model) -> tuple:
  """Each flex element group's ``flexcol.elem_pair_params``, computed
  once."""
  return m.memo("elem_params", lambda: tuple(
      flexcol.elem_pair_params(m, g)
      for g in contact_layout(m).elem_groups))


def slot_gaps(m: Model, con: Contact) -> torch.Tensor:
  """(B, ncon) each slot's gap: the two geoms' gaps added, or an explicit
  ``<pair>``'s own.  C 3.10 keeps a contact up to its margin plus its gap
  and makes rows of those within the margin (``includemargin``); under a
  contact budget the slots' geoms are lane data and their gaps are added
  whatever their pair."""
  lay = contact_layout(m)
  if lay.lane_slots:
    return m.geom_gap[con.geom1] + m.geom_gap[con.geom2]

  def build():
    gaps = []
    for g in lay.groups:
      gap = m.geom_gap[m.const(g.geom1)] + m.geom_gap[m.const(g.geom2)]
      if g.ipair is not None and np.any(g.ipair >= 0):
        gap = torch.where(m.const(g.ipair >= 0), m.pair_gap[m.const(
            np.maximum(g.ipair, 0))], gap)
      gaps.append(torch.repeat_interleave(gap, g.nslot))
    return torch.cat(gaps)

  return m.memo("slot_gaps", build).expand(con.dist.shape)


def group_margins(m: Model) -> tuple:
  """Each pair group's margin (P,), the narrowphase's argument."""
  return tuple(p[0] for p in group_params(m))


def contact_constants(m: Model):
  """Per-slot mixed parameters and geoms (includemargin, friction5, solref,
  solreffriction, solimp, geom1, geom2) of a layout without lane
  selection; lane-independent, computed once."""

  def build():
    lay = contact_layout(m)
    rep = lambda x, g: torch.repeat_interleave(x, g.nslot, dim=0)
    return tuple(torch.cat([rep(p[i], g) for p, g in zip(group_params(m),
                                                          lay.groups)])
                 for i in range(5)) + (m.const(lay.geom1),
                                       m.const(lay.geom2))

  return m.memo("contact_constants", build)


def _nearest_pairs(m: Model, d: Data, grp: PairGroup,
                   margin: torch.Tensor) -> torch.Tensor:
  """(B, npair_run): each lane's nearest candidates of a capped group by
  bounding-sphere distance less the pair's margin (a plane: the signed
  distance of the other geom's sphere), the broadphase of MJX's
  ``max_geom_pairs``.  A stable sort keeps the lower candidate of a tie,
  as XLA's ``top_k`` does, whatever the lane count."""
  g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
  p1, p2 = d.geom_xpos[:, g1], d.geom_xpos[:, g2]
  if grp.types[0] == GeomType.PLANE:
    bdist = (torch.sum((p2 - p1) * d.geom_xmat[:, g1, :, 2], dim=-1)
             - m.geom_rbound[g2])
  elif grp.types[0] == GeomType.HFIELD:
    # the field's bounding sphere from its extents (its geom_rbound is 0)
    bdist = (torch.linalg.vector_norm(p2 - p1, dim=-1)
             - m.hfield_grid[grp.did1].bound() - m.geom_rbound[g2])
  else:
    bdist = (torch.linalg.vector_norm(p2 - p1, dim=-1) - m.geom_rbound[g1]
             - m.geom_rbound[g2])
  order = torch.sort(bdist - margin, dim=-1, stable=True).indices
  return order[:, :grp.npair_run]


def lane_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x (B, n, ...) at the lane indices idx (B, k): (B, k, ...)."""
  return torch.take_along_dim(
      x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), dim=1)


def _nearest_slots(m: Model, lay: ContactLayout, dist, includemargin):
  """(B, ncon): each lane's kept slots of ``max_contact_points``, per
  condim the nearest by dist - includemargin, lower slots first in a
  tie."""
  score = dist - includemargin
  sels = []
  for _, idx, keep in lay.reduce_groups:
    idx_t = m.const(idx)
    order = torch.sort(score[:, idx_t], dim=-1, stable=True).indices
    sels.append(idx_t[order[:, :keep]])
  return torch.cat(sels, dim=1)


def collision(m: Model, d: Data) -> Data:
  """Runs every pair group's narrowphase into the static-shape contact set
  (``mj_collision``).  With a contact budget, each lane takes its own
  nearest pairs of a capped group to the narrowphase, and its own nearest
  slots of each condim (MJX's ``max_geom_pairs``, ``max_contact_points``).
  The slots' geoms and parameters are lane data either way: without lane
  selection they are the model's constants, expanded."""
  lay = contact_layout(m)
  if lay.ncon == 0:
    return d.replace(contact=None)
  bsz = d.batch
  lanes = lay.lane_slots
  dists, poss, frames, prms, geoms = [], [], [], [], []
  for grp, prm in zip(lay.groups, group_params(m)):
    fn = _group_narrowphase(m, grp)
    g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
    capped = grp.npair_run < len(grp.geom1)
    if capped:
      sel = _nearest_pairs(m, d, grp, prm[0])
      g1, g2, prm = g1[sel], g2[sel], tuple(p[sel] for p in prm)
      args = (lane_take(d.geom_xpos, g1), lane_take(d.geom_xmat, g1),
              m.geom_size[g1], lane_take(d.geom_xpos, g2),
              lane_take(d.geom_xmat, g2), m.geom_size[g2], prm[0])
    else:
      args = (d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1],
              d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2],
              prm[0])
      if lanes:
        prm = tuple(p.expand((bsz,) + p.shape) for p in prm)
        g1, g2 = g1.expand(bsz, -1), g2.expand(bsz, -1)
    chunks = _lane_chunks(m, grp, bsz, d.geom_xpos.element_size())
    if chunks == 1:
      dist, pos, nrm, yhint = fn(*args)
    else:
      # sizes and margin are lane data only in a capped group
      per_lane = (True, True, capped, True, True, capped, capped)
      split = [torch.tensor_split(a, chunks) if lane else (a,) * chunks
               for a, lane in zip(args, per_lane)]
      outs = [fn(*a) for a in zip(*split)]
      dist, pos, nrm, yhint = [torch.cat(o) for o in zip(*outs)]
    dists.append(dist.reshape(bsz, -1))
    poss.append(pos.reshape(bsz, -1, 3))
    frames.append(make_frame(nrm, yhint).reshape(bsz, -1, 3, 3))
    if lanes:
      rep = lambda x: torch.repeat_interleave(x, grp.nslot, dim=1)
      prms.append(tuple(rep(p) for p in prm))
      geoms.append((rep(g1), rep(g2)))
  bary = []
  if lay.elem_groups:
    # a geom slot's side is its geom's body at weight 1
    width = flexcol.bary_width(m)
    if geoms:
      body = m.const(m.geom_bodyid)
      bb = torch.stack([body[torch.cat([g[k] for g in geoms], 1)]
                        for k in (0, 1)], dim=2)[..., None]
      bw = torch.ones_like(bb, dtype=d.qpos.dtype)
      pad = (0, width - 1)
      bary.append((torch.nn.functional.pad(bb, pad),
                   torch.nn.functional.pad(bw, pad)))
    for eg, prm in zip(lay.elem_groups, elem_params(m)):
      ec = flexcol.run_elem_group(m, d, eg)
      dists.append(ec.dist)
      poss.append(ec.pos)
      frames.append(make_frame(ec.nrm, torch.zeros_like(ec.nrm)))
      if ec.sel is None:
        prm = tuple(p.expand((bsz,) + p.shape) for p in prm)
      else:
        prm = tuple(lane_take(p.expand((bsz,) + p.shape), ec.sel)
                    for p in prm)
      prms.append(tuple(torch.repeat_interleave(p, eg.nslot, dim=1)
                        for p in prm))
      geoms.append((ec.geom1, ec.geom2))
      bary.append((ec.bary_body, ec.bary_w))
  cat = lambda xs: torch.cat(xs, 1)
  dist, pos, frame = cat(dists), cat(poss), cat(frames)
  if not lanes:
    # the model's constants, seen as lane data (a view, no copy)
    fields = [x.expand((bsz,) + x.shape) for x in contact_constants(m)]
  else:
    fields = [cat(x) for x in zip(*prms)] + [cat(x) for x in zip(*geoms)]
  fields += [cat(x) for x in zip(*bary)] if bary else [None, None]
  if lay.reduce_groups:
    sel = _nearest_slots(m, lay, dist, fields[0])
    dist, pos, frame = (lane_take(x, sel) for x in (dist, pos, frame))
    fields = [None if x is None else lane_take(x, sel) for x in fields]
  (includemargin, friction, solref, solreffriction, solimp, g1, g2,
   bary_body, bary_w) = fields
  return d.replace(contact=Contact(
      dist=dist, pos=pos, frame=frame, includemargin=includemargin,
      friction=friction, solref=solref, solreffriction=solreffriction,
      solimp=solimp, geom1=g1, geom2=g2, bary_body=bary_body, bary_w=bary_w))
