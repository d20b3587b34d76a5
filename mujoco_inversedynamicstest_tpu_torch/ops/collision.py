"""Collision detection: static pair table + batched narrowphase.

Port of ``mujoco_inversedynamicstest_tpu/ops/collision.py`` for the
primitive pairs (plane with sphere, capsule, box and cylinder; sphere with
sphere, capsule and box; capsule-capsule) and the convex pairs of
``ops/collision_convex.py`` (plane, sphere, capsule, box and mesh against a
box or a mesh hull).  The candidate pairs are enumerated statically from
contype/conaffinity, body and parent filters and excludes; every contact
slot exists every step and ``dist >= includemargin`` marks it inactive.
Any other pair kind (ellipsoid; cylinder with anything but a plane; height
field; SDF) is refused by its name when the model is loaded.

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
from mujoco_inversedynamicstest_tpu_torch.ops import math
from mujoco_inversedynamicstest_tpu_torch.ops.hull import HullSpec

_BIG = 1e10
# a convex group is run in chunks of lanes where its edge-pair axes would
# pass this many bytes (three tensors of (B, P, Ea, Eb, 3) live at once)
CONVEX_CHUNK_BYTES = 10 * 2**30

# pairs whose kernels need hull topology (grouped per distinct mesh pair)
_CONVEX_KEYS = {
    (GeomType.PLANE, GeomType.MESH),
    (GeomType.SPHERE, GeomType.MESH),
    (GeomType.CAPSULE, GeomType.BOX),
    (GeomType.CAPSULE, GeomType.MESH),
    (GeomType.BOX, GeomType.BOX),
    (GeomType.BOX, GeomType.MESH),
    (GeomType.MESH, GeomType.MESH),
}
# contact slots per convex pair
_CONVEX_SLOTS = {
    (GeomType.PLANE, GeomType.MESH): 4,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.CAPSULE, GeomType.MESH): 2,
    (GeomType.BOX, GeomType.BOX): 4,
    (GeomType.BOX, GeomType.MESH): 4,
    (GeomType.MESH, GeomType.MESH): 4,
}


class PairGroup(NamedTuple):
  """Same-type geom pairs sharing one condim and, for the convex pairs,
  one hull topology (mesh ids ``did1``/``did2``, -1 for a box or a
  primitive), all static."""
  types: Tuple[int, int]
  geom1: np.ndarray
  geom2: np.ndarray
  nslot: int
  condim: int
  did1: int = -1
  did2: int = -1


class ContactLayout(NamedTuple):
  """Static contact-slot layout of a model."""
  groups: Tuple[PairGroup, ...]
  ncon: int
  dim: np.ndarray           # condim per slot
  geom1: np.ndarray         # per slot
  geom2: np.ndarray


def _dist_pos(p1, nrm, p2, r):
  """Plane (point p1, normal nrm) against a sphere (p2, r)."""
  dist = torch.sum((p2 - p1) * nrm, dim=-1) - r
  return dist, p2 - nrm * (r + 0.5 * dist)[..., None]


def _plane_sphere(p1, m1, s1, p2, m2, s2, margin):
  nrm = m1[..., :, 2]
  dist, pos = _dist_pos(p1, nrm, p2, s2[:, 0])
  return dist[..., None], pos[..., None, :], nrm[..., None, :], torch.zeros_like(
      pos)[..., None, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2, margin):
  nrm = m1[..., :, 2]
  axis = m2[..., :, 2]
  seg = axis * s2[:, 1:2]
  d1, c1 = _dist_pos(p1, nrm, p2 + seg, s2[:, 0])
  d2, c2 = _dist_pos(p1, nrm, p2 - seg, s2[:, 0])
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
  return _one_slot(*_sphere_sphere_raw(p1, s1[:, 0], p2, s2[:, 0], fb))


def _sphere_capsule(p1, m1, s1, p2, m2, s2, margin):
  axis = m2[..., :, 2]
  x = torch.sum(axis * (p1 - p2), dim=-1)
  x = torch.minimum(torch.maximum(x, -s2[:, 1]), s2[:, 1])
  near = p2 + axis * x[..., None]
  fb = math.normalize(math.cross(m1[..., :, 2], axis))
  return _one_slot(*_sphere_sphere_raw(p1, s1[:, 0], near, s2[:, 0], fb))


def _capsule_capsule(p1, m1, s1, p2, m2, s2, margin):
  """Closest points of the two segments (generic path of
  ``mjraw_CapsuleCapsule``; exactly parallel capsules give one contact)."""
  a1 = m1[..., :, 2] * s1[:, 1:2]
  a2 = m2[..., :, 2] * s2[:, 1:2]
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
  return _one_slot(*_sphere_sphere_raw(q1, s1[:, 0], q2, s2[:, 0], fb))


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


def _nslot(key) -> int:
  return (_NARROWPHASE[key][1] if key in _NARROWPHASE
          else _CONVEX_SLOTS[key])


def _device_hull(m: Model, spec: HullSpec) -> HullSpec:
  """The hull's tables on the model's device, made once."""
  return HullSpec(*(m.const(a) for a in spec))


def _group_narrowphase(m: Model, grp: PairGroup) -> Callable:
  """The narrowphase of a pair group: a primitive, or for the convex keys
  a closure over the group's hulls (``ops/collision_convex.py``)."""
  if grp.types in _NARROWPHASE:
    return _NARROWPHASE[grp.types][0]

  def build():
    t1, t2 = grp.types

    def hull_of(did, t):
      spec = cc.BOX_HULL if t == GeomType.BOX else m.mesh_hull[did]
      return _device_hull(m, spec), t == GeomType.BOX

    if t1 == GeomType.PLANE:
      return cc.make_plane_convex(*hull_of(grp.did2, t2))
    if t1 == GeomType.SPHERE:
      return cc.make_sphere_convex(*hull_of(grp.did2, t2))
    if t1 == GeomType.CAPSULE:
      return cc.make_capsule_convex(*hull_of(grp.did2, t2))
    return cc.make_convex_convex(*hull_of(grp.did1, t1),
                                 *hull_of(grp.did2, t2))

  return m.memo(("narrowphase", grp.types, grp.did1, grp.did2), build)


def _lane_chunks(m: Model, grp: PairGroup, batch: int, itemsize: int) -> int:
  """How many lane chunks a group runs in: one, unless the edge-pair axes
  of a hull-hull group would pass ``CONVEX_CHUNK_BYTES``."""
  t1, t2 = grp.types
  if t1 not in (GeomType.BOX, GeomType.MESH):
    return 1
  nedge = lambda did, t: len(cc.BOX_HULL.edge if t == GeomType.BOX
                             else m.mesh_hull[did].edge)
  nbytes = (3 * batch * len(grp.geom1) * nedge(grp.did1, t1)
            * nedge(grp.did2, t2) * 3 * itemsize)
  return max(1, min(batch, -(-nbytes // CONVEX_CHUNK_BYTES)))


def _build_layout(m: Model) -> ContactLayout:
  empty = np.zeros(0, np.int64)
  if m.opt.disableflags & (DisableBit.CONTACT | DisableBit.CONSTRAINT):
    return ContactLayout((), 0, empty, empty, empty)

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
  p1, p2 = m.geom_priority[tri1], m.geom_priority[tri2]
  cd = np.where(p1 > p2, m.geom_condim[tri1],
                np.where(p2 > p1, m.geom_condim[tri2],
                         np.maximum(m.geom_condim[tri1], m.geom_condim[tri2])))

  by_key = {}
  for g1, g2, c in zip(tri1[keep], tri2[keep], cd[keep]):
    if m.geom_type[g1] > m.geom_type[g2]:
      g1, g2 = g2, g1
    key = (GeomType(int(m.geom_type[g1])), GeomType(int(m.geom_type[g2])))
    if key not in _NARROWPHASE and key not in _CONVEX_KEYS:
      raise NotImplementedError(
          f"unsupported by the PyTorch port: collision pair "
          f"{key[0].name}-{key[1].name}")
    # each convex group has one static hull topology
    did = lambda g: (int(m.geom_dataid[g])
                     if m.geom_type[g] == GeomType.MESH else -1)
    by_key.setdefault((key, did(g1), did(g2), int(c)), []).append(
        (int(g1), int(g2)))

  groups, slot_dim, slot_g1, slot_g2 = [], [], [], []
  for key, did1, did2, condim in sorted(by_key):
    pairs = np.array(by_key[(key, did1, did2, condim)], np.int64)
    nslot = _nslot(key)
    groups.append(PairGroup(key, pairs[:, 0], pairs[:, 1], nslot, condim,
                            did1, did2))
    slot_dim += [condim] * (len(pairs) * nslot)
    slot_g1 += np.repeat(pairs[:, 0], nslot).tolist()
    slot_g2 += np.repeat(pairs[:, 1], nslot).tolist()

  return ContactLayout(tuple(groups), len(slot_dim),
                       np.array(slot_dim, np.int64),
                       np.array(slot_g1, np.int64), np.array(slot_g2, np.int64))


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


def _pair_params(m: Model, grp: PairGroup):
  """Mixed contact parameters of a pair group (``mj_contactParam``):
  (margin, includemargin, friction5, solref, solimp), each per pair."""
  g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
  p1 = m.geom_priority[grp.geom1]
  p2 = m.geom_priority[grp.geom2]
  s1, s2 = m.geom_solmix[g1], m.geom_solmix[g2]
  mix = torch.where(
      (s1 >= math.MINVAL) & (s2 >= math.MINVAL),
      s1 / torch.clamp(s1 + s2, min=math.MINVAL),
      torch.where((s1 < math.MINVAL) & (s2 < math.MINVAL), 0.5,
                  torch.where(s1 < math.MINVAL, 0.0, 1.0)))
  use1 = m.const(p1 > p2)[:, None]
  use2 = m.const(p1 < p2)[:, None]
  mix = torch.where(use1[:, 0], 1.0, torch.where(use2[:, 0], 0.0, mix))
  mix = mix[:, None]

  sr1, sr2 = m.geom_solref[g1], m.geom_solref[g2]
  both_std = ((sr1[:, 0] > 0) & (sr2[:, 0] > 0))[:, None]
  solref = torch.where(use1, sr1, torch.where(use2, sr2, torch.where(
      both_std, mix * sr1 + (1 - mix) * sr2, torch.minimum(sr1, sr2))))
  si1, si2 = m.geom_solimp[g1], m.geom_solimp[g2]
  solimp = torch.where(use1, si1, torch.where(
      use2, si2, mix * si1 + (1 - mix) * si2))
  f1, f2 = m.geom_friction[g1], m.geom_friction[g2]
  fri3 = torch.where(use1, f1, torch.where(use2, f2, torch.maximum(f1, f2)))
  friction5 = fri3[:, m.const(np.array([0, 0, 1, 2, 2]))]
  gap = torch.maximum(m.geom_gap[g1], m.geom_gap[g2])
  margin = torch.maximum(m.geom_margin[g1], m.geom_margin[g2])
  return margin, margin - gap, friction5, solref, solimp


def group_margins(m: Model) -> tuple:
  """Each pair group's margin (P,), the narrowphase's argument."""
  return m.memo("group_margins", lambda: tuple(
      _pair_params(m, g)[0] for g in contact_layout(m).groups))


def contact_constants(m: Model):
  """Per-slot mixed parameters (includemargin, friction5, solref,
  solimp); lane-independent, computed once."""

  def build():
    lay = contact_layout(m)
    parts = [_pair_params(m, g)[1:] for g in lay.groups]
    rep = lambda x, g: torch.repeat_interleave(x, g.nslot, dim=0)
    return tuple(torch.cat([rep(p[i], g) for p, g in zip(parts, lay.groups)])
                 for i in range(4))

  return m.memo("contact_constants", build)


def collision(m: Model, d: Data) -> Data:
  """Runs every pair group's narrowphase into the static-shape contact set
  (``mj_collision``)."""
  lay = contact_layout(m)
  if lay.ncon == 0:
    return d.replace(contact=None)
  dists, poss, frames = [], [], []
  bsz = d.batch
  for grp, margin in zip(lay.groups, group_margins(m)):
    fn = _group_narrowphase(m, grp)
    g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
    args = (d.geom_xpos[:, g1], d.geom_xmat[:, g1], d.geom_xpos[:, g2],
            d.geom_xmat[:, g2])
    chunks = _lane_chunks(m, grp, bsz, d.geom_xpos.element_size())
    outs = [fn(p1, m1, m.geom_size[g1], p2, m2, m.geom_size[g2], margin)
            for p1, m1, p2, m2 in zip(*(torch.tensor_split(a, chunks)
                                        for a in args))]
    dist, pos, nrm, yhint = (outs[0] if chunks == 1 else
                             [torch.cat(o) for o in zip(*outs)])
    dists.append(dist.reshape(bsz, -1))
    poss.append(pos.reshape(bsz, -1, 3))
    frames.append(make_frame(nrm, yhint).reshape(bsz, -1, 3, 3))
  includemargin, friction, solref, solimp = contact_constants(m)
  return d.replace(contact=Contact(
      dist=torch.cat(dists, 1), pos=torch.cat(poss, 1),
      frame=torch.cat(frames, 1), includemargin=includemargin,
      friction=friction, solref=solref, solimp=solimp,
      geom1=lay.geom1, geom2=lay.geom2))
