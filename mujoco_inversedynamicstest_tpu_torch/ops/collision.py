"""Collision detection: static pair table + batched primitive narrowphase.

Port of ``mujoco_inversedynamicstest_tpu/ops/collision.py`` for the pair
kinds the humanoid uses: plane-sphere, plane-capsule, sphere-sphere,
sphere-capsule and capsule-capsule.  The candidate pairs are enumerated
statically from contype/conaffinity, body and parent filters and excludes;
every contact slot exists every step and ``dist >= includemargin`` marks it
inactive.  Any other pair kind is refused when the model is loaded.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Contact,
    Data,
    DisableBit,
    GeomType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import math


class PairGroup(NamedTuple):
  """Same-type geom pairs sharing one condim (static)."""
  types: Tuple[int, int]
  geom1: np.ndarray
  geom2: np.ndarray
  nslot: int
  condim: int


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


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  nrm = m1[..., :, 2]
  dist, pos = _dist_pos(p1, nrm, p2, s2[:, 0])
  return dist[..., None], pos[..., None, :], nrm[..., None, :], torch.zeros_like(
      pos)[..., None, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2):
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


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  fb = math.normalize(math.cross(m1[..., :, 2], m2[..., :, 2]))
  return _one_slot(*_sphere_sphere_raw(p1, s1[:, 0], p2, s2[:, 0], fb))


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis = m2[..., :, 2]
  x = torch.sum(axis * (p1 - p2), dim=-1)
  x = torch.minimum(torch.maximum(x, -s2[:, 1]), s2[:, 1])
  near = p2 + axis * x[..., None]
  fb = math.normalize(math.cross(m1[..., :, 2], axis))
  return _one_slot(*_sphere_sphere_raw(p1, s1[:, 0], near, s2[:, 0], fb))


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
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


_NARROWPHASE = {
    (GeomType.PLANE, GeomType.SPHERE): (_plane_sphere, 1),
    (GeomType.PLANE, GeomType.CAPSULE): (_plane_capsule, 2),
    (GeomType.SPHERE, GeomType.SPHERE): (_sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (_sphere_capsule, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (_capsule_capsule, 1),
}


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
    sig = (w1 << 16) | w2
    gis = (w2 << 16) | w1
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
    key = (int(m.geom_type[g1]), int(m.geom_type[g2]))
    if key not in _NARROWPHASE:
      raise NotImplementedError(
          f"unsupported by the PyTorch port: collision pair "
          f"{GeomType(key[0]).name}-{GeomType(key[1]).name}")
    by_key.setdefault((key, int(c)), []).append((int(g1), int(g2)))

  groups, slot_dim, slot_g1, slot_g2 = [], [], [], []
  for key, condim in sorted(by_key):
    pairs = np.array(by_key[(key, condim)], np.int64)
    nslot = _NARROWPHASE[key][1]
    groups.append(PairGroup(key, pairs[:, 0], pairs[:, 1], nslot, condim))
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
  (includemargin, friction5, solref, solimp), each per pair."""
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
  return margin - gap, friction5, solref, solimp


def _contact_constants(m: Model):
  """Per-slot mixed parameters; lane-independent, computed once."""
  lay = contact_layout(m)
  parts = [_pair_params(m, g) for g in lay.groups]
  rep = lambda x, g: torch.repeat_interleave(x, g.nslot, dim=0)
  return tuple(torch.cat([rep(p[i], g) for p, g in zip(parts, lay.groups)])
               for i in range(4))


def collision(m: Model, d: Data) -> Data:
  """Runs every pair group's narrowphase into the static-shape contact set
  (``mj_collision``)."""
  lay = contact_layout(m)
  if lay.ncon == 0:
    return d.replace(contact=None)
  dists, poss, frames = [], [], []
  for grp in lay.groups:
    fn = _NARROWPHASE[grp.types][0]
    g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
    dist, pos, nrm, yhint = fn(
        d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1],
        d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2])
    bsz = d.batch
    dists.append(dist.reshape(bsz, -1))
    poss.append(pos.reshape(bsz, -1, 3))
    frames.append(make_frame(nrm, yhint).reshape(bsz, -1, 3, 3))
  includemargin, friction, solref, solimp = m.memo(
      "contact_constants", lambda: _contact_constants(m))
  return d.replace(contact=Contact(
      dist=torch.cat(dists, 1), pos=torch.cat(poss, 1),
      frame=torch.cat(frames, 1), includemargin=includemargin,
      friction=friction, solref=solref, solimp=solimp,
      geom1=lay.geom1, geom2=lay.geom2))
