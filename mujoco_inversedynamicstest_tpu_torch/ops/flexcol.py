"""Flex element contacts: geoms against flex elements, self-collision and
internal contacts, batched.

Port of the JAX package's ``ops/flexcol.py``.  Each kind of
contact is a static group of pairs (``ElemGroup``), enumerated on the host
when the model is loaded and appended after the geom-pair slots:

* ``geom_elem``: a sphere, capsule, box or mesh against the elements of a
  flex of dimension 1-3 (rounded segments, triangles, tetrahedra), a
  cylinder or an ellipsoid against a dim-2 flex (``mj_collideGeomElem``):
  exact rounded-simplex closest points for spheres and capsules, the
  thin-shell (dim 2) or volumetric (dim 3) SAT manifold for boxes, a
  barycentric descent of the box's distance for dim 1, support descent
  (``ops/ccd.py``) for meshes, cylinders and ellipsoids, the last two with
  their analytic normal restored (``mjc_fixNormal``);
* ``plane_vert``: a plane against the vertices of a trilinear flex, which
  have no geoms (``mj_collidePlaneFlex``);
* ``selfpair``: non-adjacent element pairs of one flex (``mj_collideElems``),
  of which each lane takes its nearest ``npair_run`` by bounding distance;
* ``evpair`` and ``tetface``: the compiler's element-vertex pairs and, on
  a dim-3 flex, each tetrahedron's faces against its opposite vertex
  (``mj_collideFlexInternal``).

An element's side of a contact is its vertices' bodies with the
normalized inverse-distance weights of ``mj_elemBodyWeight``; on a
trilinear flex the weights chain through the interpolation onto its 8 node
bodies.  ``Contact.bary_body``/``bary_w`` carry them to the rows.

Every function takes tensors with leading (lanes, pairs) dimensions; each
choice is a ``torch.where`` or an ``argmin`` and a gather, so that
``torch.func.vmap`` over ``jvp`` runs through it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    GeomType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import ccd
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex as cc
from mujoco_inversedynamicstest_tpu_torch.ops import math
from mujoco_inversedynamicstest_tpu_torch.ops.collision_sdf import sdf_box
from mujoco_inversedynamicstest_tpu_torch.ops.hull import HullSpec

_BIG = 1e10

# tet faces (local vertex ids) and each face's opposite vertex, in C's
# order (mj_collideFlexInternal)
TET_FACES = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]], np.int64)
TET_OPP = np.array([3, 1, 2, 0], np.int64)

# partner geom types that collide with flex elements; the smooth ones
# (cylinder, ellipsoid) only with dim-2 flexes
ELEM_PARTNER_TYPES = (
    int(GeomType.SPHERE), int(GeomType.CAPSULE), int(GeomType.BOX),
    int(GeomType.CYLINDER), int(GeomType.ELLIPSOID), int(GeomType.MESH))
SMOOTH_PARTNER_TYPES = (int(GeomType.CYLINDER), int(GeomType.ELLIPSOID))


class ElemGroup(NamedTuple):
  """A static batch of same-kind flex element contact pairs."""
  kind: str              # geom_elem, plane_vert, selfpair, evpair, tetface
  flexid: int
  gtype: int             # the partner geom's type (geom_elem, plane_vert)
  pair_geom: np.ndarray  # (npair,) partner geom, element or vertex id
  pair_elem: np.ndarray  # (npair,) global element (vertex: plane_vert) id
  face: Optional[np.ndarray]  # (npair, 3) local face vertices (tetface)
  condim: int
  nslot: int             # slots a pair
  npair_run: int         # pairs narrowphased a lane
  meshid: int = -1       # the partner mesh (one group a mesh)


def bary_width(m: Model) -> int:
  """Bodies a contact side: 4 (a tetrahedron's corners), 8 on a model
  with trilinear flexes (the node bodies, ``mj_vertBodyWeight``)."""
  return 8 if np.any(m.flex.interp) else 4


def _mix_condim(m: Model, g: int, f: int) -> int:
  p1, p2 = int(m.geom_priority[g]), int(m.flex.priority[f])
  c1, c2 = int(m.geom_condim[g]), int(m.flex.condim[f])
  return c1 if p1 > p2 else c2 if p2 > p1 else max(c1, c2)


def build_elem_groups(m: Model) -> tuple:
  """The static element contact groups of a model (the JAX package's
  ``build_elem_groups``).  The self-collision candidates are every pair of
  the flex's elements on no shared vertex body, of which each lane
  narrowphases its nearest ``max(4 elements, 64)`` (``max_geom_pairs`` if
  set): every ``selfcollide`` mode maps onto this one midphase."""
  fl = m.flex
  if fl is None:
    return ()
  groups = []
  gtypes, gflex, gbody = m.geom_type, m.geom_flexid, m.geom_bodyid
  contype, conaff = m.geom_contype, m.geom_conaffinity
  vertbody = fl.vertbodyid
  for f in range(fl.nflex):
    dim = int(fl.dim[f])
    ea, en = int(fl.elemadr[f]), int(fl.elemnum[f])
    elems = np.arange(ea, ea + en)
    elem_verts = fl.elem[elems, :dim + 1]
    fct, fca = int(fl.contype[f]), int(fl.conaffinity[f])
    if fct | fca:
      for t in ELEM_PARTNER_TYPES:
        if dim < 1 or (t in SMOOTH_PARTNER_TYPES and dim != 2):
          continue
        cand = np.nonzero((gtypes == t) & (gflex < 0) & (
            ((contype & fca) | (fct & conaff)) != 0))[0]
        if not cand.size:
          continue
        subsets = ([(int(mid), cand[m.geom_dataid[cand] == mid])
                    for mid in np.unique(m.geom_dataid[cand])]
                   if t == GeomType.MESH else [(-1, cand)])
        for meshid, csub in subsets:
          pg, pe = [], []
          for g in csub:
            # an element sharing a body with the geom does not collide
            keep = elems[~np.any(vertbody[elem_verts] == gbody[g], axis=1)]
            pg.append(np.full(len(keep), g, np.int64))
            pe.append(keep)
          pair_geom = np.concatenate(pg)
          if not pair_geom.size:
            continue
          run = len(pair_geom)
          if m.max_geom_pairs > 0:
            run = min(run, m.max_geom_pairs)
          groups.append(ElemGroup(
              "geom_elem", f, t, pair_geom, np.concatenate(pe), None,
              _mix_condim(m, int(pair_geom[0]), f),
              4 if t == GeomType.BOX else 2 if t == GeomType.CAPSULE else 1,
              run, meshid))

    if fl.interp[f] and (fct | fca):
      planes = np.nonzero((gtypes == GeomType.PLANE) & (gflex < 0) & (
          ((contype & fca) | (fct & conaff)) != 0))[0]
      if planes.size:
        va, vn = int(fl.vertadr[f]), int(fl.vertnum[f])
        groups.append(ElemGroup(
            "plane_vert", f, int(GeomType.PLANE), np.repeat(planes, vn),
            np.tile(np.arange(va, va + vn), len(planes)), None,
            _mix_condim(m, int(planes[0]), f), 1, len(planes) * vn))

    if int(fl.selfcollide[f]) and en > 1 and (fct & fca):
      vb = vertbody[elem_verts]
      se1, se2 = np.triu_indices(en, k=1)
      share = (vb[se1][:, :, None] == vb[se2][:, None, :]).any(axis=(1, 2))
      se1, se2 = se1[~share], se2[~share]
      if se1.size:
        budget = (m.max_geom_pairs if m.max_geom_pairs > 0
                  else max(4 * en, 64))
        groups.append(ElemGroup(
            "selfpair", f, -1, se1 + ea, se2 + ea, None, int(fl.condim[f]),
            1, min(len(se1), budget)))

    if fl.internal[f] and not fl.rigid[f] and (fct & fca):
      eva, evn = int(fl.evpairadr[f]), int(fl.evpairnum[f])
      if evn:
        ev = fl.evpair[eva:eva + evn]
        groups.append(ElemGroup(
            "evpair", f, -1, ev[:, 1] + int(fl.vertadr[f]), ev[:, 0] + ea,
            None, int(fl.condim[f]), 1, evn))
      if dim == 3 and en:
        pair_elem = np.repeat(elems, 4)
        groups.append(ElemGroup(
            "tetface", f, -1, fl.elem[pair_elem, np.tile(TET_OPP, en)],
            pair_elem, np.tile(TET_FACES, (en, 1)), 1, 1, len(pair_elem)))
  return tuple(groups)


def elem_pair_params(m: Model, grp: ElemGroup):
  """(includemargin, friction5, solref, solreffriction, solimp) a pair:
  ``mj_contactParam``'s mixing of the geom's and the flex's parameters
  for a geom pair (a flex has no margin or gap: ``validate_model`` refuses
  them, and ``collision`` refuses a partner's), the flex's own for an
  internal pair."""
  fl, f = m.flex, grp.flexid
  n = len(grp.pair_geom)
  if grp.kind not in ("geom_elem", "plane_vert"):
    zero = fl.radius.new_zeros(n)
    return (zero, fl.friction[f][m.const(np.array([0, 0, 1, 2, 2]))].expand(
        n, 5),
            fl.solref[f].expand(n, 2), fl.solref.new_zeros((n, 2)),
            fl.solimp[f].expand(n, 5))
  from mujoco_inversedynamicstest_tpu_torch.ops import collision

  g = m.const(grp.pair_geom)
  friction5, solref, solimp = collision.mix_params(
      m, m.geom_priority[grp.pair_geom], np.full(n, fl.priority[f]),
      m.geom_solmix[g], fl.solmix[f].expand(n), m.geom_solref[g],
      fl.solref[f].expand(n, 2), m.geom_solimp[g], fl.solimp[f].expand(n, 5),
      m.geom_friction[g], fl.friction[f].expand(n, 3))
  return (m.geom_margin[g], friction5, solref, torch.zeros_like(solref),
          solimp)


# --------------------------------------------------------------------------
# geometry (world frame; leading dims broadcast)
# --------------------------------------------------------------------------


def _norm(x):
  return torch.linalg.vector_norm(x, dim=-1)


def _dot(a, b):
  return torch.sum(a * b, dim=-1)


def _unit(x):
  """x / max(|x|, MINVAL), and that length."""
  n = torch.clamp(_norm(x), min=math.MINVAL)
  return x / n[..., None], n


def _face_normal(verts, face):
  """Unit normal of the triangle ``face`` (3 local ids) of ``verts``."""
  a, b, c = (verts[..., int(i), :] for i in face)
  return math.normalize(math.cross(b - a, c - a))


def _outward(verts, nf, face):
  """``nf`` turned away from the tetrahedron's centroid (kept where it is
  orthogonal to the way out)."""
  centroid = torch.mean(verts, dim=-2)
  s = torch.sign(_dot(nf, verts[..., int(face[0]), :] - centroid))
  return nf * torch.where(s == 0, 1.0, s)[..., None]


def _closest_pt_simplex(x, verts, dim: int):
  """The closest point to x on a segment, a triangle or a tetrahedron's
  surface (the nearest of its faces)."""
  if dim == 1:
    a, b = verts[..., 0, :], verts[..., 1, :]
    ab = b - a
    t = torch.clamp(_dot(x - a, ab) / torch.clamp(_dot(ab, ab),
                                                  min=math.MINVAL), 0.0, 1.0)
    return a + t[..., None] * ab
  if dim == 2:
    return cc._closest_pt_tri(x, verts[..., 0, :], verts[..., 1, :],
                              verts[..., 2, :])
  xs = torch.stack([cc._closest_pt_tri(x, *(verts[..., int(i), :]
                                            for i in face))
                    for face in TET_FACES], dim=-2)
  k = torch.argmin(_norm(xs - x[..., None, :]), dim=-1)
  return cc._take(xs, k)


def _sphere_simplex(s, rs, verts, rt, dim: int):
  """A sphere (centre s, radius rs) against a rounded element: the
  closest point's distance less both radii, the normal sphere -> element,
  the point between the surfaces (``mjraw_SphereTriangle``).  A centre
  inside a tetrahedron reads the nearest face from inside."""
  x = _closest_pt_simplex(s, verts, dim)
  u, lu = _unit(x - s)
  if dim == 3:
    inside = torch.ones_like(lu, dtype=torch.bool)
    centroid = torch.mean(verts, dim=-2)
    for face in TET_FACES:
      a, b, c = (verts[..., int(i), :] for i in face)
      nf = math.cross(b - a, c - a)
      nf = nf * torch.sign(_dot(nf, a - centroid))[..., None]
      inside = inside & (_dot(s - a, nf) <= 0)
    u = torch.where(inside[..., None], -u, u)
    lu = torch.where(inside, -lu, lu)
  dist = lu - rs - rt
  return dist, s + u * (rs + dist * 0.5)[..., None], u


def _capsule_simplex(p, axis, hl, rc, verts, rt, dim: int):
  """A capsule against a rounded element, two slots: its two end points
  against the element and its segment against each element edge (of a
  tetrahedron, its first face's), the deepest candidate and the deepest
  one apart from it (by a tenth of the radii)."""
  e1 = p + axis * hl[..., None]
  e2 = p - axis * hl[..., None]
  # a tetrahedron's first face stands for it, as in the JAX package
  on = lambda q: _closest_pt_simplex(q, verts[..., :3, :], min(dim, 2))
  if dim == 1:
    a, b = verts[..., 0, :], verts[..., 1, :]
    cands = [cc._closest_seg_seg(e1, e2 - e1, a, b - a), (e1, on(e1)),
             (e2, on(e2))]
  else:
    cands = [(e1, on(e1)), (e2, on(e2))]
    for i in range(3):
      pe, qe = verts[..., i, :], verts[..., (i + 1) % 3, :]
      cands.append(cc._closest_seg_seg(e1, e2 - e1, pe, qe - pe))
  ps = torch.stack([c[0] for c in cands], dim=-2)
  qs = torch.stack([c[1] for c in cands], dim=-2)
  nrms, lus = _unit(qs - ps)
  dists = lus - rc[..., None] - rt
  poss = ps + nrms * (rc[..., None] + dists * 0.5)[..., None]
  k1 = torch.argmin(dists, dim=-1)
  sep = _norm(poss - cc._take(poss, k1)[..., None, :])
  distinct = sep > torch.clamp(0.1 * (rc + rt), min=1e-9)[..., None]
  masked = torch.where(distinct, dists, _BIG)
  k2 = torch.argmin(masked, dim=-1)
  return (torch.stack([cc._take(dists, k1, -1), cc._take(masked, k2, -1)],
                      dim=-1),
          torch.stack([cc._take(poss, k1), cc._take(poss, k2)], dim=-2),
          torch.stack([cc._take(nrms, k1), cc._take(nrms, k2)], dim=-2))


def _simplex_spec(nv: int, faces, edges) -> HullSpec:
  return HullSpec(
      vert=np.zeros((nv, 3)), face=np.asarray(faces, np.int64),
      face_nvert=np.full(len(faces), 3, np.int64),
      face_normal=np.zeros((len(faces), 3)), tri=np.asarray(faces, np.int64),
      edge=np.asarray(edges, np.int64),
      edge_face_normal=np.zeros((len(edges), 2, 3)))


# a triangle is a flat two-sided hull; a tetrahedron's edges each lie on
# two of its faces
_TRI_EDGES = np.array([[0, 1], [1, 2], [0, 2]], np.int64)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      np.int64)
_TET_EDGE_FACES = np.array([[f for f in range(4) if set(e) <= set(TET_FACES[f])]
                            for e in _TET_EDGES], np.int64)
_TRI_SPEC = _simplex_spec(3, [[0, 1, 2], [0, 2, 1]], _TRI_EDGES)
_TET_SPEC = _simplex_spec(4, TET_FACES, _TET_EDGES)


def _simplex_hull(verts, dim: int) -> cc.WorldHull:
  """The world hull of an element at its vertices: a triangle's two
  opposite faces (its edges' Gauss arcs are degenerate, so its contacts
  are face contacts), or a tetrahedron's outward faces."""
  if dim == 2:
    n = _face_normal(verts, (0, 1, 2))
    face_normal = torch.stack([n, -n], dim=-2)
    spec, edge = _TRI_SPEC, _TRI_EDGES
    efn1 = n[..., None, :].expand(verts.shape)
    efn2 = -efn1
  else:
    face_normal = torch.stack([_outward(verts, _face_normal(verts, face),
                                        face) for face in TET_FACES], dim=-2)
    spec, edge = _TET_SPEC, _TET_EDGES
    efn1 = face_normal[..., _TET_EDGE_FACES[:, 0], :]
    efn2 = face_normal[..., _TET_EDGE_FACES[:, 1], :]
  e0, e1 = edge[:, 0], edge[:, 1]
  return cc.WorldHull(
      spec=spec, vert=verts, face_normal=face_normal,
      edge_dir=verts[..., e1, :] - verts[..., e0, :],
      edge_p0=verts[..., e0, :], edge_fn1=efn1, edge_fn2=efn2,
      center=torch.mean(verts, dim=-2))


def _sdf_box_grad(x, size):
  """The gradient of ``sdf_box`` at x, as reverse-mode differentiation of
  it gives it: the outside part's unit direction, else the face of the
  largest (average of tied) q; |.| differentiates to sign(x)."""
  q = torch.abs(x) - size
  o = torch.clamp(q, min=0.0)
  on = torch.sqrt(torch.clamp(torch.sum(o * o, dim=-1),
                              min=math.MINVAL * math.MINVAL))
  g = torch.where((torch.sum(o * o, dim=-1) > math.MINVAL ** 2)[..., None],
                  o / on[..., None], 0.0)
  qmax = torch.amax(q, dim=-1, keepdim=True)
  tied = (q == qmax).to(x.dtype)
  inner = tied / torch.sum(tied, dim=-1, keepdim=True)
  scale = torch.where(qmax < 0, 1.0, torch.where(qmax == 0, 0.5, 0.0))
  return torch.sign(x) * (g + scale * inner)


def _box_segment(p, mat, size, verts, rt):
  """A box against a rounded segment (a cable element): the box's
  distance minimized over the segment by projected descent on its two
  barycentric weights from both ends and the middle; one slot, padded to
  four."""
  vl = ccd._mtv(mat[..., None, :, :], verts - p[..., None, :])   # (..., 2, 3)
  sz = size[..., None, :]
  x_of = lambda w: torch.sum(w[..., :, None] * vl[..., None, :, :], dim=-2)
  phi = lambda w: sdf_box(x_of(w), sz)
  w = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]], dtype=verts.dtype,
                   device=verts.device).expand(verts.shape[:-2] + (3, 2))
  alphas = torch.logspace(-3.0, 0.0, 8, dtype=verts.dtype,
                          device=verts.device)
  for _ in range(8):
    gx = _sdf_box_grad(x_of(w), sz)                      # (..., 3, 3)
    g = torch.sum(gx[..., None, :] * vl[..., None, :, :], dim=-1)
    g = g - torch.mean(g, dim=-1, keepdim=True)
    cands = torch.clamp(w[..., None, :] - alphas[:, None] * g[..., None, :],
                        min=0.0)
    cands = cands / torch.clamp(torch.sum(cands, dim=-1, keepdim=True),
                                min=math.MINVAL)
    vals = sdf_box(torch.sum(cands[..., :, None] * vl[..., None, None, :, :],
                             dim=-2), sz[..., None, :])
    k = torch.argmin(vals, dim=-1)
    best = cc._take(cands, k)
    w = torch.where((cc._take(vals, k, -1) < phi(w))[..., None], best, w)
  w = cc._take(w, torch.argmin(phi(w), dim=-1))
  x = torch.sum(w[..., :, None] * vl, dim=-2)
  draw = sdf_box(x, size)
  nrm1 = ccd._mv(mat, math.normalize(_sdf_box_grad(x, size)))
  dist1 = draw - rt
  pos1 = (ccd._mv(mat, x) + p - nrm1 * draw[..., None]
          + nrm1 * (dist1 * 0.5)[..., None])
  empty = pos1.new_zeros(pos1.shape[:-1] + (3, 3))
  return (torch.cat([dist1[..., None], empty[..., 0] + _BIG], dim=-1),
          torch.cat([pos1[..., None, :], empty], dim=-2),
          torch.cat([nrm1[..., None, :], empty], dim=-2))


def _box_simplex(p, mat, size, verts, rt, dim: int, band: float,
                 box: HullSpec):
  """A box against a rounded element, four slots.  A triangle is a thin
  two-sided shell: the SAT axis of largest separation between the box and
  the triangle's two faces, the winning face's polygon manifold scored by
  ``|d| - rt`` (candidates tunnelled through the midplane carry no force),
  depths ``|d| - rt``, the normal the winning element face's (or the
  negated box face's).  A tetrahedron: the box-box SAT manifold, widened by
  rt.  A segment: ``_box_segment``."""
  if dim == 1:
    return _box_segment(p, mat, size, verts, rt)
  ha = cc.hull_world(box, p, mat, size)
  hb = _simplex_hull(verts, dim)
  margin = (band + rt).expand(p.shape[:-1])
  if dim == 3:
    dist, pos, nrm, _ = cc.hulls_sat_manifold(ha, hb, margin)
    valid = dist < _BIG / 2
    return (torch.where(valid, dist - rt, dist),
            torch.where(valid[..., None], pos - nrm * (rt * 0.5), pos), nrm)
  sep_fa = cc._face_separations(ha, hb.vert)
  sep_fb = cc._face_separations(hb, ha.vert)
  best_fa = torch.argmax(sep_fa, dim=-1)
  best_fb = torch.argmax(sep_fb, dim=-1)
  use_a = cc._take(sep_fa, best_fa, -1) >= cc._take(sep_fb, best_fb, -1)
  n_a = cc._take(ha.face_normal, best_fa)
  n_b = cc._take(hb.face_normal, best_fb)
  two_sided = lambda dd: torch.abs(dd) - rt
  inc_b = torch.argmin(_dot(hb.face_normal, n_a[..., None, :]), dim=-1)
  d_af, p_af = cc._face_face_manifold(ha, best_fa, hb, inc_b, margin, 4,
                                      score_fn=two_sided)
  inc_a = torch.argmin(_dot(ha.face_normal, n_b[..., None, :]), dim=-1)
  d_bf, p_bf = cc._face_face_manifold(hb, best_fb, ha, inc_a, margin, 4,
                                      score_fn=two_sided)
  d_raw = torch.where(use_a[..., None], d_af, d_bf)
  pos = torch.where(use_a[..., None, None], p_af, p_bf)
  nrm = torch.where(use_a[..., None], -n_a, n_b)
  dist = torch.where(d_raw < _BIG / 2, two_sided(d_raw), d_raw)
  return dist, pos, nrm[..., None, :].expand(pos.shape)


def _tri_seeds(verts, dc):
  """The element normal, its negation and the centre direction tilted
  half-way to each: seeds of a descent against a triangle."""
  n0 = _face_normal(verts, (0, 1, 2))
  return [n0, -n0, math.normalize(dc + 0.5 * n0),
          math.normalize(dc - 0.5 * n0)]


def _smooth_simplex(p, mat, size, verts, rt, gtype: int):
  """A cylinder or an ellipsoid against a rounded triangle by support
  descent from five seeds; one slot, normal geom -> element, snapped to
  the geom's analytic normal at the contact point."""
  supp = ccd.geom_support_fn(gtype, p, mat, size)
  dc = math.normalize(torch.mean(verts, dim=-2) - p)
  n0, m0, up, down = _tri_seeds(verts, dc)
  seeds = torch.stack([n0, m0, dc, up, down], dim=-2)
  dist, nrm, wa = ccd.support_descent(supp, ccd.hull_support_fn(verts),
                                      seeds, pad=rt)
  q = _closest_pt_simplex(wa, verts, 2)
  pos = 0.5 * (wa + q - rt * nrm)
  return dist, pos, ccd.fix_normal_smooth(gtype, p, mat, size, pos, nrm)


def _mesh_simplex(p, mat, vlocal, verts, rt, dim: int):
  """A mesh's convex hull against a rounded element by support descent;
  one slot, normal geom -> element."""
  wv = cc._mt(vlocal, mat) + p[..., None, :]
  centroid = torch.mean(verts, dim=-2)
  dc = math.normalize(centroid - p)
  seeds = [dc]
  if dim == 2:
    seeds += _tri_seeds(verts, dc)
  elif dim == 3:
    for face in TET_FACES:
      # inward (partner -> element) face normal
      seeds.append(-_outward(verts, _face_normal(verts, face), face))
  else:
    a = math.normalize(verts[..., 1, :] - verts[..., 0, :])
    perp = dc - _dot(dc, a)[..., None] * a
    pn = _norm(perp)
    seeds.append(torch.where((pn > 1e-9)[..., None],
                             perp / torch.clamp(pn, min=math.MINVAL)[..., None],
                             dc))
  dist, u, wa = ccd.support_descent(
      ccd.hull_support_fn(wv), ccd.hull_support_fn(verts),
      torch.stack(seeds, dim=-2), pad=rt)
  q = _closest_pt_simplex(wa, verts, dim)
  return dist, 0.5 * (wa + q - rt * u), u


def _elem_elem(v1, v2, rt, dim: int):
  """Two rounded elements of one flex: segment closest points for cables,
  support descent otherwise; one slot, normal element 1 -> element 2."""
  if dim == 1:
    c1, c2 = cc._closest_seg_seg(v1[..., 0, :], v1[..., 1, :] - v1[..., 0, :],
                                 v2[..., 0, :], v2[..., 1, :] - v2[..., 0, :])
    u, lu = _unit(c2 - c1)
    return lu - 2.0 * rt, 0.5 * (c1 + c2), u
  c1 = torch.mean(v1, dim=-2)
  dc = math.normalize(torch.mean(v2, dim=-2) - c1)
  seeds = [dc]
  if dim == 2:
    ssign = lambda x: torch.where(x >= 0, 1.0, -1.0)[..., None]
    n1 = _face_normal(v1, (0, 1, 2))
    n2 = _face_normal(v2, (0, 1, 2))
    seeds += [n1 * ssign(_dot(n1, dc)), n2 * ssign(_dot(n2, dc)),
              -n1 * ssign(_dot(n1, dc))]
  else:
    seeds += [_outward(v1, _face_normal(v1, face), face)
              for face in TET_FACES]
  dist, u, wa = ccd.support_descent(
      ccd.hull_support_fn(v1), ccd.hull_support_fn(v2),
      torch.stack(seeds, dim=-2), pad=2.0 * rt)
  return dist, 0.5 * (wa + _closest_pt_simplex(wa, v2, dim)), u


def _bary_weights(pos, verts, exclude: Optional[int] = None):
  """The element's inverse-distance weights at the contact point, summing
  to 1 (``mj_elemBodyWeight``), with the local vertex ``exclude`` left
  out: (..., nvert) or (..., nvert - 1)."""
  keep = [i for i in range(verts.shape[-2]) if i != exclude]
  w = 1.0 / torch.clamp(_norm(pos[..., None, :] - verts[..., keep, :]),
                        min=math.MINVAL)
  return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=math.MINVAL)


class ElemContacts(NamedTuple):
  """One group's slots, each (B, n, ...): ``sel`` (B, npair_run) are the
  pairs each lane narrowphased (None: all of them, in order)."""
  dist: torch.Tensor
  pos: torch.Tensor
  nrm: torch.Tensor
  geom1: torch.Tensor
  geom2: torch.Tensor
  bary_body: torch.Tensor
  bary_w: torch.Tensor
  sel: Optional[torch.Tensor]


def _nearest(bdist, npair_run: int):
  """Each lane's ``npair_run`` least bounding distances; a stable sort
  keeps the lower pair of a tie, as XLA's ``top_k`` does."""
  return torch.sort(bdist, dim=-1, stable=True).indices[:, :npair_run]


# elements of the (lanes, slots, slots) distances ``_duplicates`` forms at
# once: a lane chunk's (the hammock's capsule group has 6400 slots, 164 MB
# a lane in fp32)
DUPLICATE_CHUNK_ELEMS = 2**28


def _duplicates(pos: torch.Tensor, tol: float) -> torch.Tensor:
  """(B, n) bool: slot i lies within ``tol`` of an earlier slot j < i of
  its lane (``pos`` (B, n, 3)), a few lanes at a time so that the pairwise
  distances stay within ``DUPLICATE_CHUNK_ELEMS``; each lane's bits are
  those of the whole batch at once."""
  n = pos.shape[1]
  earlier = torch.ones((n, n), dtype=torch.bool, device=pos.device).tril(-1)
  step = max(1, DUPLICATE_CHUNK_ELEMS // max(n * n, 1))
  out = []
  for start in range(0, pos.shape[0], step):
    p = pos[start:start + step]
    d2 = sum((p[..., None, c] - p[..., None, :, c]) ** 2 for c in range(3))
    out.append(torch.any((torch.sqrt(d2) < tol) & earlier, dim=-1))
  return out[0] if len(out) == 1 else torch.cat(out)


def _sides(m: Model, bsz: int, n: int, dtype, side0, side1):
  """(B, n, 2, W) bodies and weights from each side's (bodies, weights),
  each (B or 1, n, k) with k <= W, zero-padded."""
  width = bary_width(m)
  bodies, weights = [], []
  for b, w in (side0, side1):
    b = b.expand(bsz, n, b.shape[-1])
    w = w.expand(bsz, n, w.shape[-1]).to(dtype)
    pad = width - b.shape[-1]
    bodies.append(torch.nn.functional.pad(b, (0, pad)))
    weights.append(torch.nn.functional.pad(w, (0, pad)))
  return torch.stack(bodies, dim=2), torch.stack(weights, dim=2)


def _element_side(m: Model, f: int, ev_ids, weights):
  """An element's side: its vertices' bodies and weights, or on a
  trilinear flex its 8 node bodies with the weights chained through the
  interpolation (``mj_vertBodyWeight``)."""
  fl = m.flex
  if not fl.interp[f]:
    return m.const(fl.vertbodyid)[ev_ids], weights
  na, nn = int(fl.nodeadr[f]), int(fl.nodenum[f])
  rows = m.const(fl.interp_w[f])[ev_ids - int(fl.vertadr[f])]
  node_w = torch.sum(weights[..., None] * rows, dim=-2)
  return m.const(fl.nodebodyid[na:na + nn]).expand(node_w.shape), node_w


def run_elem_group(m: Model, d: Data, grp: ElemGroup) -> ElemContacts:
  """Narrowphases one element group for every lane."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision

  lane_take = collision.lane_take
  fl = m.flex
  f = grp.flexid
  dim = int(fl.dim[f])
  bsz, dtype = d.batch, d.qpos.dtype
  radius = float(fl.radius_np[f])
  rt = fl.radius[f]
  one = lambda n: d.qpos.new_ones((1, n, 1))
  geom_body = lambda g: m.const(m.geom_bodyid)[g][..., None]

  if grp.kind == "plane_vert":
    g, v = grp.pair_geom, grp.pair_elem
    n = len(g)
    n0 = d.geom_xmat[:, m.const(g), :, 2]
    vx = d.flexvert_xpos[:, m.const(v)]
    dist = _dot(vx - d.geom_xpos[:, m.const(g)], n0) - rt
    pos = vx - n0 * (rt + dist * 0.5)[..., None]
    bb, bw = _sides(m, bsz, n, dtype, (geom_body(m.const(g))[None], one(n)),
                    _element_side(m, f, m.const(v)[None, :, None],
                                  one(n)))
    return ElemContacts(dist, pos, n0, m.const(g).expand(bsz, n),
                        m.const(np.full(n, -1)).expand(bsz, n), bb, bw, None)

  elem_verts = fl.elem[grp.pair_elem, :dim + 1]
  vgeom = m.ngeom_mj               # the first vertex's sphere geom

  if grp.kind == "geom_elem":
    npair = len(grp.pair_geom)
    sel = None
    if grp.npair_run < npair:
      ev = d.flexvert_xpos[:, m.const(elem_verts)]       # (B, P, dim+1, 3)
      centroid = torch.mean(ev, dim=-2)
      erad = torch.amax(_norm(ev - centroid[..., None, :]), dim=-1) + rt
      bdist = (_norm(d.geom_xpos[:, m.const(grp.pair_geom)] - centroid)
               - m.geom_rbound[m.const(grp.pair_geom)] - erad)
      sel = _nearest(bdist, grp.npair_run)
    g = m.const(grp.pair_geom)
    g = g.expand(bsz, -1) if sel is None else lane_take(
        g.expand(bsz, -1), sel)
    ev_ids = m.const(elem_verts)
    ev_ids = (ev_ids.expand(bsz, -1, -1) if sel is None
              else lane_take(ev_ids.expand(bsz, -1, -1), sel))
    everts = torch.take_along_dim(
        d.flexvert_xpos, ev_ids.reshape(bsz, -1)[..., None], dim=1).reshape(
            ev_ids.shape + (3,))
    gpos = lane_take(d.geom_xpos, g)
    gmat = lane_take(d.geom_xmat, g)
    gsize = m.geom_size[g]
    t = grp.gtype
    if t == GeomType.SPHERE:
      out = _sphere_simplex(gpos, gsize[..., 0], everts, rt, dim)
    elif t == GeomType.CAPSULE:
      out = _capsule_simplex(gpos, gmat[..., :, 2], gsize[..., 1],
                             gsize[..., 0], everts, rt, dim)
    elif t == GeomType.BOX:
      # the manifold's band is the pair's margin, 0 for every flex pair
      # (``collision`` refuses a margin)
      out = _box_simplex(gpos, gmat, gsize, everts, rt, dim, 0.0,
                         collision.device_hull(m, cc.BOX_HULL))
    elif t in SMOOTH_PARTNER_TYPES:
      out = _smooth_simplex(gpos, gmat, gsize, everts, rt, t)
    else:
      vlocal = m.const(m.mesh_hull[grp.meshid].vert)
      out = _mesh_simplex(gpos, gmat, vlocal, everts, rt, dim)
    dist, pos, nrm = out
    k = grp.nslot
    if k > 1:
      # flatten the pairs' slots; an element edge's closest point comes
      # from both elements on it: keep the first of the duplicates (within
      # 1e-9, as the JAX package; 1e-6 in fp32, whose rounding of the two
      # elements' answers alone parts them by more than 1e-9)
      dist, pos, nrm = (dist.flatten(1), pos.flatten(1, 2),
                        nrm.flatten(1, 2))
      rep = lambda x: torch.repeat_interleave(x, k, dim=1)
      everts, ev_ids, g = rep(everts), rep(ev_ids), rep(g)
      dist = torch.where(_duplicates(pos, 1e-9 if dtype == torch.float64
                                     else 1e-6), _BIG, dist)
    n = dist.shape[1]
    bb, bw = _sides(m, bsz, n, dtype, (geom_body(g), one(n)),
                    _element_side(m, f, ev_ids, _bary_weights(pos, everts)))
    geom2 = (torch.full_like(g, -1) if fl.interp[f]
             else vgeom + ev_ids[..., 0])
    return ElemContacts(dist, pos, nrm, g, geom2, bb, bw, sel)

  if grp.kind == "selfpair":
    ev1_np = fl.elem[grp.pair_geom, :dim + 1]
    v1_all = d.flexvert_xpos[:, m.const(ev1_np)]
    v2_all = d.flexvert_xpos[:, m.const(elem_verts)]
    sel = None
    if grp.npair_run < len(grp.pair_geom):
      c1, c2 = torch.mean(v1_all, dim=-2), torch.mean(v2_all, dim=-2)
      r1 = torch.amax(_norm(v1_all - c1[..., None, :]), dim=-1)
      r2 = torch.amax(_norm(v2_all - c2[..., None, :]), dim=-1)
      sel = _nearest(_norm(c1 - c2) - r1 - r2 - 2.0 * rt, grp.npair_run)
    take = lambda x: x if sel is None else lane_take(x, sel)
    v1, v2 = take(v1_all), take(v2_all)
    ev1 = take(m.const(ev1_np).expand(bsz, -1, -1))
    ev2 = take(m.const(elem_verts).expand(bsz, -1, -1))
    dist, pos, nrm = _elem_elem(v1, v2, rt, dim)
    vb = m.const(fl.vertbodyid)
    bb, bw = _sides(m, bsz, dist.shape[1], dtype,
                    (vb[ev1], _bary_weights(pos, v1)),
                    (vb[ev2], _bary_weights(pos, v2)))
    return ElemContacts(dist, pos, nrm, vgeom + ev1[..., 0],
                        vgeom + ev2[..., 0], bb, bw, sel)

  vb_np = fl.vertbodyid
  if grp.kind == "evpair":
    vglob = grp.pair_geom
    n = len(vglob)
    s = d.flexvert_xpos[:, m.const(vglob)]
    everts = d.flexvert_xpos[:, m.const(elem_verts)]
    dist, pos, nrm = _sphere_simplex(s, rt, everts, rt, dim)
    # the vertex is left out of its own element's weights (static)
    excl = np.full(n, -1)
    for k in range(dim + 1):
      excl = np.where(elem_verts[:, k] == vglob, k, excl)
    choices = []
    for e in range(-1, dim + 1):
      w = _bary_weights(pos, everts, None if e < 0 else e)
      choices.append(torch.nn.functional.pad(w, (0, 4 - w.shape[-1])))
    w_elem = torch.take_along_dim(
        torch.stack(choices, dim=-2), m.const(excl + 1)[None, :, None, None],
        dim=-2)[..., 0, :]
    rows = np.zeros((n, 4), np.int64)
    for i in range(n):
      vs = [vb_np[v] for k, v in enumerate(elem_verts[i]) if k != excl[i]]
      rows[i, :len(vs)] = vs
    bb, bw = _sides(m, bsz, n, dtype,
                    (m.const(vb_np[vglob])[None, :, None], one(n)),
                    (m.const(rows)[None], w_elem))
    return ElemContacts(
        dist, pos, nrm, m.const(vgeom + vglob).expand(bsz, n),
        m.const(vgeom + elem_verts[:, 0]).expand(bsz, n), bb, bw, None)

  # tetface: a tetrahedron's face against its opposite vertex, active
  # within twice the radius (``planeVertex``)
  face_verts = np.take_along_axis(elem_verts, grp.face, axis=1)
  vglob = grp.pair_geom
  n = len(vglob)
  tv = d.flexvert_xpos[:, m.const(face_verts)]           # (B, n, 3, 3)
  v = d.flexvert_xpos[:, m.const(vglob)]
  nrm_f, _ = _unit(math.cross(tv[..., 1, :] - tv[..., 0, :],
                              tv[..., 2, :] - tv[..., 0, :]))
  dst = _dot(v - tv[..., 0, :], nrm_f)
  dist = torch.where(dst <= -2.0 * rt, _BIG, -dst - 2.0 * rt)
  pos = v - nrm_f * (0.5 * dst)[..., None]
  bb, bw = _sides(m, bsz, n, dtype,
                  (m.const(vb_np[face_verts])[None], _bary_weights(pos, tv)),
                  (m.const(vb_np[vglob])[None, :, None], one(n)))
  return ElemContacts(
      dist, pos, -nrm_f, m.const(vgeom + face_verts[:, 0]).expand(bsz, n),
      m.const(vgeom + vglob).expand(bsz, n), bb, bw, None)
