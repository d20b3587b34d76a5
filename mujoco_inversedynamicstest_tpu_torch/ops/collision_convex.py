"""Convex narrowphase: branchless SAT + support-point kernels, batched.

Port of ``mujoco_inversedynamicstest_tpu/ops/collision_convex.py``: the
separating-axis test over the static hull topology of ``ops/hull.py``
(face normals of both hulls + Gauss-map-pruned edge-pair cross products),
polygon-intersection manifolds for face contacts, and exact closest-point
queries for the rounded shapes (sphere, capsule).

Every function takes tensors of any leading shape (the fleet's lanes times
a group's pairs) and the hull of one group as host data: one batch per
group, no Python loop over lanes or pairs.  Every kernel returns a fixed
number of contact slots; empty slots carry ``dist = 1e10``.  Each case
(face-face or edge-edge, inside or outside) is chosen by ``torch.where``,
each selection by ``argmax``/``argmin``/``topk`` and ``take_along_dim``;
nothing is read back to the host and nothing is written in place, so that
``torch.func.vmap`` over ``jvp`` runs through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mujoco_inversedynamicstest_tpu_torch.ops.hull import (
    HullSpec, MeshGraph, box_hull)

_BIG = 1e10
BOX_HULL = box_hull()


def _dot(a, b):
  return torch.sum(a * b, dim=-1)


def _cross(a, b):
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def _norm(x):
  return torch.linalg.norm(x, dim=-1)


def _const(x, like: torch.Tensor) -> torch.Tensor:
  """A host table of the hull on ``like``'s device (floats in its dtype)."""
  x = torch.as_tensor(x)
  dtype = like.dtype if x.is_floating_point() else torch.long
  return x.to(device=like.device, dtype=dtype)


def _take(x, idx, dim: int = -2):
  """``x`` at index ``idx`` (shape ``(...,)``) along ``dim`` (-2 for rows of
  (..., N, 3), -1 for (..., N)); the dimension is dropped."""
  if dim == -1:
    return torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]
  return torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]


def _rows(x, idx):
  """Rows of ``x`` (..., N, k) at the host or device indices ``idx``."""
  return x[..., idx, :]


def _mt(v, mat):
  """Local rows (..., N, 3) to world directions: v @ mat^T, summed in
  one order whatever the batch (a batched matmul may order its sums, and
  break a tie between two faces, differently for different batches)."""
  return _dot(v[..., :, None, :], mat[..., None, :, :])


class WorldHull(NamedTuple):
  spec: HullSpec
  vert: torch.Tensor         # (..., V, 3)
  face_normal: torch.Tensor  # (..., F, 3)
  edge_dir: torch.Tensor     # (..., E, 3)
  edge_p0: torch.Tensor      # (..., E, 3)
  edge_fn1: torch.Tensor     # (..., E, 3) adjacent face normal 1 (world)
  edge_fn2: torch.Tensor     # (..., E, 3) adjacent face normal 2 (world)
  center: torch.Tensor       # (..., 3)


def hull_world(spec: HullSpec, pos, mat, scale=None) -> WorldHull:
  """The hull posed at ``pos`` (..., 3), ``mat`` (..., 3, 3); a box's
  unit hull is scaled by its half-sizes ``scale`` (..., 3)."""
  vert_l = _const(spec.vert, pos)
  if scale is not None:
    vert_l = vert_l * scale[..., None, :]
  vert = _mt(vert_l, mat) + pos[..., None, :]
  face_normal = _mt(_const(spec.face_normal, pos), mat)
  efn = _const(spec.edge_face_normal, pos)
  e0, e1 = _const(spec.edge[:, 0], pos), _const(spec.edge[:, 1], pos)
  p0 = _rows(vert, e0)
  return WorldHull(
      spec=spec, vert=vert, face_normal=face_normal,
      edge_dir=_rows(vert, e1) - p0, edge_p0=p0,
      edge_fn1=_mt(efn[:, 0], mat), edge_fn2=_mt(efn[:, 1], mat),
      center=torch.mean(vert, dim=-2),
  )


def _anchor(h: WorldHull):
  """The first vertex of each face: (..., F, 3)."""
  return _rows(h.vert, _const(h.spec.face[:, 0], h.vert))


def _face_separations(h_ref: WorldHull, other_vert):
  """Separation of ``other`` behind each face plane of ``h_ref``: (..., F)."""
  d = _dot(other_vert[..., :, None, :],
           h_ref.face_normal[..., None, :, :])             # (..., Vo, F)
  return (torch.amin(d, dim=-2)
          - torch.sum(_anchor(h_ref) * h_ref.face_normal, dim=-1))


def _arcs_intersect(a1, a2, b1, b2):
  """Gauss-map test: do great-circle arcs (a1,a2) and (b1,b2) intersect?

  Edges of two hulls form a face of the Minkowski difference iff the arc
  of edge A's adjacent normals crosses the arc of edge B's *negated*
  adjacent normals (Gregorius, "Robust Contact Creation", GDC'15)."""
  bxa = _cross(a2, a1)
  dxc = _cross(b2, b1)
  cba = _dot(b1, bxa)
  dba = _dot(b2, bxa)
  adc = _dot(a1, dxc)
  bdc = _dot(a2, dxc)
  return (cba * dba < 0) & (adc * bdc < 0) & (cba * bdc > 0)


def _edge_axes(ha: WorldHull, hb: WorldHull):
  """Edge-pair axes (..., Ea, Eb, 3), their separations and validity."""
  da = ha.edge_dir[..., :, None, :]
  db = hb.edge_dir[..., None, :, :]
  axis = _cross(da, db)
  nrm = torch.linalg.norm(axis, dim=-1, keepdim=True)
  degenerate = nrm[..., 0] < 1e-8
  axis = axis / torch.where(nrm < 1e-8, 1.0, nrm)

  pa = ha.edge_p0[..., :, None, :]
  sgn = torch.sign(_dot(axis, pa - ha.center[..., None, None, :]))
  sgn = torch.where(sgn == 0, 1.0, sgn)
  axis = axis * sgn[..., None]

  pb = hb.edge_p0[..., None, :, :]
  sep = _dot(axis, pb - pa)

  valid = _arcs_intersect(
      ha.edge_fn1[..., :, None, :], ha.edge_fn2[..., :, None, :],
      -hb.edge_fn1[..., None, :, :], -hb.edge_fn2[..., None, :, :],
  ) & ~degenerate
  return axis, sep, valid


def _closest_seg_seg(p1, d1, p2, d2):
  """Closest points between segments p1+t*d1, p2+s*d2, t,s in [0,1]."""
  r = p1 - p2
  a = _dot(d1, d1)
  e = _dot(d2, d2)
  f = _dot(d2, r)
  c = _dot(d1, r)
  b = _dot(d1, d2)
  denom = a * e - b * b
  ok = torch.abs(denom) > 1e-12
  t = torch.where(ok, (b * f - c * e) / torch.where(ok, denom, 1.0), 0.0)
  t = torch.clamp(t, 0.0, 1.0)
  s = torch.where(e > 1e-12, (b * t + f) / torch.where(e > 1e-12, e, 1.0),
                  0.0)
  s = torch.clamp(s, 0.0, 1.0)
  t = torch.where(a > 1e-12, torch.clamp(
      (b * s - c) / torch.where(a > 1e-12, a, 1.0), 0.0, 1.0), 0.0)
  return p1 + t[..., None] * d1, p2 + s[..., None] * d2


# ---------------------------------------------------------------------------
# face-face manifold: polygon intersection candidates
# ---------------------------------------------------------------------------


def _face_poly(h: WorldHull, f):
  """World vertices of face ``f`` (...,) as (..., FV, 3), with the
  validity mask (..., FV)."""
  face = _const(h.spec.face, h.vert)                       # (F, FV)
  fv = face.shape[1]
  idx = face[f]                                            # (..., FV)
  poly = torch.take_along_dim(h.vert, idx[..., None], dim=-2)
  k = torch.arange(fv, device=idx.device)
  mask = k < _const(h.spec.face_nvert, h.vert)[f][..., None]
  return poly, mask


def _roll(x):
  """Next vertex of each polygon vertex: roll by -1 along dim -2."""
  return torch.cat([x[..., 1:, :], x[..., :1, :]], dim=-2)


def _point_in_poly(pts, poly, poly_mask, n):
  """pts (..., P, 3) inside the convex polygon (..., Q, 3; masked; normal
  n (..., 3))? -> (..., P) bool.

  Padded polygon entries repeat a true vertex; the resulting zero-length
  edges produce zero cross products which count as inside.
  """
  e = _roll(poly) - poly                                   # (..., Q, 3)
  rel = pts[..., :, None, :] - poly[..., None, :, :]       # (..., P, Q, 3)
  crs = _cross(e[..., None, :, :], rel)
  side = _dot(crs, n[..., None, None, :])
  edge_ok = (side >= -1e-9) | ~poly_mask[..., None, :]
  return torch.all(edge_ok, dim=-1)


def _seg_seg_cross_2d(p_a, e_a, p_b, e_b, n):
  """Intersection of segments (in the plane ⟂ n): returns (point, hit)."""
  d = _cross(e_a, e_b)
  dn = _dot(d, n)
  r = p_b - p_a
  ok = torch.abs(dn) > 1e-12
  safe = torch.where(ok, dn, 1.0)
  t = _dot(_cross(r, e_b), n) / safe
  s = _dot(_cross(r, e_a), n) / safe
  hit = ok & (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
  return p_a + t[..., None] * e_a, hit


def _face_face_manifold(h_ref: WorldHull, f_ref, h_inc: WorldHull, f_inc,
                        margin, nslot: int, score_fn=None):
  """Contact candidates where face f_inc of h_inc meets face f_ref of h_ref.

  Candidates = inc-verts inside ref-poly + ref-verts inside inc-poly +
  pairwise edge crossings, all projected along the ref normal; up to
  ``nslot`` survivors are selected by depth then spread.
  Returns (dist, pos) of shape (..., nslot), (..., nslot, 3), +BIG padded.

  ``score_fn`` remaps the candidates' depths for the selection (still
  masked by ``depth <= margin``): a thin two-sided flex element
  (``ops/flexcol.py``) scores by ``|d| - rt``, so that a candidate far
  behind its plane (tunnelled through, force-free) does not crowd out the
  ones near the surface that carry force.  The raw depths are returned
  either way.
  """
  n = _take(h_ref.face_normal, f_ref)                      # (..., 3)
  poly_r, mask_r = _face_poly(h_ref, f_ref)                # (..., FR, 3)
  poly_i, mask_i = _face_poly(h_inc, f_inc)                # (..., FI, 3)
  ni = _take(h_inc.face_normal, f_inc)
  pr = poly_r[..., 0, :]
  pi = poly_i[..., 0, :]

  # project everything onto the ref plane for the 2D tests
  def proj(x):
    nn = n[..., None, :]
    return x - nn * _dot(x - pr[..., None, :], nn)[..., None]

  poly_r2 = proj(poly_r)
  poly_i2 = proj(poly_i)

  # candidate set 1: incident verts inside ref polygon
  in_r = _point_in_poly(poly_i2, poly_r2, mask_r, n) & mask_i
  # candidate set 2: ref verts inside incident polygon (2D along n)
  in_i = _point_in_poly(poly_r2, poly_i2, mask_i, n) & mask_r
  # candidate set 3: edge-edge crossings, (FR, FI) flattened ref-major
  fr, fi = poly_r2.shape[-2], poly_i2.shape[-2]
  er = _roll(poly_r2) - poly_r2
  ei = _roll(poly_i2) - poly_i2
  xpts, xhit = _seg_seg_cross_2d(
      poly_r2[..., :, None, :], er[..., :, None, :],
      poly_i2[..., None, :, :], ei[..., None, :, :], n[..., None, None, :])
  xhit = xhit & mask_r[..., :, None] & mask_i[..., None, :]
  xpts = xpts.reshape(xpts.shape[:-3] + (fr * fi, 3))
  xhit = xhit.reshape(xhit.shape[:-2] + (fr * fi,))

  cand = torch.cat([poly_i2, poly_r2, xpts], dim=-2)      # (..., N, 3)
  valid = torch.cat([in_r, in_i, xhit], dim=-1)            # (..., N)
  # separation along n between ref plane and inc plane at each candidate
  denom = _dot(ni, n)
  tiny = torch.full_like(denom, 1e-9)
  denom = torch.where(torch.abs(denom) < 1e-9,
                      torch.where(denom < 0, -tiny, tiny), denom)
  depth = _dot(ni[..., None, :], pi[..., None, :] - cand) / denom[..., None]
  valid = valid & (depth <= margin[..., None])
  scored = depth if score_fn is None else score_fn(depth)
  score = torch.where(valid, scored, _BIG)

  # selection: deepest first, then maximize minimum spread
  num = cand.shape[-2]
  ar = torch.arange(num, device=cand.device)
  sel = torch.zeros_like(valid)
  out_d, out_p = [], []
  mind = torch.full_like(depth, _BIG)
  for k in range(nslot):
    if k == 0:
      pick = torch.argmin(score, dim=-1)
    else:
      # among valid unpicked, prefer far from already-picked; tie-break depth
      spread = torch.where(valid & ~sel, mind, -_BIG)
      pick = torch.argmax(spread - 1e-6 * scored, dim=-1)
    ok = _take(valid, pick, -1) & ~_take(sel, pick, -1)
    dp = _take(depth, pick, -1)
    cp = _take(cand, pick)
    out_d.append(torch.where(ok, dp, _BIG))
    out_p.append(cp + n * (dp * 0.5)[..., None])
    sel = sel | (ar == pick[..., None])
    mind = torch.minimum(mind, _norm(cand - cp[..., None, :]))
  return torch.stack(out_d, dim=-1), torch.stack(out_p, dim=-2)


# ---------------------------------------------------------------------------
# closest point queries (rounded shapes)
# ---------------------------------------------------------------------------


def _closest_pt_tri(p, a, b, c):
  """Closest point on triangle (clean region decomposition)."""
  ab, ac, ap = b - a, c - a, p - a
  d1, d2 = _dot(ab, ap), _dot(ac, ap)
  bp = p - b
  d3, d4 = _dot(ab, bp), _dot(ac, bp)
  cp = p - c
  d5, d6 = _dot(ab, cp), _dot(ac, cp)
  safe = lambda x: torch.where(torch.abs(x) < 1e-30, 1e-30, x)
  clip = lambda x: torch.clamp(x, 0, 1)[..., None]

  # barycentric candidates
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  v_face = vb / safe(va + vb + vc)
  w_face = vc / safe(va + vb + vc)
  p_face = a + ab * v_face[..., None] + ac * w_face[..., None]

  p_ab = a + clip(d1 / safe(d1 - d3)) * ab
  p_ac = a + clip(d2 / safe(d2 - d6)) * ac
  p_bc = b + clip((d4 - d3) / safe((d4 - d3) + (d5 - d6))) * (c - b)

  w = lambda cond, x, y: torch.where(cond[..., None], x, y)
  out = p_face
  out = w((vc <= 0) & (d1 >= 0) & (d3 <= 0), p_ab, out)
  out = w((vb <= 0) & (d2 >= 0) & (d6 <= 0), p_ac, out)
  out = w((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), p_bc, out)
  out = w((d1 <= 0) & (d2 <= 0), a.expand_as(out), out)
  out = w((d3 >= 0) & (d4 <= d3), b.expand_as(out), out)
  out = w((d6 >= 0) & (d5 <= d6), c.expand_as(out), out)
  return out


def _closest_surface_point(h: WorldHull, p):
  """Closest point on the hull *surface* to p (..., 3), its distance, and
  whether p is inside."""
  tri = _const(h.spec.tri, h.vert)
  a, b, c = (_rows(h.vert, tri[:, i]) for i in range(3))  # (..., T, 3)
  pts = _closest_pt_tri(p[..., None, :], a, b, c)
  d = _norm(pts - p[..., None, :])
  k = torch.argmin(d, dim=-1)
  # inside iff p is behind every face plane
  behind = _dot(h.face_normal, p[..., None, :] - _anchor(h)) <= 0
  return _take(pts, k), _take(d, k, -1), torch.all(behind, dim=-1)


def _deepest_face(h: WorldHull, p):
  """For a point inside the hull: face with least penetration + projection."""
  sd = _dot(h.face_normal, p[..., None, :] - _anchor(h))   # negative
  f = torch.argmax(sd, dim=-1)
  n = _take(h.face_normal, f)
  sdf = _take(sd, f, -1)
  return f, n, sdf, p - n * sdf[..., None]


# ---------------------------------------------------------------------------
# public kernels (the signature of ops/collision.py: (p1,m1,s1,p2,m2,s2,
# margin) -> slots)
# ---------------------------------------------------------------------------


def make_plane_convex(spec2: HullSpec, is_box2: bool):
  """Plane vs convex hull: the 4 deepest vertices within the margin, the
  JAX package's rule.  ``ops/collision.py`` gives a plane and a box
  ``_plane_box`` and a plane and a mesh ``make_plane_mesh`` (C's rule)."""
  nslot = 4

  def fn(p1, m1, s1, p2, m2, s2, margin):
    n = m1[..., :, 2]
    h2 = hull_world(spec2, p2, m2, s2 if is_box2 else None)
    d = _dot(h2.vert - p1[..., None, :], n[..., None, :])  # (..., V)
    # 4 deepest verts, masked by margin
    neg = torch.where(d <= margin[..., None], d, _BIG)
    _, idx = torch.topk(-neg, nslot, dim=-1)
    negk = torch.take_along_dim(neg, idx, dim=-1)
    dist = torch.where(negk < _BIG, torch.take_along_dim(d, idx, dim=-1),
                       _BIG)
    vk = torch.take_along_dim(h2.vert, idx[..., None], dim=-2)
    pos = vk - n[..., None, :] * (dist[..., None] * 0.5)
    nrm = n[..., None, :].expand_as(pos)
    return dist, pos, nrm, torch.zeros_like(pos)

  return fn


def _lin3(a, b):
  """(a0 b0 + a1 b1) + a2 b2 over the trailing axis, in C's order of the
  sums (a tie of two vertices is then broken as C breaks it)."""
  return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


PLANE_MESH_SLOTS = 3


def make_plane_mesh(graph: MeshGraph, rbound: float):
  """Plane against a mesh: C 3.10's ``mjc_PlaneConvex``, at most 3 hull
  vertices.

  1. The support vertex along the plane's inward normal: the first vertex
     of largest support, or for a mesh of at least 10 vertices with a hull
     graph a steepest-ascent hill climb over the graph from local vertex 0,
     each round moving to the first neighbour of largest support if it is
     strictly larger.  No contact unless it lies within the margin.
  2. Then the vertices C tries after it, in its order (``MeshGraph.extra``:
     the graph neighbours of the support vertex, or every other vertex
     without a graph).  One is kept if it lies strictly within the margin
     and at least 0.3 ``geom_rbound`` from the first contact's point, until
     3 contacts are made.

  Every contact point is a hull vertex moved half its depth along the
  normal.  The rule is pinned by probes of C 3.10 (``mj_forward``,
  ``scripts/plane_mesh_probe.py``): a cube, a hexagonal and a triangular
  prism and an octagonal pyramid resting flat (3, 3, 2 and 3 contacts),
  the same yawed through 0-120 degrees, tilted by small angles and at
  random, the icosahedron of ``convex_mesh`` (2 contacts at rest), a 72-gon
  prism and spheres of 40 and 300 sampled vertices: every contact of C at
  each of 720 poses.  Below 10 vertices C reads the neighbours of a global
  vertex id as if it were a local one; ``MeshGraph`` keeps that reading.
  The JAX package keeps the 4 deepest vertices instead (ROADMAP §3).
  """
  nslot = PLANE_MESH_SLOTS
  nround = max(len(graph.climb_gid) - 1, 0) if graph.climb else 0

  def fn(p1, m1, s1, p2, m2, s2, margin):
    n = m1[..., :, 2]
    vert = _const(graph.vert, p1)                         # (V, 3)
    # support of -n in the mesh frame, summed in C's order
    d = -n[..., None]
    loc = (d[..., 0, :] * m2[..., 0, :] + d[..., 1, :] * m2[..., 1, :]
           ) + d[..., 2, :] * m2[..., 2, :]                # (..., 3)
    score = _lin3(loc[..., None, :], vert)                 # (..., V)
    if graph.climb:
      nbr = _const(graph.climb_nbr, p1)
      gid = _const(graph.climb_gid, p1)
      score_l = score[..., gid]                            # (..., N)
      cur = torch.zeros(score.shape[:-1], dtype=torch.long,
                        device=p1.device)
      best = score_l[..., 0]
      for _ in range(nround):
        nb = nbr[cur]                                      # (..., D)
        s = torch.where(nb >= 0, torch.take_along_dim(
            score_l, nb.clamp(min=0), dim=-1), -float("inf"))
        j = torch.argmax(s, dim=-1)
        sj = _take(s, j, -1)
        up = sj > best
        cur = torch.where(up, _take(nb, j, -1), cur)
        best = torch.where(up, sj, best)
      first = gid[cur]
    else:
      cur = first = torch.argmax(score, dim=-1)
    wvert = _mt(vert, m2) + p2[..., None, :]               # (..., V, 3)
    v0 = _take(wvert, first)
    dist0 = _dot(v0 - p1, n)
    ok0 = dist0 <= margin
    pos0 = v0 - n * (0.5 * dist0)[..., None]

    # the vertices C tries next, in its order
    extra = _const(graph.extra, p1)[cur]                  # (..., E)
    have = extra >= 0
    ex = extra.clamp(min=0)
    thr = _lin3(n, p2 - p1) - margin
    pnt = torch.take_along_dim(wvert, ex[..., None], dim=-2)
    keep = (have & (torch.take_along_dim(score, ex, dim=-1) > thr[..., None])
            & ~(0.3 * rbound > _norm(pnt - pos0[..., None, :]))
            & ok0[..., None])
    rank = torch.cumsum(keep.long(), dim=-1)
    dists, poss = [torch.where(ok0, dist0, _BIG)], [pos0]
    for r in range(1, nslot):
      hit = keep & (rank == r)
      i = torch.argmax(hit.long(), dim=-1)
      pr = _take(pnt, i)
      dr = _dot(pr - p1, n)
      dists.append(torch.where(torch.any(hit, dim=-1), dr, _BIG))
      poss.append(pr - n * (0.5 * dr)[..., None])
    pos = torch.stack(poss, dim=-2)
    nrm = n[..., None, :].expand_as(pos)
    return torch.stack(dists, dim=-1), pos, nrm, torch.zeros_like(pos)

  return fn


def make_sphere_convex(spec2: HullSpec, is_box2: bool):
  """Sphere vs convex hull: exact closest surface point (1 contact)."""

  def fn(p1, m1, s1, p2, m2, s2, margin):
    r = s1[..., 0]
    h2 = hull_world(spec2, p2, m2, s2 if is_box2 else None)
    q, dsurf, inside = _closest_surface_point(h2, p1)
    _, n_in, sd, q_in = _deepest_face(h2, p1)

    n_out = (q - p1) / torch.clamp(dsurf, min=1e-12)[..., None]
    dist_out = dsurf - r
    dist_in = -((-sd) + r)                                 # center depth + r
    n = torch.where(inside[..., None], -n_in, n_out)       # 1 -> 2 direction
    dist = torch.where(inside, dist_in, dist_out)
    q_sel = torch.where(inside[..., None], q_in, q)
    pos = 0.5 * ((p1 + n * r[..., None]) + q_sel)
    return (dist[..., None], pos[..., None, :], n[..., None, :],
            torch.zeros_like(pos)[..., None, :])

  return fn


def make_capsule_convex(spec2: HullSpec, is_box2: bool):
  """Capsule vs convex hull: 2 contacts.

  Shallow case: exact segment-to-surface closest point (per-triangle).
  Face-parallel case: both endpoints against the surface, giving the
  2-point manifold C's ``mjc_CapsuleBox`` gives a lying capsule.
  Deep case: least-penetration hull face.
  """
  nslot = 2

  def fn(p1, m1, s1, p2, m2, s2, margin):
    r, hl = s1[..., 0], s1[..., 1]
    axis = m1[..., :, 2]
    e1 = p1 + axis * hl[..., None]
    e2 = p1 - axis * hl[..., None]
    h2 = hull_world(spec2, p2, m2, s2 if is_box2 else None)

    # per-endpoint closest surface point (covers cap-vs-face/edge/vert)
    q_a, d_a, in_a = _closest_surface_point(h2, e1)
    q_b, d_b, in_b = _closest_surface_point(h2, e2)

    # segment-interior vs hull edges (covers side-vs-edge contacts)
    c1s, c2s = _closest_seg_seg(e1[..., None, :], (e2 - e1)[..., None, :],
                                h2.edge_p0, h2.edge_dir)
    ds = _norm(c2s - c1s)
    ke = torch.argmin(ds, dim=-1)

    # candidate contacts: endpoint A, endpoint B, best edge pair
    cand_on_seg = torch.stack([e1, e2, _take(c1s, ke)], dim=-2)
    cand_on_hull = torch.stack([q_a, q_b, _take(c2s, ke)], dim=-2)
    cand_d = torch.stack([d_a, d_b, _take(ds, ke, -1)], dim=-1)
    cand_inside = torch.stack([in_a, in_b, torch.zeros_like(in_a)], dim=-1)

    # deep-penetration fallback for inside endpoints
    _, n_da, sd_a, qda = _deepest_face(h2, e1)
    _, n_db, sd_b, qdb = _deepest_face(h2, e2)
    deep_n = torch.stack([n_da, n_db, n_da], dim=-2)
    deep_sd = torch.stack([sd_a, sd_b, sd_a], dim=-1)
    deep_q = torch.stack([qda, qdb, qda], dim=-2)

    diro = cand_on_hull - cand_on_seg
    dl = torch.linalg.norm(diro, dim=-1, keepdim=True)
    n_out = diro / torch.clamp(dl, min=1e-12)
    dist_out = cand_d - r[..., None]
    n_in = -deep_n
    dist_in = deep_sd - r[..., None]                       # sd negative

    ins = cand_inside[..., None]
    n_c = torch.where(ins, n_in, n_out)
    dist_c = torch.where(cand_inside, dist_in, dist_out)
    hull_pt = torch.where(ins, deep_q, cand_on_hull)
    pos_c = 0.5 * (cand_on_seg + n_c * r[..., None, None] + hull_pt)

    # keep the best 2 distinct candidates: sort by dist, drop near-dups
    d_s, order = torch.sort(dist_c, dim=-1, stable=True)
    p_s = torch.take_along_dim(pos_c, order[..., None], dim=-2)
    n_s = torch.take_along_dim(n_c, order[..., None], dim=-2)
    near = lambda i, j: _norm(p_s[..., i, :] - p_s[..., j, :]) < 1e-6
    dup1 = near(1, 0)
    dup2 = near(2, 0) | near(2, 1)
    d1 = torch.where(dup1, _BIG, d_s[..., 1])
    d2 = torch.where(dup2, _BIG, d_s[..., 2])
    first = (d1 <= d2)[..., None]
    dist = torch.stack([d_s[..., 0], torch.minimum(d1, d2)], dim=-1)
    pos = torch.stack([p_s[..., 0, :], torch.where(first, p_s[..., 1, :],
                                                   p_s[..., 2, :])], dim=-2)
    nrm = torch.stack([n_s[..., 0, :], torch.where(first, n_s[..., 1, :],
                                                   n_s[..., 2, :])], dim=-2)
    dist = torch.where(dist <= margin[..., None], dist, _BIG)
    return dist, pos, nrm, torch.zeros_like(pos)

  return fn


def hulls_sat_manifold(ha: WorldHull, hb: WorldHull, margin,
                       nslot: int = 4):
  """SAT contact between two world hulls: (dist, pos, nrm, yhint) of
  ``nslot`` slots.  Candidate axes: all polygon face normals of both hulls
  + Gauss-map-valid edge-pair cross products.  Face winner ->
  polygon-intersection manifold; edge winner -> single closest-point
  contact."""
  sep_fa = _face_separations(ha, hb.vert)                 # (..., Fa)
  sep_fb = _face_separations(hb, ha.vert)                 # (..., Fb)
  ax_e, sep_e, val_e = _edge_axes(ha, hb)                 # (..., Ea, Eb)

  best_fa = torch.argmax(sep_fa, dim=-1)
  best_fb = torch.argmax(sep_fb, dim=-1)
  sfa = _take(sep_fa, best_fa, -1)
  sfb = _take(sep_fb, best_fb, -1)

  eb = sep_e.shape[-1]
  sep_e_m = torch.where(val_e, sep_e, -_BIG).flatten(-2)
  flat = torch.argmax(sep_e_m, dim=-1)
  se = _take(sep_e_m, flat, -1)
  ia, ib = flat // eb, flat % eb

  # prefer faces on near ties (stabler manifolds), like C's box-box, which
  # biases face axes over edge axes
  eps = 1e-6
  face_sep = torch.maximum(sfa, sfb)
  use_edge = se > face_sep + eps
  use_a = sfa >= sfb

  # --- face manifolds (computed both ways, selected) ---
  # incident face = most anti-parallel to reference normal
  n_a = _take(ha.face_normal, best_fa)
  inc_b = torch.argmin(_dot(hb.face_normal, n_a[..., None, :]), dim=-1)
  d_af, p_af = _face_face_manifold(ha, best_fa, hb, inc_b, margin, nslot)

  n_b = _take(hb.face_normal, best_fb)
  inc_a = torch.argmin(_dot(ha.face_normal, n_b[..., None, :]), dim=-1)
  d_bf, p_bf = _face_face_manifold(hb, best_fb, ha, inc_a, margin, nslot)

  d_face = torch.where(use_a[..., None], d_af, d_bf)
  p_face = torch.where(use_a[..., None, None], p_af, p_bf)
  n_face = torch.where(use_a[..., None], n_a, -n_b)       # 1 -> 2

  # --- edge-edge contact ---
  c1, c2 = _closest_seg_seg(
      _take(ha.edge_p0, ia), _take(ha.edge_dir, ia),
      _take(hb.edge_p0, ib), _take(hb.edge_dir, ib))
  n_edge = _take(ax_e.flatten(-3, -2), flat)
  p_edge0 = 0.5 * (c1 + c2)
  rest = torch.full(se.shape + (nslot - 1,), _BIG, dtype=se.dtype,
                    device=se.device)
  d_edge = torch.cat([torch.where(se <= margin, se, _BIG)[..., None], rest],
                     dim=-1)
  p_edge = torch.cat([p_edge0[..., None, :],
                      torch.zeros_like(p_face[..., 1:, :])], dim=-2)

  dist = torch.where(use_edge[..., None], d_edge, d_face)
  pos = torch.where(use_edge[..., None, None], p_edge, p_face)
  nrm = torch.where(use_edge[..., None], n_edge, n_face)[..., None, :]
  nrm = nrm.expand_as(pos)
  # total miss: nothing within margin on the best axis
  sep_best = torch.maximum(face_sep, se)
  dist = torch.where((sep_best > margin)[..., None], _BIG, dist)
  return dist, pos, nrm, torch.zeros_like(pos)


def make_convex_convex(spec1: HullSpec, is_box1: bool,
                       spec2: HullSpec, is_box2: bool):
  """General convex-convex SAT (box-box, box-mesh, mesh-mesh): 4 contacts."""

  def fn(p1, m1, s1, p2, m2, s2, margin):
    ha = hull_world(spec1, p1, m1, s1 if is_box1 else None)
    hb = hull_world(spec2, p2, m2, s2 if is_box2 else None)
    return hulls_sat_manifold(ha, hb, margin)

  return fn
