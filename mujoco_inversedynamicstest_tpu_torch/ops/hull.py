"""Host-side convex hull topology for box and mesh collision.

Copy of the JAX package's ``ops/hull.py`` (the port imports
nothing of the JAX package).  ``put_model`` builds each mesh's hull once,
with qhull through ``scipy.spatial.ConvexHull``, from the snapshot arrays
``mesh_vert``/``mesh_vertadr``/``mesh_vertnum``, so no ``mujoco`` is
needed.  The narrowphase of ``ops/collision_convex.py`` reads:

* vertices (local frame),
* polygonal faces (coplanar-merged, padded index lists) + normals,
* triangulated faces (for closest-point queries),
* unique edges with their two adjacent-face normals (for the Gauss-map
  edge-pair pruning test).

Everything here is numpy on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
from scipy.spatial import ConvexHull


class HullSpec(NamedTuple):
  """Static convex hull topology (host numpy, local frame)."""
  vert: np.ndarray            # (V, 3) float
  face: np.ndarray            # (F, FV) int vert indices, padded (repeat last)
  face_nvert: np.ndarray      # (F,) int true vert count per face
  face_normal: np.ndarray     # (F, 3) float outward normals
  tri: np.ndarray             # (T, 3) int triangulated faces
  edge: np.ndarray            # (E, 2) int unique undirected edges
  edge_face_normal: np.ndarray  # (E, 2, 3) float adjacent face normals

  @property
  def nvert(self) -> int:
    return self.vert.shape[0]


# canonical unit box: vertex k has coords (±1, ±1, ±1) by bit pattern
_BOX_VERT = np.array(
    [[(-1.0, 1.0)[(k >> i) & 1] for i in range(3)] for k in range(8)]
)
# 6 faces, counter-clockwise seen from outside
_BOX_FACE = np.array([
    [0, 4, 6, 2],   # -x
    [1, 3, 7, 5],   # +x
    [0, 1, 5, 4],   # -y
    [2, 6, 7, 3],   # +y
    [0, 2, 3, 1],   # -z
    [4, 5, 7, 6],   # +z
])


def _merge_coplanar_faces(vert: np.ndarray, simplices: np.ndarray,
                          equations: np.ndarray, tol: float = 1e-6):
  """Groups hull triangles into maximal planar polygon faces.

  Returns (face_vert_lists, face_normals): each face is the CCW-ordered
  vertex index list of the merged polygon.
  """
  nsimp = len(simplices)
  used = np.zeros(nsimp, bool)
  faces, normals = [], []
  for i in range(nsimp):
    if used[i]:
      continue
    n_i = equations[i, :3]
    d_i = equations[i, 3]
    # all triangles on (numerically) the same plane
    same = (~used
            & (np.abs(equations[:, :3] @ n_i - 1.0) < tol)
            & (np.abs(equations[:, 3] - d_i) < tol))
    used |= same
    vids = np.unique(simplices[same].ravel())
    pts = vert[vids]
    # order CCW around the face centroid in the plane basis
    c = pts.mean(axis=0)
    u = pts[0] - c
    u = u / max(np.linalg.norm(u), 1e-12)
    v = np.cross(n_i, u)
    ang = np.arctan2((pts - c) @ v, (pts - c) @ u)
    order = np.argsort(ang)
    faces.append(vids[order])
    normals.append(n_i / max(np.linalg.norm(n_i), 1e-12))
  return faces, normals


def _farthest_point_subset(vert: np.ndarray, k: int) -> np.ndarray:
  """Greedy farthest-point vertex subsampling (the ``maxhullvert``
  decimation analog, reference ``src/user/user_mesh.cc`` maxhullvert)."""
  n = len(vert)
  if n <= k:
    return vert
  sel = [int(np.argmax(np.linalg.norm(vert - vert.mean(0), axis=1)))]
  d = np.linalg.norm(vert - vert[sel[0]], axis=1)
  for _ in range(k - 1):
    nxt = int(np.argmax(d))
    sel.append(nxt)
    d = np.minimum(d, np.linalg.norm(vert - vert[nxt], axis=1))
  return vert[sel]


def build_hull(points: np.ndarray, maxhullvert: int = 64) -> HullSpec:
  """Convex hull topology of a point cloud (qhull via scipy)."""
  points = np.asarray(points, np.float64)
  if len(points) > 4:
    hull0 = ConvexHull(points)
    points = points[hull0.vertices]
  points = _farthest_point_subset(points, maxhullvert)

  # degenerate (planar/linear) clouds: jitter minimally to get a 3D hull
  try:
    hull = ConvexHull(points)
  except Exception:
    eps = 1e-9 * max(1.0, np.abs(points).max())
    points = points + eps * np.random.RandomState(0).randn(*points.shape)
    hull = ConvexHull(points)

  # reindex to hull vertices only
  vids = hull.vertices
  remap = -np.ones(len(points), np.int64)
  remap[vids] = np.arange(len(vids))
  vert = points[vids]
  tri = remap[hull.simplices]

  # qhull triangle winding can be inward; flip to outward using equations
  eqn = hull.equations  # (nsimp, 4): n·x + d = 0, n outward
  for t in range(len(tri)):
    n_geo = np.cross(vert[tri[t, 1]] - vert[tri[t, 0]],
                     vert[tri[t, 2]] - vert[tri[t, 0]])
    if n_geo @ eqn[t, :3] < 0:
      tri[t] = tri[t, ::-1]

  face_lists, face_normals = _merge_coplanar_faces(vert, tri, eqn)
  fv = max(len(f) for f in face_lists)
  face = np.stack([
      np.concatenate([f, np.full(fv - len(f), f[-1], np.int64)])
      for f in face_lists
  ])
  face_nvert = np.array([len(f) for f in face_lists], np.int64)
  face_normal = np.stack(face_normals)

  edge, edge_fn = _unique_edges(face, face_nvert, face_normal)
  return HullSpec(
      vert=vert, face=face, face_nvert=face_nvert,
      face_normal=face_normal, tri=np.asarray(tri, np.int64),
      edge=edge, edge_face_normal=edge_fn,
  )


def _unique_edges(face, face_nvert, face_normal):
  """Unique undirected edges of the polygon faces + adjacent face normals."""
  seen = {}
  for f in range(len(face)):
    n = face_nvert[f]
    for k in range(n):
      a, b = int(face[f, k]), int(face[f, (k + 1) % n])
      key = (min(a, b), max(a, b))
      seen.setdefault(key, []).append(f)
  edges, fns = [], []
  for (a, b), fs in sorted(seen.items()):
    edges.append((a, b))
    n1 = face_normal[fs[0]]
    n2 = face_normal[fs[1]] if len(fs) > 1 else n1
    fns.append(np.stack([n1, n2]))
  return np.asarray(edges, np.int64), np.stack(fns)


def box_hull() -> HullSpec:
  """Canonical unit box hull; kernels scale verts by ``geom_size``."""
  vert = _BOX_VERT.copy()
  face = _BOX_FACE.copy()
  face_nvert = np.full(6, 4, np.int64)
  face_normal = np.zeros((6, 3))
  for f in range(6):
    axis, sign = divmod(f, 2)
    face_normal[f, axis] = 1.0 if sign else -1.0
  tri = np.concatenate([
      np.stack([face[:, 0], face[:, 1], face[:, 2]], axis=1),
      np.stack([face[:, 0], face[:, 2], face[:, 3]], axis=1),
  ])
  edge, edge_fn = _unique_edges(face, face_nvert, face_normal)
  return HullSpec(
      vert=vert, face=face, face_nvert=face_nvert,
      face_normal=face_normal, tri=tri, edge=edge, edge_face_normal=edge_fn,
  )


def mesh_hulls(mesh_vert, mesh_vertadr, mesh_vertnum,
               maxhullvert: int = 64):
  """HullSpec per mesh, from the snapshot arrays of a compiled model.

  Vertices are taken in the mesh's canonical frame (the compiler already
  folds ``mesh_pos/quat`` into ``geom_pos/quat``)."""
  return tuple(
      build_hull(mesh_vert[int(adr):int(adr) + int(num)], maxhullvert)
      for adr, num in zip(mesh_vertadr, mesh_vertnum))


class MeshGraph(NamedTuple):
  """What C's ``mjc_PlaneConvex`` reads of a mesh (host numpy): its
  vertices in the compiled order, how its support vertex is found, and the
  vertices it then tries, in C's order.

  ``climb``: a hill climb over the compiler's hull graph (``mesh_graph``,
  used when the mesh has one and at least 10 vertices), from local vertex
  0; otherwise the first vertex of largest support.  ``climb_nbr`` (N, D)
  holds each local vertex's neighbours (local ids, -1 padded) and
  ``climb_gid`` (N,) each local vertex's global id.  ``extra`` (K, E) holds,
  for each value the support search leaves in C's ``meshindex`` (a local id
  after a climb, a global id otherwise), the global ids of the vertices C
  tries next, in its order (-1 padded)."""
  vert: np.ndarray
  climb: bool
  climb_nbr: np.ndarray
  climb_gid: np.ndarray
  extra: np.ndarray


def _padded(rows, fill: int = -1) -> np.ndarray:
  width = max([1] + [len(r) for r in rows])
  return np.array([list(r) + [fill] * (width - len(r)) for r in rows],
                  np.int64).reshape(len(rows), width)


def mesh_graph(vert: np.ndarray, graph) -> MeshGraph:
  """``MeshGraph`` of one mesh from its vertices (V, 3) and the flat slice
  of ``mesh_graph`` that starts at its ``mesh_graphadr`` (None without a
  graph).  Below 10 vertices C finds the support vertex by a search over
  the global vertices but reads the neighbours of that global id as if it
  were a local one; the tables keep that reading."""
  vert = np.asarray(vert, np.float64)
  nvert = len(vert)
  if graph is None:
    extra = [[j for j in range(nvert) if j != k] for k in range(nvert)]
    return MeshGraph(vert, False, np.zeros((1, 1), np.int64),
                     np.zeros(1, np.int64), _padded(extra))
  graph = np.asarray(graph, np.int64)
  numvert = int(graph[0])
  edgeadr = lambda k: int(graph[2 + k])
  gid = graph[2 + numvert:2 + 2 * numvert]
  local = graph[2 + 2 * numvert:]

  def neighbours(k):
    out, i = [], edgeadr(k)
    while local[i] >= 0:
      out.append(int(local[i]))
      i += 1
    return out

  climb = nvert >= 10
  nbr = [neighbours(k) for k in range(numvert)]
  if climb:
    extra = [[int(gid[j]) for j in nbr[k]] for k in range(numvert)]
  else:
    if nvert > numvert:
      raise NotImplementedError(
          "unsupported by the PyTorch port: plane contact with a mesh of "
          "fewer than 10 vertices, some inside its hull")
    extra = [[int(gid[j]) for j in nbr[k]] for k in range(nvert)]
  return MeshGraph(vert, climb, _padded(nbr), gid.copy(), _padded(extra))


def mesh_graphs(mesh_vert, mesh_vertadr, mesh_vertnum, mesh_graphadr,
                mesh_graph_flat):
  """``MeshGraph`` per mesh, from the snapshot arrays of a compiled model."""
  out = []
  for adr, num, gadr in zip(mesh_vertadr, mesh_vertnum, mesh_graphadr):
    graph = None if int(gadr) < 0 else mesh_graph_flat[int(gadr):]
    out.append(mesh_graph(mesh_vert[int(adr):int(adr) + int(num)], graph))
  return tuple(out)
