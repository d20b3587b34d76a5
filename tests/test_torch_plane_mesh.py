"""The PyTorch port's plane-mesh contacts against C MuJoCo 3.10's
``mjc_PlaneConvex`` (``collision_convex.make_plane_mesh``), in float64 on
the CPU through ``put_model`` and ``forward``:

* the probe meshes that pin C's rule: a cube, a hexagonal and a triangular
  prism and an octagonal pyramid resting flat (C keeps 3, 3, 2 and 3 of
  their 4, 6, 3 and 8 bottom vertices), the same yawed through 0-120
  degrees (the narrowphase at C's geom frames: see the test), and tilted
  by small angles;
* ``convex_mesh`` at rest (the icosahedron stands on a face: C keeps 2 of
  its 3 bottom vertices);

each with C's contact count, its points and depths within 1e-7 (the
compiled mesh vertices are float32) and qacc within 1e-8.  And the tables
C's rule reads (``hull.mesh_graph``) on a mesh below 10 vertices, where C
reads a global vertex id as a local one.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import re

import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex, hull


def _prism(n, r=0.1, h=0.1):
  a = 2 * np.pi * np.arange(n) / n
  bottom = np.c_[r * np.cos(a), r * np.sin(a), np.zeros(n)]
  return np.r_[bottom, bottom + [0, 0, h]]


def _pyramid(n, r=0.1, h=0.1):
  a = 2 * np.pi * np.arange(n) / n
  return np.r_[np.c_[r * np.cos(a), r * np.sin(a), np.zeros(n)], [[0, 0, h]]]


MESHES = {
    "cube": np.array([[x, y, z] for x in (-.1, .1) for y in (-.1, .1)
                      for z in (0, .2)]),
    "hexagonal prism": _prism(6),
    "triangular prism": _prism(3),
    "octagonal pyramid": _pyramid(8),
}
# C 3.10's contact count, each mesh resting flat 1 mm deep
FLAT_COUNT = {"cube": 3, "hexagonal prism": 3, "triangular prism": 2,
              "octagonal pyramid": 3}


def _model(vert, euler):
  v = " ".join(f"{x:.6f}" for x in vert.ravel())
  return mujoco.MjModel.from_xml_string(f"""
  <mujoco><asset><mesh name="m" vertex="{v}"/></asset><worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 0" euler="{euler}"><freejoint/><geom type="mesh" mesh="m"/>
    </body>
  </worldbody></mujoco>""")


def _rest(mjm, depth):
  """The mesh's lowest vertex ``depth`` below the plane."""
  mjd = mujoco.MjData(mjm)
  mujoco.mj_kinematics(mjm, mjd)
  vert = mjm.mesh_vert[:mjm.mesh_vertnum[0]]
  world = vert @ mjd.geom_xmat[1].reshape(3, 3).T + mjd.geom_xpos[1]
  mjd.qpos[2] = -world[:, 2].min() - depth
  mujoco.mj_forward(mjm, mjd)
  return mjd


def _compare(mjm, mjd):
  """The port's active contacts and qacc against C's: the same count, each
  C contact's point and depth within 1e-7 of one of the port's, qacc within
  1e-8.  Returns the count."""
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.put_data(m, mjd))
  ct = d.contact
  act = np.nonzero((ct.dist[0] < ct.includemargin[0]).numpy())[0]
  ours = [(float(ct.dist[0, i]), ct.pos[0, i].numpy(),
           ct.frame[0, i, 0].numpy()) for i in act]
  assert len(ours) == mjd.ncon
  free = list(range(len(ours)))
  for c in mjd.contact:
    err = [max(abs(ours[j][0] - c.dist), np.abs(ours[j][1] - c.pos).max(),
               np.abs(ours[j][2] - c.frame[:3]).max()) for j in free]
    k = int(np.argmin(err))
    assert err[k] <= 1e-7, (c.dist, c.pos, ours)
    free.pop(k)
  np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, rtol=0, atol=1e-8)
  return mjd.ncon


@pytest.mark.parametrize("name", list(MESHES))
def test_flat_probe_matches_c(name):
  assert _compare(*(lambda m: (m, _rest(m, 0.001)))(
      _model(MESHES[name], "0 0 0"))) == FLAT_COUNT[name]


def _at_c_frames(mjm, mjd):
  """The port's plane-mesh narrowphase at the geom frames C computed:
  (dist, pos) of its filled slots, sorted as C's contacts are compared."""
  m = mt.put_model(mjm, device="cpu")
  fn = collision_convex.make_plane_mesh(m.mesh_graph[0],
                                        float(m.geom_rbound_np[1]))
  t = lambda x, *shape: torch.as_tensor(np.asarray(x, np.float64)).reshape(
      (1,) + shape)
  dist, pos, _, _ = fn(t(mjd.geom_xpos[0], 3), t(mjd.geom_xmat[0], 3, 3),
                       t(np.zeros(3), 3), t(mjd.geom_xpos[1], 3),
                       t(mjd.geom_xmat[1], 3, 3), t(np.zeros(3), 3),
                       t(mjm.geom_margin[1], 1)[0])
  return sorted((float(dist[0, i]), *pos[0, i].tolist())
                for i in range(dist.shape[1]) if dist[0, i] < 1e9)


@pytest.mark.parametrize("name", list(MESHES))
def test_yawed_and_tilted_probe_matches_c(name):
  """Yawed through 0-120 degrees at depths of 0.5 to 20 mm: resting flat,
  the bottom vertices tie, and which of them C keeps falls by the last bit
  of the geom frame, which the port computes otherwise; so the flat poses
  hold the narrowphase at C's own frames to C's contacts (1e-9).  Tilted
  by up to 2 degrees nothing ties: C's count, points, depths and qacc
  through put_model and forward."""
  rng = np.random.default_rng(sum(map(ord, name)))
  counts = set()
  for k in range(12):
    tilt = (0.0, 0.0) if k < 4 else rng.uniform(-2.0, 2.0, 2)
    euler = f"{tilt[0]} {tilt[1]} {rng.uniform(0.0, 120.0)}"
    mjm = _model(MESHES[name], euler)
    mjd = _rest(mjm, rng.uniform(0.0005, 0.02))
    if k < 4:
      ref = sorted((c.dist, *c.pos) for c in mjd.contact)
      ours = _at_c_frames(mjm, mjd)
      assert len(ours) == len(ref)
      np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
      counts.add(len(ref))
    else:
      counts.add(_compare(mjm, mjd))
  assert max(counts) <= 3


def test_convex_mesh_at_rest_matches_c():
  """convex_mesh at rest: C's plane contacts of both meshes (2 each), and
  qacc with each mesh alone on the plane at its rest pose (the whole
  scene's qacc also carries its mesh-mesh and capsule-mesh contacts,
  which are not C's: ROADMAP §3)."""
  xml = mt.asset_path("convex_mesh.xml").read_text()
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  ct = mt.forward(m, mt.put_data(m, mjd)).contact
  for geom in (1, 2):     # the icosahedron, the tetrahedron
    ref = sorted((c.dist, tuple(c.pos)) for c in mjd.contact
                 if (c.geom1, c.geom2) == (0, geom))
    sel = ((ct.geom1[0] == 0) & (ct.geom2[0] == geom)
           & (ct.dist[0] < ct.includemargin[0])).numpy()
    ours = sorted((float(ct.dist[0, i]), tuple(ct.pos[0, i].tolist()))
                  for i in np.nonzero(sel)[0])
    assert len(ref) == len(ours) == 2
    np.testing.assert_allclose([[r[0], *r[1]] for r in ours],
                               [[r[0], *r[1]] for r in ref], atol=1e-7)
  for keep in ("ico", "tet"):
    alone = xml
    for body in {"ico", "tet", "box", "ball", "capsule"} - {keep}:
      alone = re.sub(rf'\s*<body name="{body}".*?</body>', "", alone,
                     flags=re.S)
    mjm = mujoco.MjModel.from_xml_string(alone)
    mjd = mujoco.MjData(mjm)
    mujoco.mj_forward(mjm, mjd)
    assert _compare(mjm, mjd) == 2


def test_mesh_graph_reads_a_global_id_as_local_below_ten_vertices():
  """The cube's tables: no hill climb (8 vertices), and the vertices C
  tries after support vertex k are the graph neighbours of local vertex
  k, whatever vertex that is."""
  mjm = _model(MESHES["cube"], "0 0 0")
  graph = mjm.mesh_graph[mjm.mesh_graphadr[0]:]
  g = hull.mesh_graph(mjm.mesh_vert[:8], graph)
  numvert = int(graph[0])
  gid = graph[2 + numvert:2 + 2 * numvert]
  assert not g.climb and numvert == 8
  for k in range(8):
    i, want = int(graph[2 + k]), []
    while graph[2 + 2 * numvert + i] >= 0:
      want.append(int(gid[graph[2 + 2 * numvert + i]]))
      i += 1
    row = g.extra[k]
    assert list(row[row >= 0]) == want
  assert not np.array_equal(gid, np.arange(8))
