"""The PyTorch port's convex narrowphase (``ops/collision_convex.py``) and
its host-built hulls (``ops/hull.py``), and the convex_mesh model.

In float64 on the CPU:

* the hull topology of both vendored meshes equals the JAX package's
  ``hull.build_hull``, array by array;
* ``make_plane_convex`` on ``box_hull()``, ``make_sphere_convex``,
  ``make_capsule_convex`` and ``make_convex_convex`` on ``box_hull()`` and
  on both vendored hulls against the JAX package's on 256 seeded poses
  each (``tests/collision_poses.py``), pair by pair as sets of (dist, pos,
  normal), 1e-10; ``make_plane_mesh`` on both vendored hulls against C
  MuJoCo's ``mjc_PlaneConvex`` at the same poses, 1e-9;
* the configurations of ``tests/test_collision_convex.py`` against C
  MuJoCo with its ``_match`` rule (dist and pos 1e-6, normal 1e-5): face
  stacks, vertex-face, edge-edge, a capsule on a box lying and turned, the
  plane and the tetrahedron, a sphere on a mesh vertex, a capsule on a
  mesh edge;
* the convex_mesh snapshot, its fleet step and ``transition_ad`` (no
  functorch fallback, against ``transition_fd``), and a group run in lane
  chunks equal to the group run whole.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import sys
import warnings

import mujoco
import numpy as np
import pytest
import torch

import collision_poses as poses
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import collision_convex as jcc
from mujoco_inversedynamicstest_tpu.ops import hull as jhull
from mujoco_inversedynamicstest_tpu_torch.ops import collision as tc
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex as tcc
from mujoco_inversedynamicstest_tpu_torch.opt import derivative
from test_torch_collision_box import _c_contacts, _port_contacts, match

TET_ASSET = (
    '<asset><mesh name="tet" vertex="0 0 0  .2 0 0  0 .2 0  0 0 .2"/></asset>'
)


def _convex_mesh():
  return mujoco.MjModel.from_xml_path(str(mt.asset_path("convex_mesh.xml")))


def _hulls():
  """(JAX, port) hull of box_hull() and of each vendored mesh, with its
  reach and whether it is the box."""
  mjm = _convex_mesh()
  jax_h = jhull.mesh_hulls(mjm)
  port_h = mt.put_model(mjm, device="cpu").mesh_hull
  return {"box": (jcc.BOX_HULL, tcc.BOX_HULL, True, 0.2),
          "tet": (jax_h[0], port_h[0], False, 0.15),
          "ico": (jax_h[1], port_h[1], False, 0.1)}


def test_hull_topology_matches_jax():
  """The port's hulls, built in put_model from the snapshot arrays, are
  the JAX package's build_hull of the compiled meshes, and box_hull()."""
  mjm = _convex_mesh()
  port = mt.put_model(mt.asset_path("convex_mesh.npz"), device="cpu")
  assert len(port.mesh_hull) == mjm.nmesh == 2
  pairs = [(jcc.BOX_HULL, tcc.BOX_HULL)] + list(zip(
      jhull.mesh_hulls(mjm), port.mesh_hull))
  for ref, got in pairs:
    assert ref._fields == got._fields
    for field, a, b in zip(ref._fields, ref, got):
      np.testing.assert_array_equal(a, b, err_msg=field)
  tet, ico = port.mesh_hull
  assert (tet.nvert, len(tet.face), len(tet.edge)) == (4, 4, 6)
  assert (ico.nvert, len(ico.face), len(ico.edge)) == (12, 20, 30)


CASES = [("plane", k) for k in ("box", "tet", "ico")] + [
    ("sphere", k) for k in ("box", "tet", "ico")] + [
    ("capsule", k) for k in ("box", "tet", "ico")] + [
    ("box", "box"), ("box", "tet"), ("box", "ico"), ("ico", "tet")]


def _c_plane_mesh(case, kind):
  """C MuJoCo's plane-mesh contacts (``mjc_PlaneConvex``) at the poses of
  ``case``: convex_mesh's floor and its tet or ico geom are put at each
  pose (``geom_xpos``/``geom_xmat`` written, then ``mj_collision``), the
  mesh geom's margin set to the pair's; as (dist, pos, normal) slots
  padded with 1e10, the narrowphase's output."""
  mjm = _convex_mesh()
  mjd = mujoco.MjData(mjm)
  mujoco.mj_kinematics(mjm, mjd)
  geom = {"tet": 2, "ico": 1}[kind]
  assert mjm.geom_dataid[geom] == {"tet": 0, "ico": 1}[kind]
  n = len(case[0])
  dist = np.full((n, 3), 1e10)
  pos, nrm = np.zeros((n, 3, 3)), np.zeros((n, 3, 3))
  for i in range(n):
    mjm.geom_margin[geom] = case[6][i]
    mjd.geom_xpos[0], mjd.geom_xmat[0] = case[0][i], case[1][i].ravel()
    mjd.geom_xpos[geom] = case[3][i]
    mjd.geom_xmat[geom] = case[4][i].ravel()
    mujoco.mj_collision(mjm, mjd)
    k = 0
    for c in mjd.contact:
      if (int(c.geom1), int(c.geom2)) == (0, geom):
        dist[i, k], pos[i, k], nrm[i, k] = c.dist, c.pos, c.frame[:3]
        k += 1
  return dist, pos, nrm


@pytest.mark.parametrize("kind1, kind2", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_convex_narrowphase_matches_jax(kind1, kind2):
  """Against the JAX package, except plane-mesh: the port follows C
  MuJoCo's ``mjc_PlaneConvex`` (ROADMAP §3), and is held to C's contacts at
  the same poses, 1e-9, with no tie left open (both pick a tied vertex
  by the same rule, from supports summed in C's order)."""
  hulls = _hulls()
  j2, t2, box2, reach2 = hulls[kind2]
  seed = CASES.index((kind1, kind2)) + 10
  geom2 = "box" if box2 else "mesh"
  if kind1 == "plane" and not box2:
    m = mt.put_model(_convex_mesh(), device="cpu")
    did = {"tet": 0, "ico": 1}[kind2]
    geom = int(np.nonzero(m.geom_dataid == did)[0][0])
    fn = tcc.make_plane_mesh(m.mesh_graph[did], m.geom_rbound_np[geom])
    case = poses.plane_case(seed, geom2, reach2)
    ref, got = _c_plane_mesh(case, kind2), poses.run_torch(fn, case)
    errs = [poses.set_error(poses.contact_set(ref, i, case[6]),
                            poses.contact_set(got, i, case[6]))
            for i in range(poses.N)]
    assert max(errs) <= 1e-9, max(errs)
    assert (ref[0] < poses.ACTIVE).any(1).sum() >= poses.N // 5
    return
  if kind1 == "plane":
    fns = jcc.make_plane_convex(j2, box2), tcc.make_plane_convex(t2, box2)
    case = poses.plane_case(seed, geom2, reach2)
  elif kind1 in ("sphere", "capsule"):
    make = {"sphere": "make_sphere_convex", "capsule": "make_capsule_convex"}
    fns = (getattr(jcc, make[kind1])(j2, box2),
           getattr(tcc, make[kind1])(t2, box2))
    case = poses.pair_case(seed, kind1, geom2, 0.1, reach2)
  else:
    j1, t1, box1, reach1 = hulls[kind1]
    fns = (jcc.make_convex_convex(j1, box1, j2, box2),
           tcc.make_convex_convex(t1, box1, t2, box2))
    case = poses.pair_case(seed, "box" if box1 else "mesh", geom2, reach1,
                           reach2)
  # under jax.jit, XLA's CPU compile of the capsule-hull narrowphase breaks
  # ties of equal candidate depth (a capsule parallel to a face) otherwise
  # than the same JAX code run op by op, and otherwise than its jitted
  # runs at poses a nudge away: the port is held to the op-by-op run, which
  # it matches bit for bit (ROADMAP §3)
  ncontact, ties = poses.compare_with_jax(*fns, case,
                                          jit=kind1 != "capsule")
  assert ncontact >= poses.N // 5 and ties <= poses.N // 8


def _setup(xml):
  mjm = mujoco.MjModel.from_xml_string(xml)
  return mjm, mujoco.MjData(mjm)


def _contacts(xml):
  mjm, mjd = _setup(xml)
  return _c_contacts(mjm, mjd), _port_contacts(mjm, mjd)


@pytest.mark.parametrize("offset, euler", [
    ((0.03, 0.02, 0.17), (0, 0, 0)),
    ((0.05, -0.04, 0.165), (0, 0, 25)),
], ids=["aligned", "twisted"])
def test_box_box_face_manifold_matches_c(offset, euler):
  """C may give up to 8 manifold points, the port keeps 4: each of ours is
  one of C's, and there are min(4, C's) of them."""
  ref, ours = _contacts(f"""
  <mujoco><worldbody>
    <body pos="0 0 0.1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="{offset[0]} {offset[1]} {0.1 + offset[2]}"
          euler="{euler[0]} {euler[1]} {euler[2]}">
      <freejoint/><geom type="box" size="0.08 0.08 0.08"/></body>
  </worldbody></mujoco>""")
  assert len(ours) == min(4, len(ref)) and len(ref) > 0
  assert match(ref, ours) == len(ours)


def test_box_box_vertex_face_matches_c():
  ref, ours = _contacts("""
  <mujoco><worldbody>
    <body pos="0 0 0.1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="0.2 0.0 0.1" euler="0 0 40"><freejoint/>
      <geom type="box" size="0.08 0.08 0.08"/></body>
  </worldbody></mujoco>""")
  assert len(ref) == 2
  assert match(ours, ref) == 2


def test_box_box_edge_edge_matches_c():
  """C splits the edge-edge contact into 2 clipped points; each of the
  port's is at C's depth and normal (tests/test_collision_convex.py's
  rule)."""
  ref, ours = _contacts("""
  <mujoco><worldbody>
    <body pos="0 0 0.1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="0.16 0.0 0.305" euler="45 0 0"><freejoint/>
      <geom type="box" size="0.08 0.08 0.08"/></body>
  </worldbody></mujoco>""")
  assert len(ref) == 2 and len(ours) >= 1
  for dist, _, nrm, _, _ in ours:
    assert abs(dist - ref[0][0]) < 1e-6
    np.testing.assert_allclose(nrm, ref[0][2], atol=1e-5)


@pytest.mark.parametrize("pos, euler, size", [
    ("0.0 0.0 0.25", "90 0 0", "0.05 0.08"),
    ("0.05 0.05 0.21", "0 90 30", "0.03 0.08"),
], ids=["lying", "turned"])
def test_capsule_box_matches_c(pos, euler, size):
  ref, ours = _contacts(f"""
  <mujoco><worldbody>
    <body pos="0 0 0.1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="{pos}" euler="{euler}"><freejoint/>
      <geom type="capsule" size="{size}"/></body>
  </worldbody></mujoco>""")
  assert len(ref) == 2
  assert match(ours, ref) == 2


def test_plane_tet_matches_c():
  """All three bottom vertices at one depth: C keeps 2 (the support vertex
  and the first graph neighbour it tries, ``mjc_PlaneConvex``), and so does
  the port; each matches one of C's (mesh vertices are float32 in the
  compiled model, so depths agree to 1e-7)."""
  ref, ours = _contacts(f"""
  <mujoco>{TET_ASSET}<worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 -0.005"><freejoint/><geom type="mesh" mesh="tet"/></body>
  </worldbody></mujoco>""")
  assert match(ours, ref) == len(ref) == len(ours) == 2
  for dist, _, nrm, _, _ in ours:
    assert abs(dist - ref[0][0]) < 1e-7
    np.testing.assert_allclose(nrm, [0, 0, 1], atol=1e-7)


def test_sphere_mesh_vertex_matches_c():
  ref, ours = _contacts(f"""
  <mujoco>{TET_ASSET}<worldbody>
    <body pos="0 0 0"><freejoint/><geom type="sphere" size="0.05"/></body>
    <body pos="0.04 0 0"><freejoint/><geom type="mesh" mesh="tet"/></body>
  </worldbody></mujoco>""")
  assert len(ref) == 1
  assert match(ours, ref) == 1


def test_capsule_mesh_edge_matches_c():
  """C's contacts are among ours, and the deepest depths agree."""
  ref, ours = _contacts(f"""
  <mujoco>{TET_ASSET}<worldbody>
    <body pos="0 0 0.23" euler="0 90 0"><freejoint/>
      <geom type="capsule" size="0.03 0.15"/></body>
    <body pos="0 0 0"><freejoint/><geom type="mesh" mesh="tet"/></body>
  </worldbody></mujoco>""")
  assert len(ref) >= 1
  best = min(ours, key=lambda r: r[0])
  assert abs(best[0] - min(r[0] for r in ref)) < 1e-6


def test_convex_mesh_snapshot(monkeypatch):
  """convex_mesh.npz is what save_model_snapshot writes from the vendored
  XML; put_model reads it with no mujoco importable, builds both hulls,
  and forms every convex pair kind: nv 30."""
  mjm = _convex_mesh()
  fresh = mt.put_model(mjm, device="cpu")
  monkeypatch.setitem(sys.modules, "mujoco", None)
  snap = mt.put_model(mt.asset_path("convex_mesh.npz"), device="cpu")
  for field in fresh.__dataclass_fields__:
    a, b = getattr(fresh, field), getattr(snap, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field
    elif isinstance(a, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=field)
  assert snap.nv == 30 and len(snap.mesh_hull) == 2
  kinds = {(g.types[0].name, g.types[1].name, g.did1, g.did2)
           for g in tc.contact_layout(snap).groups}
  for pair in (("PLANE", "MESH", -1, 0), ("PLANE", "MESH", -1, 1),
               ("SPHERE", "MESH", -1, 0), ("CAPSULE", "MESH", -1, 1),
               ("BOX", "MESH", -1, 0), ("BOX", "MESH", -1, 1),
               ("MESH", "MESH", 1, 0), ("CAPSULE", "BOX", -1, -1)):
    assert pair in kinds, pair


def test_mesh_hulls_only_when_a_mesh_can_collide():
  """As the JAX package's put_model: no hull where every mesh geom has
  contype and conaffinity 0."""
  with np.load(mt.asset_path("convex_mesh.npz")) as z:
    snap = {k: z[k].copy() for k in z.files}
  mesh = snap["geom_type"] == 7
  snap["geom_contype"][mesh] = snap["geom_conaffinity"][mesh] = 0
  assert mt.put_model(snap, device="cpu").mesh_hull == ()


def test_convex_mesh_steps_and_linearizes():
  """2 lanes near rest (seeded velocities of 0.01) stepped 10 times stay
  finite with contacts on every lane; transition_ad runs with no functorch
  fallback and agrees with transition_fd (centered, eps 1e-7) within 1e-4
  of max|A|.  (At velocities of 0.05 a contact of one lane reaches its
  margin, and the differences jump across it.  Since plane-mesh keeps C's
  vertices, lane 1 reaches a state within 1e-6 of such a switch: centred
  differences at eps 1e-6 are 3.26 off those at 1e-7 and 1e-8, which agree
  with each other and with transition_ad to 5e-7.)"""
  m = mt.put_model(mt.asset_path("convex_mesh.npz"), device="cpu")
  rng = np.random.RandomState(6)
  d = mt.make_data(m, 2)
  d = mt.step_n(m, d.replace(qvel=torch.as_tensor(
      0.01 * rng.randn(2, m.nv))), 10)
  assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
  d = mt.forward(m, d)
  assert ((d.contact.dist < d.contact.includemargin).sum(1) >= 8).all()
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      ad = derivative.transition_ad(m, d)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
  fd = derivative.transition_fd(
      m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
      eps=1e-7, flg_centered=True)
  assert float((ad.A - fd.A).abs().max()) <= 1e-4 * float(fd.A.abs().max())


def test_group_in_lane_chunks_equals_whole(monkeypatch):
  """A hull-hull group whose edge-pair axes pass CONVEX_CHUNK_BYTES runs in
  chunks of lanes, with the same contacts to the bit."""
  m = mt.put_model(mt.asset_path("convex_mesh.npz"), device="cpu")
  rng = np.random.RandomState(7)
  d = mt.make_data(m, 5)
  d = mt.fwd_position(m, d.replace(qpos=mt.integrate_pos(
      m, d.qpos, torch.as_tensor(0.02 * rng.randn(5, m.nv)), 1.0)))
  whole = tc.collision(m, d).contact
  grp = [g for g in tc.contact_layout(m).groups if g.types[0] == 6][0]
  assert tc._lane_chunks(m, grp, 5, 8) == 1
  monkeypatch.setattr(tc, "CONVEX_CHUNK_BYTES", 4096)
  assert tc._lane_chunks(m, grp, 5, 8) == 5
  chunked = tc.collision(m, d).contact
  for f in ("dist", "pos", "frame"):
    assert torch.equal(getattr(whole, f), getattr(chunked, f)), f
