"""The PyTorch port's box and plane-cylinder collision, and the box stack.

In float64 on the CPU:

* ``_plane_box``, ``_plane_cylinder`` and ``_sphere_box`` against the JAX
  package's on 256 seeded poses each (``tests/collision_poses.py``),
  pair by pair as sets of (dist, pos, normal), 1e-10;
* plane-box, plane-cylinder and sphere-box (outside and inside) against C
  MuJoCo's contacts, with the rule of ``tests/test_collision_convex.py``
  (dist and pos 1e-6, normal 1e-5);
* the aligned two-box stack of ``tests/test_collision_convex.py`` (its
  ``qacc`` against C's, 1e-6), and the vendored ``box_stack`` model:
  its snapshot, the fork's inverse_test (8 lanes, 20 RK4 steps,
  ``solver_fwdinv`` <= 1e-6), and ``transition_ad`` against C's
  ``mjd_transitionFD`` where the contact sets coincide;
* every pair kind the port does not collide yet is refused by its name;
* the five earlier primitives, which now take the pair's margin, give the
  humanoid's contacts bit-equal to their form before the margin.
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
from mujoco_inversedynamicstest_tpu.ops import collision as jc
from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType
from mujoco_inversedynamicstest_tpu_torch.ops import collision as tc
from mujoco_inversedynamicstest_tpu_torch.ops import linalg, math
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

INPUTS = ("qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied", "qacc",
          "qacc_warmstart", "time")


def _centre_outside_box(case):
  """The sphere-box poses whose sphere centre lies outside the box: where
  the JAX package's inside branch is not C's (ROADMAP §3), the port
  follows C (``test_sphere_box_matches_c``)."""
  p1, m1, s1, p2, m2, s2, margin = case
  local = np.einsum("nji,nj->ni", m2, p1 - p2)
  out = (np.abs(local) > s2).any(1)
  return tuple(x[out] for x in case)


@pytest.mark.parametrize("name, case", [
    ("_plane_box", lambda: poses.plane_case(1, "box", 0.17)),
    ("_plane_cylinder", lambda: poses.plane_case(2, "cylinder", 0.12)),
    ("_sphere_box", lambda: _centre_outside_box(
        poses.pair_case(3, "sphere", "box", 0.07, 0.15))),
])
def test_primitive_matches_jax(name, case):
  ncontact, ties = poses.compare_with_jax(getattr(jc, name),
                                          getattr(tc, name), case())
  assert ncontact >= poses.N // 3 and ties <= poses.N // 8


def _c_contacts(mjm, mjd):
  mujoco.mj_forward(mjm, mjd)
  return [(float(c.dist), np.array(c.pos), np.array(c.frame[:3]),
           int(c.geom1), int(c.geom2)) for c in mjd.contact]


def _port_contacts(mjm, mjd):
  """The port's active contacts of one lane, as ``_c_contacts`` gives C's."""
  m = mt.put_model(mjm, device="cpu")
  ct = mt.forward(m, mt.put_data(m, mjd)).contact
  act = (ct.dist[0] < ct.includemargin[0]).numpy()
  return [(float(ct.dist[0, i]), ct.pos[0, i].numpy(),
           ct.frame[0, i, 0].numpy(), int(ct.geom1[0, i]), int(ct.geom2[0, i]))
          for i in np.nonzero(act)[0]]


def match(ours, ref, atol=1e-6):
  """``tests/test_collision_convex.py::_match``: every C contact has a
  counterpart in ours (dist and pos within atol, normal within 1e-5, the
  normal flipped where the geoms are swapped).  Returns the count."""
  used = set()
  for dist, pos, nrm, g1, g2 in ref:
    for j, (d2, p2, n2, h1, h2) in enumerate(ours):
      n_ref = -nrm if (g1, g2) != (h1, h2) else nrm
      if (j not in used and abs(dist - d2) < atol
          and np.allclose(pos, p2, atol=atol)
          and np.allclose(n_ref, n2, atol=1e-5)):
        used.add(j)
        break
    else:
      raise AssertionError(f"C contact not matched: dist={dist} pos={pos} "
                           f"n={nrm}\nours={ours}")
  return len(used)


def _one(body2, plane=True, body1=""):
  floor = '<geom type="plane" size="2 2 .1"/>' if plane else ""
  return mujoco.MjModel.from_xml_string(
      f"<mujoco><worldbody>{floor}{body1}{body2}</worldbody></mujoco>")


@pytest.mark.parametrize("body, ncon", [
    ('<body pos="0.1 0.2 0.095" euler="0 0 30"><freejoint/>'
     '<geom type="box" size="0.1 0.05 0.1"/></body>', 4),
    ('<body pos="0.1 0.2 0.097" euler="20 10 0"><freejoint/>'
     '<geom type="box" size="0.1 0.08 0.06"/></body>', 1),
    ('<body pos="0.1 0 0.048"><freejoint/>'
     '<geom type="cylinder" size="0.05 0.05"/></body>', 3),
    ('<body pos="0.1 0.2 0.067" euler="35 0 0"><freejoint/>'
     '<geom type="cylinder" size="0.05 0.05"/></body>', 1),
    ('<body pos="0.1 0.2 0.048" euler="90 0 0"><freejoint/>'
     '<geom type="cylinder" size="0.05 0.08"/></body>', 2),
], ids=["box-flat", "box-corner", "cylinder-standing", "cylinder-tilted",
        "cylinder-lying"])
def test_plane_box_and_cylinder_match_c(body, ncon):
  """The 4 bottom corners of a flat box and the lowest of a tilted one;
  the rim and flanking points of a standing, a tilted and a lying
  cylinder: C's contacts, and no others."""
  mjm = _one(body)
  mjd = mujoco.MjData(mjm)
  ref, ours = _c_contacts(mjm, mjd), _port_contacts(mjm, mjd)
  assert len(ref) == ncon
  assert match(ours, ref) == len(ours) == ncon


@pytest.mark.parametrize("pos", [
    "0.13 0.02 0.15", "0.04 0.13 0.1", "0.02 -0.01 0.06", "0.07 0.01 0.1",
    "-0.01 -0.075 0.12", "0.01 0.0 0.17"], ids=[
        "outside-face", "outside-edge", "inside-bottom", "inside-side",
        "inside-back", "inside-top"])
def test_sphere_box_matches_c(pos):
  """A sphere against a box's face and edge from outside, and with its
  centre inside the box near four of its faces (C's inside branch, which
  the JAX package's differs from: ROADMAP §3)."""
  mjm = _one(f'<body pos="{pos}"><freejoint/><geom type="sphere" '
             'size="0.05"/></body>', plane=False,
             body1='<body pos="0 0 0.1"><freejoint/><geom type="box" '
             'size="0.1 0.1 0.1"/></body>')
  mjd = mujoco.MjData(mjm)
  ref, ours = _c_contacts(mjm, mjd), _port_contacts(mjm, mjd)
  assert len(ref) == 1
  assert match(ours, ref) == len(ours) == 1


ALIGNED_STACK = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 0.0995"><freejoint/>
      <geom type="box" size="0.1 0.1 0.1" mass="1"/></body>
    <body pos="0.02 0.01 0.2985"><freejoint/>
      <geom type="box" size="0.08 0.08 0.08" mass="0.5"/></body>
  </worldbody>
</mujoco>"""


def test_aligned_stack_qacc_matches_c():
  """``tests/test_collision_convex.py::test_box_stack_forward_dynamics_
  parity`` on the port: the same active contact count as C, qacc 1e-6."""
  mjm = mujoco.MjModel.from_xml_string(ALIGNED_STACK)
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = 0.05 * np.random.RandomState(3).randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  assert int((out.contact.dist < out.contact.includemargin).sum()) == (
      mjd.ncon) == 4
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-6)


def _box_stack(integrator=None):
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("box_stack.xml")))
  if integrator is not None:
    mjm.opt.integrator = integrator
  return mjm


def test_box_stack_snapshot(monkeypatch):
  """box_stack.npz is what save_model_snapshot writes from the vendored
  XML; put_model reads it with no mujoco importable and gives the Model of
  the compiled XML: nv 36, every pair kind of the slice, 41 slots."""
  mjm = _box_stack()
  fresh = mt.put_model(mjm, device="cpu")
  monkeypatch.setitem(sys.modules, "mujoco", None)
  snap = mt.put_model(mt.asset_path("box_stack.npz"), device="cpu")
  for field in fresh.__dataclass_fields__:
    a, b = getattr(fresh, field), getattr(snap, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field
    elif isinstance(a, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=field)
  lay = tc.contact_layout(snap)
  assert snap.nv == 36 and lay.ncon == 41 and snap.mesh_hull == ()
  assert {(g.types[0].name, g.types[1].name) for g in lay.groups} == {
      ("PLANE", "BOX"), ("BOX", "BOX"), ("SPHERE", "BOX"),
      ("CAPSULE", "BOX"), ("PLANE", "CYLINDER"), ("PLANE", "SPHERE"),
      ("PLANE", "CAPSULE"), ("SPHERE", "CAPSULE")}


def test_box_stack_inverse_test():
  """The fork's inverse_test on box_stack: 8 lanes, RK4, fresh applied
  forces every step, 20 steps; both solver_fwdinv entries <= 1e-6."""
  mjm = _box_stack(mujoco.mjtIntegrator.mjINT_RK4)
  m = mt.put_model(mjm, device="cpu")
  gen = torch.Generator().manual_seed(10)
  randn = lambda *s: torch.randn(s, generator=gen, dtype=m.dtype)
  d = mt.make_data(m, 8)
  active = 0
  for _ in range(20):
    d = d.replace(qfrc_applied=0.3 * randn(8, m.nv),
                  xfrc_applied=0.3 * randn(8, m.nbody, 6))
    fwd = mt.compare_fwd_inv(m, mt.forward(m, d))
    assert float(fwd.solver_fwdinv.max()) <= 1e-6
    active = max(active, int((fwd.contact.dist < fwd.contact.includemargin
                              ).sum(1).min()))
    d = mt.step(m, d)
  assert active >= 8 and torch.isfinite(d.qpos).all()


def test_box_stack_transition_matches_c():
  """transition_ad on box_stack with the bottom box flat on the plane (its
  4 corners 0.2 mm in) and the other bodies apart in the air, where the
  port's contacts are C's: A within 1e-6 of max|A| of C's
  mjd_transitionFD, with functorch's vmap fallback made an error.  C's
  centered differences (eps 1e-6), as tests/test_torch_sensor_derivative.py
  holds A: its forward ones are 2.4e-4 of max|A| off the centered ones
  here (their O(eps) truncation at a stiff contact)."""
  mjm = _box_stack()
  mjd = mujoco.MjData(mjm)
  q = mjd.qpos.reshape(6, 7)
  q[0, :3] = [0.0, 0.0, 0.0998]
  for k in range(1, 6):
    q[k, :3] = [0.4 * k, 0.0, 1.0]
  mjd.qvel[:] = 0.05 * np.random.RandomState(4).randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon == 4
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.from_jax_arrays(m, {
      k: np.atleast_1d(np.array(getattr(mjd, k)))[None] for k in INPUTS}))
  assert int((d.contact.dist < d.contact.includemargin).sum()) == 4
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      ad = derivative.transition_ad(m, d)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
  a = np.zeros((2 * mjm.nv, 2 * mjm.nv))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 1, a, None, None, None)
  np.testing.assert_allclose(ad.A[0].numpy(), a, rtol=0,
                             atol=1e-6 * np.abs(a).max())
  assert ad.B.shape == (1, 2 * mjm.nv, 0)


def _snapshot(off=(), **change):
  """box_stack's snapshot with the geoms ``off`` colliding with nothing and
  each ``field=(index, value)`` set (index None: the whole field)."""
  with np.load(mt.asset_path("box_stack.npz")) as z:
    snap = {k: z[k].copy() for k in z.files}
  for g in off:
    snap["geom_contype"][g] = snap["geom_conaffinity"][g] = 0
  for k, (i, v) in change.items():
    if i is None:
      snap[k] = np.array(v)
    else:
      snap[k][i] = v
  return snap


# box_stack's geoms: 0 plane, 1-3 boxes, 4 sphere, 5 capsule, 6 cylinder;
# the first pair of the geoms that collide names the refusal
ELLIPSOID, CYLINDER, HFIELD, SDF = 4, 5, 1, 8


@pytest.mark.parametrize("off, change, what", [
    ((), dict(geom_type=(4, ELLIPSOID)), "PLANE-ELLIPSOID"),
    ((0,), dict(geom_type=(4, ELLIPSOID)), "ELLIPSOID-BOX"),
    ((0, 1, 2, 3), dict(geom_type=(5, ELLIPSOID)), "SPHERE-ELLIPSOID"),
    ((), dict(geom_contype=(6, 1)), "CYLINDER-BOX"),
    ((0, 1, 2, 3), dict(geom_contype=(6, 1)), "SPHERE-CYLINDER"),
    ((0, 1, 2, 3, 4), dict(geom_contype=(6, 1)), "CAPSULE-CYLINDER"),
    ((0, 1, 2, 3, 4), dict(geom_type=(5, CYLINDER), geom_contype=(6, 1)),
     "CYLINDER-CYLINDER"),
    ((1, 2, 3, 4, 5), dict(geom_type=(0, HFIELD), geom_contype=(6, 1)),
     "HFIELD-CYLINDER"),
    # SDF geoms collide now (their plugins' clearance descent); a geom of
    # type SDF without a plugin is refused by that name
    ((), dict(geom_type=(1, SDF)), "SDF geom backed by plugin '<none>'"),
    ((), dict(npair=(None, 1), pair_geom1=(None, [6]), pair_geom2=(None, [1]),
              pair_dim=(None, [3]), pair_margin=(None, [0.0]),
              pair_gap=(None, [0.0]),
              pair_friction=(None, [[1.0, 1.0, 0.005, 1e-4, 1e-4]]),
              pair_solref=(None, [[0.02, 1.0]]),
              pair_solreffriction=(None, [[0.0, 0.0]]),
              pair_solimp=(None, [[0.9, 0.95, 0.001, 0.5, 2.0]])),
     "collision pair CYLINDER-BOX"),
    # flexes collide now; a flex feature the port does not compute is
    # refused by its name, before anything of the flex is read
    ((), dict(nflex=(None, 1), nflexbending=(None, 1)),
     "flex bending elasticity"),
], ids=["plane-ellipsoid", "ellipsoid-box", "sphere-ellipsoid",
        "cylinder-box", "sphere-cylinder", "capsule-cylinder",
        "cylinder-cylinder", "hfield", "sdf", "explicit-pair", "flex"])
def test_put_model_refuses_unported_pairs(off, change, what):
  """Each pair kind the port does not collide is refused by its name when
  the model is loaded; the cylinder and ellipsoid pairs, refused until
  they were ported, now load and form their group (an explicit <pair>
  too)."""
  if what.split()[-1] in PORTED_SINCE:
    m = mt.put_model(_snapshot(off, **change), device="cpu")
    groups = {f"{g.types[0].name}-{g.types[1].name}": g
              for g in tc.contact_layout(m).groups}
    assert what.split()[-1] in groups
    if "pair" in what:
      assert (groups[what.split()[-1]].ipair >= 0).all()
    return
  with pytest.raises(NotImplementedError, match=what):
    mt.put_model(_snapshot(off, **change), device="cpu")


# the kinds of the refusal cases that ops/collision_sdf.py now collides
PORTED_SINCE = {"PLANE-ELLIPSOID", "ELLIPSOID-BOX", "SPHERE-ELLIPSOID",
                "CYLINDER-BOX", "SPHERE-CYLINDER", "CAPSULE-CYLINDER",
                "CYLINDER-CYLINDER"}


def _old_one_slot(dist, pos, n):
  return (dist[..., None], pos[..., None, :], n[..., None, :],
          torch.zeros_like(pos)[..., None, :])


# the five primitives as they were before they took the pair's margin
def _old_plane_sphere(p1, m1, s1, p2, m2, s2):
  nrm = m1[..., :, 2]
  dist, pos = _old_dist_pos(p1, nrm, p2, s2[:, 0])
  return dist[..., None], pos[..., None, :], nrm[..., None, :], (
      torch.zeros_like(pos)[..., None, :])


def _old_dist_pos(p1, nrm, p2, r):
  dist = torch.sum((p2 - p1) * nrm, dim=-1) - r
  return dist, p2 - nrm * (r + 0.5 * dist)[..., None]


def _old_plane_capsule(p1, m1, s1, p2, m2, s2):
  nrm = m1[..., :, 2]
  axis = m2[..., :, 2]
  seg = axis * s2[:, 1:2]
  d1, c1 = _old_dist_pos(p1, nrm, p2 + seg, s2[:, 0])
  d2, c2 = _old_dist_pos(p1, nrm, p2 - seg, s2[:, 0])
  return (torch.stack([d1, d2], -1), torch.stack([c1, c2], -2),
          torch.stack([nrm, nrm], -2), torch.stack([axis, axis], -2))


def _old_sphere_sphere_raw(p1, r1, p2, r2, fallback_n):
  dif = p2 - p1
  length = math.norm_safe(dif)
  dist = length - r1 - r2
  n = torch.where((length < math.MINVAL)[..., None], fallback_n,
                  dif / length[..., None])
  pos = p1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _old_sphere_sphere(p1, m1, s1, p2, m2, s2):
  fb = math.normalize(math.cross(m1[..., :, 2], m2[..., :, 2]))
  return _old_one_slot(*_old_sphere_sphere_raw(p1, s1[:, 0], p2, s2[:, 0],
                                               fb))


def _old_sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis = m2[..., :, 2]
  x = torch.sum(axis * (p1 - p2), dim=-1)
  x = torch.minimum(torch.maximum(x, -s2[:, 1]), s2[:, 1])
  near = p2 + axis * x[..., None]
  fb = math.normalize(math.cross(m1[..., :, 2], axis))
  return _old_one_slot(*_old_sphere_sphere_raw(p1, s1[:, 0], near, s2[:, 0],
                                               fb))


def _old_capsule_capsule(p1, m1, s1, p2, m2, s2):
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
  return _old_one_slot(*_old_sphere_sphere_raw(q1, s1[:, 0], q2, s2[:, 0],
                                               fb))


_OLD = {name: globals()[f"_old{name}"] for name in (
    "_plane_sphere", "_plane_capsule", "_sphere_sphere", "_sphere_capsule",
    "_capsule_capsule")}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_humanoid_contacts_bit_equal_to_margin_free_primitives(dtype):
  """The humanoid's five primitive pair kinds give the same bits with the
  margin argument as without it, on 8 seeded lanes with feet on the floor
  and limbs touching."""
  m = mt.put_model(mt.asset_path("humanoid.npz"), device="cpu", dtype=dtype)
  rng = np.random.RandomState(0)
  d = mt.make_data(m, 8)
  dq = np.zeros((8, m.nq))
  dq[:, 2] = -0.22
  dq[:, 7:] = 0.5 * rng.randn(8, m.nq - 7)
  d = mt.fwd_position(m, d.replace(
      qpos=d.qpos + torch.as_tensor(dq, dtype=dtype)))
  lay = tc.contact_layout(m)
  dists = []
  for grp, margin in zip(lay.groups, tc.group_margins(m)):
    fn = tc._NARROWPHASE[grp.types][0]
    g1, g2 = m.const(grp.geom1), m.const(grp.geom2)
    args = (d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1],
            d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2])
    new, old = fn(*args, margin), _OLD[fn.__name__](*args)
    for a, b in zip(new, old):
      assert torch.equal(a, b), fn.__name__
    dists.append(new[0].reshape(8, -1))
  assert {tc._NARROWPHASE[g.types][0].__name__ for g in lay.groups} == set(
      _OLD)
  dist = torch.cat(dists, 1)
  assert torch.equal(dist, tc.collision(m, d).contact.dist)
  assert int((dist < 0).sum()) >= 8


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (chip_smoke.py runs these on the card)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["box_stack", "convex_mesh"])
def test_kernels_match_plain_versions_on_card(cuda, name):
  """Phase 20 (c) of chip_smoke.py: 64 lanes fp64, 5 steps with the
  kernels against 5 with the plain versions, qpos, qvel and efc_force
  within 1e-9."""
  m = mt.put_model(mt.asset_path(f"{name}.npz"), device=cuda)
  rng = np.random.RandomState(20)
  d = mt.make_data(m, 64)
  d = d.replace(qvel=torch.as_tensor(0.1 * rng.randn(64, m.nv), device=cuda))
  d_k = d_p = d
  plain = {"_factor": "chol_factor_ref", "_solve": "chol_solve_ref"}
  saved = {k: getattr(linalg, k) for k in plain}
  before = linalg.chol_factor.launches
  for _ in range(5):
    d_k = mt.step(m, d_k)
    try:
      for k, ref in plain.items():
        setattr(linalg, k, getattr(linalg, ref))
      d_p = mt.step(m, d_p)
    finally:
      for k, fn in saved.items():
        setattr(linalg, k, fn)
  assert linalg.chol_factor.launches > before
  for f in ("qpos", "qvel", "efc_force"):
    assert float((getattr(d_k, f) - getattr(d_p, f)).abs().max()) <= 1e-9


def test_slot_counts_are_the_jax_packages():
  """The port's slot count of every pair kind it collides is the JAX
  package's (``_PAIR_SLOTS``), and so are its convex keys; except
  plane-mesh, where the port keeps C's 3 contacts (``mjc_PlaneConvex``)
  and the JAX package 4."""
  keys = (list(tc._NARROWPHASE) + list(tc._CONVEX_SLOTS)
          + list(tc._SDF_SLOTS) + list(tc._HFIELD_SLOTS))
  for key in keys:
    want = 3 if key == (GeomType.PLANE, GeomType.MESH) else jc._PAIR_SLOTS[key]
    assert tc._nslot(key) == want, key
  assert jc._PAIR_SLOTS[(GeomType.PLANE, GeomType.MESH)] == 4
  assert set(tc._CONVEX_SLOTS) == set(jc._CONVEX_KEYS)
