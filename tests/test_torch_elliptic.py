"""The PyTorch port's elliptic friction cones, in float64 on the CPU.

* ``forward`` and ``inverse`` of ``tests/test_elliptic.py``'s scene (a
  sphere and a capsule on a plane) at (impratio, condim) in {(1, 3),
  (1.5, 6), (3, 4)} against C MuJoCo and the JAX package, 1e-9;
* 100 steps of its fast-sliding trajectory against C (qpos 1e-9, qvel
  1e-8), with slots in the cone's middle zone along the way;
* the vendored Newton-100 humanoid under the elliptic cone, feet on the
  floor, against C's forward and inverse (1e-6), two seeds, and the
  vendored box_stack against C's forward;
* ``transition_ad`` on sliding states with middle-zone slots against C's
  ``mjd_transitionFD`` (1e-4 of max|A|), with functorch's vmap fallback
  made an error;
* the vendored ``elliptic_pairs`` model (condim 1, 3, 4 and 6, an
  explicit <pair>): its snapshot, its touch, force and torque sensors
  against C, and the fork's inverse_test on it;
* the cone's pieces against the JAX package's: the zones and forces of
  ``forces_cost``, and the cone Hessian against the derivative of the
  cone's force.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import warnings

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import constraint as jconstraint
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import linalg, math
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

SCENE = """
<mujoco>
  <option cone="elliptic" timestep="0.002" impratio="{impratio}"/>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body pos="0 0 0.099"><freejoint/>
      <geom type="sphere" size="0.1" mass="1" friction="0.8 0.01 0.002"/>
    </body>
    <body pos="0.3 0 0.097" euler="0 90 0"><freejoint/>
      <geom type="capsule" size="0.05 0.1" mass="0.4" condim="{condim}"/>
    </body>
  </worldbody>
</mujoco>
"""


def _setup(xml, seed=0, vel=0.3):
  """``tests/test_elliptic.py::_setup``: random velocities, C's forward."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = vel * np.random.RandomState(seed).randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  return mjm, mjd


def _jar(d):
  return math.matvec(d.efc_J, d.qacc) - d.efc_aref


def middle_slots(m, d) -> int:
  """Elliptic slots in the cone's middle zone at the solved qacc."""
  return int(constraint.cone_quantities(m, d, _jar(d)).middle.sum())


@pytest.mark.parametrize("impratio,condim", [(1.0, 3), (1.5, 6), (3.0, 4)])
def test_forward_inverse_match_c_and_jax(impratio, condim):
  mjm, mjd = _setup(SCENE.format(impratio=impratio, condim=condim))
  m = mt.put_model(mjm, device="cpu")
  d = mt.put_data(m, mjd)
  out = mt.forward(m, d)
  mj = mi.put_model(mjm)
  outj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  for ref in (mjd, outj):
    np.testing.assert_allclose(out.qacc[0].numpy(), np.asarray(ref.qacc),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(out.qfrc_constraint[0].numpy(),
                               np.asarray(ref.qfrc_constraint), rtol=0,
                               atol=1e-9)
  # condim rows a contact: the active ones are C's
  assert int(out.efc_active.sum()) == mjd.nefc
  mujoco.mj_inverse(mjm, mjd)
  inv = mt.inverse(m, d.replace(qacc=torch.as_tensor(mjd.qacc)[None]))
  np.testing.assert_allclose(inv.qfrc_inverse[0].numpy(), mjd.qfrc_inverse,
                             rtol=0, atol=1e-9)


def test_sliding_trajectory_matches_c():
  """Fast sliding keeps slots in the middle zone; 100 steps against C."""
  mjm, mjd = _setup(SCENE.format(impratio=1.0, condim=3), vel=1.5)
  m = mt.put_model(mjm, device="cpu")
  d = mt.put_data(m, mjd)
  middle = 0
  for _ in range(100):
    mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
    middle += middle_slots(m, mt.forward(m, d))
  assert middle > 0
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, rtol=0, atol=1e-9)
  np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, rtol=0, atol=1e-8)


def _humanoid_state(mjm, mjd, seed):
  """``tests/test_torch_inverse.py``'s state: feet on the floor, random
  joint angles, velocities, controls and applied forces."""
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] -= 0.22
  mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
  mjd.qfrc_applied[:] = 0.3 * rng.randn(mjm.nv)
  mjd.xfrc_applied[:] = 0.3 * rng.randn(mjm.nbody, 6)


@pytest.mark.parametrize("seed", [0, 3])
def test_humanoid_matches_c(seed):
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  mjm.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  mjd = mujoco.MjData(mjm)
  _humanoid_state(mjm, mjd, seed)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0
  m = mt.put_model(mjm, device="cpu")
  d = mt.put_data(m, mjd)
  out = mt.forward(m, d)
  assert out.efc_J.shape[1] < constraint.row_layout(
      mt.put_model(mt.asset_path("humanoid.npz"), device="cpu")).nefc
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-6)
  mujoco.mj_inverse(mjm, mjd)
  inv = mt.inverse(m, d.replace(qacc=torch.as_tensor(mjd.qacc)[None]))
  np.testing.assert_allclose(inv.qfrc_inverse[0].numpy(), mjd.qfrc_inverse,
                             rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_box_stack_matches_c(seed):
  """The vendored box_stack under the elliptic cone, at rest in contact
  with small random velocities: C's rows (24) and qacc, to 1e-8 of
  max|qacc| (C solves each constraint island on its own).  convex_mesh
  is not held to C here: its plane-mesh contacts differ from C's under
  either cone (ROADMAP §3)."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("box_stack.xml")))
  mjm.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = 0.05 * np.random.RandomState(seed).randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  assert int(out.efc_active.sum()) == mjd.nefc
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-8 * np.abs(mjd.qacc).max())


def _transition(m, d):
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      return derivative.transition_ad(m, d)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("condim", [3, 6])
def test_transition_ad_in_the_middle_zone_matches_c(condim):
  """The sphere and the capsule sliding fast, every elliptic slot in the
  middle zone: A of transition_ad (the Newton step's tangent with the cone
  Hessian) against C's centered differences."""
  mjm, mjd = _setup(SCENE.format(impratio=1.0, condim=condim))
  # both on the plane, 1.4 and 0.7 mm deep: off the impedance's kinks
  # (solimp's width 1 mm and midpoint 0.5 mm), where C's centered
  # differences average two slopes
  mjd.qpos[2], mjd.qpos[9] = 0.0986, 0.0493
  mjd.qvel[:] = 0.0
  mjd.qvel[[0, 6]] = [1.0, -0.8]          # both slide along x
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.put_data(m, mjd))
  assert middle_slots(m, d) == 3
  ad = _transition(m, d)
  a = np.zeros((2 * mjm.nv, 2 * mjm.nv))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 1, a, None, None, None)
  np.testing.assert_allclose(ad.A[0].numpy(), a, rtol=0,
                             atol=1e-4 * np.abs(a).max())


def test_elliptic_pairs_snapshot():
  """elliptic_pairs.npz is what save_model_snapshot writes from the
  vendored XML, and put_model gives the same Model from either."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(
      "elliptic_pairs.xml")))
  fresh = mt.put_model(mjm, device="cpu")
  snap = mt.put_model(mt.asset_path("elliptic_pairs.npz"), device="cpu")
  for field in fresh.__dataclass_fields__:
    a, b = getattr(fresh, field), getattr(snap, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field
    elif isinstance(a, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=field)
  assert snap.opt.cone == 1 and snap.opt.impratio == 1.5
  assert len(snap.pair_geom1) == 1
  assert sorted(set(collision.contact_layout(snap).dim)) == [
      1, 3, 4, 6]


@pytest.mark.parametrize("seed", [0, 1])
def test_elliptic_pairs_sensors_match_c(seed):
  """Touch on the ball, the capsule and the box, and force and torque at
  the flap's hinge, against C at a seeded state, each body in contact.
  C solves each constraint island (the ball, the capsule, the box with its
  flap) to the solver's tolerance on its own, the port all of them in one
  Newton solve: qacc and sensordata agree to 1e-8 of their largest
  magnitude, not to the last bits."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(
      "elliptic_pairs.xml")))
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qvel[:] = 0.05 * rng.randn(mjm.nv)
  mjd.qfrc_applied[:] = 0.5 * rng.randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  assert (mjd.sensordata[:3] > 0).all()
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-8 * np.abs(mjd.qacc).max())
  np.testing.assert_allclose(out.sensordata[0].numpy(), mjd.sensordata,
                             rtol=0, atol=1e-8 * np.abs(mjd.sensordata).max())


def test_elliptic_pairs_inverse_test():
  """The fork's inverse_test: 8 lanes, 20 RK4 steps with fresh random
  applied forces and controls each step, forward and inverse consistent
  within the fork's 1e-6."""
  snap = dict(np.load(mt.asset_path("elliptic_pairs.npz")))
  snap["opt_integrator"] = np.array(1)
  m = mt.put_model(snap, device="cpu")
  d = mt.make_data(m, 8)
  rng = np.random.RandomState(2)
  worst = 0.0
  for _ in range(20):
    d = d.replace(qfrc_applied=torch.as_tensor(
        0.5 * rng.randn(8, m.nv)))
    d = mt.step(m, d)
    out = mt.compare_fwd_inv(m, mt.forward(m, d))
    worst = max(worst, float(out.solver_fwdinv.max()))
  assert torch.isfinite(d.qpos).all()
  assert worst <= 1e-6


def test_cone_pieces_match_jax():
  """forces_cost on the elliptic rows and its zones against the JAX
  package's at jar along a line through every zone; the cone Hessian is
  minus the derivative of the cone's force in jar."""
  mjm, mjd = _setup(SCENE.format(impratio=1.5, condim=6), vel=1.0)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  mj = mi.put_model(mjm)
  dj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  rng = np.random.RandomState(5)
  nefc = out.efc_J.shape[1]
  jars = rng.randn(16, nefc) * np.abs(_jar(out)[0].numpy()).max()
  seen = torch.zeros(3, dtype=torch.bool)
  for jar in jars:
    force, cost, quad = constraint.forces_cost(m, out, torch.as_tensor(
        jar)[None])
    fj, cj, qj, _ = jconstraint.forces_cost(mj, dj, jnp.asarray(jar))
    np.testing.assert_allclose(force[0].numpy(), np.asarray(fj), rtol=0,
                               atol=1e-9 * max(1.0, np.abs(fj).max()))
    np.testing.assert_allclose(float(cost[0]), float(cj), rtol=1e-12)
    np.testing.assert_array_equal(quad[0].numpy(), np.asarray(qj))
    c = constraint.cone_quantities(m, out, torch.as_tensor(jar)[None])
    seen |= torch.stack([c.top.any(), c.bottom.any(), c.middle.any()])
  assert seen.all()

  # the Hessian of a middle-zone slot against the force's Jacobian
  ct = constraint.cone_tables(m)
  jar = torch.as_tensor(jars[0])[None]
  c = constraint.cone_quantities(m, out, jar)
  rows = ct.rows[c.middle[0].numpy()]
  assert len(rows)
  f = lambda x: constraint.forces_cost(m, out, x)[0]
  jac = torch.func.jacfwd(f)(jar)[0, :, 0]               # (nefc, nefc)
  hc = constraint.cone_hessian(m, c)[0][c.middle[0]]
  for h, r, msk in zip(hc, rows, ct.rmask[c.middle[0].numpy()]):
    r = r[msk]
    np.testing.assert_allclose(h[:len(r), :len(r)].numpy(),
                               -jac[np.ix_(r, r)].numpy(), rtol=0,
                               atol=1e-9 * float(h.abs().max()))


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (chip_smoke.py runs these on the card)")
  return torch.device("cuda")


def _elliptic(name, device):
  snap = dict(np.load(mt.asset_path(f"{name}.npz")))
  snap["opt_cone"] = np.array(1)
  return mt.put_model(snap, device=device)


def _with_plain_kernels(fn):
  """``fn()`` with the plain versions in the four kernels' place (as
  chip_smoke.py's plain_cholesky)."""
  plain = {"_factor": "chol_factor_ref", "_solve": "chol_solve_ref",
           "chol_factor_jvp": "chol_factor_jvp_ref",
           "chol_solve_jvp": "chol_solve_jvp_ref"}
  saved = {k: getattr(linalg, k) for k in plain}
  try:
    for k, ref in plain.items():
      setattr(linalg, k, getattr(linalg, ref))
    return fn()
  finally:
    for k, f in saved.items():
      setattr(linalg, k, f)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["box_stack", "convex_mesh", "humanoid",
                                  "elliptic_pairs"])
def test_kernels_match_plain_versions_on_card(cuda, name):
  """Phase 22 of chip_smoke.py: each model under the elliptic cone, 64
  lanes fp64, 5 steps with the kernels against 5 with the plain versions,
  qpos, qvel and efc_force within 1e-9."""
  m = _elliptic(name, cuda)
  rng = np.random.RandomState(22)
  d = mt.make_data(m, 64)
  d = d.replace(qvel=torch.as_tensor(0.1 * rng.randn(64, m.nv), device=cuda))
  before = linalg.chol_factor.launches
  d_k = d_p = d
  for _ in range(5):
    d_k = mt.step(m, d_k)
    d_p = _with_plain_kernels(lambda: mt.step(m, d_p))
  assert linalg.chol_factor.launches > before
  for f in ("qpos", "qvel", "efc_force"):
    assert float((getattr(d_k, f) - getattr(d_p, f)).abs().max()) <= 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("n, lanes", [(19, 4096), (19, 64), (7, 4096),
                                      (120, 4096), (6, 20 * 4096)])
def test_primal_kernels_bit_equal_at_new_shapes(cuda, n, lanes):
  """The factor and the solve at phase 22's new shapes (elliptic_pairs'
  nv and its box-with-flap block, sphere_budget's nv and its 20 free
  bodies' blocks), fp32 and fp64, bit-equal to the plain versions."""
  gen = torch.Generator(device=cuda).manual_seed(n)
  for dtype in (torch.float32, torch.float64):
    g = torch.randn((lanes, n, n), generator=gen, device=cuda, dtype=dtype)
    h = g @ g.transpose(1, 2) + n * torch.eye(n, device=cuda, dtype=dtype)
    b = torch.randn((lanes, n), generator=gen, device=cuda, dtype=dtype)
    l = linalg.chol_factor(h)
    assert torch.equal(l, linalg.chol_factor_ref(h))
    assert torch.equal(linalg.chol_solve(l, b), linalg.chol_solve_ref(l, b))


@pytest.mark.gpu
def test_jvp_kernels_match_plain_on_elliptic_transition(cuda):
  """transition_ad of 8 sliding elliptic box-stack lanes (fp64): the JVP
  kernels launch at 2 nv tangents a lane, and A equals the plain
  versions' within 1e-9."""
  m = _elliptic("box_stack", cuda)
  rng = np.random.RandomState(25)
  d = mt.forward(m, mt.make_data(m, 8).replace(
      qvel=torch.as_tensor(0.5 * rng.randn(8, m.nv), device=cuda)))
  before = linalg.chol_factor_jvp.launches
  ad = derivative.transition_ad(m, d)
  assert linalg.chol_factor_jvp.launches > before
  plain = _with_plain_kernels(lambda: derivative.transition_ad(m, d))
  assert float((ad.A - plain.A).abs().max()) <= 1e-9


def test_c_inverse_test_residual_passes_1e6_on_elliptic_box_stack():
  """The forward solve's residual, solver_fwdinv[1], is the Newton
  solver's at its stopping test, not round-off, under the elliptic cone:
  at this state of elliptic box_stack (RK4; one lane of chip_smoke.py's
  phase 22 inverse_test protocol, replayed on the CPU, stored in
  tests/elliptic_fwdinv_state.npz) C MuJoCo's own solver_fwdinv[1] is
  8.98e-5, above the fork's 1e-6.  The port's inverse is C's there:
  qfrc_inverse at C's qacc within 1e-9, and its fwdinv[0] round-off."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("box_stack.xml")))
  mjm.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
  m = mt.put_model(mjm, device="cpu")
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_FWDINV
  mjd = mujoco.MjData(mjm)
  state = np.load(os.path.join(os.path.dirname(__file__),
                               "elliptic_fwdinv_state.npz"))
  for k in state.files:
    getattr(mjd, k)[:] = state[k]
  mujoco.mj_forward(mjm, mjd)
  mujoco.mj_compareFwdInv(mjm, mjd)
  assert mjd.solver_fwdinv[1] > 1e-6
  d = mt.put_data(m, mjd)
  out = mt.compare_fwd_inv(m, mt.forward(m, d))
  assert float(out.solver_fwdinv[0, 0]) <= 1e-9
  mujoco.mj_inverse(mjm, mjd)
  inv = mt.inverse(m, d.replace(qacc=torch.as_tensor(mjd.qacc)[None]))
  np.testing.assert_allclose(inv.qfrc_inverse[0].numpy(), mjd.qfrc_inverse,
                             rtol=0, atol=1e-9)
