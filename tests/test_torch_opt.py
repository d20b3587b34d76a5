"""The PyTorch port's MPC path (``opt/`` of the port) on the CPU, f64.

Transition and inverse Jacobians against C MuJoCo's ``mjd_transitionFD`` /
``mjd_inverseFD`` and the JAX package, at the tolerances of
``tests/test_opt.py``; ``box_qp`` and the ARM fleet MPC against the JAX
package (the transitions' and the fleet MPC's JAX results are stored,
``tests/jax_reference.py``);
the humanoid north-star path against C ``mj_inverse``.  The port
solves a fleet at once where the JAX package ``vmap``s one problem, so the
JAX side is vmapped over the same numpy inputs.  ``transition_ad`` and
``inverse_ad`` (``vmap`` over ``jvp``, one primal a lane) are also held to
a folded forward-AD reference built here, and their dual step to primal
Cholesky calls at the lanes' batch with no functorch fallback.

On contact states the port differs from the JAX package on purpose
(ROADMAP queue 3): its line search follows C, and its solver gives qacc the
tangent of a Newton step, where the JAX package's ``jacfwd`` differentiates
the solver's iterations from a converged warm start and lands far from C.
The humanoid's Jacobians are therefore held to C, not to the JAX package.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import warnings

import jax
import mujoco
import numpy as np
import pytest
import torch

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
from mujoco_inversedynamicstest_tpu import opt as jopt
from mujoco_inversedynamicstest_tpu.ops import support as jsupport
from mujoco_inversedynamicstest_tpu.opt import northstar as jnorthstar
from mujoco_inversedynamicstest_tpu.opt import qp as jqp
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import linalg
from mujoco_inversedynamicstest_tpu_torch.opt import derivative, northstar
from mujoco_inversedynamicstest_tpu_torch.opt import qp

from models import FREEBODY_NOCON, NLINK_NOCON, PENDULUM

ARM = """
<mujoco>
  <option timestep="0.01"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j0" type="hinge" axis="0 1 0" damping="0.15"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0" mass="0.6"/>
      <body pos="0.25 0 0">
        <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.4"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="j0" gear="1" ctrlrange="-3 3"/>
    <motor joint="j1" gear="1" ctrlrange="-3 3"/>
  </actuator>
</mujoco>
"""
SMALL = {"pendulum": PENDULUM, "arm": ARM, "nlink": NLINK_NOCON}


def _setup(xml, seed=0):
  """A seeded state (as tests/test_opt.py makes it) after mj_forward, in C,
  the JAX package and the port."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0 + 0.1 * rng.randn(mjm.nq)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.2 * rng.randn(mjm.nv)
  if mjm.nu:
    mjd.ctrl[:] = 0.1 * rng.randn(mjm.nu)
  mujoco.mj_forward(mjm, mjd)
  mj = mi.put_model(mjm)
  mp = mt.put_model(mjm, device="cpu")
  return mjm, mjd, (mj, mi.put_data(mj, mjd)), (mp, mt.put_data(mp, mjd))


@pytest.mark.parametrize("xml", [FREEBODY_NOCON, NLINK_NOCON],
                         ids=["freebody", "nlink"])
def test_differentiate_pos_matches_jax(xml):
  """Batch-first (B, nq) -> (B, nv) against the JAX package lane by lane,
  and the inverse of integrate_pos."""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mj, mp = mi.put_model(mjm), mt.put_model(mjm, device="cpu")
  rng = np.random.RandomState(1)
  q1, q2 = (np.stack([_normalized(mjm, mjm.qpos0 + 0.3 * rng.randn(mjm.nq))
                      for _ in range(4)]) for _ in range(2))
  got = mt.differentiate_pos(mp, torch.as_tensor(q1), torch.as_tensor(q2),
                             0.5).numpy()
  ref = jax.vmap(lambda a, b: jsupport.differentiate_pos(mj, a, b, 0.5))(
      q1, q2)
  np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-12)
  v = torch.as_tensor(0.2 * rng.randn(4, mjm.nv))
  q = mt.integrate_pos(mp, torch.as_tensor(q1), v, 1.0)
  np.testing.assert_allclose(
      mt.differentiate_pos(mp, torch.as_tensor(q1), q, 1.0).numpy(),
      v.numpy(), rtol=0, atol=1e-12)


def _normalized(mjm, qpos):
  qpos = np.array(qpos)
  mujoco.mj_normalizeQuat(mjm, qpos)
  return qpos


@pytest.mark.parametrize("name", list(SMALL))
def test_transition_matches_jax_and_c(name):
  """AD and FD transition Jacobians against C mjd_transitionFD (5e-5) and
  each other (1e-5), the tolerances of tests/test_opt.py, and the AD ones
  against the JAX package's jacfwd (1e-9)."""
  mjm, mjd, (mj, dj), (mp, dp) = _setup(SMALL[name])
  nx = 2 * mjm.nv
  a_c, b_c = np.zeros((nx, nx)), np.zeros((nx, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-7, 1, a_c, b_c, None, None)

  dp = mt.forward(mp, dp)
  ad = derivative.transition_ad(mp, dp)
  fd = derivative.transition_fd(mp, dp, eps=1e-7, flg_centered=True)

  def jax_transition():
    jd = jax.jit(mi.forward)(mj, dj)
    out = jax.jit(lambda dd: jopt.transition_ad(mj, dd))(jd)
    return {"A": out.A, "B": out.B}

  ad_j = jax_reference.result(
      f"transition_{name}", [jax_reference.model_bytes(mjm)] + [
          np.atleast_1d(np.array(getattr(mjd, k))) for k in (
              "qpos", "qvel", "ctrl", "qacc_warmstart", "time")],
      jax_transition)

  assert ad.A.shape == (1, nx, nx) and ad.B.shape == (1, nx, mjm.nu)
  for tr in (ad, fd):
    np.testing.assert_allclose(tr.A[0].numpy(), a_c, rtol=0, atol=5e-5)
    np.testing.assert_allclose(tr.B[0].numpy(), b_c, rtol=0, atol=5e-5)
  np.testing.assert_allclose(ad.A.numpy(), fd.A.numpy(), rtol=0, atol=1e-5)
  np.testing.assert_allclose(ad.B.numpy(), fd.B.numpy(), rtol=0, atol=1e-5)
  np.testing.assert_allclose(ad.A[0].numpy(), ad_j["A"], rtol=0, atol=1e-9)
  np.testing.assert_allclose(ad.B[0].numpy(), ad_j["B"], rtol=0, atol=1e-9)


def _humanoid_state(drop, name="humanoid", seed=0):
  """The humanoid (by default the Newton-100 one) at a seeded pose,
  ``drop`` lower (0.22 puts the feet on the floor), after mj_forward."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(name + ".xml")))
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] -= drop
  mjd.qpos[7:] += 0.05 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.1 * rng.randn(mjm.nu)
  mujoco.mj_forward(mjm, mjd)
  return mjm, mjd


@pytest.mark.parametrize("drop, ncon", [(0.0, 1), (0.22, 5)],
                         ids=["airborne", "feet-on-floor"])
def test_humanoid_transition_matches_c(drop, ncon):
  """The humanoid (nx = 54, nu = 21) in the air at qpos0, where its only
  contact is foot against foot, and lowered onto the floor.  transition_ad
  against C mjd_transitionFD (centered, eps 1e-6): within 1e-6, C's own
  truncation and solver noise, on entries up to 2e2.  Against the port's
  transition_fd (centered, eps 1e-6): within 2e-3, since a perturbed solve
  stops at the solver's tolerance (1e-8 of the scaled gradient), and that
  error over 2 eps is what the FD carries."""
  mjm, mjd = _humanoid_state(drop)
  assert mjd.ncon == ncon
  nx = 2 * mjm.nv
  a_c, b_c = np.zeros((nx, nx)), np.zeros((nx, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 1, a_c, b_c, None, None)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, mt.put_data(mp, mjd))
  ad = derivative.transition_ad(mp, d)
  fd = derivative.transition_fd(mp, d, eps=1e-6, flg_centered=True)
  np.testing.assert_allclose(ad.A[0].numpy(), a_c, rtol=0, atol=1e-6)
  np.testing.assert_allclose(ad.B[0].numpy(), b_c, rtol=0, atol=1e-6)
  np.testing.assert_allclose(ad.A.numpy(), fd.A.numpy(), rtol=0, atol=2e-3)
  np.testing.assert_allclose(ad.B.numpy(), fd.B.numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("seed, ncon", [(0, 5), (1, 4)])
def test_humanoid_mjx_transition_matches_c(seed, ncon):
  """humanoid_mjx, the MPC model (one Newton iteration, 4 line-search
  rounds), on the floor and warm-started from mj_forward's qacc, as a
  rollout leaves it.  Its solve stops at the iteration limit short of the
  tolerance, so qacc's tangent is that of the iteration (ops/solver.py:
  _newton_tangent), and A, B are those of the map the rollouts step.
  transition_ad against C mjd_transitionFD (centered, eps 1e-6): within
  1e-3 on entries up to 4e3, the FD's own truncation error (it falls 100x
  when eps falls 10x).  The port's transition_fd against C's within 1e-5: each
  perturbed copy steps as C's does, with no jump of the line search where
  C's has none."""
  mjm, mjd = _humanoid_state(0.22, "humanoid_mjx", seed)
  assert mjd.ncon == ncon and mjm.opt.iterations == 1
  mjd.qacc_warmstart[:] = mjd.qacc
  nx = 2 * mjm.nv
  a_c, b_c = np.zeros((nx, nx)), np.zeros((nx, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 1, a_c, b_c, None, None)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.put_data(mp, mjd)
  ad = derivative.transition_ad(mp, d)
  fd = derivative.transition_fd(mp, d, eps=1e-6, flg_centered=True)
  assert np.abs(a_c).max() > 1e2
  for tr, tol in ((ad, 1e-3), (fd, 1e-5)):
    np.testing.assert_allclose(tr.A[0].numpy(), a_c, rtol=0, atol=tol)
    np.testing.assert_allclose(tr.B[0].numpy(), b_c, rtol=0, atol=tol)


def test_humanoid_mjx_fleet_diverges_in_c():
  """Why the MPC plan costs on humanoid_mjx reach 1e20 and more: the MPC
  fleet's initial states (northstar.make_fleet with chip_smoke.py's noise
  of 0.01) rolled out for 100 steps with zero controls in C MuJoCo.
  humanoid_mjx (1 Newton iteration) trips C's bad-state warning on 15 of
  16 lanes, with |qvel| up to 1e12; the Newton-100 humanoid on none, with
  |qvel| below 20."""
  warned, vmax = {}, {}
  for name in ("humanoid_mjx", "humanoid"):
    mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(name + ".xml")))
    mp = mt.put_model(mjm, device="cpu")
    fleet = northstar.make_fleet(mp, mt.make_data(mp, 1),
                                 northstar.NorthStarConfig(
                                     fleet=16, qpos_noise=0.01,
                                     qvel_noise=0.01))
    warned[name], vmax[name] = 0, 0.0
    for qpos, qvel in zip(fleet.qpos.numpy(), fleet.qvel.numpy()):
      mjd = mujoco.MjData(mjm)
      mjd.qpos[:], mjd.qvel[:] = qpos, qvel
      for _ in range(100):
        mujoco.mj_step(mjm, mjd)
        vmax[name] = max(vmax[name], float(np.abs(mjd.qvel).max()))
      warned[name] += any(mjd.warning[w].number for w in (
          mujoco.mjtWarning.mjWARN_BADQACC, mujoco.mjtWarning.mjWARN_BADQVEL,
          mujoco.mjtWarning.mjWARN_BADQPOS))
  assert warned["humanoid_mjx"] >= 14 and vmax["humanoid_mjx"] > 1e9, (
      warned, vmax)
  assert warned["humanoid"] == 0 and vmax["humanoid"] < 20, (warned, vmax)


@pytest.mark.parametrize("name", ["pendulum", "arm"])
def test_inverse_jac_matches_c(name):
  """inverse_ad against C mjd_inverseFD (which writes transposed
  Jacobians) and against inverse_fd, 1e-5 as in tests/test_opt.py."""
  mjm, mjd, _, (mp, dp) = _setup(SMALL[name])
  nv = mjm.nv
  dfdq, dfdv, dfda = (np.zeros((nv, nv)) for _ in range(3))
  mujoco.mjd_inverseFD(mjm, mjd, 1e-7, 0, dfdq, dfdv, dfda, None, None,
                       None, None)
  dp = mt.forward(mp, dp)
  jac = derivative.inverse_ad(mp, dp)
  jac_fd = derivative.inverse_fd(mp, dp, eps=1e-7, flg_centered=True)
  for got, fd, ref in zip(jac, jac_fd, (dfdq, dfdv, dfda)):
    np.testing.assert_allclose(got[0].numpy(), ref.T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fd.numpy(), got.numpy(), rtol=0, atol=1e-5)


def test_box_qp_matches_jax():
  """A batch of seeded bounded QPs, some with active bounds: x to 1e-10,
  the free sets and the iteration counts exactly, lane by lane against the
  JAX package's box_qp under vmap."""
  rng = np.random.RandomState(3)
  b, n = 16, 6
  a = rng.randn(b, n, n)
  h = np.einsum("bij,bkj->bik", a, a) + 0.5 * np.eye(n)
  g = 3.0 * rng.randn(b, n)
  lo, hi = -rng.rand(b, n), rng.rand(b, n)
  ref = jax.vmap(lambda *x: jqp.box_qp(*x, maxiter=20))(h, g, lo, hi)
  got = qp.box_qp(*(torch.as_tensor(x) for x in (h, g, lo, hi)), maxiter=20)
  np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                             atol=1e-10)
  np.testing.assert_array_equal(got.free.numpy(), np.asarray(ref.free))
  np.testing.assert_array_equal(got.niter.numpy(), np.asarray(ref.niter))
  np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                             rtol=0, atol=1e-10)
  assert not got.free.all() and got.free.any()
  # no bounds: the Newton solution
  free = qp.box_qp(torch.as_tensor(h), torch.as_tensor(g))
  np.testing.assert_allclose(free.x.numpy(),
                             -np.linalg.solve(h, g[..., None])[..., 0],
                             rtol=0, atol=1e-10)


def test_cholesky_nan_marks_non_spd_lanes():
  """A lane that is not positive definite gets NaN, as LAPACK gives the
  JAX package, and not the clamped factor of ops/linalg.py."""
  h = torch.stack([torch.eye(3), -torch.eye(3)]).double()
  l = qp.cholesky_nan(h)
  assert torch.equal(l[0], torch.eye(3, dtype=torch.float64))
  assert torch.isnan(l[1]).all()


def test_arm_fleet_mpc_matches_jax_and_c():
  """The fleet MPC on the 2-dof arm (fleet 4, H = 10, 2 replans, 2 iLQR
  iterations, 4 line-search alphas): plan costs, iteration counts and
  applied controls equal the JAX package's to 1e-9, for lin_batch None and
  3; every lane's executed torques match C mj_inverse to 1e-9."""
  mjm = mujoco.MjModel.from_xml_string(ARM)
  mp = mt.put_model(mjm, device="cpu")
  kw = dict(horizon=10, fleet=4, n_replan=2, ilqr_iterations=2, n_alpha=4,
            lin_batch=None, qpos_noise=0.15, qvel_noise=0.1)

  def jax_fleet_mpc():
    mj = mi.put_model(mjm)
    cfg_j = jnorthstar.NorthStarConfig(**kw)
    out = jnorthstar.fleet_mpc_fn(mj, jnorthstar.balance_cost(mj), cfg_j)(
        jnorthstar.make_fleet(mj, mi.make_data(mj), cfg_j))
    return {"plan_costs": out.plan_costs, "niters": out.niters,
            "us": out.us, "qpos": out.ds.qpos}

  ref = jax_reference.result(
      "arm_fleet_mpc", [jax_reference.model_bytes(mjm),
                        repr(sorted(kw.items()))], jax_fleet_mpc)

  d0 = mt.make_data(mp, 1)
  cost = northstar.balance_cost(mp)
  res = northstar.measure_solves_per_sec(
      mp, cost, d0, northstar.NorthStarConfig(**kw))
  assert res.n_solves == 8 and res.finite_lane_fraction == 1.0
  run = res.run
  np.testing.assert_allclose(run.plan_costs.numpy(), ref["plan_costs"],
                             rtol=0, atol=1e-9)
  np.testing.assert_array_equal(run.niters.numpy(), ref["niters"])
  np.testing.assert_allclose(run.us.numpy(), ref["us"], rtol=0, atol=1e-9)
  np.testing.assert_allclose(run.ds.qpos.numpy(), ref["qpos"], rtol=0,
                             atol=1e-9)

  cfg3 = northstar.NorthStarConfig(**{**kw, "lin_batch": 3})
  fleet = northstar.make_fleet(mp, d0, cfg3)
  run3 = northstar.fleet_mpc_fn(mp, cost, cfg3)(fleet)
  np.testing.assert_allclose(run3.us.numpy(), run.us.numpy(), rtol=0,
                             atol=1e-12)
  for i in range(4):
    err, _ = northstar.torque_parity_vs_host(
        mjm, mp, derivative.select_lanes(fleet, slice(i, i + 1)), run.us[i])
    assert err < 1e-9, f"fleet member {i}: torque err {err}"


def test_humanoid_northstar_torque_parity():
  """The north-star path on the Newton-100 humanoid at a small horizon
  (fleet 1, H = 10, 1 iteration, 2 alphas, n_apply = 10): a finite plan,
  and the executed trajectory's inverse torques within 1e-7 of C
  mj_inverse."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  m = mt.put_model(mjm, device="cpu")
  d0 = mt.make_data(m, 1)
  cfg = northstar.NorthStarConfig(horizon=10, fleet=1, n_replan=1,
                                  ilqr_iterations=1, n_alpha=2,
                                  lin_batch=None, n_apply=10)
  res = northstar.measure_solves_per_sec(m, northstar.balance_cost(m), d0,
                                         cfg)
  assert res.finite_lane_fraction == 1.0
  assert res.run.us.shape == (1, 10, m.nu)
  assert torch.isfinite(res.run.us).all()
  err, errs = northstar.torque_parity_vs_host(
      mjm, m, northstar.make_fleet(m, d0, cfg), res.run.us[0])
  assert errs.shape == (10,)
  assert err <= 1e-7, err


# ---------------------------------------------------------------------------
# the Jacobians as vmap over jvp: one primal a lane, the tangents batched
# ---------------------------------------------------------------------------


def _folded_transition(m, d):
  """The transition Jacobian with the tangent columns folded into the
  batch: each lane repeated nx + nu times, one unit tangent a copy, one
  torch.autograd.forward_ad dual step, measured from each copy's own
  primal next state.  (B, nx, nx + nu)."""
  import torch.autograd.forward_ad as fwAD

  nx = derivative.state_dim(m)
  nz = nx + m.nu
  rep = derivative.repeat_lanes(d, nz)
  eye = torch.eye(nz, dtype=d.qpos.dtype)
  with fwAD.dual_level():
    z = fwAD.make_dual(torch.zeros_like(eye).repeat(d.batch, 1),
                       eye.repeat(d.batch, 1))
    dn = forward_mod.step(m, derivative.apply_tangent(m, rep, z[:, :nx],
                                                      z[:, nx:]))
    ref = dn.replace(qpos=fwAD.unpack_dual(dn.qpos).primal,
                     qvel=fwAD.unpack_dual(dn.qvel).primal)
    jac = fwAD.unpack_dual(derivative.measure_tangent(m, ref, dn)).tangent
  return jac.reshape(d.batch, nz, -1).transpose(1, 2)


def _folded_inverse(m, d):
  """The inverse-dynamics Jacobian, folded the same way: (B, nv, 3 nv)."""
  import torch.autograd.forward_ad as fwAD

  nz = 3 * m.nv
  rep = derivative.repeat_lanes(d, nz)
  eye = torch.eye(nz, dtype=d.qpos.dtype)
  with fwAD.dual_level():
    z = fwAD.make_dual(torch.zeros_like(eye).repeat(d.batch, 1),
                       eye.repeat(d.batch, 1))
    jac = fwAD.unpack_dual(derivative._inverse_f(m, rep, z)).tangent
  return jac.reshape(d.batch, nz, -1).transpose(1, 2)


def _route_state(name):
  """Two lanes of a seeded state of ``name`` after the port's forward:
  the ARM at two states, or the Newton-100 humanoid in the air or with
  its feet on the floor (tests/test_torch_opt.py::_humanoid_state)."""
  if name == "arm":
    _, _, _, (mp, d0) = _setup(ARM, seed=0)
    _, _, _, (_, d1) = _setup(ARM, seed=1)
  else:
    drop = 0.22 if name == "humanoid feet-on-floor" else 0.0
    mjm, mjd0 = _humanoid_state(drop, seed=0)
    _, mjd1 = _humanoid_state(drop, seed=1)
    mp = mt.put_model(mjm, device="cpu")
    d0, d1 = mt.put_data(mp, mjd0), mt.put_data(mp, mjd1)
  d = derivative.cat_lanes([derivative.select_lanes(d0, slice(None)),
                            derivative.select_lanes(d1, slice(None))])
  return mp, mt.forward(mp, d)


ROUTE_STATES = ["arm", "humanoid airborne", "humanoid feet-on-floor"]


@pytest.mark.parametrize("name", ROUTE_STATES)
def test_jacobians_match_folded_forward_ad(name):
  """transition_ad and inverse_ad (vmap over jvp) against the folded
  forward-AD reference built here, 1e-9 in f64, on two lanes; the next
  state of transition_jacobian's primal equals step's to the bit."""
  mp, d = _route_state(name)
  qpos, qvel, jac = derivative.transition_jacobian(mp, d)
  ad = derivative.transition_ad(mp, d)
  ref = _folded_transition(mp, d)
  nx = derivative.state_dim(mp)
  assert jac.shape == ref.shape == (2, nx, nx + mp.nu)
  np.testing.assert_allclose(jac.numpy(), ref.numpy(), rtol=0, atol=1e-9)
  assert torch.equal(ad.A, jac[..., :nx]) and torch.equal(ad.B, jac[..., nx:])
  nxt = mt.step(mp, d)
  assert torch.equal(qpos, nxt.qpos) and torch.equal(qvel, nxt.qvel)
  inv = derivative.inverse_ad(mp, d)
  np.testing.assert_allclose(torch.cat(inv, dim=-1).numpy(),
                             _folded_inverse(mp, d).numpy(), rtol=0,
                             atol=1e-9)


@pytest.mark.parametrize("name", ["humanoid feet-on-floor"])
def test_dual_step_primal_cholesky_sees_the_lanes(name):
  """Every primal chol_factor / chol_solve call of transition_ad's dual
  step sees the B lanes (the batches of one plain step of the same lanes,
  in the same order), never B (nx + nu); every JVP call gets nx + nu
  tangents of those lanes."""
  mp, d = _route_state(name)
  nz = derivative.state_dim(mp) + mp.nu
  calls = {"_factor": [], "_solve": [], "chol_factor_jvp": [],
           "chol_solve_jvp": []}
  saved = {k: getattr(linalg, k) for k in calls}

  def spy(key):
    def run(*args):
      calls[key].append(tuple(a.shape[:-2] if a is not None and a.ndim > 3
                              else a.shape[:1] if a is not None else ()
                              for a in args[:2]))
      return saved[key](*args)
    return run

  def batches():
    return {k: [c[0] for c in v] for k, v in calls.items()}

  for k in calls:
    setattr(linalg, k, spy(k))
  try:
    mt.step(mp, d)
    plain = batches()
    for v in calls.values():
      v.clear()
    derivative.transition_ad(mp, d)
  finally:
    for k, fn in saved.items():
      setattr(linalg, k, fn)
  route = batches()
  assert plain["_factor"] and plain["_solve"]
  assert route["_factor"] == plain["_factor"]
  assert route["_solve"] == plain["_solve"]
  assert set(route["_factor"]) == {(d.batch,)}
  assert len(route["chol_factor_jvp"]) == len(route["_factor"])
  assert len(route["chol_solve_jvp"]) == len(route["_solve"])
  # the factor's tangent argument, and the solve's tangent of L: (T, B)
  assert {c[1] for c in calls["chol_factor_jvp"]} == {(nz, d.batch)}
  assert {c[1] for c in calls["chol_solve_jvp"]} == {(nz, d.batch)}


def test_route_takes_no_vmap_fallback():
  """With functorch's vmap-fallback warning on and made an error, the
  route runs through: no operation of the dual step or of inverse falls
  back to a loop over the tangents.  The same setting catches an op that
  does fall back."""
  mp, d = _route_state("humanoid feet-on-floor")
  mp_arm, d_arm = _route_state("arm")
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      derivative.transition_ad(mp, d)
      derivative.inverse_ad(mp, d)
      derivative.inverse_ad(mp_arm, d_arm)
      with pytest.raises(UserWarning, match="performance drop"):
        torch.func.vmap(lambda x: torch.histc(x, bins=4))(torch.ones(2, 3))
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
