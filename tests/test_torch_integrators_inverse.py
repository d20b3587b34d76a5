"""qDeriv, the discrete inverse and the transition Jacobians of the PyTorch
port's RK4 and implicit integrators, on the Newton-100 humanoid.

``smooth_vel_deriv`` on floor-contact lanes against the JAX package (1e-10)
and central differences of ``fwd_velocity`` (eps 1e-6, within 1e-6); the
INVDISCRETE inverse under IMPLICIT and IMPLICITFAST against C ``mj_inverse``
and the JAX package (1e-8), and recovering the applied forces of one step
(within 1e-6, the tolerance of the reference fork's ``inverse_test``);
RK4 refused there, as C refuses it; ``transition_ad`` under RK4 and
IMPLICIT against C's centered finite differences (1e-6, as
``tests/test_torch_opt.py::test_humanoid_transition_matches_c``).  The
JAX results are stored (``tests/jax_reference.py``).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import warnings

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
from mujoco_inversedynamicstest_tpu import opt as jopt
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

DROP = 0.22  # lowers the root until the feet touch the floor


def _humanoid(integrator, discrete=False):
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  if discrete:
    mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_INVDISCRETE
  return mjm


def _states(mjm, batch, seed, forces=False):
  """Seeded floor-contact inputs (numpy, lanes first), with random applied
  forces when ``forces``."""
  rng = np.random.RandomState(seed)
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], batch, axis=0)
  qpos[:, 2] -= DROP
  qpos[:, 7:] += 0.08 * rng.randn(batch, mjm.nq - 7)
  out = dict(qpos=qpos, qvel=0.1 * rng.randn(batch, mjm.nv),
             ctrl=0.2 * rng.randn(batch, mjm.nu))
  if forces:
    out.update(qfrc_applied=0.3 * rng.randn(batch, mjm.nv),
               xfrc_applied=0.3 * rng.randn(batch, mjm.nbody, 6))
  return out


@pytest.fixture(scope="module")
def position_stage():
  """Two floor-contact lanes after the position stage in the port, their
  MjModel and inputs."""
  mjm = _humanoid("IMPLICIT")
  fields = _states(mjm, 2, seed=1)
  mp = mt.put_model(mjm, device="cpu")
  dp = mt.fwd_position(mp, mt.from_jax_arrays(mp, fields))
  assert bool((dp.contact.dist < dp.contact.includemargin).any())
  return mp, dp, mjm, fields


@pytest.mark.parametrize("flg_bias", [True, False])
def test_smooth_vel_deriv_matches_jax(position_stage, flg_bias):
  mp, dp, mjm, fields = position_stage
  got = derivative.smooth_vel_deriv(mp, dp, flg_bias=flg_bias)

  def jax_qderiv():
    mj = mi.put_model(mjm)
    d0 = mi.make_data(mj)
    dj = jax.vmap(lambda q, v, c: d0.replace(qpos=q, qvel=v, ctrl=c))(
        fields["qpos"], fields["qvel"], fields["ctrl"])

    def one(d):
      return jopt.smooth_vel_deriv(mj, mi.fwd_position(mj, d),
                                   flg_bias=flg_bias)

    return {"qderiv": jax.jit(jax.vmap(one))(dj)}

  ref = jax_reference.result(
      f"smooth_vel_deriv_{flg_bias}", [jax_reference.model_bytes(mjm),
                                       *fields.values()], jax_qderiv)
  assert got.shape == (2, mp.nv, mp.nv)
  np.testing.assert_allclose(got.numpy(), ref["qderiv"], rtol=0,
                             atol=1e-10)


@pytest.mark.parametrize("flg_bias", [True, False])
def test_smooth_vel_deriv_matches_central_differences(position_stage,
                                                      flg_bias):
  """Each lane's 2 nv perturbed velocities run as lanes of one
  fwd_velocity."""
  mp, dp, _, _ = position_stage
  got = derivative.smooth_vel_deriv(mp, dp, flg_bias=flg_bias)
  nv, eps = mp.nv, 1e-6
  k = 2 * nv
  rep = mt.fwd_position(mp, derivative.repeat_lanes(dp, k))
  step = torch.cat([torch.eye(nv), -torch.eye(nv)]).double() * eps
  dv = rep.replace(qvel=rep.qvel + step.repeat(dp.batch, 1))
  dv = mt.fwd_actuation(mp, mt.fwd_velocity(mp, dv))
  f = dv.qfrc_passive + dv.qfrc_actuator
  if flg_bias:
    f = f - dv.qfrc_bias
  f = f.reshape(dp.batch, k, nv)
  fd = ((f[:, :nv] - f[:, nv:]) / (2 * eps)).transpose(1, 2)
  np.testing.assert_allclose(got.numpy(), fd.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("integrator", ["IMPLICIT", "IMPLICITFAST"])
def test_discrete_inverse_matches_c_and_jax(integrator):
  """INVDISCRETE inverse at a contact state with applied forces and a
  random qacc."""
  mjm = _humanoid(integrator, discrete=True)
  fields = _states(mjm, 1, seed=3, forces=True)
  mjd = mujoco.MjData(mjm)
  for k, v in fields.items():
    getattr(mjd, k)[:] = v[0]
  mjd.qacc[:] = np.random.RandomState(4).randn(mjm.nv)
  mujoco.mj_inverse(mjm, mjd)

  def jax_inverse():
    mj = mi.put_model(mjm)
    return {"qfrc_inverse": jax.jit(mi.inverse)(
        mj, mi.put_data(mj, mjd).replace(qacc=jnp.asarray(mjd.qacc))
    ).qfrc_inverse}

  outj = jax_reference.result(
      f"discrete_inverse_{integrator.lower()}",
      [jax_reference.model_bytes(mjm), mjd.qacc, *fields.values()],
      jax_inverse)
  mp = mt.put_model(mjm, device="cpu")
  outp = mt.inverse(mp, mt.put_data(mp, mjd))

  assert mjd.ncon > 0
  ours = outp.qfrc_inverse[0].numpy()
  np.testing.assert_allclose(ours, mjd.qfrc_inverse, rtol=0, atol=1e-8)
  np.testing.assert_allclose(ours, outj["qfrc_inverse"], rtol=0, atol=1e-8)
  np.testing.assert_array_equal(outp.qacc[0].numpy(), mjd.qacc)


@pytest.mark.parametrize("integrator", ["IMPLICIT", "IMPLICITFAST"])
def test_discrete_inverse_recovers_the_applied_forces(integrator):
  """(qvel' - qvel) / h of one step, put through the INVDISCRETE inverse at
  the state stepped from, gives back qfrc_applied + qfrc_actuator + Jᵀ
  xfrc_applied on every lane within 1e-6: the residual of the Newton
  solve's tolerance, not round-off."""
  mjm = _humanoid(integrator, discrete=True)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.from_jax_arrays(mp, _states(mjm, 4, seed=5, forces=True))
  nxt = mt.step(mp, d)
  qacc = (nxt.qvel - d.qvel) / mp.opt.timestep
  inv = mt.inverse(mp, d.replace(qacc=qacc))
  fwd = mt.forward(mp, d)
  applied = (fwd.qfrc_applied + fwd.qfrc_actuator
             + support.xfrc_accumulate(mp, fwd))
  assert bool((fwd.contact.dist < fwd.contact.includemargin).any())
  np.testing.assert_allclose(inv.qfrc_inverse.numpy(), applied.numpy(),
                             rtol=0, atol=1e-6)


def test_discrete_inverse_refuses_rk4():
  mjm = _humanoid("RK4", discrete=True)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.from_jax_arrays(mp, _states(mjm, 1, seed=0))
  with pytest.raises(ValueError, match="RK4"):
    mt.inverse(mp, d)


def _c_transition_fd(mjm, mjd, eps):
  """Centered differences of C mj_step in mjd_transitionFD's coordinates
  (dq by mj_integratePos, measured by mj_differentiatePos), every
  perturbed copy starting from mjd's warm start: mjd_transitionFD's method,
  which C 3.10.0 refuses for RK4."""
  nv, nu = mjm.nv, mjm.nu

  def stepped(z):
    c = mujoco.MjData(mjm)
    c.qpos[:] = mjd.qpos
    mujoco.mj_integratePos(mjm, c.qpos, z[:nv], 1.0)
    c.qvel[:] = mjd.qvel + z[nv:2 * nv]
    c.ctrl[:] = mjd.ctrl + z[2 * nv:]
    c.qacc_warmstart[:] = mjd.qacc_warmstart
    mujoco.mj_step(mjm, c)
    return c

  ref = stepped(np.zeros(2 * nv + nu))

  def measure(c):
    dq = np.zeros(nv)
    mujoco.mj_differentiatePos(mjm, dq, 1.0, ref.qpos, c.qpos)
    return np.concatenate([dq, c.qvel - ref.qvel])

  jac = np.stack([(measure(stepped(e)) - measure(stepped(-e))) / (2 * eps)
                  for e in eps * np.eye(2 * nv + nu)], axis=1)
  return jac[:, :2 * nv], jac[:, 2 * nv:]


# eps of the centered differences: under RK4 the root height's column
# carries a truncation error of 2.3e-6 at eps 1e-6 on one of these lanes (it
# falls 100x when eps falls 10x: four stages of contact curvature), so RK4
# takes 1e-7, where that error is 2e-8 and the solves' noise about 3e-7
@pytest.mark.parametrize("integrator, eps", [("RK4", 1e-7),
                                             ("IMPLICIT", 1e-6)])
def test_transition_matches_c(integrator, eps):
  """Two floor-contact lanes, each against C's centered differences of its
  own mj_step, A and B within 1e-6 on entries up to 2e2; under IMPLICIT
  also against C's own mjd_transitionFD (eps 1e-6).  Under IMPLICIT the
  qDeriv Jacobian runs nested inside transition_ad's vmap over jvp;
  neither level falls back to a loop over the tangents."""
  mjm = _humanoid(integrator)
  fields = _states(mjm, 2, seed=6)
  mjds = []
  for i in range(2):
    mjd = mujoco.MjData(mjm)
    for k, v in fields.items():
      getattr(mjd, k)[:] = v[i]
    mujoco.mj_forward(mjm, mjd)
    mjds.append(mjd)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, mt.from_jax_arrays(mp, fields))
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      ad = derivative.transition_ad(mp, d)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
  for lane, mjd in enumerate(mjds):
    assert mjd.ncon > 0
    a_c, b_c = _c_transition_fd(mjm, mjd, eps)
    assert np.abs(a_c).max() > 1e2
    np.testing.assert_allclose(ad.A[lane].numpy(), a_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ad.B[lane].numpy(), b_c, rtol=0, atol=1e-6)
  if integrator == "IMPLICIT":
    nx = 2 * mjm.nv
    a_c, b_c = np.zeros((nx, nx)), np.zeros((nx, mjm.nu))
    mujoco.mjd_transitionFD(mjm, mjds[0], 1e-6, 1, a_c, b_c, None, None)
    np.testing.assert_allclose(ad.A[0].numpy(), a_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ad.B[0].numpy(), b_c, rtol=0, atol=1e-6)
