"""The PyTorch port's forward dynamics and fleet step on the humanoid.

``forward`` from seeded states with floor contacts is compared with the JAX
package (f64, 1e-9) and with C ``mj_forward`` at the tolerance of
``tests/test_humanoid.py`` (1e-6).  Fleets of four lanes are stepped beside
the vmapped JAX step (qpos to 1e-8).  The JAX results are stored
(``tests/jax_reference.py``).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import mujoco
import numpy as np
import pytest
import torch

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt

INPUTS = ("qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied", "qacc",
          "qacc_warmstart", "time")
# lowers the root until the feet touch the floor
DROP = 0.22
STEPS = 20


def _humanoid(name="humanoid"):
  return mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_jax_and_c(seed):
  mjm = _humanoid()
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] -= DROP
  mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)

  fields = ("qacc", "efc_J", "efc_aref", "efc_force", "qfrc_constraint")

  def jax_forward():
    mj = mi.put_model(mjm)
    out = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
    return {f: getattr(out, f) for f in fields + ("solver_niter",)}

  outj = jax_reference.result(
      f"forward_humanoid_{seed}", [jax_reference.model_bytes(mjm)] + [
          np.atleast_1d(np.array(getattr(mjd, k))) for k in INPUTS],
      jax_forward)
  mp = mt.put_model(mjm, device="cpu")
  outp = mt.forward(mp, mt.put_data(mp, mjd))

  ncon = int((outp.contact.dist < outp.contact.includemargin).sum())
  assert ncon > 0
  for field in fields:
    np.testing.assert_allclose(getattr(outp, field)[0].numpy(), outj[field],
                               rtol=0, atol=1e-9, err_msg=field)
  mujoco.mj_forward(mjm, mjd)
  # the JAX package's count, or C's where the two differ (ROADMAP queue 3)
  niter = int(outp.solver_niter[0])
  if niter != int(outj["solver_niter"]):
    assert niter == mjd.solver_niter[0]
  assert ncon == mjd.ncon
  np.testing.assert_allclose(outp.qacc[0].numpy(), mjd.qacc, rtol=0, atol=1e-6)
  np.testing.assert_allclose(outp.qfrc_constraint[0].numpy(),
                             mjd.qfrc_constraint, rtol=0, atol=1e-6)


def test_line_search_exact_minimum_follows_c():
  """Newton line searches that land on the exact minimum of a quadratic
  piece (slope exactly 0): the port ends the search there, and its qacc
  stays within 1e-8 of C ``mj_forward`` on every lane of this fleet.  The
  JAX package's strict bracket test keeps bisecting and ends 3e-7 off on
  three of these 16 lanes (ROADMAP queue 3)."""
  mjm = _humanoid()
  batch = 16
  rng = np.random.RandomState(1)
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], batch, axis=0)
  qpos[:, 2] -= DROP
  qpos[:, 7:] += 0.08 * rng.randn(batch, mjm.nq - 7)
  fields = dict(qpos=qpos, qvel=0.1 * rng.randn(batch, mjm.nv),
                ctrl=0.2 * rng.randn(batch, mjm.nu),
                qfrc_applied=0.3 * rng.randn(batch, mjm.nv),
                xfrc_applied=0.3 * rng.randn(batch, mjm.nbody, 6))
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, mt.from_jax_arrays(mp, fields))
  for i in range(batch):
    mjd = mujoco.MjData(mjm)
    for k, v in fields.items():
      getattr(mjd, k)[:] = v[i]
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(out.qacc[i].numpy(), mjd.qacc, rtol=0,
                               atol=1e-8, err_msg=f"lane {i}")


@pytest.mark.parametrize("name, drop", [
    # MJX budget (1 Newton iteration, 4 line-search rounds), in the air: a
    # contact step of this budget is discontinuous in the last bit of its
    # inputs, so a free-running comparison stops at the first floor contact
    ("humanoid_mjx", 0.0),
    # converged Newton: 20 steps with the feet on the floor
    ("humanoid", DROP),
])
def test_fleet_steps_match_vmapped_jax(name, drop):
  mjm = _humanoid(name)
  mp = mt.put_model(mjm, device="cpu")
  batch = 4
  rng = np.random.RandomState(3)
  dq = 0.02 * rng.randn(batch, mjm.nq)
  dq[:, :7] = 0.0
  dq[:, 2] -= drop
  qpos = np.asarray(mjm.qpos0)[None] + dq
  ctrl = 0.01 * rng.randn(batch, mjm.nu)

  def jax_steps():
    mj = mi.put_model(mjm)
    d0 = mi.make_data(mj)
    dj = jax.vmap(lambda q, c: d0.replace(qpos=q, ctrl=c))(qpos, ctrl)
    vstep = jax.jit(jax.vmap(mi.step, in_axes=(None, 0)))
    out = {}
    for i in range(STEPS):
      dj = vstep(mj, dj)
      out[f"qpos{i}"] = dj.qpos
    return {**out, "solver_niter": dj.solver_niter,
            "solver_stat": dj.solver_stat}

  jx = jax_reference.result(
      f"fleet_steps_{name}", [jax_reference.model_bytes(mjm), qpos, ctrl],
      jax_steps)
  dp = mt.from_jax_arrays(mp, {"qpos": qpos, "ctrl": ctrl})
  assert dp.qpos.shape == (batch, mjm.nq)

  mjds = [mujoco.MjData(mjm) for _ in range(batch)]
  for mjd, q, c in zip(mjds, qpos, ctrl):
    mjd.qpos[:], mjd.ctrl[:] = q, c

  for i in range(STEPS):
    dp = mt.step(mp, dp)
    for mjd in mjds:
      mujoco.mj_step(mjm, mjd)
    np.testing.assert_allclose(dp.qpos.numpy(), jx[f"qpos{i}"], rtol=0,
                               atol=1e-8)
  # the port counts Newton iterations as C does (one before the first
  # convergence test, none without a constraint row); the JAX package does
  # not (ROADMAP queue 3).  Where the two counts differ, the port's is C's,
  # and a lane without iterations keeps no solver statistics.
  niter, niter_j = dp.solver_niter.numpy(), jx["solver_niter"]
  same = niter == niter_j
  np.testing.assert_array_equal(
      niter[~same], [mjd.solver_niter[0] for mjd in np.array(mjds)[~same]])
  np.testing.assert_allclose(dp.solver_stat.numpy()[same],
                             jx["solver_stat"][same], rtol=0,
                             atol=1e-8)
  assert not dp.solver_stat.numpy()[niter == 0].any()
  if drop:
    assert bool((dp.contact.dist < dp.contact.includemargin).any())


def test_check_reset_is_per_lane():
  """A diverged lane returns to qpos0 with zero velocity and counts a
  warning; the other lanes step on (``mj_checkPos``/``mj_checkVel``)."""
  mp = mt.put_model(mt.asset_path("humanoid_mjx.npz"), device="cpu")
  d = mt.make_data(mp, 3)
  qvel = d.qvel.clone()
  qvel[1, 4] = float("nan")
  qvel[2, 0] = 0.3
  d = mt.step(mp, d.replace(qvel=qvel))
  assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
  np.testing.assert_array_equal(d.warning.numpy(), [[0, 0], [0, 1], [0, 0]])
  fresh = mt.step(mp, mt.make_data(mp, 1))
  torch.testing.assert_close(d.qpos[1], fresh.qpos[0], rtol=0, atol=0)
  assert not torch.equal(d.qpos[2], d.qpos[0])
