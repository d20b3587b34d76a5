"""The PyTorch port's RK4 step of the Newton-100 humanoid.

Four seeded floor-contact lanes stepped 10 times by the port and by C
``mj_step`` lane by lane, and once by the vmapped JAX step (one compile,
the module's fixture; its result is stored, ``tests/jax_reference.py``).
The first step against the JAX package (qpos to 1e-9), every step against
C (qpos 1e-8, qvel 1e-7), and the state RK4 leaves
behind against C's: qacc and qacc_warmstart within 1e-6 of max|qacc|, and
the same solver iteration count.  There the JAX package keeps its first
stage's fields and is far from C (ROADMAP queue 3).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import mujoco
import numpy as np
import pytest

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt

DROP = 0.22  # lowers the root until the feet touch the floor
STEPS = 10
FIELDS = ("qpos", "qvel", "qacc", "qacc_warmstart", "solver_niter",
          "qfrc_constraint", "qfrc_bias", "qacc_smooth", "xpos")


@pytest.fixture(scope="module")
def runs():
  """(port, C, JAX): dicts of FIELDS, (STEPS, lanes, ...) for the port and
  C, (lanes, ...) after the first step for the JAX package."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
  rng = np.random.RandomState(0)
  batch = 4
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], batch, axis=0)
  qpos[:, 2] -= DROP
  qpos[:, 7:] += 0.08 * rng.randn(batch, mjm.nq - 7)
  qvel, ctrl = 0.1 * rng.randn(batch, mjm.nv), 0.2 * rng.randn(batch, mjm.nu)

  mp = mt.put_model(mjm, device="cpu")
  dp = mt.from_jax_arrays(mp, dict(qpos=qpos, qvel=qvel, ctrl=ctrl))

  def jax_step():
    mj = mi.put_model(mjm)
    d0 = mi.make_data(mj)
    dj = jax.vmap(lambda q, v, c: d0.replace(qpos=q, qvel=v, ctrl=c))(
        qpos, qvel, ctrl)
    dj = jax.jit(jax.vmap(mi.step, in_axes=(None, 0)))(mj, dj)
    return {f: np.asarray(getattr(dj, f)) for f in FIELDS}

  jx = jax_reference.result(
      "integrators_rk4", [jax_reference.model_bytes(mjm), qpos, qvel, ctrl],
      jax_step)
  mjds = []
  for q, v, c in zip(qpos, qvel, ctrl):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = q, v, c
    mjds.append(mjd)

  out = {who: {f: [] for f in FIELDS} for who in ("port", "c")}
  for _ in range(STEPS):
    dp = mt.step(mp, dp)
    for mjd in mjds:
      mujoco.mj_step(mjm, mjd)
    for f in FIELDS:
      out["port"][f].append(getattr(dp, f).numpy())
      out["c"][f].append(np.stack([
          mjd.solver_niter[0] if f == "solver_niter" else getattr(mjd, f)
          for mjd in mjds]))
  assert all(mjd.ncon > 0 for mjd in mjds)
  return (*({f: np.stack(v) for f, v in out[who].items()}
            for who in ("port", "c")), jx)


def test_rk4_step_matches_jax(runs):
  port, _, jx = runs
  np.testing.assert_allclose(port["qpos"][0], jx["qpos"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("field, tol", [("qpos", 1e-8), ("qvel", 1e-7)])
def test_rk4_steps_match_c(runs, field, tol):
  port, c, _ = runs
  for i in range(STEPS):
    np.testing.assert_allclose(port[field][i], c[field][i], rtol=0, atol=tol,
                               err_msg=f"step {i}")


def test_rk4_end_state_follows_c(runs):
  """C's mj_RungeKutta leaves the last stage's forward fields, with
  qacc_warmstart = that qacc: so does the port, at every step (each field
  within 1e-6 of its largest entry in C).  The JAX package's qacc after
  the first step (its first stage's) is far from C's."""
  port, c, jx = runs
  for i in range(STEPS):
    for f in ("qacc", "qacc_warmstart", "qfrc_constraint", "qfrc_bias",
              "qacc_smooth", "xpos"):
      scale = np.abs(c["qacc" if f == "qacc_warmstart" else f][i]).max()
      np.testing.assert_allclose(port[f][i], c[f][i], rtol=0,
                                 atol=1e-6 * scale, err_msg=f"{f} step {i}")
    np.testing.assert_array_equal(port["solver_niter"][i],
                                  c["solver_niter"][i], err_msg=f"step {i}")
  assert np.abs(jx["qacc"] - c["qacc"][0]).max() > 1e-2 * np.abs(
      c["qacc"][0]).max()
