"""The PyTorch port's implicit integrators and its Newton iteration count.

IMPLICIT and IMPLICITFAST steps of the Newton-100 humanoid from seeded
floor-contact states against the vmapped JAX step (qpos to 1e-9; its
result stored, ``tests/jax_reference.py``) and, for
10 steps, against C ``mj_step`` lane by lane (qpos 1e-8, qvel 1e-7, the
tolerances of ``tests/test_forward.py``); the solver's iteration count
against C's (one iteration from a converged warm start, none without a
constraint row); and the small contracts of ``put_model`` and ``step_n``.
RK4 has its own file (``test_torch_integrators_rk4.py``), as have the
derivatives and the discrete inverse (``test_torch_integrators_inverse.py``)
and the small models' trajectories
(``test_torch_integrators_trajectories.py``).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import jax
import mujoco
import numpy as np
import pytest
import torch

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt

from models import ACTUATED

DROP = 0.22  # lowers the root until the feet touch the floor
BATCH = 4


def _humanoid(integrator="EULER", name="humanoid"):
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  return mjm


def contact_states(mjm, batch=BATCH, seed=0):
  """Seeded floor-contact inputs of ``batch`` lanes (numpy, lanes first)."""
  rng = np.random.RandomState(seed)
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], batch, axis=0)
  qpos[:, 2] -= DROP
  qpos[:, 7:] += 0.08 * rng.randn(batch, mjm.nq - 7)
  return dict(qpos=qpos, qvel=0.1 * rng.randn(batch, mjm.nv),
              ctrl=0.2 * rng.randn(batch, mjm.nu))


def c_lanes(mjm, fields):
  """One C MjData a lane, holding ``fields``."""
  out = []
  for i in range(len(next(iter(fields.values())))):
    mjd = mujoco.MjData(mjm)
    for k, v in fields.items():
      getattr(mjd, k)[:] = v[i]
    out.append(mjd)
  return out


@pytest.mark.parametrize("integrator", ["IMPLICIT", "IMPLICITFAST"])
def test_implicit_steps_match_jax_and_c(integrator):
  mjm = _humanoid(integrator)
  mp = mt.put_model(mjm, device="cpu")
  fields = contact_states(mjm)
  dp = mt.from_jax_arrays(mp, fields)

  def jax_step():
    mj = mi.put_model(mjm)
    d0 = mi.make_data(mj)
    dj = jax.vmap(lambda q, v, c: d0.replace(qpos=q, qvel=v, ctrl=c))(
        fields["qpos"], fields["qvel"], fields["ctrl"])
    return {"qpos": jax.jit(jax.vmap(mi.step, in_axes=(None, 0)))(
        mj, dj).qpos}

  jax_qpos = jax_reference.result(
      f"integrators_{integrator.lower()}",
      [jax_reference.model_bytes(mjm), *fields.values()], jax_step)["qpos"]
  mjds = c_lanes(mjm, fields)
  for i in range(10):
    dp = mt.step(mp, dp)
    for mjd in mjds:
      mujoco.mj_step(mjm, mjd)
    if i == 0:
      assert bool((dp.contact.dist < dp.contact.includemargin).any())
      np.testing.assert_allclose(dp.qpos.numpy(), jax_qpos, rtol=0,
                                 atol=1e-9)
    for lane, mjd in enumerate(mjds):
      np.testing.assert_allclose(dp.qpos[lane].numpy(), mjd.qpos, rtol=0,
                                 atol=1e-8, err_msg=f"step {i} lane {lane}")
      np.testing.assert_allclose(dp.qvel[lane].numpy(), mjd.qvel, rtol=0,
                                 atol=1e-7, err_msg=f"step {i} lane {lane}")
  assert all(mjd.ncon > 0 for mjd in mjds)


def test_newton_counts_one_iteration_from_a_converged_warm_start():
  """Four floor-contact states of the Newton-100 humanoid along a C
  trajectory, each warm-started from C's converged qacc: C's mj_forward
  takes one Newton iteration (its loop tests convergence after the first),
  and so does the port's forward; qacc stays C's."""
  mjm = _humanoid()
  mjd = mujoco.MjData(mjm)
  fields = contact_states(mjm, batch=1)
  mjd.qpos[:], mjd.qvel[:] = fields["qpos"][0], fields["qvel"][0]
  states = []
  for i in range(60):
    mujoco.mj_step(mjm, mjd)
    if i % 15 == 14:
      c = mujoco.MjData(mjm)
      c.qpos[:], c.qvel[:] = mjd.qpos, mjd.qvel
      mujoco.mj_forward(mjm, c)
      c.qacc_warmstart[:] = c.qacc
      mujoco.mj_forward(mjm, c)
      assert c.ncon > 0 and c.solver_niter[0] == 1
      states.append(c)
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, mt.from_jax_arrays(mp, {
      k: np.stack([getattr(c, k) for c in states])
      for k in ("qpos", "qvel", "qacc_warmstart")}))
  np.testing.assert_array_equal(out.solver_niter.numpy(), [1, 1, 1, 1])
  for lane, c in enumerate(states):
    np.testing.assert_allclose(out.qacc[lane].numpy(), c.qacc, rtol=0,
                               atol=1e-8)


def test_newton_counts_no_iteration_without_constraint_rows():
  """humanoid_mjx in the air: C has no constraint row (nefc 0) and reports
  0 iterations with qacc = qacc_smooth; so does the port, lane by lane,
  beside a lane lowered onto the floor, which iterates."""
  mjm = _humanoid(name="humanoid_mjx")
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], 2, axis=0)
  qpos[1, 2] -= DROP
  mjds = c_lanes(mjm, {"qpos": qpos})
  for mjd in mjds:
    mujoco.mj_forward(mjm, mjd)
  assert mjds[0].nefc == 0 and mjds[1].nefc > 0
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, mt.from_jax_arrays(mp, {"qpos": qpos}))
  np.testing.assert_array_equal(out.solver_niter.numpy(),
                                [mjd.solver_niter[0] for mjd in mjds])
  assert out.solver_niter[0] == 0
  torch.testing.assert_close(out.qacc[0], out.qacc_smooth[0], rtol=0, atol=0)
  assert not out.solver_stat[0].any()
  np.testing.assert_allclose(out.qacc[0].numpy(), mjds[0].qacc, rtol=0,
                             atol=1e-10)


def test_put_model_takes_the_integrator_from_a_snapshot_mapping():
  """A snapshot Mapping with ``opt_integrator`` set gives the model that the
  MjModel with that integrator gives (how the card, which has no mujoco,
  picks an integrator); a model with activation dynamics loads from its
  snapshot Mapping under each integrator too, and steps as C does."""
  mjm = _humanoid()
  snap = dict(np.load(mt.asset_path("humanoid.npz")))
  for integrator in ("RK4", "IMPLICIT", "IMPLICITFAST"):
    snap["opt_integrator"] = np.array(
        int(getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")))
    from_snap = mt.put_model(snap, device="cpu")
    mjm.opt.integrator = int(snap["opt_integrator"])
    from_mjm = mt.put_model(mjm, device="cpu")
    for f in dataclasses.fields(from_snap.opt):
      a, b = getattr(from_snap.opt, f.name), getattr(from_mjm.opt, f.name)
      assert torch.equal(a, b) if torch.is_tensor(a) else a == b, f.name
    assert from_snap.opt.integrator == int(snap["opt_integrator"])
    fields = contact_states(mjm, batch=2)
    a = mt.step(from_snap, mt.from_jax_arrays(from_snap, fields))
    b = mt.step(from_mjm, mt.from_jax_arrays(from_mjm, fields))
    torch.testing.assert_close(a.qpos, b.qpos, rtol=0, atol=0)
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  snap = dict(np.load(mt.asset_path("actuated.npz")))
  for integrator in ("EULER", "RK4", "IMPLICIT", "IMPLICITFAST"):
    value = int(getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}"))
    snap["opt_integrator"] = np.array(value)
    mjm.opt.integrator = value
    mp = mt.put_model(snap, device="cpu")
    mjd = mujoco.MjData(mjm)
    mjd.qvel[:] = np.linspace(-1, 1, mjm.nv)
    mjd.ctrl[:] = np.linspace(-0.8, 0.8, mjm.nu)
    d = mt.put_data(mp, mjd)
    for _ in range(5):
      mujoco.mj_step(mjm, mjd)
      d = mt.step(mp, d)
    for f in ("qpos", "qvel", "act"):
      np.testing.assert_allclose(getattr(d, f)[0].numpy(), getattr(mjd, f),
                                 rtol=0, atol=1e-10, err_msg=integrator)


@pytest.mark.parametrize("integrator", ["EULER", "RK4", "IMPLICITFAST"])
def test_step_n_is_n_steps(integrator):
  mjm = _humanoid(integrator)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.from_jax_arrays(mp, contact_states(mjm, batch=2))
  stepped = d
  for _ in range(5):
    stepped = mt.step(mp, stepped)
  out = mt.step_n(mp, d, 5)
  for f in ("qpos", "qvel", "qacc", "qacc_warmstart", "time",
            "solver_niter"):
    assert torch.equal(getattr(out, f), getattr(stepped, f)), f
