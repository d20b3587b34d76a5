"""The PyTorch port's ``lqr_gain`` and the humanoid balance recipe
(``scripts/balance.py``, BASELINE rung 3), in float64 on the CPU:

* ``lqr_gain`` on ``tests/test_opt.py``'s system (seed 4, 500 Riccati
  iterations) against scipy's DARE (1e-6) and the JAX ``lqr_gain``
  (1e-10); a batch of systems against the calls one by one (1e-12);
* the recipe on the Newton-100 humanoid: its joint and body tables against
  the MjModel's names; the pose against C (the CoM over the left foot's
  CoM within 1e-9 m, the foot flat, only left-foot contacts, the height
  the least |qfrc_inverse[2]| of C's ``mj_inverse`` sweep); ctrl0 and Q
  against the notebook's construction with C's ``mj_inverse``,
  ``mj_jacSubtreeCom`` and ``mj_jacBodyCom`` (1e-9); A, B against C's
  ``mjd_transitionFD`` (1e-4 of max |A|); scipy's DARE refusing the
  problem, and the gain's convergence;
* rung 3 on 4 lanes for 200 steps: the closed-loop lanes stay balanced,
  the open-loop ones (K = 0) do not;
* the closed loop against C's ``mjcb_control`` and the open loop against
  ``mujoco.rollout.rollout`` from the committed reference
  (``assets/humanoid_balance_c.npz``, written by
  ``scripts/balance_c_reference.py``), INTEGRATION states within 1e-8; and
  that file against what the script computes now.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import sys

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import scipy.linalg
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu import opt as jax_opt
from mujoco_inversedynamicstest_tpu_torch.models.types import StateFlag

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import balance  # noqa: E402
import balance_c_reference  # noqa: E402


def rand_spd(n, rng, cond=10.0):
  """tests/test_opt.py's ``_rand_spd``."""
  q, _ = np.linalg.qr(rng.randn(n, n))
  return q @ np.diag(np.linspace(1.0, cond, n)) @ q.T


def system(seed):
  rng = np.random.RandomState(seed)
  return (rng.randn(4, 4) * 0.5, rng.randn(4, 2), rand_spd(4, rng),
          rand_spd(2, rng))


def test_lqr_gain_matches_scipy_and_jax():
  a, b, q, r = system(4)
  k, p = mt.opt.lqr_gain(*map(torch.as_tensor, (a, b, q, r)),
                         iterations=500)
  p_ref = scipy.linalg.solve_discrete_are(a, b, q, r)
  k_ref = np.linalg.solve(r + b.T @ p_ref @ b, b.T @ p_ref @ a)
  np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(k.numpy(), k_ref, rtol=1e-6, atol=1e-6)
  k_jax, p_jax = jax_opt.lqr_gain(*map(jnp.asarray, (a, b, q, r)),
                                  iterations=500)
  np.testing.assert_allclose(p.numpy(), np.asarray(p_jax), rtol=1e-10,
                             atol=1e-10)
  np.testing.assert_allclose(k.numpy(), np.asarray(k_jax), rtol=1e-10,
                             atol=1e-10)


def test_lqr_gain_batches_lanes():
  systems = [system(s) for s in (4, 5, 6)]
  stacked = [torch.as_tensor(np.stack(x)) for x in zip(*systems)]
  k, p = mt.opt.lqr_gain(*stacked, iterations=300)
  assert k.shape == (3, 2, 4) and p.shape == (3, 4, 4)
  for i, sysm in enumerate(systems):
    k1, p1 = mt.opt.lqr_gain(*map(torch.as_tensor, sysm), iterations=300)
    np.testing.assert_allclose(k[i].numpy(), k1.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(p[i].numpy(), p1.numpy(), rtol=1e-12,
                               atol=1e-12)


_CACHE = {}


def humanoid():
  """(MjModel, the port's fp64 CPU model, balance_problem)."""
  if not _CACHE:
    mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
    m = mt.put_model(mt.asset_path("humanoid.npz"), device="cpu")
    _CACHE["v"] = (mjm, m, balance.balance_problem(m))
  return _CACHE["v"]


def test_tables_name_the_models_joints_and_bodies():
  mjm, _, _ = humanoid()
  assert balance.JOINTS == tuple(mjm.joint(i).name for i in range(mjm.njnt))
  assert balance.BODIES == tuple(mjm.body(i).name for i in range(mjm.nbody))


def c_at(mjm, qpos, ctrl=None):
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = qpos
  if ctrl is not None:
    mjd.ctrl[:] = ctrl
  mujoco.mj_forward(mjm, mjd)
  return mjd


def c_inverse_z(mjm, qpos):
  mjd = c_at(mjm, qpos)
  mjd.qacc[:] = 0
  mujoco.mj_inverse(mjm, mjd)
  return mjd


def test_pose_stands_on_the_left_foot_in_c():
  mjm, _, prob = humanoid()
  qpos = prob.pose.qpos.numpy()
  mjd = c_at(mjm, qpos)
  foot = mjm.body("left_foot").id
  offset = mjd.subtree_com[mjm.body("torso").id] - mjd.xipos[foot]
  assert np.linalg.norm(offset[:2]) < 1e-9
  assert prob.pose.offset < 1e-9
  np.testing.assert_allclose(mjd.xmat[foot].reshape(3, 3)[:, 2], [0, 0, 1],
                             atol=1e-9)
  bodies = {mjm.geom_bodyid[c.geom[i]] for c in mjd.contact[:mjd.ncon]
            for i in range(2)}
  assert mjd.ncon >= 2 and bodies == {0, foot}
  # the sweep's height: C's |qfrc_inverse[2]| is least there
  step = 2 * balance.HEIGHT_SWEEP / (balance.HEIGHT_POINTS - 1)
  force = []
  for dz in (-step, 0.0, step):
    q = qpos.copy()
    q[2] += dz
    force.append(abs(c_inverse_z(mjm, q).qfrc_inverse[2]))
  assert force[1] <= min(force[0], force[2])
  np.testing.assert_allclose(prob.pose.root_force, force[1], rtol=0,
                             atol=1e-9)
  # the right foot is clear, the right leg flexed as printed
  assert prob.pose.angles["right_hip_y"] < 0 and prob.pose.angles[
      "right_knee"] < 0


def test_open_loop_control_and_cost_match_the_notebook_in_c():
  mjm, _, prob = humanoid()
  qpos = prob.pose.qpos.numpy()
  mjd = c_inverse_z(mjm, qpos)
  moment = np.zeros((mjm.nu, mjm.nv))
  mujoco.mju_sparse2dense(moment, mjd.actuator_moment, mjd.moment_rownnz,
                          mjd.moment_rowadr, mjd.moment_colind)
  ctrl0 = mjd.qfrc_inverse @ np.linalg.pinv(moment)
  np.testing.assert_allclose(prob.ctrl0.numpy(), ctrl0, rtol=0, atol=1e-9)
  assert np.abs(ctrl0).max() < 1.0  # inside ctrlrange

  mjd = c_at(mjm, qpos)
  jac_com = np.zeros((3, mjm.nv))
  mujoco.mj_jacSubtreeCom(mjm, mjd, jac_com, mjm.body("torso").id)
  jac_foot = np.zeros((3, mjm.nv))
  mujoco.mj_jacBodyCom(mjm, mjd, jac_foot, None, mjm.body("left_foot").id)
  jac_diff = jac_com - jac_foot
  names = [mjm.joint(i).name for i in range(mjm.njnt)]
  abdomen = [mjm.joint(n).dofadr[0] for n in names
             if "abdomen" in n and "z" not in n]
  left_leg = [mjm.joint(n).dofadr[0] for n in names
              if "left" in n and ("hip" in n or "knee" in n or "ankle" in n)
              and "z" not in n]
  bal = abdomen + left_leg
  other = np.setdiff1d(np.arange(6, mjm.nv), bal)
  qjoint = np.eye(mjm.nv)
  qjoint[range(6), range(6)] *= 0
  qjoint[bal, bal] *= 3
  qjoint[other, other] *= 0.3
  qpos_cost = 1000 * jac_diff.T @ jac_diff + qjoint
  nv = mjm.nv
  q = np.block([[qpos_cost, np.zeros((nv, nv))], [np.zeros((nv, 2 * nv))]])
  np.testing.assert_allclose(prob.q.numpy(), q, rtol=0, atol=1e-9)
  np.testing.assert_array_equal(prob.r.numpy(), np.eye(mjm.nu))


def test_linearization_matches_c_transition_fd():
  mjm, _, prob = humanoid()
  mjd = c_at(mjm, prob.pose.qpos.numpy(), prob.ctrl0.numpy())
  a = np.zeros((2 * mjm.nv, 2 * mjm.nv))
  b = np.zeros((2 * mjm.nv, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, True, a, b, None, None)
  scale = np.abs(a).max()
  np.testing.assert_allclose(prob.a.numpy(), a, rtol=0, atol=1e-4 * scale)
  np.testing.assert_allclose(prob.b.numpy(), b, rtol=0, atol=1e-4 * scale)


def test_dare_has_no_finite_solution_and_the_gain_converges():
  """A has three eigenvalues at 1 here, two of them the stance moved
  sideways on the floor (exact eigenvectors, which Q sees only at
  round-off), so scipy refuses the DARE; the Riccati iteration's gain
  still converges."""
  _, _, prob = humanoid()
  a, b, q, r = (x.numpy() for x in (prob.a, prob.b, prob.q, prob.r))
  assert np.sum(np.abs(np.linalg.eigvals(a) - 1) < 1e-6) == 3
  for axis in (0, 1):
    e = np.zeros(len(a))
    e[axis] = 1.0
    np.testing.assert_array_equal(a @ e, e)
    assert np.abs(q @ e).max() < 1e-12
  with pytest.raises((ValueError, np.linalg.LinAlgError)):
    scipy.linalg.solve_discrete_are(a, b, q, r)
  half, _ = mt.opt.lqr_gain(prob.a, prob.b, prob.q, prob.r,
                            iterations=balance.LQR_ITERATIONS // 2)
  change = float(torch.linalg.norm(prob.gain - half)
                 / torch.linalg.norm(prob.gain))
  assert change < 1e-8, change
  # the closed loop is stable but for those three modes
  eig = np.sort(np.abs(np.linalg.eigvals(
      a - b @ prob.gain.numpy())))[::-1]
  assert np.all(eig[3:] < 0.995) and np.all(np.abs(eig[:3] - 1) < 1e-6)


def test_rung3_balances_closed_loop_and_falls_open_loop():
  """4 lanes, 200 steps (1 s): the two with K stay up, the two with K = 0
  fall, and no lane with K was auto-reset."""
  _, m, prob = humanoid()
  gen = torch.Generator().manual_seed(3)
  lanes, steps = 4, 200
  init = balance.fleet_states(m, prob.pose.qpos, gen, lanes)
  noise = balance.smoothed_noise(m, gen, steps, lanes)
  gain = torch.stack([prob.gain, prob.gain, 0 * prob.gain, 0 * prob.gain])
  policy = balance.lqr_policy(m, prob.pose.qpos, prob.ctrl0, gain, noise)
  out = mt.opt.rollout(m, init, nstep=steps, ctrl_fn=policy)
  nq = m.nq
  ok, worst = balance.balanced(m, out.state[..., 1:1 + nq], prob.pose.qpos)
  assert ok.tolist() == [True, True, False, False], worst
  # no closed-loop lane was reset inside the step
  assert out.warning[:2].sum() == 0


def test_smoothed_noise_is_the_notebooks():
  """np.convolve(..., mode='same') with the notebook's kernel, per lane."""
  _, m, _ = humanoid()
  gen = torch.Generator().manual_seed(0)
  steps, lanes = 300, 2
  noise = balance.smoothed_noise(m, gen, steps, lanes)
  white = torch.randn((lanes * m.nu, 1, steps),
                      generator=torch.Generator().manual_seed(0),
                      dtype=m.dtype).numpy()[:, 0]
  width = round(balance.CTRL_RATE / m.opt.timestep)
  kernel = np.exp(-0.5 * np.linspace(-3, 3, width) ** 2)
  kernel /= np.linalg.norm(kernel)
  ref = np.stack([np.convolve(w, kernel, mode="same") for w in white])
  ref = balance.CTRL_STD * ref.reshape(lanes, m.nu, steps).transpose(2, 0, 1)
  np.testing.assert_allclose(noise.numpy(), ref, rtol=0, atol=1e-12)


def reference_file():
  with np.load(mt.asset_path("humanoid_balance_c.npz")) as z:
    return {k: z[k] for k in z.files}


def test_closed_loop_matches_c_callback():
  """The committed C closed loop (4 lanes x 25 steps through
  mjcb_control) from its own inputs, against the port's lqr_policy inside
  step: INTEGRATION states within 1e-8."""
  _, m, _ = humanoid()
  ref = reference_file()
  t = torch.as_tensor
  policy = balance.lqr_policy(m, t(ref["qpos"]), t(ref["ctrl0"]),
                              t(ref["gain"]), t(ref["noise"]))
  d = mt.set_state(m, mt.make_data(m, 4), t(ref["init"]))
  got = []
  for _ in range(ref["closed_states"].shape[1]):
    d = mt.step(m, d, ctrl_fn=policy)
    got.append(mt.get_state(m, d, StateFlag.INTEGRATION))
  np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                             ref["closed_states"], rtol=0, atol=1e-8)
  out = mt.opt.rollout(m, t(ref["open_init"]), t(ref["open_control"]))
  np.testing.assert_allclose(out.state.numpy(), ref["open_states"], rtol=0,
                             atol=1e-8)


def test_reference_file_is_what_the_script_writes():
  """Its inputs are what the recipe gives now (1e-9), and C from those
  inputs gives its states exactly."""
  mjm, m, _ = humanoid()
  ref = reference_file()
  now = balance_c_reference.inputs(m)
  for k, v in now.items():
    np.testing.assert_allclose(ref[k], v, rtol=0, atol=1e-9, err_msg=k)
  np.testing.assert_array_equal(balance_c_reference.c_closed_loop(mjm, ref),
                                ref["closed_states"])
  np.testing.assert_array_equal(balance_c_reference.c_open_loop(mjm, ref),
                                ref["open_states"])
