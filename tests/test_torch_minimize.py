"""The port's ``opt.least_squares`` against the JAX package's and C.

The JAX tests' Rosenbrock and bounded problems (``tests/test_rollout.py``)
as lanes of one batch: each lane's x within 1e-10 of the JAX package's,
with its iteration count.  Three Rosenbrock starts that stop at different
iterations in one batch: each lane equals its own run alone.  Two
humanoid system-identification lanes off the floor: the controls that make
the port's step reproduce the qvel C's ``mj_step`` gives under hidden
controls u*, within the control range; C's ``mj_step`` under the fitted controls gives
that qvel back within 1e-9, and the fit is within 1e-8 of u*.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu import opt as jopt

STARTS = ((-1.2, 1.0), (0.5, 0.5), (1.1, 1.3))


def rosenbrock_jax(x):
  return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def rosenbrock(x):
  return torch.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0]], -1)


A = np.array([[2.0, 0.3], [0.3, 1.0]])
TARGET = np.array([2.0, -3.0])


def test_rosenbrock_matches_jax():
  ref = jax.jit(lambda x0: jopt.least_squares(
      rosenbrock_jax, x0, max_iter=100))(jnp.asarray(STARTS[0]))
  got = mt.opt.least_squares(rosenbrock, torch.tensor([STARTS[0]], dtype=torch.float64),
                             max_iter=100)
  np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x), rtol=0,
                             atol=1e-10)
  assert int(got.niter[0]) == int(ref.niter)
  np.testing.assert_allclose(got.x[0].numpy(), [1.0, 1.0], atol=1e-6)
  np.testing.assert_allclose(float(got.grad_norm[0]), float(ref.grad_norm),
                             rtol=0, atol=1e-10)


def test_bounded_matches_jax():
  a, target = torch.tensor(A), torch.tensor(TARGET)
  lo, hi = -torch.ones(2, dtype=torch.float64), torch.ones(2,
                                                           dtype=torch.float64)
  ref = jopt.least_squares(lambda x: jnp.asarray(A) @ (x - TARGET),
                           jnp.zeros(2), bounds=(jnp.asarray(lo.numpy()),
                                                 jnp.asarray(hi.numpy())))
  got = mt.opt.least_squares(lambda x: (x - target) @ a.T,
                             torch.zeros(1, 2, dtype=torch.float64),
                             bounds=(lo, hi))
  np.testing.assert_allclose(got.x[0].numpy(), np.asarray(ref.x), rtol=0,
                             atol=1e-10)
  assert int(got.niter[0]) == int(ref.niter)
  assert bool((got.x >= -1 - 1e-12).all() and (got.x <= 1 + 1e-12).all())


def test_lanes_stop_apart_and_equal_their_own_runs():
  """Three starts in one batch stop at different iterations; each lane's
  result is its run alone, bit for bit, and the JAX package's iteration
  count."""
  batch = mt.opt.least_squares(rosenbrock, torch.tensor(STARTS, dtype=torch.float64),
                               max_iter=100)
  assert len(set(batch.niter.tolist())) == 3, batch.niter
  solve = jax.jit(lambda x0: jopt.least_squares(rosenbrock_jax, x0,
                                                max_iter=100))
  for i, start in enumerate(STARTS):
    alone = mt.opt.least_squares(rosenbrock, torch.tensor([start], dtype=torch.float64),
                                 max_iter=100)
    for field in alone._fields:
      assert torch.equal(getattr(batch, field)[i], getattr(alone, field)[0]), (
          i, field)
    assert int(batch.niter[i]) == int(solve(jnp.asarray(start)).niter)


def test_humanoid_system_id_recovers_c_controls():
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  m = mt.put_model(mjm, device="cpu")
  rng = np.random.RandomState(0)
  lanes = 2
  lo, hi = mjm.actuator_ctrlrange[:, 0], mjm.actuator_ctrlrange[:, 1]
  span = hi - lo
  u_star = lo + span * (0.1 + 0.8 * rng.rand(lanes, mjm.nu))
  qpos = np.repeat(mjm.qpos0[None], lanes, 0)
  qpos[:, 2] += 0.1                        # off the floor
  qpos[:, 7:] += 0.02 * rng.randn(lanes, mjm.nq - 7)
  qvel = 0.1 * rng.randn(lanes, mjm.nv)

  def c_step(i, u):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = qpos[i], qvel[i], u
    mujoco.mj_step(mjm, mjd)
    return mjd

  observed = np.stack([c_step(i, u_star[i]).qvel for i in range(lanes)])
  # no constraint row: where a contact or a limit switches between the
  # fit's iterates, Gauss-Newton can stall short of u*
  assert all(c_step(i, u_star[i]).nefc == 0 for i in range(lanes))
  d = mt.from_jax_arrays(m, dict(qpos=qpos, qvel=qvel))
  target = torch.as_tensor(observed)

  def residual(u):
    # the qvel difference over the timestep, so that box_qp's absolute
    # 1e-16 improvement floor lies below the fit's tolerance
    return (mt.step(m, d.replace(ctrl=u)).qvel - target) / mjm.opt.timestep

  res = mt.opt.least_squares(
      residual, torch.zeros(lanes, mjm.nu, dtype=torch.float64),
      bounds=(torch.as_tensor(lo), torch.as_tensor(hi)), max_iter=20)
  u = res.x.numpy()
  assert np.abs(u - u_star).max() <= 1e-8 * span.max(), np.abs(u - u_star)
  for i in range(lanes):
    np.testing.assert_allclose(c_step(i, u[i]).qvel, observed[i], rtol=0,
                               atol=1e-9)
