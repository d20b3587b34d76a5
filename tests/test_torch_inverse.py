"""The PyTorch port's inverse dynamics on the humanoid.

``inverse`` against the JAX package and C ``mj_inverse`` (continuous and
INVDISCRETE Euler), and the forward/inverse consistency diagnostic in the
setting of the reference fork's ``src/inverse/inverse_test.cpp`` (random
applied forces and controls, tolerance 1e-6).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt

DROP = 0.22  # feet on the floor


def _humanoid(discrete=False):
  xml = mt.asset_path("humanoid.xml").read_text()
  if discrete:
    xml = xml.replace('<option timestep=".005"/>',
                      '<option timestep=".005"><flag invdiscrete="enable"/>'
                      '</option>')
  return mujoco.MjModel.from_xml_string(xml)


def _random_state(mjm, mjd, rng):
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] -= DROP
  mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
  mjd.qacc[:] = rng.randn(mjm.nv)
  mjd.qfrc_applied[:] = 0.3 * rng.randn(mjm.nv)
  mjd.xfrc_applied[:] = 0.3 * rng.randn(mjm.nbody, 6)


@pytest.mark.parametrize("discrete", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_inverse_matches_jax_and_c(seed, discrete):
  mjm = _humanoid(discrete)
  mjd = mujoco.MjData(mjm)
  _random_state(mjm, mjd, np.random.RandomState(seed))
  mujoco.mj_inverse(mjm, mjd)

  mj = mi.put_model(mjm)
  dj = mi.put_data(mj, mjd).replace(qacc=jnp.asarray(mjd.qacc))
  outj = jax.jit(mi.inverse)(mj, dj)
  mp = mt.put_model(mjm, device="cpu")
  outp = mt.inverse(mp, mt.put_data(mp, mjd))

  assert int((outp.contact.dist < outp.contact.includemargin).sum()) > 0
  ours = outp.qfrc_inverse[0].numpy()
  np.testing.assert_allclose(ours, np.asarray(outj.qfrc_inverse), rtol=0,
                             atol=1e-9)
  np.testing.assert_allclose(ours, mjd.qfrc_inverse, rtol=0, atol=1e-8)
  np.testing.assert_array_equal(outp.qacc[0].numpy(), mjd.qacc)


def test_compare_fwd_inv_within_fork_tolerance():
  """solver_fwdinv of a fleet with random applied forces and controls, per
  lane, stays within the fork's 1e-6 and matches the JAX diagnostic."""
  mjm = _humanoid()
  mp = mt.put_model(mjm, device="cpu")
  mj = mi.put_model(mjm)
  batch = 4
  rng = np.random.RandomState(7)
  states = []
  for _ in range(batch):
    mjd = mujoco.MjData(mjm)
    _random_state(mjm, mjd, rng)
    states.append({k: np.array(getattr(mjd, k)) for k in (
        "qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied")})
  fields = {k: np.stack([s[k] for s in states]) for k in states[0]}
  out = mt.compare_fwd_inv(mp, mt.forward(mp, mt.from_jax_arrays(mp, fields)))
  fwdinv = out.solver_fwdinv.numpy()
  assert fwdinv.shape == (batch, 2)
  assert np.all(fwdinv <= 1e-6), fwdinv

  d0 = mi.make_data(mj)
  dj = jax.vmap(lambda *a: d0.replace(**dict(zip(fields, a))))(
      *[jnp.asarray(v) for v in fields.values()])
  fn = jax.vmap(lambda d: mi.compare_fwd_inv(mj, mi.forward(mj, d)))
  outj = jax.jit(fn)(dj)
  np.testing.assert_allclose(fwdinv, np.asarray(outj.solver_fwdinv),
                             rtol=0, atol=1e-9)
  torch.testing.assert_close(out.qfrc_constraint,
                             torch.as_tensor(np.array(outj.qfrc_constraint)),
                             rtol=0, atol=1e-8)
