"""The port's SDF plugin scenes at rest, against C, and the ball in the
bowl against the JAX package, in float64 on the CPU.

The sphere dropped on the torus (300 steps) and the ball dropped into the
bowl (500 steps, ``assets/sdf_*``) come to rest at C's heights within
the JAX package's tests' limits (1e-2 and 0.05: C's SDF collider reports
another depth and seeds other inits, ROADMAP §3); the torus dropped on
the torus (200 steps) stays finite and above the fixed torus, as the JAX
package's test holds it.  The bowl's contacts and qacc at four states
against the JAX package's ``forward`` (``tests/test_torch_sdf_plugins.py``
holds the torus scenes so).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt

import test_torch_sdf_plugins

# the JAX package's tests' steps and limits
REST = {"sdf_torus": (300, 1e-2), "sdf_bowl": (500, 0.05)}


def _drop(name, steps):
  """The port's and C's height of the free body after ``steps`` steps from
  the scene's start."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  mjd = mujoco.MjData(mjm)
  m = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  d = mt.make_data(m, 1)
  for _ in range(steps):
    d = mt.step(m, d)
    mujoco.mj_step(mjm, mjd)
  assert torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()
  return float(d.qpos[0, 2]), float(mjd.qpos[2])


@pytest.mark.parametrize("name", sorted(REST))
def test_rests_like_c(name):
  steps, tol = REST[name]
  got, ref = _drop(name, steps)
  assert abs(got - ref) < tol, (got, ref)


def test_torus_on_torus_stays_above():
  """The free torus falls onto the fixed one and stays above it (the JAX
  package's test_sdf_sdf_pair_loads_and_runs: 200 steps, z > 0.4)."""
  m = mt.put_model(mt.asset_path("sdf_torus_pair.npz"), device="cpu")
  d = mt.step_n(m, mt.make_data(m, 1), 200)
  assert torch.isfinite(d.qpos).all()
  assert float(d.qpos[0, 2]) > 0.4


def test_bowl_contacts_match_jax():
  test_torch_sdf_plugins.check_forward_contacts("sdf_bowl")
