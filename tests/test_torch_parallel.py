"""The port's fleet sharding and weak-scaling harness (``parallel/``) on a
mesh of four CPU entries, the stand-in for the JAX tests' virtual devices
(``tests/test_parallel.py``, ``tests/test_northstar.py``).

The sharded step equals the unsharded step bit for bit, its mean |qacc|
within 1e-12; the sharded arm fleet MPC matches ``fleet_mpc_fn`` at rtol
1e-12; ``mpc_weak_scaling`` at 1, 2 and 4 entries reports a positive
efficiency (wall-clock ratios on one CPU are noise: the harness and the
sharded program are what is checked).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import numpy as np
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.opt import northstar
from mujoco_inversedynamicstest_tpu_torch.parallel import scaling, sharding

from models import ACTUATED
from test_mpc import ARM

CPU4 = ["cpu"] * 4


def test_sharded_step_matches_unsharded():
  m = mt.put_model(mujoco.MjModel.from_xml_string(ACTUATED), device="cpu")
  mesh = sharding.make_mesh(CPU4)
  assert mesh.size == 4 and mesh.axis == "batch"
  n = 16
  rng = np.random.RandomState(0)
  d = mt.make_data(m, n)
  d = d.replace(qpos=d.qpos + torch.as_tensor(0.05 * rng.randn(n, m.nq)),
                ctrl=torch.as_tensor(rng.randn(n, m.nu)))
  ref = mt.step(m, d)

  step = sharding.sharded_step_fn(m, mesh, mt.step)
  out, diag = step(sharding.shard_batch(mesh, d))
  assert [s.batch for s in out.shards] == [4] * 4
  whole = out.gather()
  for f in ("qpos", "qvel", "qacc", "act"):
    assert torch.equal(getattr(whole, f), getattr(ref, f)), f
  np.testing.assert_allclose(float(diag), float(ref.qacc.abs().mean()),
                             rtol=0, atol=1e-12)


def test_sharded_fleet_matches_unsharded():
  m = mt.put_model(mujoco.MjModel.from_xml_string(ARM), device="cpu")
  cost = northstar.balance_cost(m)
  cfg = northstar.NorthStarConfig(
      horizon=8, fleet=8, n_replan=1, ilqr_iterations=1, n_alpha=4,
      lin_batch=None)
  fleet = northstar.make_fleet(m, mt.make_data(m, 1), cfg)
  ref = northstar.fleet_mpc_fn(m, cost, cfg)(fleet)

  mesh = sharding.make_mesh(CPU4)
  fn = scaling.sharded_fleet_mpc_fn(m, cost, cfg, mesh)
  costs, gmean = fn(sharding.shard_batch(mesh, fleet))
  np.testing.assert_allclose(costs.numpy(), ref.plan_costs.numpy(),
                             rtol=1e-12)
  np.testing.assert_allclose(float(gmean), float(ref.plan_costs.mean()),
                             rtol=1e-12)


def test_weak_scaling_harness():
  m = mt.put_model(mujoco.MjModel.from_xml_string(ARM), device="cpu")
  cost = northstar.balance_cost(m)
  cfg = northstar.NorthStarConfig(
      horizon=6, fleet=2, n_replan=1, ilqr_iterations=1, n_alpha=2,
      lin_batch=None)
  res = scaling.mpc_weak_scaling(m, cost, mt.make_data(m, 1), cfg,
                                 fleet_per_device=2, device_counts=[1, 2, 4],
                                 devices=CPU4)
  assert [p.n_devices for p in res.points] == [1, 2, 4]
  for p in res.points:
    assert p.solves_per_sec > 0 and np.isfinite(p.plan_cost_mean)
  assert res.efficiency > 0, f"weak-scaling efficiency {res.efficiency}"
  one = scaling.mpc_weak_scaling(m, cost, mt.make_data(m, 1), cfg,
                                 devices=["cpu"])
  assert len(one.points) == 1 and np.isnan(one.efficiency)


def test_weak_scaling_shapes():
  m = mt.put_model(mujoco.MjModel.from_xml_string(ACTUATED), device="cpu")
  mesh = sharding.make_mesh(CPU4)
  batch = sharding.weak_scaling_batch(m, mt.make_data, 3, mesh)
  assert [s.qpos.shape for s in batch.shards] == [(3, m.nq)] * 4
  assert batch.gather().qpos.shape == (12, m.nq)
  assert len(sharding.replicate(mesh, m)) == 4
