"""Weak-scaling harness: MPC solves/s at 1..N devices.

Port of the JAX package's ``parallel/scaling.py``.  The fleet
is sharded over the mesh (``parallel/sharding.py``), each device runs its
shard's MPC solves, and the only cross-device traffic is the ``pmean`` of
the plan costs' mean.  ``mpc_weak_scaling`` measures solves/s at each
device count.  On one card the sweep has a single point and the
efficiency is NaN, as in the JAX package when its budget leaves one point.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import Model
from mujoco_inversedynamicstest_tpu_torch.opt import northstar
from mujoco_inversedynamicstest_tpu_torch.opt.mpc import run_mpc
from mujoco_inversedynamicstest_tpu_torch.parallel import sharding


class ScalePoint(NamedTuple):
  n_devices: int
  solves_per_sec: float
  wall_time_s: float
  compile_time_s: float   # the first (cold) run's seconds
  plan_cost_mean: float


class WeakScalingResult(NamedTuple):
  points: Tuple[ScalePoint, ...]
  # solves/s at max devices divided by (ndev * solves/s at 1 device)
  efficiency: float


def sharded_fleet_mpc_fn(m: Model, cost, cfg: northstar.NorthStarConfig,
                         mesh: sharding.Mesh, axis: str = "batch"):
  """Mesh-sharded fleet MPC: ``fn(sharded_fleet) -> (plan_costs,
  global_cost_mean)``, each shard's solves on its device, the plan costs
  (F, n_replan) gathered to the mesh's first device and their mean
  ``pmean``ed there.  ``cost`` is called with each device's model."""
  del axis
  mcfg = cfg.mpc_config()
  models = sharding.replicate(mesh, m)

  def fn(fleet: sharding.Sharded):
    runs = sharding.run_sharded(
        mesh, lambda mm, d: run_mpc(mm, cost, d, cfg.n_replan, mcfg), fleet,
        models)
    costs = [r.plan_costs for r in runs]
    return (torch.cat([c.to(mesh.devices[0]) for c in costs]),
            sharding.pmean(mesh, [c.mean() for c in costs]))

  return fn


def _sync(mesh: sharding.Mesh) -> None:
  for dev in set(mesh.devices):
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)


def mpc_weak_scaling(
    m: Model, cost, d0, cfg: northstar.NorthStarConfig,
    fleet_per_device: int = 2,
    device_counts: Optional[Sequence[int]] = None,
    time_budget_s: Optional[float] = None,
    devices: Optional[Sequence] = None,
) -> WeakScalingResult:
  """Measures MPC solves/s with the fleet sharded over 1..N devices
  (``devices``: default every card present).

  Weak scaling: the fleet a device is constant, the whole fleet grows with
  the device count.  Efficiency = throughput(N) / (N * throughput(1)),
  NaN with a single point.  ``time_budget_s`` bounds the sweep: counts are
  visited in the order given, and the sweep stops, keeping the points it
  has, once the budget is spent.
  """
  all_devices = sharding.make_mesh(devices).devices
  if device_counts is None:
    device_counts = [n for n in (1, 2, 4, 8) if n <= len(all_devices)]

  sweep_t0 = time.perf_counter()
  points = []
  for n in device_counts:
    if (time_budget_s is not None and points
        and time.perf_counter() - sweep_t0 > time_budget_s):
      break
    mesh = sharding.make_mesh(all_devices[:n])
    fleet_cfg = cfg._replace(fleet=fleet_per_device * n)
    fleet = sharding.shard_batch(mesh, northstar.make_fleet(m, d0, fleet_cfg))
    fn = sharded_fleet_mpc_fn(m, cost, fleet_cfg, mesh)

    t0 = time.perf_counter()
    fn(fleet)
    _sync(mesh)
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, gmean = fn(fleet)
    _sync(mesh)
    dt = time.perf_counter() - t0

    points.append(ScalePoint(
        n_devices=n,
        solves_per_sec=fleet_cfg.fleet * cfg.n_replan / dt,
        wall_time_s=dt,
        compile_time_s=compile_time,
        plan_cost_mean=float(gmean),
    ))

  points.sort(key=lambda p: p.n_devices)
  base, last = points[0], points[-1]
  if last.n_devices == base.n_devices:
    eff = float("nan")                 # a single point
  else:
    eff = last.solves_per_sec / (
        last.n_devices / base.n_devices * base.solves_per_sec)
  return WeakScalingResult(points=tuple(points), efficiency=float(eff))
