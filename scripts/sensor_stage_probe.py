"""Host cost of the sensor stage on one NVIDIA GPU.

    python3 scripts/sensor_stage_probe.py

dm_control's humanoid with its 34 sensors (``humanoid_sensors``), 4096
lanes in fp32 with the feet on the floor, after a forward.  For each part
of the sensor stage (``sensor_vel``, ``sensor_acc``, and inside the latter
``rne_postconstraint`` and the touch sensors; ``subtree_vel`` inside the
former): the host time to enqueue it (mean of 10 calls), the time to its
end on the card, and the number of operations that made the host wait for
the card (``torch.cuda.set_sync_debug_mode``), each of which drains the
card's queue.  Then the waits in one ``step`` of the humanoid with and
without its sensors, and 10 steps of each timed in turns (4 rounds).

Prints the card's name and power limit first; needs the card and nvcc.
"""

from __future__ import annotations

import os
import sys
import time
import warnings

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def waits(fn) -> int:
  """The operations of ``fn()`` that synchronize the host with the card."""
  torch.cuda.set_sync_debug_mode(1)
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      fn()
  finally:
    torch.cuda.set_sync_debug_mode(0)
  return sum("synchronizing" in str(w.message) for w in caught)


def main() -> None:
  if not torch.cuda.is_available():
    raise SystemExit("sensor_stage_probe: no CUDA device")
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.models.types import SensorType
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg, sensor, smooth

  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda:0")
  print(cs.nvidia_smi(), flush=True)
  linalg.build_kernels()
  models = {n: mt.put_model(mt.asset_path(f"{n}.npz"), device=dev,
                            dtype=torch.float32)
            for n in ("humanoid_sensors", "humanoid")}
  m = models["humanoid_sensors"]
  d = mt.forward(m, cs.fleet_data(mt, m, cs.FLEET, seed=0, drop=0.22))
  torch.cuda.synchronize()
  touch = m.sensor_objid[m.sensor_type == SensorType.TOUCH]
  parts = {"sensor_vel": lambda: sensor.sensor_vel(m, d),
           "subtree_vel": lambda: smooth.subtree_vel(m, d),
           "sensor_acc": lambda: sensor.sensor_acc(m, d),
           "rne_postconstraint": lambda: smooth.rne_postconstraint(m, d),
           "touch": lambda: sensor._touch(m, d, touch)}
  for name, fn in parts.items():
    fn()
    torch.cuda.synchronize()
    n_waits = waits(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
      fn()
    host = (time.perf_counter() - t0) / 10
    torch.cuda.synchronize()
    done = (time.perf_counter() - t0) / 10
    print(f"{name}: host {1e3 * host:.3f} ms a call, to its end "
          f"{1e3 * done:.3f} ms; {n_waits} waits for the card", flush=True)

  starts = {n: mt.step(mm, cs.fleet_data(mt, mm, cs.FLEET, seed=0,
                                         drop=0.22))
            for n, mm in models.items()}
  torch.cuda.synchronize()
  for n, mm in models.items():
    print(f"{n}: {waits(lambda: mt.step(mm, starts[n]))} waits for the card "
          "in a step", flush=True)
  seconds = {n: [] for n in models}
  for rnd in range(4):
    order = list(models) if rnd % 2 == 0 else list(models)[::-1]
    for n in order:
      t0 = time.perf_counter()
      mt.step_n(models[n], starts[n], 10)
      torch.cuda.synchronize()
      seconds[n].append(time.perf_counter() - t0)
  for n, s in seconds.items():
    print(f"{n}: 10 steps of {cs.FLEET} lanes in turns, s: "
          + ", ".join(f"{x:.3f}" for x in s))


if __name__ == "__main__":
  main()
