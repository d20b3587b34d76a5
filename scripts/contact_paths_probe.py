"""Fleet steps/s and factorizations a step of the contact models, and the
touch stage's two forms, for one checkout on one NVIDIA GPU.

    python3 scripts/contact_paths_probe.py CHECKOUT LABEL [STEPS]

Imports the port and ``chip_smoke.py``'s seeded fleet states from
CHECKOUT (a directory holding both, e.g. a ``git archive`` of another
commit), builds its kernels, and for each fleet of B = 4096 fp32 lanes
takes a warm-up step, then STEPS (default 20) steps with ``step_n``:

* ``humanoid_mjx`` (phase 6's states), ``humanoid_sensors`` (phase 17's:
  touch sensors and ``cfrc_ext``), ``box_stack`` and ``convex_mesh``
  (phase 20's), elliptic ``box_stack`` (phase 22's), and ``sphere_budget``
  (lane-selected slots);
* prints one line a fleet: LABEL, steps/s, the Cholesky factorizations a
  step (``chol_factor`` launches), finite lanes and the mean Newton
  iterations of the last step;
* then times ``sensor._touch`` on the sensor fleet's end state, and, where
  the checkout has it, ``sensor._touch_lanes`` on the same state (each
  slot tested against each sensor, as under a contact budget), with their
  largest difference.

Run it for several checkouts in turns, in one call, to compare them on
the same card.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def main() -> None:
  checkout, label = sys.argv[1], sys.argv[2]
  steps = int(sys.argv[3]) if len(sys.argv) > 3 else 20
  sys.path.insert(0, checkout)
  import chip_smoke as cs
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.models.types import SensorType
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg, sensor

  if not torch.cuda.is_available():
    raise SystemExit("contact_paths_probe: torch.cuda.is_available() is false")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  linalg.build_kernels()
  dev = torch.device("cuda:0")
  batch = cs.FLEET
  f32 = torch.float32
  fleets = {
      "humanoid_mjx": lambda: (
          lambda m: (m, cs.fleet_data(mt, m, batch, seed=0)))(
              mt.put_model(mt.asset_path("humanoid_mjx.npz"), device=dev,
                           dtype=f32)),
      "humanoid_sensors": lambda: (
          lambda m: (m, cs.fleet_data(mt, m, batch, seed=0, drop=0.22)))(
              mt.put_model(mt.asset_path("humanoid_sensors.npz"),
                           device=dev, dtype=f32)),
      "box_stack": lambda: (
          lambda m: (m, cs.convex_data(mt, m, batch, seed=20)))(
              cs.constraint_model(mt, "box_stack", dev, f32)),
      "convex_mesh": lambda: (
          lambda m: (m, cs.convex_data(mt, m, batch, seed=20)))(
              cs.constraint_model(mt, "convex_mesh", dev, f32)),
      "box_stack elliptic": lambda: (
          lambda m: (m, cs.contact_data(mt, m, "box_stack", batch, 22)))(
              cs.contact_model(mt, "box_stack", dev, f32)),
      "sphere_budget": lambda: (
          lambda m: (m, cs.contact_data(mt, m, "sphere_budget", batch, 22)))(
              cs.contact_model(mt, "sphere_budget", dev, f32, cone=None)),
  }
  ends = {}
  for name, make in fleets.items():
    m, d = make()
    d = mt.step(m, d)
    torch.cuda.synchronize()
    linalg.chol_factor.launches = 0
    t0 = time.perf_counter()
    d = mt.step_n(m, d, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
    print(f"{label} {name}: {batch * steps / seconds:.1f} steps/s, "
          f"factorizations a step {linalg.chol_factor.launches / steps:g}, "
          f"finite lanes {int(finite.sum())} of {batch}, Newton iterations "
          f"(last step) mean {float(d.solver_niter.float().mean()):.3f}",
          flush=True)
    ends[name] = (m, d)

  m, d = ends["humanoid_sensors"]
  d = mt.forward(m, d)
  sites = m.sensor_objid[m.sensor_type == int(SensorType.TOUCH)]
  forms = {"_touch": sensor._touch}
  if hasattr(sensor, "_touch_lanes"):
    forms["_touch_lanes"] = sensor._touch_lanes
  out = {}
  for name, fn in list(forms.items()) * 2:
    fn(m, d, sites)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
      out[name] = fn(m, d, sites)
    torch.cuda.synchronize()
    print(f"{label} {name}: {len(sites)} touch sensors, B={batch} fp32, "
          f"{(time.perf_counter() - t0) * 1e2:.3f} ms a call", flush=True)
  if len(out) == 2:
    print(f"{label} touch forms differ by "
          f"{float((out['_touch'] - out['_touch_lanes']).abs().max()):.3e}",
          flush=True)


if __name__ == "__main__":
  main()
