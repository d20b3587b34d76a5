"""Steps/s of the humanoid_mjx fleet of one checkout, on one NVIDIA GPU.

    python3 scripts/fleet_steps.py CHECKOUT LABEL

Imports the port from CHECKOUT (a directory holding
``mujoco_inversedynamicstest_tpu_torch/``, e.g. a ``git archive`` of
another commit), builds its kernels, and times 100 steps of phase 6's
fleet of ``chip_smoke.py`` (B = 4096 fp32, the same seeded states) after
a warm-up step.  Prints one line: LABEL, steps/s, and the wall and host
process time a step.  Run it for two checkouts in turns, in one call, to
compare their fleet step without phase 6's profile and fp64 check.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def main() -> None:
  checkout, label = sys.argv[1], sys.argv[2]
  sys.path.insert(0, checkout)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  if not torch.cuda.is_available():
    raise SystemExit("fleet_steps: torch.cuda.is_available() is false")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  linalg.build_kernels()
  m = mt.put_model(mt.asset_path("humanoid_mjx.npz"), dtype=torch.float32)
  batch = 4096
  rng = np.random.RandomState(0)
  dq = 0.02 * rng.randn(batch, m.nq)
  dq[:, :7] = 0.0
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
  d = mt.make_data(m, batch)
  d = mt.step(m, d.replace(qpos=d.qpos + t(dq),
                           ctrl=t(0.01 * rng.randn(batch, m.nu))))
  torch.cuda.synchronize()
  t0, c0 = time.perf_counter(), time.process_time()
  for _ in range(100):
    d = mt.step(m, d)
  torch.cuda.synchronize()
  wall, cpu = time.perf_counter() - t0, time.process_time() - c0
  print(f"{label} {batch * 100 / wall:.1f} steps/s, wall "
        f"{10 * wall:.3f} ms/step, host process {10 * cpu:.3f} ms/step",
        flush=True)


if __name__ == "__main__":
  main()
