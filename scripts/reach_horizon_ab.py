"""BASELINE rung 2's reach (chip_smoke.py's phase 19) at horizon 50 and
at horizon 25, one after the other in one process on the card.

    python3 scripts/reach_horizon_ab.py

Builds the kernels, then runs chip_smoke.py's reach (REACH_F fp32
problems, REACH_ITERATIONS iterations, REACH_ALPHAS step sizes) at H = 50
and at H = 25, and prints each solve's seconds and the median distance of
the hand to its target at the plan's end: what the horizon's cut saves,
on one card.  Needs a card.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  sys.path.insert(0, REPO)
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg
  from mujoco_inversedynamicstest_tpu_torch.opt.ilqr import ILQRConfig, ilqr

  linalg.build_kernels()
  torch.backends.cuda.matmul.allow_tf32 = False
  print(cs.nvidia_smi(), flush=True)
  m = cs.constraint_model(mt, "tendon_arm", "cuda", torch.float32)
  for h in (50, 25):
    cs.REACH_H = h
    d0, us, target = cs.reach_problems(mt, m, cs.REACH_F, seed=21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ilqr(m, cs.reach_cost, d0, us, ILQRConfig(
        iterations=cs.REACH_ITERATIONS, n_alpha=cs.REACH_ALPHAS),
               cost_args=(target,))
    torch.cuda.synchronize()
    end = cs.arm_hand(res.xs.qpos[:, -1])
    print(f"reach F={cs.REACH_F} H={h}: {time.perf_counter() - t0:.3f} s, "
          "median distance at the end "
          f"{float((end - target).norm(dim=-1).median()):.4f}", flush=True)


if __name__ == "__main__":
  main()
