"""What one fleet step asks of the host, counted on the CPU.

    python3 scripts/step_host_cost.py CHECKOUT [ASSET]

Imports the port from CHECKOUT (a directory holding
``mujoco_inversedynamicstest_tpu_torch/``, e.g. a ``git archive`` of
another commit) and steps 4 lanes of ASSET (default ``humanoid_mjx.npz``)
in fp32 on the CPU.  For one step after three warm-up steps it prints the
operators dispatched to PyTorch (each a launch on the card, but for views)
and the Python function calls (``cProfile``): the host work a step costs
wherever it runs, so two checkouts can be compared without a card.
"""

from __future__ import annotations

import cProfile
import pstats
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):

  def __init__(self):
    super().__init__()
    self.ops = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops += 1
    return func(*args, **(kwargs or {}))


def main() -> None:
  sys.path.insert(0, sys.argv[1])
  asset = sys.argv[2] if len(sys.argv) > 2 else "humanoid_mjx.npz"
  import mujoco_inversedynamicstest_tpu_torch as mt

  m = mt.put_model(mt.asset_path(asset), device="cpu", dtype=torch.float32)
  d = mt.make_data(m, 4)
  d = d.replace(qpos=d.qpos + 0.01)
  for _ in range(3):
    d = mt.step(m, d)
  with _Count() as count:
    mt.step(m, d)
  prof = cProfile.Profile()
  prof.enable()
  mt.step(m, d)
  prof.disable()
  print(f"{asset}: {count.ops} operators and "
        f"{pstats.Stats(prof).total_calls} Python calls a step")


if __name__ == "__main__":
  main()
