"""What a step of a contact fleet asks of the host under each friction
cone, counted on the CPU.

    python3 scripts/cone_host_cost.py [MODEL ...]

For each MODEL (default: phase 22's box_stack, convex_mesh, humanoid and
elliptic_pairs) steps 256 lanes of chip_smoke.py's phase-22 states in fp32
on the CPU under the pyramidal and the elliptic cone (``opt_cone`` set in
the snapshot's Mapping, as chip_smoke.py's ``contact_model`` sets it) and,
for one step after three warm-up steps, prints the operators dispatched to
PyTorch (each a launch on the card, but for views), the line search's
phi(alpha) evaluations and the most Newton iterations of a lane.  A
batched line search runs until its last lane is done, so these counts are
the host work the card waits on.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Count(TorchDispatchMode):

  def __init__(self):
    super().__init__()
    self.ops = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops += 1
    return func(*args, **(kwargs or {}))


def main() -> None:
  sys.path.insert(0, REPO)
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import solver

  evals = [0]
  line_phi = solver.line_phi

  def counted(m, d, st):
    phi, mv, jv = line_phi(m, d, st)

    def each(alpha):
      evals[0] += 1
      return phi(alpha)

    return each, mv, jv

  solver.line_phi = counted
  for name in sys.argv[1:] or cs.CONTACT_MODELS:
    for cone in ("PYRAMIDAL", "ELLIPTIC"):
      m = cs.contact_model(mt, name, "cpu", torch.float32, cone)
      d = cs.contact_data(mt, m, name, 256, seed=22)
      for _ in range(3):
        d = mt.step(m, d)
      evals[0] = 0
      with _Count() as count:
        out = mt.step(m, d)
      print(f"{name} {cone.lower()}: {count.ops} operators, {evals[0]} "
            f"phi evaluations, Newton iterations max "
            f"{int(out.solver_niter.max())} a step (256 lanes fp32)")


if __name__ == "__main__":
  main()
