"""chip_smoke.py's phase 25 (the flex scenes) on the CPU, at a small size,
to rehearse it before a chip call.

    python3 scripts/rehearse_flex_slice.py [LANES [STEPS [INV_STEPS]]]

Runs ``chip_smoke.flex_slice`` on the CPU, both its timed and its check
parts, with LANES fleet lanes (default 8), STEPS steps of each fleet
(default 2) and INV_STEPS ``inverse_test`` steps (default 3; its 64 lanes
are the phase's).  The card's synchronisations are no-ops here, the
kernels' launch counts, which only the card makes, read 1, and the
profiles and kernel timings, which need the card, are left out.  The
shapes at which the run calls the Cholesky functions (the kernels' shapes
on the card) are recorded and held to ``chip_smoke.flex_shapes`` at
LANES fleet lanes, and each fleet's timed steps are counted in PyTorch
operators (each a launch on the card, but for views): the host work a
step costs wherever it runs.  Every time it prints is the CPU's and says
nothing of the card's speed.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _CpuGenerator(torch.Generator):
  """torch.Generator that ignores the ``device`` the phase asks for."""

  def __init__(self, device=None):
    del device
    super().__init__()


class _Count(TorchDispatchMode):
  """Counts the operators dispatched to PyTorch."""

  def __init__(self):
    super().__init__()
    self.ops = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops += 1
    return func(*args, **(kwargs or {}))


def main() -> None:
  args = [int(a) for a in sys.argv[1:]]
  lanes, steps, inv_steps = args + [8, 2, 3][len(args):]
  sys.path.insert(0, REPO)
  torch.cuda.synchronize = lambda *a, **k: None
  torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
  torch.cuda.max_memory_allocated = lambda *a, **k: 0
  torch.Generator = _CpuGenerator
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  cs.FLEET, cs.FLEX_STEPS, cs.FLEX_INVERSE_STEPS = lanes, steps, inv_steps
  cs.CLOTH_STEPS = steps
  cs.read_launches = lambda _: dict.fromkeys(cs.KERNELS, 1)
  cs.time_kernels = lambda *a, **k: {}  # CUDA events: the card's alone
  cs.time_jvp_kernels = lambda *a, **k: {}
  cs.device_profile = lambda fn: (fn(), (1.0, 1, {}))[1]

  # the primal functions' shapes, as the card's wrappers count them
  seen = {"chol_factor": set(), "chol_solve": set()}
  factor, solve = linalg.chol_factor_ref, linalg.chol_solve_ref

  def chol_factor_ref(h):
    seen["chol_factor"].add((h.shape[-1], h.shape[0], h.dtype))
    return factor(h)

  def chol_solve_ref(l, b):
    seen["chol_solve"].add((l.shape[-1], l.shape[0],
                            b.shape[2] if b.ndim == 3 else 1, l.dtype))
    return solve(l, b)

  linalg._factor, linalg._solve = chol_factor_ref, chol_solve_ref
  step_n = mt.step_n

  def counted_step_n(m, d, n, **kw):
    with _Count() as count:
      out = step_n(m, d, n, **kw)
    print(f"  (operators a step: {count.ops / n:.0f})")
    return out

  mt.step_n = counted_step_n
  cs.plain_cholesky = lambda _: __import__("contextlib").nullcontext()
  cs.flex_slice(mt, linalg, "cpu", "cpu")
  primal = cs.flex_shapes(mt)[0]
  checked = {"chol_factor": primal,
             "chol_solve": {(n, b, 1, dt) for n, b, dt in primal}}
  for k, v in seen.items():
    missing = sorted(map(str, v - checked[k]))
    print(f"{k}: {len(v)} shapes called, not in flex_shapes: {missing}")


if __name__ == "__main__":
  main()
