"""chip_smoke.py's phase 23 (the quadruped and the terrain) on the CPU, at
a small size, to rehearse it before a chip call.

    python3 scripts/rehearse_shapes_slice.py [LANES [STEPS [INV_STEPS]]]

Runs ``chip_smoke.quadruped_slice`` on the CPU, both its timed and its
check parts, with LANES fleet lanes (default 8), STEPS fleet steps
(default 3) and INV_STEPS ``inverse_test`` steps (default 4; its 64 lanes
are the phase's).  The card's synchronisations are no-ops here, the
kernels' launch counts, which only the card makes, read 1, and the
profiles and kernel timings, which need the card, are left out.  Every
number it prints is the CPU's and says nothing of the card's speed.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _CpuGenerator(torch.Generator):
  """torch.Generator that ignores the ``device`` the phase asks for."""

  def __init__(self, device=None):
    del device
    super().__init__()


def main() -> None:
  args = [int(a) for a in sys.argv[1:]]
  lanes, steps, inv_steps = args + [8, 3, 4][len(args):]
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

  cs.FLEET, cs.SHAPES_STEPS, cs.FETCH_INVERSE_STEPS = lanes, steps, inv_steps
  cs.read_launches = lambda _: dict.fromkeys(cs.KERNELS, 1)
  cs.time_kernels = lambda *a, **k: {}  # CUDA events: the card's alone
  cs.device_profile = lambda fn: (fn(), (1.0, 1, {}))[1]
  cs.quadruped_slice(mt, linalg, "cpu", "cpu")


if __name__ == "__main__":
  main()
