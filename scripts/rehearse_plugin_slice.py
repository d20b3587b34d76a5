"""chip_smoke.py's phase 27 (the engine plugins and the SDF plugin geoms)
on the CPU, at a small size, to rehearse it before a chip call.

    python3 scripts/rehearse_plugin_slice.py [LANES [STEPS]]

Runs ``chip_smoke.plugin_slice`` on the CPU, both its timed and its check
parts, with LANES fleet lanes (default 8) and STEPS fleet steps (default
2, the SDF scenes' too; the checks' 64 lanes are the phase's).  The
card's synchronisations are no-ops here, the kernels' launch counts,
which only the card makes, read 1, and the profiles and kernel timings,
which need the card, are left out.  Every number it prints is the CPU's
and says nothing of the card's speed.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  args = [int(a) for a in sys.argv[1:]]
  lanes, steps = args + [8, 2][len(args):]
  sys.path.insert(0, REPO)
  torch.cuda.synchronize = lambda *a, **k: None
  torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
  torch.cuda.max_memory_allocated = lambda *a, **k: 0
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  cs.FLEET, cs.PLUGIN_STEPS, cs.SDF_STEPS = lanes, steps, steps
  cs.read_launches = lambda _: dict.fromkeys(cs.KERNELS, 1)
  # CUDA events and the profiler: the card's alone
  cs.time_kernels = cs.time_jvp_kernels = lambda *a, **k: {}
  cs.device_profile = lambda fn: (fn(), (1.0, 1, {}))[1]
  cs.plugin_slice(mt, linalg, "cpu", "cpu")


if __name__ == "__main__":
  main()
