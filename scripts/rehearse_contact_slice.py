"""chip_smoke.py's phase 22 (the contact models) on the CPU, at a small
size, to rehearse it before a chip call.

    python3 scripts/rehearse_contact_slice.py [LANES [STEPS [INV_STEPS]]]

Runs ``chip_smoke.contact_slice`` on the CPU with LANES fleet lanes
(default 8), STEPS fleet and budget steps (default 3) and INV_STEPS
``inverse_test`` steps (default 4; its 64 lanes are the phase's).  The
card's synchronisations are no-ops here, and the kernels' launch counts,
which only the card makes, read 1, so the phase's checks of them pass;
the primal kernels' timing at the phase's sizes, which needs the card's
events, is left out.  Every number it prints is the CPU's and says
nothing of the card's speed.
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
  torch.Generator = _CpuGenerator
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  cs.FLEET, cs.CONTACT_STEPS, cs.BUDGET_STEPS = lanes, steps, steps
  cs.CONTACT_INVERSE_STEPS = inv_steps
  cs.read_launches = lambda _: dict.fromkeys(cs.KERNELS, 1)
  cs.time_kernels = lambda *a, **k: {}  # CUDA events: the card's alone
  cs.contact_slice(mt, linalg, "cpu", "cpu")


if __name__ == "__main__":
  main()
