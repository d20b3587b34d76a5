"""``chip_smoke.py``'s phase 28 rehearsed on the CPU, in a process where
``mujoco`` cannot be imported (the card's machine has none): every check
of the phase passes at a small size, and every Cholesky call is at a
shape ``chip_smoke.tools_shapes`` lists (``scripts/rehearse_tools_slice.py``
at 9 lanes, 3 iterations, 30 band rows, an MPC of one lane and H = 2)."""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_phase_28_rehearsal_without_mujoco(tmp_path):
  code = ("import runpy, sys; sys.modules['mujoco'] = None; "
          "sys.argv = ['rehearse_tools_slice.py', '9', '3', '30', '1', '2']; "
          f"runpy.run_path({str(REPO / 'scripts' / 'rehearse_tools_slice.py')!r}"
          ", run_name='__main__')")
  env = dict(os.environ, OMP_NUM_THREADS="1")
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
  assert "phase 28 in" in out.stdout
  assert out.stdout.count("not in tools_shapes: []") == 4, out.stdout[-2000:]
