"""chip_smoke.py's phase 29 (the hammock, the kernels above n = 128) on the
CPU, at a small size, to rehearse it before a chip call.

    python3 scripts/rehearse_hammock_slice.py [LANES [STEPS [--ad]]]

Runs ``chip_smoke.hammock_slice`` on the CPU, both its timed and its check
parts, with LANES lanes (default 2) in the fleet, the fp64 steps and the
``inverse_test``, STEPS steps of each (default 1), and the record run's
first 10 steps.  ``transition_ad`` and ``transition_fd`` of the
contact-free scene, 669 tangents a lane, take minutes and gigabytes here:
they are left out unless ``--ad`` is given (then at one lane).  The card's
synchronisations are no-ops here, the kernels' launch counts, which only
the card makes, read 1, and the profiles and kernel timings, which need
the card, are left out.  The shapes at which the run calls the Cholesky
functions and their forward-mode rules (the kernels' shapes on the card,
the block kernels' above n = 128) are recorded, counted as the card's
wrappers count them, and held to
``chip_smoke.hammock_shapes`` at these sizes.  It imports no ``mujoco``.
Every time it prints is the CPU's and says nothing of the card's speed.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _CpuGenerator(torch.Generator):
  """torch.Generator that ignores the ``device`` the phase asks for."""

  def __init__(self, device=None):
    del device
    super().__init__()


def main() -> None:
  ad = "--ad" in sys.argv[1:]
  args = [int(a) for a in sys.argv[1:] if a != "--ad"]
  lanes, steps = args + [2, 1][len(args):]
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
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  cs.HAMMOCK_FLEET = cs.HAMMOCK_CHECK_LANES = lanes
  cs.HAMMOCK_INVERSE_LANES = lanes
  cs.HAMMOCK_STEPS = cs.HAMMOCK_CHECK_STEPS = cs.HAMMOCK_INVERSE_STEPS = steps
  cs.HAMMOCK_RECORD = cs.HAMMOCK_RECORD[:1]
  cs.HAMMOCK_AD_LANES = 1
  cs.read_launches = lambda _: dict.fromkeys(cs.KERNELS, 1)
  cs.time_large_kernels = lambda *a, **k: {}  # CUDA events: the card's
  event = types.SimpleNamespace(key="cpu", count=1, device_time_total=1e3)
  cs.device_events = lambda fn: (fn(), [event])[1]
  if not ad:
    stub = lambda m, d, **k: types.SimpleNamespace(A=torch.ones(1))
    derivative.transition_ad = derivative.transition_fd = stub

  # the functions' shapes, as the card's wrappers count them: the block
  # kernels' above N_MAX
  seen = {k: set() for k in cs.KERNELS}
  sfx = lambda n: "_large" if n > linalg.N_MAX else ""
  factor, solve = linalg.chol_factor_ref, linalg.chol_solve_ref
  factor_jvp, solve_jvp = linalg.chol_factor_jvp, linalg.chol_solve_jvp

  def record(name, shape):
    seen[name].add(shape)
    getattr(linalg, name).shapes[shape] += 1

  def chol_factor_ref(h):
    n = h.shape[-1]
    record(f"chol_factor{sfx(n)}", (n, h.shape[0], h.dtype))
    return factor(h)

  def chol_solve_ref(l, b):
    n = l.shape[-1]
    record(f"chol_solve{sfx(n)}",
           (n, l.shape[0], b.shape[2] if b.ndim == 3 else 1, l.dtype))
    return solve(l, b)

  def chol_factor_jvp(l, dh):
    n, t = l.shape[-1], dh.shape[0] if dh.ndim == 4 else 1
    record(f"chol_factor_jvp{sfx(n)}", (n, l.shape[0], t, l.dtype))
    return factor_jvp(l, dh)

  def chol_solve_jvp(l, dl, x, db):
    n = l.shape[-1]
    t = max([1] + [a.shape[0] for a, nd in ((dl, 4), (db, x.ndim + 1))
                   if a is not None and a.ndim == nd])
    k = x.shape[2] if x.ndim == 3 else 1
    record(f"chol_solve_jvp{sfx(n)}", (n, l.shape[0], t, k, l.dtype))
    return solve_jvp(l, dl, x, db)

  for fn, kernel in ((chol_factor_jvp, factor_jvp),
                     (chol_solve_jvp, solve_jvp)):
    fn.launches, fn.shapes = 0, kernel.shapes
  linalg._factor, linalg._solve = chol_factor_ref, chol_solve_ref
  linalg.chol_factor_jvp, linalg.chol_solve_jvp = chol_factor_jvp, (
      chol_solve_jvp)
  cs.hammock_slice(mt, linalg, "cpu", "cpu")
  checked = cs.hammock_shapes(mt)
  missing = {k: sorted(map(str, v - checked[k])) for k, v in seen.items()}
  for k, v in seen.items():
    print(f"{k}: {len(v)} shapes called, not in hammock_shapes: "
          f"{missing[k]}")
  assert sys.modules.get("mujoco") is None, "the rehearsal imported mujoco"
  if any(missing.values()):
    raise SystemExit("shapes outside hammock_shapes")


if __name__ == "__main__":
  main()
