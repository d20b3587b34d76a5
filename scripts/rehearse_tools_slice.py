"""chip_smoke.py's phase 28 (least squares, checkpoints, sharding, names,
the printer, the band solvers) on the CPU, at a small size, to rehearse
it before a chip call.

    python3 scripts/rehearse_tools_slice.py [LANES [ITERS [BAND_ROWS
                                             [MPC_FLEET [HORIZON]]]]]

Runs ``chip_smoke.tools_slice`` on the CPU, both its timed and its check
parts, with LANES system-identification lanes (default 16, at least the
8 the fp64 check takes), at most ITERS iterations (default 20), the
sharded step at LANES lanes, the band solvers at BAND_ROWS rows (default
270) and the MPC at MPC_FLEET lanes (default 8) and HORIZON steps
(default 10).  The card's synchronisations are no-ops here, the kernels'
launch counts, which only the card makes, read 1, and the kernel timings,
which need the card, are left out.  The shapes at which the run calls the
Cholesky functions and their forward-mode rules (the kernels' shapes on
the card) are recorded and held to ``chip_smoke.tools_shapes`` at LANES
lanes.  It imports no ``mujoco``.  Every time it prints is the CPU's and
says nothing of the card's speed.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  args = [int(a) for a in sys.argv[1:]]
  lanes, iters, rows, fleet, horizon = args + [16, 20, 270, 8, 10][
      len(args):]
  sys.path.insert(0, REPO)
  torch.cuda.synchronize = lambda *a, **k: None
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  cs.SYSID_LANES, cs.SYSID_ITERS, cs.FLEET = lanes, iters, lanes
  cs.BAND = (cs.BAND[0], rows, cs.BAND[2])
  cs.TOOLS_MPC_FLEET, cs.TOOLS_MPC_HORIZON = fleet, horizon
  cs.read_launches = lambda _: dict.fromkeys(cs.KERNELS, 1)
  cs.time_kernels = cs.time_jvp_kernels = lambda *a, **k: {}
  cs.plain_cholesky = lambda _: contextlib.nullcontext()

  # the functions' shapes, as the card's wrappers count them
  seen = {k: set() for k in cs.WARP_KERNELS}
  factor, solve = linalg.chol_factor_ref, linalg.chol_solve_ref
  factor_jvp, solve_jvp = linalg.chol_factor_jvp, linalg.chol_solve_jvp

  def chol_factor_ref(h):
    seen["chol_factor"].add((h.shape[-1], h.shape[0], h.dtype))
    return factor(h)

  def chol_solve_ref(l, b):
    seen["chol_solve"].add((l.shape[-1], l.shape[0],
                            b.shape[2] if b.ndim == 3 else 1, l.dtype))
    return solve(l, b)

  def chol_factor_jvp(l, dh):
    t = dh.shape[0] if dh.ndim == 4 else 1
    seen["chol_factor_jvp"].add((l.shape[-1], l.shape[0], t, l.dtype))
    return factor_jvp(l, dh)

  def chol_solve_jvp(l, dl, x, db):
    t = max([1] + [a.shape[0] for a, nd in ((dl, 4), (db, x.ndim + 1))
                   if a is not None and a.ndim == nd])
    k = x.shape[2] if x.ndim == 3 else 1
    seen["chol_solve_jvp"].add((l.shape[-1], l.shape[0], t, k, l.dtype))
    return solve_jvp(l, dl, x, db)

  for fn, kernel in ((chol_factor_jvp, factor_jvp),
                     (chol_solve_jvp, solve_jvp)):
    fn.launches, fn.shapes = 0, kernel.shapes
  linalg._factor, linalg._solve = chol_factor_ref, chol_solve_ref
  linalg.chol_factor_jvp, linalg.chol_solve_jvp = chol_factor_jvp, (
      chol_solve_jvp)
  cs.tools_slice(mt, linalg, "cpu", "cpu")
  primal, jvp = cs.tools_shapes(mt)
  checked = {"chol_factor": primal,
             "chol_solve": {(n, b, 1, dt) for n, b, dt in primal},
             "chol_factor_jvp": jvp,
             "chol_solve_jvp": {(n, b, t, 1, dt) for n, b, t, dt in jvp}}
  missing = {k: sorted(map(str, v - checked[k])) for k, v in seen.items()}
  for k, v in seen.items():
    print(f"{k}: {len(v)} shapes called, not in tools_shapes: {missing[k]}")
  assert sys.modules.get("mujoco") is None, "the rehearsal imported mujoco"
  if any(missing.values()):
    raise SystemExit("shapes outside tools_shapes")


if __name__ == "__main__":
  main()
