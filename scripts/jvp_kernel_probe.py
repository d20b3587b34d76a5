"""Probes of the multi-tangent JVP kernels on one NVIDIA GPU.

    python3 scripts/jvp_kernel_probe.py layouts
    python3 scripts/jvp_kernel_probe.py spread

``layouts``: both JVP kernels against their plain versions, bit-equal,
over n, lanes, 1-75 tangents and every operand layout the wrappers take;
then ``chol_factor_jvp`` timed at the bench chunk (1024 lanes x 75
tangents) and in the folded layout of the same work (76,800 lanes x 1),
and ``transition_jacobian`` on 8 fp64 humanoid lanes against the plain
versions.

``spread``: an A/B of the factor JVP's trailing update.  The tree's
kernel gives each lane whole rows (lane l updates rows l, l + 32, ...);
the variant, generated from the same source by text substitution,
spreads the trailing triangle over the lanes element by element.  Both
are built into their own libraries, checked bit-equal to the plain
version (each case reports which one differs), and timed in turns
(rows, spread, spread, rows, rows, spread).

Prints the card's name and power limit first; needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mujoco_inversedynamicstest_tpu_torch.ops import linalg  # noqa: E402

ROWS = '''      for (int r = lane; r < n; r += kWarp) {
        if (r == k) t[tri(k) + k] = dd;
        if (r <= k) continue;
        const T* lrow = a + tri(r);
        T* row = t + tri(r);
        const T lrk = lrow[k], drk = row[k];
        for (int j = k + 1; j <= r; ++j) {
          const int jk = tri(j) + k;
          row[j] -= drk * a[jk] + lrk * t[jk];
        }
      }
'''
SPREAD = '''      if (lane == 0) t[tri(k) + k] = dd;
      for_each_lower(n - 1 - k, lane, kWarp, [&](int, int i, int jj) {
        const int r = k + 1 + i, j = k + 1 + jj;
        t[tri(r) + j] -= t[tri(r) + k] * a[tri(j) + k] +
                         a[tri(r) + k] * t[tri(j) + k];
      });
'''


def time_ms(fn, reps: int = 20) -> float:
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  fn()
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / reps


def spd(rng, b, n, dt, dev):
  g = torch.as_tensor(rng.standard_normal((b, n, n)), device=dev)
  return (g @ g.transpose(1, 2)
          + n * torch.eye(n, device=dev, dtype=g.dtype)).to(dt)


def layouts(dev) -> None:
  rng = np.random.default_rng(0)
  cases = 0
  for dt in (torch.float32, torch.float64):
    for n in (1, 2, 27, 33, 64, 128):
      for b, t in ((1, 1), (127, 1), (5, 3), (33, 75), (3, 4)):
        l = linalg.chol_factor_ref(spd(rng, b, n, dt, dev))
        dh = torch.as_tensor(rng.standard_normal((t, b, n, n)), device=dev,
                             dtype=dt)
        lane_major = dh.transpose(0, 1).contiguous().transpose(0, 1)
        for d in (dh, lane_major, dh.transpose(-1, -2),
                  dh[:1].expand(t, b, n, n), dh[0]):
          assert torch.equal(linalg.chol_factor_jvp(l, d),
                             linalg.chol_factor_jvp_ref(l, d))
          cases += 1
        dl = linalg.chol_factor_jvp_ref(l, dh)
        for shape in ((b, n), (b, n, 3)):
          x = torch.as_tensor(rng.standard_normal(shape), device=dev,
                              dtype=dt)
          db = torch.as_tensor(rng.standard_normal((t, *shape)), device=dev,
                               dtype=dt)
          for a, c in ((dl, db), (dl, None), (None, db), (dl[0], db),
                       (dl, db[0]), (dl[0], db[0])):
            assert torch.equal(linalg.chol_solve_jvp(l, a, x, c),
                               linalg.chol_solve_jvp_ref(l, a, x, c))
            cases += 1
  print(f"{cases} cases bit-equal")
  b, t, n = 1024, 75, 27
  l = linalg.chol_factor_ref(spd(rng, b, n, torch.float32, dev))
  dh = torch.as_tensor(rng.standard_normal((t, b, n, n)), device=dev,
                       dtype=torch.float32)
  dh = dh + dh.transpose(-1, -2)
  folded_l = l.repeat_interleave(t, 0)
  folded_dh = dh.transpose(0, 1).reshape(-1, n, n).contiguous()
  print(f"chol_factor_jvp ms: ({b} lanes, {t} tangents) "
        f"{time_ms(lambda: linalg.chol_factor_jvp(l, dh)):.4f}; "
        f"({b * t} lanes, 1 tangent) "
        f"{time_ms(lambda: linalg.chol_factor_jvp(folded_l, folded_dh)):.4f}")

  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative
  m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                   dtype=torch.float64)
  d = mt.make_data(m, 8)
  r = np.random.RandomState(1)
  dq = 0.02 * r.randn(8, m.nq)
  dq[:, :7] = 0.0
  dq[:, 2] -= 0.22
  d = mt.forward(m, d.replace(
      qpos=d.qpos + torch.as_tensor(dq, device=dev),
      qvel=torch.as_tensor(0.1 * r.randn(8, m.nv), device=dev)))
  t0 = time.perf_counter()
  qpos, qvel, jac = derivative.transition_jacobian(m, d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  nxt = mt.step(m, d)
  saved = {k: getattr(linalg, k) for k in ("chol_factor_jvp",
                                           "chol_solve_jvp", "_factor",
                                           "_solve")}
  linalg.chol_factor_jvp = linalg.chol_factor_jvp_ref
  linalg.chol_solve_jvp = linalg.chol_solve_jvp_ref
  linalg._factor, linalg._solve = linalg.chol_factor_ref, linalg.chol_solve_ref
  try:
    plain = derivative.transition_jacobian(m, d)[2]
  finally:
    for k, fn in saved.items():
      setattr(linalg, k, fn)
  print(f"transition_jacobian, 8 humanoid lanes fp64: {seconds:.3f} s; "
        f"primal equal to step's {torch.equal(qpos, nxt.qpos)} "
        f"{torch.equal(qvel, nxt.qvel)}; kernels vs plain max "
        f"{float((jac - plain).abs().max()):.3e}")


def spread(dev, out_dir: str) -> None:
  src = linalg._SRC.read_text()
  if ROWS not in src:
    raise SystemExit("the tree's factor JVP no longer has the row loop")
  os.makedirs(out_dir, exist_ok=True)
  fns = {}
  for name, text in (("rows", src), ("spread", src.replace(ROWS, SPREAD))):
    path = os.path.join(out_dir, f"cholesky_{name}.cu")
    with open(path, "w") as f:
      f.write(text)
    lib = os.path.join(out_dir, f"libcholesky_{name}.so")
    proc = subprocess.run([linalg._nvcc(), *linalg.NVCC_FLAGS, "-o", lib,
                           path], capture_output=True, text=True)
    if proc.returncode:
      raise SystemExit(proc.stderr)
    fn = ctypes.CDLL(lib)
    fns[name] = {}
    for dt, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
      f = getattr(fn, f"mi_chol_factor_jvp_{sfx}")
      p, i = ctypes.c_void_p, ctypes.c_int
      f.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i,
                    i, i, i, p]
      fns[name][dt] = f

  def run(fn, l, dh):
    out = torch.empty(dh.shape, dtype=l.dtype, device=dev)
    g = linalg.jvp_launch_geometry(l.shape[-1], l.dtype, dh.shape[0])
    err = fn(l.data_ptr(), dh.data_ptr(), out.data_ptr(),
             linalg._strides(l, dh, out), l.shape[-1], l.shape[0],
             dh.shape[0], g.lanes, g.warps, g.buffers, g.smem,
             torch.cuda.current_stream().cuda_stream)
    if err:
      raise RuntimeError(f"launch failed: cudaError {err}")
    return out

  rng = np.random.default_rng(0)
  for b, t, n, dt in ((1024, 75, 27, torch.float32),
                      (76800, 1, 27, torch.float32),
                      (1280, 75, 27, torch.float32),
                      (8, 75, 27, torch.float64),
                      (127, 3, 128, torch.float64)):
    l = linalg.chol_factor_ref(spd(rng, b, n, dt, dev))
    dh = torch.as_tensor(rng.standard_normal((t, b, n, n)), device=dev).to(dt)
    dh = dh + dh.transpose(-1, -2)
    ref = linalg.chol_factor_jvp_ref(l, dh)
    outs = {k: run(f[dt], l, dh) for k, f in fns.items()}
    torch.cuda.synchronize()
    equal = {k: torch.equal(o, ref) for k, o in outs.items()}
    ts = {k: [] for k in fns}
    for k in ("rows", "spread", "spread", "rows", "rows", "spread"):
      ts[k].append(time_ms(lambda: run(fns[k][dt], l, dh)))
    print(f"({b} lanes, {t} tangents) n={n} {str(dt)[6:]}: bit-equal to "
          f"plain {equal}; ms rows "
          + " ".join(f"{v:.4f}" for v in ts["rows"]) + "; spread "
          + " ".join(f"{v:.4f}" for v in ts["spread"]))


def main() -> None:
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("probe", choices=("layouts", "spread"))
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("jvp_kernel_probe: no CUDA device")
  torch.backends.cuda.matmul.allow_tf32 = False
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
  print(smi.stdout.strip())
  dev = torch.device("cuda:0")
  if args.probe == "layouts":
    layouts(dev)
  else:
    spread(dev, os.path.join(REPO, "build", "jvp_kernel_probe"))


if __name__ == "__main__":
  main()
