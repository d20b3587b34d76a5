"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and the script exits
non-zero:

1. env     -- versions, the card's name and power limit; TF32 off.
2. build   -- nvcc builds the Cholesky kernels from csrc/ for sm_90a.
3. kernel: chol_factor -- CUDA kernel against its plain torch version over
   n x B x dtype, plus the asymmetric-input, non-SPD and non-contiguous
   cases; every case must be bit-equal.
4. kernel: chol_solve  -- the same grid, one and three right-hand sides.
5. timing  -- each kernel against its plain version and against the one
   PyTorch call that computes the same function (torch.linalg.cholesky_ex,
   torch.cholesky_solve; the port never calls them) at the slice's shape,
   beside the least time the card could take (bound_ms).
6. slice: fleet step   -- 100 steps of 4096 humanoids (fp32) through the
   kernels; launch counts, finiteness, steps/s; device time by kernel over
   3 more steps (torch.profiler); then 5 steps of 64 lanes in fp64 with
   the kernels against 5 steps with the plain versions.
7. slice: inverse dynamics -- forward then compare_fwd_inv on 64 lanes
   (fp64, Newton with 100 iterations); solver_fwdinv <= 1e-6 on every lane.

Then one JSON line of the kernel report, the nvidia-smi line, and the
result line.  There is no CPU path: without CUDA the script fails.  It
imports neither jax nor mujoco: the humanoid comes from the model snapshots
in the package's assets/.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "mujoco_inversedynamicstest_tpu_torch/csrc/cholesky.cu"
REPLACES = {
    "chol_factor": "mujoco_inversedynamicstest_tpu/ops/linalg.py:63",
    "chol_solve": "mujoco_inversedynamicstest_tpu/ops/linalg.py:86",
}
FLEET, FLEET_STEPS = 4096, 100
GRID_N, GRID_B = (1, 2, 6, 27, 32, 33, 64, 128), (1, 127, 4096)
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}  # of max|reference|
# NVIDIA's H100 SXM data sheet: memory rate, and fp32 outside tensor cores
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12


def log(phase: str, msg: str) -> None:
  print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True)
  return out.stdout.strip().splitlines()[0]


def spd(rng: np.random.Generator, b: int, n: int, dev) -> torch.Tensor:
  """SPD matrices with condition number <= 1e3 (Gershgorin bound):
  G Gᵀ + (R / 999) I, R the largest absolute row sum of G Gᵀ."""
  g = torch.as_tensor(rng.standard_normal((b, n, n)), device=dev)
  h = g @ g.transpose(1, 2)
  r = h.abs().sum(-1).amax(-1)
  return h + (r / 999.0)[:, None, None] * torch.eye(n, device=dev,
                                                     dtype=h.dtype)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
  if not bool(torch.isfinite(x).all()):
    raise AssertionError("non-finite kernel output")
  if x.shape != ref.shape:
    raise AssertionError(f"kernel output {tuple(x.shape)}, "
                         f"expected {tuple(ref.shape)}")
  return float((x - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
  """The least time the card could take: each input byte read once and each
  output byte written once at the memory rate, or the operations at the
  fp32 rate, whichever is longer."""
  t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
  t_ops = 1e3 * flops / FP32_FLOP_PER_S
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_cholesky(linalg):
  """Routes the slice's factor/solve calls to the plain versions, so the
  same run can be repeated without the kernels on the card."""
  saved = linalg.chol_factor, linalg.chol_solve
  linalg.chol_factor, linalg.chol_solve = (linalg.chol_factor_ref,
                                           linalg.chol_solve_ref)
  try:
    yield
  finally:
    linalg.chol_factor, linalg.chol_solve = saved


def check_kernel(name: str, got: torch.Tensor, ref: torch.Tensor,
                 case: str) -> float:
  """Holds a kernel's output to its plain version's: within TOL of
  max|reference|, and then equal to the bit (the kernels do the plain
  versions' operations in the same order, csrc/cholesky.cu).  Returns the
  relative error."""
  e = rel_err(got, ref)
  if e > TOL[ref.dtype]:
    raise AssertionError(f"{name} {case}: rel err {e:.3e}")
  if not torch.equal(got, ref):
    raise AssertionError(f"{name} {case}: within tolerance ({e:.3e}) but "
                         "not bit-equal to the plain version")
  return e


def check_kernels(linalg, dev) -> dict:
  """Phases 3 and 4; returns the max abs error at the slice's shape."""
  rng = np.random.default_rng(0)
  worst = {"chol_factor": 0.0, "chol_solve": 0.0}
  slice_err = {}
  for n in GRID_N:
    for b in GRID_B:
      h64 = spd(rng, b, n, dev)
      rhs64 = torch.as_tensor(rng.standard_normal((b, n, 3)), device=dev)
      for dt in (torch.float32, torch.float64):
        h, rhs = h64.to(dt), rhs64.to(dt)
        l_ref = linalg.chol_factor_ref(h)
        l = linalg.chol_factor(h)
        case = f"n={n} B={b} {dt}"
        worst["chol_factor"] = max(worst["chol_factor"], check_kernel(
            "chol_factor", l, l_ref, case))
        for r in (rhs[..., 0], rhs):
          worst["chol_solve"] = max(worst["chol_solve"], check_kernel(
              "chol_solve", linalg.chol_solve(l_ref, r),
              linalg.chol_solve_ref(l_ref, r), f"{case} rhs{tuple(r.shape)}"))
        if n == 27 and b == FLEET and dt == torch.float32:
          slice_err["chol_factor"] = float((l - l_ref).abs().max())
          slice_err["chol_solve"] = float(
              (linalg.chol_solve(l_ref, rhs[..., 0])
               - linalg.chol_solve_ref(l_ref, rhs[..., 0])).abs().max())

  # asymmetric input: the kernel reads true columns (the lower triangle)
  n, b = 27, 128
  a = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
  h = a @ a.T + 3.0 * torch.eye(n, device=dev, dtype=a.dtype)
  noise = torch.triu(torch.as_tensor(rng.standard_normal((n, n)),
                                     device=dev), 1)
  h_asym = (h + 1e-3 * noise).expand(b, n, n).contiguous()
  h_lower = torch.tril(h_asym) + torch.tril(h_asym, -1).transpose(1, 2)
  check_kernel("chol_factor", linalg.chol_factor(h_asym),
               linalg.chol_factor_ref(h_lower), "asymmetric input")

  # non-SPD input: the last pivot is negative and gets clamped
  for dt in (torch.float32, torch.float64):
    hn = spd(rng, 127, 27, dev).to(dt)
    hn[:, -1, -1] -= 1e3 * hn[:, -1, -1]
    check_kernel("chol_factor", linalg.chol_factor(hn),
                 linalg.chol_factor_ref(hn), f"non-SPD input {dt}")

  # non-contiguous inputs: transposed views of a stack and of a rhs
  h_t = spd(rng, 127, 27, dev).float().transpose(1, 2)
  l_t = linalg.chol_factor_ref(h_t)
  rhs_t = torch.as_tensor(rng.standard_normal((127, 3, 27)),
                          device=dev).float().transpose(1, 2)
  check_kernel("chol_factor", linalg.chol_factor(h_t), l_t,
               "non-contiguous input")
  check_kernel("chol_solve", linalg.chol_solve(l_t, rhs_t),
               linalg.chol_solve_ref(l_t, rhs_t), "non-contiguous input")

  log("kernel: chol_factor",
      f"{len(GRID_N) * len(GRID_B) * 2} cases n={GRID_N} B={GRID_B} "
      f"fp32/fp64 + asymmetric + non-SPD + non-contiguous: all bit-equal "
      f"to the plain version; max rel err {worst['chol_factor']:.3e} (tol "
      f"fp32 1e-4, fp64 1e-12)")
  log("kernel: chol_solve",
      f"{len(GRID_N) * len(GRID_B) * 4} cases, rhs (B,n) and (B,n,3), + "
      f"non-contiguous: all bit-equal to the plain version; max rel err "
      f"{worst['chol_solve']:.3e} (tol fp32 1e-4, fp64 1e-12)")
  return slice_err


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


def time_kernels(linalg, dev) -> dict:
  """Phase 5: kernel (wrapper included), plain version and library call at
  (4096, 27, 27) fp32, timed in turns plain, kernel, library, library,
  kernel, plain; the median of each pair.  The bound counts what each
  function must move once: both read only the lower triangle of their
  (B, n, n) input, n (n + 1) / 2 elements a matrix.  So the factor moves
  B (n (n + 1) / 2 + n^2) elements (the dense factor is written) and does
  B n^3 / 3 operations; the solve moves B (n (n + 1) / 2 + 2 n) elements
  (rhs read, x written) and does 2 B n^2 operations."""
  rng = np.random.default_rng(1)
  h = spd(rng, FLEET, 27, dev).float()
  rhs = torch.as_tensor(rng.standard_normal((FLEET, 27)), device=dev).float()
  l = linalg.chol_factor_ref(h)
  b, n, size = h.shape[0], h.shape[-1], h.element_size()
  tri = b * n * (n + 1) // 2  # lower-triangle elements of a (B, n, n) stack
  out = {}
  for name, kern, plain, library, (nbytes, flops) in (
      ("chol_factor", lambda: linalg.chol_factor(h),
       lambda: linalg.chol_factor_ref(h),
       lambda: torch.linalg.cholesky_ex(h),
       ((tri + h.numel()) * size, b * n**3 / 3)),
      ("chol_solve", lambda: linalg.chol_solve(l, rhs),
       lambda: linalg.chol_solve_ref(l, rhs),
       lambda: torch.cholesky_solve(rhs[..., None], l),
       ((tri + 2 * rhs.numel()) * size, 2 * b * n * n))):
    p1, k1, y1, y2, k2, p2 = (time_ms(f) for f in (
        plain, kern, library, library, kern, plain))
    bound, bound_by = bound_ms(nbytes, flops)
    out[name] = {"ms": float(np.median([k1, k2])),
                 "plain_ms": float(np.median([p1, p2])),
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": float(np.median([y1, y2]))}
  log("timing", "(4096, 27) fp32, ms kernel / plain / library / bound: "
      + ", ".join(
          f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} / {v['library_ms']:.4f}"
          f" / {v['bound_ms']:.4f} ({v['bound_by']}; kernel at "
          f"{v['bound_ms'] / v['ms']:.1%} of it)" for k, v in out.items()))
  return out


def fleet_data(mt, m, batch: int, seed: int, drop: float = 0.0):
  """qpos0 with 0.02 noise on the hinges, the root lowered by ``drop``, and
  0.01 control noise, from a seeded numpy generator."""
  rng = np.random.RandomState(seed)
  dq = 0.02 * rng.randn(batch, m.nq)
  dq[:, :7] = 0.0
  dq[:, 2] -= drop
  d = mt.make_data(m, batch)
  return d.replace(
      qpos=d.qpos + torch.as_tensor(dq, dtype=m.dtype, device=m.device),
      ctrl=torch.as_tensor(0.01 * rng.randn(batch, m.nu), dtype=m.dtype,
                           device=m.device))


def fleet_step(mt, linalg, dev, card: str) -> dict:
  """Phase 6."""
  m = mt.put_model(mt.asset_path("humanoid_mjx.npz"), device=dev,
                   dtype=torch.float32)
  d = mt.step(m, fleet_data(mt, m, FLEET, seed=0))  # warm-up step
  torch.cuda.synchronize()

  linalg.chol_factor.launches = 0
  linalg.chol_solve.launches = 0
  t0 = time.perf_counter()
  for _ in range(FLEET_STEPS):
    d = mt.step(m, d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = {"chol_factor": linalg.chol_factor.launches,
              "chol_solve": linalg.chol_solve.launches}

  for name, count in launches.items():
    if count < 4 * FLEET_STEPS:
      raise AssertionError(f"{name} launched {count} times in the fleet run")
  finite = bool(torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all())
  if not finite:
    raise AssertionError("non-finite lanes after the fleet run")
  resets = int(d.warning.sum())
  log("slice: fleet step",
      f"humanoid_mjx B={FLEET} fp32, {FLEET_STEPS} steps in {seconds:.3f} s "
      f"= {FLEET * FLEET_STEPS / seconds:.1f} steps/s on {card}; launches "
      f"{launches}; all lanes finite; auto-resets {resets}")
  profile_steps(mt, m, d, 1e3 * seconds / FLEET_STEPS)

  # kernels against plain versions, fp64, 64 lanes, 5 steps with contacts.
  # The Newton-100 humanoid: with the MJX budget (1 Newton iteration, 4
  # line-search rounds) a contact step is discontinuous in the last bit of
  # its inputs, so two runs that differ by the order of an atomic add would
  # not agree to 1e-9 (PERF.md, Findings).
  m64 = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                     dtype=torch.float64)
  d_k = d_p = fleet_data(mt, m64, 64, seed=1, drop=0.22)
  for _ in range(5):
    d_k = mt.step(m64, d_k)
  with plain_cholesky(linalg):
    for _ in range(5):
      d_p = mt.step(m64, d_p)
  err = max(float((d_k.qpos - d_p.qpos).abs().max()),
            float((d_k.qvel - d_p.qvel).abs().max()))
  ncon = int((d_k.contact.dist < d_k.contact.includemargin).sum())
  if not err <= 1e-9:
    raise AssertionError(f"fp64 kernel vs plain steps differ by {err:.3e}")
  log("slice: fleet step",
      f"humanoid 64 lanes fp64, 5 steps, kernels vs plain: max |dqpos|,|dqvel| "
      f"{err:.3e} (tol 1e-9); {ncon} active contacts at the end")
  return launches


def profile_steps(mt, m, d, wall_ms: float, steps: int = 3) -> None:
  """Device time by kernel over a few more fleet steps (torch.profiler),
  against the unprofiled wall time of a step."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(steps):
      d = mt.step(m, d)
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
  if not kernels:
    raise AssertionError("the profiler recorded no device time")
  per_step = lambda us: us / steps / 1e3
  device_ms = per_step(sum(e.device_time_total for e in kernels))
  chol = []
  for name in ("chol_factor_kernel", "chol_solve_kernel"):
    us = sum(e.device_time_total for e in kernels if name in e.key)
    count = sum(e.count for e in kernels if name in e.key)
    chol.append(f"{name} {us:.2f} us over {count} launches = "
                f"{us / max(count, 1):.2f} us/launch")
  top = sorted(kernels, key=lambda e: -e.device_time_total)[:5]
  log("profile",
      f"{steps} fleet steps: device {device_ms:.3f} ms/step over "
      f"{sum(e.count for e in kernels) / steps:.0f} launches/step = "
      f"{device_ms / wall_ms:.1%} of the unprofiled {wall_ms:.3f} ms/step; "
      + "; ".join(chol) + "; top: " + "; ".join(
          f"{e.key[:60]} {per_step(e.device_time_total):.3f} ms/step "
          f"({e.count / steps:.0f})" for e in top))


def inverse_dynamics(mt, linalg, dev) -> None:
  """Phase 7: the inverse-dynamics consistency check of the reference's
  inverse_test, on 64 lanes with random applied forces and controls."""
  m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                   dtype=torch.float64)
  b = 64
  rng = np.random.RandomState(2)
  d = fleet_data(mt, m, b, seed=3, drop=0.22)
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=dev)
  d = d.replace(
      qpos=d.qpos + t(np.concatenate(
          [np.zeros((b, 7)), 0.06 * rng.randn(b, m.nq - 7)], axis=1)),
      qvel=t(0.1 * rng.randn(b, m.nv)),
      ctrl=t(0.2 * rng.randn(b, m.nu)),
      qfrc_applied=t(0.3 * rng.randn(b, m.nv)),
      xfrc_applied=t(0.3 * rng.randn(b, m.nbody, 6)))
  linalg.chol_factor.launches = 0
  linalg.chol_solve.launches = 0
  d = mt.compare_fwd_inv(m, mt.forward(m, d))
  launches = {"chol_factor": linalg.chol_factor.launches,
              "chol_solve": linalg.chol_solve.launches}
  if not all(launches.values()):
    raise AssertionError(f"a kernel was not launched: {launches}")
  fwdinv = d.solver_fwdinv
  if not (torch.isfinite(fwdinv).all() and bool((fwdinv <= 1e-6).all())):
    raise AssertionError(f"solver_fwdinv above 1e-6: {fwdinv.amax(0)}")
  ncon = int((d.contact.dist < d.contact.includemargin).sum())
  log("slice: inverse dynamics",
      f"humanoid B=64 fp64: max solver_fwdinv "
      f"[{float(fwdinv[:, 0].max()):.3e}, {float(fwdinv[:, 1].max()):.3e}] "
      f"(tol 1e-6); Newton iterations max {int(d.solver_niter.max())}; "
      f"{ncon} active contacts; launches {launches}")


def main() -> None:
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
  sys.path.insert(0, REPO)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda:0")
  smi = nvidia_smi()
  log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
      f"cuda {torch.version.cuda} | {smi} | TF32 off")

  t0 = time.perf_counter()
  path, nvcc_log = linalg.build_kernels()
  build_s = time.perf_counter() - t0
  regs = [ln.split(":", 1)[1].strip() for ln in nvcc_log.splitlines()
          if "registers" in ln]
  log("build", f"nvcc sm_90a {SOURCE} -> {os.path.relpath(path, REPO)} in "
      f"{build_s:.2f} s; ptxas: {' | '.join(regs)}")

  slice_err = check_kernels(linalg, dev)
  times = time_kernels(linalg, dev)
  launches = fleet_step(mt, linalg, dev, smi)
  inverse_dynamics(mt, linalg, dev)

  print(json.dumps({"kernels": [
      {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
       "launches": launches[k], "max_abs_err": slice_err[k], **times[k]}
      for k in ("chol_factor", "chol_solve")]}))
  print(smi)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()
