"""Probes of the panel-blocked factor kernels above n = 128 on one NVIDIA GPU.

    python3 scripts/block_kernel_probe.py [--other CHECKOUT] [--split]

Builds the kernels and prints what ptxas says of the block kernels
(registers, spills); checks ``chol_factor_large`` and
``chol_factor_jvp_large`` bit-equal to their plain versions at the
hammock's shapes ((256, 324) fp32; (324, 4 lanes, 669 tangents) fp64) and
at a few more n, each at the launch geometry of ``large_launch_geometry``
and at variants of it (threads, panel width, tangents a block); then times
every variant at the hammock's shapes beside ``cholesky_ex`` and the
vmap-of-jvp yardstick, in turns.  With ``--other``, the block kernels of
another checkout (``git archive`` of a commit, unpacked under the
git-ignored ``build/``; built into its own ``build/torch_kernels``) are
timed at the same shapes in turns with this tree's.  With ``--split``,
where the time goes: this tree's source is built again without the
trailing updates, without the panels' pivot passes, and without both
(wrong results, timed only), and the four libraries are timed in turns at
the hammock's shapes.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from mujoco_inversedynamicstest_tpu_torch.ops import linalg  # noqa: E402

# (threads, panel, group) variants; None: the launch geometry's
FACTOR_VARIANTS = (None, (128, 32, 1), (256, 16, 1))
JVP_VARIANTS = (None, (256, 32, 1), (256, 16, 2), (256, 8, 1), (128, 16, 1))


# --split: text substitutions that take a part out of the kernels
SPLITS = {
    "no trailing update": (
        ("    trailing(src, n, 1, a, n, 1, n, j0, warp, warps,",
         "    if (false) trailing(src, n, 1, a, n, 1, n, j0, warp, warps,"),
        ("    if (g < gn) {\n      const T* dp",
         "    if (false) {\n      const T* dp")),
    "no pivot passes": (
        ("for (int k = k0 - 1; k + 1 < j0; ++k) {",
         "for (int k = k0 - 1; k + 1 < j0 && n < 0; ++k) {"),),
}
SPLITS["neither"] = SPLITS["no trailing update"] + SPLITS["no pivot passes"]
# and variants that keep the results: the k loop of the trailing update
# unrolled, so that the next k's panel reads are issued early
SPLITS["k unrolled 2"] = tuple(
    (f"for (int kk = 0; kk < w; ++kk) {{\n{' ' * pad}const T* {p}",
     f"_Pragma(\"unroll 2\") for (int kk = 0; kk < w; ++kk) {{\n"
     f"{' ' * pad}const T* {p}") for p, pad in (("pk", 17), ("lk", 19)))
SPLITS["k unrolled 4"] = tuple((a, b.replace("unroll 2", "unroll 4"))
                               for a, b in SPLITS["k unrolled 2"])


def split_entries(name: str, subs) -> dict:
  """The block factor kernels built from this tree's source with ``subs``
  applied: their C entry points by (kernel, dtype)."""
  src = open(linalg._SRC).read()
  for old, new in subs:
    if old not in src:
      raise AssertionError(f"{name}: {old!r} is not in the source")
    src = src.replace(old, new)
  out = os.path.join(REPO, "build", "block_kernel_probe")
  os.makedirs(out, exist_ok=True)
  tag = name.replace(" ", "_")
  cu, lib = os.path.join(out, f"{tag}.cu"), os.path.join(out, f"{tag}.so")
  with open(cu, "w") as f:
    f.write(src)
  proc = subprocess.run([linalg._nvcc(), *linalg.NVCC_FLAGS, "-o", lib, cu],
                        check=True, capture_output=True, text=True)
  for ln in ptxas_lines(proc.stdout + proc.stderr):
    if "registers" in ln or "spill" in ln:
      print(f"ptxas {name}: {ln}", flush=True)
  dll = ctypes.CDLL(lib)
  p, i = ctypes.c_void_p, ctypes.c_int
  s = ctypes.POINTER(ctypes.c_longlong)
  fns = {}
  for kernel, args in (("chol_factor_large", [p, p, i, i, i, i, i, p]),
                       ("chol_factor_jvp_large",
                        [p, p, p, s, i, i, i, i, i, i, i, p])):
    for dt in (torch.float32, torch.float64):
      fn = getattr(dll, f"mi_{kernel}_{linalg._suffix(dt)}")
      fn.argtypes, fn.restype = args, i
      fns[kernel, dt] = fn
  return fns


def factor(h: torch.Tensor, variant=None, fn=None) -> torch.Tensor:
  """The block factor at the launch geometry or at ``variant`` (threads,
  panel, group), through the C entry ``fn`` where given."""
  if variant is None and fn is None:
    return linalg.chol_factor_large(h)
  n = h.shape[-1]
  if variant is None:
    g = linalg.large_launch_geometry("chol_factor", n, h.dtype, h.shape[0])
    variant = (g.threads, g.panel, g.group)
  threads, panel, _ = variant
  smem = linalg._panel_smem("chol_factor", n, h.element_size(), panel, 1)
  l = torch.empty_like(h)
  err = (fn or linalg._entry("chol_factor_large", h.dtype))(
      h.data_ptr(), l.data_ptr(), n, h.shape[0], threads, panel, smem,
      linalg._stream(h))
  linalg._check_launch(err, "chol_factor_large")
  return l


def factor_jvp(l: torch.Tensor, dh: torch.Tensor, variant=None, fn=None
               ) -> torch.Tensor:
  """The block factor JVP (dh (T, B, n, n)) at the launch geometry or at
  ``variant``, through ``fn`` where given."""
  if variant is None and fn is None:
    return linalg.chol_factor_jvp_large(l, dh)
  n, lanes, nt = l.shape[-1], l.shape[0], dh.shape[0]
  if variant is None:
    g = linalg.large_launch_geometry("chol_factor_jvp", n, l.dtype, lanes, nt)
    variant = (g.threads, g.panel, g.group)
  threads, panel, group = variant
  smem = linalg._panel_smem("chol_factor_jvp", n, l.element_size(), panel,
                            group)
  dl = torch.empty(dh.shape, dtype=l.dtype, device=l.device)
  err = (fn or linalg._entry("chol_factor_jvp_large", l.dtype))(
      l.data_ptr(), dh.data_ptr(), dl.data_ptr(), linalg._strides(l, dh, dl),
      n, lanes, nt, threads, panel, group, smem, linalg._stream(l))
  linalg._check_launch(err, "chol_factor_jvp_large")
  return dl


def fits(kernel: str, n: int, dtype: torch.dtype, variant) -> bool:
  return variant is None or linalg._panel_smem(
      kernel, n, dtype.itemsize, variant[1], variant[2]) <= linalg.SMEM_MAX


def name(variant) -> str:
  return "geometry" if variant is None else "threads {} nb {} G {}".format(
      *variant)


def other_linalg(checkout: str):
  """The ops/linalg.py of another checkout, loaded on its own (it builds
  its kernels into its own build/torch_kernels)."""
  path = os.path.join(checkout, "mujoco_inversedynamicstest_tpu_torch", "ops",
                      "linalg.py")
  spec = importlib.util.spec_from_file_location("other_linalg", path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def ptxas_lines(log: str) -> list[str]:
  """ptxas's lines for the block factor kernels."""
  out, keep = [], False
  for ln in log.splitlines():
    if "Compiling entry function" in ln or "Function properties" in ln:
      keep = "factor_large" in ln or "factor_jvp_large" in ln
    if keep and ("registers" in ln or "spill" in ln or "entry" in ln):
      out.append(ln.strip())
  return out


def main() -> None:
  parser = argparse.ArgumentParser()
  parser.add_argument("--other", help="another checkout to time in turns")
  parser.add_argument("--split", action="store_true",
                      help="time the kernels without each of their parts")
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("block_kernel_probe: no card")
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device("cuda:0")
  print("env", cs.nvidia_smi(), torch.__version__, torch.version.cuda,
        flush=True)
  path, log = linalg.build_kernels()
  os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
  with open(os.path.join(REPO, "chiprun_out", "ptxas.txt"), "w") as f:
    f.write(log)
  for ln in ptxas_lines(log):
    print("ptxas", ln, flush=True)
  other = other_linalg(args.other) if args.other else None
  if other is not None:
    other.build_kernels()
  if args.split:
    split(dev)
    return

  rng = np.random.default_rng(20)
  # bit-equality: every variant at a few n, then the hammock's shapes
  for n in (129, 200, 257, 400):
    for dt in (torch.float32, torch.float64):
      h = cs.spd(rng, 3, n, dev).to(dt)
      l = linalg.chol_factor_ref(h)
      for v in FACTOR_VARIANTS:
        if fits("chol_factor", n, dt, v):
          assert torch.equal(factor(h, v), l), ("factor", n, dt, name(v))
      dh = cs.sym(rng, (5, 3, n, n), dev).to(dt)
      dl = linalg.chol_factor_jvp_ref(l, dh)
      for v in JVP_VARIANTS:
        if fits("chol_factor_jvp", n, dt, v):
          assert torch.equal(factor_jvp(l, dh, v), dl), ("jvp", n, dt,
                                                         name(v))
    print(f"n={n}: every variant bit-equal, fp32 and fp64", flush=True)

  n, b = cs.HAMMOCK_NV, cs.HAMMOCK_FLEET
  h = cs.spd(rng, b, n, dev).float()
  l = linalg.chol_factor_ref(h)
  for v in FACTOR_VARIANTS:
    assert torch.equal(factor(h, v), l), ("factor", name(v))
  tri = b * n * (n + 1) // 2
  bound, by = cs.bound_ms((tri + h.numel()) * 4, b * n**3 / 3)
  fns = {name(v): (lambda v=v: factor(h, v)) for v in FACTOR_VARIANTS}
  fns["cholesky_ex"] = lambda: torch.linalg.cholesky_ex(h)
  if other is not None:
    fns["other checkout"] = lambda: other.chol_factor_large(h)
  times = {k: [] for k in fns}
  for order in (list(fns), list(fns)[::-1]):
    for k in order:
      times[k].append(cs.time_ms(fns[k], reps=10))
  print(f"factor ({b}, {n}) fp32, bound {bound:.4f} ms ({by}): " + "; ".join(
      f"{k} {np.median(t):.4f} ms" for k, t in times.items()), flush=True)

  lanes, t = cs.HAMMOCK_AD_LANES, cs.HAMMOCK_TANGENTS
  h = cs.spd(rng, lanes, n, dev)
  l = linalg.chol_factor_ref(h)
  dh = cs.sym(rng, (t, lanes, n, n), dev)
  dl = linalg.chol_factor_jvp_ref(l, dh)
  for v in JVP_VARIANTS:
    assert torch.equal(factor_jvp(l, dh, v), dl), ("jvp", name(v))
  del dl
  bound, by = cs.bound_ms(*cs.jvp_work(n, lanes, t, 8)["chol_factor_jvp"],
                          fp64=True)
  fns = {name(v): (lambda v=v: factor_jvp(l, dh, v)) for v in JVP_VARIANTS}
  fns["yardstick"] = lambda: torch.func.vmap(
      lambda u: torch.func.jvp(torch.linalg.cholesky, (h,), (u,))[1])(dh)
  if other is not None:
    fns["other checkout"] = lambda: other.chol_factor_jvp_large(l, dh)
  times = {k: [] for k in fns}
  for order in (list(fns), list(fns)[::-1]):
    for k in order:
      times[k].append(cs.time_ms(fns[k], reps=2))
  print(f"factor JVP ({n}, {lanes} lanes, {t} tangents) fp64, bound "
        f"{bound:.4f} ms ({by}): " + "; ".join(
            f"{k} {np.median(v):.4f} ms" for k, v in times.items()),
        flush=True)


def split(dev) -> None:
  """Each kernel with and without its parts, at the hammock's shapes, in
  turns (this tree's launch geometry, and the JVP at nb 32)."""
  libs = {"tree": None}
  libs.update({k: split_entries(k, subs) for k, subs in SPLITS.items()})
  rng = np.random.default_rng(21)
  n, b = cs.HAMMOCK_NV, cs.HAMMOCK_FLEET
  h = cs.spd(rng, b, n, dev).float()
  lanes, t = cs.HAMMOCK_AD_LANES, cs.HAMMOCK_TANGENTS
  l = linalg.chol_factor_ref(cs.spd(rng, lanes, n, dev))
  dh = cs.sym(rng, (t, lanes, n, n), dev)
  cases = {}
  for k, fns in libs.items():
    get = (lambda kernel, dt, fns=fns: None if fns is None else
           fns[kernel, dt])
    cases[f"factor {k}"] = (lambda get=get: factor(
        h, fn=get("chol_factor_large", torch.float32)), 10)
    for v in (None, (256, 32, 1)):
      cases[f"JVP {name(v)} {k}"] = (lambda get=get, v=v: factor_jvp(
          l, dh, v, fn=get("chol_factor_jvp_large", torch.float64)), 2)
  times = {k: [] for k in cases}
  for order in (list(cases), list(cases)[::-1]):
    for k in order:
      fn, reps = cases[k]
      times[k].append(cs.time_ms(fn, reps=reps))
  print(f"split at ({b}, {n}) fp32 and ({n}, {lanes} lanes, {t} tangents) "
        "fp64: " + "; ".join(f"{k} {np.median(v):.4f} ms"
                             for k, v in times.items()), flush=True)


if __name__ == "__main__":
  main()
