"""Batched small-matrix Cholesky factor and solve, with forward-mode AD.

Port of the two Pallas TPU kernels of ``mujoco_inversedynamicstest_tpu/
ops/linalg.py`` (``_chol_kernel`` and ``_solve_kernel``) to hand-written CUDA
kernels for Hopper, ``csrc/cholesky.cu``, and of the JVPs that
``pallas_call``'s JVP rule derives from them (``chol_factor_jvp``,
``chol_solve_jvp``: two more kernels in the same file).  Each kernel has a
plain PyTorch version beside it (``chol_factor_ref``, ``chol_solve_ref``,
``chol_factor_jvp_ref``, ``chol_solve_jvp_ref``) that computes the same
function with the same pivot clamp, the same lower-triangle reads and the
same order of operations.

``chol_factor`` and ``chol_solve`` are ``torch.autograd.Function``s with a
forward-mode rule: a dual input (``torch.autograd.forward_ad``) gives a dual
output whose tangent comes from the JVP wrapper.  A tangent that is absent
counts as zero.  Reverse mode is not defined.

Dispatch is by the device of the tensor and nothing else: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (or raises), and any
other device raises.  ``chol_factor.launches``, ``chol_solve.launches``,
``chol_factor_jvp.launches`` and ``chol_solve_jvp.launches`` count kernel
launches.

The kernels are built with ``nvcc`` from the sources in the checkout, at
first use, into ``build/torch_kernels/`` and bound through ``ctypes``.  They
read and write PyTorch's own (B, n, n) layout, one warp per matrix; the
launch shape comes from ``launch_geometry`` (and ``jvp_launch_geometry``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

# mjMINVAL: the pivot clamp of C MuJoCo's mju_cholFactor
MINVAL = 1e-15
N_MAX = 128
# shared memory one block may use on Hopper, and the matrices (one warp
# each) a block takes at most
SMEM_MAX = 232_448
MATS_PER_BLOCK = 4

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "cholesky.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -fmad=false: the kernels round every product and difference separately,
# as the plain versions do (see csrc/cholesky.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def chol_factor_ref(h: torch.Tensor) -> torch.Tensor:
  """(B, n, n) -> lower Cholesky factor, right-looking over pivots.

  Reads only the lower triangle of ``h``; pivots are clamped as
  ``sqrt(max(p, 1e-15))``; the strict upper triangle of the result is zero.
  """
  n = h.shape[-1]
  a = torch.tril(h)
  for k in range(n):
    d = torch.sqrt(torch.clamp(a[:, k, k], min=MINVAL))
    a[:, k, k] = d
    col = a[:, k + 1:, k] * (1.0 / d)[:, None]
    a[:, k + 1:, k] = col
    a[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
  return torch.tril(a)


def chol_solve_ref(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves L Lᵀ x = b for a (B, n, n) lower factor; b is (B, n) or (B, n, k).

  Forward substitution L y = b, then Lᵀ x = y column by column; reads only
  the lower triangle of ``l``.
  """
  n = l.shape[-1]
  x = b.reshape(b.shape[0], n, -1).clone()
  for c in range(n):
    x[:, c] = x[:, c] / l[:, c, c, None]
    x[:, c + 1:] -= l[:, c + 1:, c, None] * x[:, c, None]
  for c in range(n - 1, -1, -1):
    x[:, c] = x[:, c] / l[:, c, c, None]
    x[:, :c] -= l[:, c, :c, None] * x[:, c, None]
  return x.reshape(b.shape)


def chol_factor_jvp_ref(l: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
  """Tangent dL of ``chol_factor`` at h, from L = chol_factor(h) and dh.

  The forward mode of ``chol_factor_ref``'s right-looking recurrence,
  written with the finished factor L, so that only the running tangent of
  the trailing block is carried.  At pivot k, with d = L[k][k] and p' the
  running tangent of the pivot:

      dL[k][k] = 0.5 p' / d, and 0 where the pivot was clamped
      dL[r][k] = (a'[r][k] - L[r][k] dL[k][k]) / d                 r > k
      a'[r][j] -= dL[r][k] L[j][k] + L[r][k] dL[j][k]        k < j <= r

  The clamp ``sqrt(max(p, 1e-15))`` passes no tangent: a pivot counts as
  clamped where d <= sqrt(1e-15) in the working type, which is p <= 1e-15
  and, at the tie, also a p within one rounding above it (the derivative
  of ``max`` taken as 0 there).  Reads only the lower triangles of ``l``
  and ``dh``; the strict upper triangle of the result is zero.
  """
  n = l.shape[-1]
  dmin = torch.sqrt(torch.tensor(MINVAL, dtype=l.dtype, device=l.device))
  t = torch.tril(dh)
  for k in range(n):
    d = l[:, k, k]
    dd = torch.where(d <= dmin, 0.0, 0.5 * t[:, k, k] / d)
    t[:, k, k] = dd
    col = l[:, k + 1:, k]
    dcol = (t[:, k + 1:, k] - col * dd[:, None]) / d[:, None]
    t[:, k + 1:, k] = dcol
    t[:, k + 1:, k + 1:] -= (dcol[:, :, None] * col[:, None, :]
                             + col[:, :, None] * dcol[:, None, :])
  return torch.tril(t)


def chol_solve_jvp_ref(l: torch.Tensor, dl: torch.Tensor, x: torch.Tensor,
                       db: torch.Tensor) -> torch.Tensor:
  """Tangent dx of ``chol_solve`` at (L, b), from x = chol_solve(L, b).

  dx = L⁻ᵀ (L⁻¹ (db − dL (Lᵀ x)) − dLᵀ x), in five sweeps over the columns:
  y = Lᵀ x and t = dLᵀ x (sums in ascending column order), u = db − dL y,
  v = L⁻¹ u, w = v − t, dx = L⁻ᵀ w (the substitutions of
  ``chol_solve_ref``).  Reads only the lower triangles of ``l`` and
  ``dl``; ``x`` and ``db`` are (B, n) or (B, n, k), and dx takes their
  shape.
  """
  n = l.shape[-1]
  xs = x.reshape(x.shape[0], n, -1)
  y = torch.zeros_like(xs)
  t = torch.zeros_like(xs)
  for c in range(n):
    y[:, :c + 1] += l[:, c, :c + 1, None] * xs[:, c, None]
    t[:, :c + 1] += dl[:, c, :c + 1, None] * xs[:, c, None]
  u = db.reshape(xs.shape).clone()
  for c in range(n):
    u[:, c:] -= dl[:, c:, c, None] * y[:, c, None]
  for c in range(n):
    u[:, c] = u[:, c] / l[:, c, c, None]
    u[:, c + 1:] -= l[:, c + 1:, c, None] * u[:, c, None]
  u = u - t
  for c in range(n - 1, -1, -1):
    u[:, c] = u[:, c] / l[:, c, c, None]
    u[:, :c] -= l[:, c, :c, None] * u[:, c, None]
  return u.reshape(x.shape)


# ---------------------------------------------------------------------------
# CUDA build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
  path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  if not os.path.exists(path):
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
  return path


def build_kernels() -> tuple[Path, str]:
  """Compiles ``csrc/cholesky.cu`` unless a library built from the same
  source text already exists.  Returns (library path, nvcc's output)."""
  src = _SRC.read_bytes()
  tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
  lib = BUILD_DIR / f"libmi_cholesky_{tag}.so"
  if lib.exists():
    return lib, ""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  try:
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
  """The C entry point ``mi_{name}_{f32|f64}``, built and bound at first
  use."""
  sfx = _suffix(dtype)
  fn = getattr(_library(), f"mi_{name}_{sfx}")
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = {
      "chol_factor": [p, p, i, i, i, i, i, p],
      "chol_solve": [p, p, p, i, i, i, i, i, i, p],
      "chol_factor_jvp": [p, p, p, i, i, i, i, p],
      "chol_solve_jvp": [p, p, p, p, p, i, i, i, i, i, p],
  }[name]
  fn.restype = i
  return fn


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
  return ctypes.CDLL(str(build_kernels()[0]))


@functools.lru_cache(maxsize=None)
def launch_geometry(n: int, dtype: torch.dtype) -> tuple[int, int, int]:
  """Launch shape of both kernels for n x n matrices of ``dtype``.

  Returns (row stride of a matrix's shared-memory tile, matrices per block,
  dynamic shared memory bytes per block).  One warp works on one matrix.
  The stride is odd so that 32 lanes on 32 rows of one column hit 32
  banks; a block takes up to ``MATS_PER_BLOCK`` tiles within ``SMEM_MAX``.
  """
  ld = n | 1
  tile = n * ld * dtype.itemsize
  per_block = max(1, min(MATS_PER_BLOCK, SMEM_MAX // tile))
  return ld, per_block, per_block * tile


@functools.lru_cache(maxsize=None)
def jvp_launch_geometry(n: int, dtype: torch.dtype) -> tuple[int, int]:
  """Launch shape of both JVP kernels: (matrices per block, dynamic shared
  memory bytes per block).

  A JVP kernel keeps two tiles a matrix (the factor and a tangent), each
  the packed lower triangle, n (n + 1) / 2 elements: row r starts at
  r (r + 1) / 2, and the triangular numbers of 32 consecutive rows fall in
  32 different banks.  Packed, the two tiles of n = 128 in fp64 (132 kB)
  fit in one block where two square tiles would not.
  """
  tile = 2 * (n * (n + 1) // 2) * dtype.itemsize
  per_block = max(1, min(MATS_PER_BLOCK, SMEM_MAX // tile))
  return per_block, per_block * tile


def _suffix(dtype: torch.dtype) -> str:
  if dtype == torch.float32:
    return "f32"
  if dtype == torch.float64:
    return "f64"
  raise TypeError(f"Cholesky kernels take float32 or float64, not {dtype}")


def _stream(t: torch.Tensor) -> int:
  """PyTorch's current stream on ``t``'s device, as a raw handle."""
  return torch.cuda.current_stream(t.device.index).cuda_stream


def _check_launch(err: int, name: str) -> None:
  if err != 0:
    raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _device_kind(t: torch.Tensor) -> str:
  if t.device.type not in ("cpu", "cuda"):
    raise RuntimeError(f"no Cholesky implementation for device {t.device}")
  return t.device.type


def _check_factor_shape(h: torch.Tensor) -> int:
  if h.ndim != 3 or h.shape[1] != h.shape[2]:
    raise ValueError(f"expected (B, n, n), got {tuple(h.shape)}")
  n = h.shape[-1]
  if not 1 <= n <= N_MAX:
    raise ValueError(f"kernel takes 1 <= n <= {N_MAX}, got n={n}")
  return n


def _check_solve_shapes(l: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
  """Returns (n, number of right-hand-side columns)."""
  n = _check_factor_shape(l)
  if b.device != l.device or b.dtype != l.dtype:
    raise ValueError("factor and right-hand side differ in device or dtype")
  if b.ndim not in (2, 3) or b.shape[:2] != l.shape[:2]:
    raise ValueError(f"rhs {tuple(b.shape)} does not match {tuple(l.shape)}")
  return n, b.shape[2] if b.ndim == 3 else 1


def _check_same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
  if a.shape != b.shape or a.device != b.device or a.dtype != b.dtype:
    raise ValueError(f"{what}: {tuple(b.shape)} {b.dtype} on {b.device} "
                     f"does not match {tuple(a.shape)} {a.dtype} on "
                     f"{a.device}")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _factor(h: torch.Tensor) -> torch.Tensor:
  """The primal factor: ``chol_factor_ref`` on the CPU, the kernel on the
  card, which reads ``h`` in place (a copy only if it is not
  contiguous)."""
  if _device_kind(h) == "cpu":
    return chol_factor_ref(h)
  n = _check_factor_shape(h)
  fn = _entry("chol_factor", h.dtype)
  h = h.contiguous()
  l = torch.empty_like(h)  # contiguous, like h
  bsz = h.shape[0]
  if bsz == 0:
    return l
  ld, per_block, smem = launch_geometry(n, h.dtype)
  with torch.cuda.device(h.device):
    _check_launch(fn(h.data_ptr(), l.data_ptr(), n, ld, bsz, per_block, smem,
                     _stream(h)), "chol_factor")
  chol_factor.launches += 1
  return l


def _solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The primal solve: ``chol_solve_ref`` on the CPU, the kernel on the
  card, which reads ``l`` and ``b`` in place and writes x in ``b``'s
  shape."""
  if _device_kind(l) == "cpu" and b.device.type == "cpu":
    return chol_solve_ref(l, b)
  n, k = _check_solve_shapes(l, b)
  fn = _entry("chol_solve", l.dtype)
  l, b = l.contiguous(), b.contiguous()
  x = torch.empty_like(b)  # contiguous, like b
  bsz = l.shape[0]
  if bsz == 0 or k == 0:
    return x
  ld, per_block, smem = launch_geometry(n, l.dtype)
  with torch.cuda.device(l.device):
    _check_launch(fn(l.data_ptr(), b.data_ptr(), x.data_ptr(), n, ld, bsz, k,
                     per_block, smem, _stream(l)), "chol_solve")
  chol_solve.launches += 1
  return x


def chol_factor_jvp(l: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
  """Tangent of the factor (see ``chol_factor_jvp_ref``): CPU tensors take
  the plain version, CUDA tensors launch the kernel."""
  if _device_kind(l) == "cpu" and dh.device.type == "cpu":
    return chol_factor_jvp_ref(l, dh)
  n = _check_factor_shape(l)
  _check_same(l, dh, "tangent of the matrix")
  fn = _entry("chol_factor_jvp", l.dtype)
  l, dh = l.contiguous(), dh.contiguous()
  dl = torch.empty_like(l)
  bsz = l.shape[0]
  if bsz == 0:
    return dl
  per_block, smem = jvp_launch_geometry(n, l.dtype)
  with torch.cuda.device(l.device):
    _check_launch(fn(l.data_ptr(), dh.data_ptr(), dl.data_ptr(), n, bsz,
                     per_block, smem, _stream(l)), "chol_factor_jvp")
  chol_factor_jvp.launches += 1
  return dl


chol_factor_jvp.launches = 0


def chol_solve_jvp(l: torch.Tensor, dl: torch.Tensor, x: torch.Tensor,
                   db: torch.Tensor) -> torch.Tensor:
  """Tangent of the solve (see ``chol_solve_jvp_ref``): CPU tensors take
  the plain version, CUDA tensors launch the kernel."""
  if all(t.device.type == "cpu" for t in (l, dl, x, db)):
    return chol_solve_jvp_ref(l, dl, x, db)
  _device_kind(l)
  n, k = _check_solve_shapes(l, x)
  _check_same(l, dl, "tangent of the factor")
  _check_same(x, db, "tangent of the right-hand side")
  fn = _entry("chol_solve_jvp", l.dtype)
  l, dl, x, db = (t.contiguous() for t in (l, dl, x, db))
  dx = torch.empty_like(x)
  bsz = l.shape[0]
  if bsz == 0 or k == 0:
    return dx
  per_block, smem = jvp_launch_geometry(n, l.dtype)
  with torch.cuda.device(l.device):
    _check_launch(fn(l.data_ptr(), dl.data_ptr(), x.data_ptr(), db.data_ptr(),
                     dx.data_ptr(), n, bsz, k, per_block, smem, _stream(l)),
                  "chol_solve_jvp")
  chol_solve_jvp.launches += 1
  return dx


chol_solve_jvp.launches = 0


# ---------------------------------------------------------------------------
# public functions, with their forward-mode rules
# ---------------------------------------------------------------------------


class _CholFactor(torch.autograd.Function):

  @staticmethod
  def forward(h):
    return _factor(h)

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_forward(output)

  @staticmethod
  def jvp(ctx, dh):
    (l,) = ctx.saved_tensors
    return chol_factor_jvp(l, dh)


class _CholSolve(torch.autograd.Function):

  @staticmethod
  def forward(l, b):
    return _solve(l, b)

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_forward(inputs[0], output)

  @staticmethod
  def jvp(ctx, dl, db):
    l, x = ctx.saved_tensors
    return chol_solve_jvp(l, torch.zeros_like(l) if dl is None else dl, x,
                          torch.zeros_like(x) if db is None else db)


def chol_factor(h: torch.Tensor) -> torch.Tensor:
  """(B, n, n) -> lower Cholesky factor (upper triangle zero).

  CPU tensors take ``chol_factor_ref``; CUDA tensors launch the kernel.  A
  dual ``h`` gives a dual factor, its tangent from ``chol_factor_jvp``.
  """
  return _CholFactor.apply(h)


chol_factor.launches = 0


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves L Lᵀ x = b; ``l`` (B, n, n) lower factor, ``b`` (B, n[, k]).

  CPU tensors take ``chol_solve_ref``; CUDA tensors launch the kernel.  A
  dual ``l`` or ``b`` gives a dual x, its tangent from ``chol_solve_jvp``.
  """
  return _CholSolve.apply(l, b)


chol_solve.launches = 0
