"""Batched small-matrix Cholesky factor and solve.

Port of the two Pallas TPU kernels of ``mujoco_inversedynamicstest_tpu/
ops/linalg.py`` (``_chol_kernel`` and ``_solve_kernel``) to hand-written CUDA
kernels for Hopper, ``csrc/cholesky.cu``.  Each kernel has a plain PyTorch
version beside it (``chol_factor_ref`` / ``chol_solve_ref``) that computes
the same function with the same pivot clamp and the same lower-triangle
reads.

Dispatch is by the device of the tensor and nothing else: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (or raises), and any
other device raises.  ``chol_factor.launches`` / ``chol_solve.launches``
count kernel launches.

The kernels are built with ``nvcc`` from the sources in the checkout, at
first use, into ``build/torch_kernels/`` and bound through ``ctypes``.  They
read and write PyTorch's own (B, n, n) layout, one warp per matrix; the
launch shape comes from ``launch_geometry``.
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
  fn.argtypes = ([p, p, i, i, i, i, i, p] if name == "chol_factor" else
                 [p, p, p, i, i, i, i, i, i, p])
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


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def chol_factor(h: torch.Tensor) -> torch.Tensor:
  """(B, n, n) -> lower Cholesky factor (upper triangle zero).

  CPU tensors take ``chol_factor_ref``; CUDA tensors launch the kernel,
  which reads ``h`` in place (a copy only if it is not contiguous).
  """
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


chol_factor.launches = 0


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves L Lᵀ x = b; ``l`` (B, n, n) lower factor, ``b`` (B, n[, k]).

  CPU tensors take ``chol_solve_ref``; CUDA tensors launch the kernel,
  which reads ``l`` and ``b`` in place and writes x in ``b``'s shape.
  """
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


chol_solve.launches = 0
