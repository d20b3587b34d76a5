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
first use, into ``build/torch_kernels/`` and bound through ``ctypes``.
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
def _library() -> ctypes.CDLL:
  lib = ctypes.CDLL(str(build_kernels()[0]))
  p, i = ctypes.c_void_p, ctypes.c_int
  for dt in ("f32", "f64"):
    fn = getattr(lib, f"mi_chol_factor_{dt}")
    fn.argtypes = [p, p, i, i, p]
    fn.restype = i
    fn = getattr(lib, f"mi_chol_solve_{dt}")
    fn.argtypes = [p, p, p, i, i, i, p]
    fn.restype = i
  return lib


def _suffix(dtype: torch.dtype) -> str:
  if dtype == torch.float32:
    return "f32"
  if dtype == torch.float64:
    return "f64"
  raise TypeError(f"Cholesky kernels take float32 or float64, not {dtype}")


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


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def chol_factor(h: torch.Tensor) -> torch.Tensor:
  """(B, n, n) -> lower Cholesky factor (upper triangle zero).

  CPU tensors take ``chol_factor_ref``; CUDA tensors launch the kernel.
  """
  if _device_kind(h) == "cpu":
    return chol_factor_ref(h)
  n = _check_factor_shape(h)
  sfx = _suffix(h.dtype)
  bsz = h.shape[0]
  if bsz == 0:
    return torch.empty_like(h)
  # true column-major relayout, batch contiguous: (col * n + row, b)
  h_cm = h.transpose(1, 2).reshape(bsz, n * n).T.contiguous()
  l_cm = torch.empty_like(h_cm)
  with torch.cuda.device(h.device):
    stream = torch.cuda.current_stream(h.device).cuda_stream
    fn = getattr(_library(), f"mi_chol_factor_{sfx}")
    _check_launch(fn(h_cm.data_ptr(), l_cm.data_ptr(), n, bsz, stream),
                  "chol_factor")
  chol_factor.launches += 1
  return l_cm.T.reshape(bsz, n, n).transpose(1, 2).contiguous()


chol_factor.launches = 0


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves L Lᵀ x = b; ``l`` (B, n, n) lower factor, ``b`` (B, n[, k]).

  CPU tensors take ``chol_solve_ref``; CUDA tensors launch the kernel.
  """
  if _device_kind(l) == "cpu" and b.device.type == "cpu":
    return chol_solve_ref(l, b)
  n = _check_factor_shape(l)
  if b.device != l.device or b.dtype != l.dtype:
    raise ValueError("factor and right-hand side differ in device or dtype")
  if b.ndim not in (2, 3) or b.shape[:2] != l.shape[:2]:
    raise ValueError(f"rhs {tuple(b.shape)} does not match {tuple(l.shape)}")
  sfx = _suffix(l.dtype)
  bsz = l.shape[0]
  k = b.shape[2] if b.ndim == 3 else 1
  if bsz == 0 or k == 0:
    return torch.empty_like(b)
  l_cm = l.transpose(1, 2).reshape(bsz, n * n).T.contiguous()
  # rhs as (row, b * k + column)
  rhs = b.reshape(bsz, n, k).permute(1, 0, 2).reshape(n, bsz * k).contiguous()
  x = torch.empty_like(rhs)
  with torch.cuda.device(l.device):
    stream = torch.cuda.current_stream(l.device).cuda_stream
    fn = getattr(_library(), f"mi_chol_solve_{sfx}")
    _check_launch(
        fn(l_cm.data_ptr(), rhs.data_ptr(), x.data_ptr(), n, bsz, k, stream),
        "chol_solve")
  chol_solve.launches += 1
  return x.reshape(n, bsz, k).permute(1, 0, 2).reshape(b.shape).contiguous()


chol_solve.launches = 0
