"""Batched Cholesky factor and solve, with forward-mode AD.

Port of the two Pallas TPU kernels of the JAX package's
``ops/linalg.py`` (``_chol_kernel`` and ``_solve_kernel``) to hand-written CUDA
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
launches, and each one's ``shapes`` counts them by shape.

The kernels are built with ``nvcc`` from the sources in the checkout, at
first use, into ``build/torch_kernels/`` and bound through ``ctypes``.  They
read and write PyTorch's own (B, n, n) layout.  Up to n = ``N_MAX`` each
matrix is one warp's, in a shared-memory tile; the launch shape comes from
``launch_geometry`` (and ``jvp_launch_geometry``).  Above it four more
kernels of the same file take the same functions, one block of several
warps a matrix (a solve column, a tangent), in place in device memory:
``chol_factor_large``, ``chol_solve_large``, ``chol_factor_jvp_large`` and
``chol_solve_jvp_large``, whose launch shape comes from
``large_launch_geometry``.  They replace no Pallas kernel: above n = 128
the JAX package calls ``jnp.linalg.cholesky`` and ``cho_solve``.  Dispatch
is by device and n alone; each of the four counts its own launches and
shapes.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

# mjMINVAL: the pivot clamp of C MuJoCo's mju_cholFactor
MINVAL = 1e-15
# the largest n of the warp-per-matrix kernels; above it, the block kernels
N_MAX = 128
# shared memory one block may use on Hopper, and the matrices (one warp
# each) a block takes at most
SMEM_MAX = 232_448
MATS_PER_BLOCK = 4
# the most warps a JVP block runs, each on its own (lane, tangent) items
JVP_WARPS = 8
# warps a block of the n > N_MAX kernels, one item (matrix, column,
# tangent) a block
LARGE_WARPS = 8

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


def _like_both(a: torch.Tensor, b: torch.Tensor, keep: bool) -> torch.Tensor:
  """A new buffer of the broadcast shape of ``a[..., :1]`` and ``b``,
  batched (under ``vmap``) wherever either is, holding ``b``'s bits
  (``keep``) or zeros, so that in-place updates by values derived from
  both land in a buffer that can hold them."""
  return torch.where(torch.full_like(a[..., :1], keep, dtype=torch.bool), b,
                     0.0)


def chol_factor_jvp_ref(l: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
  """Tangent dL of ``chol_factor`` at h, from L = chol_factor(h) and dh.

  ``l`` is (B, n, n); ``dh`` is (B, n, n), or (T, B, n, n) for T tangents
  a lane, in any strides; dL takes dh's shape.  The forward mode of
  ``chol_factor_ref``'s right-looking recurrence, written with the
  finished factor L, so that only the running tangent of the trailing
  block is carried.  At pivot k, with d = L[k][k] and p' the running
  tangent of the pivot:

      dL[k][k] = 0.5 p' / d, and 0 where the pivot was clamped
      dL[r][k] = (a'[r][k] - L[r][k] dL[k][k]) / d                 r > k
      a'[r][j] -= dL[r][k] L[j][k] + L[r][k] dL[j][k]        k < j <= r

  The clamp ``sqrt(max(p, 1e-15))`` passes no tangent: a pivot counts as
  clamped where d <= sqrt(1e-15) in the working type, which is p <= 1e-15
  and, at the tie, also a p within one rounding above it (the derivative
  of ``max`` taken as 0 there).  Reads only the lower triangles of ``l``
  and ``dh``; the strict upper triangle of the result is zero.  Every
  tangent is its own computation, element for element the single-tangent
  one.
  """
  n = l.shape[-1]
  dmin = torch.sqrt(torch.tensor(MINVAL, dtype=l.dtype, device=l.device))
  # dh's lower triangle, in a new buffer shaped (and batched) like both
  t = torch.where(torch.ones_like(l, dtype=torch.bool).tril(), dh, 0.0)
  for k in range(n):
    d = l[..., k, k]
    dd = torch.where(d <= dmin, 0.0, 0.5 * t[..., k, k] / d)
    t[..., k, k] = dd
    col = l[..., k + 1:, k]
    dcol = (t[..., k + 1:, k] - col * dd[..., None]) / d[..., None]
    t[..., k + 1:, k] = dcol
    t[..., k + 1:, k + 1:] -= (dcol[..., :, None] * col[..., None, :]
                               + col[..., :, None] * dcol[..., None, :])
  return torch.tril(t)


def chol_solve_jvp_ref(l: torch.Tensor, dl: torch.Tensor | None,
                       x: torch.Tensor,
                       db: torch.Tensor | None) -> torch.Tensor:
  """Tangent dx of ``chol_solve`` at (L, b), from x = chol_solve(L, b).

  dx = L⁻ᵀ (L⁻¹ (db − dL (Lᵀ x)) − dLᵀ x), in five sweeps over the columns:
  y = Lᵀ x and t = dLᵀ x (sums in ascending column order), u = db − dL y,
  v = L⁻¹ u, w = v − t, dx = L⁻ᵀ w (the substitutions of
  ``chol_solve_ref``).  Reads only the lower triangles of ``l`` and
  ``dl``.  ``l`` is (B, n, n) and ``x`` (B, n) or (B, n, k), one a lane;
  ``dl`` and ``db`` take their shapes, or carry T tangents a lane in front
  ((T, B, n, n), (T, B, n[, k])).  Either may be None, a zero tangent:
  its sweeps are left out, which gives the same bits as zeros would.  dx
  is x's shape, with T in front where a tangent has it.
  """
  n = l.shape[-1]
  xs = x.reshape(x.shape[0], n, -1)
  if dl is None and db is None:
    return x.new_zeros(x.shape)
  lead = torch.broadcast_shapes(*(t.shape[:t.ndim - nd] for t, nd in (
      (dl, 3), (db, x.ndim)) if t is not None))
  y = _like_both(l, xs, False)
  for c in range(n):
    y[..., :c + 1, :] += l[..., c, :c + 1, None] * xs[..., c, None, :]
  u = _like_both(y, xs, False) if db is None else _like_both(
      y, db.reshape(*db.shape[:db.ndim - x.ndim], *xs.shape), True)
  if dl is not None:
    t = _like_both(dl, xs, False)
    for c in range(n):
      t[..., :c + 1, :] += dl[..., c, :c + 1, None] * xs[..., c, None, :]
    u = _like_both(dl, u, True)
    for c in range(n):
      u[..., c:, :] -= dl[..., c:, c, None] * y[..., c, None, :]
  for c in range(n):
    u[..., c, :] = u[..., c, :] / l[..., c, c, None]
    u[..., c + 1:, :] -= l[..., c + 1:, c, None] * u[..., c, None, :]
  if dl is not None:
    u = u - t
  for c in range(n - 1, -1, -1):
    u[..., c, :] = u[..., c, :] / l[..., c, c, None]
    u[..., :c, :] -= l[..., c, :c, None] * u[..., c, None, :]
  return u.reshape(*lead, *x.shape)


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
  s = ctypes.POINTER(ctypes.c_longlong)
  fn.argtypes = {
      "chol_factor": [p, p, i, i, i, i, i, p],
      "chol_solve": [p, p, p, i, i, i, i, i, i, p],
      "chol_factor_jvp": [p, p, p, s, i, i, i, i, i, i, i, p],
      "chol_solve_jvp": [p, p, p, p, p, s, i, i, i, i, i, i, i, i, p],
      "chol_factor_large": [p, p, i, i, i, i, p],
      "chol_solve_large": [p, p, p, i, i, i, i, i, p],
      "chol_factor_jvp_large": [p, p, p, s, i, i, i, i, i, p],
      "chol_solve_jvp_large": [p, p, p, p, p, s, i, i, i, i, i, i, p],
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


class JvpGeometry(NamedTuple):
  """Launch shape of a JVP kernel: lanes (factors) a block, warps a block,
  tangent buffers a warp, dynamic shared memory bytes a block."""
  lanes: int
  warps: int
  buffers: int
  smem: int


@functools.lru_cache(maxsize=None)
def jvp_launch_geometry(n: int, dtype: torch.dtype, tangents: int,
                        cols: int = 0, tangent_tiles: bool = True
                        ) -> JvpGeometry:
  """Launch shape of both JVP kernels for T = ``tangents`` tangents a lane.

  A block holds the packed lower triangle of each of its lanes' factors
  L, n (n + 1) / 2 elements (row r starts at r (r + 1) / 2; the starts of
  32 consecutive rows fall in 32 different banks), read once, and, for
  the solve, each lane's x and y = Lᵀ x (``cols`` columns of n).  Its
  warps take the block's (lane, tangent) items in turn; each warp has
  ``buffers`` packed tangent tiles (dH or dL; none without
  ``tangent_tiles``), two when it takes more than one item, so that the
  next item's tile is copied in while the current one runs.  A block takes
  ``MATS_PER_BLOCK`` items when T is small (T = 1: four lanes, one warp
  each, the single-tangent launch) and one lane with up to ``JVP_WARPS``
  warps when T is large; warps, then lanes, then buffers give way until
  the block fits ``SMEM_MAX`` (n = 128 in fp64: one lane, one warp).
  Returns (lanes, warps, buffers, shared memory bytes) of a block.
  """
  size = dtype.itemsize
  tile = n * (n + 1) // 2 * size
  per_lane = tile + 2 * n * cols * size
  lanes = max(1, -(-MATS_PER_BLOCK // max(tangents, 1)))
  most_warps, two = JVP_WARPS, True
  while True:
    items = lanes * tangents
    warps = max(1, min(most_warps, items))
    buffers = (2 if two and items > warps else 1) if tangent_tiles else 0
    smem = lanes * per_lane + warps * buffers * tile
    if smem <= SMEM_MAX:
      return JvpGeometry(lanes, warps, buffers, smem)
    if lanes > 1:
      lanes -= 1
    elif warps > 1:
      most_warps = warps - 1
    elif buffers > 1:
      two = False
    else:
      raise ValueError(f"a JVP block for n={n} {dtype} with {cols} "
                       f"right-hand-side columns does not fit {SMEM_MAX} "
                       "bytes")


class LargeGeometry(NamedTuple):
  """Launch shape of an n > N_MAX kernel: blocks, threads a block, dynamic
  shared memory bytes a block."""
  blocks: int
  threads: int
  smem: int


# vectors of n elements in a block's shared memory, by kernel: the
# factor's running diagonal and two pivot columns; the solve's right-hand
# side and solution; the factor JVP's tangent diagonal and two columns
# each of L and dL; the solve JVP's x, y, t, u and v
_LARGE_VECTORS = {"chol_factor": 3, "chol_solve": 2, "chol_factor_jvp": 5,
                  "chol_solve_jvp": 5}


def large_launch_geometry(kernel: str, n: int, dtype: torch.dtype,
                          lanes: int, tangents: int = 1,
                          cols: int = 1) -> LargeGeometry:
  """Launch shape of the n > N_MAX kernel of ``kernel`` ("chol_factor",
  "chol_solve", "chol_factor_jvp" or "chol_solve_jvp") for ``lanes``
  matrices, ``tangents`` tangents a lane and ``cols`` right-hand-side
  columns: one block of ``LARGE_WARPS`` warps an item (a matrix; a
  (matrix, column); a (lane, tangent); a (lane, tangent, column)), with a
  few vectors of n in shared memory (``_LARGE_VECTORS``).  The matrices
  stay in device memory, so nothing but those vectors bounds n: in fp64
  the factor runs up to n = 9685 and the JVPs to 5811, and a launch
  whose vectors outgrow ``SMEM_MAX`` is refused here."""
  smem = _LARGE_VECTORS[kernel] * n * dtype.itemsize
  if smem > SMEM_MAX:
    raise ValueError(f"{kernel} at n={n} {dtype} needs {smem} bytes of "
                     f"shared memory a block, over {SMEM_MAX}")
  blocks = (lanes * (tangents if kernel.endswith("_jvp") else 1)
            * (cols if kernel.startswith("chol_solve") else 1))
  if blocks > 2**31 - 1:
    raise ValueError(f"{kernel}: {blocks} blocks, over the grid's 2^31 - 1")
  return LargeGeometry(blocks, LARGE_WARPS * 32, smem)


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
  if n < 1:
    raise ValueError(f"kernel takes n >= 1, got n={n}")
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
# kernel wrappers
# ---------------------------------------------------------------------------


def _factor(h: torch.Tensor) -> torch.Tensor:
  """The primal factor: ``chol_factor_ref`` on the CPU; on the card the
  warp kernel up to n = ``N_MAX``, the block kernel above."""
  if _device_kind(h) == "cpu":
    return chol_factor_ref(h)
  return _factor_kernel(h, _check_factor_shape(h) > N_MAX)


def chol_factor_large(h: torch.Tensor) -> torch.Tensor:
  """The factor's block kernel whatever n (``chol_factor_ref`` on the
  CPU): what ``_factor`` launches above ``N_MAX``."""
  if _device_kind(h) == "cpu":
    return chol_factor_ref(h)
  return _factor_kernel(h, True)


def _factor_kernel(h: torch.Tensor, block: bool) -> torch.Tensor:
  """Launches the factor's warp or ``block`` kernel, which reads ``h`` in
  place (a copy only if it is not contiguous)."""
  n = _check_factor_shape(h)
  name = "chol_factor_large" if block else "chol_factor"
  fn = _entry(name, h.dtype)
  h = h.contiguous()
  l = torch.empty_like(h)  # contiguous, like h
  bsz = h.shape[0]
  if bsz == 0:
    return l
  if block:
    g = large_launch_geometry("chol_factor", n, h.dtype, bsz)
    shape = (n, bsz, g.threads, g.smem)
  else:
    ld, per_block, smem = launch_geometry(n, h.dtype)
    shape = (n, ld, bsz, per_block, smem)
  with torch.cuda.device(h.device):
    _check_launch(fn(h.data_ptr(), l.data_ptr(), *shape, _stream(h)), name)
  _count(chol_factor_large if block else chol_factor, n, bsz, h.dtype)
  return l


def _solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The primal solve: ``chol_solve_ref`` on the CPU; on the card the warp
  kernel up to n = ``N_MAX`` (a warp a matrix, its columns in turn), the
  block kernel above (a block a column), each reading ``l`` and ``b`` in
  place and writing x in ``b``'s shape."""
  if _device_kind(l) == "cpu" and b.device.type == "cpu":
    return chol_solve_ref(l, b)
  return _solve_kernel(l, b, _check_solve_shapes(l, b)[0] > N_MAX)


def chol_solve_large(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The solve's block kernel whatever n (``chol_solve_ref`` on the CPU):
  what ``_solve`` launches above ``N_MAX``."""
  if _device_kind(l) == "cpu" and b.device.type == "cpu":
    return chol_solve_ref(l, b)
  return _solve_kernel(l, b, True)


def _solve_kernel(l: torch.Tensor, b: torch.Tensor,
                  block: bool) -> torch.Tensor:
  n, k = _check_solve_shapes(l, b)
  name = "chol_solve_large" if block else "chol_solve"
  fn = _entry(name, l.dtype)
  l, b = l.contiguous(), b.contiguous()
  x = torch.empty_like(b)  # contiguous, like b
  bsz = l.shape[0]
  if bsz == 0 or k == 0:
    return x
  if block:
    g = large_launch_geometry("chol_solve", n, l.dtype, bsz, cols=k)
    shape = (n, bsz, k, g.threads, g.smem)
  else:
    ld, per_block, smem = launch_geometry(n, l.dtype)
    shape = (n, ld, bsz, k, per_block, smem)
  with torch.cuda.device(l.device):
    _check_launch(fn(l.data_ptr(), b.data_ptr(), x.data_ptr(), *shape,
                     _stream(l)), name)
  _count(chol_solve_large if block else chol_solve, n, bsz, k, l.dtype)
  return x


def _strides(*ts: torch.Tensor | None) -> ctypes.Array:
  """The element strides of ``ts``, one after the other, as a C array; an
  absent (tangent) operand gives four strides of 0."""
  flat = [st for t in ts for st in (t.stride() if t is not None else
                                    (0, 0, 0, 0))]
  return (ctypes.c_longlong * len(flat))(*flat)


def _count(fn, *shape) -> None:
  """One launch of ``fn``'s kernel at ``shape``: (n, lanes, dtype) of the
  factor, (n, lanes, columns, dtype) of the solve, (n, lanes, tangents a
  lane, dtype) of the factor's JVP and (n, lanes, tangents a lane,
  columns, dtype) of the solve's; the n > N_MAX kernels' the same."""
  fn.launches += 1
  fn.shapes[shape] += 1


def _check_tangent(ref: torch.Tensor, t: torch.Tensor, what: str) -> int:
  """``t`` has ``ref``'s shape, or (T,) in front of it; returns T, 0 for
  none."""
  if t.device != ref.device or t.dtype != ref.dtype or (
      t.shape[t.ndim - ref.ndim:] != ref.shape) or t.ndim > ref.ndim + 1:
    raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} on {t.device} "
                     f"does not match {tuple(ref.shape)} {ref.dtype} on "
                     f"{ref.device}, with or without T tangents in front")
  return t.shape[0] if t.ndim > ref.ndim else 0


def chol_factor_jvp(l: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
  """Tangent of the factor (see ``chol_factor_jvp_ref``): CPU tensors take
  the plain version, CUDA tensors launch the warp kernel up to n =
  ``N_MAX`` and the block kernel above.

  ``l`` (B, n, n); ``dh`` (B, n, n) or (T, B, n, n), T tangents a lane, in
  any strides: the kernel reads each operand through its element strides
  (a stride of 0 repeats it), with no copy, and reads each lane's L once
  for all its tangents (the warp kernel; the block kernel takes a block a
  (lane, tangent) and works in dL).  dL is a new contiguous tensor of
  dh's shape.
  """
  if _device_kind(l) == "cpu" and dh.device.type == "cpu":
    return chol_factor_jvp_ref(l, dh)
  return _factor_jvp_kernel(l, dh, _check_factor_shape(l) > N_MAX)


def chol_factor_jvp_large(l: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
  """The factor JVP's block kernel whatever n (``chol_factor_jvp_ref`` on
  the CPU), with ``chol_factor_jvp``'s contract."""
  if _device_kind(l) == "cpu" and dh.device.type == "cpu":
    return chol_factor_jvp_ref(l, dh)
  return _factor_jvp_kernel(l, dh, True)


def _factor_jvp_kernel(l: torch.Tensor, dh: torch.Tensor,
                       block: bool) -> torch.Tensor:
  n = _check_factor_shape(l)
  tangents = _check_tangent(l, dh, "tangent of the matrix")
  name = "chol_factor_jvp_large" if block else "chol_factor_jvp"
  fn = _entry(name, l.dtype)
  dh4 = dh if tangents else dh[None]
  dl = torch.empty(dh4.shape, dtype=l.dtype, device=l.device)
  lanes, nt = l.shape[0], dh4.shape[0]
  if lanes and nt:
    if block:
      g = large_launch_geometry("chol_factor_jvp", n, l.dtype, lanes, nt)
      shape = (g.threads, g.smem)
    else:
      g = jvp_launch_geometry(n, l.dtype, nt)
      shape = (g.lanes, g.warps, g.buffers, g.smem)
    with torch.cuda.device(l.device):
      _check_launch(fn(l.data_ptr(), dh4.data_ptr(), dl.data_ptr(),
                       _strides(l, dh4, dl), n, lanes, nt, *shape,
                       _stream(l)), name)
    _count(chol_factor_jvp_large if block else chol_factor_jvp, n, lanes, nt,
           l.dtype)
  return dl if tangents else dl[0]


def chol_solve_jvp(l: torch.Tensor, dl: torch.Tensor | None, x: torch.Tensor,
                   db: torch.Tensor | None) -> torch.Tensor:
  """Tangent of the solve (see ``chol_solve_jvp_ref``): CPU tensors take
  the plain version, CUDA tensors launch the warp kernel up to n =
  ``N_MAX`` and the block kernel above.

  ``l`` (B, n, n) and ``x`` (B, n[, k]) one a lane; ``dl`` and ``db`` of
  their shapes or with T tangents a lane in front, in any strides, or None
  (a zero tangent: the kernel is told so and reads nothing for it).  The
  warp kernel reads L and x once a lane, computes y = Lᵀ x once a lane,
  and takes the lane's tangents past them (the block kernel: a block a
  (lane, tangent, column)); an operand without T is read with a tangent
  stride of 0.  dx is a new contiguous tensor of x's shape, with T in
  front where a tangent has it.
  """
  if all(t.device.type == "cpu" for t in (l, x, dl, db) if t is not None):
    return chol_solve_jvp_ref(l, dl, x, db)
  _device_kind(l)
  return _solve_jvp_kernel(l, dl, x, db,
                           _check_solve_shapes(l, x)[0] > N_MAX)


def chol_solve_jvp_large(l: torch.Tensor, dl: torch.Tensor | None,
                         x: torch.Tensor,
                         db: torch.Tensor | None) -> torch.Tensor:
  """The solve JVP's block kernel whatever n (``chol_solve_jvp_ref`` on
  the CPU), with ``chol_solve_jvp``'s contract."""
  if all(t.device.type == "cpu" for t in (l, x, dl, db) if t is not None):
    return chol_solve_jvp_ref(l, dl, x, db)
  _device_kind(l)
  return _solve_jvp_kernel(l, dl, x, db, True)


def _solve_jvp_kernel(l: torch.Tensor, dl: torch.Tensor | None,
                      x: torch.Tensor, db: torch.Tensor | None,
                      block: bool) -> torch.Tensor:
  n, k = _check_solve_shapes(l, x)
  tl = 0 if dl is None else _check_tangent(l, dl, "tangent of the factor")
  tb = 0 if db is None else _check_tangent(x, db,
                                           "tangent of the right-hand side")
  if tl and tb and tl != tb:
    raise ValueError(f"{tl} tangents of the factor, {tb} of the rhs")
  tangents = max(tl, tb)
  nt = max(tangents, 1)
  given = dl is not None or db is not None
  new = torch.empty if given else torch.zeros
  dx = new((nt, *x.shape), dtype=x.dtype, device=x.device)
  lanes = l.shape[0]
  if not given or lanes == 0 or k == 0:
    return dx if tangents else dx[0]
  name = "chol_solve_jvp_large" if block else "chol_solve_jvp"
  fn = _entry(name, l.dtype)

  # (T, B, n, k) views; an operand without T repeats by a stride of 0
  col = (lambda t: t) if x.ndim == 3 else (lambda t: t[..., None])
  x3, dx4 = col(x), col(dx)
  dl4 = None if dl is None else (dl if tl else dl[None]).expand(nt, *l.shape)
  db4 = None if db is None else col(db if tb else db[None]).expand(
      nt, *x3.shape)
  if block:
    g = large_launch_geometry("chol_solve_jvp", n, l.dtype, lanes, nt, k)
    shape = (g.threads, g.smem)
  else:
    g = jvp_launch_geometry(n, l.dtype, nt, k, dl is not None)
    shape = (g.lanes, g.warps, g.buffers, g.smem)
  with torch.cuda.device(l.device):
    # an absent operand: a null pointer
    _check_launch(fn(
        l.data_ptr(), None if dl4 is None else dl4.data_ptr(), x3.data_ptr(),
        None if db4 is None else db4.data_ptr(), dx4.data_ptr(),
        _strides(l, dl4, x3, db4, dx4), n, lanes, nt, k, *shape,
        _stream(l)), name)
  _count(chol_solve_jvp_large if block else chol_solve_jvp, n, lanes, nt, k,
         l.dtype)
  return dx if tangents else dx[0]


# ---------------------------------------------------------------------------
# public functions, with their forward-mode and vmap rules
# ---------------------------------------------------------------------------


def _fold(t: torch.Tensor | None, bdim: int | None, size: int,
          lane_dim: int) -> torch.Tensor | None:
  """Folds the vmapped dimension of ``t`` (at ``bdim``; None: t is the same
  for all ``size`` entries) into its lane dimension ``lane_dim`` (counted
  without the vmapped one): (..., V·B, ...), entry v's lanes in a row."""
  if t is None:
    return None
  t = t.unsqueeze(0).expand(size, *t.shape) if bdim is None else (
      t.movedim(bdim, 0))
  return t.movedim(0, lane_dim).flatten(lane_dim, lane_dim + 1)


def _unfold(t: torch.Tensor, size: int, lane_dim: int) -> torch.Tensor:
  """The inverse of ``_fold``: the vmapped dimension back in front."""
  return t.unflatten(lane_dim, (size, -1)).movedim(lane_dim, 0)


def _tangents(t: torch.Tensor | None, bdim: int | None, ndim: int
              ) -> torch.Tensor | None:
  """A tangent operand whose vmapped dimension (at ``bdim``) is a
  dimension of tangents: moved in front (a view), and merged with the
  tangents ``t`` already has (its logical ndim > ``ndim``)."""
  if t is None or bdim is None:
    return t
  t = t.movedim(bdim, 0)
  return t.flatten(0, 1) if t.ndim > ndim + 1 else t


class _CholFactorJvp(torch.autograd.Function):
  """``chol_factor_jvp`` as an operation ``vmap`` can batch: the tangents'
  vmapped dimension becomes the kernel's tangent dimension, read in place
  through its stride; a vmapped factor folds into the lanes."""

  @staticmethod
  def forward(l, dh):
    return chol_factor_jvp(l, dh)

  @staticmethod
  def setup_context(ctx, inputs, output):
    pass

  @staticmethod
  def vmap(info, in_dims, l, dh):
    ld, hd = in_dims
    if ld is None:
      out = _CholFactorJvp.apply(l, _tangents(dh, hd, 3))
      tangents = dh.ndim > 4
      return (out.unflatten(0, (info.batch_size, -1)) if tangents else
              out), 0
    lane = dh.ndim - 3 - (hd is not None)
    out = _CholFactorJvp.apply(_fold(l, ld, info.batch_size, 0),
                               _fold(dh, hd, info.batch_size, lane))
    return _unfold(out, info.batch_size, lane), 0


class _CholSolveJvp(torch.autograd.Function):
  """``chol_solve_jvp`` as an operation ``vmap`` can batch, as
  ``_CholFactorJvp``; absent tangents stay absent."""

  @staticmethod
  def forward(l, dl, x, db):
    return chol_solve_jvp(l, dl, x, db)

  @staticmethod
  def setup_context(ctx, inputs, output):
    pass

  @staticmethod
  def vmap(info, in_dims, l, dl, x, db):
    ld, dld, xd, dbd = in_dims
    size = info.batch_size
    xnd = x.ndim - (xd is not None)
    if ld is None and xd is None:
      out = _CholSolveJvp.apply(l, _tangents(dl, dld, 3), x,
                                _tangents(db, dbd, xnd))
      # the tangents a tangent operand had before vmap, if any
      had = (dl is not None and dl.ndim - (dld is not None) > 3) or (
          db is not None and db.ndim - (dbd is not None) > xnd)
      return (out.unflatten(0, (size, -1)) if had else out), 0
    tl = dl is not None and dl.ndim - (dld is not None) > 3
    tb = db is not None and db.ndim - (dbd is not None) > xnd
    out = _CholSolveJvp.apply(
        _fold(l, ld, size, 0), _fold(dl, dld, size, int(tl)),
        _fold(x, xd, size, 0), _fold(db, dbd, size, int(tb)))
    return _unfold(out, size, int(tl or tb)), 0


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
    return _CholFactorJvp.apply(l, dh)

  @staticmethod
  def vmap(info, in_dims, h):
    # a vmapped matrix: its stack folds into the kernel's batch
    (hd,) = in_dims
    return _unfold(chol_factor(_fold(h, hd, info.batch_size, 0)),
                   info.batch_size, 0), 0


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
    return _CholSolveJvp.apply(l, dl, x, db)

  @staticmethod
  def vmap(info, in_dims, l, b):
    ld, bd = in_dims
    size = info.batch_size
    return _unfold(chol_solve(_fold(l, ld, size, 0), _fold(b, bd, size, 0)),
                   size, 0), 0


def chol_factor(h: torch.Tensor) -> torch.Tensor:
  """(B, n, n) -> lower Cholesky factor (upper triangle zero).

  CPU tensors take ``chol_factor_ref``; CUDA tensors launch the kernel.  A
  dual ``h`` gives a dual factor, its tangent from ``chol_factor_jvp``;
  under ``torch.func.vmap`` over ``torch.func.jvp`` the factor is computed
  once and all the tangents go through one ``chol_factor_jvp`` launch.
  """
  return _CholFactor.apply(h)



def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves L Lᵀ x = b; ``l`` (B, n, n) lower factor, ``b`` (B, n[, k]).

  CPU tensors take ``chol_solve_ref``; CUDA tensors launch the kernel.  A
  dual ``l`` or ``b`` gives a dual x, its tangent from ``chol_solve_jvp``
  (one launch for all tangents under ``vmap`` over ``jvp``).
  """
  return _CholSolve.apply(l, b)


# launches, and launches by shape (see _count)
for _fn in (chol_factor, chol_solve, chol_factor_jvp, chol_solve_jvp,
            chol_factor_large, chol_solve_large, chol_factor_jvp_large,
            chol_solve_jvp_large):
  _fn.launches = 0
  _fn.shapes = collections.Counter()
