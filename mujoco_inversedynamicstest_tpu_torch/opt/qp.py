"""Box-constrained QP for trajectory optimization, a batch of problems.

Port of ``box_qp`` from the JAX package's ``opt/qp.py``, the
projected-Newton analog of ``mju_boxQP``.  The JAX package solves one QP
and ``vmap``s it; here ``h`` is (B, n, n) and ``g`` (B, n), and the Newton
and Armijo ``lax.while_loop``s become loops under per-lane masks: a lane
that is done freezes, exactly as the vmapped while-loop selects, and a loop
ends when no lane is live.

The masked free-set factorization is LAPACK's in the JAX package
(``jnp.linalg.cholesky``), outside any Pallas kernel; here it is
``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``, with NaN written
into a lane whose matrix is not positive definite, as LAPACK returns there.
The port's clamped ``chol_factor`` would turn such a lane's NaN gain, which
the iLQR rejects, into a finite one, which it might accept.

The banded solvers (``chol_factor_band``, ``chol_solve_band``,
``band_to_dense``, ``dense_to_band``) are ``lax.scan``s over rows in the
JAX package, not Pallas kernels; here they are loops over rows of plain
batched torch, (B, ntotal, nband) a batch of band matrices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BoxQPResult(NamedTuple):
  x: torch.Tensor           # (B, n) solution
  free: torch.Tensor        # (B, n) bool: dofs strictly inside the box
  cost: torch.Tensor        # (B,) objective 0.5 x'Hx + x'g
  niter: torch.Tensor       # (B,) iterations taken
  hfree_chol: torch.Tensor  # (B, n, n) Cholesky of the masked free Hessian


def cholesky_nan(h: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of each (B, n, n) matrix; all NaN where the
  matrix is not positive definite (LAPACK's answer in the JAX package)."""
  l, info = torch.linalg.cholesky_ex(h)
  return torch.where((info != 0)[:, None, None], torch.nan, l)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves L Lᵀ x = b for b (B, n) or (B, n, k)."""
  if b.ndim == 2:
    return torch.cholesky_solve(b[..., None], l)[..., 0]
  return torch.cholesky_solve(b, l)


def masked_matrix(h: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
  """H with the rows and columns of clamped dofs replaced by identity's."""
  fm = free.to(h.dtype)
  return h * fm[:, :, None] * fm[:, None, :] + torch.diag_embed(1.0 - fm)


def _masked_chol_solve(h: torch.Tensor, g: torch.Tensor, free: torch.Tensor):
  """Solves H[free, free] x = g[free] with clamped rows pinned to identity
  (static shapes; the reference compresses indices instead)."""
  l = cholesky_nan(masked_matrix(h, free))
  fm = free.to(h.dtype)
  return cho_solve(l, g * fm) * fm, l


def _matvec(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  return (h @ x[..., None])[..., 0]


def box_qp(h: torch.Tensor, g: torch.Tensor,
           lower: Optional[torch.Tensor] = None,
           upper: Optional[torch.Tensor] = None,
           x0: Optional[torch.Tensor] = None, maxiter: int = 50,
           tol_grad: float = 1e-10, tol_ls: float = 1e-8) -> BoxQPResult:
  """min_x 0.5 x'Hx + x'g  s.t. lower <= x <= upper, a lane each.

  Projected Newton with Armijo backtracking (``mju_boxQP``'s free-set
  logic: clamped = at a bound and the gradient pushing outward).  ``h``
  (B, n, n) SPD, ``g`` (B, n); the bounds and ``x0`` are (B, n) or (n,).
  """
  bsz, n = g.shape
  dtype, dev = g.dtype, g.device
  big = torch.finfo(dtype).max / 4
  shape = (bsz, n)
  lo = (torch.full(shape, -big, dtype=dtype, device=dev) if lower is None
        else lower.expand(shape))
  hi = (torch.full(shape, big, dtype=dtype, device=dev) if upper is None
        else upper.expand(shape))
  x = torch.zeros(shape, dtype=dtype, device=dev) if x0 is None else x0
  x = torch.clamp(x.expand(shape), lo, hi)

  def cost(x):
    return 0.5 * torch.sum(x * _matvec(h, x), -1) + torch.sum(x * g, -1)

  def lanes(mask, new, old):
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

  l = torch.eye(n, dtype=dtype, device=dev).expand(bsz, n, n)
  it = torch.zeros(bsz, dtype=torch.int32, device=dev)
  done = torch.zeros(bsz, dtype=torch.bool, device=dev)
  while True:
    live = ~done & (it < maxiter)
    if not bool(live.any()):
      break
    grad = _matvec(h, x) + g
    free = ~(((x <= lo) & (grad > 0)) | ((x >= hi) & (grad < 0)))
    dx, l_new = _masked_chol_solve(h, -grad, free)

    # projected Armijo backtracking (ref :1171-1192)
    c0 = cost(x)
    slope = torch.sum(grad * dx, -1)
    xn = torch.clamp(x + dx, lo, hi)
    ok = cost(xn) <= c0 + 0.1 * slope
    alpha = torch.full((bsz,), 0.5, dtype=dtype, device=dev)
    searching = ~ok & (alpha > tol_ls)
    while bool(searching.any()):
      xs = torch.clamp(x + alpha[:, None] * dx, lo, hi)
      oks = cost(xs) <= c0 + 0.1 * alpha * slope
      xn = lanes(searching, xs, xn)
      ok = lanes(searching, oks, ok)
      alpha = lanes(searching, alpha * 0.5, alpha)
      searching = ~ok & (alpha > tol_ls)

    gnorm = torch.linalg.vector_norm(grad * free.to(dtype), dim=-1)
    improved = cost(xn) < c0 - 1e-16
    x = lanes(live & improved, xn, x)
    l = lanes(live, l_new, l)
    it = it + live.to(it.dtype)
    done = done | (live & ((gnorm < tol_grad) | ~improved))

  grad = _matvec(h, x) + g
  free = ~(((x <= lo) & (grad > 0)) | ((x >= hi) & (grad < 0)))
  return BoxQPResult(x=x, free=free, cost=cost(x), niter=it, hfree_chol=l)


# ---------------------------------------------------------------------------
# banded Cholesky (trajectory band solver)
# ---------------------------------------------------------------------------


def chol_factor_band(mat_band: torch.Tensor, diagadd: float = 0.0,
                     diagmul: float = 0.0) -> torch.Tensor:
  """Cholesky of each banded SPD matrix in dense-row band storage, analog of
  ``mju_cholFactorBand`` without the trailing dense block.

  ``mat_band`` is (B, ntotal, nband): row i holds [A[i, i-nband+1], ...,
  A[i, i]], left-zero-padded.  Returns L in the same layout (the last
  column is its diagonal).  Row by row, as the JAX scan: the row's
  off-diagonal entries solve the triangle of the nband-1 rows before it
  (rows before the start: zero entries, unit diagonal), its diagonal is
  the square root of what is left, floored at 1e-30.
  """
  bsz, ntotal, nband = mat_band.shape
  dtype, dev = mat_band.dtype, mat_band.device
  k = nband - 1
  # the window's triangle: tri[c, e] = L[j_c, j_e] = window[c, k + e - c]
  # for e <= c, where window[c] is the band row of row j_c = i - k + c
  c_idx = torch.arange(k, device=dev)
  gather = (k + c_idx[None, :] - c_idx[:, None]).clamp(0, nband - 1)
  lower = c_idx[None, :] <= c_idx[:, None]
  window = torch.zeros(bsz, k, nband, dtype=dtype, device=dev)
  window[..., -1] = 1.0
  rows = []
  for i in range(ntotal):
    r = mat_band[:, i]
    diag = r[:, -1] * (1.0 + diagmul) + diagadd
    if k:
      tri = torch.where(lower, torch.gather(
          window, 2, gather.expand(bsz, k, k)), 0.0)
      off = torch.linalg.solve_triangular(tri, r[:, :k, None],
                                          upper=False)[..., 0]
      diag = diag - torch.sum(off * off, -1)
    row = torch.sqrt(torch.clamp(diag, min=1e-30))[:, None]
    row = torch.cat([off, row], -1) if k else row
    if k:
      window = torch.cat([window[:, 1:], row[:, None]], 1)
    rows.append(row)
  return torch.stack(rows, 1)


def chol_solve_band(l_band: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solves (L L') x = b for each lane, given the band factor (B, ntotal,
  nband) of ``chol_factor_band`` and b (B, ntotal): analog of
  ``mju_cholSolveBand``.  Forward then backward substitution, a row at a
  time."""
  bsz, ntotal, nband = l_band.shape
  k = nband - 1
  y = []
  for i in range(ntotal):
    lrow = l_band[:, i]
    lo = max(0, i - k)
    acc = b[:, i]
    if i > lo:
      prev = torch.stack(y[lo:i], -1)
      acc = acc - torch.sum(lrow[:, k - (i - lo):k] * prev, -1)
    y.append(acc / lrow[:, -1])
  x = [None] * ntotal
  for i in reversed(range(ntotal)):
    hi = min(ntotal, i + nband)
    acc = y[i]
    if hi > i + 1:
      # L[i + t, i] = l_band[i + t, k - t], t = 1 .. hi - i - 1
      t = torch.arange(1, hi - i, device=l_band.device)
      col = l_band[:, i + t, k - t]
      acc = acc - torch.sum(col * torch.stack(x[i + 1:hi], -1), -1)
    x[i] = acc / l_band[:, i, -1]
  return torch.stack(x, -1)


def band_to_dense(mat_band: torch.Tensor,
                  lower_only: bool = False) -> torch.Tensor:
  """Expands band storage (B, ntotal, nband) to dense (B, ntotal, ntotal)
  (analog of ``mju_band2Dense``)."""
  bsz, ntotal, nband = mat_band.shape
  dense = mat_band.new_zeros(bsz, ntotal, ntotal)
  for k in range(nband):
    offset = nband - 1 - k
    if offset >= ntotal:
      continue
    i = torch.arange(offset, ntotal, device=mat_band.device)
    dense[:, i, i - offset] = mat_band[:, offset:, k]
  if not lower_only:
    dense = dense + torch.tril(dense, -1).transpose(1, 2)
  return dense


def dense_to_band(dense: torch.Tensor, nband: int) -> torch.Tensor:
  """Packs the lower band of each dense SPD matrix (B, ntotal, ntotal)
  into band storage (B, ntotal, nband)."""
  bsz, ntotal, _ = dense.shape
  band = dense.new_zeros(bsz, ntotal, nband)
  for k in range(nband):
    offset = nband - 1 - k
    if offset >= ntotal:
      continue
    band[:, offset:, k] = torch.diagonal(dense, -offset, dim1=1, dim2=2)
  return band
