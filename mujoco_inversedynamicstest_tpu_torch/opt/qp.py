"""Box-constrained QP for trajectory optimization, a batch of problems.

Port of ``box_qp`` from ``mujoco_inversedynamicstest_tpu/opt/qp.py``, the
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

The banded solvers of the JAX module (``chol_factor_band``,
``chol_solve_band``, ``band_to_dense``, ``dense_to_band``) are not on the
MPC path and are not ported yet (ROADMAP queue 1).
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
