"""Nonlinear least squares (Gauss-Newton) with box bounds, a batch of
problems.

Port of the JAX package's ``opt/minimize.py`` (the analog of
the reference's ``python/mujoco/minimize.py:138 least_squares``).  The JAX
package solves one problem in a ``lax.while_loop`` and ``vmap``s it; here
``x0`` is (B, n) and the residual maps (B, n) to (B, r).  The loop runs
while any lane is live, and a lane that has stopped freezes, as the
vmapped while-loop keeps a finished lane's carry.

The residual Jacobian is ``torch.func.vmap`` over ``torch.func.jvp`` with
the n unit tangents, as ``opt/derivative.py`` forms the transition
Jacobians: the residual's primal runs once a lane and the tangents are
the vmapped dimension (B, r, n).  The unbounded step factors J'J + mu I
with ``torch.linalg.cholesky_ex`` (``jnp.linalg.cholesky`` in the JAX
package, outside any Pallas kernel); the bounded step is ``box_qp``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import func

from mujoco_inversedynamicstest_tpu_torch.opt import qp


class LeastSquaresResult(NamedTuple):
  x: torch.Tensor          # (B, n) solution
  cost: torch.Tensor       # (B,) 0.5 ||r(x)||^2
  grad_norm: torch.Tensor  # (B,)
  niter: torch.Tensor      # (B,) iterations taken


def residual_jacobian(residual: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """The residual (B, r) at x (B, n) and its Jacobian (B, r, n)."""
  bsz, n = x.shape
  eye = torch.eye(n, dtype=x.dtype, device=x.device)
  tangents = eye[:, None, :].expand(n, bsz, n)
  r, jac = func.vmap(lambda e: func.jvp(residual, (x,), (e,)),
                     out_dims=(None, 0))(tangents)
  return r, jac.permute(1, 2, 0)


def least_squares(
    residual: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    bounds: Optional[tuple] = None,
    max_iter: int = 50,
    tol_grad: float = 1e-9,
    tol_step: float = 1e-12,
    mu_init: float = 1e-4,
    mu_factor: float = 3.0,
) -> LeastSquaresResult:
  """min_x 0.5 ||residual(x)||^2 a lane each, optionally within bounds
  (lower, upper), each (B, n) or (n,).

  Levenberg-regularized Gauss-Newton: H = J'J + mu I, the step from
  ``box_qp`` when bounded (a Cholesky solve when not), mu divided by
  ``mu_factor`` on an accepted step and multiplied on a rejected one.  A
  lane stops on the JAX loop's tests: gradient norm below ``tol_grad``, an
  accepted step shorter than ``tol_step``, a rejected step at mu 1e10, or
  ``max_iter`` iterations.
  """
  bsz, n = x0.shape
  dtype, dev = x0.dtype, x0.device
  lo = hi = None
  if bounds is not None:
    lo, hi = (b.to(dtype).expand(bsz, n) for b in bounds)
    x0 = torch.clamp(x0, lo, hi)

  def cost(x):
    r = residual(x)
    return 0.5 * torch.sum(r * r, -1)

  def lanes(mask, new, old):
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

  eye = torch.eye(n, dtype=dtype, device=dev)
  x, c = x0, cost(x0)
  mu = torch.full((bsz,), mu_init, dtype=dtype, device=dev)
  it = torch.zeros(bsz, dtype=torch.int32, device=dev)
  done = torch.zeros(bsz, dtype=torch.bool, device=dev)
  while True:
    live = ~done & (it < max_iter)
    if not bool(live.any()):
      break
    r, jac = residual_jacobian(residual, x)
    jt = jac.transpose(1, 2)
    g = (jt @ r[..., None])[..., 0]
    h = jt @ jac + mu[:, None, None] * eye
    if lo is not None:
      dx = qp.box_qp(h, g, lo - x, hi - x, maxiter=30).x
      x_new = torch.clamp(x + dx, lo, hi)
    else:
      dx = -qp.cho_solve(qp.cholesky_nan(h), g)
      x_new = x + dx
    c_new = cost(x_new)
    improved = c_new < c
    gnorm = torch.linalg.vector_norm(g, dim=-1)
    step = torch.linalg.vector_norm(dx, dim=-1)
    stop = ((gnorm < tol_grad) | (improved & (step < tol_step))
            | (~improved & (mu >= 1e10)))
    accept = live & improved
    x = lanes(accept, x_new, x)
    c = lanes(accept, c_new, c)
    mu = lanes(live, torch.where(improved,
                                 torch.clamp(mu / mu_factor, min=1e-10),
                                 torch.clamp(mu * mu_factor, max=1e10)), mu)
    it = it + live.to(it.dtype)
    done = done | (live & stop)

  r, jac = residual_jacobian(residual, x)
  g = (jac.transpose(1, 2) @ r[..., None])[..., 0]
  return LeastSquaresResult(x=x, cost=c,
                            grad_norm=torch.linalg.vector_norm(g, dim=-1),
                            niter=it)
