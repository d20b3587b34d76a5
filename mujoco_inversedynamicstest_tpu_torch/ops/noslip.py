"""Noslip post-pass: dual Gauss-Seidel over the friction rows.

Port of the JAX package's ``ops/noslip.py`` (``mj_solNoSlip``).
After the main solve the friction forces are solved again in the dual
with the friction rows' regularization R removed, which takes away the
slip the regularized cones allow.  The sweep visits the friction "units"
in efc order:

* dry-friction rows (dof and tendon friction loss): a scalar update
  clamped to ±frictionloss;
* pyramidal contacts: each pair of opposing edges, their sum (the normal's
  share) kept while the difference moves within it;
* elliptic contacts: the friction block solved again as a QCQP inside the
  ellipse of radius the normal force (``mju_QCQP``, ``_qcqp``).

The dual matrix AR = J M⁻¹ Jᵀ + diag(R) is one dense product a lane, with
M⁻¹ Jᵀ through ``smooth.solve_m`` (the Cholesky solve kernel, one launch
for all nefc columns).  The JAX package's ``lax.scan`` over a padded unit
table becomes a host loop over the static units, each unit updated in all
lanes at once at its own width; its ``while_loop`` over sweeps becomes
sweeps under a per-lane ``live`` mask, ended when no lane is live.  Every
update is out of place, so forward-mode AD differentiates the sweeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import math, smooth

# Newton iterations on the QCQP's multiplier (mju_QCQP's)
_QCQP_ITERATIONS = 20


class Unit(NamedTuple):
  """One unit of a sweep: its kind, its efc rows (contiguous), its contact
  slot (-1 for a row without one) and, for an elliptic block, its normal
  row."""
  kind: str
  start: int
  width: int
  slot: int = -1
  normal: int = -1


def contact_rows(m: Model) -> np.ndarray:
  """The first efc row of each contact slot."""
  dim = collision.contact_layout(m).dim
  width = np.where(dim == 1, 1, dim if constraint.elliptic(m)
                   else 2 * (dim - 1))
  return constraint.row_layout(m).ncon_start + np.cumsum(
      np.concatenate([[0], width]))[:-1].astype(np.int64)


def _units(m: Model) -> tuple:
  """The noslip sweep's units, in efc order."""
  lay = constraint.row_layout(m)
  units = [Unit("dry", r, 1) for r in range(lay.ne, lay.ne + lay.nf)]
  dim = collision.contact_layout(m).dim
  for s, adr in enumerate(contact_rows(m)):
    if dim[s] == 1:
      continue
    if constraint.elliptic(m):
      units.append(Unit("elliptic", int(adr) + 1, int(dim[s]) - 1, s,
                        int(adr)))
    else:
      units += [Unit("pyramid", int(adr) + 2 * k, 2, s)
                for k in range(dim[s] - 1)]
  return tuple(units)


def dual(m: Model, d: Data):
  """The dual problem's AR = J M⁻¹ Jᵀ + diag(R) (B, nefc, nefc), from
  ``mj_projectConstraint``, and b = J qacc_smooth - aref (B, nefc)."""
  minv_jt = smooth.solve_m(m, d, d.efc_J.transpose(1, 2))
  ar = torch.matmul(d.efc_J, minv_jt) + torch.diag_embed(d.efc_R)
  return ar, math.matvec(d.efc_J, d.qacc_smooth) - d.efc_aref


def _solve_small(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """(B, n, n) lower factors, (B, n) right-hand sides: L Lᵀ x = b."""
  return torch.cholesky_solve(b[..., None], l)[..., 0]


def qcqp(a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
         r: torch.Tensor) -> torch.Tensor:
  """min ½ vᵀ A v + bᵀ v subject to Σ (v_i / mu_i)² ≤ r², each lane
  (``mju_QCQP``): A (B, n, n), b and mu (B, n), r (B,).  Newton's method
  on the multiplier of the scaled problem, at most 20 iterations a lane,
  each lane ending as C's does (the value or the step below 1e-10, or a
  matrix that is not positive definite, which gives v = 0); on the
  constraint the result is put back on the ellipse.  The factors of
  these (n ≤ 5) matrices are ``torch.linalg.cholesky_ex``'s, as the JAX
  package's ``jnp.linalg.cholesky`` is outside any Pallas kernel."""
  a_s = a * mu[:, :, None] * mu[:, None, :]
  b_s = b * mu
  eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)

  def factor(la):
    l, info = torch.linalg.cholesky_ex(a_s + la[:, None, None] * eye)
    ok = (info == 0) & (torch.diagonal(l, dim1=-2, dim2=-1) > 1e-10).all(-1)
    return torch.where(ok[:, None, None], l, eye), ok

  la = torch.zeros_like(r)
  live = torch.ones_like(r, dtype=torch.bool)
  failed = torch.zeros_like(live)
  for _ in range(_QCQP_ITERATIONS):
    l, ok = factor(la)
    v = -_solve_small(l, b_s)
    val = torch.sum(v * v, dim=-1) - r * r
    deriv = -2.0 * torch.sum(v * _solve_small(l, v), dim=-1)
    delta = -val / torch.where(deriv == 0, -1.0, deriv)
    done = (val < 1e-10) | (delta < 1e-10)
    la = torch.where(live & ~done & ok, la + delta, la)
    failed = failed | (live & ~ok)
    live = live & ~done & ok
    if not bool(live.any()):
      break
  l, ok = factor(la)
  v = torch.where((ok & ~failed)[:, None], -_solve_small(l, b_s), 0.0)
  # on the constraint: back onto the ellipse
  scl = torch.sqrt(r * r / torch.clamp(torch.sum(v * v, dim=-1),
                                       min=math.MINVAL))
  return v * mu * torch.where(la != 0, scl, 1.0)[:, None]


def _put(force: torch.Tensor, start: int, new: torch.Tensor) -> torch.Tensor:
  """``force`` with the columns start:start + width replaced by ``new``,
  out of place."""
  return torch.cat([force[:, :start], new, force[:, start + new.shape[1]:]],
                   dim=1)


def noslip(m: Model, d: Data, ar_b: tuple | None = None) -> Data:
  """The noslip pass (``mj_solNoSlip``) from ``d.efc_force``: at most
  ``noslip_iterations`` sweeps, a lane ending where a sweep's scaled
  improvement falls below ``noslip_tolerance`` (the first sweep's counts
  the regularization's energy ½ Σ R f² too, as C's).  ``ar_b`` is
  ``dual(m, d)`` where the caller has it already (after PGS, as C shares
  efc_AR).  Returns ``d`` with the friction forces, ``qfrc_constraint``
  and ``qacc`` (and its warm start) updated."""
  units = m.memo("noslip_units", lambda: _units(m))
  if not units:
    return d
  ar, b = dual(m, d) if ar_b is None else ar_b
  r = d.efc_R
  diag_nor = torch.clamp(torch.diagonal(ar, dim1=-2, dim2=-1) - r,
                         min=math.MINVAL)
  friction = d.contact.friction if collision.contact_layout(m).ncon else None
  scale = 1.0 / (m.stat_meaninertia * max(1, m.nv))

  def sweep(force):
    imp = torch.zeros_like(force[:, 0])
    for u in units:
      rows = slice(u.start, u.start + u.width)
      fold = force[:, rows]
      res = (b[:, rows] + math.matvec(ar[:, rows], force)
             - r[:, rows] * fold)
      if u.kind == "dry":
        floss = d.efc_frictionloss[:, u.start]
        a = diag_nor[:, u.start]
        f = torch.clamp(fold[:, 0] - res[:, 0] / a, min=-floss, max=floss)
        delta = f - fold[:, 0]
        imp = imp - (0.5 * delta * delta * a + delta * res[:, 0])
        force = _put(force, u.start, f[:, None])
        continue
      ac = ar[:, rows, rows] - torch.diag_embed(r[:, rows])
      ac = ac + torch.diag_embed(
          torch.clamp(torch.diagonal(ac, dim1=-2, dim2=-1), min=1e-10)
          - torch.diagonal(ac, dim1=-2, dim2=-1))
      bc = res - math.matvec(ac, fold)
      if u.kind == "pyramid":
        mid = 0.5 * (fold[:, 0] + fold[:, 1])
        k1 = ac[:, 0, 0] + ac[:, 1, 1] - ac[:, 0, 1] - ac[:, 1, 0]
        k0 = mid * (ac[:, 0, 0] - ac[:, 1, 1]) + bc[:, 0] - bc[:, 1]
        flat = k1 < math.MINVAL
        y = -k0 / torch.where(flat, 1.0, k1)
        y = torch.where(flat, 0.0, torch.minimum(torch.maximum(y, -mid), mid))
        new = torch.stack([mid + y, mid - y], dim=-1)
      else:
        normal = force[:, u.normal]
        mu = friction[:, u.slot, :u.width]
        new = torch.where((normal < math.MINVAL)[:, None], 0.0,
                          qcqp(ac, bc, mu, normal))
      # C's costChange: a block update that would raise the cost is undone
      delta = new - fold
      change = (0.5 * torch.sum(delta * math.matvec(ac, delta), dim=-1)
                + torch.sum(delta * res, dim=-1))
      keep = change <= 1e-10
      imp = imp - torch.where(keep, change, 0.0)
      force = _put(force, u.start, torch.where(keep[:, None], new, fold))
    return force, imp * scale

  force = d.efc_force
  reg = 0.5 * torch.sum(force * force * r, dim=-1) * scale
  force, imp = sweep(force)
  imp = imp + reg
  niter = torch.ones_like(d.solver_niter)
  live = imp >= m.opt.noslip_tolerance
  for _ in range(1, m.opt.noslip_iterations):
    if not bool(live.any()):
      break
    new, imp_new = sweep(force)
    force = torch.where(live[:, None], new, force)
    niter = niter + live.to(niter.dtype)
    live = live & (imp_new >= m.opt.noslip_tolerance)
  qfrc = math.matvec(d.efc_J.transpose(1, 2), force)
  qacc = d.qacc_smooth + smooth.solve_m(m, d, qfrc)
  return d.replace(efc_force=force, qfrc_constraint=qfrc, qacc=qacc,
                   qacc_warmstart=qacc, solver_niter=d.solver_niter + niter)
