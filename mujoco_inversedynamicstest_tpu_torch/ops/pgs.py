"""Dual projected Gauss-Seidel solver (``mj_solPGS``).

Port of the JAX package's ``ops/pgs.py``.  PGS solves the dual
problem: minimize ½ fᵀ AR f + fᵀ b over the constraint forces f, with AR =
J M⁻¹ Jᵀ + diag(R) and b = J qacc_smooth - aref (``noslip.dual``), each
force feasible: equality rows free, friction-loss rows within
±frictionloss, limit rows and pyramidal (or frictionless) contact rows
non-negative, an elliptic contact's block inside its friction cone (the
normal's update or a ray update, then the friction's QCQP at the new
normal, ``noslip.qcqp``).

The Gauss-Seidel sweep is sequential over its units: a host loop over the
static unit table, each unit updated in all lanes at once; sweeps run
under a per-lane ``live`` mask (C's improvement test) until no lane is
live.  The sweeps run on the primal values only: under forward-mode AD the
solution's tangent is that of a Newton step from the result on every lane
(``solver._newton_tangent``), the derivative of the optimum both solvers
reach.  A lane that reached the iteration limit has no differentiated
sweeps to keep: its tangent is the same Newton step's from where the
sweeps stopped, exact to first order in the gradient there.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import math, noslip, smooth
from mujoco_inversedynamicstest_tpu_torch.ops import solver


def _units(m: Model) -> tuple:
  """The sweep's units in efc order: every row but an elliptic contact's a
  scalar ("free" equality, "boxed" friction loss, "lower" limits and
  pyramidal or frictionless contacts), an elliptic contact's rows one
  "elliptic" block."""
  lay = constraint.row_layout(m)
  units = ([noslip.Unit("free", r, 1) for r in range(lay.ne)]
           + [noslip.Unit("boxed", r, 1)
              for r in range(lay.ne, lay.ne + lay.nf)]
           + [noslip.Unit("lower", r, 1)
              for r in range(lay.ne + lay.nf, lay.ncon_start)])
  dim = collision.contact_layout(m).dim
  for s, adr in enumerate(noslip.contact_rows(m)):
    if dim[s] > 1 and constraint.elliptic(m):
      units.append(noslip.Unit("elliptic", int(adr), int(dim[s]), s))
    else:
      n = 1 if dim[s] == 1 else 2 * (dim[s] - 1)
      units += [noslip.Unit("lower", int(adr) + k, 1) for k in range(n)]
  return tuple(units)


def _primal(d: Data) -> Data:
  """``d`` with the fields PGS reads as plain tensors (their primal
  values under forward-mode AD)."""
  p = lambda x: None if x is None else fwAD.unpack_dual(x).primal
  return d.replace(
      efc_J=p(d.efc_J), efc_R=p(d.efc_R), efc_aref=p(d.efc_aref),
      efc_D=p(d.efc_D), efc_frictionloss=p(d.efc_frictionloss),
      efc_KBIP=p(d.efc_KBIP), qacc_smooth=p(d.qacc_smooth),
      qfrc_smooth=p(d.qfrc_smooth), qLD=p(d.qLD), qM=p(d.qM),
      qacc_warmstart=p(d.qacc_warmstart),
      contact=dataclasses.replace(d.contact, **{
          f.name: p(getattr(d.contact, f.name))
          for f in dataclasses.fields(d.contact)}) if d.contact else None)


def initial_force(m: Model, d: Data, ar: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
  """The sweeps' start (C's ``warmstart`` for PGS): the constraint forces
  at ``qacc_warmstart``, or zero where their dual cost ½ fᵀ AR f + fᵀ b is
  positive; zero without warm start.  (The JAX package starts from the
  forces at ``qacc_warmstart`` or at ``qacc_smooth``, whichever has the
  lower constraint cost; from the latter an elliptic contact's ray update
  can stall at a point that is not the optimum, where C's sweeps from zero
  reach it: tests/test_torch_solvers.py.)"""
  if m.opt.disableflags & DisableBit.WARMSTART:
    return torch.zeros_like(b)
  jar = math.matvec(d.efc_J, d.qacc_warmstart) - d.efc_aref
  force = constraint.forces_cost(m, d, jar)[0]
  cost = torch.sum(force * (0.5 * math.matvec(ar, force) + b), dim=-1)
  return torch.where((cost > 0)[:, None], 0.0, force)


def pgs(m: Model, d: Data, dual: tuple | None = None) -> Data:
  """PGS from the warm start's forces: at most ``iterations`` sweeps, a lane
  ending once a sweep's scaled improvement falls below the tolerance
  (``solver.solver_tolerance``); each sweep's improvement goes to
  ``solver_stat``.  ``dual`` is ``noslip.dual(m, d)`` where the caller
  has it already (the noslip pass shares it).  Returns ``d`` with
  efc_force, qfrc_constraint, qacc (and its warm start), solver_niter and
  solver_stat."""
  units = m.memo("pgs_units", lambda: _units(m))
  full = d
  d = _primal(d)
  if dual is None:
    ar, b = noslip.dual(m, d)
  else:
    ar, b = (fwAD.unpack_dual(x).primal for x in dual)
  diag = torch.clamp(torch.diagonal(ar, dim1=-2, dim2=-1), min=math.MINVAL)
  friction = d.contact.friction if collision.contact_layout(m).ncon else None
  scale = 1.0 / (m.stat_meaninertia * max(1, m.nv))
  force = initial_force(m, d, ar, b)

  def sweep(force):
    imp = torch.zeros_like(force[:, 0])
    for u in units:
      r = u.start
      if u.kind != "elliptic":
        fold = force[:, r]
        res = b[:, r] + torch.sum(ar[:, r] * force, dim=-1)
        f = fold - res / diag[:, r]
        if u.kind == "boxed":
          floss = d.efc_frictionloss[:, r]
          f = torch.minimum(torch.maximum(f, -floss), floss)
        elif u.kind == "lower":
          f = torch.clamp(f, min=0.0)
        delta = f - fold
        imp = imp - delta * (0.5 * delta * ar[:, r, r] + res)
        force[:, r] = f
        continue
      rows = slice(r, r + u.width)
      a = ar[:, rows, rows]
      fold = force[:, rows].clone()
      res = b[:, rows] + math.matvec(ar[:, rows], force)
      fn = fold[:, 0]
      # the normal alone where the force is 0, else the normal of a ray
      # update of the whole force that keeps it non-negative
      fn_alone = torch.clamp(fn - res[:, 0] / diag[:, r], min=0.0)
      denom = torch.sum(fold * math.matvec(a, fold), dim=-1)
      small = denom < math.MINVAL
      x = torch.where(small, 0.0, -torch.sum(fold * res, dim=-1)
                      / torch.where(small, 1.0, denom))
      x = torch.where(fn + x * fn < 0, -1.0, x)
      zero = fn < math.MINVAL
      fn_new = torch.where(zero, fn_alone, fn * (1.0 + x))
      # the friction's QCQP at the new normal
      ac = a[:, 1:, 1:]
      bc = (res[:, 1:] - math.matvec(ac, fold[:, 1:])
            + a[:, 1:, 0] * (fn_new - fn)[:, None])
      mu = friction[:, u.slot, :u.width - 1]
      fric = torch.where((fn_new < math.MINVAL)[:, None], 0.0,
                         noslip.qcqp(ac, bc, mu, fn_new))
      new = torch.cat([fn_new[:, None], fric], dim=-1)
      delta = new - fold
      imp = imp - (0.5 * torch.sum(delta * math.matvec(a, delta), dim=-1)
                   + torch.sum(delta * res, dim=-1))
      force[:, rows] = new
    return imp * scale

  tol = solver.solver_tolerance(m, force.dtype)
  stats = force.new_zeros((d.batch, solver.stat_cap(m), 3))
  slot = torch.arange(stats.shape[1], device=force.device)
  niter = torch.zeros(d.batch, dtype=torch.int32, device=force.device)
  live = torch.ones_like(niter, dtype=torch.bool)
  for _ in range(m.opt.iterations):
    if not bool(live.any()):
      break
    prev = force.clone()
    imp = sweep(force)
    force = torch.where(live[:, None], force, prev)
    at = (slot[None, :] == niter[:, None]) & live[:, None]
    stats[..., 0] = torch.where(at, imp[:, None], stats[..., 0])
    niter = niter + live.to(niter.dtype)
    live = live & (imp >= tol)

  qfrc = math.matvec(d.efc_J.transpose(1, 2), force)
  qacc = d.qacc_smooth + smooth.solve_m(m, d, qfrc)
  out = full.replace(efc_force=force, qfrc_constraint=qfrc, qacc=qacc,
                     qacc_warmstart=qacc, solver_niter=niter,
                     solver_stat=stats)
  return _tangent(m, full, out)


def _tangent(m: Model, d: Data, out: Data) -> Data:
  """Under forward-mode AD, ``out`` with the tangents of a Newton step from
  PGS's qacc on every lane (``solver._newton_tangent``), those that met
  the tolerance and those that reached the iteration limit alike: the
  sweeps carry no tangent of their own; unchanged without a tangent."""
  if fwAD.unpack_dual(d.efc_J).tangent is None and (
      fwAD.unpack_dual(d.qacc_smooth).tangent is None):
    return out
  st = solver._eval_state(m, d, out.qacc, with_grad=False)
  st = solver._refresh_gradient(m, d, st, newton=True)
  st = dataclasses.replace(st, search=-st.mgrad)
  st = solver._newton_tangent(m, d, st, torch.ones_like(out.solver_niter,
                                                       dtype=torch.bool))
  return out.replace(qacc=st.qacc, qacc_warmstart=st.qacc,
                     efc_force=st.efc_force,
                     qfrc_constraint=st.qfrc_constraint)
