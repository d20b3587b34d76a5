"""Constraint solvers: primal Newton and Polak-Ribière CG with an exact line
search, and the dispatch to PGS and the noslip pass.

Port of the JAX package's ``ops/solver.py`` (``mj_solNewton``,
``mj_solCG``).  The primal solve minimizes, per lane,

    cost(qacc) = 0.5 (qacc - qacc_smooth)' M (qacc - qacc_smooth)
                 + sum_i s_i(J_i qacc - aref_i)

The JAX package runs the Newton iterations and the line search as
``lax.while_loop``s under ``vmap``: every lane keeps iterating until its own
condition fails, then stays frozen while the others go on.  Here each loop
runs over the whole fleet with a per-lane ``live`` mask that freezes a lane
exactly where the vmapped loop would, and the loop ends when no lane is
live.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    Model,
    SolverType,
)
from mujoco_inversedynamicstest_tpu_torch.ops import constraint, linalg, math
from mujoco_inversedynamicstest_tpu_torch.ops import noslip, smooth


def stat_cap(m: Model) -> int:
  """Length of the per-iteration solver-stat trace."""
  return max(1, min(int(m.opt.iterations), 32))


@dataclasses.dataclass
class _State:
  """Solver iterate; every field has the fleet dimension first."""
  qacc: torch.Tensor
  Ma: torch.Tensor
  jaref: torch.Tensor
  efc_force: torch.Tensor
  qfrc_constraint: torch.Tensor
  quad_mask: torch.Tensor
  cost: torch.Tensor
  prev_cost: torch.Tensor
  grad: torch.Tensor
  mgrad: torch.Tensor
  search: torch.Tensor
  niter: torch.Tensor
  lineslope: torch.Tensor
  stats: torch.Tensor


def solver_tolerance(m: Model, dtype: torch.dtype) -> float:
  """``opt.tolerance``, floored at 10 ulp of ``dtype``: below that the
  cost and slope comparisons are float noise."""
  return max(m.opt.tolerance, 10 * torch.finfo(dtype).eps)


def _select(live: torch.Tensor, new, old):
  """Per-lane choice between two states (the batched while-loop carry)."""
  pick = lambda a, b: torch.where(live.reshape((-1,) + (1,) * (a.ndim - 1)),
                                  a, b)
  return type(old)(**{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                      for f in dataclasses.fields(old)})


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _gauss_cost(d: Data, qacc, ma):
  return 0.5 * _dot(ma - d.qfrc_smooth, qacc - d.qacc_smooth)


def _eval_state(m: Model, d: Data, qacc, with_grad: bool) -> _State:
  ma = smooth.mul_m(m, d, qacc)
  jaref = math.matvec(d.efc_J, qacc) - d.efc_aref
  force, ccost, quad = constraint.forces_cost(m, d, jaref)
  zero = torch.zeros_like(qacc)
  st = _State(
      qacc=qacc, Ma=ma, jaref=jaref, efc_force=force,
      qfrc_constraint=math.matvec(d.efc_J.transpose(1, 2), force),
      quad_mask=quad, cost=ccost + _gauss_cost(d, qacc, ma),
      prev_cost=torch.full_like(ccost, float("inf")),
      grad=zero, mgrad=zero, search=zero,
      niter=torch.zeros(d.batch, dtype=torch.int32, device=qacc.device),
      lineslope=torch.zeros_like(ccost),
      stats=qacc.new_zeros((d.batch, stat_cap(m), 3)),
  )
  if with_grad:
    st = _refresh_gradient(m, d, st)
    st.search = -st.mgrad
  return st


def _refresh_gradient(m: Model, d: Data, st: _State,
                      newton: bool | None = None) -> _State:
  """grad = M qacc - qfrc_smooth - qfrc_constraint, preconditioned through
  the Cholesky kernels: under Newton by the exact Hessian ``M + Jᵀ diag(D ·
  quad) J``, plus each elliptic slot's cone block ``J_cᵀ H_c J_c`` in its
  middle zone (C's ``HessianCone``); under CG by M (``mj_solveM``).
  ``newton`` overrides the model's solver."""
  grad = st.Ma - d.qfrc_smooth - st.qfrc_constraint
  if newton is None:
    newton = m.opt.solver == SolverType.NEWTON
  if not newton:
    return dataclasses.replace(st, grad=grad,
                               mgrad=smooth.solve_m(m, d, grad))
  dd = d.efc_D * st.quad_mask
  # a plain fp32/fp64 matmul: TF32 stays off (see chip_smoke.py)
  hess = d.qM + torch.matmul(d.efc_J.transpose(1, 2) * dd[:, None, :],
                             d.efc_J)
  ct = constraint.cone_tables(m)
  if ct.nes:
    hc = constraint.cone_hessian(m, constraint.cone_quantities(m, d,
                                                              st.jaref))
    jc = (d.efc_J[:, m.const(ct.rows)]
          * m.const(ct.rmask.astype(float))[..., None])   # (B, nes, 6, nv)
    hess = hess + torch.matmul(jc.flatten(1, 2).transpose(1, 2),
                               torch.matmul(hc, jc).flatten(1, 2))
  hess = 0.5 * (hess + hess.transpose(1, 2))
  mgrad = linalg.chol_solve(linalg.chol_factor(hess), grad)
  return dataclasses.replace(st, grad=grad, mgrad=mgrad)


def line_phi(m: Model, d: Data, st: _State):
  """The total cost along ``st.search``, phi(alpha), piecewise quadratic
  in alpha (B,): returns (phi, M search, J search), where phi(alpha) is the
  (B, 4) line-search point alpha, cost, phi', phi''."""
  mv = smooth.mul_m(m, d, st.search)
  jv = math.matvec(d.efc_J, st.search)
  quad_gauss = torch.stack([
      _gauss_cost(d, st.qacc, st.Ma),
      _dot(st.search, st.Ma - d.qfrc_smooth),
      0.5 * _dot(st.search, mv),
  ], dim=-1)                                              # (B, 3)
  quad_rows = torch.stack([
      0.5 * d.efc_D * st.jaref * st.jaref,
      d.efc_D * jv * st.jaref,
      0.5 * d.efc_D * jv * jv,
  ], dim=-1)                                              # (B, nefc, 3)

  # a friction row in a linear zone costs -R floss^2 / 2 ∓ floss x at
  # x = jaref + alpha jv, a polynomial in alpha
  lin_rows = None
  if constraint.row_layout(m).nf:
    floss = d.efc_frictionloss
    zero = torch.zeros_like(jv)
    half = -0.5 * d.efc_R * floss * floss
    lin_rows = (torch.stack([half - floss * st.jaref, -floss * jv, zero],
                            dim=-1),
                torch.stack([half + floss * st.jaref, floss * jv, zero],
                            dim=-1))

  def row_terms(x):
    quad, lin_neg, lin_pos = constraint.zones(m, d, x)
    rows = torch.where(quad[..., None], quad_rows, 0.0)
    if lin_rows is not None:
      rows = torch.where(lin_neg[..., None], lin_rows[0], torch.where(
          lin_pos[..., None], lin_rows[1], rows))
    return rows

  cone = _cone_line(m, d, st, jv, quad_rows)

  def phi(alpha):
    x = st.jaref + alpha[:, None] * jv
    total = quad_gauss + torch.sum(row_terms(x), dim=1)
    mid = None
    if cone is not None:
      bottom, mid = cone(alpha)
      total = total + bottom
    cost = total[:, 0] + alpha * total[:, 1] + alpha * alpha * total[:, 2]
    d0 = total[:, 1] + 2 * alpha * total[:, 2]
    d1 = 2 * total[:, 2]
    if mid is not None:
      cost, d0, d1 = cost + mid[:, 0], d0 + mid[:, 1], d1 + mid[:, 2]
    d1 = d1 + (d1 == 0) * math.MINVAL
    return torch.stack([alpha, cost, d0, d1], dim=-1)

  return phi, mv, jv


def _cone_line(m: Model, d: Data, st: _State, jv, quad_rows):
  """The elliptic slots' part of phi(alpha) (C's ``CGprepare`` and
  ``CGeval``), None without them: a function of alpha (B,) giving the
  bottom-zone slots' summed row quadratics as (B, 3) coefficients in
  alpha, and the middle-zone slots' (B, 3) cost, phi' and phi''.  Each
  slot's zone is that of N(alpha) = U_0 + alpha V_0 and
  T(alpha)^2 = UU + alpha (2 UV + alpha VV), with V = J search in the cone's
  coordinates."""
  ct = constraint.cone_tables(m)
  if not ct.nes:
    return None
  c = constraint.cone_quantities(m, d, st.jaref)
  rmask = m.const(ct.rmask.astype(float))
  rows = m.const(ct.rows)
  v = jv[:, rows] * rmask * c.coef
  u0, v0, mu, dm = c.U[..., 0], v[..., 0], c.mu, c.Dm
  uu = torch.sum(c.U[..., 1:] ** 2, dim=-1)
  uv = torch.sum(c.U[..., 1:] * v[..., 1:], dim=-1)
  vv = torch.sum(v[..., 1:] ** 2, dim=-1)
  slot_quad = torch.sum(quad_rows[:, rows] * rmask[..., None], dim=2)

  def terms(alpha):
    a = alpha[:, None]
    n = u0 + a * v0
    tsqr = uu + a * (2 * uv + a * vv)
    no_t = tsqr <= math.MINVAL**2
    t = torch.sqrt(torch.clamp(tsqr, min=math.MINVAL**2))
    top = (n >= mu * t) | (no_t & (n >= 0))
    bottom = ((mu * n + t <= 0) & ~top) | (no_t & (n < 0))
    middle = ~top & ~bottom
    nmt = n - mu * t
    t1 = (uv + a * vv) / t
    t2 = vv / t - (uv + a * vv) * t1 / (t * t)
    slope = v0 - mu * t1
    mid = torch.stack([0.5 * dm * nmt * nmt, dm * nmt * slope,
                       dm * (slope * slope - nmt * mu * t2)], dim=-1)
    return (torch.sum(torch.where(bottom[..., None], slot_quad, 0.0), dim=1),
            torch.sum(torch.where(middle[..., None], mid, 0.0), dim=1))

  return terms


def _linesearch(m: Model, d: Data, st: _State) -> _State:
  """Exact line search along ``st.search`` (``CGsearch``): phi(alpha) of
  ``line_phi`` is piecewise quadratic; a bracket [lo, hi] on phi' shrinks
  by safeguarded Newton steps for at most ``ls_iterations`` rounds per
  lane.

  A line-search point is a (B, 4) tensor: alpha, cost, phi', phi''.
  """
  phi, mv, jv = line_phi(m, d, st)

  def newton(p):
    return p[:, 0] - p[:, 2] / p[:, 3]

  def pick(mask, new, old):
    return torch.where(mask[:, None], new, old)

  smag = math.norm_safe(st.search) * m.stat_meaninertia * max(1, m.nv)
  # the solver's tolerance, floored as solve floors it: below ~10 ulp a
  # slope is float noise, and an fp32 lane on the cone's curved phi would
  # otherwise bisect for all ls_iterations rounds (fp64 keeps C's)
  gtol = solver_tolerance(m, smag.dtype) * m.opt.ls_tolerance * smag

  p0 = phi(torch.zeros_like(smag))
  pn = phi(newton(p0))
  pick_pn = pn[:, 2] < p0[:, 2]
  lo = pick(pick_pn, pn, p0)
  hi = pick(pick_pn, p0, pn)

  def joins_lo(cur, new):
    # the lower end holds a slope <= 0, the upper end a slope > 0.  A
    # candidate on an end's side replaces it if its slope lies nearer zero,
    # or if the end is on the wrong side (both starting points can have a
    # slope of one sign).  A slope of exactly zero (the minimum of a
    # quadratic piece) joins the lower end, which then counts as converged.
    # The JAX package's test is strict and has no wrong-side rule: it
    # rejects an exact minimum, keeps bisecting, and leaves some contact
    # states off C MuJoCo's qacc by ~1e-7; and where the minimum's slope
    # rounds to a positive value while both ends' slopes are negative, it
    # keeps the Newton point of alpha = 0, so the step jumps with the last
    # bit of its inputs where C's does not (ROADMAP queue 3;
    # tests/test_torch_step.py, tests/test_torch_opt.py).
    return (new <= 0) & ((cur < new) | (cur > 0))

  def joins_hi(cur, new):
    return (new > 0) & ((cur > new) | (cur <= 0))

  live = torch.ones_like(pick_pn)
  for _ in range(m.opt.ls_iterations):
    if not bool(live.any()):
      break
    cand_lo = phi(newton(lo))
    cand_hi = phi(newton(hi))
    cand_mid = phi(0.5 * (lo[:, 0] + hi[:, 0]))
    moved = torch.zeros_like(live)
    new_lo, new_hi = lo, hi
    for cand in (cand_lo, cand_mid, cand_hi):
      take = joins_lo(new_lo[:, 2], cand[:, 2])
      new_lo = pick(take, cand, new_lo)
      moved = moved | take
    for cand in (cand_hi, cand_mid, cand_lo):
      take = joins_hi(new_hi[:, 2], cand[:, 2])
      new_hi = pick(take, cand, new_hi)
      moved = moved | take
    done = ~moved
    done |= (new_lo[:, 2] <= 0) & (new_lo[:, 2] > -gtol)
    done |= (new_hi[:, 2] > 0) & (new_hi[:, 2] < gtol)
    lo = pick(live, new_lo, lo)
    hi = pick(live, new_hi, hi)
    live = live & ~done

  improved = (lo[:, 1] <= p0[:, 1]) | (hi[:, 1] <= p0[:, 1])
  lo_best = lo[:, 1] < hi[:, 1]
  alpha = torch.where(lo_best, lo[:, 0], hi[:, 0]) * improved
  return dataclasses.replace(
      st,
      qacc=st.qacc + alpha[:, None] * st.search,
      Ma=st.Ma + alpha[:, None] * mv,
      jaref=st.jaref + alpha[:, None] * jv,
      lineslope=torch.where(lo_best, lo[:, 2], hi[:, 2]) * improved,
  )


def _has_tangent(st: _State) -> bool:
  """Whether the iterate carries a forward-mode tangent."""
  return any(fwAD.unpack_dual(x).tangent is not None
             for x in (st.qacc, st.search))


def _newton_tangent(m: Model, d: Data, st: _State,
                    met: torch.Tensor) -> _State:
  """Under forward-mode AD, gives qacc of the lanes ``met`` (B,), those
  whose solve met its tolerance, the tangent of one full Newton step from
  the final iterate, and the constraint forces the matching tangent; the
  primal values stay as they are, to the bit.  The other lanes stopped at
  the iteration limit, and keep the tangent of their iterations: the
  derivative of the map the solve computes, as the JAX package's
  ``jacfwd`` takes it.

  The iterate's own tangent is not the minimizer's where the solve starts
  from a converged warm start (``forward`` leaves one, and
  ``transition_ad`` steps from it): the loop's one iteration moves qacc by
  a line-search step along a search direction of round-off size, so qacc
  keeps the warm start's tangent, zero, plus that step's.  (The JAX
  package's ``jacfwd``, whose loop takes no step there, is far from C:
  ROADMAP queue 3.)  With g the
  gradient and H the exact Hessian at the final qacc, T its tangent, the
  step qacc - H⁻¹ g has the tangent T - d(H⁻¹ g) = -H⁻¹ (∂g/∂p) dp -
  d(H⁻¹) g, the implicit-function derivative of the minimizer when g = 0
  (to first order in g otherwise), whatever T was.  Without a dual level
  the state is returned unchanged.
  """
  qacc, t_qacc = fwAD.unpack_dual(st.qacc)
  t_search = fwAD.unpack_dual(st.search).tangent
  if t_qacc is None and t_search is None:
    return st
  tangent = sum(t for t in (t_qacc, t_search) if t is not None)
  newton = fwAD.make_dual(qacc, tangent)
  jaref = math.matvec(d.efc_J, newton) - d.efc_aref
  force = constraint.forces_cost(m, d, jaref)[0]
  qfrc = math.matvec(d.efc_J.transpose(1, 2), force)

  def retangent(own, dual):
    lane = met.reshape((-1,) + (1,) * (own.ndim - 1))
    return torch.where(lane, fwAD.make_dual(fwAD.unpack_dual(own).primal,
                                            fwAD.unpack_dual(dual).tangent),
                       own)

  return dataclasses.replace(st, qacc=retangent(st.qacc, newton),
                             efc_force=retangent(st.efc_force, force),
                             qfrc_constraint=retangent(st.qfrc_constraint,
                                                       qfrc))


def solve(m: Model, d: Data) -> Data:
  """The primal solver loop: ``mj_solNewton``, or ``mj_solCG`` under the CG
  solver, whose search direction is Polak-Ribière's on the M-preconditioned
  gradient, reset to steepest descent where its beta is negative."""
  if not m.opt.disableflags & DisableBit.WARMSTART:
    warm = _eval_state(m, d, d.qacc_warmstart, with_grad=False)
    smth = _eval_state(m, d, d.qacc_smooth, with_grad=False)
    qacc0 = torch.where((warm.cost < smth.cost)[:, None], d.qacc_warmstart,
                        d.qacc_smooth)
  else:
    qacc0 = d.qacc_smooth
  st = _eval_state(m, d, qacc0, with_grad=True)

  tol = solver_tolerance(m, qacc0.dtype)
  scale = m.stat_meaninertia * max(1, m.nv)

  def met(st):
    improvement = (st.prev_cost - st.cost) / scale
    gradient = math.norm_safe(st.grad) / scale
    return (improvement < tol) | (gradient < tol)

  def live(st):
    return ~((st.niter >= m.opt.iterations) | met(st))

  cg = m.opt.solver == SolverType.CG

  def iterate(st: _State) -> _State:
    st = _linesearch(m, d, st)
    prev_grad, prev_mgrad = st.grad, st.mgrad
    force, ccost, quad = constraint.forces_cost(m, d, st.jaref)
    st = dataclasses.replace(
        st, efc_force=force,
        qfrc_constraint=math.matvec(d.efc_J.transpose(1, 2), force),
        quad_mask=quad, cost=ccost + _gauss_cost(d, st.qacc, st.Ma),
        prev_cost=st.cost)
    st = _refresh_gradient(m, d, st)
    search = -st.mgrad
    if cg:
      beta = _dot(st.grad, st.mgrad - prev_mgrad) / torch.clamp(
          _dot(prev_grad, prev_mgrad), min=math.MINVAL)
      search = search + torch.clamp(beta, min=0.0)[:, None] * st.search
    row = torch.stack([(st.prev_cost - st.cost) / scale,
                       math.norm_safe(st.grad) / scale,
                       st.lineslope / scale], dim=-1)
    # past the trace capacity the write is a no-op
    slot = torch.arange(st.stats.shape[1], device=row.device)
    at = (slot[None, :] == st.niter[:, None])[..., None]
    return dataclasses.replace(
        st, search=search, niter=st.niter + 1,
        stats=torch.where(at, row[:, None, :], st.stats))

  # as C's mj_solNewton: one iteration before the first convergence test,
  # and none on a lane with no constraint row (C's nefc = 0), whose qacc is
  # qacc_smooth (its constraint force is zero already: every row inactive)
  rows = d.efc_active.any(dim=-1)
  st = iterate(st)
  if m.opt.iterations > 1:
    alive = live(st) & rows
    while bool(alive.any()):
      st = _select(alive, iterate(st), st)
      alive = live(st) & rows
  if cg and _has_tangent(st):
    # a converged CG iterate is Newton's optimum: its tangent is that of a
    # Newton step from it (_newton_tangent), along the Newton direction
    st = _refresh_gradient(m, d, st, newton=True)
    st = dataclasses.replace(st, search=-st.mgrad)
  st = _newton_tangent(m, d, st, met(st))

  lane = rows[:, None]
  qacc = torch.where(lane, st.qacc, d.qacc_smooth)
  return d.replace(qacc=qacc, qacc_warmstart=qacc,
                   qfrc_constraint=st.qfrc_constraint, efc_force=st.efc_force,
                   solver_niter=torch.where(rows, st.niter, 0),
                   solver_stat=torch.where(lane[..., None], st.stats, 0.0))


def fwd_constraint(m: Model, d: Data) -> Data:
  """Constraint forces and final qacc (``mj_fwdConstraint``): PGS
  (``ops/pgs.py``) or the primal solve, then the noslip pass
  (``ops/noslip.py``) where ``noslip_iterations`` > 0."""
  if constraint.row_layout(m).nefc == 0:
    return d.replace(qacc=d.qacc_smooth,
                     qfrc_constraint=torch.zeros_like(d.qacc_smooth),
                     qacc_warmstart=d.qacc_smooth,
                     solver_niter=torch.zeros(d.batch, dtype=torch.int32,
                                              device=d.qacc_smooth.device))
  ar_b = None
  if m.opt.solver == SolverType.PGS:
    # pgs imports this module
    from mujoco_inversedynamicstest_tpu_torch.ops import pgs

    # PGS and noslip share the dual matrix, as C's efc_AR
    if m.opt.noslip_iterations > 0:
      ar_b = noslip.dual(m, d)
    d = pgs.pgs(m, d, ar_b)
  else:
    d = solve(m, d)
  if m.opt.noslip_iterations > 0:
    d = noslip.noslip(m, d, ar_b)
  return d
