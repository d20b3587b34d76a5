"""iLQR trajectory optimization for a fleet of problems.

Port of the JAX package's ``opt/ilqr.py``.  The JAX package
solves one problem and ``vmap``s it over the fleet; here the fleet F is the
leading dimension of everything:

* ``_forward_pass`` rolls out all F n_alpha (problem, step size) lanes in
  one ``step`` a timestep, as the JAX package's vmap-in-vmap does;
* ``_linearize`` runs chunks of ``lin_batch`` timesteps x F problems, each
  a ``forward`` and one dual ``step`` of those lin_batch F lanes with nx +
  nu tangents each (``derivative.transition_ad``); ``lin_batch=None``
  takes all T at once;
* the iteration and regularization ``while_loop``s become loops under
  per-lane masks (a lane that is done freezes, as the vmapped loop
  selects), and the backward ``scan`` a Python loop over T;
* costs keep the JAX signature ``cost(m, state, u, t)`` for one sample and
  are batched with ``torch.func.vmap``, ``grad`` and ``hessian``.

``lqr_gain`` is the infinite-horizon LQR gain of the balance recipe
(``scripts/balance.py``), by the JAX package's Riccati iteration, one per lane.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import func

from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.opt import derivative, qp


class State(NamedTuple):
  """Trajectory state samples (the mjSTATE_PHYSICS triple); ``act`` has
  width na."""
  qpos: torch.Tensor
  qvel: torch.Tensor
  act: torch.Tensor


# cost(m, state, u, t, *args) -> scalar for ONE sample (qpos (nq,), qvel
# (nv,), act (na,), u (nu,), t a 0-d tensor, and the sample's problem's row
# of each of ilqr's cost_args); the terminal cost gets u = zeros(nu), t = T.
CostFn = Callable[[Model, State, torch.Tensor, torch.Tensor], torch.Tensor]


class ILQRConfig(NamedTuple):
  iterations: int = 30
  # parallel line-search step sizes
  n_alpha: int = 8
  alpha_decay: float = 0.5
  reg_init: float = 1e-6
  reg_min: float = 1e-8
  reg_max: float = 1e8
  reg_factor: float = 10.0
  tol_cost: float = 1e-8
  # use control limits from actuator_ctrlrange via boxQP backward pass
  limits: bool = True
  # linearization chunking: None = all T timesteps in one dual step; an int
  # c = chunks of c timesteps (c F lanes of nx + nu tangents a dual step:
  # memory bounded for big MPC fleets)
  lin_batch: Optional[int] = None
  # recompute feedback gains for the returned trajectory (an extra
  # linearization pass; only needed when the caller consumes gains_K/k)
  final_gains: bool = False


class ILQRResult(NamedTuple):
  us: torch.Tensor        # (F, T, nu) optimized controls
  xs: State               # (F, T+1, ...) optimized state trajectory
  cost: torch.Tensor      # (F,) total cost
  gains_K: torch.Tensor   # (F, T, nu, nx) feedback gains
  gains_k: torch.Tensor   # (F, T, nu) feedforward
  niter: torch.Tensor     # (F,) iterations taken
  reg: torch.Tensor       # (F,) final regularization


def _state_of(d: Data) -> State:
  return State(qpos=d.qpos, qvel=d.qvel, act=d.act)


def _stack(states) -> State:
  """A list of (F, ...) states -> (F, len, ...)."""
  return State(*(torch.stack(f, dim=1) for f in zip(*states)))


def _where(mask: torch.Tensor, new, old):
  """Per-lane choice between two (F, ...) tensors or States."""
  if isinstance(new, State):
    return State(*(_where(mask, a, b) for a, b in zip(new, old)))
  return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def rollout_open_loop(m: Model, d0: Data, us: torch.Tensor):
  """Rolls the controls (F, T, nu) out from the F lanes of ``d0``; returns
  the stacked states (F, T+1, ...) including the initial one, and the last
  Data."""
  states = [_state_of(d0)]
  d = d0
  for t in range(us.shape[1]):
    d = forward_mod.step(m, d.replace(ctrl=us[:, t]))
    states.append(_state_of(d))
  return _stack(states), d


def _samples(xs: State, T: int) -> State:
  """The first T states of each trajectory, flattened to (F T, ...)."""
  return State(*(a[:, :T].flatten(0, 1) for a in xs))


def _terminal(xs: State) -> State:
  return State(*(a[:, -1] for a in xs))


def _total_cost(m: Model, cost: CostFn, xs: State, us: torch.Tensor,
                args: tuple = ()):
  """(F,) sum over t of cost(x_t, u_t, t), plus cost(x_T, 0, T); ``args``
  are (F, ...) rows of each problem's cost arguments."""
  nf, T, nu = us.shape
  ts = torch.arange(T, dtype=us.dtype, device=us.device).repeat(nf)
  one = lambda s, u, t, *a: cost(m, s, u, t, *a)
  run = func.vmap(one)(_samples(xs, T), us.reshape(nf * T, nu), ts,
                       *(a.repeat_interleave(T, 0) for a in args))
  u_nil = us.new_zeros((nf, nu))
  t_end = us.new_full((nf,), float(T))
  terminal = func.vmap(one)(_terminal(xs), u_nil, t_end, *args)
  return run.reshape(nf, T).sum(-1) + terminal


def _quadratize_cost(m: Model, cost: CostFn, x: State, u: torch.Tensor,
                     t: torch.Tensor, args: tuple = ()):
  """Gradient + Hessian of the cost in tangent coords z = [dx; du] for a
  batch of samples: x's fields, u and the cost arguments are (N, ...), t
  (N,)."""
  nv, nu = m.nv, m.nu
  nx = derivative.state_dim(m)

  def one(qpos, qvel, act, uu, tt, *a):
    def c(z):
      dx, du = z[:nx], z[nx:]
      state = State(support.integrate_pos(m, qpos, dx[:nv], 1.0),
                    qvel + dx[nv:2 * nv], act + dx[2 * nv:])
      return cost(m, state, uu + du, tt, *a)

    z0 = uu.new_zeros(nx + nu)
    return func.grad(c)(z0), func.hessian(c)(z0)

  g, h = func.vmap(one)(x.qpos, x.qvel, x.act, u, t, *args)
  return (g[:, :nx], g[:, nx:], h[:, :nx, :nx], h[:, nx:, nx:],
          h[:, nx:, :nx])


def _linearize(m: Model, d_template: Data, xs: State, us: torch.Tensor,
               lin_batch: Optional[int] = None):
  """(A, B) for every timestep of every problem: (F, T, nx, nx), (F, T, nx,
  nu).  A chunk of c timesteps is one ``forward`` of F c lanes, whose
  solution warm-starts one dual step of the same lanes, nx + nu tangents
  each."""
  nf, T, _ = us.shape
  chunk = min(lin_batch or T, T)
  As, Bs = [], []
  for t0 in range(0, T, chunk):
    t1 = min(t0 + chunk, T)
    c = t1 - t0
    d = derivative.repeat_lanes(d_template, c).replace(
        qpos=xs.qpos[:, t0:t1].flatten(0, 1),
        qvel=xs.qvel[:, t0:t1].flatten(0, 1),
        act=xs.act[:, t0:t1].flatten(0, 1),
        ctrl=us[:, t0:t1].flatten(0, 1))
    tr = derivative.transition_ad(m, forward_mod.forward(m, d))
    As.append(tr.A.unflatten(0, (nf, c)))
    Bs.append(tr.B.unflatten(0, (nf, c)))
  return torch.cat(As, dim=1), torch.cat(Bs, dim=1)


def _mT(a: torch.Tensor) -> torch.Tensor:
  return a.transpose(-1, -2)


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  return (a @ x[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _backward(m: Model, cfg: ILQRConfig, As, Bs, lx, lu, lxx, luu, lux,
              vx_T, vxx_T, reg, u_lo, u_hi, us):
  """Riccati backward pass, a lane each; ``reg`` (F,).  Returns (k (F, T,
  nu), K (F, T, nu, nx), dV (F, 2), diverged (F,))."""
  nf, T, nx, _ = As.shape
  eye = torch.eye(nx, dtype=As.dtype, device=As.device)
  vx, vxx = vx_T, vxx_T
  bad = torch.zeros(nf, dtype=torch.bool, device=As.device)
  ks, Ks, dvs = [None] * T, [None] * T, [None] * T
  for t in range(T - 1, -1, -1):
    a, b = As[:, t], Bs[:, t]
    vxx_reg = vxx + reg[:, None, None] * eye
    qx = lx[:, t] + _mv(_mT(a), vx)
    qu = lu[:, t] + _mv(_mT(b), vx)
    qxx = lxx[:, t] + _mT(a) @ vxx @ a
    quu = luu[:, t] + _mT(b) @ vxx_reg @ b
    qux = lux[:, t] + _mT(b) @ vxx_reg @ a
    quu = 0.5 * (quu + _mT(quu))

    if cfg.limits:
      res = qp.box_qp(quu, qu, u_lo - us[:, t], u_hi - us[:, t], maxiter=20)
      k = res.x
      free = res.free.to(quu.dtype)
      kmat = -qp.cho_solve(qp.cholesky_nan(qp.masked_matrix(quu, res.free)),
                           qux * free[:, :, None])
      ok = torch.all(torch.diagonal(quu, dim1=-2, dim2=-1) > 0, dim=-1)
    else:
      lq = qp.cholesky_nan(quu)
      ok = (torch.all(torch.isfinite(lq).flatten(1), dim=-1)
            & torch.all(torch.diagonal(lq, dim1=-2, dim2=-1) > 0, dim=-1))
      sol = qp.cho_solve(lq, torch.cat([qu[:, :, None], qux], dim=2))
      k, kmat = -sol[:, :, 0], -sol[:, :, 1:]

    vx = qx + _mv(_mT(kmat) @ quu, k) + _mv(_mT(kmat), qu) + _mv(_mT(qux), k)
    vxx = qxx + _mT(kmat) @ quu @ kmat + _mT(kmat) @ qux + _mT(qux) @ kmat
    vxx = 0.5 * (vxx + _mT(vxx))
    dvs[t] = torch.stack([_dot(k, qu), 0.5 * _dot(k, _mv(quu, k))], dim=-1)
    bad = bad | ~ok
    ks[t], Ks[t] = k, kmat
  return (torch.stack(ks, 1), torch.stack(Ks, 1), torch.stack(dvs, 1).sum(1),
          bad)


def _forward_pass(m: Model, cfg: ILQRConfig, cost: CostFn, d0: Data,
                  xs: State, us: torch.Tensor, ks, Ks, u_lo, u_hi,
                  args: tuple = ()):
  """Feedback rollouts of all F n_alpha (problem, step size) lanes in one
  batch; picks each problem's best."""
  nf, T, nu = us.shape
  na = cfg.n_alpha
  alphas = cfg.alpha_decay ** torch.arange(na, dtype=us.dtype,
                                           device=us.device)
  alpha = alphas.repeat(nf)[:, None]                      # (F na, 1)
  rep = lambda a: a.repeat_interleave(na, dim=0)
  d = derivative.repeat_lanes(d0, na)
  states, controls = [_state_of(d)], []
  for t in range(T):
    x_qpos, x_qvel = rep(xs.qpos[:, t]), rep(xs.qvel[:, t])
    dx = torch.cat([support.differentiate_pos(m, x_qpos, d.qpos, 1.0),
                    d.qvel - x_qvel, d.act - rep(xs.act[:, t])], dim=-1)
    u = rep(us[:, t]) + alpha * rep(ks[:, t]) + _mv(rep(Ks[:, t]), dx)
    if cfg.limits:
      u = torch.clamp(u, u_lo, u_hi)
    d = forward_mod.step(m, d.replace(ctrl=u))
    states.append(_state_of(d))
    controls.append(u)
  xs_all = _stack(states)                                 # (F na, T+1, ...)
  us_all = torch.stack(controls, dim=1)                   # (F na, T, nu)
  costs = _total_cost(m, cost, xs_all, us_all,
                      tuple(rep(a) for a in args)).reshape(nf, na)
  best = torch.argmin(torch.where(torch.isfinite(costs), costs, torch.inf),
                      dim=1)
  pick = torch.arange(nf, device=us.device) * na + best
  return (State(*(a[pick] for a in xs_all)), us_all[pick],
          costs.gather(1, best[:, None])[:, 0])


def _control_limits(m: Model, cfg: ILQRConfig, dtype):
  if not cfg.limits:
    z = torch.zeros(m.nu, dtype=dtype, device=m.device)
    return z, z
  limited = m.const(m.actuator_ctrllimited.astype(bool))
  rng = m.actuator_ctrlrange.to(dtype)
  return (torch.where(limited, rng[:, 0], -1e10),
          torch.where(limited, rng[:, 1], 1e10))


def _quadratize_all(m: Model, cost: CostFn, xs: State, us: torch.Tensor,
                    args: tuple = ()):
  """Cost derivatives along a trajectory: (lx, lu, lxx, luu, lux) (F, T,
  ...) and the terminal (gT, hT) (F, nx), (F, nx, nx)."""
  nf, T, nu = us.shape
  ts = torch.arange(T, dtype=us.dtype, device=us.device).repeat(nf)
  parts = _quadratize_cost(m, cost, _samples(xs, T), us.flatten(0, 1), ts,
                           tuple(a.repeat_interleave(T, 0) for a in args))
  gT, _, hT, _, _ = _quadratize_cost(m, cost, _terminal(xs),
                                     us.new_zeros((nf, nu)),
                                     us.new_full((nf,), float(T)), args)
  return tuple(p.unflatten(0, (nf, T)) for p in parts), gT, hT


def ilqr(m: Model, cost: CostFn, d0: Data, us_init: torch.Tensor,
         config: Optional[ILQRConfig] = None,
         cost_args: tuple = ()) -> ILQRResult:
  """Iterative LQR for each of the F problems of a fleet:
  min_U sum_t cost(x_t, u_t, t) + cost(x_T, 0, T).

  ``d0`` holds the F initial states (qpos, qvel, act and the solver's
  warm start); ``us_init`` is (F, T, nu); ``cost_args`` are (F, ...)
  tensors, each problem's row passed to its cost (a reach target, say):
  what the JAX package gets by vmapping ilqr over a closure.
  """
  cfg = config or ILQRConfig()
  nf, T, nu = us_init.shape
  nx = derivative.state_dim(m)
  dtype, dev = us_init.dtype, us_init.device
  u_lo, u_hi = _control_limits(m, cfg, dtype)
  us = torch.clamp(us_init, u_lo, u_hi) if cfg.limits else us_init

  xs, _ = rollout_open_loop(m, d0, us)
  c_prev = _total_cost(m, cost, xs, us, cost_args)
  reg = torch.full((nf,), cfg.reg_init, dtype=dtype, device=dev)
  it = torch.zeros(nf, dtype=torch.int32, device=dev)
  done = torch.zeros(nf, dtype=torch.bool, device=dev)

  while True:
    live = ~done & (it < cfg.iterations)
    if not bool(live.any()):
      break
    As, Bs = _linearize(m, d0, xs, us, cfg.lin_batch)
    (lx, lu, lxx, luu, lux), gT, hT = _quadratize_all(m, cost, xs, us,
                                                      cost_args)

    def bw(reg_in):
      return _backward(m, cfg, As, Bs, lx, lu, lxx, luu, lux, gT, hT,
                       reg_in, u_lo, u_hi, us)

    # escalate each lane's regularization until its backward pass succeeds
    ks, Ks, _, bad = bw(reg)
    reg_used = reg
    escalate = bad & (reg_used < cfg.reg_max)
    while bool(escalate.any()):
      reg_n = torch.where(escalate, torch.clamp(reg_used * cfg.reg_factor,
                                                max=cfg.reg_max), reg_used)
      ks_n, Ks_n, _, bad_n = bw(reg_n)
      ks, Ks = _where(escalate, ks_n, ks), _where(escalate, Ks_n, Ks)
      bad = _where(escalate, bad_n, bad)
      reg_used = reg_n
      escalate = bad & (reg_used < cfg.reg_max)

    xs_new, us_new, c_new = _forward_pass(m, cfg, cost, d0, xs, us, ks, Ks,
                                          u_lo, u_hi, cost_args)

    # non-finite guard: a NaN/Inf c_new never replaces the incumbent, and a
    # non-finite incumbent is replaced by any finite plan
    improved = torch.isfinite(c_new) & (
        (c_new < c_prev - cfg.tol_cost) | ~torch.isfinite(c_prev))
    reg_next = torch.where(
        improved, torch.clamp(reg_used / cfg.reg_factor, min=cfg.reg_min),
        torch.clamp(reg_used * cfg.reg_factor, max=cfg.reg_max))
    done_next = done | (~improved & (reg_used >= cfg.reg_max)) | (
        improved & (c_prev - c_new < cfg.tol_cost * (1 + torch.abs(c_prev))))
    keep = live & improved
    xs, us = _where(keep, xs_new, xs), _where(keep, us_new, us)
    c_prev = _where(keep, c_new, c_prev)
    reg = _where(live, reg_next, reg)
    done = _where(live, done_next, done)
    it = it + live.to(it.dtype)

  if cfg.final_gains:
    As, Bs = _linearize(m, d0, xs, us, cfg.lin_batch)
    (lx, lu, lxx, luu, lux), gT, hT = _quadratize_all(m, cost, xs, us,
                                                      cost_args)
    ks, Ks, _, _ = _backward(
        m, ILQRConfig(limits=cfg.limits), As, Bs, lx, lu, lxx, luu, lux, gT,
        hT, torch.full((nf,), cfg.reg_min, dtype=dtype, device=dev), u_lo,
        u_hi, us)
  else:
    ks = torch.zeros((nf, T, nu), dtype=dtype, device=dev)
    Ks = torch.zeros((nf, T, nu, nx), dtype=dtype, device=dev)

  return ILQRResult(us=us, xs=xs, cost=c_prev, gains_K=Ks, gains_k=ks,
                    niter=it, reg=reg)


# ---------------------------------------------------------------------------
# LQR (infinite horizon; the humanoid balance recipe, scripts/balance.py)
# ---------------------------------------------------------------------------


def lqr_gain(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
             r: torch.Tensor, iterations: int = 200):
  """Discrete-time infinite-horizon LQR gain by ``iterations`` steps of the
  Riccati iteration from P = Q, as the JAX ``lqr_gain``.  ``a`` (..., nx,
  nx), ``b`` (..., nx, nu), ``q`` (..., nx, nx), ``r`` (..., nu, nu), any
  leading dimensions broadcast (one iteration a lane).  Returns ``(K, P)``,
  with u = -K dx."""
  at, bt = a.transpose(-1, -2), b.transpose(-1, -2)
  p = q
  for _ in range(iterations):
    btp = bt @ p
    gain = torch.linalg.solve(r + btp @ b, btp @ a)
    p = q + at @ p @ (a - b @ gain)
    p = 0.5 * (p + p.transpose(-1, -2))
  btp = bt @ p
  return torch.linalg.solve(r + btp @ b, btp @ a), p
