"""Receding-horizon MPC for a fleet of problems (the north-star engine).

Port of the JAX package's ``opt/mpc.py``.  One MPC *solve* is a
warm-started iLQR from the current state; the fleet is the leading
dimension of every tensor (the JAX package ``vmap``s a single problem).
``inverse_torques`` recovers the generalized forces of a trajectory through
the inverse-dynamics pipeline (``mj_inverse``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mujoco_inversedynamicstest_tpu_torch.models.io import make_data
from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import inverse as inverse_mod
from mujoco_inversedynamicstest_tpu_torch.opt.ilqr import (
    CostFn,
    ILQRConfig,
    State,
    ilqr,
)


class MPCConfig(NamedTuple):
  horizon: int = 25
  ilqr: ILQRConfig = ILQRConfig(iterations=5, n_alpha=6)
  # steps of the plan consumed (and simulated) per replan
  n_apply: int = 1


class MPCCarry(NamedTuple):
  d: Data                  # current "real" system states, F lanes
  us_warm: torch.Tensor    # (F, horizon, nu) warm-start plans


class MPCStepResult(NamedTuple):
  carry: MPCCarry
  u_applied: torch.Tensor  # (F, n_apply, nu) controls actually applied
  plan_cost: torch.Tensor  # (F,) iLQR objective of the accepted plan
  niter: torch.Tensor      # (F,) iLQR iterations used


def make_warm_start(m: Model, horizon: int, fleet: int,
                    dtype=None) -> torch.Tensor:
  """Zero plans (F, horizon, nu)."""
  return torch.zeros((fleet, horizon, m.nu), dtype=dtype or m.dtype,
                     device=m.device)


def mpc_step(m: Model, cost: CostFn, carry: MPCCarry,
             config: MPCConfig) -> MPCStepResult:
  """One replan-then-act cycle for every problem: solve iLQR from the
  current state, apply the first ``n_apply`` controls, shift the plan."""
  cfg = config
  res = ilqr(m, cost, carry.d, carry.us_warm, cfg.ilqr)
  u_apply = res.us[:, :cfg.n_apply]
  d = carry.d
  for i in range(cfg.n_apply):
    d = forward_mod.step(m, d.replace(ctrl=u_apply[:, i]))
  # receding-horizon shift: drop consumed controls, repeat the tail
  us_next = torch.cat([res.us[:, cfg.n_apply:],
                       res.us[:, -1:].expand(-1, cfg.n_apply, -1)], dim=1)
  return MPCStepResult(carry=MPCCarry(d=d, us_warm=us_next),
                       u_applied=u_apply, plan_cost=res.cost,
                       niter=res.niter)


class MPCRun(NamedTuple):
  ds: Data                    # final states (F lanes)
  us: torch.Tensor            # (F, n_replan * n_apply, nu) applied controls
  plan_costs: torch.Tensor    # (F, n_replan)
  niters: torch.Tensor        # (F, n_replan)


def run_mpc(m: Model, cost: CostFn, d0: Data, n_replan: int,
            config: Optional[MPCConfig] = None,
            us_warm: Optional[torch.Tensor] = None) -> MPCRun:
  """Runs ``n_replan`` MPC cycles from the F lanes of ``d0``."""
  cfg = config or MPCConfig()
  if us_warm is None:
    us_warm = make_warm_start(m, cfg.horizon, d0.batch, d0.qpos.dtype)
  carry = MPCCarry(d=d0, us_warm=us_warm)
  us, costs, niters = [], [], []
  for _ in range(n_replan):
    out = mpc_step(m, cost, carry, cfg)
    carry = out.carry
    us.append(out.u_applied)
    costs.append(out.plan_cost)
    niters.append(out.niter)
  return MPCRun(ds=carry.d, us=torch.cat(us, dim=1),
                plan_costs=torch.stack(costs, dim=1),
                niters=torch.stack(niters, dim=1))


def inverse_torques(m: Model, xs: State) -> torch.Tensor:
  """Generalized torques (F, T, nv) along (F, T+1) stacked plan states.

  Finite-differences the discrete accelerations the integrator produced
  and runs the inverse pipeline (``mj_inverse``).
  """
  nf, T = xs.qvel.shape[0], xs.qvel.shape[1] - 1
  qacc = (xs.qvel[:, 1:] - xs.qvel[:, :-1]) / m.opt.timestep
  d = make_data(m, nf * T, dtype=xs.qpos.dtype).replace(
      qpos=xs.qpos[:, :T].flatten(0, 1), qvel=xs.qvel[:, :T].flatten(0, 1),
      qacc=qacc.flatten(0, 1))
  return inverse_mod.inverse(m, d).qfrc_inverse.unflatten(0, (nf, T))
