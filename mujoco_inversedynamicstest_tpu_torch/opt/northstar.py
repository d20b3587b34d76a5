"""North-star harness: humanoid MPC solves/s and torque parity.

Port of the JAX package's ``opt/northstar.py``.  A fleet of
receding-horizon iLQR solves over the full contact dynamics, timed as
solves per second, with the executed trajectories' generalized torques
reproduced through the inverse-dynamics pipeline and compared with C
MuJoCo's ``mj_inverse`` (the fork's ``inverse_test`` pattern lifted to
MPC).

Differences from the JAX package:

* the fleet is the leading dimension of every tensor; ``fleet_mpc_fn``
  returns a plain function (PyTorch runs eagerly: nothing is compiled);
* ``compile_time_s`` is the first (cold) run's seconds, which on the card
  include building the CUDA kernels and PyTorch's own first-use costs;
  ``measure_solves_per_sec(..., cold_run=False)`` times one run only, for
  a process whose kernels are built and warm already (NaN then);
* timing synchronizes with ``torch.cuda.synchronize()`` on the card;
* the fleet runs as one batch: ``max_exec_fleet``, which split fleets into
  dispatches to stay within the deadlines of a remote TPU runtime, has no
  counterpart.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    JointType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import inverse as inverse_mod
from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.opt import derivative
from mujoco_inversedynamicstest_tpu_torch.opt.ilqr import ILQRConfig, State
from mujoco_inversedynamicstest_tpu_torch.opt.mpc import (
    MPCConfig,
    MPCRun,
    run_mpc,
)


def balance_cost(m: Model, qpos_ref: Optional[torch.Tensor] = None,
                 w_pos: float = 8.0, w_root: float = 40.0,
                 w_vel: float = 0.08, w_ctrl: float = 0.02):
  """Posture-tracking cost: quadratic in the tangent-space posture error
  relative to ``qpos_ref`` (default qpos0), free-root dofs weighted
  ``w_root`` and the other joints ``w_pos``, plus velocity and control
  regularization.  Returns ``cost(m, state, u, t)`` for one sample."""
  ref = m.qpos0 if qpos_ref is None else qpos_ref
  w = np.full(m.nv, w_pos)
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.FREE:
      adr = m.jnt_dofadr[j]
      w[adr:adr + 6] = w_root
  w = torch.as_tensor(w, device=m.device)

  def cost(mm: Model, s: State, u: torch.Tensor, t: torch.Tensor):
    del t
    dq = support.differentiate_pos(mm, ref.to(s.qpos), s.qpos, 1.0)
    return (torch.sum(w.to(dq) * dq * dq) + w_vel * s.qvel @ s.qvel
            + w_ctrl * u @ u)

  return cost


class NorthStarConfig(NamedTuple):
  """Fleet-MPC benchmark configuration."""
  horizon: int = 100
  fleet: int = 512
  n_replan: int = 2
  ilqr_iterations: int = 2
  n_alpha: int = 8
  lin_batch: Optional[int] = 2
  qpos_noise: float = 0.02
  qvel_noise: float = 0.02
  seed: int = 0
  # plan steps executed per replan; n_apply == horizon consumes the whole
  # plan
  n_apply: int = 1

  def mpc_config(self) -> MPCConfig:
    return MPCConfig(
        horizon=self.horizon,
        ilqr=ILQRConfig(iterations=self.ilqr_iterations,
                                 n_alpha=self.n_alpha,
                                 lin_batch=self.lin_batch),
        n_apply=self.n_apply,
    )


def make_fleet(m: Model, d0: Data, cfg: NorthStarConfig) -> Data:
  """A fleet of perturbed initial states from the one lane of ``d0``; the
  same ``np.random.RandomState(seed)`` draws as the JAX package, so both
  packages start from the same fleet."""
  rng = np.random.RandomState(cfg.seed)
  nq_off = 7 if (m.njnt and m.jnt_type[0] == 0) else 0  # keep the root pose
  dq = cfg.qpos_noise * rng.randn(cfg.fleet, m.nq)
  dq[:, :nq_off] = 0.0
  qvel = cfg.qvel_noise * rng.randn(cfg.fleet, m.nv)
  t = lambda a: torch.as_tensor(a, dtype=d0.qpos.dtype,
                                device=d0.qpos.device)
  fleet = derivative.repeat_lanes(d0, cfg.fleet)
  return fleet.replace(qpos=fleet.qpos + t(dq), qvel=t(qvel))


def fleet_mpc_fn(m: Model, cost, cfg: NorthStarConfig):
  """The fleet solve: (Data of F lanes) -> MPCRun; one call performs
  ``fleet * n_replan`` MPC solves."""
  mcfg = cfg.mpc_config()

  def run(d0_fleet: Data) -> MPCRun:
    return run_mpc(m, cost, d0_fleet, cfg.n_replan, mcfg)

  return run


class NorthStarResult(NamedTuple):
  solves_per_sec: float          # one card
  n_solves: int
  wall_time_s: float
  compile_time_s: float          # the first (cold) run's seconds, or NaN
  plan_cost_mean: float          # over FINITE lanes (the quality signal)
  run: MPCRun            # for downstream parity checks
  finite_lane_fraction: float = float("nan")  # lanes with finite plan cost
  mean_iterations: float = float("nan")       # iLQR iterations per solve
  solve_latency_s: float = float("nan")       # wall seconds per solve


def _sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def measure_solves_per_sec(m: Model, cost, d0: Data, cfg: NorthStarConfig,
                           cold_run: bool = True) -> NorthStarResult:
  """Times the fleet solve: a first (cold) run, then one warm run; with
  ``cold_run`` false, only the timed run."""
  fleet = make_fleet(m, d0, cfg)
  fn = fleet_mpc_fn(m, cost, cfg)

  def run_all():
    out = fn(fleet)
    _sync(m.device)
    return out

  compile_time = float("nan")
  if cold_run:
    t0 = time.perf_counter()
    run_all()
    compile_time = time.perf_counter() - t0
  t0 = time.perf_counter()
  out = run_all()
  dt = time.perf_counter() - t0

  n_solves = cfg.fleet * cfg.n_replan
  costs = out.plan_costs.cpu().numpy()
  finite = np.isfinite(costs)
  return NorthStarResult(
      solves_per_sec=n_solves / dt,
      n_solves=n_solves,
      wall_time_s=dt,
      compile_time_s=compile_time,
      plan_cost_mean=(float(costs[finite].mean()) if finite.any()
                      else float("nan")),
      run=out,
      finite_lane_fraction=float(finite.mean()),
      mean_iterations=float(out.niters.double().mean()),
      # the fleet progresses in lockstep: a solve's latency is the batch's
      # wall time per replan cycle
      solve_latency_s=dt / cfg.n_replan,
  )


def executed_trajectory(m: Model, d0: Data, us: torch.Tensor):
  """Rolls the applied controls (F, T, nu) out from ``d0``; returns per
  step (qpos, qvel, qacc_discrete), each (F, T, ...), where
  ``qacc_discrete[t] = (qvel[t+1] - qvel[t]) / h`` is the acceleration the
  integrator produced (the fork's harness convention)."""
  h = m.opt.timestep
  qpos, qvel, qacc = [], [], []
  d = d0
  for t in range(us.shape[1]):
    dn = forward_mod.step(m, d.replace(ctrl=us[:, t]))
    qpos.append(d.qpos)
    qvel.append(d.qvel)
    qacc.append((dn.qvel - d.qvel) / h)
    d = dn
  return tuple(torch.stack(x, dim=1) for x in (qpos, qvel, qacc))


def inverse_torques_along(m: Model, d_template: Data, qpos: torch.Tensor,
                          qvel: torch.Tensor,
                          qacc: torch.Tensor) -> torch.Tensor:
  """Our inverse-dynamics torques (F, T, nv) at each (state, qacc) sample;
  the other inputs come from the F lanes of ``d_template``."""
  nf, T = qpos.shape[:2]
  d = derivative.repeat_lanes(d_template, T).replace(
      qpos=qpos.flatten(0, 1), qvel=qvel.flatten(0, 1),
      qacc=qacc.flatten(0, 1))
  return inverse_mod.inverse(m, d).qfrc_inverse.unflatten(0, (nf, T))


def torque_parity_vs_host(mjm, m: Model, d0: Data,
                          us: torch.Tensor) -> Tuple[float, np.ndarray]:
  """Max |qfrc_inverse(ours) - mj_inverse(C)| along the executed
  trajectory of one lane: ``d0`` has one lane and ``us`` is (T, nu).

  Replays each visited (qpos, qvel, qacc_discrete) through both inverse
  pipelines; returns (max_abs_err, per-step err).  Needs ``mujoco``.
  """
  import mujoco

  qpos, qvel, qacc = executed_trajectory(m, d0, us[None])
  ours = inverse_torques_along(m, d0, qpos, qvel, qacc)[0].cpu().numpy()
  qpos_h, qvel_h, qacc_h = (x[0].cpu().numpy() for x in (qpos, qvel, qacc))
  mjd = mujoco.MjData(mjm)
  errs = np.zeros(len(qpos_h))
  for t in range(len(qpos_h)):
    mjd.qpos[:] = qpos_h[t]
    mjd.qvel[:] = qvel_h[t]
    mjd.qacc[:] = qacc_h[t]
    mujoco.mj_inverse(mjm, mjd)
    errs[t] = np.abs(ours[t] - mjd.qfrc_inverse).max()
  return float(errs.max()), errs
