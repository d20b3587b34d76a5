"""Trajectory optimization / MPC layer of the PyTorch port (derivatives,
box QP, iLQR, MPC, the north-star harness, rollouts, LQR).

``get_state``/``set_state`` here are the tangent-state helpers of
``opt/derivative.py``; the ``mjtState`` vectors are ``ops.support``'s
(exported at the package root)."""

from mujoco_inversedynamicstest_tpu_torch.opt.derivative import (
    InverseJac,
    Transition,
    apply_tangent,
    get_state,
    inverse_ad,
    inverse_fd,
    measure_tangent,
    set_state,
    smooth_vel_deriv,
    state_dim,
    transition_ad,
    transition_fd,
)
from mujoco_inversedynamicstest_tpu_torch.opt.ilqr import (
    ILQRConfig,
    ILQRResult,
    State,
    ilqr,
    lqr_gain,
    rollout_open_loop,
)
from mujoco_inversedynamicstest_tpu_torch.opt.mpc import (
    MPCCarry,
    MPCConfig,
    MPCRun,
    MPCStepResult,
    inverse_torques,
    make_warm_start,
    mpc_step,
    run_mpc,
)
from mujoco_inversedynamicstest_tpu_torch.opt.northstar import (
    NorthStarConfig,
    NorthStarResult,
    balance_cost,
    executed_trajectory,
    fleet_mpc_fn,
    inverse_torques_along,
    make_fleet,
    measure_solves_per_sec,
    torque_parity_vs_host,
)
from mujoco_inversedynamicstest_tpu_torch.opt.qp import BoxQPResult, box_qp
from mujoco_inversedynamicstest_tpu_torch.opt.rollout import (
    RolloutResult,
    rollout,
)
