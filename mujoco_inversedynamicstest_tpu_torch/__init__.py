"""PyTorch/CUDA port of the physics engine, beside the JAX reference.

The layout mirrors ``mujoco_inversedynamicstest_tpu`` (``models/``, ``ops/``),
so each module's counterpart is found by path.  ``Model``/``Data`` are
dataclasses of tensors; every ``Data`` tensor has a leading fleet dimension.
The two Pallas TPU kernels of the JAX package, and their forward-mode
JVPs, are hand-written CUDA kernels here (``csrc/cholesky.cu``, bound in
``ops/linalg.py``).  ``step`` integrates by the model's ``opt.integrator``
(Euler, RK4, implicit, implicitfast).  The constraint rows are C's:
equality (connect, weld, joint; per-lane ``eq_active``, mocap bodies), dof
friction loss, limits on hinges, slides and balls, and pyramidal contacts
(``ops/constraint.py``).  ``forward`` fills ``sensordata``
with the sensor types of ``models.types.PORTED_SENSORS`` (``ops/sensor.py``;
``sensor_pos``, ``sensor_vel``, ``sensor_acc``), among them dm_control's
humanoid's 34 (``assets/humanoid_sensors.npz``).  ``opt/`` holds the MPC
path: transition derivatives (with the sensor Jacobians C, D:
``opt.transition_ad(m, d, flg_sensor=True)``), qDeriv
(``smooth_vel_deriv``), box QP, iLQR, MPC, the north-star harness,
batched rollouts (``opt.rollout``, open loop or closed loop through the
in-step control callback ``ctrl_fn`` of ``forward``/``step``) and
``lqr_gain`` (``mt.opt``).  The
state-vector API (``get_state``, ``set_state``, ``state_size``, by
``StateFlag``) follows the installed mujoco's ``mjtState``.  The engine
plugins (``plugins/``: PID actuators, elastic cables, the touch grid, SDF
plugin geoms and the mesh-SDF bridge) are built from a model's snapshot
and run inside the step.

This package never imports jax; it imports ``mujoco`` only inside
``load_model`` (to compile MJCF) and ``opt.torque_parity_vs_host`` (the C
``mj_inverse`` oracle).
"""

from mujoco_inversedynamicstest_tpu_torch.models.io import (
    asset_path,
    from_jax_arrays,
    load_model,
    make_data,
    put_data,
    put_model,
    save_model_snapshot,
)
from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    Model,
    StateFlag,
)
from mujoco_inversedynamicstest_tpu_torch.ops.forward import (
    euler,
    forward,
    fwd_acceleration,
    fwd_actuation,
    fwd_position,
    fwd_velocity,
    rungekutta4,
    step,
    step_n,
)
from mujoco_inversedynamicstest_tpu_torch.ops.inverse import (
    compare_fwd_inv,
    inverse,
)
from mujoco_inversedynamicstest_tpu_torch.ops.sensor import (
    sensor_acc,
    sensor_pos,
    sensor_vel,
)
from mujoco_inversedynamicstest_tpu_torch.ops.smooth import factor_m, solve_m
from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.ops.support import (
    differentiate_pos,
    get_state,
    integrate_pos,
    set_state,
    state_size,
)
from mujoco_inversedynamicstest_tpu_torch import opt
