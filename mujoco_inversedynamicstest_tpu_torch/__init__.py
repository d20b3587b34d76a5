"""PyTorch/CUDA port of the physics engine, beside the JAX reference.

The layout mirrors ``mujoco_inversedynamicstest_tpu`` (``models/``, ``ops/``),
so each module's counterpart is found by path.  ``Model``/``Data`` are
dataclasses of tensors; every ``Data`` tensor has a leading fleet dimension.
The two Pallas TPU kernels of the JAX package are hand-written CUDA kernels
here (``csrc/cholesky.cu``, bound in ``ops/linalg.py``).

This package never imports jax; it imports ``mujoco`` only inside
``load_model``, to compile MJCF.
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
from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.ops.forward import forward, step
from mujoco_inversedynamicstest_tpu_torch.ops.inverse import (
    compare_fwd_inv,
    inverse,
)
from mujoco_inversedynamicstest_tpu_torch.ops.smooth import factor_m, solve_m
