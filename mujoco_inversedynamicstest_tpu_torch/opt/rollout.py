"""Batched rollouts, open loop or closed loop.

Port of ``mujoco_inversedynamicstest_tpu/opt/rollout.py`` (the analog of
``mujoco.rollout.rollout``).  The JAX package ``vmap``s one trajectory over
the batch and ``lax.scan``s it over time; here the trajectories are the
lanes of one ``Data`` and time is a loop over ``step``:

* each lane starts from an ``mjSTATE_FULLPHYSICS`` vector in the installed
  mujoco's layout (``ops.support.get_state``), so ``initial_state`` can come
  straight from ``mj_getState`` and go to ``mujoco.rollout.rollout``;
* open loop, ``control`` gives each step's inputs, the fields of
  ``control_spec`` written with ``set_state`` before the step;
* closed loop, ``ctrl_fn(m, d) -> (B, nu)`` fires inside each step at
  ``mjcb_control``'s point (``ops/forward.py``);
* the result is the FULLPHYSICS state and ``sensordata`` after each
  step, and each lane's auto-resets over the run (``Data.warning``): a lane
  that diverged was reset by ``step`` and reads as finite.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mujoco_inversedynamicstest_tpu_torch.models.io import make_data
from mujoco_inversedynamicstest_tpu_torch.models.types import Model, StateFlag
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import support


class RolloutResult(NamedTuple):
  state: torch.Tensor       # (B, nstep, nfullphysics)
  sensordata: torch.Tensor  # (B, nstep, nsensordata)
  warning: torch.Tensor     # (B, 2) int32: bad qpos / bad qvel resets


def rollout(m: Model, initial_state: torch.Tensor,
            control: Optional[torch.Tensor] = None,
            control_spec: int = StateFlag.CTRL,
            nstep: Optional[int] = None, ctrl_fn=None) -> RolloutResult:
  """Rolls out B trajectories (``mujoco.rollout.rollout``).

  Args:
    m: model.
    initial_state: (B, nfullphysics) ``mjSTATE_FULLPHYSICS`` vectors; every
      other input of a lane starts as ``make_data``'s (C's rollout clears
      them too, and starts from a zero warm start).
    control: optional (B, nstep, ncontrol) per-step inputs, ncontrol =
      ``support.state_size(m, control_spec)``; without it the inputs stay
      as they are, but for what ``ctrl_fn`` writes.
    control_spec: the ``mjtState`` fields ``control`` writes each step.
    nstep: the horizon; needed when ``control`` is None.
    ctrl_fn: optional ``(m, d) -> (B, nu)`` control callback, fired inside
      each step (``mjcb_control``).

  Returns the FULLPHYSICS state and sensordata after each step, (B, nstep,
  ...), and the lanes' auto-resets over the run, (B, 2).
  """
  if control is None and nstep is None:
    raise ValueError("rollout needs control or nstep")
  if nstep is None:
    nstep = control.shape[1]
  full = StateFlag.FULLPHYSICS
  d = support.set_state(m, make_data(m, initial_state.shape[0]),
                        initial_state, full)
  states, sensors = [], []
  for t in range(nstep):
    if control is not None:
      d = support.set_state(m, d, control[:, t], control_spec)
    d = forward_mod.step(m, d, ctrl_fn=ctrl_fn)
    states.append(support.get_state(m, d, full))
    sensors.append(d.sensordata)
  return RolloutResult(state=torch.stack(states, dim=1),
                       sensordata=torch.stack(sensors, dim=1),
                       warning=d.warning)
