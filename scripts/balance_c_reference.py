"""C MuJoCo's runs of the humanoid balance LQR, for the card to be held to.

    python3 scripts/balance_c_reference.py [out.npz]

The card's machine has no ``mujoco``, so ``chip_smoke.py``'s phase 21
compares its fp64 closed loop with C's runs written here, from the same
inputs.  On the CPU in float64, with the port: the recipe of
``scripts/balance.py`` (pose, ctrl0, the gain K of ``lqr_gain`` at
``LQR_ITERATIONS``), 4 initial states of ``fleet_states`` and 25 steps of
``smoothed_noise`` from a seeded ``torch.Generator``.  Then C:

* closed loop: 25 ``mj_step``s of each lane with the same policy as
  ``balance.lqr_policy`` fired by ``mujoco.set_mjcb_control``, the
  ``mjSTATE_INTEGRATION`` state after each;
* open loop: ``mujoco.rollout.rollout`` of 4 more initial states under
  10 steps of uniform random controls in [-1, 1].

Writes inputs and C's states to ``out.npz`` (by default the package's
``assets/humanoid_balance_c.npz``).  Needs ``mujoco`` and no card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import mujoco  # noqa: E402
import mujoco.rollout  # noqa: E402

import balance  # noqa: E402
import mujoco_inversedynamicstest_tpu_torch as mt  # noqa: E402

SEED, LANES, CLOSED_STEPS, OPEN_STEPS = 21, 4, 25, 10
INTEGRATION = int(mujoco.mjtState.mjSTATE_INTEGRATION)
FULLPHYSICS = int(mujoco.mjtState.mjSTATE_FULLPHYSICS)


def inputs(m) -> dict:
  """The port's recipe and the seeded lanes, as numpy arrays."""
  prob = balance.balance_problem(m)
  gen = torch.Generator().manual_seed(SEED)
  init = balance.fleet_states(m, prob.pose.qpos, gen, LANES)
  noise = balance.smoothed_noise(m, gen, CLOSED_STEPS, LANES)
  open_init = balance.fleet_states(m, prob.pose.qpos, gen, LANES)
  control = 2 * torch.rand((LANES, OPEN_STEPS, m.nu), generator=gen,
                           dtype=m.dtype) - 1
  return {k: v.numpy() for k, v in dict(
      qpos=prob.pose.qpos, ctrl0=prob.ctrl0, gain=prob.gain, init=init,
      noise=noise, open_init=open_init, open_control=control).items()}


def c_closed_loop(mjm, ref: dict) -> np.ndarray:
  """(LANES, CLOSED_STEPS, nintegration): C's closed loop from ``ref``'s
  inputs."""
  mjd = mujoco.MjData(mjm)
  h = mjm.opt.timestep
  noise = ref["noise"]
  out = np.zeros((LANES, CLOSED_STEPS, mujoco.mj_stateSize(mjm, INTEGRATION)))
  dq = np.zeros(mjm.nv)
  for lane in range(LANES):

    def policy(cm, cd, lane=lane):
      mujoco.mj_differentiatePos(cm, dq, 1.0, ref["qpos"], cd.qpos)
      t = min(max(int(np.round(cd.time / h)), 0), len(noise) - 1)
      cd.ctrl[:] = (ref["ctrl0"] - ref["gain"] @ np.concatenate([dq, cd.qvel])
                    + noise[t, lane])

    mujoco.mj_resetData(mjm, mjd)
    mujoco.mj_setState(mjm, mjd, ref["init"][lane], FULLPHYSICS)
    mujoco.set_mjcb_control(policy)
    try:
      for t in range(CLOSED_STEPS):
        mujoco.mj_step(mjm, mjd)
        mujoco.mj_getState(mjm, mjd, out[lane, t], INTEGRATION)
    finally:
      mujoco.set_mjcb_control(None)
  return out


def c_open_loop(mjm, ref: dict) -> np.ndarray:
  state, _ = mujoco.rollout.rollout(mjm, mujoco.MjData(mjm), ref["open_init"],
                                    ref["open_control"])
  return state


def reference() -> dict:
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  m = mt.put_model(mt.asset_path("humanoid.npz"), device="cpu")
  ref = inputs(m)
  ref["closed_states"] = c_closed_loop(mjm, ref)
  ref["open_states"] = c_open_loop(mjm, ref)
  return ref


def main() -> None:
  out = (sys.argv[1] if len(sys.argv) > 1
         else str(mt.asset_path("humanoid_balance_c.npz")))
  ref = reference()
  np.savez_compressed(out, **ref)
  print(f"wrote {out}: " + ", ".join(f"{k} {v.shape}" for k, v in ref.items()))


if __name__ == "__main__":
  main()
