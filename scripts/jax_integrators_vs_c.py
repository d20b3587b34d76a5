"""The JAX package's integrators against C MuJoCo, on the CPU in float64.

    python3 scripts/jax_integrators_vs_c.py

Prints two findings about the JAX reference (ROADMAP queue 3):

1. ``rk4``: the Newton-100 humanoid from a seeded floor-contact state
   (qpos0, root lowered 0.22, hinge noise 0.08, qvel noise 0.1, control
   noise 0.2; seed 0), 5 RK4 steps by ``jax.jit(mi.step)`` and by C
   ``mj_step``: max |qpos| gap, max |qacc| and |qacc_warmstart| gaps, and
   both solver iteration counts, a step each.
2. ``mjx``: ``humanoid_mjx`` (Newton, iterations=1, ls_iterations=4) from
   the same state, one step under EULER and under RK4: the max |qvel| gap
   to C.

Needs ``jax`` (set to the CPU and float64 here) and ``mujoco``; reads the
vendored humanoids of the PyTorch port's assets.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import mujoco  # noqa: E402
import numpy as np  # noqa: E402

import mujoco_inversedynamicstest_tpu as mi  # noqa: E402

ASSETS = os.path.join(REPO, "mujoco_inversedynamicstest_tpu_torch", "assets")


def state(mjm, seed=0):
  rng = np.random.RandomState(seed)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] -= 0.22
  mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
  return mjd


def model(name, integrator):
  mjm = mujoco.MjModel.from_xml_path(os.path.join(ASSETS, f"{name}.xml"))
  mjm.opt.integrator = integrator
  return mjm


def rk4(steps=5):
  mjm = model("humanoid", mujoco.mjtIntegrator.mjINT_RK4)
  mjd = state(mjm)
  mj = mi.put_model(mjm)
  dj = mi.put_data(mj, mjd)
  step = jax.jit(mi.step)
  for i in range(steps):
    dj = step(mj, dj)
    mujoco.mj_step(mjm, mjd)
    gap = lambda f: float(np.abs(np.asarray(getattr(dj, f))
                                 - getattr(mjd, f)).max())
    print(f"rk4 step {i}: |dqpos| {gap('qpos'):.3e}, |dqacc| "
          f"{gap('qacc'):.3e}, |dqacc_warmstart| {gap('qacc_warmstart'):.3e}"
          f", solver_niter JAX {int(dj.solver_niter)} C "
          f"{mjd.solver_niter[0]}, C contacts {mjd.ncon}")


def mjx():
  for name, integ in (("EULER", mujoco.mjtIntegrator.mjINT_EULER),
                      ("RK4", mujoco.mjtIntegrator.mjINT_RK4)):
    mjm = model("humanoid_mjx", integ)
    mjd = state(mjm)
    mj = mi.put_model(mjm)
    dj = jax.jit(mi.step)(mj, mi.put_data(mj, mjd))
    mujoco.mj_step(mjm, mjd)
    print(f"mjx {name}: one step, |dqvel| "
          f"{float(np.abs(np.asarray(dj.qvel) - mjd.qvel).max()):.3e}, "
          f"C contacts {mjd.ncon}")


if __name__ == "__main__":
  print(f"mujoco {mujoco.__version__}, jax {jax.__version__}, CPU float64")
  rk4()
  mjx()
