"""The JAX package's iLQR reach on the tendon arm, the reference of
``tests/test_torch_actuation.py::test_arm_reach_ilqr_matches_jax``, and
its copy on disk (``tests/arm_reach_ilqr_jax.npz``).

    python3 tests/arm_reach_reference.py

writes the copy.  Tracing and compiling the JAX package's ``ilqr`` through
the arm's wrapping tendons takes 3-5 minutes of a CPU (most of it the
trace of the tendon wrap under ``vmap`` and ``jvp``), and the JAX package
does not change: ``jax_result`` returns the stored plan, cost and
iteration counts where the file's key is this run's, and runs the JAX
package otherwise.  The key is a hash of everything the result depends
on: JAX's, jaxlib's and mujoco's versions, every source file of the JAX
package, the arm's MJCF and the problem (states, targets, initial plan,
iLQR settings).
"""

from __future__ import annotations

import hashlib
import importlib
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
STORED = HERE / "arm_reach_ilqr_jax.npz"

# the problem: two reaches of H = 10 from states away from the joint
# limits, each to its own target, 2 iterations, 2 alphas, no control limits
QPOS = ((0.4, 0.9), (0.8, 1.2))
ACT0 = 0.2
TARGETS = np.array([[0.5, 0.6], [0.2, 0.7]])
HORIZON, U0 = 10, 0.2
ILQR = dict(iterations=2, n_alpha=2, limits=False)


def problem():
  """(the arm's MjModel under EULER, one MjData a problem, targets,
  initial plans (2, H, nu), the ILQRConfig settings)."""
  import mujoco

  sys.path.insert(0, str(REPO))
  import mujoco_inversedynamicstest_tpu_torch as mt

  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("tendon_arm.xml")))
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_EULER
  mjds = []
  for qpos in QPOS:
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = qpos
    mjd.act[:] = ACT0
    mjds.append(mjd)
  us0 = U0 * np.ones((len(QPOS), HORIZON, mjm.nu))
  return mjm, mjds, TARGETS, us0, dict(ILQR)


def key(targets, us0, kw) -> str:
  """The hash of what the JAX package's result depends on."""
  import jax
  import jaxlib
  import mujoco

  h = hashlib.sha256()
  for v in (jax.__version__, jaxlib.__version__, mujoco.__version__,
            repr(sorted(kw.items())), repr(QPOS), repr(ACT0)):
    h.update(v.encode())
  for a in (targets, us0):
    h.update(np.ascontiguousarray(a, np.float64).tobytes())
  package = REPO / "mujoco_inversedynamicstest_tpu"
  for path in sorted(package.rglob("*.py")):
    h.update(str(path.relative_to(REPO)).encode())
    h.update(path.read_bytes())
  arm = REPO / "mujoco_inversedynamicstest_tpu_torch" / "assets"
  h.update((arm / "tendon_arm.xml").read_bytes())
  return h.hexdigest()


def reach_cost_jax(target):
  import jax.numpy as jnp

  def cost(m, s, u, t):
    del m, t
    q1, q2 = s.qpos[0], s.qpos[0] + s.qpos[1]
    dif = 0.5 * jnp.stack([jnp.cos(q1) + jnp.cos(q2),
                           jnp.sin(q1) + jnp.sin(q2)]) - target
    return dif @ dif + 1e-3 * u @ u
  return cost


def compute(mj, mjds, targets, us0, kw) -> dict:
  """The JAX package's ilqr vmapped over the problems (one jit)."""
  import jax
  import jax.numpy as jnp

  import mujoco_inversedynamicstest_tpu as mi

  # the module (the package's opt exports its function of the same name)
  jilqr = importlib.import_module("mujoco_inversedynamicstest_tpu.opt.ilqr")
  d_j = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[
      mi.put_data(mj, mjd) for mjd in mjds])
  ref = jax.jit(jax.vmap(lambda d, u, g: jilqr.ilqr(
      mj, reach_cost_jax(g), d, u, jilqr.ILQRConfig(**kw))))(
          d_j, us0, targets)
  return {k: np.asarray(getattr(ref, k)) for k in ("us", "cost", "niter")}


def jax_result(mj, mjds, targets, us0, kw) -> dict:
  """The JAX package's plan, cost and iterations: the stored ones where
  their key is this run's, computed otherwise."""
  want = key(targets, us0, kw)
  if STORED.exists():
    with np.load(STORED) as z:
      if str(z["key"]) == want:
        return {k: z[k] for k in ("us", "cost", "niter")}
  return compute(mj, mjds, targets, us0, kw)


def main() -> None:
  sys.path.insert(0, str(REPO))
  os.environ.setdefault("JAX_PLATFORMS", "cpu")
  import jax

  jax.config.update("jax_platforms", "cpu")
  jax.config.update("jax_enable_x64", True)
  import mujoco_inversedynamicstest_tpu as mi

  mjm, mjds, targets, us0, kw = problem()
  out = compute(mi.put_model(mjm), mjds, targets, us0, kw)
  np.savez(STORED, key=np.array(key(targets, us0, kw)), **out)
  print(f"wrote {STORED}: cost {out['cost']}, niter {out['niter']}")


if __name__ == "__main__":
  main()
