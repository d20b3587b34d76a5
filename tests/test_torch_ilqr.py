"""The port's ``opt/ilqr.py`` with ``final_gains`` against the JAX package,
on the 2-dof arm of ``tests/test_torch_opt.py``, f64 on the CPU.

A file of its own: compiling the JAX package's iLQR takes about half a
minute, and the Tier-1 command gives each file one worker.  The JAX
result is stored (``tests/jax_reference.py``).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import importlib

import jax
import mujoco
import numpy as np
import torch

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
from mujoco_inversedynamicstest_tpu.opt import northstar as jnorthstar
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.opt import northstar

from test_torch_opt import ARM

# the modules, which the packages' opt/__init__ shadow with the functions
jilqr = importlib.import_module("mujoco_inversedynamicstest_tpu.opt.ilqr")
ilqr_mod = importlib.import_module(
    "mujoco_inversedynamicstest_tpu_torch.opt.ilqr")


def test_arm_ilqr_final_gains_match_jax():
  """ilqr with ``final_gains`` on a 2-problem ARM fleet (H = 8, 2
  iterations, 4 alphas, control limits active): plan, cost and the gains
  of the returned plan equal the JAX package's (vmapped) to 1e-9."""
  mjm = mujoco.MjModel.from_xml_string(ARM)
  mp = mt.put_model(mjm, device="cpu")
  kw = dict(horizon=8, fleet=2, qpos_noise=0.15, qvel_noise=0.1)
  us0 = 2.0 * np.ones((2, 8, mjm.nu))

  def jax_ilqr():
    mj = mi.put_model(mjm)
    d_j = jnorthstar.make_fleet(mj, mi.make_data(mj),
                                jnorthstar.NorthStarConfig(**kw))
    cfg_j = jilqr.ILQRConfig(iterations=2, n_alpha=4, final_gains=True)
    out = jax.jit(jax.vmap(lambda d, u: jilqr.ilqr(
        mj, jnorthstar.balance_cost(mj), d, u, cfg_j)))(d_j, us0)
    return {k: getattr(out, k) for k in ("us", "cost", "gains_K",
                                         "gains_k", "niter")}

  ref = jax_reference.result(
      "arm_ilqr_final_gains", [jax_reference.model_bytes(mjm),
                               repr(sorted(kw.items())), us0], jax_ilqr)

  d_p = northstar.make_fleet(mp, mt.make_data(mp, 1),
                             northstar.NorthStarConfig(**kw))
  got = ilqr_mod.ilqr(mp, northstar.balance_cost(mp), d_p,
                      torch.as_tensor(us0),
                      ilqr_mod.ILQRConfig(iterations=2, n_alpha=4,
                                          final_gains=True))
  for name in ("us", "cost", "gains_K", "gains_k"):
    np.testing.assert_allclose(getattr(got, name).numpy(), ref[name],
                               rtol=0, atol=1e-9, err_msg=name)
  np.testing.assert_array_equal(got.niter.numpy(), ref["niter"])
  assert np.abs(got.gains_K.numpy()).max() > 0
