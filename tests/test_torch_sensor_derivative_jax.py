"""The port's sensor Jacobians C and D in the air, against the JAX
package's ``transition_ad(flg_sensor=True)`` and C MuJoCo.

f64 on the CPU.  dm_control's humanoid with its 34 sensors, lifted off the
floor with contacts disabled: no constraint but the joint limits, where
the JAX package's Jacobians are right (on contact states they are not,
ROADMAP queue 3, and tests/test_torch_sensor_derivative.py holds the port
to C there).  This file holds the one JAX ``transition_ad`` of the humanoid
(its trace and compile took most of the file's time; its result is
stored, ``tests/jax_reference.py``), apart from the contact states' file.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import mujoco
import numpy as np

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
from mujoco_inversedynamicstest_tpu import opt as jopt
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.opt import derivative


def test_sensor_jacobians_in_the_air_match_jax_and_c():
  """C, D (and A, B) against the JAX package (1e-9 of max|C|, max|D|) and
  against C mjd_transitionFD (centered, eps 1e-6; D against its forward
  differences, its centered D having the wrong sign: ROADMAP queue 3),
  1e-6 of max|C|, max|D|."""
  mjm = mujoco.MjModel.from_xml_path(
      str(mt.asset_path("humanoid_sensors.xml")))
  mjm.opt.disableflags |= int(mujoco.mjtDisableBit.mjDSBL_CONTACT)
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(5)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[2] += 0.5
  mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.3 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
  mjd.xfrc_applied[1:] = 0.3 * rng.randn(mjm.nbody - 1, 6)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon == 0

  def jax_transition():
    mj = mi.put_model(mjm)
    out = jax.jit(lambda m, d: jopt.transition_ad(m, d, flg_sensor=True))(
        mj, mi.put_data(mj, mjd))
    return {k: getattr(out, k) for k in "ABCD"}

  tj = jax_reference.result(
      "sensor_transition_in_the_air", [jax_reference.model_bytes(mjm)] + [
          np.atleast_1d(np.array(getattr(mjd, k))) for k in (
              "qpos", "qvel", "ctrl", "xfrc_applied", "qacc_warmstart",
              "time")], jax_transition)
  mp = mt.put_model(mjm, device="cpu")
  tp = derivative.transition_ad(mp, mt.forward(mp, mt.put_data(mp, mjd)),
                                flg_sensor=True)

  nx, ns = 2 * mjm.nv, mjm.nsensordata
  c_c, d_c = np.zeros((ns, nx)), np.zeros((ns, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 1, None, None, c_c, None)
  mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 0, None, None, None, d_c)
  for ours, theirs, c in ((tp.A, tj["A"], None), (tp.B, tj["B"], None),
                          (tp.C, tj["C"], c_c), (tp.D, tj["D"], d_c)):
    ours = ours[0].numpy()
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-9 * scale)
    if c is not None:
      np.testing.assert_allclose(ours, c, rtol=0,
                                 atol=1e-6 * np.abs(c).max())
  assert np.abs(tp.C[0].numpy()[12:48]).max() > 1.0   # force and torque
