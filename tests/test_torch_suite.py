"""dm_control's swimmer, fish, acrobot, cartpole and pendulum in the PyTorch
port, in float64 on the CPU, against C MuJoCo and the JAX package:

* the vendored ``assets/<name>.xml`` are ``scripts/dm_suite_models.py``'s
  output (the task module's model without its ``./common/`` includes and
  ``material=`` attributes), compile to dm_control's own model, and every
  snapshot is what ``save_model_snapshot`` writes;
* 20 steps of 3 lanes of each, from states their dm_control tasks start
  (``suite.load(...).reset()`` at seeded task randoms), with random
  controls, against C's ``mj_step``: qpos and qvel within 1e-9,
  sensordata within 1e-8, ``d.energy`` within 1e-9;
* swimmer6's forward against the JAX package's (qacc, qfrc_fluid and
  sensordata within 1e-10);
* the forward/inverse consistency with fluid forces;
* ``put_model`` still refuses, by name, the enable flags the port has not
  ported (OVERRIDE, the contact override among them; FWDINV; SLEEP).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import re
import sys

import jax
import mujoco
import numpy as np
import pytest

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import dm_suite_models  # noqa: E402

NAMES = list(dm_suite_models.MODELS)
# the task each model's states start from
TASKS = {"swimmer6": ("swimmer", "swimmer6"),
         "swimmer15": ("swimmer", "swimmer15"), "fish": ("fish", "swim"),
         "acrobot": ("acrobot", "swingup"), "cartpole": ("cartpole", "swingup"),
         "pendulum": ("pendulum", "swingup")}


def _mjmodel(name):
  return mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))


def test_vendored_xml_is_the_task_modules_output():
  from dm_control.suite import common

  for name in NAMES:
    ours = mt.asset_path(f"{name}.xml").read_text()
    assert "dm_control 1.0.43" in ours
    assert ours == dm_suite_models.vendored(name), name
    # the stated changes change no dynamics
    a = _mjmodel(name)
    b = mujoco.MjModel.from_xml_string(dm_suite_models.dm_xml(name),
                                       common.ASSETS)
    for field in ("body_mass", "body_inertia", "body_pos", "geom_size",
                  "geom_type", "jnt_range", "dof_damping", "dof_armature",
                  "actuator_gainprm", "actuator_ctrlrange", "sensor_type",
                  "geom_fluid"):
      np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                    err_msg=f"{name}.{field}")
    for opt in ("density", "viscosity", "timestep", "integrator",
                "enableflags", "disableflags"):
      assert getattr(a.opt, opt) == getattr(b.opt, opt), (name, opt)


@pytest.mark.parametrize("name", NAMES)
def test_snapshot_is_current_and_loads(name, tmp_path):
  mjm = _mjmodel(name)
  fresh = tmp_path / "snap.npz"
  mt.save_model_snapshot(mjm, fresh)
  with np.load(mt.asset_path(f"{name}.npz")) as committed, np.load(
      fresh) as written:
    assert sorted(committed.files) == sorted(written.files)
    for k in written.files:
      np.testing.assert_array_equal(committed[k], written[k], err_msg=k)
  m = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  assert m.nv == mjm.nv
  assert m.has_fluid == (name in ("swimmer6", "swimmer15", "fish"))


def _task_states(name, seeds):
  """The states the model's dm_control task starts from, one a seed, as
  MjData of the vendored model, with controls uniform in ctrlrange."""
  from dm_control import suite

  mjm = _mjmodel(name)
  out = []
  for seed in seeds:
    env = suite.load(*TASKS[name], task_kwargs={"random": seed})
    env.reset()
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = env.physics.data.qpos
    mjd.qvel[:] = env.physics.data.qvel
    lo, hi = mjm.actuator_ctrlrange.T
    mjd.ctrl[:] = np.random.RandomState(seed).uniform(lo, hi)
    out.append(mjd)
  return mjm, out


@pytest.mark.parametrize("name", NAMES)
def test_rollout_matches_c(name):
  mjm, datas = _task_states(name, (0, 1, 2))
  m = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  d = mt.from_jax_arrays(m, {k: np.stack([getattr(x, k) for x in datas])
                             for k in ("qpos", "qvel", "ctrl")})
  for _ in range(20):
    for mjd in datas:
      mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  want = lambda f: np.stack([getattr(x, f) for x in datas])
  np.testing.assert_allclose(d.qpos, want("qpos"), rtol=0, atol=1e-9)
  np.testing.assert_allclose(d.qvel, want("qvel"), rtol=0, atol=1e-9)
  np.testing.assert_allclose(d.sensordata, want("sensordata"), rtol=0,
                             atol=1e-8)
  np.testing.assert_allclose(d.energy, want("energy"), rtol=0, atol=1e-9)
  if mjm.opt.enableflags & mujoco.mjtEnableBit.mjENBL_ENERGY:
    assert np.abs(want("energy")).max() > 0


def test_swimmer_forward_matches_jax():
  mjm, datas = _task_states("swimmer6", (3,))
  mjd = datas[0]
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  mj = mi.put_model(mjm)
  ref = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  for f in ("qacc", "qfrc_fluid", "sensordata"):
    np.testing.assert_allclose(getattr(out, f)[0], np.asarray(getattr(ref, f)),
                               rtol=0, atol=1e-10, err_msg=f)


@pytest.mark.parametrize("name", ["swimmer15", "fish"])
def test_fluid_models_inverse_matches_forward(name):
  mjm, datas = _task_states(name, (4, 5))
  m = mt.put_model(mjm, device="cpu")
  rng = np.random.RandomState(6)
  d = mt.from_jax_arrays(m, {
      "qpos": np.stack([x.qpos for x in datas]),
      "qvel": rng.randn(2, mjm.nv),
      "ctrl": np.stack([x.ctrl for x in datas]),
      "qfrc_applied": 0.3 * rng.randn(2, mjm.nv)})
  d = mt.compare_fwd_inv(m, mt.forward(m, d))
  assert float(d.solver_fwdinv.max()) <= 1e-9


@pytest.mark.parametrize("flag, what", [
    ("override", "OVERRIDE"), ("fwdinv", "FWDINV"), ("sleep", "SLEEP")])
def test_put_model_refuses_the_other_enable_flags(flag, what):
  xml = mt.asset_path("pendulum.xml").read_text().replace(
      'energy="enable"', f'energy="enable" {flag}="enable"')
  assert f'{flag}="enable"' in xml
  with pytest.raises(NotImplementedError,
                     match=re.escape(f"enable flags {what}")):
    mt.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")
