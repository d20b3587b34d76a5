"""The port's engine plugins (PID, cable, touch grid) and the plugin
refusals, against C and the JAX package, in float64 on the CPU.

The wheel ships C's ``mujoco.pid``, ``mujoco.elasticity.cable`` and
``mujoco.sensor.touch_grid``, so C is the reference wherever
``tests/test_plugins.py`` holds the JAX package to it, at its tolerances;
the JAX package at 1e-9 (its steps jitted: these models have no SDF
descent).  Also: each instance's static data against the JAX package's
instance; the refusals by name of an unknown plugin, a sensor plugin with no sensor hook, an SDF
geom whose plugin has no distance, and the shell, whose C plugin the
wheel does not ship (through snapshot fields alone).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import sys

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models import io
from mujoco_inversedynamicstest_tpu_torch.plugins import registry

import test_plugins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import plugin_models  # noqa: E402

# the JAX package's test's cases (tests/test_plugins.py)
PID_CASES = [
    dict(kp="40", kd="2"),
    dict(kp="25", ki="30", imax="5", actdim=1),
    dict(kp="30", ki="20", kd="1", imax="4", slewmax="8", actdim=2),
]


@pytest.mark.parametrize("cfg", PID_CASES)
def test_pid_rollout_matches_c_and_jax(cfg):
  """P, PI and PID with slew limit: 150 steps of changing controls, qpos,
  qvel and act against C (1e-8, 1e-7, 1e-8: the JAX package's test) and
  the JAX package (1e-9)."""
  mjm = mujoco.MjModel.from_xml_string(test_plugins._pid_xml(**cfg))
  mjd = mujoco.MjData(mjm)
  mj = mi.put_model(mjm)
  dj = mi.make_data(mj)
  m = mt.put_model(mjm, device="cpu")
  d = mt.make_data(m, 1)
  step = jax.jit(lambda dd: mi.step(mj, dd))
  rng = np.random.RandomState(0)
  for t in range(150):
    u = 0.8 * np.sin(0.05 * t) + 0.1 * rng.randn()
    mjd.ctrl[0] = u
    mujoco.mj_step(mjm, mjd)
    dj = step(dj.replace(ctrl=jnp.asarray([u])))
    d = mt.step(m, d.replace(ctrl=torch.tensor([[u]], dtype=torch.float64)))
  for name, tol in (("qpos", 1e-8), ("qvel", 1e-7), ("act", 1e-8)):
    got = getattr(d, name)[0].numpy()
    np.testing.assert_allclose(got, getattr(mjd, name), rtol=0, atol=tol,
                               err_msg=name)
    np.testing.assert_allclose(got, np.asarray(getattr(dj, name)), rtol=0,
                               atol=1e-9, err_msg=name)
  inst, jinst = m.plugin_hooks[0], mj.plugin_hooks[0]
  for k in ("kp", "ki", "kd", "imax", "slewmax"):
    assert getattr(inst, k) == getattr(jinst, k), k
  np.testing.assert_array_equal(inst.acts, jinst.acts)
  np.testing.assert_array_equal(inst.actadr, jinst.actadr)


def _bent(mjm, mjd, rng):
  """The JAX package's test's bent cable: random ball-joint rotations of
  up to 0.25 rad and 0.1 randn velocities."""
  mujoco.mj_resetData(mjm, mjd)
  for j in range(mjm.njnt):
    if mjm.jnt_type[j] == mujoco.mjtJoint.mjJNT_BALL:
      adr = mjm.jnt_qposadr[j]
      axis = rng.randn(3)
      axis /= np.linalg.norm(axis)
      ang = 0.25 * rng.rand()
      mjd.qpos[adr:adr + 4] = np.concatenate(
          [[np.cos(ang / 2)], np.sin(ang / 2) * axis])
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)


def test_cable_passive_matches_c_and_jax():
  """qfrc_passive at the JAX package's test's 4 bent states (one batch of
  4 lanes) against C (1e-6) and the JAX package (1e-9); the instance's
  stiffness, lengths, reference curvature and joint addresses equal the
  JAX package's."""
  mjm = mujoco.MjModel.from_xml_string(test_plugins._cable_xml())
  mjd = mujoco.MjData(mjm)
  mj = mi.put_model(mjm)
  m = mt.put_model(mjm, device="cpu")
  rng = np.random.RandomState(0)
  qpos, qvel, ref = [], [], []
  for _ in range(4):
    _bent(mjm, mjd, rng)
    qpos.append(mjd.qpos.copy())
    qvel.append(mjd.qvel.copy())
    ref.append(mjd.qfrc_passive.copy())
  qpos, qvel = np.array(qpos), np.array(qvel)
  d = mt.forward(m, mt.make_data(m, 4).replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
  dj = jax.jit(jax.vmap(lambda q, v: mi.forward(mj, mi.make_data(mj).replace(
      qpos=q, qvel=v))))(jnp.asarray(qpos), jnp.asarray(qvel))
  got = d.qfrc_passive.numpy()
  assert np.abs(np.array(ref)).max() > 0
  np.testing.assert_allclose(got, np.array(ref), rtol=0, atol=1e-6)
  np.testing.assert_allclose(got, np.asarray(dj.qfrc_passive), rtol=0,
                             atol=1e-9)
  inst, jinst = m.plugin_hooks[0], mj.plugin_hooks[0]
  for k in ("_K", "_L", "_omega0"):
    np.testing.assert_array_equal(getattr(inst, k), getattr(jinst, k),
                                  err_msg=k)
  np.testing.assert_array_equal(inst._body_quat, jinst._body_quat[1:])
  np.testing.assert_array_equal(inst.qadr, jinst.qadr)
  np.testing.assert_array_equal(inst.bodies, jinst.bodies)


def test_cable_rollout_matches_c():
  """The cable swinging from rest: 100 steps against C, qpos 1e-6 and
  qvel 1e-5 (the JAX package's test)."""
  mjm = mujoco.MjModel.from_xml_string(test_plugins._cable_xml())
  mjd = mujoco.MjData(mjm)
  m = mt.put_model(mjm, device="cpu")
  d = mt.step_n(m, mt.make_data(m, 1), 100)
  for _ in range(100):
    mujoco.mj_step(mjm, mjd)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, rtol=0, atol=1e-6)
  np.testing.assert_allclose(d.qvel[0].numpy(), mjd.qvel, rtol=0, atol=1e-5)


TOUCH_CASES = [
    dict(size="3 3", nchannel="1"),
    dict(size="7 5", fov="45 30", nchannel="3"),
    dict(size="5 5", gamma="0.7", nchannel="6"),
]


@pytest.mark.parametrize("cfg", TOUCH_CASES)
def test_touch_grid_matches_c_and_jax(cfg):
  """The taxel sums of the pressed sphere (the JAX package's test's three
  grids) against C (1e-6) and the JAX package (1e-9); the bin edges equal
  the JAX package's."""
  mjm = mujoco.MjModel.from_xml_string(test_plugins._touch_grid_xml(**cfg))
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0 and np.abs(mjd.sensordata).max() > 0
  mj = mi.put_model(mjm)
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.put_data(m, mjd))
  dj = jax.jit(lambda dd: mi.forward(mj, dd))(mi.put_data(mj, mjd))
  got = d.sensordata[0].numpy()
  np.testing.assert_allclose(got, mjd.sensordata, rtol=0, atol=1e-6)
  np.testing.assert_allclose(got, np.asarray(dj.sensordata), rtol=0,
                             atol=1e-9)
  inst, jinst = m.plugin_hooks[0], mj.plugin_hooks[0]
  np.testing.assert_array_equal(inst.x_edges, jinst._x_edges)
  np.testing.assert_array_equal(inst.y_edges, jinst._y_edges)
  assert inst.nchannel == jinst.nchannel and inst.size == jinst.size


class registry_kept:
  """Restores the registry's entry of ``name`` after the block."""

  def __init__(self, name=None, factory=None):
    self.name, self.factory = name, factory

  def __enter__(self):
    self.saved = dict(registry._REGISTRY)
    if self.name is not None:
      if self.factory is None:
        registry._REGISTRY.pop(self.name)
      else:
        registry._REGISTRY[self.name] = self.factory

  def __exit__(self, *exc):
    registry._REGISTRY.clear()
    registry._REGISTRY.update(self.saved)


class _Bare(registry.PluginInstance):
  """A registered plugin's port that implements no hook."""

  def __init__(self, f, instance, attrs):
    pass


@pytest.mark.parametrize("case", ["unknown", "sensor_hook", "sdf", "shell"])
def test_plugin_refusals_by_name(case):
  """Refused by name at load: a plugin the port has not registered, a
  PLUGIN sensor whose port has no sensor hook, an SDF geom whose port has
  no distance, and the shell (its C plugin is not in the wheel, so its
  refusal goes through snapshot fields naming it)."""
  if case == "shell":
    f = io.compile_mjcf(str(mt.asset_path("plugin_pid.xml")))[1]
    f["plugin_name"] = np.array(["mujoco.elasticity.shell"])
    f["plugin_attr"] = np.array(["poisson=0.2\nyoung=3e3\nthickness=0.02"])
    f["actuator_plugin"] = np.full_like(f["actuator_plugin"], -1)
    with pytest.raises(NotImplementedError,
                       match="plugin 'mujoco.elasticity.shell'"):
      mt.put_model(f, device="cpu")
    return
  name, xml, match = {
      "unknown": ("mujoco.sensor.touch_grid",
                  test_plugins._touch_grid_xml(),
                  "plugin 'mujoco.sensor.touch_grid'"),
      "sensor_hook": ("mujoco.sensor.touch_grid",
                      test_plugins._touch_grid_xml(),
                      "sensor plugin 'mujoco.sensor.touch_grid'"),
      "sdf": ("mujoco.sdf.torus", plugin_models.SCENES["sdf_torus"][1],
              "SDF geom backed by plugin 'mujoco.sdf.torus'"),
  }[case]
  f = io.compile_mjcf(xml)[1]
  factory = None if case == "unknown" else _Bare
  with registry_kept(name, factory):
    with pytest.raises(NotImplementedError, match=match):
      mt.put_model(f, device="cpu")
  mt.put_model(f, device="cpu")


@pytest.mark.parametrize("name", ["plugin_cable", "plugin_pid",
                                  "plugin_touch_grid"])
def test_snapshot_instances_equal_the_mjmodels(name):
  """Each instance's static data built from the committed snapshot alone
  (as on the card) equals the one built from the compiled MjModel: the
  cable's stiffness, lengths and curvature, the PID's gains and slots, the
  touch grid's bin edges (the sdflib grid:
  tests/test_torch_sdflib_scene.py)."""
  import mujoco

  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  a = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu").plugin_hooks
  b = mt.put_model(mjm, device="cpu").plugin_hooks
  assert [h.name for h in a] == [h.name for h in b] and a
  for x, y in zip(a, b):
    assert sorted(vars(x)) == sorted(vars(y))
    for k, v in vars(x).items():
      np.testing.assert_array_equal(np.asarray(v), np.asarray(vars(y)[k]),
                                    err_msg=f"{name} {k}")
