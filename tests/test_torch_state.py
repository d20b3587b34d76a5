"""The PyTorch port's state-vector API (``ops/support.py``: ``state_size``,
``get_state``, ``set_state``) and the rest of its ``support`` helpers
(``apply_ft``, ``full_m``, ``object_velocity``).

On four vendored models (``actuated``, ``mocap_weld``, ``weld``,
``tendon_arm``), each with random qpos, qvel, act, ctrl, applied forces,
warm start, time, mocap poses and eq_active, in float64:

* ``state_size`` and ``get_state`` equal C's ``mj_stateSize`` and
  ``mj_getState`` exactly (atol 0) for every single ``mjtState`` bit of the
  installed mujoco and each composite, read from ``mujoco.mjtState``;
* ``set_state`` round-trips exactly, and a batch of three lanes gives
  each lane's C vector;
* against the JAX ``support.get_state``, flags mapped by name (its
  ``StateFlag`` carries mujoco 3.3.1's bits), exactly;
* the helpers against C (``mj_applyFT``, ``mj_fullM``,
  ``mj_objectVelocity``) within 1e-12.
"""

import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.models.types import StateFlag as JaxFlag
from mujoco_inversedynamicstest_tpu.ops import support as jax_support
from mujoco_inversedynamicstest_tpu_torch.models.types import StateFlag
from mujoco_inversedynamicstest_tpu_torch.ops import support

MODELS = ("actuated", "mocap_weld", "weld", "tendon_arm")
BITS = [k[len("mjSTATE_"):] for k in dir(mujoco.mjtState)
        if k.startswith("mjSTATE_")]
_CACHE = {}


def c_model(name):
  if name not in _CACHE:
    mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
    _CACHE[name] = (mjm, mt.put_model(mjm, device="cpu"))
  return _CACHE[name]


def seeded(mjm, seed):
  """An MjData with every input of the state vector random."""
  rng = np.random.RandomState(seed)
  mjd = mujoco.MjData(mjm)
  mjd.time = rng.uniform(0, 3)
  mujoco.mj_integratePos(mjm, mjd.qpos, 0.3 * rng.randn(mjm.nv), 1.0)
  mjd.qvel[:] = 0.5 * rng.randn(mjm.nv)
  mjd.act[:] = rng.uniform(0, 1, mjm.na)
  mjd.ctrl[:] = rng.uniform(-1, 1, mjm.nu)
  mjd.qacc_warmstart[:] = rng.randn(mjm.nv)
  mjd.qfrc_applied[:] = rng.randn(mjm.nv)
  mjd.xfrc_applied[:] = rng.randn(mjm.nbody, 6)
  mjd.mocap_pos[:] = rng.randn(mjm.nmocap, 3)
  quat = rng.randn(mjm.nmocap, 4)
  mjd.mocap_quat[:] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
  mjd.eq_active[:] = rng.uniform(size=mjm.neq) < 0.5
  return mjd


def c_state(mjm, mjd, spec):
  out = np.zeros(mujoco.mj_stateSize(mjm, spec))
  mujoco.mj_getState(mjm, mjd, out, spec)
  return out


def test_flags_are_the_installed_mujocos():
  for name in BITS:
    assert int(StateFlag[name]) == int(getattr(mujoco.mjtState,
                                               f"mjSTATE_{name}")), name


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("flag", BITS)
def test_get_state_matches_c(name, flag):
  mjm, m = c_model(name)
  mjd = seeded(mjm, 1)
  d = mt.put_data(m, mjd)
  spec = int(getattr(mujoco.mjtState, f"mjSTATE_{flag}"))
  assert support.state_size(m, spec) == mujoco.mj_stateSize(mjm, spec)
  ours = support.get_state(m, d, spec)
  assert ours.shape == (1, mujoco.mj_stateSize(mjm, spec))
  np.testing.assert_allclose(ours[0].numpy(), c_state(mjm, mjd, spec),
                             rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_set_state_round_trips(name):
  mjm, m = c_model(name)
  mjd = seeded(mjm, 2)
  spec = StateFlag.INTEGRATION
  vec = torch.as_tensor(c_state(mjm, mjd, spec))[None]
  d = support.set_state(m, mt.make_data(m, 1), vec, spec)
  np.testing.assert_array_equal(support.get_state(m, d, spec).numpy(),
                                vec.numpy())
  ref = mt.put_data(m, mjd)
  for field in ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart",
                "qfrc_applied", "xfrc_applied", "eq_active", "mocap_pos",
                "mocap_quat"):
    got, want = getattr(d, field), getattr(ref, field)
    assert got.dtype == want.dtype and torch.equal(got, want), field


@pytest.mark.parametrize("name", MODELS)
def test_batched_lanes_match_c(name):
  """Three lanes in one Data: get_state's rows are C's vectors, and
  set_state writes each lane's."""
  mjm, m = c_model(name)
  spec = StateFlag.INTEGRATION
  datas = [seeded(mjm, 10 + i) for i in range(3)]
  fields = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart",
            "qfrc_applied", "xfrc_applied", "eq_active", "mocap_pos",
            "mocap_quat")
  d = mt.from_jax_arrays(m, {f: np.stack([np.array(getattr(x, f))
                                          for x in datas]) for f in fields})
  ref = np.stack([c_state(mjm, x, spec) for x in datas])
  np.testing.assert_array_equal(support.get_state(m, d, spec).numpy(), ref)
  back = support.set_state(m, mt.make_data(m, 3), torch.as_tensor(ref), spec)
  np.testing.assert_array_equal(support.get_state(m, back, spec).numpy(), ref)


def test_set_state_refuses_a_wrong_size():
  _, m = c_model("actuated")
  d = mt.make_data(m, 2)
  n = support.state_size(m, StateFlag.PHYSICS)
  with pytest.raises(ValueError):
    support.set_state(m, d, torch.zeros(2, n + 1, dtype=torch.float64),
                      StateFlag.PHYSICS)
  with pytest.raises(ValueError):
    support.get_state(m, d, 1 << 14)


# JAX StateFlag names (mujoco 3.3.1's layout), each with the same fields
JAX_FLAGS = [f.name for f in JaxFlag] + ["PHYSICS", "FULLPHYSICS", "USER",
                                         "INTEGRATION"]


@pytest.mark.parametrize("name", ["actuated", "mocap_weld", "weld"])
@pytest.mark.parametrize("flag", JAX_FLAGS)
def test_get_state_matches_jax(name, flag):
  mjm, m = c_model(name)
  mjd = seeded(mjm, 3)
  ours = support.get_state(m, mt.put_data(m, mjd), StateFlag[flag])[0]
  jm = mi.put_model(mjm)
  ref = jax_support.get_state(jm, mi.put_data(jm, mjd), JaxFlag[flag])
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_jax_flags_differ_from_the_installed_mujocos():
  """The JAX package's bits are mujoco 3.3.1's: WARMSTART is 3.10's
  HISTORY.  Which is why the port carries its own."""
  assert int(JaxFlag.WARMSTART) == int(mujoco.mjtState.mjSTATE_HISTORY)
  assert int(JaxFlag.FULLPHYSICS) != int(mujoco.mjtState.mjSTATE_FULLPHYSICS)


@pytest.mark.parametrize("name", MODELS)
def test_support_helpers_match_c(name):
  """apply_ft, full_m and object_velocity against mj_applyFT, mj_fullM
  and mj_objectVelocity (at each body's CoM, world frame) after
  mj_forward, within 1e-12."""
  mjm, m = c_model(name)
  mjd = seeded(mjm, 4)
  mujoco.mj_forward(mjm, mjd)
  d = mt.forward(m, mt.put_data(m, mjd))
  rng = np.random.RandomState(5)
  bodies = np.arange(1, mjm.nbody)
  force, torque = rng.randn(2, len(bodies), 3)
  point = np.array(mjd.xpos[bodies]) + 0.1 * rng.randn(len(bodies), 3)
  ref = np.zeros(mjm.nv)
  for k, b in enumerate(bodies):
    mujoco.mj_applyFT(mjm, mjd, force[k], torque[k], point[k], b, ref)
  t = lambda x: torch.as_tensor(x)[None]
  ours = support.apply_ft(m, d, t(force), t(torque), t(point), bodies)
  np.testing.assert_allclose(ours[0].numpy(), ref, rtol=0, atol=1e-12)

  full = np.zeros((mjm.nv, mjm.nv))
  mujoco.mj_fullM(mjm, mjd, full)
  np.testing.assert_allclose(support.full_m(m, d)[0].numpy(), full, rtol=0,
                             atol=1e-12)

  vel = support.object_velocity(m, d, bodies, d.xipos[:, bodies])[0].numpy()
  for k, b in enumerate(bodies):
    ref = np.zeros(6)
    mujoco.mj_objectVelocity(mjm, mjd, mujoco.mjtObj.mjOBJ_BODY, b, ref, 0)
    np.testing.assert_allclose(vel[k], ref, rtol=0, atol=1e-12,
                               err_msg=str(b))


def test_put_model_refuses_user_data():
  mjm = mujoco.MjModel.from_xml_string(
      '<mujoco><size nuserdata="2"/><worldbody><body><freejoint/>'
      '<geom size=".1"/></body></worldbody></mujoco>')
  with pytest.raises(NotImplementedError, match="nuserdata = 2"):
    mt.put_model(mjm, device="cpu")


def test_jax_state_vector_is_ours_where_the_bits_agree():
  """A FULLPHYSICS vector from the JAX package's layout is the port's (the
  3.10 bits it lacks are empty here), so it feeds ``opt.rollout``."""
  mjm, m = c_model("actuated")
  mjd = seeded(mjm, 6)
  jm = mi.put_model(mjm)
  vec = np.array(jax_support.get_state(jm, mi.put_data(jm, mjd),
                                       JaxFlag.FULLPHYSICS))
  d = support.set_state(m, mt.make_data(m, 1), torch.as_tensor(vec)[None])
  np.testing.assert_array_equal(support.get_state(m, d).numpy()[0], vec)
  np.testing.assert_array_equal(vec, c_state(
      mjm, mjd, mujoco.mjtState.mjSTATE_FULLPHYSICS))
