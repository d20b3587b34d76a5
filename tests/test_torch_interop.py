"""The port's names, keyframes and ``get_data`` (``models/interop.py``).

Names and ids of every object type of the humanoid from its snapshot, in
a process where ``mujoco`` cannot be imported, against C's
``mj_name2id``/``mj_id2name``; ``reset_data_keyframe`` against C's
``mj_resetDataKeyframe`` bit for bit, on every lane and on masked lanes;
``get_data`` against the JAX package's on the pendulum: equal with
``recompute=True``, within 1e-9 with ``recompute=False``.  The snapshots
that carry names are what ``scripts/named_snapshots.py`` writes.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models import interop

from models import PENDULUM

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import named_snapshots  # noqa: E402

MISSES = ("", "nothing", "torso ")


def test_names_from_the_snapshot_match_c():
  code = (
      "import json, sys; sys.modules['mujoco'] = None; "
      f"sys.path.insert(0, {str(REPO)!r}); "
      "import mujoco_inversedynamicstest_tpu_torch as mt; "
      "from mujoco_inversedynamicstest_tpu_torch.models import interop; "
      "m = mt.put_model(mt.asset_path('humanoid.npz'), device='cpu'); "
      "out = {t: [mt.id2name(m, t, i) for i in range(-1, 64)] "
      "for t in interop.OBJECT_NAMES}; "
      "out['nkey'] = mt.nkey(m); "
      "out['ids'] = {t: {n: mt.name2id(m, t, n) for n in "
      "[x for x in out[t] if x] + " + repr(list(MISSES)) + "} "
      "for t in interop.OBJECT_NAMES}; print(json.dumps(out))")
  out = json.loads(subprocess.run([sys.executable, "-c", code], check=True,
                                  capture_output=True, text=True).stdout)
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  assert out["nkey"] == mjm.nkey
  named = 0
  for name, (objtype, _) in interop.OBJECT_NAMES.items():
    want = [mujoco.mj_id2name(mjm, objtype, i) for i in range(-1, 64)]
    assert out[name] == want, name
    for n, got in out["ids"][name].items():
      assert got == mujoco.mj_name2id(mjm, objtype, n), (name, n)
      named += got >= 0
  assert named > 60
  # a type without names (DOF) and mjtObj given as C's enum
  m = mt.put_model(mjm, device="cpu")
  assert mt.id2name(m, mujoco.mjtObj.mjOBJ_DOF, 0) is None
  assert mt.name2id(m, mujoco.mjtObj.mjOBJ_BODY, "torso") == 1


def test_a_snapshot_without_names_raises_by_name():
  m = mt.put_model(mt.asset_path("humanoid_mjx.npz"), device="cpu")
  for fn, args in ((mt.name2id, ("body", "torso")), (mt.nkey, ()),
                   (mt.reset_data_keyframe, (mt.make_data(m, 1), 0))):
    with pytest.raises(ValueError, match="names=True"):
      fn(m, *args)


@pytest.mark.parametrize("name", named_snapshots.NAMED)
def test_named_snapshots_are_current(name, tmp_path):
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  fresh = tmp_path / "snap.npz"
  mt.save_model_snapshot(mjm, fresh, names=True)
  with np.load(mt.asset_path(f"{name}.npz")) as committed, np.load(
      fresh) as written:
    assert sorted(committed.files) == sorted(written.files)
    for k in written.files:
      np.testing.assert_array_equal(committed[k], written[k], err_msg=k)


def test_reset_data_keyframe_matches_c():
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("keyframes.xml")))
  m = mt.put_model(mt.asset_path("keyframes.npz"), device="cpu")
  assert mt.nkey(m) == mjm.nkey == 2
  rng = np.random.RandomState(3)
  d = mt.from_jax_arrays(m, dict(
      qpos=rng.randn(3, m.nq), qvel=rng.randn(3, m.nv),
      ctrl=rng.randn(3, m.nu), act=rng.randn(3, m.na),
      qfrc_applied=rng.randn(3, m.nv), time=rng.rand(3)))
  fields = ("time", "qpos", "qvel", "act", "ctrl", "mocap_pos",
            "mocap_quat", "qacc_warmstart", "qfrc_applied", "xfrc_applied")
  lanes = torch.tensor([True, False, True])
  for key in (0, "reach"):
    k = key if isinstance(key, int) else mujoco.mj_name2id(
        mjm, mujoco.mjtObj.mjOBJ_KEY, key)
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = 1.0
    mujoco.mj_resetDataKeyframe(mjm, mjd, k)
    every = mt.reset_data_keyframe(m, d, key)
    some = mt.reset_data_keyframe(m, d, key, lanes=lanes)
    for f in fields:
      want = np.asarray(getattr(mjd, f)).reshape(getattr(every, f).shape[1:])
      for i in range(3):
        np.testing.assert_array_equal(getattr(every, f)[i].numpy(), want,
                                      err_msg=f"{key} {f}")
        np.testing.assert_array_equal(
            getattr(some, f)[i].numpy(),
            want if lanes[i] else getattr(d, f)[i].numpy(),
            err_msg=f"{key} {f} lane {i}")
  with pytest.raises(KeyError):
    mt.reset_data_keyframe(m, d, "nowhere")
  with pytest.raises(IndexError):
    mt.reset_data_keyframe(m, d, 2)


@pytest.fixture(scope="module")
def pendulum():
  mjm = mujoco.MjModel.from_xml_string(PENDULUM)
  mj, mp = mi.put_model(mjm), mt.put_model(mjm, device="cpu")
  qpos, qvel = np.array([[0.4], [-0.7]]), np.array([[0.3], [1.1]])
  dj = jax.jit(jax.vmap(mi.forward, in_axes=(None, 0)))(
      mj, jax.vmap(lambda q, v: mi.make_data(mj).replace(qpos=q, qvel=v))(
          jnp.asarray(qpos), jnp.asarray(qvel)))
  dp = mt.forward(mp, mt.from_jax_arrays(mp, dict(qpos=qpos, qvel=qvel)))
  return mjm, mj, mp, dj, dp


FIELDS = ("qpos", "qvel", "qacc", "xpos", "xquat", "xmat", "xipos",
          "ximat", "geom_xpos", "geom_xmat", "qfrc_constraint",
          "qfrc_passive", "qfrc_actuator", "qfrc_bias")


@pytest.mark.parametrize("recompute", [True, False])
def test_get_data_matches_jax(pendulum, recompute):
  mjm, mj, mp, dj, dp = pendulum
  for i in range(2):
    ref = mi.get_data(mj, jax.tree.map(lambda x: x[i], dj),
                      recompute=recompute)
    got = mt.get_data(mp, dp, mjm, recompute=recompute, index=i)
    assert got.time == ref.time
    if recompute:
      batch = mt.get_data_batch(mp, dp, i, mjm)
      np.testing.assert_array_equal(batch.qacc, got.qacc)
    for f in FIELDS:
      if recompute:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
      elif f != "qfrc_bias":  # no C forward ran: left at zero by both
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=1e-9, err_msg=f)
