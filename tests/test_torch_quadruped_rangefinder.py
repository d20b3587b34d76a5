"""dm_control's quadruped with its 20 rangefinders in the PyTorch port, in
float64 on the CPU, against the JAX package and C MuJoCo: the slice as a
whole.

* ``assets/quadruped_rangefinder.xml`` is ``scripts/dm_suite_models.py``'s
  vendoring of ``quadruped.make_model(floor_size=10, rangefinders=True)``
  (the escape task's 32 sensors on the walk task's floor), the snapshot is
  what ``save_model_snapshot`` writes of it, and both compile to
  dm_control's own sensor table;
* ``forward`` and 5 ``step``s of 4 seeded upright lanes standing on their
  toes (sphere-plane contacts, closed forms in the port and C): sensordata
  within 1e-9 of max(1, max|ref|) of the JAX package's jitted step and
  within 1e-7 of it of C's (the step's sensordata is that of the state it
  steps from), qpos after the 5 steps likewise;
* the fp32 rangefinders of 64 of the walk task's starts against fp64: the
  same geom hit by each ray and distances within 1e-4, but for rays that
  graze a silhouette (counted, at most 2 of 1280).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import SensorType
from mujoco_inversedynamicstest_tpu_torch.ops import ray

import test_torch_quadruped

NAME = "quadruped_rangefinder"
STEPS = 5


def _mjmodel():
  return mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{NAME}.xml")))


def test_vendored_model_is_make_model_output(tmp_path):
  import sys, os
  sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                  "scripts"))
  import dm_suite_models
  from dm_control.suite import common

  assert mt.asset_path(f"{NAME}.xml").read_text() == (
      dm_suite_models.vendored(NAME))
  a = _mjmodel()
  b = mujoco.MjModel.from_xml_string(dm_suite_models.dm_xml(NAME),
                                     common.ASSETS)
  for field in ("sensor_type", "sensor_objtype", "sensor_objid",
                "sensor_dim", "sensor_intprm", "sensor_cutoff", "site_pos",
                "site_quat", "site_bodyid", "body_mass", "geom_size",
                "geom_type", "geom_group", "jnt_range", "actuator_gainprm"):
    np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                  err_msg=field)
  # the stripped materials hid nothing from a ray: every geom is opaque
  assert np.all(b.geom_rgba[:, 3] > 0) and np.all(b.mat_rgba[:, 3] > 0)
  fresh = tmp_path / "snap.npz"
  mt.save_model_snapshot(a, fresh)
  with np.load(mt.asset_path(f"{NAME}.npz")) as committed, np.load(
      fresh) as written:
    assert sorted(committed.files) == sorted(written.files)
    for k in written.files:
      np.testing.assert_array_equal(committed[k], written[k], err_msg=k)
  m = mt.put_model(mt.asset_path(f"{NAME}.npz"), device="cpu")
  assert (m.nv, m.nsensor, m.nsensordata) == (22, 32, 56)
  assert int(np.sum(m.sensor_type == SensorType.RANGEFINDER)) == 20


def upright(mjm, n, seed):
  """n MjData standing on their toes: a random yaw and a 0.05 randn tilt,
  the hinges 0.1 randn about qpos0, lowered until the lowest toe is 1 mm
  into the floor; qvel 0.1 randn, controls uniform in ctrlrange."""
  rng = np.random.RandomState(seed)
  toes = np.nonzero(mjm.geom_type == mujoco.mjtGeom.mjGEOM_SPHERE)[0]
  out = []
  for _ in range(n):
    mjd = mujoco.MjData(mjm)
    yaw = rng.uniform(0, 2 * np.pi)
    q = np.r_[np.cos(yaw / 2), 0.05 * rng.randn(2), np.sin(yaw / 2)]
    mjd.qpos[3:7] = q / np.linalg.norm(q)
    mjd.qpos[7:] += 0.1 * rng.randn(mjm.nq - 7)
    mjd.qpos[2] = 1.0
    mujoco.mj_kinematics(mjm, mjd)
    low = (mjd.geom_xpos[toes, 2] - mjm.geom_size[toes, 0]).min()
    mjd.qpos[2] -= low + 0.001
    mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
    mjd.ctrl[:] = rng.uniform(*mjm.actuator_ctrlrange.T)
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def test_forward_and_steps_match_jax_and_c():
  mjm = _mjmodel()
  mjds = upright(mjm, 4, seed=3)
  for mjd in mjds:
    kinds = {(int(mjm.geom_type[c.geom1]), int(mjm.geom_type[c.geom2]))
             for c in mjd.contact}
    assert mjd.ncon >= 1 and kinds == {(0, 2)}, kinds
  mp = mt.put_model(mt.asset_path(f"{NAME}.npz"), device="cpu")
  d = mt.from_jax_arrays(mp, {k: np.stack([getattr(x, k) for x in mjds])
                              for k in ("qpos", "qvel", "ctrl")})
  mj = mi.put_model(mjm)
  dj = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                              *[mi.put_data(mj, x) for x in mjds])
  step_j = jax.jit(jax.vmap(mi.step, in_axes=(None, 0)))
  rf = mjm.sensor_adr[mjm.sensor_type == SensorType.RANGEFINDER]
  seen = []
  for k in range(STEPS + 1):
    c_sd = np.stack([x.sensordata for x in mjds])
    if k == 0:
      ours = mt.forward(mp, d).sensordata.numpy()
    else:
      ours = d.sensordata.numpy()
      jax_sd = np.asarray(dj.sensordata)
      scale = max(1.0, np.abs(jax_sd).max())
      np.testing.assert_allclose(ours, jax_sd, rtol=0, atol=1e-9 * scale,
                                 err_msg=f"step {k} vs JAX")
    scale = max(1.0, np.abs(c_sd).max())
    np.testing.assert_allclose(ours, c_sd, rtol=0, atol=1e-7 * scale,
                               err_msg=f"step {k} vs C")
    seen.append(ours[:, rf])
    if k < STEPS:
      for mjd in mjds:
        mujoco.mj_step(mjm, mjd)
      d = mt.step(mp, d)
      dj = step_j(mj, dj)
  np.testing.assert_allclose(d.qpos.numpy(), np.asarray(dj.qpos), rtol=0,
                             atol=1e-9)
  np.testing.assert_allclose(d.qpos.numpy(), np.stack([x.qpos for x in mjds]),
                             rtol=0, atol=1e-7)
  seen = np.concatenate(seen)
  # rays that hit the floor, the legs, and that miss (-1)
  assert (seen == -1).any() and (seen > 0).sum() > seen.size // 4


def test_fp32_rangefinders_match_fp64():
  mjm = _mjmodel()
  states = test_torch_quadruped._states(mjm, 64, 11)
  sites = mjm.sensor_objid[mjm.sensor_type == SensorType.RANGEFINDER]
  hits = []
  for dtype in (torch.float64, torch.float32):
    mp = mt.put_model(mt.asset_path(f"{NAME}.npz"), device="cpu",
                      dtype=dtype)
    d = mt.from_jax_arrays(mp, {"qpos": np.stack([s[0] for s in states])})
    d = mt.fwd_position(mp, d)
    s = torch.as_tensor(sites)
    hits.append(ray.ray(mp, d, d.site_xpos[:, s], d.site_xmat[:, s, :, 2],
                        bodyexclude=mp.site_bodyid[sites]))
  (d64, g64), (d32, g32) = hits
  graze = (g64 != g32).numpy()
  err = (d64 - d32.double()).abs().numpy()[~graze]
  print(f"{graze.sum()} grazing rays of {graze.size}, max |ddist| "
        f"{err.max():.3e}")
  assert graze.sum() <= 2 and err.max() <= 1e-4
  assert (g64 >= 0).float().mean() > 0.25
