"""The PyTorch port's sensor tail against C MuJoCo and the JAX package:
the rangefinder, touch and distance sensors, cameras and the camera
sensors, the limit sensors, USER sensors, and what stays refused.

f64 on the CPU, each scene as one fleet.  ``tests/test_sensor_tail.py``'s
SCENE (a ball resting on the floor and the same ball in the air) and CAMS
scenes against C (1e-7, and C's 1e-12 on the camera frames) and the JAX
package's jitted ``forward`` (1e-9); the port's own camera scene
(``assets/sensor_cams.xml``: every camera mode, projections through the
field of view and through a lens's intrinsics, frame sensors on cameras)
and that test's camera-frame scene at four seeded lanes against C (1e-9)
and, where the JAX package follows C, against it; the limit sensors (``assets/sensor_limits.xml``: hinge,
slide, ball and tendon limits) at four seeded lanes with limits active
against C and the JAX package (1e-9 of max(1, |value|)); the distance
sensors over each pair kind they are computed for against C (1e-12); USER
sensors
against C's ``mjcb_sensor`` and the JAX package's ``user_sensor_fn``; the
refusals that remain, by name; the vendored scenes against their sources
and snapshots.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import inspect
import os
import re
import sys

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import (
    ObjType,
    PORTED_SENSORS,
    SensorType,
)

import test_sensor_tail
import test_transmission

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import sensor_tail_models  # noqa: E402

INPUTS = ("qpos", "qvel", "ctrl", "qfrc_applied", "time")


def fleet(mp, mjds):
  return mt.from_jax_arrays(mp, {
      k: np.stack([np.atleast_1d(np.array(getattr(x, k))) for x in mjds])
      for k in INPUTS})


def jax_forward(mjm, mjds, **kw):
  """The JAX package's forward of the states, one vmapped jit."""
  mj = mi.put_model(mjm, **kw)
  dj = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                              *[mi.put_data(mj, x) for x in mjds])
  return jax.jit(jax.vmap(mi.forward, in_axes=(None, 0)))(mj, dj)


def test_scene_touch_rangefinder_and_distance_match_c_and_jax():
  """SCENE's ball after 400 C steps (resting: touch reads its weight) and
  at its start (in the air: the rangefinder, blind to its own body, sees
  the floor 0.5 below)."""
  mjm = mujoco.MjModel.from_xml_string(test_sensor_tail.SCENE)
  rest, air = mujoco.MjData(mjm), mujoco.MjData(mjm)
  for _ in range(400):
    mujoco.mj_step(mjm, rest)
  for mjd in (rest, air):
    mujoco.mj_forward(mjm, mjd)
  mp = mt.put_model(mjm, device="cpu")
  sd = mt.forward(mp, fleet(mp, [rest, air])).sensordata.numpy()
  ref = np.stack([rest.sensordata, air.sensordata])
  np.testing.assert_allclose(sd, ref, rtol=0, atol=1e-7)
  np.testing.assert_allclose(
      sd, np.asarray(jax_forward(mjm, [rest, air]).sensordata), rtol=0,
      atol=1e-9 * max(1.0, np.abs(ref).max()))
  assert abs(sd[0, 0] - 9.81) < 1e-6 and sd[1, 0] == 0.0
  assert abs(sd[1, 1] - 0.5) < 1e-9


def test_cams_match_c_and_jax():
  """CAMS at qpos 0.4: the camera frames of each mode (1e-12) and the
  projection (1e-9) against C and the JAX package."""
  mjm = mujoco.MjModel.from_xml_string(test_sensor_tail.CAMS)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = 0.4
  mujoco.mj_forward(mjm, mjd)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, fleet(mp, [mjd]))
  dj = jax_forward(mjm, [mjd])
  for ref, tol in ((mjd, 1e-12), (None, 1e-12)):
    xpos = mjd.cam_xpos if ref else np.asarray(dj.cam_xpos)[0]
    xmat = mjd.cam_xmat if ref else np.asarray(dj.cam_xmat)[0].reshape(-1, 9)
    np.testing.assert_allclose(d.cam_xpos[0].numpy(), xpos, rtol=0, atol=tol)
    np.testing.assert_allclose(d.cam_xmat[0].numpy().reshape(-1, 9), xmat,
                               rtol=0, atol=tol)
  np.testing.assert_allclose(d.sensordata[0].numpy(), mjd.sensordata,
                             rtol=0, atol=1e-9)
  np.testing.assert_allclose(d.sensordata.numpy(), np.asarray(dj.sensordata),
                             rtol=0, atol=1e-9)


def seeded(mjm, seed, scale):
  """An MjData at qpos0 moved by ``scale`` randn in each dof's tangent
  direction, with randn qvel, ctrl and 0.3 randn qfrc_applied, after
  mj_forward."""
  rng = np.random.RandomState(seed)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_integratePos(mjm, mjd.qpos, scale * rng.randn(mjm.nv), 1.0)
  mjd.qvel[:] = rng.randn(mjm.nv)
  mjd.ctrl[:] = rng.randn(mjm.nu)
  mjd.qfrc_applied[:] = 0.3 * rng.randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  return mjd


# tests/test_sensor_tail.py::test_camera_frame_sensors_match_c's scene
CAMERA_FRAME = """
  <mujoco>
    <worldbody>
      <body pos="0 0 1">
        <joint name="j0" type="ball"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
        <camera name="cam" pos="0.1 0.05 0.2" euler="20 30 10"/>
      </body>
      <body pos="1 0 1">
        <joint type="hinge" axis="0 0 1"/>
        <geom type="sphere" size="0.05" mass="0.5"/>
        <camera name="cam2" pos="0 0 0.1"/>
      </body>
    </worldbody>
    <sensor>
      <framepos objtype="camera" objname="cam"/>
      <framequat objtype="camera" objname="cam"/>
      <framexaxis objtype="camera" objname="cam"/>
      <framelinvel objtype="camera" objname="cam"/>
      <frameangvel objtype="camera" objname="cam"/>
      <framelinacc objtype="camera" objname="cam"/>
      <framepos objtype="camera" objname="cam" reftype="camera"
                refname="cam2"/>
    </sensor>
  </mujoco>
  """


@pytest.mark.parametrize("scene", ["sensor_cams", "camera_frame"])
def test_camera_sensors_match_c(scene):
  """assets/sensor_cams.xml and the JAX test's camera-frame scene at four
  seeded lanes (swung by 1.5 randn): every camera's frame (1e-12) and
  every sensor (1e-9) against C.
  Where the JAX package departs from C (ROADMAP §3), the port follows C: a
  camera's FRAMEQUAT is C's body quaternion times the camera's, whatever
  its mode (the JAX package reads it off the camera's frame, which differs
  in sign or, for a camera that looks at a target, altogether), and C forms
  a lens's focal length from its intrinsics in float (the JAX package in
  double: 4e-6 px apart).  Against the JAX package every other sensor
  (1e-9); those two differ on some lane."""
  if scene == "camera_frame":
    assert CAMERA_FRAME in inspect.getsource(
        test_sensor_tail.test_camera_frame_sensors_match_c)
    mjm = mujoco.MjModel.from_xml_string(CAMERA_FRAME)
    mp = mt.put_model(mjm, device="cpu")
  else:
    mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{scene}.xml")))
    mp = mt.put_model(mt.asset_path(f"{scene}.npz"), device="cpu")
  mjds = [seeded(mjm, seed, 1.5) for seed in range(4)]
  d = mt.forward(mp, fleet(mp, mjds))
  for k, mjd in enumerate(mjds):
    np.testing.assert_allclose(d.cam_xpos[k].numpy(), mjd.cam_xpos, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(d.cam_xmat[k].numpy().reshape(-1, 9),
                               mjd.cam_xmat, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.sensordata[k].numpy(), mjd.sensordata,
                               rtol=0, atol=1e-9, err_msg=f"lane {k}")
  def cells(sel):
    mask = np.zeros(mjm.nsensordata, bool)
    for i in np.nonzero(sel)[0]:
      mask[mjm.sensor_adr[i]:mjm.sensor_adr[i] + mjm.sensor_dim[i]] = True
    return mask

  quat = cells((mjm.sensor_type == SensorType.FRAMEQUAT)
               & (mjm.sensor_objtype == ObjType.CAMERA))
  lens = cells((mjm.sensor_type == SensorType.CAMPROJECTION)
               & (mjm.cam_sensorsize[mjm.sensor_refid, 0] > 0))
  sd = d.sensordata.numpy()
  sj = np.asarray(jax_forward(mjm, mjds).sensordata)
  same = ~quat & ~lens
  np.testing.assert_allclose(sd[:, same], sj[:, same], rtol=0, atol=1e-9)
  if scene == "sensor_cams":
    assert np.abs(sd[:, quat] - sj[:, quat]).max() > 0.1
    assert np.abs(sd[:, lens] - sj[:, lens]).max() > 1e-7
    assert set(mjm.cam_mode.tolist()) == {0, 1, 2, 3, 4}


def test_limit_sensors_match_c_and_jax():
  """assets/sensor_limits.xml at four seeded lanes, the joints swung by
  1.2 randn so that limits are hit: the limit sensors' distances,
  velocities and forces against C and the JAX package, 1e-9 of max(1,
  |value|); each kind reads a nonzero value on some lane."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("sensor_limits.xml")))
  mjds = [seeded(mjm, seed, 1.2) for seed in range(4)]
  mp = mt.put_model(mt.asset_path("sensor_limits.npz"), device="cpu")
  sd = mt.forward(mp, fleet(mp, mjds)).sensordata.numpy()
  ref = np.stack([x.sensordata for x in mjds])
  scale = np.maximum(1.0, np.abs(ref))
  assert np.all(np.abs(sd - ref) <= 1e-9 * scale), np.abs(sd - ref).max()
  sj = np.asarray(jax_forward(mjm, mjds).sensordata)
  assert np.all(np.abs(sd - sj) <= 1e-9 * scale), np.abs(sd - sj).max()
  assert np.all(np.abs(ref).max(0) > 0), ref



DISTANCE_GEOMS = {
    "plane": 'type="plane" size="2 2 0.1" euler="8 -5 0"',
    "sphere": 'type="sphere" size="0.1"',
    "capsule": 'type="capsule" size="0.05 0.15"',
    "box": 'type="box" size="0.1 0.07 0.05"',
    "cylinder": 'type="cylinder" size="0.08 0.1"',
}


@pytest.mark.parametrize("kind", [
    "plane-sphere", "plane-capsule", "plane-box", "plane-cylinder",
    "sphere-sphere", "sphere-capsule", "sphere-box", "capsule-capsule"])
def test_distance_sensors_match_c(kind):
  """GEOMDIST, GEOMNORMAL and GEOMFROMTO over each pair kind the port
  computes them for (the closed-form narrowphases at margin = cutoff), the
  second geom on a free body at 12 seeded poses about the first, into it,
  separated within the cutoff 0.3 and beyond it (the cutoff and zeros):
  against C's ``mj_geomDistance``, 1e-12."""
  a, b = kind.split("-")
  xml = f"""<mujoco><worldbody><geom name="g1" {DISTANCE_GEOMS[a]}/>
    <body><freejoint/><geom name="g2" {DISTANCE_GEOMS[b]}/></body>
    </worldbody><sensor>
    <distance geom1="g1" geom2="g2" cutoff="0.3"/>
    <normal geom1="g1" geom2="g2" cutoff="0.3"/>
    <fromto geom1="g1" geom2="g2" cutoff="0.3"/></sensor></mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjds = []
  for seed in range(12):
    rng = np.random.RandomState(seed)
    mjd = mujoco.MjData(mjm)
    r = 0.1 if seed % 2 else 0.45
    mjd.qpos[:3] = rng.uniform(-r, r, 3)
    if a == "plane":
      mjd.qpos[2] = rng.uniform(-0.05, 0.6)
    q = rng.randn(4)
    mjd.qpos[3:] = q / np.linalg.norm(q)
    mujoco.mj_forward(mjm, mjd)
    mjds.append(mjd)
  mp = mt.put_model(mjm, device="cpu")
  sd = mt.forward(mp, fleet(mp, mjds)).sensordata.numpy()
  ref = np.stack([x.sensordata for x in mjds])
  np.testing.assert_allclose(sd, ref, rtol=0, atol=1e-12)
  assert (ref[:, 0] < 0).any() and (ref[:, 0] == 0.3).any(), ref[:, 0]


def test_user_sensor_matches_mjcb_sensor_and_jax():
  """tests/test_sensor_tail.py's USER scene and callback at three seeded
  lanes: the port's ``user_sensor_fn`` (B, dim) against C's
  ``mjcb_sensor`` (1e-12) and the JAX package's (1e-12); a USER sensor
  without a function is refused by name."""
  xml = """
  <mujoco>
    <worldbody>
      <body pos="0 0 1">
        <joint name="j0" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
      </body>
    </worldbody>
    <sensor>
      <user dim="2" needstage="vel" datatype="real"/>
      <user dim="1" needstage="pos" datatype="real"/>
    </sensor>
  </mujoco>
  """
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjds = []

  def c_cb(cm, cd, stage):
    if stage == mujoco.mjtStage.mjSTAGE_POS:
      cd.sensordata[2] = 2.0 * cd.qpos[0]
    if stage == mujoco.mjtStage.mjSTAGE_VEL:
      cd.sensordata[0] = cd.qvel[0]
      cd.sensordata[1] = 3.0 * cd.qpos[0]

  mujoco.set_mjcb_sensor(c_cb)
  try:
    for seed in range(3):
      rng = np.random.RandomState(seed)
      mjd = mujoco.MjData(mjm)
      mjd.qpos[0], mjd.qvel[0] = rng.randn(2)
      mujoco.mj_forward(mjm, mjd)
      mjds.append(mjd)
  finally:
    mujoco.set_mjcb_sensor(None)

  def user_fn(m, d, sid):
    if sid == 0:
      return torch.stack([d.qvel[:, 0], 3.0 * d.qpos[:, 0]], dim=-1)
    return 2.0 * d.qpos[:, 0:1]

  def user_fn_jax(m, d, sid):
    if sid == 0:
      return jnp.stack([d.qvel[0], 3.0 * d.qpos[0]])
    return 2.0 * d.qpos[0:1]

  mp = mt.put_model(mjm, device="cpu", user_sensor_fn=user_fn)
  sd = mt.forward(mp, fleet(mp, mjds)).sensordata.numpy()
  np.testing.assert_allclose(sd, np.stack([x.sensordata for x in mjds]),
                             rtol=0, atol=1e-12)
  sj = jax_forward(mjm, mjds, user_sensor_fn=user_fn_jax).sensordata
  np.testing.assert_allclose(sd, np.asarray(sj), rtol=0, atol=1e-12)
  with pytest.raises(NotImplementedError,
                     match="sensor type USER without a user_sensor_fn"):
    mt.put_model(mjm, device="cpu")


REFUSED = """<mujoco>
  <asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <geom name="box" type="box" size="0.1 0.1 0.1" pos="1 0 0.1"/>
    <camera name="cam" pos="0 -1 1" xyaxes="1 0 0 0 1 1"/>
    <body name="b" pos="0 0 0.5">
      <joint name="j" type="hinge" axis="0 1 0" range="-1 1"/>
      <geom name="g" type="capsule" size="0.02" fromto="0 0 0 0.2 0 0"/>
      <geom name="mg" type="mesh" mesh="m" contype="0" conaffinity="0"/>
      <site name="s" pos="0.2 0 0"/>
    </body>
  </worldbody>
  <tendon><fixed name="t"><joint joint="j" coef="1"/></fixed></tendon>
  <sensor>SENSOR</sensor>
</mujoco>"""

# what this slice leaves refused: (the sensor, the name it is refused by)
REFUSALS = {
    "insidesite": ('<insidesite site="s" objtype="geom" objname="g"/>',
                   "sensor type INSIDESITE"),
    "contact": ('<contact geom1="g"/>', "sensor type CONTACT"),
    "tactile": ('<tactile geom="mg" mesh="m"/>', "sensor type TACTILE"),
    "tendonactfrc": ('<tendonactuatorfrc tendon="t"/>',
                     "sensor type TENDONACTFRC"),
    "rangefinder-camera": ('<rangefinder camera="cam"/>',
                           "sensor object type CAMERA (RANGEFINDER)"),
    "rangefinder-data": ('<rangefinder site="s" data="dist dir"/>',
                         "RANGEFINDER output other than the distance"),
    "geomdist-capsule-box": ('<distance geom1="g" geom2="box"/>',
                             "GEOMDIST sensor over geom pair CAPSULE-BOX"),
    "geomnormal-mesh": ('<normal geom1="mg" geom2="floor"/>',
                        "GEOMNORMAL sensor over geom pair PLANE-MESH"),
    "user": ('<user dim="1" needstage="acc"/>',
             "sensor type USER without a user_sensor_fn"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_that_remain(name):
  """Every sensor type the port does not compute (PLUGIN sensors are
  computed since the plugin slice; one the port cannot compute is
  test_torch_sensor.py's case), mujoco 3.10's rangefinder on a camera and
  its outputs beyond the distance, distance sensors over pairs without a
  closed-form narrowphase, and a USER sensor without a function are
  refused by name."""
  element, what = REFUSALS[name]
  mjm = mujoco.MjModel.from_xml_string(REFUSED.replace("SENSOR", element))
  with pytest.raises(NotImplementedError, match=re.escape(what)):
    mt.put_model(mjm, device="cpu")
  left = {SensorType[n] for n in ("INSIDESITE", "CONTACT", "TACTILE",
                                  "TENDONACTFRC")}
  assert set(SensorType) - PORTED_SENSORS == left


def test_vendored_scenes_are_current(tmp_path):
  """The script's copies equal the JAX tests' strings; every committed
  XML is what the script writes, every snapshot what save_model_snapshot
  writes of it, and the port loads each."""
  assert sensor_tail_models.SLIDERCRANK == test_transmission.SLIDERCRANK
  assert sensor_tail_models.REFSITE == test_transmission.REFSITE
  assert sensor_tail_models.ADHESION == test_transmission.ADHESION
  assert sensor_tail_models.SCENE == test_sensor_tail.SCENE
  for name in sensor_tail_models.SCENES:
    path = mt.asset_path(f"{name}.xml")
    assert path.read_text() == sensor_tail_models.vendored(name), name
    fresh = tmp_path / f"{name}.npz"
    mt.save_model_snapshot(mujoco.MjModel.from_xml_path(str(path)), fresh)
    with np.load(mt.asset_path(f"{name}.npz")) as committed, np.load(
        fresh) as written:
      assert sorted(committed.files) == sorted(written.files)
      for k in written.files:
        np.testing.assert_array_equal(committed[k], written[k],
                                      err_msg=f"{name} {k}")
    mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
