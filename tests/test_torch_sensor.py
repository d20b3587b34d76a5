"""The PyTorch port's sensor stage against the JAX package and C MuJoCo.

f64 on the CPU.  dm_control's humanoid with its 34 sensors
(``assets/humanoid_sensors.xml``) at 8 seeded states, half of them with
the feet or the body on the floor: ``sensordata``, the site frames,
``subtree_vel``, ``rne_postconstraint`` (cacc, cfrc_int, cfrc_ext) and
``contact_forces_frame`` against the JAX package (1e-10, one vmapped jit a
module) and C (``mj_forward``, ``mj_subtreeVel``, ``mj_rnePostConstraint``,
``mj_contactForce``; 1e-8).  ``ray_geom`` of each shape against the JAX
package's and ``mju_rayGeom``; the other ported types on a small model
against C; ``sensordata`` after ``step`` under EULER and RK4 against C
``mj_step``, and ``inverse(skip_sensor=False)`` against C ``mj_inverse``;
the sensor disable flag; ``put_model``'s refusals; the vendored XML.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import jax_reference
import mujoco_inversedynamicstest_tpu as mi
from mujoco_inversedynamicstest_tpu.ops import constraint as jconstraint
from mujoco_inversedynamicstest_tpu.ops import ray as jray
from mujoco_inversedynamicstest_tpu.ops import smooth as jsmooth
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import (
    DisableBit,
    PORTED_SENSORS,
    SensorType,
)
from mujoco_inversedynamicstest_tpu_torch.ops import constraint, ray, sensor
from mujoco_inversedynamicstest_tpu_torch.ops import smooth

INPUTS = ("qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied", "qacc",
          "qacc_warmstart", "time")
# dm_control's own humanoid, the source of humanoid_sensors.xml
DM_CONTROL_XML = os.path.join(
    importlib.util.find_spec("dm_control").submodule_search_locations[0],
    "suite", "humanoid.xml")
# (root height change, lying face down) of the 8 humanoid states: two in
# the air, four standing on the floor, two lying on it on their arms
POSES = ((0.0, False), (0.3, False), (-0.22, False), (-0.24, False),
         (-0.26, False), (-0.25, False), (-1.32, True), (-1.34, True))
TOUCH = slice(48, 66)


def _humanoid():
  return mujoco.MjModel.from_xml_path(
      str(mt.asset_path("humanoid_sensors.xml")))


def _humanoid_states(mjm):
  """The POSES as MjData after mj_forward, from seeded numpy inputs."""
  out = []
  for seed, (dz, lying) in enumerate(POSES):
    mjd = mujoco.MjData(mjm)
    rng = np.random.RandomState(seed)
    mjd.qpos[:] = mjm.qpos0
    mjd.qpos[2] += dz
    if lying:
      mjd.qpos[3:7] = [np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0]
    mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
    mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
    mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
    mjd.qfrc_applied[:] = 0.3 * rng.randn(mjm.nv)
    mjd.xfrc_applied[1:] = 0.3 * rng.randn(mjm.nbody - 1, 6)
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def _port_data(mp, mjds):
  return mt.from_jax_arrays(mp, {
      k: np.stack([np.atleast_1d(np.array(getattr(d, k))) for d in mjds])
      for k in INPUTS})


@pytest.fixture(scope="module")
def humanoid():
  """The 8 humanoid states in C, in the JAX package (one vmapped jit of
  forward, subtree_vel, rne_postconstraint and contact_forces_frame; its
  result stored, ``tests/jax_reference.py``) and in the port (one fleet of
  8 lanes)."""
  mjm = _humanoid()
  mjds = _humanoid_states(mjm)
  names = ("sensordata", "site_xpos", "site_xmat", "linvel", "angmom",
           "cacc", "cfrc_int", "cfrc_ext", "forces")

  def jax_stages():
    mj = mi.put_model(mjm)
    dj = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                *[mi.put_data(mj, d) for d in mjds])

    def stages(m, d):
      out = mi.forward(m, d)
      post = jsmooth.rne_postconstraint(m, out)
      return (out.sensordata, out.site_xpos, out.site_xmat,
              *jsmooth.subtree_vel(m, out), post.cacc, post.cfrc_int,
              post.cfrc_ext, jconstraint.contact_forces_frame(m, out))

    return dict(zip(names, jax.jit(jax.vmap(stages, in_axes=(None, 0)))(
        mj, dj)))

  out = jax_reference.result(
      "sensor_humanoid", [jax_reference.model_bytes(mjm)] + [
          np.atleast_1d(np.array(getattr(d, k))) for d in mjds
          for k in INPUTS], jax_stages)
  jax_out = tuple(out[k] for k in names[:3]) + (
      (out["linvel"], out["angmom"]),) + tuple(out[k] for k in names[5:])
  mp = mt.put_model(mjm, device="cpu")
  dp = mt.forward(mp, _port_data(mp, mjds))
  return mjm, mjds, mp, dp, jax_out


def test_humanoid_sensordata_matches_jax_and_c(humanoid):
  mjm, mjds, mp, dp, jax_out = humanoid
  assert dp.sensordata.shape == (len(POSES), 66) and mjm.nsensor == 34
  ncon = (dp.contact.dist < dp.contact.includemargin).sum(1).numpy()
  touching = (dp.sensordata[:, TOUCH] > 0).sum(1).numpy()
  live = (ncon >= 4) & (touching >= 2)
  assert live.sum() >= len(POSES) // 2, (ncon, touching)
  np.testing.assert_array_equal(ncon, [d.ncon for d in mjds])
  # values reach 3e3 (touch, force): 1e-10 of a value's size, or absolute
  np.testing.assert_allclose(dp.sensordata.numpy(), jax_out[0], rtol=1e-10,
                             atol=1e-10)
  np.testing.assert_allclose(dp.sensordata.numpy(),
                             np.stack([d.sensordata for d in mjds]), rtol=0,
                             atol=1e-8)


def test_sensor_stages_match_jax_and_c(humanoid):
  """Site frames, subtree_vel, rne_postconstraint and contact_forces_frame.
  C's cfrc_int keeps in the world's row the sum of its children (the force
  the world takes); the JAX package zeroes that row, so against the JAX
  package it is left out."""
  mjm, mjds, mp, dp, jax_out = humanoid
  _, site_xpos, site_xmat, (linvel, angmom), cacc, cfrc_int, cfrc_ext, \
      forces = jax_out
  post = smooth.rne_postconstraint(mp, dp)
  lv, am = smooth.subtree_vel(mp, dp)
  frc = constraint.contact_forces_frame(mp, dp)
  close = lambda a, b, tol, what: np.testing.assert_allclose(
      a.numpy() if isinstance(a, torch.Tensor) else a, b, rtol=0, atol=tol,
      err_msg=what)
  for ours, theirs, what in (
      (dp.site_xpos, site_xpos, "site_xpos"),
      (dp.site_xmat, site_xmat, "site_xmat"), (lv, linvel, "linvel"),
      (am, angmom, "angmom"), (post.cacc, cacc, "cacc"),
      (post.cfrc_int[:, 1:], cfrc_int[:, 1:], "cfrc_int"),
      (post.cfrc_ext, cfrc_ext, "cfrc_ext"), (frc, forces, "forces")):
    # 1e-10 of the field's size: cfrc_int sums forces of up to 3e3
    close(ours, theirs, 1e-10 * max(1.0, np.abs(theirs).max()), what)

  for b, mjd in enumerate(mjds):
    geom1, geom2 = dp.contact.geom1[b], dp.contact.geom2[b]
    mujoco.mj_rnePostConstraint(mjm, mjd)
    mujoco.mj_subtreeVel(mjm, mjd)
    for ours, field in ((dp.site_xpos, "site_xpos"),
                        (dp.site_xmat, "site_xmat"), (lv, "subtree_linvel"),
                        (am, "subtree_angmom"), (post.cacc, "cacc"),
                        (post.cfrc_int, "cfrc_int"),
                        (post.cfrc_ext, "cfrc_ext")):
      theirs = getattr(mjd, field)
      close(ours[b].reshape(theirs.shape), theirs, 1e-8, field)
    # each C contact against the port's active slot of the same geoms
    # nearest to it; the world force frameᵀ f flips with the geom order
    active = (dp.contact.dist[b] < dp.contact.includemargin[b]).numpy()
    f_world = (frc[b, :, None, :3] @ dp.contact.frame[b])[:, 0].numpy()
    for i in range(mjd.ncon):
      con = mjd.contact[i]
      res = np.zeros(6)
      mujoco.mj_contactForce(mjm, mjd, i, res)
      pair = {int(con.geom[0]), int(con.geom[1])}
      slots = [j for j in np.nonzero(active)[0]
               if {int(geom1[j]), int(geom2[j])} == pair]
      j = min(slots, key=lambda j: np.linalg.norm(
          dp.contact.pos[b, j].numpy() - con.pos))
      sign = 1.0 if geom1[j] == con.geom[0] else -1.0
      close(frc[b, j, 0], res[0], 1e-8, "normal force")
      close(sign * f_world[j], con.frame.reshape(3, 3).T @ res[:3], 1e-8,
            "world contact force")
    assert active.sum() == mjd.ncon


# each shape with the sizes its ray test reads
SHAPES = {
    "PLANE": np.array([0.4, 0.3, 0.0]), "SPHERE": np.array([0.3, 0.0, 0.0]),
    "CAPSULE": np.array([0.2, 0.35, 0.0]),
    "ELLIPSOID": np.array([0.3, 0.2, 0.4]),
    "CYLINDER": np.array([0.25, 0.3, 0.0]), "BOX": np.array([0.3, 0.2, 0.4]),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ray_geom_matches_jax_and_c(shape):
  """64 rays against one shape at a seeded pose: aimed at points on and
  near it from outside (hits and near misses), pointing away (misses), and
  from points inside it; each distance against JAX ray_geom (1e-10) and
  mju_rayGeom (1e-10; its -1 is the port's +inf)."""
  rng = np.random.RandomState(sum(map(ord, shape)))
  gtype = int(getattr(mujoco.mjtGeom, f"mjGEOM_{shape}"))
  size = SHAPES[shape]
  pos = rng.randn(3) * 0.2
  quat = rng.randn(4)
  mat = np.zeros(9)
  mujoco.mju_quat2Mat(mat, quat / np.linalg.norm(quat))
  mat = mat.reshape(3, 3)
  n = 64
  target = pos + (rng.rand(n, 3) - 0.5) * 3.0 * np.maximum(size, 0.2) @ mat.T
  start = pos + 2.0 * rng.randn(n, 3)
  vec = target - start
  vec[16:24] *= -1.0                             # pointing away
  start[24:40] = pos + 0.1 * (rng.rand(16, 3) - 0.5) * np.maximum(
      size, 0.05) @ mat.T                        # inside, any direction
  vec[24:40] = rng.randn(16, 3)
  if shape == "PLANE":                           # from above and below
    start[40:] = pos + (rng.randn(24, 3) * [0.3, 0.3, 1.0]) @ mat.T

  t = lambda x: torch.as_tensor(x)
  ours = ray.ray_geom(t(pos), t(mat), t(size), t(start), t(vec),
                      gtype).numpy()
  theirs = np.asarray(jax.vmap(
      lambda p, v: jray.ray_geom(pos, mat, size, p, v, gtype))(start, vec))
  c = np.array([mujoco.mju_rayGeom(pos, mat.ravel(), size, start[i], vec[i],
                                   gtype) for i in range(n)])
  c = np.where(c < 0, np.inf, c)
  np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-10)
  np.testing.assert_allclose(ours, c, rtol=0, atol=1e-10)
  hits = np.isfinite(ours)
  assert hits[:16].any() and (~hits[:16]).any() and not hits[16:24].any()
  if shape != "PLANE":
    assert hits[24:40].all()                     # a closed shape's inside


# the ported types the humanoid lacks (tests/test_sensor.py's SENSOR_RICH,
# cut to what the port loads), with cutoffs of both data types and touch
# sites of four more shapes; a fixed tendon carries the tendon sensors
SENSOR_SMALL = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <body name="base" pos="0 0 0.025">
      <freejoint/>
      <geom type="capsule" size="0.03" fromto="-0.05 0 0 0.05 0 0" mass="0.5"/>
      <site name="imu" type="cylinder" size="0.04 0.02" pos="0.02 0.01 0.01"
            quat="0.95 0.2 0.1 0.2"/>
      <site name="sole" type="box" size="0.08 0.04 0.035"/>
      <body name="arm" pos="0.06 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.015" fromto="0 0 0 0.15 0 0" mass="0.2"/>
        <site name="tip" pos="0.15 0 0"/>
        <body name="wrist" pos="0.15 0 0">
          <joint name="ball" type="ball" damping="0.01"/>
          <geom name="hand" type="sphere" size="0.03" mass="0.1"/>
          <site name="pad" type="ellipsoid" size="0.04 0.035 0.045"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="ft"><joint joint="elbow" coef="0.7"/></fixed>
  </tendon>
  <actuator>
    <motor name="m0" joint="elbow" gear="1.2"/>
  </actuator>
  <sensor>
    <tendonpos tendon="ft"/>
    <tendonvel tendon="ft"/>
    <jointpos joint="elbow"/>
    <jointvel joint="elbow" cutoff="0.3"/>
    <ballquat joint="ball"/>
    <ballangvel joint="ball"/>
    <actuatorpos actuator="m0"/>
    <actuatorvel actuator="m0"/>
    <actuatorfrc actuator="m0"/>
    <jointactuatorfrc joint="elbow"/>
    <framepos objtype="site" objname="tip"/>
    <framepos objtype="body" objname="wrist" reftype="site" refname="imu"/>
    <framequat objtype="xbody" objname="arm"/>
    <framequat objtype="site" objname="tip" reftype="body" refname="base"/>
    <framequat objtype="geom" objname="hand"/>
    <framexaxis objtype="site" objname="tip"/>
    <frameyaxis objtype="body" objname="arm" reftype="xbody" refname="wrist"/>
    <framezaxis objtype="geom" objname="floor" reftype="site" refname="imu"/>
    <framelinvel objtype="site" objname="tip"/>
    <frameangvel objtype="body" objname="wrist"/>
    <framelinvel objtype="site" objname="tip" reftype="site" refname="imu"/>
    <frameangvel objtype="geom" objname="hand" reftype="xbody" refname="arm"/>
    <framelinacc objtype="site" objname="tip"/>
    <frameangacc objtype="body" objname="wrist"/>
    <framelinacc objtype="geom" objname="hand"/>
    <subtreecom body="base"/>
    <subtreecom body="arm"/>
    <subtreelinvel body="base"/>
    <subtreeangmom body="base"/>
    <subtreeangmom body="wrist"/>
    <velocimeter site="imu"/>
    <gyro site="imu"/>
    <accelerometer site="imu" cutoff="5"/>
    <force site="imu"/>
    <torque site="imu"/>
    <force site="tip"/>
    <touch site="pad"/>
    <touch site="sole" cutoff="2"/>
    <touch site="imu"/>
    <clock/>
    <magnetometer site="imu"/>
    <e_potential/>
    <e_kinetic/>
  </sensor>
</mujoco>
"""


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_other_sensor_types_match_c(seed):
  """Every ported type on SENSOR_SMALL, lying on the floor, against C
  mj_forward, 1e-8, sensor by sensor."""
  mjm = mujoco.MjModel.from_xml_string(SENSOR_SMALL)
  types = {SensorType(int(t)) for t in mjm.sensor_type}
  humanoid = {SensorType(int(t)) for t in _humanoid().sensor_type}
  # the rest are tests/test_torch_sensor_tail.py's,
  # tests/test_torch_quadruped_rangefinder.py's and (PLUGIN, the touch
  # grid) tests/test_torch_plugins.py's
  tail = {SensorType[n] for n in (
      "RANGEFINDER", "CAMPROJECTION", "JOINTLIMITPOS", "JOINTLIMITVEL",
      "JOINTLIMITFRC", "TENDONLIMITPOS", "TENDONLIMITVEL", "TENDONLIMITFRC",
      "GEOMDIST", "GEOMNORMAL", "GEOMFROMTO", "USER", "PLUGIN")}
  assert types | humanoid == PORTED_SENSORS - tail
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0
  mjd.qpos[7:] += 0.3 * rng.randn(mjm.nq - 7)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.4 * rng.randn(mjm.nv)
  mjd.ctrl[:] = rng.randn(mjm.nu)
  mjd.xfrc_applied[1:] = 0.2 * rng.randn(mjm.nbody - 1, 6)
  mjd.time = 0.37 * (seed + 1)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon >= 2
  mp = mt.put_model(mjm, device="cpu")
  ours = mt.forward(mp, mt.put_data(mp, mjd)).sensordata[0].numpy()
  for i in range(mjm.nsensor):
    adr, dim = mjm.sensor_adr[i], mjm.sensor_dim[i]
    np.testing.assert_allclose(
        ours[adr:adr + dim], mjd.sensordata[adr:adr + dim], rtol=0,
        atol=1e-8, err_msg=f"sensor {i} ({SensorType(mjm.sensor_type[i])})")


@pytest.mark.parametrize("integrator", ["EULER", "RK4"])
def test_step_sensordata_matches_c(integrator):
  """sensordata after each of 3 steps of 4 floor-contact humanoid states
  against C mj_step's, 1e-8: the step's first forward's values, also under
  RK4, whose stage forwards skip the sensors (as do cacc and cfrc_int)."""
  mjm = _humanoid()
  mjm.opt.integrator = int(getattr(mujoco.mjtIntegrator,
                                   f"mjINT_{integrator}"))
  mjds = _humanoid_states(mjm)[2:6]
  mp = mt.put_model(mjm, device="cpu")
  d = _port_data(mp, mjds)
  for _ in range(3):
    first = mt.forward(mp, d)
    nxt = mt.step(mp, d)
    assert torch.equal(nxt.sensordata, first.sensordata)
    if integrator == "RK4":
      for field in ("cacc", "cfrc_int", "cfrc_ext"):
        assert torch.equal(getattr(nxt, field), getattr(first, field))
    for mjd in mjds:
      mujoco.mj_step(mjm, mjd)
    np.testing.assert_allclose(
        nxt.sensordata.numpy(), np.stack([x.sensordata for x in mjds]),
        rtol=0, atol=1e-8)
    assert (nxt.sensordata[:, TOUCH] > 0).any()
    d = nxt


@pytest.mark.parametrize("invdiscrete", [False, True])
def test_inverse_sensordata_matches_c(invdiscrete):
  """inverse(skip_sensor=False) at the 8 states with seeded qacc against C
  mj_inverse's sensordata, 1e-8 (the acceleration stage reads the
  continuous qacc and the inverse's constraint forces); with skip_sensor,
  sensordata is left as it was."""
  mjm = _humanoid()
  if invdiscrete:
    mjm.opt.enableflags |= int(mujoco.mjtEnableBit.mjENBL_INVDISCRETE)
  mjds = _humanoid_states(mjm)
  rng = np.random.RandomState(9)
  for mjd in mjds:
    mjd.qacc[:] += rng.randn(mjm.nv)
  mp = mt.put_model(mjm, device="cpu")
  d = _port_data(mp, mjds)
  assert torch.equal(mt.inverse(mp, d).sensordata, d.sensordata)
  out = mt.inverse(mp, d, skip_sensor=False)
  for mjd in mjds:
    mujoco.mj_inverse(mjm, mjd)
  np.testing.assert_allclose(out.sensordata.numpy(),
                             np.stack([x.sensordata for x in mjds]), rtol=0,
                             atol=1e-8)
  np.testing.assert_allclose(out.qfrc_inverse.numpy(),
                             np.stack([x.qfrc_inverse for x in mjds]),
                             rtol=0, atol=1e-8)
  assert (out.sensordata[:, TOUCH] > 0).sum() >= 4


def test_sensor_stage_costs_nothing_without_sensors():
  """With the sensor disable flag, forward and step leave sensordata as
  make_data gave it, zero; a model without sensors carries its (B, 0)
  sensordata through forward untouched, as does a stage with no sensor of
  its own (the humanoid has no position-stage sensor)."""
  mjm = _humanoid()
  mjm.opt.disableflags |= int(mujoco.mjtDisableBit.mjDSBL_SENSOR)
  mp = mt.put_model(mjm, device="cpu")
  assert mp.opt.disableflags & DisableBit.SENSOR
  d = _port_data(mp, _humanoid_states(mjm)[2:4])
  out = mt.forward(mp, d)
  assert out.sensordata is d.sensordata and not out.sensordata.any()
  assert out.cacc is None
  assert not mt.step(mp, d).sensordata.any()

  plain = mt.put_model(mt.asset_path("humanoid.npz"), device="cpu")
  d = mt.make_data(plain, 2)
  assert d.sensordata.shape == (2, 0)
  assert mt.forward(plain, d).sensordata is d.sensordata

  mp = mt.put_model(_humanoid(), device="cpu")
  dp = mt.fwd_position(mp, mt.make_data(mp, 2))
  assert sensor.sensor_pos(mp, dp) is dp


UNPORTED = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 0.1"/>
    <geom name="box" type="box" size="0.1 0.1 0.1" pos="1 0 0.1"/>
    <camera name="cam" pos="0 -1 1" xyaxes="1 0 0 0 1 1"/>
    <body name="b" pos="0 0 0.5">
      <joint name="j" type="hinge" axis="0 1 0" range="-1 1"/>
      <geom name="g" type="capsule" size="0.02" fromto="0 0 0 0.2 0 0"/>
      <site name="s" pos="0.2 0 0"/>
    </body>
  </worldbody>
  EXTRA
  <sensor>SENSOR</sensor>
</mujoco>"""
TENDON = '<tendon><fixed name="t"><joint joint="j" coef="1"/></fixed></tendon>'
MESH = ('<asset><mesh name="m" vertex="0 0 0 0.1 0 0 0 0.1 0 0 0 0.1"/>'
        '</asset>')


# each id names the case it held before the sensor tail was ported; each
# now holds a sensor that stays refused ("plugin", since the plugin slice
# computes the touch grid, a TACTILE sensor: C validates every touch-grid
# configuration the port would refuse)
@pytest.mark.parametrize("extra, element, what", [
    (TENDON, '<tendonactuatorfrc tendon="t"/>', "sensor type TENDONACTFRC"),
    ("", '<insidesite site="s" objtype="geom" objname="g"/>',
     "sensor type INSIDESITE"),
    ("", '<contact geom1="g"/>', "sensor type CONTACT"),
    ("", '<normal geom1="g" geom2="box"/>',
     "GEOMNORMAL sensor over geom pair CAPSULE-BOX"),
    ("", '<rangefinder site="s" data="dist dir"/>',
     "RANGEFINDER output other than the distance"),
    ("", '<fromto geom1="g" geom2="box"/>',
     "GEOMFROMTO sensor over geom pair CAPSULE-BOX"),
    ("", '<distance geom1="g" geom2="box"/>',
     "GEOMDIST sensor over geom pair CAPSULE-BOX"),
    (MESH, '<tactile geom="g" mesh="m"/>', "sensor type TACTILE"),
    ("", '<user dim="1" needstage="acc"/>', "sensor type USER"),
    ("", '<rangefinder camera="cam"/>',
     "sensor object type CAMERA (RANGEFINDER)"),
    ("", '<framepos objtype="site" objname="s" reftype="camera" '
     'refname="cam" nsample="2"/>',
     "sensor delay, interval or history (FRAMEPOS)"),
    ("", '<jointpos joint="j" nsample="3"/>',
     "sensor delay, interval or history (JOINTPOS)"),
    ("", '<jointpos joint="j" interval="0.01"/>',
     "sensor delay, interval or history (JOINTPOS)"),
], ids=["tendon", "limit", "energy", "magnetometer", "rangefinder",
        "camprojection", "geomdist", "plugin", "user", "camera-object",
        "camera-reference", "history", "interval"])
def test_put_model_refuses_unported_sensors(extra, element, what):
  xml = UNPORTED.replace("EXTRA", extra).replace("SENSOR", element)
  with pytest.raises(NotImplementedError, match=re.escape(what)):
    mt.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")


def test_snapshot_without_the_new_fields_fails(tmp_path):
  with np.load(mt.asset_path("humanoid_sensors.npz")) as z:
    snap = {k: z[k] for k in z.files if not k.startswith("sensor_")}
  with pytest.raises(ValueError, match="sensor_adr"):
    mt.put_model(snap, device="cpu")


def test_vendored_xml_is_dm_control_humanoid_with_sensors():
  """humanoid_sensors.xml is humanoid.xml with dm_control's <sensor> block
  restored and the header's note of changes amended; it compiles to
  dm_control's sensor table."""
  ours = mt.asset_path("humanoid_sensors.xml").read_text()
  base = mt.asset_path("humanoid.xml").read_text()
  dm = open(DM_CONTROL_XML).read()
  block = dm[dm.index("  <sensor>"):dm.index("</sensor>") + len("</sensor>")]
  note = re.compile(r"Changes:.*?-->", re.S)
  assert block in ours and block not in base
  assert (note.sub("", ours.replace(block + "\n\n", ""))
          == note.sub("", base))
  assert "<sensor> block (dm_control/suite/humanoid.xml:161-199) is kept" in (
      " ".join(ours.split()))
  a = _humanoid()
  b = mujoco.MjModel.from_xml_path(DM_CONTROL_XML)
  assert a.nsensor == b.nsensor == 34 and a.nsensordata == b.nsensordata == 66
  for field in ("sensor_type", "sensor_objtype", "sensor_objid",
                "sensor_reftype", "sensor_refid", "sensor_adr", "sensor_dim",
                "sensor_datatype", "sensor_needstage", "sensor_cutoff",
                "site_type", "site_size", "site_pos", "site_quat",
                "site_bodyid"):
    np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                  err_msg=field)
