"""The PyTorch port's tendons: fixed and spatial paths, wrapping, the
tendon transmission, and the three models of the tendon slice.

The three vendored models (``assets/tendon_arm.xml``, BASELINE rung 2's
muscle arm on arm26's pattern; ``actuated.xml``, the JAX tests' actuated
model; ``tendon_rows.xml``, the tendon rows and actuators), from seeded
states, in float64: ten_length and ten_J against C MuJoCo (1e-12) and the
JAX package (1e-12); a seeded wrap sweep of a sphere and a cylinder, with
and without a side site, against C (1e-12), which must wrap at least 5
times (the pattern of ``tests/test_tendon.py``'s sweep, which skips
without the reference's arm26); the transmission's lengths and moments
against C; and each vendored XML against its snapshot.
"""

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from models import ACTUATED

MODELS = ("actuated", "tendon_arm", "tendon_rows")
_CACHE = {}


def c_model(name):
  """The C model of a vendored asset (compiled once: the arm's compiler
  computes its muscles' lengthrange by simulation)."""
  if name not in _CACHE:
    _CACHE[name] = mujoco.MjModel.from_xml_path(str(mt.asset_path(
        f"{name}.xml")))
  return _CACHE[name]


def seeded(mjm, seed):
  """An MjData at qpos0 moved by 0.4 randn in each dof's tangent
  direction, with 0.6 randn qvel, activations in [0, 1], controls in
  [-1, 1] and 0.1 randn applied forces."""
  rng = np.random.RandomState(seed)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_integratePos(mjm, mjd.qpos, 0.4 * rng.randn(mjm.nv), 1.0)
  mjd.qvel[:] = 0.6 * rng.randn(mjm.nv)
  mjd.act[:] = rng.uniform(0, 1, mjm.na)
  mjd.ctrl[:] = rng.uniform(-1, 1, mjm.nu)
  mjd.qfrc_applied[:] = 0.1 * rng.randn(mjm.nv)
  return mjd


def dense(mjm, mjd, field):
  """C's sparse ten_J or actuator_moment as a dense matrix."""
  if field == "ten_J":
    out = np.zeros((mjm.ntendon, mjm.nv))
    mujoco.mju_sparse2dense(out, mjd.ten_J, mjm.ten_J_rownnz,
                            mjm.ten_J_rowadr, mjm.ten_J_colind)
  else:
    out = np.zeros((mjm.nu, mjm.nv))
    mujoco.mju_sparse2dense(out, mjd.actuator_moment, mjd.moment_rownnz,
                            mjd.moment_rowadr, mjd.moment_colind)
  return out


@pytest.mark.parametrize("name", MODELS)
def test_tendons_and_transmission_match_c_and_jax(name):
  """ten_length, ten_J, actuator_length and the dense actuator_moment of
  three seeded lanes against C mj_forward and the JAX package's position
  stage, 1e-12."""
  mjm = c_model(name)
  mjds = [seeded(mjm, seed) for seed in range(3)]
  mp = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(mp, mt.from_jax_arrays(mp, {
      k: np.stack([getattr(x, k) for x in mjds]) for k in ("qpos", "qvel")}))
  mj = mi.put_model(mjm)
  pos_j = jax.jit(mi.fwd_position)
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    dj = pos_j(mj, mi.put_data(mj, mjd))
    for f, ref in (("ten_length", mjd.ten_length),
                   ("ten_J", dense(mjm, mjd, "ten_J")),
                   ("actuator_length", mjd.actuator_length),
                   ("actuator_moment", dense(mjm, mjd, "actuator_moment"))):
      if f.startswith("ten") and not mjm.ntendon:
        continue
      got = getattr(d, f)[i].numpy()
      np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12,
                                 err_msg=f"{f} lane {i} vs C")
      np.testing.assert_allclose(got, np.asarray(getattr(dj, f)), rtol=0,
                                 atol=1e-12, err_msg=f"{f} lane {i} vs JAX")


_WRAP_XML = """
<mujoco>
  <option>
    <flag contact="disable" gravity="disable"/>
  </option>
  <worldbody>
    <geom name="wrapgeom" type="{gtype}" size="0.15 0.4" contype="0"
          conaffinity="0"/>
    <site name="side" pos="0 -0.4 0" size="0.01"/>
    <body name="a" pos="-0.5 0.3 0.05">
      <joint type="free"/>
      <geom type="sphere" size="0.02" mass="0.1"/>
      <site name="s0" size="0.01"/>
    </body>
    <body name="b" pos="0.5 0.3 -0.05">
      <joint type="free"/>
      <geom type="sphere" size="0.02" mass="0.1"/>
      <site name="s1" size="0.01"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t0">
      <site site="s0"/>
      <geom geom="wrapgeom" {side}/>
      <site site="s1"/>
    </spatial>
  </tendon>
</mujoco>
"""


@pytest.mark.parametrize("gtype", ["sphere", "cylinder"])
@pytest.mark.parametrize("use_side", [False, True])
def test_wrap_sweep_matches_c(gtype, use_side):
  """40 seeded poses of the two end sites around a sphere or a cylinder,
  with and without a side site (``tests/test_tendon.py``'s sweep), as one
  fleet: ten_length and ten_J against C (1e-12); at least 5 poses wrap."""
  mjm = mujoco.MjModel.from_xml_string(_WRAP_XML.format(
      gtype=gtype, side='sidesite="side"' if use_side else ""))
  rng = np.random.RandomState(7)
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], 40, axis=0)
  for q in qpos:
    q[0:3] = np.array([-0.5, 0.3, 0.05]) + 0.4 * rng.randn(3)
    q[7:10] = np.array([0.5, 0.3, -0.05]) + 0.4 * rng.randn(3)
    for off in (0, 7):
      while np.linalg.norm(q[off:off + 3]) < 0.2:
        q[off:off + 3] *= 1.5
  mp = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(mp, mt.from_jax_arrays(mp, {"qpos": qpos}))
  mjd = mujoco.MjData(mjm)
  wrapped = 0
  for i, q in enumerate(qpos):
    mjd.qpos[:] = q
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(d.ten_length[i].numpy(), mjd.ten_length,
                               rtol=0, atol=1e-12, err_msg=f"pose {i}")
    np.testing.assert_allclose(d.ten_J[i].numpy(), dense(mjm, mjd, "ten_J"),
                               rtol=0, atol=1e-12, err_msg=f"pose {i}")
    straight = np.linalg.norm(mjd.site_xpos[1] - mjd.site_xpos[0])
    wrapped += mjd.ten_length[0] > straight + 1e-9
  assert wrapped >= 5


def test_wrap_inside_a_side_site_matches_c():
  """A side site inside the sphere takes C's inside wrap (``wrap_inside``,
  the Newton search): 20 seeded poses against C, 1e-10."""
  xml = _WRAP_XML.format(gtype="sphere", side='sidesite="side"').replace(
      'name="side" pos="0 -0.4 0"', 'name="side" pos="0 0.05 0.02"')
  mjm = mujoco.MjModel.from_xml_string(xml)
  rng = np.random.RandomState(3)
  qpos = np.repeat(np.asarray(mjm.qpos0)[None], 20, axis=0)
  qpos[:, 0:3] += 0.1 * rng.randn(20, 3)
  qpos[:, 7:10] += 0.1 * rng.randn(20, 3)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(mp, mt.from_jax_arrays(mp, {"qpos": qpos}))
  mjd = mujoco.MjData(mjm)
  for i, q in enumerate(qpos):
    mjd.qpos[:] = q
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(d.ten_length[i].numpy(), mjd.ten_length,
                               rtol=0, atol=1e-10, err_msg=f"pose {i}")
    np.testing.assert_allclose(d.ten_J[i].numpy(), dense(mjm, mjd, "ten_J"),
                               rtol=0, atol=1e-10, err_msg=f"pose {i}")


def test_free_and_ball_joint_transmissions_match_c():
  """JOINT and JOINTINPARENT transmissions on a free joint and a ball
  joint: actuator_length and the dense moment against C, 1e-12."""
  mjm = mujoco.MjModel.from_xml_string("""
  <mujoco><option><flag contact="disable"/></option><worldbody>
    <body pos="0 0 1"><freejoint name="f"/><geom type="box" size=".1 .2 .3"/>
      <body pos="0 0 -0.4"><joint name="b" type="ball"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.2"/></body>
    </body></worldbody>
  <actuator>
    <general joint="f" gear="1 2 3 0.4 0.5 0.6"/>
    <general jointinparent="f" gear="1 2 3 0.4 0.5 0.6"/>
    <general joint="b" gear="0.3 -0.2 0.1"/>
    <general jointinparent="b" gear="0.3 -0.2 0.1"/>
  </actuator></mujoco>""")
  mjds = [seeded(mjm, seed) for seed in range(2)]
  mp = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(mp, mt.from_jax_arrays(mp, {
      "qpos": np.stack([x.qpos for x in mjds])}))
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(d.actuator_length[i].numpy(),
                               mjd.actuator_length, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.actuator_moment[i].numpy(),
                               dense(mjm, mjd, "actuator_moment"), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_assets_match_their_snapshots(name):
  """Each vendored XML's snapshot is what save_model_snapshot writes from
  it; the actuated model is the JAX tests' ``ACTUATED``."""
  if name == "actuated":
    assert mt.asset_path("actuated.xml").read_text() == ACTUATED.lstrip("\n")
  fresh = mt.put_model(c_model(name), device="cpu")
  snap = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  for field in fresh.__dataclass_fields__:
    a, b = getattr(fresh, field), getattr(snap, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field
    elif isinstance(a, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=field)
