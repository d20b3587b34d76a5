"""The PyTorch port's model I/O and smooth dynamics against the JAX package.

The same MjModel and the same seeded state go through the JAX stage
functions and their port counterparts, in float64 on the CPU; the port's
fields must agree to 1e-10.  Models: those of ``tests/models.py::ALL_SMOOTH``
that the port's ``put_model`` accepts, and the vendored humanoid.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import inspect

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import forward as tforward
from mujoco_inversedynamicstest_tpu_torch.ops import smooth as tsmooth

from models import ALL_SMOOTH

HUMANOID = mt.asset_path("humanoid.xml").read_text()
MODELS = dict(ALL_SMOOTH, humanoid=HUMANOID)
INPUTS = ("qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied", "qacc",
          "qacc_warmstart", "time")


def _setup(xml, seed):
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0 + 0.3 * rng.randn(mjm.nq)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.5 * rng.randn(mjm.nv)
  mjd.qacc[:] = rng.randn(mjm.nv)
  return mjm, mjd


def _jax_smooth(m, d):
  d = mi.kinematics(m, d)
  d = mi.com_pos(m, d)
  d = mi.crb(m, d)
  d = mi.factor_m(m, d)
  d = mi.com_vel(m, d)
  return d, mi.rne(m, d, flg_acc=False)


def _port_smooth(m, d):
  d = tsmooth.kinematics(m, d)
  d = tsmooth.com_pos(m, d)
  d = tsmooth.crb(m, d)
  d = tsmooth.factor_m(m, d)
  d = tsmooth.com_vel(m, d)
  return d, tsmooth.rne(m, d, flg_acc=False)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_smooth_stages_match_jax(name, seed):
  mjm, mjd = _setup(MODELS[name], seed)
  mj = mi.put_model(mjm)
  dj = mi.put_data(mj, mjd)
  outj, biasj = jax.jit(_jax_smooth)(mj, dj)

  mp = mt.put_model(mjm, device="cpu")
  dp = mt.from_jax_arrays(
      mp, {k: np.asarray(getattr(dj, k))[None] for k in INPUTS})
  outp, biasp = _port_smooth(mp, dp)

  for field in ("xpos", "xquat", "cinert", "cdof", "qM", "cvel",
                "cdof_dot"):
    np.testing.assert_allclose(getattr(outp, field)[0].numpy(),
                               np.asarray(getattr(outj, field)), rtol=0,
                               atol=1e-10, err_msg=field)
  # JAX's LAPACK factor leaves the upper triangle unspecified; the port's
  # is zero
  np.testing.assert_allclose(outp.qLD[0].numpy(), np.tril(outj.qLD),
                             rtol=0, atol=1e-10)
  np.testing.assert_allclose(biasp[0].numpy(), np.asarray(biasj), rtol=0,
                             atol=1e-10)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_fields_match_jax_put_model(name):
  """Every Model field of the port equals the JAX package's field of the
  same name, from the same MjModel."""
  mjm = mujoco.MjModel.from_xml_string(MODELS[name])
  mj, mp = mi.put_model(mjm), mt.put_model(mjm, device="cpu")
  checked = 0
  for field in mp.__dataclass_fields__:
    ours = getattr(mp, field)
    if not isinstance(ours, (torch.Tensor, np.ndarray)):
      continue
    theirs = np.asarray(getattr(mj, field))
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_array_equal(ours, theirs, err_msg=field)
    checked += 1
  assert checked > 50
  for lvl_p, lvl_j in zip(mp.tree.body_levels, mj.tree.body_levels):
    np.testing.assert_array_equal(lvl_p, lvl_j)
  np.testing.assert_array_equal(mp.tree.ancestor_mask, mj.tree.ancestor_mask)
  np.testing.assert_array_equal(mp.tree.body_dof_mask, mj.tree.body_dof_mask)


@pytest.mark.parametrize("name", ["humanoid", "humanoid_mjx",
                                  "humanoid_sensors"])
def test_snapshot_matches_vendored_xml(name, tmp_path):
  """The committed snapshot is what save_model_snapshot writes from the
  vendored XML (the humanoid's with its names: scripts/named_snapshots.py),
  and put_model gives the same Model from either."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  fresh = tmp_path / "snap.npz"
  mt.save_model_snapshot(mjm, fresh, names=name == "humanoid")
  with np.load(mt.asset_path(f"{name}.npz")) as committed, np.load(
      fresh) as written:
    assert sorted(committed.files) == sorted(written.files)
    for k in written.files:
      np.testing.assert_array_equal(committed[k], written[k], err_msg=k)
  from_snapshot = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  from_mjmodel = mt.put_model(mjm, device="cpu")
  for field in from_mjmodel.__dataclass_fields__:
    a, b = getattr(from_snapshot, field), getattr(from_mjmodel, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field


def test_model_entry_points_default_to_the_card():
  for fn in (mt.put_model, mt.load_model):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
  m = mt.put_model(mt.asset_path("humanoid.npz"), device="cpu")
  assert m.qpos0.device.type == "cpu" and m.body_mass.device.type == "cpu"
  assert mt.make_data(m, 2).qpos.device.type == "cpu"


@pytest.mark.parametrize("xml, what", [
    (ALL_SMOOTH["pendulum"].replace(
        "<joint ", "<joint name=\"j\" ").replace(
            "</mujoco>", "<actuator><general joint=\"j\" dyntype=\"user\" "
            "/></actuator></mujoco>"), "actuator dynamics USER"),
    # CG is ported: the pendulum is refused for the OVERRIDE enable flag
    # (the id is the case's from before the port)
    pytest.param(
        ALL_SMOOTH["pendulum"].replace(
            "<option timestep=\"0.002\" gravity=\"0 0 -9.81\"/>",
            "<option timestep=\"0.002\" gravity=\"0 0 -9.81\">"
            "<flag override=\"enable\"/></option>"),
        "enable flags OVERRIDE",
        id=ALL_SMOOTH["pendulum"].replace(
            "<option ", "<option solver=\"CG\" ") + "-solver CG"),
    # elliptic cones and the noslip solver are ported: the elliptic
    # humanoid with noslip is refused for the FWDINV enable flag (the id is
    # the case's from before the ports)
    pytest.param(
        HUMANOID.replace(
            "<option timestep=\".005\"/>",
            "<option cone=\"elliptic\" noslip_iterations=\"3\" "
            "timestep=\".005\"><flag fwdinv=\"enable\"/></option>"),
        "enable flags FWDINV",
        id=HUMANOID.replace("<option ", "<option cone=\"elliptic\" ")
        + "-elliptic"),
    # the ellipsoid's pairs are ported: the ellipsoid is refused on a height
    # field (the id is the case's from before the port)
    pytest.param(
        ALL_SMOOTH["freebody"].replace(
            "<worldbody>", "<asset><hfield name=\"h\" nrow=\"3\" ncol=\"3\" "
            "size=\"5 5 .1 .1\"/></asset><worldbody><geom type=\"hfield\" "
            "hfield=\"h\"/>").replace("type=\"box\"", "type=\"ellipsoid\""),
        "collision pair HFIELD-ELLIPSOID",
        id=ALL_SMOOTH["freebody"].replace(
            "<worldbody>",
            "<worldbody><geom type=\"plane\" size=\"5 5 .1\"/>").replace(
                "type=\"box\"", "type=\"ellipsoid\"")
        + "-collision pair PLANE-ELLIPSOID"),
])
def test_put_model_refuses_unported_features(xml, what):
  with pytest.raises(NotImplementedError, match=what):
    mt.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")


def test_blocked_factor_matches_jax():
  """Several independent mechanisms: M is block-diagonal and each group
  of equal-size blocks factors as one batch (smooth._dof_blocks)."""
  xml = """
  <mujoco>
    <option><flag contact="disable"/></option>
    <worldbody>
      <body pos="0 0 1"><freejoint/><geom type="sphere" size="0.1" mass="1"/></body>
      <body pos="1 0 1"><freejoint/><geom type="box" size="0.1 0.1 0.1" mass="2"/></body>
      <body pos="2 0 1">
        <joint type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="0.5"/>
        <body pos="0.3 0 0">
          <joint type="hinge" axis="1 0 0"/>
          <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.3"/>
        </body>
      </body>
    </worldbody>
  </mujoco>
  """
  mjm, mjd = _setup(xml, 0)
  mj = mi.put_model(mjm)
  dj = mi.put_data(mj, mjd)
  x = np.random.RandomState(1).randn(mjm.nv)
  fn = lambda m, d: mi.solve_m(m, _jax_smooth(m, d)[0], x)
  yj = np.asarray(jax.jit(fn)(mj, dj))

  mp = mt.put_model(mjm, device="cpu")
  dp = mt.from_jax_arrays(
      mp, {k: np.asarray(getattr(dj, k))[None] for k in INPUTS})
  outp, _ = _port_smooth(mp, dp)
  assert sorted(tsmooth._dof_blocks(mp)) == [2, 6]
  yp = mt.solve_m(mp, outp, torch.as_tensor(x)[None])[0].numpy()
  np.testing.assert_allclose(yp, yj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", sorted(ALL_SMOOTH))
def test_smooth_models_step_like_jax_and_c(name):
  """Five Euler steps of each contact-free model (no constraint rows)
  against the JAX step and C ``mj_step``."""
  mjm, mjd = _setup(MODELS[name], 2)
  mjd.qacc[:] = 0.0
  mj = mi.put_model(mjm)
  dj = mi.put_data(mj, mjd)
  mp = mt.put_model(mjm, device="cpu")
  dp = mt.from_jax_arrays(
      mp, {k: np.asarray(getattr(dj, k))[None] for k in INPUTS})
  step = jax.jit(mi.step)
  for _ in range(5):
    dj = step(mj, dj)
    dp = tforward.step(mp, dp)
    mujoco.mj_step(mjm, mjd)
  np.testing.assert_allclose(dp.qpos[0].numpy(), np.asarray(dj.qpos),
                             rtol=0, atol=1e-10)
  np.testing.assert_allclose(dp.qvel[0].numpy(), np.asarray(dj.qvel),
                             rtol=0, atol=1e-9)
  np.testing.assert_allclose(dp.qpos[0].numpy(), mjd.qpos, rtol=0, atol=1e-8)
  np.testing.assert_allclose(dp.qvel[0].numpy(), mjd.qvel, rtol=0, atol=1e-6)
