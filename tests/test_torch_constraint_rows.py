"""The PyTorch port's equality, friction-loss and ball-limit rows.

The five constrained models of the JAX tests (``models.ALL_CONSTRAINED``:
the BASELINE rung-1 slider crank with its site-to-site connect, a joint
equality with a quartic polycoef, a body-to-body weld with torquescale, a
ball-joint limit beside hinge and slide limits, and dof friction loss) and
a free body welded to a mocap body, from the seeded states of
``tests/test_constraint.py::_setup``, in float64: row data against the JAX
package (every static row) and C MuJoCo (the active rows), ``forward``,
20 steps, ``inverse`` and the reference fork's forward/inverse check.
"""

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from models import ALL_CONSTRAINED

# a free body held by a weld to a mocap body (the only mocap model here)
MOCAP_WELD = """
<mujoco>
  <option timestep="0.002"><flag contact="disable"/></option>
  <worldbody>
    <body name="target" mocap="true" pos="0.1 0 0.6" quat="0.9 0.1 0.3 0">
      <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
    </body>
    <body name="box" pos="0 0 0.5">
      <freejoint/>
      <geom type="box" size="0.05 0.04 0.03" mass="0.5"/>
    </body>
  </worldbody>
  <equality>
    <weld body1="box" body2="target" solref="0.02 1"/>
  </equality>
</mujoco>
"""
MODELS = dict(ALL_CONSTRAINED, mocap_weld=MOCAP_WELD)
INPUTS = ("time", "qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied",
          "qacc_warmstart", "qacc", "eq_active", "mocap_pos", "mocap_quat")
ROWS = ("efc_J", "efc_pos", "efc_D", "efc_aref", "efc_frictionloss")


def random_state(mjm, mjd, seed):
  """The state of ``tests/test_constraint.py::_setup``; a mocap body is
  also moved and turned."""
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0 + 0.3 * rng.randn(mjm.nq)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.6 * rng.randn(mjm.nv)
  if mjm.nu:
    mjd.ctrl[:] = rng.randn(mjm.nu)
  mjd.qfrc_applied[:] = 0.1 * rng.randn(mjm.nv)
  if mjm.nmocap:
    mjd.mocap_pos[:] += 0.05 * rng.randn(mjm.nmocap, 3)
    quat = mjd.mocap_quat + 0.2 * rng.randn(mjm.nmocap, 4)
    mjd.mocap_quat[:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)


def setup_lanes(name, seeds=(0,), integrator=None):
  """C model and one MjData a seed, the port's model and a fleet of one
  lane a seed."""
  mjm = mujoco.MjModel.from_xml_string(MODELS[name])
  if integrator is not None:
    mjm.opt.integrator = integrator
  mjds = []
  for seed in seeds:
    mjd = mujoco.MjData(mjm)
    random_state(mjm, mjd, seed)
    mjds.append(mjd)
  mp = mt.put_model(mjm, device="cpu")
  return mjm, mjds, mp, lanes(mp, mjds)


def lanes(mp, mjds):
  """A port fleet of the input state of each MjData."""
  return mt.from_jax_arrays(mp, {
      k: np.stack([np.array(getattr(mjd, k)) for mjd in mjds])
      for k in INPUTS})


def c_rows(mjm, mjd):
  """C's dense efc_J after mj_forward."""
  if mujoco.mj_isSparse(mjm):
    out = np.zeros((mjd.nefc, mjm.nv))
    mujoco.mju_sparse2dense(out, mjd.efc_J, mjd.efc_J_rownnz,
                            mjd.efc_J_rowadr, mjd.efc_J_colind)
    return out
  return mjd.efc_J.reshape(mjd.nefc, mjm.nv).copy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_rows_match_jax_and_c(name):
  """efc_J, efc_pos, efc_D, efc_aref and efc_frictionloss of every static
  row against the JAX package (1e-10), and of the active rows against C's
  packed rows (the JAX tests' tolerances)."""
  mjm, (mjd,), mp, dp = setup_lanes(name)
  out = mt.fwd_velocity(mp, mt.fwd_position(mp, dp))
  mj = mi.put_model(mjm)
  outj = jax.jit(lambda m, d: mi.fwd_velocity(m, mi.fwd_position(m, d)))(
      mj, mi.put_data(mj, mjd))
  for f in ROWS:
    np.testing.assert_allclose(getattr(out, f)[0].numpy(),
                               np.asarray(getattr(outj, f)), rtol=0,
                               atol=1e-10, err_msg=f)
  mujoco.mj_forward(mjm, mjd)
  act = np.nonzero(out.efc_active[0].numpy())[0]
  assert len(act) == mjd.nefc > 0
  ours = lambda f: getattr(out, f)[0].numpy()[act]
  np.testing.assert_allclose(ours("efc_J"), c_rows(mjm, mjd), atol=1e-10)
  np.testing.assert_allclose(ours("efc_pos"), mjd.efc_pos, atol=1e-10)
  np.testing.assert_allclose(ours("efc_D"), mjd.efc_D, atol=1e-7, rtol=1e-9)
  np.testing.assert_allclose(ours("efc_aref"), mjd.efc_aref, atol=1e-9)
  np.testing.assert_allclose(ours("efc_frictionloss"), mjd.efc_frictionloss,
                             atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_c_and_jax(name):
  """qacc and qfrc_constraint against C mj_forward (5e-6), and against the
  JAX package with both solves run to a tolerance of 1e-14 (1e-10 of each
  field's largest magnitude, at least 1)."""
  mjm, mjds, mp, dp = setup_lanes(name, seeds=(0, 1))
  out = mt.forward(mp, dp)
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    for f in ("qacc", "qfrc_constraint"):
      np.testing.assert_allclose(getattr(out, f)[i].numpy(), getattr(mjd, f),
                                 rtol=0, atol=5e-6, err_msg=f"{f} lane {i}")
  mjm.opt.tolerance = 1e-14
  mjm.opt.iterations = 100
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, dp)
  mj = mi.put_model(mjm)
  outj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjds[0]))
  for f in ("qacc", "qfrc_constraint", "efc_force"):
    ref = np.asarray(getattr(outj, f))
    # 1e-10 of the field's scale: the limited model's qacc reaches thousands
    np.testing.assert_allclose(getattr(out, f)[0].numpy(), ref, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(ref).max()),
                               err_msg=f)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_steps_match_c(name):
  """20 Euler steps of two lanes against C mj_step."""
  mjm, mjds, mp, dp = setup_lanes(name, seeds=(0, 1))
  dp = mt.step_n(mp, dp, 20)
  for i, mjd in enumerate(mjds):
    for _ in range(20):
      mujoco.mj_step(mjm, mjd)
    np.testing.assert_allclose(dp.qpos[i].numpy(), mjd.qpos, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dp.qvel[i].numpy(), mjd.qvel, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_inverse_matches_c(name):
  """inverse at a random qacc against C mj_inverse (1e-8), two lanes."""
  mjm, mjds, mp, _ = setup_lanes(name, seeds=(0, 3))
  for i, mjd in enumerate(mjds):
    mjd.qacc[:] = np.random.RandomState(50 + i).randn(mjm.nv)
  out = mt.inverse(mp, lanes(mp, mjds))
  for i, mjd in enumerate(mjds):
    mujoco.mj_inverse(mjm, mjd)
    for f in ("qfrc_inverse", "qfrc_constraint"):
      np.testing.assert_allclose(getattr(out, f)[i].numpy(), getattr(mjd, f),
                                 rtol=0, atol=1e-8, err_msg=f"{f} lane {i}")


def _applied(mjm, rng, batch):
  """Fresh applied forces of the fork's harness (and of the JAX package's
  ``test_slider_crank_fwdinv``)."""
  return (0.3 * rng.randn(batch, mjm.nv), 0.3 * rng.randn(batch, mjm.nbody, 6),
          0.2 * rng.randn(batch, mjm.nu))


def test_slider_crank_fwdinv():
  """BASELINE rung 1: the slider crank's forward/inverse consistency over
  10 steps with fresh random forces, both solver_fwdinv entries <= 1e-6
  (the reference fork's tolerance), as the JAX package's
  ``test_slider_crank_fwdinv`` checks the second."""
  mjm, _, mp, d = setup_lanes("slider_crank", seeds=(5, 6))
  rng = np.random.RandomState(11)
  for i in range(10):
    qfrc, xfrc, _ = _applied(mjm, rng, 2)
    d = d.replace(qfrc_applied=torch.as_tensor(qfrc),
                  xfrc_applied=torch.as_tensor(xfrc))
    out = mt.compare_fwd_inv(mp, mt.forward(mp, d))
    fwdinv = out.solver_fwdinv.numpy()
    assert np.all(fwdinv <= 1e-6), (i, fwdinv)
    assert np.all(out.efc_active.numpy()), "an equality row is inactive"
    d = mt.step(mp, d)
    assert torch.isfinite(d.qpos).all()


def test_slider_crank_rk4_harness_matches_c():
  """20 steps of the fork's inverse_test on the slider crank under RK4:
  fresh qfrc_applied, xfrc_applied and ctrl each step, forward and
  compare_fwd_inv (both entries <= 1e-6), then the step, beside C's
  mj_step with the same forces; qpos 1e-5 and qvel 1e-4 of C's."""
  mjm, mjds, mp, d = setup_lanes("slider_crank", seeds=(2, 4),
                                 integrator=mujoco.mjtIntegrator.mjINT_RK4)
  rng = np.random.RandomState(16)
  for _ in range(20):
    qfrc, xfrc, ctrl = _applied(mjm, rng, 2)
    d = d.replace(qfrc_applied=torch.as_tensor(qfrc),
                  xfrc_applied=torch.as_tensor(xfrc),
                  ctrl=torch.as_tensor(ctrl))
    out = mt.compare_fwd_inv(mp, mt.forward(mp, d))
    assert np.all(out.solver_fwdinv.numpy() <= 1e-6), out.solver_fwdinv
    d = mt.step(mp, d)
    for i, mjd in enumerate(mjds):
      mjd.qfrc_applied[:], mjd.xfrc_applied[:], mjd.ctrl[:] = (
          qfrc[i], xfrc[i], ctrl[i])
      mujoco.mj_step(mjm, mjd)
  for i, mjd in enumerate(mjds):
    np.testing.assert_allclose(d.qpos[i].numpy(), mjd.qpos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.qvel[i].numpy(), mjd.qvel, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_assets_match_the_test_models(name):
  """The vendored XML is the test's model, and its snapshot is what
  save_model_snapshot writes from it."""
  xml = mt.asset_path(f"{name}.xml").read_text()
  assert xml == MODELS[name].lstrip("\n")
  mjm = mujoco.MjModel.from_xml_string(xml)
  fresh = mt.put_model(mjm, device="cpu")
  snap = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  for field in fresh.__dataclass_fields__:
    a, b = getattr(fresh, field), getattr(snap, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field
    elif isinstance(a, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=field)
