"""The PyTorch port's fluid forces, in float64 on the CPU, against C MuJoCo
and the JAX package:

* ``tests/test_fluid.py``'s inertia-box model in its three settings (drag
  only, viscosity only, both with wind): ``qfrc_fluid`` and
  ``qfrc_passive`` to 1e-12, qacc to 1e-10, on a batch of seeded states;
* its ellipsoid model (added mass, Magnus and Kutta lift, drag and
  viscosity, beside inertia-box bodies): ``qfrc_fluid`` to 1e-12 of C and
  of the JAX package, and 100 Euler steps to 1e-12 of C;
* IMPLICIT and IMPLICITFAST steps of the inertia-box model against C
  (1e-12), and IMPLICIT steps of the ellipsoid model; in a fluid C steps
  a lone free body by the implicit solve, not by its midpoint rule.  Under
  IMPLICITFAST the ellipsoid model's velocity derivative in C 3.10 is not
  the exact one the port takes (its added-mass terms differ): that gap is
  printed, and the port's step held to the JAX package's (``jacfwd``'s
  exact derivative) to 1e-12;
* ``transition_ad`` of the fluid models against ``transition_fd`` and the
  forward/inverse consistency with fluid forces;
* a model without fluid computes none.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import forward as jforward
from mujoco_inversedynamicstest_tpu_torch.ops import forward, passive
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

BOX = """<mujoco>
<option density="{density}" viscosity="{viscosity}" wind="{wind}"/>
<worldbody>
  <body pos="0 0 1"><freejoint/><geom type="box" size=".1 .05 .2" mass="1"/>
    <body pos="0.2 0 0"><joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" size=".03" fromto="0 0 0 .3 0 0" mass=".4"/>
    </body>
  </body>
</worldbody></mujoco>"""
SETTINGS = [(1.2, 0.0, "0 0 0"), (0.0, 0.0002, "0 0 0"),
            (1.2, 0.0002, "0.5 -0.3 0.1")]

ELLIPSOID = """
<mujoco>
  <option density="1.2" viscosity="0.00002" wind="0.5 -0.3 0.1"
          timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1"><freejoint/>
      <geom type="ellipsoid" size="0.08 0.05 0.03" mass="0.2"
            fluidshape="ellipsoid" fluidcoef="0.5 0.25 1.5 1.0 1.0"/></body>
    <body pos="0.5 0 1"><freejoint/>
      <geom type="capsule" size="0.03 0.1" mass="0.1"
            fluidshape="ellipsoid"/>
      <geom type="sphere" size="0.05" pos="0.2 0 0" mass="0.1"/></body>
    <body pos="1 0 1"><freejoint/>
      <geom type="box" size="0.05 0.04 0.03" mass="0.2"/></body>
  </worldbody>
</mujoco>"""


def _states(mjm, n, seed, vel=1.0):
  """n seeded states: qpos0 and qvel ``vel`` randn, each an MjData after
  mj_forward."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    mjd = mujoco.MjData(mjm)
    mjd.qvel[:] = vel * rng.randn(mjm.nv)
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def _port_data(m, datas):
  return mt.from_jax_arrays(m, {k: np.stack([getattr(x, k) for x in datas])
                                for k in ("qpos", "qvel", "qacc_warmstart")})


@pytest.mark.parametrize("density,viscosity,wind", SETTINGS)
def test_box_fluid_matches_c(density, viscosity, wind):
  mjm = mujoco.MjModel.from_xml_string(BOX.format(
      density=density, viscosity=viscosity, wind=wind))
  datas = _states(mjm, 4, seed=1)
  m = mt.put_model(mjm, device="cpu")
  assert m.has_fluid
  d = mt.forward(m, _port_data(m, datas))
  for i, mjd in enumerate(datas):
    np.testing.assert_allclose(d.qfrc_fluid[i], mjd.qfrc_fluid, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(d.qfrc_passive[i], mjd.qfrc_passive, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(d.qacc[i], mjd.qacc, rtol=0, atol=1e-10)
  assert float(d.qfrc_fluid.abs().max()) > 1e-4


def test_no_fluid_is_a_no_op():
  mjm = mujoco.MjModel.from_xml_string(BOX.format(density=0, viscosity=0,
                                                  wind="0 0 0"))
  m = mt.put_model(mjm, device="cpu")
  assert not m.has_fluid
  d = mt.forward(m, _port_data(m, _states(mjm, 2, seed=0)))
  assert float(d.qfrc_fluid.abs().max()) == 0.0


def test_ellipsoid_fluid_matches_c_and_jax():
  mjm = mujoco.MjModel.from_xml_string(ELLIPSOID)
  datas = _states(mjm, 3, seed=0)
  m = mt.put_model(mjm, device="cpu")
  assert m.geom_fluid_active.tolist() == [True, True, False, False]
  d = mt.forward(m, _port_data(m, datas))
  mj = mi.put_model(mjm)
  jfwd = jax.jit(lambda dd: jforward.forward(mj, dd))
  for i, mjd in enumerate(datas):
    np.testing.assert_allclose(d.qfrc_fluid[i], mjd.qfrc_fluid, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(d.qacc[i], mjd.qacc, rtol=0, atol=1e-10)
    out = jfwd(mi.put_data(mj, mjd))
    np.testing.assert_allclose(d.qfrc_fluid[i], np.asarray(out.qfrc_fluid),
                               rtol=0, atol=1e-12)
  # the steps of all three lanes against C's
  for _ in range(100):
    for mjd in datas:
      mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  for i, mjd in enumerate(datas):
    np.testing.assert_allclose(d.qpos[i], mjd.qpos, rtol=0, atol=1e-12)


def _step_both(mjm, integrator, steps, vel=3.0, seed=1):
  mjm.opt.integrator = integrator
  datas = _states(mjm, 2, seed=seed, vel=vel)
  m = mt.put_model(mjm, device="cpu")
  d = _port_data(m, datas)
  for _ in range(steps):
    for mjd in datas:
      mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  return m, d, datas


@pytest.mark.parametrize("integrator", ["IMPLICIT", "IMPLICITFAST"])
def test_implicit_box_fluid_matches_c(integrator):
  mjm = mujoco.MjModel.from_xml_string(BOX.format(
      density=1.2, viscosity=0.0002, wind="0.5 -0.3 0.1"))
  _, d, datas = _step_both(
      mjm, getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}"), 20)
  for i, mjd in enumerate(datas):
    np.testing.assert_allclose(d.qpos[i], mjd.qpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.qvel[i], mjd.qvel, rtol=0, atol=1e-12)


def test_implicit_ellipsoid_fluid_matches_c():
  mjm = mujoco.MjModel.from_xml_string(ELLIPSOID)
  _, d, datas = _step_both(mjm, mujoco.mjtIntegrator.mjINT_IMPLICIT, 20)
  for i, mjd in enumerate(datas):
    np.testing.assert_allclose(d.qpos[i], mjd.qpos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.qvel[i], mjd.qvel, rtol=0, atol=1e-12)


def test_implicitfast_in_a_fluid_skips_the_midpoint_rule():
  """Viscosity alone: C's IMPLICITFAST step of the three lone free bodies
  is the implicit solve's (no midpoint rule), to 1e-12, for the
  ellipsoid and the box models alike."""
  mjm = mujoco.MjModel.from_xml_string(ELLIPSOID.replace(
      'density="1.2"', 'density="0"'))
  m, d, datas = _step_both(mjm, mujoco.mjtIntegrator.mjINT_IMPLICITFAST, 1)
  assert forward._midpoint_layout(m).body.size == 3
  for i, mjd in enumerate(datas):
    np.testing.assert_allclose(d.qvel[i], mjd.qvel, rtol=0, atol=1e-12)


def test_implicitfast_ellipsoid_departs_from_c_in_its_added_mass():
  """With density, C 3.10's IMPLICITFAST step of an ellipsoid-model body
  departs from the step with the exact velocity derivative (the port's,
  ``smooth_vel_deriv``'s JVP of ``passive``); the box-model body, and
  every body under IMPLICIT, agree to round-off.  The gap is printed, and
  the port is held to the exact step's own: the JAX package's
  IMPLICITFAST step (its ``smooth_vel_deriv`` is ``jax.jacfwd``) on the
  same states over 5 steps to 1e-12, and a solve of (M - h qDeriv_sym)
  qacc = f with qDeriv by central differences of ``fwd_velocity``."""
  mjm = mujoco.MjModel.from_xml_string(ELLIPSOID)
  m, d, datas = _step_both(mjm, mujoco.mjtIntegrator.mjINT_IMPLICITFAST, 1)
  gap = np.abs(d.qvel.numpy() - np.stack([x.qvel for x in datas])).reshape(
      2, 3, 6).max(axis=(0, 2))
  print(f"IMPLICITFAST qvel gap to C by body (ellipsoid, capsule+sphere, "
        f"box): {gap}")
  assert gap[2] < 1e-12 and gap[0] > 1e-8

  # the port's steps against the JAX package's from the same states
  mj = mi.put_model(mjm)
  jstep = jax.jit(mi.step)
  starts = _states(mjm, 2, seed=1, vel=3.0)
  dp = _port_data(m, starts)
  djs = [mi.put_data(mj, x) for x in starts]
  for _ in range(5):
    dp = mt.step(m, dp)
    djs = [jstep(mj, dj) for dj in djs]
  for i, dj in enumerate(djs):
    np.testing.assert_allclose(dp.qpos[i], np.asarray(dj.qpos), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dp.qvel[i], np.asarray(dj.qvel), rtol=0,
                               atol=1e-12)

  # the port's step against one with qDeriv from central differences
  d0 = _port_data(m, _states(mjm, 2, seed=1, vel=3.0))
  full = mt.forward(m, d0)
  eps = 1e-6
  cols = []
  for j in range(m.nv):
    e = torch.zeros(m.nv, dtype=torch.float64)
    e[j] = eps
    f = lambda s: passive.passive(m, forward.fwd_velocity(
        m, full.replace(qvel=full.qvel + s * e))).qfrc_passive
    cols.append((f(1.0) - f(-1.0)) / (2 * eps))
  qderiv = torch.stack(cols, dim=-1)
  mh = full.qM - m.opt.timestep * qderiv
  mh = 0.5 * (mh + mh.transpose(1, 2))
  qacc = torch.linalg.solve(mh, full.qfrc_smooth + full.qfrc_constraint)
  np.testing.assert_allclose(d.qvel, full.qvel + m.opt.timestep * qacc,
                             rtol=0, atol=1e-8)


@pytest.mark.parametrize("integrator", ["EULER", "IMPLICIT"])
def test_fluid_transition_ad_matches_fd(integrator):
  mjm = mujoco.MjModel.from_xml_string(ELLIPSOID)
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, _port_data(m, _states(mjm, 2, seed=3)))
  ad = derivative.transition_ad(m, d)
  fd = derivative.transition_fd(m, d, eps=1e-6, flg_centered=True)
  scale = float(fd.A.abs().max())
  assert float((ad.A - fd.A).abs().max()) <= 1e-6 * scale


def test_inverse_with_fluid_matches_forward():
  """inverse sees the fluid forces through passive: compare_fwd_inv's
  solver_fwdinv within 1e-9 on the box model, with contact-free rows."""
  mjm = mujoco.MjModel.from_xml_string(BOX.format(
      density=1.2, viscosity=0.0002, wind="0.5 -0.3 0.1").replace(
          '<joint type="hinge" axis="0 1 0"/>',
          '<joint type="hinge" axis="0 1 0" limited="true" range="-5 5"/>'))
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, _port_data(m, _states(mjm, 3, seed=4)))
  d = mt.compare_fwd_inv(m, d)
  assert float(d.solver_fwdinv.max()) <= 1e-9
  mjd = _states(mjm, 1, seed=4)[0]
  mujoco.mj_inverse(mjm, mjd)
  inv = mt.inverse(m, mt.forward(m, _port_data(m, [mjd])))
  np.testing.assert_allclose(inv.qfrc_inverse[0], mjd.qfrc_inverse, rtol=0,
                             atol=1e-9)


def test_fluid_layout_groups_bodies_and_geoms():
  """The box model skips the bodies that own an ellipsoid geom and the
  world; the ellipsoid model takes only the ellipsoid geoms."""
  m = mt.put_model(mujoco.MjModel.from_xml_string(ELLIPSOID), device="cpu")
  bodies, geoms = passive._fluid_layout(m)
  assert bodies.tolist() == [3] and geoms.tolist() == [0, 1]
  # a massless body is skipped by both, as C's mj_fluid skips it
  m2 = dataclasses.replace(m, body_mass=m.body_mass * torch.tensor(
      [1.0, 0.0, 1.0, 1.0], dtype=torch.float64), _memo={})
  bodies, geoms = passive._fluid_layout(m2)
  assert bodies.tolist() == [3] and geoms.tolist() == [1]
