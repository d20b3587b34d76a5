"""The Newton solver, derivatives and model checks of the port's equality,
friction-loss and ball-limit rows.

``forces_cost`` and the line search's cost along a direction against the
JAX package where the friction rows pass through all three of their zones;
per-lane ``eq_active``, the EQUALITY and FRICTIONLOSS disable flags,
``jac``/``jac_dot``, ``transition_ad`` and the mocap poses against C
MuJoCo; the refusals of ``validate_model`` by name (float64, CPU).

The Newton solve in float32 against float64 on the same states, under
each friction cone (box_stack, elliptic_pairs; 16 lanes): every fp32 lane
meets the solver's tolerance, its qacc lies within 1e-3 of max|qacc|, and
the fp64 cost at the fp32 qacc within 1e-6 (relative) of the fp64
optimum.  fp32 fleets run the solver's tolerances floored at 10 ulp (the
outer loop's and the line search's slope test) and its tie rule.
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
from mujoco_inversedynamicstest_tpu.ops import constraint as jconstraint
from mujoco_inversedynamicstest_tpu.ops import solver as jsolver
from mujoco_inversedynamicstest_tpu_torch.models.types import DisableBit
from mujoco_inversedynamicstest_tpu_torch.ops import constraint, math, solver
from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.opt import derivative
from test_torch_constraint_rows import MODELS, lanes, setup_lanes

# a mocap body carrying a hinged child: C moves the child with it
MOCAP_CHILD = """
<mujoco>
  <option><flag contact="disable"/></option>
  <worldbody>
    <body name="hand" mocap="true" pos="0 0 1">
      <body name="finger" pos="0.1 0 0">
        <joint type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.01" fromto="0 0 0 0.1 0 0" mass="0.1"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _friction_state():
  """The friction-loss model's forward at four seeded states, C's and the
  port's, with the jar of each lane spread over the three zones of its
  friction rows: jar = c R floss for c in (-2, -0.5, 0.5, 2) by lane."""
  mjm, mjds, mp, dp = setup_lanes("frictionloss", seeds=(0, 1, 2, 3))
  out = mt.forward(mp, dp)
  c = torch.tensor([-2.0, -0.5, 0.5, 2.0], dtype=torch.float64)[:, None]
  jar = c * out.efc_R * out.efc_frictionloss
  return mjm, mjds, mp, out, jar


def test_forces_cost_matches_jax_in_every_friction_zone():
  mjm, mjds, mp, out, jar = _friction_state()
  quad = constraint.zones(mp, out, jar)[0].numpy()
  assert quad[1:3].all() and not quad[[0, 3]].any()
  force, cost, _ = constraint.forces_cost(mp, out, jar)
  mj = mi.put_model(mjm)
  for i, mjd in enumerate(mjds):
    dj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
    fj, cj, qj, _ = jconstraint.forces_cost(mj, dj, jnp.asarray(jar[i]))
    np.testing.assert_array_equal(quad[i], np.asarray(qj))
    np.testing.assert_allclose(force[i].numpy(), np.asarray(fj), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(float(cost[i]), float(cj), rtol=1e-12,
                               atol=1e-12)


def test_line_cost_matches_jax_across_friction_zones():
  """phi(alpha) and phi'(alpha) of ``solver.line_phi`` against the JAX
  package's total cost (and its derivative along the direction) at
  qacc + alpha search, where the direction takes each friction row through
  its three zones as alpha runs over [-2, 2]."""
  mjm, mjds, mp, out, _ = _friction_state()
  # from J qacc0 = aref along J search = 2 R floss, each friction row's
  # x = 2 alpha R floss crosses both kinks
  solve = lambda rhs: torch.linalg.lstsq(out.efc_J, rhs[..., None]
                                         ).solution[..., 0]
  qacc0 = solve(out.efc_aref)
  search = solve(2 * out.efc_R * out.efc_frictionloss)
  st = solver._eval_state(mp, out, qacc0, with_grad=False)
  st.search = search
  phi, _, _ = solver.line_phi(mp, out, st)
  alphas = np.linspace(-2.0, 2.0, 9)
  got = np.stack([phi(torch.full((4,), a, dtype=torch.float64)).numpy()
                  for a in alphas])                         # (9, 4, 4)
  seen = [constraint.zones(mp, out, st.jaref + a * (2 * out.efc_R
                                                    * out.efc_frictionloss))
          for a in alphas]
  for zone in zip(*seen):       # every row in every zone on every lane
    assert torch.stack(zone).any(0).all()
  mj = mi.put_model(mjm)

  @jax.jit
  def cost_slope(dj, q0, s, alpha):
    cost = lambda a: jsolver._eval_state(mj, dj, q0 + a * s, False).cost
    return jax.jvp(cost, (alpha,), (jnp.ones_like(alpha),))

  for i in (0, 3):
    dj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjds[i]))
    for k, alpha in enumerate(alphas):
      c, slope = cost_slope(dj, jnp.asarray(qacc0[i].numpy()),
                            jnp.asarray(search[i].numpy()),
                            jnp.asarray(alpha))
      np.testing.assert_allclose(got[k, i, 1], float(c), rtol=1e-12,
                                 atol=1e-10)
      np.testing.assert_allclose(got[k, i, 2], float(slope), rtol=1e-10,
                                 atol=1e-9)


@pytest.mark.parametrize("name", ["slider_crank", "weld"])
def test_inactive_equality_lane_matches_c(name):
  """A fleet whose second lane has its equality switched off: each lane's
  forward and 10 steps against C with the same eq_active.  The inactive
  lane has no row (C's nefc = 0: no Newton iteration)."""
  mjm, mjds, mp, _ = setup_lanes(name, seeds=(0, 1))
  mjds[1].eq_active[:] = 0
  d = lanes(mp, mjds)
  out = mt.forward(mp, d)
  assert out.efc_active[0].all() and not out.efc_active[1].any()
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    assert int(out.solver_niter[i]) == mjd.solver_niter[0]
    np.testing.assert_allclose(out.qacc[i].numpy(), mjd.qacc, rtol=0,
                               atol=5e-6)
  d = mt.step_n(mp, d, 10)
  for i, mjd in enumerate(mjds):
    for _ in range(10):
      mujoco.mj_step(mjm, mjd)
    np.testing.assert_allclose(d.qpos[i].numpy(), mjd.qpos, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name, bit", [
    ("slider_crank", "EQUALITY"), ("weld", "EQUALITY"),
    ("frictionloss", "FRICTIONLOSS")])
def test_disable_flags_match_c(name, bit):
  mjm = mujoco.MjModel.from_xml_string(MODELS[name])
  mjm.opt.disableflags |= int(DisableBit[bit])
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = mjm.qpos0 + 0.1
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.3
  mp = mt.put_model(mjm, device="cpu")
  lay = constraint.row_layout(mp)
  assert lay.ne == 0 if bit == "EQUALITY" else lay.nf == 0
  out = mt.forward(mp, lanes(mp, [mjd]))
  mujoco.mj_forward(mjm, mjd)
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=5e-6)


def test_ball_limit_at_the_identity_stays_finite():
  """A ball joint at exactly the identity quaternion: its limit row is
  inactive and exactly zero, and forward, step and transition_ad are
  finite (the axis of a zero rotation is 0, not 0/0)."""
  mjm = mujoco.MjModel.from_xml_string(MODELS["limited"])
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, mt.make_data(mp, 2))
  lay = constraint.row_layout(mp)
  ball = lay.ne + lay.nf + 2 * len(lay.limit_jnt)     # the ball row last
  assert mp.jnt_type[lay.ball_jnt].tolist() == [1] and lay.nl == ball + 1
  assert torch.equal(d.efc_J[:, ball], torch.zeros_like(d.efc_J[:, ball]))
  assert not d.efc_active[:, ball].any()
  assert torch.isfinite(mt.step(mp, d).qpos).all()
  tr = derivative.transition_ad(mp, d)
  assert torch.isfinite(tr.A).all() and torch.isfinite(tr.B).all()


@pytest.mark.parametrize("name", ["weld", "mocap_weld", "limited"])
def test_jac_and_jac_dot_match_c(name):
  """Point Jacobians and their time derivatives of a body-fixed point on
  every body, against C ``mj_jac`` and ``mj_jacDot`` after mj_forward."""
  mjm, (mjd,), mp, dp = setup_lanes(name, seeds=(7,))
  out = mt.fwd_velocity(mp, mt.fwd_position(mp, dp))
  mujoco.mj_forward(mjm, mjd)
  bodies = np.arange(1, mjm.nbody)
  offset = np.random.RandomState(3).randn(len(bodies), 3) * 0.1
  points = np.asarray(mjd.xpos)[bodies] + offset
  pt = torch.as_tensor(points)[None]
  jacp, jacr = support.jac(mp, out, pt, bodies)
  jpd, jrd = support.jac_dot(mp, out, pt, bodies)
  for k, b in enumerate(bodies):
    ref = [np.zeros((3, mjm.nv)) for _ in range(4)]
    mujoco.mj_jac(mjm, mjd, ref[0], ref[1], points[k], int(b))
    mujoco.mj_jacDot(mjm, mjd, ref[2], ref[3], points[k], int(b))
    for got, want, what in zip((jacp, jacr, jpd, jrd), ref,
                               ("jacp", "jacr", "jacp_dot", "jacr_dot")):
      np.testing.assert_allclose(got[0, k].numpy().T, want, rtol=0,
                                 atol=1e-10, err_msg=f"{what} body {b}")


def _c_transition(mjm, mjd, eps=1e-6):
  a = np.zeros((2 * mjm.nv, 2 * mjm.nv))
  b = np.zeros((2 * mjm.nv, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, eps, 1, a, b if mjm.nu else None, None,
                          None)
  return a, b


@pytest.mark.parametrize("name", ["slider_crank", "frictionloss"])
def test_transition_ad_matches_c_fd(name):
  """transition_ad after forward against C's centered mjd_transitionFD
  (eps 1e-6), within 1e-6 of max|A|, two lanes.  (C's forward differences
  carry a truncation error above that bound on the slider crank.)"""
  mjm, mjds, mp, dp = setup_lanes(name, seeds=(0, 1))
  tr = derivative.transition_ad(mp, mt.forward(mp, dp))
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    a, b = _c_transition(mjm, mjd)
    scale = np.abs(a).max()
    np.testing.assert_allclose(tr.A[i].numpy(), a, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(tr.B[i].numpy(), b, rtol=0, atol=1e-6 * scale)


def _snapshot(name, **change):
  with np.load(mt.asset_path(f"{name}.npz")) as z:
    snap = {k: z[k] for k in z.files}
  snap.update({k: np.asarray(v) for k, v in change.items()})
  return snap


# force and torque sensors on a body that a connect or a weld holds
SENSORS = {
    "slider_crank": MODELS["slider_crank"].replace(
        "<actuator>", '<sensor><force site="rodtip"/><torque site="rodtip"/>'
        '<accelerometer site="rodtip"/></sensor><actuator>'),
    "weld": MODELS["weld"].replace(
        '<geom type="box" size="0.03 0.03 0.03" mass="0.3"/>',
        '<geom type="box" size="0.03 0.03 0.03" mass="0.3"/><site name="s"/>'
    ).replace("</mujoco>", '<sensor><force site="s"/><torque site="s"/>'
              "</sensor></mujoco>"),
}


@pytest.mark.parametrize("src, what", [
    (_snapshot("slider_crank", eq_type=[5]), "FLEXVERT equality"),
    (_snapshot("slider_crank", eq_type=[6]), "FLEXSTRAIN equality"),
    (_snapshot("slider_crank", eq_type=[4]), "FLEX equality"),
    (_snapshot("slider_crank", eq_type=[7]), "DISTANCE equality"),
], ids=["flexvert", "flexstrain", "flex", "distance"])
def test_put_model_refuses_unported_equalities(src, what):
  if isinstance(src, str):
    src = mujoco.MjModel.from_xml_string(src)
  with pytest.raises(NotImplementedError, match=what):
    mt.put_model(src, device="cpu")


def test_make_data_mocap_follows_c_reset():
  """make_data puts each mocap body at its model pose, as C's
  mj_resetData; the JAX package's make_data puts it at the origin with the
  identity quaternion (ROADMAP queue 3)."""
  for xml in (MOCAP_CHILD, MODELS["mocap_weld"]):
    model = mujoco.MjModel.from_xml_string(xml)
    mjd = mujoco.MjData(model)
    mujoco.mj_resetData(model, mjd)
    mp = mt.put_model(model, device="cpu")
    d = mt.make_data(mp, 3)
    for f in ("mocap_pos", "mocap_quat"):
      np.testing.assert_array_equal(getattr(d, f).numpy(),
                                    np.repeat(getattr(mjd, f)[None], 3, 0))
    dj = mi.make_data(mi.put_model(model))
    assert not np.allclose(np.asarray(dj.mocap_pos), mjd.mocap_pos)


def test_mocap_child_follows_c():
  """A mocap body's child moves with the mocap pose in C's mj_kinematics
  and in the port; the JAX package sets the mocap pose after its tree pass,
  so there the child stays at the model pose (ROADMAP queue 3)."""
  mjm = mujoco.MjModel.from_xml_string(MOCAP_CHILD)
  mjd = mujoco.MjData(mjm)
  mjd.mocap_pos[:] = [[0.3, -0.2, 0.7]]
  mjd.mocap_quat[:] = [[0.8, 0.0, 0.6, 0.0]]
  mjd.qpos[:] = [0.4]
  mujoco.mj_kinematics(mjm, mjd)
  mp = mt.put_model(mjm, device="cpu")
  out = mt.fwd_position(mp, lanes(mp, [mjd]))
  np.testing.assert_allclose(out.xpos[0].numpy(), mjd.xpos, rtol=0,
                             atol=1e-12)
  np.testing.assert_allclose(out.xquat[0].numpy(), mjd.xquat, rtol=0,
                             atol=1e-12)
  mj = mi.put_model(mjm)
  dj = jax.jit(mi.kinematics)(mj, mi.put_data(mj, mjd))
  assert np.abs(np.asarray(dj.xpos)[2] - mjd.xpos[2]).max() > 0.1


@pytest.mark.parametrize("name", sorted(SENSORS))
def test_force_torque_sensors_see_equality_forces(name):
  """Force and torque sensors of a body held by a connect or a weld: C's
  mj_rnePostConstraint adds the constraint's forces to cfrc_ext, and so
  does the port (sensordata within 1e-8 of C's after mj_forward, two
  lanes); the JAX package leaves them out (ROADMAP queue 3)."""
  mjm = mujoco.MjModel.from_xml_string(SENSORS[name])
  mjds = []
  for seed in (0, 1):
    mjd = mujoco.MjData(mjm)
    rng = np.random.RandomState(seed)
    mjd.qpos[:] = mjm.qpos0 + 0.3 * rng.randn(mjm.nq)
    mujoco.mj_normalizeQuat(mjm, mjd.qpos)
    mjd.qvel[:] = 0.6 * rng.randn(mjm.nv)
    mjds.append(mjd)
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, lanes(mp, mjds))
  mj = mi.put_model(mjm)
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(out.sensordata[i].numpy(), mjd.sensordata,
                               rtol=0, atol=1e-8, err_msg=f"lane {i}")
    dj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
    assert np.abs(np.asarray(dj.sensordata) - mjd.sensordata).max() > 1e-2


@pytest.mark.parametrize("integrator", ["EULER", "RK4", "IMPLICITFAST"])
def test_integrators_carry_eq_active_and_mocap(integrator):
  """The advance and RK4's stages keep each lane's eq_active and mocap
  pose: 10 steps of the mocap weld, its second lane's weld off, against C
  mj_step (qpos 1e-6), and the inputs come back unchanged."""
  mjm, mjds, mp, _ = setup_lanes(
      "mocap_weld", seeds=(0, 1),
      integrator=getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}"))
  mjds[1].eq_active[:] = 0
  d0 = lanes(mp, mjds)
  d = mt.step_n(mp, d0, 10)
  for f in ("eq_active", "mocap_pos", "mocap_quat"):
    assert torch.equal(getattr(d, f), getattr(d0, f)), f
  for i, mjd in enumerate(mjds):
    for _ in range(10):
      mujoco.mj_step(mjm, mjd)
    np.testing.assert_allclose(d.qpos[i].numpy(), mjd.qpos, rtol=0,
                               atol=1e-6, err_msg=f"lane {i}")


@pytest.mark.parametrize("cone", ["PYRAMIDAL", "ELLIPTIC"])
@pytest.mark.parametrize("name", ["box_stack", "elliptic_pairs"])
def test_fp32_solve_matches_fp64(name, cone):
  """fp32 fleets run the solver's floored tolerances (the outer loop's and
  the line search's slope test, 10 ulp) and its tie rule: their solve
  must still reach fp64's optimum to fp32's precision."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  mjm.opt.cone = getattr(mujoco.mjtCone, f"mjCONE_{cone}")
  m64 = mt.put_model(mjm, device="cpu")
  m32 = mt.put_model(mjm, device="cpu", dtype=torch.float32)
  lanes = 16
  qvel = 0.3 * np.random.RandomState(0).randn(lanes, mjm.nv)
  d = mt.from_jax_arrays(m64, {"qpos": np.stack([mjm.qpos0] * lanes),
                               "qvel": qvel})
  d = mt.step(m64, mt.step(m64, d))
  f64 = mt.forward(m64, d)
  f32 = mt.forward(m32, mt.from_jax_arrays(
      m32, {"qpos": d.qpos.numpy(), "qvel": d.qvel.numpy()}))
  assert int(f64.efc_active.any(-1).sum()) >= lanes // 2
  assert int(f32.solver_niter.max()) < mjm.opt.iterations
  scale = float(f64.qacc.abs().max())
  err = float((f32.qacc.double() - f64.qacc).abs().max())
  assert err <= 1e-3 * scale, (err, scale)
  cost64 = solver._eval_state(m64, f64, f64.qacc, False).cost
  cost32 = solver._eval_state(m64, f64, f32.qacc.double(), False).cost
  gap = cost32 - cost64
  assert bool((gap <= 1e-6 * torch.clamp(cost64.abs(), min=1.0)).all()), (
      gap.max(), cost64.abs().max())
  if cone == "ELLIPTIC":
    jar = math.matvec(f64.efc_J, f64.qacc) - f64.efc_aref
    assert int(constraint.cone_quantities(m64, f64, jar).middle.sum()) > 0
