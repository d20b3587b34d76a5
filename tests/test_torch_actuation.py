"""The PyTorch port's actuation: activation dynamics, gains and biases
(FIXED, AFFINE, MUSCLE), actearly, the integrators carrying ``act``, qDeriv,
the linearization with activations, iLQR on BASELINE rung 2 (the muscle
arm), C's IMPLICITFAST step of a lone free body, and the features the port
still refuses.

Models: the three vendored assets of the tendon slice (see
``tests/test_torch_tendon.py``), from seeded states, in float64, against C
MuJoCo and the JAX package.  Where the JAX package and C differ, the test
follows C and asserts the JAX difference.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import importlib

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import forward as fwd
from test_torch_tendon import MODELS, c_model, dense, seeded

import arm_reach_reference

ilqr_mod = importlib.import_module(
    "mujoco_inversedynamicstest_tpu_torch.opt.ilqr")
INTEGRATORS = ("EULER", "RK4", "IMPLICIT", "IMPLICITFAST")


def fleet(mp, mjds):
  """A port fleet of the input state of each MjData."""
  return mt.from_jax_arrays(mp, {
      k: np.stack([np.array(getattr(x, k)) for x in mjds])
      for k in ("qpos", "qvel", "act", "ctrl", "qfrc_applied")})


def with_integrator(name, integrator):
  mjm = c_model(name)
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  return mjm


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_c_and_jax(name):
  """act_dot, actuator_force, qfrc_actuator, qfrc_passive and ten_velocity
  against C mj_forward (1e-10), qacc (1e-9) and the active rows' efc_force
  (1e-7) on three seeded lanes; the same fields against the JAX package's
  forward (1e-9)."""
  mjm = with_integrator(name, "EULER")
  mjds = [seeded(mjm, seed) for seed in range(3)]
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, fleet(mp, mjds))
  mj = mi.put_model(mjm)
  fwd_j = jax.jit(mi.forward)
  fields = ["act_dot", "actuator_force", "qfrc_actuator", "qfrc_passive"]
  if mjm.ntendon:
    fields.append("ten_velocity")
  for i, mjd in enumerate(mjds):
    dj = fwd_j(mj, mi.put_data(mj, mjd))
    mujoco.mj_forward(mjm, mjd)
    for f in fields + ["qacc"]:
      got = getattr(out, f)[i].numpy()
      np.testing.assert_allclose(got, getattr(mjd, f), rtol=0,
                                 atol=1e-9 if f == "qacc" else 1e-10,
                                 err_msg=f"{f} lane {i} vs C")
      np.testing.assert_allclose(got, np.asarray(getattr(dj, f)), rtol=0,
                                 atol=1e-9, err_msg=f"{f} lane {i} vs JAX")
    if mjd.nefc:
      active = out.efc_active[i].numpy()
      np.testing.assert_allclose(out.efc_force[i].numpy()[active],
                                 mjd.efc_force, rtol=0, atol=1e-7)


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("name", MODELS)
def test_trajectories_match_c(name, integrator):
  """50 steps of two seeded lanes against C mj_step: qpos, qvel and act
  within 1e-9 at every step."""
  mjm = with_integrator(name, integrator)
  mjds = [seeded(mjm, seed) for seed in (4, 5)]
  mp = mt.put_model(mjm, device="cpu")
  d = fleet(mp, mjds)
  for k in range(50):
    d = mt.step(mp, d)
    for i, mjd in enumerate(mjds):
      mujoco.mj_step(mjm, mjd)
      for f in ("qpos", "qvel", "act"):
        np.testing.assert_allclose(getattr(d, f)[i].numpy(), getattr(mjd, f),
                                   rtol=0, atol=1e-9,
                                   err_msg=f"{f} lane {i} step {k}")


_CLAMPED = """
<mujoco><option integrator="implicitfast"/><worldbody><body>
  <joint name="j" type="hinge" axis="0 1 0"/>
  <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
</body></worldbody><actuator>
  <velocity joint="j" kv="3" forcelimited="true" forcerange="-0.1 0.1"/>
  <velocity joint="j" kv="2"/>
</actuator></mujoco>"""


@pytest.mark.parametrize("integrator", ["IMPLICIT", "IMPLICITFAST"])
@pytest.mark.parametrize("name", MODELS + ("clamped",))
def test_qderiv_matches_c(name, integrator):
  """qDeriv (``smooth_vel_deriv``, without the RNE term under
  IMPLICITFAST) against C's ``d.qDeriv`` after mj_step (1e-10), on two
  seeded lanes.  C keeps the muscles' force-velocity slope and gives a
  clamped force no slope (``clamped``: one velocity servo at its force
  limit, one free), as the JAX package's jacfwd does."""
  if name == "clamped":
    mjm = mujoco.MjModel.from_xml_string(_CLAMPED)
    mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  else:
    mjm = with_integrator(name, integrator)
  mjds = [seeded(mjm, seed) for seed in (6, 7)]
  if name == "clamped":
    for mjd in mjds:
      mjd.qvel[:] = 2.0
  mp = mt.put_model(mjm, device="cpu")
  full = integrator == "IMPLICIT"
  d = mt.forward(mp, fleet(mp, mjds))
  got = mt.opt.smooth_vel_deriv(mp, d, flg_bias=full).numpy()
  for i, mjd in enumerate(mjds):
    mujoco.mj_step(mjm, mjd)
    ref = np.zeros((mjm.nv, mjm.nv))
    mujoco.mju_sparse2dense(ref, mjd.qDeriv, mjm.D_rownnz, mjm.D_rowadr,
                            mjm.D_colind)
    np.testing.assert_allclose(got[i], ref, rtol=0, atol=1e-10,
                               err_msg=f"lane {i}")
  if name == "clamped":
    assert got[0, 0, 0] == -2.0   # the clamped servo adds nothing


@pytest.mark.parametrize("name", MODELS)
def test_compare_fwd_inv(name):
  """The fork's forward/inverse check on three seeded lanes, RK4: both
  solver_fwdinv entries <= 1e-6."""
  mjm = with_integrator(name, "RK4")
  mp = mt.put_model(mjm, device="cpu")
  d = fleet(mp, [seeded(mjm, seed) for seed in range(3)])
  for _ in range(3):
    out = mt.compare_fwd_inv(mp, mt.forward(mp, d))
    assert np.all(out.solver_fwdinv.numpy() <= 1e-6), out.solver_fwdinv
    d = mt.step(mp, d)


@pytest.mark.parametrize("name", MODELS)
def test_transition_matches_c(name):
  """transition_ad's A ((2 nv + na)^2) and B ((2 nv + na) x nu) of two
  seeded lanes against C's mjd_transitionFD (centered, eps 1e-6), within
  1e-6 of their largest entry, under EULER."""
  mjm = with_integrator(name, "EULER")
  mjds = [seeded(mjm, seed) for seed in (8, 9)]
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, fleet(mp, mjds))
  tr = mt.opt.transition_ad(mp, d)
  nx = 2 * mjm.nv + mjm.na
  assert tr.A.shape == (2, nx, nx) and tr.B.shape == (2, nx, mjm.nu)
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    a = np.zeros((nx, nx))
    b = np.zeros((nx, mjm.nu))
    mujoco.mjd_transitionFD(mjm, mjd, 1e-6, 1, a, b, None, None)
    for got, ref in ((tr.A[i].numpy(), a), (tr.B[i].numpy(), b)):
      np.testing.assert_allclose(got, ref, rtol=0,
                                 atol=1e-6 * max(1.0, np.abs(ref).max()))


def hand(qpos):
  """The tendon arm's hand site in the x-z plane: the closed-form planar
  kinematics of two 0.5 m links turning about -y from the origin."""
  t1, t2 = qpos[0], qpos[0] + qpos[1]
  return 0.5 * torch.stack([torch.cos(t1) + torch.cos(t2),
                            torch.sin(t1) + torch.sin(t2)])


def reach_cost(m, s, u, t, target):
  """|hand - target|^2 + 1e-3 |u|^2 for one sample."""
  del m, t
  dif = hand(s.qpos) - target
  return dif @ dif + 1e-3 * u @ u


def test_arm_reach_ilqr_matches_jax():
  """BASELINE rung 2 at a small size: a 2-problem H = 10 iLQR reach on
  the tendon arm (2 iterations, 2 alphas, no control limits: the JAX
  package's box QP adds about a minute to its compile here), each problem
  with its own target, from states away from the joint limits (where the
  JAX package's transition_ad differentiates the Newton iterations,
  ROADMAP §3), against the JAX package's ilqr vmapped over the problems:
  plan, cost and iterations to 1e-9; the plan moves the hand toward its
  target.  The JAX package's result is ``tests/arm_reach_reference.py``'s:
  stored, where its key (a hash of the JAX package's sources, the
  versions, the model and the problem) is this run's, else computed (its
  trace and compile take 3-5 minutes)."""
  mjm, mjds, targets, us0, kw = arm_reach_reference.problem()
  mj, mp = mi.put_model(mjm), mt.put_model(mjm, device="cpu")
  ref = arm_reach_reference.jax_result(mj, mjds, targets, us0, kw)
  got = ilqr_mod.ilqr(mp, reach_cost, fleet(mp, mjds), torch.as_tensor(us0),
                      ilqr_mod.ILQRConfig(**kw),
                      cost_args=(torch.as_tensor(targets),))
  for name in ("us", "cost"):
    np.testing.assert_allclose(getattr(got, name).numpy(), ref[name], rtol=0,
                               atol=1e-9, err_msg=name)
  np.testing.assert_array_equal(got.niter.numpy(), ref["niter"])
  start = np.linalg.norm(hand(got.xs.qpos[:, 0].T).T.numpy() - targets, axis=1)
  end = np.linalg.norm(hand(got.xs.qpos[:, -1].T).T.numpy() - targets, axis=1)
  assert np.all(end < start), (start, end)


_BOX = """<mujoco><option gravity="0 0 0" integrator="implicitfast"/>
<worldbody><body pos="0 0 1"><freejoint/><geom type="box" size=".1 .2 .3"/>
</body></worldbody><option><flag contact="disable"/></option></mujoco>"""
_OFF_CENTRE = """<mujoco><option integrator="implicitfast" timestep="0.01">
<flag contact="disable"/></option><worldbody>
<body pos="0 0 1" quat="0.8 0.2 -0.3 0.1">{joint}
<geom type="box" size=".1 .2 .3"/><inertial pos="0.1 -0.2 0.05"
 quat="0.9 0.1 0.3 -0.2" mass="2" diaginertia="0.1 0.2 0.3"/></body>
</worldbody></mujoco>"""


@pytest.mark.parametrize("case", ["box", "ball", "off_centre", "in_contact"])
def test_implicitfast_lone_body_follows_c(case):
  """C's IMPLICITFAST steps a free body alone in its tree, with no
  constraint row on it, by the implicit midpoint rule
  (``forward._midpoint_qvel``): 10 steps against C mj_step within 1e-9 in
  qpos and qvel, for the spinning box of ``scripts/
  implicitfast_gyro_probe.py``, a ball joint (no such term), a free body
  with an off-centre inertia, gravity and an applied force, and a box on
  the floor (a sphere: its contact rows keep the ordinary solve).  The JAX
  package has no such term: its box is off C by more than 1e-6."""
  if case == "box":
    mjm = mujoco.MjModel.from_xml_string(_BOX)
  elif case == "in_contact":
    mjm = mujoco.MjModel.from_xml_string(_BOX.replace(
        '<option><flag contact="disable"/></option>', "").replace(
            'gravity="0 0 0"', "").replace(
                "<worldbody>",
                '<worldbody><geom type="plane" size="2 2 .1"/>').replace(
                    'pos="0 0 1"', 'pos="0 0 0.19"').replace(
                        'type="box" size=".1 .2 .3"', 'size=".2"'))
  else:
    mjm = mujoco.MjModel.from_xml_string(_OFF_CENTRE.format(
        joint="<freejoint/>" if case == "off_centre" else
        '<joint type="ball"/>'))
  mjd = mujoco.MjData(mjm)
  mjd.qvel[-3:] = (0.3, 0.7, 1.0)
  mjd.qfrc_applied[:] = np.linspace(-0.5, 0.5, mjm.nv)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.put_data(mp, mjd)
  start = mujoco.MjData(mjm)
  mujoco.mj_copyData(start, mjm, mjd)
  for k in range(10):
    mujoco.mj_step(mjm, mjd)
    d = mt.step(mp, d)
    for f in ("qpos", "qvel"):
      np.testing.assert_allclose(getattr(d, f)[0].numpy(), getattr(mjd, f),
                                 rtol=0, atol=1e-9, err_msg=f"{f} step {k}")
  if case == "in_contact":
    assert mjd.ncon > 0
  if case == "box":
    mj = mi.put_model(mjm)
    dj = mi.put_data(mj, start)
    for _ in range(10):
      dj = jax.jit(mi.step)(mj, dj)
    assert np.abs(np.asarray(dj.qvel) - mjd.qvel).max() > 1e-6


def test_implicitfast_invdiscrete_skips_the_midpoint_as_c():
  """With INVDISCRETE on, C's IMPLICITFAST leaves the spinning box to the
  implicit solve alone (no midpoint rule), so that its discrete inverse
  gives back the applied force: 10 steps against C mj_step within 1e-9,
  and at each, the port's inverse at (qvel' - qvel) / h equal to C
  mj_inverse's and to qfrc_applied (1e-12)."""
  mjm = mujoco.MjModel.from_xml_string(_BOX)
  mjm.opt.enableflags |= mujoco.mjtEnableBit.mjENBL_INVDISCRETE
  mjd = mujoco.MjData(mjm)
  mjd.qvel[3:] = (0.3, 0.7, 1.0)
  mjd.qfrc_applied[:] = np.linspace(-0.5, 0.5, mjm.nv)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.put_data(mp, mjd)
  before = mujoco.MjData(mjm)
  for k in range(10):
    mujoco.mj_copyData(before, mjm, mjd)
    mujoco.mj_step(mjm, mjd)
    d = mt.step(mp, d)
    for f in ("qpos", "qvel"):
      np.testing.assert_allclose(getattr(d, f)[0].numpy(), getattr(mjd, f),
                                 rtol=0, atol=1e-9, err_msg=f"{f} step {k}")
    before.qacc[:] = (mjd.qvel - before.qvel) / mjm.opt.timestep
    got = mt.inverse(mp, mt.put_data(mp, before)).qfrc_inverse[0].numpy()
    mujoco.mj_inverse(mjm, before)
    np.testing.assert_allclose(got, before.qfrc_inverse, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, before.qfrc_applied, rtol=0, atol=1e-12)


_REFUSED = {
    # adhesion reads the contact slots' bodies, which a flex element contact
    # does not have
    "actuator transmission BODY": """<mujoco><worldbody>
      <flexcomp type="grid" count="3 3 1" spacing="0.1 0.1 0.1" radius="0.01"
                name="sheet" dim="2" mass="0.1"/>
      <body name="b" pos="0 0 0.3"><freejoint/><geom size="0.05"/></body>
      </worldbody><actuator><adhesion body="b" ctrlrange="0 1"/></actuator>
      </mujoco>""",
    "actuator dynamics USER": """<mujoco><worldbody><body>
      <joint name="j" type="hinge"/><geom size="0.1"/></body></worldbody>
      <actuator><general joint="j" dyntype="user"/></actuator></mujoco>""",
    "actuator gain USER": """<mujoco><worldbody><body>
      <joint name="j" type="hinge"/><geom size="0.1"/></body></worldbody>
      <actuator><general joint="j" gaintype="user"/></actuator></mujoco>""",
    "actuator bias USER": """<mujoco><worldbody><body>
      <joint name="j" type="hinge"/><geom size="0.1"/></body></worldbody>
      <actuator><general joint="j" biastype="user"/></actuator></mujoco>""",
}
# refused until the transmission and sensor-tail slice, which computes them:
# each is now held to C
_PORTED = {
    "actuator transmission SITE": """<mujoco><worldbody><body>
      <joint type="hinge"/><geom size="0.1"/><site name="s" pos="0.1 0 0"/>
      </body></worldbody><actuator><general site="s" gear="0 1 0 0 0 1"/>
      </actuator></mujoco>""",
    "actuator transmission SLIDERCRANK": """<mujoco><worldbody><body>
      <joint type="hinge" axis="0 1 0"/><geom size="0.1"/>
      <site name="a" pos="0.05 0 0"/></body>
      <body pos="0.3 0 0"><joint type="slide"/><geom size="0.1"/>
      <site name="b" euler="0 90 0"/></body></worldbody><actuator>
      <general cranksite="a" slidersite="b" cranklength="0.2"/>
      </actuator></mujoco>""",
    "sensor type TENDONLIMITPOS": """<mujoco><worldbody><body>
      <joint name="j" type="hinge"/><geom size="0.1"/></body></worldbody>
      <tendon><fixed name="t" limited="true" range="-1 1">
      <joint joint="j" coef="1"/></fixed></tendon>
      <sensor><tendonlimitpos tendon="t"/></sensor></mujoco>""",
}


@pytest.mark.parametrize("what", sorted(_REFUSED) + sorted(_PORTED) + [
    "actuator plugins", "muscle without the compiler's lengthrange"])
def test_validate_model_refuses_by_name(what):
  """put_model refuses each feature the port leaves out, by its name: the
  BODY transmission on a model with flex contacts, USER dynamics, gain
  and bias, an actuator plugin that the model does not have or whose port
  computes no actuator force (the PID is ported: tests/
  test_torch_plugins.py), and a muscle whose snapshot lacks the
  compiler's lengthrange.  The SITE and SLIDERCRANK transmissions and the
  tendon-limit sensors, which it refused before they were ported, load
  and match C's mj_forward at a state that moves them (1e-12)."""
  if what in _PORTED:
    mjm = mujoco.MjModel.from_xml_string(_PORTED[what])
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = 1.3
    mjd.qvel[:] = 0.4
    mujoco.mj_forward(mjm, mjd)
    mp = mt.put_model(mjm, device="cpu")
    d = mt.forward(mp, mt.put_data(mp, mjd))
    pairs = [(d.sensordata, mjd.sensordata)]
    if mjm.nu:
      pairs += [(d.actuator_length, mjd.actuator_length),
                (d.actuator_moment, dense(mjm, mjd, "actuator_moment"))]
    for got, ref in pairs:
      np.testing.assert_allclose(got[0].numpy(), ref, rtol=0, atol=1e-12)
    assert max(np.abs(ref).max(initial=0.0) for _, ref in pairs) > 0.1
    return
  if what in _REFUSED:
    src = mujoco.MjModel.from_xml_string(_REFUSED[what])
  else:
    src = dict(np.load(mt.asset_path("tendon_arm.npz")))
    if what == "actuator plugins":
      src["actuator_plugin"] = np.zeros_like(src["actuator_plugin"])
    else:
      src["actuator_lengthrange"] = np.zeros_like(
          src["actuator_lengthrange"])
  with pytest.raises(NotImplementedError, match=what):
    mt.put_model(src, device="cpu")


def test_next_activation_follows_c():
  """``next_activation`` on the tendon_rows model's FILTEREXACT (actlimited)
  and INTEGRATOR (actrange) activations against C's mj_step of act from
  the same act_dot: one EULER step of three seeded lanes, 1e-12."""
  mjm = with_integrator("tendon_rows", "EULER")
  mjds = [seeded(mjm, seed) for seed in range(3)]
  for mjd in mjds:
    mjd.act[:] = [0.45, -0.9]
    mjd.ctrl[:] = [0.0, 1.0, -1.0]
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, fleet(mp, mjds))
  nxt = fwd.next_activation(mp, d.act, d.act_dot).numpy()
  for i, mjd in enumerate(mjds):
    mujoco.mj_step(mjm, mjd)
    np.testing.assert_allclose(nxt[i], mjd.act, rtol=0, atol=1e-12)
  assert np.all(np.abs(nxt) <= [0.5, 1.0])
