"""The PyTorch port's in-step control callback (``ctrl_fn`` of
``forward``/``step``, C's ``mjcb_control``) and its batched rollout
(``opt/rollout.py``, ``mujoco.rollout.rollout``), in float64:

* a feedback policy (``tests/test_rollout.py``'s PD law plus a term in
  ``d.time``) fired inside the step on the JAX tests' ACTUATED model under
  EULER, RK4, IMPLICIT and IMPLICITFAST, and a muscle policy reading
  ``actuator_velocity`` on ``tendon_arm`` under RK4: 25 steps, the whole
  ``mjSTATE_INTEGRATION`` state (ctrl and warm start included) against C's
  ``mjcb_control`` within 1e-8.  Under RK4 the callback fires in each
  stage at the stage's time and the step keeps stage 4's ctrl, as C;
  with actuation disabled it does not fire, as C 3.10;
* ``rollout`` against ``mujoco.rollout.rollout`` on ACTUATED (4 lanes x 25
  steps, 1e-8) and on the Newton-100 humanoid in contact (2 lanes x 10
  steps, 1e-6), and against the JAX package's ``opt.rollout`` under EULER
  (1e-10).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import mujoco
import mujoco.rollout
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu import opt as jax_opt
from mujoco_inversedynamicstest_tpu_torch.models.types import StateFlag
from models import ACTUATED

INTEGRATION = int(mujoco.mjtState.mjSTATE_INTEGRATION)
FULLPHYSICS = int(mujoco.mjtState.mjSTATE_FULLPHYSICS)
KP, KD, WAVE = 2.0, 0.4, 0.3


def c_state(mjm, mjd, spec):
  out = np.zeros(mujoco.mj_stateSize(mjm, spec))
  mujoco.mj_getState(mjm, mjd, out, spec)
  return out


def seeded(mjm, seed):
  rng = np.random.RandomState(seed)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_integratePos(mjm, mjd.qpos, 0.2 * rng.randn(mjm.nv), 1.0)
  mjd.qvel[:] = 0.3 * rng.randn(mjm.nv)
  mjd.act[:] = rng.uniform(0, 1, mjm.na)
  return mjd


def pd_policies(mjm):
  """tests/test_rollout.py's PD law on each actuator's joint, plus a wave
  in time: (the port's ctrl_fn, the C callback)."""
  trn = np.asarray(mjm.actuator_trnid[:, 0])
  qadr, vadr = mjm.jnt_qposadr[trn], mjm.jnt_dofadr[trn]

  def ours(m, d):
    return (-KP * d.qpos[:, qadr] - KD * d.qvel[:, vadr]
            + WAVE * torch.sin(40.0 * d.time)[:, None])

  def c(cm, cd):
    cd.ctrl[:] = (-KP * cd.qpos[qadr] - KD * cd.qvel[vadr]
                  + WAVE * np.sin(40.0 * cd.time))

  return ours, c


def muscle_policies():
  """Muscle inputs in (0.1, 0.9) from the actuators' velocities, which the
  velocity stage computes before the callback."""

  def ours(m, d):
    return 0.5 - 0.4 * torch.tanh(5.0 * d.actuator_velocity)

  def c(cm, cd):
    cd.ctrl[:] = 0.5 - 0.4 * np.tanh(5.0 * cd.actuator_velocity)

  return ours, c


def run_both(mjm, ours, c, nstep=25, seed=0):
  """The INTEGRATION states of nstep steps of the port (ctrl_fn) and of C
  (mjcb_control) from one seeded state."""
  mjd = seeded(mjm, seed)
  m = mt.put_model(mjm, device="cpu")
  d = mt.put_data(m, mjd)
  got, want = [], []
  for _ in range(nstep):
    d = mt.step(m, d, ctrl_fn=ours)
    got.append(mt.get_state(m, d, INTEGRATION)[0].numpy())
  mujoco.set_mjcb_control(c)
  try:
    for _ in range(nstep):
      mujoco.mj_step(mjm, mjd)
      want.append(c_state(mjm, mjd, INTEGRATION))
  finally:
    mujoco.set_mjcb_control(None)
  return np.array(got), np.array(want)


@pytest.mark.parametrize("integrator", ["EULER", "RK4", "IMPLICIT",
                                        "IMPLICITFAST"])
def test_ctrl_fn_matches_c_callback(integrator):
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  got, want = run_both(mjm, *pd_policies(mjm))
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_ctrl_fn_matches_c_callback_on_the_muscle_arm_under_rk4():
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("tendon_arm.xml")))
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
  got, want = run_both(mjm, *muscle_policies())
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_rk4_fires_at_each_stage_and_keeps_the_last():
  """Under RK4 the callback sees the step's time and three stage times
  (h/2, h/2, h), as C's; the step ends with stage 4's ctrl."""
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  mjm.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
  m = mt.put_model(mjm, device="cpu")
  seen = []

  def count(m_, d):
    seen.append(float(d.time[0]))
    return torch.full_like(d.ctrl, float(len(seen)))

  d = mt.step(m, mt.make_data(m, 1), ctrl_fn=count)
  h = mjm.opt.timestep
  assert seen == [0.0, 0.5 * h, 0.5 * h, h]
  assert torch.equal(d.ctrl, torch.full_like(d.ctrl, 4.0))
  assert float(d.time[0]) == h


@pytest.mark.parametrize("integrator", ["EULER", "RK4"])
def test_ctrl_fn_does_not_fire_with_actuation_disabled(integrator):
  """C 3.10 skips mjcb_control under mjDSBL_ACTUATION; so does the port,
  and the state follows C's."""
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  mjm.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_ACTUATION
  calls = []

  def ours(m, d):
    calls.append(1)
    return d.ctrl + 1.0

  def c(cm, cd):
    calls.append(1)
    cd.ctrl[:] += 1.0

  got, want = run_both(mjm, ours, c, nstep=10)
  assert not calls
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("integrator", ["EULER", "RK4", "IMPLICITFAST"])
def test_identity_ctrl_fn_changes_nothing(integrator):
  """A callback that writes back the controls it was given leaves every
  step bit-identical to a step without one."""
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  m = mt.put_model(mjm, device="cpu")
  d0 = mt.put_data(m, seeded(mjm, 3))
  d0 = d0.replace(ctrl=torch.full_like(d0.ctrl, 0.3))
  a = mt.step_n(m, d0, 5)
  b = mt.step_n(m, d0, 5, ctrl_fn=lambda m_, d: d.ctrl)
  for f in ("qpos", "qvel", "act", "qacc", "qacc_warmstart", "ctrl", "time"):
    assert torch.equal(getattr(a, f), getattr(b, f)), f


def initial_states(mjm, nbatch, seed, drop=0.0):
  rng = np.random.RandomState(seed)
  mjd = mujoco.MjData(mjm)
  init = np.zeros((nbatch, mujoco.mj_stateSize(mjm, FULLPHYSICS)))
  for b in range(nbatch):
    mujoco.mj_resetData(mjm, mjd)
    mujoco.mj_integratePos(mjm, mjd.qpos, 0.1 * rng.randn(mjm.nv), 1.0)
    mjd.qpos[2] -= drop
    mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
    init[b] = c_state(mjm, mjd, FULLPHYSICS)
  return init


@pytest.mark.parametrize("spec", ["CTRL", "CTRL|QFRC_APPLIED"])
def test_rollout_matches_mujoco_rollout(spec):
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  flags = [getattr(mujoco.mjtState, f"mjSTATE_{f}") for f in spec.split("|")]
  cspec = int(np.bitwise_or.reduce([int(f) for f in flags]))
  nbatch, nstep = 4, 25
  init = initial_states(mjm, nbatch, seed=1)
  rng = np.random.RandomState(2)
  control = 0.3 * rng.randn(nbatch, nstep, mujoco.mj_stateSize(mjm, cspec))
  want, want_sensor = mujoco.rollout.rollout(
      mjm, mujoco.MjData(mjm), init, control, control_spec=cspec)
  m = mt.put_model(mjm, device="cpu")
  got = mt.opt.rollout(m, torch.as_tensor(init), torch.as_tensor(control),
                       control_spec=cspec)
  assert got.state.shape == want.shape == (nbatch, nstep, init.shape[1])
  np.testing.assert_allclose(got.state.numpy(), want, rtol=0, atol=1e-8)
  assert got.sensordata.shape == want_sensor.shape


def test_rollout_matches_mujoco_rollout_on_the_humanoid():
  """The Newton-100 humanoid dropped onto the floor: 2 lanes x 10 steps of
  random controls, FULLPHYSICS within 1e-6."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  init = initial_states(mjm, 2, seed=3, drop=0.22)
  control = np.random.RandomState(4).uniform(-1, 1, (2, 10, mjm.nu))
  want, _ = mujoco.rollout.rollout(mjm, mujoco.MjData(mjm), init, control)
  m = mt.put_model(mjm, device="cpu")
  got = mt.opt.rollout(m, torch.as_tensor(init), torch.as_tensor(control))
  np.testing.assert_allclose(got.state.numpy(), want, rtol=0, atol=1e-6)
  # the lanes touched the floor
  d = mt.forward(m, mt.set_state(m, mt.make_data(m, 2),
                                 got.state[:, -1]))
  assert bool((d.contact.dist < d.contact.includemargin).any())


def test_rollout_closed_loop_and_no_control():
  """Closed loop with nstep alone is the step loop with ctrl_fn; identical
  initial states give identical lanes."""
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  ours, _ = pd_policies(mjm)
  init = np.repeat(initial_states(mjm, 1, seed=5), 2, axis=0)
  m = mt.put_model(mjm, device="cpu")
  out = mt.opt.rollout(m, torch.as_tensor(init), nstep=10, ctrl_fn=ours)
  assert out.state.shape == (2, 10, init.shape[1])
  assert torch.equal(out.state[0], out.state[1])
  d = mt.set_state(m, mt.make_data(m, 2), torch.as_tensor(init))
  for t in range(10):
    d = mt.step(m, d, ctrl_fn=ours)
    assert torch.equal(out.state[:, t], mt.get_state(m, d, StateFlag.FULLPHYSICS))
  with pytest.raises(ValueError):
    mt.opt.rollout(m, torch.as_tensor(init))


def test_rollout_matches_jax_rollout():
  """Against the JAX package's opt.rollout (EULER, open loop): 3 lanes x
  10 steps, within 1e-10.  Its FULLPHYSICS layout is C 3.10's here (the
  bits it lacks are empty on this model)."""
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  init = initial_states(mjm, 3, seed=6)
  control = 0.3 * np.random.RandomState(7).randn(3, 10, mjm.nu)
  jm = mi.put_model(mjm)
  want = jax.jit(lambda s, c: jax_opt.rollout(jm, mi.make_data(jm), s, c))(
      jnp.asarray(init), jnp.asarray(control))
  m = mt.put_model(mjm, device="cpu")
  got = mt.opt.rollout(m, torch.as_tensor(init), torch.as_tensor(control))
  np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                             rtol=0, atol=1e-10)


def test_rollout_counts_auto_resets():
  """A lane that diverges is reset inside the step and reads as finite; the
  rollout's ``warning`` counts its resets as C's ``mjWARN_BADQVEL`` does,
  and the other lane's stay 0."""
  mjm = mujoco.MjModel.from_xml_string(ACTUATED)
  init = initial_states(mjm, 2, seed=8)
  nq = mjm.nq
  init[1, 1 + nq] = np.nan  # lane 1's first qvel
  m = mt.put_model(mjm, device="cpu")
  out = mt.opt.rollout(m, torch.as_tensor(init), nstep=5)
  assert bool(torch.isfinite(out.state).all())
  mjd = mujoco.MjData(mjm)
  mujoco.mj_setState(mjm, mjd, init[1], FULLPHYSICS)
  for _ in range(5):
    mujoco.mj_step(mjm, mjd)
  want = [mjd.warning[mujoco.mjtWarning.mjWARN_BADQPOS].number,
          mjd.warning[mujoco.mjtWarning.mjWARN_BADQVEL].number]
  assert want == [0, 1]
  assert out.warning.tolist() == [[0, 0], want]
