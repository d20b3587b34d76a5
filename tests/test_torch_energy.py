"""The PyTorch port's energy and the sensors that read it, in float64 on the
CPU, against C MuJoCo and the JAX package:

* ``sensor.energy_pos`` and ``energy_vel`` against the JAX package's and
  against C's ``d.energy`` under the ENERGY enable flag (1e-10), on a
  model with every spring kind (hinge, slide, ball, free, a tendon outside
  its deadband) and on the vendored acrobot, cartpole and pendulum;
* ``d.energy`` after RK4 steps (the last stage's forward, as C leaves
  it); zero without the flag;
* the E_POTENTIAL, E_KINETIC and MAGNETOMETER sensors against C and the
  JAX package (1e-10);
* the JAX package accepts the flag but leaves ``energy`` at zero (ROADMAP
  §3): the port follows C.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import mujoco
import numpy as np
import pytest

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import forward as jforward
from mujoco_inversedynamicstest_tpu.ops import sensor as jsensor
from mujoco_inversedynamicstest_tpu_torch.ops import sensor

SPRINGS = """
<mujoco>
  <option timestep="0.002"><flag energy="enable"/></option>
  <worldbody>
    <site name="s0" pos="0 0 1" euler="20 -10 40"/>
    <body name="a" pos="0 0 1">
      <joint name="h" type="hinge" axis="0 1 0" stiffness="3" springref="0.2"/>
      <geom type="capsule" fromto="0 0 0 .3 0 0" size=".03"/>
      <site name="s1" pos=".1 0 0" euler="10 20 30"/>
      <body pos=".3 0 0">
        <joint name="b" type="ball" stiffness="1.5"/>
        <geom type="capsule" fromto="0 0 0 0 0 -.3" size=".03"/>
      </body>
    </body>
    <body name="c" pos="1 0 1">
      <joint name="sl" type="slide" axis="1 0 0" stiffness="5" springref="-.1"/>
      <geom type="box" size=".05 .05 .05"/>
      <site name="s2" pos="0 .05 0"/>
    </body>
    <body pos="0 1 1"><joint type="free" stiffness="2"/>
      <geom type="sphere" size=".1"/></body>
  </worldbody>
  <tendon>
    <spatial name="t" stiffness="7" springlength=".4 .5">
      <site site="s1"/><site site="s2"/>
    </spatial>
  </tendon>
  <sensor>
    <e_potential/>
    <e_kinetic/>
    <magnetometer site="s1"/>
    <magnetometer site="s2"/>
  </sensor>
</mujoco>"""


def _states(mjm, n, seed):
  """n seeded states (qpos0 moved in each dof's tangent, qvel randn), each
  an MjData after mj_forward."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    mjd = mujoco.MjData(mjm)
    mujoco.mj_integratePos(mjm, mjd.qpos, 0.4 * rng.randn(mjm.nv), 1.0)
    mjd.qvel[:] = rng.randn(mjm.nv)
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def _port_data(m, datas):
  return mt.from_jax_arrays(m, {k: np.stack([getattr(x, k) for x in datas])
                                for k in ("qpos", "qvel", "qacc_warmstart",
                                          "ctrl")})


def _model(name):
  if name == "springs":
    return mujoco.MjModel.from_xml_string(SPRINGS)
  return mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))


@pytest.mark.parametrize("name", ["springs", "acrobot", "cartpole",
                                  "pendulum"])
def test_energy_matches_c(name):
  mjm = _model(name)
  assert mjm.opt.enableflags & mujoco.mjtEnableBit.mjENBL_ENERGY
  datas = _states(mjm, 4, seed=0)
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, _port_data(m, datas))
  want = np.stack([x.energy for x in datas])
  np.testing.assert_allclose(d.energy, want, rtol=0, atol=1e-10)
  np.testing.assert_allclose(sensor.energy_pos(m, d), want[:, 0], rtol=0,
                             atol=1e-10)
  np.testing.assert_allclose(sensor.energy_vel(m, d), want[:, 1], rtol=0,
                             atol=1e-10)
  assert np.abs(want).min() > 1e-3


def test_energy_matches_jax_functions():
  """energy_pos and energy_vel against the JAX package's, on the springs
  model's states (1e-12); and the JAX forward leaves ``energy`` at zero
  under the flag, where C and the port fill it."""
  mjm = _model("springs")
  datas = _states(mjm, 3, seed=1)
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, _port_data(m, datas))
  mj = mi.put_model(mjm)
  jfwd = jax.jit(lambda dd: jforward.forward(mj, dd))
  for i, mjd in enumerate(datas):
    out = jfwd(mi.put_data(mj, mjd))
    assert float(np.abs(np.asarray(out.energy)).max()) == 0.0
    np.testing.assert_allclose(float(d.energy[i, 0]),
                               float(jsensor.energy_pos(mj, out)), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(float(d.energy[i, 1]),
                               float(jsensor.energy_vel(mj, out)), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(d.sensordata[i], np.asarray(out.sensordata),
                               rtol=0, atol=1e-10)


def test_energy_sensors_match_c():
  """E_POTENTIAL, E_KINETIC and two magnetometers (the sites' frames
  transposed times opt.magnetic), as C's mj_sensorPos writes them; the
  same without the ENERGY flag."""
  for flag in (True, False):
    mjm = _model("springs")
    if not flag:
      mjm.opt.enableflags = 0
    datas = _states(mjm, 4, seed=2)
    m = mt.put_model(mjm, device="cpu")
    d = mt.forward(m, _port_data(m, datas))
    np.testing.assert_allclose(
        d.sensordata, np.stack([x.sensordata for x in datas]), rtol=0,
        atol=1e-10)
    if not flag:
      assert float(d.energy.abs().max()) == 0.0


@pytest.mark.parametrize("name", ["acrobot", "cartpole"])
def test_energy_after_rk4_steps_matches_c(name):
  """Their own RK4: after 10 steps ``d.energy`` is the last stage's, as C
  leaves mjData, with qpos and qvel within 1e-12."""
  mjm = _model(name)
  assert mjm.opt.integrator == mujoco.mjtIntegrator.mjINT_RK4
  datas = _states(mjm, 3, seed=3)
  m = mt.put_model(mjm, device="cpu")
  d = _port_data(m, datas)
  for _ in range(10):
    for mjd in datas:
      mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  np.testing.assert_allclose(d.qpos, np.stack([x.qpos for x in datas]),
                             rtol=0, atol=1e-12)
  np.testing.assert_allclose(d.energy, np.stack([x.energy for x in datas]),
                             rtol=0, atol=1e-10)
