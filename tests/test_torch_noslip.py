"""The PyTorch port's noslip pass, in float64 on the CPU, against C MuJoCo
and the JAX package:

* ``tests/test_elliptic.py``'s noslip scenes: a sphere and a condim-6
  capsule on the floor under both cones (forward within 1e-9 of C and of
  the JAX package, 30 steps within 1e-10 of C), and dry friction on a
  slide joint pushed by a motor (1e-10); the noslip sweeps add to
  ``solver_niter`` as C's do;
* noslip after PGS and after CG, against C (1e-5 of max|qacc|: C solves
  each island on its own, to its tolerance);
* the QCQP of an elliptic unit against the JAX package's ``_qcqp``
  (1e-12), its result inside the friction ellipse;
* ``transition_ad`` with the noslip pass (the tangent of its sweeps)
  against ``transition_fd``.
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
from mujoco_inversedynamicstest_tpu.ops import noslip as jnoslip
from mujoco_inversedynamicstest_tpu_torch.ops import noslip
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

SCENE = """
  <mujoco>
    <option cone="{cone}" timestep="0.002" noslip_iterations="5" {extra}/>
    <worldbody>
      <geom type="plane" size="2 2 .1"/>
      <body pos="0 0 0.099"><freejoint/>
        <geom type="sphere" size="0.1" mass="1" friction="0.6"/></body>
      <body pos="0.3 0 0.097" euler="0 90 0"><freejoint/>
        <geom type="capsule" size="0.05 0.1" mass="0.4" condim="6"/></body>
    </worldbody>
  </mujoco>"""
DRY = """
  <mujoco>
    <option noslip_iterations="10"/>
    <worldbody>
      <body pos="0 0 1">
        <joint name="s" type="slide" axis="1 0 0" frictionloss="2.5"/>
        <geom type="box" size=".1 .1 .1" mass="1"/>
      </body>
    </worldbody>
    <actuator><motor joint="s"/></actuator>
  </mujoco>"""


def _state(mjm, vel, seed=0):
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = vel * np.random.RandomState(seed).randn(mjm.nv)
  return mjd


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_noslip_matches_c_and_jax(cone):
  mjm = mujoco.MjModel.from_xml_string(SCENE.format(cone=cone, extra=""))
  mjd = _state(mjm, 0.5)
  m = mt.put_model(mjm, device="cpu")
  d = mt.put_data(m, mjd)
  mj = mi.put_model(mjm)
  ref = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  mujoco.mj_forward(mjm, mjd)
  out = mt.forward(m, d)
  assert mjd.ncon >= 1
  np.testing.assert_allclose(out.qacc[0], mjd.qacc, rtol=0, atol=1e-9)
  np.testing.assert_allclose(out.qfrc_constraint[0], mjd.qfrc_constraint,
                             rtol=0, atol=1e-9)
  np.testing.assert_allclose(out.qacc[0], np.asarray(ref.qacc), rtol=0,
                             atol=1e-9)
  for _ in range(30):
    mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  np.testing.assert_allclose(d.qpos[0], mjd.qpos, rtol=0, atol=1e-10)


def test_noslip_dry_friction_matches_c():
  """The dry-friction sweep: the motor's push held by friction loss
  (1e-10); Newton's iteration and the noslip sweeps counted together in
  solver_niter, as C counts them."""
  mjm = mujoco.MjModel.from_xml_string(DRY)
  mjd = mujoco.MjData(mjm)
  mjd.ctrl[:] = 1.0
  m = mt.put_model(mjm, device="cpu")
  d = mt.put_data(m, mjd)
  mujoco.mj_forward(mjm, mjd)
  out = mt.forward(m, d)
  np.testing.assert_allclose(out.qacc[0], mjd.qacc, rtol=0, atol=1e-10)
  assert int(out.solver_niter[0]) == mjd.solver_niter[0] > 1


@pytest.mark.parametrize("solver, extra", [
    ("PGS", 'solver="PGS" iterations="500" tolerance="1e-12"'),
    ("CG", 'solver="CG" iterations="200"'),
])
@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_noslip_after_pgs_and_cg_matches_c(cone, solver, extra):
  """Within 1e-5 of C's max|qacc|: the main solves end within their
  tolerances of C's (which solves each of the scene's two islands on its
  own), and noslip's 5 sweeps carry that difference."""
  mjm = mujoco.MjModel.from_xml_string(SCENE.format(cone=cone, extra=extra))
  for seed in (0, 1):
    mjd = _state(mjm, 0.5, seed)
    m = mt.put_model(mjm, device="cpu")
    d = mt.put_data(m, mjd)
    mujoco.mj_forward(mjm, mjd)
    out = mt.forward(m, d)
    np.testing.assert_allclose(out.qacc[0], mjd.qacc, rtol=0,
                               atol=1e-5 * np.abs(mjd.qacc).max())


def test_qcqp_matches_jax():
  """Elliptic friction blocks of widths 2 to 5 (condim 3, 4 and 6), seeded
  SPD matrices, radii with the constraint inactive, active, and a zero
  radius: the port's batched QCQP against the JAX package's ``_qcqp``
  lane by lane (1e-12), each result inside its ellipse."""
  rng = np.random.RandomState(0)
  for n in (2, 3, 5):
    g = rng.randn(6, n, n)
    a = g @ np.swapaxes(g, 1, 2) + 0.1 * np.eye(n)
    b = 3.0 * rng.randn(6, n)
    mu = rng.uniform(0.3, 1.5, (6, n))
    r = np.array([100.0, 0.5, 0.1, 1.0, 0.0, 2.0])
    ours = noslip.qcqp(*(torch.as_tensor(x) for x in (a, b, mu, r))).numpy()
    for i in range(6):
      pad = np.eye(5)
      pad[:n, :n] = a[i]
      ref = jnoslip._qcqp(jnp.asarray(pad), jnp.asarray(np.r_[b[i], np.zeros(
          5 - n)]), jnp.asarray(np.r_[mu[i], np.ones(5 - n)]), r[i], n)
      np.testing.assert_allclose(ours[i], np.asarray(ref)[:n], rtol=0,
                                 atol=1e-12)
      assert np.sum((ours[i] / mu[i]) ** 2) <= r[i] ** 2 * (1 + 1e-9)


def _snapshot_model(name, **opts):
  with np.load(mt.asset_path(f"{name}.npz")) as z:
    snap = {k: z[k] for k in z.files}
  snap.update({k: np.array(v) for k, v in opts.items()})
  return mt.put_model(snap, device="cpu")


@pytest.mark.parametrize("name", ["elliptic_pairs", "box_stack"])
def test_noslip_transition_ad_matches_fd(name):
  """transition_ad with 4 noslip sweeps (the dm_control dog's count) from
  seeded states at rest in contact: the sweeps' own tangent, within 1e-4
  of max|A| of centered differences (eps 1e-6) of the same map."""
  m = _snapshot_model(name, opt_noslip_iterations=4)
  rng = np.random.RandomState(0)
  d = mt.make_data(m, 3)
  d = mt.forward(m, d.replace(
      qpos=mt.integrate_pos(m, d.qpos, torch.as_tensor(
          0.005 * rng.randn(3, m.nv)), 1.0),
      qvel=torch.as_tensor(0.05 * rng.randn(3, m.nv))))
  ad = derivative.transition_ad(m, d)
  fd = derivative.transition_fd(m, d, eps=1e-6, flg_centered=True)
  scale = float(fd.A.abs().max())
  assert float((ad.A - fd.A).abs().max()) <= 1e-4 * scale
