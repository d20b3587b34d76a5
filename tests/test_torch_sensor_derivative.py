"""The sensor Jacobians C = d sensordata / dx and D = d sensordata / du of
the port's ``transition_ad(flg_sensor=True)`` against C MuJoCo.

f64 on the CPU, dm_control's humanoid with its 34 sensors (nsensordata =
66, nx = 54, nu = 21) at two contact states: feet on the floor, and lying
face down on its arms.  C and D come out of the same ``vmap`` over ``jvp``
as A and B, with no functorch fallback; A and B are those of the model
without sensors, to the bit.  On contact states they are held to C's
``mjd_transitionFD``, not to the JAX package, whose Jacobians are wrong
there (ROADMAP queue 3).  The force, torque and touch rows read the
constraint forces, whose tangent ``ops/solver.py::_newton_tangent`` sets.
"""

import dataclasses
import warnings

import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import solver
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

INPUTS = ("qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied", "qacc",
          "qacc_warmstart", "time")
EPS = 1e-6
# of max|C| and max|D|: tests/test_torch_opt.py::
# test_humanoid_transition_matches_c's 1e-6 on entries up to 2e2
TOL = 1e-6
# rows of sensordata that read the constraint forces: force, torque, touch
FORCE_ROWS = np.r_[12:66]


def _states(name="humanoid_sensors"):
  """The two contact states (C's MjData after mj_forward) and the model."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  out = []
  for seed, (dz, lying) in enumerate(((-0.24, False), (-1.34, True))):
    mjd = mujoco.MjData(mjm)
    rng = np.random.RandomState(seed + 3)
    mjd.qpos[:] = mjm.qpos0
    mjd.qpos[2] += dz
    if lying:
      mjd.qpos[3:7] = [np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0]
    mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
    mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
    mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return mjm, out


def _port(mjm, mjds):
  mp = mt.put_model(mjm, device="cpu")
  d = mt.from_jax_arrays(mp, {
      k: np.stack([np.atleast_1d(np.array(getattr(x, k))) for x in mjds])
      for k in INPUTS})
  return mp, mt.forward(mp, d)


def _c_jacobians(mjm, mjd, centered):
  nx, ns = 2 * mjm.nv, mjm.nsensordata
  a, b = np.zeros((nx, nx)), np.zeros((nx, mjm.nu))
  c, d = np.zeros((ns, nx)), np.zeros((ns, mjm.nu))
  mujoco.mjd_transitionFD(mjm, mjd, EPS, int(centered), a, b, c, d)
  return a, b, c, d


@pytest.fixture(scope="module")
def contact():
  """The two contact states in C and the port, with the port's
  transition_ad(flg_sensor=True), run with functorch's vmap-fallback
  warning made an error."""
  mjm, mjds = _states()
  mp, d = _port(mjm, mjds)
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      ad = derivative.transition_ad(mp, d, flg_sensor=True)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
  return mjm, mjds, mp, d, ad


def test_sensor_jacobians_match_c(contact):
  """C against C's centered differences, D against its forward ones,
  within TOL of max|C| and max|D|, every row.  C's centered D (3.10.0) is
  the negative of its forward D (a C fault: ROADMAP queue 3), asserted
  here; the port follows the forward one, as a one-actuator model's
  actuatorfrc row (D = +1) shows."""
  mjm, mjds, mp, d, ad = contact
  nx = 2 * mjm.nv
  assert ad.C.shape == (2, 66, nx) and ad.D.shape == (2, 66, mjm.nu)
  touch = (d.sensordata[:, 48:] > 0).sum(1)
  assert (touch >= 2).all() and ((d.contact.dist < d.contact.includemargin
                                  ).sum(1) >= 4).all()
  for lane, mjd in enumerate(mjds):
    a_c, b_c, c_c, d_c = _c_jacobians(mjm, mjd, centered=True)
    _, _, _, d_f = _c_jacobians(mjm, mjd, centered=False)
    np.testing.assert_allclose(ad.A[lane].numpy(), a_c, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ad.B[lane].numpy(), b_c, rtol=0, atol=1e-6)
    tol_c, tol_d = TOL * np.abs(c_c).max(), TOL * np.abs(d_f).max()
    np.testing.assert_allclose(ad.C[lane].numpy(), c_c, rtol=0, atol=tol_c)
    np.testing.assert_allclose(ad.D[lane].numpy(), d_f, rtol=0, atol=tol_d)
    np.testing.assert_allclose(d_c, -d_f, rtol=0, atol=tol_d)
    assert np.abs(ad.C[lane].numpy()[FORCE_ROWS]).max() > 1e2

  one = mujoco.MjModel.from_xml_string("""
  <mujoco><worldbody><body><joint name="j" type="hinge"/>
  <geom size=".1" mass="1"/></body></worldbody>
  <actuator><motor name="a" joint="j" gear="2"/></actuator>
  <sensor><actuatorfrc actuator="a"/></sensor></mujoco>""")
  od = mujoco.MjData(one)
  od.ctrl[:] = 0.3
  mujoco.mj_forward(one, od)
  _, _, _, d_cen = _c_jacobians(one, od, centered=True)
  _, _, _, d_fwd = _c_jacobians(one, od, centered=False)
  mo, do = _port(one, [od])
  tr = derivative.transition_ad(mo, do, flg_sensor=True)
  np.testing.assert_allclose(d_fwd, [[1.0]], atol=1e-6)
  np.testing.assert_allclose(d_cen, [[-1.0]], atol=1e-6)
  np.testing.assert_allclose(tr.D[0].numpy(), [[1.0]], rtol=0, atol=1e-12)


def test_a_b_are_those_without_sensors(contact):
  """The same pass gives A and B: equal to the bit to transition_ad without
  sensors, and to the humanoid without its <sensor> block."""
  mjm, mjds, mp, d, ad = contact
  plain = derivative.transition_ad(mp, d)
  assert plain.C is None and plain.D is None
  assert torch.equal(ad.A, plain.A) and torch.equal(ad.B, plain.B)
  mp0, d0 = _port(*_states("humanoid"))
  bare = derivative.transition_ad(mp0, d0)
  assert torch.equal(ad.A, bare.A) and torch.equal(ad.B, bare.B)


def test_transition_fd_sensors_match_ad(contact):
  """The port's transition_fd(flg_sensor=True), centered, eps 1e-6, from
  qacc_warmstart = 0 (C's after mj_forward), against transition_ad (which
  does not depend on the warm start): within TOL of max|C| and max|D|.
  From the forward's converged warm start a perturbed solve stops after
  one iteration, short of the perturbed minimum by up to the solver's
  tolerance, and 2 eps turns that into up to 3e-4 of max|C| in the force
  rows; from zero it iterates to the minimum, as C's does."""
  mjm, mjds, mp, d, ad = contact
  cold = d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart))
  fd = derivative.transition_fd(mp, cold, eps=EPS, flg_centered=True,
                                flg_sensor=True)
  for x, y in ((ad.C, fd.C), (ad.D, fd.D)):
    np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                               atol=TOL * float(y.abs().max()))


def test_constraint_force_tangent_reaches_the_sensors(contact, monkeypatch):
  """Without _newton_tangent's tangent of efc_force (the solver's own
  iterate tangent kept, qacc's still set), A stays C's and the force,
  torque and touch rows of C fall far from C's differences: their
  tangent is the one _newton_tangent gives."""
  mjm, mjds, mp, d, _ = contact
  keep = solver._newton_tangent

  def qacc_only(m, dd, st, met):
    return dataclasses.replace(keep(m, dd, st, met), efc_force=st.efc_force)

  monkeypatch.setattr(solver, "_newton_tangent", qacc_only)
  tr = derivative.transition_ad(mp, d, flg_sensor=True)
  a_c, _, c_c, _ = _c_jacobians(mjm, mjds[0], centered=True)
  np.testing.assert_allclose(tr.A[0].numpy(), a_c, rtol=0, atol=1e-6)
  err = np.abs(tr.C[0].numpy() - c_c)
  assert err[FORCE_ROWS].max() > 1e3 * TOL * np.abs(c_c).max()
  other = np.setdiff1d(np.arange(66), FORCE_ROWS)
  assert err[other].max() <= TOL * np.abs(c_c).max()
