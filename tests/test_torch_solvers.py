"""The PyTorch port's CG and PGS solvers, in float64 on the CPU, against C
MuJoCo and the JAX package:

* CG (``mj_solCG``: Polak-Ribière on the M-preconditioned gradient, the
  exact line search) on ``tests/test_constraint.py``'s constrained scenes
  and on the Newton-100 humanoid in contact: qacc and qfrc_constraint
  within 5e-6 of C (``test_forward_constrained``'s), C's iteration count,
  and its per-iteration improvement and gradient (C scales them by the
  mean of diag(M) at the state, the port by stat.meaninertia, as the JAX
  package); against the JAX
  package's CG on two of the scenes (5e-6);
* PGS (``mj_solPGS``) on ``tests/test_pgs.py``'s scene, both cones: run to
  convergence, within 5e-5 of C's max|qacc| (that file's tolerance), and
  against the JAX package's sweeps at a fixed count from the JAX
  package's start (1e-9);
* an elliptic contact whose forces are zero at the optimum: PGS from C's
  start (the warm start's forces, or zero where their dual cost is
  positive) reaches it as C does; the JAX package's start (the forces at
  qacc_smooth) stalls its ray update short of it (ROADMAP §3);
* ``transition_ad`` under CG and PGS: both solvers end at Newton's
  optimum, so the Newton step's tangent applies; held to Newton's
  ``transition_ad`` and to ``transition_fd``, PGS also at the model's own
  sweep count, where its lanes stop at the limit.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import sys

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import constraint, math, pgs
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

sys.path.insert(0, os.path.dirname(__file__))
from models import ALL_CONSTRAINED  # noqa: E402

CG = mujoco.mjtSolver.mjSOL_CG
PGS_SCENE = """
  <mujoco>
    <option timestep="0.002" solver="PGS" iterations="60"
            tolerance="1e-12" cone="{cone}"/>
    <worldbody>
      <geom type="plane" size="2 2 .1"/>
      <body pos="0 0 0.28">
        <freejoint/>
        <geom type="box" size="0.1 0.1 0.1" mass="1" friction="0.6"/>
      </body>
      <body pos="0.5 0 0.6">
        <joint name="j0" type="hinge" axis="0 1 0" damping="0.1"
               range="-30 30" limited="true" frictionloss="0.02"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="0.4"/>
        <body pos="0.3 0 0">
          <joint name="j1" type="hinge" axis="1 0 0"/>
          <geom type="sphere" size="0.05" mass="0.2"/>
        </body>
      </body>
      <body pos="-0.4 0 0.4">
        <joint type="slide" axis="0 0 1"/>
        <geom type="sphere" size="0.08" mass="0.5" friction="0.4"/>
      </body>
    </worldbody>
    <equality>
      <joint joint1="j0" joint2="j1" polycoef="0 1 0 0 0"/>
    </equality>
  </mujoco>
  """
# tests/test_elliptic.py's noslip scene, its bodies leaving the floor
LEAVING = """
  <mujoco>
    <option cone="elliptic" timestep="0.002" solver="PGS" iterations="200"/>
    <worldbody>
      <geom type="plane" size="2 2 .1"/>
      <body pos="0 0 0.099"><freejoint/>
        <geom type="sphere" size="0.1" mass="1" friction="0.6"/></body>
      <body pos="0.3 0 0.097" euler="0 90 0"><freejoint/>
        <geom type="capsule" size="0.05 0.1" mass="0.4" condim="6"/></body>
    </worldbody>
  </mujoco>"""


def _constrained_state(mjm, seed=0):
  """``tests/test_constraint.py``'s state."""
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0 + 0.3 * rng.randn(mjm.nq)
  mujoco.mj_normalizeQuat(mjm, mjd.qpos)
  mjd.qvel[:] = 0.6 * rng.randn(mjm.nv)
  if mjm.nu:
    mjd.ctrl[:] = rng.randn(mjm.nu)
  mjd.qfrc_applied[:] = 0.1 * rng.randn(mjm.nv)
  return mjd


def _forward_both(mjm, mjd):
  """The port's forward of the state of ``mjd`` (its warm start too), and
  C's mj_forward of it."""
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  mujoco.mj_forward(mjm, mjd)
  return m, out


def _c_stats(mjd, niter):
  return np.array([[mjd.solver[i].improvement, mjd.solver[i].gradient]
                   for i in range(niter)])


@pytest.mark.parametrize("name", sorted(ALL_CONSTRAINED))
def test_cg_constrained_matches_c(name):
  mjm = mujoco.MjModel.from_xml_string(ALL_CONSTRAINED[name])
  mjm.opt.solver = CG
  mjd = _constrained_state(mjm)
  m, out = _forward_both(mjm, mjd)
  np.testing.assert_allclose(out.qacc[0], mjd.qacc, rtol=0, atol=5e-6)
  np.testing.assert_allclose(out.qfrc_constraint[0], mjd.qfrc_constraint,
                             rtol=0, atol=5e-6)
  niter = int(out.solver_niter[0])
  assert niter == mjd.solver_niter[0]
  # C 3.10 scales its trace by the island's mean of diag(M) at the state,
  # the port (as the JAX package) by stat.meaninertia: the same trace once
  # rescaled, where it is above the converged solve's round-off (1e-4);
  # both end below the tolerance
  full = np.zeros((mjm.nv, mjm.nv))
  mujoco.mj_fullM(mjm, mjd, full)
  ours = out.solver_stat[0, :niter, :2].numpy() * (
      mjm.stat.meaninertia / np.diag(full).mean())
  theirs = _c_stats(mjd, niter)
  live = theirs > 1e-4
  np.testing.assert_allclose(ours[live], theirs[live], rtol=1e-6)
  assert ours[-1].min() < mjm.opt.tolerance
  assert theirs[-1].min() < mjm.opt.tolerance


@pytest.mark.parametrize("name", ["limited", "slider_crank"])
def test_cg_constrained_matches_jax(name):
  mjm = mujoco.MjModel.from_xml_string(ALL_CONSTRAINED[name])
  mjm.opt.solver = CG
  mjd = _constrained_state(mjm)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  mj = mi.put_model(mjm)
  ref = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  np.testing.assert_allclose(out.qacc[0], np.asarray(ref.qacc), rtol=0,
                             atol=5e-6)


def _humanoid_state(mjm, seed):
  """``tests/test_torch_elliptic.py``'s humanoid state: feet on the
  floor, random joint angles, velocities, controls and applied forces."""
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[2] -= 0.22
  mjd.qpos[7:] += 0.08 * rng.randn(mjm.nq - 7)
  mjd.qvel[:] = 0.1 * rng.randn(mjm.nv)
  mjd.ctrl[:] = 0.2 * rng.randn(mjm.nu)
  mjd.qfrc_applied[:] = 0.3 * rng.randn(mjm.nv)
  mjd.xfrc_applied[:] = 0.3 * rng.randn(mjm.nbody, 6)
  return mjd


@pytest.mark.parametrize("seed", [0, 3])
def test_cg_humanoid_matches_c(seed):
  """The Newton-100 humanoid in contact under CG: qacc within 5e-6 of C,
  C's iteration count (CG takes many more than Newton here)."""
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path("humanoid.xml")))
  mjm.opt.solver = CG
  mjd = _humanoid_state(mjm, seed)
  m, out = _forward_both(mjm, mjd)
  assert mjd.ncon > 0 and mjd.solver_niter[0] > 5
  np.testing.assert_allclose(out.qacc[0], mjd.qacc, rtol=0, atol=5e-6)
  assert int(out.solver_niter[0]) == mjd.solver_niter[0]


def _pgs_states(mjm, n):
  """``tests/test_pgs.py``'s states: 200 steps from the reset into contact,
  then 0.1 randn added to qvel; each an MjData before mj_forward."""
  rng = np.random.RandomState(0)
  out = []
  for _ in range(n):
    mjd = mujoco.MjData(mjm)
    for _ in range(200):
      mujoco.mj_step(mjm, mjd)
    mjd.qvel[:] += 0.1 * rng.randn(mjm.nv)
    out.append(mjd)
  return out


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_pgs_converged_matches_c(cone):
  mjm = mujoco.MjModel.from_xml_string(PGS_SCENE.format(cone=cone).replace(
      'iterations="60"', 'iterations="500"'))
  for trial, mjd in enumerate(_pgs_states(mjm, 2)):
    m, out = _forward_both(mjm, mjd)
    scale = max(1.0, np.abs(mjd.qacc).max())
    err = np.abs(out.qacc[0].numpy() - mjd.qacc).max() / scale
    assert err < 5e-5, f"{cone} trial {trial}: qacc err {err}"
    niter = int(out.solver_niter[0])
    assert 1 <= niter < 500
    # the trace keeps the first 32 sweeps' improvements
    stats = out.solver_stat[0, :min(niter, 32), 0]
    assert bool(torch.isfinite(stats).all()) and float(stats[0]) > 0


def _jax_start(m, d, ar, b):
  """The JAX package's start of the sweeps: the forces at qacc_warmstart
  or at qacc_smooth, whichever has the lower constraint cost."""
  jar = lambda qacc: math.matvec(d.efc_J, qacc) - d.efc_aref
  fw, cw, _ = constraint.forces_cost(m, d, jar(d.qacc_warmstart))
  fs, cs, _ = constraint.forces_cost(m, d, jar(d.qacc_smooth))
  return torch.where((cw < cs)[:, None], fw, fs)


@pytest.mark.parametrize("cone", ["pyramidal", "elliptic"])
def test_pgs_sweeps_match_jax(cone, monkeypatch):
  """8 sweeps (of 60) from the JAX package's start: the same forces and
  qacc (1e-9), the same improvement in each sweep."""
  mjm = mujoco.MjModel.from_xml_string(PGS_SCENE.format(cone=cone).replace(
      'iterations="60"', 'iterations="8"'))
  mjd = _pgs_states(mjm, 1)[0]
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  monkeypatch.setattr(pgs, "initial_force", _jax_start)
  out = mt.forward(m, mt.put_data(m, mjd))
  mj = mi.put_model(mjm)
  ref = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  assert int(out.solver_niter[0]) == int(ref.solver_niter) == 8
  np.testing.assert_allclose(out.qacc[0], np.asarray(ref.qacc), rtol=0,
                             atol=1e-9)
  np.testing.assert_allclose(out.efc_force[0], np.asarray(ref.efc_force),
                             rtol=0, atol=1e-9)
  np.testing.assert_allclose(out.solver_stat[0, :8, 0],
                             np.asarray(ref.solver_stat)[:8, 0], rtol=1e-9,
                             atol=1e-12)


def test_pgs_leaving_contact_reaches_c():
  """Bodies leaving the floor: C's forces are zero.  From C's start PGS
  reaches them; from the JAX package's start its ray update stalls with
  a normal force of about 11 (the JAX package's own result too)."""
  mjm = mujoco.MjModel.from_xml_string(LEAVING)
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = 0.5 * np.random.RandomState(0).randn(mjm.nv)
  m, out = _forward_both(mjm, mjd)
  assert np.abs(mjd.efc_force).max() == 0.0
  np.testing.assert_allclose(out.qacc[0], mjd.qacc, rtol=0, atol=1e-9)
  assert float(out.efc_force.abs().max()) == 0.0
  mj = mi.put_model(mjm)
  mjd_in = mujoco.MjData(mjm)
  mjd_in.qvel[:] = mjd.qvel
  ref = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd_in))
  assert np.abs(np.asarray(ref.efc_force)).max() > 1.0


def _state_fleet(m, seed, lanes=3):
  rng = np.random.RandomState(seed)
  d = mt.make_data(m, lanes)
  d = d.replace(qpos=mt.integrate_pos(m, d.qpos, torch.as_tensor(
      0.005 * rng.randn(lanes, m.nv)), 1.0),
                qvel=torch.as_tensor(0.05 * rng.randn(lanes, m.nv)))
  return mt.forward(m, d)


def _snapshot_model(name, **opts):
  with np.load(mt.asset_path(f"{name}.npz")) as z:
    snap = {k: z[k] for k in z.files}
  snap.update({k: np.array(v) for k, v in opts.items()})
  return mt.put_model(snap, device="cpu")


@pytest.mark.parametrize("name, opts", [
    ("box_stack", {"opt_solver": 1, "opt_iterations": 3000,
                   "opt_tolerance": 1e-12}),
    ("box_stack", {"opt_solver": 0, "opt_iterations": 2000,
                   "opt_tolerance": 1e-14}),
], ids=["cg-box_stack", "pgs-box_stack"])
def test_transition_ad_reaches_newtons(name, opts):
  """transition_ad under CG and PGS from their converged solves: Newton's
  transition_ad on the same states within 1e-6 of max|A|, and Newton's
  transition_fd (centered, eps 1e-6) within 1e-4 of it.  (Their own
  finite differences are not a reference: each perturbed CG or PGS solve
  stops at its tolerance, whose noise over 2 eps swamps A.  Under the
  elliptic cone CG stalls about 5e-5 short of Newton's qacc on
  elliptic_pairs, and its tangent is that far from Newton's, 1.5e-3 of
  max|A|: ``test_cg_elliptic_tangent_follows_its_stall``.)"""
  m = _snapshot_model(name, **opts)
  newton = _snapshot_model(name)
  d = _state_fleet(m, seed=0)
  dn = mt.forward(newton, d.replace(qacc_warmstart=d.qacc))
  np.testing.assert_allclose(d.qacc, dn.qacc, rtol=0,
                             atol=1e-6 * float(dn.qacc.abs().max()))
  ad = derivative.transition_ad(m, d)
  ref = derivative.transition_ad(newton, dn)
  fd = derivative.transition_fd(newton, dn, eps=1e-6, flg_centered=True)
  scale = float(ref.A.abs().max())
  assert float((ad.A - ref.A).abs().max()) <= 1e-6 * scale
  assert float((ad.A - fd.A).abs().max()) <= 1e-4 * scale


def test_pgs_transition_ad_on_capped_lanes():
  """PGS at box_stack's own 100 sweeps and tolerance 1e-8: the stack's
  lanes reach the sweep limit, about 5e-4 of max|qacc| short of Newton's
  optimum.  Their sweeps carry no tangent, so each lane takes the Newton
  step's from where they stopped: Newton's transition_ad on the same
  states within 1e-6 of max|A|, and Newton's transition_fd (centered,
  eps 1e-6) within 1e-4.  (Keeping the capped lanes' own tangent, none,
  left A a whole max|A| off.)"""
  m = _snapshot_model("box_stack", opt_solver=0)
  assert (m.opt.iterations, m.opt.tolerance) == (100, 1e-8)
  newton = _snapshot_model("box_stack")
  d = _state_fleet(m, seed=0)
  # transition_ad steps from d's warm start: lanes capped there too
  assert int((mt.forward(m, d).solver_niter == 100).sum()) >= 2
  dn = mt.forward(newton, d.replace(qacc_warmstart=d.qacc))
  gap = float((d.qacc - dn.qacc).abs().max())
  assert 1e-5 < gap / float(dn.qacc.abs().max()) < 1e-2
  ad = derivative.transition_ad(m, d)
  ref = derivative.transition_ad(newton, dn)
  fd = derivative.transition_fd(newton, dn, eps=1e-6, flg_centered=True)
  scale = float(ref.A.abs().max())
  assert float((ad.A - ref.A).abs().max()) <= 1e-6 * scale
  assert float((ad.A - fd.A).abs().max()) <= 1e-4 * scale


def test_cg_elliptic_tangent_follows_its_stall():
  """Under the elliptic cone CG's improvement test stops it short of the
  optimum on elliptic_pairs (qacc 1e-5 to 1e-4 from Newton's), and the
  Newton step's tangent at its end is as far from Newton's: printed, and
  held within 1e-2 of max|A| (Newton's own is held to 1e-4 of
  transition_fd in tests/test_torch_elliptic.py)."""
  m = _snapshot_model("elliptic_pairs", opt_solver=1, opt_iterations=1000,
                      opt_tolerance=1e-12)
  newton = _snapshot_model("elliptic_pairs")
  d = _state_fleet(m, seed=0)
  dn = mt.forward(newton, d.replace(qacc_warmstart=d.qacc))
  qerr = float((d.qacc - dn.qacc).abs().max())
  ad = derivative.transition_ad(m, d)
  ref = derivative.transition_ad(newton, dn)
  scale = float(ref.A.abs().max())
  err = float((ad.A - ref.A).abs().max())
  print(f"elliptic CG: qacc {qerr:.3e} from Newton's, A {err / scale:.3e} "
        "of max|A| from Newton's transition_ad")
  assert 0 < qerr < 1e-4 and err <= 1e-2 * scale
