"""The PyTorch port's SITE (with and without a reference site), SLIDERCRANK
and BODY (adhesion) transmissions against C MuJoCo and the JAX package.

f64 on the CPU.  The JAX tests' three scenes (``tests/
test_transmission.py``: SLIDERCRANK, REFSITE, ADHESION, vendored by
``scripts/sensor_tail_models.py``) at three seeded lanes in one fleet:
qacc (1e-9) and actuator_length and the dense actuator_moment (1e-12)
after ``forward``, and qpos after 40 ``step``s (1e-10), against C and
against the JAX package's jitted ``forward`` and ``step``; site
transmissions with and without a reference site on a free body against
C; C's adhesion counts every contact of the body, those in the gap
without rows too; adhesion holds a sphere on the floor; a flex scene with
adhesion is refused by name.
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

# asset: (the control of every lane, the scale of the seeded qvel)
SCENES = {"transmission_slidercrank": (0.5, 0.2),
          "transmission_refsite": (0.3, 0.2),
          "transmission_adhesion": (2.0, 0.05)}
LANES, STEPS = 3, 40


def dense_moment(mjm, mjd):
  out = np.zeros((mjm.nu, mjm.nv))
  mujoco.mju_sparse2dense(out, mjd.actuator_moment, mjd.moment_rownnz,
                          mjd.moment_rowadr, mjd.moment_colind)
  return out


def lanes(mjm, ctrl, vel):
  """LANES MjData after mj_forward: qvel ``vel`` randn (seeds 0-2), the
  first lane's the JAX test's own (seed 0)."""
  out = []
  for seed in range(LANES):
    mjd = mujoco.MjData(mjm)
    mjd.qvel[:] = vel * np.random.RandomState(seed).randn(mjm.nv)
    mjd.ctrl[:] = ctrl
    mujoco.mj_forward(mjm, mjd)
    out.append(mjd)
  return out


def fleet(mp, mjds):
  return mt.from_jax_arrays(mp, {k: np.stack([getattr(x, k) for x in mjds])
                                 for k in ("qpos", "qvel", "ctrl")})


@pytest.mark.parametrize("name", list(SCENES))
def test_transmission_matches_c_and_jax(name):
  mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
  mjds = lanes(mjm, *SCENES[name])
  mp = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  d = mt.forward(mp, fleet(mp, mjds))
  mj = mi.put_model(mjm)
  dj = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                              *[mi.put_data(mj, x) for x in mjds])
  fj = jax.jit(jax.vmap(mi.forward, in_axes=(None, 0)))(mj, dj)
  close = lambda a, b, tol, what: np.testing.assert_allclose(
      a, b, rtol=0, atol=tol, err_msg=f"{name} {what}")
  for k, mjd in enumerate(mjds):
    close(d.qacc[k].numpy(), mjd.qacc, 1e-9, f"qacc lane {k} vs C")
    close(d.actuator_length[k].numpy(), mjd.actuator_length, 1e-12,
          f"actuator_length lane {k} vs C")
    close(d.actuator_moment[k].numpy(), dense_moment(mjm, mjd), 1e-12,
          f"actuator_moment lane {k} vs C")
  close(d.qacc.numpy(), np.asarray(fj.qacc), 1e-9, "qacc vs JAX")
  close(d.actuator_length.numpy(), np.asarray(fj.actuator_length), 1e-12,
        "actuator_length vs JAX")
  close(d.actuator_moment.numpy(), np.asarray(fj.actuator_moment), 1e-12,
        "actuator_moment vs JAX")
  assert float(d.actuator_moment.abs().max()) > 0.1

  step_j = jax.jit(jax.vmap(mi.step, in_axes=(None, 0)))
  for _ in range(STEPS):
    for mjd in mjds:
      mujoco.mj_step(mjm, mjd)
    d = mt.step(mp, d)
    dj = step_j(mj, dj)
  close(d.qpos.numpy(), np.stack([x.qpos for x in mjds]), 1e-10,
        f"qpos after {STEPS} steps vs C")
  close(d.qpos.numpy(), np.asarray(dj.qpos), 1e-10,
        f"qpos after {STEPS} steps vs JAX")


SITE_FREE = """
<mujoco><option timestep="0.002"/>
<worldbody>
  <body pos="0 0 1"><freejoint/>
    <geom type="box" size="0.05 0.03 0.02" mass="0.3"/>
    <site name="s" pos="0.04 0.01 0" euler="10 20 30"/>
    <body pos="0.05 0 0"><joint type="hinge" axis="0 0 1"/>
      <geom type="capsule" size="0.01" fromto="0 0 0 0.1 0 0" mass="0.1"/>
      <site name="tip" pos="0.1 0 0"/></body></body>
</worldbody>
<actuator>
  <general site="s" gear="1 0 0 0 0.5 0"/>
  <general site="tip" gear="0 0.3 1 0.2 0 0"/>
  <general site="tip" refsite="s" gear="0.4 0 0.1 0 0 1"/>
</actuator>
</mujoco>"""


def test_site_transmissions_on_a_free_body_match_c():
  """Two site transmissions without a reference site and one with (whose
  bodies share the free joint's dofs, which the moment leaves out), on
  three seeded lanes: lengths, moments (1e-12) and qacc (1e-9) against
  C."""
  mjm = mujoco.MjModel.from_xml_string(SITE_FREE)
  mjds = []
  for seed in range(LANES):
    rng = np.random.RandomState(seed)
    mjd = mujoco.MjData(mjm)
    mujoco.mj_integratePos(mjm, mjd.qpos, rng.randn(mjm.nv), 1.0)
    mjd.qvel[:] = rng.randn(mjm.nv)
    mjd.ctrl[:] = rng.randn(mjm.nu)
    mujoco.mj_forward(mjm, mjd)
    mjds.append(mjd)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, fleet(mp, mjds))
  for k, mjd in enumerate(mjds):
    np.testing.assert_allclose(d.actuator_length[k].numpy(),
                               mjd.actuator_length, rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.actuator_moment[k].numpy(),
                               dense_moment(mjm, mjd), rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.qacc[k].numpy(), mjd.qacc, rtol=0,
                               atol=1e-9)


ADHESION_GAP = """
<mujoco><option timestep="0.002"/>
<worldbody>
  <geom type="plane" size="1 1 .1" margin="0.02" gap="0.01"/>
  <body name="gripper" pos="0 0 0.1"><freejoint/>
    <geom type="sphere" size="0.1" mass="0.5" margin="0.02" gap="0.01"/></body>
  <body pos="0.3 0 0.1"><freejoint/>
    <geom type="box" size="0.05 0.05 0.05" mass="0.2"/></body>
</worldbody>
<actuator><adhesion body="gripper" ctrlrange="0 5" gain="10"/></actuator>
</mujoco>"""


@pytest.mark.parametrize("height", [0.098, 0.115, 0.145, 0.155, 0.165])
def test_adhesion_counts_every_contact_of_the_body_as_c(height):
  """A sphere and the floor, each of margin 0.02 and gap 0.01, at five
  heights: into the floor, within the margins (C 3.10 adds the two: rows
  within 0.04), in the gaps (a contact without rows up to 0.06), and out
  of reach.  C's moment averages the normal Jacobians of every contact of
  the body, rows or none; the port's matches it (1e-12).  (The JAX package
  counts a contact within the larger margin, 0.02: ROADMAP §3.)"""
  mjm = mujoco.MjModel.from_xml_string(ADHESION_GAP)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[2] = height
  mjd.qpos[3:7] = [np.cos(0.2), np.sin(0.2), 0.0, 0.0]
  mjd.ctrl[:] = 2.0
  mujoco.mj_forward(mjm, mjd)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.forward(mp, mt.put_data(mp, mjd))
  np.testing.assert_allclose(d.actuator_moment[0].numpy(),
                             dense_moment(mjm, mjd), rtol=0, atol=1e-12)
  np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, rtol=0, atol=1e-9)


def test_adhesion_holds_against_gravity():
  """With enough gain the sphere stays on the floor, on every lane
  (tests/test_transmission.py's check, on a fleet of 4 lanes)."""
  mp = mt.put_model(mt.asset_path("transmission_adhesion.npz"), device="cpu")
  d = mt.make_data(mp, 4)
  qvel = torch.zeros_like(d.qvel)
  qvel[:, 2] = torch.tensor([0.5, 0.3, 0.1, 0.0], dtype=qvel.dtype)
  d = mt.step_n(mp, d.replace(ctrl=torch.full_like(d.ctrl, 3.0), qvel=qvel),
                150)
  assert float((d.qpos[:, 2] - 0.099).abs().max()) < 0.005


def test_adhesion_with_flex_contacts_refused_by_name():
  xml = """<mujoco><worldbody>
    <flexcomp type="grid" count="3 3 1" spacing="0.1 0.1 0.1" radius="0.01"
              name="sheet" dim="2" mass="0.1"/>
    <body name="b" pos="0 0 0.3"><freejoint/><geom size="0.05"/></body>
    </worldbody><actuator><adhesion body="b" ctrlrange="0 1"/></actuator>
    </mujoco>"""
  with pytest.raises(NotImplementedError,
                     match="actuator transmission BODY with flex contacts"):
    mt.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")
