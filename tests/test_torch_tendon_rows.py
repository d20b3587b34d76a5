"""The PyTorch port's tendon constraint rows: the tendon equality, tendon
friction loss and tendon limits, on ``assets/tendon_rows.xml``.

In float64, from seeded states: every static row against the JAX package
and the active rows against C's packed rows, in C's order (dof friction
then tendon friction, joint limits then tendon limits); over a fleet, the
tendon limit reached, the friction row in all three zones and the
equality always on; inverse dynamics against C ``mj_inverse``; and the
tendon sensors against C.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import mujoco
import numpy as np
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import constraint
from test_torch_actuation import fleet
from test_torch_tendon import c_model, seeded

ROWS = ("efc_J", "efc_pos", "efc_D", "efc_aref", "efc_frictionloss")


def c_rows(mjm, mjd):
  """C's dense efc_J after mj_forward."""
  if mujoco.mj_isSparse(mjm):
    out = np.zeros((mjd.nefc, mjm.nv))
    mujoco.mju_sparse2dense(out, mjd.efc_J, mjd.efc_J_rownnz,
                            mjd.efc_J_rowadr, mjd.efc_J_colind)
    return out
  return mjd.efc_J.reshape(mjd.nefc, mjm.nv).copy()


def test_rows_match_jax_and_c():
  """Four seeded lanes: every static row against the JAX package's
  (1e-10), the active rows against C's (efc_J, efc_pos 1e-10; efc_D 1e-7
  and 1e-9 relative; efc_aref 1e-9; efc_frictionloss exact)."""
  mjm = c_model("tendon_rows")
  mjds = [seeded(mjm, seed) for seed in range(4)]
  mp = mt.put_model(mjm, device="cpu")
  out = mt.fwd_velocity(mp, mt.fwd_position(mp, fleet(mp, mjds)))
  mj = mi.put_model(mjm)
  stages = jax.jit(lambda m, d: mi.fwd_velocity(m, mi.fwd_position(m, d)))
  lay = constraint.row_layout(mp)
  assert (lay.ne, lay.nf, lay.nl) == (1, 1, 2)
  for i, mjd in enumerate(mjds):
    dj = stages(mj, mi.put_data(mj, mjd))
    for f in ROWS:
      np.testing.assert_allclose(getattr(out, f)[i].numpy(),
                                 np.asarray(getattr(dj, f)), rtol=0,
                                 atol=1e-10, err_msg=f"{f} lane {i}")
    mujoco.mj_forward(mjm, mjd)
    act = np.nonzero(out.efc_active[i].numpy())[0]
    assert len(act) == mjd.nefc
    ours = lambda f: getattr(out, f)[i].numpy()[act]
    np.testing.assert_allclose(ours("efc_J"), c_rows(mjm, mjd), atol=1e-10)
    np.testing.assert_allclose(ours("efc_pos"), mjd.efc_pos, atol=1e-10)
    np.testing.assert_allclose(ours("efc_D"), mjd.efc_D, atol=1e-7,
                               rtol=1e-9)
    np.testing.assert_allclose(ours("efc_aref"), mjd.efc_aref, atol=1e-9)
    np.testing.assert_array_equal(ours("efc_frictionloss"),
                                  mjd.efc_frictionloss)


def test_every_row_kind_is_active_in_the_fleet():
  """64 seeded lanes, after forward: the tendon equality is on in every
  lane, the tendon's limit rows are active in some lanes and not in
  others, and its friction row lies in each of the three zones (the
  quadratic one between -R floss and R floss, and both linear ones) in
  some lane; qacc and efc_force against C mj_forward (1e-9, 1e-7)."""
  mjm = c_model("tendon_rows")
  mjds = [seeded(mjm, seed) for seed in range(64)]
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, fleet(mp, mjds))
  active = out.efc_active.numpy()
  assert active[:, 0].all()                     # the equality
  limit = active[:, 2:].any(1)
  assert limit.any() and not limit.all()
  jar = (torch.einsum("brv,bv->br", out.efc_J, out.qacc) - out.efc_aref)
  quad, lin_neg, lin_pos = constraint.zones(mp, out, jar)
  assert quad[:, 1].any() and lin_neg[:, 1].any() and lin_pos[:, 1].any()
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(out.qacc[i].numpy(), mjd.qacc, rtol=0,
                               atol=1e-9, err_msg=f"lane {i}")
    np.testing.assert_allclose(out.efc_force[i].numpy()[active[i]],
                               mjd.efc_force, rtol=0, atol=1e-7)


def test_inverse_matches_c():
  """inverse at a seeded qacc against C mj_inverse: qfrc_inverse and
  qfrc_constraint within 1e-8, four lanes."""
  mjm = c_model("tendon_rows")
  mjds = [seeded(mjm, seed) for seed in range(4)]
  for i, mjd in enumerate(mjds):
    mjd.qacc[:] = np.random.RandomState(50 + i).randn(mjm.nv)
  mp = mt.put_model(mjm, device="cpu")
  d = fleet(mp, mjds).replace(qacc=torch.as_tensor(
      np.stack([mjd.qacc for mjd in mjds])))
  out = mt.inverse(mp, d)
  for i, mjd in enumerate(mjds):
    mujoco.mj_inverse(mjm, mjd)
    for f in ("qfrc_inverse", "qfrc_constraint"):
      np.testing.assert_allclose(getattr(out, f)[i].numpy(), getattr(mjd, f),
                                 rtol=0, atol=1e-8, err_msg=f"{f} lane {i}")


def test_tendon_sensors_match_c():
  """The model's tendonpos and tendonvel sensors against C's sensordata,
  1e-12, four lanes."""
  mjm = c_model("tendon_rows")
  mjds = [seeded(mjm, seed) for seed in range(4)]
  mp = mt.put_model(mjm, device="cpu")
  out = mt.forward(mp, fleet(mp, mjds))
  for i, mjd in enumerate(mjds):
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(out.sensordata[i].numpy(), mjd.sensordata,
                               rtol=0, atol=1e-12)
