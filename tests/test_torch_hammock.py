"""The hammock (``assets/hammock.xml``: dm_control's humanoid over an 11 x 11
pinned flexcomp sheet, nv = 324) on the PyTorch port, float64 on the CPU,
against C MuJoCo and the JAX package.

Above n = 128 the port's Cholesky calls take the block kernels on the card
and the plain versions here, so this scene's Newton Hessian and Euler's
damped matrix (324 x 324) run the plain versions' n > 128 path end to end:

* the committed XML, snapshot and C runs (``hammock_c.npz``) are what
  ``scripts/flex_models.py`` writes, and the snapshot loads: nv 324, dof
  blocks of 27 and 3, the 300 edge-equality rows of C's reset state;
* ``forward`` at reset against C's ``mj_forward`` (qacc within 1e-8 of
  max|qacc|, vertex positions within 1e-12: the JAX package's hammock
  test's bounds);
* three steps of the contact-free scene against ``mj_step`` (qpos 1e-9);
* ``forward`` at C's state 0.3 s into the fall, the humanoid in the sheet,
  against the JAX package's jitted ``forward`` (1e-9 of max|qacc|; the
  JAX result stored, ``tests/jax_reference.py``).  C collides the flex
  otherwise there (ROADMAP §3).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import functools
import os
import sys

import jax
import mujoco
import numpy as np
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import DisableBit
from mujoco_inversedynamicstest_tpu_torch.ops import smooth

import jax_reference

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import flex_models  # noqa: E402

jax.config.update("jax_enable_x64", True)

XML = mt.asset_path("hammock.xml")
SNAPSHOT = mt.asset_path("hammock.npz")
# C's steps to the state in the sheet: 0.3 s of 0.005 s
CONTACT_STEPS = 60


@functools.lru_cache(maxsize=None)
def _port(contact: bool = True):
  """The port's model from the snapshot; without contacts, the flag set
  in the snapshot's Mapping as on the card."""
  snap = dict(np.load(SNAPSHOT))
  if not contact:
    snap["opt_disableflags"] = np.array(
        int(snap["opt_disableflags"]) | int(DisableBit.CONTACT))
  return mt.put_model(snap, device="cpu", dtype=torch.float64)


def _mjmodel(contact: bool = True):
  mjm = mujoco.MjModel.from_xml_path(str(XML))
  if not contact:
    mjm.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONTACT
  return mjm


def test_scene_is_the_scripts_and_its_snapshot_loads():
  assert XML.read_text() == flex_models.hammock_xml()
  mjm = _mjmodel()
  with np.load(SNAPSHOT) as z:
    stored = {k: z[k] for k in z.files}
  written = {**mt.models.io._snapshot_arrays(mjm),
             **mt.models.io._name_arrays(mjm)}
  assert stored.keys() == written.keys()
  for k, v in written.items():
    np.testing.assert_array_equal(stored[k], v, err_msg=k)
  # C's runs that the card holds the port to (chip_smoke.py, phase 29)
  with np.load(mt.asset_path("hammock_c.npz")) as z:
    stored = {k: z[k] for k in z.files}
  written = flex_models.hammock_c_reference(mjm)
  assert stored.keys() == written.keys()
  for k, v in written.items():
    np.testing.assert_array_equal(stored[k], v, err_msg=k)
  assert stored["rest_ncon"] > 40
  m = _port(contact=False)
  assert (m.nv, m.nu, m.flex.nvert) == (324, 21, 121)
  blocks = smooth._dof_blocks(m)
  assert {k: len(v) for k, v in blocks.items()} == {27: 1, 3: 99}
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  d = mt.forward(m, mt.make_data(m, 1))
  # C's reset state: the 300 rows of the non-pinned edges, no contact
  assert mjd.nefc == int(d.efc_active.sum()) == 300 and mjd.ncon == 0


def test_forward_at_reset_matches_c():
  mjm = _mjmodel()
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = _port()
  d = mt.forward(m, mt.make_data(m, 1))
  np.testing.assert_allclose(d.flexvert_xpos[0].numpy(), mjd.flexvert_xpos,
                             rtol=0, atol=1e-12)
  scale = max(1.0, np.abs(mjd.qacc).max())
  assert np.abs(d.qacc[0].numpy() - mjd.qacc).max() / scale <= 1e-8


def test_contact_free_steps_match_c():
  mjm = _mjmodel(contact=False)
  mjd = mujoco.MjData(mjm)
  m = _port(contact=False)
  d = mt.make_data(m, 1)
  for _ in range(3):
    mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, rtol=0, atol=1e-9)


def test_forward_in_the_sheet_matches_jax():
  mjm = _mjmodel()
  mjd = mujoco.MjData(mjm)
  for _ in range(CONTACT_STEPS):
    mujoco.mj_step(mjm, mjd)
  assert mjd.ncon > 0

  def jax_forward():
    mj = mi.put_model(mjm, dtype=jax.numpy.float64)
    dj = jax.jit(lambda x: mi.forward(mj, x))(mi.put_data(mj, mjd))
    return {"qacc": dj.qacc, "active": np.sum(
        np.asarray(dj.contact.dist) < np.asarray(dj.contact.includemargin))}

  ref = jax_reference.result(
      "forward_hammock", [jax_reference.model_bytes(mjm)] + [
          getattr(mjd, f) for f in ("qpos", "qvel", "ctrl", "act",
                                    "qacc_warmstart")], jax_forward)
  m = _port()
  d = mt.forward(m, mt.put_data(m, mjd))
  active = int((d.contact.dist < d.contact.includemargin).sum())
  assert active == int(ref["active"]) > 0
  scale = max(1.0, np.abs(ref["qacc"]).max())
  assert np.abs(d.qacc[0].numpy() - ref["qacc"]).max() / scale <= 1e-9
