"""The contact rows and the linearization of flex scenes in the PyTorch
port, in float64 on the CPU:

* the rows and the solve on the JAX package's contacts: the port's
  forward, with the JAX package's contact slots (a mesh and a cylinder on
  the sheet, found by support descent) in place of its collision's, gives
  the JAX package's qacc within 1e-9 of max|qacc|; the ellipsoid's scene,
  where every pair is within 1e-9 of the JAX package's, end to end;
* ``transition_ad`` of the cloth (elasticity) and of the box on the sheet
  (weighted contact rows) against centered ``transition_fd``, within 1e-4
  of max|A|.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import Contact
from mujoco_inversedynamicstest_tpu_torch.ops import collision
from mujoco_inversedynamicstest_tpu_torch.opt import derivative

import flex_cases as fc
from test_torch_flex_descent import _state


@pytest.mark.parametrize("label", ["sheet-mesh", "sheet-cylinder"])
def test_rows_on_jax_contacts_match_jax(label, monkeypatch):
  """The port's forward, with the JAX package's contact slots in place of
  its collision's, gives the JAX package's qacc."""
  mjm, mjd, _ = _state(label)
  m, d, dj = fc.both(mjm, mjd)
  c = dj.contact
  t = lambda x, dtype=None: torch.as_tensor(np.array(x), dtype=dtype)[None]
  theirs = Contact(
      dist=t(c.dist), pos=t(c.pos), frame=t(c.frame),
      includemargin=t(c.includemargin), friction=t(c.friction),
      solref=t(c.solref), solreffriction=t(c.solreffriction),
      solimp=t(c.solimp), geom1=t(c.geom1, torch.long),
      geom2=t(c.geom2, torch.long), bary_body=t(c.bary_body, torch.long),
      bary_w=t(c.bary_w))
  assert int((theirs.dist < theirs.includemargin).sum()) >= 1
  monkeypatch.setattr(collision, "collision",
                      lambda m, d: d.replace(contact=theirs))
  d = mt.forward(m, mt.put_data(m, mjd))
  assert fc.qacc_error(d, dj.qacc) < 1e-9


def test_ellipsoid_on_sheet_end_to_end():
  mjm, mjd, gtype = _state("sheet-ellipsoid")
  m, d, dj = fc.both(mjm, mjd)
  slots = fc.group_slots(m, "geom_elem", gtype)
  assert fc.check_contacts(d, dj, slots=slots) >= 1
  assert fc.qacc_error(d, dj.qacc) < 1e-9


@pytest.mark.parametrize("name", ["flex_cloth", "flex_sheet_box"])
def test_transition_ad_matches_fd(name):
  """``transition_ad`` (vmap over jvp of one step) through the flex terms
  and the weighted contact rows, against centered differences of the
  step; the box rests on the sheet (C's state after 300 steps)."""
  mjm = fc.scene(name)
  mjd = (fc.perturbed(mjm, 0.01, 5) if name == "flex_cloth"
         else fc.dropped(mjm, 300))
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.put_data(m, mjd))
  if name == "flex_sheet_box":
    assert int((d.contact.dist < d.contact.includemargin).sum()) >= 2
  ad = derivative.transition_ad(m, d)
  fd = derivative.transition_fd(
      m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
      eps=1e-6, flg_centered=True)
  scale = float(fd.A.abs().max())
  assert float((ad.A - fd.A).abs().max()) <= 1e-4 * scale
