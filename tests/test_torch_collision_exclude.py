"""Contact exclusion (``<contact><exclude>``) in the PyTorch port, against
C MuJoCo, in float64 on the CPU.

C's ``exclude_signature`` holds body ids, (body1 << 16) + body2, and C
matches the bodies of a geom pair against it; the JAX package matches
weld ids.  On a body welded to its parent the two differ:

* a free body ``a`` with a child ``a2`` welded to it, and a free sphere
  ``b`` overlapping ``a2`` by 0.05: excluding ``a2``-``b`` removes the
  contact (C: none, ``b`` falls at -9.81), excluding ``a``-``b`` keeps it;
  the active contacts and ``qacc`` against C (1e-10);
* excluded bodies that each have a joint (weld id = body id) as well;
* every vendored snapshot's candidate pairs are what the weld-id rule gave
  (none of them has an exclude).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import glob
import os

import mujoco
import numpy as np
import pytest

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import DisableBit
from mujoco_inversedynamicstest_tpu_torch.ops import collision

WELDED = """
<mujoco>
  <worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body name="a" pos="0 0 1">
      <freejoint/>
      <geom type="sphere" size=".1"/>
      <body name="a2" pos=".5 0 0">
        <geom type="sphere" size=".1"/>
      </body>
    </body>
    <body name="b" pos=".5 0 1.15">
      <freejoint/>
      <geom type="sphere" size=".1"/>
    </body>
  </worldbody>
  <contact><exclude body1="{body1}" body2="b"/></contact>
</mujoco>
"""

JOINTED = """
<mujoco>
  <worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body name="a" pos="0 0 1">
      <freejoint/>
      <geom type="capsule" size=".1" fromto="0 0 0 .3 0 0"/>
      <body name="a2" pos=".5 0 0">
        <joint type="hinge" axis="0 1 0"/>
        <geom type="sphere" size=".1"/>
      </body>
    </body>
    <body name="b" pos=".5 0 1.15">
      <freejoint/>
      <geom type="sphere" size=".1"/>
    </body>
  </worldbody>
  <contact><exclude body1="{body1}" body2="b"/></contact>
</mujoco>
"""


def forward_both(xml):
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.put_data(m, mjd))
  return mjm, mjd, m, d


@pytest.mark.parametrize("model, body1, ncon", [
    ("welded", "a2", 0), ("welded", "a", 1), ("jointed", "a2", 0),
    ("jointed", "a", 1)])
def test_exclude_matches_c(model, body1, ncon):
  xml = {"welded": WELDED, "jointed": JOINTED}[model]
  mjm, mjd, m, d = forward_both(xml.format(body1=body1))
  active = d.contact.dist[0] < d.contact.includemargin[0]
  assert mjd.ncon == ncon == int(active.sum())
  np.testing.assert_allclose(
      np.sort(d.contact.dist[0][active].numpy()),
      np.sort([c.dist for c in mjd.contact[:mjd.ncon]]), rtol=0, atol=1e-10)
  np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, rtol=0, atol=1e-10)
  if ncon == 0:
    z = mjm.body_dofadr[mjm.body("b").id] + 2
    assert float(d.qacc[0, z]) == pytest.approx(-9.81, abs=1e-12)


def weld_rule_pairs(m):
  """The candidate geom pairs of the rule before the repair, exclusions by
  weld id: (g1, g2) with g1 < g2."""
  if m.opt.disableflags & (DisableBit.CONTACT | DisableBit.CONSTRAINT):
    return set()
  tri1, tri2 = np.triu_indices(m.ngeom, k=1)
  b1, b2 = m.geom_bodyid[tri1], m.geom_bodyid[tri2]
  w1, w2 = m.body_weldid[b1], m.body_weldid[b2]
  keep = (b1 != b2) & (w1 != w2)
  if len(m.exclude_signature):
    keep &= ~np.isin((w1 << 16) | w2, m.exclude_signature)
    keep &= ~np.isin((w2 << 16) | w1, m.exclude_signature)
  pw1 = m.body_weldid[m.body_parentid[w1]]
  pw2 = m.body_weldid[m.body_parentid[w2]]
  keep &= ~(((w1 == pw2) & (w1 != 0)) | ((w2 == pw1) & (w2 != 0)))
  keep &= ((m.geom_contype[tri1] & m.geom_conaffinity[tri2])
           | (m.geom_contype[tri2] & m.geom_conaffinity[tri1])) != 0
  return {(int(a), int(b)) for a, b in zip(tri1[keep], tri2[keep])}


SNAPSHOTS = sorted(os.path.basename(p)[:-4] for p in glob.glob(
    str(mt.asset_path("*.xml"))))


@pytest.mark.parametrize("name", SNAPSHOTS)
def test_snapshot_pairs_unchanged(name):
  m = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  assert len(m.exclude_signature) == 0
  lay = collision.contact_layout(m)
  pairs = {(min(a, b), max(a, b)) for grp in lay.groups
           for a, b in zip(grp.geom1.tolist(), grp.geom2.tolist())}
  assert pairs == weld_rule_pairs(m)


def test_welded_pair_differs_from_the_weld_rule():
  """The probe model is one where the two rules part: the weld-id rule
  would have dropped a2-b under body1="a" and kept it under "a2"."""
  for body1, kept in (("a2", False), ("a", True)):
    _, _, m, _ = forward_both(WELDED.format(body1=body1))
    lay = collision.contact_layout(m)
    ours = {(min(a, b), max(a, b)) for grp in lay.groups
            for a, b in zip(grp.geom1.tolist(), grp.geom2.tolist())}
    a2_b = (2, 3)
    assert (a2_b in ours) == kept
    assert (a2_b in weld_rule_pairs(m)) != kept
