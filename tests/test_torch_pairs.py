"""The PyTorch port's explicit ``<pair>``s, in float64 on the CPU.

* a scene of three pairs (one replacing a mixed pair, with its own margin,
  gap, condim 6, friction, solref and solimp; a frictionless one for a
  geom that collides with nothing by contype; a sphere-capsule one with a
  wide margin): every active contact's pair, distance, condim and
  parameters against C's ``mjContact``, and ``forward`` against C (1e-9),
  at two seeded states.  C 3.10 takes a pair's margin as its
  includemargin, with no gap subtracted, and adds two geoms' margins: the
  JAX package, which takes the larger margin less the larger gap, is not
  the reference here (ROADMAP §3);
* the margins of two geoms add up, as in C;
* the pair groups and slots against the JAX package's layout;
* ``tests/test_elliptic.py``'s ``solreffriction`` pair under the elliptic
  cone against C and the JAX package (1e-9), and under the pyramidal cone,
  where C reads no solreffriction;
* a mesh that collides only through a ``<pair>`` gets its hull.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import collision as jcollision
from mujoco_inversedynamicstest_tpu_torch.ops import collision

PAIRS = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body pos="0 0 0.1"><freejoint/>
      <geom name="a" type="sphere" size="0.1" mass="1"/></body>
    <body pos="0.25 0 0.049" euler="0 90 0"><freejoint/>
      <geom name="b" type="capsule" size="0.05 0.1" mass="0.5" contype="0"
            conaffinity="0"/></body>
    <body pos="-0.25 0 0.099"><freejoint/>
      <geom name="c" type="box" size="0.1 0.1 0.1" mass="1"/></body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="a" margin="0.01" gap="0.004" condim="6"
          friction="0.7 0.7 0.02 0.003 0.003" solref="0.03 0.9"
          solimp="0.8 0.9 0.002 0.4 3"/>
    <pair geom1="b" geom2="floor" condim="1"/>
    <pair geom1="b" geom2="a" margin="0.1"/>
  </contact>
</mujoco>
"""

SOLREFFRICTION = """
<mujoco>
  <option cone="{cone}" timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body pos="0 0 0.099"><freejoint/>
      <geom name="ball" type="sphere" size="0.1" mass="1"/>
    </body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="ball" solreffriction="0.05 1.2"
          friction="0.6 0.6 0.004 0.001 0.001"/>
  </contact>
</mujoco>"""


def _state(mjm, seed, vel):
  mjd = mujoco.MjData(mjm)
  mjd.qvel[:] = vel * np.random.RandomState(seed).randn(mjm.nv)
  mujoco.mj_forward(mjm, mjd)
  return mjd


def _forward_both(xml, seed, vel=0.3):
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = _state(mjm, seed, vel)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  mj = mi.put_model(mjm)
  outj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  return mjm, mjd, m, out, outj


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_contacts_and_forward_match_c(seed):
  mjm = mujoco.MjModel.from_xml_string(PAIRS)
  mjd = _state(mjm, seed, 0.3)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  con = out.contact
  dim = collision.contact_layout(m).dim
  ours = {}
  for i in np.nonzero((con.dist[0] < con.includemargin[0]).numpy())[0]:
    key = tuple(sorted((int(con.geom1[0, i]), int(con.geom2[0, i]))))
    ours.setdefault(key, []).append(i)
  theirs = {}
  for c in mjd.contact:
    theirs.setdefault(tuple(sorted(c.geom)), []).append(c)
  assert {k: len(v) for k, v in ours.items()} == {
      k: len(v) for k, v in theirs.items()}
  # the three pairs, and the box's mixed pair with the plane
  assert set(ours) == {(0, 1), (0, 2), (1, 2), (0, 3)}
  for key, slots in ours.items():
    for i, c in zip(slots, theirs[key]):
      assert dim[i] == c.dim
      np.testing.assert_allclose(float(con.dist[0, i]), c.dist, atol=1e-12)
      for field in ("includemargin", "friction", "solref", "solreffriction",
                    "solimp"):
        np.testing.assert_allclose(getattr(con, field)[0, i].numpy(),
                                   getattr(c, field), rtol=0, atol=1e-15,
                                   err_msg=field)
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-9)


@pytest.mark.parametrize("z", [0.105, 0.1095])
def test_geom_margins_add_up_as_in_c(z):
  """A plane (margin 0.01, gap 0.004) and a sphere (margin 0.002, gap
  0.001) 0.005 and 0.0095 apart: C's contact has includemargin 0.012 and
  is a row of the solve at either distance."""
  xml = f"""
  <mujoco>
    <worldbody>
      <geom type="plane" size="2 2 .1" margin="0.01" gap="0.004"/>
      <body pos="0 0 {z}"><freejoint/>
        <geom type="sphere" size="0.1" mass="1" margin="0.002" gap="0.001"/>
      </body>
    </worldbody>
  </mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = _state(mjm, 0, 0.1)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  assert mjd.ncon == 1 and mjd.contact[0].includemargin == pytest.approx(0.012)
  np.testing.assert_allclose(out.contact.includemargin[0].numpy(), [0.012],
                             rtol=1e-15)
  assert int(out.efc_active.sum()) == mjd.nefc
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-9)


def test_pair_layout_matches_jax():
  """The same groups, each with the JAX package's pairs in its order: the
  explicit pairs first, the mixed pair they replace gone."""
  mjm = mujoco.MjModel.from_xml_string(PAIRS)
  lay = collision.contact_layout(mt.put_model(mjm, device="cpu"))
  jlay = jcollision.contact_layout(mi.put_model(mjm))
  assert len(lay.groups) == len(jlay.groups)
  for g, jg in zip(lay.groups, jlay.groups):
    assert (int(g.types[0]), int(g.types[1]), g.condim) == (
        jg.types[0], jg.types[1], jg.condim)
    for a, b in ((g.geom1, jg.geom1), (g.geom2, jg.geom2),
                 (g.ipair, jg.ipair)):
      np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(lay.dim, jlay.dim)


@pytest.mark.parametrize("cone", ["elliptic", "pyramidal"])
def test_solreffriction_pair_matches_c_and_jax(cone):
  """Under the elliptic cone the pair's solreffriction gives the friction
  rows their damping; the pyramidal cone ignores it."""
  mjm, mjd, m, out, outj = _forward_both(
      SOLREFFRICTION.format(cone=cone), 0, vel=0.8)
  np.testing.assert_allclose(m.pair_solreffriction[0].numpy(), [0.05, 1.2])
  for ref in (mjd, outj):
    np.testing.assert_allclose(out.qacc[0].numpy(), np.asarray(ref.qacc),
                               rtol=0, atol=1e-9)
  if cone == "elliptic":
    # the friction rows' B is 2 / (dmax * 0.05), not the normal's
    # 2 / (dmax * 0.02)
    kbip = out.efc_KBIP[0, :3]
    assert float(kbip[1, 1]) == pytest.approx(float(kbip[0, 1]) * 0.4)


def test_mesh_only_in_a_pair_gets_its_hull():
  xml = """
  <mujoco>
    <asset>
      <mesh name="tet" vertex="0 0 0  0.2 0 0  0 0.2 0  0 0 0.2"/>
    </asset>
    <worldbody>
      <geom name="floor" type="plane" size="2 2 .1"/>
      <body pos="0 0 -0.001" euler="30 -20 10"><freejoint/>
        <geom name="tet" type="mesh" mesh="tet" contype="0" conaffinity="0"/>
      </body>
    </worldbody>
    <contact><pair geom1="floor" geom2="tet"/></contact>
  </mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  mjd = _state(mjm, 0, 0.0)
  m = mt.put_model(mjm, device="cpu")
  assert len(m.mesh_hull) == 1
  out = mt.forward(m, mt.put_data(m, mjd))
  assert mjd.ncon == int((out.contact.dist < out.contact.includemargin).sum())
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-8)
  assert torch.isfinite(out.qacc).all()
