"""The PyTorch port's contact budget (MJX's ``max_geom_pairs`` and
``max_contact_points`` numerics), in float64 on the CPU, on the vendored
``sphere_budget`` model (``tests/test_budget.py``'s 20 free spheres):

* the slots: 12 a lane against the 210 of the same scene without the
  numerics; ``forward``'s qacc against C's (1e-9) and the JAX package's,
  with C's count of active contacts;
* 100 steps with caps above the contact count equal to the unbudgeted
  scene's (1e-12);
* a lane's slots are its own: lanes in other states keep other pairs, and
  each lane's forward is the lane's alone;
* the lane-data consumers (the rows, ``contact_forces_frame``, touch,
  ``cfrc_ext``) against the unbudgeted scene's static slots;
* ties: two candidates at the same distance keep the lower one, whatever
  the lane count;
* capped plane-box and box-box groups (five boxes, ``max_geom_pairs`` 3,
  in a lane where the caps drop real contacts): each lane's kept pairs
  and qacc against the JAX package's budget (1e-9), in one lane chunk and
  in one chunk a lane (``CONVEX_CHUNK_BYTES`` lowered), the two equal.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import functools
import re

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.ops import collision

XML = mt.asset_path("sphere_budget.xml").read_text()


def unbudgeted(xml=XML):
  return re.sub(r"<custom>.*?</custom>", "", xml, flags=re.S)


def with_touch(xml):
  """A touch sensor on the first sphere (it rests on the plane)."""
  return xml.replace(
      '<geom type="sphere" size="0.1" mass="0.3"/></body>',
      '<geom type="sphere" size="0.1" mass="0.3"/>'
      '<site name="s0" type="sphere" size="0.101"/></body>', 1).replace(
          "</worldbody>", "</worldbody><sensor><touch site=\"s0\"/>"
          "</sensor>")


def test_snapshot_and_slot_counts():
  mjm = mujoco.MjModel.from_xml_string(XML)
  m = mt.put_model(mt.asset_path("sphere_budget.npz"), device="cpu")
  fresh = mt.put_model(mjm, device="cpu")
  for field in fresh.__dataclass_fields__:
    a, b = getattr(fresh, field), getattr(m, field)
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), field
  assert (m.max_contact_points, m.max_geom_pairs) == (12, 24)
  lay = collision.contact_layout(m)
  lay_un = collision.contact_layout(
      mt.put_model(mujoco.MjModel.from_xml_string(unbudgeted()),
                   device="cpu"))
  assert lay.lane_slots and not lay_un.lane_slots
  assert lay.ncon == 12 < lay.ncon_full == 44 < lay_un.ncon == 210
  assert [g.npair_run for g in lay.groups] == [20, 24]


def test_forward_matches_c_and_jax():
  mjm = mujoco.MjModel.from_xml_string(XML)
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  m = mt.put_model(mjm, device="cpu")
  out = mt.forward(m, mt.put_data(m, mjd))
  assert out.contact.dist.shape == (1, 12)
  np.testing.assert_allclose(out.qacc[0].numpy(), mjd.qacc, rtol=0,
                             atol=1e-9)
  assert int((out.contact.dist < out.contact.includemargin).sum()) == (
      mjd.ncon)
  mj = mi.put_model(mjm)
  outj = jax.jit(mi.forward)(mj, mi.put_data(mj, mjd))
  np.testing.assert_allclose(out.qacc[0].numpy(), np.asarray(outj.qacc),
                             rtol=0, atol=1e-9)


def test_trajectory_matches_unbudgeted():
  """With caps above the contact count, 100 steps of 3 lanes are the
  unbudgeted scene's."""
  m_c = mt.put_model(mujoco.MjModel.from_xml_string(XML), device="cpu")
  m_u = mt.put_model(mujoco.MjModel.from_xml_string(unbudgeted()),
                     device="cpu")
  d_c, d_u = mt.make_data(m_c, 3), mt.make_data(m_u, 3)
  d_c = d_c.replace(qvel=torch.as_tensor(
      0.1 * np.random.RandomState(1).randn(3, m_c.nv)))
  d_u = d_u.replace(qvel=d_c.qvel.clone())
  for _ in range(100):
    d_c, d_u = mt.step(m_c, d_c), mt.step(m_u, d_u)
  np.testing.assert_allclose(d_c.qpos.numpy(), d_u.qpos.numpy(), rtol=0,
                             atol=1e-12)


def test_lanes_keep_their_own_pairs():
  """Two lanes in different poses select different sphere pairs, and each
  lane's qacc is what the lane gets alone, and C's."""
  mjm = mujoco.MjModel.from_xml_string(XML)
  m = mt.put_model(mjm, device="cpu")
  rng = np.random.RandomState(3)
  qpos = np.stack([mjm.qpos0, mjm.qpos0])
  # lane 1: the falling spheres dropped onto the resting ones' row
  qpos[1].reshape(20, 7)[:, 2] = np.where(np.arange(20) % 3 == 0, 0.099,
                                          0.25)
  qpos[1].reshape(20, 7)[:, 0] += 0.02 * rng.randn(20)
  d = mt.from_jax_arrays(m, {"qpos": qpos})
  out = mt.forward(m, d)
  assert not torch.equal(out.contact.geom2[0], out.contact.geom2[1])
  for lane in range(2):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = qpos[lane]
    mujoco.mj_forward(mjm, mjd)
    alone = mt.forward(m, mt.from_jax_arrays(m, {"qpos": qpos[lane][None]}))
    torch.testing.assert_close(out.qacc[lane], alone.qacc[0], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(out.qacc[lane].numpy(), mjd.qacc, rtol=0,
                               atol=1e-9)


def test_lane_consumers_match_static_slots():
  """Touch, cfrc_ext and the contact frames' forces read the lane's geoms:
  with caps above the contact count they equal the unbudgeted scene's,
  whose slots are constants (a touch sensor on a resting sphere)."""
  m_c = mt.put_model(mujoco.MjModel.from_xml_string(with_touch(XML)),
                     device="cpu")
  m_u = mt.put_model(mujoco.MjModel.from_xml_string(
      with_touch(unbudgeted())), device="cpu")
  d = mt.make_data(m_c, 2)
  d = d.replace(qvel=torch.as_tensor(
      0.2 * np.random.RandomState(4).randn(2, m_c.nv)))
  out_c = mt.forward(m_c, d)
  out_u = mt.forward(m_u, mt.make_data(m_u, 2).replace(qvel=d.qvel))
  assert (out_c.sensordata > 0).all()
  torch.testing.assert_close(out_c.sensordata, out_u.sensordata, rtol=0,
                             atol=1e-9)
  torch.testing.assert_close(out_c.cfrc_ext, out_u.cfrc_ext, rtol=0,
                             atol=1e-9)


@pytest.mark.parametrize("numeric", ["max_geom_pairs", "max_contact_points"])
@pytest.mark.parametrize("lanes", [1, 64])
def test_ties_keep_the_lower_candidate(lanes, numeric):
  """Sphere 1 exactly between spheres 0 and 2: pairs (0, 1) and (1, 2) lie
  at the same distance.  A cap of one pair, or of one slot, keeps the
  lower candidate, (0, 1), in every lane (a stable sort, as XLA's top_k)."""
  xml = f"""
  <mujoco>
    <custom><numeric name="{numeric}" data="1"/></custom>
    <worldbody>
      <body pos="-0.19 0 1"><freejoint/><geom type="sphere" size="0.1"/></body>
      <body pos="0 0 1"><freejoint/><geom type="sphere" size="0.1"/></body>
      <body pos="0.19 0 1"><freejoint/><geom type="sphere" size="0.1"/></body>
    </worldbody>
  </mujoco>"""
  m = mt.put_model(mujoco.MjModel.from_xml_string(xml), device="cpu")
  d = mt.forward(m, mt.make_data(m, lanes))
  assert collision.contact_layout(m).ncon == 1
  assert (d.contact.geom1 == 0).all() and (d.contact.geom2 == 1).all()
  assert (d.contact.dist < d.contact.includemargin).all()


BOXES = """
<mujoco>
  <custom><numeric name="max_geom_pairs" data="3"/></custom>
  <worldbody>
    <geom type="plane" size="2 2 0.1"/>
    <body pos="0 0 0.099"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="0.5 0 0.0985"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="1.05 0 0.0995"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="0.01 0 0.296"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
    <body pos="0.5 0.01 0.297"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>
  </worldbody>
</mujoco>"""


def box_lanes(mjm):
  """Lane 0: two stacks and a lone box (the caps keep every contact);
  lane 1: the five boxes in a row on the plane, each pressing its
  neighbour by its own depth, so that each cap drops real contacts."""
  qpos = np.stack([mjm.qpos0] * 2)
  row = qpos[1].reshape(5, 7)
  row[:, 0] = [0.0, 0.199, 0.3974, 0.597, 0.7958]
  row[:, 1] = 0.0
  row[:, 2] = [0.099, 0.0985, 0.0995, 0.0992, 0.0988]
  return qpos


@functools.lru_cache(maxsize=None)
def box_reference():
  """The JAX package's forward of each lane: (qacc, active geom pairs)."""
  mjm = mujoco.MjModel.from_xml_string(BOXES)
  mj = mi.put_model(mjm)
  fwd = jax.jit(mi.forward)
  out = []
  for qpos in box_lanes(mjm):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:] = qpos
    o = fwd(mj, mi.put_data(mj, mjd))
    act = np.asarray(o.contact.dist) < np.asarray(o.contact.includemargin)
    out.append((np.asarray(o.qacc), sorted(zip(
        np.asarray(o.contact.geom1)[act].tolist(),
        np.asarray(o.contact.geom2)[act].tolist()))))
  return out


@pytest.mark.parametrize("chunked", [False, True])
def test_capped_box_groups_match_jax(chunked, monkeypatch):
  """``max_geom_pairs`` below the plane-box group's size (5) and the
  box-box group's (10): each lane keeps its nearest candidates (a plane
  by its signed distance), narrowphases them with its own sizes and
  margins, and gets the JAX package's contacts and qacc."""
  mjm = mujoco.MjModel.from_xml_string(BOXES)
  m = mt.put_model(mjm, device="cpu")
  lay = collision.contact_layout(m)
  assert [(len(g.geom1), g.npair_run) for g in lay.groups] == [(5, 3),
                                                                (10, 3)]
  qpos = box_lanes(mjm)
  d = mt.from_jax_arrays(m, {"qpos": qpos})
  if chunked:
    monkeypatch.setattr(collision, "CONVEX_CHUNK_BYTES", 1)
  assert [collision._lane_chunks(m, g, 2, 8) for g in lay.groups] == (
      [1, 2] if chunked else [1, 1])
  out = mt.forward(m, d)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = qpos[1]
  mujoco.mj_forward(mjm, mjd)
  for lane, (qacc, pairs) in enumerate(box_reference()):
    con = out.contact
    act = (con.dist[lane] < con.includemargin[lane]).numpy()
    ours = sorted(zip(con.geom1[lane][act].tolist(),
                      con.geom2[lane][act].tolist()))
    assert ours == pairs
    np.testing.assert_allclose(out.qacc[lane].numpy(), qacc, rtol=0,
                               atol=1e-9)
  # lane 1 keeps 24 of C's 39 contacts: the caps dropped real ones
  assert len(pairs) == 24 < mjd.ncon
  if chunked:
    monkeypatch.undo()
    whole = mt.forward(mt.put_model(mjm, device="cpu"), d)
    torch.testing.assert_close(out.qacc, whole.qacc, rtol=0, atol=1e-12)
