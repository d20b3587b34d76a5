"""dm_control's quadruped (walk and fetch) and the escape task's terrain in
the PyTorch port, in float64 on the CPU, against C MuJoCo:

* the vendored ``quadruped.xml`` and ``quadruped_fetch.xml`` are
  ``quadruped.make_model``'s output for the walk and fetch tasks with the
  stated changes (no ``./common/`` includes, no ``material=``), and every
  snapshot (``terrain_objects.npz`` with the escape heights of
  ``scripts/terrain_objects.py``) is what ``save_model_snapshot`` writes;
* ``forward`` of 64 seeded states each (a random orientation, random joint
  angles, the body lowered onto the floor; for fetch the ball on or near
  the torso) against ``mj_forward`` with ``mjDSBL_MULTICCD``: the same
  active contacts (geom pairs, depths and points), and qacc within 1e-8
  where only closed-form pairs are active;
* ``inverse`` against ``mj_inverse`` on the same states;
* the escape task's model is refused by name: first for its rangefinders,
  then, without them, for its height field with a cylinder or an
  ellipsoid.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import sys

import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import terrain_objects  # noqa: E402

MULTICCD = int(mujoco.mjtDisableBit.mjDSBL_MULTICCD)
# kinds the port (and C) collide by a closed form; the others by descent
CLOSED = {(0, 2), (0, 3), (0, 4), (0, 5), (2, 2), (2, 3), (3, 3), (2, 5)}


def _dm_quadruped():
  from dm_control.suite import quadruped

  return quadruped


def _stripped(xml: bytes) -> str:
  """make_model's output without the ./common/ includes and the material=
  attributes, in lxml's layout (the vendored files' stated changes)."""
  from lxml import etree

  root = etree.fromstring(xml, etree.XMLParser(remove_blank_text=True))
  for inc in root.findall("include"):
    root.remove(inc)
  for el in root.iter():
    el.attrib.pop("material", None)
  return etree.tostring(root, pretty_print=True).decode()


def _body(text: str) -> str:
  """A vendored file without its header comment."""
  return text[text.index("-->") + 4:]


def test_vendored_xml_is_make_model_output():
  q = _dm_quadruped()
  walk = q.make_model(floor_size=q._DEFAULT_TIME_LIMIT * q._WALK_SPEED)
  fetch = q.make_model(walls_and_ball=True)
  for name, xml in (("quadruped", walk), ("quadruped_fetch", fetch)):
    ours = mt.asset_path(f"{name}.xml").read_text()
    assert "dm_control 1.0.43" in ours
    assert _body(ours) == _stripped(xml), name
  # the stated changes change no dynamics: the compiled models agree with
  # dm_control's own, built with its assets
  from dm_control.suite import common

  for name, xml in (("quadruped", walk), ("quadruped_fetch", fetch)):
    a = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
    b = mujoco.MjModel.from_xml_string(xml.decode(), common.ASSETS)
    for field in ("body_mass", "body_inertia", "body_pos", "geom_size",
                  "geom_type", "geom_friction", "geom_solref",
                  "geom_solimp", "geom_condim", "geom_priority",
                  "jnt_range", "dof_damping", "dof_armature",
                  "actuator_gainprm", "actuator_biasprm", "actuator_dynprm",
                  "tendon_range", "eq_data", "sensor_type"):
      np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                    err_msg=f"{name}.{field}")


def _mjmodel(name):
  if name == "terrain_objects":
    return terrain_objects.load_model()
  return mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))


@pytest.mark.parametrize("name", ["quadruped", "quadruped_fetch",
                                  "terrain_objects"])
def test_snapshot_is_current_and_loads(name, tmp_path):
  mjm = _mjmodel(name)
  fresh = tmp_path / "snap.npz"
  mt.save_model_snapshot(mjm, fresh)
  with np.load(mt.asset_path(f"{name}.npz")) as committed, np.load(
      fresh) as written:
    assert sorted(committed.files) == sorted(written.files)
    for k in written.files:
      np.testing.assert_array_equal(committed[k], written[k], err_msg=k)
  m = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  assert m.nv == {"quadruped": 22, "quadruped_fetch": 28,
                  "terrain_objects": 36}[name]
  if name == "terrain_objects":
    # C holds the heights as float32
    heights = terrain_objects.escape_heights(201, 30.0).astype(np.float32)
    np.testing.assert_array_equal(m.hfield_grid[0].vert[..., 2],
                                  heights.astype(np.float64) * 5.0)


def _states(mjm, n, seed, ball=False):
  """n seeded states the way the tasks start them: a random orientation
  (randn, normalized), joint angles uniform in their ranges, the body
  lowered until it touches the floor and 5 mm more; velocities N(0, 0.1);
  for fetch the ball on the torso or next to it."""
  rng = np.random.default_rng(seed)
  mjd = mujoco.MjData(mjm)
  out = []
  hinge = np.nonzero(mjm.jnt_type == mujoco.mjtJoint.mjJNT_HINGE)[0]
  for _ in range(n):
    mujoco.mj_resetData(mjm, mjd)
    q = rng.standard_normal(4)
    mjd.qpos[3:7] = q / np.linalg.norm(q)
    lo, hi = mjm.jnt_range[hinge].T
    mjd.qpos[mjm.jnt_qposadr[hinge]] = rng.uniform(lo, hi)
    if ball:
      mjd.qpos[23:26] = [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), 0]
    z = 1.5
    while True:
      mjd.qpos[2] = z
      if ball:
        mjd.qpos[25] = z + rng.uniform(0.25, 0.5)
      mujoco.mj_forward(mjm, mjd)
      if mjd.ncon:
        break
      z -= 0.005
    mjd.qpos[2] -= 0.005
    mjd.qvel[:] = 0.1 * rng.standard_normal(mjm.nv)
    mjd.ctrl[:] = rng.uniform(*mjm.actuator_ctrlrange.T)
    mjd.act[:] = rng.uniform(-0.5, 0.5, mjm.na)
    out.append((mjd.qpos.copy(), mjd.qvel.copy(), mjd.ctrl.copy(),
                mjd.act.copy()))
  return out


def _contacts_c(mjm, mjd):
  return sorted((min(c.geom1, c.geom2), max(c.geom1, c.geom2), c.dist,
                 tuple(c.pos)) for c in mjd.contact)


def _contacts_port(d, b):
  ct = d.contact
  act = np.nonzero((ct.dist[b] < ct.includemargin[b]).numpy())[0]
  return sorted((int(min(ct.geom1[b, i], ct.geom2[b, i])),
                 int(max(ct.geom1[b, i], ct.geom2[b, i])),
                 float(ct.dist[b, i]), tuple(ct.pos[b, i].tolist()))
                for i in act)


@pytest.mark.parametrize("name", ["quadruped", "quadruped_fetch"])
def test_forward_and_inverse_match_c(name):
  mjm = _mjmodel(name)
  mjm.opt.disableflags |= MULTICCD
  states = _states(mjm, 64, 7 + len(name), ball=name.endswith("fetch"))
  m = mt.put_model(mjm, device="cpu")
  stack = lambda i: np.stack([s[i] for s in states])
  d = mt.make_data(m, len(states))
  d = d.replace(qpos=torch.as_tensor(stack(0)), qvel=torch.as_tensor(stack(1)),
                ctrl=torch.as_tensor(stack(2)), act=torch.as_tensor(stack(3)))
  d = mt.forward(m, d)
  d_inv = mt.inverse(m, d)
  mjd = mujoco.MjData(mjm)
  closed = descent = 0
  kinds = set()
  for b, (qpos, qvel, ctrl, act) in enumerate(states):
    mjd.qpos, mjd.qvel, mjd.ctrl, mjd.act = qpos, qvel, ctrl, act
    mujoco.mj_forward(mjm, mjd)
    ref, ours = _contacts_c(mjm, mjd), _contacts_port(d, b)
    assert [r[:2] for r in ref] == [o[:2] for o in ours], b
    pair_kinds = {tuple(sorted((int(mjm.geom_type[g1]), int(mjm.geom_type[g2]))))
                  for g1, g2, _, _ in ref}
    kinds |= pair_kinds
    if pair_kinds <= CLOSED:
      closed += 1
      for r, o in zip(ref, ours):
        assert abs(r[2] - o[2]) <= 1e-9
        np.testing.assert_allclose(o[3], r[3], atol=1e-9)
      scale = max(1.0, float(np.abs(mjd.qacc).max()))
      np.testing.assert_allclose(d.qacc[b].numpy(), mjd.qacc, rtol=0,
                                 atol=1e-8 * scale)
      # inverse dynamics at the forward's qacc
      mjd.qacc[:] = d.qacc[b].numpy()
      mujoco.mj_inverse(mjm, mjd)
      fscale = max(1.0, float(np.abs(mjd.qfrc_inverse).max()))
      np.testing.assert_allclose(d_inv.qfrc_inverse[b].numpy(),
                                 mjd.qfrc_inverse, rtol=0,
                                 atol=1e-8 * fscale)
    else:
      descent += 1
      for r, o in zip(ref, ours):
        assert abs(r[2] - o[2]) <= 1e-3
  print(f"{name}: {closed} states with closed-form pairs only, {descent} "
        f"with a descent pair; kinds {sorted(kinds)}")
  assert closed >= 16 and descent >= 1


def _escape_xml(rangefinders):
  q = _dm_quadruped()
  return q.make_model(floor_size=40, terrain=True,
                      rangefinders=rangefinders).decode()


def test_escape_model_refused_by_name():
  from dm_control.suite import common

  mjm = mujoco.MjModel.from_xml_string(_escape_xml(True), common.ASSETS)
  with pytest.raises(NotImplementedError, match="sensor type RANGEFINDER"):
    mt.put_model(mjm, device="cpu")
  mjm = mujoco.MjModel.from_xml_string(_escape_xml(False), common.ASSETS)
  with pytest.raises(NotImplementedError,
                     match="collision pair HFIELD-(CYLINDER|ELLIPSOID)"):
    mt.put_model(mjm, device="cpu")
