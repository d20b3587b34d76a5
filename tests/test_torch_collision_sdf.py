"""The PyTorch port's cylinder and ellipsoid narrowphase
(``ops/collision_sdf.py``), in float64 on the CPU:

* the signed distance functions ``sdf_*`` against the JAX package's,
  1e-12;
* each of the ten pair kinds of ``SDF_NARROWPHASE`` against the JAX
  package's on 256 seeded poses (``tests/collision_poses.py``), pair by
  pair as sets of (dist, pos, normal): 1e-9 wherever the reference is
  stable.  The descent's seeds include directions on a knife edge of a
  support's sign (a capsule's or a cylinder's radial seed is perpendicular
  to its axis, a box's face seed has two zero components in the box's
  frame), where the sign is that of rounding noise: there the JAX
  package's own jitted and op-by-op runs, and runs a 1e-9 nudge apart,
  disagree.  At such a tie the port must give one of the reference's
  answers (1e-8), except for a few pairs a kind, counted, where no run of
  the reference took the port's side; there the deepest contacts must
  agree within the descent's accuracy (1e-2);
* the ten kinds against C MuJoCo with ``mjDSBL_MULTICCD`` set, on the
  configurations of ``tests/test_collision_sdf.py`` and one more for each
  kind it lacks: the same active set, dist, pos and normal within 1e-9 for
  the closed forms, depth within 1e-4 and normal within 1e-3 for the
  descent pairs (of the exact contact where C's own normal is off it);
* C's default multi-contact CCD, the recorded fault (ROADMAP §3): on
  flat-faced pairs C gives more contacts than the port's one, and with the
  disable bit it gives the port's one.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import collision_poses as poses
from mujoco_inversedynamicstest_tpu.ops import collision_sdf as jsdf
from mujoco_inversedynamicstest_tpu_torch.ops import collision_sdf as tsdf
from mujoco_inversedynamicstest_tpu_torch.models.types import DisableBit
from test_torch_collision_box import _c_contacts, _port_contacts

KINDS = {0: "plane", 2: "sphere", 3: "capsule", 4: "ellipsoid",
         5: "cylinder", 6: "box"}
MULTICCD = int(mujoco.mjtDisableBit.mjDSBL_MULTICCD)
# two runs of the staged descent that leave a knife edge on different sides
# end in different basins; how far apart their depths may be is the
# descent's accuracy (against C's mj_geomDistance on random poses, 90% of
# its gaps are under 3.2e-3: tests/test_torch_ccd.py)
DESCENT_ACCURACY = 1e-2


def test_disable_bits_are_the_installed_mujocos():
  assert DisableBit.MULTICCD == MULTICCD == 1 << 19
  assert DisableBit.NATIVECCD == int(mujoco.mjtDisableBit.mjDSBL_NATIVECCD)


@pytest.mark.parametrize("kind", ["sphere", "capsule", "ellipsoid",
                                  "cylinder", "box"])
def test_sdf_functions_match_jax(kind):
  """The local-frame signed distance functions, on 256 seeded points
  inside and outside geoms of seeded sizes, 1e-12."""
  rng = np.random.default_rng(7)
  x = 0.15 * rng.standard_normal((poses.N, 3))
  size = rng.uniform(0.03, 0.12, (poses.N, 3))
  jfn, tfn = getattr(jsdf, f"sdf_{kind}"), getattr(tsdf, f"sdf_{kind}")
  ref = jax.vmap(jfn)(jnp.asarray(x), jnp.asarray(size))
  got = tfn(torch.as_tensor(x), torch.as_tensor(size))
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                             atol=1e-12)


def _case(key):
  t1, t2 = key
  seed = 100 + 10 * t1 + t2
  # the poses' generator knows no ellipsoid: it takes three half-sizes,
  # a box's
  size_kind = lambda t: "box" if t == 4 else KINDS[t]
  if t1 == 0:
    case = list(poses.plane_case(seed, size_kind(t2), 0.12))
  else:
    case = list(poses.pair_case(seed, size_kind(t1), size_kind(t2), 0.1,
                                0.1))
  return tuple(case)


def _nudged_cases(case):
  """Geom 2 moved by poses.NUDGE either way (a seeded shift and turn)."""
  rng = np.random.default_rng(99)
  n = len(case[0])
  shift = poses.NUDGE * rng.standard_normal((n, 3))
  turn = poses.NUDGE * rng.standard_normal((n, 3))
  out = []
  for sign in (1.0, -1.0):
    moved = list(case)
    moved[3] = case[3] + sign * shift
    moved[4] = Rotation.from_rotvec(sign * turn).as_matrix() @ case[4]
    out.append(tuple(moved))
  return out


def compare_descent_with_jax(jfn, tfn, case, label):
  """A descent narrowphase of the port against the JAX package's on the
  pairs of ``case``: 1e-9 where the reference is stable (its jitted and
  op-by-op runs, and the runs of both packages a nudge away, agree within
  1e-6); at a knife edge one of the reference's answers (1e-8), or, on a
  side no run of the reference took, the deepest contact within
  ``DESCENT_ACCURACY``.  Returns (stable pairs, knife edges, odd sides)."""
  moved = _nudged_cases(case)
  ref = [poses.run_jax(jfn, case, True), poses.run_jax(jfn, case, False)]
  ref += [poses.run_jax(jfn, c, jit) for c in moved for jit in (True, False)]
  got = [poses.run_torch(tfn, case)] + [poses.run_torch(tfn, c)
                                        for c in moved]
  stable = ties = odd = 0
  bad = []
  for i in range(len(case[0])):
    sets = lambda outs: [poses.contact_set(o, i, case[6]) for o in outs]
    want, have = sets(ref), sets(got)
    if max(poses.set_error(want[0], x) for x in want[1:] + have) <= 1e-6:
      stable += 1
      if poses.set_error(want[0], have[0]) > 1e-9:
        bad.append((i, "stable", poses.set_error(want[0], have[0])))
      continue
    ties += 1
    if min(poses.set_error(w, have[0]) for w in want) <= 1e-8:
      continue
    # the port's side of a knife edge no run of the reference took: the
    # deepest contact's depth (none: the margin, where a contact carries no
    # force) within the descent's accuracy
    odd += 1
    deepest = lambda x: min(x[:, 0].min(initial=np.inf), case[6][i])
    gap = min(abs(deepest(w) - deepest(have[0])) for w in want)
    if gap > DESCENT_ACCURACY:
      bad.append((i, "tie", gap))
  print(f"{label}: {stable} stable pairs, {ties} at a knife edge, {odd} of "
        "them on a side no reference run took")
  assert not bad, bad[:8]
  assert (ref[0][0] < poses.ACTIVE).any(1).sum() >= len(case[0]) // 5
  return stable, ties, odd


@pytest.mark.parametrize("key", list(tsdf.SDF_NARROWPHASE),
                         ids=[f"{KINDS[a]}-{KINDS[b]}"
                              for a, b in tsdf.SDF_NARROWPHASE])
def test_sdf_narrowphase_matches_jax(key):
  stable, _, odd = compare_descent_with_jax(
      jsdf.SDF_NARROWPHASE[key], tsdf.SDF_NARROWPHASE[key], _case(key),
      f"{KINDS[key[0]]}-{KINDS[key[1]]}")
  assert stable >= poses.N // 3 and odd <= poses.N // 16


# ---------------------------------------------------------------------------
# against C MuJoCo
# ---------------------------------------------------------------------------


def _scene(body1, body2, plane=False):
  floor = '<geom type="plane" size="1 1 .1"/>' if plane else ""
  mjm = mujoco.MjModel.from_xml_string(
      f"<mujoco><worldbody>{floor}{body1}{body2}</worldbody></mujoco>")
  mjm.opt.disableflags |= MULTICCD
  return mjm, mujoco.MjData(mjm)


def _free(pos, geom, euler="0 0 0"):
  return f'<body pos="{pos}" euler="{euler}"><freejoint/>{geom}</body>'


C_SCENES = {
    "plane-ellipsoid": ("", _free(
        "0 0 0.045", '<geom type="ellipsoid" size="0.1 0.07 0.05"/>',
        "20 0 0"), True),
    "sphere-ellipsoid": (
        _free("0.02 0.01 0.13", '<geom type="sphere" size="0.06"/>'),
        _free("0 0 0", '<geom type="ellipsoid" size="0.1 0.08 0.08"/>'),
        False),
    "sphere-cylinder side": (
        _free("0 0 0.1", '<geom type="sphere" size="0.1"/>'),
        _free("0.17 0 0.1", '<geom type="cylinder" size="0.08 0.1"/>'),
        False),
    "sphere-cylinder cap": (
        _free("0 0 0.3", '<geom type="sphere" size="0.11"/>'),
        _free("0 0 0.1", '<geom type="cylinder" size="0.2 0.1"/>'), False),
    "capsule-ellipsoid": (
        _free("0 0 0.135", '<geom type="capsule" size="0.04 0.1"/>',
              "0 90 0"),
        _free("0 0 0", '<geom type="ellipsoid" size="0.12 0.1 0.1"/>'),
        False),
    "capsule-cylinder": (
        _free("0 0 0.1", '<geom type="capsule" size="0.05 0.12"/>',
              "0 90 0"),
        _free("0 0 0.23", '<geom type="cylinder" size="0.09 0.05"/>',
              "90 0 0"), False),
    "ellipsoid-ellipsoid": (
        _free("0 0 0.1", '<geom type="ellipsoid" size="0.1 0.08 0.06"/>'),
        _free("0.15 0 0.1", '<geom type="ellipsoid" size="0.07 0.07 0.09"/>'),
        False),
    "ellipsoid-cylinder": (
        _free("0 0 0.195", '<geom type="ellipsoid" size="0.08 0.07 0.1"/>'),
        _free("0 0 0", '<geom type="cylinder" size="0.15 0.1"/>'), False),
    "ellipsoid-box": (
        _free("0 0 0.1", '<geom type="box" size="0.2 0.2 0.1"/>'),
        _free("0 0 0.24", '<geom type="ellipsoid" size="0.08 0.06 0.05"/>'),
        False),
    "cylinder-cylinder": (
        _free("0 0 0.12", '<geom type="cylinder" size="0.1 0.05"/>',
              "90 0 0"),
        _free("0 0 0.30", '<geom type="cylinder" size="0.1 0.06"/>',
              "90 0 0"), False),
    "cylinder-box": (
        _free("0 0 0.1", '<geom type="box" size="0.2 0.2 0.1"/>'),
        _free("0 0 0.245", '<geom type="cylinder" size="0.05 0.12"/>',
              "90 0 0"), False),
}
CLOSED_FORM = ("plane-ellipsoid", "sphere-cylinder side",
               "sphere-cylinder cap")
# where C's GJK/EPA normal is itself off the exact one, the configuration's
# exact contact (tests/test_collision_sdf.py's): depth, normal (geom 1 to 2
# of the port's order) and their tolerances
EXACT = {
    "ellipsoid-ellipsoid": (-0.02, [1, 0, 0], 1e-4, 1e-3),
    "cylinder-cylinder": (-0.02, [0, 0, 1], 1e-6, 1e-6),
}


@pytest.mark.parametrize("name", list(C_SCENES))
def test_sdf_pairs_match_c_without_multiccd(name):
  """One contact each in C and the port.  The closed forms equal C's to
  1e-9; a descent pair's depth is within 1e-4 and its normal within 1e-3
  of C's, or, where C's own normal is off the exact one by more than that
  (its EPA on smooth or parallel flat geoms), of the exact contact."""
  mjm, mjd = _scene(*C_SCENES[name])
  ref, ours = _c_contacts(mjm, mjd), _port_contacts(mjm, mjd)
  assert len(ref) == 1 and len(ours) == 1, (ref, ours)
  (d0, p0, n0, g1, g2), (d1, p1, n1, h1, h2) = ref[0], ours[0]
  if (g1, g2) != (h1, h2):
    n0 = -n0
  if name in CLOSED_FORM:
    assert abs(d0 - d1) <= 1e-9
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    np.testing.assert_allclose(n1, n0, atol=1e-9)
  elif name in EXACT:
    depth, nrm, dtol, ntol = EXACT[name]
    assert abs(d1 - depth) <= dtol
    np.testing.assert_allclose(n1, nrm, atol=ntol)
    assert abs(d0 - depth) <= 1e-4 and np.abs(n0 - nrm).max() > 1e-3
  else:
    assert abs(d0 - d1) <= 1e-4
    np.testing.assert_allclose(n1, n0, atol=1e-3)


# C 3.10's contact counts with its default multi-contact CCD on, against
# one with mjDSBL_MULTICCD; the port gives one under either setting
MULTI_SCENES = {
    "cylinder on a box, upright": (
        _free("0 0 0.1", '<geom type="box" size="0.2 0.2 0.1"/>'),
        _free("0 0 0.295", '<geom type="cylinder" size="0.05 0.1"/>'), 5),
    "cylinder on a box, lying": (C_SCENES["cylinder-box"][0],
                                 C_SCENES["cylinder-box"][1], 5),
    "cylinder-cylinder, stacked": (
        _free("0 0 0.1", '<geom type="cylinder" size="0.1 0.1"/>'),
        _free("0 0 0.295", '<geom type="cylinder" size="0.08 0.1"/>'), 5),
    "cylinder-cylinder, parallel": (C_SCENES["cylinder-cylinder"][0],
                                    C_SCENES["cylinder-cylinder"][1], 3),
    "capsule-cylinder, parallel": (
        _free("0 0 0.1", '<geom type="cylinder" size="0.1 0.1"/>',
              "90 0 0"),
        _free("0 0 0.245", '<geom type="capsule" size="0.05 0.1"/>',
              "90 0 0"), 3),
}


@pytest.mark.parametrize("name", list(MULTI_SCENES))
def test_default_multiccd_gives_c_more_contacts(name):
  """The recorded fault: under C 3.10's default, multi-contact CCD gives
  these flat-faced pairs several contacts; the port (as the JAX package)
  gives one, which is C's count with ``mjDSBL_MULTICCD``."""
  body1, body2, count = MULTI_SCENES[name]
  mjm, mjd = _scene(body1, body2)
  ours = _port_contacts(mjm, mjd)
  assert len(_c_contacts(mjm, mjd)) == len(ours) == 1
  mjm.opt.disableflags &= ~MULTICCD
  assert len(_c_contacts(mjm, mjd)) == count
  assert len(_port_contacts(mjm, mjd)) == 1
