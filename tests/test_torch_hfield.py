"""The PyTorch port's height-field narrowphase (``ops/hfield.py``), in
float64 on the CPU:

* the grid and its window of triangles against the JAX package's
  ``HFieldGrid`` and ``_gather_subgrid_tris``;
* ``make_hfield_sphere``, ``make_hfield_capsule`` and
  ``make_hfield_convex`` (a box and a mesh hull) against the JAX
  package's on 64 seeded poses each over a bumpy field, pair by pair as
  sets of (dist, pos, normal), 1e-9 (the prism descent where the
  reference is stable, with ``test_torch_collision_sdf.py``'s rule at
  its knife edges);
* a sphere and a capsule on the field against C MuJoCo (the
  configurations of ``tests/test_hfield.py``): every contact one of C's
  and qacc within 1e-6; the capsule's deepest depth within 1e-5;
* a box resting on the field against C, whose prism CCD keeps other
  contacts (ROADMAP §3): both in contact, the gaps printed;
* ``put_model`` refuses a height field with a cylinder or an ellipsoid,
  by the pair's name, as the JAX package does.
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
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import collision_convex as jcc
from mujoco_inversedynamicstest_tpu.ops import hfield as jhf
from mujoco_inversedynamicstest_tpu.ops import hull as jhull
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex as tcc
from mujoco_inversedynamicstest_tpu_torch.ops import hfield as thf
from test_torch_collision_sdf import compare_descent_with_jax

NROW, NCOL = 9, 11
SIZE = np.array([1.0, 0.8, 0.3, 0.1])
N = 64


def _heights():
  """tests/test_hfield.py's smooth bumps, normalized to [0, 1]."""
  r, c = np.meshgrid(np.arange(NROW), np.arange(NCOL), indexing="ij")
  z = 0.5 + 0.35 * np.sin(c * 0.7) * np.cos(r * 0.9)
  return (z - z.min()) / (z.max() - z.min())


def _grids():
  z = _heights()
  return (jhf.HFieldGrid(NROW, NCOL, SIZE, z),
          thf.HFieldGrid(NROW, NCOL, SIZE, z.ravel()))


def test_grid_and_window_match_jax():
  jg, tg = _grids()
  np.testing.assert_array_equal(jg.vert, tg.vert)
  assert (jg.dx, jg.dy) == (tg.dx, tg.dy)
  assert jhf.subgrid_cells(jg, 0.13) == thf.subgrid_cells(tg, 0.13) == (3, 3)
  rng = np.random.default_rng(0)
  lpos = rng.uniform(-1.2, 1.2, (N, 3))
  ref = jax.vmap(lambda p: jhf._gather_subgrid_tris(
      jg, p, 3, 4, jnp.float64))(jnp.asarray(lpos))
  got = thf._gather_subgrid_tris(tg, torch.as_tensor(tg.vert.reshape(-1, 3)),
                                 torch.as_tensor(lpos), 3, 4)
  np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def _case(seed, size2):
  """The field at a small seeded pose, geom 2 over a random point of it at
  -0.6 to 1.4 times its reach above the surface."""
  rng = np.random.default_rng(seed)
  m1 = Rotation.from_rotvec(0.2 * rng.standard_normal((N, 3))).as_matrix()
  p1 = 0.05 * rng.standard_normal((N, 3))
  jg, _ = _grids()
  xy = rng.uniform([-0.8, -0.6], [0.8, 0.6], (N, 2))
  r = np.clip(np.round((xy[:, 1] + SIZE[1]) / jg.dy).astype(int), 0, NROW - 1)
  c = np.clip(np.round((xy[:, 0] + SIZE[0]) / jg.dx).astype(int), 0, NCOL - 1)
  reach = np.linalg.norm(size2, axis=1)
  z = jg.vert[r, c, 2] + rng.uniform(-0.6, 1.4, N) * reach
  local = np.c_[xy, z]
  p2 = p1 + np.einsum("nij,nj->ni", m1, local)
  m2 = Rotation.random(N, random_state=rng).as_matrix()
  return (p1, m1, np.zeros((N, 3)), p2, m2, size2,
          np.where(rng.uniform(size=N) < 0.25, 0.01, 0.0))


def _bipyramid():
  a = np.arange(6) * np.pi / 3
  return np.r_[np.c_[0.08 * np.cos(a), 0.08 * np.sin(a), np.zeros(6)],
               [[0, 0, 0.07], [0, 0, -0.07]]]


KINDS = ["sphere", "capsule", "box", "mesh"]


@pytest.mark.parametrize("kind", KINDS)
def test_hfield_narrowphase_matches_jax(kind):
  jg, tg = _grids()
  rng = np.random.default_rng(10 + KINDS.index(kind))
  nr, nc = 3, 3
  tvert = torch.as_tensor(tg.vert.reshape(-1, 3))
  if kind == "sphere":
    size2 = np.c_[rng.uniform(0.05, 0.12, N), np.zeros((N, 2))]
    fns = (jhf.make_hfield_sphere(jg, nr, nc),
           thf.make_hfield_sphere(tg, tvert, nr, nc))
  elif kind == "capsule":
    size2 = np.c_[rng.uniform(0.03, 0.06, N), rng.uniform(0.03, 0.08, N),
                  np.zeros(N)]
    fns = (jhf.make_hfield_capsule(jg, nr, nc),
           thf.make_hfield_capsule(tg, tvert, nr, nc))
  elif kind == "box":
    size2 = rng.uniform(0.03, 0.08, (N, 3))
    fns = (jhf.make_hfield_convex(jg, jcc.BOX_HULL, True, nr, nc),
           thf.make_hfield_convex(tg, tvert, torch.as_tensor(
               tcc.BOX_HULL.vert), True, nr, nc))
  else:
    hull = jhull.build_hull(_bipyramid())
    size2 = np.zeros((N, 3)) + 0.08
    fns = (jhf.make_hfield_convex(jg, hull, False, nr, nc),
           thf.make_hfield_convex(tg, tvert, torch.as_tensor(hull.vert),
                                  False, nr, nc))
  case = _case(20 + KINDS.index(kind), size2)
  if kind in ("sphere", "capsule"):
    ncontact, ties = poses.compare_with_jax(*fns, case, tol=1e-9)
    assert ncontact >= N // 4 and ties <= N // 8
  else:
    # the prism descent has the knife edges of every support descent, and
    # more: a prism's top triangle and the field's up axis are seeds too
    stable, _, odd = compare_descent_with_jax(*fns, case, f"hfield-{kind}")
    assert stable >= N // 2 and odd <= N // 4


# ---------------------------------------------------------------------------
# against C MuJoCo
# ---------------------------------------------------------------------------


def _terrain(geom):
  mjm = mujoco.MjModel.from_xml_string(f"""
  <mujoco>
    <option timestep="0.005"/>
    <asset>
      <hfield name="terrain" nrow="{NROW}" ncol="{NCOL}"
              size="{SIZE[0]} {SIZE[1]} {SIZE[2]} {SIZE[3]}"/>
    </asset>
    <worldbody>
      <geom type="hfield" hfield="terrain" pos="0 0 0"/>
      <body pos="0 0 1"><freejoint/>{geom}</body>
    </worldbody>
  </mujoco>""")
  mjm.hfield_data[:] = _heights().ravel()
  return mjm


def _surface(x, y):
  """The field's top surface at (x, y): height and upward unit normal."""
  jg, _ = _grids()
  cf, rf = (x + SIZE[0]) / jg.dx, (y + SIZE[1]) / jg.dy
  ci = int(np.clip(np.floor(cf), 0, NCOL - 2))
  ri = int(np.clip(np.floor(rf), 0, NROW - 2))
  v = jg.vert
  third = v[ri, ci + 1] if cf - ci >= rf - ri else v[ri + 1, ci]
  n = np.cross(v[ri + 1, ci + 1] - v[ri, ci], third - v[ri, ci])
  n *= np.sign(n[2])
  z = v[ri, ci, 2] - (n[0] * (x - v[ri, ci, 0])
                      + n[1] * (y - v[ri, ci, 1])) / n[2]
  return z, n / np.linalg.norm(n)


def _port(mjm, mjd):
  m = mt.put_model(mjm, device="cpu")
  return mt.forward(m, mt.put_data(m, mjd))


def test_hfield_sphere_matches_c():
  """A sphere 2 cm into the local triangle's plane (tests/test_hfield.py's
  placement): every active contact is one of C's (dist, pos, normal 1e-6),
  the same count up to 4, and qacc within 1e-6 where the sets are equal."""
  mjm = _terrain('<geom type="sphere" size="0.08" mass="1"/>')
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(2)
  checked = 0
  for _ in range(10):
    x, y = rng.uniform(-0.6, 0.6), rng.uniform(-0.45, 0.45)
    zs, n = _surface(x, y)
    mujoco.mj_resetData(mjm, mjd)
    mjd.qpos[:3] = np.array([x, y, zs]) + n * (0.08 - 0.02) / n[2]
    mujoco.mj_forward(mjm, mjd)
    d = _port(mjm, mjd)
    ct = d.contact
    act = np.nonzero((ct.dist[0] < 0).numpy())[0]
    assert len(act) == min(mjd.ncon, 4) and mjd.ncon >= 1
    used = set()
    for k in act:
      for c in range(mjd.ncon):
        if c not in used and (
            abs(float(ct.dist[0, k]) - mjd.contact.dist[c]) < 1e-6
            and np.abs(ct.pos[0, k].numpy() - mjd.contact.pos[c]).max() < 1e-6
            and np.abs(ct.frame[0, k, 0].numpy()
                       - mjd.contact.frame[c][:3]).max() < 1e-6):
          used.add(c)
          break
      else:
        raise AssertionError(f"unmatched contact {k}")
    if len(act) == mjd.ncon:
      np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, atol=1e-6)
      checked += 1
  assert checked >= 5


def test_hfield_capsule_matches_c():
  """A capsule lying 4 cm above the surface (tests/test_hfield.py's
  placement, without C's side-wall contacts): the deepest depth within
  1e-5 of C's, and qacc within 1e-5 where the contact sets have one
  contact each."""
  mjm = _terrain(
      '<geom type="capsule" size="0.05 0.15" mass="1" euler="90 0 0"/>')
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(3)
  checked = 0
  for _ in range(12):
    x, y = rng.uniform(-0.5, 0.5), rng.uniform(-0.35, 0.35)
    zs, _ = _surface(x, y)
    mujoco.mj_resetData(mjm, mjd)
    mjd.qpos[:3] = [x, y, zs + 0.04]
    mujoco.mj_forward(mjm, mjd)
    if mjd.ncon == 0 or any(abs(mjd.contact.frame[c][2]) < 0.2
                            for c in range(mjd.ncon)):
      continue
    checked += 1
    d = _port(mjm, mjd)
    ours = np.sort(d.contact.dist[0].numpy())
    assert abs(ours[0] - np.min(mjd.contact.dist[:mjd.ncon])) <= 1e-5
    if mjd.ncon == 1 and (ours < 0).sum() == 1:
      np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, atol=1e-5)
  assert checked >= 4


def test_hfield_box_against_c_prism_ccd():
  """A box resting on the field, C's prism CCD against the port's prism
  descent (one contact a prism, the 4 deepest kept, as the JAX package):
  both in contact at every pose; the gaps are printed and ROADMAP §3
  records them (C's contact selection is not ported)."""
  mjm = _terrain('<geom type="box" size="0.1 0.08 0.05" mass="1"/>')
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(4)
  gaps, qgaps = [], []
  for _ in range(10):
    x, y = rng.uniform(-0.5, 0.5), rng.uniform(-0.35, 0.35)
    zs, n = _surface(x, y)
    mujoco.mj_resetData(mjm, mjd)
    mjd.qpos[:3] = [x, y, zs + 0.05 / n[2] - 0.003]
    mujoco.mj_forward(mjm, mjd)
    d = _port(mjm, mjd)
    ours = d.contact.dist[0].numpy()
    assert mjd.ncon > 0 and (ours < 0).any()
    gaps.append(abs(ours.min() - mjd.contact.dist[:mjd.ncon].min()))
    qgaps.append(np.abs(d.qacc[0].numpy() - mjd.qacc).max()
                 / max(np.abs(mjd.qacc).max(), 1.0))
  print(f"box on the field: deepest-depth gap to C worst {max(gaps):.3e}, "
        f"median {np.median(gaps):.3e}; qacc gap over C's max|qacc| worst "
        f"{max(qgaps):.3e}, median {np.median(qgaps):.3e}")


@pytest.mark.parametrize("geom, pair", [
    ('<geom type="cylinder" size="0.05 0.1"/>', "HFIELD-CYLINDER"),
    ('<geom type="ellipsoid" size="0.05 0.06 0.07"/>', "HFIELD-ELLIPSOID"),
])
def test_hfield_cylinder_and_ellipsoid_refused_by_name(geom, pair):
  with pytest.raises(NotImplementedError, match=f"collision pair {pair}"):
    mt.put_model(_terrain(geom), device="cpu")
