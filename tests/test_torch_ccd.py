"""The PyTorch port's support-function descent (``ops/ccd.py``).

In float64 on the CPU, on 64 seeded poses each:

* ``geom_support_fn`` of each geom type, ``hull_support_fn``,
  ``support_descent`` and ``support_descent_staged`` (from random seed
  directions, so that no seed lies on a knife edge of a support's sign),
  ``ellipsoid_normal`` and ``fix_normal_smooth`` against the JAX
  package's, 1e-9;
* ``support_descent_staged``'s signed distance against C MuJoCo's
  ``mj_geomDistance`` on random poses, deep penetrations and needle geoms:
  never above C's (the descent's h(u) bounds the separation), with the
  worst gap printed;
* the staged descent runs under ``torch.func.vmap`` over
  ``torch.func.jvp``, with no functorch fallback.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import warnings

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from mujoco_inversedynamicstest_tpu.ops import ccd as jccd
from mujoco_inversedynamicstest_tpu_torch.ops import ccd as tccd

N = 64
TYPES = {"sphere": 2, "capsule": 3, "ellipsoid": 4, "cylinder": 5, "box": 6}


def _poses(seed, n=N):
  rng = np.random.default_rng(seed)
  p = 0.1 * rng.standard_normal((n, 3))
  m = Rotation.random(n, random_state=rng).as_matrix()
  s = rng.uniform(0.03, 0.12, (n, 3))
  u = rng.standard_normal((n, 3))
  u /= np.linalg.norm(u, axis=1, keepdims=True)
  return p, m, s, u


def _seeds(rng, n, k=4):
  v = rng.standard_normal((n, k, 3))
  return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _j(*xs):
  return [jnp.asarray(x) for x in xs]


def _t(*xs):
  return [torch.as_tensor(x) for x in xs]


def _close(a, b, tol=1e-9):
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("kind", list(TYPES))
def test_geom_support_matches_jax(kind):
  t = TYPES[kind]
  p, m, s, u = _poses(1 + t)
  ref = jax.jit(jax.vmap(
      lambda p, m, s, u: jccd.geom_support_fn(t, p, m, s)(u)))(*_j(p, m, s, u))
  got = tccd.geom_support_fn(t, *_t(p, m, s))(torch.as_tensor(u))
  _close(ref, got)


def test_hull_support_matches_jax():
  rng = np.random.default_rng(7)
  vert = rng.standard_normal((N, 20, 3)) * 0.1
  _, _, _, u = _poses(8)
  ref = jax.vmap(lambda v, u: jccd.hull_support_fn(v)(u))(*_j(vert, u))
  got = tccd.hull_support_fn(torch.as_tensor(vert))(torch.as_tensor(u))
  _close(ref, got, 0.0)
  # a fan of directions a pose
  us = _seeds(rng, N)
  ref = jax.vmap(lambda v, u: jax.vmap(jccd.hull_support_fn(v))(u))(
      *_j(vert, us))
  got = tccd.hull_support_fn(torch.as_tensor(vert))(torch.as_tensor(us))
  _close(ref, got, 0.0)


PAIRS = [("ellipsoid", "box"), ("cylinder", "capsule"),
         ("ellipsoid", "cylinder"), ("box", "cylinder"),
         ("sphere", "ellipsoid")]


def _pair(seed, k1, k2):
  rng = np.random.default_rng(seed)
  p1, m1, s1, _ = _poses(seed)
  _, m2, s2, u = _poses(seed + 50)
  p2 = p1 + u * rng.uniform(0.05, 0.3, (N, 1))
  return (p1, m1, s1, p2, m2, s2), _seeds(rng, N)


@pytest.mark.parametrize("staged", [False, True], ids=["full", "staged"])
@pytest.mark.parametrize("k1, k2", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_support_descent_matches_jax(k1, k2, staged):
  t1, t2 = TYPES[k1], TYPES[k2]
  geoms, seeds = _pair(10 * t1 + t2, k1, k2)
  jfn = jccd.support_descent_staged if staged else jccd.support_descent
  tfn = tccd.support_descent_staged if staged else tccd.support_descent

  def ref_one(p1, m1, s1, p2, m2, s2, seeds):
    return jfn(jccd.geom_support_fn(t1, p1, m1, s1),
               jccd.geom_support_fn(t2, p2, m2, s2), seeds, pad=0.01)

  ref = jax.jit(jax.vmap(ref_one))(*_j(*geoms, seeds))
  p1, m1, s1, p2, m2, s2 = _t(*geoms)
  got = tfn(tccd.geom_support_fn(t1, p1, m1, s1),
            tccd.geom_support_fn(t2, p2, m2, s2), torch.as_tensor(seeds),
            pad=0.01)
  for a, b in zip(ref, got):
    _close(a, b)


def test_ellipsoid_normal_matches_jax():
  rng = np.random.default_rng(3)
  size = rng.uniform(0.03, 0.12, (N, 3))
  # half inside the ellipsoid, half outside
  pos = rng.standard_normal((N, 3))
  pos /= np.linalg.norm(pos / size, axis=1, keepdims=True)
  pos *= np.where(np.arange(N) % 2, 0.7, 1.3)[:, None]
  nrm = rng.standard_normal((N, 3))
  ref = jax.jit(jax.vmap(lambda p, s, n: jccd.ellipsoid_normal(
      p, s, n, p.dtype)))(*_j(pos, size, nrm))
  got = tccd.ellipsoid_normal(*_t(pos, size, nrm))
  _close(ref, got)


@pytest.mark.parametrize("kind", ["cylinder", "ellipsoid", "box"])
def test_fix_normal_smooth_matches_jax(kind):
  t = TYPES[kind]
  p, m, s, u = _poses(20 + t)
  rng = np.random.default_rng(21 + t)
  # contact points near the surface: the support point along u, moved
  pos = np.asarray(jax.vmap(lambda p, m, s, u: jccd.geom_support_fn(
      t, p, m, s)(u))(*_j(p, m, s, u))) + 0.005 * rng.standard_normal((N, 3))
  ref = jax.jit(jax.vmap(lambda p, m, s, x, n: jccd.fix_normal_smooth(
      t, p, m, s, x, n)))(*_j(p, m, s, pos, u))
  got = tccd.fix_normal_smooth(t, *_t(p, m, s, pos, u))
  _close(ref, got)


# ---------------------------------------------------------------------------
# against C's mj_geomDistance
# ---------------------------------------------------------------------------


def _c_scene(k1, k2):
  xml = f"""<mujoco><worldbody>
    <body><freejoint/><geom type="{k1}" size=".1 .1 .1"/></body>
    <body><freejoint/><geom type="{k2}" size=".1 .1 .1"/></body>
  </worldbody></mujoco>"""
  mjm = mujoco.MjModel.from_xml_string(xml)
  return mjm, mujoco.MjData(mjm)


def _c_distance(mjm, mjd, geoms):
  """mj_geomDistance at each pose: the geoms' poses and sizes are written
  into the model and data as given."""
  out = []
  for p1, m1, s1, p2, m2, s2 in zip(*geoms):
    mjm.geom_size[0], mjm.geom_size[1] = s1, s2
    mjm.geom_rbound[:] = 10.0
    mjd.geom_xpos[0], mjd.geom_xpos[1] = p1, p2
    mjd.geom_xmat[0], mjd.geom_xmat[1] = m1.ravel(), m2.ravel()
    out.append(mujoco.mj_geomDistance(mjm, mjd, 0, 1, 10.0, None))
  return np.array(out)


def _sizes(kind, s):
  """geom_size as C holds it for a kind (a capsule's and a cylinder's
  radius and half-length, a sphere's radius)."""
  s = s.copy()
  if kind in ("capsule", "cylinder"):
    s[:, 2] = 0.0
  if kind == "sphere":
    s[:, 1:] = 0.0
  return s


CASES = {
    "random": lambda rng: (rng.uniform(0.03, 0.12, (N, 3)),
                           rng.uniform(0.03, 0.12, (N, 3)),
                           rng.uniform(0.3, 1.3, N)),
    "deep": lambda rng: (rng.uniform(0.05, 0.12, (N, 3)),
                         rng.uniform(0.05, 0.12, (N, 3)),
                         rng.uniform(0.05, 0.4, N)),
    "needle": lambda rng: (np.c_[rng.uniform(0.003, 0.01, (N, 2)),
                                 rng.uniform(0.1, 0.3, N)],
                           rng.uniform(0.03, 0.12, (N, 3)),
                           rng.uniform(0.3, 1.1, N)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("k1, k2", [("ellipsoid", "box"),
                                    ("cylinder", "capsule"),
                                    ("ellipsoid", "cylinder")],
                         ids=["ellipsoid-box", "cylinder-capsule",
                              "ellipsoid-cylinder"])
def test_staged_distance_matches_c_geom_distance(k1, k2, case):
  """support_descent_staged from the narrowphase's seeds (the centre line
  and each geom's feature directions) against C's signed distance.  The
  second geom sits at ``reach`` times the sum of the two bounding radii
  along a random direction: apart, touching or deep."""
  t1, t2 = TYPES[k1], TYPES[k2]
  rng = np.random.default_rng(100 + 10 * t1 + t2 + len(case))
  s1, s2, reach = CASES[case](rng)
  s1, s2 = _sizes(k1, s1), _sizes(k2, s2)
  m1 = Rotation.random(N, random_state=rng).as_matrix()
  m2 = Rotation.random(N, random_state=rng).as_matrix()
  u = rng.standard_normal((N, 3))
  u /= np.linalg.norm(u, axis=1, keepdims=True)
  bound = lambda s: np.linalg.norm(s[:, :2], axis=1) + s[:, 2]
  p1 = 0.1 * rng.standard_normal((N, 3))
  p2 = p1 + u * (reach * 0.5 * (bound(s1) + bound(s2)))[:, None]
  geoms = (p1, m1, s1, p2, m2, s2)
  ref = _c_distance(*_c_scene(k1, k2), geoms)

  from mujoco_inversedynamicstest_tpu_torch.ops import collision_sdf as tsdf
  from mujoco_inversedynamicstest_tpu_torch.ops import math as tmath
  P1, M1, S1, P2, M2, S2 = _t(*geoms)
  dc = tmath.normalize(P2 - P1)
  seeds = torch.stack([dc] + tsdf._feature_seeds(t1, M1, dc)
                      + tsdf._feature_seeds(t2, M2, dc), dim=-2)
  dist, _, _ = tccd.support_descent_staged(
      tccd.geom_support_fn(t1, P1, M1, S1),
      tccd.geom_support_fn(t2, P2, M2, S2), seeds)
  diff = dist.numpy() - ref
  gap = np.abs(diff)
  print(f"{k1}-{k2} {case}: worst |ours - mj_geomDistance| {gap.max():.3e}"
        f" (median {np.median(gap):.3e}, 90% {np.quantile(gap, 0.9):.3e}; "
        f"C's range {ref.min():.3f} to {ref.max():.3f})")
  # h(u) is at least its minimum for every u, so the descent can only
  # report a smaller distance (a deeper penetration) than the true one; how
  # much smaller is the descent's accuracy (ROADMAP §3 has the worst gaps)
  assert diff.max() <= 1e-9
  if case == "deep":
    assert (ref < 0).mean() > 0.9


def test_staged_descent_runs_under_vmap_of_jvp():
  """The dual step's route: vmap over jvp of the staged descent runs with
  no functorch fallback, and gives the primal and finite tangents."""
  t1, t2 = TYPES["ellipsoid"], TYPES["cylinder"]
  geoms, seeds = _pair(5, "ellipsoid", "cylinder")
  p1, m1, s1, p2, m2, s2 = _t(*geoms)
  seeds = torch.as_tensor(seeds)

  def dist_of(x):
    return tccd.support_descent_staged(
        tccd.geom_support_fn(t1, p1, m1, s1),
        tccd.geom_support_fn(t2, x, m2, s2), seeds)[0]

  tangents = torch.eye(3, dtype=torch.float64)[:, None, :].expand(3, N, 3)
  torch._C._functorch._set_vmap_fallback_warning_enabled(True)
  try:
    with warnings.catch_warnings():
      warnings.filterwarnings("error", message=".*performance drop.*")
      primal, tang = torch.func.vmap(
          lambda t: torch.func.jvp(dist_of, (p2,), (t,)))(tangents)
  finally:
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
  assert torch.equal(primal[0], dist_of(p2))
  assert torch.isfinite(tang).all()
