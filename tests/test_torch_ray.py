"""The PyTorch port's ray casts against C MuJoCo and the JAX package.

f64 on the CPU.  ``ray.ray`` (``mj_ray``) on a scene of every geom type (a
plane, a height field, spheres, capsules, an ellipsoid, a cylinder, boxes,
a tetrahedron and a concave mesh; two invisible geoms, one by its own alpha
and one by its material's), at two seeded states of 64 seeded rays each,
under four settings (all geoms; a group mask; movable geoms only; a body
excluded a ray): each ray's distance (1e-9) and geom against C
``mj_ray`` and the JAX package's ``ray``, every geom type hit.
``ray_flex`` (``mju_rayFlex``) on ``tests/test_ray_flex.py``'s sheet under
its three flag settings and on a tet cube's outer and inner layers,
against C and the JAX package; ``ray_skin`` (``mju_raySkin``) on that
test's deformed sheet against its brute-force oracle and the JAX
package.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
from mujoco_inversedynamicstest_tpu.ops import ray as jray
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType
from mujoco_inversedynamicstest_tpu_torch.ops import ray

import test_ray_flex

SCENE = """
<mujoco>
  <option><flag contact="disable"/></option>
  <asset>
    <hfield name="hf" nrow="6" ncol="7" size="0.6 0.5 0.2 0.1"/>
    <mesh name="tet" vertex="0 0 0  0.25 0 0  0 0.25 0  0 0 0.25"/>
    <mesh name="vee" vertex="-0.2 -0.1 0  0.2 -0.1 0  0 -0.1 -0.15
                             -0.2 0.1 0   0.2 0.1 0   0 0.1 -0.15"
          face="0 2 3  3 2 5  2 1 5  5 1 4  0 1 2  3 5 4"/>
    <material name="clear" rgba="1 1 1 0"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="3 3 .1"/>
    <geom name="terrain" type="hfield" hfield="hf" pos="1.6 0 0" group="1"/>
    <geom name="post" type="box" size="0.05 0.05 0.4" pos="-0.8 0.6 0.4"
          group="1"/>
    <geom name="ghost" type="sphere" size="0.3" pos="-0.8 -0.6 0.5"
          rgba="1 0 0 0"/>
    <geom name="glass" type="box" size="0.3 0.3 0.02" pos="0 0 1.4"
          material="clear"/>
    <body name="a" pos="0 0 0.6"><freejoint/>
      <geom type="sphere" size="0.12" group="2"/>
      <geom type="capsule" size="0.05" fromto="0.1 0 0 0.4 0.1 0"
            group="2"/>
      <site name="rf" pos="0 0 0.2"/>
    </body>
    <body name="b" pos="0.5 -0.4 0.5"><freejoint/>
      <geom type="ellipsoid" size="0.15 0.1 0.07" group="3"/>
      <geom type="cylinder" size="0.08 0.1" pos="0.25 0 0" group="3"/>
    </body>
    <body name="c" pos="-0.4 0.3 0.4"><freejoint/>
      <geom type="box" size="0.1 0.07 0.05" group="4"/>
      <geom type="mesh" mesh="tet" pos="0 0.2 0" group="4"/>
    </body>
    <body name="d" pos="1.6 0.2 0.5"><freejoint/>
      <geom type="mesh" mesh="vee" group="5"/>
    </body>
  </worldbody>
  <sensor><rangefinder site="rf"/></sensor>
</mujoco>
"""
NRAY = 64
# the bodies a ray may exclude in the last setting (-1: none), by ray
BODIES = ("a", "c")


def _scene():
  """The scene with seeded heights, and two seeded states."""
  mjm = mujoco.MjModel.from_xml_string(SCENE)
  rng = np.random.RandomState(0)
  mjm.hfield_data[:] = rng.uniform(0, 1, mjm.hfield_data.shape)
  mjds = []
  for seed in range(2):
    rng = np.random.RandomState(seed + 1)
    mjd = mujoco.MjData(mjm)
    mujoco.mj_integratePos(mjm, mjd.qpos, 0.03 * rng.randn(mjm.nv), 1.0)
    mujoco.mj_forward(mjm, mjd)
    mjds.append(mjd)
  return mjm, mjds


# points the aimed rays go through: each body's geoms, the terrain
TARGETS = np.array([[0.0, 0.0, 0.6], [0.3, 0.07, 0.6], [0.5, -0.4, 0.5],
                    [0.75, -0.4, 0.5], [-0.4, 0.3, 0.4], [-0.35, 0.55, 0.45],
                    [1.6, 0.2, 0.45], [1.6, -0.2, 0.1]])


def _rays(seed):
  """NRAY seeded rays: half aimed from above at the TARGETS (0.03 randn
  off), a quarter from above pointing down and sideways, a quarter nearly
  horizontal."""
  rng = np.random.RandomState(seed)
  pnt = np.c_[rng.uniform(-1.2, 2.2, NRAY), rng.uniform(-0.9, 0.9, NRAY),
              rng.uniform(0.9, 1.8, NRAY)]
  vec = np.c_[0.5 * rng.randn(NRAY), 0.5 * rng.randn(NRAY), -np.ones(NRAY)]
  aimed = np.arange(NRAY) < NRAY // 2
  at = TARGETS[np.arange(NRAY) % len(TARGETS)] + 0.03 * rng.randn(NRAY, 3)
  vec[aimed] = (at - pnt)[aimed]
  flat = np.arange(NRAY) >= 3 * NRAY // 4
  pnt[flat, 2] = rng.uniform(0.3, 0.7, flat.sum())
  pnt[flat, 0] -= 1.0
  vec[flat] = np.c_[np.ones(flat.sum()), 0.3 * rng.randn(flat.sum()),
                    0.1 * rng.randn(flat.sum())]
  return pnt, vec / np.linalg.norm(vec, axis=1, keepdims=True)


SETTINGS = {
    "all": dict(),
    "geomgroup": dict(geomgroup=np.array([1, 0, 1, 0, 1, 1], np.uint8)),
    "movable": dict(flg_static=False),
    "bodyexclude": dict(bodyexclude=True),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_scene_ray_matches_c_and_jax(setting):
  opts = SETTINGS[setting]
  mjm, mjds = _scene()
  group = opts.get("geomgroup")
  static = opts.get("flg_static", True)
  bex = np.full(NRAY, -1)
  if opts.get("bodyexclude"):
    ids = [-1] + [mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_BODY, b)
                  for b in BODIES]
    bex = np.array(ids)[np.arange(NRAY) % len(ids)]
  mp = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(mp, mt.from_jax_arrays(
      mp, {"qpos": np.stack([x.qpos for x in mjds])}))
  pnts, vecs = zip(*[_rays(seed) for seed in range(2)])
  dist, geom = ray.ray(mp, d, torch.tensor(np.stack(pnts)),
                       torch.tensor(np.stack(vecs)), geomgroup=group,
                       flg_static=static, bodyexclude=bex)
  mj = mi.put_model(mjm)
  position = jax.jit(mi.fwd_position)
  casts = {int(b): jax.jit(lambda dj, p, v, b=int(b): jax.vmap(
      lambda p1, v1: jray.ray(mj, dj, p1, v1, geomgroup=group,
                              flg_static=static, bodyexclude=b))(p, v))
           for b in np.unique(bex)}
  hit_types = set()
  for k, mjd in enumerate(mjds):
    c_dist, c_geom = np.zeros(NRAY), np.zeros(NRAY, np.int64)
    gid = np.zeros(1, np.int32)
    for r in range(NRAY):
      c_dist[r] = mujoco.mj_ray(mjm, mjd, pnts[k][r], vecs[k][r], group,
                                int(static), int(bex[r]), gid)
      c_geom[r] = gid[0]
    dj = position(mj, mi.put_data(mj, mjd))
    j_dist, j_geom = [], []
    for b, cast in casts.items():
      sel = np.nonzero(bex == b)[0]
      out = cast(dj, jnp.asarray(pnts[k][sel]), jnp.asarray(vecs[k][sel]))
      j_dist.append((sel, np.asarray(out[0])))
      j_geom.append((sel, np.asarray(out[1])))
    jd, jg = np.zeros(NRAY), np.zeros(NRAY, np.int64)
    for (sel, x), (_, g) in zip(j_dist, j_geom):
      jd[sel], jg[sel] = x, g
    ours, our_geom = dist[k].numpy(), geom[k].numpy()
    np.testing.assert_array_equal(our_geom, c_geom, err_msg=f"lane {k} vs C")
    np.testing.assert_array_equal(our_geom, jg, err_msg=f"lane {k} vs JAX")
    np.testing.assert_allclose(ours, c_dist, rtol=0, atol=1e-9,
                               err_msg=f"lane {k} vs C")
    np.testing.assert_allclose(ours, jd, rtol=0, atol=1e-9,
                               err_msg=f"lane {k} vs JAX")
    hit_types |= set(mjm.geom_type[c_geom[c_geom >= 0]].tolist())
  # every geom type the setting can see is hit by some ray
  want = {int(t) for t in GeomType if t != GeomType.SDF}
  if setting == "geomgroup":
    want -= {GeomType.HFIELD, GeomType.ELLIPSOID, GeomType.CYLINDER}
  if setting == "movable":
    want -= {GeomType.PLANE, GeomType.HFIELD}
  assert hit_types == want, (setting, hit_types)
  assert mp.geom_visible.tolist().count(False) == 2


@pytest.mark.parametrize("flags", [
    dict(flg_vert=0, flg_edge=0, flg_face=1, flg_skin=1),
    dict(flg_vert=0, flg_edge=1, flg_face=0, flg_skin=0),
    dict(flg_vert=1, flg_edge=0, flg_face=0, flg_skin=0),
], ids=["face-skin", "edge", "vert"])
def test_ray_flex_on_the_sheet_matches_c_and_jax(flags):
  """tests/test_ray_flex.py's sheet and rays (12 a flag setting, as one
  fleet of 12 lanes): distance (1e-10) and vertex against C's
  ``mj_rayFlex`` and the JAX package's ``ray_flex``."""
  mjm, mjd, mj, dj = _sheet()
  _check_flex(mjm, mjd, mj, dj, flags, 0, seed=1, z=0.4, spread=0.15,
              tilt=0.2, want_hits=2)


# each flex scene's C and JAX models and states, made once a module
_sheet = functools.lru_cache(test_ray_flex._sheet)


TET = """
<mujoco>
  <worldbody>
    <flexcomp type="grid" count="4 4 4" spacing="0.1 0.1 0.1" radius="0.01"
              name="cube" dim="3" mass="0.3" pos="0 0 0.2">
      <contact selfcollide="none" internal="false"/>
      <edge equality="true"/>
    </flexcomp>
  </worldbody>
</mujoco>
"""


@pytest.mark.parametrize("flags, layer", [
    (dict(flg_vert=0, flg_edge=0, flg_face=1, flg_skin=1), 0),
    (dict(flg_vert=0, flg_edge=0, flg_face=1, flg_skin=0), 1),
    (dict(flg_vert=0, flg_edge=1, flg_face=1, flg_skin=0), 0),
], ids=["skin", "layer1", "edge-face"])
def test_ray_flex_on_a_tet_cube_matches_c_and_jax(flags, layer):
  """A 4 x 4 x 4 tet cube, deformed: its outer faces (under flg_skin), an
  inner layer's faces, and edges with the outer layer's faces."""
  _check_flex(*_tet(), flags, layer, seed=6, z=0.6, spread=0.1, tilt=0.3,
              want_hits=6)


@functools.lru_cache
def _tet():
  mjm = mujoco.MjModel.from_xml_string(TET)
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(5)
  mjd.qpos[:] = mjm.qpos0 + 0.01 * rng.randn(mjm.nq)
  mujoco.mj_forward(mjm, mjd)
  mj = mi.put_model(mjm, dtype=jnp.float64)
  return mjm, mjd, mj, jax.jit(mi.fwd_position)(mj, mi.put_data(mj, mjd))


def _check_flex(mjm, mjd, mj, dj, flags, layer, seed, z, spread, tilt,
                want_hits):
  # the draws of tests/test_ray_flex.py, in its order
  rng = np.random.RandomState(seed)
  n = 12
  pnt, vec = np.zeros((n, 3)), np.zeros((n, 3))
  for r in range(n):
    pnt[r] = [spread * rng.randn(), spread * rng.randn(), z]
    vec[r] = [tilt * rng.randn(), tilt * rng.randn(), -1.0]
  vec /= np.linalg.norm(vec, axis=1, keepdims=True)
  mp = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(mp, mt.from_jax_arrays(
      mp, {"qpos": np.tile(mjd.qpos, (n, 1))}))
  kw = {k: bool(v) for k, v in flags.items()}
  dist, vid = ray.ray_flex(mp, d, 0, torch.tensor(pnt), torch.tensor(vec),
                           flex_layer=layer, **kw)
  cast = jax.jit(jax.vmap(lambda p, v: jray.ray_flex(
      mj, dj, 0, p, v, flex_layer=layer, **kw)))
  jd, jv = (np.asarray(x) for x in cast(jnp.asarray(pnt), jnp.asarray(vec)))
  hits = 0
  for r in range(n):
    vertid = np.zeros(1, np.int32)
    ref = mujoco.mj_rayFlex(mjm, mjd, layer, kw["flg_vert"], kw["flg_edge"],
                            kw["flg_face"], kw["flg_skin"], 0, pnt[r],
                            vec[r], vertid)
    assert float(dist[r]) == pytest.approx(ref, abs=1e-10), r
    assert float(dist[r]) == pytest.approx(float(jd[r]), abs=1e-10), r
    if ref >= 0:
      hits += 1
      assert int(vid[r]) == int(vertid[0]) == int(jv[r]), r
  assert hits >= want_hits


def test_ray_skin_matches_oracle_and_jax():
  """tests/test_ray_flex.py's deformed sheet mesh and rays, as one fleet of
  10 lanes: distance (1e-12) and nearest vertex of the hit triangle
  against its brute-force oracle and the JAX package's ``ray_skin``."""
  rng = np.random.RandomState(2)
  nx, ny = 6, 5
  xs, ys = np.meshgrid(np.linspace(-1, 1, nx), np.linspace(-1, 1, ny))
  vert = np.stack([xs.ravel(), ys.ravel(), 0.1 * rng.randn(nx * ny)], axis=1)
  face = []
  for r in range(ny - 1):
    for c in range(nx - 1):
      a = r * nx + c
      face += [[a, a + 1, a + nx], [a + 1, a + nx + 1, a + nx]]
  face = np.asarray(face)
  pnt, vec = [], []
  for _ in range(10):
    pnt.append([0.8 * rng.randn(), 0.8 * rng.randn(), 2.0])
    v = np.array([0.1 * rng.randn(), 0.1 * rng.randn(), -1.0])
    vec.append(v / np.linalg.norm(v))
  pnt, vec = np.array(pnt), np.array(vec)
  dist, vid = ray.ray_skin(face, torch.tensor(vert).expand(10, -1, -1),
                           torch.tensor(pnt), torch.tensor(vec))
  checked = 0
  for r in range(10):
    ts = np.array([test_ray_flex._np_ray_tri(vert[f], pnt[r], vec[r])
                   for f in face])
    jd, jv = jray.ray_skin(face.astype(np.int32), vert, pnt[r], vec[r])
    assert float(dist[r]) == pytest.approx(float(jd), abs=1e-12)
    if not np.isfinite(ts.min()):
      assert float(dist[r]) == -1.0
      continue
    checked += 1
    assert float(dist[r]) == pytest.approx(ts.min(), abs=1e-12)
    best = face[int(np.argmin(ts))]
    hit = pnt[r] + vec[r] * ts.min()
    near = best[np.argmin(np.linalg.norm(vert[best] - hit, axis=1))]
    assert int(vid[r]) == int(near) == int(jv)
  assert checked >= 3
