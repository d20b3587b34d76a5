"""The port's mesh-SDF bridge (``mujoco.sdf.sdflib``), its voxel grid and
the clearance descent's kernels, against the JAX package, in float64 on
the CPU.

The wheel ships no SdfLib plugin, so there is no C oracle (as in
``tests/test_sdflib.py``): the grid of a cube mesh against the analytic
box distance and bit-equal to the JAX package's grid; the cube scene's
snapshot (``assets/sdflib_cube``) grid equal to the JAX package's
instance's built from the same compiled mesh; the sphere-cube narrowphase
at four poses against the JAX package's (``jax.jit`` of a ``vmap`` of the
one pair); ``_sdf_pair_kernel`` on one pair; and the stub's sharing of
C's plugin table with the JAX package's, whichever registers first (two
fresh processes).  The scene's compile through the stub and the sphere
at rest on the cube are ``tests/test_torch_sdflib_scene.py``'s (a
compile's marching cubes call the stub a million times).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import copy
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import collision_sdf as jcsdf
from mujoco_inversedynamicstest_tpu.ops import meshsdf as jmeshsdf
from mujoco_inversedynamicstest_tpu_torch.ops import collision, collision_sdf
from mujoco_inversedynamicstest_tpu_torch.ops import meshsdf

import test_sdflib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid_args(g):
  return (torch.as_tensor(g.values.ravel()), g.values.shape) + tuple(
      torch.as_tensor(a) for a in (g.lo, g.spacing, g.box_center,
                                   g.box_half))


def test_voxel_grid_matches_analytic_cube_and_jax():
  """The cube mesh's grid: sampled at 200 points within 1.5 voxel
  diagonals of the analytic box distance (the JAX package's test and
  limit), its values bit-equal to the JAX package's grid, and the
  samples' gradient (written out) against jax.grad of the JAX sampler."""
  verts, faces = test_sdflib._cube_mesh(0.1)
  g = meshsdf.mesh_sdf_grid(verts, faces, res=48)
  jg = jmeshsdf.mesh_sdf_grid(verts, faces, res=48)
  for k in g._fields:
    np.testing.assert_array_equal(getattr(g, k), getattr(jg, k), err_msg=k)
  pts = (np.random.RandomState(0).rand(200, 3) - 0.5) * 0.36
  q = np.abs(pts) - 0.1
  analytic = (np.linalg.norm(np.maximum(q, 0.0), axis=1)
              + np.minimum(q.max(axis=1), 0.0))
  value, grad = meshsdf.sample_grid_and_grad(*_grid_args(g),
                                             torch.as_tensor(pts))
  vox = float(np.linalg.norm(g.spacing))
  assert np.all(np.abs(value.numpy() - analytic) < 1.5 * vox)
  jargs = tuple(jnp.asarray(a) for a in (jg.values, jg.lo, jg.spacing,
                                         jg.box_center, jg.box_half))
  ref = jax.vmap(lambda p: jmeshsdf.sample_grid(*jargs, p))(jnp.asarray(pts))
  np.testing.assert_allclose(value.numpy(), np.asarray(ref), rtol=0,
                             atol=1e-12)
  far = pts * 2.5          # half of them outside the box: the excess
  jgrad = jax.vmap(jax.grad(lambda p: jmeshsdf.sample_grid(*jargs, p)))
  for x in (pts, far):
    _, grad = meshsdf.sample_grid_and_grad(*_grid_args(g), torch.as_tensor(x))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad(
        jnp.asarray(x))), rtol=0, atol=1e-9)


def _jax_model(f, tinst):
  """What the JAX package's make_plugin_narrowphase reads of a model, from
  the port's snapshot arrays, with a JAX package SdfLibInstance holding the
  port's instance's grid (the JAX package's own build of this 39,342-
  vertex mesh's grid takes 18 s; the two packages' grid functions are
  held bit-equal on the cube mesh above, and the snapshot to the port's
  build by ``tests/test_torch_sdflib_scene.py``)."""
  from mujoco_inversedynamicstest_tpu.plugins import sdflib as jsdflib

  inst = jsdflib.SdfLibInstance.__new__(jsdflib.SdfLibInstance)
  inst._values = jnp.asarray(tinst._values.reshape(tinst.shape))
  inst._lo, inst._spacing = jnp.asarray(tinst._lo), jnp.asarray(
      tinst._spacing)
  inst._center, inst._half = jnp.asarray(tinst._center), jnp.asarray(
      tinst._half)
  inst._aabb = (tinst._center, tinst._half)
  return types.SimpleNamespace(
      plugin_hooks=(inst,), geom_plugin_np=np.asarray(f["geom_plugin"]),
      geom_dataid=np.asarray(f["geom_dataid"]),
      mesh_pos_np=np.asarray(f["mesh_pos"]).reshape(-1, 3),
      mesh_quat_np=np.asarray(f["mesh_quat"]).reshape(-1, 4),
      geom_aabb_np=np.asarray(f["geom_aabb"]).reshape(-1, 6))


def test_snapshot_grid_and_narrowphase_match_jax():
  """The cube scene's sdflib instance holds its snapshot's grid (which
  ``tests/test_torch_sdflib_scene.py`` holds to a fresh build from the
  compiled mesh); the sphere-cube narrowphase at four poses (the sphere
  on, into and beside the cube) slot by slot against the JAX package's on
  that grid: distance, point, normal to 1e-9."""
  with np.load(mt.asset_path("sdflib_cube.npz")) as z:
    f = {k: z[k] for k in z.files}
  mp = mt.put_model(f, device="cpu")
  tinst = mp.plugin_hooks[0]
  np.testing.assert_array_equal(tinst._values, f["plugin_grid_values"])
  np.testing.assert_array_equal(tinst.shape, f["plugin_grid_shape"][0])
  np.testing.assert_array_equal(np.concatenate(
      [tinst._lo, tinst._spacing, tinst._center, tinst._half]),
      f["plugin_grid_frame"][0])
  mj = _jax_model(f, tinst)
  jinst = mj.plugin_hooks[0]
  grp = collision.contact_layout(mp).groups[0]
  assert (int(grp.types[0]), int(grp.types[1])) == (2, 8)
  rng = np.random.RandomState(5)
  p1 = np.c_[0.03 * rng.randn(4, 2), 0.148 - 0.01 * rng.rand(4)]
  p1[3] = (0.13, 0.02, 0.05)
  g1, g2 = int(grp.geom1[0]), int(grp.geom2[0])
  s1, s2 = (np.asarray(f["geom_size"])[g] for g in (g1, g2))
  eye = np.eye(3)

  def jax_narrowphase(values, p):
    # the grid an argument, not a constant the compile would fold
    inst = copy.copy(jinst)
    inst._values = values
    jfn = jcsdf.make_plugin_narrowphase(types.SimpleNamespace(
        **{**vars(mj), "plugin_hooks": (inst,)}), grp)
    return jax.vmap(lambda q: jfn(q, jnp.asarray(eye), jnp.asarray(s1),
                                  jnp.zeros(3), jnp.asarray(eye),
                                  jnp.asarray(s2), 0.0))(p)

  ref = jax.jit(jax_narrowphase)(jinst._values, jnp.asarray(p1))
  t = torch.as_tensor
  fn = collision._group_narrowphase(mp, grp)
  got = fn(t(p1)[:, None], t(eye).expand(4, 1, 3, 3), mp.geom_size[[g1]],
           torch.zeros(4, 1, 3, dtype=torch.float64),
           t(eye).expand(4, 1, 3, 3), mp.geom_size[[g2]], t([0.0]))
  rd, gd = np.asarray(ref[0]), got[0][:, 0].numpy()
  active = rd < 1e9
  assert active[:3].any(axis=1).all(), rd
  np.testing.assert_array_equal(gd < 1e9, active)
  np.testing.assert_allclose(gd[active], rd[active], rtol=0, atol=1e-9)
  for k in (1, 2):
    np.testing.assert_allclose(got[k][:, 0].numpy()[active],
                               np.asarray(ref[k])[active], rtol=0, atol=1e-9)


def test_sdf_pair_kernel_matches_jax():
  """The clearance descent over two primitives (a sphere and an
  ellipsoid), on no path of either package's collision, against the JAX
  package's ``_sdf_pair_kernel`` on one pair: three inits, each slot's
  distance, point and normal to 1e-9."""
  p1, p2 = np.array([0.0, 0.0, 0.0]), np.array([0.15, 0.05, 0.2])
  m1 = np.eye(3)
  m2 = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]])
  s1, s2 = np.array([0.1, 0.0, 0.0]), np.array([0.1, 0.15, 0.2])
  offsets = np.array([[0.0, 0.0, 0.0], [0.02, -0.01, 0.0],
                      [-0.01, 0.0, 0.03]])

  def jinits(p1, m1, s1, p2, m2, s2):
    return 0.5 * (p1 + p2)[None] + jnp.asarray(offsets)

  def tinits(p1, m1, s1, p2, m2, s2):
    return 0.5 * (p1 + p2)[..., None, :] + torch.as_tensor(offsets)

  ref = jax.jit(jcsdf._sdf_pair_kernel(2, 4, jinits))(
      *(jnp.asarray(a) for a in (p1, m1, s1, p2, m2, s2)), 0.01)
  t = lambda a: torch.as_tensor(a)[None, None]
  got = collision_sdf._sdf_pair_kernel(2, 4, tinits)(
      t(p1), t(m1), torch.as_tensor(s1)[None], t(p2), t(m2),
      torch.as_tensor(s2)[None], torch.tensor([0.01], dtype=torch.float64))
  assert np.any(np.asarray(ref[0]) < 0.01)
  for k in range(3):
    np.testing.assert_allclose(got[k][0, 0].numpy(), np.asarray(ref[k]),
                               rtol=0, atol=1e-9, err_msg=str(k))


_SHARE = """
import ctypes, sys
import numpy as np
sys.path.insert(0, {repo!r})
from mujoco_inversedynamicstest_tpu.plugins import sdflib as jax_sdflib
from mujoco_inversedynamicstest_tpu_torch.ops import meshsdf
from mujoco_inversedynamicstest_tpu_torch.plugins import registry, sdflib

lib = registry.host_library()
lib.mjp_getPluginAtSlot.restype = ctypes.POINTER(sdflib._MjpPlugin)
lib.mjp_getPluginAtSlot.argtypes = [ctypes.c_int]


def entries():
  return [p for p in map(lib.mjp_getPluginAtSlot,
                         range(lib.mjp_pluginCount()))
          if p.contents.name == b"mujoco.sdf.sdflib"]


def served(point):
  # what the compiler's sdf_staticdistance of the named entry returns
  (entry,) = entries()
  fn = sdflib._SDFSTATIC(entry.contents.sdf_staticdistance)
  return fn((ctypes.c_double * 3)(*point), (ctypes.c_double * 1)(0.0))


cube = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                 for z in (-1, 1)], float)
faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
grids = {{"port": meshsdf.mesh_sdf_grid(0.1 * cube, faces, res=12),
         "jax": meshsdf.mesh_sdf_grid(0.2 * cube, faces, res=12)}}
ctx = {{"port": sdflib.host_compile_grid,
       "jax": jax_sdflib.host_compile_grid}}
point = (0.05, 0.01, -0.02)
for side in [{order}]:
  with ctx[side](grids[side]):
    assert len(entries()) == 1, len(entries())
    want = sdflib._HostGrid(grids[side]).sample(point)
    assert abs(served(point) - want) < 1e-12, (side, served(point), want)
  assert len(entries()) <= 1, len(entries())
print("ok")
"""


def test_stub_shares_the_plugin_table_with_jax():
  """C's plugin table is global to the process: with the JAX package's
  stub registered first, and with the port's first, inside each package's
  compile context C's ``mujoco.sdf.sdflib`` entry serves that package's
  grid, and at no time is more than one such entry registered (fresh
  processes, one order each; two different grids tell the packages
  apart)."""
  for order in ('"jax", "port", "jax", "port"',
                '"port", "port", "jax", "port", "jax"'):
    code = _SHARE.format(repo=REPO, order=order)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0 and "ok" in out.stdout, (order, out.stdout,
                                                        out.stderr[-3000:])
