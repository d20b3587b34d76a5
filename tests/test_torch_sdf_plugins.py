"""The port's analytic SDF plugin geoms and their collider, against C and
the JAX package, in float64 on the CPU.

Each shape's distance against C's own ``sdf_staticdistance`` (the wheel
ships the plugins; ctypes, as ``tests/test_sdf_plugins.py`` calls them) at
200 points; its gradient against ``jax.grad`` of the JAX package's shape;
the sphere on the torus and the torus on the torus (``assets/sdf_*``):
every contact slot (distance, point, normal) and qacc of one ``forward``
at four states in contact against the JAX package's ``forward`` (one
``jax.jit`` of a ``vmap`` a scene; the ball in the bowl is
``tests/test_torch_sdf_rest.py``'s); each shape's box against the JAX
package's instance; the vendored plugin scenes (``scripts/
plugin_models.py``) against the JAX tests' MJCF, the committed files
against what the script writes, each loading without ``mujoco``.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import ctypes
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.plugins import sdf as jsdf
from mujoco_inversedynamicstest_tpu_torch.plugins import sdf as tsdf

import test_plugins
import test_sdf_plugins
import test_sdflib
import test_torch_plugins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import plugin_models  # noqa: E402

SHAPES = [
    ("mujoco.sdf.torus", "TorusInstance", (0.35, 0.15)),
    ("mujoco.sdf.torus", "TorusInstance", (0.5, 0.05)),
    ("mujoco.sdf.bowl", "BowlInstance", (0.4, 1.0, 0.02)),
    ("mujoco.sdf.bowl", "BowlInstance", (0.2, 0.6, 0.05)),
    ("mujoco.sdf.bolt", "BoltInstance", (0.26,)),
    ("mujoco.sdf.nut", "NutInstance", (0.26,)),
    ("mujoco.sdf.gear", "GearInstance", (0.0, 2.8, 25.0, 0.2, -1.0)),
    ("mujoco.sdf.gear", "GearInstance", (0.1, 1.6, 16.0, 0.3, 0.4)),
]


def _points(inst, seed, n=200, grow=1.3, pad=0.1):
  center, half = inst.aabb()
  rng = np.random.RandomState(seed)
  return center + (2.0 * rng.rand(n, 3) - 1.0) * (half * grow + pad)


@pytest.mark.parametrize("name,cls,attr", SHAPES)
def test_sdf_distance_matches_c(name, cls, attr):
  """The port's distance at 200 points against C's sdf_staticdistance, to
  1e-9 (the JAX package's test and tolerance)."""
  cfn = test_sdf_plugins._c_staticdistance(name)
  assert cfn is not None, f"{name} not in the host engine"
  inst = getattr(tsdf, cls).with_attr(attr)
  pts = _points(inst, 0)
  ours = inst.sdf(torch.as_tensor(pts)).numpy()
  c_attr = (ctypes.c_double * len(attr))(*attr)
  ref = np.array([cfn((ctypes.c_double * 3)(*p), c_attr) for p in pts])
  np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9, err_msg=name)
  value, _ = inst.sdf_and_grad(torch.as_tensor(pts))
  np.testing.assert_allclose(value.numpy(), ours, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,cls,attr", SHAPES)
def test_sdf_gradient_matches_jax(name, cls, attr):
  """sdf_and_grad's gradient (written out for the torus and the bowl,
  torch.func for the others) against jax.grad of the JAX package's shape
  at 200 points, to 1e-9.  A point within 1e-9 of a kink of the shape (a
  tie of a maximum, |.| at 0, a floor's step, where the JAX package's
  own jitted and op-by-op gradients may part) would be held to both; the
  seeded points have none: every point is compared."""
  inst = getattr(tsdf, cls).with_attr(attr)
  jinst = test_sdf_plugins._make_instance(getattr(jsdf, cls), attr)
  pts = _points(inst, 1, grow=1.0, pad=0.05)
  ref = np.asarray(jax.jit(jax.vmap(jax.grad(jinst.sdf)))(jnp.asarray(pts)))
  _, got = inst.sdf_and_grad(torch.as_tensor(pts))
  np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9,
                             err_msg=name)
  assert np.isfinite(got.numpy()).all()
  c_ref, h_ref = jinst.aabb()
  c_got, h_got = inst.aabb()
  np.testing.assert_array_equal(c_got, c_ref)
  np.testing.assert_array_equal(h_got, h_ref)


def _states(name, mjm, rng, n=4):
  """qpos of ``n`` states in contact: the sphere on the torus's top, the
  free torus crossing the fixed one at its top (rings at right angles),
  the ball near the bowl's bottom."""
  qpos = np.tile(mjm.qpos0, (n, 1))
  if name == "sdf_torus":
    qpos[:, :3] = np.c_[0.01 * rng.randn(n, 2), 1.085 + 0.005 * rng.rand(n)]
  elif name == "sdf_torus_pair":
    qpos[:, :3] = np.c_[0.02 * rng.randn(n, 2), 1.49 - 0.01 * rng.rand(n)]
    # ring in the y-z plane: the x axis turned 90 degrees about z, then
    # about x as the fixed one's
    quat = np.zeros(4)
    mujoco.mju_euler2Quat(quat, np.deg2rad([90, 0, 90]), "xyz")
    tilt = 0.05 * rng.randn(n, 3)
    for k in range(n):
      q = quat.copy()
      mujoco.mju_quatIntegrate(q, tilt[k], 1.0)
      qpos[k, 3:7] = q
  else:
    qpos[:, :3] = np.c_[0.05 * rng.randn(n, 2), 0.166 - 0.004 * rng.rand(n)]
  return qpos


@pytest.mark.parametrize("name", ["sdf_torus", "sdf_torus_pair"])
def test_forward_contacts_match_jax(name):
  check_forward_contacts(name)


def check_forward_contacts(name):
  """One forward at four states in contact: every active contact slot's
  distance, point and normal, and qacc, against the JAX package's forward
  (one jit of a vmap), to 1e-9 (qacc to 1e-9 of max|qacc|); inactive slots
  inactive in both."""
  mjm = mujoco.MjModel.from_xml_string(plugin_models.SCENES[name][1])
  mj = mi.put_model(mjm)
  mp = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  qpos = _states(name, mjm, np.random.RandomState(3))
  ref = jax.jit(jax.vmap(lambda q: mi.forward(mj, mi.make_data(mj).replace(
      qpos=q))))(jnp.asarray(qpos))
  got = mt.forward(mp, mt.make_data(mp, len(qpos)).replace(
      qpos=torch.as_tensor(qpos)))
  rd, gd = np.asarray(ref.contact.dist), got.contact.dist.numpy()
  active = rd < 1e9
  assert active.any(axis=1).all(), "a state without contact"
  np.testing.assert_array_equal(gd < 1e9, active)
  np.testing.assert_allclose(gd[active], rd[active], rtol=0, atol=1e-9)
  np.testing.assert_allclose(got.contact.pos.numpy()[active],
                             np.asarray(ref.contact.pos)[active], rtol=0,
                             atol=1e-9)
  np.testing.assert_allclose(got.contact.frame.numpy()[..., 0, :][active],
                             np.asarray(ref.contact.frame)[..., 0, :][active],
                             rtol=0, atol=1e-9)
  qacc = np.asarray(ref.qacc)
  np.testing.assert_allclose(got.qacc.numpy(), qacc, rtol=0,
                             atol=1e-9 * np.abs(qacc).max())


def test_vendored_scenes_are_current():
  """The script's copies equal the JAX tests' MJCF; every committed XML is
  what the script writes and every snapshot what it writes of it (the
  sdflib cube's compile is ``tests/test_torch_sdflib_scene.py``'s); each
  of the seven snapshots loads where ``mujoco`` cannot be imported."""
  pm = plugin_models
  assert pm.cable_xml() == test_plugins._cable_xml()
  for cfg in test_torch_plugins.PID_CASES:
    assert pm.pid_xml(**cfg) == test_plugins._pid_xml(**cfg)
  for cfg in test_torch_plugins.TOUCH_CASES:
    assert pm.touch_grid_xml(**cfg) == test_plugins._touch_grid_xml(**cfg)
  assert pm.torus_scene("x") == test_sdf_plugins._torus_scene("x")
  src = inspect.getsource(test_sdf_plugins)
  for text in (pm.SPHERE_ON_TORUS, pm.TORUS_ON_TORUS, pm.BOWL):
    assert text in src
  assert pm.SDFLIB == test_sdflib._XML
  for name in pm.SCENES:
    assert mt.asset_path(f"{name}.xml").read_text() == pm.vendored(name)
    if name == "sdflib_cube":
      continue
    fresh = pm.snapshot_arrays(name)
    with np.load(mt.asset_path(f"{name}.npz")) as committed:
      assert sorted(committed.files) == sorted(fresh)
      for k in committed.files:
        np.testing.assert_array_equal(committed[k], fresh[k],
                                      err_msg=f"{name} {k}")
  code = ("import sys; sys.modules['mujoco'] = None; "
          f"sys.path.insert(0, {REPO!r}); "
          "import mujoco_inversedynamicstest_tpu_torch as mt; "
          f"names = {sorted(pm.SCENES)!r}; "
          "ms = [mt.put_model(mt.asset_path(n + '.npz'), device='cpu') "
          "for n in names]; "
          "print('ok', [[h.name for h in m.plugin_hooks] for m in ms])")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
  assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]


_SHAPE_SCENE = """<mujoco><extension><plugin plugin="mujoco.sdf.{p}">
<instance name="s"/></plugin></extension>
<asset><mesh name="s"><plugin instance="s"/></mesh></asset>
<worldbody><geom type="sdf" mesh="s"><plugin instance="s"/></geom>
<body pos="{x} 0 {z}"><freejoint/><geom type="sphere" size="0.1" mass="0.3"/>
</body></worldbody></mujoco>"""


@pytest.mark.parametrize("plugin,x,z", [("bolt", 0.0, -0.3),
                                        ("nut", 0.42, -0.25),
                                        ("gear", 1.35, 0.1)])
def test_put_model_accepts_bolt_nut_gear(plugin, x, z):
  """A sphere overlapping the bolt's shaft, the nut's head and the gear's
  teeth (C's plugins at their default attributes): put_model accepts each
  scene, and one forward fills the four slots with finite contacts and a
  finite qacc."""
  mjm = mujoco.MjModel.from_xml_string(_SHAPE_SCENE.format(p=plugin, x=x,
                                                           z=z))
  m = mt.put_model(mjm, device="cpu")
  assert [h.name for h in m.plugin_hooks] == [f"mujoco.sdf.{plugin}"]
  d = mt.forward(m, mt.make_data(m, 1))
  active = d.contact.dist < d.contact.includemargin
  assert int(active.sum()) == 4
  assert torch.isfinite(d.contact.pos[active]).all()
  assert torch.isfinite(d.qacc).all()
