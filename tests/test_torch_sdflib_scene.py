"""The mesh-SDF cube scene (``assets/sdflib_cube``, ``tests/
test_sdflib.py::_XML``) compiled through the port's host stub, in float64
on the CPU.

``models.io.compile_mjcf`` compiles the XML with the port's sdflib stub
(the compiler's marching cubes call it a million times: about 25 s), the
arrays equal the committed snapshot's, and the model ``put_model`` makes
of them is ``load_model``'s: two geoms, the SDF backed by the sdflib
instance.  Then the sphere dropped on the cube rests at the analytic
height (the JAX package's test and limit).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import os
import sys

import numpy as np
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch.models import io

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import plugin_models  # noqa: E402


def test_compiles_through_the_stub_as_committed():
  """The vendored XML compiles through the port's stub into the committed
  snapshot's arrays, each equal; the model loads with its sdflib
  instance."""
  assert (mt.asset_path("sdflib_cube.xml").read_text()
          == plugin_models.vendored("sdflib_cube"))
  _, fresh = io.compile_mjcf(str(mt.asset_path("sdflib_cube.xml")))
  with np.load(mt.asset_path("sdflib_cube.npz")) as committed:
    assert sorted(committed.files) == sorted(fresh)
    for k in committed.files:
      np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
  m = mt.put_model(fresh, device="cpu")
  assert m.ngeom == 2 and [h.name for h in m.plugin_hooks] == [
      "mujoco.sdf.sdflib"]


def test_sphere_rests_on_sdflib_cube():
  """The sphere dropped on the cube rests at the analytic height, the cube's
  top 0.1 plus the radius 0.05, within 0.015 (the JAX package's test)."""
  m = mt.put_model(mt.asset_path("sdflib_cube.npz"), device="cpu")
  d = mt.step_n(m, mt.make_data(m, 1), 500)
  assert torch.isfinite(d.qpos).all()
  assert abs(float(d.qpos[0, 2]) - 0.15) < 0.015, float(d.qpos[0, 2])
