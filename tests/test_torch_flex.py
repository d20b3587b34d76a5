"""Flex kinematics, edge rows and passive forces of the PyTorch port, in
float64 on the CPU, against the JAX package and C MuJoCo:

* ``smooth.flex`` (vertex positions, edge lengths and Jacobians) and the
  FLEX equality rows on ``tests/test_flex.py``'s GRID_XML, qacc within
  1e-9 of max|qacc| of the JAX package's and C's, a 100-step trajectory
  against C and the inverse of the forward;
* the element elasticity with its Rayleigh damping (ELAST_XML) and the
  edge spring-dampers (a cable), qfrc_passive against both;
* the trilinear flex of ``tests/test_flex_trilinear.py``: vertex
  positions against C (1e-12), the nodal elasticity's forces against the
  JAX package's (1e-9 of their max) and qacc against C (1e-6, the JAX
  test's tolerance);
* every vendored flex scene (``scripts/flex_models.py``) is its JAX test's
  MJCF, its snapshot is what ``save_model_snapshot`` writes, and
  ``put_model`` gives the same Model from either without ``mujoco``;
* ``put_model`` refuses, by name, each flex feature the port does not
  compute.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import inspect
import re
import sys

import jax
import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
import test_flex
import test_flex_elem
import test_flex_self
import test_flex_trilinear

import flex_cases as fc
from flex_cases import flex_models


def test_grid_kinematics_and_edge_rows_match_jax_and_c():
  mjm = fc.model(test_flex.GRID_XML)
  mjd = fc.perturbed(mjm, 0.02, 0)
  m, d, dj = fc.both(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  np.testing.assert_allclose(d.flexvert_xpos[0].numpy(), mjd.flexvert_xpos,
                             rtol=0, atol=1e-12)
  np.testing.assert_allclose(d.flexedge_length[0].numpy(),
                             mjd.flexedge_length, rtol=0, atol=1e-12)
  np.testing.assert_allclose(d.flexedge_J[0].numpy(),
                             np.asarray(dj.flexedge_J), rtol=0, atol=1e-12)
  # one row a non-rigid edge, in C's order
  assert d.efc_J.shape[1] == mjd.nefc == m.flex.nedge
  np.testing.assert_allclose(d.efc_J[0].numpy(), np.asarray(dj.efc_J),
                             rtol=0, atol=1e-12)
  np.testing.assert_allclose(d.efc_pos[0].numpy(), mjd.efc_pos, rtol=0,
                             atol=1e-12)
  assert fc.qacc_error(d, dj.qacc) < 1e-9
  assert fc.qacc_error(d, mjd.qacc) < 1e-9


def test_grid_trajectory_and_inverse():
  mjm = fc.model(test_flex.GRID_XML)
  mjd = mujoco.MjData(mjm)
  m = mt.put_model(mjm, device="cpu")
  d = mt.make_data(m, 1)
  for _ in range(100):
    mujoco.mj_step(mjm, mjd)
    d = mt.step(m, d)
  assert np.abs(d.qpos[0].numpy() - mjd.qpos).max() < 1e-10
  assert np.abs(d.qvel[0].numpy() - mjd.qvel).max() < 1e-8
  # the inverse of the forward gives back the applied force (none)
  rng = np.random.RandomState(0)
  d = mt.forward(m, d.replace(qvel=torch.as_tensor(0.1 * rng.randn(1, m.nv))))
  assert float(mt.inverse(m, d).qfrc_inverse.abs().max()) < 1e-8


def test_cloth_elasticity_matches_jax_and_c():
  mjm = fc.model(test_flex.ELAST_XML)
  mjd = fc.perturbed(mjm, 0.02, 1)
  m, d, dj = fc.both(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  assert m.flex.has_elasticity and not m.flex.has_edge_sd
  np.testing.assert_allclose(d.qfrc_passive[0].numpy(),
                             np.asarray(dj.qfrc_passive), rtol=0, atol=1e-10)
  np.testing.assert_allclose(d.qfrc_passive[0].numpy(), mjd.qfrc_passive,
                             rtol=0, atol=1e-10)
  assert fc.qacc_error(d, dj.qacc) < 1e-9
  assert fc.qacc_error(d, mjd.qacc) < 1e-9


CABLE_SD = """
<mujoco>
  <option timestep="0.001"><flag contact="disable"/></option>
  <worldbody>
    <flexcomp type="grid" count="6 1 1" spacing="0.05 0.05 0.05" radius="0.01"
              name="cable" dim="1" mass="0.1">
      <edge stiffness="40" damping="0.3"/>
      <pin id="0"/>
    </flexcomp>
  </worldbody>
</mujoco>
"""


def test_edge_spring_damper_matches_jax_and_c():
  mjm = fc.model(CABLE_SD)
  mjd = fc.perturbed(mjm, 0.02, 2)
  m, d, dj = fc.both(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  assert m.flex.has_edge_sd
  for ref in (np.asarray(dj.qfrc_passive), mjd.qfrc_passive):
    np.testing.assert_allclose(d.qfrc_passive[0].numpy(), ref, rtol=0,
                               atol=1e-10)
  assert fc.qacc_error(d, dj.qacc) < 1e-9
  assert fc.qacc_error(d, mjd.qacc) < 1e-9


def test_trilinear_vertices_and_nodal_forces():
  mjm = fc.model(test_flex_trilinear._xml())
  mjd = fc.perturbed(mjm, 0.015, 3)
  m, d, dj = fc.both(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  assert m.flex.has_nodal_elasticity and m.ngeom == m.ngeom_mj
  np.testing.assert_allclose(d.flexvert_xpos[0].numpy(), mjd.flexvert_xpos,
                             rtol=0, atol=1e-12)
  ref = np.asarray(dj.qfrc_passive)
  assert np.abs(d.qfrc_passive[0].numpy() - ref).max() < 1e-9 * np.abs(
      ref).max()
  assert fc.qacc_error(d, dj.qacc) < 1e-9
  # the JAX test's tolerance against C
  assert fc.qacc_error(d, mjd.qacc) < 1e-6


def _test_source(module, fn: str) -> str:
  return inspect.getsource(getattr(module, fn))


@pytest.mark.parametrize("key", sorted(flex_models.EXTRAS))
def test_vendored_bodies_are_the_jax_tests(key):
  """Each partner body the script copies is its JAX test's ``extra``."""
  module = {"test_flex_elem.py": test_flex_elem,
            "test_flex_trilinear.py": test_flex_trilinear}[key[0]]
  src = _test_source(module, key[1])
  extra = re.search(r'extra = """(.*?)"""', src, re.S).group(1)
  assert extra == flex_models.EXTRAS[key]


def test_vendored_scenes_are_the_jax_tests():
  """The script's copies of the JAX tests' scene builders give their
  MJCF."""
  e = lambda fn: flex_models._extra(fn)
  assert flex_models.ELAST_XML == test_flex.ELAST_XML
  assert flex_models.MESH_ASSET == test_flex_elem._MESH_ASSET
  for extra in ("", e("test_box_on_sheet_settles_like_c")):
    assert flex_models.sheet_xml(extra, internal="false") == (
        test_flex_elem._sheet_xml(extra, internal="false"))
  assert flex_models.tet_xml(e("test_box_on_tet_cube_settles_finite")) == (
      test_flex_elem._tet_xml(e("test_box_on_tet_cube_settles_finite")))
  assert flex_models.self_sheet_xml() == test_flex_self._sheet_xml()
  sphere = e("test_sphere_rests_on_trilinear_cube")
  assert flex_models.trilinear_xml(sphere, pos="0 0 0.16", plane=True) == (
      test_flex_trilinear._xml(sphere, pos="0 0 0.16", plane=True))


@pytest.mark.parametrize("name", sorted(flex_models.SCENES))
def test_flex_snapshot_is_current_and_loads(name, tmp_path, monkeypatch):
  """The committed XML and snapshot are what the script writes, and
  put_model gives the same Model from the snapshot, without mujoco, as
  from the MjModel."""
  assert mt.asset_path(f"{name}.xml").read_text() == flex_models.vendored(
      name)
  mjm = fc.scene(name)
  fresh = tmp_path / "snap.npz"
  mt.save_model_snapshot(mjm, fresh)
  with np.load(mt.asset_path(f"{name}.npz")) as committed, np.load(
      fresh) as written:
    assert sorted(committed.files) == sorted(written.files)
    for k in written.files:
      np.testing.assert_array_equal(committed[k], written[k], err_msg=k)
  from_mjmodel = mt.put_model(mjm, device="cpu")
  monkeypatch.setitem(sys.modules, "mujoco", None)
  from_snapshot = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
  for a, b in ((from_mjmodel, from_snapshot),
               (from_mjmodel.flex, from_snapshot.flex)):
    for field in a.__dataclass_fields__:
      x, y = getattr(a, field), getattr(b, field)
      if isinstance(x, torch.Tensor):
        assert torch.equal(x, y), field
      elif isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=field)
  assert from_snapshot.flex.nvert == mjm.nflexvert
  assert from_snapshot.ngeom_mj == mjm.ngeom


def _flex(attrs="", inner="", extra="", opt="", after=""):
  return f"""<mujoco><option timestep="0.001">{opt}</option><worldbody>
  <flexcomp name="f" type="grid" count="3 3 1" spacing="0.1 0.1 0.1"
            radius="0.01" dim="2" {attrs}>{inner}</flexcomp>{extra}
  </worldbody>{after}</mujoco>"""


_SOLID = ('type="grid" count="3 3 3" spacing="0.05 0.05 0.05" radius="0.005" '
          'dim="3" name="g" pos="0 0 1"')
_NOCONTACT = '<contact internal="false" selfcollide="none"/>'
_BALL = '<body pos="0 0 0.2"><freejoint/><geom size="0.02"{}/>{}</body>'

REFUSED = {
    "bend": (_flex(inner='<elasticity young="50" poisson="0.2" '
                   'elastic2d="bend" thickness="0.01"/>'),
             'flex bending elasticity'),
    "both": (_flex(inner='<elasticity young="50" poisson="0.2" '
                   'elastic2d="both" thickness="0.01"/>'),
             'flex bending elasticity'),
    "mixed": (_flex(inner=_NOCONTACT, extra=f'<flexcomp {_SOLID} '
                    f'dof="trilinear">{_NOCONTACT}</flexcomp>'),
              "mixed trilinear and vertex-dof flexes"),
    "quadratic": (f'<mujoco><worldbody><flexcomp {_SOLID} dof="quadratic">'
                  f'{_NOCONTACT}</flexcomp></worldbody></mujoco>',
                  "flex interpolation order beyond trilinear"),
    "trilinear edge equality": (
        f'<mujoco><worldbody><flexcomp {_SOLID} dof="trilinear">'
        f'{_NOCONTACT}<edge equality="true"/></flexcomp></worldbody>'
        '</mujoco>', "edge equality on a trilinear flex"),
    "margin": (_flex(inner='<contact margin="0.01" internal="false" '
                     'selfcollide="none"/>'), "flex contact margin"),
    "gap": (_flex(inner='<contact gap="0.005" internal="false" '
                  'selfcollide="none"/>'), "flex contact gap"),
    "touch": (_flex(inner=_NOCONTACT, extra=_BALL.format(
        "", '<site name="s" size="0.03"/>'),
                    after='<sensor><touch site="s"/></sensor>'),
              "sensor type TOUCH with flex contacts"),
    "energy": (_flex(inner=_NOCONTACT, opt='<flag energy="enable"/>'),
               "the ENERGY flag with flexes"),
    "flexvert": (_flex(inner=_NOCONTACT,
                       after='<equality><flexvert flex="f"/></equality>'),
                 "FLEXVERT equality"),
    "flexstrain": (_flex(inner=_NOCONTACT,
                         after='<equality><flexstrain flex="f"/></equality>'),
                   "FLEXSTRAIN equality"),
    "partner margin": (_flex(inner=_NOCONTACT, extra=_BALL.format(
        ' margin="0.01"', "")),
                       "a contact margin or gap on a geom that collides "
                       "with a flex"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_put_model_refuses_unported_flex_features(case):
  xml, what = REFUSED[case]
  mjm = fc.model(xml)
  with pytest.raises(NotImplementedError, match=re.escape(what)):
    mt.put_model(mjm, device="cpu")
