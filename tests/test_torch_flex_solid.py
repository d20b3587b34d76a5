"""Flex element contacts of the PyTorch port on solids, trilinear cubes and
folded cloth, in float64 on the CPU, against the JAX package and C
MuJoCo: a box, a sphere and a capsule on a dim-3 tet cube (the volumetric
SAT manifold, rounded tetrahedra), the within-tet face-vertex contacts of
a crushed cube (``test_flex_elem.py::test_tetface_contacts_match_c_forward``,
also against C at its 1e-6), the plane and a sphere on the trilinear cube
(node-weight rows), and a folded sheet's self-collision.  At each state
every active slot is held to the JAX package's within 1e-9
(``flex_cases.check_contacts``), and qacc within 1e-9 of max|qacc|.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import numpy as np

from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType

import flex_cases as fc
from flex_cases import flex_models
import test_flex_self


def test_box_on_tet_cube_matches_jax():
  mjm = fc.scene("flex_tet_box")
  m, d, dj = fc.both(mjm, fc.dropped(mjm, 250))
  slots = fc.group_slots(m, "geom_elem", GeomType.BOX)
  assert fc.check_contacts(d, dj, slots=slots) >= 4
  assert fc.check_contacts(d, dj) > 0
  assert fc.qacc_error(d, dj.qacc) < 1e-9


def test_sphere_and_capsule_on_tet_cube_match_jax():
  extra = """
      <body pos="-0.02 0.0 0.3"><freejoint/>
        <geom type="sphere" size="0.015" mass="0.05"/></body>
      <body pos="0.03 0.02 0.3"><freejoint/>
        <geom type="capsule" size="0.01" fromto="-0.02 0 0 0.02 0 0"
              mass="0.04"/></body>
  """
  mjm = fc.model(flex_models.tet_xml(extra))
  m, d, dj = fc.both(mjm, fc.dropped(mjm, 200))
  for gtype in (GeomType.SPHERE, GeomType.CAPSULE):
    slots = fc.group_slots(m, "geom_elem", gtype)
    assert fc.check_contacts(d, dj, slots=slots) >= 1, gtype.name
  assert fc.qacc_error(d, dj.qacc) < 1e-9


def _crushed(mjm, scale: float = None):
  """``test_tetface_contacts_match_c_forward``'s state (the vertices'
  slide offsets, 0 at qpos0, times 0.3, plus 1 mm of seeded noise); with
  ``scale``, the cube flattened about its mid-height to that fraction of
  its height first."""
  rng = np.random.RandomState(0)
  mjd = mujoco.MjData(mjm)
  mjd.qpos[:] = mjm.qpos0
  mujoco.mj_forward(mjm, mjd)
  mid = mjd.flexvert_xpos[:, 2].mean()
  for v in range(mjm.nflexvert):
    adr = mjm.jnt_qposadr[mjm.body_jntadr[mjm.flex_vertbodyid[v]]]
    mjd.qpos[adr + 2] *= 0.3
    if scale is not None:
      mjd.qpos[adr + 2] += (scale - 1) * (mjd.flexvert_xpos[v, 2] - mid)
    mjd.qpos[adr:adr + 3] += 0.001 * rng.randn(3)
  return mjd


def test_tetface_contacts_match_jax_and_c():
  """At the JAX test's state against C, as the JAX test holds it;
  flattened to 0.1 of its height, where the tetrahedra are flatter than
  twice the radius and their face-vertex contacts act, against the JAX
  package and C."""
  mjm = fc.model(flex_models.tet_xml())
  mjd = _crushed(mjm)
  m, d, _ = fc.both(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  assert fc.qacc_error(d, mjd.qacc) < 1e-6
  mjd = _crushed(mjm, 0.1)
  m, d, dj = fc.both(mjm, mjd)
  assert fc.check_contacts(d, dj, slots=fc.group_slots(m, "tetface")) >= 4
  assert fc.check_contacts(d, dj) > 0
  assert fc.qacc_error(d, dj.qacc) < 1e-9
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0 and fc.qacc_error(d, mjd.qacc) < 1e-9


def test_trilinear_cube_on_plane_with_sphere_matches_jax():
  mjm = fc.scene("flex_trilinear")
  m, d, dj = fc.both(mjm, fc.dropped(mjm, 300))
  assert d.contact.bary_w.shape[-1] == 8
  assert fc.check_contacts(d, dj, slots=fc.group_slots(m, "plane_vert")) >= 4
  slots = fc.group_slots(m, "geom_elem", GeomType.SPHERE)
  assert fc.check_contacts(d, dj, slots=slots) >= 1
  assert fc.qacc_error(d, dj.qacc) < 1e-9


def test_folded_sheet_self_contacts_match_jax():
  """``test_flex_self.py``'s folded sheet: element-element contacts of the
  runtime-budgeted candidate pairs (each lane its nearest by bounding
  distance, lower pair first in a tie): the active slots compared as a
  set, since candidates at equal bounding distance, in the last bit, may
  come in either order."""
  mjm = fc.scene("flex_self")
  m, d, dj = fc.both(mjm, test_flex_self._folded_state(mjm)[0])
  slots = fc.group_slots(m, "selfpair")
  assert fc.check_contacts(d, dj, slots=slots, as_set=True) >= 4
  assert fc.qacc_error(d, dj.qacc) < 1e-9
