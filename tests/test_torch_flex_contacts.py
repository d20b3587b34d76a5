"""Flex element contacts of closed form in the PyTorch port (spheres,
capsules and boxes against cloth and cable elements; internal
element-vertex pairs), in float64 on the CPU, against the JAX package and
C MuJoCo: at states where each kind has active slots, every active slot's
dist, pos, frame, weighted bodies and parameters within 1e-9 of the JAX
package's (``flex_cases.check_contacts``), the active sets equal, and
qacc within 1e-9 of max|qacc| of the JAX package's; the sphere on the
sheet also against C (``test_flex_elem.py::
test_sphere_on_sheet_contact_matches_c``'s 1e-6).
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import numpy as np

from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType

import flex_cases as fc
from flex_cases import flex_models


def test_sphere_on_sheet_matches_jax_and_c():
  mjm = fc.scene("flex_sheet_sphere")
  mjd = fc.dropped(mjm, 400)
  m, d, dj = fc.both(mjm, mjd)
  mujoco.mj_forward(mjm, mjd)
  assert mjd.ncon > 0
  assert fc.check_contacts(d, dj) > 0
  assert fc.qacc_error(d, dj.qacc) < 1e-9
  assert fc.qacc_error(d, mjd.qacc) < 1e-6


def test_capsule_and_box_on_sheet_match_jax():
  for name, gtype in (("flex_sheet_capsule", GeomType.CAPSULE),
                      ("flex_sheet_box", GeomType.BOX)):
    mjm = fc.scene(name)
    m, d, dj = fc.both(mjm, fc.dropped(mjm, 300))
    slots = fc.group_slots(m, "geom_elem", gtype)
    assert fc.check_contacts(d, dj, slots=slots) >= 2, name
    assert fc.check_contacts(d, dj) > 0
    assert fc.qacc_error(d, dj.qacc) < 1e-9, name


CABLE = """
<mujoco>
  <option timestep="0.001"/>
  <worldbody>
    <flexcomp type="grid" count="12 1 1" spacing="0.03 0.03 0.03"
              radius="0.01" name="cable" dim="1" mass="0.1">
      <contact selfcollide="none" internal="false"/>
      <edge equality="true"/>
      <pin id="0 11"/>
    </flexcomp>
    <body pos="-0.1 0.0 0.04"><freejoint/>
      <geom type="sphere" size="0.02" mass="0.05"/></body>
    <body pos="0.0 0.0 0.04"><freejoint/>
      <geom type="capsule" size="0.01" fromto="-0.03 0.01 0 0.03 -0.01 0"
            mass="0.04"/></body>
    <body pos="0.1 0.0 0.04" euler="10 20 30"><freejoint/>
      <geom type="box" size="0.02 0.015 0.01" mass="0.04"/></body>
  </worldbody>
</mujoco>
"""


def test_cable_partners_match_jax():
  """A sphere, a capsule and a box on a cable (dim-1 elements: segment
  closest points, the box's barycentric descent)."""
  mjm = fc.model(CABLE)
  mjd = fc.dropped(mjm, 150)
  m, d, dj = fc.both(mjm, mjd)
  for gtype in (GeomType.SPHERE, GeomType.CAPSULE, GeomType.BOX):
    slots = fc.group_slots(m, "geom_elem", gtype)
    assert fc.check_contacts(d, dj, slots=slots) >= 1, gtype.name
  assert fc.qacc_error(d, dj.qacc) < 1e-9


def _touching_evpairs(mjm, count: int):
  """The sheet with the vertices of ``count`` element-vertex pairs moved
  over their elements, 1.5 radii above the element's centre: the first
  pairs whose vertex is not pinned and which share no vertex with an
  earlier one."""
  mjd = mujoco.MjData(mjm)
  mujoco.mj_forward(mjm, mjd)
  radius = float(mjm.flex_radius[0])
  elem = np.asarray(mjm.flex_elem).reshape(-1, 3)
  pairs, used = [], set()
  for e, v in np.asarray(mjm.flex_evpair).reshape(-1, 2):
    verts = {int(v)} | set(elem[e].tolist())
    if mjm.body_jntnum[mjm.flex_vertbodyid[v]] and not verts & used:
      pairs.append((e, v))
      used |= verts
  for e, v in pairs[:count]:
    target = mjd.flexvert_xpos[elem[e]].mean(0)
    target[2] += 1.5 * radius
    adr = mjm.jnt_qposadr[mjm.body_jntadr[mjm.flex_vertbodyid[v]]]
    mjd.qpos[adr:adr + 3] += target - mjd.flexvert_xpos[v]
  return mjd


def test_internal_evpairs_match_jax():
  mjm = fc.model(flex_models.sheet_xml(internal="true"))
  assert mjm.flex_internal[0] and mjm.nflexevpair
  m, d, dj = fc.both(mjm, _touching_evpairs(mjm, 3))
  slots = fc.group_slots(m, "evpair")
  assert fc.check_contacts(d, dj, slots=slots) >= 3
  assert fc.qacc_error(d, dj.qacc) < 1e-9
