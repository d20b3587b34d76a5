"""The flex scenes of the JAX package's tests, vendored for the port.

    python3 scripts/flex_models.py

Writes each scene's XML into the package's ``assets/`` (after a header
that names the test and function it comes from) and its snapshot beside
it.  The scenes are the MJCF strings of ``tests/test_flex.py``,
``tests/test_flex_elem.py``, ``tests/test_flex_self.py`` and
``tests/test_flex_trilinear.py``, copied here so that this script imports
neither the tests nor JAX; ``tests/test_torch_flex.py`` holds the
copies to the tests' strings and the committed files to what this writes.
It also writes ``hammock.xml`` (``hammock_xml``) and its snapshot, with
the model's names, and C's runs of it that ``chip_smoke.py``'s phase 29
holds the port to on the card, which has no ``mujoco``
(``hammock_c_reference``: ``hammock_c.npz``).  Needs ``mujoco`` and no card.  Import it with
``scripts/`` on ``sys.path``.
"""

from __future__ import annotations

import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# tests/test_flex.py::ELAST_XML
ELAST_XML = """
<mujoco>
  <option timestep="0.001"><flag contact="disable"/></option>
  <worldbody>
    <flexcomp name="cloth" type="grid" count="4 4 1" spacing="0.15 0.15 0.15"
              radius="0.02" dim="2" pos="0 0 1" mass="0.5">
      <pin id="0 3"/>
      <elasticity young="50" poisson="0.2" damping="0.02"
                  elastic2d="stretch" thickness="0.01"/>
      <contact selfcollide="none" internal="false"/>
    </flexcomp>
  </worldbody>
</mujoco>
"""

# tests/test_flex_elem.py::_MESH_ASSET
MESH_ASSET = """
    <asset>
      <mesh name="octa" vertex="0.02 0 0  -0.02 0 0  0 0.015 0
                                0 -0.015 0  0 0 0.012  0 0 -0.012"/>
    </asset>
"""


def sheet_xml(extra="", count="5 5 1", spacing="0.08 0.08 0.08",
              radius="0.008", internal=None, pin=True):
  """tests/test_flex_elem.py::_sheet_xml."""
  internal_attr = "" if internal is None else f'internal="{internal}"'
  pins = ('<pin id="0"/><pin id="4"/><pin id="20"/><pin id="24"/>'
          if pin else "")
  return f"""
  <mujoco>
    <option timestep="0.001"/>
    <worldbody>
      <flexcomp type="grid" count="{count}" spacing="{spacing}"
                radius="{radius}" name="sheet" dim="2" mass="0.2">
        <contact selfcollide="none" {internal_attr}/>
        <edge equality="true"/>
        {pins}
      </flexcomp>
      {extra}
    </worldbody>
  </mujoco>
  """


def tet_xml(extra=""):
  """tests/test_flex_elem.py::_tet_xml."""
  return f"""
  <mujoco>
    <option timestep="0.001"/>
    <worldbody>
      <geom type="plane" size="2 2 .1"/>
      <flexcomp type="grid" count="3 3 3" spacing="0.05 0.05 0.05"
                radius="0.005" name="cube" dim="3" mass="0.3"
                pos="0 0 0.2">
        <contact selfcollide="none" internal="true"/>
        <edge equality="true"/>
      </flexcomp>
      {extra}
    </worldbody>
  </mujoco>
  """


def self_sheet_xml(selfcollide="auto", pin=False, count="5 5 1"):
  """tests/test_flex_self.py::_sheet_xml."""
  pins = '<pin id="0"/><pin id="4"/>' if pin else ""
  return f"""
  <mujoco>
    <option timestep="0.001"/>
    <worldbody>
      <geom type="plane" size="2 2 .1"/>
      <flexcomp type="grid" count="{count}" spacing="0.08 0.08 0.08"
                radius="0.008" name="sheet" dim="2" mass="0.2"
                pos="0 0 0.2">
        <contact selfcollide="{selfcollide}" internal="false"/>
        <edge equality="true"/>
        {pins}
      </flexcomp>
    </worldbody>
  </mujoco>
  """


def trilinear_xml(extra="", pos="0 0 0.3", plane=False):
  """tests/test_flex_trilinear.py::_xml."""
  pl = '<geom type="plane" size="2 2 .1"/>' if plane else ""
  return f"""
  <mujoco>
    <option timestep="0.001"/>
    <worldbody>
      {pl}
      <flexcomp type="grid" count="5 5 5" spacing="0.05 0.05 0.05"
                radius="0.005" name="cube" dim="3" mass="0.3" pos="{pos}"
                dof="trilinear">
        <contact selfcollide="none" internal="false"/>
        <edge equality="false"/>
        <elasticity young="5e4" poisson="0.2" damping="0.003"/>
      </flexcomp>
      {extra}
    </worldbody>
  </mujoco>
  """


# each partner test's body (the ``extra`` of its scene), by (test file,
# test function)
EXTRAS = {
    ("test_flex_elem.py", "test_sphere_on_sheet_contact_matches_c"): """
      <body pos="0.04 0.01 0.1">
        <freejoint/>
        <geom type="sphere" size="0.015" mass="0.05"/>
      </body>
  """,
    ("test_flex_elem.py", "test_capsule_on_sheet_settles_like_c"): """
      <body pos="0.04 0.02 0.06">
        <freejoint/>
        <geom type="capsule" size="0.01" fromto="-0.03 0 0 0.03 0 0"
              mass="0.04"/>
      </body>
  """,
    ("test_flex_elem.py", "test_box_on_sheet_settles_like_c"): """
      <body pos="0.04 0.02 0.06">
        <freejoint/>
        <geom type="box" size="0.02 0.015 0.01" mass="0.04"/>
      </body>
  """,
    ("test_flex_elem.py", "test_mesh_on_sheet_settles_like_c"): """
      <body pos="0.04 0.02 0.06">
        <freejoint/>
        <geom type="mesh" mesh="octa" mass="0.04"/>
      </body>
  """,
    ("test_flex_elem.py", "test_cylinder_on_sheet_settles_like_c"): """
      <body pos="0.0 0.0 0.03">
        <freejoint/>
        <geom type="cylinder" size="0.03 0.01" mass="0.03"/>
      </body>
  """,
    ("test_flex_elem.py", "test_ellipsoid_does_not_tunnel_triangle_interior"):
    """
      <body pos="0.04 0.04 0.05">
        <freejoint/>
        <geom type="ellipsoid" size="0.006 0.005 0.004" mass="0.01"/>
      </body>
  """,
    ("test_flex_elem.py", "test_box_on_tet_cube_settles_finite"): """
      <body pos="0.02 0.01 0.35">
        <freejoint/>
        <geom type="box" size="0.02 0.015 0.01" mass="0.05"/>
      </body>
  """,
    ("test_flex_trilinear.py", "test_sphere_rests_on_trilinear_cube"): """
      <body pos="0.02 0.01 0.5">
        <freejoint/>
        <geom type="sphere" size="0.02" mass="0.05"/>
      </body>
  """,
}


def _extra(fn: str) -> str:
  return next(v for (_, f), v in EXTRAS.items() if f == fn)


def _sheet(fn: str, mesh: bool = False) -> str:
  xml = sheet_xml(extra=_extra(fn), internal="false")
  return xml.replace("<worldbody>", MESH_ASSET + "<worldbody>") if mesh else xml


# asset name: (source, the scene's XML)
SCENES = {
    "flex_cloth": ("tests/test_flex.py::ELAST_XML", ELAST_XML),
    "flex_sheet_sphere": (
        "tests/test_flex_elem.py::_sheet_xml(extra, internal=\"false\") with "
        "the body of test_sphere_on_sheet_contact_matches_c",
        _sheet("test_sphere_on_sheet_contact_matches_c")),
    "flex_sheet_capsule": (
        "tests/test_flex_elem.py::_sheet_xml(extra, internal=\"false\") with "
        "the body of test_capsule_on_sheet_settles_like_c",
        _sheet("test_capsule_on_sheet_settles_like_c")),
    "flex_sheet_box": (
        "tests/test_flex_elem.py::_sheet_xml(extra, internal=\"false\") with "
        "the body of test_box_on_sheet_settles_like_c",
        _sheet("test_box_on_sheet_settles_like_c")),
    "flex_sheet_mesh": (
        "tests/test_flex_elem.py::_sheet_xml(extra, internal=\"false\") with "
        "_MESH_ASSET and the body of test_mesh_on_sheet_settles_like_c",
        _sheet("test_mesh_on_sheet_settles_like_c", mesh=True)),
    "flex_sheet_cylinder": (
        "tests/test_flex_elem.py::_sheet_xml(extra, internal=\"false\") with "
        "the body of test_cylinder_on_sheet_settles_like_c",
        _sheet("test_cylinder_on_sheet_settles_like_c")),
    "flex_sheet_ellipsoid": (
        "tests/test_flex_elem.py::_sheet_xml(extra, internal=\"false\") with "
        "the body of test_ellipsoid_does_not_tunnel_triangle_interior",
        _sheet("test_ellipsoid_does_not_tunnel_triangle_interior")),
    "flex_tet_box": (
        "tests/test_flex_elem.py::_tet_xml(extra) with the body of "
        "test_box_on_tet_cube_settles_finite",
        tet_xml(_extra("test_box_on_tet_cube_settles_finite"))),
    "flex_self": ("tests/test_flex_self.py::_sheet_xml()", self_sheet_xml()),
    "flex_trilinear": (
        "tests/test_flex_trilinear.py::_xml(extra, pos=\"0 0 0.16\", "
        "plane=True) with the body of test_sphere_rests_on_trilinear_cube",
        trilinear_xml(_extra("test_sphere_rests_on_trilinear_cube"),
                      pos="0 0 0.16", plane=True)),
}


# the hammock's sheet: an 11 x 11 grid 0.1 apart (1 m square) at z = 0,
# its two edges x = -0.5 (vertices 0-10) and x = 0.5 (110-120) pinned
HAMMOCK_PINS = tuple(range(11)) + tuple(range(110, 121))
HAMMOCK_SHEET = f"""
    <flexcomp type="grid" count="11 11 1" spacing="0.1 0.1 0.1"
              radius="0.01" name="hammock" dim="2" mass="2">
      <contact selfcollide="none" internal="false"/>
      <edge equality="true"/>
      <pin id="{' '.join(map(str, HAMMOCK_PINS))}"/>
    </flexcomp>
"""


def hammock_xml() -> str:
  """The hammock: the package's ``assets/humanoid.xml`` (dm_control's
  humanoid: Newton, pyramidal cone, EULER at 0.005 s) with its floor
  lowered to z = -1 and ``HAMMOCK_SHEET`` (``sheet_xml``'s pinned
  edge-equality sheet, grown to 11 x 11) under it.  nv = 27 + 99 free
  vertices x 3 = 324, nu = 21.  Written for this repository on the pattern
  of MuJoCo's ``model/hammock/hammock.xml`` (BASELINE config 5), which is
  not in it."""
  from mujoco_inversedynamicstest_tpu_torch import asset_path

  text = asset_path("humanoid.xml").read_text()
  body = text[text.index("<mujoco"):]
  floor = '<geom name="floor" type="plane" conaffinity="1" size="100 100 .2"/>'
  assert body.count(floor) == 1
  body = body.replace('<mujoco model="humanoid">', '<mujoco model="hammock">')
  body = body.replace(floor, floor[:-2] + ' pos="0 0 -1"/>\n'
                      + HAMMOCK_SHEET.rstrip())
  header = text[:text.index("-->")].rstrip()
  return (header + "\n\nThe hammock: this file with its floor at z = -1 and "
          "an 11 x 11 flexcomp sheet,\npinned along x = -0.5 and x = 0.5, "
          "under the humanoid (scripts/flex_models.py:\nhammock_xml).  "
          "Written for this repository on the pattern of MuJoCo's\n"
          "model/hammock/hammock.xml (BASELINE config 5), which is not in "
          "it, from\ntests/test_flex_elem.py's pinned sheet and dm_control's "
          "humanoid.\n-->\n" + body)


# C's steps from reset to the resting state of phase 29's fleet (2 s), and
# the steps after first contact at which qpos is recorded
HAMMOCK_REST_STEPS = 400
HAMMOCK_CONTACT_STEPS = (10, 50)


def hammock_c_reference(mjm) -> dict:
  """C MuJoCo's runs of the hammock ``mjm`` (fp64), for the card: the
  state after ``HAMMOCK_REST_STEPS`` steps from reset, the humanoid
  resting in the sheet (``rest_*``); ``mj_forward`` at reset with contacts
  disabled (``reset_qacc``, ``reset_flexvert_xpos``); the first state
  with a contact, stepping from reset (``contact_*``), and qpos after
  each of ``HAMMOCK_CONTACT_STEPS`` more steps (``contact_qpos<k>``)."""
  import mujoco
  import numpy as np

  state = ("qpos", "qvel", "act", "qacc_warmstart")
  out = {}
  mjd = mujoco.MjData(mjm)
  for _ in range(HAMMOCK_REST_STEPS):
    mujoco.mj_step(mjm, mjd)
  out.update({f"rest_{k}": getattr(mjd, k).copy() for k in state})
  out["rest_ncon"] = np.array(mjd.ncon)
  free = copy.copy(mjm)
  free.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONTACT
  mjd = mujoco.MjData(free)
  mujoco.mj_forward(free, mjd)
  out["reset_qacc"] = mjd.qacc.copy()
  out["reset_flexvert_xpos"] = mjd.flexvert_xpos.copy()
  mjd = mujoco.MjData(mjm)
  while mjd.ncon == 0:
    mujoco.mj_step(mjm, mjd)
  out.update({f"contact_{k}": getattr(mjd, k).copy() for k in state})
  out["contact_time"] = np.array(mjd.time)
  for k in range(1, max(HAMMOCK_CONTACT_STEPS) + 1):
    mujoco.mj_step(mjm, mjd)
    if k in HAMMOCK_CONTACT_STEPS:
      out[f"contact_qpos{k}"] = mjd.qpos.copy()
  return out


def vendored(name: str) -> str:
  """The text of the vendored ``assets/<name>.xml``."""
  source, xml = SCENES[name]
  return (f"<!--\nSource: {source}, the JAX package's test of this scene "
          "(this repository).\n-->\n" + xml.strip() + "\n")


def main() -> None:
  import mujoco
  import numpy as np

  import mujoco_inversedynamicstest_tpu_torch as mt

  for name in SCENES:
    path = mt.asset_path(f"{name}.xml")
    path.write_text(vendored(name))
    mt.save_model_snapshot(mujoco.MjModel.from_xml_path(str(path)),
                           mt.asset_path(f"{name}.npz"))
    print(f"wrote {path} and its snapshot")
  path = mt.asset_path("hammock.xml")
  path.write_text(hammock_xml())
  mjm = mujoco.MjModel.from_xml_path(str(path))
  mt.save_model_snapshot(mjm, mt.asset_path("hammock.npz"), names=True)
  np.savez(mt.asset_path("hammock_c.npz"), **hammock_c_reference(mjm))
  print(f"wrote {path}, its snapshot and hammock_c.npz")


if __name__ == "__main__":
  main()
