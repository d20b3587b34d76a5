"""The flex scenes of the JAX package's tests, vendored for the port.

    python3 scripts/flex_models.py

Writes each scene's XML into the package's ``assets/`` (after a header
that names the test and function it comes from) and its snapshot beside
it.  The scenes are the MJCF strings of ``tests/test_flex.py``,
``tests/test_flex_elem.py``, ``tests/test_flex_self.py`` and
``tests/test_flex_trilinear.py``, copied here so that this script imports
neither the tests nor JAX; ``tests/test_torch_flex.py`` holds the
copies to the tests' strings and the committed files to what this writes.
Needs ``mujoco`` and no card.  Import it with ``scripts/`` on
``sys.path``.
"""

from __future__ import annotations

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


def vendored(name: str) -> str:
  """The text of the vendored ``assets/<name>.xml``."""
  source, xml = SCENES[name]
  return (f"<!--\nSource: {source}, the JAX package's test of this scene "
          "(this repository).\n-->\n" + xml.strip() + "\n")


def main() -> None:
  import mujoco

  import mujoco_inversedynamicstest_tpu_torch as mt

  for name in SCENES:
    path = mt.asset_path(f"{name}.xml")
    path.write_text(vendored(name))
    mt.save_model_snapshot(mujoco.MjModel.from_xml_path(str(path)),
                           mt.asset_path(f"{name}.npz"))
    print(f"wrote {path} and its snapshot")


if __name__ == "__main__":
  main()
