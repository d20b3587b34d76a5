"""The engine-plugin and SDF-plugin scenes, vendored for the port.

    python3 scripts/plugin_models.py

Writes each scene's XML into the package's ``assets/`` (after a header
that names where it comes from) and its snapshot beside it.  Each scene
is the MJCF of a JAX package test, at the width that test gives it,
copied here so that this script imports neither the tests nor JAX:
``tests/test_plugins.py``'s cable (8 segments), PID with slew limit
(``kp 30 ki 20 kd 1 imax 4 slewmax 8``, two activations) and touch grid
(7 x 5 taxels, fov 45 x 30, 3 channels), ``tests/test_sdf_plugins.py``'s
sphere on the torus, torus on the torus and ball in the bowl, and
``tests/test_sdflib.py``'s sphere on the mesh-SDF cube (compiled through
the port's sdflib stub, ``models.io.compile_mjcf``).
``tests/test_torch_plugins.py`` holds the copies to the tests' MJCF and
the committed files to what this writes.  Needs ``mujoco`` and no card.
Import it with ``scripts/`` on ``sys.path``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


# tests/test_plugins.py::_cable_xml()
def cable_xml(twist="4e6", bend="8e6", curve="s", count=9):
  return f"""
  <mujoco>
    <option timestep="0.002" gravity="0 0 -9.81"/>
    <extension><plugin plugin="mujoco.elasticity.cable"/></extension>
    <worldbody>
      <composite type="cable" curve="{curve}" count="{count} 1 1" size="1"
                 offset="0 0 1" initial="none">
        <plugin plugin="mujoco.elasticity.cable">
          <config key="twist" value="{twist}"/>
          <config key="bend" value="{bend}"/>
        </plugin>
        <joint kind="main" damping="0.05"/>
        <geom type="capsule" size=".005" density="1000"/>
      </composite>
    </worldbody>
  </mujoco>
  """


# tests/test_plugins.py::_pid_xml
def pid_xml(kp="40", ki="", kd="", imax="", slewmax="", actdim=0):
  cfg = "".join(
      f'<config key="{k}" value="{v}"/>'
      for k, v in (("kp", kp), ("ki", ki), ("kd", kd), ("imax", imax),
                   ("slewmax", slewmax)) if v)
  dim = f' actdim="{actdim}"' if actdim else ""
  return f"""
  <mujoco>
    <option timestep="0.002"/>
    <extension><plugin plugin="mujoco.pid">
      <instance name="pid0">{cfg}</instance>
    </plugin></extension>
    <worldbody>
      <body pos="0 0 1">
        <joint name="j" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0" mass="0.5"/>
      </body>
    </worldbody>
    <actuator>
      <plugin plugin="mujoco.pid" instance="pid0" joint="j"{dim}/>
    </actuator>
  </mujoco>
  """


# tests/test_plugins.py::_touch_grid_xml
def touch_grid_xml(size="3 3", fov="60 60", gamma="0", nchannel="1",
                   drop=0.06):
  return f"""
  <mujoco>
    <option timestep="0.002"/>
    <extension><plugin plugin="mujoco.sensor.touch_grid">
      <instance name="tg">
        <config key="size" value="{size}"/>
        <config key="fov" value="{fov}"/>
        <config key="gamma" value="{gamma}"/>
        <config key="nchannel" value="{nchannel}"/>
      </instance>
    </plugin></extension>
    <worldbody>
      <body pos="0.01 -0.02 {0.1 - drop}">
        <joint type="slide" axis="0 0 1" damping="1"/>
        <joint type="slide" axis="1 0 0" damping="1"/>
        <geom type="sphere" size="0.1" mass="1" friction="0.8"/>
        <site name="s" pos="0 0 -0.02" size="0.01"/>
      </body>
      <geom type="plane" size="2 2 0.1"/>
    </worldbody>
    <sensor>
      <plugin plugin="mujoco.sensor.touch_grid" instance="tg"
              objtype="site" objname="s"/>
    </sensor>
  </mujoco>
  """


# tests/test_sdf_plugins.py::_torus_scene
def torus_scene(extra=""):
  return f"""
  <mujoco>
    <extension>
      <plugin plugin="mujoco.sdf.torus">
        <instance name="torus">
          <config key="radius1" value="0.35"/>
          <config key="radius2" value="0.15"/>
        </instance>
      </plugin>
    </extension>
    <asset><mesh name="torus"><plugin instance="torus"/></mesh></asset>
    <option sdf_iterations="10" sdf_initpoints="40"/>
    <worldbody>
      <body pos="0 0 0.5" euler="90 0 0">
        <geom type="sdf" mesh="torus" name="t">
          <plugin instance="torus"/>
        </geom>
      </body>
      {extra}
    </worldbody>
  </mujoco>
  """


# tests/test_sdf_plugins.py::test_sphere_on_torus_settles_like_c
SPHERE_ON_TORUS = """
      <body pos="0 0 1.2">
        <freejoint/>
        <geom type="sphere" size="0.1" mass="0.3"/>
      </body>
  """

# tests/test_sdf_plugins.py::test_sdf_sdf_pair_loads_and_runs
TORUS_ON_TORUS = """
      <body pos="0 0.02 1.3" euler="90 0 0">
        <freejoint/>
        <geom type="sdf" mesh="torus" mass="0.4">
          <plugin instance="torus"/>
        </geom>
      </body>
  """

# tests/test_sdf_plugins.py::test_ball_in_bowl_settles_like_c
BOWL = """
  <mujoco>
    <extension>
      <plugin plugin="mujoco.sdf.bowl">
        <instance name="bowl">
          <config key="height" value="0.4"/>
          <config key="radius" value="1.0"/>
          <config key="thickness" value="0.02"/>
        </instance>
      </plugin>
    </extension>
    <asset><mesh name="bowl"><plugin instance="bowl"/></mesh></asset>
    <option sdf_iterations="10" sdf_initpoints="40"/>
    <default><geom solref="0.01 1" solimp=".95 .99 .0001" condim="1"/></default>
    <worldbody>
      <body pos="0 0 1">
        <geom type="sdf" name="bowl" mesh="bowl">
          <plugin instance="bowl"/>
        </geom>
      </body>
      <body pos=".2 -.1 2.2">
        <freejoint/>
        <geom type="sphere" size=".15" mass="0.2"/>
      </body>
    </worldbody>
  </mujoco>
  """

# tests/test_sdflib.py::_XML
SDFLIB = """
<mujoco>
  <extension>
    <plugin plugin="mujoco.sdf.sdflib">
      <instance name="sdf"><config key="aabb" value="0"/></instance>
    </plugin>
  </extension>
  <asset>
    <mesh name="cube" vertex="0.1 0.1 0.1  0.1 0.1 -0.1  0.1 -0.1 0.1
                              0.1 -0.1 -0.1  -0.1 0.1 0.1  -0.1 0.1 -0.1
                              -0.1 -0.1 0.1  -0.1 -0.1 -0.1">
      <plugin instance="sdf"/>
    </mesh>
  </asset>
  <option sdf_iterations="20" sdf_initpoints="16"/>
  <worldbody>
    <geom type="sdf" mesh="cube"><plugin instance="sdf"/></geom>
    <body pos="0.0 0.0 0.3"><freejoint/>
      <geom type="sphere" size="0.05" mass="0.1"/></body>
  </worldbody>
</mujoco>
"""

# asset name: (source, the scene's XML)
SCENES = {
    "plugin_cable": ("tests/test_plugins.py::_cable_xml(), the JAX "
                     "package's test", cable_xml()),
    "plugin_pid": ("tests/test_plugins.py::_pid_xml(kp='30', ki='20', "
                   "kd='1', imax='4', slewmax='8', actdim=2), the JAX "
                   "package's test", pid_xml(kp="30", ki="20", kd="1",
                                             imax="4", slewmax="8",
                                             actdim=2)),
    "plugin_touch_grid": ("tests/test_plugins.py::_touch_grid_xml(size='7 "
                          "5', fov='45 30', nchannel='3'), the JAX "
                          "package's test", touch_grid_xml(
                              size="7 5", fov="45 30", nchannel="3")),
    "sdf_torus": ("tests/test_sdf_plugins.py::_torus_scene with "
                  "test_sphere_on_torus_settles_like_c's sphere, the JAX "
                  "package's test", torus_scene(SPHERE_ON_TORUS)),
    "sdf_torus_pair": ("tests/test_sdf_plugins.py::_torus_scene with "
                       "test_sdf_sdf_pair_loads_and_runs's torus, the JAX "
                       "package's test", torus_scene(TORUS_ON_TORUS)),
    "sdf_bowl": ("tests/test_sdf_plugins.py::"
                 "test_ball_in_bowl_settles_like_c, the JAX package's test",
                 BOWL),
    "sdflib_cube": ("tests/test_sdflib.py::_XML, the JAX package's test",
                    SDFLIB),
}


def vendored(name: str) -> str:
  """The text of the vendored ``assets/<name>.xml``."""
  source, xml = SCENES[name]
  return f"<!--\nSource: {source} (this repository).\n-->\n" + xml.strip(
  ) + "\n"


def snapshot_arrays(name: str) -> dict:
  """The snapshot arrays of the vendored scene, compiled from its XML."""
  from mujoco_inversedynamicstest_tpu_torch.models import io

  return io.compile_mjcf(str(io.asset_path(f"{name}.xml")))[1]


def main() -> None:
  import numpy as np

  import mujoco_inversedynamicstest_tpu_torch as mt

  for name in SCENES:
    path = mt.asset_path(f"{name}.xml")
    path.write_text(vendored(name))
    np.savez_compressed(mt.asset_path(f"{name}.npz"),
                        **snapshot_arrays(name))
    print(f"wrote {path} and its snapshot")


if __name__ == "__main__":
  main()
