"""The transmission and sensor-tail scenes, vendored for the port.

    python3 scripts/sensor_tail_models.py

Writes each scene's XML into the package's ``assets/`` (after a header
that names where it comes from) and its snapshot beside it.  Four scenes
are the MJCF strings of the JAX package's tests (``tests/
test_transmission.py``: SLIDERCRANK, REFSITE, ADHESION;
``tests/test_sensor_tail.py``: SCENE), copied here so that this script
imports neither the tests nor JAX; two are the port's own: cameras of
every mode with the sensors that read them, and the limit sensors on
``limited.xml``'s joints and a limited tendon.
``tests/test_torch_sensor_tail.py`` holds the copies to the tests' strings
and the committed files to what this writes.  Needs ``mujoco`` and no
card.  Import it with ``scripts/`` on ``sys.path``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# tests/test_transmission.py::SLIDERCRANK
SLIDERCRANK = """
<mujoco><option timestep="0.002"/>
<worldbody>
  <body name="crank" pos="0 0 0.5">
    <joint name="hinge" type="hinge" axis="0 1 0" damping="0.1"/>
    <geom type="capsule" size="0.02" fromto="0 0 0 0.15 0 0" mass="0.3"/>
    <site name="cranksite" pos="0.15 0 0"/></body>
  <body name="slider" pos="0.4 0 0.5">
    <joint type="slide" axis="1 0 0" damping="0.2"/>
    <geom type="box" size="0.04 0.02 0.02" mass="0.2"/>
    <site name="slidersite" euler="0 90 0"/></body>
</worldbody>
<actuator><general cranksite="cranksite" slidersite="slidersite"
  cranklength="0.3" gear="2"/></actuator>
</mujoco>"""

# tests/test_transmission.py::REFSITE
REFSITE = """
<mujoco><option timestep="0.002"/>
<worldbody>
  <site name="ref" pos="0.1 0 0.9" euler="0 20 0"/>
  <body pos="0 0 1"><joint type="hinge" axis="0 1 0" damping="0.1"/>
    <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.4"/>
    <body pos="0.2 0 0"><joint type="slide" axis="0 0 1" damping="0.1"/>
      <geom type="box" size="0.02 0.02 0.02" mass="0.1"/>
      <site name="s" euler="10 0 0"/></body></body>
</worldbody>
<actuator><position site="s" refsite="ref" kp="3" gear="1 0.5 0 0.2 0 1"/>
</actuator>
</mujoco>"""

# tests/test_transmission.py::ADHESION
ADHESION = """
<mujoco><option timestep="0.002"/>
<worldbody>
  <geom type="plane" size="1 1 .1"/>
  <body name="gripper" pos="0 0 0.099"><freejoint/>
    <geom type="sphere" size="0.1" mass="0.5"/></body>
</worldbody>
<actuator><adhesion body="gripper" ctrlrange="0 5" gain="10"/></actuator>
</mujoco>"""

# tests/test_sensor_tail.py::SCENE
SCENE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body pos="0 0 0.5">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1" mass="1"/>
      <site name="tip" pos="0 0 -0.05" type="sphere" size="0.06"/>
      <site name="rf" pos="0 0 0" euler="180 0 0"/>
    </body>
    <body pos="0.5 0 0.2"><freejoint/>
      <geom name="box2" type="box" size="0.1 0.1 0.1" mass="0.5"/></body>
  </worldbody>
  <sensor>
    <touch site="tip"/>
    <rangefinder site="rf"/>
    <distance geom1="ball" geom2="box2" cutoff="3"/>
    <normal geom1="ball" geom2="box2" cutoff="3"/>
    <fromto geom1="ball" geom2="box2" cutoff="3"/>
  </sensor>
</mujoco>"""

# cameras of every mode on a swinging arm, with the sensors that read them:
# a projection, and frame sensors on cameras (objects and references)
CAMS = """
<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body name="b" pos="0 0 0.5">
      <joint type="ball" damping="0.05"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="0.4"/>
      <site name="tip" pos="0.3 0 0"/>
      <camera name="fixedcam" pos="0.1 0.2 0.1" euler="30 0 0"/>
      <body pos="0.3 0 0">
        <joint type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="sphere" size="0.04" mass="0.2"/>
        <camera name="tip" mode="track" pos="0 -0.4 0.1" euler="80 0 0"/>
      </body>
    </body>
    <camera name="trackcom" mode="trackcom" target="b" pos="1 1 1"/>
    <camera name="tgt" mode="targetbody" target="b" pos="1.5 0 1"/>
    <camera name="tgtcom" mode="targetbodycom" target="b" pos="-1 0.5 1.2"/>
    <camera name="proj" pos="0 -1.5 0.5" euler="90 0 0"
            resolution="640 480" fovy="45"/>
    <camera name="lens" pos="0.2 -1.5 0.6" euler="90 0 0"
            resolution="320 240" sensorsize="0.004 0.003"
            focal="0.003 0.0035"/>
  </worldbody>
  <sensor>
    <camprojection site="tip" camera="proj"/>
    <camprojection site="tip" camera="lens"/>
    <framepos objtype="camera" objname="fixedcam"/>
    <framequat objtype="camera" objname="fixedcam"/>
    <framexaxis objtype="camera" objname="tgt"/>
    <framezaxis objtype="camera" objname="tgtcom"/>
    <framepos objtype="camera" objname="tip" reftype="camera" refname="tgt"/>
    <framequat objtype="camera" objname="trackcom"/>
    <framequat objtype="camera" objname="tgt"/>
    <framelinvel objtype="camera" objname="fixedcam"/>
    <frameangvel objtype="camera" objname="tip" reftype="camera"
                 refname="fixedcam"/>
    <framelinacc objtype="camera" objname="fixedcam"/>
  </sensor>
</mujoco>"""

# limited.xml's hinge, slide and ball limits and a limited tendon over the
# hinge and the slide, with the limit sensors of each
LIMITS = """
<mujoco>
  <option timestep="0.002"><flag contact="disable"/></option>
  <worldbody>
    <body pos="0 0 0.6">
      <joint name="h" type="hinge" axis="0 1 0" range="-25 35" margin="0.01"
             damping="0.02"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0" mass="0.5"/>
      <body pos="0.25 0 0">
        <joint name="s" type="slide" axis="0 0 1" range="-0.08 0.12"/>
        <geom type="box" size="0.03 0.03 0.03" mass="0.2"/>
      </body>
      <body pos="-0.15 0 0">
        <joint name="bl" type="ball" range="0 40"/>
        <geom type="capsule" size="0.015" fromto="0 0 0 0 0 -0.15" mass="0.25"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t" limited="true" range="-0.1 0.15" margin="0.02">
      <joint joint="h" coef="0.3"/><joint joint="s" coef="1"/>
    </fixed>
  </tendon>
  <actuator><motor joint="h" gear="1"/></actuator>
  <sensor>
    <jointlimitpos joint="h"/>
    <jointlimitvel joint="h"/>
    <jointlimitfrc joint="h"/>
    <jointlimitpos joint="s"/>
    <jointlimitvel joint="s"/>
    <jointlimitfrc joint="s"/>
    <jointlimitpos joint="bl"/>
    <jointlimitfrc joint="bl"/>
    <tendonlimitpos tendon="t"/>
    <tendonlimitvel tendon="t"/>
    <tendonlimitfrc tendon="t"/>
  </sensor>
</mujoco>"""

# asset name: (source, the scene's XML)
SCENES = {
    "transmission_slidercrank": ("tests/test_transmission.py::SLIDERCRANK, "
                                 "the JAX package's test", SLIDERCRANK),
    "transmission_refsite": ("tests/test_transmission.py::REFSITE, the JAX "
                             "package's test", REFSITE),
    "transmission_adhesion": ("tests/test_transmission.py::ADHESION, the JAX "
                              "package's test", ADHESION),
    "sensor_tail": ("tests/test_sensor_tail.py::SCENE, the JAX package's "
                    "test", SCENE),
    "sensor_cams": ("scripts/sensor_tail_models.py::CAMS: cameras of every "
                    "mode and the sensors that read them", CAMS),
    "sensor_limits": ("scripts/sensor_tail_models.py::LIMITS: limited.xml's "
                      "joints and a limited tendon, with their limit "
                      "sensors", LIMITS),
}


def vendored(name: str) -> str:
  """The text of the vendored ``assets/<name>.xml``."""
  source, xml = SCENES[name]
  return f"<!--\nSource: {source} (this repository).\n-->\n" + xml.strip(
  ) + "\n"


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
