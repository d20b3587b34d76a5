"""dm_control's swimmer, fish, acrobot, cartpole and pendulum, and the
quadruped with its rangefinders, for the port.

    python3 scripts/dm_suite_models.py

Writes each model's XML into the package's ``assets/`` (``stripped`` of
the task module's ``get_model_and_assets()`` output, or of
``quadruped.make_model``'s, after a header that names its source) and its
snapshot beside it.  The tests hold the committed files to what this
writes (``tests/test_torch_suite.py``,
``tests/test_torch_quadruped_rangefinder.py``).
Needs ``mujoco``, ``dm_control`` and ``lxml``, and no card.  Import it with
``scripts/`` on ``sys.path``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# asset name: (dm_control.suite module, get_model_and_assets arguments, the
# tasks that run the model)
MODELS = {
    "swimmer6": ("swimmer", (6,), "swimmer6"),
    "swimmer15": ("swimmer", (15,), "swimmer15"),
    "fish": ("fish", (), "upright and swim"),
    "acrobot": ("acrobot", (), "swingup and swingup_sparse"),
    "cartpole": ("cartpole", (), "balance and swingup, with their sparse "
                 "forms"),
    "pendulum": ("pendulum", (), "swingup"),
}

# asset name: quadruped.make_model's arguments, and the task whose sensors
# they give
QUADRUPEDS = {
    "quadruped_rangefinder": (dict(floor_size=10, rangefinders=True),
                              "escape"),
}

HEADER = """<!--
Copyright 2017 The dm_control Authors.

Licensed under the Apache License, Version 2.0 (the "License");
you may not use this file except in compliance with the License.
You may obtain a copy of the License at

   http://www.apache.org/licenses/LICENSE-2.0

Unless required by applicable law or agreed to in writing, software
distributed under the License is distributed on an "AS IS" BASIS,
WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
See the License for the specific language governing permissions and
limitations under the License.

Source: dm_control 1.0.43, dm_control/suite/{module}.py,
{call}, the model of its {tasks} task{s}.
Changes: the ./common/ includes (skybox, visual, materials) and every
material= attribute are removed; neither changes the dynamics.  The layout
is lxml's pretty print of the module's output.
-->
"""


QUADRUPED_HEADER = """<!--
Copyright 2019 The dm_control Authors.

Licensed under the Apache License, Version 2.0 (the "License");
you may not use this file except in compliance with the License.
You may obtain a copy of the License at

   http://www.apache.org/licenses/LICENSE-2.0

Unless required by applicable law or agreed to in writing, software
distributed under the License is distributed on an "AS IS" BASIS,
WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
See the License for the specific language governing permissions and
limitations under the License.

Source: dm_control 1.0.43, dm_control/suite/quadruped.xml as
quadruped.make_model({args}) writes it (quadruped.py:55-93): the {task}
task's sensors, its 20 rangefinders included, on the walk task's flat
10 x 10 floor (no terrain geom, no walls, ball or target).
Changes: the ./common/ includes (skybox, visual, materials) and every
material= attribute are removed; neither changes the dynamics, nor what a
rangefinder sees (every material and geom of the model is opaque).  The
layout is lxml's pretty print of make_model's output.
-->
"""


def dm_xml(name: str) -> str:
  """The model's XML as dm_control's task module builds it."""
  import importlib

  if name in QUADRUPEDS:
    from dm_control.suite import quadruped

    return quadruped.make_model(**QUADRUPEDS[name][0]).decode()
  module, args, _ = MODELS[name]
  xml, _ = importlib.import_module(
      f"dm_control.suite.{module}").get_model_and_assets(*args)
  return xml if isinstance(xml, str) else xml.decode()


def stripped(xml: str) -> str:
  """``xml`` without the ./common/ includes and the material= attributes,
  in lxml's layout (the vendored files' stated changes)."""
  from lxml import etree

  root = etree.fromstring(xml.encode(),
                          etree.XMLParser(remove_blank_text=True))
  for inc in root.findall("include"):
    root.remove(inc)
  for el in root.iter():
    el.attrib.pop("material", None)
  return etree.tostring(root, pretty_print=True).decode()


def vendored(name: str) -> str:
  """The text of the vendored ``assets/<name>.xml``."""
  if name in QUADRUPEDS:
    kwargs, task = QUADRUPEDS[name]
    args = ", ".join(f"{k}={v}" for k, v in kwargs.items())
    return QUADRUPED_HEADER.format(args=args, task=task) + stripped(
        dm_xml(name))
  module, args, tasks = MODELS[name]
  call = f"get_model_and_assets({', '.join(map(str, args))})"
  return HEADER.format(module=module, call=call, tasks=tasks,
                       s="s" if " and " in tasks else "") + stripped(
                           dm_xml(name))


def main() -> None:
  import mujoco

  import mujoco_inversedynamicstest_tpu_torch as mt

  for name in (*MODELS, *QUADRUPEDS):
    path = mt.asset_path(f"{name}.xml")
    path.write_text(vendored(name))
    mt.save_model_snapshot(mujoco.MjModel.from_xml_path(str(path)),
                           mt.asset_path(f"{name}.npz"))
    print(f"wrote {path} and its snapshot")


if __name__ == "__main__":
  main()
