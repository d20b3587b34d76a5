"""Engine plugins of the port (the JAX package's ``plugins``):
the registry and the registered ports, each registering itself on import.

``mujoco.pid`` (actuator), ``mujoco.elasticity.cable`` (passive),
``mujoco.sensor.touch_grid`` (sensor), the analytic SDF shapes
``mujoco.sdf.{torus,bowl,bolt,nut,gear}`` and the mesh-SDF bridge
``mujoco.sdf.sdflib``.  The shell (``mujoco.elasticity.shell``) is not
ported and is refused by its name, as every unregistered plugin is.
"""

from mujoco_inversedynamicstest_tpu_torch.plugins.registry import (
    PluginInstance,
    build_instances,
    register_plugin,
    registered_plugins,
)
from mujoco_inversedynamicstest_tpu_torch.plugins import cable  # registers
from mujoco_inversedynamicstest_tpu_torch.plugins import pid  # registers
from mujoco_inversedynamicstest_tpu_torch.plugins import sdf  # registers
from mujoco_inversedynamicstest_tpu_torch.plugins import sdflib  # registers
from mujoco_inversedynamicstest_tpu_torch.plugins import touch_grid  # noqa
