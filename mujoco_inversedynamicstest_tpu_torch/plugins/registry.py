"""Plugin registry: named factories -> per-instance hooks.

Port of ``mujoco_inversedynamicstest_tpu/plugins/registry.py``, C's global
plugin table (``mjp_registerPlugin`` / ``mjp_getPluginAtSlot``).  A plugin
is registered under its MJCF extension name; ``put_model`` calls
``build_instances``, which turns every ``<extension><plugin>`` instance of
the model into a ``PluginInstance`` whose hooks are functions of the fleet
(``Model``, ``Data``) and of the instance's static data.

The instances are built from the model's snapshot arrays alone: the
plugin names and their resolved attributes are read from C's table once,
on the host, when the snapshot is made (``read_plugins``, the one place
that needs ``mujoco``), so the card's machine rebuilds them from an
``.npz``.  An unregistered plugin is refused by its name.

Hooks (C's ``mjpPlugin`` capabilities):

* ``passive(m, d) -> (B, nv)`` added to ``qfrc_passive`` (mjPLUGIN_PASSIVE);
* ``act_dot(m, d, ctrl, act_dot) -> (B, na)`` and
  ``actuator_force(m, d, ctrl, force) -> (B, nu)``: the plugin's slots
  replaced, out of place (mjPLUGIN_ACTUATOR);
* ``sensor(m, d, sensor_id) -> (B, dim)`` at the sensor's needstage
  (mjPLUGIN_SENSOR);
* an SDF geom's plugin has ``sdf(x)`` and ``aabb()`` (mjPLUGIN_SDF).
"""

from __future__ import annotations

import ctypes
import glob
import os
from collections.abc import Mapping
from typing import Callable, Dict, Optional, Tuple

import numpy as np

_REGISTRY: Dict[str, Callable] = {}


class PluginInstance:
  """Base class of the built instances; subclasses override the hooks they
  implement.  A hook left at its base returns None (no contribution)."""

  name: str = ""

  def passive(self, m, d):
    return None

  def act_dot(self, m, d, ctrl, act_dot):
    return None

  def actuator_force(self, m, d, ctrl, force):
    return None

  def sensor(self, m, d, sensor_id):
    """The (B, sensor_dim) reading of a PLUGIN sensor.  ``put_model``
    refuses plugin sensors whose port leaves this base in place."""
    return None


def register_plugin(name: str, factory: Callable) -> None:
  """Registers ``factory(f, instance, attrs) -> PluginInstance``: ``f`` the
  snapshot arrays of the model, ``attrs`` the instance's attributes by
  name (strings, as C stores them)."""
  _REGISTRY[name] = factory


def registered_plugins() -> Tuple[str, ...]:
  return tuple(sorted(_REGISTRY))


def attrs_of(f: Mapping, instance: int) -> Dict[str, str]:
  """The resolved attributes of an instance, from the snapshot's
  ``plugin_attr`` ("key=value" lines)."""
  text = str(np.asarray(f["plugin_attr"])[instance])
  return dict(line.split("=", 1) for line in text.split("\n") if line)


def require(attrs: Dict[str, str], keys: Tuple[str, ...], name: str):
  """``attrs`` at ``keys``; refuses a key the plugin does not declare."""
  unknown = [k for k in keys if k not in attrs]
  if unknown:
    raise NotImplementedError(
        f"unsupported by the PyTorch port: plugin attribute(s) {unknown} "
        f"not declared by {name} (declared: {sorted(attrs)})")
  return {k: attrs[k] for k in keys}


def build_instances(f: Mapping) -> Tuple[PluginInstance, ...]:
  """Every plugin instance of a model's snapshot arrays, or a refusal by
  the plugin's name."""
  out = []
  for i in range(int(f["nplugin"])):
    name = str(np.asarray(f["plugin_name"])[i])
    if name not in _REGISTRY:
      raise NotImplementedError(
          f"unsupported by the PyTorch port: plugin '{name}' (registered: "
          f"{', '.join(registered_plugins())})")
    inst = _REGISTRY[name](f, i, attrs_of(f, i))
    inst.name = name
    out.append(inst)
  return tuple(out)


# ---------------------------------------------------------------------------
# host only: C's plugin table, read through ctypes when a snapshot is made
# ---------------------------------------------------------------------------


class _MjpPluginHead(ctypes.Structure):
  """Leading members of ``mjpPlugin`` (mjplugin.h): the name and the
  declared attribute names."""

  _fields_ = [
      ("name", ctypes.c_char_p),
      ("nattribute", ctypes.c_int),
      ("attributes", ctypes.POINTER(ctypes.c_char_p)),
  ]


def host_library():
  """The ``libmujoco`` of the installed ``mujoco`` package, loaded by
  ctypes (the Python bindings expose no plugin table)."""
  import mujoco

  libs = glob.glob(os.path.join(os.path.dirname(mujoco.__file__),
                                "libmujoco.so*"))
  if not libs:
    raise NotImplementedError("the mujoco package's libmujoco is not found")
  return ctypes.CDLL(libs[0])


def _plugin_at_slot(slot: int) -> Optional[_MjpPluginHead]:
  fn = host_library().mjp_getPluginAtSlot
  fn.restype = ctypes.POINTER(_MjpPluginHead)
  fn.argtypes = [ctypes.c_int]
  p = fn(int(slot))
  return p.contents if p else None


def read_plugins(mjm) -> Tuple[np.ndarray, np.ndarray]:
  """Each instance's plugin name and its declared attributes with their
  values (C stores the values as consecutive NUL-terminated strings from
  ``plugin_attradr`` in the plugin's declaration order), as two string
  arrays of ``nplugin``; the attributes one "key=value" line each."""
  names, attrs = [], []
  n = int(mjm.nplugin)
  for i in range(n):
    head = _plugin_at_slot(int(mjm.plugin[i]))
    name = head.name.decode() if head is not None and head.name else ""
    declared = ([head.attributes[k].decode()
                 for k in range(int(head.nattribute))]
                if head is not None else [])
    adr = int(mjm.plugin_attradr[i])
    end = int(mjm.plugin_attradr[i + 1]) if i + 1 < n else int(
        mjm.npluginattr)
    vals = bytes(mjm.plugin_attr[adr:end]).split(b"\0")
    names.append(name)
    attrs.append("\n".join(
        f"{k}={vals[j].decode() if j < len(vals) else ''}"
        for j, k in enumerate(declared)))
  return np.array(names, dtype=str), np.array(attrs, dtype=str)
