"""Host-side model pipeline of the PyTorch port.

Counterpart of the JAX package's ``models/io.py``.  MJCF is
compiled by the ``mujoco`` package (imported only inside ``load_model``);
``put_model`` converts either a ``mujoco.MjModel`` or a *model snapshot* —
an ``.npz`` of exactly the MjModel fields ``put_model`` reads, written by
``save_model_snapshot`` — into the port's ``Model``.  The snapshot lets the
port run where ``mujoco`` is not installed.

``validate_model`` refuses, at load time, every feature the port has not
ported yet, the way the JAX package's ``validate_model`` refuses what the
JAX engine cannot simulate.
"""

from __future__ import annotations

import contextlib
import os
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    BiasType,
    ConeType,
    Data,
    DynType,
    EnableBit,
    EqType,
    FlexModel,
    FRAME_OBJECTS,
    FRAME_SENSORS,
    GainType,
    GeomType,
    IntegratorType,
    JointType,
    Model,
    ObjType,
    Option,
    PluginModel,
    PORTED_BIASES,
    PORTED_DYNAMICS,
    PORTED_EQUALITIES,
    PORTED_GAINS,
    PORTED_SENSORS,
    SensorType,
    SolverType,
    TreeLayout,
    TrnType,
    WrapType,
)

# MjModel array fields read by put_model / validate_model
_ARRAY_FIELDS = (
    "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
    "body_inertia", "body_gravcomp", "body_invweight0", "body_parentid",
    "body_rootid", "body_weldid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_subtreemass", "body_mocapid",
    "body_geomadr", "body_geomnum",
    "jnt_pos", "jnt_axis", "jnt_stiffness", "jnt_range", "jnt_margin",
    "jnt_solref", "jnt_solimp", "jnt_type", "jnt_qposadr", "jnt_dofadr",
    "jnt_limited", "jnt_actfrclimited", "jnt_actfrcrange", "jnt_actgravcomp",
    "dof_armature", "dof_damping", "dof_invweight0", "dof_frictionloss",
    "dof_bodyid", "dof_jntid", "dof_parentid", "dof_solref", "dof_solimp",
    "eq_type", "eq_obj1id", "eq_obj2id", "eq_objtype", "eq_data",
    "eq_solref", "eq_solimp", "eq_active0",
    "tendon_adr", "tendon_num", "tendon_limited", "tendon_stiffness",
    "tendon_damping", "tendon_frictionloss", "tendon_lengthspring",
    "tendon_length0", "tendon_invweight0", "tendon_range", "tendon_margin",
    "tendon_solref_lim", "tendon_solimp_lim", "tendon_solref_fri",
    "tendon_solimp_fri", "tendon_armature", "tendon_actfrclimited",
    "tendon_stiffnesspoly", "tendon_dampingpoly",
    "wrap_type", "wrap_objid", "wrap_prm",
    "geom_pos", "geom_quat", "geom_size", "geom_friction", "geom_margin",
    "geom_gap", "geom_solref", "geom_solimp", "geom_solmix", "geom_type",
    "geom_bodyid", "geom_contype", "geom_conaffinity", "geom_condim",
    "geom_priority", "geom_dataid", "geom_rbound", "geom_fluid",
    "geom_group", "geom_rgba", "geom_matid", "mat_rgba", "exclude_signature",
    "pair_dim", "pair_geom1", "pair_geom2", "pair_signature", "pair_solref",
    "pair_solreffriction", "pair_solimp", "pair_margin", "pair_gap",
    "pair_friction",
    "mesh_vert", "mesh_vertadr", "mesh_vertnum", "mesh_graphadr",
    "mesh_graph", "mesh_face", "mesh_faceadr", "mesh_facenum",
    "hfield_size", "hfield_nrow", "hfield_ncol", "hfield_adr", "hfield_data",
    "site_pos", "site_quat", "site_size", "site_type", "site_bodyid",
    "sensor_type", "sensor_datatype", "sensor_needstage", "sensor_objtype",
    "sensor_objid", "sensor_reftype", "sensor_refid", "sensor_adr",
    "sensor_dim", "sensor_cutoff", "sensor_history", "sensor_delay",
    "sensor_interval", "sensor_intprm",
    "cam_mode", "cam_bodyid", "cam_targetbodyid", "cam_pos", "cam_quat",
    "cam_pos0", "cam_poscom0", "cam_mat0", "cam_resolution", "cam_sensorsize",
    "cam_intrinsic", "cam_fovy",
    "actuator_gear", "actuator_ctrlrange", "actuator_forcerange",
    "actuator_gainprm", "actuator_biasprm", "actuator_dynprm",
    "actuator_trnid", "actuator_trntype", "actuator_dyntype",
    "actuator_gaintype", "actuator_biastype", "actuator_actadr",
    "actuator_actnum", "actuator_actlimited", "actuator_actrange",
    "actuator_actearly", "actuator_lengthrange", "actuator_acc0",
    "actuator_ctrllimited", "actuator_forcelimited", "actuator_plugin",
    "actuator_armature", "actuator_damping", "actuator_dampingpoly",
    "actuator_delay", "actuator_cranklength",
    "qpos0", "qpos_spring",
    # flexes
    "flex_dim", "flex_vertadr", "flex_vertnum", "flex_edgeadr",
    "flex_edgenum", "flex_elemadr", "flex_elemnum", "flex_elemdataadr",
    "flex_elemedgeadr", "flex_elem", "flex_elemedge", "flex_edge",
    "flex_vert", "flex_vert0", "flex_vertbodyid", "flex_centered",
    "flex_rigid", "flexedge_rigid", "flex_edgeequality", "flex_internal",
    "flex_selfcollide", "flex_contype", "flex_conaffinity", "flex_condim",
    "flex_priority", "flex_radius", "flex_friction", "flex_solref",
    "flex_solimp", "flex_margin", "flex_gap", "flex_solmix",
    "flexedge_length0", "flexedge_invweight0", "flex_edgestiffness",
    "flex_edgedamping", "flex_damping", "flex_stiffness",
    "flex_stiffnessadr", "flex_interp", "flex_nodeadr", "flex_nodenum",
    "flex_nodebodyid", "flex_node0", "flex_cellnum", "flex_evpair",
    "flex_evpairadr", "flex_evpairnum", "flex_passive", "flex_vertmetric",
    "flex_bendingadr", "flexvert_J_rownnz", "flex_elemlayer",
)
_SIZE_FIELDS = (
    "nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite", "nmocap",
    "neq", "ntendon", "nwrap", "nsensor", "nsensordata", "nflex", "npair",
    "nplugin", "nmesh", "nuserdata", "nhistory", "nflexvert", "nflexedge",
    "nflexelem", "nflexnode", "nflexevpair", "nflexbending", "ncam", "nmat",
)
_OPT_FIELDS = (
    "timestep", "gravity", "wind", "density", "viscosity", "impratio",
    "tolerance", "ls_tolerance", "integrator", "cone", "solver", "iterations",
    "ls_iterations", "noslip_iterations", "noslip_tolerance", "magnetic",
    "disableflags", "enableflags",
)
# MJX-convention <numeric> customs (contact budgets)
_BUDGET_NUMERICS = ("max_contact_points", "max_geom_pairs")
# the fields the plugins read (plugins/): MjModel's, each instance's plugin
# name and resolved attributes (read from C's plugin table), the bodies'
# positions at qpos0 (the cable's segment lengths) and the sdflib grids.  A
# snapshot carries them only where the model has plugins; without, each
# takes the value of a model without plugins (so the snapshots written
# before they were added load unchanged)
_PLUGIN_FIELDS = {
    "npluginstate": lambda f: np.array(0),
    "geom_plugin": lambda f: np.full(int(f["ngeom"]), -1),
    "body_plugin": lambda f: np.full(int(f["nbody"]), -1),
    "sensor_plugin": lambda f: np.full(int(f["nsensor"]), -1),
    "geom_aabb": lambda f: np.zeros((int(f["ngeom"]), 6)),
    "mesh_pos": lambda f: np.zeros((int(f["nmesh"]), 3)),
    "mesh_quat": lambda f: np.tile([1.0, 0.0, 0.0, 0.0], (int(f["nmesh"]), 1)),
    "plugin_name": lambda f: np.zeros(0, dtype=str),
    "plugin_attr": lambda f: np.zeros(0, dtype=str),
    "body_xpos0": lambda f: np.zeros((int(f["nbody"]), 3)),
    "plugin_grid_values": lambda f: np.zeros(0),
    "plugin_grid_adr": lambda f: np.zeros(0, np.int64),
    "plugin_grid_shape": lambda f: np.zeros((0, 3), np.int64),
    "plugin_grid_frame": lambda f: np.zeros((0, 12)),
}


# the names of every named object type (``mj_name2id``, ``mj_id2name``)
# and the keyframes (``mj_resetDataKeyframe``), read by ``models/interop.py``.
# A snapshot carries them where it was written with ``names=True``; the
# physics does not read them, so snapshots without them load as before
# mjtObj's value of each named object type, and the field of its name
# addresses (XBODY shares BODY's names; DOF and the rest have none)
OBJECT_NAMES = {
    "body": (1, "name_bodyadr"), "xbody": (2, "name_bodyadr"),
    "joint": (3, "name_jntadr"), "geom": (5, "name_geomadr"),
    "site": (6, "name_siteadr"), "camera": (7, "name_camadr"),
    "light": (8, "name_lightadr"), "flex": (9, "name_flexadr"),
    "mesh": (10, "name_meshadr"), "skin": (11, "name_skinadr"),
    "hfield": (12, "name_hfieldadr"), "texture": (13, "name_texadr"),
    "material": (14, "name_matadr"), "pair": (15, "name_pairadr"),
    "exclude": (16, "name_excludeadr"), "equality": (17, "name_eqadr"),
    "tendon": (18, "name_tendonadr"), "actuator": (19, "name_actuatoradr"),
    "sensor": (20, "name_sensoradr"), "numeric": (21, "name_numericadr"),
    "text": (22, "name_textadr"), "tuple": (23, "name_tupleadr"),
    "key": (24, "name_keyadr"), "plugin": (25, "name_pluginadr"),
}
NAME_ADR_FIELDS = tuple(dict.fromkeys(a for _, a in OBJECT_NAMES.values()))
KEY_FIELDS = ("key_time", "key_qpos", "key_qvel", "key_act", "key_ctrl",
              "key_mpos", "key_mquat")
NAME_FIELDS = ("names", "nkey") + NAME_ADR_FIELDS + KEY_FIELDS


def _name_arrays(mjm) -> dict[str, np.ndarray]:
  """The fields of ``NAME_FIELDS`` of a compiled MjModel."""
  out = {f: np.array(getattr(mjm, f)) for f in NAME_ADR_FIELDS + KEY_FIELDS}
  out["names"] = np.frombuffer(bytes(mjm.names), np.uint8).copy()
  out["nkey"] = np.array(int(mjm.nkey))
  return out


def _numeric_custom(mjm, name: str) -> int:
  """Value of a ``<numeric>`` custom by name, -1 when absent."""
  names = bytes(mjm.names)
  for i in range(mjm.nnumeric):
    adr = int(mjm.name_numericadr[i])
    if names[adr:names.index(b"\0", adr)].decode() == name:
      return int(mjm.numeric_data[mjm.numeric_adr[i]])
  return -1


def _snapshot_arrays(mjm) -> dict[str, np.ndarray]:
  """The MjModel fields put_model reads, as numpy arrays."""
  out = {f: np.array(getattr(mjm, f)) for f in _ARRAY_FIELDS}
  out.update({f: np.array(int(getattr(mjm, f))) for f in _SIZE_FIELDS})
  out.update({f"opt_{f}": np.array(getattr(mjm.opt, f)) for f in _OPT_FIELDS})
  out["stat_meaninertia"] = np.array(mjm.stat.meaninertia)
  out.update({f: np.array(_numeric_custom(mjm, f)) for f in _BUDGET_NUMERICS})
  out.update(_plugin_arrays(mjm, out))
  return out


def _plugin_arrays(mjm, f: Mapping) -> dict[str, np.ndarray]:
  """The fields of ``_PLUGIN_FIELDS`` of a compiled MjModel with plugins
  (host only: C's plugin table and ``mj_kinematics``); none without, so
  that the snapshots of models without plugins keep their fields."""
  if not int(mjm.nplugin):
    return {}
  import mujoco

  from mujoco_inversedynamicstest_tpu_torch.plugins import registry, sdflib

  out = {k: np.array(getattr(mjm, k)) for k in (
      "npluginstate", "geom_plugin", "body_plugin", "sensor_plugin",
      "geom_aabb", "mesh_pos", "mesh_quat")}
  out["plugin_name"], out["plugin_attr"] = registry.read_plugins(mjm)
  d0 = mujoco.MjData(mjm)
  d0.qpos[:] = mjm.qpos0
  mujoco.mj_kinematics(mjm, d0)
  out["body_xpos0"] = np.array(d0.xpos)
  out.update(sdflib.grid_arrays({**f, **out}, out["plugin_name"]))
  return out


def save_model_snapshot(mjm, path, names: bool = False) -> None:
  """Writes the MjModel fields ``put_model`` reads to an ``.npz``; with
  ``names`` also its names and keyframes (``NAME_FIELDS``), which
  ``models/interop.py`` reads."""
  f = _snapshot_arrays(mjm)
  if names:
    f.update(_name_arrays(mjm))
  np.savez(path, **f)


def _source_arrays(src) -> dict[str, np.ndarray]:
  if isinstance(src, (str, os.PathLike)):
    with np.load(src, allow_pickle=False) as z:
      f = {k: z[k] for k in z.files}
  elif isinstance(src, Mapping):
    f = {k: np.asarray(v) for k, v in src.items()}
  else:
    f = {**_snapshot_arrays(src), **_name_arrays(src)}
  missing = sorted(set(_ARRAY_FIELDS + _SIZE_FIELDS
                       + tuple(f"opt_{o}" for o in _OPT_FIELDS)) - set(f))
  if not missing and not int(f["nplugin"]):
    f.update({k: fn(f) for k, fn in _PLUGIN_FIELDS.items() if k not in f})
  missing += sorted(set(_PLUGIN_FIELDS) - set(f))
  if missing:
    raise ValueError(f"model snapshot lacks the fields {missing}: rewrite it "
                     "from the MjModel with save_model_snapshot")
  return f


# the sensors that measure the distance between two geom sets
_GEOMDIST_SENSORS = frozenset(SensorType[n] for n in (
    "GEOMDIST", "GEOMNORMAL", "GEOMFROMTO"))


def sensor_geoms(body_geomadr, body_geomnum, objtype: int,
                 objid: int) -> range:
  """The geoms of a distance sensor's side: a body's, or one geom."""
  if objtype == ObjType.BODY:
    adr = int(body_geomadr[objid])
    return range(adr, adr + int(body_geomnum[objid]))
  return range(objid, objid + 1)


def _validate_sensors(f: Mapping, bad, user_ok: bool = False) -> None:
  """Refuses every sensor the port does not compute, by name: its type,
  an object or reference type it cannot read, a delay or history; a USER
  sensor without ``user_sensor_fn``; mujoco 3.10's rangefinder outputs
  beyond the distance (the JAX package, written for 3.3.1, has none); a
  distance sensor over a geom pair without a closed-form narrowphase."""
  from mujoco_inversedynamicstest_tpu_torch.ops.collision import (
      DISTANCE_PAIRS)

  for i in range(int(f["nsensor"])):
    t = SensorType(int(f["sensor_type"][i]))
    if t not in PORTED_SENSORS:
      bad(f"sensor type {t.name}")
    if t == SensorType.USER and not user_ok:
      bad("sensor type USER without a user_sensor_fn (pass put_model the "
          "(m, d, sensor_id) -> (B, dim) callback, C's mjcb_sensor)")
    objs = [int(f["sensor_objtype"][i])]
    if int(f["sensor_refid"][i]) >= 0:
      objs.append(int(f["sensor_reftype"][i]))
    for ot in objs:
      if ot == ObjType.CAMERA and not (t in FRAME_SENSORS
                                       or t == SensorType.CAMPROJECTION):
        bad(f"sensor object type CAMERA ({t.name})")
      if t in FRAME_SENSORS and ot not in FRAME_OBJECTS:
        bad(f"sensor object type {ot} ({t.name})")
    if t == SensorType.RANGEFINDER and (
        int(f["sensor_dim"][i]) != 1
        or int(np.asarray(f["sensor_intprm"])[i, 0]) != 1):
      bad("RANGEFINDER output other than the distance (mujoco 3.10's "
          "data= beyond dist)")
    if t in _GEOMDIST_SENSORS:
      types = np.asarray(f["geom_type"])
      side = lambda ot, oid: sensor_geoms(f["body_geomadr"],
                                          f["body_geomnum"], ot, int(oid))
      for g1 in side(objs[0], f["sensor_objid"][i]):
        for g2 in side(objs[-1], f["sensor_refid"][i]):
          pair = tuple(sorted((GeomType(int(types[g1])),
                               GeomType(int(types[g2])))))
          if pair not in DISTANCE_PAIRS:
            bad(f"{t.name} sensor over geom pair {pair[0].name}-"
                f"{pair[1].name}")
    if (np.any(f["sensor_history"][i] != 0) or float(f["sensor_delay"][i])
        or np.any(f["sensor_interval"][i] != 0)):
      bad(f"sensor delay, interval or history ({t.name})")


def _validate_plugins(f: Mapping, bad) -> None:
  """Refuses, by its name, a plugin the port has not registered (the
  shell, ``mujoco.elasticity.shell``, among them)."""
  from mujoco_inversedynamicstest_tpu_torch.plugins import registry

  for name in np.asarray(f["plugin_name"])[:int(f["nplugin"])]:
    if str(name) not in registry.registered_plugins():
      bad(f"plugin '{name}' (registered: "
          f"{', '.join(registry.registered_plugins())})")


def _validate_plugin_hooks(f: Mapping, hooks: tuple) -> None:
  """Refuses a PLUGIN sensor whose plugin's port computes no sensor, an
  actuator whose plugin's port computes no actuator force (or that names
  no instance of the model), and an SDF geom whose plugin's port has no
  distance function, each by the plugin's name."""
  from mujoco_inversedynamicstest_tpu_torch.plugins import registry

  def bad(msg):
    raise NotImplementedError(f"unsupported by the PyTorch port: {msg}")

  base = registry.PluginInstance.actuator_force
  for i in np.nonzero(np.asarray(f["actuator_plugin"]) >= 0)[0]:
    pid = int(f["actuator_plugin"][i])
    if pid >= len(hooks) or type(hooks[pid]).actuator_force is base:
      name = hooks[pid].name if pid < len(hooks) else "<none>"
      bad(f"actuator plugins: actuator {i} driven by plugin '{name}' "
          f"(instance {pid} of {len(hooks)}; its port computes no actuator "
          "force)")
  for i in np.nonzero(np.asarray(f["sensor_type"]) == SensorType.PLUGIN)[0]:
    inst = hooks[int(f["sensor_plugin"][i])]
    if type(inst).sensor is registry.PluginInstance.sensor:
      bad(f"sensor plugin '{inst.name}' (its port has no sensor hook)")
  for g in np.nonzero(np.asarray(f["geom_type"]) == GeomType.SDF)[0]:
    pid = int(f["geom_plugin"][g])
    if pid < 0 or not hasattr(hooks[pid], "sdf"):
      name = hooks[pid].name if pid >= 0 else "<none>"
      bad(f"SDF geom backed by plugin '{name}' (its port has no sdf "
          "distance function)")


def _validate_equalities(f: Mapping, bad) -> None:
  """Refuses every equality the port does not build rows for, by its type's
  name."""
  for i, t in enumerate(EqType(int(t)) for t in f["eq_type"]):
    if t not in PORTED_EQUALITIES:
      bad(f"{t.name} equality")
    if t == EqType.FLEX and not 0 <= int(f["eq_obj1id"][i]) < int(f["nflex"]):
      bad(f"FLEX equality of flex {int(f['eq_obj1id'][i])}, which the model "
          f"does not have ({int(f['nflex'])} flexes)")
    if t in (EqType.CONNECT, EqType.WELD) and int(f["eq_objtype"][i]) not in (
        ObjType.BODY, ObjType.SITE):
      bad(f"{t.name} equality on object type {int(f['eq_objtype'][i])}")


def validate_model(f: Mapping, user_sensor_fn=None) -> None:
  """Raises NotImplementedError for every feature the port has not ported.

  ``f``: the snapshot arrays of a model (see ``save_model_snapshot``);
  ``user_sensor_fn``: the USER sensors' callback ``put_model`` was given.
  """

  def bad(msg):
    raise NotImplementedError(f"unsupported by the PyTorch port: {msg}")

  for jt in f["jnt_type"]:
    JointType(int(jt))
  # before the size refusals, so that a tendon or plugin sensor is refused
  # by its own name
  _validate_sensors(f, bad, user_sensor_fn is not None)
  # before the size refusals too: an equality is refused by its own name
  _validate_equalities(f, bad)
  _validate_plugins(f, bad)
  for name in ("nuserdata", "nhistory", "npluginstate"):
    if int(f[name]):
      bad(f"{name} = {int(f[name])}")
  _validate_flex(f, bad)
  IntegratorType(int(f["opt_integrator"]))
  ConeType(int(f["opt_cone"]))
  SolverType(int(f["opt_solver"]))
  enable = int(f["opt_enableflags"]) & ~int(EnableBit.INVDISCRETE
                                            | EnableBit.ENERGY)
  if enable:
    bad("enable flags " + ", ".join(
        b.name for b in EnableBit if enable & b) + f" ({enable:#x})")
  _validate_tendons(f, bad)
  _validate_actuators(f, bad)


# the sensors that read the bodies of the contact slots (touch) or the
# contact wrenches of ``rne_postconstraint``; the JAX package gives a flex
# contact's weighted bodies no meaning there
_CONTACT_BODY_SENSORS = frozenset(SensorType[n] for n in (
    "TOUCH", "ACCELEROMETER", "FORCE", "TORQUE", "FRAMELINACC",
    "FRAMEANGACC"))


def _validate_flex(f: Mapping, bad) -> None:
  """Refuses, by name, the flex features the port does not compute: those
  the JAX package refuses (trilinear flexes beyond its generator's
  configuration, models mixing trilinear and vertex-dof flexes), and the
  mujoco 3.10 features the JAX package (written for 3.3.1) does not
  compute: bending elasticity (``elastic2d="bend"``/``"both"``), the
  per-vertex metric and Jacobian, flex_passive, a contact margin or gap;
  and, on a flex that collides, the sensors that read contact bodies and
  the ENERGY flag."""
  nflex = int(f["nflex"])
  if not nflex:
    return
  if int(f["nflexbending"]) or np.any(np.asarray(f["flex_bendingadr"]) >= 0):
    bad('flex bending elasticity (elastic2d="bend" or "both")')
  for name, what in (("flex_passive", "flex_passive"),
                     ("flex_vertmetric", "flex vertex metric"),
                     ("flexvert_J_rownnz", "flex vertex Jacobian (flexvert_J)"),
                     ("flex_margin", "flex contact margin"),
                     ("flex_gap", "flex contact gap")):
    if np.any(np.asarray(f[name]) != 0):
      bad(what)
  interp = np.asarray(f["flex_interp"])
  for fl in range(nflex):
    if interp[fl]:
      if int(interp[fl]) != 1 or int(f["flex_nodenum"][fl]) != 8:
        bad("flex interpolation order beyond trilinear (8 nodes)")
      if not f["flex_centered"][fl]:
        bad("non-centered trilinear flex nodes")
      if f["flex_internal"][fl]:
        bad("internal contacts on a trilinear flex")
      if int(f["flex_selfcollide"][fl]):
        bad("self-collision on a trilinear flex")
      if f["flex_edgeequality"][fl]:
        bad("edge equality on a trilinear flex")
      if f["flex_edgestiffness"][fl] or f["flex_edgedamping"][fl]:
        bad("edge stiffness or damping on a trilinear flex")
    elif np.any(interp):
      bad("mixed trilinear and vertex-dof flexes in one model")
  collides = np.any((np.asarray(f["flex_contype"])
                     | np.asarray(f["flex_conaffinity"])) != 0)
  for t in np.unique(np.asarray(f["sensor_type"])) if collides else ():
    if SensorType(int(t)) in _CONTACT_BODY_SENSORS:
      bad(f"sensor type {SensorType(int(t)).name} with flex contacts")
  if collides and np.any(np.asarray(f["actuator_trntype"]) == TrnType.BODY):
    # adhesion reads the contact slots' bodies too
    bad("actuator transmission BODY with flex contacts")
  if int(f["opt_enableflags"]) & EnableBit.ENERGY:
    bad("the ENERGY flag with flexes")


def _validate_tendons(f: Mapping, bad) -> None:
  """Refuses the tendon features the port does not compute, by name."""
  if int(f["ntendon"]) == 0:
    return
  for t in np.unique(f["wrap_type"]):
    if WrapType(int(t)) == WrapType.NONE:
      bad("tendon path object NONE")
  for name, what in (("tendon_armature", "tendon armature"),
                     ("tendon_actfrclimited", "tendon actuator force limits"),
                     ("tendon_stiffnesspoly", "tendon polynomial stiffness"),
                     ("tendon_dampingpoly", "tendon polynomial damping")):
    if np.any(f[name] != 0):
      bad(what)


def _validate_actuators(f: Mapping, bad) -> None:
  """Refuses the actuators the port does not compute, by the name of their
  transmission, dynamics, gain or bias type; muscles need the compiler's
  lengthrange and acc0 in the snapshot."""
  nu = int(f["nu"])
  for i in range(nu):
    TrnType(int(f["actuator_trntype"][i]))
    dyn = DynType(int(f["actuator_dyntype"][i]))
    if dyn not in PORTED_DYNAMICS:
      bad(f"actuator dynamics {dyn.name}")
    gain = GainType(int(f["actuator_gaintype"][i]))
    if gain not in PORTED_GAINS:
      bad(f"actuator gain {gain.name}")
    bias = BiasType(int(f["actuator_biastype"][i]))
    if bias not in PORTED_BIASES:
      bad(f"actuator bias {bias.name}")
    if int(f["actuator_actnum"][i]) > 1 and int(f["actuator_plugin"][i]) < 0:
      bad("actuator with more than one activation")
    muscle = (dyn == DynType.MUSCLE or gain == GainType.MUSCLE
              or bias == BiasType.MUSCLE)
    lr = f["actuator_lengthrange"][i]
    if muscle and not (np.all(np.isfinite(lr)) and lr[1] > lr[0]
                       and float(f["actuator_acc0"][i]) > 0):
      bad("muscle without the compiler's lengthrange and acc0")
  for name, what in (("actuator_armature", "actuator armature"),
                     ("actuator_damping", "actuator damping"),
                     ("actuator_dampingpoly", "actuator polynomial damping"),
                     ("actuator_delay", "actuator delay")):
    if np.any(f[name] != 0):
      bad(what)


def build_tree_layout(body_parentid, body_jntnum, dof_parentid, body_dofadr,
                      body_dofnum) -> TreeLayout:
  """Level-wise tree tables (see the JAX ``build_tree_layout``)."""
  nbody, nv = len(body_parentid), len(dof_parentid)
  depth = np.zeros(nbody, dtype=np.int32)
  for i in range(1, nbody):
    depth[i] = depth[body_parentid[i]] + 1
  body_levels = tuple(
      np.nonzero(depth == lvl)[0].astype(np.int32)
      for lvl in range(1, int(depth.max(initial=0)) + 1))
  level_max_jnts = tuple(
      int(body_jntnum[b].max()) if len(b) else 0 for b in body_levels)

  ancestor_mask = np.zeros((nv, nv), dtype=bool)
  for i in range(nv):
    j = i
    while j != -1:
      ancestor_mask[i, j] = True
      j = dof_parentid[j]

  body_dof_mask = np.zeros((nbody, nv), dtype=bool)
  for b in range(nbody):
    a = b
    while a != 0:
      body_dof_mask[b, body_dofadr[a]:body_dofadr[a] + body_dofnum[a]] = True
      a = body_parentid[a]
  return TreeLayout(body_levels=body_levels, level_max_jnts=level_max_jnts,
                    ancestor_mask=ancestor_mask, body_dof_mask=body_dof_mask)


def _can_collide(f: Mapping, gtype: GeomType) -> bool:
  """Whether a geom of type ``gtype`` can collide, by its contype and
  conaffinity or in an explicit ``<pair>``."""
  of_type = np.asarray(f["geom_type"]) == gtype
  paired = np.zeros_like(of_type)
  paired[np.asarray(f["pair_geom1"], np.int64)] = True
  paired[np.asarray(f["pair_geom2"], np.int64)] = True
  return bool(np.any(of_type & (paired | (np.asarray(f["geom_contype"]) != 0)
                                | (np.asarray(f["geom_conaffinity"]) != 0))))


def _mesh_tables(f: Mapping) -> tuple:
  """Each mesh's convex hull topology and C's plane-contact tables
  (``ops/hull.py``), built on the host only when a mesh geom can collide;
  ``((), ())`` otherwise."""
  if not _can_collide(f, GeomType.MESH):
    return (), ()
  from mujoco_inversedynamicstest_tpu_torch.ops import hull

  return (hull.mesh_hulls(f["mesh_vert"], f["mesh_vertadr"],
                          f["mesh_vertnum"]),
          hull.mesh_graphs(f["mesh_vert"], f["mesh_vertadr"],
                           f["mesh_vertnum"], f["mesh_graphadr"],
                           f["mesh_graph"]))


def _has_rangefinder(f: Mapping) -> bool:
  return bool(np.any(np.asarray(f["sensor_type"]) == SensorType.RANGEFINDER))


def _hfield_grids(f: Mapping) -> tuple:
  """Each height field's vertex grid (``ops/hfield.py``), built on the host
  only when a height-field geom can collide or a rangefinder can cast at
  it; ``()`` otherwise."""
  if not (_can_collide(f, GeomType.HFIELD) or _has_rangefinder(f)
          and np.any(np.asarray(f["geom_type"]) == GeomType.HFIELD)):
    return ()
  from mujoco_inversedynamicstest_tpu_torch.ops import hfield

  return hfield.hfield_grids(f["hfield_size"], f["hfield_nrow"],
                             f["hfield_ncol"], f["hfield_adr"],
                             f["hfield_data"])


def _mesh_tris(f: Mapping) -> tuple:
  """Each mesh's whole surface, (T, 3, 3) triangles in its geom's frame (C's
  compiler folds the mesh's pose into the geom's), for the ray cast: the
  true surface, which may be concave, not the hull; built only when a
  rangefinder exists (the JAX package's ``_build_mesh_tris``)."""
  if not (_has_rangefinder(f) and np.any(np.asarray(f["geom_type"])
                                         == GeomType.MESH)):
    return ()
  vert = np.asarray(f["mesh_vert"], np.float64).reshape(-1, 3)
  face = np.asarray(f["mesh_face"], np.int64).reshape(-1, 3)
  return tuple(
      np.ascontiguousarray(vert[int(va) + face[int(fa):int(fa) + int(fn)]])
      for va, fa, fn in zip(f["mesh_vertadr"], f["mesh_faceadr"],
                            f["mesh_facenum"]))


def _geom_visible(f: Mapping) -> np.ndarray:
  """(ngeom,) whether each geom is visible to ``mj_ray``: its alpha, or its
  material's where it has one, above 0 (the JAX package's
  ``_geom_visible``)."""
  own = np.asarray(f["geom_rgba"]).reshape(-1, 4)[:, 3] > 0
  matid = np.asarray(f["geom_matid"]).astype(np.int64)
  if not int(f["nmat"]):
    return own
  mat = np.asarray(f["mat_rgba"]).reshape(-1, 4)[np.maximum(matid, 0), 3] > 0
  return np.where(matid >= 0, mat, own)


# edges per element, by the flex's dimension
_ELEM_EDGES = {1: 1, 2: 3, 3: 6}


def _put_flex(f: Mapping, t) -> FlexModel | None:
  """The flexes of the snapshot arrays ``f`` (the JAX package's
  ``_put_flex``): local vertex and edge ids rebased to global, the
  elements' packed stiffness (21 numbers an element from
  ``flex_stiffnessadr``) unpacked into a dense metric, or on a trilinear
  flex the (3 N, 3 N) nodal stiffness, and each trilinear vertex's 8 node
  weights (``mj_flex``: node bit 0 is z, bit 1 y, bit 2 x).  ``t`` makes a
  tensor on the model's device."""
  nflex = int(f["nflex"])
  if not nflex:
    return None
  a = lambda name: np.asarray(f[name])
  ai = lambda name: np.asarray(f[name]).astype(np.int64)
  nvert, nedge, nelem = (int(f[k]) for k in ("nflexvert", "nflexedge",
                                             "nflexelem"))
  dim, vertadr, vertnum = ai("flex_dim"), ai("flex_vertadr"), ai("flex_vertnum")
  edgeadr, edgenum = ai("flex_edgeadr"), ai("flex_edgenum")
  elemadr, elemnum = ai("flex_elemadr"), ai("flex_elemnum")
  edge = ai("flex_edge").reshape(nedge, 2).copy()
  vertflexid = np.zeros(nvert, np.int64)
  for fl in range(nflex):
    edge[edgeadr[fl]:edgeadr[fl] + edgenum[fl]] += vertadr[fl]
    vertflexid[vertadr[fl]:vertadr[fl] + vertnum[fl]] = fl
  nvpe = int(dim.max()) + 1
  nepe = _ELEM_EDGES[int(dim.max())]
  elem = np.full((nelem, nvpe), -1, np.int64)
  elemedge = np.full((nelem, nepe), -1, np.int64)
  flat_elem, flat_ee = ai("flex_elem"), ai("flex_elemedge")
  for fl in range(nflex):
    dv, de = int(dim[fl]) + 1, _ELEM_EDGES[int(dim[fl])]
    base, eebase = int(f["flex_elemdataadr"][fl]), int(f["flex_elemedgeadr"][fl])
    n = int(elemnum[fl])
    sl = slice(elemadr[fl], elemadr[fl] + n)
    elem[sl, :dv] = flat_elem[base:base + n * dv].reshape(n, dv) + vertadr[fl]
    if flat_ee.size:
      elemedge[sl, :de] = (flat_ee[eebase:eebase + n * de].reshape(n, de)
                           + edgeadr[fl])

  interp, nodenum = ai("flex_interp"), ai("flex_nodenum")
  stiff, stiffadr = a("flex_stiffness"), ai("flex_stiffnessadr")
  metric = np.zeros((nelem, nepe, nepe))
  nodal, interp_w = [], []
  vert0 = a("flex_vert0").reshape(nvert, 3)
  for fl in range(nflex):
    if interp[fl]:
      n3 = 3 * int(nodenum[fl])
      k = (stiff[stiffadr[fl]:stiffadr[fl] + n3 * n3].reshape(n3, n3)
           if stiffadr[fl] >= 0 else np.zeros((0, 0)))
      nodal.append(t(k))
      co = vert0[vertadr[fl]:vertadr[fl] + vertnum[fl]]
      j = np.arange(int(nodenum[fl]))
      interp_w.append(np.where(j & 4, co[:, 0:1], 1 - co[:, 0:1])
                      * np.where(j & 2, co[:, 1:2], 1 - co[:, 1:2])
                      * np.where(j & 1, co[:, 2:3], 1 - co[:, 2:3]))
      continue
    nodal.append(t(np.zeros((0, 0))))
    interp_w.append(np.zeros((0, 0)))
    if dim[fl] == 1 or f["flex_rigid"][fl] or stiffadr[fl] < 0:
      continue
    de = _ELEM_EDGES[int(dim[fl])]
    r, c = np.triu_indices(de)
    n = int(elemnum[fl])
    packed = stiff[stiffadr[fl]:stiffadr[fl] + 21 * n].reshape(n, 21)
    sl = slice(elemadr[fl], elemadr[fl] + n)
    metric[sl, r, c] = packed[:, :len(r)]
    metric[sl, c, r] = packed[:, :len(r)]
  evpair = (ai("flex_evpair").reshape(-1, 2) if int(f["nflexevpair"])
            else np.zeros((0, 2), np.int64))
  edgestiffness, edgedamping = a("flex_edgestiffness"), a("flex_edgedamping")
  return FlexModel(
      nflex=nflex, nvert=nvert, nedge=nedge, nelem=nelem, dim=dim,
      vertadr=vertadr, vertnum=vertnum, edgeadr=edgeadr, edgenum=edgenum,
      elemadr=elemadr, elemnum=elemnum, vertbodyid=ai("flex_vertbodyid"),
      vertflexid=vertflexid, vert=a("flex_vert").reshape(nvert, 3),
      centered=a("flex_centered").astype(bool), edge=edge,
      edge_rigid=a("flexedge_rigid").astype(bool), elem=elem,
      elemedge=elemedge, rigid=a("flex_rigid").astype(bool),
      edgeequality=a("flex_edgeequality").astype(bool),
      internal=a("flex_internal").astype(bool),
      selfcollide=ai("flex_selfcollide"), contype=ai("flex_contype"),
      conaffinity=ai("flex_conaffinity"), condim=ai("flex_condim"),
      priority=ai("flex_priority"), radius_np=a("flex_radius").astype(float),
      evpair=evpair, evpairadr=ai("flex_evpairadr"),
      evpairnum=ai("flex_evpairnum"), interp=interp,
      nodeadr=ai("flex_nodeadr"), nodenum=nodenum,
      nodebodyid=ai("flex_nodebodyid"), interp_w=tuple(interp_w),
      elemlayer=ai("flex_elemlayer"),
      radius=t(a("flex_radius")),
      friction=t(a("flex_friction")), solref=t(a("flex_solref")),
      solimp=t(a("flex_solimp")), solmix=t(a("flex_solmix")),
      edge_length0=t(a("flexedge_length0")),
      edge_invweight0=t(a("flexedge_invweight0")),
      edgestiffness=t(edgestiffness), edgedamping=t(edgedamping),
      damping=t(a("flex_damping")), metric=t(metric),
      node0=t(a("flex_node0").reshape(-1, 3)), stiffness_nodal=tuple(nodal),
      has_elasticity=bool(np.any(metric != 0)),
      has_nodal_elasticity=any(bool(torch.any(k != 0)) for k in nodal
                               if k.numel()),
      has_edge_sd=bool(np.any(edgestiffness > 0) | np.any(edgedamping > 0)))


# the geom fields one sphere geom a flex vertex appends, from the flex's
# own parameters (``_append_flex_geoms`` of the JAX package)
_VERTEX_GEOM_FIELDS = {
    "geom_friction": "flex_friction", "geom_margin": "flex_margin",
    "geom_gap": "flex_gap", "geom_solref": "flex_solref",
    "geom_solimp": "flex_solimp", "geom_solmix": "flex_solmix",
    "geom_contype": "flex_contype", "geom_conaffinity": "flex_conaffinity",
    "geom_condim": "flex_condim", "geom_priority": "flex_priority",
}


def _with_vertex_geoms(f: Mapping, flex: FlexModel) -> tuple[dict, np.ndarray]:
  """``f`` with one sphere geom of the flex's radius a vertex of every
  vertex-dof flex appended past C's geoms, at the vertex's body-local
  position (the body itself when the flex is centered), and the geoms'
  flex ids (-1 for C's).  A trilinear flex's vertices have no bodies, and
  no geoms: its contacts are all element groups (``ops/flexcol.py``)."""
  ngeom = int(f["ngeom"])
  if flex is None or np.all(flex.interp != 0):
    return dict(f), np.full(ngeom, -1, np.int64)
  vf = flex.vertflexid
  nv = flex.nvert
  g = dict(f)
  cat = lambda name, extra: np.concatenate(
      [np.asarray(f[name]), np.asarray(extra).astype(np.asarray(f[name]).dtype)
       .reshape((nv,) + np.asarray(f[name]).shape[1:])])
  radius = flex.radius_np[vf]
  local = np.where(flex.centered[vf][:, None], 0.0, flex.vert)
  size = np.zeros((nv, 3))
  size[:, 0] = radius
  g["geom_pos"] = cat("geom_pos", local)
  g["geom_quat"] = cat("geom_quat", np.tile([1.0, 0.0, 0.0, 0.0], (nv, 1)))
  g["geom_size"] = cat("geom_size", size)
  g["geom_rbound"] = cat("geom_rbound", radius)
  g["geom_fluid"] = cat("geom_fluid", np.zeros((nv, 12)))
  g["geom_type"] = cat("geom_type", np.full(nv, int(GeomType.SPHERE)))
  g["geom_dataid"] = cat("geom_dataid", np.full(nv, -1))
  g["geom_bodyid"] = cat("geom_bodyid", flex.vertbodyid)
  for name, src in _VERTEX_GEOM_FIELDS.items():
    g[name] = cat(name, np.asarray(f[src])[vf])
  g["ngeom"] = np.array(ngeom + nv)
  return g, np.concatenate([np.full(ngeom, -1, np.int64), vf])


def put_model(src, device="cuda", dtype=torch.float64,
              user_sensor_fn=None) -> Model:
  """Builds the port's ``Model`` from a ``mujoco.MjModel``, a snapshot
  ``.npz`` path, or a mapping of snapshot arrays, on the card unless
  ``device`` says otherwise (``device="cpu"`` runs the plain versions).
  ``user_sensor_fn(m, d, sensor_id) -> (B, dim)`` computes the USER
  sensors at their stage (C's ``mjcb_sensor``)."""
  from mujoco_inversedynamicstest_tpu_torch.plugins import registry

  f = _source_arrays(src)
  snapshot = dict(f)
  validate_model(f, user_sensor_fn)
  hooks = registry.build_instances(f)
  _validate_plugin_hooks(f, hooks)
  ncam = int(f["ncam"])
  cam = {k: torch.as_tensor(np.asarray(f[k], np.float64).reshape(
      (ncam,) + shape), dtype=dtype, device=device) for k, shape in (
          ("cam_pos", (3,)), ("cam_quat", (4,)), ("cam_pos0", (3,)),
          ("cam_poscom0", (3,)), ("cam_mat0", (3, 3)),
          ("cam_resolution", (2,)), ("cam_sensorsize", (2,)),
          ("cam_intrinsic", (4,)), ("cam_fovy", ()))}
  geom_visible = _geom_visible(f)
  flex = _put_flex(f, lambda x: torch.as_tensor(
      np.asarray(x, np.float64), dtype=dtype, device=device))
  ngeom_mj = int(f["ngeom"])
  f, geom_flexid = _with_vertex_geoms(f, flex)
  t = lambda name: torch.as_tensor(np.asarray(f[name], np.float64),
                                   dtype=dtype, device=device)
  i = lambda name: np.asarray(f[name]).astype(np.int64)
  opt = Option(
      timestep=float(f["opt_timestep"]),
      gravity=t("opt_gravity"),
      impratio=float(f["opt_impratio"]),
      tolerance=float(f["opt_tolerance"]),
      ls_tolerance=float(f["opt_ls_tolerance"]),
      integrator=int(f["opt_integrator"]),
      cone=int(f["opt_cone"]),
      solver=int(f["opt_solver"]),
      iterations=int(f["opt_iterations"]),
      ls_iterations=int(f["opt_ls_iterations"]),
      disableflags=int(f["opt_disableflags"]),
      enableflags=int(f["opt_enableflags"]),
      noslip_iterations=int(f["opt_noslip_iterations"]),
      noslip_tolerance=float(f["opt_noslip_tolerance"]),
      density=float(f["opt_density"]),
      viscosity=float(f["opt_viscosity"]),
      wind=t("opt_wind"),
      magnetic=t("opt_magnetic"),
  )
  tree = build_tree_layout(i("body_parentid"), i("body_jntnum"),
                           i("dof_parentid"), i("body_dofadr"),
                           i("body_dofnum"))
  float_fields = (
      "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
      "body_inertia", "body_gravcomp", "body_invweight0", "body_subtreemass",
      "jnt_pos", "jnt_axis", "jnt_stiffness", "jnt_range", "jnt_margin",
      "jnt_solref", "jnt_solimp", "jnt_actfrcrange",
      "dof_armature", "dof_damping", "dof_invweight0", "dof_frictionloss",
      "dof_solref", "dof_solimp", "eq_data", "eq_solref", "eq_solimp",
      "geom_pos", "geom_quat", "geom_size", "geom_friction", "geom_margin",
      "geom_gap", "geom_solref", "geom_solimp", "geom_solmix", "geom_rbound",
      "geom_fluid", "pair_margin", "pair_gap", "pair_friction", "pair_solref",
      "pair_solreffriction", "pair_solimp",
      "site_pos", "site_quat", "site_size", "sensor_cutoff",
      "actuator_gear", "actuator_ctrlrange", "actuator_forcerange",
      "actuator_gainprm", "actuator_biasprm", "actuator_dynprm",
      "actuator_actrange", "actuator_lengthrange", "actuator_acc0",
      "actuator_cranklength",
      "tendon_stiffness", "tendon_damping", "tendon_frictionloss",
      "tendon_lengthspring", "tendon_length0", "tendon_invweight0",
      "tendon_range", "tendon_margin", "tendon_solref_lim",
      "tendon_solimp_lim", "tendon_solref_fri", "tendon_solimp_fri",
      "qpos0", "qpos_spring",
  )
  int_fields = (
      "body_parentid", "body_rootid", "body_weldid", "body_jntadr",
      "body_jntnum", "body_dofadr", "body_dofnum", "body_mocapid",
      "body_geomadr", "body_geomnum",
      "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_limited",
      "jnt_actfrclimited", "jnt_actgravcomp",
      "dof_bodyid", "dof_jntid", "dof_parentid",
      "eq_type", "eq_obj1id", "eq_obj2id", "eq_objtype", "eq_active0",
      "geom_type", "geom_bodyid", "geom_contype", "geom_conaffinity",
      "geom_condim", "geom_priority", "geom_dataid", "exclude_signature",
      "pair_geom1", "pair_geom2", "pair_dim",
      "site_type", "site_bodyid",
      "sensor_type", "sensor_datatype", "sensor_needstage", "sensor_objtype",
      "sensor_objid", "sensor_reftype", "sensor_refid", "sensor_adr",
      "sensor_dim",
      "actuator_trnid", "actuator_trntype", "actuator_dyntype",
      "actuator_gaintype", "actuator_biastype", "actuator_actadr",
      "actuator_actnum", "actuator_ctrllimited", "actuator_forcelimited",
      "actuator_actlimited", "actuator_actearly",
      "tendon_adr", "tendon_num", "tendon_limited", "wrap_type", "wrap_objid",
  )
  mesh_hull, mesh_graph = _mesh_tables(f)
  m = Model(
      nq=int(f["nq"]), nv=int(f["nv"]), nu=int(f["nu"]),
      nbody=int(f["nbody"]), njnt=int(f["njnt"]), ngeom=int(f["ngeom"]),
      nsite=int(f["nsite"]), nsensor=int(f["nsensor"]),
      nsensordata=int(f["nsensordata"]), neq=int(f["neq"]),
      nmocap=int(f["nmocap"]), na=int(f["na"]), ntendon=int(f["ntendon"]),
      nwrap=int(f["nwrap"]), opt=opt, tree=tree,
      stat_meaninertia=float(f["stat_meaninertia"]),
      has_dof_damping=bool(np.any(f["dof_damping"] > 0)),
      has_gravcomp=bool(np.any(f["body_gravcomp"] != 0)),
      has_fluid=bool(float(f["opt_density"]) > 0
                     or float(f["opt_viscosity"]) > 0
                     or np.any(f["opt_wind"] != 0)),
      geom_fluid_active=np.asarray(f["geom_fluid"]).reshape(
          len(f["geom_type"]), 12)[:, 0] > 0,
      dof_frictionloss_nz=np.asarray(f["dof_frictionloss"]) > 0,
      tendon_frictionloss_nz=np.asarray(f["tendon_frictionloss"]) > 0,
      wrap_prm=np.asarray(f["wrap_prm"], np.float64),
      mesh_hull=mesh_hull,
      mesh_graph=mesh_graph,
      hfield_grid=_hfield_grids(f),
      geom_rbound_np=np.asarray(f["geom_rbound"], np.float64),
      max_contact_points=int(f["max_contact_points"]),
      max_geom_pairs=int(f["max_geom_pairs"]),
      flex=flex, geom_flexid=geom_flexid, ngeom_mj=ngeom_mj,
      ncam=ncam, cam_mode=i("cam_mode"), cam_bodyid=i("cam_bodyid"),
      cam_targetbodyid=i("cam_targetbodyid"), **cam,
      geom_group=i("geom_group")[:ngeom_mj], geom_visible=geom_visible,
      mesh_tris=_mesh_tris(f), user_sensor_fn=user_sensor_fn,
      snapshot=snapshot,
      plugins=PluginModel(
          hooks=hooks, geom=i("geom_plugin"), sensor=i("sensor_plugin"),
          geom_aabb=np.asarray(f["geom_aabb"], np.float64).reshape(-1, 6),
          mesh_pos=np.asarray(f["mesh_pos"], np.float64).reshape(-1, 3),
          mesh_quat=np.asarray(f["mesh_quat"], np.float64).reshape(-1, 4)),
      **{k: t(k) for k in float_fields},
      **{k: i(k) for k in int_fields},
  )
  # unsupported geom pairs must fail at load, not at the first step
  from mujoco_inversedynamicstest_tpu_torch.ops.collision import contact_layout

  contact_layout(m)
  return m


def compile_mjcf(path_or_xml: str):
  """Compiles an MJCF file or XML string with ``mujoco``: the MjModel and
  its snapshot arrays.  XML that names ``mujoco.sdf.sdflib`` (which the
  wheel does not ship) compiles through the port's host stub, its mesh
  pre-scanned into the grid the compiler's marching cubes read
  (``plugins/sdflib.py``); the arrays are read inside that compile."""
  import mujoco

  from mujoco_inversedynamicstest_tpu_torch.plugins import sdflib

  is_xml = str(path_or_xml).lstrip().startswith("<")
  text = path_or_xml if is_xml else Path(path_or_xml).read_text()
  base = "." if is_xml else os.path.dirname(os.path.abspath(path_or_xml))
  grid = (sdflib.prescan_xml(text, base) if sdflib.PLUGIN_NAME in text
          else None)
  with (contextlib.nullcontext() if grid is None
        else sdflib.host_compile_grid(grid)):
    mjm = (mujoco.MjModel.from_xml_string(path_or_xml) if is_xml
           else mujoco.MjModel.from_xml_path(str(path_or_xml)))
    return mjm, _snapshot_arrays(mjm)


def load_model(path_or_xml: str, device="cuda",
               dtype=torch.float64) -> Model:
  """Compiles an MJCF file or XML string with ``mujoco`` (``compile_mjcf``)
  and converts it with ``put_model`` (on the card by default), names and
  keyframes included."""
  mjm, f = compile_mjcf(path_or_xml)
  return put_model({**f, **_name_arrays(mjm)}, device=device, dtype=dtype)


def asset_path(name: str) -> Path:
  """Path of a file in the package's ``assets/`` directory."""
  return Path(__file__).resolve().parent.parent / "assets" / name


def mocap_bodies(m: Model) -> np.ndarray:
  """The mocap bodies, in the order of their mocap ids."""
  bodies = np.nonzero(m.body_mocapid >= 0)[0]
  return bodies[np.argsort(m.body_mocapid[bodies])]


def make_data(m: Model, batch: int, device=None, dtype=None) -> Data:
  """A fleet of ``batch`` lanes in the reset state (``mj_resetData``):
  qpos = qpos0, eq_active = eq_active0, each mocap body's pose its
  body_pos and body_quat, every other input zero (``act`` too), and ``sensordata`` zero.
  (The JAX package's ``make_data`` puts the mocap bodies at the origin with
  the identity quaternion.)  Derived fields are filled by ``forward`` /
  ``inverse``."""
  device = m.device if device is None else device
  dtype = m.dtype if dtype is None else dtype
  z = lambda *s: torch.zeros((batch,) + s, dtype=dtype, device=device)
  mocap = m.const(mocap_bodies(m))
  pose = lambda x: x[mocap].to(device=device, dtype=dtype).expand(
      batch, m.nmocap, x.shape[-1]).clone()
  return Data(
      time=z(),
      qpos=m.qpos0.to(device=device, dtype=dtype).expand(batch, m.nq).clone(),
      qvel=z(m.nv),
      ctrl=z(m.nu),
      qfrc_applied=z(m.nv),
      xfrc_applied=z(m.nbody, 6),
      qacc_warmstart=z(m.nv),
      qacc=z(m.nv),
      warning=torch.zeros((batch, 2), dtype=torch.int32, device=device),
      eq_active=torch.as_tensor(m.eq_active0.astype(bool), device=device
                                ).expand(batch, m.neq).clone(),
      mocap_pos=pose(m.body_pos),
      mocap_quat=pose(m.body_quat),
      act=z(m.na),
      sensordata=z(m.nsensordata),
      energy=z(2),
  )


def put_data(m: Model, mjd) -> Data:
  """A fleet of one lane holding the input state of a ``mujoco.MjData``."""
  return from_jax_arrays(m, {
      "time": np.array([mjd.time]),
      **{k: np.array(getattr(mjd, k))[None] for k in (
          "qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied",
          "qacc_warmstart", "qacc", "eq_active", "mocap_pos", "mocap_quat",
          "act")},
  })


def from_jax_arrays(m: Model, fields: Mapping[str, np.ndarray]) -> Data:
  """Builds a fleet ``Data`` from numpy arrays of the JAX package's ``Data``
  leaves, keyed by field name, each with a leading fleet dimension (stack
  unbatched leaves with ``x[None]``).  Only input fields are taken: every
  other field is computed by the port from them."""
  batch = len(next(iter(fields.values())))
  d = make_data(m, batch)
  updates = {}
  for name, value in fields.items():
    cur = getattr(d, name, None)
    if cur is None:
      raise KeyError(f"{name} is not an input field of Data")
    updates[name] = torch.as_tensor(np.array(value), dtype=cur.dtype,
                                    device=cur.device).reshape(cur.shape)
  return d.replace(**updates)
