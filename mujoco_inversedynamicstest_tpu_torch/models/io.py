"""Host-side model pipeline of the PyTorch port.

Counterpart of ``mujoco_inversedynamicstest_tpu/models/io.py``.  MJCF is
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
    FRAME_OBJECTS,
    FRAME_SENSORS,
    GainType,
    GeomType,
    IntegratorType,
    JointType,
    Model,
    ObjType,
    Option,
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
    "geom_priority", "geom_dataid", "geom_rbound", "exclude_signature",
    "pair_dim", "pair_geom1", "pair_geom2", "pair_signature", "pair_solref",
    "pair_solreffriction", "pair_solimp", "pair_margin", "pair_gap",
    "pair_friction",
    "mesh_vert", "mesh_vertadr", "mesh_vertnum", "mesh_graphadr",
    "mesh_graph",
    "hfield_size", "hfield_nrow", "hfield_ncol", "hfield_adr", "hfield_data",
    "site_pos", "site_quat", "site_size", "site_type", "site_bodyid",
    "sensor_type", "sensor_datatype", "sensor_needstage", "sensor_objtype",
    "sensor_objid", "sensor_reftype", "sensor_refid", "sensor_adr",
    "sensor_dim", "sensor_cutoff", "sensor_history", "sensor_delay",
    "sensor_interval",
    "actuator_gear", "actuator_ctrlrange", "actuator_forcerange",
    "actuator_gainprm", "actuator_biasprm", "actuator_dynprm",
    "actuator_trnid", "actuator_trntype", "actuator_dyntype",
    "actuator_gaintype", "actuator_biastype", "actuator_actadr",
    "actuator_actnum", "actuator_actlimited", "actuator_actrange",
    "actuator_actearly", "actuator_lengthrange", "actuator_acc0",
    "actuator_ctrllimited", "actuator_forcelimited", "actuator_plugin",
    "actuator_armature", "actuator_damping", "actuator_dampingpoly",
    "actuator_delay",
    "qpos0", "qpos_spring",
)
_SIZE_FIELDS = (
    "nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite", "nmocap",
    "neq", "ntendon", "nwrap", "nsensor", "nsensordata", "nflex", "npair",
    "nplugin", "nmesh", "nuserdata", "nhistory",
)
_OPT_FIELDS = (
    "timestep", "gravity", "wind", "density", "viscosity", "impratio",
    "tolerance", "ls_tolerance", "integrator", "cone", "solver", "iterations",
    "ls_iterations", "noslip_iterations", "disableflags", "enableflags",
)
# MJX-convention <numeric> customs (contact budgets)
_BUDGET_NUMERICS = ("max_contact_points", "max_geom_pairs")


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
  return out


def save_model_snapshot(mjm, path) -> None:
  """Writes the MjModel fields ``put_model`` reads to an ``.npz``."""
  np.savez(path, **_snapshot_arrays(mjm))


def _source_arrays(src) -> dict[str, np.ndarray]:
  if isinstance(src, (str, os.PathLike)):
    with np.load(src, allow_pickle=False) as z:
      f = {k: z[k] for k in z.files}
  elif isinstance(src, Mapping):
    f = {k: np.asarray(v) for k, v in src.items()}
  else:
    return _snapshot_arrays(src)
  missing = sorted(set(_ARRAY_FIELDS + _SIZE_FIELDS) - set(f))
  if missing:
    raise ValueError(f"model snapshot lacks the fields {missing}: rewrite it "
                     "from the MjModel with save_model_snapshot")
  return f


def _validate_sensors(f: Mapping, bad) -> None:
  """Refuses every sensor the port does not compute, by name: its type,
  an object or reference type it cannot read, a delay or history."""
  for i in range(int(f["nsensor"])):
    t = SensorType(int(f["sensor_type"][i]))
    if t not in PORTED_SENSORS:
      bad(f"sensor type {t.name}")
    objs = [int(f["sensor_objtype"][i])]
    if int(f["sensor_refid"][i]) >= 0:
      objs.append(int(f["sensor_reftype"][i]))
    for ot in objs:
      if ot == ObjType.CAMERA:
        bad(f"sensor object type CAMERA ({t.name})")
      if t in FRAME_SENSORS and ot not in FRAME_OBJECTS:
        bad(f"sensor object type {ot} ({t.name})")
    if (np.any(f["sensor_history"][i] != 0) or float(f["sensor_delay"][i])
        or np.any(f["sensor_interval"][i] != 0)):
      bad(f"sensor delay, interval or history ({t.name})")


def _validate_equalities(f: Mapping, bad) -> None:
  """Refuses every equality the port does not build rows for, by its type's
  name."""
  for i, t in enumerate(EqType(int(t)) for t in f["eq_type"]):
    if t not in PORTED_EQUALITIES:
      bad(f"{t.name} equality")
    if t in (EqType.CONNECT, EqType.WELD) and int(f["eq_objtype"][i]) not in (
        ObjType.BODY, ObjType.SITE):
      bad(f"{t.name} equality on object type {int(f['eq_objtype'][i])}")


def validate_model(f: Mapping) -> None:
  """Raises NotImplementedError for every feature the port has not ported.

  ``f``: the snapshot arrays of a model (see ``save_model_snapshot``).
  """

  def bad(msg):
    raise NotImplementedError(f"unsupported by the PyTorch port: {msg}")

  for jt in f["jnt_type"]:
    JointType(int(jt))
  # before the size refusals, so that a tendon or plugin sensor is refused
  # by its own name
  _validate_sensors(f, bad)
  # before the size refusals too: an equality is refused by its own name
  _validate_equalities(f, bad)
  for name in ("nflex", "nplugin", "nuserdata", "nhistory"):
    if int(f[name]):
      bad(f"{name} = {int(f[name])}")
  IntegratorType(int(f["opt_integrator"]))
  ConeType(int(f["opt_cone"]))
  if int(f["opt_solver"]) != SolverType.NEWTON:
    bad(f"solver {SolverType(int(f['opt_solver'])).name}")
  if int(f["opt_noslip_iterations"]):
    bad("noslip solver")
  enable = int(f["opt_enableflags"]) & ~int(EnableBit.INVDISCRETE)
  if enable:
    bad(f"enable flags {enable:#x}")
  if (float(f["opt_density"]) > 0 or float(f["opt_viscosity"]) > 0
      or np.any(f["opt_wind"] != 0)):
    bad("fluid forces")
  _validate_tendons(f, bad)
  _validate_actuators(f, bad)


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
    trn = TrnType(int(f["actuator_trntype"][i]))
    if trn not in (TrnType.JOINT, TrnType.JOINTINPARENT, TrnType.TENDON):
      bad(f"actuator transmission {trn.name}")
    dyn = DynType(int(f["actuator_dyntype"][i]))
    if dyn not in PORTED_DYNAMICS:
      bad(f"actuator dynamics {dyn.name}")
    gain = GainType(int(f["actuator_gaintype"][i]))
    if gain not in PORTED_GAINS:
      bad(f"actuator gain {gain.name}")
    bias = BiasType(int(f["actuator_biastype"][i]))
    if bias not in PORTED_BIASES:
      bad(f"actuator bias {bias.name}")
    if int(f["actuator_actnum"][i]) > 1:
      bad("actuator with more than one activation")
    muscle = (dyn == DynType.MUSCLE or gain == GainType.MUSCLE
              or bias == BiasType.MUSCLE)
    lr = f["actuator_lengthrange"][i]
    if muscle and not (np.all(np.isfinite(lr)) and lr[1] > lr[0]
                       and float(f["actuator_acc0"][i]) > 0):
      bad("muscle without the compiler's lengthrange and acc0")
  if nu and np.any(f["actuator_plugin"] >= 0):
    bad("actuator plugins")
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


def _hfield_grids(f: Mapping) -> tuple:
  """Each height field's vertex grid (``ops/hfield.py``), built on the host
  only when a height-field geom can collide; ``()`` otherwise."""
  if not _can_collide(f, GeomType.HFIELD):
    return ()
  from mujoco_inversedynamicstest_tpu_torch.ops import hfield

  return hfield.hfield_grids(f["hfield_size"], f["hfield_nrow"],
                             f["hfield_ncol"], f["hfield_adr"],
                             f["hfield_data"])


def put_model(src, device="cuda", dtype=torch.float64) -> Model:
  """Builds the port's ``Model`` from a ``mujoco.MjModel``, a snapshot
  ``.npz`` path, or a mapping of snapshot arrays, on the card unless
  ``device`` says otherwise (``device="cpu"`` runs the plain versions)."""
  f = _source_arrays(src)
  validate_model(f)
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
      "pair_margin", "pair_gap", "pair_friction", "pair_solref",
      "pair_solreffriction", "pair_solimp",
      "site_pos", "site_quat", "site_size", "sensor_cutoff",
      "actuator_gear", "actuator_ctrlrange", "actuator_forcerange",
      "actuator_gainprm", "actuator_biasprm", "actuator_dynprm",
      "actuator_actrange", "actuator_lengthrange", "actuator_acc0",
      "tendon_stiffness", "tendon_damping", "tendon_frictionloss",
      "tendon_lengthspring", "tendon_length0", "tendon_invweight0",
      "tendon_range", "tendon_margin", "tendon_solref_lim",
      "tendon_solimp_lim", "tendon_solref_fri", "tendon_solimp_fri",
      "qpos0", "qpos_spring",
  )
  int_fields = (
      "body_parentid", "body_rootid", "body_weldid", "body_jntadr",
      "body_jntnum", "body_dofadr", "body_dofnum", "body_mocapid",
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
      dof_frictionloss_nz=np.asarray(f["dof_frictionloss"]) > 0,
      tendon_frictionloss_nz=np.asarray(f["tendon_frictionloss"]) > 0,
      wrap_prm=np.asarray(f["wrap_prm"], np.float64),
      mesh_hull=mesh_hull,
      mesh_graph=mesh_graph,
      hfield_grid=_hfield_grids(f),
      geom_rbound_np=np.asarray(f["geom_rbound"], np.float64),
      max_contact_points=int(f["max_contact_points"]),
      max_geom_pairs=int(f["max_geom_pairs"]),
      **{k: t(k) for k in float_fields},
      **{k: i(k) for k in int_fields},
  )
  # unsupported geom pairs must fail at load, not at the first step
  from mujoco_inversedynamicstest_tpu_torch.ops.collision import contact_layout

  contact_layout(m)
  return m


def load_model(path_or_xml: str, device="cuda",
               dtype=torch.float64) -> Model:
  """Compiles an MJCF file or XML string with ``mujoco`` and converts it
  with ``put_model`` (on the card by default)."""
  import mujoco

  if path_or_xml.lstrip().startswith("<"):
    mjm = mujoco.MjModel.from_xml_string(path_or_xml)
  else:
    mjm = mujoco.MjModel.from_xml_path(str(path_or_xml))
  return put_model(mjm, device=device, dtype=dtype)


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
