"""Model / Data dataclasses of the PyTorch port.

Counterpart of the JAX package's ``models/types.py``.  The JAX
package's pytrees become plain dataclasses:

* ``Model`` holds the float parameters the ported slice reads as tensors on
  the model's device (no batch dimension), and the integer layout tables as
  host numpy attributes, exactly the split the JAX package makes between
  pytree leaves and static fields.
* ``Data`` holds every per-lane quantity as a tensor with an explicit
  leading fleet dimension ``B`` (``vmap`` written out).

The enums are re-declared here because the JAX module imports jax.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch


class JointType(enum.IntEnum):
  """mjtJoint."""
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class IntegratorType(enum.IntEnum):
  """mjtIntegrator."""
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class EqType(enum.IntEnum):
  """mjtEq (installed-mujoco values)."""
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3
  FLEX = 4
  FLEXVERT = 5
  FLEXSTRAIN = 6
  DISTANCE = 7


# the equality types the port builds rows for (ops/constraint.py);
# validate_model refuses every other type by its name
PORTED_EQUALITIES = frozenset({EqType.CONNECT, EqType.WELD, EqType.JOINT,
                               EqType.TENDON, EqType.FLEX})


class ConeType(enum.IntEnum):
  """mjtCone."""
  PYRAMIDAL = 0
  ELLIPTIC = 1


class SolverType(enum.IntEnum):
  """mjtSolver."""
  PGS = 0
  CG = 1
  NEWTON = 2


class GeomType(enum.IntEnum):
  """mjtGeom."""
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7
  SDF = 8


class TrnType(enum.IntEnum):
  """mjtTrn."""
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  """mjtDyn (activation dynamics)."""
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4
  DCMOTOR = 5
  USER = 6


class GainType(enum.IntEnum):
  """mjtGain."""
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2
  DCMOTOR = 3
  USER = 4


class BiasType(enum.IntEnum):
  """mjtBias."""
  NONE = 0
  AFFINE = 1
  MUSCLE = 2
  DCMOTOR = 3
  USER = 4


class WrapType(enum.IntEnum):
  """mjtWrap (tendon path objects)."""
  NONE = 0
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


# what the port computes (ops/forward.py, ops/smooth.py); validate_model
# refuses every other type by its name
PORTED_DYNAMICS = frozenset({DynType.NONE, DynType.INTEGRATOR, DynType.FILTER,
                             DynType.FILTEREXACT, DynType.MUSCLE})
PORTED_GAINS = frozenset({GainType.FIXED, GainType.AFFINE, GainType.MUSCLE})
PORTED_BIASES = frozenset({BiasType.NONE, BiasType.AFFINE, BiasType.MUSCLE})


class SensorType(enum.IntEnum):
  """mjtSensor (installed-mujoco values)."""
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  CAMPROJECTION = 8
  JOINTPOS = 9
  JOINTVEL = 10
  TENDONPOS = 11
  TENDONVEL = 12
  ACTUATORPOS = 13
  ACTUATORVEL = 14
  ACTUATORFRC = 15
  JOINTACTFRC = 16
  TENDONACTFRC = 17
  BALLQUAT = 18
  BALLANGVEL = 19
  JOINTLIMITPOS = 20
  JOINTLIMITVEL = 21
  JOINTLIMITFRC = 22
  TENDONLIMITPOS = 23
  TENDONLIMITVEL = 24
  TENDONLIMITFRC = 25
  FRAMEPOS = 26
  FRAMEQUAT = 27
  FRAMEXAXIS = 28
  FRAMEYAXIS = 29
  FRAMEZAXIS = 30
  FRAMELINVEL = 31
  FRAMEANGVEL = 32
  FRAMELINACC = 33
  FRAMEANGACC = 34
  SUBTREECOM = 35
  SUBTREELINVEL = 36
  SUBTREEANGMOM = 37
  INSIDESITE = 38
  GEOMDIST = 39
  GEOMNORMAL = 40
  GEOMFROMTO = 41
  CONTACT = 42
  E_POTENTIAL = 43
  E_KINETIC = 44
  CLOCK = 45
  TACTILE = 46
  PLUGIN = 47
  USER = 48


class ObjType(enum.IntEnum):
  """mjtObj (the object types the sensor stage reads or refuses)."""
  UNKNOWN = 0
  BODY = 1
  XBODY = 2
  JOINT = 3
  GEOM = 5
  SITE = 6
  CAMERA = 7
  TENDON = 18


# the sensor types the port computes (ops/sensor.py); validate_model
# refuses every other type by its name, and a USER sensor without the
# model's user_sensor_fn
PORTED_SENSORS = frozenset(SensorType[n] for n in (
    "TOUCH", "ACCELEROMETER", "VELOCIMETER", "GYRO", "FORCE", "TORQUE",
    "JOINTPOS", "JOINTVEL", "TENDONPOS", "TENDONVEL", "ACTUATORPOS",
    "ACTUATORVEL", "ACTUATORFRC", "JOINTACTFRC", "BALLQUAT", "BALLANGVEL",
    "FRAMEPOS", "FRAMEQUAT", "FRAMEXAXIS", "FRAMEYAXIS", "FRAMEZAXIS",
    "FRAMELINVEL", "FRAMEANGVEL", "FRAMELINACC", "FRAMEANGACC", "SUBTREECOM",
    "SUBTREELINVEL", "SUBTREEANGMOM", "CLOCK", "MAGNETOMETER", "E_POTENTIAL",
    "E_KINETIC", "RANGEFINDER", "CAMPROJECTION", "JOINTLIMITPOS",
    "JOINTLIMITVEL", "JOINTLIMITFRC", "TENDONLIMITPOS", "TENDONLIMITVEL",
    "TENDONLIMITFRC", "GEOMDIST", "GEOMNORMAL", "GEOMFROMTO", "USER",
    "PLUGIN"))
# the sensors that read the frame of an object (and of a reference object)
# of one of FRAME_OBJECTS
FRAME_SENSORS = frozenset(SensorType[n] for n in (
    "FRAMEPOS", "FRAMEQUAT", "FRAMEXAXIS", "FRAMEYAXIS", "FRAMEZAXIS",
    "FRAMELINVEL", "FRAMEANGVEL", "FRAMELINACC", "FRAMEANGACC"))
FRAME_OBJECTS = frozenset({ObjType.XBODY, ObjType.BODY, ObjType.GEOM,
                           ObjType.SITE, ObjType.CAMERA})


class Stage(enum.IntEnum):
  """mjtStage: the stage whose results a sensor needs."""
  NONE = 0
  POS = 1
  VEL = 2
  ACC = 3


class DataType(enum.IntEnum):
  """mjtDataType: how a sensor's cutoff applies."""
  REAL = 0
  POSITIVE = 1
  AXIS = 2
  QUATERNION = 3


class DisableBit(enum.IntFlag):
  """mjtDisableBit (installed-mujoco layout)."""
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  SPRING = 1 << 5
  DAMPER = 1 << 6
  GRAVITY = 1 << 7
  CLAMPCTRL = 1 << 8
  WARMSTART = 1 << 9
  FILTERPARENT = 1 << 10
  ACTUATION = 1 << 11
  REFSAFE = 1 << 12
  SENSOR = 1 << 13
  MIDPHASE = 1 << 14
  EULERDAMP = 1 << 15
  AUTORESET = 1 << 16
  NATIVECCD = 1 << 17
  ISLAND = 1 << 18
  # multi-contact CCD: on unless disabled in mujoco 3.10; the port's CCD
  # pairs give one contact under either setting (ROADMAP §3)
  MULTICCD = 1 << 19


class EnableBit(enum.IntFlag):
  """mjtEnableBit (installed-mujoco layout)."""
  OVERRIDE = 1 << 0
  ENERGY = 1 << 1
  FWDINV = 1 << 2
  INVDISCRETE = 1 << 3
  SLEEP = 1 << 4
  DIAGEXACT = 1 << 5


class StateFlag(enum.IntFlag):
  """mjtState of the installed mujoco (3.10): the components of a state
  vector, in the order ``mj_getState`` writes them.  (The JAX package's
  ``StateFlag`` carries 3.3.1's bits, before HISTORY, USERDATA and PLUGIN.)
  HISTORY, USERDATA and PLUGIN have size 0 on every model the port
  accepts: ``validate_model`` refuses history buffers, user data and
  plugin state (``npluginstate``)."""
  TIME = 1 << 0
  QPOS = 1 << 1
  QVEL = 1 << 2
  ACT = 1 << 3
  HISTORY = 1 << 4
  WARMSTART = 1 << 5
  CTRL = 1 << 6
  QFRC_APPLIED = 1 << 7
  XFRC_APPLIED = 1 << 8
  EQ_ACTIVE = 1 << 9
  MOCAP_POS = 1 << 10
  MOCAP_QUAT = 1 << 11
  USERDATA = 1 << 12
  PLUGIN = 1 << 13

  PHYSICS = QPOS | QVEL | ACT | HISTORY
  FULLPHYSICS = TIME | PHYSICS | PLUGIN
  USER = (CTRL | QFRC_APPLIED | XFRC_APPLIED | EQ_ACTIVE | MOCAP_POS
          | MOCAP_QUAT | USERDATA)
  INTEGRATION = FULLPHYSICS | USER | WARMSTART


@dataclasses.dataclass(frozen=True)
class Option:
  """Physics options (analog of ``mjOption``); scalars are Python floats."""
  timestep: float
  gravity: torch.Tensor       # (3,)
  impratio: float
  tolerance: float
  ls_tolerance: float
  integrator: int
  cone: int
  solver: int
  iterations: int
  ls_iterations: int
  disableflags: int
  enableflags: int
  noslip_iterations: int
  noslip_tolerance: float
  density: float
  viscosity: float
  wind: torch.Tensor       # (3,)
  magnetic: torch.Tensor   # (3,)


@dataclasses.dataclass(frozen=True)
class TreeLayout:
  """Host-side kinematic-tree tables (see the JAX ``TreeLayout``)."""
  body_levels: Tuple[np.ndarray, ...]
  level_max_jnts: Tuple[int, ...]
  ancestor_mask: np.ndarray    # (nv, nv) bool: j ancestor-or-self of i
  body_dof_mask: np.ndarray    # (nbody, nv) bool: dof j moves body b


@dataclasses.dataclass(frozen=True)
class FlexModel:
  """The flexes (deformable bodies) of a model (``mjModel.flex_*``), with
  C's local vertex and edge ids rebased to global ones.  Layout tables are
  host numpy; the parameters the step reads are tensors on the model's
  device."""
  nflex: int
  nvert: int
  nedge: int
  nelem: int
  dim: np.ndarray             # (nflex,) 1 (cable), 2 (cloth) or 3 (solid)
  vertadr: np.ndarray
  vertnum: np.ndarray
  edgeadr: np.ndarray
  edgenum: np.ndarray
  elemadr: np.ndarray
  elemnum: np.ndarray
  vertbodyid: np.ndarray      # (nvert,) -1 on a trilinear flex
  vertflexid: np.ndarray      # (nvert,)
  vert: np.ndarray         # (nvert, 3) body-local vertex positions
  centered: np.ndarray        # (nflex,) bool: vertices at their bodies
  edge: np.ndarray            # (nedge, 2) global vertex ids
  edge_rigid: np.ndarray      # (nedge,) bool
  elem: np.ndarray            # (nelem, dim + 1) global vertex ids, -1 pad
  elemedge: np.ndarray        # (nelem, 1 | 3 | 6) global edge ids, -1 pad
  rigid: np.ndarray           # (nflex,) bool
  edgeequality: np.ndarray    # (nflex,) bool
  internal: np.ndarray        # (nflex,) bool
  selfcollide: np.ndarray     # (nflex,) mjtFlexSelf
  contype: np.ndarray
  conaffinity: np.ndarray
  condim: np.ndarray
  priority: np.ndarray
  radius_np: np.ndarray       # (nflex,)
  evpair: np.ndarray          # (nevpair, 2) local (element, vertex)
  evpairadr: np.ndarray
  evpairnum: np.ndarray
  interp: np.ndarray          # (nflex,) 1: trilinear nodes
  nodeadr: np.ndarray
  nodenum: np.ndarray
  nodebodyid: np.ndarray
  interp_w: tuple             # per flex (vertnum, nodenum) weights, or ()
  elemlayer: np.ndarray       # (nelem,) a solid element's distance from the surface
  radius: torch.Tensor        # (nflex,)
  friction: torch.Tensor      # (nflex, 3)
  solref: torch.Tensor        # (nflex, 2)
  solimp: torch.Tensor        # (nflex, 5)
  solmix: torch.Tensor        # (nflex,)
  edge_length0: torch.Tensor  # (nedge,)
  edge_invweight0: torch.Tensor  # (nedge,)
  edgestiffness: torch.Tensor  # (nflex,)
  edgedamping: torch.Tensor   # (nflex,)
  damping: torch.Tensor       # (nflex,)
  metric: torch.Tensor        # (nelem, nepe, nepe) element stretch metric
  node0: torch.Tensor         # (nnode, 3)
  stiffness_nodal: tuple      # per flex (3 nodenum, 3 nodenum), or empty
  has_elasticity: bool        # a nonzero element metric
  has_nodal_elasticity: bool  # a nonzero trilinear nodal stiffness
  has_edge_sd: bool           # edge stiffness or damping


@dataclasses.dataclass(frozen=True)
class PluginModel:
  """The engine plugins of a model (``plugins/registry.py``): one instance
  a ``<plugin>`` instance, the instance of each geom and sensor (-1:
  none), the geoms' compiled boxes (centre and half sizes in the geom's
  frame, what the SDF collider seeds its descent in) and the meshes' poses
  that C's compiler took out of them (an SDF geom backed by a mesh is
  evaluated in the mesh's frame).  Host data."""
  hooks: tuple
  geom: np.ndarray        # (ngeom,)
  sensor: np.ndarray      # (nsensor,)
  geom_aabb: np.ndarray   # (ngeom, 6)
  mesh_pos: np.ndarray    # (nmesh, 3)
  mesh_quat: np.ndarray   # (nmesh, 4)


@dataclasses.dataclass(frozen=True)
class Model:
  """Compiled model of the ported slice (analog of ``mjModel``)."""
  nq: int
  nv: int
  nu: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nsensor: int
  nsensordata: int
  neq: int
  nmocap: int
  na: int
  ntendon: int
  nwrap: int
  opt: Option
  tree: TreeLayout

  body_pos: torch.Tensor           # (nbody, 3)
  body_quat: torch.Tensor          # (nbody, 4)
  body_ipos: torch.Tensor          # (nbody, 3)
  body_iquat: torch.Tensor         # (nbody, 4)
  body_mass: torch.Tensor          # (nbody,)
  body_inertia: torch.Tensor       # (nbody, 3)
  body_gravcomp: torch.Tensor      # (nbody,)
  body_invweight0: torch.Tensor    # (nbody, 2)
  body_subtreemass: torch.Tensor   # (nbody,)
  body_parentid: np.ndarray
  body_rootid: np.ndarray
  body_weldid: np.ndarray
  body_jntadr: np.ndarray
  body_jntnum: np.ndarray
  body_dofadr: np.ndarray
  body_dofnum: np.ndarray
  body_mocapid: np.ndarray

  jnt_pos: torch.Tensor            # (njnt, 3)
  jnt_axis: torch.Tensor           # (njnt, 3)
  jnt_stiffness: torch.Tensor      # (njnt,)
  jnt_range: torch.Tensor          # (njnt, 2)
  jnt_margin: torch.Tensor         # (njnt,)
  jnt_solref: torch.Tensor         # (njnt, 2)
  jnt_solimp: torch.Tensor         # (njnt, 5)
  jnt_type: np.ndarray
  jnt_qposadr: np.ndarray
  jnt_dofadr: np.ndarray
  jnt_limited: np.ndarray
  jnt_actfrcrange: torch.Tensor    # (njnt, 2)
  jnt_actfrclimited: np.ndarray
  jnt_actgravcomp: np.ndarray

  dof_armature: torch.Tensor       # (nv,)
  dof_damping: torch.Tensor        # (nv,)
  dof_invweight0: torch.Tensor     # (nv,)
  dof_frictionloss: torch.Tensor   # (nv,)
  dof_solref: torch.Tensor         # (nv, 2)
  dof_solimp: torch.Tensor         # (nv, 5)
  dof_bodyid: np.ndarray
  dof_jntid: np.ndarray
  dof_parentid: np.ndarray
  dof_frictionloss_nz: np.ndarray  # (nv,) bool: dof_frictionloss > 0

  geom_pos: torch.Tensor           # (ngeom, 3)
  geom_quat: torch.Tensor          # (ngeom, 4)
  geom_size: torch.Tensor          # (ngeom, 3)
  geom_friction: torch.Tensor      # (ngeom, 3)
  geom_margin: torch.Tensor        # (ngeom,)
  geom_gap: torch.Tensor           # (ngeom,)
  geom_solref: torch.Tensor        # (ngeom, 2)
  geom_solimp: torch.Tensor        # (ngeom, 5)
  geom_solmix: torch.Tensor        # (ngeom,)
  geom_type: np.ndarray
  geom_bodyid: np.ndarray
  geom_contype: np.ndarray
  geom_conaffinity: np.ndarray
  geom_condim: np.ndarray
  geom_priority: np.ndarray
  geom_dataid: np.ndarray          # mesh id of a mesh geom, else -1
  geom_rbound: torch.Tensor        # (ngeom,) bounding-sphere radius
  geom_fluid: torch.Tensor         # (ngeom, 12) ellipsoid fluid model
  exclude_signature: np.ndarray

  # explicit <pair>s: their geoms and condim, and the parameters that
  # replace the geoms' mixed ones
  pair_geom1: np.ndarray
  pair_geom2: np.ndarray
  pair_dim: np.ndarray
  pair_margin: torch.Tensor        # (npair,)
  pair_gap: torch.Tensor           # (npair,)
  pair_friction: torch.Tensor      # (npair, 5)
  pair_solref: torch.Tensor        # (npair, 2)
  pair_solreffriction: torch.Tensor  # (npair, 2)
  pair_solimp: torch.Tensor        # (npair, 5)

  body_geomadr: np.ndarray
  body_geomnum: np.ndarray

  site_pos: torch.Tensor           # (nsite, 3)
  site_quat: torch.Tensor          # (nsite, 4)
  site_size: torch.Tensor          # (nsite, 3)
  site_type: np.ndarray
  site_bodyid: np.ndarray

  eq_data: torch.Tensor            # (neq, 11)
  eq_solref: torch.Tensor          # (neq, 2)
  eq_solimp: torch.Tensor          # (neq, 5)
  eq_type: np.ndarray
  eq_obj1id: np.ndarray
  eq_obj2id: np.ndarray
  eq_objtype: np.ndarray
  eq_active0: np.ndarray

  sensor_cutoff: torch.Tensor      # (nsensor,)
  sensor_type: np.ndarray
  sensor_datatype: np.ndarray
  sensor_needstage: np.ndarray
  sensor_objtype: np.ndarray
  sensor_objid: np.ndarray
  sensor_reftype: np.ndarray
  sensor_refid: np.ndarray
  sensor_adr: np.ndarray
  sensor_dim: np.ndarray

  actuator_gear: torch.Tensor      # (nu, 6)
  actuator_ctrlrange: torch.Tensor  # (nu, 2)
  actuator_forcerange: torch.Tensor  # (nu, 2)
  actuator_gainprm: torch.Tensor   # (nu, 10)
  actuator_biasprm: torch.Tensor   # (nu, 10)
  actuator_dynprm: torch.Tensor    # (nu, 10)
  actuator_actrange: torch.Tensor  # (nu, 2)
  actuator_lengthrange: torch.Tensor  # (nu, 2)
  actuator_acc0: torch.Tensor      # (nu,)
  actuator_cranklength: torch.Tensor  # (nu,) slider-crank rod length
  actuator_trnid: np.ndarray
  actuator_trntype: np.ndarray
  actuator_dyntype: np.ndarray
  actuator_gaintype: np.ndarray
  actuator_biastype: np.ndarray
  actuator_actadr: np.ndarray
  actuator_actnum: np.ndarray
  actuator_ctrllimited: np.ndarray
  actuator_forcelimited: np.ndarray
  actuator_actlimited: np.ndarray
  actuator_actearly: np.ndarray

  tendon_stiffness: torch.Tensor   # (ntendon,)
  tendon_damping: torch.Tensor     # (ntendon,)
  tendon_frictionloss: torch.Tensor  # (ntendon,)
  tendon_lengthspring: torch.Tensor  # (ntendon, 2)
  tendon_length0: torch.Tensor     # (ntendon,)
  tendon_invweight0: torch.Tensor  # (ntendon,)
  tendon_range: torch.Tensor       # (ntendon, 2)
  tendon_margin: torch.Tensor      # (ntendon,)
  tendon_solref_lim: torch.Tensor  # (ntendon, 2)
  tendon_solimp_lim: torch.Tensor  # (ntendon, 5)
  tendon_solref_fri: torch.Tensor  # (ntendon, 2)
  tendon_solimp_fri: torch.Tensor  # (ntendon, 5)
  tendon_adr: np.ndarray
  tendon_num: np.ndarray
  tendon_limited: np.ndarray
  tendon_frictionloss_nz: np.ndarray  # (ntendon,) bool
  wrap_prm: np.ndarray             # (nwrap,) divisor, side site or coefficient
  wrap_type: np.ndarray
  wrap_objid: np.ndarray

  qpos0: torch.Tensor              # (nq,)
  qpos_spring: torch.Tensor        # (nq,)
  stat_meaninertia: float
  has_dof_damping: bool
  has_gravcomp: bool
  # density, viscosity or wind set: passive adds the fluid forces
  has_fluid: bool
  # (ngeom,) bool: geoms with fluidshape="ellipsoid" (geom_fluid[:, 0] > 0)
  geom_fluid_active: np.ndarray
  # convex hull topology of each mesh (ops/hull.HullSpec); () when no mesh
  # geom can collide
  mesh_hull: tuple
  # MJX's contact budget (<numeric> customs), -1 when absent: the nearest
  # max_geom_pairs candidates of each pair group go to the narrowphase, the
  # nearest max_contact_points slots of each condim to the rows
  max_contact_points: int = -1
  max_geom_pairs: int = -1
  # what C's plane-mesh contact reads of each mesh (ops/hull.MeshGraph); ()
  # when no mesh geom can collide
  mesh_graph: tuple = ()
  # each height field's vertex grid (ops/hfield.HFieldGrid); () when no
  # height-field geom can collide
  hfield_grid: tuple = ()
  # geom_rbound on the host, for the narrowphases' static choices
  geom_rbound_np: np.ndarray = None
  # the flexes, None without; a vertex-dof flex adds one sphere geom a
  # vertex past C's geoms (``ngeom`` counts them; ``ngeom_mj`` does not),
  # whose flex ``geom_flexid`` gives (-1 for C's geoms)
  flex: FlexModel = None
  geom_flexid: np.ndarray = None
  ngeom_mj: int = -1

  # cameras (``camlight``, the camera sensors): mjtCamLight mode, body,
  # target body, local pose, the TRACK modes' offsets and frame, and the
  # image's pixels, sensor size, focal lengths and principal point, field
  # of view
  ncam: int = 0
  cam_mode: np.ndarray = None
  cam_bodyid: np.ndarray = None
  cam_targetbodyid: np.ndarray = None
  cam_pos: torch.Tensor = None        # (ncam, 3)
  cam_quat: torch.Tensor = None       # (ncam, 4)
  cam_pos0: torch.Tensor = None       # (ncam, 3)
  cam_poscom0: torch.Tensor = None    # (ncam, 3)
  cam_mat0: torch.Tensor = None       # (ncam, 3, 3)
  cam_resolution: torch.Tensor = None  # (ncam, 2)
  cam_sensorsize: torch.Tensor = None  # (ncam, 2)
  cam_intrinsic: torch.Tensor = None  # (ncam, 4)
  cam_fovy: torch.Tensor = None       # (ncam,)
  # the scene ray cast (``ray.ray``, ``mj_ray``): each of C's geoms' group
  # and whether it is visible (alpha > 0, the material's where it has one)
  geom_group: np.ndarray = None
  geom_visible: np.ndarray = None
  # each mesh's whole surface (T, 3, 3) in its geom's frame, for the ray
  # cast; () unless a rangefinder can cast at a mesh
  mesh_tris: tuple = ()
  # ``user_sensor_fn(m, d, sensor_id) -> (B, dim)`` of the USER sensors, C's
  # ``mjcb_sensor``; None without
  user_sensor_fn: object = None
  # the engine plugins (``PluginModel``)
  plugins: PluginModel = None
  # the snapshot arrays the model was built from, on the host: the names
  # and keyframes (``models/interop.py``) and checkpoints
  # (``utils/checkpoint.py``) read them
  snapshot: dict = dataclasses.field(default=None, repr=False, compare=False)

  # derived host tables and device constants, computed once per model
  _memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype

  @property
  def plugin_hooks(self) -> tuple:
    """One ``plugins.registry.PluginInstance`` a plugin instance."""
    return () if self.plugins is None else self.plugins.hooks

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  def memo(self, key, fn):
    """``fn()``, computed on first use and kept for the model's lifetime."""
    if key not in self._memo:
      self._memo[key] = fn()
    return self._memo[key]

  def const(self, a) -> torch.Tensor:
    """Device copy of a host numpy constant (an index table, a mask, a
    coefficient array), made once.  Indexing a CUDA tensor with a host
    array would copy it to the card, and wait for the card, on every use."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
      a = a.astype(np.int64)
    dtype = self.dtype if a.dtype.kind == "f" else None
    return self.memo(("const", a.dtype.str, a.shape, a.tobytes()),
                     lambda: torch.as_tensor(a, dtype=dtype,
                                             device=self.device))


@dataclasses.dataclass
class Contact:
  """Static-shape contact set, batched (analog of ``mjContact``).

  Every slot exists every step; ``dist >= includemargin`` marks it inactive.
  Every field is lane data, with the fleet dimension first.  A slot's pair
  and parameters are constants of the model (expanded views), unless the
  model has a contact budget that selects pairs or slots lane by lane
  (``collision.ContactLayout.lane_slots``).
  """
  dist: torch.Tensor           # (B, ncon)
  pos: torch.Tensor            # (B, ncon, 3)
  frame: torch.Tensor          # (B, ncon, 3, 3) rows = [normal, tan1, tan2]
  includemargin: torch.Tensor  # (B, ncon)
  friction: torch.Tensor       # (B, ncon, 5)
  solref: torch.Tensor         # (B, ncon, 2)
  solreffriction: torch.Tensor  # (B, ncon, 2): 0 unless a <pair> sets it
  solimp: torch.Tensor         # (B, ncon, 5)
  geom1: torch.Tensor          # (B, ncon) geom ids
  geom2: torch.Tensor
  # with flex element contacts: each side's bodies and weights, (B, ncon,
  # 2, W) (``mj_elemBodyWeight``; a geom's side is its body at weight 1);
  # None otherwise
  bary_body: torch.Tensor = None
  bary_w: torch.Tensor = None


@dataclasses.dataclass
class Data:
  """Per-lane state + workspace (analog of ``mjData``), batch-first.

  Functions of the port return a new ``Data`` (``dataclasses.replace``) and
  never write into the tensors of the one they were given.
  """
  time: torch.Tensor            # (B,)
  qpos: torch.Tensor            # (B, nq)
  qvel: torch.Tensor            # (B, nv)
  ctrl: torch.Tensor            # (B, nu)
  qfrc_applied: torch.Tensor    # (B, nv)
  xfrc_applied: torch.Tensor    # (B, nbody, 6)
  qacc_warmstart: torch.Tensor  # (B, nv)
  qacc: torch.Tensor            # (B, nv)
  warning: torch.Tensor         # (B, 2) int32: bad qpos / bad qvel resets
  eq_active: torch.Tensor       # (B, neq) bool
  mocap_pos: torch.Tensor       # (B, nmocap, 3)
  mocap_quat: torch.Tensor      # (B, nmocap, 4)
  act: torch.Tensor             # (B, na) actuator activations

  # position stage
  xpos: torch.Tensor = None        # (B, nbody, 3)
  xquat: torch.Tensor = None       # (B, nbody, 4)
  xmat: torch.Tensor = None        # (B, nbody, 3, 3)
  xipos: torch.Tensor = None       # (B, nbody, 3)
  ximat: torch.Tensor = None       # (B, nbody, 3, 3)
  xanchor: torch.Tensor = None     # (B, njnt, 3)
  xaxis: torch.Tensor = None       # (B, njnt, 3)
  geom_xpos: torch.Tensor = None   # (B, ngeom, 3)
  geom_xmat: torch.Tensor = None   # (B, ngeom, 3, 3)
  site_xpos: torch.Tensor = None   # (B, nsite, 3)
  site_xmat: torch.Tensor = None   # (B, nsite, 3, 3)
  cam_xpos: torch.Tensor = None    # (B, ncam, 3)
  cam_xmat: torch.Tensor = None    # (B, ncam, 3, 3)
  subtree_com: torch.Tensor = None  # (B, nbody, 3)
  cinert: torch.Tensor = None      # (B, nbody, 10)
  cdof: torch.Tensor = None        # (B, nv, 6)
  crb: torch.Tensor = None         # (B, nbody, 10)
  qM: torch.Tensor = None          # (B, nv, nv)
  qLD: torch.Tensor = None         # (B, nv, nv) lower Cholesky factor of qM
  ten_length: torch.Tensor = None  # (B, ntendon)
  ten_J: torch.Tensor = None       # (B, ntendon, nv)
  flexvert_xpos: torch.Tensor = None    # (B, nflexvert, 3)
  flexedge_length: torch.Tensor = None  # (B, nflexedge)
  flexedge_J: torch.Tensor = None       # (B, nflexedge, nv), where needed
  actuator_length: torch.Tensor = None  # (B, nu)
  actuator_moment: torch.Tensor = None  # (B, nu, nv)
  contact: Contact = None
  efc_J: torch.Tensor = None       # (B, nefc, nv)
  efc_pos: torch.Tensor = None     # (B, nefc)
  efc_margin: torch.Tensor = None  # (B, nefc)
  efc_D: torch.Tensor = None       # (B, nefc)
  efc_R: torch.Tensor = None       # (B, nefc)
  efc_KBIP: torch.Tensor = None    # (B, nefc, 4)
  efc_active: torch.Tensor = None  # (B, nefc) bool
  efc_frictionloss: torch.Tensor = None  # (B, nefc)

  # velocity stage
  cvel: torch.Tensor = None        # (B, nbody, 6)
  cdof_dot: torch.Tensor = None    # (B, nv, 6)
  ten_velocity: torch.Tensor = None  # (B, ntendon)
  flexedge_velocity: torch.Tensor = None  # (B, nflexedge), where needed
  actuator_velocity: torch.Tensor = None  # (B, nu)
  qfrc_spring: torch.Tensor = None  # (B, nv)
  qfrc_damper: torch.Tensor = None  # (B, nv)
  qfrc_gravcomp: torch.Tensor = None  # (B, nv)
  qfrc_fluid: torch.Tensor = None  # (B, nv)
  qfrc_passive: torch.Tensor = None  # (B, nv)
  qfrc_bias: torch.Tensor = None   # (B, nv)
  efc_aref: torch.Tensor = None    # (B, nefc)

  # actuation / acceleration / constraint
  act_dot: torch.Tensor = None         # (B, na)
  actuator_force: torch.Tensor = None  # (B, nu)
  qfrc_actuator: torch.Tensor = None   # (B, nv)
  qfrc_smooth: torch.Tensor = None     # (B, nv)
  qacc_smooth: torch.Tensor = None     # (B, nv)
  efc_force: torch.Tensor = None       # (B, nefc)
  qfrc_constraint: torch.Tensor = None  # (B, nv)
  qfrc_inverse: torch.Tensor = None    # (B, nv)
  solver_niter: torch.Tensor = None    # (B,) int32
  solver_stat: torch.Tensor = None     # (B, stat_cap, 3)
  solver_fwdinv: torch.Tensor = None   # (B, 2)
  # potential and kinetic energy, under the ENERGY enable flag (mj_energyPos,
  # mj_energyVel); zero otherwise
  energy: torch.Tensor = None          # (B, 2)

  # sensors and the post-constraint RNE they read
  sensordata: torch.Tensor = None      # (B, nsensordata)
  cacc: torch.Tensor = None            # (B, nbody, 6)
  cfrc_int: torch.Tensor = None        # (B, nbody, 6)
  cfrc_ext: torch.Tensor = None        # (B, nbody, 6)

  @property
  def batch(self) -> int:
    return self.qpos.shape[0]

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)
