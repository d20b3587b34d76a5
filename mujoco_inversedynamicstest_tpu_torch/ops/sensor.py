"""Sensors: the position, velocity and acceleration stages of sensordata.

Port of ``mujoco_inversedynamicstest_tpu/ops/sensor.py`` (``mj_sensorPos``,
``mj_sensorVel``, ``mj_sensorAcc``) for the types in
``models.types.PORTED_SENSORS``, on a fleet.  The JAX package loops over
the sensors one by one; here a model's sensors are grouped once, on the
host, by what they compute (``_plan``): each group is one batched
computation over all its objects (every site of a VELOCIMETER or GYRO, say),
each sensor then takes its columns, and one gather writes a stage's values
into ``sensordata``, after the stage's cutoffs.  A stage with no sensor,
or a model whose sensors are disabled, costs nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DataType,
    DisableBit,
    JointType,
    Model,
    ObjType,
    SensorType,
    Stage,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import math, ray, smooth

S = SensorType

# what a sensor type computes: (kind, the offset of its values in the kind's
# row of one object).  The kinds "sitevel" and "framevel" are [angular,
# linear] velocities, "siteacc"/"frameacc" accelerations, "forcetorque"
# [torque, force], "subtreevel" [linear velocity, angular momentum] and
# "frameaxis" the rows of the object frame's transpose, [x; y; z].
_KIND = {
    S.JOINTPOS: ("jointpos", 0), S.JOINTVEL: ("jointvel", 0),
    S.TENDONPOS: ("tendonpos", 0), S.TENDONVEL: ("tendonvel", 0),
    S.ACTUATORPOS: ("actuatorpos", 0), S.ACTUATORVEL: ("actuatorvel", 0),
    S.ACTUATORFRC: ("actuatorfrc", 0), S.JOINTACTFRC: ("jointactfrc", 0),
    S.BALLQUAT: ("ballquat", 0), S.BALLANGVEL: ("ballangvel", 0),
    S.FRAMEPOS: ("framepos", 0), S.FRAMEQUAT: ("framequat", 0),
    S.FRAMEXAXIS: ("frameaxis", 0), S.FRAMEYAXIS: ("frameaxis", 3),
    S.FRAMEZAXIS: ("frameaxis", 6), S.SUBTREECOM: ("subtreecom", 0),
    S.CLOCK: ("clock", 0),
    S.GYRO: ("sitevel", 0), S.VELOCIMETER: ("sitevel", 3),
    S.FRAMEANGVEL: ("framevel", 0), S.FRAMELINVEL: ("framevel", 3),
    S.SUBTREELINVEL: ("subtreevel", 0), S.SUBTREEANGMOM: ("subtreevel", 3),
    S.ACCELEROMETER: ("siteacc", 3),
    S.FRAMEANGACC: ("frameacc", 0), S.FRAMELINACC: ("frameacc", 3),
    S.TORQUE: ("forcetorque", 0), S.FORCE: ("forcetorque", 3),
    S.TOUCH: ("touch", 0), S.MAGNETOMETER: ("magnetometer", 0),
    S.E_POTENTIAL: ("epotential", 0), S.E_KINETIC: ("ekinetic", 0),
}
# the kinds that read cacc or cfrc_int (mj_rnePostConstraint)
_RNEPOST = {"siteacc", "frameacc", "forcetorque"}


class _Group(NamedTuple):
  """Sensors of one kind, object type and reference type (-1: none)."""
  kind: str
  objtype: int
  reftype: int
  objid: np.ndarray        # the group's distinct (object, reference) pairs
  refid: np.ndarray
  cols: np.ndarray         # the group's values, in its sensors' order


class _Plan(NamedTuple):
  """A stage's sensors: groups, where their values go, their cutoffs."""
  groups: tuple
  index: np.ndarray        # (nsensordata,) column of each address's value
  mask: np.ndarray         # (nsensordata,) the addresses this stage writes
  lo: np.ndarray | None    # (ncols,) cutoff bounds; None: no cutoff
  hi: np.ndarray | None
  rnepost: bool


def _enabled(m: Model) -> bool:
  return m.nsensor > 0 and not m.opt.disableflags & DisableBit.SENSOR


def _build_plan(m: Model, stage: Stage) -> _Plan | None:
  ids = np.nonzero(m.sensor_needstage == stage)[0]
  if not ids.size:
    return None
  width = {"ballquat": 4, "framequat": 4, "frameaxis": 9, "sitevel": 6,
           "framevel": 6, "subtreevel": 6, "siteacc": 6, "frameacc": 6,
           "forcetorque": 6, "framepos": 3, "ballangvel": 3,
           "subtreecom": 3, "magnetometer": 3}
  members = {}
  for i in ids:
    kind, _ = _KIND[S(int(m.sensor_type[i]))]
    ref = int(m.sensor_reftype[i]) if m.sensor_refid[i] >= 0 else -1
    members.setdefault((kind, int(m.sensor_objtype[i]), ref), []).append(i)
  groups, addrs, ncols = [], [], 0
  for (kind, objtype, reftype), sids in members.items():
    pairs = list(dict.fromkeys((int(m.sensor_objid[i]), int(m.sensor_refid[i]))
                               for i in sids))
    w = width.get(kind, 1)
    cols = []
    for i in sids:
      p = pairs.index((int(m.sensor_objid[i]), int(m.sensor_refid[i])))
      off = _KIND[S(int(m.sensor_type[i]))][1]
      dim = int(m.sensor_dim[i])
      cols.append(p * w + off + np.arange(dim))
      addrs.append(int(m.sensor_adr[i]) + np.arange(dim))
    pairs = np.array(pairs, np.int64)
    groups.append(_Group(kind, objtype, reftype, pairs[:, 0], pairs[:, 1],
                         np.concatenate(cols)))
    ncols += len(groups[-1].cols)
  addr = np.concatenate(addrs)
  index = np.zeros(m.nsensordata, np.int64)
  index[addr] = np.arange(ncols)
  mask = np.zeros(m.nsensordata, bool)
  mask[addr] = True

  # cutoffs (apply_cutoff): REAL clipped to [-c, c], POSITIVE to c, where
  # c > 0; the sensors' columns in the order of ``addr``
  lo, hi = np.full(ncols, -np.inf), np.full(ncols, np.inf)
  cutoff = m.sensor_cutoff.cpu().numpy()
  sid_of_addr = np.repeat(np.arange(m.nsensor), m.sensor_dim)
  for col, a in enumerate(addr):
    i = sid_of_addr[a]
    if cutoff[i] > 0 and m.sensor_datatype[i] == DataType.REAL:
      lo[col], hi[col] = -cutoff[i], cutoff[i]
    elif cutoff[i] > 0 and m.sensor_datatype[i] == DataType.POSITIVE:
      hi[col] = cutoff[i]
  cut = bool(np.isfinite(lo).any() or np.isfinite(hi).any())
  return _Plan(tuple(groups), index, mask, lo if cut else None,
               hi if cut else None,
               any(g.kind in _RNEPOST for g in groups))


def _plan(m: Model, stage: Stage) -> _Plan | None:
  return m.memo(("sensor_plan", stage), lambda: _build_plan(m, stage))


def _frame_pos_mat(m: Model, d: Data, objtype: int, objid: np.ndarray):
  """World positions and frames (B, n, 3), (B, n, 3, 3) of objects of one
  type (``get_xpos_xmat``)."""
  i = m.const(objid)
  t = ObjType(objtype)
  if t == ObjType.XBODY:
    return d.xpos[:, i], d.xmat[:, i]
  if t == ObjType.BODY:
    return d.xipos[:, i], d.ximat[:, i]
  if t == ObjType.GEOM:
    return d.geom_xpos[:, i], d.geom_xmat[:, i]
  if t == ObjType.SITE:
    return d.site_xpos[:, i], d.site_xmat[:, i]
  raise NotImplementedError(f"sensor object type {t.name}")


def _frame_quat(m: Model, d: Data, objtype: int, objid: np.ndarray):
  """World quaternions (B, n, 4) of objects of one type (``get_xquat``)."""
  i = m.const(objid)
  t = ObjType(objtype)
  if t == ObjType.XBODY:
    return d.xquat[:, i]
  if t == ObjType.BODY:
    return math.quat_mul(d.xquat[:, i], m.body_iquat[i])
  if t == ObjType.GEOM:
    return math.quat_mul(d.xquat[:, m.const(m.geom_bodyid[objid])],
                         m.geom_quat[i])
  if t == ObjType.SITE:
    return math.quat_mul(d.xquat[:, m.const(m.site_bodyid[objid])],
                         m.site_quat[i])
  raise NotImplementedError(f"sensor object type {t.name}")


def _obj_body(m: Model, objtype: int, objid: np.ndarray) -> np.ndarray:
  t = ObjType(objtype)
  if t in (ObjType.BODY, ObjType.XBODY):
    return objid
  if t == ObjType.GEOM:
    return m.geom_bodyid[objid]
  if t == ObjType.SITE:
    return m.site_bodyid[objid]
  raise NotImplementedError(f"sensor object type {t.name}")


def _spatial_at(m: Model, d: Data, spatial: torch.Tensor, objtype: int,
                objid: np.ndarray, local: bool) -> torch.Tensor:
  """Com-based motion vectors ``spatial`` (B, nbody, [k,] 6) of the
  objects' bodies moved to the objects' frames (``mju_transformSpatial``),
  and rotated into them where ``local``."""
  pos, mat = _frame_pos_mat(m, d, objtype, objid)
  body = _obj_body(m, objtype, objid)
  off = pos - d.subtree_com[:, m.const(m.body_rootid[body])]
  v = spatial[:, m.const(body)]
  extra = v.ndim - 3
  off = off.reshape(off.shape[:2] + (1,) * extra + (3,))
  out = math.transform_motion(v, off)
  if local:
    out = math.rotate_spatial_t(
        mat.reshape(mat.shape[:2] + (1,) * extra + (3, 3)), out)
  return out


def object_velocity(m: Model, d: Data, objtype: int, objid: np.ndarray,
                    local: bool) -> torch.Tensor:
  """[angular, linear] velocity (B, n, 6) of objects of one type, in the
  world frame or, where ``local``, the objects' own
  (``mj_objectVelocity``)."""
  return _spatial_at(m, d, d.cvel, objtype, objid, local)


def object_acceleration(m: Model, d: Data, objtype: int, objid: np.ndarray,
                        local: bool) -> torch.Tensor:
  """[angular, linear] acceleration (B, n, 6) of objects of one type
  (``mj_objectAcceleration``): cacc moved to the objects, plus the
  centripetal term ang_vel x lin_vel.  Reads ``d.cacc``
  (``smooth.rne_postconstraint``)."""
  both = _spatial_at(m, d, torch.stack([d.cvel, d.cacc], dim=2), objtype,
                     objid, local)
  vel, acc = both[:, :, 0], both[:, :, 1]
  return acc + torch.cat([torch.zeros_like(vel[..., :3]),
                          math.cross(vel[..., :3], vel[..., 3:])], dim=-1)


def _apply_ref_velocity(m: Model, d: Data, g: _Group, v: torch.Tensor):
  """Velocity relative to a reference frame, in that frame: v - vref, the
  linear part less vref_ang x (pos - rpos)."""
  pos, _ = _frame_pos_mat(m, d, g.objtype, g.objid)
  rpos, rmat = _frame_pos_mat(m, d, g.reftype, g.refid)
  vref = object_velocity(m, d, g.reftype, g.refid, local=False)
  rel = v - vref
  rel = rel + torch.cat([torch.zeros_like(pos),
                         math.cross(pos - rpos, vref[..., :3])], dim=-1)
  return math.rotate_spatial_t(rmat, rel)


def _touch_pairs(m: Model, sites: np.ndarray):
  """The (touch sensor, contact slot) pairs whose slot involves the
  sensor's site body, grouped by site type: {type: (sensor, slot, sign)},
  sign -1 where the body is the slot's second (the ray runs against the
  contact normal); and the (n, P) table of each sensor's pairs in the
  concatenation of the groups, padded with P (a zero column)."""
  clay = collision.contact_layout(m)
  b1, b2 = m.geom_bodyid[clay.geom1], m.geom_bodyid[clay.geom2]
  groups, pos_of = {}, [[] for _ in sites]
  for k, s in enumerate(sites):
    body = m.site_bodyid[s]
    slots = np.nonzero((b1 == body) | (b2 == body))[0]
    sign = np.where(b2[slots] == body, -1.0, 1.0)
    groups.setdefault(int(m.site_type[s]), []).append(
        (np.full(len(slots), k), slots, sign))
  out, n = {}, 0
  for stype, parts in sorted(groups.items()):
    sensor, slot, sign = (np.concatenate(p) for p in zip(*parts))
    for j, k in enumerate(sensor):
      pos_of[k].append(n + j)
    out[stype] = (sensor, slot, sign)
    n += len(sensor)
  width = max(1, max(len(p) for p in pos_of))
  table = np.full((len(sites), width), n)
  for k, p in enumerate(pos_of):
    table[k, :len(p)] = p
  return out, table


def _touch(m: Model, d: Data, sites: np.ndarray) -> torch.Tensor:
  """Touch sensors at ``sites`` (B, n): the sum of the normal forces of the
  active contacts of each site's body whose force ray, from the contact
  point along the normal (away from the body), meets the site's shape
  (``mjSENS_TOUCH``)."""
  clay = collision.contact_layout(m)
  if not clay.ncon:
    return d.qpos.new_zeros((d.batch, len(sites)))
  if clay.lane_slots:
    return _touch_lanes(m, d, sites)
  # without a budget only the slots of each sensor's body are tested (the
  # layout's constant geoms): 2-3x faster than testing every slot on the
  # card, which a budget's lane-selected slots need (PERF.md, PR 12)
  groups, table = m.memo(("touch_pairs", sites.tobytes()),
                         lambda: _touch_pairs(m, sites))
  con = d.contact
  f0 = constraint.contact_forces_frame(m, d)[..., 0]
  active = con.dist < con.includemargin
  parts = []
  for stype, (sensor, slot, sign) in groups.items():
    si, sl = m.const(sites[sensor]), m.const(slot)
    dist = ray.ray_geom(d.site_xpos[:, si], d.site_xmat[:, si],
                        m.site_size[si], con.pos[:, sl],
                        con.frame[:, sl, 0] * m.const(sign)[:, None], stype)
    f = f0[:, sl]
    parts.append(torch.where(active[:, sl] & (f > 0) & torch.isfinite(dist),
                             f, 0.0))
  parts.append(f0.new_zeros((d.batch, 1)))
  return torch.cat(parts, dim=1)[:, m.const(table)].sum(-1)


def _touch_lanes(m: Model, d: Data, sites: np.ndarray) -> torch.Tensor:
  """``_touch`` where a contact budget gives each lane its own slots: each
  sensor tests every slot, and the lane's geoms say whether the slot
  involves the site's body and on which side."""
  con = d.contact
  ncon = collision.contact_layout(m).ncon
  f0 = constraint.contact_forces_frame(m, d)[..., 0]
  b1, b2 = constraint.slot_bodies(m, con)
  live = (con.dist < con.includemargin) & (f0 > 0)
  out = [None] * len(sites)
  for stype in np.unique(m.site_type[sites]):
    ks = np.nonzero(m.site_type[sites] == stype)[0]
    si = m.const(np.repeat(sites[ks], ncon))
    sl = m.const(np.tile(np.arange(ncon), len(ks)))
    body = m.const(np.repeat(m.site_bodyid[sites[ks]], ncon))
    first, second = b1[:, sl] == body, b2[:, sl] == body
    sign = torch.where(second, -1.0, 1.0).to(f0.dtype)[..., None]
    dist = ray.ray_geom(d.site_xpos[:, si], d.site_xmat[:, si],
                        m.site_size[si], con.pos[:, sl],
                        con.frame[:, sl, 0] * sign, int(stype))
    f = torch.where((first | second) & live[:, sl] & torch.isfinite(dist),
                    f0[:, sl], 0.0)
    for j, k in enumerate(ks):
      out[k] = f.reshape(d.batch, len(ks), ncon)[:, j].sum(-1)
  return torch.stack(out, dim=1)


def _values(m: Model, d: Data, g: _Group, cache: dict) -> torch.Tensor:
  """The group's rows (B, n, w), one a distinct (object, reference)."""
  oid = m.const(g.objid)
  k = g.kind
  if k == "jointpos":
    return d.qpos[:, m.const(m.jnt_qposadr[g.objid])][..., None]
  if k == "jointvel":
    return d.qvel[:, m.const(m.jnt_dofadr[g.objid])][..., None]
  if k == "jointactfrc":
    return d.qfrc_actuator[:, m.const(m.jnt_dofadr[g.objid])][..., None]
  if k in ("tendonpos", "tendonvel", "actuatorpos", "actuatorvel",
           "actuatorfrc"):
    field = {"tendonpos": d.ten_length, "tendonvel": d.ten_velocity,
             "actuatorpos": d.actuator_length,
             "actuatorvel": d.actuator_velocity,
             "actuatorfrc": d.actuator_force}[k]
    return field[:, oid][..., None]
  if k == "ballquat":
    adr = m.jnt_qposadr[g.objid][:, None] + np.arange(4)
    return math.normalize_quat(d.qpos[:, m.const(adr)])
  if k == "ballangvel":
    return d.qvel[:, m.const(m.jnt_dofadr[g.objid][:, None] + np.arange(3))]
  if k == "subtreecom":
    return d.subtree_com[:, oid]
  if k == "clock":
    return d.time[:, None, None].expand(d.batch, len(g.objid), 1)
  if k == "framepos":
    pos, _ = _frame_pos_mat(m, d, g.objtype, g.objid)
    if g.reftype < 0:
      return pos
    rpos, rmat = _frame_pos_mat(m, d, g.reftype, g.refid)
    return math.matvec(rmat.transpose(-1, -2), pos - rpos)
  if k == "frameaxis":
    _, mat = _frame_pos_mat(m, d, g.objtype, g.objid)
    if g.reftype >= 0:
      mat = _frame_pos_mat(m, d, g.reftype, g.refid)[1].transpose(-1, -2) @ mat
    return mat.transpose(-1, -2).flatten(-2)
  if k == "framequat":
    q = _frame_quat(m, d, g.objtype, g.objid)
    if g.reftype < 0:
      return q
    return math.quat_mul(math.quat_conj(_frame_quat(m, d, g.reftype,
                                                    g.refid)), q)
  if k == "sitevel":
    return object_velocity(m, d, g.objtype, g.objid, local=True)
  if k == "framevel":
    v = object_velocity(m, d, g.objtype, g.objid, local=False)
    return v if g.reftype < 0 else _apply_ref_velocity(m, d, g, v)
  if k == "subtreevel":
    if "subtree" not in cache:
      cache["subtree"] = torch.cat(smooth.subtree_vel(m, d), dim=-1)
    return cache["subtree"][:, oid]
  if k == "siteacc":
    return object_acceleration(m, d, g.objtype, g.objid, local=True)
  if k == "frameacc":
    return object_acceleration(m, d, g.objtype, g.objid, local=False)
  if k == "forcetorque":
    body = m.site_bodyid[g.objid]
    off = d.site_xpos[:, oid] - d.subtree_com[:, m.const(m.body_rootid[body])]
    w = math.transform_force(d.cfrc_int[:, m.const(body)], off)
    return math.rotate_spatial_t(d.site_xmat[:, oid], w)
  if k == "touch":
    return _touch(m, d, g.objid)[..., None]
  if k == "magnetometer":
    return math.mat_t_vec(d.site_xmat[:, oid], m.opt.magnetic)
  if k in ("epotential", "ekinetic"):
    e = energy_pos(m, d) if k == "epotential" else energy_vel(m, d)
    return e[:, None, None].expand(d.batch, len(g.objid), 1)
  raise NotImplementedError(f"sensor kind {k}")


def energy_pos(m: Model, d: Data) -> torch.Tensor:
  """Potential energy (B,) (``mj_energyPos``): gravity's on every body's
  CoM, and the joint and tendon springs' (a free joint's translation and
  rotation, a ball's rotation; a tendon's outside its ``lengthspring``
  deadband), from a completed position stage."""
  e = d.qpos.new_zeros(d.batch)
  if not m.opt.disableflags & DisableBit.GRAVITY:
    e = e - torch.sum(m.body_mass[1:] * (d.xipos[:, 1:] * m.opt.gravity
                                         ).sum(-1), dim=-1)
  if m.opt.disableflags & DisableBit.SPRING:
    return e
  jt, adr = m.jnt_type, m.jnt_qposadr
  k = m.jnt_stiffness
  scalar = np.nonzero((jt == JointType.HINGE) | (jt == JointType.SLIDE))[0]
  free = np.nonzero(jt == JointType.FREE)[0]
  ball = np.nonzero(jt == JointType.BALL)[0]
  if scalar.size:
    p = m.const(adr[scalar])
    dif = d.qpos[:, p] - m.qpos_spring[p]
    e = e + 0.5 * torch.sum(k[m.const(scalar)] * dif * dif, dim=-1)
  if free.size:
    p = m.const(adr[free][:, None] + np.arange(3))
    dif = d.qpos[:, p] - m.qpos_spring[p]
    e = e + 0.5 * torch.sum(k[m.const(free)] * (dif * dif).sum(-1), dim=-1)
  for jids, off in ((ball, 0), (free, 3)):
    if jids.size:
      p = m.const(adr[jids][:, None] + off + np.arange(4))
      dif = math.quat_sub(math.normalize_quat(d.qpos[:, p]), m.qpos_spring[p])
      e = e + 0.5 * torch.sum(k[m.const(jids)] * (dif * dif).sum(-1), dim=-1)
  if m.ntendon:
    length = d.ten_length
    lower, upper = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
    disp = torch.where(length > upper, upper - length,
                       torch.where(length < lower, lower - length, 0.0))
    e = e + 0.5 * torch.sum(m.tendon_stiffness * disp * disp, dim=-1)
  return e


def energy_vel(m: Model, d: Data) -> torch.Tensor:
  """Kinetic energy 0.5 qvelᵀ M qvel (B,) (``mj_energyVel``)."""
  return 0.5 * torch.sum(d.qvel * smooth.mul_m(m, d, d.qvel), dim=-1)


def _stage(m: Model, d: Data, stage: Stage) -> Data:
  if not _enabled(m):
    return d
  plan = _plan(m, stage)
  if plan is None:
    return d
  if plan.rnepost:
    d = smooth.rne_postconstraint(m, d)
  cache = {}
  vals = []
  for g in plan.groups:
    v = _values(m, d, g, cache).flatten(1)
    if not np.array_equal(g.cols, np.arange(v.shape[1])):
      v = v[:, m.const(g.cols)]
    vals.append(v)
  vals = torch.cat(vals, dim=1) if len(vals) > 1 else vals[0]
  if plan.lo is not None:
    vals = torch.clamp(vals, m.const(plan.lo), m.const(plan.hi))
  sd = d.sensordata
  if sd is None:
    sd = vals.new_zeros((d.batch, m.nsensordata))
  return d.replace(sensordata=torch.where(m.const(plan.mask),
                                          vals[:, m.const(plan.index)], sd))


def sensor_pos(m: Model, d: Data) -> Data:
  """Position-stage sensors (``mj_sensorPos``), from a completed position
  stage."""
  return _stage(m, d, Stage.POS)


def sensor_vel(m: Model, d: Data) -> Data:
  """Velocity-stage sensors (``mj_sensorVel``), from a completed velocity
  stage."""
  return _stage(m, d, Stage.VEL)


def sensor_acc(m: Model, d: Data) -> Data:
  """Acceleration-stage sensors (``mj_sensorAcc``), from a completed
  constraint solve; runs ``smooth.rne_postconstraint`` first where a
  sensor reads cacc or cfrc_int."""
  return _stage(m, d, Stage.ACC)
