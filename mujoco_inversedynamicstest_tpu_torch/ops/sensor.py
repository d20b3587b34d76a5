"""Sensors: the position, velocity and acceleration stages of sensordata.

Port of ``mujoco_inversedynamicstest_tpu/ops/sensor.py`` (``mj_sensorPos``,
``mj_sensorVel``, ``mj_sensorAcc``) for the types in
``models.types.PORTED_SENSORS``, on a fleet.  The JAX package loops over
the sensors one by one; here a model's sensors are grouped once, on the
host, by what they compute (``_plan``): each group is one batched
computation over all its objects (every site of a VELOCIMETER or GYRO, say),
each sensor then takes its columns, and one gather writes a stage's values
into ``sensordata``, after the stage's cutoffs.  A stage with no sensor,
or a model whose sensors are disabled, costs nothing.  So all of a model's
rangefinders are one scene cast (``ray.ray``), and all of its distance
sensors' geom pairs one narrowphase call a pair kind
(``collision.geom_distance``); each USER sensor calls the model's
``user_sensor_fn`` (C's ``mjcb_sensor``), and each PLUGIN sensor its
plugin's sensor hook at the stage the plugin declares (C's
mjPLUGIN_SENSOR compute).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.io import sensor_geoms
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
    S.RANGEFINDER: ("rangefinder", 0), S.CAMPROJECTION: ("camprojection", 0),
    S.JOINTLIMITPOS: ("limitpos", 0), S.TENDONLIMITPOS: ("limitpos", 0),
    S.JOINTLIMITVEL: ("limitvel", 0), S.TENDONLIMITVEL: ("limitvel", 0),
    S.JOINTLIMITFRC: ("limitfrc", 0), S.TENDONLIMITFRC: ("limitfrc", 0),
    # [distance, normal, fromto]
    S.GEOMDIST: ("geomdist", 0), S.GEOMNORMAL: ("geomdist", 1),
    S.GEOMFROMTO: ("geomdist", 4), S.USER: ("user", 0),
    S.PLUGIN: ("plugin", 0),
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
  # the distance sensors' cutoff a pair (their narrowphase's margin), the
  # USER or PLUGIN sensor's id
  extra: np.ndarray = None


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
           "subtreecom": 3, "magnetometer": 3, "camprojection": 2,
           "geomdist": 10}
  cutoff = m.sensor_cutoff.cpu().numpy()
  members = {}
  for i in ids:
    kind, _ = _KIND[S(int(m.sensor_type[i]))]
    ref = int(m.sensor_reftype[i]) if m.sensor_refid[i] >= 0 else -1
    # each USER and PLUGIN sensor is a group of its own
    alone = int(i) if kind in ("user", "plugin") else -1
    members.setdefault((kind, int(m.sensor_objtype[i]), ref, alone),
                       []).append(i)
  groups, addrs, ncols = [], [], 0
  for (kind, objtype, reftype, alone), sids in members.items():
    extra = lambda i: (float(cutoff[i]) if kind == "geomdist" else
                       int(i) if kind in ("user", "plugin") else 0)
    key = lambda i: (int(m.sensor_objid[i]), int(m.sensor_refid[i]),
                     extra(i))
    pairs = list(dict.fromkeys(key(i) for i in sids))
    w = (int(m.sensor_dim[alone]) if kind in ("user", "plugin")
         else width.get(kind, 1))
    cols = []
    for i in sids:
      p = pairs.index(key(i))
      off = _KIND[S(int(m.sensor_type[i]))][1]
      dim = int(m.sensor_dim[i])
      cols.append(p * w + off + np.arange(dim))
      addrs.append(int(m.sensor_adr[i]) + np.arange(dim))
    groups.append(_Group(kind, objtype, reftype,
                         np.array([p[0] for p in pairs], np.int64),
                         np.array([p[1] for p in pairs], np.int64),
                         np.concatenate(cols),
                         np.array([p[2] for p in pairs])))
    ncols += len(groups[-1].cols)
  addr = np.concatenate(addrs)
  index = np.zeros(m.nsensordata, np.int64)
  index[addr] = np.arange(ncols)
  mask = np.zeros(m.nsensordata, bool)
  mask[addr] = True

  # cutoffs (apply_cutoff): REAL clipped to [-c, c], POSITIVE to c, where
  # c > 0, except on GEOMFROMTO (whose cutoff is only the narrowphase's
  # margin); the sensors' columns in the order of ``addr``
  lo, hi = np.full(ncols, -np.inf), np.full(ncols, np.inf)
  sid_of_addr = np.repeat(np.arange(m.nsensor), m.sensor_dim)
  for col, a in enumerate(addr):
    i = sid_of_addr[a]
    if m.sensor_type[i] == S.GEOMFROMTO:
      continue
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
  if t == ObjType.CAMERA:
    return d.cam_xpos[:, i], d.cam_xmat[:, i]
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
  if t == ObjType.CAMERA:
    # C's get_xquat: the body's quaternion times the camera's, whatever the
    # camera's mode (its frame, cam_xmat, may look elsewhere)
    return math.quat_mul(d.xquat[:, m.const(m.cam_bodyid[objid])],
                         m.cam_quat[i])
  raise NotImplementedError(f"sensor object type {t.name}")


def _obj_body(m: Model, objtype: int, objid: np.ndarray) -> np.ndarray:
  t = ObjType(objtype)
  if t in (ObjType.BODY, ObjType.XBODY):
    return objid
  if t == ObjType.GEOM:
    return m.geom_bodyid[objid]
  if t == ObjType.SITE:
    return m.site_bodyid[objid]
  if t == ObjType.CAMERA:
    return m.cam_bodyid[objid]
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


def _limit_rows(m: Model, objtype: int, objid: np.ndarray) -> tuple:
  """Each joint's or tendon's limit rows, (n, 2) efc indices in row order,
  and which of the two exist: a limited hinge or slide joint, or tendon,
  has two (lower, upper), a ball joint one, any other none."""
  lay = constraint.row_layout(m)
  start = lay.ne + lay.nf
  keys = np.concatenate([np.repeat(lay.limit_jnt, 2), lay.ball_jnt])
  if lay.limit_perm is not None:
    keys = keys[lay.limit_perm]
  if objtype == ObjType.TENDON:
    start += len(keys)
    keys = np.repeat(lay.limit_ten, 2)
  rows = np.zeros((len(objid), 2), np.int64)
  exists = np.zeros((len(objid), 2), bool)
  for k, j in enumerate(objid):
    r = np.nonzero(keys == j)[0]
    rows[k, :len(r)] = start + r
    exists[k, :len(r)] = True
  return m.const(rows), m.const(exists)


def _limit(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """The first active limit row of each joint or tendon (B, n) (C's limit
  sensors): its distance past the margin, its velocity or its force, 0
  where no row is active."""
  if d.efc_J is None:
    return d.qpos.new_zeros((d.batch, len(g.objid)))
  rows, exists = m.memo(("limit_rows", g.objtype, g.objid.tobytes()),
                        lambda: _limit_rows(m, g.objtype, g.objid))
  if g.kind == "limitpos":
    val = (d.efc_pos - d.efc_margin)[:, rows]
  elif g.kind == "limitvel":
    val = math.matvec(d.efc_J[:, rows], d.qvel[:, None])
  else:
    val = d.efc_force[:, rows]
  act = d.efc_active[:, rows] & exists
  return torch.where(act[..., 0], val[..., 0],
                     torch.where(act[..., 1], val[..., 1], 0.0))


def _cam_focal(m: Model) -> torch.Tensor:
  """Each camera's focal lengths in pixels (ncam, 2), on the host as C's
  ``cam_project`` forms them: from the intrinsics where the sensor size is
  set, in float (C keeps both in float: intrinsic / sensorsize * pixels),
  else from the vertical field of view."""
  res = m.cam_resolution.cpu().numpy()
  ss = m.cam_sensorsize.cpu().numpy().astype(np.float32)
  intr = m.cam_intrinsic.cpu().numpy()[:, :2].astype(np.float32)
  with np.errstate(divide="ignore", invalid="ignore"):
    lens = intr / ss * res.astype(np.float32)
  fov = 0.5 / np.tan(m.cam_fovy.cpu().numpy() * np.pi / 360.0) * res[:, 1]
  return m.const(np.where((ss != 0).all(1, keepdims=True),
                          lens.astype(np.float64), fov[:, None]))


def _cam_project(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """Pixel coordinates (B, n, 2) of sites in camera images
  (``cam_project``)."""
  c = m.const(g.refid)
  xc = math.mat_t_vec(d.cam_xmat[:, c],
                      d.site_xpos[:, m.const(g.objid)] - d.cam_xpos[:, c])
  f = m.memo("cam_focal", lambda: _cam_focal(m))[c]
  res = m.cam_resolution[c]
  z = xc[..., 2]
  return torch.stack([-f[:, 0] * xc[..., 0] / z + res[:, 0] / 2.0,
                      f[:, 1] * xc[..., 1] / z + res[:, 1] / 2.0], dim=-1)


def _geom_pairs(m: Model, g: _Group) -> tuple:
  """The geom pairs of the group's distance sensors, in the JAX package's
  order (the first side's geoms, then the second's): their geoms and
  margins, and the (n, W) table of each sensor's pairs, padded with the
  pair count (an extra column that never wins)."""
  g1, g2, margin, table = [], [], [], []
  for o, r, c in zip(g.objid, g.refid, g.extra):
    mine = []
    for a in sensor_geoms(m.body_geomadr, m.body_geomnum, g.objtype, o):
      for b in sensor_geoms(m.body_geomadr, m.body_geomnum, g.reftype, r):
        mine.append(len(g1))
        g1.append(a)
        g2.append(b)
        margin.append(c)
    table.append(mine)
  width = max(len(t) for t in table)
  table = [t + [len(g1)] * (width - len(t)) for t in table]
  return (np.array(g1), np.array(g2), m.const(np.array(margin, np.float64)),
          m.const(np.array(table)))


def _geom_dist(m: Model, d: Data, g: _Group) -> torch.Tensor:
  """[distance, normal, fromto] (B, n, 10) of the distance sensors: the
  smallest signed distance between their two geom sets within the cutoff
  (``mj_geomDistance`` of each geom pair at margin = cutoff), the first
  of equal ones; where none lies within it, the cutoff and zeros."""
  g1, g2, margin, table = m.memo(("geom_pairs", g.objid.tobytes(),
                                  g.refid.tobytes(), g.extra.tobytes(),
                                  g.objtype, g.reftype),
                                 lambda: _geom_pairs(m, g))
  dist, fromto = collision.geom_distance(m, d, g1, g2, margin)
  dist = torch.cat([dist, torch.full_like(dist[:, :1], float("inf"))], 1)
  fromto = torch.cat([fromto, torch.zeros_like(fromto[:, :1])], 1)
  k = torch.argmin(dist[:, table], dim=-1, keepdim=True)
  best = torch.take_along_dim(table[None], k, dim=-1)[..., 0]   # (B, n)
  dist = torch.take_along_dim(dist, best, dim=1)
  ft = torch.take_along_dim(fromto, best[..., None], dim=1)
  n = ft[..., 3:] - ft[..., :3]
  nn = math.norm_safe(n, keepdim=True)
  n = torch.where(nn > 1e-15, n / nn, 0.0)
  return torch.cat([dist[..., None], n, ft], dim=-1)


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
  if k == "rangefinder":
    # every rangefinder of the stage in one cast, each blind to its body
    dist, _ = ray.ray(m, d, d.site_xpos[:, oid], d.site_xmat[:, oid, :, 2],
                      bodyexclude=m.site_bodyid[g.objid])
    return dist[..., None]
  if k in ("limitpos", "limitvel", "limitfrc"):
    return _limit(m, d, g)[..., None]
  if k == "camprojection":
    return _cam_project(m, d, g)
  if k == "geomdist":
    return _geom_dist(m, d, g)
  if k == "user":
    sid = int(g.extra[0])
    return m.user_sensor_fn(m, d, sid).reshape(d.batch, 1, -1)
  if k == "plugin":
    sid = int(g.extra[0])
    inst = m.plugin_hooks[int(m.plugins.sensor[sid])]
    return inst.sensor(m, d, sid).reshape(d.batch, 1, -1)
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
