"""Constraint rows with static shapes and activity masks.

Port of the JAX package's ``ops/constraint.py`` for the rows the
port builds: equality rows of type connect, weld (on bodies or sites),
joint, tendon and flex (one row a non-rigid edge); dof and tendon friction
loss; joint limits on hinges, slides and balls, and tendon limits; and
pyramidal, elliptic or frictionless contacts, whose sides are a geom's
body or, on a flex element, the element's bodies with weights.  Every potential row exists every step;
an inactive row (an equality element switched off in its lane by
``eq_active``, a limit or contact out of reach) has a zero Jacobian and
D = 0, which makes it a no-op downstream, as C's packing leaves it out.
Row order follows C: equality, friction (dofs, then tendons), limits
(joints, then tendons), contacts.

The equality elements are grouped by kind (connect or weld, on bodies or
on sites, joint, and tendon) and each group is built in one batch over its
elements; a static permutation puts the rows back in element order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    ConeType,
    Data,
    DisableBit,
    EqType,
    JointType,
    Model,
    ObjType,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, math, support

# mjMINIMP / mjMAXIMP
_MINIMP = 0.0001
_MAXIMP = 0.9999

_EQ_ROWS = {EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1,
            EqType.TENDON: 1}
# the equality kinds whose one row couples two scalar positions
_SCALAR_EQ = (EqType.JOINT, EqType.TENDON)


class EqGroup(NamedTuple):
  """Equality elements of one kind, built as one batch."""
  kind: EqType
  site: bool              # connect/weld between sites (else bodies)
  ids: np.ndarray         # the elements, in id order
  # a flex group's rows: each element's non-rigid edges, one row each
  edges: tuple = ()

  @property
  def nrows(self) -> int:
    if self.kind == EqType.FLEX:
      return sum(len(e) for e in self.edges)
    return _EQ_ROWS[self.kind] * len(self.ids)

  def row_ids(self) -> np.ndarray:
    """The element of each of the group's rows."""
    if self.kind == EqType.FLEX:
      return np.repeat(self.ids, [len(e) for e in self.edges])
    return np.repeat(self.ids, _EQ_ROWS[self.kind])


def _flex_eq_edges(m: Model, f: int) -> np.ndarray:
  """The global ids of flex ``f``'s non-rigid edges."""
  fl = m.flex
  adr, num = int(fl.edgeadr[f]), int(fl.edgenum[f])
  return adr + np.nonzero(~fl.edge_rigid[adr:adr + num])[0]


class RowLayout(NamedTuple):
  """Static efc row layout of a model."""
  ne: int
  nf: int
  nl: int
  ncon_rows: int
  nefc: int
  eq_groups: tuple        # EqGroup, ...
  eq_perm: np.ndarray | None  # grouped rows -> element order; None: same
  friction_dof: np.ndarray  # dofs with friction loss, one row each
  friction_ten: np.ndarray  # tendons with friction loss, one row each
  limit_jnt: np.ndarray   # limited hinge/slide joints, one per row pair
  ball_jnt: np.ndarray    # limited ball joints, one row each
  limit_perm: np.ndarray | None  # limit rows -> joint order; None: same
  limit_ten: np.ndarray   # limited tendons, one per row pair, after joints

  @property
  def ncon_start(self) -> int:
    """The first contact row."""
    return self.ne + self.nf + self.nl


def elliptic(m: Model) -> bool:
  """Whether the model's friction cones are elliptic."""
  return m.opt.cone == ConeType.ELLIPTIC


def _build_row_layout(m: Model) -> RowLayout:
  # frictionless contacts take one row, pyramidal 2 (condim - 1), elliptic
  # condim
  dim = collision.contact_layout(m).dim
  ncon_rows = int(np.sum(np.where(dim == 1, 1, dim if elliptic(m)
                                  else 2 * (dim - 1))))
  flags = m.opt.disableflags
  on = lambda bit: not flags & (DisableBit.CONSTRAINT | bit)
  empty = np.zeros(0, np.int64)

  groups, keys = [], []
  if on(DisableBit.EQUALITY) and m.neq:
    site = m.eq_objtype == ObjType.SITE
    for kind in (EqType.CONNECT, EqType.WELD) + _SCALAR_EQ:
      for on_site in ((False,) if kind in _SCALAR_EQ else (False, True)):
        ids = np.nonzero((m.eq_type == kind) & (site == on_site))[0]
        if ids.size:
          groups.append(EqGroup(kind, on_site, ids))
    ids = np.nonzero(m.eq_type == EqType.FLEX)[0]
    if ids.size:
      groups.append(EqGroup(EqType.FLEX, False, ids, tuple(
          _flex_eq_edges(m, int(m.eq_obj1id[i])) for i in ids)))
    keys = [g.row_ids() for g in groups]
  ne = sum(len(k) for k in keys)
  eq_perm = None
  if len(groups) > 1:
    eq_perm = np.argsort(np.concatenate(keys), kind="stable")

  friction_dof = friction_ten = empty
  if on(DisableBit.FRICTIONLOSS):
    friction_dof = np.nonzero(m.dof_frictionloss_nz)[0]
    friction_ten = np.nonzero(m.tendon_frictionloss_nz)[0]

  limit_jnt = ball_jnt = limit_ten = empty
  limit_perm = None
  if on(DisableBit.LIMIT):
    limited = np.nonzero(m.jnt_limited)[0]
    jt = m.jnt_type[limited]
    limit_jnt = limited[(jt == JointType.HINGE) | (jt == JointType.SLIDE)]
    ball_jnt = limited[jt == JointType.BALL]
    if limit_jnt.size and ball_jnt.size:
      # C's order: joint by joint, two rows a hinge or slide, one a ball
      limit_perm = np.argsort(np.concatenate(
          [np.repeat(limit_jnt, 2), ball_jnt]), kind="stable")
    limit_ten = np.nonzero(m.tendon_limited)[0]
  nf = len(friction_dof) + len(friction_ten)
  nl = 2 * len(limit_jnt) + len(ball_jnt) + 2 * len(limit_ten)
  return RowLayout(ne=ne, nf=nf, nl=nl, ncon_rows=ncon_rows,
                   nefc=ne + nf + nl + ncon_rows, eq_groups=tuple(groups),
                   eq_perm=eq_perm, friction_dof=friction_dof,
                   friction_ten=friction_ten, limit_jnt=limit_jnt,
                   ball_jnt=ball_jnt, limit_perm=limit_perm,
                   limit_ten=limit_ten)


def row_layout(m: Model) -> RowLayout:
  """The static constraint row budget of ``m``."""
  return m.memo("row_layout", lambda: _build_row_layout(m))


def _impedance(solimp: torch.Tensor, pos: torch.Tensor, margin: torch.Tensor):
  """Impedance and its derivative per row (``getimpedance``)."""
  d0 = torch.clamp(solimp[..., 0], _MINIMP, _MAXIMP)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  width = torch.clamp(solimp[..., 2], min=0.0)
  mid = torch.clamp(solimp[..., 3], _MINIMP, _MAXIMP)
  power = torch.clamp(solimp[..., 4], min=1.0)

  flat = (d0 == dmax) | (width <= math.MINVAL)
  width_safe = torch.clamp(width, min=math.MINVAL)
  x_raw = (pos - margin) / width_safe
  sgn = torch.where(x_raw < 0, -1.0, 1.0)
  x = torch.clamp(torch.abs(x_raw), 0.0, 1.0)

  xm = torch.clamp(x, min=math.MINVAL)
  a = 1.0 / torch.clamp(mid, min=math.MINVAL) ** (power - 1)
  b = 1.0 / torch.clamp(1 - mid, min=math.MINVAL) ** (power - 1)
  one_mx = torch.clamp(1 - x, min=math.MINVAL)
  below = x <= mid
  y = torch.where(power == 1, x, torch.where(below, a * xm**power,
                                             1 - b * one_mx**power))
  yp = torch.where(power == 1, 1.0, torch.where(
      below, power * a * xm ** (power - 1), power * b * one_mx ** (power - 1)))

  saturated = (torch.abs(x_raw) >= 1) | (x <= 0)
  y_sat = torch.where(torch.abs(x_raw) >= 1, 1.0, 0.0)
  imp = torch.where(saturated, d0 + y_sat * (dmax - d0), d0 + y * (dmax - d0))
  impp = torch.where(saturated, 0.0, yp * sgn * (dmax - d0) / width_safe)
  return (torch.where(flat, 0.5 * (d0 + dmax), imp),
          torch.where(flat, 0.0, impp))


def _kbip(m: Model, solref, solimp, imp, impp,
          friction: bool = False) -> torch.Tensor:
  """Stiffness, damping, impedance, impedance' per row
  (``mj_makeImpedance``); solref/solimp are per row, or per lane and row.
  Friction rows have no stiffness."""
  ref0, ref1 = solref[..., 0], solref[..., 1]
  if not m.opt.disableflags & DisableBit.REFSAFE:
    ref0 = torch.where(ref0 > 0,
                       torch.clamp(ref0, min=2 * m.opt.timestep), ref0)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  k = torch.where(
      ref0 > 0,
      1.0 / torch.clamp(dmax**2 * ref0**2 * ref1**2, min=math.MINVAL),
      -ref0 / torch.clamp(dmax**2, min=math.MINVAL))
  if friction:
    k = torch.zeros_like(k)
  b = torch.where(ref1 > 0, 2.0 / torch.clamp(dmax * ref0, min=math.MINVAL),
                  -ref1 / torch.clamp(dmax, min=math.MINVAL))
  return torch.stack([k.expand_as(imp), b.expand_as(imp), imp, impp], dim=-1)


class _Rows(NamedTuple):
  """A block of r rows before impedance: per lane, the (B, r, nv)
  Jacobian and the (B, r) position, impedance position and activity; per
  row, the (r,) margin, (r, 2) solref, (r, 5) solimp and (r,) diagonal."""
  jac: torch.Tensor
  pos: torch.Tensor
  imp_pos: torch.Tensor
  active: torch.Tensor
  margin: torch.Tensor
  solref: torch.Tensor
  solimp: torch.Tensor
  diag: torch.Tensor


def _cat_rows(blocks, perm) -> _Rows:
  """The blocks' rows one after the other, reordered by ``perm``."""
  if len(blocks) == 1:
    return blocks[0]
  fields = []
  for i, f in enumerate(zip(*blocks)):
    dim = 1 if i < 4 else 0   # the per-lane fields lead with the lanes
    x = torch.cat(f, dim=dim)
    fields.append(x if perm is None else x.index_select(dim, perm))
  return _Rows(*fields)


def _limit_rows(m: Model, d: Data, jnts: np.ndarray) -> _Rows:
  """Two rows (lower, upper) per limited hinge/slide joint
  (``mj_instantiateLimit``)."""
  bsz, ns = d.batch, len(jnts)
  jj = m.const(jnts)
  value = d.qpos[:, m.const(m.jnt_qposadr[jnts])]
  rng = m.jnt_range[jj]
  margin = m.jnt_margin[jj]
  dist = torch.stack([value - rng[:, 0], rng[:, 1] - value], dim=-1)
  act = dist < margin[:, None]
  signs = torch.ones(2, dtype=value.dtype, device=value.device)
  signs[1] = -1.0
  jac = value.new_zeros((bsz, ns, 2, m.nv))
  jac[:, m.const(np.arange(ns)[:, None]), m.const(np.arange(2)[None]),
      m.const(m.jnt_dofadr[jnts][:, None])] = signs * act
  rep2 = lambda x: torch.repeat_interleave(x, 2, dim=0)
  dist = dist.reshape(bsz, -1)
  return _Rows(jac.reshape(bsz, 2 * ns, m.nv), dist, dist,
               act.reshape(bsz, -1), rep2(margin), rep2(m.jnt_solref[jj]),
               rep2(m.jnt_solimp[jj]),
               rep2(m.dof_invweight0[m.const(m.jnt_dofadr[jnts])]))


def _tendon_limit_rows(m: Model, d: Data, tens: np.ndarray) -> _Rows:
  """Two rows (lower, upper) per limited tendon (``mj_instantiateLimit``):
  the tendon length against its range, the Jacobian ± ten_J."""
  bsz, nt = d.batch, len(tens)
  tt = m.const(tens)
  value = d.ten_length[:, tt]
  rng = m.tendon_range[tt]
  margin = m.tendon_margin[tt]
  dist = torch.stack([value - rng[:, 0], rng[:, 1] - value], dim=-1)
  act = dist < margin[:, None]
  signs = m.const(np.array([1.0, -1.0]))
  jac = d.ten_J[:, tt, None, :] * (signs[:, None] * act[..., None])
  rep2 = lambda x: torch.repeat_interleave(x, 2, dim=0)
  dist = dist.reshape(bsz, -1)
  return _Rows(jac.reshape(bsz, 2 * nt, m.nv), dist, dist,
               act.reshape(bsz, -1), rep2(margin), rep2(m.tendon_solref_lim[tt]),
               rep2(m.tendon_solimp_lim[tt]), rep2(m.tendon_invweight0[tt]))


def _ball_limit_rows(m: Model, d: Data, jnts: np.ndarray) -> _Rows:
  """One row per limited ball joint (``mj_instantiateLimit``): the
  rotation angle of its quaternion against the larger range bound, the
  Jacobian minus the rotation axis.  The axis of a zero rotation is 0, not
  0/0, so an inactive row at the identity stays exactly zero."""
  nb = len(jnts)
  jj = m.const(jnts)
  quat = math.normalize_quat(
      d.qpos[:, m.const(m.jnt_qposadr[jnts][:, None] + np.arange(4))])
  aa = math.quat_sub(quat, m.const(np.array([1.0, 0.0, 0.0, 0.0])))
  angle = math.norm_safe(aa)
  axis = torch.where((angle > math.MINVAL)[..., None],
                     aa / angle[..., None], 0.0)
  margin = m.jnt_margin[jj]
  dist = torch.max(m.jnt_range[jj], dim=-1).values - angle
  act = dist < margin
  # out of place, so that torch.func transforms can batch it: dof v of
  # joint i's row reads component v - dofadr_i of the axis
  col = np.arange(m.nv)[None] - m.jnt_dofadr[jnts][:, None]   # (nb, nv)
  own = m.const((col >= 0) & (col < 3))
  row = torch.where(act[..., None], -axis, 0.0)
  jac = torch.where(own, torch.gather(
      row, 2, m.const(np.clip(col, 0, 2)).expand(d.batch, nb, m.nv)), 0.0)
  return _Rows(jac, dist, dist, act, margin, m.jnt_solref[jj],
               m.jnt_solimp[jj],
               m.dof_invweight0[m.const(m.jnt_dofadr[jnts])])


def _friction_rows(m: Model, d: Data, dofs: np.ndarray,
                   tens: np.ndarray) -> _Rows:
  """One row per dof, then per tendon, with friction loss
  (``mj_instantiateFriction``): a unit Jacobian or the tendon's, position
  0, always active."""
  nf = len(dofs) + len(tens)
  dd, tt = m.const(dofs), m.const(tens)
  jac = m.const(np.eye(m.nv)[dofs]).expand(d.batch, len(dofs), m.nv)
  if tens.size:
    jac = torch.cat([jac, d.ten_J[:, tt]], dim=1)
  cat = lambda a, b: torch.cat([a[dd], b[tt]])
  zero = jac.new_zeros((d.batch, nf))
  return _Rows(jac, zero, zero,
               torch.ones((d.batch, nf), dtype=torch.bool, device=jac.device),
               jac.new_zeros(nf), cat(m.dof_solref, m.tendon_solref_fri),
               cat(m.dof_solimp, m.tendon_solimp_fri),
               cat(m.dof_invweight0, m.tendon_invweight0))


def _eq_anchors(m: Model, d: Data, g: EqGroup):
  """World anchor points (B, K, 3) and bodies (K,) of both sides of a
  connect or weld group.  On bodies, the anchors are body-frame points of
  eq_data: connect (data[0:3], data[3:6]), weld (data[3:6], data[0:3])."""
  o1, o2 = m.eq_obj1id[g.ids], m.eq_obj2id[g.ids]
  if g.site:
    return ((d.site_xpos[:, m.const(o1)], m.site_bodyid[o1]),
            (d.site_xpos[:, m.const(o2)], m.site_bodyid[o2]))
  data = m.eq_data[m.const(g.ids)]
  first = (0, 3) if g.kind == EqType.CONNECT else (3, 0)
  return tuple(
      (math.matvec(d.xmat[:, m.const(o)], data[:, s:s + 3])
       + d.xpos[:, m.const(o)], o) for o, s in zip((o1, o2), first))


def _weld_frames(m: Model, d: Data, g: EqGroup, b1, b2):
  """(B, K, 4) orientations of a weld group's two sides: body 1's frame
  times relpose (data[6:10]) and body 2's frame; on sites, each site's
  frame."""
  q1, q2 = d.xquat[:, m.const(b1)], d.xquat[:, m.const(b2)]
  if g.site:
    return (math.quat_mul(q1, m.site_quat[m.const(m.eq_obj1id[g.ids])]),
            math.quat_mul(q2, m.site_quat[m.const(m.eq_obj2id[g.ids])]))
  return math.quat_mul(q1, m.eq_data[m.const(g.ids)][:, 6:10]), q2


def _pure(w: torch.Tensor) -> torch.Tensor:
  """The quaternion (0, w) of a 3-vector."""
  return torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1)


def _eq_rows(m: Model, d: Data, g: EqGroup) -> _Rows:
  """The rows of one group of equality elements (``mj_instantiateEquality``,
  with the diagonal of ``mj_diagApprox`` and the impedance position of
  ``getposdim``: the norm of a connect's or weld's residual)."""
  bsz, k, nv = d.batch, len(g.ids), m.nv
  ids = m.const(g.ids)
  if g.kind == EqType.FLEX:
    # each non-rigid edge: its length less length0 along the edge Jacobian
    # (``mj_instantiateEquality``), diagonal the edge's invweight0
    edges = m.const(np.concatenate(g.edges))
    rows = m.const(g.row_ids())
    pos = d.flexedge_length[:, edges] - m.flex.edge_length0[edges]
    return _Rows(d.flexedge_J[:, edges], pos, pos, d.eq_active[:, rows],
                 pos.new_zeros(len(edges)), m.eq_solref[rows],
                 m.eq_solimp[rows], m.flex.edge_invweight0[edges])
  r = _EQ_ROWS[g.kind]
  rep = lambda x: torch.repeat_interleave(x, r, dim=0)
  active = torch.repeat_interleave(d.eq_active[:, ids], r, dim=1)
  solref, solimp = rep(m.eq_solref[ids]), rep(m.eq_solimp[ids])
  if g.kind in _SCALAR_EQ:
    # object 1's position minus the quartic of object 2's (data[0:5]); a
    # single object reads object 2 as absent (its terms times 0).  A
    # joint's position is qpos - qpos0 with a unit Jacobian, a tendon's
    # ten_length - tendon_length0 with ten_J
    o1, o2 = m.eq_obj1id[g.ids], m.eq_obj2id[g.ids]
    two = m.const((o2 >= 0).astype(float))
    o2 = np.where(o2 >= 0, o2, o1)
    data = m.eq_data[ids]
    if g.kind == EqType.JOINT:
      qa = lambda o: (d.qpos[:, m.const(m.jnt_qposadr[o])]
                      - m.qpos0[m.const(m.jnt_qposadr[o])])
      row = lambda o: m.const(np.eye(nv)[m.jnt_dofadr[o]])
      invw = lambda o: m.dof_invweight0[m.const(m.jnt_dofadr[o])]
    else:
      qa = lambda o: d.ten_length[:, m.const(o)] - m.tendon_length0[m.const(o)]
      row = lambda o: d.ten_J[:, m.const(o)]
      invw = lambda o: m.tendon_invweight0[m.const(o)]
    dif = qa(o2) * two
    powers = torch.stack([torch.ones_like(dif), dif, dif**2, dif**3,
                          dif**4], dim=-1)
    pos = qa(o1) - torch.sum(data[:, :5] * powers, dim=-1)
    deriv = (data[:, 1] + 2 * data[:, 2] * dif + 3 * data[:, 3] * dif**2
             + 4 * data[:, 4] * dif**3) * two
    jac = row(o1) - deriv[..., None] * row(o2)
    diag = invw(o1) + two * invw(o2)
    return _Rows(jac, pos, pos, active, solref.new_zeros(k), solref, solimp,
                 diag)

  (p1, b1), (p2, b2) = _eq_anchors(m, d, g)
  jacp1, jacr1 = support.jac(m, d, p1, b1)
  jacp2, jacr2 = support.jac(m, d, p2, b2)
  jac = (jacp1 - jacp2).transpose(-1, -2)                 # (B, K, 3, nv)
  pos = p1 - p2                                           # (B, K, 3)
  invw = m.body_invweight0
  tran = invw[m.const(b1), 0] + invw[m.const(b2), 0]
  diag = tran[:, None].expand(k, 3)
  if g.kind == EqType.WELD:
    ts = m.eq_data[ids][:, 10, None]
    quat, q2 = _weld_frames(m, d, g, b1, b2)
    q2c = math.quat_conj(q2)
    crot = math.quat_mul(q2c, quat)[..., 1:] * ts
    # 0.5 ts vec(conj(q2) (0, w) quat) for each dof's w = jacr1 - jacr2
    jrot = math.quat_mul(math.quat_mul(q2c[:, :, None],
                                       _pure(jacr1 - jacr2)),
                         quat[:, :, None])[..., 1:]
    jac = torch.cat([jac, (0.5 * ts[:, None]) * jrot.transpose(-1, -2)],
                    dim=2)
    pos = torch.cat([pos, crot], dim=-1)
    rot = invw[m.const(b1), 1] + invw[m.const(b2), 1]
    diag = torch.cat([diag, rot[:, None].expand(k, 3)], dim=1)
  imp_pos = math.norm_safe(pos)[..., None].expand(bsz, k, r)
  return _Rows(jac.reshape(bsz, k * r, nv), pos.reshape(bsz, k * r),
               imp_pos.reshape(bsz, k * r), active, solref.new_zeros(k * r),
               solref, solimp, diag.reshape(-1))


def equality_wrenches(m: Model, d: Data):
  """The forces of the connect and weld rows as body wrenches, as
  ``mj_rnePostConstraint`` adds them to cfrc_ext: body 1 takes the
  translational force f at its anchor and a weld's rotational row forces
  as a torque, body 2 the opposite at its own anchor.  Returns (B, W, 6)
  wrenches [torque about the body's root subtree CoM; force] and the (W,)
  bodies; None without connect or weld rows."""
  lay = row_layout(m)
  # where each group's rows went in element order
  at = (np.arange(lay.ne) if lay.eq_perm is None
        else np.argsort(lay.eq_perm))
  start, out, bodies = 0, [], []
  for g in lay.eq_groups:
    rows = at[start:start + g.nrows]
    start += g.nrows
    if g.kind in _SCALAR_EQ or g.kind == EqType.FLEX:
      continue
    r, k = _EQ_ROWS[g.kind], len(g.ids)
    f = d.efc_force[:, m.const(rows)].reshape(d.batch, k, r)
    torque = f[..., 3:] if r == 6 else torch.zeros_like(f)
    for (p, b), sign in zip(_eq_anchors(m, d, g), (1.0, -1.0)):
      com = d.subtree_com[:, m.const(m.body_rootid[b])]
      out.append(sign * torch.cat([math.cross(p - com, f[..., :3]) + torque,
                                   f[..., :3]], dim=-1))
      bodies.append(b)
  if not out:
    return None
  return torch.cat(out, dim=1), np.concatenate(bodies)


def _eq_acc_bias(m: Model, d: Data) -> torch.Tensor:
  """(B, ne): what C subtracts from the reference acceleration of each
  equality row (``mj_referenceConstraint``): at the anchors of a connect
  or weld, J-dot qvel (``mj_jacDot``), and for a weld's rotation rows the
  time derivative of its rotation Jacobian, by the product rule over
  ts vec(conj(q2) (0, w) quat), contracted with qvel; zero on joint,
  tendon and flex edge rows."""
  lay = row_layout(m)
  out = []
  for g in lay.eq_groups:
    if g.kind in _SCALAR_EQ or g.kind == EqType.FLEX:
      out.append(d.qvel.new_zeros((d.batch, g.nrows)))
      continue
    (p1, b1), (p2, b2) = _eq_anchors(m, d, g)
    jp1, jr1 = support.jac_dot(m, d, p1, b1)
    jp2, jr2 = support.jac_dot(m, d, p2, b2)
    qv = d.qvel[:, None, :, None]
    bias = torch.sum((jp1 - jp2) * qv, dim=2)             # (B, K, 3)
    if g.kind == EqType.WELD:
      ts = m.eq_data[m.const(g.ids)][:, 10, None]
      quat, q2 = _weld_frames(m, d, g, b1, b2)
      q2c = math.quat_conj(q2)
      jacr1 = support.jac(m, d, p1, b1)[1]
      jacr2 = support.jac(m, d, p2, b2)[1]
      wd = _pure(torch.sum((jacr1 - jacr2) * qv, dim=2))
      wd_dot = _pure(torch.sum((jr1 - jr2) * qv, dim=2))
      w1 = _pure(d.cvel[:, m.const(b1), :3])
      w2 = _pure(-d.cvel[:, m.const(b2), :3])
      qm = math.quat_mul
      term = 0.5 * (0.5 * qm(qm(qm(q2c, w2), wd), quat)
                    + qm(qm(q2c, wd_dot), quat)
                    + 0.5 * qm(qm(qm(q2c, wd), w1), quat))
      bias = torch.cat([bias, ts * term[..., 1:]], dim=-1)
    out.append(bias.flatten(1))
  bias = torch.cat(out, dim=1) if len(out) > 1 else out[0]
  return bias if lay.eq_perm is None else bias[:, m.const(lay.eq_perm)]


def _contact_row_map(m: Model):
  """Static per-row tables (slot, friction axis k, sign); pyramidal rows
  come as (k, +1), (k, -1) per friction axis, elliptic ones as (k, 0) for
  k = 0 (the normal) .. condim - 1, frictionless as (0, 0)."""
  ell = elliptic(m)
  slot_idx, k_idx, sign = [], [], []
  for slot, condim in enumerate(collision.contact_layout(m).dim):
    if condim == 1 or ell:
      slot_idx += [slot] * condim
      k_idx += list(range(condim))
      sign += [0.0] * condim
    else:
      for k in range(1, condim):
        for s in (1.0, -1.0):
          slot_idx.append(slot)
          k_idx.append(k)
          sign.append(s)
  return np.array(slot_idx), np.array(k_idx), np.array(sign)


def slot_bodies(m: Model, con):
  """The bodies of each slot's two geoms, (B, ncon) each.  A flex element
  contact has no one body a side, and the JAX package gives its readers
  (touch, the contact wrenches of ``rne_postconstraint``) no meaning:
  refused, by name."""
  if con.bary_body is not None:
    raise NotImplementedError(
        "unsupported by the PyTorch port: a reader of the contact slots' "
        "bodies (touch, cfrc_ext) on a model with flex element contacts")
  bodyid = m.const(m.geom_bodyid)
  return bodyid[con.geom1], bodyid[con.geom2]


def _contact_rows(m: Model, d: Data):
  """Contact rows (``mj_instantiateContact``, contact ``mj_diagApprox``,
  ``mj_makeImpedance``).  Pyramidal: every row carries the contact's
  distance, R = Rpy = 2 mu_reg^2 R0.  Elliptic: the normal row carries
  the distance and margin, the friction rows 0; R1 = R0 / impratio and
  Rj mu_j^2 = R1 mu_1^2; the friction rows have no stiffness and take
  their damping from solreffriction where a <pair> sets it.  Returns (J,
  pos, margin, active, KBIP, R, D)."""
  con = d.contact
  ell = elliptic(m)
  slot_idx, k_idx, sign_np = _contact_row_map(m)
  nrows = len(slot_idx)
  si = m.const(slot_idx)
  ar = m.const(np.arange(nrows))
  if con.bary_body is None:
    b1, b2 = slot_bodies(m, con)

  frame = con.frame[:, si]                               # (B, R, 3, 3)
  mu_row = con.friction[..., si, m.const(np.maximum(k_idx - 1, 0))]
  if ell:
    # row k: the translational axis k of the frame for k < 3, the
    # rotational axis k - 3 above
    is_t = k_idx < 3
    w_t = (frame[:, ar, m.const(np.where(is_t, k_idx, 0))]
           * m.const(is_t.astype(float))[:, None])
    w_r = (frame[:, ar, m.const(np.where(is_t, 0, k_idx - 3))]
           * m.const((~is_t).astype(float))[:, None])
  else:
    n_dir = frame[..., 0, :]
    is_tan = (k_idx >= 1) & (k_idx <= 2)
    tan_row = m.const(np.where(is_tan, np.maximum(k_idx, 1), 1))
    rot_row = m.const(np.where(k_idx >= 3, k_idx - 3, 0))
    sign_mu = (m.const(sign_np) * mu_row)[..., None]
    w_t = n_dir + sign_mu * (frame[:, ar, tan_row]
                             * m.const(is_tan.astype(float))[:, None])
    w_r = sign_mu * (frame[:, ar, rot_row]
                     * m.const((k_idx >= 3).astype(float))[:, None])

  p_row = con.pos[:, si]
  com = d.subtree_com[:, m.const(m.body_rootid)]
  cdof_t = d.cdof.transpose(1, 2)
  dof_mask = m.const(m.tree.body_dof_mask)
  com_of = lambda b: torch.take_along_dim(com, b[..., None], dim=1)

  def side_rows(bids):
    off = p_row - com_of(bids)
    u = torch.cat([math.cross(off, w_t) + w_r, w_t], dim=-1)
    return torch.where(dof_mask[bids], u @ cdof_t, 0.0)   # (B, R, nv)

  invw = m.body_invweight0
  if con.bary_body is None:
    rows_j = side_rows(b2[:, si]) - side_rows(b1[:, si])
    tran = invw[b1, 0] + invw[b2, 0]                     # (B, ncon)
  else:
    # each side: the weighted sum over its bodies (``mj_elemBodyWeight``;
    # a geom's side is its body at weight 1), in the Jacobian and in the
    # diagonal approximation
    bb, bw = con.bary_body[:, si], con.bary_w[:, si]     # (B, R, 2, W)
    rows_j = 0.0
    for side, sign in ((1, 1.0), (0, -1.0)):
      for k in range(bb.shape[-1]):
        rows_j = rows_j + (sign * bw[:, :, side, k, None]) * side_rows(
            bb[:, :, side, k])
    tran = torch.sum(con.bary_w * invw[con.bary_body, 0], dim=(-1, -2))
  imp, impp = _impedance(con.solimp, con.dist, con.includemargin)
  kbip = _kbip(m, con.solref, con.solimp, imp, impp)     # (B, ncon, 4)
  active = con.dist < con.includemargin
  mu0 = con.friction[..., 0]
  rows_active = active[:, si]
  normal = m.const(k_idx == 0)
  if ell:
    r0 = torch.clamp((1 - imp) * tran / imp, min=math.MINVAL)
    r1 = r0 / max(math.MINVAL, m.opt.impratio)
    rows_r = torch.where(normal, r0[:, si], r1[:, si] * mu0[..., si] ** 2
                         / torch.clamp(mu_row**2, min=math.MINVAL))
    srf = con.solreffriction[..., si, :]
    own = torch.any(srf != 0, dim=-1, keepdim=True)
    kbip_f = _kbip(m, torch.where(own, srf, con.solref[..., si, :]),
                   con.solimp[..., si, :], imp[:, si], impp[:, si],
                   friction=True)
    rows_kbip = torch.where(normal[:, None], kbip[:, si], kbip_f)
    rows_pos = torch.where(normal, con.dist[:, si], 0.0)
    rows_margin = torch.where(normal, con.includemargin[..., si], 0.0)
  else:
    da0 = torch.where(m.const(collision.contact_layout(m).dim == 1), tran,
                      tran + mu0**2 * tran)
    r0 = torch.clamp((1 - imp) * da0 / imp, min=math.MINVAL)
    r_py = 2.0 * (mu0 / np.sqrt(m.opt.impratio))**2 * r0
    rows_r = torch.where(normal, r0[:, si], r_py[:, si])
    rows_kbip = kbip[:, si]
    rows_pos = con.dist[:, si]
    rows_margin = con.includemargin[..., si]
  rows_d = torch.where(rows_active, 1.0 / rows_r, 0.0)
  return (rows_j * rows_active[..., None], rows_pos,
          rows_margin.expand(d.batch, nrows), rows_active, rows_kbip, rows_r,
          rows_d)


def _finish(m: Model, rows: _Rows, friction: bool = False):
  """Impedance, KBIP, R and D of a block of rows (``mj_makeImpedance``,
  with the block's ``mj_diagApprox`` diagonal)."""
  imp, impp = _impedance(rows.solimp, rows.imp_pos, rows.margin)
  r = torch.clamp((1 - imp) * rows.diag / imp, min=math.MINVAL)
  return (rows.jac, rows.pos, rows.margin.expand(rows.pos.shape[0], -1),
          rows.active, _kbip(m, rows.solref, rows.solimp, imp, impp,
                             friction), r,
          torch.where(rows.active, 1.0 / r, 0.0))


def _frictionloss(m: Model) -> torch.Tensor:
  """(nefc,): each row's friction loss, zero outside the friction rows."""
  lay = row_layout(m)
  out = torch.zeros(lay.nefc, dtype=m.dtype, device=m.device)
  out[lay.ne:lay.ne + lay.nf] = torch.cat([
      m.dof_frictionloss[m.const(lay.friction_dof)],
      m.tendon_frictionloss[m.const(lay.friction_ten)]])
  return out


def make_constraint(m: Model, d: Data) -> Data:
  """Builds every constraint row (``mj_makeConstraint``)."""
  lay = row_layout(m)
  parts = []
  if lay.ne:
    perm = None if lay.eq_perm is None else m.const(lay.eq_perm)
    parts.append(_finish(m, _cat_rows(
        [_eq_rows(m, d, g) for g in lay.eq_groups], perm)))
  if lay.nf:
    parts.append(_finish(m, _friction_rows(m, d, lay.friction_dof,
                                           lay.friction_ten), friction=True))
  if lay.nl:
    blocks = []
    if lay.limit_jnt.size:
      blocks.append(_limit_rows(m, d, lay.limit_jnt))
    if lay.ball_jnt.size:
      blocks.append(_ball_limit_rows(m, d, lay.ball_jnt))
    perm = None if lay.limit_perm is None else m.const(lay.limit_perm)
    blocks = [_cat_rows(blocks, perm)] if blocks else []
    if lay.limit_ten.size:
      blocks.append(_tendon_limit_rows(m, d, lay.limit_ten))
    parts.append(_finish(m, _cat_rows(blocks, None)))
  if lay.ncon_rows:
    parts.append(_contact_rows(m, d))
  if not parts:
    return d.replace(efc_J=None)
  jac, pos, margin, active, kbip, r, dvec = (
      torch.cat(p, dim=1) if len(parts) > 1 else p[0] for p in zip(*parts))
  floss = m.memo("efc_frictionloss", lambda: _frictionloss(m))
  return d.replace(efc_J=jac * active[..., None], efc_pos=pos,
                   efc_margin=margin, efc_D=dvec, efc_R=r, efc_KBIP=kbip,
                   efc_active=active,
                   efc_frictionloss=floss.expand(d.batch, -1))


def reference_constraint(m: Model, d: Data) -> Data:
  """aref = -B vel - K imp (pos - margin) - bias
  (``mj_referenceConstraint``), with the equality rows' bias of
  ``_eq_acc_bias``."""
  lay = row_layout(m)
  if lay.nefc == 0:
    return d
  vel = math.matvec(d.efc_J, d.qvel)
  k, b, imp = d.efc_KBIP[..., 0], d.efc_KBIP[..., 1], d.efc_KBIP[..., 2]
  aref = -b * vel - k * imp * (d.efc_pos - d.efc_margin)
  if lay.ne:
    aref = torch.cat([aref[:, :lay.ne] - _eq_acc_bias(m, d),
                      aref[:, lay.ne:]], dim=1)
  return d.replace(efc_aref=aref * d.efc_active)


def row_kinds(m: Model) -> tuple[torch.Tensor, torch.Tensor]:
  """(nefc,) masks of the equality rows and of the friction rows."""

  def kinds():
    lay = row_layout(m)
    idx = np.arange(lay.nefc)
    return (m.const(idx < lay.ne),
            m.const((idx >= lay.ne) & (idx < lay.ne + lay.nf)))

  return m.memo("row_kinds", kinds)


class ConeTables(NamedTuple):
  """Static gather tables of the elliptic contacts (slots with condim >
  1): each slot's efc rows, padded to 6 with its first row."""
  nes: int
  slot: np.ndarray        # (nes,) contact slot
  rows: np.ndarray        # (nes, 6) efc rows
  rmask: np.ndarray       # (nes, 6) bool: a row of the slot
  is_ell: np.ndarray      # (nefc,) bool: an elliptic row
  flat: np.ndarray        # (nefc,) an elliptic row's place in (nes * 6)


def cone_tables(m: Model) -> ConeTables:
  """The elliptic cone tables of ``m`` (``nes = 0`` for pyramidal
  cones)."""

  def build():
    lay = row_layout(m)
    dim = collision.contact_layout(m).dim
    slot = np.nonzero(dim > 1)[0] if elliptic(m) else np.zeros(0, np.int64)
    first = lay.ncon_start + np.concatenate(
        [[0], np.cumsum(np.where(dim == 1, 1, dim))[:-1]]).astype(np.int64)
    j = np.arange(6)
    rmask = j[None] < dim[slot][:, None]
    rows = first[slot][:, None] + np.where(rmask, j[None], 0)
    is_ell = np.zeros(lay.nefc, bool)
    flat = np.zeros(lay.nefc, np.int64)
    is_ell[rows[rmask]] = True
    flat[rows[rmask]] = np.nonzero(rmask.reshape(-1))[0]
    return ConeTables(len(slot), slot, rows, rmask, is_ell, flat)

  return m.memo("cone_tables", build)


class Cone(NamedTuple):
  """The elliptic slots at one jar (the elliptic branch of
  ``mj_constraintUpdate``), each (B, nes[, 6]): U = jar_j coef_j in the
  dual cone's coordinates with coef = (mu, friction...), N = U_0, T the
  norm of U's friction part (kept off 0 before its square root), Dm =
  D_0 / (mu^2 (1 + mu^2)), and the zones (top: no force; bottom: each
  row quadratic; middle: the cone's force)."""
  U: torch.Tensor
  N: torch.Tensor
  T: torch.Tensor
  Dm: torch.Tensor
  mu: torch.Tensor
  coef: torch.Tensor
  jar: torch.Tensor       # the slots' rows of jar (0 on the padding)
  top: torch.Tensor
  bottom: torch.Tensor
  middle: torch.Tensor


def cone_quantities(m: Model, d: Data, jar: torch.Tensor) -> Cone:
  """The elliptic slots' cone coordinates and zones at ``jar``."""
  ct = cone_tables(m)
  rmask = m.const(ct.rmask.astype(float))
  fr = d.contact.friction[..., m.const(ct.slot), :]      # ([B,] nes, 5)
  mu = fr[..., 0] / np.sqrt(max(math.MINVAL, m.opt.impratio))
  coef = torch.cat([mu[..., None], fr], dim=-1) * rmask
  jar_rows = jar[:, m.const(ct.rows)] * rmask            # (B, nes, 6)
  u = jar_rows * coef
  n = u[..., 0]
  t2 = torch.sum(u[..., 1:] ** 2, dim=-1)
  # the square root's argument is kept off 0, so that its tangent stays
  # finite where the friction part vanishes (C: mjMINVAL)
  t = torch.sqrt(torch.clamp(t2, min=math.MINVAL**2))
  d0 = d.efc_D[:, m.const(ct.rows[:, 0])]
  dm = d0 / torch.clamp(mu * mu * (1 + mu * mu), min=math.MINVAL)
  no_t = t2 <= math.MINVAL**2
  top = (n >= mu * t) | (no_t & (n >= 0))
  bottom = ((mu * n + t <= 0) & ~top) | (no_t & (n < 0))
  return Cone(u, n, t, dm, mu.expand_as(n), coef.expand_as(u), jar_rows,
              top, bottom, ~top & ~bottom)


def _cone_rows(m: Model, x: torch.Tensor) -> torch.Tensor:
  """(B, nes[, ...]) per elliptic slot -> (B, nefc[, ...]) on its rows."""
  return x[:, m.const(cone_tables(m).flat // 6)]


def cone_hessian(m: Model, c: Cone) -> torch.Tensor:
  """(B, nes, 6, 6): each middle-zone slot's cone Hessian (the
  ``flg_coneHessian`` branch of ``mj_constraintUpdate``), zero in the
  other zones and on the padding:
  Dm coef_i coef_j [[1, -mu U'/T], [-mu U/T, mu N U U'/T^3 + (mu^2 -
  mu N / T) I]]."""
  u, n, t, mu = c.U, c.N, c.T, c.mu
  uf = u[..., 1:]
  s1 = (-mu / t)[..., None] * uf                          # (B, nes, 5)
  corner = torch.ones_like(n)[..., None, None]
  block = ((mu * n / t**3)[..., None, None] * uf[..., :, None]
           * uf[..., None, :]
           + (mu * mu - mu * n / t)[..., None, None]
           * torch.eye(5, dtype=u.dtype, device=u.device))
  h = torch.cat([torch.cat([corner, s1[..., None, :]], dim=-1),
                 torch.cat([s1[..., :, None], block], dim=-1)], dim=-2)
  h = h * (c.Dm[..., None, None] * c.coef[..., :, None]
           * c.coef[..., None, :])
  return torch.where(c.middle[..., None, None], h, 0.0)


def zones(m: Model, d: Data, jar: torch.Tensor):
  """The zones of ``mj_constraintUpdate`` at ``jar``: (quadratic, linear
  negative, linear positive) masks, the last two None without equality
  and friction rows.  Equality rows are always quadratic; a friction row
  is linear below -R floss (force +floss) and above R floss (force
  -floss), quadratic between; limits, frictionless and pyramidal contacts
  are inequalities, quadratic exactly when jar < 0.  An elliptic
  contact's rows are left out: their zone is their slot's
  (``cone_quantities``), which ``forces_cost`` and the line search read."""
  lay = row_layout(m)
  quad = jar < 0
  ct = cone_tables(m)
  if ct.nes:
    quad = quad & ~m.const(ct.is_ell)
  if not lay.ne and not lay.nf:
    return quad, None, None
  is_eq, is_fri = row_kinds(m)
  rf = d.efc_R * d.efc_frictionloss
  lin_neg = is_fri & (jar <= -rf)
  lin_pos = is_fri & (jar >= rf)
  return (torch.where(is_eq | is_fri, ~lin_neg & ~lin_pos, quad), lin_neg,
          lin_pos)


def forces_cost(m: Model, d: Data, jar: torch.Tensor):
  """Constraint force, cost and quadratic-zone mask at ``jar = J qacc -
  aref`` (``mj_constraintUpdate``), by the zones of ``zones``; an
  elliptic slot in its middle zone takes the cone's force
  f_0 = -Dm (N - mu T) mu, f_j = -f_0 U_j coef_j / T, and costs
  Dm (N - mu T)^2 / 2."""
  ct = cone_tables(m)
  quad, lin_neg, lin_pos = zones(m, d, jar)
  if lin_neg is None:
    force = torch.where(quad, -d.efc_D * jar, 0.0)
    cost = 0.5 * torch.sum(torch.where(quad, d.efc_D * jar * jar, 0.0),
                           dim=-1)
  else:
    floss = d.efc_frictionloss
    force = torch.where(quad, -d.efc_D * jar, 0.0)
    force = torch.where(lin_neg, floss, torch.where(lin_pos, -floss, force))
    half = 0.5 * d.efc_R * floss * floss
    cost = torch.sum(torch.where(
        quad, 0.5 * d.efc_D * jar * jar, torch.where(
            lin_neg, -half - floss * jar, torch.where(
                lin_pos, -half + floss * jar, 0.0))), dim=-1)
  if ct.nes:
    c = cone_quantities(m, d, jar)
    d_rows = d.efc_D[:, m.const(ct.rows)]
    nmt = c.N - c.mu * c.T
    f0 = -c.Dm * nmt * c.mu
    f_mid = torch.cat([f0[..., None],
                       (-f0 / c.T)[..., None] * c.U[..., 1:] * c.coef[..., 1:]],
                      dim=-1)
    f_cone = torch.where(c.middle[..., None], f_mid, torch.where(
        c.bottom[..., None], -d_rows * c.jar, 0.0))
    is_ell = m.const(ct.is_ell)
    force = torch.where(is_ell, f_cone.flatten(1)[:, m.const(ct.flat)], force)
    cost = cost + torch.sum(torch.where(
        c.bottom, 0.5 * torch.sum(d_rows * c.jar * c.jar, dim=-1),
        torch.where(c.middle, 0.5 * c.Dm * nmt * nmt, 0.0)), dim=-1)
    quad = torch.where(is_ell, _cone_rows(m, c.bottom), quad)
  return force * d.efc_active, cost, quad


def constraint_update(m: Model, d: Data, jar: torch.Tensor) -> Data:
  """efc_force and qfrc_constraint at ``jar``."""
  force, _, _ = forces_cost(m, d, jar)
  qfrc = math.matvec(d.efc_J.transpose(1, 2), force)
  return d.replace(efc_force=force, qfrc_constraint=qfrc)


def _contact_force_map(m: Model) -> tuple[torch.Tensor, torch.Tensor]:
  """Two (ncon_rows, 6 ncon) maps of each contact row into its slot's
  force in the contact frame, (normal, friction).  Pyramidal
  (``mju_decodePyramid``): every row adds 1 into the normal, and the
  rows of friction axis k add ±1 into component k, which
  ``contact_forces_frame`` scales by the lane's mu_k.  Elliptic: row k is
  component k, all in the first map."""
  clay = collision.contact_layout(m)
  slot_idx, k_idx, sign = _contact_row_map(m)
  rows = np.arange(len(slot_idx))
  shape = (len(slot_idx), clay.ncon, 6)
  normal = torch.zeros(shape, dtype=m.dtype, device=m.device)
  friction = torch.zeros(shape, dtype=m.dtype, device=m.device)
  if elliptic(m):
    normal[m.const(rows), m.const(slot_idx), m.const(k_idx)] = 1.0
  else:
    normal[m.const(rows), m.const(slot_idx), 0] = 1.0
    fric = np.nonzero(k_idx >= 1)[0]
    friction[m.const(rows[fric]), m.const(slot_idx[fric]),
             m.const(k_idx[fric])] = m.const(sign[fric])
  return (normal.reshape(len(slot_idx), -1),
          friction.reshape(len(slot_idx), -1))


def contact_forces_frame(m: Model, d: Data) -> torch.Tensor:
  """Each contact slot's force and torque in its contact frame, (B, ncon,
  6) (``mj_contactForce``): for pyramidal rows the normal force is the sum
  of the slot's rows and friction component k is the lane's mu_k times
  the difference of axis k's pair of rows; elliptic rows are the
  components themselves; a frictionless slot's one row is its normal
  force.  Inactive slots read zero."""
  lay = row_layout(m)
  clay = collision.contact_layout(m)
  f_rows = d.efc_force[:, lay.ncon_start:]
  normal, friction = m.memo("contact_force_map",
                            lambda: _contact_force_map(m))
  out = f_rows @ normal
  if not elliptic(m):
    slot_idx, k_idx, _ = _contact_row_map(m)
    mu = d.contact.friction[:, m.const(slot_idx),
                            m.const(np.maximum(k_idx - 1, 0))]
    out = out + (f_rows * mu) @ friction
  return out.reshape(d.batch, clay.ncon, 6)
