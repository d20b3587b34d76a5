"""Smooth dynamics: kinematics, CoM frames, CRB, mass-matrix factor, RNE.

Port of ``mujoco_inversedynamicstest_tpu/ops/smooth.py``.  The JAX package's
level-wise masked vectorization carries over unchanged: bodies at equal tree
depth are updated together, joint-type variation is handled by selects on
static masks, and the mass matrix is one dense ``(nv, 6) @ (6, nv)`` product
masked by the ancestor pattern.  Every ``Data`` tensor has a leading fleet
dimension ``B``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    JointType,
    Model,
    TrnType,
    WrapType,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import linalg, math, support
from mujoco_inversedynamicstest_tpu_torch.ops import wrap


def _quat_adr(m: Model) -> np.ndarray:
  """qpos addresses of the quaternion segments (ball and free joints)."""
  jt = m.jnt_type
  return np.concatenate([m.jnt_qposadr[jt == JointType.BALL],
                         m.jnt_qposadr[jt == JointType.FREE] + 3])


def kinematics(m: Model, d: Data) -> Data:
  """Forward kinematics (``mj_kinematics``): body, joint, geom and site
  frames, with the mocap bodies at their lane's mocap pose.

  Normalizes the quaternion segments of qpos like the reference.  (The JAX
  package sets the mocap bodies' poses after the tree pass, so a child of
  a mocap body does not follow it there.)
  """
  qpos = d.qpos.clone()
  quat_adr = _quat_adr(m)
  if quat_adr.size:
    idx = m.const(quat_adr[:, None] + np.arange(4)[None, :])
    qpos[:, idx] = math.normalize_quat(qpos[:, idx])

  bsz, nb = qpos.shape[0], m.nbody
  xpos = qpos.new_zeros((bsz, nb, 3))
  xquat = qpos.new_zeros((bsz, nb, 4))
  xquat[..., 0] = 1.0
  xanchor = qpos.new_zeros((bsz, m.njnt, 3))
  xaxis = qpos.new_zeros((bsz, m.njnt, 3))
  up = qpos.new_zeros(3)
  up[2] = 1.0

  for lvl, bodies in enumerate(m.tree.body_levels):
    par = m.const(m.body_parentid[bodies])
    b = m.const(bodies)
    pos = xpos[:, par] + math.rotate(m.body_pos[b], xquat[:, par])
    quat = math.quat_mul(xquat[:, par], m.body_quat[b])

    for k in range(m.tree.level_max_jnts[lvl]):
      valid_np = k < m.body_jntnum[bodies]
      jids = np.where(valid_np, m.body_jntadr[bodies] + k, 0)
      jtype = m.jnt_type[jids]
      win = np.clip(m.jnt_qposadr[jids][:, None] + np.arange(7)[None, :], 0,
                    m.nq - 1)
      qwin = qpos[:, m.const(win)]                  # (B, L, 7)
      q0win = m.qpos0[m.const(win)]                 # (L, 7)
      jpos = m.jnt_pos[m.const(jids)]
      jaxis = m.jnt_axis[m.const(jids)]

      anchor_world = math.rotate(jpos, quat) + pos
      axis_world = math.rotate(jaxis, quat)

      is_free = m.const((jtype == JointType.FREE)[:, None])
      is_ball = m.const((jtype == JointType.BALL)[:, None])
      is_hinge = m.const((jtype == JointType.HINGE)[:, None])

      free_pos = qwin[..., 0:3]
      free_quat = math.normalize_quat(qwin[..., 3:7])
      ball_quat = math.quat_mul(quat, math.normalize_quat(qwin[..., 0:4]))
      ball_pos = anchor_world - math.rotate(jpos, ball_quat)
      angle = qwin[..., 0] - q0win[:, 0]
      hinge_quat = math.quat_mul(quat, math.axis_angle_quat(jaxis, angle))
      hinge_pos = anchor_world - math.rotate(jpos, hinge_quat)
      slide_pos = pos + axis_world * angle[..., None]

      new_pos = torch.where(is_free, free_pos, torch.where(
          is_ball, ball_pos, torch.where(is_hinge, hinge_pos, slide_pos)))
      new_quat = torch.where(is_free, free_quat, torch.where(
          is_ball, ball_quat, torch.where(is_hinge, hinge_quat, quat)))
      anchor = torch.where(is_free, free_pos, anchor_world)
      axis = torch.where(is_free, up, axis_world)

      vmask = m.const(valid_np[:, None])
      pos = torch.where(vmask, new_pos, pos)
      quat = torch.where(vmask, new_quat, quat)
      sel = np.nonzero(valid_np)[0]
      xanchor[:, m.const(jids[sel])] = anchor[:, m.const(sel)]
      xaxis[:, m.const(jids[sel])] = axis[:, m.const(sel)]

    # mocap bodies (children of the world, without joints) take their pose
    # from the lane's mocap_pos and normalized mocap_quat, and their
    # children move with them
    mocapid = m.body_mocapid[bodies]
    if np.any(mocapid >= 0):
      is_mocap = m.const((mocapid >= 0)[:, None])
      mid = m.const(np.maximum(mocapid, 0))
      pos = torch.where(is_mocap, d.mocap_pos[:, mid], pos)
      quat = torch.where(is_mocap, math.normalize_quat(d.mocap_quat[:, mid]),
                         quat)

    xpos[:, b] = pos
    xquat[:, b] = quat

  xmat = math.quat_to_mat(xquat)
  xipos, ximat = math.local_to_global(xpos, xquat, m.body_ipos, m.body_iquat)
  # geom and site frames in one local_to_global: the sites add no launch.
  # The compiler leaves a geom's quaternion a few ulp off unit length (a
  # mesh's principal frame turned by quarter turns: 0.5000000000000007 x
  # 4); C's mju_quat2Mat is homogeneous and gives that frame exact zeros,
  # quat_to_mat only for a unit quaternion, and C's plane-mesh rule breaks a
  # tie of equally deep vertices by those zeros
  body, pos, quat = m.memo("geom_site_frames", lambda: (
      m.const(np.concatenate([m.geom_bodyid, m.site_bodyid])),
      torch.cat([m.geom_pos, m.site_pos]),
      torch.cat([math.normalize_quat(m.geom_quat), m.site_quat])))
  fpos, fmat = math.local_to_global(xpos[:, body], xquat[:, body], pos, quat)
  ng = m.ngeom
  return d.replace(qpos=qpos, xpos=xpos, xquat=xquat, xmat=xmat,
                   xanchor=xanchor, xaxis=xaxis, xipos=xipos, ximat=ximat,
                   geom_xpos=fpos[:, :ng], geom_xmat=fmat[:, :ng],
                   site_xpos=fpos[:, ng:], site_xmat=fmat[:, ng:])


def rank_groups(index: np.ndarray) -> tuple[np.ndarray, ...]:
  """Positions of ``index`` split into groups in which no value repeats:
  group k holds every value's k-th occurrence, in order.

  ``index_add_`` with repeated indices adds with atomics on the card, in an
  order that changes from run to run and from lane to lane; one
  ``index_add_`` a group makes the sums deterministic, in the order the CPU
  takes (one add after the other, by position).  Lanes that hold the same
  state then step to the same bits, which the column copies of
  ``opt.derivative.transition_ad`` need.
  """
  seen: dict[int, int] = {}
  rank = np.empty(len(index), dtype=np.int64)
  for i, v in enumerate(np.asarray(index).tolist()):
    rank[i] = seen.get(v, 0)
    seen[v] = rank[i] + 1
  return tuple(np.nonzero(rank == k)[0]
               for k in range(int(rank.max(initial=-1)) + 1))


def ordered_index_add(m: Model, out: torch.Tensor, index: np.ndarray,
                      src: torch.Tensor, key) -> torch.Tensor:
  """``out.index_add_(1, index, src)`` with a fixed order of the adds into
  each slot (see ``rank_groups``); ``key`` names the index for the model's
  memo."""
  for grp in m.memo(("rank_groups", key), lambda: rank_groups(index)):
    out.index_add_(1, m.const(index[grp]), src[:, m.const(grp)])
  return out


def tree_sum_up(m: Model, x: torch.Tensor) -> torch.Tensor:
  """Subtree sums of per-body quantities ``x`` (B, nbody, ...): deepest
  level first, children add into their parents, siblings in body order."""
  x = x.clone()
  for lvl in range(len(m.tree.body_levels) - 1, -1, -1):
    bodies = m.tree.body_levels[lvl]
    ordered_index_add(m, x, m.body_parentid[bodies],
                      x[:, m.const(bodies)], ("tree_sum_up", lvl))
  return x


def com_pos(m: Model, d: Data) -> Data:
  """Subtree CoM, CoM-frame inertias and dof axes (``mj_comPos``)."""
  mass = m.body_mass
  mass_pos = tree_sum_up(m, d.xipos * mass[:, None])
  mass_sum = tree_sum_up(m, mass.expand(d.batch, m.nbody))
  com = mass_pos / torch.clamp(mass_sum, min=math.MINVAL)[..., None]
  subtree_com = torch.where((mass_sum < math.MINVAL)[..., None], d.xipos, com)

  # cinert: body inertia rotated to world, parallel-axis shift to the root
  # subtree CoM, packed as [triu(I), m * off, m]
  off = d.xipos - subtree_com[:, m.const(m.body_rootid)]
  rot = d.ximat
  i_world = (rot * m.body_inertia[:, None, :]) @ rot.transpose(-1, -2)
  off2 = torch.sum(off * off, dim=-1)
  eye = torch.eye(3, dtype=off.dtype, device=off.device)
  shift = (off2[..., None, None] * eye - off[..., :, None] * off[..., None, :]
           ) * mass[:, None, None]
  i_tot = i_world + shift
  r_idx = m.const(np.array([0, 1, 2, 0, 0, 1]))
  c_idx = m.const(np.array([0, 1, 2, 1, 2, 2]))
  cinert = torch.cat([i_tot[..., r_idx, c_idx], off * mass[:, None],
                      mass[:, None].expand(d.batch, m.nbody, 1)], dim=-1)

  # cdof: all nv dofs at once, by dof category
  nv = m.nv
  dof_jnt = m.dof_jntid
  jtype = m.jnt_type[dof_jnt]
  dof_off = np.arange(nv) - m.jnt_dofadr[dof_jnt]
  anchor = d.xanchor[:, m.const(dof_jnt)]
  offset = subtree_com[:, m.const(m.body_rootid[m.dof_bodyid])] - anchor
  xaxis = d.xaxis[:, m.const(dof_jnt)]
  col = np.clip(np.where(jtype == JointType.FREE, dof_off - 3, dof_off), 0, 2)
  # column `col` of the body rotation = row `col` of its transpose
  xmat_t = d.xmat[:, m.const(m.dof_bodyid)].transpose(-1, -2)
  rot_axis = xmat_t[:, m.const(np.arange(nv)), m.const(col)]

  is_free_trans = (jtype == JointType.FREE) & (dof_off < 3)
  is_rot = ((jtype == JointType.FREE) & (dof_off >= 3)) | (
      jtype == JointType.BALL)
  is_hinge = jtype == JointType.HINGE
  is_slide = jtype == JointType.SLIDE
  e_trans = m.const(np.eye(3)[np.clip(dof_off, 0, 2)])

  rot_m = m.const(is_rot[:, None])
  ang = torch.where(rot_m, rot_axis,
                    torch.where(m.const(is_hinge[:, None]), xaxis, 0.0))
  lin_axis = torch.where(rot_m, rot_axis, xaxis)
  lin = torch.where(
      m.const(is_free_trans[:, None]), e_trans,
      torch.where(m.const(is_slide[:, None]), xaxis,
                  torch.where(m.const((is_rot | is_hinge)[:, None]),
                              math.cross(lin_axis, offset), 0.0)))
  cdof = torch.cat([ang, lin], dim=-1)
  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def camlight(m: Model, d: Data) -> Data:
  """Camera frames ``cam_xpos``, ``cam_xmat`` (B, ncam, ...) by each
  camera's mode (``mj_camlight``): fixed to its body; TRACK and TRACKCOM
  at an offset from its body's frame or subtree CoM, in a fixed world
  orientation; TARGETBODY and TARGETBODYCOM turned to look at the target's
  frame or subtree CoM.  From a completed ``com_pos``; nothing without
  cameras."""
  if not m.ncam:
    return d
  body = m.const(m.cam_bodyid)
  xmat = d.xmat[:, body]
  pos = d.xpos[:, body] + math.matvec(xmat, m.cam_pos)
  mat = xmat @ math.quat_to_mat(m.cam_quat)
  mode, target = m.cam_mode, m.cam_targetbodyid
  track, trackcom = mode == 1, mode == 2
  if np.any(track | trackcom):
    pos = torch.where(m.const(track[:, None]), d.xpos[:, body] + m.cam_pos0,
                      torch.where(m.const(trackcom[:, None]),
                                  d.subtree_com[:, body] + m.cam_poscom0, pos))
    mat = torch.where(m.const((track | trackcom)[:, None, None]), m.cam_mat0,
                      mat)
  look = ((mode == 3) | (mode == 4)) & (target >= 0)
  if np.any(look):
    tgt = m.const(np.where(look, target, 0))
    at = torch.where(m.const((mode == 3)[:, None]), d.xpos[:, tgt],
                     d.subtree_com[:, tgt])
    z = math.normalize(pos - at)        # minus the view direction
    up = m.const(np.array([0.0, 0.0, 1.0]))
    x = math.normalize(math.cross(up, z))
    y = math.normalize(math.cross(z, x))
    mat = torch.where(m.const(look[:, None, None]),
                      torch.stack([x, y, z], dim=-1), mat)
  return d.replace(cam_xpos=pos, cam_xmat=mat)


def _point_rows(m: Model, d: Data, points: torch.Tensor, bodies: np.ndarray,
                w: torch.Tensor) -> torch.Tensor:
  """(B, K, nv): w_k . jacp(point_k) for K points (B, K, 3) on the host
  ``bodies`` (K,), each along its own direction w (B, K, 3) (``mj_jac``
  contracted: cdof_lin . w + cdof_ang . (off x w) on the dofs that move the
  body)."""
  off = points - d.subtree_com[:, m.const(m.body_rootid[bodies])]
  u = torch.cat([math.cross(off, w), w], dim=-1)
  rows = u @ d.cdof.transpose(1, 2)
  return torch.where(m.const(m.tree.body_dof_mask[bodies]), rows, 0.0)


def flex_needs_jacobian(m: Model) -> bool:
  """Whether an edge row, an edge spring-damper or the element elasticity
  reads the edge Jacobian (``mj_flex`` skips it otherwise)."""
  fl = m.flex
  return bool(np.any(fl.edgeequality & ~fl.rigid & (fl.interp == 0))
              or fl.has_edge_sd or fl.has_elasticity)


def flex(m: Model, d: Data) -> Data:
  """Flex vertex positions, edge lengths and, where something reads them,
  edge Jacobians (``mj_flex``).  A vertex sits at its body's frame, at
  its body-local position unless the flex is centered; a trilinear
  flex's vertex is its static weights times its 8 node bodies' positions.
  Edge e's Jacobian row is u_e . (jacp(v2) - jacp(v1)), u_e the unit edge
  vector."""
  fl = m.flex
  if fl is None:
    return d
  if np.any(fl.interp):
    parts = []
    for f in range(fl.nflex):
      na, nn = int(fl.nodeadr[f]), int(fl.nodenum[f])
      nodes = d.xpos[:, m.const(fl.nodebodyid[na:na + nn])]   # (B, nn, 3)
      parts.append(m.const(fl.interp_w[f]) @ nodes)
    xpos = torch.cat(parts, dim=1)
  else:
    vb = m.const(fl.vertbodyid)
    local = m.const(np.where(fl.centered[fl.vertflexid][:, None], 0.0,
                             fl.vert))
    xpos = d.xpos[:, vb] + math.matvec(d.xmat[:, vb], local)
  v1, v2 = fl.edge[:, 0], fl.edge[:, 1]
  vec = xpos[:, m.const(v2)] - xpos[:, m.const(v1)]
  length = math.norm_safe(vec)
  d = d.replace(flexvert_xpos=xpos, flexedge_length=length)
  if not flex_needs_jacobian(m):
    return d
  u = vec / length[..., None]
  vb = fl.vertbodyid
  jac = (_point_rows(m, d, xpos[:, m.const(v2)], vb[v2], u)
         - _point_rows(m, d, xpos[:, m.const(v1)], vb[v1], u))
  return d.replace(flexedge_J=jac)


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body mass matrix, dense (``mj_crb``)."""
  crb_body = tree_sum_up(m, d.cinert)
  crb_body[:, 0] = 0.0
  buf = math.inert_mul(crb_body[:, m.const(m.dof_bodyid)], d.cdof)
  full = buf @ d.cdof.transpose(1, 2)
  lower = torch.where(m.const(m.tree.ancestor_mask), full, 0.0)
  qm = lower + lower.transpose(1, 2) - torch.diag_embed(
      torch.diagonal(lower, dim1=1, dim2=2))
  return d.replace(crb=crb_body, qM=qm + torch.diag(m.dof_armature))


def _dof_blocks(m: Model):
  """Independent dof blocks (root subtrees of the dof forest) grouped by
  size, ``{size: (nblk,) starts}``; None for a single mechanism."""
  nv = m.nv
  if nv < 2:
    return None
  par = m.dof_parentid
  root = np.arange(nv)
  for k in range(nv):
    root[k] = root[par[k]] if par[k] >= 0 else k
  starts = np.nonzero(np.concatenate([[True], root[1:] != root[:-1]]))[0]
  if len(starts) < 2:
    return None
  sizes = np.diff(np.concatenate([starts, [nv]]))
  for s, sz in zip(starts, sizes):
    if not np.all(root[s:s + sz] == root[s]):
      return None
  groups = {}
  for s, sz in zip(starts, sizes):
    groups.setdefault(int(sz), []).append(int(s))
  return {sz: np.asarray(ss) for sz, ss in groups.items()}


def factor_m(m: Model, d: Data) -> Data:
  """Cholesky factor of qM (``mj_factorM``), through ``linalg.chol_factor``.

  Scenes with several independent mechanisms factor each same-size group of
  diagonal blocks as one batch of small matrices.
  """
  blocks = m.memo("dof_blocks", lambda: _dof_blocks(m))
  if blocks is None:
    return d.replace(qLD=linalg.chol_factor(d.qM))
  bsz = d.batch
  qld = torch.zeros_like(d.qM)
  for sz, starts in sorted(blocks.items()):
    idx = starts[:, None] + np.arange(sz)[None]               # (nblk, sz)
    rows, cols = m.const(idx[:, :, None]), m.const(idx[:, None, :])
    sub = d.qM[:, rows, cols].reshape(-1, sz, sz)
    qld[:, rows, cols] = linalg.chol_factor(sub).reshape(bsz, -1, sz, sz)
  return d.replace(qLD=qld)


def solve_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
  """Solves M y = x with the factor in ``d.qLD``; x is (B, nv[, k])."""
  blocks = m.memo("dof_blocks", lambda: _dof_blocks(m))
  if blocks is None:
    return linalg.chol_solve(d.qLD, x)
  bsz = d.batch
  y = torch.zeros_like(x)
  for sz, starts in sorted(blocks.items()):
    idx = starts[:, None] + np.arange(sz)[None]
    rows, cols = m.const(idx[:, :, None]), m.const(idx[:, None, :])
    lsub = d.qLD[:, rows, cols].reshape(-1, sz, sz)
    xi = m.const(idx)
    rhs = x[:, xi].reshape((-1, sz) + x.shape[2:])
    y[:, xi] = linalg.chol_solve(lsub, rhs).reshape(
        (bsz, -1, sz) + x.shape[2:])
  return y


def mul_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
  """M @ x for x of shape (B, nv) (``mj_mulM``)."""
  return math.matvec(d.qM, x)


def com_vel(m: Model, d: Data) -> Data:
  """Body CoM-frame velocities and dof-axis rates (``mj_comVel``).

  Within a body, joints apply in slot order with the reference's update
  rules: hinge/slide/ball dofs see the velocity before the joint; free
  joints apply translation first, and their rotation dofs see the velocity
  after it.
  """
  bsz, nb, nv = d.batch, m.nbody, m.nv
  cvel = d.qvel.new_zeros((bsz, nb, 6))
  cdof_dot = d.qvel.new_zeros((bsz, nv, 6))
  slot6 = np.arange(6)[None, :]

  for lvl, bodies in enumerate(m.tree.body_levels):
    vel = cvel[:, m.const(m.body_parentid[bodies])]
    for k in range(m.tree.level_max_jnts[lvl]):
      valid_np = k < m.body_jntnum[bodies]
      jids = np.where(valid_np, m.body_jntadr[bodies] + k, 0)
      jtype = m.jnt_type[jids]
      width = np.array([6, 3, 1, 1])[jtype]
      win = np.clip(m.jnt_dofadr[jids][:, None] + slot6, 0, nv - 1)
      wmask = (slot6 < width[:, None]) & valid_np[:, None]
      is_free = (jtype == JointType.FREE)[:, None]

      cd = d.cdof[:, m.const(win)]                          # (B, L, 6, 6)
      qv = d.qvel[:, m.const(win)] * m.const(wmask.astype(float))
      trans_sel = m.const((is_free & (slot6 < 3)).astype(float))
      vel_mid = vel + torch.einsum("blw,blwc->blc", qv * trans_sel, cd)

      cdd_pre = math.motion_cross(vel[:, :, None, :], cd)
      cdd_mid = math.motion_cross(vel_mid[:, :, None, :], cd)
      cdd = torch.where(m.const((is_free & (slot6 >= 3))[..., None]),
                        cdd_mid, cdd_pre)
      cdd = torch.where(m.const((is_free & (slot6 < 3))[..., None]), 0.0, cdd)

      rows, cols = np.nonzero(wmask)
      cdof_dot[:, m.const(win[rows, cols])] = cdd[:, m.const(rows),
                                                  m.const(cols)]
      vel = vel + torch.einsum("blw,blwc->blc", qv, cd)
    cvel[:, m.const(bodies)] = vel

  return d.replace(cvel=cvel, cdof_dot=cdof_dot)


class _TendonLayout(NamedTuple):
  """Host tables of the tendons: the fixed tendons as linear maps of qpos
  and qvel, and every spatial tendon's path cut into segments, a straight
  one from site to site or a wrap from site around a geom to site, each
  weighted by 1 / its branch's pulley divisor."""
  len_map: np.ndarray     # (ntendon, nq) fixed tendons' coefficients
  jac_map: np.ndarray     # (ntendon, nv)
  straight: tuple         # (site0 (S,), site1 (S,), weight (ntendon, S))
  wraps: tuple            # per (is_sphere, ...): see _build_tendon_layout


def _build_tendon_layout(m: Model) -> _TendonLayout:
  len_map = np.zeros((m.ntendon, m.nq))
  jac_map = np.zeros((m.ntendon, m.nv))
  straight = ([], [], [], [])          # site0, site1, tendon, weight
  wraps = {True: ([], [], [], [], [], [], []),
           False: ([], [], [], [], [], [], [])}
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    types = m.wrap_type[adr:adr + num]
    if np.all(types == WrapType.JOINT):
      for w in range(adr, adr + num):
        j = int(m.wrap_objid[w])
        len_map[t, m.jnt_qposadr[j]] += m.wrap_prm[w]
        jac_map[t, m.jnt_dofadr[j]] += m.wrap_prm[w]
      continue
    divisor, j = 1.0, adr
    while j < adr + num - 1:
      t0, t1 = types[j - adr], types[j + 1 - adr]
      if t0 == WrapType.PULLEY or t1 == WrapType.PULLEY:
        if t0 == WrapType.PULLEY:
          divisor = float(m.wrap_prm[j])
        j += 1
        continue
      s0 = int(m.wrap_objid[j])
      if t1 == WrapType.SITE:
        for lst, v in zip(straight, (s0, int(m.wrap_objid[j + 1]), t,
                                     1.0 / divisor)):
          lst.append(v)
        j += 1
        continue
      is_sphere = bool(t1 == WrapType.SPHERE)
      side = int(round(float(m.wrap_prm[j + 1])))
      for lst, v in zip(wraps[is_sphere], (
          s0, int(m.wrap_objid[j + 1]), int(m.wrap_objid[j + 2]),
          max(side, 0), side >= 0, t, 1.0 / divisor)):
        lst.append(v)
      j += 2

  def weight(tendons, weights):
    w = np.zeros((m.ntendon, len(tendons)))
    w[tendons, np.arange(len(tendons))] = weights
    return w

  s0, s1, ts = (np.asarray(x, dtype=np.int64) for x in straight[:3])
  straight = (s0, s1, weight(ts, np.asarray(straight[3], dtype=float)))
  groups = []
  for is_sphere, (s0, geom, s1, side, has_side, ts, ws) in wraps.items():
    if ts:
      ints = lambda x: np.asarray(x, dtype=np.int64)
      groups.append((is_sphere, ints(s0), ints(geom), ints(s1), ints(side),
                     np.asarray(has_side, dtype=bool),
                     weight(ints(ts), np.asarray(ws, dtype=float))))
  return _TendonLayout(len_map, jac_map, straight, tuple(groups))


def _segments(m: Model, d: Data, p0, b0: np.ndarray, p1, b1: np.ndarray):
  """Lengths (B, K) and length Jacobians (B, K, nv) of K straight
  segments from p0 on bodies b0 to p1 on bodies b1 (``mj_tendon``'s
  segment: the unit direction times the difference of the end points'
  Jacobians, zero where both ends are on one body)."""
  dif = p1 - p0
  length = torch.sqrt(torch.sum(dif * dif, dim=-1))
  unit = torch.where((length < math.MINVAL)[..., None],
                     m.const(np.array([1.0, 0.0, 0.0])),
                     dif / torch.clamp(length, min=math.MINVAL)[..., None])
  jac = support.jac(m, d, p1, b1)[0] - support.jac(m, d, p0, b0)[0]
  jac = torch.sum(jac * unit[:, :, None, :], dim=-1)
  return length, jac * m.const((b0 != b1).astype(float))[:, None]


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths and Jacobians (``mj_tendon``).  Fixed tendons are
  static linear maps of qpos.  Spatial tendons are cut on the host into
  straight and wrap segments (``_build_tendon_layout``), each kind
  evaluated in one batch over the fleet and all its segments, and summed
  into the tendons by static weight matrices, out of place."""
  if not m.ntendon:
    return d
  lay = m.memo("tendon_layout", lambda: _build_tendon_layout(m))
  length = d.qpos @ m.const(lay.len_map).T
  jac = m.const(lay.jac_map).expand(d.batch, m.ntendon, m.nv)
  s0, s1, w = lay.straight
  if s0.size:
    ln, jr = _segments(m, d, d.site_xpos[:, m.const(s0)], m.site_bodyid[s0],
                       d.site_xpos[:, m.const(s1)], m.site_bodyid[s1])
    length = length + ln @ m.const(w).T
    jac = jac + torch.einsum("ts,bsv->btv", m.const(w), jr)
  for is_sphere, s0, geom, s1, side, has_side, w in lay.wraps:
    p0, p1 = d.site_xpos[:, m.const(s0)], d.site_xpos[:, m.const(s1)]
    b0, b1, bg = m.site_bodyid[s0], m.site_bodyid[s1], m.geom_bodyid[geom]
    gg = m.const(geom)
    shape = p0.shape[:-1]
    wlen, w0, w1 = wrap.wrap(
        p0, p1, d.geom_xpos[:, gg], d.geom_xmat[:, gg],
        m.geom_size[gg, 0].expand(shape), d.site_xpos[:, m.const(side)],
        m.const(has_side).expand(shape), is_sphere)
    l_ss, j_ss = _segments(m, d, p0, b0, p1, b1)
    l_sg, j_sg = _segments(m, d, p0, b0, w0, bg)
    l_gs, j_gs = _segments(m, d, w1, bg, p1, b1)
    no_wrap = wlen < 0
    ln = torch.where(no_wrap, l_ss, l_sg + torch.clamp(wlen, min=0.0) + l_gs)
    jr = torch.where(no_wrap[..., None], j_ss, j_sg + j_gs)
    length = length + ln @ m.const(w).T
    jac = jac + torch.einsum("ts,bsv->btv", m.const(w), jr)
  return d.replace(ten_length=length, ten_J=jac)


def _transmission_pieces(m: Model):
  """Host tables of ``transmission``: the actuators by kind (hinge or
  slide joint, ball, free, tendon, site, site with a reference site,
  slider-crank, body)."""
  trn, jid = m.actuator_trntype, m.actuator_trnid[:, 0]
  joint = (trn == TrnType.JOINT) | (trn == TrnType.JOINTINPARENT)
  jt = np.where(joint, m.jnt_type[np.where(joint, jid, 0)], -1)
  site = trn == TrnType.SITE
  ref = m.actuator_trnid[:, 1] >= 0
  return tuple(np.nonzero(sel)[0] for sel in (
      joint & ((jt == JointType.HINGE) | (jt == JointType.SLIDE)),
      jt == JointType.BALL, jt == JointType.FREE, trn == TrnType.TENDON,
      site & ~ref, site & ref, trn == TrnType.SLIDERCRANK,
      trn == TrnType.BODY))


def _common_ancestor_dofs(m: Model, b0: int, b1: int) -> np.ndarray:
  """The dofs of the chain two bodies share (``mj_transmission``'s refsite
  search): walking up the dof tree from each body's weld's last dof until
  the two meet, that dof and its ancestors; none where they never meet."""
  w0, w1 = int(m.body_weldid[b0]), int(m.body_weldid[b1])
  if m.body_dofnum[w0] == 0 or m.body_dofnum[w1] == 0:
    return np.zeros(0, np.int64)
  d0 = int(m.body_dofadr[w0] + m.body_dofnum[w0] - 1)
  d1 = int(m.body_dofadr[w1] + m.body_dofnum[w1] - 1)
  while d0 != d1:
    if d0 < d1:
      d1 = int(m.dof_parentid[d1])
    else:
      d0 = int(m.dof_parentid[d0])
    if d0 == -1 or d1 == -1:
      return np.zeros(0, np.int64)
  chain = []
  while d0 >= 0:
    chain.append(d0)
    d0 = int(m.dof_parentid[d0])
  return np.array(chain, np.int64)


def _site_moment(jacp, jacr, force, torque) -> torch.Tensor:
  """(B, K, nv): jacpᵀ force + jacrᵀ torque of K points (B, K, nv, 3)."""
  return (torch.einsum("bkvc,bkc->bkv", jacp, force)
          + torch.einsum("bkvc,bkc->bkv", jacr, torque))


def _site_transmission(m: Model, d: Data, sel: np.ndarray):
  """SITE transmissions without a reference site: length 0, the moment of
  the gear's wrench in the site's frame at the site."""
  sid = m.actuator_trnid[sel, 0]
  s = m.const(sid)
  jacp, jacr = support.jac(m, d, d.site_xpos[:, s], m.site_bodyid[sid])
  smat = d.site_xmat[:, s]
  g = m.actuator_gear[m.const(sel)]
  return (d.qpos.new_zeros((d.batch, len(sel))),
          _site_moment(jacp, jacr, math.matvec(smat, g[:, :3]),
                       math.matvec(smat, g[:, 3:])))


def _refsite_transmission(m: Model, d: Data, sel: np.ndarray):
  """SITE transmissions with a reference site: length the site's position
  and rotation in the reference site's frame, weighted by the gear; the
  moment the difference of the two sites' Jacobians, less the dofs the two
  bodies share, along the gear rotated into the reference frame.  The
  sites' rotations are site_quat * xquat, in C's order."""
  sid, rid = m.actuator_trnid[sel, 0], m.actuator_trnid[sel, 1]
  s, r = m.const(sid), m.const(rid)
  bid, rbid = m.site_bodyid[sid], m.site_bodyid[rid]

  def shared():
    keep = np.ones((len(sel), m.nv))
    for k, (b0, b1) in enumerate(zip(bid, rbid)):
      keep[k, _common_ancestor_dofs(m, int(b0), int(b1))] = 0.0
    return m.const(keep)

  keep = m.memo(("refsite_dofs", sel.tobytes()), shared)
  jacp, jacr = support.jac(m, d, d.site_xpos[:, s], bid)
  jacp_r, jacr_r = support.jac(m, d, d.site_xpos[:, r], rbid)
  rmat = d.site_xmat[:, r]
  g = m.actuator_gear[m.const(sel)]
  vec = math.mat_t_vec(rmat, d.site_xpos[:, s] - d.site_xpos[:, r])
  quat = math.quat_mul(m.site_quat[s], d.xquat[:, m.const(bid)])
  refquat = math.quat_mul(m.site_quat[r], d.xquat[:, m.const(rbid)])
  length = (torch.sum(vec * g[:, :3], dim=-1)
            + torch.sum(math.quat_sub(quat, refquat) * g[:, 3:], dim=-1))
  moment = _site_moment(jacp - jacp_r, jacr - jacr_r,
                        math.matvec(rmat, g[:, :3]),
                        math.matvec(rmat, g[:, 3:])) * keep
  return length, moment


def _crank_transmission(m: Model, d: Data, sel: np.ndarray):
  """SLIDERCRANK transmissions: the slider's travel along its site's z axis
  from the crank pin, a rod of ``actuator_cranklength`` between them (where
  the rod cannot reach, the projection alone), and its derivative through
  both sites' Jacobians; both times the gear."""
  sid, slid = m.actuator_trnid[sel, 0], m.actuator_trnid[sel, 1]
  c, s = m.const(sid), m.const(slid)
  k = m.const(sel)
  rod = m.actuator_cranklength[k]
  axis = d.site_xmat[:, s, :, 2]
  vec = d.site_xpos[:, c] - d.site_xpos[:, s]
  av = torch.sum(vec * axis, dim=-1)
  det = av * av + rod * rod - torch.sum(vec * vec, dim=-1)
  ok = det > 0
  sdet = torch.sqrt(torch.clamp(det, min=math.MINVAL))
  length = av - torch.where(ok, sdet, 0.0)
  one_m = (1.0 - av / sdet)[..., None]
  dldv = torch.where(ok[..., None], axis * one_m + vec / sdet[..., None], axis)
  dlda = torch.where(ok[..., None], vec * one_m, vec)
  jacp_c, _ = support.jac(m, d, d.site_xpos[:, c], m.site_bodyid[sid])
  jacp_s, jacr_s = support.jac(m, d, d.site_xpos[:, s], m.site_bodyid[slid])
  jac_axis = math.cross(jacr_s, axis[:, :, None])
  g0 = m.actuator_gear[k, 0]
  return length * g0, _site_moment(jac_axis, jacp_c - jacp_s, dlda,
                                   dldv) * g0[:, None]


def _body_transmission(m: Model, d: Data, sel: np.ndarray):
  """BODY transmissions (adhesion): length 0, the moment minus the mean of
  the normal Jacobians (from the contact frame, body 2's less body 1's) of
  the lane's contacts of the body, 0 without any.  As in C, a contact
  counts up to its margin plus its gap, rows or none (a pair kind whose
  narrowphase stops at the margin reports none in the gap)."""
  length = d.qpos.new_zeros((d.batch, len(sel)))
  if not collision.contact_layout(m).ncon:
    return length, d.qpos.new_zeros((d.batch, len(sel), m.nv))
  con = d.contact
  b1, b2 = constraint.slot_bodies(m, con)
  n = con.frame[..., 0, :]
  root = m.const(m.body_rootid)
  mask = m.const(m.tree.body_dof_mask)

  def side(b):
    com = torch.take_along_dim(d.subtree_com, root[b][..., None], dim=1)
    u = torch.cat([math.cross(con.pos - com, n), n], dim=-1)
    return torch.where(mask[b], u @ d.cdof.transpose(1, 2), 0.0)

  jn = side(b2) - side(b1)                                 # (B, ncon, nv)
  bid = m.const(m.actuator_trnid[sel, 0])[:, None]
  kept = con.dist < con.includemargin + collision.slot_gaps(m, con)
  counted = (kept[:, None]
             & ((b1[:, None] == bid) | (b2[:, None] == bid))).to(jn.dtype)
  count = counted.sum(-1, keepdim=True)
  return length, -(counted @ jn) / torch.clamp(count, min=1.0)


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and dense (nu, nv) moments (``mj_transmission``) for
  joint transmissions (on any joint; JOINTINPARENT rotates a ball's or a
  free joint's rotational gear into the joint's frame), tendon, site (with
  or without a reference site), slider-crank and body (adhesion)
  transmissions, from a completed collision; built out of place, so that
  ``torch.func`` transforms can batch it."""
  if not m.nu:
    return d
  (scalar, ball, free, ten, site, refsite, crank,
   body) = m.memo("transmission", lambda: _transmission_pieces(m))
  jid, gear = m.actuator_trnid[:, 0], m.actuator_gear
  inparent = m.actuator_trntype == TrnType.JOINTINPARENT
  lengths, moments = [], []
  if scalar.size:
    adr = m.const(m.jnt_qposadr[jid[scalar]])

    def scalar_constants():
      g0 = gear[m.const(scalar), 0]
      mom = np.zeros((len(scalar), m.nv))
      mom[np.arange(len(scalar)), m.jnt_dofadr[jid[scalar]]] = 1.0
      return g0, m.const(mom) * g0[:, None]

    g0, mom = m.memo("scalar_transmission", scalar_constants)
    lengths.append((scalar, d.qpos[:, adr] * g0))
    moments.append((scalar, mom))
  for sel, off in ((ball, 0), (free, 3)):
    if not sel.size:
      continue
    quat = math.normalize_quat(d.qpos[:, m.const(
        m.jnt_qposadr[jid[sel]][:, None] + off + np.arange(4))])
    g = gear[m.const(sel), off:off + 3].expand(quat.shape[:-1] + (3,))
    g = torch.where(m.const(inparent[sel][:, None]),
                    math.rotate(g, math.quat_conj(quat)), g)
    if off == 0:
      axis = math.quat_sub(quat, m.const(np.array([1.0, 0.0, 0.0, 0.0])))
      lengths.append((sel, torch.sum(axis * g, dim=-1)))
      vals = g
    else:
      lengths.append((sel, quat.new_zeros(quat.shape[:-1])))
      vals = torch.cat([gear[m.const(sel), :3].expand_as(g), g], dim=-1)
    width = vals.shape[-1]
    place = np.zeros((len(sel), width, m.nv))
    for k, j in enumerate(jid[sel]):
      place[k, np.arange(width), m.jnt_dofadr[j] + np.arange(width)] = 1.0
    moments.append((sel, torch.einsum("bkc,kcv->bkv", vals, m.const(place))))
  if ten.size:
    tid = m.const(jid[ten])
    g0 = gear[m.const(ten), 0]
    lengths.append((ten, d.ten_length[:, tid] * g0))
    moments.append((ten, d.ten_J[:, tid] * g0[:, None]))
  for sel, fn in ((site, _site_transmission), (refsite, _refsite_transmission),
                  (crank, _crank_transmission), (body, _body_transmission)):
    if sel.size:
      length, moment = fn(m, d, sel)
      lengths.append((sel, length))
      moments.append((sel, moment))
  if len(lengths) == 1:
    # one kind, in actuator order
    return d.replace(actuator_length=lengths[0][1],
                     actuator_moment=moments[0][1].expand(d.batch, m.nu, m.nv))
  length = support.assemble(m, "actuator_length", lengths)
  moment = support.assemble(m, "actuator_moment", [
      (idx, v.transpose(-1, -2)) for idx, v in moments]).transpose(-1, -2)
  return d.replace(actuator_length=length,
                   actuator_moment=moment.expand(d.batch, m.nu, m.nv))


def rne(m: Model, d: Data, flg_acc: bool = False) -> torch.Tensor:
  """Recursive Newton-Euler: C(qpos, qvel) [+ M qacc] -> (B, nv)."""
  bsz, nb = d.batch, m.nbody
  dof_body = m.const(m.dof_bodyid)
  contrib = d.cdof_dot * d.qvel[..., None]
  if flg_acc:
    contrib = contrib + d.cdof * d.qacc[..., None]
  body_contrib = ordered_index_add(m, contrib.new_zeros((bsz, nb, 6)),
                                   m.dof_bodyid, contrib, "dof_bodyid")
  cacc = contrib.new_zeros((bsz, nb, 6))
  if not m.opt.disableflags & DisableBit.GRAVITY:
    cacc[:, 0, 3:] = -m.opt.gravity
  for bodies in m.tree.body_levels:
    b = m.const(bodies)
    cacc[:, b] = cacc[:, m.const(m.body_parentid[bodies])] + body_contrib[:, b]

  cfrc = math.inert_mul(d.cinert, cacc) + math.force_cross(
      d.cvel, math.inert_mul(d.cinert, d.cvel))
  cfrc[:, 0] = 0.0
  cfrc = tree_sum_up(m, cfrc)
  return torch.sum(d.cdof * cfrc[:, dof_body], dim=-1)


def _nonworld(m: Model) -> torch.Tensor:
  """(nbody, 1): 0 for the world body, 1 for every other."""
  return m.const((np.arange(m.nbody) > 0)[:, None].astype(float))


def subtree_vel(m: Model, d: Data) -> tuple[torch.Tensor, torch.Tensor]:
  """Subtree linear velocity and angular momentum (``mj_subtreeVel``),
  each (B, nbody, 3), about each subtree's CoM, from a completed velocity
  stage."""
  mass = m.body_mass[:, None]
  smass = m.body_subtreemass[:, None]
  off = d.xipos - d.subtree_com[:, m.const(m.body_rootid)]
  ang = d.cvel[..., :3]
  lin = d.cvel[..., 3:] + math.cross(ang, off)
  linvel = tree_sum_up(m, lin * mass) / torch.clamp(smass, min=math.MINVAL)

  # each body's angular momentum about its CoM, then about its subtree's
  # CoM; a subtree's total adds each child's total about the child's
  # subtree CoM and the child subtree's momentum about the parent's
  rot = d.ximat
  own = math.matvec((rot * m.body_inertia[:, None, :]) @ rot.transpose(-1, -2),
                    ang)
  own = own + math.cross(d.xipos - d.subtree_com,
                         (lin - linvel) * mass) * _nonworld(m)
  par = m.const(m.body_parentid)
  shift = math.cross(d.subtree_com - d.subtree_com[:, par],
                     (linvel - linvel[:, par]) * smass)
  # tree_sum_up adds each child's total (own + shift) into its parent
  angmom = tree_sum_up(m, own + shift) - shift
  return linvel, angmom


def rne_postconstraint(m: Model, d: Data) -> Data:
  """Body accelerations and forces of the complete dynamics
  (``mj_rnePostConstraint``): ``cacc`` with qacc, ``cfrc_ext`` (the
  applied wrenches, the active contacts' and the connect and weld
  constraints' wrenches, at the subtree CoM) and ``cfrc_int``, the force
  each body takes from its parent, summed up the tree (world's row: the
  force the world takes, as C leaves it)."""
  nonworld = _nonworld(m)
  xfrc = d.xfrc_applied
  off = d.subtree_com[:, m.const(m.body_rootid)] - d.xipos
  cfrc_ext = torch.cat([xfrc[..., 3:] - math.cross(off, xfrc[..., :3]),
                        xfrc[..., :3]], dim=-1) * nonworld
  clay = collision.contact_layout(m)
  if clay.ncon:
    con = d.contact
    force = constraint.contact_forces_frame(m, d)
    f_world = math.mat_t_vec(con.frame, force[..., :3])
    t_world = math.mat_t_vec(con.frame, force[..., 3:])
    b1, b2 = constraint.slot_bodies(m, con)

    def wrench(bodies):
      com = torch.take_along_dim(d.subtree_com, m.const(m.body_rootid)[
          bodies][..., None], dim=1)
      return torch.cat([t_world - math.cross(com - con.pos, f_world),
                        f_world], dim=-1)

    # body 1 takes -wrench, body 2 +wrench, the world nothing: one product
    # with each lane's (nbody, 2 ncon) table of signs, in a fixed order
    body = m.const(np.arange(1, m.nbody))[:, None]
    on = lambda b: (b[:, None] == body).to(cfrc_ext.dtype)
    table = torch.cat([-on(b1), on(b2)], dim=2)
    table = torch.cat([torch.zeros_like(table[:, :1]), table], dim=1)
    cfrc_ext = cfrc_ext + table @ torch.cat(
        [wrench(b1), wrench(b2)], dim=1)

  eq = constraint.equality_wrenches(m, d) if constraint.row_layout(
      m).ne else None
  if eq is not None:
    wrench, bodies = eq

    def eq_table():
      s = np.zeros((m.nbody, len(bodies)))
      s[bodies, np.arange(len(bodies))] = 1.0
      s[0] = 0.0
      return m.const(s)

    cfrc_ext = cfrc_ext + m.memo("equality_wrench_table", eq_table) @ wrench

  contrib = d.cdof_dot * d.qvel[..., None] + d.cdof * d.qacc[..., None]
  body_contrib = ordered_index_add(m, contrib.new_zeros((d.batch, m.nbody, 6)),
                                   m.dof_bodyid, contrib, "dof_bodyid")
  cacc = contrib.new_zeros((d.batch, m.nbody, 6))
  if not m.opt.disableflags & DisableBit.GRAVITY:
    cacc[:, 0, 3:] = -m.opt.gravity
  for bodies in m.tree.body_levels:
    b = m.const(bodies)
    cacc[:, b] = cacc[:, m.const(m.body_parentid[bodies])] + body_contrib[:, b]

  cfrc = (math.inert_mul(d.cinert, cacc)
          + math.force_cross(d.cvel, math.inert_mul(d.cinert, d.cvel))
          - cfrc_ext)
  cfrc_int = tree_sum_up(m, cfrc * nonworld)
  return d.replace(cacc=cacc, cfrc_int=cfrc_int, cfrc_ext=cfrc_ext)
