"""Passive forces: joint and tendon springs, dof and tendon dampers,
gravity compensation, fluid forces, and the flexes' element elasticity,
trilinear nodal elasticity and edge spring-dampers.

Port of ``mujoco_inversedynamicstest_tpu/ops/passive.py``.  The fluid forces (``mj_fluid``) are
both of C's models, the inertia box of each body and the ellipsoid of each
``fluidshape="ellipsoid"`` geom, computed in one batch over the bodies and
geoms of each model and applied to the dofs in one contraction (the JAX
package loops over the geoms to pick the bodies).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    GeomType,
    JointType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import math, smooth, support


def _spring(m: Model, d: Data) -> torch.Tensor:
  """Joint springs toward ``qpos_spring``."""
  qfrc = d.qpos.new_zeros((d.batch, m.nv))
  jt = m.jnt_type
  scalar = np.nonzero((jt == JointType.HINGE) | (jt == JointType.SLIDE))[0]
  free = np.nonzero(jt == JointType.FREE)[0]
  ball = np.nonzero(jt == JointType.BALL)[0]
  if scalar.size:
    padr = m.const(m.jnt_qposadr[scalar])
    k = m.jnt_stiffness[m.const(scalar)]
    qfrc.index_add_(1, m.const(m.jnt_dofadr[scalar]),
                    -k * (d.qpos[:, padr] - m.qpos_spring[padr]))
  if free.size:
    pidx = m.const(m.jnt_qposadr[free][:, None] + np.arange(3)[None])
    vidx = m.const((m.jnt_dofadr[free][:, None] + np.arange(3)[None]).ravel())
    k = m.jnt_stiffness[m.const(free)][:, None]
    qfrc.index_add_(1, vidx, (-k * (d.qpos[:, pidx] - m.qpos_spring[pidx])
                              ).reshape(d.batch, -1))
  for jids, off in ((ball, 0), (free, 3)):
    if not jids.size:
      continue
    pidx = m.const(m.jnt_qposadr[jids][:, None] + off + np.arange(4)[None])
    vidx = m.const((m.jnt_dofadr[jids][:, None] + off
                    + np.arange(3)[None]).ravel())
    k = m.jnt_stiffness[m.const(jids)][:, None]
    dif = math.quat_sub(math.normalize_quat(d.qpos[:, pidx]),
                        m.qpos_spring[pidx])
    qfrc.index_add_(1, vidx, (-k * dif).reshape(d.batch, -1))
  return qfrc


def gravcomp(m: Model, d: Data) -> torch.Tensor:
  """Gravity compensation ``-gravity * mass * body_gravcomp`` applied at
  each body's CoM (``mj_gravcomp``)."""
  force = -m.opt.gravity * (m.body_mass * m.body_gravcomp)[:, None]
  force = force.expand(d.batch, m.nbody, 3)
  return support.jac_transpose(m, d, d.xipos, force, torch.zeros_like(force))


def _mv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat v for (..., 3, 3) and (..., 3), by products and sums."""
  return (mat * v[..., None, :]).sum(-1)


def _fluid_layout(m: Model):
  """The fluid forces' host tables: the bodies of the inertia-box model
  (massive bodies with no ellipsoid geom, C's ``mj_fluid``), the geoms of
  the ellipsoid model (those with ``fluidshape="ellipsoid"`` on massive
  bodies), and each geom's equivalent semi-axes' source (``mju_geomSemiAxes``)."""
  mass = m.body_mass.cpu().numpy()
  massive = mass >= math.MINVAL
  ell = m.geom_fluid_active & massive[m.geom_bodyid]
  box = massive.copy()
  box[0] = False
  box[m.geom_bodyid[m.geom_fluid_active]] = False
  return np.nonzero(box)[0], np.nonzero(ell)[0]


def _semiaxes(m: Model, geoms: np.ndarray) -> torch.Tensor:
  """Equivalent ellipsoid semi-axes (K, 3) of the geoms (``mju_geomSemiAxes``):
  a sphere's radius thrice, a capsule's (r, r, half-length + r), a
  cylinder's (r, r, half-length), the size of the others."""
  size = m.geom_size[m.const(geoms)]
  t = m.geom_type[geoms]
  r = size[:, 0]
  s1 = torch.where(m.const(np.isin(t, (GeomType.SPHERE, GeomType.CAPSULE,
                                       GeomType.CYLINDER))), r, size[:, 1])
  s2 = torch.where(m.const(t == GeomType.SPHERE), r, size[:, 2])
  s2 = torch.where(m.const(t == GeomType.CAPSULE), r + size[:, 1], s2)
  s2 = torch.where(m.const(t == GeomType.CYLINDER), size[:, 1], s2)
  return torch.stack([r, s1, s2], dim=-1)


def _box_fluid(m: Model, d: Data, bodies: np.ndarray):
  """The inertia-box model (``mj_inertiaBoxFluidModel``) of ``bodies``: each
  body's box of equal inertia, viscous drag on the box's equivalent sphere
  and the density's quadratic drag on its faces, in the inertial frame
  with the wind subtracted.  Returns the world force and torque (B, K, 3)
  at each body's CoM."""
  b = m.const(bodies)
  inert, mass = m.body_inertia[b], m.body_mass[b]
  roll = inert[:, [1, 0, 0]] + inert[:, [2, 2, 1]] - inert
  box = torch.sqrt(torch.clamp(roll, min=math.MINVAL) / mass[:, None] * 6.0)
  root = m.const(m.body_rootid[bodies])
  vel = math.transform_motion(d.cvel[:, b], d.xipos[:, b]
                              - d.subtree_com[:, root])
  rot = d.ximat[:, b]
  ang = math.mat_t_vec(rot, vel[..., :3])
  lin = math.mat_t_vec(rot, vel[..., 3:]) - math.mat_t_vec(rot, m.opt.wind)
  diam = box.mean(-1, keepdim=True)
  visc, rho = m.opt.viscosity, m.opt.density
  frc_ang = ang * (-torch.pi * diam**3 * visc)
  frc_lin = lin * (-3.0 * torch.pi * diam * visc)
  bx, by, bz = box.unbind(-1)
  face = torch.stack([by * bz, bx * bz, bx * by], dim=-1)
  roll4 = torch.stack([bx * (by**4 + bz**4), by * (bx**4 + bz**4),
                       bz * (bx**4 + by**4)], dim=-1)
  frc_lin = frc_lin - 0.5 * rho * face * torch.abs(lin) * lin
  frc_ang = frc_ang - rho * roll4 * torch.abs(ang) * ang / 64.0
  return _mv(rot, frc_lin), _mv(rot, frc_ang)


def _ellipsoid_fluid(m: Model, d: Data, geoms: np.ndarray):
  """The ellipsoid model (``mj_ellipsoidFluidModel``: ``mj_addedMassForces``
  and ``mj_viscousForces``) of ``geoms``: added mass, Magnus and Kutta
  lift, blunt, slender and angular drag and Stokes viscosity on each geom's
  equivalent ellipsoid, scaled by its interaction coefficient, in the
  geom's frame with the wind subtracted.  Returns the world force and
  torque (B, K, 3) at each geom's centre."""
  g = m.const(geoms)
  coef = m.geom_fluid[g]
  interact, c_blunt, c_slender, c_ang, c_kutta, c_magnus = coef[:, :6].T
  v_mass, v_inert = coef[:, 6:9], coef[:, 9:12]
  rho, visc = m.opt.density, m.opt.viscosity
  root = m.const(m.body_rootid[m.geom_bodyid[geoms]])
  body = m.const(m.geom_bodyid[geoms])
  vel = math.transform_motion(d.cvel[:, body], d.geom_xpos[:, g]
                              - d.subtree_com[:, root])
  rot = d.geom_xmat[:, g]
  ang = math.mat_t_vec(rot, vel[..., :3])
  lin = math.mat_t_vec(rot, vel[..., 3:]) - math.mat_t_vec(rot, m.opt.wind)

  # added mass (mj_addedMassForces)
  p_lin, p_ang = rho * v_mass * lin, rho * v_inert * ang
  frc_ang = math.cross(p_lin, lin) + math.cross(p_ang, ang)
  frc_lin = math.cross(p_lin, ang)

  # lift, drag and viscosity (mj_viscousForces)
  size = _semiaxes(m, geoms)
  s0, s1, s2 = size.unbind(-1)
  volume = 4.0 / 3.0 * torch.pi * s0 * s1 * s2
  d_max, d_min = size.amax(-1), size.amin(-1)
  d_mid = s0 + s1 + s2 - d_max - d_min
  a_max = torch.pi * d_max * d_mid
  magnus = math.cross(ang, lin) * (c_magnus * rho * volume)[:, None]
  lx, ly, lz = lin.unbind(-1)
  sq = lambda x: x * x
  proj_denom = (sq(sq(s1 * s2)) * sq(lx) + sq(sq(s2 * s0)) * sq(ly)
                + sq(sq(s0 * s1)) * sq(lz))
  proj_num = sq(s1 * s2 * lx) + sq(s2 * s0 * ly) + sq(s0 * s1 * lz)
  a_proj = torch.pi * torch.sqrt(proj_denom
                                 / torch.clamp(proj_num, min=math.MINVAL))
  norm = torch.stack([sq(s1 * s2) * lx, sq(s2 * s0) * ly, sq(s0 * s1) * lz],
                     dim=-1)
  lin_norm = torch.linalg.vector_norm(lin, dim=-1)
  cos_alpha = proj_num / torch.clamp(lin_norm * proj_denom, min=math.MINVAL)
  kutta = math.cross(math.cross(norm, lin) * (
      c_kutta * rho * cos_alpha * a_proj)[..., None], lin)
  eq_d = 2.0 / 3.0 * (s0 + s1 + s2)
  moment = lambda a, b, c: 8.0 / 15.0 * torch.pi * a * torch.maximum(b, c)**4
  i_max = 8.0 / 15.0 * torch.pi * d_mid * d_max**4
  inertia = torch.stack([moment(s0, s1, s2), moment(s1, s2, s0),
                         moment(s2, s0, s1)], dim=-1)
  mom_visc = ang * (c_ang[:, None] * inertia
                    + c_slender[:, None] * (i_max[:, None] - inertia))
  drag_lin = visc * 3.0 * torch.pi * eq_d + rho * lin_norm * (
      a_proj * c_blunt + c_slender * (a_max - a_proj))
  drag_ang = visc * torch.pi * eq_d**3 + rho * torch.linalg.vector_norm(
      mom_visc, dim=-1)
  frc_ang = (frc_ang - drag_ang[..., None] * ang) * interact[:, None]
  frc_lin = (frc_lin + magnus + kutta - drag_lin[..., None] * lin
             ) * interact[:, None]
  return _mv(rot, frc_lin), _mv(rot, frc_ang)


def fluid(m: Model, d: Data) -> torch.Tensor:
  """Fluid forces (``mj_fluid``), (B, nv): the inertia-box model on every
  massive body without an ellipsoid geom and the ellipsoid model on every
  ellipsoid geom, each force and torque applied at its body's CoM or its
  geom's centre, all in one contraction with ``cdof``."""
  bodies, geoms = m.memo("fluid_layout", lambda: _fluid_layout(m))
  points, owner, force, torque = [], [], [], []
  if bodies.size:
    f, t = _box_fluid(m, d, bodies)
    points.append(d.xipos[:, m.const(bodies)])
    owner.append(bodies)
    force.append(f)
    torque.append(t)
  if geoms.size:
    f, t = _ellipsoid_fluid(m, d, geoms)
    points.append(d.geom_xpos[:, m.const(geoms)])
    owner.append(m.geom_bodyid[geoms])
    force.append(f)
    torque.append(t)
  if not owner:
    return d.qpos.new_zeros((d.batch, m.nv))
  owner = np.concatenate(owner)
  cat = lambda xs: torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
  return support.apply_at_bodies(m, d, cat(points), owner, cat(force),
                                 cat(torque))


def _tendon_forces(m: Model, d: Data):
  """Tendon spring (toward the ``lengthspring`` deadband [lower, upper],
  zero inside it) and damper forces along each tendon, (B, ntendon)."""
  length = d.ten_length
  lower, upper = m.tendon_lengthspring[:, 0], m.tendon_lengthspring[:, 1]
  spring = m.tendon_stiffness * torch.where(
      length > upper, upper - length,
      torch.where(length < lower, lower - length, 0.0))
  return spring, -m.tendon_damping * d.ten_velocity


# each element edge's two local vertices (C's edge order of an element)
_ELEM_EDGES = {2: np.array([[1, 2], [2, 0], [0, 1]]),
               3: np.array([[0, 1], [1, 2], [2, 0], [2, 3], [0, 3], [1, 3]])}


def flex_elasticity(m: Model, d: Data) -> torch.Tensor:
  """Element elasticity with Rayleigh damping (the element loop of
  ``mj_passive``): each element's squared-length elongations, with the
  discrete damping term, contracted with its metric, pushed to its
  vertices along the squared lengths' gradients, and to the dofs through
  the vertices' point Jacobians.  (B, nv)."""
  fl = m.flex
  fvert = d.qpos.new_zeros((d.batch, fl.nvert, 3))
  for f in range(fl.nflex):
    dim = int(fl.dim[f])
    if dim == 1 or fl.rigid[f]:
      continue
    ea, en = int(fl.elemadr[f]), int(fl.elemnum[f])
    ltab = _ELEM_EDGES[dim]
    nepe = len(ltab)
    vert_ids = fl.elem[ea:ea + en, :dim + 1]
    edge_ids = m.const(fl.elemedge[ea:ea + en, :nepe])
    x = d.flexvert_xpos[:, m.const(vert_ids)]            # (B, ne, dim+1, 3)
    grad0 = x[:, :, m.const(ltab[:, 0])] - x[:, :, m.const(ltab[:, 1])]
    length = d.flexedge_length[:, edge_ids]
    length0 = fl.edge_length0[edge_ids]
    dt = m.opt.timestep
    prev = length - d.flexedge_velocity[:, edge_ids] * dt
    elong = (length * length - length0 * length0
             + (length * length - prev * prev) * (fl.damping[f] / dt))
    metric = fl.metric[ea:ea + en, :nepe, :nepe]
    coef = torch.sum(elong[..., :, None] * metric, dim=-2)  # (B, ne, nepe)
    f0 = (-coef[..., None] * grad0).reshape(d.batch, -1, 3)
    ends = [vert_ids[:, ltab[:, k]].reshape(-1) for k in (0, 1)]
    for k, (idx, sgn) in enumerate(zip(ends, (1.0, -1.0))):
      fvert = smooth.ordered_index_add(m, fvert, idx, sgn * f0,
                                       ("flex_elasticity", f, k))
  return support.apply_at_bodies(m, d, d.flexvert_xpos, fl.vertbodyid,
                                 fvert, torch.zeros_like(fvert))


def _mat2rot(mat: torch.Tensor, iters: int = 80) -> torch.Tensor:
  """The rotation of a deformation gradient (``mju_mat2Rot``, Mueller et
  al. 2016) as a quaternion, by a fixed count of updates; a converged
  update is a no-op."""
  quat = mat.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(mat.shape[:-2] + (4,))
  cols_m = mat.transpose(-1, -2)
  for _ in range(iters):
    cols_r = math.quat_to_mat(quat).transpose(-1, -2)
    omega = torch.sum(math.cross(cols_r, cols_m), dim=-2)
    denom = torch.abs(torch.sum(cols_r * cols_m, dim=(-1, -2))) + math.MINVAL
    omega = omega / denom[..., None]
    w = torch.linalg.vector_norm(omega, dim=-1)
    axis = omega / torch.clamp(w, min=math.MINVAL)[..., None]
    qn = math.normalize_quat(math.quat_mul(math.axis_angle_quat(axis, w),
                                           quat))
    quat = torch.where((w < 1e-12)[..., None], quat, qn)
  return quat


def flex_nodal_elasticity(m: Model, d: Data):
  """Stretch-frame nodal elasticity of the trilinear flexes (the interp
  branch of ``mj_passive``): the nodes re-centred, the rotation fit from
  the deformation gradient at the cell centre (``mju_defGradient``,
  ``mju_mat2Rot``), displacements and velocities rotated into its frame,
  one (3N, 3N) product with the nodal stiffness, rotated back onto the
  nodes' dofs.  Returns the (B, nv) spring and damper forces."""
  fl = m.flex
  qfrc_s = d.qpos.new_zeros((d.batch, m.nv))
  qfrc_d = d.qpos.new_zeros((d.batch, m.nv))
  for f in range(fl.nflex):
    stiff = fl.stiffness_nodal[f]
    if not fl.interp[f] or not stiff.numel():
      continue
    na, nn = int(fl.nodeadr[f]), int(fl.nodenum[f])
    bodies = fl.nodebodyid[na:na + nn]
    dof_idx = (m.body_dofadr[bodies][:, None] + np.arange(3)).reshape(-1)
    xpos = d.xpos[:, m.const(bodies)]                    # (B, nn, 3)
    vel = d.qvel[:, m.const(dof_idx)].reshape(d.batch, nn, 3)
    xc = xpos - torch.mean(xpos, dim=1, keepdim=True)
    j = np.arange(nn)
    grad = m.const(np.stack([np.where(j & 4, 1.0, -1.0),
                             np.where(j & 2, 1.0, -1.0),
                             np.where(j & 1, 1.0, -1.0)], axis=1) * 0.25)
    defgrad = torch.sum(xc[..., :, :, None] * grad[:, None, :], dim=-3)
    quat = _mat2rot(defgrad)                            # (B, 4)
    qinv = math.quat_conj(quat)[:, None]
    x_r = math.rotate(xc, qinv) + 0.5
    v_r = math.rotate(vel, qinv)
    displ = (x_r - fl.node0[na:na + nn]).reshape(d.batch, -1)
    frc = math.matvec(stiff, displ).reshape(d.batch, nn, 3)
    dmp = math.matvec(stiff, v_r.reshape(d.batch, -1)).reshape(
        d.batch, nn, 3) * fl.damping[f]
    q = quat[:, None]
    cols = m.const(dof_idx)
    qfrc_s = qfrc_s.index_add(1, cols, math.rotate(frc, q).reshape(
        d.batch, -1))
    qfrc_d = qfrc_d.index_add(1, cols, math.rotate(dmp, q).reshape(
        d.batch, -1))
  return qfrc_s, qfrc_d


def flex_edge_springdamper(m: Model, d: Data):
  """Edge spring-dampers (the edge loop of ``mj_passive``): stiffness
  times (length0 - length) and -damping times the edge velocity along the
  edge Jacobian; rigid edges and rigid flexes take none.  Returns the
  (B, nv) spring and damper forces."""
  fl = m.flex
  edge_flex = np.repeat(np.arange(fl.nflex), fl.edgenum)
  on = m.const((~fl.edge_rigid & ~fl.rigid[edge_flex]).astype(float))
  ef = m.const(edge_flex)
  spring = fl.edgestiffness[ef] * on * (fl.edge_length0 - d.flexedge_length)
  damper = -fl.edgedamping[ef] * on * d.flexedge_velocity
  jt = d.flexedge_J.transpose(1, 2)
  return math.matvec(jt, spring), math.matvec(jt, damper)


def passive(m: Model, d: Data) -> Data:
  """All passive forces (``mj_passive``).  Gravity compensation of the
  dofs of ``jnt_actgravcomp`` joints goes to qfrc_actuator instead
  (``fwd_actuation``), as C routes it.  The plugins' passive hooks (C's
  mjPLUGIN_PASSIVE compute) add to qfrc_passive alone."""
  flags = m.opt.disableflags
  zero = d.qpos.new_zeros((d.batch, m.nv))
  qfrc_spring = zero if flags & DisableBit.SPRING else _spring(m, d)
  qfrc_damper = zero if flags & DisableBit.DAMPER else -m.dof_damping * d.qvel
  if m.ntendon:
    spring, damper = _tendon_forces(m, d)
    jt = d.ten_J.transpose(1, 2)
    if not flags & DisableBit.SPRING:
      qfrc_spring = qfrc_spring + math.matvec(jt, spring)
    if not flags & DisableBit.DAMPER:
      qfrc_damper = qfrc_damper + math.matvec(jt, damper)
  fl = m.flex
  if fl is not None:
    # element elasticity goes to qfrc_spring, as C accounts it
    if fl.has_elasticity and not flags & DisableBit.SPRING:
      qfrc_spring = qfrc_spring + flex_elasticity(m, d)
    terms = []
    if fl.has_nodal_elasticity:
      terms.append(flex_nodal_elasticity(m, d))
    if fl.has_edge_sd:
      terms.append(flex_edge_springdamper(m, d))
    for spring, damper in terms:
      if not flags & DisableBit.SPRING:
        qfrc_spring = qfrc_spring + spring
      if not flags & DisableBit.DAMPER:
        qfrc_damper = qfrc_damper + damper
  qfrc_gravcomp = zero
  to_passive = zero
  if m.has_gravcomp and not flags & DisableBit.GRAVITY:
    qfrc_gravcomp = gravcomp(m, d)
    to_passive = qfrc_gravcomp
    actgrav = m.jnt_actgravcomp[m.dof_jntid] != 0
    if actgrav.any():
      to_passive = torch.where(m.const(actgrav), 0.0, qfrc_gravcomp)
  qfrc_fluid = fluid(m, d) if m.has_fluid else zero
  qfrc_passive = qfrc_spring + qfrc_damper + qfrc_fluid
  for hook in m.plugin_hooks:
    extra = hook.passive(m, d)
    if extra is not None:
      qfrc_passive = qfrc_passive + extra
  return d.replace(
      qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
      qfrc_gravcomp=qfrc_gravcomp, qfrc_fluid=qfrc_fluid,
      qfrc_passive=qfrc_passive + to_passive)
