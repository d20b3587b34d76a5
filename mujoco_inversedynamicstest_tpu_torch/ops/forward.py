"""Forward dynamics pipeline and the integrators.

Port of ``mujoco_inversedynamicstest_tpu/ops/forward.py`` (``mj_fwdPosition``,
``mj_fwdVelocity``, ``mj_fwdActuation``, ``mj_fwdAcceleration``,
``mj_forward``, ``mj_Euler``, ``mj_RungeKutta``, ``mj_implicit``,
``mjd_smooth_vel``, ``mj_step``) for a fleet, with the sensor stages of
``ops/sensor.py``: every ``Data`` tensor carries the leading fleet
dimension.  Activations (``Data.act``) are part of the state: every
integrator advances them (``mj_advance``'s ``mj_nextActivation``).
``forward``, ``step`` and ``step_n`` take the in-step control callback
``ctrl_fn(m, d) -> (B, nu)``, C's ``mjcb_control``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import func

from mujoco_inversedynamicstest_tpu_torch.models.io import mocap_bodies
from mujoco_inversedynamicstest_tpu_torch.models.types import (
    BiasType,
    Data,
    DisableBit,
    DynType,
    EnableBit,
    GainType,
    IntegratorType,
    JointType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.ops import linalg, math, passive
from mujoco_inversedynamicstest_tpu_torch.ops import sensor, smooth, solver
from mujoco_inversedynamicstest_tpu_torch.ops import support, wrap

# mjMAXVAL: state-validity bound
_MAXVAL = 1e10


def fwd_position(m: Model, d: Data) -> Data:
  """Position-dependent stage (``mj_fwdPosition``); the same stages make
  up ``mj_invPosition``."""
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.camlight(m, d)
  d = smooth.flex(m, d)
  d = smooth.tendon(m, d)
  d = smooth.crb(m, d)
  d = smooth.factor_m(m, d)
  d = collision.collision(m, d)
  d = constraint.make_constraint(m, d)
  return smooth.transmission(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  """Velocity-dependent stage (``mj_fwdVelocity``)."""
  if m.ntendon:
    d = d.replace(ten_velocity=math.matvec(d.ten_J, d.qvel))
  if d.flexedge_J is not None:
    d = d.replace(flexedge_velocity=math.matvec(d.flexedge_J, d.qvel))
  if m.nu:
    d = d.replace(actuator_velocity=math.matvec(d.actuator_moment, d.qvel))
  d = smooth.com_vel(m, d)
  d = passive.passive(m, d)
  d = constraint.reference_constraint(m, d)
  return d.replace(qfrc_bias=smooth.rne(m, d, flg_acc=False))


class _ActLayout(NamedTuple):
  """Host tables of the actuators, by what ``fwd_actuation`` does with
  them."""
  act_actuator: np.ndarray   # (na,) each activation's actuator
  stateful: np.ndarray       # actuators with an activation
  stateless: np.ndarray      # the others: their input is ctrl
  last: np.ndarray           # (len(stateful),) their last activation
  dyn: tuple                 # (DynType, actuators, activations) a kind
  plugin_slots: np.ndarray   # the activations of dyntype-none actuators,
                             # which their plugins write (zero otherwise)
  muscle_gain: np.ndarray    # actuators with a muscle gain
  other_gain: np.ndarray
  muscle_bias: np.ndarray    # actuators with a muscle bias
  other_bias: np.ndarray
  gravcomp_dofs: np.ndarray  # (nv,) bool: dofs of actgravcomp joints
  actfrc_dofs: np.ndarray    # dofs of jnt_actfrclimited joints
  actfrc_jnt: np.ndarray     # their joints


def _act_layout(m: Model) -> _ActLayout:
  act_actuator = np.zeros(m.na, dtype=np.int64)
  for i in range(m.nu):
    adr, num = m.actuator_actadr[i], m.actuator_actnum[i]
    if adr >= 0:
      act_actuator[adr:adr + num] = i
  stateful = np.nonzero(m.actuator_actadr >= 0)[0]
  dyn = []
  for kind in (DynType.INTEGRATOR, DynType.FILTER, DynType.FILTEREXACT,
               DynType.MUSCLE):
    ids = stateful[m.actuator_dyntype[stateful] == kind]
    if ids.size:
      dyn.append((kind, ids, m.actuator_actadr[ids] + m.actuator_actnum[ids]
                  - 1))
  none = stateful[m.actuator_dyntype[stateful] == DynType.NONE]
  plugin_slots = np.concatenate([np.zeros(0, np.int64)] + [
      m.actuator_actadr[i] + np.arange(m.actuator_actnum[i]) for i in none])
  gravcomp_dofs = np.zeros(m.nv, dtype=bool)
  actfrc_dofs, actfrc_jnt = [], []
  width = {JointType.FREE: 6, JointType.BALL: 3}
  for j in range(m.njnt):
    dofs = m.jnt_dofadr[j] + np.arange(width.get(int(m.jnt_type[j]), 1))
    if m.jnt_actgravcomp[j]:
      gravcomp_dofs[dofs] = True
    if m.jnt_actfrclimited[j]:
      actfrc_dofs.append(dofs)
      actfrc_jnt.append(np.full(len(dofs), j))
  muscle_gain = m.actuator_gaintype == GainType.MUSCLE
  muscle_bias = m.actuator_biastype == BiasType.MUSCLE
  return _ActLayout(
      act_actuator=act_actuator, stateful=stateful,
      stateless=np.nonzero(m.actuator_actadr < 0)[0],
      last=m.actuator_actadr[stateful] + m.actuator_actnum[stateful] - 1,
      dyn=tuple(dyn), plugin_slots=plugin_slots,
      muscle_gain=np.nonzero(muscle_gain)[0],
      other_gain=np.nonzero(~muscle_gain)[0],
      muscle_bias=np.nonzero(muscle_bias)[0],
      other_bias=np.nonzero(~muscle_bias)[0],
      gravcomp_dofs=gravcomp_dofs,
      actfrc_dofs=np.concatenate(actfrc_dofs) if actfrc_dofs else np.zeros(
          0, np.int64),
      actfrc_jnt=np.concatenate(actfrc_jnt) if actfrc_jnt else np.zeros(
          0, np.int64))


def act_layout(m: Model) -> _ActLayout:
  return m.memo("act_layout", lambda: _act_layout(m))


def next_activation(m: Model, act: torch.Tensor,
                    act_dot: torch.Tensor) -> torch.Tensor:
  """Every activation one step on (``mj_nextActivation``): FILTEREXACT
  integrates exactly, the others by Euler, then ``actlimited`` clamps to
  ``actrange``.  (B, na) -> (B, na)."""
  if not m.na:
    return act
  actuator = act_layout(m).act_actuator
  owner = m.const(actuator)
  h = m.opt.timestep
  tau = torch.clamp(m.actuator_dynprm[owner, 0], min=math.MINVAL)
  exact = m.const(m.actuator_dyntype[actuator] == DynType.FILTEREXACT)
  nxt = torch.where(exact, act + act_dot * tau * (1 - torch.exp(-h / tau)),
                    act + act_dot * h)
  rng = m.actuator_actrange[owner]
  return torch.where(m.const(m.actuator_actlimited[actuator].astype(bool)),
                     torch.minimum(torch.maximum(nxt, rng[:, 0]), rng[:, 1]),
                     nxt)


def _ctrl(m: Model, d: Data) -> torch.Tensor:
  """The controls as the actuators read them: clamped to ``ctrlrange``
  where limited, and all zero in a lane with any non-finite control."""
  ctrl = d.ctrl
  if not m.opt.disableflags & DisableBit.CLAMPCTRL:
    rng = m.actuator_ctrlrange
    ctrl = torch.where(m.const(m.actuator_ctrllimited.astype(bool)),
                       torch.minimum(torch.maximum(ctrl, rng[:, 0]), rng[:, 1]),
                       ctrl)
  bad = ~torch.all(torch.isfinite(ctrl), dim=-1, keepdim=True)
  return torch.where(bad, 0.0, ctrl)


def _act_dot(m: Model, d: Data, ctrl: torch.Tensor) -> torch.Tensor:
  """(B, na): INTEGRATOR ctrl, FILTER and FILTEREXACT (ctrl - act) / tau,
  MUSCLE ``mju_muscleDynamics``; zero in the activations of dyntype-none
  actuators, which their plugins' hooks write (``fwd_actuation``)."""
  lay = act_layout(m)
  pieces = []
  if lay.plugin_slots.size:
    pieces.append((lay.plugin_slots,
                   d.act.new_zeros((d.batch, lay.plugin_slots.size))))
  for kind, ids, slots in lay.dyn:
    u, a = ctrl[:, m.const(ids)], d.act[:, m.const(slots)]
    prm = m.actuator_dynprm[m.const(ids)]
    if kind == DynType.INTEGRATOR:
      pieces.append((slots, u))
    elif kind == DynType.MUSCLE:
      pieces.append((slots, wrap.muscle_dynamics(u, a, prm[:, :3])))
    else:
      pieces.append((slots, (u - a) / torch.clamp(prm[:, 0], min=math.MINVAL)))
  return support.assemble(m, "act_dot", pieces)


def _affine(prm: torch.Tensor, d: Data) -> torch.Tensor:
  return (prm[:, 0] + prm[:, 1] * d.actuator_length
          + prm[:, 2] * d.actuator_velocity)


def fwd_actuation(m: Model, d: Data) -> Data:
  """Actuator forces and activation rates (``mj_fwdActuation``): the
  dynamics of ``_act_dot``; FIXED, AFFINE and MUSCLE gains and biases; the
  input ctrl, or the actuator's last activation (the next step's where
  ``actearly``); force limits; then qfrc_actuator = momentᵀ force, with
  the gravity compensation of ``jnt_actgravcomp`` joints and the
  ``jnt_actfrclimited`` clamps.  Each kind is computed on its actuators
  alone and put in place out of place.  The actuator plugins' hooks then
  replace their actuators' activation rates and forces, before the force
  limits (C's mjPLUGIN_ACTUATOR compute inside ``mj_fwdActuation``)."""
  zero = d.qvel.new_zeros((d.batch, m.nv))
  no_act = d.qvel.new_zeros((d.batch, m.na))
  if not m.nu or m.opt.disableflags & DisableBit.ACTUATION:
    return d.replace(qfrc_actuator=zero, act_dot=no_act,
                     actuator_force=d.qvel.new_zeros((d.batch, m.nu)))
  lay = act_layout(m)
  ctrl = _ctrl(m, d)
  act_dot = _act_dot(m, d, ctrl) if m.na else no_act

  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  gain, bias = gp[:, 0], None
  if np.any(m.actuator_gaintype == GainType.AFFINE):
    gain = torch.where(m.const(m.actuator_gaintype == GainType.AFFINE),
                       _affine(gp, d), gain)
  if np.any(m.actuator_biastype == BiasType.AFFINE):
    bias = torch.where(m.const(m.actuator_biastype == BiasType.AFFINE),
                       _affine(bp, d), 0.0)
  lrange, acc0 = m.actuator_lengthrange, m.actuator_acc0
  length, vel = d.actuator_length, d.actuator_velocity
  if lay.muscle_gain.size:
    i = m.const(lay.muscle_gain)
    gain = support.assemble(m, "actuator_gain", [
        (lay.other_gain, gain[..., m.const(lay.other_gain)]),
        (lay.muscle_gain, wrap.muscle_gain(length[:, i], vel[:, i],
                                           lrange[i], acc0[i], gp[i, :9]))])
  if lay.muscle_bias.size:
    i = m.const(lay.muscle_bias)
    other = (torch.zeros_like(length[:, m.const(lay.other_bias)])
             if bias is None else bias[:, m.const(lay.other_bias)])
    bias = support.assemble(m, "actuator_bias", [
        (lay.other_bias, other),
        (lay.muscle_bias, wrap.muscle_bias(length[:, i], lrange[i], acc0[i],
                                           bp[i, :9]))])

  inputs = ctrl
  if lay.stateful.size:
    act = d.act
    if np.any(m.actuator_actearly):
      act = torch.where(m.const(m.actuator_actearly[lay.act_actuator] != 0),
                        next_activation(m, d.act, act_dot), d.act)
    inputs = support.assemble(m, "actuator_input", [
        (lay.stateless, ctrl[:, m.const(lay.stateless)]),
        (lay.stateful, act[:, m.const(lay.last)])])
  force = gain * inputs if bias is None else gain * inputs + bias
  for hook in m.plugin_hooks:
    new = hook.act_dot(m, d, ctrl, act_dot)
    act_dot = act_dot if new is None else new
    new = hook.actuator_force(m, d, ctrl, force)
    force = force if new is None else new
  rng = m.actuator_forcerange
  force = torch.where(m.const(m.actuator_forcelimited.astype(bool)),
                      torch.minimum(torch.maximum(force, rng[:, 0]), rng[:, 1]),
                      force)
  qfrc = math.matvec(d.actuator_moment.transpose(1, 2), force)
  if lay.gravcomp_dofs.any() and not m.opt.disableflags & DisableBit.GRAVITY:
    qfrc = qfrc + torch.where(m.const(lay.gravcomp_dofs), d.qfrc_gravcomp,
                              0.0)
  if lay.actfrc_dofs.size:
    rng = m.jnt_actfrcrange[m.const(lay.actfrc_jnt)]
    dofs = m.const(lay.actfrc_dofs)
    clamped = torch.minimum(torch.maximum(qfrc[:, dofs], rng[:, 0]), rng[:, 1])
    rest = np.setdiff1d(np.arange(m.nv), lay.actfrc_dofs)
    qfrc = support.assemble(m, "actfrc", [(rest, qfrc[:, m.const(rest)]),
                                          (lay.actfrc_dofs, clamped)])
  return d.replace(qfrc_actuator=qfrc, actuator_force=force, act_dot=act_dot)


def fwd_acceleration(m: Model, d: Data) -> Data:
  """Smooth acceleration (``mj_fwdAcceleration``)."""
  qfrc = (d.qfrc_passive - d.qfrc_bias + d.qfrc_applied + d.qfrc_actuator
          + support.xfrc_accumulate(m, d))
  return d.replace(qfrc_smooth=qfrc, qacc_smooth=smooth.solve_m(m, d, qfrc))


def _control(m: Model, d: Data, ctrl_fn) -> Data:
  """``d`` with the controls ``ctrl_fn(m, d)`` (B, nu) writes."""
  ctrl = ctrl_fn(m, d)
  if ctrl.shape != d.ctrl.shape:
    raise ValueError(f"ctrl_fn gave shape {tuple(ctrl.shape)}, the controls "
                     f"are {tuple(d.ctrl.shape)}")
  return d.replace(ctrl=ctrl.to(d.ctrl.dtype))


def forward(m: Model, d: Data, skip_sensor: bool = False,
            ctrl_fn=None) -> Data:
  """Full forward dynamics (``mj_forward``), with each sensor stage after
  the stage it reads unless ``skip_sensor`` (``mj_forwardSkip``'s
  skipsensor).

  ``ctrl_fn(m, d) -> (B, nu)``, where given, is the in-step control
  callback (C's ``mjcb_control``): it fires where ``mj_forwardSkip`` calls
  it, after the velocity stage and its sensors and before actuation, and
  its result becomes ``d.ctrl``.  As in C it does not fire when actuation
  is disabled.  Under the ENERGY enable flag ``d.energy`` holds the
  potential and kinetic energy (C's; the JAX package leaves it zero).
  """
  d = fwd_position(m, d)
  if not skip_sensor:
    d = sensor.sensor_pos(m, d)
  d = fwd_velocity(m, d)
  if not skip_sensor:
    d = sensor.sensor_vel(m, d)
  if m.opt.enableflags & EnableBit.ENERGY:
    # C's mj_energyPos after the position stage, mj_energyVel after the
    # velocity stage; the first reads no velocity
    d = d.replace(energy=torch.stack([sensor.energy_pos(m, d),
                                      sensor.energy_vel(m, d)], dim=-1))
  if ctrl_fn is not None and not m.opt.disableflags & DisableBit.ACTUATION:
    d = _control(m, d, ctrl_fn)
  d = fwd_actuation(m, d)
  d = fwd_acceleration(m, d)
  d = solver.fwd_constraint(m, d)
  if not skip_sensor:
    d = sensor.sensor_acc(m, d)
  return d


def _advance(m: Model, d: Data, qacc: torch.Tensor, act_dot: torch.Tensor,
             qvel_for_pos: torch.Tensor | None = None,
             qvel: torch.Tensor | None = None) -> Data:
  """State advance (``mj_advance``): act by ``next_activation`` of
  act_dot, qvel += h qacc (or ``qvel`` where given), then qpos by the new
  qvel, or by ``qvel_for_pos`` where given (RK4's weighted velocity)."""
  h = m.opt.timestep
  act = d.act
  if m.na and not m.opt.disableflags & DisableBit.ACTUATION:
    act = next_activation(m, d.act, act_dot)
  if qvel is None:
    qvel = d.qvel + qacc * h
  qpos = support.integrate_pos(
      m, d.qpos, qvel if qvel_for_pos is None else qvel_for_pos, h)
  return d.replace(qvel=qvel, qpos=qpos, act=act, time=d.time + h)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (``mj_Euler``):
  solves (M + h diag(damping)) qacc = qfrc_smooth + qfrc_constraint."""
  qacc = d.qacc
  if m.has_dof_damping and not m.opt.disableflags & DisableBit.EULERDAMP:
    mh = d.qM + torch.diag(m.opt.timestep * m.dof_damping)
    qacc = linalg.chol_solve(linalg.chol_factor(mh),
                             d.qfrc_smooth + d.qfrc_constraint)
  return _advance(m, d, qacc, d.act_dot)


# the fixed RK4 tableau of mj_RungeKutta: A's rows and B
_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rungekutta4(m: Model, d: Data, ctrl_fn=None) -> Data:
  """Explicit RK4 (``mj_RungeKutta(m, d, 4)``) of every lane.

  ``d`` holds a completed forward pass (stage 1).  Stages 2-4 are
  ``forward``s of the fleet without sensors (C's ``mj_forwardSkip(...,
  skipsensor=1)``), so sensordata, cacc and cfrc_* stay stage 1's; each
  solve starts from
  ``d.qacc_warmstart``: C's stage forwards all start from the warm start
  the step began with, since its ``mj_forward`` does not write one (``step``
  hands that one over).  A stage's act is act + h (its weighted act_dot),
  unclamped; the end state's goes through ``next_activation`` of the
  weighted act_dot.  The result holds the last stage's forward fields,
  as C leaves mjData: its qacc, qacc_warmstart (= that qacc), solver
  counts, contacts and constraint forces, with qpos, qvel, act and time
  advanced by the tableau's weights.  (The JAX package keeps the first
  stage's fields, and warm-starts the stages from its qacc.)  A stage's
  time is the step's plus h times its node (1/2, 1/2, 1), as C's; each
  stage forward fires ``ctrl_fn`` again, as C's re-enters ``mjcb_control``,
  so the step leaves stage 4's controls in ``ctrl``.
  """
  h = m.opt.timestep
  qpos0, qvel0, act0, warm = d.qpos, d.qvel, d.act, d.qacc_warmstart
  time0 = d.time
  vels, accs, rates = [qvel0], [d.qacc], [d.act_dot]
  for a in _RK4_A:
    dqvel = sum(w * v for w, v in zip(a, vels))
    dqacc = sum(w * v for w, v in zip(a, accs))
    dact = sum(w * v for w, v in zip(a, rates))
    qvel = qvel0 + dqacc * h
    d = forward(m, d.replace(qpos=support.integrate_pos(m, qpos0, dqvel, h),
                             qvel=qvel, act=act0 + dact * h,
                             qacc_warmstart=warm, time=time0 + sum(a) * h),
                skip_sensor=True, ctrl_fn=ctrl_fn)
    vels.append(qvel)
    accs.append(d.qacc)
    rates.append(d.act_dot)
  dqvel = sum(w * v for w, v in zip(_RK4_B, vels))
  dqacc = sum(w * v for w, v in zip(_RK4_B, accs))
  dact = sum(w * v for w, v in zip(_RK4_B, rates))
  return _advance(m, d.replace(qpos=qpos0, qvel=qvel0, act=act0, time=time0),
                  dqacc, dact, qvel_for_pos=dqvel)


def smooth_vel_deriv(m: Model, d: Data, flg_bias: bool = True,
                     flg_actuation: bool = True) -> torch.Tensor:
  """qDeriv = d(qfrc_passive - qfrc_bias + qfrc_actuator)/dqvel, (B, nv,
  nv): one Jacobian a lane (``mjd_smooth_vel``).

  ``torch.func.vmap`` over ``torch.func.jvp`` of ``fwd_velocity`` (and
  ``fwd_actuation``) of the B lanes, the nv unit tangents the vmapped
  dimension: the JAX package's ``jax.jacfwd``.  As C's
  ``mjd_actuator_vel``, it takes the muscles' force-velocity slope and
  gives a clamped force no slope.  ``flg_bias=False`` drops the RNE
  (Coriolis) term, IMPLICITFAST's approximation.  ``d`` must hold a
  completed position stage.
  """

  def f(qvel):
    dd = fwd_velocity(m, d.replace(qvel=qvel))
    out = dd.qfrc_passive
    if flg_bias:
      out = out - dd.qfrc_bias
    if flg_actuation:
      out = out + fwd_actuation(m, dd).qfrc_actuator
    return out

  eye = torch.eye(m.nv, dtype=d.qvel.dtype, device=d.qvel.device)
  cols = func.vmap(lambda e: func.jvp(f, (d.qvel,), (e,))[1])(
      eye[:, None, :].expand(m.nv, d.batch, m.nv))
  return cols.permute(1, 2, 0)


class _Midpoint(NamedTuple):
  """The free joints whose bodies C's IMPLICITFAST steps by the implicit
  midpoint rule (``mj_midpoint``): each the only joint of its tree, its
  body without massive children."""
  body: np.ndarray        # (K,)
  dofs: np.ndarray        # (K, 6)
  offset: np.ndarray      # (K,) bool: the CoM is off the joint


def _midpoint_layout(m: Model) -> _Midpoint:
  tree_dofs = np.bincount(m.body_rootid[m.dof_bodyid], minlength=m.nbody)
  mass = m.body_mass.cpu().numpy()
  subtree = m.body_subtreemass.cpu().numpy()
  free = np.nonzero(m.jnt_type == JointType.FREE)[0]
  body = m.dof_bodyid[m.jnt_dofadr[free]]
  keep = (tree_dofs[m.body_rootid[body]] == 6) & (mass[body] == subtree[body])
  free, body = free[keep], body[keep]
  return _Midpoint(
      body=body, dofs=m.jnt_dofadr[free][:, None] + np.arange(6),
      offset=np.any(m.body_ipos.cpu().numpy()[body] != 0, axis=-1))


def _skew(w: torch.Tensor) -> torch.Tensor:
  """(..., 3) -> (..., 3, 3): [w]x, the matrix of w x ."""
  z = torch.zeros_like(w[..., 0])
  return torch.stack([
      torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
      torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
      torch.stack([-w[..., 1], w[..., 0], z], dim=-1)], dim=-2)


# Newton iterations of the midpoint rule: from w, at h |w| << 1, the
# iterate reaches round-off in three or four
_MIDPOINT_ITERATIONS = 8


def _midpoint_qvel(m: Model, d: Data, qvel: torch.Tensor):
  """C's IMPLICITFAST step of the free bodies of ``_midpoint_layout``
  (``mj_midpoint``), on the lanes where no constraint row touches them:
  the body's angular velocity w by the implicit midpoint rule of Euler's
  equations about its CoM, in its frame,
      I (w' - w) = h (tau_c - wm x I wm),   wm = (w + w') / 2,
  wm by Newton's method from w; tau_c the torque of every force but the
  bias (qfrc_smooth + qfrc_constraint + qfrc_bias) about the CoM.  With
  the CoM at the joint, the linear velocity is the implicit solve's
  (``qvel``); off it, the CoM's velocity in the body frame by the same
  rule, m (vc' - vc) = h (F + m g - wm x m (vc + vc') / 2), back to the
  joint in the frame turned by h wm.  Returns qvel with those dofs
  replaced, and the velocity that moves qpos: there the body turns by wm,
  and an off-centre body's joint moves by the mean of the old and new
  linear velocities."""
  lay = m.memo("midpoint", lambda: _midpoint_layout(m))
  if not lay.body.size:
    return qvel, qvel
  h = m.opt.timestep
  dofs, body = m.const(lay.dofs), m.const(lay.body)
  f6 = (d.qfrc_smooth + d.qfrc_constraint + d.qfrc_bias)[:, dofs]
  v6 = d.qvel[:, dofs]
  rot = d.xmat[:, body]                               # (B, K, 3, 3)
  c = m.body_ipos[body]
  r_i = math.quat_to_mat(m.body_iquat[body])
  inertia = (r_i * m.body_inertia[body][:, None, :]) @ r_i.transpose(-1, -2)
  mass = m.body_mass[body][:, None]
  force_b = math.mat_t_vec(rot, f6[..., :3])
  tau = f6[..., 3:] - math.cross(c, force_b)
  w = v6[..., 3:]
  wm = w
  for _ in range(_MIDPOINT_ITERATIONS):
    res = (2.0 / h) * math.matvec(inertia, wm - w) + math.cross(
        wm, math.matvec(inertia, wm)) - tau
    jac = (2.0 / h) * inertia + _skew(wm) @ inertia - _skew(
        math.matvec(inertia, wm))
    wm = wm - torch.linalg.solve(jac, res)
  w_new = 2.0 * wm - w
  lin = lin_pos = qvel[:, dofs[:, :3]]
  if lay.offset.any():
    g = m.opt.gravity
    if m.opt.disableflags & DisableBit.GRAVITY:
      g = torch.zeros_like(g)
    vc = math.mat_t_vec(rot, v6[..., :3]) + math.cross(w, c)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    a = (mass / h)[..., None] * eye + 0.5 * mass[..., None] * _skew(wm)
    rhs = ((mass / h) * vc + force_b + mass * math.mat_t_vec(rot, g)
           - 0.5 * mass * math.cross(wm, vc))
    vc_new = torch.linalg.solve(a, rhs)
    quat = math.quat_integrate(d.xquat[:, body], wm, h)
    lin_off = math.matvec(math.quat_to_mat(quat), vc_new - math.cross(w_new, c))
    off = m.const(lay.offset[:, None])
    lin = torch.where(off, lin_off, lin)
    lin_pos = torch.where(off, 0.5 * (v6[..., :3] + lin_off), lin_pos)
  # a lane in which a constraint row acts on the body keeps the solve's
  free = torch.ones(lin.shape[:2], dtype=torch.bool, device=lin.device)
  if constraint.row_layout(m).nefc:
    touch = (d.efc_J[:, :, dofs] != 0).any(-1)         # (B, nefc, K)
    free = ~(touch & d.efc_active[..., None]).any(1)
  rest = np.setdiff1d(np.arange(m.nv), lay.dofs.ravel())

  def put(new):
    new = torch.where(free[..., None], new, qvel[:, dofs])
    return support.assemble(m, "midpoint_qvel", [
        (rest, qvel[:, m.const(rest)]), (lay.dofs, new)])

  return (put(torch.cat([lin, w_new], dim=-1)),
          put(torch.cat([lin_pos, wm], dim=-1)))


def implicit(m: Model, d: Data) -> Data:
  """Implicit-in-velocity integrators (``mj_implicit``): solves (M -
  h qDeriv) qacc = qfrc_smooth + qfrc_constraint.  IMPLICIT takes the full
  qDeriv and a dense LU solve (``torch.linalg.solve``, the JAX package's
  ``jnp.linalg.solve``); IMPLICITFAST drops the Coriolis term and
  symmetrizes, so the Cholesky kernels factor and solve it, and then
  steps the lone free bodies by C's implicit midpoint rule
  (``_midpoint_qvel``; the JAX package has no such term), but for
  INVDISCRETE, whose inverse (``inverse.discrete_acc``) undoes the solve
  alone, and in a fluid: C skips the rule then too."""
  full = m.opt.integrator == IntegratorType.IMPLICIT
  qderiv = smooth_vel_deriv(m, d, flg_bias=full)
  mh = d.qM - m.opt.timestep * qderiv
  qfrc = d.qfrc_smooth + d.qfrc_constraint
  if full:
    return _advance(m, d, torch.linalg.solve(mh, qfrc), d.act_dot)
  mh = 0.5 * (mh + mh.transpose(1, 2))
  qacc = linalg.chol_solve(linalg.chol_factor(mh), qfrc)
  # C applies the rule neither under INVDISCRETE nor in a fluid (density or
  # viscosity set: its probe, tests/test_torch_fluid.py)
  if (m.opt.enableflags & EnableBit.INVDISCRETE or m.opt.density > 0
      or m.opt.viscosity > 0):
    return _advance(m, d, qacc, d.act_dot)
  qvel, qvel_for_pos = _midpoint_qvel(m, d, d.qvel + qacc * m.opt.timestep)
  return _advance(m, d, qacc, d.act_dot, qvel_for_pos=qvel_for_pos,
                  qvel=qvel)


def _check_reset(m: Model, d: Data) -> Data:
  """Per-lane reset of diverged states (``mj_checkPos``/``mj_checkVel``):
  a lane with a non-finite or huge qpos/qvel returns to qpos0 with zero
  velocity, activations, controls and applied forces, eq_active0 and the mocap bodies'
  model poses (``mj_resetData``); the other lanes are untouched."""
  if m.opt.disableflags & DisableBit.AUTORESET:
    return d
  bad_pos = ~torch.all(torch.isfinite(d.qpos), dim=-1) | torch.any(
      torch.abs(d.qpos) > _MAXVAL, dim=-1)
  bad_vel = ~torch.all(torch.isfinite(d.qvel), dim=-1) | torch.any(
      torch.abs(d.qvel) > _MAXVAL, dim=-1)
  bad = bad_pos | bad_vel

  def rst(x, v):
    return torch.where(bad.reshape((-1,) + (1,) * (x.ndim - 1)), v, x)

  reset = {}
  if m.na:
    reset["act"] = rst(d.act, 0.0)
  if m.neq:
    reset["eq_active"] = rst(d.eq_active, m.const(m.eq_active0 != 0))
  if m.nmocap:
    mocap = m.const(mocap_bodies(m))
    reset["mocap_pos"] = rst(d.mocap_pos, m.body_pos[mocap])
    reset["mocap_quat"] = rst(d.mocap_quat, m.body_quat[mocap])
  return d.replace(
      qpos=rst(d.qpos, m.qpos0),
      qvel=rst(d.qvel, 0.0),
      ctrl=rst(d.ctrl, 0.0),
      qacc_warmstart=rst(d.qacc_warmstart, 0.0),
      qfrc_applied=rst(d.qfrc_applied, 0.0),
      xfrc_applied=rst(d.xfrc_applied, 0.0),
      warning=d.warning + torch.stack([bad_pos, bad_vel], -1).to(
          d.warning.dtype),
      **reset,
  )


def step(m: Model, d: Data, ctrl_fn=None) -> Data:
  """One simulation step of every lane (``mj_step``), by the model's
  integrator.  ``ctrl_fn`` is the in-step control callback of ``forward``:
  it fires once under EULER, IMPLICIT and IMPLICITFAST, and once more in
  each of RK4's three stage forwards."""
  d = _check_reset(m, d)
  warm = d.qacc_warmstart
  d = forward(m, d, ctrl_fn=ctrl_fn)
  integrator = IntegratorType(m.opt.integrator)
  if integrator == IntegratorType.EULER:
    return euler(m, d)
  if integrator == IntegratorType.RK4:
    return rungekutta4(m, d.replace(qacc_warmstart=warm), ctrl_fn=ctrl_fn)
  return implicit(m, d)


def step_n(m: Model, d: Data, n: int, ctrl_fn=None) -> Data:
  """``n`` steps of every lane: what ``n`` calls of ``step`` return."""
  for _ in range(n):
    d = step(m, d, ctrl_fn=ctrl_fn)
  return d
