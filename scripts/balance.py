"""The humanoid's one-leg balance LQR (BASELINE rung 3), on the port.

The recipe of MuJoCo's ``python/LQR.ipynb`` (SURVEY.md), on dm_control's
suite humanoid (``assets/humanoid.npz``: nv 27, nu 21, Newton, Euler at
0.005 s), for which the notebook's keyframe does not exist.  It is a
recipe for one model, not part of the package: ``chip_smoke.py`` (phase
21), ``scripts/balance_c_reference.py`` and ``tests/test_torch_lqr.py``
import it with ``scripts/`` on ``sys.path``.

1. ``balance_pose``: stand on the left foot.  The right hip flexes and the
   right knee bends until the right foot is clear of the floor; the body
   then leans over the left ankle until the whole-body CoM is above the
   left foot's CoM, with the foot flat (Gauss-Newton on the port's
   ``support.jac``); the root is lowered until the foot touches, and its
   height is the notebook's: of 2001 heights over +-1 mm, the one where
   ``inverse`` at qacc = 0 needs the least vertical root force.
2. ``balance_control``: the notebook's open-loop control, ctrl0 = qfrc0
   pinv(actuator_moment), qfrc0 from ``inverse`` at that pose.
3. ``balance_cost``: Q = blockdiag(Qpos, 0), R = I, with the notebook's
   Qpos: 1000 J_diffᵀ J_diff (J_diff the whole-body CoM Jacobian less the
   left foot's) plus the joint terms, 3 on the abdomen's and the left
   leg's non-z dofs, 0.3 on the other hinges, 0 on the root.
4. ``lqr_policy``: the in-step control callback ctrl0 - K [dq; qvel] +
   noise, with ``smoothed_noise``'s perturbations (the notebook's smoothed
   Gaussian control noise).
5. ``balanced``: which lanes of a rollout stayed up at every step.

``balance_problem`` runs steps 1-3 and the gain: ``opt.lqr_gain`` of
``opt.transition_ad``'s A and B at the pose and ctrl0.  ``fleet_states``
makes the perturbed initial states of a fleet.

At this pose A has three eigenvalues at 1, two of them the stance moved
sideways on the floor (an equilibrium too, which the controls cannot undo
and Q sees only at round-off), so scipy's ``solve_discrete_are`` finds no
finite solution; the Riccati iteration's gain converges (to 2.2e-10 of
itself from 2000 to 4000 iterations) while P keeps a slow drift
(PERF.md)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.io import make_data
from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    Model,
    StateFlag,
)
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import inverse as inverse_mod
from mujoco_inversedynamicstest_tpu_torch.ops import math, smooth, support
from mujoco_inversedynamicstest_tpu_torch.opt import derivative
from mujoco_inversedynamicstest_tpu_torch.opt.ilqr import lqr_gain

# dm_control's humanoid: its joints and bodies in model order (the
# snapshot carries no names; the CPU tests hold these to the MjModel's)
JOINTS = ("root", "abdomen_z", "abdomen_y", "abdomen_x", "right_hip_x",
          "right_hip_z", "right_hip_y", "right_knee", "right_ankle_y",
          "right_ankle_x", "left_hip_x", "left_hip_z", "left_hip_y",
          "left_knee", "left_ankle_y", "left_ankle_x", "right_shoulder1",
          "right_shoulder2", "right_elbow", "left_shoulder1",
          "left_shoulder2", "left_elbow")
BODIES = ("world", "torso", "head", "lower_waist", "pelvis", "right_thigh",
          "right_shin", "right_foot", "left_thigh", "left_shin", "left_foot",
          "right_upper_arm", "right_lower_arm", "right_hand",
          "left_upper_arm", "left_lower_arm", "left_hand")
TORSO, RIGHT_FOOT, LEFT_FOOT = (BODIES.index(b) for b in (
    "torso", "right_foot", "left_foot"))

# the notebook's cost weights and perturbation
BALANCE_COST, BALANCE_JOINT_COST, OTHER_JOINT_COST = 1000.0, 3.0, 0.3
CTRL_STD, CTRL_RATE = 0.05, 0.8
# the right foot's clearance, the steps of the right leg's flexion (hip,
# knee, in rad), and the Gauss-Newton lean's iteration cap and tolerance
CLEARANCE, HIP_STEP, KNEE_STEP = 0.05, -0.1, -0.2
LEAN_ITERATIONS, LEAN_TOL = 20, 1e-12
HEIGHT_SWEEP, HEIGHT_POINTS = 1e-3, 2001
# the balance test: torso height over the pose's, CoM-foot distance (m)
MIN_HEIGHT, MAX_OFFSET = 0.9, 0.1
# Riccati iterations: the gain changes by 2.2e-10 of itself from 2000 to
# 4000 (dt = 0.005 s; the slowest closed-loop mode is at |z| = 0.9906)
LQR_ITERATIONS = 4000
# a fleet's perturbation of the pose: hinge angles (rad) and velocities
HINGE_NOISE, VEL_NOISE = 0.01, 0.01
# states a kinematics call of ``balanced`` takes
CHUNK_LANES = 1 << 16


class Pose(NamedTuple):
  qpos: torch.Tensor      # (nq,)
  angles: dict            # joint name -> angle set (rad)
  offset: float           # horizontal CoM - left-foot-CoM distance (m)
  height_offset: float    # the sweep's choice (m)
  root_force: float       # |qfrc_inverse[2]| there (N)


def _dof(name: str) -> int:
  """The dof of a hinge of ``JOINTS`` (the root's six come first)."""
  return 5 + JOINTS.index(name)


def _qadr(name: str) -> int:
  return 6 + JOINTS.index(name)


def _positions(m: Model, qpos: torch.Tensor) -> Data:
  """Kinematics and CoM positions of the lanes ``qpos`` (B, nq)."""
  d = make_data(m, qpos.shape[0]).replace(qpos=qpos)
  return smooth.com_pos(m, smooth.kinematics(m, d))


def _bottom(m: Model, d: Data, body: int) -> torch.Tensor:
  """(B,) the lowest point of the capsules of ``body``."""
  geoms = np.nonzero(m.geom_bodyid == body)[0]
  g = m.const(geoms)
  axis = d.geom_xmat[:, g, :, 2]
  size = m.geom_size[g]
  low = (d.geom_xpos[:, g, 2] - torch.abs(axis[..., 2]) * size[:, 1]
         - size[:, 0])
  return low.amin(-1)


def _com(m: Model, d: Data) -> torch.Tensor:
  """(B, 3) the whole-body CoM."""
  mass = m.body_mass
  return (mass[:, None] * d.xipos).sum(1) / mass.sum()


def com_jacobian(m: Model, d: Data) -> torch.Tensor:
  """(B, 3, nv): the whole-body CoM's Jacobian, the mass-weighted sum of
  ``support.jac`` at each body's CoM."""
  bodies = np.arange(m.nbody)
  jacp = support.jac(m, d, d.xipos, bodies)[0]             # (B, nbody, nv, 3)
  mass = m.body_mass
  return (torch.einsum("k,bkvc->bcv", mass, jacp) / mass.sum())


def _foot_jacobian(m: Model, d: Data):
  """(B, 3, nv) each of the left foot's CoM and its frame's rotation."""
  jacp, jacr = support.jac(m, d, d.xipos[:, LEFT_FOOT:LEFT_FOOT + 1],
                           np.array([LEFT_FOOT]))
  return jacp[:, 0].transpose(1, 2), jacr[:, 0].transpose(1, 2)


def _with(qpos: torch.Tensor, values: dict) -> torch.Tensor:
  q = qpos.clone()
  for name, v in values.items():
    q[..., _qadr(name)] = v
  return q


def balance_pose(m: Model) -> Pose:
  """The one-leg stance of the recipe (step 1 of the module docstring),
  one lane in the model's dtype.

  The lean turns the root (roll and pitch) and the left ankle's two hinges
  so that the CoM is over the foot's CoM and the foot is flat: C's
  humanoid limits the left hip's adduction to 5 degrees, too little to put
  the CoM over the foot from an upright torso."""
  q = m.qpos0[None].clone()
  angles = {}
  for k in range(1, 16):
    angles = {"right_hip_y": HIP_STEP * k, "right_knee": KNEE_STEP * k}
    d = _positions(m, _with(q, angles))
    if float(_bottom(m, d, RIGHT_FOOT) - _bottom(m, d, LEFT_FOOT)) >= CLEARANCE:
      break
  q = _with(q, angles)

  dofs = [3, 4, _dof("left_ankle_x"), _dof("left_ankle_y")]
  for _ in range(LEAN_ITERATIONS):
    d = _positions(m, q)
    offset = _com(m, d) - d.xipos[:, LEFT_FOOT]
    z = d.xmat[:, LEFT_FOOT, :, 2]
    res = torch.cat([offset[:, :2], z[:, :2]], -1)[0]
    if float(res.abs().max()) < LEAN_TOL:
      break
    foot_p, foot_r = _foot_jacobian(m, d)
    # the foot's z axis turns as w x z
    jz = -math.cross(z[:, None], foot_r.transpose(1, 2)).transpose(1, 2)
    jac = torch.cat([(com_jacobian(m, d) - foot_p)[:, :2], jz[:, :2]], 1)[0]
    step = torch.linalg.solve(jac[:, dofs], -res)
    dq = torch.zeros(m.nv, dtype=q.dtype, device=q.device)
    dq[dofs] = step
    q = support.integrate_pos(m, q, dq[None], 1.0)
  for name in ("left_ankle_x", "left_ankle_y"):
    angles[name] = float(q[0, _qadr(name)])

  d = _positions(m, q)
  offset = float(torch.linalg.norm((_com(m, d) - d.xipos[:, LEFT_FOOT])[0, :2]))
  q[:, 2] -= _bottom(m, d, LEFT_FOOT)
  heights = torch.linspace(-HEIGHT_SWEEP, HEIGHT_SWEEP, HEIGHT_POINTS,
                           dtype=q.dtype, device=q.device)
  sweep = q.expand(HEIGHT_POINTS, m.nq).clone()
  sweep[:, 2] += heights
  d = make_data(m, HEIGHT_POINTS).replace(qpos=sweep)
  force = inverse_mod.inverse(m, d).qfrc_inverse[:, 2].abs()
  best = int(torch.argmin(force))
  q[:, 2] += heights[best]
  return Pose(qpos=q[0], angles=angles, offset=offset,
              height_offset=float(heights[best]),
              root_force=float(force[best]))


def balance_control(m: Model, qpos: torch.Tensor) -> torch.Tensor:
  """ctrl0 (nu,): the notebook's qfrc0 pinv(actuator_moment), qfrc0 the
  inverse dynamics at ``qpos`` (nq,) at rest with qacc = 0."""
  d = inverse_mod.inverse(m, make_data(m, 1).replace(qpos=qpos[None]))
  return (d.qfrc_inverse @ torch.linalg.pinv(d.actuator_moment[0]))[0]


def balance_cost(m: Model, qpos: torch.Tensor):
  """(Q, R): Q (2 nv, 2 nv) = blockdiag(Qpos, 0) and R = I (nu, nu) of the
  notebook, at the pose ``qpos`` (nq,)."""
  d = _positions(m, qpos[None])
  j_diff = (com_jacobian(m, d) - _foot_jacobian(m, d)[0])[0]   # (3, nv)
  weights = torch.full((m.nv,), OTHER_JOINT_COST, dtype=qpos.dtype,
                       device=qpos.device)
  weights[:6] = 0.0
  for name in JOINTS[1:]:
    if "z" in name:
      continue
    if name.startswith("abdomen") or (name.startswith("left_") and any(
        part in name for part in ("hip", "knee", "ankle"))):
      weights[_dof(name)] = BALANCE_JOINT_COST
  qpos_cost = BALANCE_COST * j_diff.T @ j_diff + torch.diag(weights)
  q = torch.zeros((2 * m.nv, 2 * m.nv), dtype=qpos.dtype, device=qpos.device)
  q[:m.nv, :m.nv] = qpos_cost
  return q, torch.eye(m.nu, dtype=qpos.dtype, device=qpos.device)


def smoothed_noise(m: Model, gen: torch.Generator, steps: int,
                   lanes: int) -> torch.Tensor:
  """(steps, lanes, nu) control perturbations: the notebook's, white noise
  a (lane, actuator) convolved with a unit-norm Gaussian of CTRL_RATE
  seconds ('same' mode), times CTRL_STD."""
  width = round(CTRL_RATE / m.opt.timestep)
  kw = dict(dtype=m.dtype, device=m.device)
  white = torch.randn((lanes * m.nu, 1, steps), generator=gen, **kw)
  kernel = torch.exp(-0.5 * torch.linspace(-3, 3, width, **kw) ** 2)
  kernel = kernel / torch.linalg.norm(kernel)
  full = torch.nn.functional.conv1d(white, kernel.flip(0)[None, None],
                                    padding=width - 1)
  start = (width - 1) // 2
  same = full[:, 0, start:start + steps]
  return CTRL_STD * same.reshape(lanes, m.nu, steps).permute(2, 0, 1)


def lqr_policy(m: Model, qpos: torch.Tensor, ctrl0: torch.Tensor,
               gain: torch.Tensor, noise: torch.Tensor):
  """The closed-loop control callback ctrl_fn(m, d) = ctrl0 - K
  [differentiate_pos(qpos, d.qpos); d.qvel; d.act] + noise[t], t the step
  number of each lane's ``d.time``.  ``gain`` (nu, nx) or (B, nu, nx)
  (K = 0 on a lane runs it open loop); ``noise`` (T, B, nu)."""
  h = m.opt.timestep

  def ctrl_fn(m_, d):
    dx = torch.cat([support.differentiate_pos(m_, qpos, d.qpos, 1.0),
                    d.qvel, d.act], dim=-1)
    t = torch.round(d.time / h).long().clamp(0, noise.shape[0] - 1)
    lanes = torch.arange(d.batch, device=d.qpos.device)
    return ctrl0 - math.matvec(gain, dx) + noise[t, lanes]

  return ctrl_fn


def balanced(m: Model, qpos: torch.Tensor, pose: torch.Tensor):
  """Of the states ``qpos`` (B, T, nq) of a rollout from ``pose`` (nq,):
  (B,) whether the lane stayed up at every step (the torso at least
  MIN_HEIGHT of the pose's height, and the horizontal distance from the
  CoM to the left foot's CoM at most MAX_OFFSET), and (B,) the largest
  such distance.  The kinematics run on up to CHUNK_LANES states at a
  time."""
  b, steps = qpos.shape[:2]
  per = max(1, CHUNK_LANES // b)
  ok, worst = [], []
  for t in range(0, steps, per):
    q = qpos[:, t:t + per]
    d = _positions(m, q.reshape(-1, m.nq))
    dist = torch.linalg.norm((_com(m, d) - d.xipos[:, LEFT_FOOT])[:, :2],
                             dim=-1).reshape(b, -1)
    up = d.xpos[:, TORSO, 2].reshape(b, -1) >= MIN_HEIGHT * pose[2]
    ok.append((up & (dist <= MAX_OFFSET)).all(1))
    worst.append(dist.amax(1))
  return (torch.stack(ok, 1).all(1),
          torch.stack(worst, 1).amax(1))


class Problem(NamedTuple):
  pose: Pose
  ctrl0: torch.Tensor     # (nu,)
  a: torch.Tensor         # (nx, nx)
  b: torch.Tensor         # (nx, nu)
  q: torch.Tensor         # (nx, nx)
  r: torch.Tensor         # (nu, nu)
  gain: torch.Tensor      # (nu, nx)
  p: torch.Tensor         # (nx, nx)


def balance_problem(m: Model, iterations: int = LQR_ITERATIONS) -> Problem:
  """Steps 1-3 of the recipe and the gain K, P = lqr_gain(A, B, Q, R) with
  A, B of ``transition_ad`` at the pose with ctrl0, one lane in the model's
  dtype."""
  pose = balance_pose(m)
  ctrl0 = balance_control(m, pose.qpos)
  d = forward_mod.forward(m, make_data(m, 1).replace(
      qpos=pose.qpos[None], ctrl=ctrl0[None]))
  tr = derivative.transition_ad(m, d)
  q, r = balance_cost(m, pose.qpos)
  gain, p = lqr_gain(tr.A[0], tr.B[0], q, r, iterations)
  return Problem(pose=pose, ctrl0=ctrl0, a=tr.A[0], b=tr.B[0], q=q, r=r,
                 gain=gain, p=p)


def fleet_states(m: Model, qpos: torch.Tensor, gen: torch.Generator,
                 lanes: int) -> torch.Tensor:
  """(lanes, nfullphysics) FULLPHYSICS vectors at rest at the pose ``qpos``
  (nq,), with HINGE_NOISE on the hinge angles and VEL_NOISE on every
  velocity (normal, from ``gen``), in the model's dtype."""
  kw = dict(generator=gen, dtype=m.dtype, device=m.device)
  q = qpos.expand(lanes, m.nq).clone()
  q[:, 7:] += HINGE_NOISE * torch.randn((lanes, m.nq - 7), **kw)
  d = make_data(m, lanes).replace(
      qpos=q, qvel=VEL_NOISE * torch.randn((lanes, m.nv), **kw))
  return support.get_state(m, d, StateFlag.FULLPHYSICS)
