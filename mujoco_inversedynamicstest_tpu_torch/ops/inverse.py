"""Inverse dynamics (port of the JAX package's ``ops/inverse.py``).

Given (qpos, qvel, qacc) per lane, computes the generalized force

    qfrc_inverse = RNE(qpos, qvel, qacc) + armature * qacc
                   - qfrc_passive - qfrc_constraint

(``mj_inverse``), with INVDISCRETE's map from the integrator's discrete
qacc to the continuous one, and the forward/inverse consistency diagnostic
(``mj_compareFwdInv``).
"""

from __future__ import annotations

import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    EnableBit,
    IntegratorType,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import constraint, math, sensor
from mujoco_inversedynamicstest_tpu_torch.ops import smooth, support
from mujoco_inversedynamicstest_tpu_torch.ops.forward import (
    fwd_position,
    fwd_velocity,
    smooth_vel_deriv,
)


def discrete_acc(m: Model, d: Data) -> torch.Tensor:
  """Continuous-time qacc for INVDISCRETE mode (``mj_discreteAcc``).

  EULER solves M qacc' = (M + h diag(damping)) qacc; IMPLICIT and
  IMPLICITFAST solve M qacc' = (M - h qDeriv) qacc, with qDeriv from
  ``smooth_vel_deriv`` (without the Coriolis term, and symmetrized, for
  IMPLICITFAST).  RK4 has no discrete inverse: ValueError, as C refuses it.
  """
  integrator = IntegratorType(m.opt.integrator)
  if integrator == IntegratorType.RK4:
    raise ValueError("discrete inverse dynamics is unsupported for RK4")
  if integrator == IntegratorType.EULER:
    if not m.has_dof_damping or m.opt.disableflags & DisableBit.EULERDAMP:
      return d.qacc
    qfrc = (smooth.mul_m(m, d, d.qacc)
            + m.opt.timestep * m.dof_damping * d.qacc)
    return smooth.solve_m(m, d, qfrc)
  full = integrator == IntegratorType.IMPLICIT
  mh = d.qM - m.opt.timestep * smooth_vel_deriv(m, d, flg_bias=full)
  if not full:
    mh = 0.5 * (mh + mh.transpose(1, 2))
  return smooth.solve_m(m, d, math.matvec(mh, d.qacc))


def inv_constraint(m: Model, d: Data) -> Data:
  """Constraint force at the given qacc (``mj_invConstraint``)."""
  if constraint.row_layout(m).nefc == 0:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qacc))
  jar = math.matvec(d.efc_J, d.qacc) - d.efc_aref
  return constraint.constraint_update(m, d, jar)


def _inverse_force(m: Model, d: Data) -> torch.Tensor:
  return (smooth.rne(m, d, flg_acc=True) + m.dof_armature * d.qacc
          - d.qfrc_passive - d.qfrc_constraint)


def inverse(m: Model, d: Data, skip_sensor: bool = True) -> Data:
  """Full inverse dynamics (``mj_inverse``): reads qpos, qvel and qacc,
  writes ``qfrc_inverse`` and the intermediate stages.  Unless
  ``skip_sensor``, each sensor stage runs after the stage it reads, the
  acceleration stage at the continuous qacc and the inverse's constraint
  forces (``mj_inverseSkip``)."""
  d = fwd_position(m, d)
  if not skip_sensor:
    d = sensor.sensor_pos(m, d)
  d = fwd_velocity(m, d)
  if not skip_sensor:
    d = sensor.sensor_vel(m, d)
  qacc = d.qacc
  if m.opt.enableflags & EnableBit.INVDISCRETE:
    d = d.replace(qacc=discrete_acc(m, d))
  d = inv_constraint(m, d)
  d = d.replace(qfrc_inverse=_inverse_force(m, d))
  if not skip_sensor:
    d = sensor.sensor_acc(m, d)
  return d.replace(qacc=qacc)


def compare_fwd_inv(m: Model, d: Data) -> Data:
  """Forward/inverse consistency (``mj_compareFwdInv``) of a completed
  forward pass, per lane:

  ``solver_fwdinv[:, 0] = |qfrc_constraint_fwd - qfrc_constraint_inv|``,
  ``solver_fwdinv[:, 1] = |qfrc_applied + Jᵀ xfrc + qfrc_actuator -
  qfrc_inverse|``.
  """
  qforce = d.qfrc_applied + d.qfrc_actuator + support.xfrc_accumulate(m, d)
  di = d
  if m.opt.enableflags & EnableBit.INVDISCRETE:
    di = di.replace(qacc=discrete_acc(m, di))
  di = inv_constraint(m, di)
  fwdinv = torch.stack([
      torch.linalg.vector_norm(d.qfrc_constraint - di.qfrc_constraint, dim=-1),
      torch.linalg.vector_norm(qforce - _inverse_force(m, di), dim=-1),
  ], dim=-1)
  return d.replace(solver_fwdinv=fwdinv)
