"""Inverse dynamics (port of ``mujoco_inversedynamicstest_tpu/ops/inverse.py``).

Given (qpos, qvel, qacc) per lane, computes the generalized force

    qfrc_inverse = RNE(qpos, qvel, qacc) + armature * qacc
                   - qfrc_passive - qfrc_constraint

(``mj_inverse``) and the forward/inverse consistency diagnostic
(``mj_compareFwdInv``).
"""

from __future__ import annotations

import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    EnableBit,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import constraint, math, smooth
from mujoco_inversedynamicstest_tpu_torch.ops import support
from mujoco_inversedynamicstest_tpu_torch.ops.forward import (
    fwd_position,
    fwd_velocity,
)


def discrete_acc(m: Model, d: Data) -> torch.Tensor:
  """Continuous-time qacc for INVDISCRETE mode, Euler branch
  (``mj_discreteAcc``): solves M qacc' = (M + h diag(damping)) qacc."""
  if not m.has_dof_damping or m.opt.disableflags & DisableBit.EULERDAMP:
    return d.qacc
  qfrc = smooth.mul_m(m, d, d.qacc) + m.opt.timestep * m.dof_damping * d.qacc
  return smooth.solve_m(m, d, qfrc)


def inv_constraint(m: Model, d: Data) -> Data:
  """Constraint force at the given qacc (``mj_invConstraint``)."""
  if constraint.row_layout(m).nefc == 0:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qacc))
  jar = math.matvec(d.efc_J, d.qacc) - d.efc_aref
  return constraint.constraint_update(d, jar)


def _inverse_force(m: Model, d: Data) -> torch.Tensor:
  return (smooth.rne(m, d, flg_acc=True) + m.dof_armature * d.qacc
          - d.qfrc_passive - d.qfrc_constraint)


def inverse(m: Model, d: Data) -> Data:
  """Full inverse dynamics (``mj_inverse``): reads qpos, qvel and qacc,
  writes ``qfrc_inverse`` and the intermediate stages."""
  d = fwd_velocity(m, fwd_position(m, d))
  qacc = d.qacc
  if m.opt.enableflags & EnableBit.INVDISCRETE:
    d = d.replace(qacc=discrete_acc(m, d))
  d = inv_constraint(m, d)
  return d.replace(qfrc_inverse=_inverse_force(m, d), qacc=qacc)


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
