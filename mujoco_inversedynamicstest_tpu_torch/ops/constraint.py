"""Constraint rows with static shapes and activity masks.

Port of ``mujoco_inversedynamicstest_tpu/ops/constraint.py`` for the rows the
slice reaches: joint limits on hinges and slides, and pyramidal or
frictionless contacts.  Every potential row exists every step; an inactive
row has a zero Jacobian and D = 0, which makes it a no-op downstream.  Row
order follows the reference: limits, then contacts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models.types import (
    Data,
    DisableBit,
    Model,
)
from mujoco_inversedynamicstest_tpu_torch.ops import collision, math

# mjMINIMP / mjMAXIMP
_MINIMP = 0.0001
_MAXIMP = 0.9999


class RowLayout(NamedTuple):
  """Static efc row layout of a model."""
  nl: int
  ncon_rows: int
  nefc: int
  limit_jnt: np.ndarray   # limited hinge/slide joints, one per row pair


def _build_row_layout(m: Model) -> RowLayout:
  # frictionless contacts take one row, pyramidal 2 (condim - 1)
  dim = collision.contact_layout(m).dim
  ncon_rows = int(np.sum(np.where(dim == 1, 1, 2 * (dim - 1))))
  limit_jnt = np.zeros(0, np.int64)
  if not m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.LIMIT):
    limit_jnt = np.nonzero(m.jnt_limited)[0]
  nl = 2 * len(limit_jnt)
  return RowLayout(nl=nl, ncon_rows=ncon_rows, nefc=nl + ncon_rows,
                   limit_jnt=limit_jnt)


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


def _kbip(m: Model, solref, solimp, imp, impp) -> torch.Tensor:
  """Stiffness, damping, impedance, impedance' per row
  (``mj_makeImpedance``); solref/solimp are lane-independent."""
  ref0, ref1 = solref[:, 0], solref[:, 1]
  if not m.opt.disableflags & DisableBit.REFSAFE:
    ref0 = torch.where(ref0 > 0,
                       torch.clamp(ref0, min=2 * m.opt.timestep), ref0)
  dmax = torch.clamp(solimp[:, 1], _MINIMP, _MAXIMP)
  k = torch.where(
      ref0 > 0,
      1.0 / torch.clamp(dmax**2 * ref0**2 * ref1**2, min=math.MINVAL),
      -ref0 / torch.clamp(dmax**2, min=math.MINVAL))
  b = torch.where(ref1 > 0, 2.0 / torch.clamp(dmax * ref0, min=math.MINVAL),
                  -ref1 / torch.clamp(dmax, min=math.MINVAL))
  return torch.stack([k.expand_as(imp), b.expand_as(imp), imp, impp], dim=-1)


def _limit_rows(m: Model, d: Data, jnts: np.ndarray):
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
  return (jac.reshape(bsz, 2 * ns, m.nv), dist.reshape(bsz, -1),
          rep2(margin), act.reshape(bsz, -1), rep2(m.jnt_solref[jj]),
          rep2(m.jnt_solimp[jj]),
          rep2(m.dof_invweight0[m.const(m.jnt_dofadr[jnts])]))


def _contact_row_map(clay):
  """Static per-row tables (slot, friction axis k, sign); pyramidal rows
  come as (k, +1), (k, -1) per friction axis, frictionless as (0, 0)."""
  slot_idx, k_idx, sign = [], [], []
  for slot, condim in enumerate(clay.dim):
    if condim == 1:
      slot_idx.append(slot)
      k_idx.append(0)
      sign.append(0.0)
    else:
      for k in range(1, condim):
        for s in (1.0, -1.0):
          slot_idx.append(slot)
          k_idx.append(k)
          sign.append(s)
  return np.array(slot_idx), np.array(k_idx), np.array(sign)


def _contact_rows(m: Model, d: Data):
  """Contact rows (``mj_instantiateContact``, contact ``mj_diagApprox``,
  pyramidal R: Rpy = 2 mu_reg^2 R0).  Returns (J, pos, margin, active,
  KBIP, R, D)."""
  clay = collision.contact_layout(m)
  con = d.contact
  slot_idx, k_idx, sign_np = _contact_row_map(clay)
  nrows = len(slot_idx)
  si = m.const(slot_idx)
  ar = m.const(np.arange(nrows))
  b1, b2 = m.geom_bodyid[con.geom1], m.geom_bodyid[con.geom2]

  frame = con.frame[:, si]                               # (B, R, 3, 3)
  n_dir = frame[..., 0, :]
  is_tan = (k_idx >= 1) & (k_idx <= 2)
  tan_row = m.const(np.where(is_tan, np.maximum(k_idx, 1), 1))
  rot_row = m.const(np.where(k_idx >= 3, k_idx - 3, 0))
  mu_row = con.friction[si, m.const(np.maximum(k_idx - 1, 0))]
  sign_mu = (m.const(sign_np) * mu_row)[:, None]
  w_t = n_dir + sign_mu * (frame[:, ar, tan_row]
                           * m.const(is_tan.astype(float))[:, None])
  w_r = sign_mu * (frame[:, ar, rot_row]
                   * m.const((k_idx >= 3).astype(float))[:, None])

  p_row = con.pos[:, si]
  com = d.subtree_com[:, m.const(m.body_rootid)]
  cdof_t = d.cdof.transpose(1, 2)

  def side_rows(bids):
    off = p_row - com[:, m.const(bids[slot_idx])]
    u = torch.cat([math.cross(off, w_t) + w_r, w_t], dim=-1)
    return u @ cdof_t                                     # (B, R, nv)

  mask = lambda bids: m.const(m.tree.body_dof_mask[bids[slot_idx]])
  rows_j = (torch.where(mask(b2), side_rows(b2), 0.0)
            - torch.where(mask(b1), side_rows(b1), 0.0))

  invw = m.body_invweight0
  tran = invw[m.const(b1), 0] + invw[m.const(b2), 0]      # (ncon,)
  imp, impp = _impedance(con.solimp, con.dist, con.includemargin)
  kbip = _kbip(m, con.solref, con.solimp, imp, impp)     # (B, ncon, 4)
  active = con.dist < con.includemargin

  mu0 = con.friction[:, 0]
  da0 = torch.where(m.const(clay.dim == 1), tran, tran + mu0**2 * tran)
  r0 = torch.clamp((1 - imp) * da0 / imp, min=math.MINVAL)
  r_py = 2.0 * (mu0 / np.sqrt(m.opt.impratio))**2 * r0
  rows_r = torch.where(m.const(k_idx == 0), r0[:, si], r_py[:, si])
  rows_active = active[:, si]
  rows_d = torch.where(rows_active, 1.0 / rows_r, 0.0)
  return (rows_j * rows_active[..., None], con.dist[:, si],
          con.includemargin[si].expand(d.batch, nrows), rows_active,
          kbip[:, si], rows_r, rows_d)


def make_constraint(m: Model, d: Data) -> Data:
  """Builds every constraint row (``mj_makeConstraint``)."""
  lay = row_layout(m)
  bsz = d.batch
  parts = []
  if lay.nl:
    jac, pos, margin, active, solref, solimp, diag = _limit_rows(
        m, d, lay.limit_jnt)
    imp, impp = _impedance(solimp, pos, margin)
    r = torch.clamp((1 - imp) * diag / imp, min=math.MINVAL)
    parts.append((jac, pos, margin.expand(bsz, -1), active,
                  _kbip(m, solref, solimp, imp, impp), r,
                  torch.where(active, 1.0 / r, 0.0)))
  if lay.ncon_rows:
    parts.append(_contact_rows(m, d))
  if not parts:
    return d.replace(efc_J=None)
  jac, pos, margin, active, kbip, r, dvec = (
      torch.cat(p, dim=1) for p in zip(*parts))
  return d.replace(efc_J=jac * active[..., None], efc_pos=pos,
                   efc_margin=margin, efc_D=dvec, efc_R=r, efc_KBIP=kbip,
                   efc_active=active)


def reference_constraint(m: Model, d: Data) -> Data:
  """aref = -B vel - K imp (pos - margin) (``mj_referenceConstraint``)."""
  if row_layout(m).nefc == 0:
    return d
  vel = math.matvec(d.efc_J, d.qvel)
  k, b, imp = d.efc_KBIP[..., 0], d.efc_KBIP[..., 1], d.efc_KBIP[..., 2]
  aref = -b * vel - k * imp * (d.efc_pos - d.efc_margin)
  return d.replace(efc_aref=aref * d.efc_active)


def forces_cost(d: Data, jar: torch.Tensor):
  """Constraint force, cost and quadratic-zone mask at ``jar = J qacc -
  aref`` (``mj_constraintUpdate``).  Every row of the slice is an
  inequality (limits, pyramidal and frictionless contacts): it is in its
  quadratic zone exactly when ``jar < 0``."""
  quad = jar < 0
  force = torch.where(quad, -d.efc_D * jar, 0.0) * d.efc_active
  cost = 0.5 * torch.sum(torch.where(quad, d.efc_D * jar * jar, 0.0), dim=-1)
  return force, cost, quad


def constraint_update(d: Data, jar: torch.Tensor) -> Data:
  """efc_force and qfrc_constraint at ``jar``."""
  force, _, _ = forces_cost(d, jar)
  qfrc = math.matvec(d.efc_J.transpose(1, 2), force)
  return d.replace(efc_force=force, qfrc_constraint=qfrc)


def _contact_force_map(m: Model) -> torch.Tensor:
  """(ncon_rows, 6 ncon): each contact row's share of its slot's force in
  the contact frame (``mju_decodePyramid``): 1 into the normal for every
  row, ±mu_k into friction component k for the pair of rows of axis k."""
  clay = collision.contact_layout(m)
  slot_idx, k_idx, sign = _contact_row_map(clay)
  friction = collision.contact_constants(m)[1]             # (ncon, 5)
  rows = np.arange(len(slot_idx))
  out = torch.zeros((len(slot_idx), clay.ncon, 6), dtype=m.dtype,
                    device=m.device)
  out[m.const(rows), m.const(slot_idx), 0] = 1.0
  fric = np.nonzero(k_idx >= 1)[0]
  mu = friction[m.const(slot_idx[fric]), m.const(k_idx[fric] - 1)]
  out[m.const(rows[fric]), m.const(slot_idx[fric]),
      m.const(k_idx[fric])] = m.const(sign[fric]) * mu
  return out.reshape(len(slot_idx), clay.ncon * 6)


def contact_forces_frame(m: Model, d: Data) -> torch.Tensor:
  """Each contact slot's force and torque in its contact frame, (B, ncon,
  6) (``mj_contactForce``): for pyramidal rows the normal force is the sum
  of the slot's rows and friction component k is mu_k times the difference
  of axis k's pair of rows; a frictionless slot's one row is its normal
  force.  Inactive slots read zero."""
  lay = row_layout(m)
  ncon = collision.contact_layout(m).ncon
  f_rows = d.efc_force[:, lay.nl:]
  return (f_rows @ m.memo("contact_force_map", lambda: _contact_force_map(m))
          ).reshape(d.batch, ncon, 6)
