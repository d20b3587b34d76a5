"""Dynamics derivatives: the linearization primitives of the MPC engine.

Port of ``mujoco_inversedynamicstest_tpu/opt/derivative.py`` for a fleet:
every function takes a ``Data`` of B lanes and returns one Jacobian a lane.

* ``transition_ad`` / ``transition_fd`` -- analogs of ``mjd_transitionFD``:
  A, B of ``step`` in the tangent space x = [dq; qvel] (dim 2 nv; the port
  has no activations).  The JAX package takes ``jax.jacfwd`` (or ``vmap``
  over perturbed columns) one lane at a time.  Here the columns are folded
  into the batch: each lane's Data is repeated once a column, every copy
  gets its own unit tangent (AD) or perturbation (FD), and one ``step``
  runs all B (nx + nu) lanes.  The AD variant runs that step on
  ``torch.autograd.forward_ad`` dual tensors and reads A, B from the
  tangent of the measured next state.  ``torch.func.vmap`` over the
  tangents is not an option: the Newton and line-search loops of
  ``ops/solver.py`` end on ``bool(live.any())``, which vmap cannot trace.
  The dual step's Cholesky factor and solve carry their tangents through
  ``chol_factor_jvp`` / ``chol_solve_jvp`` (``ops/linalg.py``).
* ``inverse_ad`` / ``inverse_fd`` -- analogs of ``mjd_inverseFD``:
  Jacobians of ``qfrc_inverse`` w.r.t. (qpos, qvel, qacc), folded the same
  way.

Sensor Jacobians (C, D) are always None: the port has no sensors.
``smooth_vel_deriv`` (``mjd_smooth_vel``) is not ported yet: it belongs to
the implicit integrators, which the port does not have (ROADMAP P6.2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import inverse as inverse_mod
from mujoco_inversedynamicstest_tpu_torch.ops import support

# the fields step and inverse read; every other field is computed from them
INPUTS = ("time", "qpos", "qvel", "ctrl", "qfrc_applied", "xfrc_applied",
           "qacc_warmstart", "qacc", "warning")


# ---------------------------------------------------------------------------
# tangent-space state <-> Data
# ---------------------------------------------------------------------------


def state_dim(m: Model) -> int:
  """Tangent state dimension 2 nv (mjd_transitionFD's layout; na = 0)."""
  return 2 * m.nv


def apply_tangent(m: Model, d: Data, dx: torch.Tensor,
                  du: Optional[torch.Tensor] = None) -> Data:
  """Perturbs every lane of ``d`` by its tangent state dx = [dq; dv]
  (B, nx), and its controls by du (B, nu)."""
  nv = m.nv
  qpos = support.integrate_pos(m, d.qpos, dx[:, :nv], 1.0)
  ctrl = d.ctrl + du if du is not None else d.ctrl
  return d.replace(qpos=qpos, qvel=d.qvel + dx[:, nv:2 * nv], ctrl=ctrl)


def measure_tangent(m: Model, d_ref: Data, d: Data) -> torch.Tensor:
  """Tangent coordinates (B, nx) of ``d``'s state relative to ``d_ref``'s."""
  dq = support.differentiate_pos(m, d_ref.qpos, d.qpos, 1.0)
  return torch.cat([dq, d.qvel - d_ref.qvel], dim=-1)


def get_state(m: Model, d: Data) -> torch.Tensor:
  """Physics state vectors [qpos; qvel] (B, nq + nv) (cf. mjSTATE_PHYSICS)."""
  del m
  return torch.cat([d.qpos, d.qvel], dim=-1)


def set_state(m: Model, d: Data, x: torch.Tensor) -> Data:
  """Writes [qpos; qvel] state vectors (B, nq + nv) into ``d``."""
  return d.replace(qpos=x[:, :m.nq], qvel=x[:, m.nq:m.nq + m.nv])


def repeat_lanes(d: Data, k: int) -> Data:
  """The input fields of ``d`` with each lane repeated ``k`` times in a row
  (lane b becomes lanes b k .. b k + k - 1); derived fields are dropped,
  since ``step``/``forward``/``inverse`` compute them from the inputs."""
  return Data(**{f: getattr(d, f).repeat_interleave(k, dim=0)
                 for f in INPUTS})


def select_lanes(d: Data, index) -> Data:
  """The input fields of the lanes ``index`` (a slice or index tensor)."""
  return Data(**{f: getattr(d, f)[index] for f in INPUTS})


def cat_lanes(ds) -> Data:
  """The input fields of several Data, their lanes one after the other."""
  return Data(**{f: torch.cat([getattr(d, f) for d in ds]) for f in INPUTS})


# ---------------------------------------------------------------------------
# transition Jacobians (A, B)
# ---------------------------------------------------------------------------


class Transition(NamedTuple):
  """State-space linearization of step, a lane each: dx' = A dx + B du."""
  A: torch.Tensor              # (B, nx, nx)
  B: torch.Tensor              # (B, nx, nu)
  C: Optional[torch.Tensor]    # None: the port has no sensors
  D: Optional[torch.Tensor]


def _split(m: Model, jac: torch.Tensor) -> Transition:
  """(B, nx, nx + nu) -> Transition."""
  nx = state_dim(m)
  return Transition(A=jac[..., :nx], B=jac[..., nx:], C=None, D=None)


def _primal_state(d: Data) -> Data:
  """The primal (qpos, qvel) of a dual Data, as a reference to measure
  from."""
  return d.replace(qpos=fwAD.unpack_dual(d.qpos).primal,
                   qvel=fwAD.unpack_dual(d.qvel).primal)


def transition_ad(m: Model, d: Data) -> Transition:
  """Exact transition Jacobians by forward-mode AD, columns in the batch.

  ``d`` holds B lanes after a completed forward pass (as the reference
  requires: its ``qacc_warmstart`` starts the solver).  One dual ``step``
  runs B (nx + nu) lanes: copy i of lane b carries the unit tangent e_i of
  z = [dx; du], and row i of the tangent of its measured next state is
  column i of [A B].  The next state is measured from the copy's own
  primal, the state ``step(d)`` reaches.
  """
  nx = state_dim(m)
  nz = nx + m.nu
  rep = repeat_lanes(d, nz)
  eye = torch.eye(nz, dtype=d.qpos.dtype, device=d.qpos.device)
  with fwAD.dual_level():
    z = fwAD.make_dual(torch.zeros_like(eye).repeat(d.batch, 1),
                       eye.repeat(d.batch, 1))
    dn = forward_mod.step(m, apply_tangent(m, rep, z[:, :nx], z[:, nx:]))
    y = measure_tangent(m, _primal_state(dn), dn)
    jac = fwAD.unpack_dual(y).tangent
  return _split(m, jac.reshape(d.batch, nz, -1).transpose(1, 2))


def _perturbations(nz: int, eps: float, centered: bool,
                   d: Data) -> tuple[torch.Tensor, int]:
  """The k perturbations of one lane (zero, then +eps e_i, then -eps e_i
  when centered), repeated for every lane of ``d``: ((B k, nz), k)."""
  eye = torch.eye(nz, dtype=d.qpos.dtype, device=d.qpos.device)
  z = [torch.zeros_like(eye[:1]), eps * eye] + ([-eps * eye] if centered
                                                else [])
  z = torch.cat(z)
  return z.repeat(d.batch, 1), z.shape[0]


def transition_fd(m: Model, d: Data, eps: float = 1e-6,
                  flg_centered: bool = False) -> Transition:
  """Finite-difference transition Jacobians (ref ``mjd_transitionFD``).

  All perturbed steps of all lanes run as one ``step``: lane b's copies
  are the unperturbed state (the reference), then +eps e_i and, when
  centered, -eps e_i for every column i.
  """
  nx = state_dim(m)
  nz = nx + m.nu
  z, k = _perturbations(nz, eps, flg_centered, d)
  dn = forward_mod.step(m, apply_tangent(m, repeat_lanes(d, k), z[:, :nx],
                                         z[:, nx:]))
  ref = dn.replace(qpos=dn.qpos[::k].repeat_interleave(k, 0),
                   qvel=dn.qvel[::k].repeat_interleave(k, 0))
  y = measure_tangent(m, ref, dn).reshape(d.batch, k, -1)
  if flg_centered:
    jac = (y[:, 1:nz + 1] - y[:, nz + 1:]) / (2 * eps)
  else:
    jac = (y[:, 1:] - y[:, :1]) / eps
  return _split(m, jac.transpose(1, 2))


# ---------------------------------------------------------------------------
# inverse-dynamics Jacobians
# ---------------------------------------------------------------------------


class InverseJac(NamedTuple):
  """d qfrc_inverse / d (qpos, qvel, qacc), a lane each (B, nv, nv)."""
  dfdq: torch.Tensor
  dfdv: torch.Tensor
  dfda: torch.Tensor


def _inverse_f(m: Model, d: Data, z: torch.Tensor) -> torch.Tensor:
  """qfrc_inverse of every lane of ``d`` perturbed by z = [dq; dv; da]."""
  nv = m.nv
  dp = d.replace(
      qpos=support.integrate_pos(m, d.qpos, z[:, :nv], 1.0),
      qvel=d.qvel + z[:, nv:2 * nv],
      qacc=d.qacc + z[:, 2 * nv:],
  )
  return inverse_mod.inverse(m, dp).qfrc_inverse


def _inverse_jac(m: Model, jac: torch.Tensor) -> InverseJac:
  """(B, nv, 3 nv) -> InverseJac."""
  nv = m.nv
  return InverseJac(dfdq=jac[..., :nv], dfdv=jac[..., nv:2 * nv],
                    dfda=jac[..., 2 * nv:])


def inverse_ad(m: Model, d: Data) -> InverseJac:
  """Exact inverse-dynamics Jacobians by forward-mode AD (replacement for
  ``mjd_inverseFD``), the 3 nv columns folded into the batch."""
  nz = 3 * m.nv
  rep = repeat_lanes(d, nz)
  eye = torch.eye(nz, dtype=d.qpos.dtype, device=d.qpos.device)
  with fwAD.dual_level():
    z = fwAD.make_dual(torch.zeros_like(eye).repeat(d.batch, 1),
                       eye.repeat(d.batch, 1))
    jac = fwAD.unpack_dual(_inverse_f(m, rep, z)).tangent
  return _inverse_jac(m, jac.reshape(d.batch, nz, -1).transpose(1, 2))


def inverse_fd(m: Model, d: Data, eps: float = 1e-6,
               flg_centered: bool = False) -> InverseJac:
  """Finite-difference inverse-dynamics Jacobians, all columns of all lanes
  in one ``inverse``."""
  nz = 3 * m.nv
  z, k = _perturbations(nz, eps, flg_centered, d)
  f = _inverse_f(m, repeat_lanes(d, k), z).reshape(d.batch, k, -1)
  if flg_centered:
    jac = (f[:, 1:nz + 1] - f[:, nz + 1:]) / (2 * eps)
  else:
    jac = (f[:, 1:] - f[:, :1]) / eps
  return _inverse_jac(m, jac.transpose(1, 2))
