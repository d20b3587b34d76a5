"""Dynamics derivatives: the linearization primitives of the MPC engine.

Port of ``mujoco_inversedynamicstest_tpu/opt/derivative.py`` for a fleet:
every function takes a ``Data`` of B lanes and returns one Jacobian a lane.

* ``transition_ad`` / ``transition_fd`` -- analogs of ``mjd_transitionFD``:
  A, B of ``step`` in the tangent space x = [dq; qvel; act] (dim 2 nv +
  na).  The AD variant is ``torch.func.vmap`` over
  ``torch.func.jvp`` of one ``step`` of the B lanes, as the JAX package's
  ``jax.jacfwd``: the primal runs once a lane and the nx + nu unit
  tangents are the vmapped dimension.  The Newton and line-search loops
  of ``ops/solver.py`` end on ``bool(live.any())``, which depends on
  primals alone and so stays unbatched under a ``vmap`` over tangents.
  The step's Cholesky factor and solve carry all the tangents through one
  ``chol_factor_jvp`` / ``chol_solve_jvp`` launch each (``ops/linalg.py``).
  The FD variant folds its perturbations into the batch: each lane's Data
  is repeated once a perturbation, and one ``step`` runs them all.
* ``inverse_ad`` / ``inverse_fd`` -- analogs of ``mjd_inverseFD``:
  Jacobians of ``qfrc_inverse`` w.r.t. (qpos, qvel, qacc), the same two
  ways.

* ``smooth_vel_deriv`` -- analog of ``mjd_smooth_vel``: qDeriv, the
  Jacobian of qfrc_passive - qfrc_bias + qfrc_actuator by qvel, a lane
  each, by ``vmap`` over ``jvp`` (``ops/forward.py``).  The implicit
  integrators and their discrete inverse use it; under IMPLICIT or
  IMPLICITFAST ``transition_ad`` nests it inside its own ``vmap`` over
  ``jvp``.

With ``flg_sensor``, ``transition_ad`` and ``transition_fd`` also give the
sensor Jacobians C = d sensordata / dx and D = d sensordata / du, a lane
each: sensordata of the step's own forward, at the perturbed pre-step state
(what ``mjd_transitionFD`` reads), from the same pass as A and B.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import func

from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod
from mujoco_inversedynamicstest_tpu_torch.ops import inverse as inverse_mod
from mujoco_inversedynamicstest_tpu_torch.ops import support

smooth_vel_deriv = forward_mod.smooth_vel_deriv

# the fields step and inverse read; every other field is computed from them
INPUTS = ("time", "qpos", "qvel", "act", "ctrl", "qfrc_applied",
          "xfrc_applied", "qacc_warmstart", "qacc", "warning", "eq_active",
          "mocap_pos", "mocap_quat")


# ---------------------------------------------------------------------------
# tangent-space state <-> Data
# ---------------------------------------------------------------------------


def state_dim(m: Model) -> int:
  """Tangent state dimension 2 nv + na (mjd_transitionFD's layout)."""
  return 2 * m.nv + m.na


def apply_tangent(m: Model, d: Data, dx: torch.Tensor,
                  du: Optional[torch.Tensor] = None) -> Data:
  """Perturbs every lane of ``d`` by its tangent state dx = [dq; dv; da]
  (B, nx), and its controls by du (B, nu)."""
  nv = m.nv
  qpos = support.integrate_pos(m, d.qpos, dx[:, :nv], 1.0)
  ctrl = d.ctrl + du if du is not None else d.ctrl
  return d.replace(qpos=qpos, qvel=d.qvel + dx[:, nv:2 * nv],
                   act=d.act + dx[:, 2 * nv:], ctrl=ctrl)


def measure_tangent(m: Model, d_ref: Data, d: Data) -> torch.Tensor:
  """Tangent coordinates (B, nx) of ``d``'s state relative to ``d_ref``'s."""
  dq = support.differentiate_pos(m, d_ref.qpos, d.qpos, 1.0)
  return torch.cat([dq, d.qvel - d_ref.qvel, d.act - d_ref.act], dim=-1)


def get_state(m: Model, d: Data) -> torch.Tensor:
  """Physics state vectors [qpos; qvel; act] (B, nq + nv + na) (cf.
  mjSTATE_PHYSICS)."""
  del m
  return torch.cat([d.qpos, d.qvel, d.act], dim=-1)


def set_state(m: Model, d: Data, x: torch.Tensor) -> Data:
  """Writes [qpos; qvel; act] state vectors (B, nq + nv + na) into ``d``."""
  nq, nv = m.nq, m.nv
  return d.replace(qpos=x[:, :nq], qvel=x[:, nq:nq + nv],
                   act=x[:, nq + nv:nq + nv + m.na])


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
  """State-space linearization of step, a lane each: dx' = A dx + B du,
  and with sensors ds = C dx + D du."""
  A: torch.Tensor              # (B, nx, nx)
  B: torch.Tensor              # (B, nx, nu)
  C: Optional[torch.Tensor]    # (B, nsensordata, nx); None without flg_sensor
  D: Optional[torch.Tensor]    # (B, nsensordata, nu)


def _split(m: Model, jac: torch.Tensor,
           sjac: Optional[torch.Tensor] = None) -> Transition:
  """(B, nx, nx + nu) and (B, nsensordata, nx + nu) -> Transition."""
  nx = state_dim(m)
  return Transition(A=jac[..., :nx], B=jac[..., nx:],
                    C=None if sjac is None else sjac[..., :nx],
                    D=None if sjac is None else sjac[..., nx:])


def _unit_tangents(d: Data, nz: int) -> torch.Tensor:
  """(nz, B, nz): tangent i is the unit vector e_i in every lane (a view of
  an identity, repeated over the lanes by a stride of 0)."""
  eye = torch.eye(nz, dtype=d.qpos.dtype, device=d.qpos.device)
  return eye[:, None, :].expand(nz, d.batch, nz)


def _sensordata(m: Model, d: Data) -> torch.Tensor:
  """``d.sensordata``; zeros where no sensor stage wrote it (sensors
  disabled, or none), which C's finite differences of it read as zero."""
  if d.sensordata is None:
    return d.qpos.new_zeros((d.batch, m.nsensordata))
  return d.sensordata


def transition_jacobian(m: Model, d: Data, flg_sensor: bool = False):
  """One ``step`` of the B lanes of ``d`` with all the tangent columns:
  (qpos, qvel, act) of the next state, and the (B, nx, nx + nu) Jacobian of its
  tangent coordinates by z = [dx; du]; with ``flg_sensor`` also the step's
  sensordata and its (B, nsensordata, nx + nu) Jacobian.

  ``torch.func.vmap`` over ``torch.func.jvp``, as the JAX package's
  ``jacfwd``: the step's primal runs once a lane and stays unbatched, and
  the nx + nu unit tangents are the vmapped dimension, carried by every
  operation at once (the Cholesky JVPs as one multi-tangent launch).  The
  next state's tangent coordinates are measured from its own primal.
  """
  nx = state_dim(m)
  nz = nx + m.nu
  ins = select_lanes(d, slice(None))
  z0 = d.qpos.new_zeros(d.batch, nz)

  def next_state(z):
    dn = forward_mod.step(m, apply_tangent(m, ins, z[:, :nx], z[:, nx:]))
    return (dn.qpos, dn.qvel, dn.act) + ((_sensordata(m, dn),) if flg_sensor
                                          else ())

  def column(e):
    primal, tangent = func.jvp(next_state, (z0,), (e,))
    qpos, qvel, act = primal[:3]
    ref = ins.replace(qpos=qpos, qvel=qvel, act=act)
    _, dy = func.jvp(
        lambda q, v, a: measure_tangent(m, ref, ref.replace(qpos=q, qvel=v,
                                                            act=a)),
        (qpos, qvel, act), tangent[:3])
    return (dy,) + tangent[3:], primal

  jac, primal = func.vmap(column, out_dims=(0, None))(_unit_tangents(d, nz))
  jac = tuple(j.permute(1, 2, 0) for j in jac)
  if flg_sensor:
    return primal[0], primal[1], jac[0], primal[3], jac[1]
  return primal[0], primal[1], jac[0]


def transition_ad(m: Model, d: Data, flg_sensor: bool = False) -> Transition:
  """Exact transition Jacobians by forward-mode AD (``transition_jacobian``);
  with ``flg_sensor`` also C and D, from the same pass.

  ``d`` holds B lanes after a completed forward pass (as the reference
  requires: its ``qacc_warmstart`` starts the solver).
  """
  out = transition_jacobian(m, d, flg_sensor)
  return _split(m, out[2], out[4] if flg_sensor else None)


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
                  flg_centered: bool = False,
                  flg_sensor: bool = False) -> Transition:
  """Finite-difference transition Jacobians (ref ``mjd_transitionFD``),
  with C and D where ``flg_sensor``.

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
                   qvel=dn.qvel[::k].repeat_interleave(k, 0),
                   act=dn.act[::k].repeat_interleave(k, 0))

  def differences(y):
    y = y.reshape(d.batch, k, -1)
    if flg_centered:
      jac = (y[:, 1:nz + 1] - y[:, nz + 1:]) / (2 * eps)
    else:
      jac = (y[:, 1:] - y[:, :1]) / eps
    return jac.transpose(1, 2)

  return _split(m, differences(measure_tangent(m, ref, dn)),
                differences(_sensordata(m, dn)) if flg_sensor else None)


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
  ``mjd_inverseFD``): ``vmap`` over ``jvp`` of one ``inverse`` of the B
  lanes, the 3 nv unit tangents the vmapped dimension."""
  nz = 3 * m.nv
  ins = select_lanes(d, slice(None))
  z0 = d.qpos.new_zeros(d.batch, nz)
  jac = func.vmap(lambda e: func.jvp(lambda z: _inverse_f(m, ins, z), (z0,),
                                     (e,))[1])(_unit_tangents(d, nz))
  return _inverse_jac(m, jac.permute(1, 2, 0))


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
