"""Host interop: names, keyframes, and Data export back to the C engine.

Port of the JAX package's ``models/interop.py``.  Parity
targets in the reference: ``mj_name2id`` / ``mj_id2name``
(``src/engine/engine_name.c``), ``mj_resetDataKeyframe``
(``src/engine/engine_io.c``) and MJX's ``get_data``.

The JAX package reads names and keyframes from the ``mujoco.MjModel`` its
``Model`` keeps.  The port's ``Model`` keeps none: the names and keyframes
come from the model's snapshot (``Model.snapshot``, the ``NAME_FIELDS`` of
``models/io.py``), so they work on a machine without ``mujoco``.  A model
whose snapshot lacks them raises and says how to rewrite the snapshot.
``get_data`` and ``get_data_batch`` copy a lane into a ``mujoco.MjData``
and take the ``MjModel`` as an argument; they import ``mujoco`` inside.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models import io
from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model

OBJECT_NAMES = io.OBJECT_NAMES
_ADR_BY_TYPE = {v: adr for v, adr in OBJECT_NAMES.values()}


def _snapshot(m: Model) -> dict:
  f = m.snapshot
  if f is None or "names" not in f:
    raise ValueError(
        "the model's snapshot carries no names or keyframes: rewrite it "
        "from the MjModel with save_model_snapshot(mjm, path, names=True)")
  return f


def _objtype(objtype) -> int:
  """mjtObj's value of a type given by name ("body"), as
  ``mujoco.mjtObj`` or as an int."""
  if isinstance(objtype, str):
    return OBJECT_NAMES[objtype.lower().removeprefix("mjobj_")][0]
  return int(objtype)


def _names(m: Model, objtype: int) -> tuple:
  """The names of each object of the type, "" where unnamed."""

  def table():
    f = _snapshot(m)
    field = _ADR_BY_TYPE.get(objtype)
    if field is None:
      return ()
    blob = bytes(np.asarray(f["names"], np.uint8))
    return tuple(blob[a:blob.index(b"\0", a)].decode()
                 for a in np.asarray(f[field]).astype(np.int64))

  return m.memo(("names", objtype), table)


def name2id(m: Model, objtype, name: str) -> int:
  """Object id for a name, -1 if absent (ref ``mj_name2id``)."""
  if not name:
    return -1
  names = _names(m, _objtype(objtype))
  return names.index(name) if name in names else -1


def id2name(m: Model, objtype, objid: int) -> Optional[str]:
  """Name of an object id, None if unnamed or out of range (ref
  ``mj_id2name``)."""
  names = _names(m, _objtype(objtype))
  objid = int(objid)
  return (names[objid] or None) if 0 <= objid < len(names) else None


def nkey(m: Model) -> int:
  return int(_snapshot(m)["nkey"])


def reset_data_keyframe(m: Model, d: Data, key,
                        lanes: Optional[torch.Tensor] = None) -> Data:
  """``d`` with the lanes ``lanes`` (a (B,) bool mask; every lane when
  None) reset to model keyframe ``key`` (name or id).

  As ``mj_resetDataKeyframe``: the lane is reset as ``make_data`` resets
  it (``mj_resetData``), then takes time, qpos, qvel, act, ctrl and the
  mocap poses from the keyframe.  (The JAX package writes those fields
  and keeps the lane's other inputs.)  Derived fields are left as they
  were; the next ``forward`` or ``step`` computes them.
  """
  from mujoco_inversedynamicstest_tpu_torch.opt.derivative import INPUTS

  f = _snapshot(m)
  n = int(f["nkey"])
  if isinstance(key, str):
    k = name2id(m, "key", key)
    if k < 0:
      raise KeyError(f"no keyframe named {key!r}")
  else:
    k = int(key)
  if not 0 <= k < n:
    raise IndexError(f"keyframe {k} out of range [0, {n})")

  reset = io.make_data(m, d.batch, device=d.qpos.device, dtype=d.qpos.dtype)
  row = lambda name, shape: torch.as_tensor(
      np.asarray(f[name], np.float64)[k].reshape(shape),
      device=d.qpos.device).to(d.qpos.dtype).expand((d.batch,) + shape)
  reset = reset.replace(
      time=row("key_time", ()), qpos=row("key_qpos", (m.nq,)),
      qvel=row("key_qvel", (m.nv,)), act=row("key_act", (m.na,)),
      ctrl=row("key_ctrl", (m.nu,)),
      mocap_pos=row("key_mpos", (m.nmocap, 3)),
      mocap_quat=row("key_mquat", (m.nmocap, 4)))
  out = {}
  for name in INPUTS:
    new = getattr(reset, name).clone()
    if lanes is not None:
      old = getattr(d, name)
      new = torch.where(lanes.reshape((-1,) + (1,) * (old.ndim - 1)), new,
                        old)
    out[name] = new
  return d.replace(**out)


def _lane(x: torch.Tensor, index: int) -> np.ndarray:
  return x[index].detach().cpu().numpy().astype(np.float64)


def get_data(m: Model, d: Data, mjm, mjd=None, recompute: bool = True,
             index: int = 0):
  """Copies lane ``index`` of ``d`` into a ``mujoco.MjData`` of ``mjm``
  (the MjModel ``m`` was built from).

  With ``recompute=True`` (default) only the input state is copied and C's
  ``mj_forward`` recomputes every derived quantity, so the result is
  consistent for the reference viewer and renderer (and says nothing about
  the port's own derived fields).  With ``recompute=False`` the port's
  derived fields (frames, qacc, generalized forces, sensordata) are copied
  verbatim and no C forward runs.  Pass ``mjd`` to reuse its allocation.
  """
  import mujoco

  if mjd is None:
    mjd = mujoco.MjData(mjm)
  lane = lambda name: _lane(getattr(d, name), index)
  mjd.time = float(d.time[index])
  for name in ("qpos", "qvel", "qacc_warmstart", "qfrc_applied",
               "xfrc_applied"):
    getattr(mjd, name)[:] = lane(name)
  if m.na:
    mjd.act[:] = lane("act")
  if m.nu:
    mjd.ctrl[:] = lane("ctrl")
  if m.nmocap:
    mjd.mocap_pos[:] = lane("mocap_pos")
    mjd.mocap_quat[:] = lane("mocap_quat")

  if recompute:
    mujoco.mj_forward(mjm, mjd)
    return mjd

  # the port's derived quantities, verbatim
  ng = mjm.ngeom  # without the flex vertices' geoms appended past C's
  for name in ("xpos", "xquat", "xipos", "qacc", "qfrc_constraint",
               "qfrc_passive", "qfrc_actuator"):
    getattr(mjd, name)[:] = lane(name)
  for name in ("xmat", "ximat", "site_xmat"):
    getattr(mjd, name)[:] = lane(name).reshape(-1, 9)
  mjd.site_xpos[:] = lane("site_xpos")
  mjd.geom_xpos[:] = lane("geom_xpos")[:ng]
  mjd.geom_xmat[:] = lane("geom_xmat").reshape(-1, 9)[:ng]
  if mjd.sensordata.size:
    mjd.sensordata[:] = lane("sensordata")
  if m.flex is not None and mjm.nflexvert:
    mjd.flexvert_xpos[:] = lane("flexvert_xpos")
  return mjd


def get_data_batch(m: Model, batch: Data, index: int, mjm, mjd=None):
  """Lane ``index`` of a fleet ``Data`` as a ``mujoco.MjData``."""
  return get_data(m, batch, mjm, mjd=mjd, index=index)
