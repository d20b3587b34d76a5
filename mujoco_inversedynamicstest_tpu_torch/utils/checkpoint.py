"""Checkpoint / resume for (Model, Data fleet, MPC carry) state.

Port of the JAX package's ``utils/checkpoint.py``.  One
checkpoint directory holds

* ``model.npz``: the snapshot arrays the model was built from
  (``Model.snapshot``, kept on the host by ``put_model``).  The JAX package
  writes C's binary model (``model.mjb``) instead; the card's machine has
  no ``mujoco`` to write or read one, and a snapshot rebuilds the same
  ``Model`` (``put_model``);
* ``model.json``: the model's dtype;
* ``state.npz``: every leaf of an arbitrary state (a ``Data`` fleet, an
  ``MPCCarry``, a dict of both, ...), keyed by its path as the JAX package
  keys it (``utils/tree.py``), saved verbatim: restore is bit-exact.

The state's structure is not saved: ``restore`` fills a template built the
way the run built it, and puts each leaf on the template leaf's device and
dtype, so a checkpoint written on the CPU restores onto the card.

Usage::

    checkpoint.save("ckpt/step100", m, {"carry": carry})
    m2 = checkpoint.load_model("ckpt/step100")
    state = checkpoint.restore("ckpt/step100", {"carry": make_carry(m2)})
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models import io
from mujoco_inversedynamicstest_tpu_torch.models.types import Model
from mujoco_inversedynamicstest_tpu_torch.utils import tree

_MODEL_FILE = "model.npz"
_META_FILE = "model.json"
_STATE_FILE = "state.npz"


def _host(leaf) -> np.ndarray:
  if isinstance(leaf, torch.Tensor):
    return leaf.detach().cpu().numpy()
  return np.asarray(leaf)


def save(path: str, m: Model, state: Any) -> None:
  """Writes a checkpoint directory: model.npz + model.json + state.npz.
  Tensors on the card are copied to the host; saving is synchronous."""
  if m.snapshot is None:
    raise ValueError("the model keeps no snapshot to save")
  os.makedirs(path, exist_ok=True)
  np.savez(os.path.join(path, _MODEL_FILE), **m.snapshot)
  with open(os.path.join(path, _META_FILE), "w") as f:
    json.dump({"dtype": str(m.dtype).removeprefix("torch."), "format": 1},
              f)
  arrays = {}
  for p, leaf in tree.leaves_with_path(state):
    key = tree.leaf_key(p)
    if key in arrays:
      raise ValueError(f"duplicate state leaf key {key!r}")
    arrays[key] = _host(leaf)
  np.savez(os.path.join(path, _STATE_FILE), **arrays)


def load_model(path: str, dtype=None, device="cuda",
               user_sensor_fn=None) -> Model:
  """Rebuilds the Model from a checkpoint's model.npz (on the card unless
  ``device`` says otherwise), in its saved dtype unless ``dtype`` is
  given.  A USER sensor's callback is code, not data: pass it again."""
  with open(os.path.join(path, _META_FILE)) as f:
    meta = json.load(f)
  if dtype is None:
    dtype = getattr(torch, meta["dtype"])
  return io.put_model(os.path.join(path, _MODEL_FILE), device=device,
                      dtype=dtype, user_sensor_fn=user_sensor_fn)


def restore(path: str, template: Any, strict: bool = True) -> Any:
  """Fills ``template``'s leaves with the checkpointed values, each on the
  template leaf's device and in its dtype.  With ``strict`` every template
  leaf must exist in the checkpoint with a matching shape."""
  with np.load(os.path.join(path, _STATE_FILE)) as z:
    saved = {k: z[k] for k in z.files}

  def fill(p, leaf):
    key = tree.leaf_key(p)
    if key not in saved:
      if strict:
        raise KeyError(f"checkpoint missing state leaf {key!r}")
      return leaf
    val = saved[key]
    if strict and tuple(val.shape) != tuple(np.shape(leaf)):
      raise ValueError(f"checkpoint leaf {key!r} shape {val.shape} != "
                       f"template {tuple(np.shape(leaf))}")
    if isinstance(leaf, torch.Tensor):
      return torch.as_tensor(val).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
      return val.astype(leaf.dtype)
    return type(leaf)(val)

  return tree.map_leaves(template, fill)
