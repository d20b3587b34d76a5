"""The walk over nested state: dataclasses, NamedTuples, dicts, lists and
tuples down to tensors, numpy arrays and numbers.

The JAX package's state is a pytree and JAX walks it; the port's state is
dataclasses of tensors (``Data``, ``Contact``), NamedTuples (``MPCCarry``)
and containers of them.  A leaf's path is the field names, dict keys and
sequence indices that reach it, as JAX's ``tree_flatten_with_path`` gives
them (dict keys sorted; ``None`` is no leaf).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch

LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, int, float, bool)


def _is_dataclass(obj) -> bool:
  return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _children(obj) -> list:
  """(key, child) of a container, in JAX's order; [] for a leaf."""
  if _is_dataclass(obj):
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.init]
  if isinstance(obj, tuple) and hasattr(obj, "_fields"):
    return [(name, getattr(obj, name)) for name in obj._fields]
  if isinstance(obj, dict):
    return [(k, obj[k]) for k in sorted(obj)]
  if isinstance(obj, (list, tuple)):
    return list(enumerate(obj))
  return []


def leaves_with_path(obj: Any, path: tuple = ()) -> Iterator[tuple]:
  """(path, leaf) of every leaf under ``obj``, depth first."""
  if obj is None:
    return
  if isinstance(obj, LEAF_TYPES):
    yield path, obj
    return
  for key, child in _children(obj):
    yield from leaves_with_path(child, path + (key,))


def map_leaves(obj: Any, fn: Callable[[tuple, Any], Any],
               path: tuple = ()) -> Any:
  """``obj`` rebuilt with every leaf replaced by ``fn(path, leaf)``."""
  if obj is None:
    return None
  if isinstance(obj, LEAF_TYPES):
    return fn(path, obj)
  if _is_dataclass(obj):
    return dataclasses.replace(obj, **{
        k: map_leaves(v, fn, path + (k,)) for k, v in _children(obj)})
  if isinstance(obj, tuple) and hasattr(obj, "_fields"):
    return type(obj)(*(map_leaves(v, fn, path + (k,))
                       for k, v in _children(obj)))
  if isinstance(obj, dict):
    return {k: map_leaves(v, fn, path + (k,)) for k, v in _children(obj)}
  if isinstance(obj, (list, tuple)):
    return type(obj)(map_leaves(v, fn, path + (i,))
                     for i, v in enumerate(obj))
  return obj


def leaf_key(path: tuple) -> str:
  """The string key of a leaf's path ("." for the root itself)."""
  return "/".join(str(p) for p in path) or "."
