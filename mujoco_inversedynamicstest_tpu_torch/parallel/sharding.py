"""Fleet sharding over devices: one process, one fleet shard a device.

Port of the JAX package's ``parallel/sharding.py``.  The JAX
package ``shard_map``s the vmapped step over a device mesh from one
controller; its only cross-device traffic is the ``pmean`` of a scalar.
The counterpart here is the same single-controller program: the fleet is
split into one shard a device (``opt.derivative.select_lanes`` of the
fleet's lanes), each shard runs on its own device and its own CUDA stream,
and the scalar is gathered to the mesh's first device.  There is no
``torch.distributed`` process group: that needs a process a card.

A mesh may list one device more than once (several shards on one card, or
the CPU standing in for several devices, as the JAX tests' 8 virtual CPU
devices do).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from mujoco_inversedynamicstest_tpu_torch.models import io
from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.opt import derivative
from mujoco_inversedynamicstest_tpu_torch.utils import tree


class Mesh(NamedTuple):
  """A 1-D device mesh over the fleet axis."""
  devices: tuple        # torch.device a shard
  axis: str = "batch"

  @property
  def size(self) -> int:
    return len(self.devices)


class Sharded(NamedTuple):
  """A fleet split over a mesh: ``shards[i]`` lives on ``mesh.devices[i]``
  and holds the i-th equal run of lanes."""
  mesh: Mesh
  shards: tuple

  def gather(self, device=None):
    """The whole fleet on one device (the mesh's first by default)."""
    device = self.mesh.devices[0] if device is None else torch.device(device)
    flat = [list(tree.leaves_with_path(s)) for s in self.shards]
    leaves = iter(zip(*flat))

    def cat(path, leaf):
      parts = next(leaves)
      return torch.cat([p.to(device) for _, p in parts])

    return tree.map_leaves(self.shards[0], cat)


def make_mesh(devices: Optional[Sequence] = None,
              axis: str = "batch") -> Mesh:
  """A 1-D mesh over ``devices`` (default: every card present, or the CPU
  without one)."""
  if devices is None:
    n = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(n)] if n else ["cpu"])
  return Mesh(tuple(torch.device(d) for d in devices), axis)


def _lanes(t) -> int:
  return next(leaf.shape[0] for _, leaf in tree.leaves_with_path(t)
              if isinstance(leaf, torch.Tensor) and leaf.ndim)


def shard_batch(mesh: Mesh, batch, axis: str = "batch") -> Sharded:
  """Splits a fleet into one equal shard a device of the mesh: a Data by
  ``derivative.select_lanes`` (its input fields), any other state (an
  ``MPCCarry``, a tensor) by slicing every tensor's leading dimension."""
  del axis
  n = _lanes(batch)
  if n % mesh.size:
    raise ValueError(f"{n} lanes do not split over {mesh.size} devices")
  k = n // mesh.size

  def shard(i, dev):
    if isinstance(batch, Data):
      return tree.map_leaves(
          derivative.select_lanes(batch, slice(i * k, (i + 1) * k)),
          lambda _, x: x.to(dev))
    return tree.map_leaves(batch, lambda _, x: (
        x[i * k:(i + 1) * k].to(dev) if isinstance(x, torch.Tensor)
        and x.ndim else x.to(dev) if isinstance(x, torch.Tensor) else x))

  return Sharded(mesh, tuple(shard(i, d) for i, d in enumerate(mesh.devices)))


def replicate(mesh: Mesh, obj) -> tuple:
  """One copy of ``obj`` a device of the mesh.  A ``Model`` is rebuilt
  from its snapshot on each other device (its device constants are made
  per model); any other state has its tensors copied."""
  copies = {}
  for dev in mesh.devices:
    if dev in copies:
      continue
    if isinstance(obj, Model):
      copies[dev] = obj if obj.device == dev else io.put_model(
          obj.snapshot, device=dev, dtype=obj.dtype,
          user_sensor_fn=obj.user_sensor_fn)
    else:
      copies[dev] = tree.map_leaves(obj, lambda _, x: x.to(dev) if isinstance(
          x, torch.Tensor) else x)
  return tuple(copies[dev] for dev in mesh.devices)


def _stream_context(dev: torch.device):
  """A side stream on a card that waits for the current stream's work;
  nothing on the CPU.  Returns (context, stream or None)."""
  if dev.type != "cuda":
    return contextlib.nullcontext(), None
  s = torch.cuda.Stream(device=dev)
  s.wait_stream(torch.cuda.current_stream(dev))
  return torch.cuda.stream(s), s


def run_sharded(mesh: Mesh, fn: Callable, batch: Sharded, *per_device):
  """``fn(*per_device_args, shard)`` on each shard on its device, each on a
  stream of its own; the current streams wait for all of them.  Returns
  the outputs, one a shard."""
  outs, streams = [], []
  for i, (dev, shard) in enumerate(zip(mesh.devices, batch.shards)):
    ctx, s = _stream_context(dev)
    with ctx:
      outs.append(fn(*(a[i] for a in per_device), shard))
    streams.append((dev, s))
  for dev, s in streams:
    if s is not None:
      torch.cuda.current_stream(dev).wait_stream(s)
  return outs


def pmean(mesh: Mesh, values: Sequence[torch.Tensor]) -> torch.Tensor:
  """The mean over shards of one scalar a shard, on the first device."""
  return torch.stack([v.to(mesh.devices[0]) for v in values]).mean()


def sharded_step_fn(m: Model, mesh: Mesh, step_fn: Callable,
                    axis: str = "batch") -> Callable:
  """A mesh-sharded fleet step: ``fn(sharded) -> (sharded, mean |qacc|)``.
  ``step_fn(m, d) -> d`` runs on each shard on its device; the mean of
  |qacc| over each shard is ``pmean``ed to the first device, the scalar
  reduction of the JAX package's sharded step."""
  del axis
  models = replicate(mesh, m)

  def fn(batch: Sharded):
    def one(mm, d_shard):
      d_out = step_fn(mm, d_shard)
      return d_out, torch.sum(torch.abs(d_out.qacc)) / d_out.qacc.numel()

    outs = run_sharded(mesh, one, batch, models)
    return (Sharded(mesh, tuple(o[0] for o in outs)),
            pmean(mesh, [o[1] for o in outs]))

  return fn


def weak_scaling_batch(m: Model, make_data_fn: Callable,
                       batch_per_device: int, mesh: Mesh,
                       axis: str = "batch") -> Sharded:
  """A sharded fleet of ``batch_per_device`` x the mesh's size lanes in
  the reset state; ``make_data_fn(m, batch)`` is ``make_data``'s
  signature."""
  return shard_batch(mesh, make_data_fn(m, batch_per_device * mesh.size),
                     axis)
