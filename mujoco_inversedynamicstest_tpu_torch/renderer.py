"""Offscreen rendering: port state in, RGB/depth/segmentation out.

Port of the JAX package's ``renderer.py``, the analog of the
reference's ``python/mujoco/renderer.py``.  Rendering is a host/GL concern:
``Renderer`` copies a lane of the port's ``Data`` into a host ``MjData``
through ``models/interop.get_data`` (C recomputes the derived quantities)
and hands it to ``mujoco.Renderer``.  The port's ``Model`` keeps no
``MjModel``: pass the one it was built from.

Usage::

    r = Renderer(m, mjm, height=240, width=320)
    rgb = r.render(fleet, index=3)         # lane 3 of a fleet
    frames = r.render_batch(fleet)         # every lane -> (B, H, W, 3)
    depth = r.render(fleet, depth=True)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models import interop
from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model
from mujoco_inversedynamicstest_tpu_torch.utils import tree


def host_copy(d: Data) -> Data:
  """The whole fleet on the host: one device-to-host copy a field."""
  return tree.map_leaves(d, lambda _, x: x.detach().cpu() if isinstance(
      x, torch.Tensor) else x)


class Renderer:
  """Offscreen renderer over the host GL contexts (EGL/OSMesa/GLFW): owns
  one ``mujoco.Renderer`` and one scratch ``MjData``."""

  def __init__(self, m: Model, mjm, height: int = 240, width: int = 320,
               max_geom: int = 10000):
    import mujoco

    self._m = m
    self._src = mjm
    self._mjd = mujoco.MjData(mjm)
    self._renderer = mujoco.Renderer(mjm, height=height, width=width,
                                     max_geom=max_geom)

  @property
  def model(self):
    return self._src

  def render(self, d: Data, *, index: Optional[int] = None,
             camera=-1, depth: bool = False, segmentation: bool = False,
             scene_option=None) -> np.ndarray:
    """Renders lane ``index`` (default 0) of a fleet.

    Returns (H, W, 3) uint8 RGB by default; (H, W) float32 depth with
    ``depth=True``; (H, W, 2) int32 (objid, objtype) with
    ``segmentation=True``: the reference Renderer's three modes.
    """
    interop.get_data(self._m, d, self._src, mjd=self._mjd, recompute=True,
                     index=0 if index is None else index)
    if depth:
      self._renderer.enable_depth_rendering()
    elif segmentation:
      self._renderer.enable_segmentation_rendering()
    try:
      self._renderer.update_scene(self._mjd, camera=camera,
                                  scene_option=scene_option)
      return self._renderer.render()
    finally:
      if depth:
        self._renderer.disable_depth_rendering()
      elif segmentation:
        self._renderer.disable_segmentation_rendering()

  def render_batch(self, d: Data, *, camera=-1, depth: bool = False,
                   segmentation: bool = False, scene_option=None
                   ) -> np.ndarray:
    """Renders every lane of a fleet -> stacked pixels: one bulk copy of the
    fleet to the host, then one host render a lane."""
    host = host_copy(d)
    return np.stack([
        self.render(host, index=i, camera=camera, depth=depth,
                    segmentation=segmentation, scene_option=scene_option)
        for i in range(host.batch)])

  def close(self):
    self._renderer.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
