"""Taxel-grid touch sensor plugin (port of
the JAX package's ``plugins/touch_grid.py``, C's
``mujoco.sensor.touch_grid``, ``plugin/sensor/touch_grid.cc:249-374``).

The contacts of the sensor site's weld body are read as 6-D forces in
their frames (``constraint.contact_forces_frame``), turned into the site's
frame, signed to act on the sensor's body and permuted to (normal,
tangent, tangent).  Each contact's position relative to the site maps to
spherical (azimuth, elevation) angles, the site frame looking down -z,
binned into a ``size[0] x size[1]`` grid whose edges span the field of
view, with an optional foveal deformation (``touch_grid.cc:108-135``).
``sensordata`` holds ``nchannel`` frames, channel-major.

One batch over lanes x contact slots: ``torch.searchsorted`` over the
host-built edges, and the taxels summed by a one-hot contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
from mujoco_inversedynamicstest_tpu_torch.plugins import registry


def _fovea(x: np.ndarray, gamma: float) -> np.ndarray:
  """Linear-quintic foveal deformation (touch_grid.cc:108)."""
  if not gamma:
    return x
  g = np.clip(gamma, 0.0, 1.0)
  return g * x ** 5 + (1 - g) * x


def bin_edges(size, fov, gamma):
  """(x_edges, y_edges) in radians (touch_grid.cc:118-135)."""
  xe = _fovea(np.linspace(-1.0, 1.0, size[0] + 1), gamma)
  ye = _fovea(np.linspace(-1.0, 1.0, size[1] + 1), gamma)
  return xe * fov[0] * np.pi / 180.0, ye * fov[1] * np.pi / 180.0


class TouchGridInstance(registry.PluginInstance):
  """The grid's static configuration and the sensor hook."""

  def __init__(self, f, instance: int, attrs):
    attrs = registry.require(attrs, ("nchannel", "size", "fov", "gamma"),
                             "mujoco.sensor.touch_grid")
    self.nchannel = int(float(attrs["nchannel"] or 1) or 1)
    if not 1 <= self.nchannel <= 6:
      raise NotImplementedError(
          "unsupported by the PyTorch port: touch_grid nchannel outside 1-6")
    self.size = [int(float(v)) for v in attrs["size"].split()]
    fov = [float(v) for v in attrs["fov"].split()]
    gamma = float(attrs["gamma"] or 0.0)
    if len(self.size) != 2 or len(fov) != 2:
      raise NotImplementedError(
          "unsupported by the PyTorch port: touch_grid size or fov that is "
          "not a 2-vector")
    self.x_edges, self.y_edges = bin_edges(self.size, fov, gamma)

  def contacts(self, m, d, sensor_id):
    """What the sensor reads of each contact slot, (B, ncon, ...): its
    channels (B, ncon, nchannel) in the site's frame on the sensor's body,
    its taxel, whether it counts (active, of the site's weld body, in the
    field of view) and its azimuth and elevation."""
    sx, sy = self.size
    site = int(m.sensor_objid[sensor_id])
    weldid = m.body_weldid
    parent_body = int(weldid[m.site_bodyid[site]])
    parent_weld = int(weldid[parent_body])
    con = d.contact
    body1, body2 = constraint.slot_bodies(m, con)
    weld = m.const(weldid)
    relevant = (weld[body1] == parent_weld) | (weld[body2] == parent_weld)
    active = con.dist < con.includemargin
    site_pos, site_mat = d.site_xpos[:, site], d.site_xmat[:, site]

    # the 6-D force in the contact frame -> world -> the site's frame (the
    # rows of con.frame are its axes)
    f6 = constraint.contact_forces_frame(m, d)              # (B, ncon, 6)
    ft = con.frame.transpose(-1, -2)
    fw = (ft @ f6[..., :3, None])[..., 0]
    tw = (ft @ f6[..., 3:, None])[..., 0]
    fs, ts = fw @ site_mat, tw @ site_mat                  # matᵀ v
    # forces point from the smaller body to the larger: flip where the
    # sensor's body is the smaller
    sign = torch.where(parent_body < torch.maximum(body1, body2), -1.0,
                       1.0).to(fs.dtype)[..., None]
    fs, ts = fs * sign, ts * sign
    chans = torch.stack([fs[..., 2], fs[..., 0], fs[..., 1], ts[..., 2],
                         ts[..., 0], ts[..., 1]], dim=-1)[..., :self.nchannel]

    # positions -> the site's frame -> spherical (touch_grid.cc:151-156)
    rel = (con.pos - site_pos[:, None]) @ site_mat
    x, y, z = rel.unbind(-1)
    az = torch.atan2(x, -z)
    el = torch.atan2(y, torch.sqrt(x * x + z * z))
    # C's LowerBound: the first edge not below; 0 or n_edges is outside
    xi = torch.searchsorted(m.const(self.x_edges), az.contiguous())
    yi = torch.searchsorted(m.const(self.y_edges), el.contiguous())
    in_fov = (xi > 0) & (xi < sx + 1) & (yi > 0) & (yi < sy + 1)
    taxel = (torch.clamp(yi - 1, 0, sy - 1) * sx
             + torch.clamp(xi - 1, 0, sx - 1))              # (B, ncon)
    return chans, taxel, relevant & active & in_fov, az, el

  def sensor(self, m, d, sensor_id):
    """(B, nchannel size[0] size[1]) taxel sums (the mjPLUGIN_SENSOR
    compute, touch_grid.cc:249)."""
    frame = self.size[0] * self.size[1]
    if collision.contact_layout(m).ncon == 0:
      return d.qpos.new_zeros((d.batch, self.nchannel * frame))
    chans, taxel, valid, _, _ = self.contacts(m, d, sensor_id)
    w = torch.where(valid[..., None], chans, 0.0)
    onehot = (taxel[..., None] == m.const(np.arange(frame))).to(w.dtype)
    return torch.einsum("bcf,bck->bkf", onehot, w).reshape(d.batch, -1)


registry.register_plugin("mujoco.sensor.touch_grid", TouchGridInstance)
