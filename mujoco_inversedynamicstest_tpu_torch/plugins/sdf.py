"""Analytic SDF plugin geoms (port of
the JAX package's ``plugins/sdf.py``, C's
``plugin/sdf/{torus,bowl,nut,bolt,gear}.cc``).

Each shape is a signed distance ``sdf(x)`` in the geom's own frame over
points (..., 3), its value and gradient ``sdf_and_grad(x)``, and the
static box ``aabb()`` (centre, half sizes) that the collider seeds its
descent in (``ops/collision_sdf.py::make_plugin_narrowphase``).  The
JAX package takes ``jax.grad`` of the distance (C writes each gradient by
hand).  The torus's and the bowl's are written out here, as C's are, so
that the collider's descent costs no backward pass; the bolt's, the nut's
and the gear's are ``torch.func.grad`` of the distance (``value_and_grad``).
Either follows ``jax.grad``'s rules at the kinks: ``abs`` has slope +1 at
0, and ``maximum``, ``minimum`` and ``jnp.clip`` (a maximum, then a
minimum) split a tie's gradient in half, as ``torch.maximum`` and
``torch.minimum`` do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import func

from mujoco_inversedynamicstest_tpu_torch.plugins import registry

_SQRT12 = float(np.sqrt(2.0) / 2.0)
_SCREW = 12.0


def _fract(x):
  return x - torch.floor(x)


def _clip(x, lo, hi):
  """``jnp.clip``: the maximum with ``lo``, then the minimum with ``hi``."""
  return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                                        device=x.device)),
                       torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def _max0(x):
  return torch.maximum(x, torch.zeros_like(x))


def _union(a, b):
  return torch.minimum(a, b)


def _intersection(a, b):
  return torch.maximum(a, b)


def _subtraction(a, b):
  return torch.maximum(a, -b)


def _norm2(x, y):
  return torch.sqrt(x * x + y * y + 1e-30)


def value_and_grad(fn, x: torch.Tensor):
  """(fn(x), ∇fn(x)) of a pointwise function at points (..., 3), each
  point's own gradient (``torch.func`` of the sum)."""
  g, (_, v) = func.grad_and_value(lambda p: (lambda v: (v.sum(), v))(fn(p)),
                                  has_aux=True)(x)
  return v, g


def abs_slope(x):
  """d|x|/dx as ``jax.grad`` takes it: +1 at 0."""
  return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class SdfGeomInstance(registry.PluginInstance):
  """Base of the analytic shapes: ``attr`` (the declared attributes, with
  their defaults), ``sdf(x)`` and ``aabb()``."""

  defaults: tuple = ()
  attr_names: tuple = ()

  def __init__(self, f, instance: int, attrs):
    attrs = registry.require(attrs, self.attr_names, self.plugin)
    self.attr = np.array([float(attrs[n]) if attrs[n] else float(dflt)
                          for n, dflt in zip(self.attr_names, self.defaults)])

  @classmethod
  def with_attr(cls, attr) -> "SdfGeomInstance":
    """An instance of the given attribute values (no model)."""
    inst = cls.__new__(cls)
    inst.attr = np.asarray(attr, np.float64)
    inst.name = cls.plugin
    return inst

  def sdf(self, x):
    raise NotImplementedError

  def sdf_and_grad(self, x):
    """(distance, gradient) at local points (..., 3)."""
    return value_and_grad(self.sdf, x)

  def aabb(self):
    raise NotImplementedError


class TorusInstance(SdfGeomInstance):
  """``mujoco.sdf.torus`` (plugin/sdf/torus.cc:28-31)."""

  plugin = "mujoco.sdf.torus"
  attr_names = ("radius1", "radius2")
  defaults = (0.35, 0.15)

  def sdf(self, x):
    r1, r2 = (float(a) for a in self.attr)
    q = _norm2(x[..., 0], x[..., 1]) - r1
    return _norm2(q, x[..., 2]) - r2

  def sdf_and_grad(self, x):
    r1, r2 = (float(a) for a in self.attr)
    a = _norm2(x[..., 0], x[..., 1])
    q = a - r1
    b = _norm2(q, x[..., 2])
    k = q / b / a
    return b - r2, torch.stack([k * x[..., 0], k * x[..., 1],
                                x[..., 2] / b], dim=-1)

  def aabb(self):
    r1, r2 = self.attr
    return np.zeros(3), np.array([r1 + r2, r1 + r2, r2])


class BowlInstance(SdfGeomInstance):
  """``mujoco.sdf.bowl`` (plugin/sdf/bowl.cc:28-38): a cut hollow
  sphere."""

  plugin = "mujoco.sdf.bowl"
  attr_names = ("height", "radius", "thickness")
  defaults = (0.4, 1.0, 0.02)

  def sdf(self, x):
    height, radius, thick = (float(a) for a in self.attr)
    width = float(np.sqrt(max(radius * radius - height * height, 0.0)))
    q0, q1 = _norm2(x[..., 0], x[..., 1]), x[..., 2]
    d_rim = _norm2(q0 - width, q1 - height)
    d_shell = torch.abs(_norm2(q0, q1) - radius)
    return torch.where(height * q0 < width * q1, d_rim, d_shell) - thick

  def sdf_and_grad(self, x):
    height, radius, thick = (float(a) for a in self.attr)
    width = float(np.sqrt(max(radius * radius - height * height, 0.0)))
    q0, q1 = _norm2(x[..., 0], x[..., 1]), x[..., 2]
    d_rim = _norm2(q0 - width, q1 - height)
    n = _norm2(q0, q1)
    d_shell = torch.abs(n - radius)
    rim = height * q0 < width * q1
    s = abs_slope(n - radius) / n
    # d/d(q0, q1), then q0 = |(x0, x1)|
    g0 = torch.where(rim, (q0 - width) / d_rim, s * q0)
    g1 = torch.where(rim, (q1 - height) / d_rim, s * q1)
    return (torch.where(rim, d_rim, d_shell) - thick,
            torch.stack([g0 * x[..., 0] / q0, g0 * x[..., 1] / q0, g1],
                        dim=-1))

  def aabb(self):
    _, radius, thick = self.attr
    return np.zeros(3), np.full(3, radius + thick)


def _hex_head(x, radius):
  """The hexagonal head clipped by cones of the bolt and the nut
  (bolt.cc:48-61)."""
  k = 6.0 / np.pi / 2.0
  angle = -torch.floor(torch.atan2(x[..., 1], x[..., 0]) * k + 0.5) / k
  s0, s1 = torch.sin(angle), torch.sin(angle + np.pi * 0.5)
  px = s1 * x[..., 0] - s0 * x[..., 1]
  head = px - 0.5
  head = _intersection(head, torch.abs(x[..., 2] + 0.25) - 0.25)
  return _intersection(head, (x[..., 2] + radius - 0.22) * _SQRT12)


class BoltInstance(SdfGeomInstance):
  """``mujoco.sdf.bolt`` (plugin/sdf/bolt.cc:30-63): a threaded screw and
  a hex head."""

  plugin = "mujoco.sdf.bolt"
  attr_names = ("radius",)
  defaults = (0.26,)

  def sdf(self, x):
    r0 = float(self.attr[0])
    radius = _norm2(x[..., 0], x[..., 1]) - r0
    azimuth = torch.atan2(x[..., 1], x[..., 0])
    triangle = torch.abs(_fract(x[..., 2] * _SCREW - azimuth / np.pi / 2.0)
                         - 0.5)
    thread = (radius - triangle / _SCREW) * _SQRT12
    bolt = _subtraction(thread, 0.5 - torch.abs(x[..., 2] + 0.5))
    cone = (x[..., 2] - radius) * _SQRT12
    bolt = _subtraction(bolt, cone + 1.0 * _SQRT12)
    return _union(bolt, _hex_head(x, radius))

  def aabb(self):
    return np.zeros(3), np.array([0.6, 0.6, 1.0])


class NutInstance(SdfGeomInstance):
  """``mujoco.sdf.nut`` (plugin/sdf/nut.cc:30-63): the thread cut out of a
  hex head."""

  plugin = "mujoco.sdf.nut"
  attr_names = ("radius",)
  defaults = (0.26,)

  def sdf(self, x):
    r0 = float(self.attr[0])
    radius2 = _norm2(x[..., 0], x[..., 1]) - r0
    azimuth = torch.atan2(x[..., 1], x[..., 0])
    triangle = torch.abs(_fract(x[..., 2] * _SCREW - azimuth / np.pi / 2.0)
                         - 0.5)
    thread2 = (radius2 - triangle / _SCREW) * _SQRT12
    cone2 = (x[..., 2] - radius2) * _SQRT12
    hole = _subtraction(thread2, cone2 + 0.5 * _SQRT12)
    hole = _union(hole, -cone2 - 0.05 * _SQRT12)
    return _subtraction(_hex_head(x, radius2), hole)

  def aabb(self):
    return np.zeros(3), np.array([0.6, 0.6, 1.0])


class GearInstance(SdfGeomInstance):
  """``mujoco.sdf.gear`` (plugin/sdf/gear.cc:54-146): an extruded involute
  gear profile."""

  plugin = "mujoco.sdf.gear"
  attr_names = ("alpha", "diameter", "teeth", "thickness", "innerdiameter")
  defaults = (0.0, 2.8, 25.0, 0.2, -1.0)

  def sdf(self, x):
    alpha, D, N, thickness, innerD = (float(a) for a in self.attr)
    psi = 3.096e-5 * N * N - 6.557e-3 * N + 0.551  # pressure angle
    R = D / 2.0
    Pd = N / D
    P = np.pi / Pd
    a = 1.0 / Pd
    Ro = (D + 2.0 * a) / 2.0
    h = 2.2 / Pd
    innerR = float(innerD / 2.0 if innerD >= 0.0 else Ro - h - 0.14 * D)
    Rb = D * float(np.cos(psi)) / 2.0
    stride = P / R
    inv_alpha = float(np.arccos(np.clip(Rb / R, -1.0, 1.0)))
    inv_phi = float(np.tan(inv_alpha)) - inv_alpha
    shift = stride / 2.0 - 2.0 * inv_phi

    rho = _norm2(x[..., 0], x[..., 1])
    fi = torch.atan2(x[..., 1], x[..., 0]) + alpha
    mod = lambda v, y: v - y * torch.floor(v / y)
    fia = mod(fi + shift / 2.0, stride) - shift / 2.0
    fib = mod(-fi - shift + shift / 2.0, stride) - shift / 2.0

    # the involute tooth flanks
    safe_rho = torch.maximum(rho, torch.full_like(rho, Rb + 1e-12))
    acos_rb = torch.acos(_clip(Rb / safe_rho, -1.0, 1.0))
    ta = torch.sqrt(_max0(safe_rho * safe_rho - Rb * Rb))
    dista = torch.where(rho > Rb, ta - Rb * (fia + acos_rb), -1.0e6)
    distb = torch.where(rho > Rb, ta - Rb * (fib + acos_rb), -1.0e6)

    def smooth_union(p, q, k):
      hh = _clip(0.5 + 0.5 * (q - p) / k, 0.0, 1.0)
      return q * (1.0 - hh) + p * hh - k * hh * (1.0 - hh)

    def smooth_intersection(p, q, k):
      return _subtraction(_intersection(p, q), smooth_union(
          _subtraction(p, q), _subtraction(q, p), k))

    gear_outer = rho - Ro
    gear_low_base = rho - (Ro - h)
    crown_base = rho - innerR
    cogs = _intersection(dista, distb)
    base_walls = _intersection(fia - (stride - shift), fib - (stride - shift))
    cogs = _intersection(base_walls, cogs)
    cogs = smooth_intersection(gear_outer, cogs, 0.0035 * D)
    cogs = smooth_union(gear_low_base, cogs, Rb - Ro + h)
    cogs = _subtraction(cogs, crown_base)

    # C's early exits, as selects
    d2d = torch.where(innerR - rho > 0.0, innerR - rho,
                      torch.where(Ro - rho < -0.2, rho - Ro, cogs))

    # extrusion along z (gear.cc:45-49)
    w0, w1 = d2d, torch.abs(x[..., 2]) - thickness / 2.0
    outside = _norm2(_max0(w0), _max0(w1))
    inside = torch.maximum(w0, w1)
    return torch.minimum(inside, torch.zeros_like(inside)) + outside

  def aabb(self):
    _, D, _, thickness, _ = self.attr
    return np.zeros(3), np.array(
        [D / 2.0 * 1.25, D / 2.0 * 1.25, thickness / 2.0 * 1.1])


SHAPES = (TorusInstance, BowlInstance, BoltInstance, NutInstance,
          GearInstance)
for _cls in SHAPES:
  registry.register_plugin(_cls.plugin, _cls)
