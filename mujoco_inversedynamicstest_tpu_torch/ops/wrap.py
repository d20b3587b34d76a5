"""Tendon wrapping geometry and the muscle curves, batched.

Port of ``mujoco_inversedynamicstest_tpu/ops/wrap.py`` (``mju_wrap``,
``wrap_circle``, ``wrap_inside``, ``mju_muscleGain``/``Bias``/``Dynamics``
and ``mju_sigmoid``).  Every function takes tensors of any leading shape
(a fleet of lanes, a group of wrap segments) and decides every branch of
the reference per element with ``torch.where``: nothing is read back to
the host, and nothing is written in place, so that ``torch.func.vmap``
over ``jvp`` runs through it.  ``wlen < 0`` marks "no wrap".
"""

from __future__ import annotations

import math as pymath

import torch

from mujoco_inversedynamicstest_tpu_torch.ops import math

_MINVAL = 1e-15


def _dot2(a, b):
  return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _norm(v):
  return torch.sqrt(torch.sum(v * v, dim=-1))


def _normalize(v):
  """v / |v|, and v unchanged where |v| < mjMINVAL; returns (unit, |v|)."""
  n = _norm(v)
  return v / torch.where(n < _MINVAL, 1.0, n)[..., None], n


def _cross2(a, b):
  """The z component of a x b for 2D vectors."""
  return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _is_intersect(p1, p2, p3, p4):
  """Whether the 2D segments (p1, p2) and (p3, p4) intersect."""
  det = ((p4[..., 1] - p3[..., 1]) * (p2[..., 0] - p1[..., 0])
         - (p4[..., 0] - p3[..., 0]) * (p2[..., 1] - p1[..., 1]))
  small = torch.abs(det) < _MINVAL
  safe = torch.where(small, 1.0, det)
  a = ((p4[..., 0] - p3[..., 0]) * (p1[..., 1] - p3[..., 1])
       - (p4[..., 1] - p3[..., 1]) * (p1[..., 0] - p3[..., 0])) / safe
  b = ((p2[..., 0] - p1[..., 0]) * (p1[..., 1] - p3[..., 1])
       - (p2[..., 1] - p1[..., 1]) * (p1[..., 0] - p3[..., 0])) / safe
  return ~small & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)


def _length_circle(p0, p1, ind, radius):
  """Arc length from p0 to p1 on the circle; ``ind`` picks the way round."""
  p0n, _ = _normalize(p0)
  p1n, _ = _normalize(p1)
  angle = torch.arccos(torch.clamp(_dot2(p0n, p1n), -1.0, 1.0))
  cross = p0[..., 1] * p1[..., 0] - p0[..., 0] * p1[..., 1]
  flip = ((cross > 0) & ind) | ((cross < 0) & ~ind)
  return radius * torch.where(flip, 2 * pymath.pi - angle, angle)


def wrap_circle(end0, end1, side, has_side, radius):
  """2D wrap around a circle at the origin (``wrap_circle``): (wlen, pnt0,
  pnt1), ``wlen < 0`` where the segment end0-end1 does not wrap.  ``side``
  is the side site's direction scaled to the circle (ignored where not
  ``has_side``)."""
  sqlen0 = _dot2(end0, end0)
  sqlen1 = _dot2(end1, end1)
  sqrad = radius * radius
  dif = end1 - end0
  dd = _dot2(dif, dif)
  a = torch.clamp(-_dot2(dif, end0) / torch.where(dd < _MINVAL, 1.0, dd),
                  0.0, 1.0)
  closest = a[..., None] * dif + end0
  no_wrap = ((sqlen0 < sqrad) | (sqlen1 < sqrad) | (radius < _MINVAL)
             | (dd < _MINVAL)
             | ((_dot2(closest, closest) > sqrad)
                & (~has_side | (_dot2(side, closest) >= 0))))

  sqrt0 = torch.sqrt(torch.clamp(sqlen0 - sqrad, min=0.0))
  sqrt1 = torch.sqrt(torch.clamp(sqlen1 - sqrad, min=0.0))
  safe0 = torch.where(sqlen0 < _MINVAL, 1.0, sqlen0)
  safe1 = torch.where(sqlen1 < _MINVAL, 1.0, sqlen1)

  def tangents(sgn):
    t0 = torch.stack([
        (end0[..., 0] * sqrad + sgn * radius * end0[..., 1] * sqrt0) / safe0,
        (end0[..., 1] * sqrad - sgn * radius * end0[..., 0] * sqrt0) / safe0,
    ], dim=-1)
    t1 = torch.stack([
        (end1[..., 0] * sqrad - sgn * radius * end1[..., 1] * sqrt1) / safe1,
        (end1[..., 1] * sqrad + sgn * radius * end1[..., 0] * sqrt1) / safe1,
    ], dim=-1)
    return t0, t1

  def goodness(t0, t1):
    mid, _ = _normalize(t0 + t1)
    dt = t0 - t1
    g = torch.where(has_side, _dot2(mid, side), -_dot2(dt, dt))
    return torch.where(_is_intersect(end0, t0, end1, t1), -10000.0, g)

  a0, a1 = tangents(1.0)
  b0, b1 = tangents(-1.0)
  pick0 = goodness(a0, a1) > goodness(b0, b1)
  p0 = torch.where(pick0[..., None], a0, b0)
  p1 = torch.where(pick0[..., None], a1, b1)
  no_wrap = no_wrap | _is_intersect(end0, p0, end1, p1)
  wlen = _length_circle(p0, p1, ~pick0, radius)
  return torch.where(no_wrap, -1.0, wlen), p0, p1


def wrap_inside(end0, end1, radius, maxiter: int = 20,
                z_init: float = 1.0 - 1e-7, tolerance: float = 1e-6):
  """2D wrap from inside the circle (``wrap_inside``): both tangent points
  are one point, (wlen, pnt, pnt) with wlen 0 or -1.  The Newton search of
  ``asin(A z) + asin(B z) - 2 asin(z) + G = 0`` runs the reference's
  ``maxiter - 1`` iterations that can still succeed, each element freezing
  where the reference's loop stops; where the search fails the point is
  the reference's default, the mean direction of the ends."""
  len0 = _norm(end0)
  len1 = _norm(end1)
  dif = end1 - end0
  dd = _dot2(dif, dif)
  no_wrap = ((len0 <= radius) | (len1 <= radius) | (radius < _MINVAL)
             | (len0 < _MINVAL) | (len1 < _MINVAL))
  a = -_dot2(dif, end0) / torch.where(dd < _MINVAL, 1.0, dd)
  closest = end0 + a[..., None] * dif
  no_wrap = no_wrap | ((dd > _MINVAL) & (a > 0) & (a < 1)
                       & (_norm(closest) <= radius))

  pdef, _ = _normalize(0.5 * (end0 + end1))
  pdef = pdef * radius[..., None]

  safe_l0 = torch.clamp(len0, min=_MINVAL)
  safe_l1 = torch.clamp(len1, min=_MINVAL)
  ca = radius / safe_l0
  cb = radius / safe_l1
  cos_g = (len0 * len0 + len1 * len1 - dd) / (2 * safe_l0 * safe_l1)
  # ends in opposite directions: no wrap; in the same direction: default
  no_wrap = no_wrap | (cos_g < -1 + _MINVAL)
  trivial = cos_g > 1 - _MINVAL
  g = torch.arccos(torch.clamp(cos_g, -1.0, 1.0))
  asin = lambda x: torch.arcsin(torch.clamp(x, -1.0, 1.0))

  def f(z):
    return asin(ca * z) + asin(cb * z) - 2 * asin(z) + g

  z = torch.full_like(len0, z_init)
  fz = f(z)
  failed = trivial | (fz > 0)
  done = ~failed & (torch.abs(fz) <= tolerance)
  inv = lambda x: 1.0 / torch.clamp(torch.sqrt(torch.clamp(x, min=0.0)),
                                    min=_MINVAL)
  for _ in range(maxiter - 1):
    live = ~done & ~failed
    df = (ca * inv(1 - z * z * ca * ca) + cb * inv(1 - z * z * cb * cb)
          - 2 * inv(1 - z * z))
    z1 = z - fz / torch.where(df > -_MINVAL, -1.0, df)
    bad = (df > -_MINVAL) | (z1 > z)
    fz1 = f(z1)
    bad = bad | (fz1 > tolerance)
    step = live & ~bad
    failed = failed | (live & bad)
    done = done | (step & (torch.abs(fz1) <= tolerance))
    z = torch.where(step, z1, z)
    fz = torch.where(step, fz1, fz)

  use0 = _cross2(end0, end1) > 0
  vec = torch.where(use0[..., None], end0, end1)
  ang = asin(z) - torch.where(use0, asin(ca * z), asin(cb * z))
  vecn, _ = _normalize(vec)
  c, s = torch.cos(ang), torch.sin(ang)
  pnt = radius[..., None] * torch.stack(
      [c * vecn[..., 0] - s * vecn[..., 1], s * vecn[..., 0] + c * vecn[..., 1]],
      dim=-1)
  pnt = torch.where(done[..., None], pnt, pdef)
  return torch.where(no_wrap, -1.0, 0.0).to(end0.dtype), pnt, pnt


def wrap(x0, x1, xpos, xmat, radius, side, has_side, is_sphere: bool):
  """Wrap of the segment x0-x1 around a sphere, or a cylinder along its
  local z (``mju_wrap``).  ``x0``, ``x1``, ``xpos``, ``side`` (..., 3),
  ``xmat`` (..., 3, 3), ``radius`` and the bool ``has_side`` (...,);
  ``is_sphere`` is static.  Returns (wlen, w0, w1): the arc length (-1: no
  wrap) and the two tangent points in the world frame."""
  p0 = math.mat_t_vec(xmat, x0 - xpos)
  p1 = math.mat_t_vec(xmat, x1 - xpos)
  too_close = (_norm(p0) < _MINVAL) | (_norm(p1) < _MINVAL)

  if is_sphere:
    axis0, _ = _normalize(p0)
    normal, nrm = _normalize(torch.cross(p0, p1, dim=-1))
    # p0, p1 parallel: the second axis is 1 off the largest component of
    # axis0 and 0 on it (the first such component on ties)
    aa = torch.abs(axis0)
    i1 = (aa[..., 1] > aa[..., 0]) & (aa[..., 1] > aa[..., 2])
    i2 = (aa[..., 2] > aa[..., 0]) & (aa[..., 2] > aa[..., 1])
    alt = torch.stack([(i1 | i2).to(p0.dtype), (~i1).to(p0.dtype),
                       (~i2).to(p0.dtype)], dim=-1)
    normal_alt, _ = _normalize(torch.cross(axis0, alt, dim=-1))
    normal = torch.where((nrm < _MINVAL)[..., None], normal_alt, normal)
    axis1, _ = _normalize(torch.cross(normal, axis0, dim=-1))
  else:
    axis0 = torch.cat([torch.ones_like(p0[..., :1]), p0[..., 1:] * 0], -1)
    axis1 = torch.cat([p0[..., :1] * 0, torch.ones_like(p0[..., :1]),
                       p0[..., 2:] * 0], -1)

  dot3 = lambda a, b: torch.sum(a * b, dim=-1)
  end0 = torch.stack([dot3(p0, axis0), dot3(p0, axis1)], dim=-1)
  end1 = torch.stack([dot3(p1, axis0), dot3(p1, axis1)], dim=-1)

  s3 = math.mat_t_vec(xmat, side - xpos)
  sd, _ = _normalize(torch.stack([dot3(s3, axis0), dot3(s3, axis1)], dim=-1))
  sd = sd * radius[..., None]

  inside = has_side & (_norm(s3) < radius)
  w_in, pi0, pi1 = wrap_inside(end0, end1, radius)
  w_out, po0, po1 = wrap_circle(end0, end1, torch.where(
      has_side[..., None], sd, 0.0), has_side, radius)
  wlen = torch.where(inside, w_in, w_out)
  pnt0 = torch.where(inside[..., None], pi0, po0)
  pnt1 = torch.where(inside[..., None], pi1, po1)

  res0 = axis0 * pnt0[..., :1] + axis1 * pnt0[..., 1:]
  res1 = axis0 * pnt1[..., :1] + axis1 * pnt1[..., 1:]
  if not is_sphere:
    # cylinder: the points' heights along the path, the arc lengthened by
    # the height it climbs
    l0 = torch.sqrt((p0[..., 0] - res0[..., 0]) ** 2
                    + (p0[..., 1] - res0[..., 1]) ** 2)
    l1 = torch.sqrt((p1[..., 0] - res1[..., 0]) ** 2
                    + (p1[..., 1] - res1[..., 1]) ** 2)
    arc = torch.clamp(wlen, min=0.0)
    total = torch.clamp(l0 + arc + l1, min=_MINVAL)
    z0 = p0[..., 2] + (p1[..., 2] - p0[..., 2]) * l0 / total
    z1 = p0[..., 2] + (p1[..., 2] - p0[..., 2]) * (l0 + arc) / total
    res0 = torch.cat([res0[..., :2], z0[..., None]], dim=-1)
    res1 = torch.cat([res1[..., :2], z1[..., None]], dim=-1)
    height = torch.abs(z1 - z0)
    wlen = torch.where(wlen >= 0, torch.sqrt(wlen * wlen + height * height),
                       wlen)

  xmat_t = xmat.transpose(-1, -2)
  w0 = math.mat_t_vec(xmat_t, res0) + xpos
  w1 = math.mat_t_vec(xmat_t, res1) + xpos
  return torch.where(too_close, -1.0, wlen), w0, w1


# ---------------------------------------------------------------------------
# muscles (mju_muscleGain, mju_muscleBias, mju_muscleDynamics)
# ---------------------------------------------------------------------------


def sigmoid(x):
  """Quintic smoothstep on [0, 1] (``mju_sigmoid``)."""
  y = x * x * x * (3 * x * (2 * x - 5) + 10)
  return torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, y))


def muscle_gain_length(length, lmin, lmax):
  """Normalized force-length curve, 1 at L = 1 (``mju_muscleGainLength``)."""
  a = 0.5 * (lmin + 1)
  b = 0.5 * (1 + lmax)
  q = lambda x: 0.5 * x * x
  x_low = (length - lmin) / torch.clamp(a - lmin, min=_MINVAL)
  x_mid1 = (1 - length) / torch.clamp(1 - a, min=_MINVAL)
  x_mid2 = (length - 1) / torch.clamp(b - 1, min=_MINVAL)
  x_high = (lmax - length) / torch.clamp(lmax - b, min=_MINVAL)
  fl = torch.where(length <= a, q(x_low), torch.where(
      length <= 1, 1 - q(x_mid1), torch.where(length <= b, 1 - q(x_mid2),
                                               q(x_high))))
  return torch.where((lmin <= length) & (length <= lmax), fl, 0.0)


def _scale(force, scale, acc0):
  """The peak force: prm[2], or scale / acc0 where prm[2] < 0."""
  return torch.where(force < 0, scale / torch.clamp(acc0, min=_MINVAL), force)


def _normalized(length, lengthrange, prm):
  """(L0, L): the optimal length and the length on the [range] scale."""
  l0 = (lengthrange[..., 1] - lengthrange[..., 0]) / torch.clamp(
      prm[..., 1] - prm[..., 0], min=_MINVAL)
  return l0, prm[..., 0] + (length - lengthrange[..., 0]) / torch.clamp(
      l0, min=_MINVAL)


def muscle_gain(length, vel, lengthrange, acc0, prm):
  """Active force-length-velocity gain, negative pulling
  (``mju_muscleGain``); ``prm`` is gainprm[:9]."""
  force = _scale(prm[..., 2], prm[..., 3], acc0)
  l0, big_l = _normalized(length, lengthrange, prm)
  v = vel / torch.clamp(l0 * prm[..., 6], min=_MINVAL)
  fl = muscle_gain_length(big_l, prm[..., 4], prm[..., 5])
  fvmax = prm[..., 8]
  y = fvmax - 1
  fv = torch.where(v <= -1, 0.0, torch.where(
      v <= 0, (v + 1) ** 2, torch.where(
          v <= y, fvmax - (y - v) ** 2 / torch.clamp(y, min=_MINVAL), fvmax)))
  return -force * fl * fv


def muscle_bias(length, lengthrange, acc0, prm):
  """Passive force, negative pulling (``mju_muscleBias``); ``prm`` is
  biasprm[:9]."""
  force = _scale(prm[..., 2], prm[..., 3], acc0)
  _, big_l = _normalized(length, lengthrange, prm)
  b = 0.5 * (1 + prm[..., 5])
  fpmax = prm[..., 7]
  x_mid = (big_l - 1) / torch.clamp(b - 1, min=_MINVAL)
  x_high = (big_l - b) / torch.clamp(b - 1, min=_MINVAL)
  return torch.where(big_l <= 1, 0.0, torch.where(
      big_l <= b, -force * fpmax * 0.5 * x_mid * x_mid,
      -force * fpmax * (0.5 + x_high)))


def muscle_dynamics(ctrl, act, prm):
  """Activation rate (``mju_muscleDynamics``): time constants that grow
  with the activation, switched by the sign of ctrl - act, smoothly over
  ``prm[2]`` (tausmooth) where it is positive."""
  ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
  actclamp = torch.clamp(act, 0.0, 1.0)
  tau_act = prm[..., 0] * (0.5 + 1.5 * actclamp)
  tau_deact = prm[..., 1] / (0.5 + 1.5 * actclamp)
  width = prm[..., 2]
  dctrl = ctrlclamp - act
  tau_smooth = tau_deact + (tau_act - tau_deact) * sigmoid(
      dctrl / torch.clamp(width, min=_MINVAL) + 0.5)
  tau_hard = torch.where(dctrl > 0, tau_act, tau_deact)
  tau = torch.where(width < _MINVAL, tau_hard, tau_smooth)
  return dctrl / torch.clamp(tau, min=_MINVAL)
