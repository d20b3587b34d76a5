"""Mesh-SDF bridge plugin, ``mujoco.sdf.sdflib`` (port of
the JAX package's ``plugins/sdflib.py``).

C's plugin (``plugin/sdf/sdflib.cc``) builds an SdfLib octree from a
triangle mesh and serves its signed distances to the SDF collider.  Here,
as in the JAX package, the octree is a dense voxel grid built on the host
(``ops/meshsdf.py``) and sampled on the device by trilinear interpolation.

* Device side: ``SdfLibInstance`` samples the grid that the model's
  snapshot carries (``grid_arrays``, built when the snapshot is made from
  the compiled mesh moved by ``mesh_quat``/``mesh_pos``, as C does,
  sdflib.cc:81-87).
* Host compiler side: the ``mujoco`` wheel ships no SdfLib plugin, so a
  model naming it cannot compile.  ``host_compile_grid`` serves a
  pre-scanned grid of the referenced mesh (``prescan_xml``) to the
  compiler's marching-cubes pass through a ctypes ``mjpPlugin`` stub.
  C's plugin table is global to the process and another package may have
  registered a stub of the same name (the JAX package does): then this
  module puts its own callbacks into that entry for the compile and puts
  the owner's back after it.  Where no entry exists it registers its stub
  and, after the compile, renames the entry (``RETIRED``), so that
  whichever package compiles next finds the name free and registers its
  own.  ``models.io.load_model`` does all this for XML that names the
  plugin.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import meshsdf
from mujoco_inversedynamicstest_tpu_torch.plugins import registry

PLUGIN_NAME = "mujoco.sdf.sdflib"
# the name of an entry this module registered, after its compile
RETIRED = PLUGIN_NAME + " (retired)"


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def quat_mat_np(q) -> np.ndarray:
  """Rotation matrix of a unit quaternion (w, x, y, z), host float64."""
  w, x, y, z = np.asarray(q, np.float64)
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def instance_grid(f, instance: int) -> meshsdf.SdfGrid:
  """The voxel grid of an sdflib instance, from its geom's compiled mesh
  in the frame C builds its octree in: rotated by ``mesh_quat`` and moved
  by ``mesh_pos`` (sdflib.cc:81-87).  Host only."""
  geoms = np.nonzero(np.asarray(f["geom_plugin"]) == instance)[0]
  if not len(geoms):
    raise NotImplementedError(
        f"unsupported by the PyTorch port: sdflib instance {instance} "
        "attached to no geom")
  mid = int(f["geom_dataid"][geoms[0]])
  adr, num = int(f["mesh_vertadr"][mid]), int(f["mesh_vertnum"][mid])
  fadr, fnum = int(f["mesh_faceadr"][mid]), int(f["mesh_facenum"][mid])
  verts = np.asarray(f["mesh_vert"], np.float64).reshape(-1, 3)[adr:adr + num]
  faces = np.asarray(f["mesh_face"], np.int64).reshape(-1, 3)[fadr:fadr + fnum]
  rot = quat_mat_np(np.asarray(f["mesh_quat"]).reshape(-1, 4)[mid])
  verts = verts @ rot.T + np.asarray(f["mesh_pos"], np.float64).reshape(
      -1, 3)[mid]
  return meshsdf.mesh_sdf_grid(verts, faces)


def grid_arrays(f, names) -> dict:
  """The snapshot fields of every sdflib instance's grid: the values
  flattened one instance after another (``plugin_grid_values``), each
  instance's offset there (-1: not sdflib), its grid's shape, and its
  frame (lo, spacing, box centre, box half sizes)."""
  n = len(names)
  adr = np.full(n, -1, np.int64)
  shape = np.zeros((n, 3), np.int64)
  frame = np.zeros((n, 12))
  values = []
  for i, name in enumerate(names):
    if name != PLUGIN_NAME:
      continue
    g = instance_grid(f, i)
    adr[i] = sum(v.size for v in values)
    shape[i] = g.values.shape
    frame[i] = np.concatenate([g.lo, g.spacing, g.box_center, g.box_half])
    values.append(g.values.ravel())
  return {"plugin_grid_values": (np.concatenate(values) if values
                                 else np.zeros(0)),
          "plugin_grid_adr": adr, "plugin_grid_shape": shape,
          "plugin_grid_frame": frame}


class SdfLibInstance(registry.PluginInstance):
  """The voxel SDF of the geom's compiled mesh, from the snapshot."""

  def __init__(self, f, instance: int, attrs):
    adr = int(f["plugin_grid_adr"][instance])
    if adr < 0:
      raise NotImplementedError(
          f"unsupported by the PyTorch port: sdflib instance {instance} "
          "without its grid in the snapshot")
    self.shape = tuple(int(s) for s in f["plugin_grid_shape"][instance])
    size = int(np.prod(self.shape))
    self._values = np.asarray(f["plugin_grid_values"],
                              np.float64)[adr:adr + size]
    frame = np.asarray(f["plugin_grid_frame"], np.float64)[instance]
    self._lo, self._spacing = frame[0:3], frame[3:6]
    self._center, self._half = frame[6:9], frame[9:12]
    self._on = {}

  def _grid(self, x) -> tuple:
    """``sample_grid``'s grid arguments on the points' dtype and device,
    made once for each."""
    key = (x.dtype, str(x.device))
    if key not in self._on:
      t = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)
      self._on[key] = (t(self._values), self.shape, t(self._lo),
                       t(self._spacing), t(self._center), t(self._half))
    return self._on[key]

  def sdf(self, x):
    return meshsdf.sample_grid(*self._grid(x), x)

  def sdf_and_grad(self, x):
    return meshsdf.sample_grid_and_grad(*self._grid(x), x)

  def aabb(self):
    return self._center.copy(), self._half.copy()


registry.register_plugin(PLUGIN_NAME, SdfLibInstance)


# ---------------------------------------------------------------------------
# host compiler side: a ctypes stub against the wheel's mjplugin.h ABI
# ---------------------------------------------------------------------------

_mjtNum = ctypes.c_double
_NSTATE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int)
_NSENSOR = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
_INIT = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int)
_RESET = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.POINTER(_mjtNum), ctypes.c_void_p,
    ctypes.c_int)
_COMPUTE = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
_SDFDIST = ctypes.CFUNCTYPE(
    _mjtNum, ctypes.POINTER(_mjtNum), ctypes.c_void_p, ctypes.c_int)
_SDFGRAD = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(_mjtNum), ctypes.POINTER(_mjtNum),
    ctypes.c_void_p, ctypes.c_int)
_SDFSTATIC = ctypes.CFUNCTYPE(
    _mjtNum, ctypes.POINTER(_mjtNum), ctypes.POINTER(_mjtNum))
_SDFATTR = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(_mjtNum), ctypes.POINTER(ctypes.c_char_p),
    ctypes.POINTER(ctypes.c_char_p))
_SDFAABB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(_mjtNum), ctypes.POINTER(_mjtNum))

# the callbacks the compiler's SDF pass calls, in mjpPlugin's order
_SDF_FIELDS = ("sdf_distance", "sdf_gradient", "sdf_staticdistance",
               "sdf_attribute", "sdf_aabb")


class _MjpPlugin(ctypes.Structure):
  """mjpPlugin, field for field against the wheel's mjplugin.h."""

  _fields_ = [
      ("name", ctypes.c_char_p),
      ("nattribute", ctypes.c_int),
      ("attributes", ctypes.POINTER(ctypes.c_char_p)),
      ("capabilityflags", ctypes.c_int),
      ("needstage", ctypes.c_int),
      ("nstate", _NSTATE),
      ("nsensordata", _NSENSOR),
      ("init", _INIT),
      ("destroy", ctypes.c_void_p),
      ("copy", ctypes.c_void_p),
      ("reset", _RESET),
      ("compute", _COMPUTE),
      ("advance", ctypes.c_void_p),
      ("visualize", ctypes.c_void_p),
      ("actuator_act_dot", ctypes.c_void_p),
  ] + [(k, ctypes.c_void_p) for k in _SDF_FIELDS]


_MJPLUGIN_SDF = 1 << 3
# the grid served to the compiler (one sdflib mesh a compile)
_active_grid = None
_stub: Optional[_MjpPlugin] = None
_keepalive = []


class _HostGrid:
  """The served grid as Python floats: the compiler calls the distance
  once a point, and per-point numpy calls would cost it a minute a
  compile."""

  def __init__(self, grid: meshsdf.SdfGrid):
    self.values = grid.values.ravel().tolist()
    self.shape = tuple(int(n) for n in grid.values.shape)
    self.lo, self.spacing, self.center, self.half = (
        tuple(float(v) for v in a) for a in (
            grid.lo, grid.spacing, grid.box_center, grid.box_half))
    self.box = (self.center, self.half)

  def sample(self, p) -> float:
    """``meshsdf.sample_grid`` at one point (the JAX package's host
    sampler, in scalars, unrolled: a million calls a compile)."""
    (cx, cy, cz), (hx, hy, hz) = self.center, self.half
    (lx, ly, lz), (sx, sy, sz) = self.lo, self.spacing
    nx, ny, nz = self.shape
    rx, ry, rz = p[0] - cx, p[1] - cy, p[2] - cz
    qx, qy, qz = abs(rx) - hx, abs(ry) - hy, abs(rz) - hz
    excess = 0.0
    if qx > 0 or qy > 0 or qz > 0:
      mx, my, mz = max(qx, 0.0), max(qy, 0.0), max(qz, 0.0)
      excess = math.sqrt(mx * mx + my * my + mz * mz)
    ux = (cx + min(max(rx, -hx), hx) - lx) / sx
    uy = (cy + min(max(ry, -hy), hy) - ly) / sy
    uz = (cz + min(max(rz, -hz), hz) - lz) / sz
    ix = min(max(math.floor(ux), 0), nx - 2)
    iy = min(max(math.floor(uy), 0), ny - 2)
    iz = min(max(math.floor(uz), 0), nz - 2)
    fx, fy, fz = ux - ix, uy - iy, uz - iz
    v = self.values
    a = (ix * ny + iy) * nz + iz
    b = a + ny * nz
    gx = 1 - fx
    c00 = v[a] * gx + v[b] * fx
    c01 = v[a + 1] * gx + v[b + 1] * fx
    c10 = v[a + nz] * gx + v[b + nz] * fx
    c11 = v[a + nz + 1] * gx + v[b + nz + 1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz + excess


def _dist_at(pt) -> float:
  if _active_grid is None:
    return 1.0
  return _active_grid.sample((pt[0], pt[1], pt[2]))


def _grad(g, pt, d, i):
  eps = 1e-6
  d0 = _dist_at(pt)
  for k in range(3):
    pk = [pt[0], pt[1], pt[2]]
    pk[k] += eps
    g[k] = 0.0 if _active_grid is None else (
        _active_grid.sample(pk) - d0) / eps


def _aabb(aabb, at):
  if _active_grid is None:
    for k in range(6):
      aabb[k] = 0.5 if k >= 3 else 0.0
    return
  for k in range(3):
    aabb[k] = _active_grid.center[k]
    aabb[3 + k] = _active_grid.half[k]


def _attr(out, names, vals):
  out[0] = 0.0


def _make_stub() -> _MjpPlugin:
  """The stub plugin, its callbacks kept alive with it (made once)."""
  global _stub
  if _stub is not None:
    return _stub
  p = _MjpPlugin()
  ctypes.memset(ctypes.byref(p), 0, ctypes.sizeof(p))
  names = (ctypes.c_char_p * 1)(b"aabb")
  p.name = PLUGIN_NAME.encode()
  p.nattribute = 1
  p.attributes = names
  p.capabilityflags = _MJPLUGIN_SDF
  p.nstate = _NSTATE(lambda m, i: 0)
  p.nsensordata = _NSENSOR(lambda m, i, s: 0)
  p.init = _INIT(lambda m, d, i: 0)
  p.reset = _RESET(lambda m, st, pd, i: None)
  p.compute = _COMPUTE(lambda m, d, i, c: None)
  sdf = (_SDFDIST(lambda pt, d, i: _dist_at(pt)), _SDFGRAD(_grad),
         _SDFSTATIC(lambda pt, at: _dist_at(pt)), _SDFATTR(_attr),
         _SDFAABB(_aabb))
  for k, fn in zip(_SDF_FIELDS, sdf):
    setattr(p, k, ctypes.cast(fn, ctypes.c_void_p).value)
  _keepalive.extend([names, p.nstate, p.nsensordata, p.init, p.reset,
                     p.compute, *sdf])
  _stub = p
  return p


def _entry(lib):
  """C's table entry named ``mujoco.sdf.sdflib``, or None."""
  lib.mjp_pluginCount.restype = ctypes.c_int
  lib.mjp_getPluginAtSlot.restype = ctypes.POINTER(_MjpPlugin)
  lib.mjp_getPluginAtSlot.argtypes = [ctypes.c_int]
  for i in range(lib.mjp_pluginCount()):
    p = lib.mjp_getPluginAtSlot(i)
    if p and p.contents.name and p.contents.name.decode() == PLUGIN_NAME:
      return p
  return None


@contextlib.contextmanager
def host_compile_grid(grid: meshsdf.SdfGrid):
  """Serves ``grid`` to the host compiler's sdflib callbacks for the
  duration of the context (see the module's docstring)."""
  global _active_grid
  lib = registry.host_library()
  stub = _make_stub()
  entry = _entry(lib)
  retire = entry is None
  if retire:
    lib.mjp_registerPlugin.argtypes = [ctypes.POINTER(_MjpPlugin)]
    lib.mjp_registerPlugin.restype = ctypes.c_int
    lib.mjp_registerPlugin(ctypes.byref(stub))
    entry = _entry(lib)
  saved = [getattr(entry.contents, k) for k in _SDF_FIELDS]
  for k in _SDF_FIELDS:
    setattr(entry.contents, k, getattr(stub, k))
  prev, _active_grid = _active_grid, _HostGrid(grid)
  try:
    yield
  finally:
    _active_grid = prev
    for k, v in zip(_SDF_FIELDS, saved):
      setattr(entry.contents, k, v)
    if retire:
      name = ctypes.create_string_buffer(RETIRED.encode())
      _keepalive.append(name)
      ctypes.cast(entry, ctypes.POINTER(ctypes.c_void_p))[0] = (
          ctypes.addressof(name))


# ---------------------------------------------------------------------------
# the XML pre-scan (load_model)
# ---------------------------------------------------------------------------


def prescan_xml(xml_text: str, base_dir: str = ".") -> Optional[
    meshsdf.SdfGrid]:
  """The voxel grid of the mesh an sdflib instance is attached to in MJCF
  text, for the host compile; None where there is none."""
  try:
    root = ET.fromstring(xml_text)
  except ET.ParseError:
    return None
  instances = set()
  for pl in root.iter("plugin"):
    if pl.get("plugin") == PLUGIN_NAME:
      for inst in pl.iter("instance"):
        instances.add(inst.get("name"))
  if not instances:
    return None
  meshdir = "."
  comp = root.find("compiler")
  if comp is not None and comp.get("meshdir"):
    meshdir = comp.get("meshdir")
  targets = []
  for mesh in root.iter("mesh"):
    for pl in mesh.iter("plugin"):
      if pl.get("instance") in instances or pl.get("plugin") == PLUGIN_NAME:
        targets.append(mesh)
  if not targets:
    return None
  if len(targets) > 1:
    raise NotImplementedError(
        "unsupported by the PyTorch port: more than one sdflib mesh in a "
        "model (one compile grid)")
  mesh = targets[0]
  if mesh.get("vertex"):
    verts = np.array(mesh.get("vertex").split(), np.float64).reshape(-1, 3)
    from scipy.spatial import ConvexHull

    faces = ConvexHull(verts).simplices
    # qhull's winding is not outward: orient each face away from the centre
    cen = verts.mean(0)
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fc,fc->f", n, tri.mean(1) - cen) < 0
    faces[flip] = faces[flip][:, ::-1]
  elif mesh.get("file"):
    verts, faces = read_obj(os.path.join(base_dir, meshdir, mesh.get("file")))
  else:
    return None
  scale = np.array(mesh.get("scale", "1 1 1").split(), np.float64)
  return meshsdf.mesh_sdf_grid(verts * scale, faces)


def read_obj(path: str):
  """A minimal OBJ reader (v and f records; polygons fan-triangulated)."""
  verts, faces = [], []
  with open(path) as f:
    for line in f:
      parts = line.split()
      if not parts:
        continue
      if parts[0] == "v":
        verts.append([float(x) for x in parts[1:4]])
      elif parts[0] == "f":
        idx = [int(t.split("/")[0]) - 1 for t in parts[1:]]
        for k in range(1, len(idx) - 1):
          faces.append([idx[0], idx[k], idx[k + 1]])
  return np.asarray(verts, np.float64), np.asarray(faces, np.int64)
