"""C MuJoCo's plane-mesh contacts against the port's, on the probe meshes.

    python3 scripts/plane_mesh_probe.py [POSES]

For each probe mesh (a cube, a hexagonal and a triangular prism, an
octagonal pyramid, the icosahedron of ``convex_mesh``, a 72-gon prism,
spheres sampled at 40 and 300 points) and POSES poses (default 90: a third
resting flat and yawed through 0-120 degrees, a third also tilted by small
angles, a third at random, 0.5 mm above to 60 mm into the plane, a third
with a margin of 0.01), runs C's ``mj_forward`` and the port's
``collision_convex.make_plane_mesh`` at the frames C computed, and prints,
per mesh, C's contact counts and how many poses the two agree on (every
contact's point and depth within 1e-9).  Needs ``mujoco`` and no card.
"""

from __future__ import annotations

import os
import sys

import mujoco
import numpy as np
import torch
from scipy.spatial.transform import Rotation

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mujoco_inversedynamicstest_tpu_torch as mt  # noqa: E402
from mujoco_inversedynamicstest_tpu_torch.ops import collision_convex  # noqa: E402


def _prism(n, r=0.1, h=0.1):
  a = 2 * np.pi * np.arange(n) / n
  bottom = np.c_[r * np.cos(a), r * np.sin(a), np.zeros(n)]
  return np.r_[bottom, bottom + [0, 0, h]]


def _sphere(n, r=0.1):
  i = np.arange(n) + 0.5
  phi, th = np.arccos(1 - 2 * i / n), np.pi * (1 + 5 ** 0.5) * i
  return r * np.c_[np.cos(th) * np.sin(phi), np.sin(th) * np.sin(phi),
                   np.cos(phi)]


def meshes() -> dict:
  a = 2 * np.pi * np.arange(8) / 8
  ico = mujoco.MjModel.from_xml_path(str(mt.asset_path("convex_mesh.xml")))
  adr, num = ico.mesh_vertadr[1], ico.mesh_vertnum[1]
  return {
      "cube": np.array([[x, y, z] for x in (-.1, .1) for y in (-.1, .1)
                        for z in (0, .2)]),
      "hexagonal prism": _prism(6),
      "triangular prism": _prism(3),
      "octagonal pyramid": np.r_[np.c_[0.1 * np.cos(a), 0.1 * np.sin(a),
                                       np.zeros(8)], [[0, 0, 0.1]]],
      "icosahedron": ico.mesh_vert[adr:adr + num].astype(np.float64),
      "72-gon prism": _prism(72),
      "sphere of 40 points": _sphere(40),
      "sphere of 300 points": _sphere(300),
  }


def model(vert, margin):
  v = " ".join(f"{x:.7f}" for x in vert.ravel())
  return mujoco.MjModel.from_xml_string(f"""
  <mujoco><asset><mesh name="m" vertex="{v}"/></asset><worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body><freejoint/><geom type="mesh" mesh="m" margin="{margin}"/></body>
  </worldbody></mujoco>""")


def main() -> None:
  poses = int(sys.argv[1]) if len(sys.argv) > 1 else 90
  rng = np.random.default_rng(0)
  total = agree = 0
  for name, vert in meshes().items():
    counts, same = {}, 0
    for k in range(poses):
      if k < poses // 3:
        rot = Rotation.from_euler("z", rng.uniform(0, 120), degrees=True)
      elif k < 2 * poses // 3:
        rot = Rotation.from_euler("zyx", [rng.uniform(0, 120),
                                          rng.normal(0, 1), rng.normal(0, 1)],
                                  degrees=True)
      else:
        rot = Rotation.random(random_state=rng)
      mjm = model(vert, 0.01 if k % 3 == 0 else 0.0)
      mjd = mujoco.MjData(mjm)
      mjd.qpos[3:7] = rot.as_quat()[[3, 0, 1, 2]]
      mujoco.mj_kinematics(mjm, mjd)
      world = (mjm.mesh_vert[:mjm.mesh_vertnum[0]]
               @ mjd.geom_xmat[1].reshape(3, 3).T + mjd.geom_xpos[1])
      mjd.qpos[2] = -world[:, 2].min() - rng.uniform(-0.0005, 0.06)
      mujoco.mj_forward(mjm, mjd)
      ref = sorted((c.dist, *c.pos) for c in mjd.contact)
      counts[len(ref)] = counts.get(len(ref), 0) + 1

      m = mt.put_model(mjm, device="cpu")
      fn = collision_convex.make_plane_mesh(m.mesh_graph[0],
                                            float(m.geom_rbound_np[1]))
      t = lambda x: torch.as_tensor(np.asarray(x, np.float64))[None]
      dist, pos, _, _ = fn(t(mjd.geom_xpos[0]), t(mjd.geom_xmat[0]).reshape(
          1, 3, 3), t(np.zeros(3)), t(mjd.geom_xpos[1]),
                           t(mjd.geom_xmat[1]).reshape(1, 3, 3),
                           t(np.zeros(3)), t(mjm.geom_margin[1]).reshape(1))
      ours = sorted((float(dist[0, i]), *pos[0, i].tolist())
                    for i in range(dist.shape[1]) if dist[0, i] < 1e9)
      same += len(ours) == len(ref) and all(
          np.abs(np.subtract(a, b)).max() <= 1e-9 for a, b in zip(ours, ref))
    total += poses
    agree += same
    print(f"{name}: C's contact counts {dict(sorted(counts.items()))}; "
          f"the port agrees at {same} of {poses} poses")
  print(f"all: {agree} of {total} poses")


if __name__ == "__main__":
  main()
