"""The SDF plugin scenes' contacts: C MuJoCo's against the port's.

    python3 scripts/sdf_contact_probe.py

For the sphere on the torus and the ball in the bowl (``assets/sdf_*``)
at four states in contact each (``tests/test_torch_sdf_plugins.py``'s),
prints C's contacts after ``mj_forward`` (their count and the deepest
depth, under the scene's ``sdf_iterations`` and ``sdf_initpoints`` and
under (12, 12) and (20, 20)) beside the port's (fp64, CPU): the port, as the JAX package,
reports the depth f1 + f2 at the clearance minimum and keeps up to 4
distinct contacts from 12 fixed inits, whatever the two options; C
reports max(f1, f2) from ``sdf_initpoints`` inits.  Needs ``mujoco`` and
no card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> None:
  import mujoco

  import mujoco_inversedynamicstest_tpu_torch as mt

  from test_torch_sdf_plugins import _states

  for name in ("sdf_torus", "sdf_bowl"):
    path = str(mt.asset_path(f"{name}.xml"))
    mjm = mujoco.MjModel.from_xml_path(path)
    qpos = _states(name, mjm, np.random.RandomState(3))
    m = mt.put_model(mt.asset_path(f"{name}.npz"), device="cpu")
    d = mt.fwd_position(m, mt.make_data(m, len(qpos)).replace(
        qpos=torch.as_tensor(qpos)))
    print(f"{name}: sdf_iterations {mjm.opt.sdf_iterations}, "
          f"sdf_initpoints {mjm.opt.sdf_initpoints}")
    for k, q in enumerate(qpos):
      dist = d.contact.dist[k].numpy()
      ours = np.sort(dist[dist < d.contact.includemargin[k].numpy()])
      rows = []
      for iters, inits in ((mjm.opt.sdf_iterations, mjm.opt.sdf_initpoints),
                           (12, 12), (20, 20)):
        mjm.opt.sdf_iterations, mjm.opt.sdf_initpoints = iters, inits
        mjd = mujoco.MjData(mjm)
        mjd.qpos[:] = q
        mujoco.mj_forward(mjm, mjd)
        c = np.sort(np.array([mjd.contact[i].dist for i in range(mjd.ncon)]))
        rows.append(f"C ({iters}, {inits}) {mjd.ncon}, deepest "
                    f"{c.min():.5f}" if mjd.ncon else f"C ({iters}, "
                    f"{inits}) none")
      mjm = mujoco.MjModel.from_xml_path(path)
      print(f"  state {k}: contacts and the deepest depth: port "
            f"{len(ours)}, deepest {ours.min():.5f}; " + "; ".join(rows))


if __name__ == "__main__":
  main()
