"""C MuJoCo's IMPLICITFAST step of a spinning free body, against the port.

    python3 scripts/implicitfast_gyro_probe.py

One free box (size .1 .2 .3, contact and gravity off) spinning at
w = (0.3, 0.7, 1.0) rad/s with no damping.  Prints, for one IMPLICITFAST
step of C MuJoCo (``mj_step``) and of the port on the CPU in float64,
the rotational part of (qvel' - qvel) / h; then C's ``mj_forward`` qacc,
the same for RK4 and EULER, ``qDeriv`` after C's step, and what
(I - h/2 df/dw) a = f and (I - h df/dw) a = f give, f = -w x (I w),
beside the implicit midpoint rule I (w' - w) = h f((w + w') / 2), which
C follows.  Then 10 steps of the box and of a ball joint, each with an
off-centre inertia, gravity and an applied force as well: the largest
difference between C and the port in qpos and qvel.  Needs ``mujoco``
and no card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mujoco  # noqa: E402

import mujoco_inversedynamicstest_tpu_torch as mt  # noqa: E402

W = np.array([0.3, 0.7, 1.0])
BOX = """<mujoco><option gravity="0 0 0" integrator="{integrator}"/>
<worldbody><body pos="0 0 1"><freejoint/><geom type="box" size=".1 .2 .3"/>
</body></worldbody><option><flag contact="disable"/></option></mujoco>"""
HARD = """<mujoco><option integrator="implicitfast" timestep="0.01">
<flag contact="disable"/></option><worldbody>
<body pos="0 0 1" quat="0.8 0.2 -0.3 0.1">{joint}
<geom type="box" size=".1 .2 .3"/><inertial pos="0.1 -0.2 0.05"
 quat="0.9 0.1 0.3 -0.2" mass="2" diaginertia="0.1 0.2 0.3"/></body>
</worldbody></mujoco>"""


def rot_delta(integrator: str):
  """C's one step of the box: its model, (qvel' - qvel)[3:] / h, qDeriv,
  and mj_forward's qacc."""
  mjm = mujoco.MjModel.from_xml_string(BOX.format(integrator=integrator))
  d = mujoco.MjData(mjm)
  d.qvel[3:] = W
  mujoco.mj_forward(mjm, d)
  qacc = d.qacc[3:].copy()
  mujoco.mj_step(mjm, d)
  return mjm, (d.qvel[3:] - W) / mjm.opt.timestep, d.qDeriv.copy(), qacc


def main() -> None:
  np.set_printoptions(precision=10, suppress=True)
  mjm, c_delta, qderiv, qacc = rot_delta("implicitfast")
  h = mjm.opt.timestep
  m = mt.put_model(mjm, device="cpu")
  d = mt.make_data(m, 1)
  d = d.replace(qvel=torch.as_tensor(np.r_[0, 0, 0, W][None]))
  port = (mt.step(m, d).qvel[0, 3:].numpy() - W) / h
  print(f"box, h = {h}: IMPLICITFAST (qvel' - qvel)[3:] / h")
  print(f"  C MuJoCo {mujoco.__version__}: {c_delta}")
  print(f"  port:            {port}   (max diff "
        f"{np.abs(port - c_delta).max():.3e})")
  print(f"  mj_forward qacc: {qacc}")
  for integrator in ("RK4", "Euler"):
    print(f"  {integrator:6s}:         {rot_delta(integrator)[1]}")
  print(f"  qDeriv after C's step: {qderiv}")

  inertia = np.diag(mjm.body_inertia[1])
  skew = lambda v: np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                             [-v[1], v[0], 0]])
  f = -np.cross(W, inertia @ W)
  dfdw = -(skew(W) @ inertia - skew(inertia @ W))
  for name, k in (("(I - h/2 df/dw) a = f", 0.5), ("(I - h df/dw) a = f", 1)):
    a = np.linalg.solve(inertia - k * h * dfdw, f)
    print(f"  {name}: {a}   (max diff from C {np.abs(a - c_delta).max():.3e})")
  wm = W.copy()
  for _ in range(20):
    res = (2 / h) * inertia @ (wm - W) + np.cross(wm, inertia @ wm)
    jac = (2 / h) * inertia + skew(wm) @ inertia - skew(inertia @ wm)
    wm = wm - np.linalg.solve(jac, res)
  a = (2 * wm - 2 * W) / h
  print(f"  implicit midpoint: {a}   (max diff from C "
        f"{np.abs(a - c_delta).max():.3e})")

  for joint in ('<freejoint/>', '<joint type="ball"/>'):
    mjm = mujoco.MjModel.from_xml_string(HARD.format(joint=joint))
    dc = mujoco.MjData(mjm)
    dc.qvel[-3:] = W
    dc.qfrc_applied[:] = np.linspace(-0.5, 0.5, mjm.nv)
    m = mt.put_model(mjm, device="cpu")
    d = mt.put_data(m, dc)
    err = 0.0
    for _ in range(10):
      mujoco.mj_step(mjm, dc)
      d = mt.step(m, d)
      err = max(err, np.abs(d.qpos[0].numpy() - dc.qpos).max(),
                np.abs(d.qvel[0].numpy() - dc.qvel).max())
    print(f"{joint}: off-centre inertia, gravity, applied force, h = 0.01: "
          f"10 IMPLICITFAST steps, max |port - C| in qpos, qvel {err:.3e}")


if __name__ == "__main__":
  main()
