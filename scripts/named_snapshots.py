"""Writes the snapshots that carry names and keyframes.

    python3 scripts/named_snapshots.py

``assets/humanoid.npz`` (dm_control's humanoid, the model the port's tools
run on the card) and ``assets/keyframes.npz`` (an arm with a filtered
actuator, a free ball and a mocap target, and two named keyframes that set
every field a keyframe holds), each from its XML beside it, with
``save_model_snapshot(..., names=True)``: the physics fields as every
snapshot has them, and the names and keyframes ``models/interop.py`` reads
on a machine without ``mujoco``.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
NAMED = ("humanoid", "keyframes")


def main() -> None:
  import mujoco

  sys.path.insert(0, str(REPO))
  import mujoco_inversedynamicstest_tpu_torch as mt

  for name in NAMED:
    mjm = mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))
    mt.save_model_snapshot(mjm, mt.asset_path(f"{name}.npz"), names=True)
    print(f"wrote {mt.asset_path(f'{name}.npz')}: nkey {mjm.nkey}")


if __name__ == "__main__":
  main()
