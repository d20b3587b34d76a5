"""The escape task's terrain heights, and the terrain_objects snapshot.

    python3 scripts/terrain_objects.py [out.npz]

dm_control's quadruped escape task (``dm_control/suite/quadruped.py``
:362-384) writes its height field at each episode's start: a sinusoidal
bowl times smooth random bumps (``scipy.ndimage.zoom``).  ``escape_heights``
is that recipe at a fixed seed; ``load_model`` compiles the port's
``assets/terrain_objects.xml`` and writes the heights into the
``MjModel``.  Run as a script, it writes the model's snapshot (by default
the package's ``assets/terrain_objects.npz``).  Needs ``mujoco`` and no
card.  Import it with ``scripts/`` on ``sys.path``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy import ndimage

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 0
_TERRAIN_SMOOTHNESS = 0.15   # quadruped.py's constants
_TERRAIN_BUMP_SCALE = 2


def escape_heights(res: int, size0: float, seed: int = SEED) -> np.ndarray:
  """The escape task's (res, res) heights for a field of half-width
  ``size0``, with ``numpy.random.RandomState(seed)`` as the task's
  random state."""
  random = np.random.RandomState(seed)
  row_grid, col_grid = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
  radius = np.clip(np.sqrt(col_grid ** 2 + row_grid ** 2), .04, 1)
  bowl_shape = .5 - np.cos(2 * np.pi * radius) / 2
  terrain_size = 2 * size0
  bump_res = int(terrain_size / _TERRAIN_BUMP_SCALE)
  bumps = random.uniform(_TERRAIN_SMOOTHNESS, 1, (bump_res, bump_res))
  smooth_bumps = ndimage.zoom(bumps, res / float(bump_res))
  return bowl_shape * smooth_bumps


def set_escape_heights(mjm, seed: int = SEED) -> None:
  """Writes ``escape_heights`` into height field 0 of ``mjm``."""
  res = int(mjm.hfield_nrow[0])
  assert res == int(mjm.hfield_ncol[0])
  adr = int(mjm.hfield_adr[0])
  mjm.hfield_data[adr:adr + res * res] = escape_heights(
      res, float(mjm.hfield_size[0, 0]), seed).ravel()


def load_model(seed: int = SEED):
  """``assets/terrain_objects.xml`` compiled, with the escape heights."""
  import mujoco

  import mujoco_inversedynamicstest_tpu_torch as mt

  mjm = mujoco.MjModel.from_xml_path(
      str(mt.asset_path("terrain_objects.xml")))
  set_escape_heights(mjm, seed)
  return mjm


def main(argv) -> None:
  import mujoco_inversedynamicstest_tpu_torch as mt

  out = argv[1] if len(argv) > 1 else mt.asset_path("terrain_objects.npz")
  mt.save_model_snapshot(load_model(), out)
  print("wrote", out)


if __name__ == "__main__":
  main(sys.argv)
