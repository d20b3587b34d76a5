"""Stored results of the JAX package for the port's tests.

The port's tests hold it to the JAX package, and most of their time is
tracing and compiling the JAX side, which does not change from run to run.
``result(name, parts, compute)`` returns the arrays ``compute()`` gives
(the JAX package's result, as numpy arrays), read from
``tests/jax_results/<name>.npz`` where the key stored there is this run's,
and computed otherwise.  The key is a hash of everything the result
depends on: JAX's, jaxlib's and mujoco's versions, every source file of
the JAX package, the source of ``compute``, and ``parts`` (the model, the
problem's inputs and settings).  So a change to any of them runs the JAX
side again.  With ``JAX_REFERENCE_WRITE=1`` set, a result computed is also
written.

    python3 tests/jax_reference.py

rewrites every stored result (it runs the tests that read them with the
variable set, and ``tests/arm_reach_reference.py``).
"""

from __future__ import annotations

import hashlib
import inspect
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
STORE = HERE / "jax_results"
# the test files that read stored results
READERS = (
    "test_torch_integrators_rk4.py", "test_torch_opt.py",
    "test_torch_quadruped_rangefinder.py", "test_torch_integrators.py",
    "test_torch_sensor.py", "test_torch_ilqr.py", "test_torch_step.py",
    "test_torch_sensor_derivative_jax.py",
    "test_torch_integrators_inverse.py", "test_torch_hammock.py")


def model_bytes(mjm) -> bytes:
  """A compiled MjModel as C's binary model: what a result of it depends
  on, options included."""
  import mujoco

  buf = np.zeros(mujoco.mj_sizeModel(mjm), np.uint8)
  mujoco.mj_saveModel(mjm, None, buf)
  return buf.tobytes()


def key(parts: Iterable, files: Iterable[Path] = ()) -> str:
  """The hash of the versions, ``parts`` (strings, bytes or arrays, in
  order), every source file of the JAX package, and ``files``."""
  import jax
  import jaxlib
  import mujoco

  h = hashlib.sha256()
  for v in (jax.__version__, jaxlib.__version__, mujoco.__version__):
    h.update(v.encode())
  for p in parts:
    if isinstance(p, str):
      h.update(p.encode())
    elif isinstance(p, bytes):
      h.update(p)
    else:
      h.update(np.ascontiguousarray(p, np.float64).tobytes())
  package = REPO / "mujoco_inversedynamicstest_tpu"
  for path in sorted(package.rglob("*.py")):
    h.update(str(path.relative_to(REPO)).encode())
    h.update(path.read_bytes())
  for path in files:
    h.update(Path(path).read_bytes())
  return h.hexdigest()


def result(name: str, parts: Iterable, compute: Callable[[], dict]) -> dict:
  """``compute()``'s arrays: stored ones where their key is this run's,
  computed (and, with JAX_REFERENCE_WRITE=1, stored) otherwise."""
  want = key([inspect.getsource(compute), *parts])
  path = STORE / f"{name}.npz"
  if path.exists():
    with np.load(path) as z:
      if str(z["key"]) == want:
        return {k: z[k] for k in z.files if k != "key"}
  out = {k: np.asarray(v) for k, v in compute().items()}
  if os.environ.get("JAX_REFERENCE_WRITE") == "1":
    STORE.mkdir(exist_ok=True)
    np.savez_compressed(path, key=np.array(want), **out)
  return out


def main() -> None:
  env = dict(os.environ, JAX_REFERENCE_WRITE="1")
  subprocess.run([sys.executable, "-m", "pytest", "-q", "-p",
                  "no:cacheprovider", "-n", "4", "--dist", "loadfile",
                  *(str(HERE / f) for f in READERS)], cwd=REPO, env=env,
                 check=True)
  subprocess.run([sys.executable, str(HERE / "arm_reach_reference.py")],
                 cwd=REPO, check=True)


if __name__ == "__main__":
  main()
