"""50-step trajectories of small models under the PyTorch port's RK4,
IMPLICIT and IMPLICITFAST integrators against C ``mj_step``, lane by lane
at every step: qpos within 1e-8, qvel within 1e-7 (the tolerances of
``tests/test_forward.py``).  The models are those of ``tests/models.py``
that the port's ``put_model`` accepts: a damped pendulum, a chain with
hinge, slide and ball joints and springs, and a free body with a hinge.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import numpy as np
import pytest

import mujoco_inversedynamicstest_tpu_torch as mt

from models import FREEBODY_NOCON, NLINK_NOCON, PENDULUM

SMALL = {"pendulum": PENDULUM, "nlink": NLINK_NOCON,
         "freebody": FREEBODY_NOCON}


@pytest.mark.parametrize("integrator", ["RK4", "IMPLICIT", "IMPLICITFAST"])
@pytest.mark.parametrize("name", list(SMALL))
def test_small_model_trajectories_match_c(name, integrator):
  """50 steps of three seeded lanes against C mj_step, every step."""
  mjm = mujoco.MjModel.from_xml_string(SMALL[name])
  mjm.opt.integrator = getattr(mujoco.mjtIntegrator, f"mjINT_{integrator}")
  mp = mt.put_model(mjm, device="cpu")
  rng = np.random.RandomState(5)
  qpos = mjm.qpos0 + 0.1 * rng.randn(3, mjm.nq)
  for q in qpos:
    mujoco.mj_normalizeQuat(mjm, q)
  fields = dict(qpos=qpos, qvel=0.2 * rng.randn(3, mjm.nv))
  d = mt.from_jax_arrays(mp, fields)
  mjds = [mujoco.MjData(mjm) for _ in range(3)]
  for mjd, q, v in zip(mjds, fields["qpos"], fields["qvel"]):
    mjd.qpos[:], mjd.qvel[:] = q, v
  for i in range(50):
    d = mt.step(mp, d)
    for lane, mjd in enumerate(mjds):
      mujoco.mj_step(mjm, mjd)
      np.testing.assert_allclose(d.qpos[lane].numpy(), mjd.qpos, rtol=0,
                                 atol=1e-8, err_msg=f"step {i} lane {lane}")
      np.testing.assert_allclose(d.qvel[lane].numpy(), mjd.qvel, rtol=0,
                                 atol=1e-7, err_msg=f"step {i} lane {lane}")
