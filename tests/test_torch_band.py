"""The port's band solvers (``opt/qp.py``) against the JAX package's and
dense numpy.

At the JAX test's (ntotal, nband) = (12, 1), (12, 3), (30, 5)
(``tests/test_opt.py::test_banded_cholesky``), plain and with ``diagadd``
and ``diagmul``: the packing, the factor, the solve and the expansion
within 1e-12 of the JAX functions, lane by lane of a batch of three; the
factor's product and the solve against dense numpy.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu import opt as jopt

LANES = 3


def banded_spd(rng, ntotal, nband):
  """The JAX test's matrices: a random SPD matrix cut to the band, its
  diagonal raised by ntotal."""
  a = rng.randn(ntotal, ntotal)
  dense = a @ a.T + ntotal * np.eye(ntotal)
  mask = np.abs(np.subtract.outer(range(ntotal), range(ntotal))) < nband
  return dense * mask + ntotal * np.eye(ntotal)


@pytest.mark.parametrize("diag", [(0.0, 0.0), (0.3, 0.1)])
@pytest.mark.parametrize("ntotal,nband", [(12, 1), (12, 3), (30, 5)])
def test_band_solvers_match_jax_and_dense(ntotal, nband, diag):
  rng = np.random.RandomState(2)
  dense = np.stack([banded_spd(rng, ntotal, nband) for _ in range(LANES)])
  b = rng.randn(LANES, ntotal)
  diagadd, diagmul = diag

  band = mt.opt.dense_to_band(torch.as_tensor(dense), nband)
  l_band = mt.opt.chol_factor_band(band, diagadd, diagmul)
  x = mt.opt.chol_solve_band(l_band, torch.as_tensor(b))
  l_dense = mt.opt.band_to_dense(l_band, lower_only=True).numpy()
  full = mt.opt.band_to_dense(band).numpy()

  factor = jax.jit(jopt.chol_factor_band, static_argnums=(1, 2))
  solve = jax.jit(jopt.chol_solve_band)
  for i in range(LANES):
    jband = jopt.dense_to_band(jnp.asarray(dense[i]), nband)
    jl = factor(jband, diagadd, diagmul)
    for got, ref in ((band[i], jband), (l_band[i], jl),
                     (x[i], solve(jl, jnp.asarray(b[i]))),
                     (l_dense[i], jopt.band_to_dense(jl, lower_only=True)),
                     (full[i], jopt.band_to_dense(jband))):
      np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                                 atol=1e-12)

  # dense numpy: L L' is the matrix with diag scaled and shifted
  want = dense.copy()
  idx = np.arange(ntotal)
  want[:, idx, idx] = want[:, idx, idx] * (1 + diagmul) + diagadd
  np.testing.assert_allclose(l_dense @ l_dense.transpose(0, 2, 1), want,
                             rtol=0, atol=1e-9)
  np.testing.assert_allclose(full, dense, rtol=0, atol=0)
  np.testing.assert_allclose(x.numpy(), np.linalg.solve(want, b[..., None])[..., 0], rtol=0,
                             atol=1e-8)


def test_out_of_range_rows_and_floor():
  """A non-positive pivot is floored at sqrt(1e-30), as the JAX scan
  floors it, and the rows before the start read as zero entries with a
  unit diagonal (a first row of [0, 0, a] factors to sqrt(a))."""
  band = torch.zeros(1, 3, 3, dtype=torch.float64)
  band[0, :, -1] = torch.tensor([4.0, -1.0, 9.0])
  l_band = mt.opt.chol_factor_band(band)
  jl = jopt.chol_factor_band(jnp.asarray(band[0].numpy()))
  np.testing.assert_array_equal(l_band[0].numpy(), np.asarray(jl))
  assert float(l_band[0, 1, -1]) == np.sqrt(1e-30)
  assert float(l_band[0, 0, -1]) == 2.0
