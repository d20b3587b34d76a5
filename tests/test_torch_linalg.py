"""The PyTorch port's Cholesky factor/solve (``ops/linalg.py`` of the port).

On the CPU the public wrappers take the plain torch versions, which are
checked here against the JAX package's Pallas kernels run in interpret mode
(built exactly as ``tests/test_linalg.py`` builds them), against numpy, and
against C MuJoCo's ``mju_cholFactor`` on a non-SPD input.  The CUDA kernels
themselves are checked against the plain versions by the ``gpu`` tests below
and by ``chip_smoke.py``; they skip without a card.
"""

import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_inversedynamicstest_tpu.ops import linalg as jlinalg
from mujoco_inversedynamicstest_tpu_torch.ops import linalg

REPO = Path(__file__).resolve().parent.parent


def _pallas_chol_interpret(hb):
  from jax.experimental import pallas as pl

  b, n, _ = hb.shape
  h_cm = hb.transpose(0, 2, 1).reshape(b, n * n).T
  out = pl.pallas_call(
      partial(jlinalg._chol_kernel, n),
      out_shape=jax.ShapeDtypeStruct((n * n, b), hb.dtype),
      grid=(b // jlinalg._LANES,),
      in_specs=[pl.BlockSpec((n * n, jlinalg._LANES), lambda i: (0, i))],
      out_specs=pl.BlockSpec((n * n, jlinalg._LANES), lambda i: (0, i)),
      interpret=True,
  )(h_cm)
  return out.T.reshape(b, n, n).transpose(0, 2, 1)


def _pallas_solve_interpret(lb, rhs):
  from jax.experimental import pallas as pl

  b, n, _ = lb.shape
  l_cm = lb.transpose(0, 2, 1).reshape(b, n * n).T
  lanes = jlinalg._LANES
  out = pl.pallas_call(
      partial(jlinalg._solve_kernel, n),
      out_shape=jax.ShapeDtypeStruct((n, b), rhs.dtype),
      grid=(b // lanes,),
      in_specs=[pl.BlockSpec((n * n, lanes), lambda i: (0, i)),
                pl.BlockSpec((n, lanes), lambda i: (0, i))],
      out_specs=pl.BlockSpec((n, lanes), lambda i: (0, i)),
      interpret=True,
  )(l_cm, rhs.T)
  return out.T


def _spd(rng, b, n):
  a = rng.randn(b, n, n)
  return np.einsum("bij,bkj->bik", a, a) + 3.0 * np.eye(n)


@pytest.mark.parametrize("n", [4, 27])
def test_plain_versions_match_pallas_kernels(n):
  rng = np.random.RandomState(0)
  h = _spd(rng, 128, n)
  rhs = rng.randn(128, n)
  l_ref = np.asarray(_pallas_chol_interpret(jnp.asarray(h)))
  x_ref = np.asarray(_pallas_solve_interpret(jnp.asarray(np.tril(l_ref)),
                                             jnp.asarray(rhs)))
  l = linalg.chol_factor(torch.as_tensor(h))
  x = linalg.chol_solve(l, torch.as_tensor(rhs))
  np.testing.assert_allclose(l.numpy(), np.tril(l_ref), rtol=0, atol=1e-10)
  assert np.all(np.triu(l.numpy(), 1) == 0)
  np.testing.assert_allclose(x.numpy(), x_ref, rtol=0, atol=1e-10)


def test_asymmetric_input_reads_lower_triangle():
  """An O(1e-3) upper-triangle asymmetry (the bf16 Newton-Hessian case that
  broke round 2) must factor like the symmetrized lower triangle."""
  rng = np.random.RandomState(1)
  n, b = 27, 128
  a = rng.randn(n, n)
  h = a @ a.T + 3.0 * np.eye(n)
  h_asym = h + 1e-3 * np.triu(rng.randn(n, n), k=1)
  l = linalg.chol_factor(torch.as_tensor(np.tile(h_asym, (b, 1, 1))))
  assert torch.isfinite(l).all()
  h_lower = np.tril(h_asym) + np.tril(h_asym, -1).T
  np.testing.assert_allclose(l[0].numpy(), np.linalg.cholesky(h_lower),
                             rtol=0, atol=1e-8)


@pytest.mark.parametrize("k", [1, 3])
def test_multi_column_rhs_matches_numpy(k):
  rng = np.random.RandomState(2)
  n, b = 11, 16
  h = _spd(rng, b, n)
  rhs = rng.randn(b, n, k)
  x = linalg.chol_solve(linalg.chol_factor(torch.as_tensor(h)),
                        torch.as_tensor(rhs))
  np.testing.assert_allclose(x.numpy(), np.linalg.solve(h, rhs), rtol=0,
                             atol=1e-10)


def test_non_spd_input_follows_mju_chol_factor():
  """One clamp everywhere: C's mju_cholFactor with mjMINVAL (the JAX
  package gives three answers here, ROADMAP queue 3); a fleet and a single
  matrix factor the same."""
  rng = np.random.RandomState(3)
  n = 9
  h = _spd(rng, 4, n)
  h[:, 4, 4] -= 50.0            # a negative pivot mid-way
  h[:, -1, -1] = -1.0           # and at the end
  ref = np.stack([np.tril(_mju_chol(hi)) for hi in h])
  batched = linalg.chol_factor(torch.as_tensor(h)).numpy()
  single = np.stack([linalg.chol_factor(torch.as_tensor(hi[None]))[0].numpy()
                     for hi in h])
  assert np.isfinite(batched).all()
  np.testing.assert_allclose(batched, ref, rtol=1e-12, atol=1e-12)
  np.testing.assert_array_equal(batched, single)


def _mju_chol(h):
  mat = np.ascontiguousarray(h, dtype=np.float64).copy()
  mujoco.mju_cholFactor(mat, 1e-15)
  return mat


def test_cpu_wrappers_take_the_plain_versions():
  rng = np.random.RandomState(4)
  h = torch.as_tensor(_spd(rng, 3, 5))
  rhs = torch.as_tensor(rng.randn(3, 5))
  before = (linalg.chol_factor.launches, linalg.chol_solve.launches)
  l = linalg.chol_factor(h)
  x = linalg.chol_solve(l, rhs)
  assert torch.equal(l, linalg.chol_factor_ref(h))
  assert torch.equal(x, linalg.chol_solve_ref(l, rhs))
  assert (linalg.chol_factor.launches, linalg.chol_solve.launches) == before
  with pytest.raises(RuntimeError, match="no Cholesky implementation"):
    linalg.chol_factor(torch.zeros(2, 3, 3, device="meta"))


def test_port_imports_without_jax():
  code = ("import sys; sys.modules['jax'] = None; "
          "import mujoco_inversedynamicstest_tpu_torch as mt; "
          "assert 'jax' not in {m.split('.')[0] for m in sys.modules "
          "if sys.modules[m] is not None}")
  subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                 timeout=120)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_geometry_fits_hopper(dtype):
  """Every n the kernels take gets at least one whole matrix per block, an
  odd tile stride (the 32 rows of a column in 32 banks), and no more
  shared memory than a Hopper block may use."""
  for n in range(1, linalg.N_MAX + 1):
    ld, per_block, smem = linalg.launch_geometry(n, dtype)
    assert ld % 2 == 1 and n <= ld <= n + 1
    assert len({r * ld % 32 for r in range(32)}) == 32
    assert 1 <= per_block <= linalg.MATS_PER_BLOCK
    assert smem == per_block * n * ld * dtype.itemsize <= 232_448
  # n = 128 in fp64: one 132 kB tile, above the 48 kB default
  assert linalg.launch_geometry(128, torch.float64) == (129, 1, 132_096)
  assert linalg.launch_geometry(27, torch.float32) == (27, 4, 4 * 2916)


@pytest.mark.parametrize("shape, match", [
    ((2, 3, 4), "expected"),
    ((3, 3), "expected"),
    ((2, 0, 0), "kernel takes"),
    ((2, 129, 129), "kernel takes"),
])
def test_factor_shape_checks_raise(shape, match):
  with pytest.raises(ValueError, match=match):
    linalg._check_factor_shape(torch.zeros(shape))


@pytest.mark.parametrize("rhs, match", [
    (torch.zeros(2, 5, dtype=torch.float32), "dtype"),
    (torch.zeros(2, 5, dtype=torch.float64, device="meta"), "device"),
    (torch.zeros(2, 4, dtype=torch.float64), "does not match"),
    (torch.zeros(3, 5, dtype=torch.float64), "does not match"),
    (torch.zeros(2, 5, 1, 1, dtype=torch.float64), "does not match"),
])
def test_solve_shape_checks_raise(rhs, match):
  l = torch.zeros(2, 5, 5, dtype=torch.float64)
  with pytest.raises(ValueError, match=match):
    linalg._check_solve_shapes(l, rhs)
  if rhs.device.type != "cpu":
    with pytest.raises(ValueError, match=match):
      linalg.chol_solve(l, rhs)


def test_solve_shapes_count_rhs_columns():
  l = torch.zeros(2, 5, 5)
  assert linalg._check_solve_shapes(l, torch.zeros(2, 5)) == (5, 1)
  assert linalg._check_solve_shapes(l, torch.zeros(2, 5, 3)) == (5, 3)


def test_kernels_take_float32_and_float64_only():
  assert (linalg._suffix(torch.float32), linalg._suffix(torch.float64)) == (
      "f32", "f64")
  for dtype in (torch.float16, torch.bfloat16, torch.int32):
    with pytest.raises(TypeError, match="float32 or float64"):
      linalg._suffix(dtype)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (chip_smoke.py runs these on the card)")
  return torch.device("cuda")


def _launches():
  return linalg.chol_factor.launches, linalg.chol_solve.launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 27, 32, 33, 128])
@pytest.mark.parametrize("b", [1, 4096])
def test_kernels_match_plain_versions_on_card(cuda, dtype, n, b):
  """Bit-equal to the plain versions, one launch per call; n = 32 and 33
  bound one row per lane, n = 128 fills four rows per lane and needs more
  than 48 kB of shared memory in fp64."""
  rng = np.random.RandomState(5)
  g = torch.as_tensor(rng.randn(b, n, n), device=cuda, dtype=dtype)
  h = g @ g.transpose(1, 2) + n * torch.eye(n, device=cuda, dtype=dtype)
  before = _launches()
  l = linalg.chol_factor(h)
  assert _launches() == (before[0] + 1, before[1])
  torch.testing.assert_close(l, linalg.chol_factor_ref(h), rtol=0, atol=0)
  for k in (1, 3):
    rhs = torch.as_tensor(rng.randn(b, n, k), device=cuda, dtype=dtype)
    if k == 1:
      rhs = rhs[..., 0]
    before = _launches()
    x = linalg.chol_solve(l, rhs)
    assert _launches() == (before[0], before[1] + 1)
    assert x.shape == rhs.shape
    torch.testing.assert_close(x, linalg.chol_solve_ref(l, rhs), rtol=0,
                               atol=0)

  # non-contiguous inputs: a transposed stack and a transposed rhs
  h_t = h.transpose(1, 2)
  torch.testing.assert_close(linalg.chol_factor(h_t),
                             linalg.chol_factor_ref(h_t), rtol=0, atol=0)
  rhs_t = torch.as_tensor(rng.randn(b, 3, n), device=cuda,
                          dtype=dtype).transpose(1, 2)
  torch.testing.assert_close(linalg.chol_solve(l, rhs_t),
                             linalg.chol_solve_ref(l, rhs_t), rtol=0, atol=0)
