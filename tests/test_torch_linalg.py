"""The PyTorch port's Cholesky factor/solve (``ops/linalg.py`` of the port).

On the CPU the public wrappers take the plain torch versions, which are
checked here against the JAX package's Pallas kernels run in interpret mode
(built exactly as ``tests/test_linalg.py`` builds them), against numpy, and
against C MuJoCo's ``mju_cholFactor`` on a non-SPD input.  The CUDA kernels
themselves are checked against the plain versions by the ``gpu`` tests below
and by ``chip_smoke.py``; they skip without a card.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

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
    ((2, 2, 3, 3), "expected"),
])
def test_factor_shape_checks_raise(shape, match):
  with pytest.raises(ValueError, match=match):
    linalg._check_factor_shape(torch.zeros(shape))


@pytest.mark.parametrize("n", [129, 324, 512])
def test_factor_shape_check_takes_n_above_128(n):
  """Above N_MAX the block kernels take the matrix: nothing raises."""
  assert linalg._check_factor_shape(torch.zeros(2, n, n)) == n
  assert linalg._check_solve_shapes(torch.zeros(2, n, n),
                                    torch.zeros(2, n, 3)) == (n, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_large_launch_geometry_fits_hopper(dtype):
  """The n > 128 kernels: a block of LARGE_WARPS warps an item, within
  what a Hopper block may use, for every n in 129..512, the JVPs at 1, 3,
  75 and 669 tangents a lane.  The solves: a (matrix, column) or a (lane,
  tangent, column) a block, a few vectors of n in shared memory.  The
  factor and its JVP, panel-blocked: a matrix, or a group of tangents of
  one lane (a power of two up to min(T, warps)), a block, with a panel of
  LARGE_PANELS columns (L's and each tangent's for the JVP) of n | 1 rows
  and 32 more in shared memory; two blocks an SM up to n = 512.  Every n
  that the kernels' first form took (whose shared memory held 3 (factor)
  or 5 (JVP) vectors of n) is still taken, with a narrower panel."""
  size = dtype.itemsize

  def panels(nb, group):
    return group * (nb * (n | 1) + 32 + nb)

  for n in range(129, 513):
    for lanes in (1, 256):
      g = linalg.large_launch_geometry("chol_factor", n, dtype, lanes)
      assert g.panel in linalg.LARGE_PANELS and g.group == 1
      assert g == (lanes, 256, panels(g.panel, 1) * size, g.panel, 1)
      assert g.smem <= linalg.SMEM_HALF
      for cols in (1, 3):
        g = linalg.large_launch_geometry("chol_solve", n, dtype, lanes,
                                         cols=cols)
        assert g == (lanes * cols, 256, 2 * n * dtype.itemsize, 1, 1)
      for t in (1, 3, 75, 669):
        g = linalg.large_launch_geometry("chol_factor_jvp", n, dtype, lanes,
                                         t)
        assert g.panel in linalg.LARGE_PANELS
        assert g.group & (g.group - 1) == 0 and g.group <= min(t, 8)
        assert g == (lanes * -(-t // g.group), 256,
                     (g.panel * (n | 1) + 32 + panels(g.panel, g.group))
                     * size, g.panel, g.group)
        assert g.smem <= linalg.SMEM_HALF
        g = linalg.large_launch_geometry("chol_solve_jvp", n, dtype, lanes,
                                         t, 3)
        assert g == (lanes * t * 3, 256, 5 * n * dtype.itemsize, 1, 1)
        assert g.smem <= 232_448
  # the hammock's fleet factor, (256, 324) fp32, and its linearization, 4
  # lanes x 669 tangents at n = 324, fp64
  assert linalg.large_launch_geometry(
      "chol_factor", 324, torch.float32, 256) == (256, 256, 41_856, 32, 1)
  assert linalg.large_launch_geometry(
      "chol_factor_jvp", 324, torch.float64, 4, 669) == (2676, 256, 83_840,
                                                         16, 1)
  # every n the first form took, up to its limit, is taken: the panel
  # narrows instead (to nb = 1 at the largest)
  for kernel, vectors in (("chol_factor", 3), ("chol_factor_jvp", 5)):
    old = 232_448 // (vectors * size)
    for n in range(129, old + 1):
      g = linalg.large_launch_geometry(kernel, n, dtype, 1, 3)
      assert g.smem <= 232_448 and g.panel >= 1
    assert linalg.large_launch_geometry(kernel, old, dtype, 1).panel < 32
  # where even a panel of one column outgrows shared memory, the launch is
  # refused
  with pytest.raises(ValueError, match="shared memory"):
    linalg.large_launch_geometry("chol_factor", 232_448 // size, dtype, 1)
  with pytest.raises(ValueError, match="shared memory"):
    linalg.large_launch_geometry("chol_factor_jvp", 232_448 // (2 * size),
                                 dtype, 1)
  with pytest.raises(ValueError, match="shared memory"):
    linalg.large_launch_geometry("chol_solve_jvp", 6000, torch.float64, 1)


def _spd_np(rng, b, n):
  """SPD matrices, G Gᵀ + n I: no pivot near the clamp."""
  g = rng.randn(b, n, n)
  return g @ g.transpose(0, 2, 1) + n * np.eye(n)


@pytest.mark.parametrize("n", [129, 200, 324])
def test_plain_versions_above_128_match_jax_linalg(n):
  """Above n = 128 the JAX package's factor and solve are
  ``jnp.linalg.cholesky`` and ``cho_solve`` (its Pallas dispatch stops at
  128), differentiated by JAX; the plain versions, which the block
  kernels follow to the bit, agree with them and with their ``jax.jvp``
  to 1e-10 relative, fp64."""
  rng = np.random.RandomState(n)
  h = _spd_np(rng, 2, n)
  dh = rng.randn(2, n, n)
  dh = dh + dh.transpose(0, 2, 1)
  b, db = rng.randn(2, n), rng.randn(2, n)
  jfactor = jax.vmap(jlinalg.chol_factor)
  jsolve = jax.vmap(jlinalg.chol_solve)
  l_j, dl_j = jax.jvp(jfactor, (jnp.asarray(h),), (jnp.asarray(dh),))
  x_j, dx_j = jax.jvp(lambda a, c: jsolve(jfactor(a), c),
                      (jnp.asarray(h), jnp.asarray(b)),
                      (jnp.asarray(dh), jnp.asarray(db)))
  th = torch.as_tensor(h)
  l = linalg.chol_factor_ref(th)
  x = linalg.chol_solve_ref(l, torch.as_tensor(b))
  dl = linalg.chol_factor_jvp_ref(l, torch.as_tensor(dh))
  dx = linalg.chol_solve_jvp_ref(l, dl, x, torch.as_tensor(db))
  for got, ref in ((l, l_j), (x, x_j), (dl, dl_j), (dx, dx_j)):
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-10, err


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


# ---------------------------------------------------------------------------
# forward mode: the JVPs of the factor and the solve
# ---------------------------------------------------------------------------


def _sym(rng, b, n):
  g = rng.randn(b, n, n)
  return g + g.transpose(0, 2, 1)


@pytest.mark.parametrize("n", [1, 4, 27])
def test_factor_jvp_plain_matches_torch_and_jax(n):
  """chol_factor_jvp_ref against torch's forward mode through
  chol_factor_ref and against jax.jvp of the JAX package's chol_factor
  (LAPACK on the CPU), f64, 1e-10."""
  rng = np.random.RandomState(10 + n)
  h, dh = _spd(rng, 8, n), _sym(rng, 8, n)
  ht, dht = torch.as_tensor(h), torch.as_tensor(dh)
  got = linalg.chol_factor_jvp_ref(linalg.chol_factor_ref(ht), dht)
  _, ref = torch.func.jvp(linalg.chol_factor_ref, (ht,), (dht,))
  _, ref_jax = jax.jvp(jlinalg.chol_factor, (jnp.asarray(h),),
                       (jnp.asarray(dh),))
  np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-10)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref_jax), rtol=0,
                             atol=1e-10)
  assert np.all(np.triu(got.numpy(), 1) == 0)


@pytest.mark.parametrize("k", [None, 3])
def test_solve_jvp_plain_matches_torch_and_jax(k):
  """chol_solve_jvp_ref against torch's forward mode through
  chol_solve_ref and against jax.jvp of the JAX package's chol_solve, with
  tangents of both the factor and the right-hand side, f64, 1e-10."""
  rng = np.random.RandomState(20)
  n, b = 27, 8
  l = np.linalg.cholesky(_spd(rng, b, n))
  dl = np.tril(rng.randn(b, n, n))
  shape = (b, n) if k is None else (b, n, k)
  rhs, drhs = rng.randn(*shape), rng.randn(*shape)
  lt, dlt, bt, dbt = (torch.as_tensor(a) for a in (l, dl, rhs, drhs))
  x = linalg.chol_solve_ref(lt, bt)
  got = linalg.chol_solve_jvp_ref(lt, dlt, x, dbt)
  _, ref = torch.func.jvp(linalg.chol_solve_ref, (lt, bt), (dlt, dbt))
  _, ref_jax = jax.jvp(jax.vmap(jlinalg.chol_solve), (l, rhs), (dl, drhs))
  assert got.shape == bt.shape
  np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-10)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref_jax), rtol=0,
                             atol=1e-10)


def test_factor_jvp_at_clamped_pivots():
  """A clamped pivot passes no tangent: dL[k][k] = 0, and the column below
  it is the running tangent over sqrt(1e-15).  torch's clamp has the same
  derivative below the bound, so its forward mode agrees."""
  rng = np.random.RandomState(11)
  n = 9
  h = _spd(rng, 4, n)
  h[:, 4, 4] -= 50.0            # a negative pivot mid-way
  h[:, -1, -1] = -1.0           # and at the end
  dh = _sym(rng, 4, n)
  ht, dht = torch.as_tensor(h), torch.as_tensor(dh)
  l = linalg.chol_factor_ref(ht)
  assert torch.all(l[:, 4, 4] == np.sqrt(1e-15))
  got = linalg.chol_factor_jvp_ref(l, dht)
  assert torch.all(got[:, 4, 4] == 0) and torch.all(got[:, -1, -1] == 0)
  _, ref = torch.func.jvp(linalg.chol_factor_ref, (ht,), (dht,))
  torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)


def test_dual_inputs_give_dual_outputs():
  """chol_factor / chol_solve carry forward-mode tangents: a dual input
  gives a dual output whose tangent is the JVP (a missing tangent counts as
  zero), and no dual input is ever dropped."""
  import torch.autograd.forward_ad as fwAD

  rng = np.random.RandomState(12)
  n, b = 6, 5
  h, dh = torch.as_tensor(_spd(rng, b, n)), torch.as_tensor(_sym(rng, b, n))
  rhs, drhs = (torch.as_tensor(rng.randn(b, n)) for _ in range(2))
  l = linalg.chol_factor_ref(h)
  dl = linalg.chol_factor_jvp_ref(l, dh)
  x = linalg.chol_solve_ref(l, rhs)
  with fwAD.dual_level():
    ld = linalg.chol_factor(fwAD.make_dual(h, dh))
    primal, tangent = fwAD.unpack_dual(ld)
    assert torch.equal(primal, l) and torch.equal(tangent, dl)
    for l_in, b_in, dl_in, db_in in (
        (ld, fwAD.make_dual(rhs, drhs), dl, drhs),
        (ld, rhs, dl, torch.zeros_like(rhs)),
        (l, fwAD.make_dual(rhs, drhs), torch.zeros_like(l), drhs)):
      primal, tangent = fwAD.unpack_dual(linalg.chol_solve(l_in, b_in))
      assert torch.equal(primal, x)
      assert torch.equal(tangent, linalg.chol_solve_jvp_ref(l, dl_in, x,
                                                            db_in))
    assert fwAD.unpack_dual(linalg.chol_solve(l, rhs)).tangent is None


def test_cpu_jvp_wrappers_take_the_plain_versions():
  rng = np.random.RandomState(13)
  h, dh = torch.as_tensor(_spd(rng, 3, 5)), torch.as_tensor(_sym(rng, 3, 5))
  l = linalg.chol_factor_ref(h)
  x, db = (torch.as_tensor(rng.randn(3, 5)) for _ in range(2))
  before = (linalg.chol_factor_jvp.launches, linalg.chol_solve_jvp.launches)
  dl = linalg.chol_factor_jvp(l, dh)
  assert torch.equal(dl, linalg.chol_factor_jvp_ref(l, dh))
  assert torch.equal(linalg.chol_solve_jvp(l, dl, x, db),
                     linalg.chol_solve_jvp_ref(l, dl, x, db))
  assert (linalg.chol_factor_jvp.launches,
          linalg.chol_solve_jvp.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jvp_launch_geometry_fits_hopper(dtype):
  """A JVP block (each lane's packed factor, for the solve its x and y,
  and one or two packed tangent tiles a warp) fits a Hopper block for
  every n the kernels take and every tangent count, n = 128 in fp64
  included; the packed rows of 32 consecutive rows start in 32 different
  banks."""
  size = dtype.itemsize
  for n in range(1, linalg.N_MAX + 1):
    tile = n * (n + 1) // 2 * size
    for tangents in (1, 3, 75):
      for cols, tiles in ((0, True), (1, True), (3, True), (1, False)):
        g = linalg.jvp_launch_geometry(n, dtype, tangents, cols, tiles)
        assert 1 <= g.lanes <= linalg.MATS_PER_BLOCK
        assert 1 <= g.warps <= min(linalg.JVP_WARPS, g.lanes * tangents)
        assert g.buffers == (0 if not tiles else
                             2 if g.lanes * tangents > g.warps and g.buffers
                             == 2 else 1)
        assert g.smem == (g.lanes * (tile + 2 * n * cols * size)
                          + g.warps * g.buffers * tile) <= 232_448
  for r0 in (0, 32, 96):
    assert len({(r * (r + 1) // 2) % 32 for r in range(r0, r0 + 32)}) == 32
  # the single-tangent launch: four lanes a block, a warp each
  assert linalg.jvp_launch_geometry(27, torch.float32, 1) == (4, 4, 1, 12_096)
  if dtype == torch.float64:
    # n = 128: one lane, one warp; two tangent buffers when it has work
    assert linalg.jvp_launch_geometry(128, dtype, 1) == (1, 1, 1, 132_096)
    assert linalg.jvp_launch_geometry(128, dtype, 75) == (1, 1, 2, 198_144)
    # a right-hand side too wide for shared memory is refused
    with pytest.raises(ValueError, match="does not fit"):
      linalg.jvp_launch_geometry(128, dtype, 1, 64)
  else:
    # the bench chunk: 1.5 kB of L and 2 x 1.5 kB a warp, 8 warps
    assert linalg.jvp_launch_geometry(27, dtype, 75) == (1, 8, 2, 25_704)


@pytest.mark.parametrize("args, match", [
    ((torch.zeros(2, 5, 5), torch.zeros(2, 5, 4)), "tangent of the matrix"),
    ((torch.zeros(2, 5, 5), torch.zeros(2, 5, 5, dtype=torch.float64)),
     "tangent of the matrix"),
    ((torch.zeros(2, 5, 5), torch.zeros(1, 3, 2, 5, 5)),
     "tangent of the matrix"),
])
def test_jvp_shape_checks_raise(args, match):
  with pytest.raises(ValueError, match=match):
    linalg._check_tangent(args[0], args[1], match)
  assert linalg._check_tangent(args[0], args[0], match) == 0
  assert linalg._check_tangent(args[0], args[0].expand(3, 2, 5, 5),
                               match) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 27, 32, 33, 128])
@pytest.mark.parametrize("b", [1, 4096])
def test_jvp_kernels_match_plain_versions_on_card(cuda, dtype, n, b):
  """The JVP kernels are bit-equal to their plain versions, one launch a
  call, rhs (B, n) and (B, n, 3), asymmetric tangents and transposed
  (non-contiguous) inputs."""
  rng = np.random.RandomState(6)
  g = torch.as_tensor(rng.randn(b, n, n), device=cuda, dtype=dtype)
  h = g @ g.transpose(1, 2) + n * torch.eye(n, device=cuda, dtype=dtype)
  dh = torch.as_tensor(rng.randn(b, n, n), device=cuda, dtype=dtype)
  l = linalg.chol_factor_ref(h)
  before = linalg.chol_factor_jvp.launches
  dl = linalg.chol_factor_jvp(l, dh)
  assert linalg.chol_factor_jvp.launches == before + 1
  torch.testing.assert_close(dl, linalg.chol_factor_jvp_ref(l, dh), rtol=0,
                             atol=0)
  torch.testing.assert_close(linalg.chol_factor_jvp(l, dh.transpose(1, 2)),
                             linalg.chol_factor_jvp_ref(l, dh.transpose(1, 2)),
                             rtol=0, atol=0)
  for k in (1, 3):
    x, db = (torch.as_tensor(rng.randn(b, n, k), device=cuda, dtype=dtype)
             for _ in range(2))
    if k == 1:
      x, db = x[..., 0], db[..., 0]
    before = linalg.chol_solve_jvp.launches
    dx = linalg.chol_solve_jvp(l, dl, x, db)
    assert linalg.chol_solve_jvp.launches == before + 1
    assert dx.shape == x.shape
    torch.testing.assert_close(dx, linalg.chol_solve_jvp_ref(l, dl, x, db),
                               rtol=0, atol=0)
  x_t = torch.as_tensor(rng.randn(b, 3, n), device=cuda,
                        dtype=dtype).transpose(1, 2)
  torch.testing.assert_close(linalg.chol_solve_jvp(l, dl, x_t, x_t),
                             linalg.chol_solve_jvp_ref(l, dl, x_t, x_t),
                             rtol=0, atol=0)


# ---------------------------------------------------------------------------
# many tangents a lane: the layout of vmap over jvp
# ---------------------------------------------------------------------------


def _factor_jvp_one(l, dh):
  """The single-tangent plain factor JVP as it stood before the tangent
  dimension: the formula every tangent must follow to the bit."""
  n = l.shape[-1]
  dmin = torch.sqrt(torch.tensor(linalg.MINVAL, dtype=l.dtype))
  t = torch.tril(dh)
  for k in range(n):
    d = l[:, k, k]
    dd = torch.where(d <= dmin, 0.0, 0.5 * t[:, k, k] / d)
    t[:, k, k] = dd
    col = l[:, k + 1:, k]
    dcol = (t[:, k + 1:, k] - col * dd[:, None]) / d[:, None]
    t[:, k + 1:, k] = dcol
    t[:, k + 1:, k + 1:] -= (dcol[:, :, None] * col[:, None, :]
                             + col[:, :, None] * dcol[:, None, :])
  return torch.tril(t)


def _solve_jvp_one(l, dl, x, db):
  """The single-tangent plain solve JVP as it stood before the tangent
  dimension (zeros for an absent tangent)."""
  n = l.shape[-1]
  xs = x.reshape(x.shape[0], n, -1)
  y = torch.zeros_like(xs)
  t = torch.zeros_like(xs)
  for c in range(n):
    y[:, :c + 1] += l[:, c, :c + 1, None] * xs[:, c, None]
    t[:, :c + 1] += dl[:, c, :c + 1, None] * xs[:, c, None]
  u = db.reshape(xs.shape).clone()
  for c in range(n):
    u[:, c:] -= dl[:, c:, c, None] * y[:, c, None]
  for c in range(n):
    u[:, c] = u[:, c] / l[:, c, c, None]
    u[:, c + 1:] -= l[:, c + 1:, c, None] * u[:, c, None]
  u = u - t
  for c in range(n - 1, -1, -1):
    u[:, c] = u[:, c] / l[:, c, c, None]
    u[:, :c] -= l[:, c, :c, None] * u[:, c, None]
  return u.reshape(x.shape)


def _tangent_layout(t, layout):
  """(T, B, ...) with the tangents in front in memory, or the lanes."""
  if layout == "tangent-major":
    return t
  return t.transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.parametrize("layout", ["tangent-major", "lane-major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tangents", [1, 3, 75])
@pytest.mark.parametrize("n", [1, 2, 5, 27])
def test_multi_tangent_plain_versions_equal_a_loop(n, tangents, dtype,
                                                   layout):
  """chol_factor_jvp_ref / chol_solve_jvp_ref with T tangents a lane equal
  the single-tangent formula applied to each tangent, to the bit, in
  either layout; an absent dL or db equals a zero one."""
  rng = np.random.RandomState(30 + n)
  b = 3
  l = linalg.chol_factor_ref(torch.as_tensor(_spd(rng, b, n))).to(dtype)
  dh = _tangent_layout(torch.as_tensor(
      rng.randn(tangents, b, n, n)).to(dtype), layout)
  dl = linalg.chol_factor_jvp_ref(l, dh)
  assert dl.shape == dh.shape
  assert torch.equal(dl, torch.stack([_factor_jvp_one(l, d) for d in dh]))
  for shape in ((b, n), (b, n, 2)):
    x = torch.as_tensor(rng.randn(*shape)).to(dtype)
    db = _tangent_layout(torch.as_tensor(
        rng.randn(tangents, *shape)).to(dtype), layout)
    zl, zb = torch.zeros_like(l), torch.zeros_like(x)
    for dl_in, db_in, one in (
        (dl, db, lambda i: _solve_jvp_one(l, dl[i], x, db[i])),
        (None, db, lambda i: _solve_jvp_one(l, zl, x, db[i])),
        (dl, None, lambda i: _solve_jvp_one(l, dl[i], x, zb)),
        (dl[0], db, lambda i: _solve_jvp_one(l, dl[0], x, db[i]))):
      got = linalg.chol_solve_jvp_ref(l, dl_in, x, db_in)
      assert got.shape == (tangents, *shape)
      assert torch.equal(got, torch.stack([one(i) for i in range(tangents)]))
  assert torch.equal(linalg.chol_solve_jvp_ref(l, dl[0], x, db[0]),
                     _solve_jvp_one(l, dl[0], x, db[0]))


def _columns(f, primals, tangents):
  """torch.func.vmap over torch.func.jvp, and the same jvp one tangent at
  a time: (vmapped, looped) tangent outputs."""
  batched = torch.func.vmap(lambda *t: torch.func.jvp(f, primals, t)[1])(
      *tangents)
  looped = torch.stack([torch.func.jvp(f, primals, tuple(t[i] for t in
                                                         tangents))[1]
                        for i in range(tangents[0].shape[0])])
  return batched, looped


@pytest.mark.parametrize("case", ["both", "matrix only", "rhs only",
                                  "rhs tangent unbatched", "lane-major",
                                  "rhs columns"])
def test_vmap_of_jvp_equals_per_column_jvp(case):
  """torch.func.vmap over torch.func.jvp of chol_factor / chol_solve (the
  explicit vmap rules and the multi-tangent JVPs) equals the per-column
  jvp to the bit, with a tangent absent or the same for all columns; the
  primal factor is computed once, at the lanes' batch."""
  rng = np.random.RandomState(31)
  b, n, tangents = 4, 6, 5
  h = torch.as_tensor(_spd(rng, b, n))
  dh = torch.as_tensor(_sym(rng, tangents * b, n)).reshape(tangents, b, n, n)
  shape = (b, n, 3) if case == "rhs columns" else (b, n)
  rhs = torch.as_tensor(rng.randn(*shape))
  drhs = torch.as_tensor(rng.randn(tangents, *shape))

  def both(hh, bb):
    return linalg.chol_solve(linalg.chol_factor(hh), bb)

  factor_calls = []
  saved = linalg._factor
  linalg._factor = lambda x: (factor_calls.append(x.shape[0]), saved(x))[1]
  try:
    if case in ("both", "rhs columns"):
      got, ref = _columns(both, (h, rhs), (dh, drhs))
    elif case == "matrix only":
      got, ref = _columns(lambda hh: both(hh, rhs), (h,), (dh,))
    elif case == "rhs only":
      got, ref = _columns(lambda bb: both(h, bb), (rhs,), (drhs,))
    elif case == "rhs tangent unbatched":
      got = torch.func.vmap(lambda t: torch.func.jvp(
          both, (h, rhs), (t, drhs[0]))[1])(dh)
      ref = torch.stack([torch.func.jvp(both, (h, rhs), (t, drhs[0]))[1]
                         for t in dh])
    else:
      got = torch.func.vmap(lambda t: torch.func.jvp(
          linalg.chol_factor, (h,), (t,))[1], in_dims=1)(
              dh.transpose(0, 1).contiguous())
      ref = torch.stack([torch.func.jvp(linalg.chol_factor, (h,), (t,))[1]
                         for t in dh])
  finally:
    linalg._factor = saved
  assert got.shape == ref.shape and torch.equal(got, ref)
  assert set(factor_calls) == {b}


def test_vmap_over_lanes_folds_into_the_batch():
  """A vmapped primal (a caller vmapping over lanes) folds into the
  kernel's batch: vmap of chol_factor / chol_solve, and of their jvp,
  equal the unbatched calls lane by lane, to the bit."""
  rng = np.random.RandomState(32)
  v, b, n = 3, 2, 5
  h = torch.as_tensor(_spd(rng, v * b, n)).reshape(v, b, n, n)
  dh = torch.as_tensor(_sym(rng, v * b, n)).reshape(v, b, n, n)
  rhs, drhs = (torch.as_tensor(rng.randn(v, b, n)) for _ in range(2))

  def both(hh, bb):
    return linalg.chol_solve(linalg.chol_factor(hh), bb)

  x = torch.func.vmap(both)(h, rhs)
  dx = torch.func.vmap(lambda *a: torch.func.jvp(both, a[:2], a[2:])[1])(
      h, rhs, dh, drhs)
  dx_shared = torch.func.vmap(lambda hh: torch.func.jvp(
      both, (hh, rhs[0]), (dh[0], drhs[0]))[1])(h)
  for i in range(v):
    assert torch.equal(x[i], both(h[i], rhs[i]))
    assert torch.equal(dx[i], torch.func.jvp(both, (h[i], rhs[i]),
                                             (dh[i], drhs[i]))[1])
    assert torch.equal(dx_shared[i], torch.func.jvp(
        both, (h[i], rhs[0]), (dh[0], drhs[0]))[1])


@pytest.mark.parametrize("n", [4, 11])
def test_multi_tangent_jvps_match_torch_and_jax(n):
  """The multi-tangent plain JVPs against torch.func.vmap over
  torch.func.jvp of torch.linalg.cholesky / torch.cholesky_solve and
  against jax.jvp of the JAX package's Pallas kernels in interpret mode
  (pallas_call's own JVP rule), f64, 1e-10.  The JAX side takes one
  tangent at a time: jax.vmap over jax.jvp of the interpreted pallas_call
  gives other tangents (0.87 off at n = 4, where one jax.jvp at a time is
  within 1e-15 of the plain version)."""
  rng = np.random.RandomState(33 + n)
  b, tangents = 128, 3
  h, rhs = _spd(rng, b, n), rng.randn(b, n)
  dh = _sym(rng, tangents * b, n).reshape(tangents, b, n, n)
  drhs = rng.randn(tangents, b, n)
  ht, rt, dht, drt = (torch.as_tensor(a) for a in (h, rhs, dh, drhs))
  l = linalg.chol_factor_ref(ht)
  dl = linalg.chol_factor_jvp_ref(l, dht)
  x = linalg.chol_solve_ref(l, rt)
  dx = linalg.chol_solve_jvp_ref(l, dl, x, drt)

  dl_torch = torch.func.vmap(lambda t: torch.func.jvp(
      torch.linalg.cholesky, (ht,), (t,))[1])(dht)
  dx_torch = torch.func.vmap(lambda a, c: torch.func.jvp(
      lambda hh, bb: torch.cholesky_solve(bb[..., None],
                                          torch.linalg.cholesky(hh))[..., 0],
      (ht, rt), (a, c))[1])(dht, drt)
  dl_jax = np.stack([jax.jvp(_pallas_chol_interpret, (jnp.asarray(h),),
                             (jnp.asarray(t),))[1] for t in dh])

  def solve(hh, bb):
    return _pallas_solve_interpret(jnp.tril(_pallas_chol_interpret(hh)), bb)

  dx_jax = np.stack([jax.jvp(solve, (jnp.asarray(h), jnp.asarray(rhs)),
                             (jnp.asarray(a), jnp.asarray(c)))[1]
                     for a, c in zip(dh, drhs)])
  for got, ref in ((dl, dl_torch), (dx, dx_torch)):
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-10)
  np.testing.assert_allclose(dl.numpy(), np.tril(np.asarray(dl_jax)),
                             rtol=0, atol=1e-10)
  np.testing.assert_allclose(dx.numpy(), np.asarray(dx_jax), rtol=0,
                             atol=1e-10)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tangent-major", "lane-major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, lanes, tangents", [
    (1, 33, 3), (27, 1, 1), (27, 8, 75), (27, 1024, 75), (33, 5, 75),
    (128, 2, 3)])
def test_multi_tangent_jvp_kernels_match_plain_versions_on_card(
    cuda, n, lanes, tangents, dtype, layout):
  """The multi-tangent JVP kernels are bit-equal to their plain versions,
  one launch a call, in either layout, with tangent strides of 0 and
  absent tangents."""
  rng = np.random.RandomState(7)
  g = torch.as_tensor(rng.randn(lanes, n, n), device=cuda, dtype=dtype)
  l = linalg.chol_factor_ref(g @ g.transpose(1, 2) + n * torch.eye(
      n, device=cuda, dtype=dtype))
  dh = _tangent_layout(torch.as_tensor(rng.randn(tangents, lanes, n, n),
                                       device=cuda, dtype=dtype), layout)
  for dh_in in (dh, dh[:1].expand(tangents, lanes, n, n)):
    before = linalg.chol_factor_jvp.launches
    got = linalg.chol_factor_jvp(l, dh_in)
    assert linalg.chol_factor_jvp.launches == before + 1
    torch.testing.assert_close(got, linalg.chol_factor_jvp_ref(l, dh_in),
                               rtol=0, atol=0)
  dl = linalg.chol_factor_jvp_ref(l, dh)
  x = torch.as_tensor(rng.randn(lanes, n), device=cuda, dtype=dtype)
  db = _tangent_layout(torch.as_tensor(rng.randn(tangents, lanes, n),
                                       device=cuda, dtype=dtype), layout)
  for dl_in, db_in in ((dl, db), (None, db), (dl, None), (dl[0], db),
                       (dl, db[0])):
    before = linalg.chol_solve_jvp.launches
    got = linalg.chol_solve_jvp(l, dl_in, x, db_in)
    assert linalg.chol_solve_jvp.launches == before + 1
    torch.testing.assert_close(got, linalg.chol_solve_jvp_ref(l, dl_in, x,
                                                              db_in),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# n > 128 on the card: the block kernels
# ---------------------------------------------------------------------------


def _large_launches():
  return tuple(getattr(linalg, f"chol_{k}_large").launches
               for k in ("factor", "solve", "factor_jvp", "solve_jvp"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [129, 324])
@pytest.mark.parametrize("b", [1, 256])
def test_large_kernels_match_plain_versions_on_card(cuda, dtype, n, b):
  """``test_kernels_match_plain_versions_on_card`` above n = 128: the
  factor and the solve launch the block kernels, once a call, bit-equal to
  the plain versions; the warp kernels are not launched."""
  rng = np.random.RandomState(5)
  h = torch.as_tensor(_spd_np(rng, b, n), device=cuda, dtype=dtype)
  before, warp = _large_launches(), _launches()
  l = linalg.chol_factor(h)
  assert _large_launches()[:2] == (before[0] + 1, before[1])
  torch.testing.assert_close(l, linalg.chol_factor_ref(h), rtol=0, atol=0)
  for k in (1, 3):
    rhs = torch.as_tensor(rng.randn(b, n, k), device=cuda, dtype=dtype)
    if k == 1:
      rhs = rhs[..., 0]
    x = linalg.chol_solve(l, rhs)
    assert x.shape == rhs.shape
    torch.testing.assert_close(x, linalg.chol_solve_ref(l, rhs), rtol=0,
                               atol=0)
  assert _large_launches()[:2] == (before[0] + 1, before[1] + 2)
  assert _launches() == warp
  h_t = h.transpose(1, 2)
  torch.testing.assert_close(linalg.chol_factor(h_t),
                             linalg.chol_factor_ref(h_t), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [129, 324])
@pytest.mark.parametrize("b", [1, 8])
def test_large_jvp_kernels_match_plain_versions_on_card(cuda, dtype, n, b):
  """``test_jvp_kernels_match_plain_versions_on_card`` above n = 128: one
  block-kernel launch a call, bit-equal, rhs (B, n) and (B, n, 3) and
  transposed inputs."""
  rng = np.random.RandomState(6)
  h = torch.as_tensor(_spd_np(rng, b, n), device=cuda, dtype=dtype)
  dh = torch.as_tensor(rng.randn(b, n, n), device=cuda, dtype=dtype)
  l = linalg.chol_factor_ref(h)
  before = _large_launches()
  dl = linalg.chol_factor_jvp(l, dh)
  assert _large_launches()[2] == before[2] + 1
  torch.testing.assert_close(dl, linalg.chol_factor_jvp_ref(l, dh), rtol=0,
                             atol=0)
  torch.testing.assert_close(linalg.chol_factor_jvp(l, dh.transpose(1, 2)),
                             linalg.chol_factor_jvp_ref(l, dh.transpose(1, 2)),
                             rtol=0, atol=0)
  for k in (1, 3):
    x, db = (torch.as_tensor(rng.randn(b, n, k), device=cuda, dtype=dtype)
             for _ in range(2))
    if k == 1:
      x, db = x[..., 0], db[..., 0]
    before = _large_launches()
    dx = linalg.chol_solve_jvp(l, dl, x, db)
    assert _large_launches()[3] == before[3] + 1
    torch.testing.assert_close(dx, linalg.chol_solve_jvp_ref(l, dl, x, db),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tangent-major", "lane-major"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, lanes, tangents", [
    (129, 1, 1), (129, 8, 75), (324, 1, 3), (324, 4, 75)])
def test_large_multi_tangent_jvp_kernels_match_plain_versions_on_card(
    cuda, n, lanes, tangents, dtype, layout):
  """``test_multi_tangent_jvp_kernels_match_plain_versions_on_card`` above
  n = 128: either layout, tangent strides of 0, absent tangents."""
  rng = np.random.RandomState(7)
  l = linalg.chol_factor_ref(torch.as_tensor(_spd_np(rng, lanes, n),
                                             device=cuda, dtype=dtype))
  dh = _tangent_layout(torch.as_tensor(rng.randn(tangents, lanes, n, n),
                                       device=cuda, dtype=dtype), layout)
  for dh_in in (dh, dh[:1].expand(tangents, lanes, n, n)):
    before = _large_launches()
    got = linalg.chol_factor_jvp(l, dh_in)
    assert _large_launches()[2] == before[2] + 1
    torch.testing.assert_close(got, linalg.chol_factor_jvp_ref(l, dh_in),
                               rtol=0, atol=0)
  dl = linalg.chol_factor_jvp_ref(l, dh)
  x = torch.as_tensor(rng.randn(lanes, n), device=cuda, dtype=dtype)
  db = _tangent_layout(torch.as_tensor(rng.randn(tangents, lanes, n),
                                       device=cuda, dtype=dtype), layout)
  for dl_in, db_in in ((dl, db), (None, db), (dl, None), (dl[0], db),
                       (dl, db[0])):
    before = _large_launches()
    got = linalg.chol_solve_jvp(l, dl_in, x, db_in)
    assert _large_launches()[3] == before[3] + 1
    torch.testing.assert_close(got, linalg.chol_solve_jvp_ref(l, dl_in, x,
                                                              db_in),
                               rtol=0, atol=0)
