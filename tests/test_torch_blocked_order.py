"""The visiting order of the panel-blocked kernels above n = 128, emulated in
plain torch on the CPU and held bit for bit to the plain versions.

``chol_factor_large_kernel`` and ``chol_factor_jvp_large_kernel``
(``csrc/cholesky.cu``) factor nb columns at a time: (a) the panel's rows
k0 .. n - 1 in shared memory, one pass a pivot, pass k applying pivot k to
the panel's later columns and finishing column k + 1 (its last update, then
its scaling by a pivot every thread computes from the diagonal; the
finished pivots kept apart and written with the panel); (b) the trailing
triangle a tile at a time, each tile taking the panel's nb rank-1 updates in
ascending pivot order.  The first panel reads the input, later ones the
output, in which the matrix is factored in place; the upper triangle is
zero.  Their bit-equality with ``chol_factor_ref`` and
``chol_factor_jvp_ref`` rests on each element taking its updates in
ascending pivot order with the same roundings, whatever order the elements
are visited in.

The emulation below runs those steps with the kernels' arithmetic: the
passes as they are (a pass at a time over the panel), the trailing update
panel by panel (each element its nb updates in a row; the elements of a
tile are independent, so one tensor operation an update covers every tile),
stored only where the kernels' walk of tiles (``TileWalk``: 4 RM rows by 32
columns, RM = 32 / itemsize) stores.  It must give the plain versions' bits
(``torch.equal``) at n = 129, 200 and 324, fp32 and fp64, for every panel
width ``large_launch_geometry`` can choose (``LARGE_PANELS``; each n leaves
a ragged last panel), the JVP at 1 and 3 tangents.  Both sides use torch's
own sqrt, so the comparison is of the order alone.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import functools

import numpy as np
import pytest
import torch

from mujoco_inversedynamicstest_tpu_torch.ops import linalg

TILE_COLS = 32  # csrc/cholesky.cu: kTileCols
NS = (129, 200, 324)
DTYPES = (torch.float32, torch.float64)


def tile_rows(dtype: torch.dtype) -> int:
  """Rows of a trailing tile: 4 row groups of RM = 32 / itemsize rows."""
  return 4 * (32 // dtype.itemsize)


def tiles(j0: int, n: int, tr: int) -> list[tuple[int, int]]:
  """The kernels' TileWalk: (first row, first column) of each tile over
  the trailing triangle, rows and columns j0 .. n - 1, band by band; band
  i holds the column tiles that reach its lower triangle."""
  out, i = [], 0
  while j0 + i * tr < n:
    count = (min(i * tr + tr, n - j0) - 1) // TILE_COLS + 1
    out += [(j0 + i * tr, j0 + c * TILE_COLS) for c in range(count)]
    i += 1
  return out


@functools.lru_cache(maxsize=None)
def stored(j0: int, n: int, tr: int) -> torch.Tensor:
  """(n - j0, n - j0) counts of the tile stores of each trailing element:
  a tile stores its elements in the matrix's lower triangle."""
  m = n - j0
  count = torch.zeros(m, m, dtype=torch.int32)
  for r0, c0 in tiles(j0, n, tr):
    count[r0 - j0:r0 - j0 + tr, c0 - j0:c0 - j0 + TILE_COLS] += 1
  return count * torch.ones(m, m, dtype=torch.int32).tril()


def factor_blocked(h: torch.Tensor, nb: int) -> torch.Tensor:
  """chol_factor_large_kernel's steps on a (B, n, n) stack."""
  n = h.shape[-1]
  lower = torch.ones(n, n, dtype=torch.bool).tril()
  a = torch.zeros_like(h)  # zeros above the diagonal
  tr = tile_rows(h.dtype)
  for k0 in range(0, n, nb):
    w, src = min(nb, n - k0), h if k0 == 0 else a
    j0 = k0 + w
    # (a) the panel, P[b, r - k0, c - k0]: its lower part
    p = torch.where(lower[k0:, k0:j0], src[:, k0:, k0:j0], 0.0)
    dg = torch.empty(h.shape[0], w, dtype=h.dtype)
    for k in range(k0 - 1, j0 - 1):
      c1, cc = k + 1 - k0, k - k0
      piv = p[:, c1, c1]
      if k >= k0:
        piv = piv - p[:, c1, cc] * p[:, c1, cc]
      d = torch.sqrt(torch.clamp(piv, min=linalg.MINVAL))
      dg[:, c1] = d
      v = p[:, c1 + 1:, c1]
      if k >= k0:
        v = v - p[:, c1 + 1:, cc] * p[:, c1, cc, None]
        # the panel's later columns (their upper part is never read)
        p[:, c1 + 1:, c1 + 1:w] = p[:, c1 + 1:, c1 + 1:w] - (
            p[:, c1 + 1:, cc, None] * p[:, None, c1 + 1:w, cc])
      p[:, c1 + 1:, c1] = v * (1.0 / d)[:, None]
    # (b) the panel into L, its pivots from dg; then the trailing triangle
    idx = torch.arange(w)
    p[:, idx, idx] = dg
    a[:, k0:, k0:j0] = torch.where(lower[k0:, k0:j0], p, a[:, k0:, k0:j0])
    if j0 < n:
      t = src[:, j0:, j0:]
      for kk in range(w):
        t = t - p[:, j0 - k0:, kk, None] * p[:, None, j0 - k0:, kk]
      count = stored(j0, n, tr)
      assert int(count.max()) == 1  # no element is stored twice
      a[:, j0:, j0:] = torch.where(count == 1, t, a[:, j0:, j0:])
  return a


def factor_jvp_blocked(l: torch.Tensor, dh: torch.Tensor,
                       nb: int) -> torch.Tensor:
  """chol_factor_jvp_large_kernel's steps: L (B, n, n), dH (T, B, n, n)."""
  n = l.shape[-1]
  lower = torch.ones(n, n, dtype=torch.bool).tril()
  dmin = torch.sqrt(torch.tensor(linalg.MINVAL, dtype=l.dtype))
  t = torch.zeros_like(dh)  # the running tangents, then dL
  tr = tile_rows(l.dtype)
  for k0 in range(0, n, nb):
    w, src = min(nb, n - k0), dh if k0 == 0 else t
    j0 = k0 + w
    lp = torch.where(lower[k0:, k0:j0], l[:, k0:, k0:j0], 0.0)
    dp = torch.where(lower[k0:, k0:j0], src[..., k0:, k0:j0], 0.0)
    dg = torch.empty(*dh.shape[:2], w, dtype=l.dtype)
    for k in range(k0 - 1, j0 - 1):
      c1, cc = k + 1 - k0, k - k0
      d = lp[:, c1, c1]
      pk = dp[..., c1, c1]
      if k >= k0:
        pk = pk - (dp[..., c1, cc] * lp[:, c1, cc]
                   + lp[:, c1, cc] * dp[..., c1, cc])
      dd = torch.where(d <= dmin, 0.0, 0.5 * pk / d)
      dg[..., c1] = dd
      v = dp[..., c1 + 1:, c1]
      if k >= k0:
        v = v - (dp[..., c1 + 1:, cc] * lp[:, c1, cc, None]
                 + lp[:, c1 + 1:, cc] * dp[..., c1, cc, None])
        dp[..., c1 + 1:, c1 + 1:w] = dp[..., c1 + 1:, c1 + 1:w] - (
            dp[..., c1 + 1:, cc, None] * lp[:, None, c1 + 1:w, cc]
            + lp[:, c1 + 1:, cc, None] * dp[..., None, c1 + 1:w, cc])
      dp[..., c1 + 1:, c1] = (v - lp[:, c1 + 1:, c1] * dd[..., None]) / (
          d[..., None])
    idx = torch.arange(w)
    dp[..., idx, idx] = dg
    t[..., k0:, k0:j0] = torch.where(lower[k0:, k0:j0], dp,
                                     t[..., k0:, k0:j0])
    if j0 < n:
      u = src[..., j0:, j0:]
      for kk in range(w):
        u = u - (dp[..., j0 - k0:, kk, None] * lp[:, None, j0 - k0:, kk]
                 + lp[:, j0 - k0:, kk, None] * dp[..., None, j0 - k0:, kk])
      count = stored(j0, n, tr)
      assert int(count.max()) == 1
      t[..., j0:, j0:] = torch.where(count == 1, u, t[..., j0:, j0:])
  return t


def spd(rng: np.random.RandomState, b: int, n: int) -> torch.Tensor:
  g = rng.randn(b, n, n)
  return torch.as_tensor(g @ g.transpose(0, 2, 1) + n * np.eye(n))


def sym(rng: np.random.RandomState, shape) -> torch.Tensor:
  g = torch.as_tensor(rng.randn(*shape))
  return g + g.transpose(-1, -2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp64"])
def test_tile_walk_stores_every_trailing_element_once(dtype):
  """The tiles of a panel's trailing triangle store each of its lower
  elements once and nothing above the diagonal, for n = 129..400 (every
  13th) and a trailing triangle from j0 = 1 to n - 1 (every 17th, and the
  last 34)."""
  tr = tile_rows(dtype)
  for n in range(129, 401, 13):
    for j0 in sorted(set(range(1, n, 17)) | set(range(n - 34, n))):
      count = stored(j0, n, tr)
      want = torch.ones_like(count).tril()
      assert torch.equal(count, want), (n, j0)


@functools.lru_cache(maxsize=None)
def factor_case(n: int, dtype: torch.dtype):
  """(h, the plain factor): one draw an (n, dtype), shared by the panel
  widths."""
  h = spd(np.random.RandomState(n), 1, n).to(dtype)
  return h, linalg.chol_factor_ref(h)


@functools.lru_cache(maxsize=None)
def jvp_case(n: int, dtype: torch.dtype, tangents: int):
  """(L, dH, the plain tangent), shared by the panel widths."""
  rng = np.random.RandomState(n + tangents)
  l = linalg.chol_factor_ref(spd(rng, 1, n).to(dtype))
  dh = sym(rng, (tangents, 1, n, n)).to(dtype)
  return l, dh, linalg.chol_factor_jvp_ref(l, dh)


@pytest.mark.parametrize("nb", linalg.LARGE_PANELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp64"])
@pytest.mark.parametrize("n", NS)
def test_blocked_factor_order_is_bit_equal_to_plain(n, dtype, nb):
  h, ref = factor_case(n, dtype)
  assert torch.equal(factor_blocked(h, nb), ref)


@pytest.mark.parametrize("tangents", (1, 3))
@pytest.mark.parametrize("nb", linalg.LARGE_PANELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp64"])
@pytest.mark.parametrize("n", NS)
def test_blocked_factor_jvp_order_is_bit_equal_to_plain(n, dtype, nb,
                                                        tangents):
  l, dh, ref = jvp_case(n, dtype, tangents)
  assert torch.equal(factor_jvp_blocked(l, dh, nb), ref)


@pytest.mark.parametrize("nb", (32, 1))
def test_blocked_order_with_a_clamped_pivot(nb):
  """A zero row and column: the pivot is clamped to sqrt(1e-15), the
  tangent's pivot is 0 there; still the plain versions' bits."""
  rng = np.random.RandomState(nb)
  h = spd(rng, 2, 129)
  h[:, 40, :] = 0.0
  h[:, :, 40] = 0.0
  l = linalg.chol_factor_ref(h)
  assert torch.equal(factor_blocked(h, nb), l)
  dh = sym(rng, (2, 2, 129, 129))
  assert torch.equal(factor_jvp_blocked(l, dh, nb),
                     linalg.chol_factor_jvp_ref(l, dh))
