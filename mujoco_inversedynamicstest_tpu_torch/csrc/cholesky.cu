// Batched Cholesky factor and solve for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's ops/linalg.py:
//   mi_chol_factor_*  <- _chol_kernel  (linalg.py:63, launched by _pallas_chol)
//   mi_chol_solve_*   <- _solve_kernel (linalg.py:86, launched by _pallas_solve)
// for n <= 128, a warp a matrix, with their forward-mode kernels; above
// n = 128, where the JAX package leaves Pallas, four block kernels
// (mi_chol_*_large_*, the second half of this file).
//
// Layout.  Both kernels read and write PyTorch's own layout: a contiguous
// (B, n, n) stack of row-major matrices and a right-hand side (B, n) or
// (B, n, k).  The TPU kernels wanted the batch on the 128 vector lanes; here
// the batch is spread over warps instead, so a contiguous input is used as
// it is and the wrapper makes one launch and no copy.
//
// What bounds it.  At the humanoid's n = 27 a factorization is about
// n^3 / 6 = 3.3k multiply-subtracts against (n (n + 1) / 2 + n^2) * 4 B =
// 4.4 kB of compulsory traffic in fp32 (the lower triangle read, the dense
// factor written), under one operation per byte: the memory rate bounds it
// (4096 matrices: 18.1 MB, 5.4 us at 3.35 TB/s).  A solve is 2 n^2
// operations against (n (n + 1) / 2 + 2 n) * 4 B, bound the same way.
// What stands between a kernel and that bound is latency: every pivot
// depends on the one before.
//
// Design: one warp per matrix, several matrices per block, each warp on a
// tile of shared memory of its own.
//   * The warp copies the lower triangle of its matrix into the tile with
//     coalesced cp.async loads (lane l takes elements l, l + 32, ... in
//     memory order, all in flight at once), works there, and writes back
//     the same way, so device memory sees each byte once.
//   * The tile's row stride ld is odd (n or n + 1): 32 lanes on 32 rows of
//     one column then hit 32 different banks, or 16 different bank pairs
//     for the 8-byte accesses of fp64, which run a half-warp at a time.
//   * Lane l owns rows r = l (mod 32).  Factor, pivot k: every lane reads
//     a[k][k] and computes d = sqrt(max(p, minval)) and 1/d; the owners
//     scale column k below the diagonal; __syncwarp; each lane subtracts
//     a[r][k] * a[j][k] from a[r][j], k < j <= r, on its own rows.
//   * Solve: L stays in the tile for both sweeps.  x is held in registers
//     (lane l holds rows l, l + 32, ...) and x[c] reaches every lane by a
//     warp shuffle.  The k columns of the right-hand side go one after the
//     other through the same warp.
//   * The caller works out the launch geometry (tile stride, matrices per
//     block, dynamic shared memory; ops/linalg.py: launch_geometry) and
//     passes it in.  Above 48 KB the entry point raises the kernel's
//     dynamic shared memory limit first (n = 128 in fp64: 132 kB a tile).
//
// The plain versions in ops/linalg.py perform, for every element, the same
// operations in the same order, and the library is compiled with
// -fmad=false so that no multiply and subtract fuse into one rounding:
// kernel and plain version then agree to the last bit, which keeps their
// comparison on the card exact.
//
// Semantics shared with the plain versions:
//   * only the lower triangle of the input is read;
//   * the pivot is clamped as C MuJoCo's mju_cholFactor does:
//     sqrt(max(p, mjMINVAL)), mjMINVAL = 1e-15, with NaN left as NaN;
//   * the strict upper triangle of the factor is zero.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDefaultSharedLimit = 48 * 1024;

// Calls f(e, r, c) for the elements e = lane, lane + 32, ... of a row-major
// n x n matrix, element e being (row r, column c).
template <typename F>
__device__ void for_each_element(int n, int lane, F f) {
  int r = lane / n, c = lane % n;
  for (int e = lane; e < n * n; e += kWarp) {
    f(e, r, c);
    for (c += kWarp; c >= n; c -= n) ++r;
  }
}

// This warp's tile in the block's dynamic shared memory.
template <typename T>
__device__ T* warp_tile(int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  return reinterpret_cast<T*>(smem) +
         static_cast<size_t>(threadIdx.x / kWarp) * n * ld;
}

// Copies the lower triangle of the matrix at src into the tile with
// cp.async, so that all of a lane's loads are in flight at once, and waits
// for the whole warp's copies.
template <typename T>
__device__ void load_lower(const T* __restrict__ src, T* a, int n, int ld,
                           int lane) {
  for_each_element(n, lane, [&](int e, int r, int c) {
    if (c <= r) __pipeline_memcpy_async(a + r * ld + c, src + e, sizeof(T));
  });
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

template <typename T>
__global__ void chol_factor_kernel(const T* __restrict__ h, T* __restrict__ l,
                                   int n, int ld, int batch, T minval) {
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (b >= batch) return;  // the whole warp leaves together
  const size_t off = static_cast<size_t>(b) * n * n;
  T* a = warp_tile<T>(n, ld);
  load_lower(h + off, a, n, ld, lane);

  // right-looking, in place: scale column k, then subtract its outer
  // product from the trailing lower triangle
  for (int k = 0; k < n; ++k) {
    T p = a[k * ld + k];
    p = p < minval ? minval : p;  // keeps NaN, unlike fmax
    const T d = sqrt(p);
    const T inv = T(1) / d;
    for (int r = lane; r < n; r += kWarp) {
      if (r > k) a[r * ld + k] *= inv;
    }
    __syncwarp();  // column k scaled; every lane has read a[k][k]
    for (int r = lane; r < n; r += kWarp) {
      if (r == k) a[r * ld + k] = d;
      if (r <= k) continue;
      T* row = a + r * ld;
      const T lrk = row[k];
      // four columns at a time, loads ahead of stores: the compiler cannot
      // tell that row[j] and a[j][k] never alias (j > k)
      int j = k + 1;
      for (; j + 3 <= r; j += 4) {
        const T c0 = a[j * ld + k], c1 = a[(j + 1) * ld + k],
                c2 = a[(j + 2) * ld + k], c3 = a[(j + 3) * ld + k];
        const T r0 = row[j], r1 = row[j + 1], r2 = row[j + 2],
                r3 = row[j + 3];
        row[j] = r0 - lrk * c0;
        row[j + 1] = r1 - lrk * c1;
        row[j + 2] = r2 - lrk * c2;
        row[j + 3] = r3 - lrk * c3;
      }
      for (; j <= r; ++j) row[j] -= lrk * a[j * ld + k];
    }
    __syncwarp();  // the trailing triangle is up to date
  }

  T* dst = l + off;
  for_each_element(n, lane, [&](int e, int r, int c) {
    dst[e] = c <= r ? a[r * ld + c] : T(0);
  });
}

// x[c] as every lane of the warp sees it: row c lives in register c / 32
// of lane c % 32.
template <typename T, int R>
__device__ T row_of(const T (&xr)[R], int c) {
  T v = xr[0];
#pragma unroll
  for (int i = 1; i < R; ++i) {
    if (c / kWarp == i) v = xr[i];
  }
  return __shfl_sync(kFullMask, v, c % kWarp);
}

// R registers a lane: rows lane, lane + 32, ..., lane + 32 (R - 1), n <= 32 R.
template <typename T, int R>
__global__ void chol_solve_kernel(const T* __restrict__ l,
                                  const T* __restrict__ rhs, T* __restrict__ x,
                                  int n, int ld, int batch, int k) {
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (b >= batch) return;
  T* a = warp_tile<T>(n, ld);
  load_lower(l + static_cast<size_t>(b) * n * n, a, n, ld, lane);

  const size_t xoff = static_cast<size_t>(b) * n * k;
  for (int q = 0; q < k; ++q) {
    T xr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + i * kWarp;
      xr[i] = r < n ? rhs[xoff + static_cast<size_t>(r) * k + q] : T(0);
    }
    // L y = b
    for (int c = 0; c < n; ++c) {
      const T yc = row_of(xr, c) / a[c * ld + c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = lane + i * kWarp;
        if (r == c) {
          xr[i] = yc;
        } else if (r > c && r < n) {
          xr[i] -= a[r * ld + c] * yc;
        }
      }
    }
    // L^T x = y, column by column: row c of L is column c of L^T
    for (int c = n - 1; c >= 0; --c) {
      const T xc = row_of(xr, c) / a[c * ld + c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = lane + i * kWarp;
        if (r == c) {
          xr[i] = xc;
        } else if (r < c) {
          xr[i] -= a[c * ld + r] * xc;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = lane + i * kWarp;
      if (r < n) x[xoff + static_cast<size_t>(r) * k + q] = xr[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward mode (JVP) of both kernels, many tangents a lane.
//
// Replaces the JVP that pallas_call's JVP rule derives from each Pallas
// kernel body (_chol_kernel, _solve_kernel) when jax.jacfwd differentiates
// the TPU step through them, as the MPC linearization does
// (opt/derivative.py: transition_ad).  jacfwd is vmap over jvp: one primal
// a lane, and the nx + nu tangents batched.  The port's transition_ad is
// the same (torch.func.vmap over torch.func.jvp), so each launch gets, for
// each of B lanes, one factor L (and one x) and T tangents:
//
//   mi_chol_factor_jvp_*  (L, dH) -> dL, the forward mode of the
//     right-looking recurrence written with the finished factor L:
//       dL[k][k] = 0.5 p' / d (0 where the pivot was clamped, d <= sqrt(1e-15))
//       dL[r][k] = (a'[r][k] - L[r][k] dL[k][k]) / d,   r > k
//       a'[r][j] -= dL[r][k] L[j][k] + L[r][k] dL[j][k],  k < j <= r
//   mi_chol_solve_jvp_*   (L, dL, x, db) -> dx,
//       dx = L^-T (L^-1 (db - dL (L^T x)) - dL^T x)
//     in five sweeps: y = L^T x and t = dL^T x, u = db - dL y, v = L^-1 u,
//     w = v - t, dx = L^-T w.  y depends on the lane alone and is computed
//     once a lane; the other four sweeps run a tangent.  dL or db may be
//     absent (a null pointer: a zero tangent), and their sweeps are left
//     out.
//
// Layout.  Every operand comes with its element strides (tangent, lane,
// row, column), so the kernels read the layout that vmap hands over,
// tangent-major or lane-major, transposed or not, with no relayout copy; a
// tangent stride of 0 repeats one operand for all tangents.  The outputs
// are written through strides the same way.
//
// What bounds them.  At n = 27 in fp32 a tangent of the factor's JVP is
// about n^3 / 3 = 6.6k operations against its dH triangle read and dL
// written (4.4 kB), under two operations per byte; the solve's JVP is about
// 4 n^2 operations a tangent against its dL triangle and two vectors.  So
// the memory rate bounds both (3.35 TB/s), and reading L once a lane rather
// than once a tangent is what this design buys: 1024 lanes x 75 tangents
// move 341.6 MB (factor) and 134.4 MB (solve), 0.102 ms and 0.040 ms.
// What stands between a kernel and that bound is the chain of dependent
// steps of a tangent: n pivots, or 4 n substitution steps.
//
// Design: a block takes a few lanes (T small) or one lane (T large).
//   * Its threads copy the packed lower triangle of each lane's L into
//     shared memory once, with coalesced cp.async loads (row r starts at
//     r (r + 1) / 2: the triangular numbers of 32 consecutive rows fall in
//     32 different banks, so 32 lanes on 32 rows of a column do not
//     conflict).  The solve also copies x, and computes y = L^T x.
//   * Its warps take the block's (lane, tangent) items in turn, warp w the
//     items w, w + W, ...  Each warp has one packed tangent tile, or two:
//     then the next item's tile is copied in with cp.async while the
//     current one runs its pivot chain, and many warps in flight on the SM
//     hide the rest of it.  All warps of a block share L.
//   * Within an item the arithmetic is that of the single-tangent kernel
//     (one warp a matrix, lane l owning rows l, l + 32, ...); the solve
//     keeps its vectors in registers.  (Spreading the factor's trailing
//     update over the lanes element by element, so that no lane waits for
//     the longest row, was slower on the card: scripts/jvp_kernel_probe.py
//     spread, and PERF.md.)
//
// The plain versions (ops/linalg.py: chol_factor_jvp_ref,
// chol_solve_jvp_ref) do, for every element of every tangent, the same
// operations in the same order; built with -fmad=false, kernel and plain
// version agree to the last bit.
// ---------------------------------------------------------------------------

// Element strides of an operand: tangent, lane, row, column.
struct View {
  long long tan, lane, row, col;
};

// Start of packed row r: the triangular number r (r + 1) / 2.
__device__ __forceinline__ int tri(int r) { return r * (r + 1) / 2; }

// Calls f(e, r, c) for the elements e = first, first + step, ... of the
// packed lower triangle of an n x n matrix, element e being (row r,
// column c), e = r (r + 1) / 2 + c.
template <typename F>
__device__ void for_each_lower(int n, int first, int step, F f) {
  int r = 0, c = first;
  while (c > r) c -= ++r;
  for (int e = first; e < tri(n); e += step) {
    f(e, r, c);
    for (c += step; c > r;) c -= ++r;
  }
}

// Issues cp.async copies of the lower triangle of the matrix at src (row
// and column strides of v) into the packed tile a, elements first,
// first + step, ...; the caller commits and waits.
template <typename T>
__device__ void load_packed(const T* __restrict__ src, const View& v, T* a,
                            int n, int first, int step) {
  for_each_lower(n, first, step, [&](int e, int r, int c) {
    __pipeline_memcpy_async(a + e, src + r * v.row + c * v.col, sizeof(T));
  });
}

// The block's dynamic shared memory.
template <typename T>
__device__ T* block_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return reinterpret_cast<T*>(smem);
}

template <typename T>
__global__ void chol_factor_jvp_kernel(
    const T* __restrict__ l, View sl, const T* __restrict__ dh, View sdh,
    T* __restrict__ dl, View sdl, int n, int lanes, int tangents,
    int lanes_per_block, int buffers, T minval) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int first = blockIdx.x * lanes_per_block;
  const int nl = min(lanes_per_block, lanes - first);
  const int tn = tri(n);
  T* ls = block_smem<T>();  // the block's factors, one packed tile each
  T* buf = ls + lanes_per_block * tn + warp * buffers * tn;
  for (int p = 0; p < nl; ++p) {
    load_packed(l + (first + p) * sl.lane, sl, ls + p * tn, n, threadIdx.x,
                blockDim.x);
  }
  // item i: tangent i % T of the block's lane i / T
  auto src = [&](int i) {
    return dh + (first + i / tangents) * sdh.lane + (i % tangents) * sdh.tan;
  };
  const int items = nl * tangents;
  int i = warp;
  if (i < items) load_packed(src(i), sdh, buf, n, lane, kWarp);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();  // every factor, and each warp's first tangent, in place
  const T dmin = sqrt(minval);

  for (int cur = 0; i < items; i += warps, cur ^= buffers == 2) {
    const int next = i + warps;
    if (buffers == 2 && next < items) {
      load_packed(src(next), sdh, buf + (cur ^ 1) * tn, n, lane, kWarp);
      __pipeline_commit();
    }
    const T* a = ls + (i / tangents) * tn;  // L
    T* t = buf + cur * tn;                  // the running tangent, then dL
    for (int k = 0; k < n; ++k) {
      const T d = a[tri(k) + k];
      const T dd = d <= dmin ? T(0) : T(0.5) * t[tri(k) + k] / d;
      for (int r = lane; r < n; r += kWarp) {
        if (r > k) t[tri(r) + k] = (t[tri(r) + k] - a[tri(r) + k] * dd) / d;
      }
      __syncwarp();  // tangent column k done; every lane has read t[k][k]
      for (int r = lane; r < n; r += kWarp) {
        if (r == k) t[tri(k) + k] = dd;
        if (r <= k) continue;
        const T* lrow = a + tri(r);
        T* row = t + tri(r);
        const T lrk = lrow[k], drk = row[k];
        for (int j = k + 1; j <= r; ++j) {
          const int jk = tri(j) + k;
          row[j] -= drk * a[jk] + lrk * t[jk];
        }
      }
      __syncwarp();  // the trailing tangent is up to date
    }

    T* dst = dl + (first + i / tangents) * sdl.lane + (i % tangents) * sdl.tan;
    for_each_element(n, lane, [&](int, int r, int c) {
      dst[r * sdl.row + c * sdl.col] = c <= r ? t[tri(r) + c] : T(0);
    });
    if (next < items) {
      if (buffers == 1) {
        __syncwarp();  // every lane has written its part of t
        load_packed(src(next), sdh, buf, n, lane, kWarp);
        __pipeline_commit();
      }
      __pipeline_wait_prior(0);
    }
    __syncwarp();  // the next tile is in place; t is free again
  }
}

// R registers a lane: rows lane, lane + 32, ..., lane + 32 (R - 1), n <= 32 R.
template <typename T, int R>
__global__ void chol_solve_jvp_kernel(
    const T* __restrict__ l, View sl, const T* __restrict__ dl, View sdl,
    const T* __restrict__ x, View sx, const T* __restrict__ db, View sdb,
    T* __restrict__ dx, View sdx, int n, int lanes, int tangents, int k,
    int lanes_per_block, int buffers) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int first = blockIdx.x * lanes_per_block;
  const int nl = min(lanes_per_block, lanes - first);
  const int tn = tri(n), nk = n * k;
  T* ls = block_smem<T>();              // factors, one packed tile a lane
  T* xs = ls + lanes_per_block * tn;    // x of each lane, column by column
  T* ys = xs + lanes_per_block * nk;    // y = L^T x, the same way
  T* buf = ys + lanes_per_block * nk + warp * buffers * tn;
  for (int p = 0; p < nl; ++p) {
    load_packed(l + (first + p) * sl.lane, sl, ls + p * tn, n, threadIdx.x,
                blockDim.x);
    const T* xp = x + (first + p) * sx.lane;
    for (int e = threadIdx.x; e < nk; e += blockDim.x) {
      __pipeline_memcpy_async(xs + p * nk + e,
                              xp + (e % n) * sx.row + (e / n) * sx.col,
                              sizeof(T));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // y = L^T x once a lane and column: row c of L times x[c], c ascending
  for (int j = warp; j < nl * k; j += warps) {
    const T* a = ls + (j / k) * tn;
    const T* xv = xs + j * n;
    T yr[R];
#pragma unroll
    for (int q = 0; q < R; ++q) yr[q] = T(0);
    for (int c = 0; c < n; ++c) {
      const T xc = xv[c];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + q * kWarp;
        if (r <= c) yr[q] += a[tri(c) + r] * xc;
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = lane + q * kWarp;
      if (r < n) ys[j * n + r] = yr[q];
    }
  }

  auto src = [&](int i) {
    return dl + (first + i / tangents) * sdl.lane + (i % tangents) * sdl.tan;
  };
  const int items = nl * tangents;
  int i = warp;
  if (dl != nullptr && i < items) load_packed(src(i), sdl, buf, n, lane, kWarp);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();  // y of every lane, and each warp's first dL, in place

  for (int cur = 0; i < items; i += warps, cur ^= buffers == 2) {
    const int next = i + warps;
    if (dl != nullptr && buffers == 2 && next < items) {
      load_packed(src(next), sdl, buf + (cur ^ 1) * tn, n, lane, kWarp);
      __pipeline_commit();
    }
    const int p = i / tangents, tg = i % tangents;
    const T* a = ls + p * tn;    // L
    const T* t = buf + cur * tn;  // dL
    for (int col = 0; col < k; ++col) {
      const T* xv = xs + (p * k + col) * n;
      const T* yv = ys + (p * k + col) * n;
      const T* dbv = db + (first + p) * sdb.lane + tg * sdb.tan +
                     col * sdb.col;
      T tr[R], ur[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + q * kWarp;
        ur[q] = db != nullptr && r < n ? dbv[r * sdb.row] : T(0);
        tr[q] = T(0);
      }
      if (dl != nullptr) {
        // t = dL^T x: row c of dL times x[c], c ascending
        for (int c = 0; c < n; ++c) {
          const T xc = xv[c];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int r = lane + q * kWarp;
            if (r <= c) tr[q] += t[tri(c) + r] * xc;
          }
        }
        // u = db - dL y: column c of dL times y[c], c ascending
        for (int c = 0; c < n; ++c) {
          const T yc = yv[c];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int r = lane + q * kWarp;
            if (r >= c && r < n) ur[q] -= t[tri(r) + c] * yc;
          }
        }
      }
      // L v = u
      for (int c = 0; c < n; ++c) {
        const T vc = row_of(ur, c) / a[tri(c) + c];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int r = lane + q * kWarp;
          if (r == c) {
            ur[q] = vc;
          } else if (r > c && r < n) {
            ur[q] -= a[tri(r) + c] * vc;
          }
        }
      }
      // w = v - t
      if (dl != nullptr) {
#pragma unroll
        for (int q = 0; q < R; ++q) ur[q] = ur[q] - tr[q];
      }
      // L^T dx = w
      for (int c = n - 1; c >= 0; --c) {
        const T wc = row_of(ur, c) / a[tri(c) + c];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int r = lane + q * kWarp;
          if (r == c) {
            ur[q] = wc;
          } else if (r < c) {
            ur[q] -= a[tri(c) + r] * wc;
          }
        }
      }
      T* dxv = dx + (first + p) * sdx.lane + tg * sdx.tan + col * sdx.col;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = lane + q * kWarp;
        if (r < n) dxv[r * sdx.row] = ur[q];
      }
    }
    if (dl != nullptr && next < items) {
      if (buffers == 1) {
        __syncwarp();  // every lane is done with t
        load_packed(src(next), sdl, buf, n, lane, kWarp);
        __pipeline_commit();
      }
      __pipeline_wait_prior(0);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// n > 128: a block a matrix (a solve column, a group of tangents).
//
// Replaces no Pallas kernel.  The JAX package's Pallas dispatch stops at
// n = 128 (ops/linalg.py: _use_pallas); above it, it calls
// jnp.linalg.cholesky and jax.scipy.linalg.cho_solve (ops/linalg.py:348,
// :361, :367, :387-389 there) and differentiates through them.  These four
// kernels take those sizes on the card:
//   mi_chol_factor_large_*      the factor           (chol_factor_ref)
//   mi_chol_solve_large_*       the solve            (chol_solve_ref)
//   mi_chol_factor_jvp_large_*  the factor's tangent (chol_factor_jvp_ref)
//   mi_chol_solve_jvp_large_*   the solve's tangent  (chol_solve_jvp_ref)
// A warp-per-matrix tile stops fitting shared memory there: at n = 128 in
// fp64 one (n, n | 1) tile is 132 kB of the 227 kB a block may use, and a
// (324, 324) fp64 matrix is 840 kB.
//
// What bounds them.  A factor is n^3 / 3 operations (a multiply and a
// subtract for each of n^3 / 6 updates) against (n (n + 1) / 2 + n^2)
// elements moved: at n = 324 in fp32, 11.3 M operations against 631 kB,
// so the card's memory (0.048 ms for 256 matrices) and its fp32 rate
// (0.043 ms at 67 TFLOP/s; twice that without fused multiply-adds) bound
// it about equally.  The factor's tangent is 2 n^3 / 3 operations: 669
// fp64 tangents of 4 lanes at n = 324 are 60.7 GFLOP, 1.8 ms at the fp64
// rate (3.6 ms unfused), against 3.4 GB of compulsory traffic (1.0 ms).  A
// solve is 2 n^2 operations a column against L's triangle and two
// vectors, under one operation a byte: the memory rate bounds it.  What
// stands between the factors and their bounds is the chain of n dependent
// pivots.
//
// The factor and its tangent: right-looking, blocked by panels of nb
// columns (ops/linalg.py: large_launch_geometry picks nb = 32 where two
// blocks still share an SM, narrower panels, down to nb = 1, for large n
// or fp64 tangents: nb = 16 for the hammock's).  A block has 256 threads,
// at most 128 registers each, two blocks an SM.  For each panel k0 ..
// k0 + nb - 1:
//   (a) its rows k0 .. n - 1 are copied into shared memory with cp.async
//       (the JVP: L's panel, fixed, and each tangent's running panel) and
//       factored there, one pass and one __syncthreads() a pivot: pass k
//       applies pivot k to the panel's later columns and finishes column
//       k + 1 (its last update, then its scaling), whose pivot every
//       thread computes alike from the diagonal, which no thread writes
//       in that pass (the finished pivots go to a vector of their own).
//       Then the panel is written to L (dL).
//   (b) the trailing triangle right of and below the panel is updated a
//       tile at a time, each tile by one warp with no barrier: the warp
//       loads the tile into registers (a lane holds RM rows by 4 columns
//       8 apart, so that 8 lanes read neighbouring elements), applies the
//       panel's nb updates in ascending k, reading the panel's entries of
//       the tile's rows and columns from shared memory (broadcasts within
//       a row group), and stores it once; the next tile's loads are
//       issued before the current tile's updates, so they are in flight
//       while it computes.  A barrier ends the panel.
// So the trailing triangle goes through the SMs once a panel instead of
// once a pivot: at n = 324 and nb = 32, 0.15 M element visits a matrix
// instead of 5.7 M (312 MB instead of 11.6 GB at 256 fp32 matrices); the
// JVP's 669 x 4 fp64 tangents at nb = 16 move 14 GB instead of 243 GB.
// The matrix lives in place in the output, which the first panel reads
// from the input.  The tiles are 4 RM rows by 32 columns, RM = 32 /
// sizeof(T): 32 x 32 in fp32, 16 x 32 in fp64.  A JVP block takes a group
// of tangents of one lane, which share L's panel, its warps spread over
// the tangents' tiles (group 1 at the hammock's shape, where two blocks
// of one tangent each fill the SM's shared memory).  Tensor cores are
// not used: their products would sum in another order (and TF32 would
// round the operands).
//
// The solves keep the running right-hand side in shared memory, one
// __syncthreads() a pivot; the solve's JVP computes y = L^T x, t = dL^T x
// and u = db - dL y a row a thread, in the plain version's order, before
// its two substitutions.
//
// Every element takes the plain versions' operations in their order: the
// rank-1 updates of each element in ascending pivot order (the panels and
// tiles change only the order in which different elements are visited),
// one rounding for each product, sum and difference (-fmad=false), the
// pivot clamp sqrt(max(p, 1e-15)), column-oriented substitutions
// (ascending, then descending); so the kernels are bit-equal to
// chol_factor_ref, chol_solve_ref, chol_factor_jvp_ref and
// chol_solve_jvp_ref.
// ---------------------------------------------------------------------------

// Threads a block of the factor and its JVP, two blocks an SM: 128
// registers a thread.
constexpr int kLargeThreads = 256;
// A trailing tile's columns: 8 lanes of 4 (8 apart).  Its rows: 4 lanes
// of kTileRows.
constexpr int kTileCols = 32;
template <typename T>
constexpr int kTileRows = 32 / sizeof(T);
// Elements past each panel in shared memory: a ragged tile reads panel
// rows up to 31 past the last (their results are never stored).
constexpr int kPanelPad = 32;
// The panel columns a pivot pass updates in a row at a time: 32 bytes
// of each.
template <typename T>
constexpr int kBatch = 32 / sizeof(T);

// Tiles of TR rows by kTileCols columns over the trailing triangle, rows
// and columns j0 .. n - 1: band i (rows j0 + TR i ...) holds the column
// tiles that reach its lower triangle.  A warp visits tiles s, s + stride,
// ... in band order.
template <int TR>
struct TileWalk {
  int j0, n, band, col;  // band < 0: past the last tile

  __device__ TileWalk(int j0_, int n_, int start)
      : j0(j0_), n(n_), band(j0_ < n_ ? 0 : -1), col(0) {
    advance(start);
  }
  __device__ int tiles(int i) const {
    return (min(i * TR + TR, n - j0) - 1) / kTileCols + 1;
  }
  __device__ void advance(int steps) {
    while (band >= 0) {
      const int count = tiles(band);
      if (col + steps < count) {
        col += steps;
        return;
      }
      steps -= count - col;
      col = 0;
      if (j0 + ++band * TR >= n) band = -1;
    }
  }
  __device__ bool done() const { return band < 0; }
  __device__ int row() const { return j0 + band * TR; }
  __device__ int column() const { return j0 + col * kTileCols; }
};

// Start of row r of a row-major n x n matrix.
__device__ __forceinline__ size_t row_start(int r, int n) {
  return static_cast<size_t>(r) * n;
}

// This lane's RM x 4 part of a tile: rows r .. r + RM - 1, columns c,
// c + 8, c + 16, c + 24 (the 8 lanes of a row group on neighbouring
// columns), of the lower triangle of an n x n matrix with element strides
// (sr, sc); zeros outside it.
template <typename T, int RM>
__device__ __forceinline__ void load_tile(const T* src, long long sr,
                                          long long sc, int n, int r, int c,
                                          T (&v)[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[i][j] = r + i < n && c + 8 * j <= r + i
                    ? src[(r + i) * sr + (c + 8 * j) * sc]
                    : T(0);
    }
  }
}

template <typename T, int RM>
__device__ __forceinline__ void store_tile(T* dst, long long sr,
                                           long long sc, int n, int r, int c,
                                           const T (&v)[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r + i < n && c + 8 * j <= r + i) {
        dst[(r + i) * sr + (c + 8 * j) * sc] = v[i][j];
      }
    }
  }
}

// (b) of both kernels: warp ``first`` of ``stride`` walks the tiles of the
// trailing triangle, rows and columns j0 .. n - 1, of a matrix read from
// src (element strides sr, sc: the input for the first panel, the output
// after) and written to dst (tr, tc).  It loads a tile into registers,
// update(r, c, v) applies the panel's updates to this lane's part of it,
// and it is stored once; the next tile's loads are issued before the
// current tile's updates, so they are in flight while it computes.
template <typename T, typename Update>
__device__ void trailing(const T* src, long long sr, long long sc, T* dst,
                         long long tr, long long tc, int n, int j0,
                         int first, int stride, Update update) {
  constexpr int RM = kTileRows<T>, TR = 4 * RM;
  const int lane = threadIdx.x % kWarp;
  const int ry = lane / 8 * RM, cx = lane % 8;
  TileWalk<TR> it(j0, n, first);
  if (it.done()) return;
  T v[RM][4], next[RM][4];
  load_tile(src, sr, sc, n, it.row() + ry, it.column() + cx, v);
  for (;;) {
    TileWalk<TR> nx = it;
    nx.advance(stride);
    if (!nx.done()) {
      load_tile(src, sr, sc, n, nx.row() + ry, nx.column() + cx, next);
    }
    const int r = it.row() + ry, c = it.column() + cx;
    update(r, c, v);
    store_tile(dst, tr, tc, n, r, c, v);
    if (nx.done()) return;
    it = nx;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = next[i][j];
    }
  }
}

// A block a matrix; ``nb`` the panel width.  Shared memory: the panel,
// nb columns of ldp = n | 1 rows (odd: the lanes that copy a row of the
// panel hit different banks) and kPanelPad, then its nb pivots.
template <typename T>
__global__ void __launch_bounds__(kLargeThreads, 2)
    chol_factor_large_kernel(const T* h, T* l, int n, int nb, T minval) {
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  T* a = l + off;
  const int ldp = n | 1;
  T* P = block_smem<T>();
  T* dg = P + nb * ldp + kPanelPad;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int warps = blockDim.x / kWarp;

  // zeros above the diagonal
  for (int r = warp; r < n; r += warps) {
    for (int c = r + 1 + lane; c < n; c += kWarp) a[row_start(r, n) + c] = T(0);
  }

  for (int k0 = 0; k0 < n; k0 += nb) {
    const int w = min(nb, n - k0), j0 = k0 + w;
    const T* src = k0 == 0 ? h + off : a;
    // (a) the panel, rows k0 .. n - 1, into shared memory: a warp a row,
    // a lane a column (w <= 32), every copy in flight at once
    const int c = k0 + lane;
    for (int r = k0 + warp; r < n; r += warps) {
      if (c < j0 && c <= r) {
        __pipeline_memcpy_async(P + (c - k0) * ldp + r,
                                src + row_start(r, n) + c, sizeof(T));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = k0 - 1; k + 1 < j0; ++k) {
      const bool first = k < k0;  // nothing to apply: finish column k0
      const int k1 = k + 1;
      const T* pc = P + max(k - k0, 0) * ldp;  // column k
      T* pn = P + (k1 - k0) * ldp;             // column k + 1
      T p = pn[k1];
      if (!first) p = p - pc[k1] * pc[k1];
      p = p < minval ? minval : p;  // keeps NaN, unlike fmax
      const T d = sqrt(p), inv = T(1) / d;
      for (int r = k1 + tid; r < n; r += blockDim.x) {
        if (r == k1) {
          dg[k1 - k0] = d;
          continue;
        }
        T v = pn[r];
        if (!first) {
          const T cr = pc[r];
          v = v - cr * pc[k1];
          // the panel's later columns, kBatch at a time, loads ahead of
          // stores: the compiler cannot tell that they never alias
          const int last = min(r, j0 - 1);
          for (int j = k1 + 1; j <= last; j += kBatch<T>) {
            T* pj = P + (j - k0) * ldp + r;
            T x[kBatch<T>], cj[kBatch<T>];
#pragma unroll
            for (int q = 0; q < kBatch<T>; ++q) {
              if (j + q <= last) {
                x[q] = pj[q * ldp];
                cj[q] = pc[j + q];
              }
            }
#pragma unroll
            for (int q = 0; q < kBatch<T>; ++q) {
              if (j + q <= last) pj[q * ldp] = x[q] - cr * cj[q];
            }
          }
        }
        pn[r] = v * inv;
      }
      __syncthreads();  // column k + 1 finished, the panel updated by k
    }
    // (b) the panel into L, then the trailing triangle
    for (int r = k0 + warp; r < n; r += warps) {
      if (c < j0 && c <= r) {
        a[row_start(r, n) + c] = r == c ? dg[c - k0] : P[(c - k0) * ldp + r];
      }
    }
    trailing(src, n, 1, a, n, 1, n, j0, warp, warps,
             [&](int r, int c, T (&v)[kTileRows<T>][4]) {
               // the panel's updates in ascending k, P's column kk holding
               // L[.][k0 + kk] by row
               for (int kk = 0; kk < w; ++kk) {
                 const T* pk = P + kk * ldp;
                 T cr[kTileRows<T>], cc[4];
#pragma unroll
                 for (int i = 0; i < kTileRows<T>; ++i) cr[i] = pk[r + i];
#pragma unroll
                 for (int j = 0; j < 4; ++j) cc[j] = pk[c + 8 * j];
#pragma unroll
                 for (int i = 0; i < kTileRows<T>; ++i) {
#pragma unroll
                   for (int j = 0; j < 4; ++j) {
                     v[i][j] = v[i][j] - cr[i] * cc[j];
                   }
                 }
               }
             });
    __syncthreads();  // the trailing triangle is up to date; P is free
  }
}

// L y = x for one column, L read through (row, column) strides; x is
// overwritten below each pivot, y gets the solution.  Column by column, one
// __syncthreads() a pivot: every thread reads x[c] (no thread writes it in
// that pass) and updates its rows below it.
template <typename T>
__device__ void forward_sub(const T* __restrict__ a, long long rs,
                            long long cs, T* x, T* y, int n) {
  for (int c = 0; c < n; ++c) {
    const T yc = x[c] / a[c * rs + c * cs];
    for (int r = c + 1 + threadIdx.x; r < n; r += blockDim.x) {
      x[r] -= a[r * rs + c * cs] * yc;
    }
    if (threadIdx.x == 0) y[c] = yc;
    __syncthreads();
  }
}

// L^T x = y the same way, columns descending: row c of L is column c of
// L^T; y is overwritten above each pivot, x gets the solution.
template <typename T>
__device__ void backward_sub(const T* __restrict__ a, long long rs,
                             long long cs, T* y, T* x, int n) {
  for (int c = n - 1; c >= 0; --c) {
    const T xc = y[c] / a[c * rs + c * cs];
    for (int r = threadIdx.x; r < c; r += blockDim.x) {
      y[r] -= a[c * rs + r * cs] * xc;
    }
    if (threadIdx.x == 0) x[c] = xc;
    __syncthreads();
  }
}

// A block a (matrix, column): blockIdx.x = b k + q.
template <typename T>
__global__ void chol_solve_large_kernel(const T* __restrict__ l,
                                        const T* __restrict__ rhs,
                                        T* __restrict__ x, int n, int k) {
  const int b = blockIdx.x / k, q = blockIdx.x % k;
  const T* a = l + static_cast<size_t>(b) * n * n;
  const size_t xoff = static_cast<size_t>(b) * n * k + q;
  T* xs = block_smem<T>();  // the running right-hand side
  T* ys = xs + n;           // y, then the running L^T x = y
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    xs[r] = rhs[xoff + static_cast<size_t>(r) * k];
  }
  __syncthreads();
  forward_sub(a, n, 1, xs, ys, n);
  backward_sub(a, n, 1, ys, xs, n);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    x[xoff + static_cast<size_t>(r) * k] = xs[r];
  }
}

// A block a group of ``group`` tangents of one lane: blockIdx.x = lane G +
// group index, G = ceil(T / group); ``nb`` the panel width.  The running
// tangent lives in dL's own buffer (through its strides).  Shared memory:
// L's panel, then each tangent's panel (nb columns of ldp = n | 1 rows
// and kPanelPad each), then each tangent's nb pivot tangents.  Warp w
// takes the trailing tiles of tangent w % group; group divides the warps.
template <typename T>
__global__ void __launch_bounds__(kLargeThreads, 2)
    chol_factor_jvp_large_kernel(const T* l, View sl, const T* dh, View sdh,
                                 T* dl, View sdl, int n, int tangents,
                                 int nb, int group, T minval) {
  const int groups = (tangents + group - 1) / group;
  const int p = blockIdx.x / groups, t0 = blockIdx.x % groups * group;
  const int gn = min(group, tangents - t0);  // this block's tangents
  const T* a = l + p * sl.lane;              // L
  const T* s0 = dh + p * sdh.lane + t0 * sdh.tan;
  T* t = dl + p * sdl.lane + t0 * sdl.tan;  // the running tangents, then dL
  const int ldp = n | 1, span = nb * ldp + kPanelPad;
  T* Lp = block_smem<T>();
  T* D = Lp + span;         // tangent g's panel at D + g span
  T* dg = D + group * span;  // tangent g's pivot tangents at dg + g nb
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int warps = blockDim.x / kWarp;
  const T dmin = sqrt(minval);

  // zeros above the diagonal of each tangent
  for (int g = 0; g < gn; ++g) {
    for (int r = warp; r < n; r += warps) {
      for (int c = r + 1 + lane; c < n; c += kWarp) {
        t[g * sdl.tan + r * sdl.row + c * sdl.col] = T(0);
      }
    }
  }

  for (int k0 = 0; k0 < n; k0 += nb) {
    const int w = min(nb, n - k0), j0 = k0 + w;
    // the running tangents: dH for the first panel, then dL
    const T* src = k0 == 0 ? s0 : t;
    const View ss = k0 == 0 ? sdh : sdl;
    // (a) L's panel and each tangent's, rows k0 .. n - 1, into shared
    // memory, a warp a row, a lane a column, every copy in flight at once
    const int c = k0 + lane;
    for (int r = k0 + warp; r < n; r += warps) {
      if (c < j0 && c <= r) {
        __pipeline_memcpy_async(Lp + (c - k0) * ldp + r,
                                a + r * sl.row + c * sl.col, sizeof(T));
        for (int g = 0; g < gn; ++g) {
          __pipeline_memcpy_async(D + g * span + (c - k0) * ldp + r,
                                  src + g * ss.tan + r * ss.row + c * ss.col,
                                  sizeof(T));
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = k0 - 1; k + 1 < j0; ++k) {
      const bool first = k < k0;  // nothing to apply: finish column k0
      const int k1 = k + 1, kc = max(k - k0, 0) * ldp, kn = (k1 - k0) * ldp;
      const T* lc = Lp + kc;  // L's column k
      const T* ln = Lp + kn;  // L's column k + 1
      const T d = ln[k1];
      const int left = n - k1;
      int gd = -1;  // the tangent whose pivot tangent dd is
      T dd = T(0);
      for (int e = tid; e < gn * left; e += blockDim.x) {
        const int g = e / left, r = k1 + e % left;
        T* dc = D + g * span + kc;  // the tangent's column k
        T* dn = D + g * span + kn;  // its column k + 1
        if (g != gd) {
          // the pivot's tangent: its last update, by every thread alike
          T pk = dn[k1];
          if (!first) pk = pk - (dc[k1] * lc[k1] + lc[k1] * dc[k1]);
          dd = d <= dmin ? T(0) : T(0.5) * pk / d;
          gd = g;
        }
        if (r == k1) {
          dg[g * nb + k1 - k0] = dd;
          continue;
        }
        T v = dn[r];
        if (!first) {
          const T drk = dc[r], lrk = lc[r];
          v = v - (drk * lc[k1] + lrk * dc[k1]);
          // the panel's later columns, as in the factor
          const int last = min(r, j0 - 1);
          for (int j = k1 + 1; j <= last; j += kBatch<T>) {
            T* dj = D + g * span + (j - k0) * ldp + r;
            T x[kBatch<T>], u[kBatch<T>];
#pragma unroll
            for (int q = 0; q < kBatch<T>; ++q) {
              if (j + q <= last) {
                x[q] = dj[q * ldp];
                u[q] = drk * lc[j + q] + lrk * dc[j + q];
              }
            }
#pragma unroll
            for (int q = 0; q < kBatch<T>; ++q) {
              if (j + q <= last) dj[q * ldp] = x[q] - u[q];
            }
          }
        }
        dn[r] = (v - ln[r] * dd) / d;
      }
      __syncthreads();  // column k + 1 finished, the panels updated by k
    }
    // (b) the panels into dL, then the trailing triangles
    for (int r = k0 + warp; r < n; r += warps) {
      if (c < j0 && c <= r) {
        for (int g = 0; g < gn; ++g) {
          t[g * sdl.tan + r * sdl.row + c * sdl.col] =
              r == c ? dg[g * nb + c - k0] : D[g * span + (c - k0) * ldp + r];
        }
      }
    }
    const int g = warp % group;
    if (g < gn) {
      const T* dp = D + g * span;
      trailing(src + g * ss.tan, ss.row, ss.col, t + g * sdl.tan, sdl.row,
               sdl.col, n, j0, warp / group, warps / group,
               [&](int r, int c, T (&v)[kTileRows<T>][4]) {
                 for (int kk = 0; kk < w; ++kk) {
                   const T* lk = Lp + kk * ldp;
                   const T* dk = dp + kk * ldp;
                   T lr[kTileRows<T>], dr[kTileRows<T>], lc[4], dc[4];
#pragma unroll
                   for (int i = 0; i < kTileRows<T>; ++i) {
                     lr[i] = lk[r + i];
                     dr[i] = dk[r + i];
                   }
#pragma unroll
                   for (int j = 0; j < 4; ++j) {
                     lc[j] = lk[c + 8 * j];
                     dc[j] = dk[c + 8 * j];
                   }
#pragma unroll
                   for (int i = 0; i < kTileRows<T>; ++i) {
#pragma unroll
                     for (int j = 0; j < 4; ++j) {
                       v[i][j] = v[i][j] - (dr[i] * lc[j] + lr[i] * dc[j]);
                     }
                   }
                 }
               });
    }
    __syncthreads();  // the trailing triangles are up to date
  }
}

// A block a (lane, tangent, column): blockIdx.x = (lane T + tangent) k +
// column.  dL or db may be null (a zero tangent), as in the warp kernel.
template <typename T>
__global__ void chol_solve_jvp_large_kernel(
    const T* __restrict__ l, View sl, const T* __restrict__ dl, View sdl,
    const T* __restrict__ x, View sx, const T* __restrict__ db, View sdb,
    T* __restrict__ dx, View sdx, int n, int tangents, int k) {
  const int q = blockIdx.x % k, item = blockIdx.x / k;
  const int p = item / tangents, tg = item % tangents;
  const T* a = l + p * sl.lane;
  const T* xv = x + p * sx.lane + q * sx.col;
  T* xs = block_smem<T>();  // x
  T* ys = xs + n;           // y = L^T x
  T* ts = ys + n;           // t = dL^T x
  T* us = ts + n;           // u = db - dL y, then the running L^-1 u
  T* ws = us + n;           // v = L^-1 u, then w = v - t and its sweep
  for (int r = threadIdx.x; r < n; r += blockDim.x) xs[r] = xv[r * sx.row];
  __syncthreads();
  // y = L^T x: row r sums L[c][r] x[c], c ascending from r
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    T acc = T(0);
    for (int c = r; c < n; ++c) acc += a[c * sl.row + r * sl.col] * xs[c];
    ys[r] = acc;
  }
  __syncthreads();
  const T* dlv = dl == nullptr ? nullptr : dl + p * sdl.lane + tg * sdl.tan;
  const T* dbv = db == nullptr ? nullptr
                               : db + p * sdb.lane + tg * sdb.tan + q * sdb.col;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    T u = dbv != nullptr ? dbv[r * sdb.row] : T(0);
    T acc = T(0);
    if (dlv != nullptr) {
      // t = dL^T x: dL[c][r] x[c], c ascending from r
      for (int c = r; c < n; ++c) acc += dlv[c * sdl.row + r * sdl.col] * xs[c];
      // u = db - dL y: column c of dL times y[c], c ascending to r
      for (int c = 0; c <= r; ++c) u -= dlv[r * sdl.row + c * sdl.col] * ys[c];
    }
    ts[r] = acc;
    us[r] = u;
  }
  __syncthreads();
  forward_sub(a, sl.row, sl.col, us, ws, n);  // v = L^-1 u
  if (dlv != nullptr) {
    for (int r = threadIdx.x; r < n; r += blockDim.x) ws[r] = ws[r] - ts[r];
    __syncthreads();
  }
  backward_sub(a, sl.row, sl.col, ws, us, n);  // dx = L^-T w
  T* dxv = dx + p * sdx.lane + tg * sdx.tan + q * sdx.col;
  for (int r = threadIdx.x; r < n; r += blockDim.x) dxv[r * sdx.row] = us[r];
}

// Raises the kernel's dynamic shared memory limit where the launch needs
// more than the default, then launches it, one block of ``threads`` for
// every ``per_block`` of ``batch``; returns the first error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int batch, int per_block, int threads, int smem,
           cudaStream_t stream, Args... args) {
  if (smem > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + per_block - 1) / per_block;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int factor(const T* h, T* l, int n, int ld, int batch, int per_block,
           int smem, cudaStream_t stream) {
  return launch(chol_factor_kernel<T>, batch, per_block, per_block * kWarp,
                smem, stream, h, l, n, ld, batch, T(1e-15));
}

template <typename T>
int solve(const T* l, const T* rhs, T* x, int n, int ld, int batch, int k,
          int per_block, int smem, cudaStream_t stream) {
  const int threads = per_block * kWarp;
  if (n <= kWarp) {
    return launch(chol_solve_kernel<T, 1>, batch, per_block, threads, smem,
                  stream, l, rhs, x, n, ld, batch, k);
  }
  if (n <= 2 * kWarp) {
    return launch(chol_solve_kernel<T, 2>, batch, per_block, threads, smem,
                  stream, l, rhs, x, n, ld, batch, k);
  }
  return launch(chol_solve_kernel<T, 4>, batch, per_block, threads, smem,
                stream, l, rhs, x, n, ld, batch, k);
}

// The strides the wrapper passes, operand after operand: L (lane, row,
// column), then (tangent, lane, row, column) of each other operand.
View matrix_view(const long long* s) { return View{0, s[0], s[1], s[2]}; }
View tangent_view(const long long* s) { return View{s[0], s[1], s[2], s[3]}; }

template <typename T>
int factor_jvp(const T* l, const T* dh, T* dl, const long long* strides,
               int n, int lanes, int tangents, int lanes_per_block,
               int warps, int buffers, int smem, cudaStream_t stream) {
  return launch(chol_factor_jvp_kernel<T>, lanes, lanes_per_block,
                warps * kWarp, smem, stream, l, matrix_view(strides), dh,
                tangent_view(strides + 3), dl, tangent_view(strides + 7), n,
                lanes, tangents, lanes_per_block, buffers, T(1e-15));
}

template <typename T, int R>
int solve_jvp_r(const T* l, const T* dl, const T* x, const T* db, T* dx,
                const long long* s, int n, int lanes, int tangents, int k,
                int lanes_per_block, int warps, int buffers, int smem,
                cudaStream_t stream) {
  return launch(chol_solve_jvp_kernel<T, R>, lanes, lanes_per_block,
                warps * kWarp, smem, stream, l, matrix_view(s), dl,
                tangent_view(s + 3), x, matrix_view(s + 7), db,
                tangent_view(s + 10), dx, tangent_view(s + 14), n, lanes,
                tangents, k, lanes_per_block, buffers);
}

template <typename T>
int solve_jvp(const T* l, const T* dl, const T* x, const T* db, T* dx,
              const long long* s, int n, int lanes, int tangents, int k,
              int lanes_per_block, int warps, int buffers, int smem,
              cudaStream_t stream) {
  if (n <= kWarp) {
    return solve_jvp_r<T, 1>(l, dl, x, db, dx, s, n, lanes, tangents, k,
                             lanes_per_block, warps, buffers, smem, stream);
  }
  if (n <= 2 * kWarp) {
    return solve_jvp_r<T, 2>(l, dl, x, db, dx, s, n, lanes, tangents, k,
                             lanes_per_block, warps, buffers, smem, stream);
  }
  return solve_jvp_r<T, 4>(l, dl, x, db, dx, s, n, lanes, tangents, k,
                           lanes_per_block, warps, buffers, smem, stream);
}

// The n > 128 kernels: a block an item, ``blocks`` of them.
template <typename T>
int factor_large(const T* h, T* l, int n, int batch, int threads, int panel,
                 int smem, cudaStream_t stream) {
  return launch(chol_factor_large_kernel<T>, batch, 1, threads, smem, stream,
                h, l, n, panel, T(1e-15));
}

template <typename T>
int solve_large(const T* l, const T* rhs, T* x, int n, int batch, int k,
                int threads, int smem, cudaStream_t stream) {
  return launch(chol_solve_large_kernel<T>, batch * k, 1, threads, smem,
                stream, l, rhs, x, n, k);
}

template <typename T>
int factor_jvp_large(const T* l, const T* dh, T* dl, const long long* s,
                     int n, int lanes, int tangents, int threads, int panel,
                     int group, int smem, cudaStream_t stream) {
  const int groups = (tangents + group - 1) / group;
  return launch(chol_factor_jvp_large_kernel<T>, lanes * groups, 1, threads,
                smem, stream, l, matrix_view(s), dh, tangent_view(s + 3), dl,
                tangent_view(s + 7), n, tangents, panel, group, T(1e-15));
}

template <typename T>
int solve_jvp_large(const T* l, const T* dl, const T* x, const T* db, T* dx,
                    const long long* s, int n, int lanes, int tangents, int k,
                    int threads, int smem, cudaStream_t stream) {
  return launch(chol_solve_jvp_large_kernel<T>, lanes * tangents * k, 1,
                threads, smem, stream, l, matrix_view(s), dl,
                tangent_view(s + 3), x, matrix_view(s + 7), db,
                tangent_view(s + 10), dx, tangent_view(s + 14), n, tangents,
                k);
}

}  // namespace

extern "C" {

int mi_chol_factor_f32(const float* h, float* l, int n, int ld, int batch,
                       int per_block, int smem, cudaStream_t stream) {
  return factor(h, l, n, ld, batch, per_block, smem, stream);
}

int mi_chol_factor_f64(const double* h, double* l, int n, int ld, int batch,
                       int per_block, int smem, cudaStream_t stream) {
  return factor(h, l, n, ld, batch, per_block, smem, stream);
}

int mi_chol_solve_f32(const float* l, const float* rhs, float* x, int n,
                      int ld, int batch, int k, int per_block, int smem,
                      cudaStream_t stream) {
  return solve(l, rhs, x, n, ld, batch, k, per_block, smem, stream);
}

int mi_chol_solve_f64(const double* l, const double* rhs, double* x, int n,
                      int ld, int batch, int k, int per_block, int smem,
                      cudaStream_t stream) {
  return solve(l, rhs, x, n, ld, batch, k, per_block, smem, stream);
}

int mi_chol_factor_jvp_f32(const float* l, const float* dh, float* dl,
                           const long long* strides, int n, int lanes,
                           int tangents, int lanes_per_block, int warps,
                           int buffers, int smem, cudaStream_t stream) {
  return factor_jvp(l, dh, dl, strides, n, lanes, tangents, lanes_per_block,
                    warps, buffers, smem, stream);
}

int mi_chol_factor_jvp_f64(const double* l, const double* dh, double* dl,
                           const long long* strides, int n, int lanes,
                           int tangents, int lanes_per_block, int warps,
                           int buffers, int smem, cudaStream_t stream) {
  return factor_jvp(l, dh, dl, strides, n, lanes, tangents, lanes_per_block,
                    warps, buffers, smem, stream);
}

int mi_chol_solve_jvp_f32(const float* l, const float* dl, const float* x,
                          const float* db, float* dx,
                          const long long* strides, int n, int lanes,
                          int tangents, int k, int lanes_per_block,
                          int warps, int buffers, int smem,
                          cudaStream_t stream) {
  return solve_jvp(l, dl, x, db, dx, strides, n, lanes, tangents, k,
                   lanes_per_block, warps, buffers, smem, stream);
}

int mi_chol_solve_jvp_f64(const double* l, const double* dl,
                          const double* x, const double* db, double* dx,
                          const long long* strides, int n, int lanes,
                          int tangents, int k, int lanes_per_block,
                          int warps, int buffers, int smem,
                          cudaStream_t stream) {
  return solve_jvp(l, dl, x, db, dx, strides, n, lanes, tangents, k,
                   lanes_per_block, warps, buffers, smem, stream);
}

int mi_chol_factor_large_f32(const float* h, float* l, int n, int batch,
                             int threads, int panel, int smem,
                             cudaStream_t stream) {
  return factor_large(h, l, n, batch, threads, panel, smem, stream);
}

int mi_chol_factor_large_f64(const double* h, double* l, int n, int batch,
                             int threads, int panel, int smem,
                             cudaStream_t stream) {
  return factor_large(h, l, n, batch, threads, panel, smem, stream);
}

int mi_chol_solve_large_f32(const float* l, const float* rhs, float* x, int n,
                            int batch, int k, int threads, int smem,
                            cudaStream_t stream) {
  return solve_large(l, rhs, x, n, batch, k, threads, smem, stream);
}

int mi_chol_solve_large_f64(const double* l, const double* rhs, double* x,
                            int n, int batch, int k, int threads, int smem,
                            cudaStream_t stream) {
  return solve_large(l, rhs, x, n, batch, k, threads, smem, stream);
}

int mi_chol_factor_jvp_large_f32(const float* l, const float* dh, float* dl,
                                 const long long* strides, int n, int lanes,
                                 int tangents, int threads, int panel,
                                 int group, int smem, cudaStream_t stream) {
  return factor_jvp_large(l, dh, dl, strides, n, lanes, tangents, threads,
                          panel, group, smem, stream);
}

int mi_chol_factor_jvp_large_f64(const double* l, const double* dh,
                                 double* dl, const long long* strides, int n,
                                 int lanes, int tangents, int threads,
                                 int panel, int group, int smem,
                                 cudaStream_t stream) {
  return factor_jvp_large(l, dh, dl, strides, n, lanes, tangents, threads,
                          panel, group, smem, stream);
}

int mi_chol_solve_jvp_large_f32(const float* l, const float* dl,
                                const float* x, const float* db, float* dx,
                                const long long* strides, int n, int lanes,
                                int tangents, int k, int threads, int smem,
                                cudaStream_t stream) {
  return solve_jvp_large(l, dl, x, db, dx, strides, n, lanes, tangents, k,
                         threads, smem, stream);
}

int mi_chol_solve_jvp_large_f64(const double* l, const double* dl,
                                const double* x, const double* db, double* dx,
                                const long long* strides, int n, int lanes,
                                int tangents, int k, int threads, int smem,
                                cudaStream_t stream) {
  return solve_jvp_large(l, dl, x, db, dx, strides, n, lanes, tangents, k,
                         threads, smem, stream);
}

}  // extern "C"
