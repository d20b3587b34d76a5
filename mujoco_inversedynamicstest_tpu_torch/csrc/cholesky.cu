// Batched small-matrix Cholesky factor and solve for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package,
// mujoco_inversedynamicstest_tpu/ops/linalg.py:
//   mi_chol_factor_*  <- _chol_kernel  (linalg.py:63, launched by _pallas_chol)
//   mi_chol_solve_*   <- _solve_kernel (linalg.py:86, launched by _pallas_solve)
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

// Raises the kernel's dynamic shared memory limit where the launch needs
// more than the default, then launches it; returns the first error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int batch, int per_block, int smem,
           cudaStream_t stream, Args... args) {
  if (smem > kDefaultSharedLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + per_block - 1) / per_block;
  kernel<<<blocks, per_block * kWarp, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int factor(const T* h, T* l, int n, int ld, int batch, int per_block,
           int smem, cudaStream_t stream) {
  return launch(chol_factor_kernel<T>, batch, per_block, smem, stream, h, l,
                n, ld, batch, T(1e-15));
}

template <typename T>
int solve(const T* l, const T* rhs, T* x, int n, int ld, int batch, int k,
          int per_block, int smem, cudaStream_t stream) {
  if (n <= kWarp) {
    return launch(chol_solve_kernel<T, 1>, batch, per_block, smem, stream, l,
                  rhs, x, n, ld, batch, k);
  }
  if (n <= 2 * kWarp) {
    return launch(chol_solve_kernel<T, 2>, batch, per_block, smem, stream, l,
                  rhs, x, n, ld, batch, k);
  }
  return launch(chol_solve_kernel<T, 4>, batch, per_block, smem, stream, l,
                rhs, x, n, ld, batch, k);
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

}  // extern "C"
