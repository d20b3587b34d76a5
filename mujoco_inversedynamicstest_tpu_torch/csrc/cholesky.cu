// Batched small-matrix Cholesky factor and solve for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package,
// mujoco_inversedynamicstest_tpu/ops/linalg.py:
//   mi_chol_factor_*  <- _chol_kernel  (linalg.py:63, launched by _pallas_chol)
//   mi_chol_solve_*   <- _solve_kernel (linalg.py:86, launched by _pallas_solve)
//
// Layout.  The TPU kernels kept the batch on the 128 vector lanes, with each
// matrix flattened column-major: element (col * n + row, b).  The same
// layout serves here: element (col * n + row) * B + b, so the 32 threads of a
// warp, one matrix each, touch 32 neighbouring addresses on every access.
// The relayout (a true column transpose, never a row-major shortcut) is done
// by the caller in torch, as XLA did it outside Pallas.
//
// What bounds it.  At the humanoid's n = 27 a factorization is about
// n^3 / 6 = 3.3k FMAs against 2 * n^2 * 4 B = 5.8 kB of compulsory traffic in
// fp32: under one FMA per byte, far below the card's ridge point, and each
// thread walks a chain of dependent pivots.  The kernel is latency- and
// memory-bound.  A thread's 729 values do not fit in registers, and a
// block's worth (128 threads, 373 kB) does not fit in shared memory, so the
// factorization works in place in the output buffer in device memory and
// leans on L1/L2 for the trailing updates.
//
// Why it is this simple.  One thread per matrix is the direct translation of
// the lane-batched TPU kernel and is easy to check against its plain torch
// version.  Faster designs (a warp per matrix, shared-memory tiles, one fused
// factor + solve launch for the Newton step) are later work.
//
// The plain versions in ops/linalg.py perform the same operations in the same
// order, and the library is compiled with -fmad=false so that no multiply
// and subtract fuse into one rounding: kernel and plain version then agree
// to the last bit, which keeps their comparison on the card exact.
//
// Semantics shared with the plain versions:
//   * only the lower triangle of the input is read (true columns);
//   * the pivot is clamped as C MuJoCo's mju_cholFactor does:
//     sqrt(max(p, mjMINVAL)), mjMINVAL = 1e-15, with NaN left as NaN;
//   * the strict upper triangle of the factor is zero.
//
// Every entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch reaches the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void chol_factor_kernel(const T* __restrict__ h, T* __restrict__ l,
                                   int n, int batch, T minval) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const size_t B = static_cast<size_t>(batch);
  // element (row r, col c) of matrix b lives at at(c, r)
  auto at = [&](int c, int r) { return (static_cast<size_t>(c) * n + r) * B + b; };

  for (int c = 0; c < n; ++c) {
    for (int r = 0; r < n; ++r) {
      l[at(c, r)] = r >= c ? h[at(c, r)] : T(0);
    }
  }

  // right-looking, in place: scale column k, then subtract its outer
  // product from the trailing lower triangle
  for (int k = 0; k < n; ++k) {
    T p = l[at(k, k)];
    p = p < minval ? minval : p;  // keeps NaN, unlike fmax
    const T d = sqrt(p);
    l[at(k, k)] = d;
    const T inv = T(1) / d;
    for (int r = k + 1; r < n; ++r) l[at(k, r)] *= inv;
    for (int j = k + 1; j < n; ++j) {
      const T ljk = l[at(k, j)];
      for (int r = j; r < n; ++r) l[at(j, r)] -= l[at(k, r)] * ljk;
    }
  }
}

// One thread per (matrix, right-hand-side column).  b and x are laid out
// (row, b * k + column): element row * (B * k) + t.
template <typename T>
__global__ void chol_solve_kernel(const T* __restrict__ l,
                                  const T* __restrict__ rhs, T* __restrict__ x,
                                  int n, int batch, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int bk = batch * k;
  if (t >= bk) return;
  const int b = t / k;
  const size_t B = static_cast<size_t>(batch);
  const size_t BK = static_cast<size_t>(bk);
  auto lat = [&](int c, int r) { return (static_cast<size_t>(c) * n + r) * B + b; };
  auto xat = [&](int r) { return static_cast<size_t>(r) * BK + t; };

  for (int r = 0; r < n; ++r) x[xat(r)] = rhs[xat(r)];

  // L y = b
  for (int c = 0; c < n; ++c) {
    const T yc = x[xat(c)] / l[lat(c, c)];
    x[xat(c)] = yc;
    for (int r = c + 1; r < n; ++r) x[xat(r)] -= l[lat(c, r)] * yc;
  }
  // L^T x = y, column by column: row c of L is column c of L^T
  for (int c = n - 1; c >= 0; --c) {
    const T xc = x[xat(c)] / l[lat(c, c)];
    x[xat(c)] = xc;
    for (int r = 0; r < c; ++r) x[xat(r)] -= l[lat(r, c)] * xc;
  }
}

int blocks_for(int work) { return (work + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int mi_chol_factor_f32(const float* h, float* l, int n, int batch,
                       cudaStream_t stream) {
  chol_factor_kernel<float><<<blocks_for(batch), kThreads, 0, stream>>>(
      h, l, n, batch, 1e-15f);
  return static_cast<int>(cudaGetLastError());
}

int mi_chol_factor_f64(const double* h, double* l, int n, int batch,
                       cudaStream_t stream) {
  chol_factor_kernel<double><<<blocks_for(batch), kThreads, 0, stream>>>(
      h, l, n, batch, 1e-15);
  return static_cast<int>(cudaGetLastError());
}

int mi_chol_solve_f32(const float* l, const float* rhs, float* x, int n,
                      int batch, int k, cudaStream_t stream) {
  chol_solve_kernel<float><<<blocks_for(batch * k), kThreads, 0, stream>>>(
      l, rhs, x, n, batch, k);
  return static_cast<int>(cudaGetLastError());
}

int mi_chol_solve_f64(const double* l, const double* rhs, double* x, int n,
                      int batch, int k, cudaStream_t stream) {
  chol_solve_kernel<double><<<blocks_for(batch * k), kThreads, 0, stream>>>(
      l, rhs, x, n, batch, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
