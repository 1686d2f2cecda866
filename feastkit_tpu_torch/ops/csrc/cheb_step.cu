// Fused Chebyshev-recurrence step for Hopper (sm_90a), f32 and fp64.
//
// Replaces two Pallas TPU kernels of feastkit_tpu/ops/cheb_pallas.py:
//   cheb_step_f32 <- _cheb_f32_kernel (one f32 step per pass)
//   cheb_step_f64 <- _cheb_ds_kernel  (the double-single step; on Hopper
//                    native fp64 replaces the (hi, lo) f32 pairs)
//
// One launch computes, for row-major (N, M) T0, T1, acc and row-aligned
// DIA diagonals (nd, N) with offsets off_k:
//
//   y[i, j]   = sum_k diags[k, i] * T1[i + off_k, j]   (terms with
//               i + off_k outside [0, N) are skipped: the diagonal is
//               zero there)
//   T2[i, j]  = 2 (sc y[i, j] - sh T1[i, j]) - T0[i, j]
//   acc[i, j] += ck T2[i, j]
//
// T2 is written into T0's buffer and acc is updated in place: each thread
// reads only its own T0 and acc element before writing it, so that is safe.
// T1 must not alias T0 or acc (the Python wrapper checks). The caller then
// rotates its carry (T0, T1, acc) <- (T1, T2, acc).
//
// The same step on the column-major (M, N) carry of the sparse-SPD-B
// composite is cheb_step_cm.cu.
//
// What bounds it: memory. A step moves 5 (N, M) planes (T0, T1 and acc
// read; T2 and acc written) plus the nd diagonals, and does ~2 nd + 6
// operations per element: about 0.5 operation per byte in f32, far below
// the card's ~20 FLOP/byte ridge. The design therefore only has to stream:
// one thread per element (i, j) of a flat grid over N * M, so every lane
// of every warp works whatever M is, and consecutive threads touch
// consecutive addresses (coalesced loads and stores). The diagonal value
// diags[k, i] is loaded by every thread of row i; the threads of a warp
// span one to three rows, so the load is a broadcast served by L1. The
// shifted T1 rows i + off_k are re-read from L1/L2 rather than device
// memory for the stencil offsets of a 2D Laplacian (+-1 row is adjacent,
// +-nx rows are 0.3-0.6 MB away, well inside the 50 MB L2). Tiling T1 in
// shared memory, TMA and multi-step fusion are later work.
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 32;   // bcoo_to_dia keeps at most 32 diagonals
constexpr int kThreadsPerBlock = 256;

struct DiaOffsets {
  long long v[kMaxDiags];
};

// MAXD is a compile-time bound on nd, so the loop over the diagonals
// unrolls and its independent loads issue together: 8 covers the 2D and 3D
// Laplacian stencils (5 and 7 diagonals), 32 any operator bcoo_to_dia
// accepts.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreadsPerBlock)
cheb_step_kernel(const T* __restrict__ diags, DiaOffsets offs, int nd,
                 T* __restrict__ t0, const T* __restrict__ t1,
                 T* __restrict__ acc, long long n, long long m,
                 T sc, T sh, T ck) {
  const unsigned long long total = static_cast<unsigned long long>(n) * m;
  const unsigned long long e =
      static_cast<unsigned long long>(blockIdx.x) * kThreadsPerBlock +
      threadIdx.x;
  if (e >= total) return;
  // the row of element e; 32-bit division where the grid fits (the branch
  // is uniform)
  const long long row = static_cast<long long>(
      total <= 0xffffffffULL
          ? static_cast<unsigned int>(e) / static_cast<unsigned int>(m)
          : e / static_cast<unsigned long long>(m));

  T y = T(0);
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < nd) {
      const long long r = row + offs.v[k];
      if (r >= 0 && r < n) {
        y += __ldg(diags + static_cast<long long>(k) * n + row) *
             __ldg(t1 + static_cast<long long>(e) + offs.v[k] * m);
      }
    }
  }
  const T t2 = T(2) * (sc * y - sh * __ldg(t1 + e)) - t0[e];
  t0[e] = t2;
  acc[e] += ck * t2;
}

template <typename T>
int launch(const T* diags, const long long* offsets, int nd, T* t0,
           const T* t1, T* acc, long long n, long long m, T sc, T sh, T ck,
           void* stream) {
  if (nd < 0 || nd > kMaxDiags || n < 0 || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  DiaOffsets offs = {};
  for (int k = 0; k < nd; ++k) offs.v[k] = offsets[k];
  const unsigned long long total = static_cast<unsigned long long>(n) * m;
  const unsigned long long blocks =
      (total + kThreadsPerBlock - 1) / kThreadsPerBlock;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  const dim3 block(kThreadsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nd <= 8) {
    cheb_step_kernel<T, 8><<<grid, block, 0, s>>>(
        diags, offs, nd, t0, t1, acc, n, m, sc, sh, ck);
  } else {
    cheb_step_kernel<T, kMaxDiags><<<grid, block, 0, s>>>(
        diags, offs, nd, t0, t1, acc, n, m, sc, sh, ck);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cheb_step_f32(const float* diags, const long long* offsets, int nd,
                  float* t0, const float* t1, float* acc, long long n,
                  long long m, float sc, float sh, float ck, void* stream) {
  return launch<float>(diags, offsets, nd, t0, t1, acc, n, m, sc, sh, ck,
                       stream);
}

int cheb_step_f64(const double* diags, const long long* offsets, int nd,
                  double* t0, const double* t1, double* acc, long long n,
                  long long m, double sc, double sh, double ck,
                  void* stream) {
  return launch<double>(diags, offsets, nd, t0, t1, acc, n, m, sc, sh, ck,
                        stream);
}

const char* cheb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
