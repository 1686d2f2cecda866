// DIA (diagonal-offset) sparse matvec for Hopper (sm_90a), f32 and fp64.
//
// Replaces two Pallas TPU kernels of feastkit_tpu/ops/pallas_kernels.py:
//   dia_matvec_f32 / dia_matvec_f64         <- _dia_kernel   (:91, via
//       _dia_matvec_32 :163 and dia_matvec :141)
//   dia_matvec_batched_f32 / _batched_f64   <- _dia_kernel_b (:206, via
//       _dia_matvec_batched :226, the custom_vmap rule of dia_matvec)
// The fp64 entries also replace the XLA shifted-add product the JAX package
// takes for 64-bit data (Mosaic has no 64-bit types); Hopper has native
// fp64.
//
// One launch computes, for row-aligned DIA diagonals (nd, N) with offsets
// off_k and g row-major (N, M) operands x[b] (g = 1 for the unbatched
// entries; the batch is the grid's y dimension, the operands lie b * N * M
// elements apart):
//
//   y[b, i, j] = sum_k diags[k, i] * x[b, i + off_k, j]
//
// where terms with i + off_k outside [0, N) are dropped (the diagonal is
// zero there). Complex operands come in as their real view: a complex
// (N, K) tensor is a real (N, 2K) one with the same real diagonals, so one
// launch does the whole complex product.
//
// What bounds it: memory. Each output element reads nd diagonal values and
// nd x values and does 2 nd operations: 0.25 operation per byte in f32, far
// below the card's ridge. So the design only has to stream: one thread per
// output element (i, j) of a flat grid over N * M, consecutive threads on
// consecutive columns of a row, so loads and stores coalesce; the TPU
// kernel's 128-lane padding of M, its padding of N to the row block and its
// halo slab are not carried over (the ragged edges are masked here). The
// diagonal value diags[k, i] is the same for every thread of row i (a
// broadcast from L1); the shifted rows i + off_k of x are re-read from L1 or
// L2 (a 2D stencil's +-nx rows lie a few MB apart, inside the 50 MB L2).
// Two lessons of the multi-step kernels (cheb_multistep.cu) are taken from
// the start: the loads are branch-free (an out-of-range neighbour loads the
// row itself and its term is dropped by a select), and the diagonal count is
// a compile-time constant for 3, 5, 7 and 9 diagonals, so the loop unrolls
// and its independent loads issue together; any other count (up to 32) runs
// a loop over a run-time count.
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

// ND > 0: exactly ND diagonals, unrolled; ND == 0: nd diagonals, a run-time
// loop.
template <typename T, int ND>
__global__ void __launch_bounds__(kThreadsPerBlock)
dia_matvec_kernel(const T* __restrict__ diags, DiaOffsets offs, int nd,
                  const T* __restrict__ x, T* __restrict__ y, long long n,
                  long long m) {
  const unsigned long long per_batch = static_cast<unsigned long long>(n) * m;
  const unsigned long long e =
      static_cast<unsigned long long>(blockIdx.x) * kThreadsPerBlock +
      threadIdx.x;
  if (e >= per_batch) return;
  const unsigned long long base =
      static_cast<unsigned long long>(blockIdx.y) * per_batch;
  const T* __restrict__ xb = x + base;
  // the row of element e; 32-bit division where the operand fits (the
  // branch is uniform)
  const long long row = static_cast<long long>(
      per_batch <= 0xffffffffULL
          ? static_cast<unsigned int>(e) / static_cast<unsigned int>(m)
          : e / static_cast<unsigned long long>(m));
  const int count = ND > 0 ? ND : nd;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < (ND > 0 ? ND : kMaxDiags); ++k) {
    if (ND == 0 && k >= count) break;
    const long long off = offs.v[k];
    const long long r = row + off;
    const bool ok = r >= 0 && r < n;
    // branch-free: an out-of-range neighbour reads element e itself
    const long long src = ok ? static_cast<long long>(e) + off * m
                             : static_cast<long long>(e);
    const T term = __ldg(diags + static_cast<long long>(k) * n + row) *
                   __ldg(xb + src);
    acc += ok ? term : T(0);
  }
  y[base + e] = acc;
}

template <typename T>
int launch(const T* diags, const long long* offsets, int nd, const T* x,
           T* y, long long n, long long m, long long g, void* stream) {
  if (nd < 0 || nd > kMaxDiags || n < 0 || m < 0 || g < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0 || g == 0) return static_cast<int>(cudaSuccess);
  DiaOffsets offs = {};
  for (int k = 0; k < nd; ++k) offs.v[k] = offsets[k];
  const unsigned long long per_batch = static_cast<unsigned long long>(n) * m;
  const unsigned long long blocks =
      (per_batch + kThreadsPerBlock - 1) / kThreadsPerBlock;
  if (blocks > 0x7fffffffULL || g > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(g));
  const dim3 block(kThreadsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nd) {
    case 3:
      dia_matvec_kernel<T, 3><<<grid, block, 0, s>>>(diags, offs, nd, x, y,
                                                      n, m);
      break;
    case 5:
      dia_matvec_kernel<T, 5><<<grid, block, 0, s>>>(diags, offs, nd, x, y,
                                                      n, m);
      break;
    case 7:
      dia_matvec_kernel<T, 7><<<grid, block, 0, s>>>(diags, offs, nd, x, y,
                                                      n, m);
      break;
    case 9:
      dia_matvec_kernel<T, 9><<<grid, block, 0, s>>>(diags, offs, nd, x, y,
                                                      n, m);
      break;
    default:
      dia_matvec_kernel<T, 0><<<grid, block, 0, s>>>(diags, offs, nd, x, y,
                                                      n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = A x for one row-major (n, m) operand
int dia_matvec_f32(const float* diags, const long long* offsets, int nd,
                   const float* x, float* y, long long n, long long m,
                   void* stream) {
  return launch<float>(diags, offsets, nd, x, y, n, m, 1, stream);
}

int dia_matvec_f64(const double* diags, const long long* offsets, int nd,
                   const double* x, double* y, long long n, long long m,
                   void* stream) {
  return launch<double>(diags, offsets, nd, x, y, n, m, 1, stream);
}

// y[b] = A x[b] for g contiguous row-major (n, m) operands sharing the
// diagonals
int dia_matvec_batched_f32(const float* diags, const long long* offsets,
                           int nd, const float* x, float* y, long long n,
                           long long m, long long g, void* stream) {
  return launch<float>(diags, offsets, nd, x, y, n, m, g, stream);
}

int dia_matvec_batched_f64(const double* diags, const long long* offsets,
                           int nd, const double* x, double* y, long long n,
                           long long m, long long g, void* stream) {
  return launch<double>(diags, offsets, nd, x, y, n, m, g, stream);
}

const char* dia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
