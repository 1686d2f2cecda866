// Column-major one-step Chebyshev entries for Hopper (sm_90a), f32 and fp64.
//
// Replaces, on the column-major carry of the sparse-SPD-B composite
// (feastkit_tpu_torch/ops/cheb_gen.py), two Pallas TPU kernels of
// feastkit_tpu/ops/cheb_pallas.py:
//   cheb_step_cm_f32 <- _cheb_f32_kernel (:685, launched by _cheb_f32_step
//                       :709)
//   cheb_step_cm_f64 <- _cheb_ds_kernel  (:256, launched by _cheb_ds_step
//                       :300; the double-single (hi, lo) f32 pairs become
//                       native fp64)
// (cheb_step.cu keeps the row-major entries of the same two kernels.)
//
// One launch computes, on column-major (M, N) planes (column j is the
// contiguous N-vector at j N) and row-aligned DIA diagonals (nd, N) with
// offsets off_k:
//
//   y[j, i]   = sum_k diags[k, i] * T1[j, i + off_k]   (terms with
//               i + off_k outside [0, N) dropped: the diagonal is zero
//               there)
//   T2[j, i]  = 2 (sc y[j, i] - sh T1[j, i]) - T0[j, i]
//   acc[j, i] += ck T2[j, i]
//
// in one of four forms, chosen by two flags. T0 present: T2 is written
// over it in place (each thread reads its own T0 element before writing
// it). T0 absent: T0 is read as zero and never loaded, and T2 goes to the
// plane t2 that the caller allocated. acc absent: it is neither loaded nor
// stored (the caller refuses ck != 0 then). Every column-major launch of
// the composite starts from T0 = 0, and its y = A~ T1 launch and its fp64
// inner init keep no accumulator, so the forms without them move two or
// three planes where the full form moves five.
//
// What bounds it: bytes. The form without T0 and acc moves two planes (T1
// read, T2 written) and the diagonals; the full form five. ~2 nd + 6
// operations per element are far below the card's ridge. The flat-grid
// body this replaces (one thread per element, in cheb_step.cu until now)
// issued nd diagonal loads per element and ran a predicated 32-iteration
// loop at nine diagonals: it was bound by instructions, at 20% (f32) and
// 40% (fp64) of its byte bound at the consistent-mass shapes. Here:
//  - a thread owns one row i for a group of `cols` columns: it loads its
//    row's nd diagonal values into registers once, zeroed where i + off_k
//    falls outside the matrix, where the neighbour's offset is taken as 0
//    (the loads are branch-free, and the dropped term is exactly zero for
//    a finite T1), then walks the group's columns with nd loads of T1 per
//    element. Consecutive threads take consecutive rows, so the loads
//    coalesce; the diagonal loads are spread over the group;
//  - the grid is (row blocks, column groups); blocks are small (128
//    threads in the plan) so that many are resident on every SM. A block
//    that walked a strip of several chunks of rows, to find the rows its
//    +-nx neighbours reach in L1, was measured slower than one chunk per
//    block: the pass is not bound by those L2 reads (PERF.md);
//  - the diagonal count is a compile-time constant for 5, 7 and 9 (the
//    loops unroll and the values stay in registers); any other count up to
//    32 runs a body with a run-time count;
//  - offsets and in-column indices are 32-bit (N < 2^31); each column's
//    base is one 64-bit pointer, so M N may exceed 2^31.
// The block shape (cols, threads) comes from cm_step_plan in
// ops/cheb_kernels.py.
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 32;   // bcoo_to_dia keeps at most 32 diagonals
constexpr int kMaxThreads = 512;   // threads per block = rows per block

struct Offsets {
  int v[kMaxDiags];   // clamped to [-n, n]: beyond that a diagonal is empty
};

// ND > 0: exactly ND diagonals; ND == 0: nd of them, a run-time count.
template <typename T, int ND, bool HAS_T0, bool HAS_ACC>
__global__ void __launch_bounds__(kMaxThreads)
cheb_step_cm_kernel(const T* __restrict__ diags, Offsets offs, int nd,
                    T* __restrict__ t2, const T* __restrict__ t1,
                    T* __restrict__ acc, int n, int m, int cols, T sc, T sh,
                    T ck) {
  constexpr int kDiags = ND > 0 ? ND : kMaxDiags;
  const int count = ND > 0 ? ND : nd;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int i = static_cast<int>(row);
  const int j0 = static_cast<int>(blockIdx.y) * cols;
  const int ncols = min(cols, m - j0);
  // the row's diagonal values and its neighbours' rows, once for the
  // group; an out-of-range neighbour is the row itself with a zero value
  T d[kDiags];
  int src[kDiags];
#pragma unroll
  for (int k = 0; k < kDiags; ++k) {
    if (ND == 0 && k >= count) break;
    const int r = i + offs.v[k];    // |offs| <= n < 2^31 - n: no overflow
    const bool ok = r >= 0 && r < n;
    d[k] = ok ? __ldg(diags + static_cast<size_t>(k) * n + i) : T(0);
    src[k] = ok ? r : i;
  }
  size_t base = static_cast<size_t>(j0) * static_cast<size_t>(n);
#pragma unroll 2
  for (int jj = 0; jj < ncols; ++jj, base += n) {
    const T* __restrict__ x = t1 + base;
    T y = T(0);
#pragma unroll
    for (int k = 0; k < kDiags; ++k) {
      if (ND == 0 && k >= count) break;
      y += d[k] * __ldg(x + src[k]);
    }
    T v = T(2) * (sc * y - sh * __ldg(x + i));
    if (HAS_T0) v -= t2[base + i];
    t2[base + i] = v;
    if (HAS_ACC) acc[base + i] += ck * v;
  }
}

template <typename T, bool HAS_T0, bool HAS_ACC>
void launch_form(dim3 grid, int threads, cudaStream_t s, const T* diags,
                 const Offsets& offs, int nd, T* t2, const T* t1, T* acc,
                 int n, int m, int cols, T sc, T sh, T ck) {
  switch (nd) {
    case 5:
      cheb_step_cm_kernel<T, 5, HAS_T0, HAS_ACC><<<grid, threads, 0, s>>>(
          diags, offs, nd, t2, t1, acc, n, m, cols, sc, sh, ck);
      break;
    case 7:
      cheb_step_cm_kernel<T, 7, HAS_T0, HAS_ACC><<<grid, threads, 0, s>>>(
          diags, offs, nd, t2, t1, acc, n, m, cols, sc, sh, ck);
      break;
    case 9:
      cheb_step_cm_kernel<T, 9, HAS_T0, HAS_ACC><<<grid, threads, 0, s>>>(
          diags, offs, nd, t2, t1, acc, n, m, cols, sc, sh, ck);
      break;
    default:
      cheb_step_cm_kernel<T, 0, HAS_T0, HAS_ACC><<<grid, threads, 0, s>>>(
          diags, offs, nd, t2, t1, acc, n, m, cols, sc, sh, ck);
  }
}

// t2: T0's buffer (has_t0 != 0, T2 written over it) or the plane T2 goes
// to; acc: nullptr for the forms without an accumulator
template <typename T>
int launch(const T* diags, const long long* offsets, int nd, T* t2,
           int has_t0, const T* t1, T* acc, long long n, long long m,
           long long cols, long long threads, T sc, T sh, T ck,
           void* stream) {
  if (nd < 0 || nd > kMaxDiags || n < 0 || m < 0 || n > INT_MAX / 2 ||
      m > INT_MAX || cols < 1 || cols > INT_MAX || threads < 32 ||
      threads > kMaxThreads || threads % 32 || t2 == nullptr ||
      t1 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  Offsets offs = {};
  for (int k = 0; k < nd; ++k) {
    const long long o = offsets[k];
    offs.v[k] = static_cast<int>(o < -n ? -n : (o > n ? n : o));
  }
  const long long strips = (n + threads - 1) / threads;
  const long long groups = (m + cols - 1) / cols;
  if (strips > INT_MAX || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>(strips),
                  static_cast<unsigned int>(groups));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), mi = static_cast<int>(m);
  const int ci = static_cast<int>(cols), ti = static_cast<int>(threads);
  if (has_t0) {
    if (acc) {
      launch_form<T, true, true>(grid, ti, s, diags, offs, nd, t2, t1, acc,
                                 ni, mi, ci, sc, sh, ck);
    } else {
      launch_form<T, true, false>(grid, ti, s, diags, offs, nd, t2, t1, acc,
                                  ni, mi, ci, sc, sh, ck);
    }
  } else {
    if (acc) {
      launch_form<T, false, true>(grid, ti, s, diags, offs, nd, t2, t1, acc,
                                  ni, mi, ci, sc, sh, ck);
    } else {
      launch_form<T, false, false>(grid, ti, s, diags, offs, nd, t2, t1,
                                   acc, ni, mi, ci, sc, sh, ck);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// column-major (m, n) planes; n is the number of rows N
int cheb_step_cm_f32(const float* diags, const long long* offsets, int nd,
                     float* t2, int has_t0, const float* t1, float* acc,
                     long long n, long long m, long long cols,
                     long long threads, float sc, float sh, float ck,
                     void* stream) {
  return launch<float>(diags, offsets, nd, t2, has_t0, t1, acc, n, m, cols,
                       threads, sc, sh, ck, stream);
}

int cheb_step_cm_f64(const double* diags, const long long* offsets, int nd,
                     double* t2, int has_t0, const double* t1, double* acc,
                     long long n, long long m, long long cols,
                     long long threads, double sc, double sh, double ck,
                     void* stream) {
  return launch<double>(diags, offsets, nd, t2, has_t0, t1, acc, n, m, cols,
                        threads, sc, sh, ck, stream);
}

const char* cheb_step_cm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
