// Fused Chebyshev-recurrence step for Hopper (sm_90a): f32, fp64,
// complex64 and complex128.
//
// Replaces two Pallas TPU kernels of feastkit_tpu/ops/cheb_pallas.py:
//   cheb_step_f32 <- _cheb_f32_kernel (one f32 step per pass)
//   cheb_step_f64 <- _cheb_ds_kernel  (the double-single step; on Hopper
//                    native fp64 replaces the (hi, lo) f32 pairs)
// The complex entries cheb_step_c64 / cheb_step_c128 have no TPU
// counterpart (Mosaic has no complex type, and the JAX package runs a
// Hermitian operator's recurrence unfused): the same step on complex
// diagonals and planes in torch's interleaved layout (float2 / double2),
// with real scalars (float / double), each term y += d x as four fused
// multiply-adds.
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
// operations per element: about 0.5 operation per byte in f32 (a complex
// step does ~8 nd + 10 real operations per element: about 1.6 per byte in
// complex64, 0.8 in complex128), far below the card's ~20 FLOP/byte
// ridge. The design therefore only has to stream:
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

// ------------------------------------------------------- value arithmetic

// A value type T (float, double, float2, double2) with its real scalar
// type S: the zero, c + a b (one fused multiply-add for a real type, four
// for a complex one: (a + ib)(c + id) = ac - bd + i(ad + bc)), the step's
// 2 (sc y - sh t1) - t0 and acc + ck t2, a complex value part by part. For
// a real type each is the expression the kernel had written inline, so the
// real entries compile as before.
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.f, 0.f);
}
template <>
__device__ __forceinline__ double2 zero<double2>() {
  return make_double2(0.0, 0.0);
}

template <typename T>
__device__ __forceinline__ T mul_add(T a, T b, T c) {
  return c + a * b;
}
template <>
__device__ __forceinline__ float2 mul_add<float2>(float2 a, float2 b,
                                                  float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
template <>
__device__ __forceinline__ double2 mul_add<double2>(double2 a, double2 b,
                                                    double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

template <typename S>
__device__ __forceinline__ S recur(S y, S t1, S t0, S sc, S sh) {
  return S(2) * (sc * y - sh * t1) - t0;
}
__device__ __forceinline__ float2 recur(float2 y, float2 t1, float2 t0,
                                        float sc, float sh) {
  return make_float2(recur(y.x, t1.x, t0.x, sc, sh),
                     recur(y.y, t1.y, t0.y, sc, sh));
}
__device__ __forceinline__ double2 recur(double2 y, double2 t1, double2 t0,
                                         double sc, double sh) {
  return make_double2(recur(y.x, t1.x, t0.x, sc, sh),
                      recur(y.y, t1.y, t0.y, sc, sh));
}

template <typename S>
__device__ __forceinline__ S add_scaled(S acc, S ck, S t2) {
  return acc + ck * t2;
}
__device__ __forceinline__ float2 add_scaled(float2 acc, float ck,
                                             float2 t2) {
  return make_float2(add_scaled(acc.x, ck, t2.x),
                     add_scaled(acc.y, ck, t2.y));
}
__device__ __forceinline__ double2 add_scaled(double2 acc, double ck,
                                              double2 t2) {
  return make_double2(add_scaled(acc.x, ck, t2.x),
                      add_scaled(acc.y, ck, t2.y));
}

// ------------------------------------------------------------------ kernel

// T the value type, S its real scalar type. MAXD is a compile-time bound
// on nd, so the loop over the diagonals unrolls and its independent loads
// issue together: 8 covers the 2D and 3D Laplacian stencils (5 and 7
// diagonals) and the Hofstadter cylinder's 7, 32 any operator bcoo_to_dia
// accepts.
template <typename T, typename S, int MAXD>
__global__ void __launch_bounds__(kThreadsPerBlock)
cheb_step_kernel(const T* __restrict__ diags, DiaOffsets offs, int nd,
                 T* __restrict__ t0, const T* __restrict__ t1,
                 T* __restrict__ acc, long long n, long long m,
                 S sc, S sh, S ck) {
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

  T y = zero<T>();
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < nd) {
      const long long r = row + offs.v[k];
      if (r >= 0 && r < n) {
        y = mul_add(__ldg(diags + static_cast<long long>(k) * n + row),
                    __ldg(t1 + static_cast<long long>(e) + offs.v[k] * m),
                    y);
      }
    }
  }
  const T t2 = recur(y, __ldg(t1 + e), t0[e], sc, sh);
  t0[e] = t2;
  acc[e] = add_scaled(acc[e], ck, t2);
}

template <typename T, typename S>
int launch(const T* diags, const long long* offsets, int nd, T* t0,
           const T* t1, T* acc, long long n, long long m, S sc, S sh, S ck,
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
    cheb_step_kernel<T, S, 8><<<grid, block, 0, s>>>(
        diags, offs, nd, t0, t1, acc, n, m, sc, sh, ck);
  } else {
    cheb_step_kernel<T, S, kMaxDiags><<<grid, block, 0, s>>>(
        diags, offs, nd, t0, t1, acc, n, m, sc, sh, ck);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cheb_step_f32(const float* diags, const long long* offsets, int nd,
                  float* t0, const float* t1, float* acc, long long n,
                  long long m, float sc, float sh, float ck, void* stream) {
  return launch<float, float>(diags, offsets, nd, t0, t1, acc, n, m, sc, sh,
                              ck, stream);
}

int cheb_step_f64(const double* diags, const long long* offsets, int nd,
                  double* t0, const double* t1, double* acc, long long n,
                  long long m, double sc, double sh, double ck,
                  void* stream) {
  return launch<double, double>(diags, offsets, nd, t0, t1, acc, n, m, sc,
                                sh, ck, stream);
}

int cheb_step_c64(const float2* diags, const long long* offsets, int nd,
                  float2* t0, const float2* t1, float2* acc, long long n,
                  long long m, float sc, float sh, float ck, void* stream) {
  return launch<float2, float>(diags, offsets, nd, t0, t1, acc, n, m, sc,
                               sh, ck, stream);
}

int cheb_step_c128(const double2* diags, const long long* offsets, int nd,
                   double2* t0, const double2* t1, double2* acc, long long n,
                   long long m, double sc, double sh, double ck,
                   void* stream) {
  return launch<double2, double>(diags, offsets, nd, t0, t1, acc, n, m, sc,
                                 sh, ck, stream);
}

const char* cheb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
