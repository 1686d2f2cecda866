// Two fused Chebyshev steps per pass for Hopper (sm_90a), f32 and fp64.
//
// Replaces two Pallas TPU kernels of feastkit_tpu/ops/cheb_pallas.py:
//   cheb_step2_f32 <- _cheb_f32_2_kernel   cheb_step2_f64 <- _cheb_ds2_kernel
// (the double-single kernel becomes native fp64, as in cheb_step.cu). The
// four-step passes are the streamed strips of cheb_stream4.cu.
//
// One launch computes, column-major carries (M, N) (each of the M columns
// one contiguous N-vector), row-aligned DIA diagonals (nd, N) with offsets
// off_k and coefficients c_0, c_1:
//
//   for s in 0..1:
//     T_{s+2}[i] = 2 (sc sum_k diags[k, i] T_{s+1}[i + off_k] - sh T_{s+1}[i])
//                  - T_s[i]          (terms with i + off_k outside [0, N)
//                                     are skipped: the diagonal is zero there)
//   acc[i] = (acc[i] + c_0 T_2[i]) + c_1 T_3[i]
//   out0 = T_2, out1 = T_3
//
// T0 and T1 are read in neighbouring blocks' rows, so T_2 and T_3 go to
// separate buffers (the Python wrapper refuses aliases and ping-pongs two
// pairs); acc is read and written on the block's own rows only, in place.
//
// What bounds it: memory. The work needs 6 (N, M) planes per launch (T0, T1
// and acc read; T_2, T_3 and acc written) plus the diagonals once, for two
// steps; the arithmetic is 2 (2 nd + 6) operations per element, far below
// the card's ridge. The TPU kernels reach that traffic with revolving VMEM
// rings handed from one sequential grid step to the next. Thread blocks run
// concurrently and in no order, so this kernel uses overlapped tiles
// instead: the stencil couples rows only, never columns, so a block owns
// `tile` rows of ONE column (contiguous in the column-major layout, hence
// coalesced), computes level T_2 on its rows plus one halo (halo =
// max |off_k|) each side and T_3 on its own rows, and keeps in shared
// memory
//
//   bufA  tile + 2 halo   T_2
//   accS  tile            the partial accumulator of the own rows
//
// T_1's shifted rows are read from global memory through L1/L2 (as
// cheb_step.cu reads them); T_0 is read once per computed T_2 row. A block
// uses up to the 227 KB of dynamic shared memory an sm_90 block may have;
// the wrapper chooses `tile` from that budget and refuses shapes whose
// halo does not fit. Rows recomputed in the halos cost 1 + halo / tile
// times the arithmetic and re-read T_0/T_1 halo rows and the diagonals
// (once per column and level; the column is the fast grid index, so those
// reads hit L2).
//
// With at most 2048 threads resident per SM and a block-wide barrier
// between the levels, the row loop is bound by the latency of its loads,
// not by their bytes: it must keep all ~2 nd + 3 loads of a row in flight
// at once. So the loop has no branch (an out-of-range neighbour is loaded
// from a safe address and dropped by a select). The five-point stencil,
// the operator of the main path, and the nine-point stencil, both operators
// of the consistent-mass pencils (ops/cheb_gen.py), have their number of
// diagonals as a template parameter, which unrolls the loop over them
// without predicates; every other operator runs the same body with a
// run-time count. Built with -DCHEB_RUNTIME_COUNT_ONLY, every operator runs
// the run-time-count body (chip_smoke.py times the two against each other).
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 32;   // bcoo_to_dia keeps at most 32 diagonals
constexpr int kThreads = 1024;
constexpr long long kMaxSharedBytes = 232448;   // 227 KB, sm_90 opt-in limit

struct DiaOffsets {
  int v[kMaxDiags];
};

template <typename T>
struct Coeffs {
  T v[2];
};

// ND > 0: the operator has exactly ND diagonals (the loop over them unrolls
// with no predicate; instantiated for the five- and nine-point stencils);
// ND == 0: nd is a run-time value up to kMaxDiags. The kernel is held to
// the 32 registers per thread that let two blocks share an SM, which they
// do where the wrapper's tile rule gives each half the SM's shared memory.
template <typename T, int ND>
__global__ void __launch_bounds__(kThreads, 2)
cheb_step2_kernel(const T* __restrict__ diags, DiaOffsets offs, int nd_rt,
                  const T* __restrict__ t0, const T* __restrict__ t1,
                  T* __restrict__ acc, T* __restrict__ out0,
                  T* __restrict__ out1, int n, int m, int tile, int halo,
                  T sc, T sh, Coeffs<T> ck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const bufA = reinterpret_cast<T*>(smem_raw);
  T* const accS = bufA + tile + 2 * halo;
  const int nd = ND > 0 ? ND : nd_rt;
  constexpr int kBound = ND > 0 ? ND : kMaxDiags;

  // the column is the fast index of the grid: the blocks in flight share
  // a few row tiles, so a tile's diagonals are read from device memory
  // once and served to the other columns by L2
  const long long col = static_cast<long long>(blockIdx.x % m) * n;
  t0 += col;
  t1 += col;
  acc += col;
  out0 += col;
  out1 += col;

  // own rows [r0, r1); every row index below fits an int (checked by launch)
  const int r0 = static_cast<int>(blockIdx.x / m) * tile;
  const int r1 = min(r0 + tile, n);
  const int baseA = r0 - halo;

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    // level 0 computes T_2 on the own rows plus a halo each side from T_1
    // in global memory; level 1 computes T_3 on the own rows from bufA
    const int reach = s == 0 ? halo : 0;
    const int lo = max(r0 - reach, 0);
    const int hi = min(r0 + tile + reach, n);
    for (int r = lo + static_cast<int>(threadIdx.x); r < hi; r += kThreads) {
      // every load is unconditional: an out-of-range neighbour reads the
      // row itself and its term is dropped by a select, so nothing
      // branches and the loads of a row are all in flight together
      T y = T(0);
#pragma unroll
      for (int k = 0; k < kBound; ++k) {
        if (ND > 0 || k < nd) {
          const int rr = r + offs.v[k];
          const bool ok = static_cast<unsigned>(rr) < static_cast<unsigned>(n);
          const int rs = ok ? rr : r;
          const T x = (s == 0) ? __ldg(t1 + rs) : bufA[rs - baseA];
          const T d = __ldg(diags + static_cast<long long>(k) * n + r);
          y += ok ? d * x : T(0);
        }
      }
      const T center = (s == 0) ? __ldg(t1 + r) : bufA[r - baseA];
      const T prev = (s == 0) ? __ldg(t0 + r) : __ldg(t1 + r);
      const T v = T(2) * (sc * y - sh * center) - prev;
      if (s == 0) bufA[r - baseA] = v;
      if (r >= r0 && r < r1) {
        const T a = ((s == 0) ? acc[r] : accS[r - r0]) + ck.v[s] * v;
        if (s == 1) {
          acc[r] = a;
          out1[r] = v;
        } else {
          accS[r - r0] = a;
          out0[r] = v;
        }
      }
    }
    if (s == 0) __syncthreads();
  }
}

template <typename T, int ND>
int launch_nd(const T* diags, const DiaOffsets& offs, int nd, const T* t0,
              const T* t1, T* acc, T* out0, T* out1, int n, int m, int tile,
              int halo, T sc, T sh, Coeffs<T> ck, unsigned int blocks,
              size_t bytes, cudaStream_t st) {
  auto kernel = cheb_step2_kernel<T, ND>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks), dim3(kThreads), bytes, st>>>(
      diags, offs, nd, t0, t1, acc, out0, out1, n, m, tile, halo, sc, sh, ck);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* diags, const long long* offsets, int nd, const T* t0,
           const T* t1, T* acc, T* out0, T* out1, long long n, long long m,
           long long tile, T sc, T sh, Coeffs<T> ck, void* stream) {
  if (nd < 0 || nd > kMaxDiags || n < 0 || m < 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  DiaOffsets offs = {};
  long long halo = 0;
  for (int k = 0; k < nd; ++k) {
    const long long a = offsets[k] < 0 ? -offsets[k] : offsets[k];
    if (a >= n) {
      // a diagonal wholly outside the matrix: its terms are all skipped
      offs.v[k] = offsets[k] < 0 ? -static_cast<int>(n) : static_cast<int>(n);
      continue;
    }
    offs.v[k] = static_cast<int>(offsets[k]);
    if (a > halo) halo = a;
  }
  // bufA (tile + 2 halo) and accS (tile)
  const long long bytes = (2 * tile + 2 * halo) *
                          static_cast<long long>(sizeof(T));
  const long long tiles = (n + tile - 1) / tile;
  // row indices (own rows plus halos or a skipped diagonal's +-n, plus the
  // stride of the row loop) must fit an int, and so must the block count
  if (bytes > kMaxSharedBytes ||
      2 * n + tile + 3 * halo + kThreads > 0x7fffffffLL ||
      m > 0x7fffffffLL / tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHEB_LAUNCH(ND)                                                      \
  launch_nd<T, ND>(diags, offs, nd, t0, t1, acc, out0, out1,                 \
                   static_cast<int>(n), static_cast<int>(m),                 \
                   static_cast<int>(tile), static_cast<int>(halo), sc, sh,   \
                   ck, static_cast<unsigned int>(tiles * m),                 \
                   static_cast<size_t>(bytes), st)
#ifdef CHEB_RUNTIME_COUNT_ONLY
  return CHEB_LAUNCH(0);
#else
  return nd == 5 ? CHEB_LAUNCH(5) : nd == 9 ? CHEB_LAUNCH(9) : CHEB_LAUNCH(0);
#endif
#undef CHEB_LAUNCH
}

}  // namespace

extern "C" {

int cheb_step2_f32(const float* diags, const long long* offsets, int nd,
                   const float* t0, const float* t1, float* acc, float* out0,
                   float* out1, long long n, long long m, long long tile,
                   float sc, float sh, float c0, float c1, void* stream) {
  return launch<float>(diags, offsets, nd, t0, t1, acc, out0, out1, n, m,
                       tile, sc, sh, Coeffs<float>{{c0, c1}}, stream);
}

int cheb_step2_f64(const double* diags, const long long* offsets, int nd,
                   const double* t0, const double* t1, double* acc,
                   double* out0, double* out1, long long n, long long m,
                   long long tile, double sc, double sh, double c0, double c1,
                   void* stream) {
  return launch<double>(diags, offsets, nd, t0, t1, acc, out0, out1, n, m,
                        tile, sc, sh, Coeffs<double>{{c0, c1}}, stream);
}

const char* cheb_multistep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
