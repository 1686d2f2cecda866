// Elementwise combine of the sparse-SPD-B composite Chebyshev recurrence for
// Hopper (sm_90a), f32 and fp64.
//
// Replaces one Pallas TPU kernel of feastkit_tpu/ops/cheb_pallas.py:
//   cheb_combine_f64 <- _ds_combine_kernel (the double-single combine; on
//                       Hopper native fp64 replaces the (hi, lo) f32 pairs)
//   cheb_combine_f32 <- the same three operations, which the JAX package
//                       writes as XLA glue on its f32 rung
//                       (cheb_gen_chunk, cheb_pallas.py:1174-1185)
//
// One launch computes, for planes z, x, t0, f of one shape (any layout:
// the pass is elementwise) and scalars sc, sh, ck:
//
//   t2 = 2 (sc z - sh x) - t0
//   f' = f + ck t2
//
// t0 and f may be null (read as zero): the composite starts its inner and
// outer accumulators as qc0 y + qc1 t1 through this form, with (sc, sh, ck)
// = (qc1, -qc0, 0.5) (cheb_pallas.py:1101-1103, :1211-1215). t2 is written
// to t2_out unless that is null; f' to f_out. t2_out may be t0 and f_out
// may be f (each thread reads its own elements before it writes them).
//
// What bounds it: memory. The outer combine moves 6 planes (z, x, t0, f
// read; t2, f' written) for 6 operations per element, about 0.25 operation
// per byte in f32. So the design only streams: a grid-stride loop of
// coalesced element accesses, enough blocks to fill every SM several times
// over. Vector (16-byte) accesses are later work.
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsPerBlock = 256;
constexpr unsigned long long kMaxBlocks = 132ULL * 16;   // 16 per SM

template <typename T>
__global__ void __launch_bounds__(kThreadsPerBlock)
cheb_combine_kernel(const T* __restrict__ z, const T* __restrict__ x,
                    const T* t0, T* t2_out, const T* f, T* f_out,
                    unsigned long long total, T sc, T sh, T ck) {
  const unsigned long long step =
      static_cast<unsigned long long>(gridDim.x) * kThreadsPerBlock;
  for (unsigned long long e =
           static_cast<unsigned long long>(blockIdx.x) * kThreadsPerBlock +
           threadIdx.x;
       e < total; e += step) {
    const T prev = t0 ? t0[e] : T(0);
    const T acc = f ? f[e] : T(0);
    const T t2 = T(2) * (sc * __ldg(z + e) - sh * __ldg(x + e)) - prev;
    if (t2_out) t2_out[e] = t2;
    f_out[e] = acc + ck * t2;
  }
}

template <typename T>
int launch(const T* z, const T* x, const T* t0, T* t2_out, const T* f,
           T* f_out, long long total, T sc, T sh, T ck, void* stream) {
  if (total < 0 || f_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return static_cast<int>(cudaSuccess);
  const unsigned long long n = static_cast<unsigned long long>(total);
  unsigned long long blocks = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cheb_combine_kernel<T><<<dim3(static_cast<unsigned int>(blocks)),
                           dim3(kThreadsPerBlock), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      z, x, t0, t2_out, f, f_out, n, sc, sh, ck);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cheb_combine_f32(const float* z, const float* x, const float* t0,
                     float* t2_out, const float* f, float* f_out,
                     long long total, float sc, float sh, float ck,
                     void* stream) {
  return launch<float>(z, x, t0, t2_out, f, f_out, total, sc, sh, ck, stream);
}

int cheb_combine_f64(const double* z, const double* x, const double* t0,
                     double* t2_out, const double* f, double* f_out,
                     long long total, double sc, double sh, double ck,
                     void* stream) {
  return launch<double>(z, x, t0, t2_out, f, f_out, total, sc, sh, ck,
                        stream);
}

const char* cheb_combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
