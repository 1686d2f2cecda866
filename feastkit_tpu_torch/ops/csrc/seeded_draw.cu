// The seeded initial subspace on the card, bit for bit numpy's host draw,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws the subspace on the host
// (core/tools.seeded_subspace), numpy's
//
//   w = default_rng(key).standard_normal((N, M0))
//   w = w / np.linalg.norm(w, axis=0, keepdims=True)
//
// and the precision ladder starts from w's float32 bits, widened. These
// kernels write the same bits straight into the (N, M0) float64 buffer of
// the solve (ops/seeded_draw.py holds the design, its plain version and
// the order of launches; the argument of each step is there):
//
//   seeded_chunk_maps   every (chunk, entry offset) of the stream parsed:
//                       the normals that start in the chunk, the exit
//   seeded_walk         one block: the maps composed, each chunk's true
//                       entry and its first normal's index
//   seeded_emit         each chunk parsed from its true entry, normal k
//                       to element k
//   seeded_column_norms each column's sum of squares, a sequential chain
//                       in row order (M0 >= 2), then its square root
//   seeded_pairwise_*   the same for M0 = 1: numpy's pairwise sum in
//                       blocks of its buffer size
//   seeded_scale        w / norm, rounded to float32, widened, in place
//
// numpy's stream is PCG64 (XSL-RR output of a 128-bit LCG); a normal is
// numpy's random_standard_normal (distributions.c), ziggurat tables from
// npy_ziggurat.h. Every multiply and add that numpy does separately is
// done separately here (__dmul_rn, __dadd_rn: no FMA contraction). The
// ziggurat's tail takes glibc's log1p and its wedge test glibc's exp:
// log1p_glibc_fma and exp_glibc_fma are glibc's x86-64 FMA builds of
// sysdeps/ieee754/dbl-64/s_log1p.c and e_exp.c (the targets the libm of
// glibc 2.36 and 2.39 selects on a CPU with FMA), operation for operation,
// exp's table and constants from glibc_exp.h. The wrapper holds both
// against the host's libm once a process (ops/seeded_draw.py).
//
// What bounds it: the normalisation's M0 chains of N dependent fp64 adds
// (about 8 cycles each, ~5 ms at N = 1,048,576); the parses are integer
// work (a 128-bit multiply a position), ~ENTRIES + 1 passes over the
// stream spread over the whole card; the buffer is written twice (608 MB
// at the main path's shape: ~0.4 ms at 3.35 TB/s).
//
// Plain C interface (bound with ctypes). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#define NPY_ZIG_STORAGE static __device__
#include "npy_ziggurat.h"
#define GLIBC_EXP_STORAGE static __device__
#include "glibc_exp.h"

namespace {

typedef unsigned long long u64;

struct U128 {
  u64 lo, hi;
};

__device__ __forceinline__ U128 mul(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo * b.lo;
  r.hi = __umul64hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo;
  return r;
}

__device__ __forceinline__ U128 add(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo + b.lo;
  r.hi = a.hi + b.hi + (r.lo < a.lo ? 1ULL : 0ULL);
  return r;
}

// PCG_DEFAULT_MULTIPLIER_128
__device__ __forceinline__ U128 multiplier() {
  return U128{0x4385df649fccf645ULL, 0x2360ed051fc65da4ULL};
}

// the LCG's state after `delta` steps from `s` (pcg's jump-ahead)
__device__ U128 advance(U128 s, U128 inc, u64 delta) {
  U128 acc_mult{1, 0}, acc_plus{0, 0};
  U128 cur_mult = multiplier(), cur_plus = inc;
  while (delta) {
    if (delta & 1) {
      acc_mult = mul(acc_mult, cur_mult);
      acc_plus = add(mul(acc_plus, cur_mult), cur_plus);
    }
    cur_plus = mul(add(cur_mult, U128{1, 0}), cur_plus);
    cur_mult = mul(cur_mult, cur_mult);
    delta >>= 1;
  }
  return add(mul(acc_mult, s), acc_plus);
}

// numpy's PCG64 from stream position `pos` (the next output is the
// (pos + 1)-th of the stream)
struct Stream {
  U128 s, inc;
  u64 pos;

  __device__ Stream(U128 s0, U128 inc_, u64 at)
      : s(advance(s0, inc_, at)), inc(inc_), pos(at) {}

  __device__ __forceinline__ u64 next() {
    s = add(mul(s, multiplier()), inc);
    ++pos;
    const u64 x = s.hi ^ s.lo;
    const unsigned rot = static_cast<unsigned>(s.hi >> 58);
    return (x >> rot) | (x << ((64u - rot) & 63u));
  }

  // next_double: (next64 >> 11) * 2^-53
  __device__ __forceinline__ double next_double() {
    return __dmul_rn(__ull2double_rn(next() >> 11), 0x1.0p-53);
  }
};

// glibc's log1p as its x86-64 FMA build computes it (the ifunc target the
// libm of glibc 2.36 and 2.39 picks on a CPU with FMA): fdlibm's
// s_log1p.c with glibc's split polynomial, each fused multiply-add where
// that build fuses one and no other
__device__ double log1p_glibc_fma(double x) {
  const double ln2_hi = 6.93147180369123816490e-01;
  const double ln2_lo = 1.90821492927058770002e-10;
  const double Lp1 = 6.666666666666735130e-01, Lp2 = 3.999999999940941908e-01,
               Lp3 = 2.857142874366239149e-01, Lp4 = 2.222219843214978396e-01,
               Lp5 = 1.818357216161805012e-01, Lp6 = 1.531383769920937332e-01,
               Lp7 = 1.479819860511658591e-01;
  const int hx = __double2hiint(x);
  const int ax = hx & 0x7fffffff;
  int k = 1, hu = 0;
  double f = 0.0, c = 0.0, u;
  if (hx < 0x3FDA827A) {
    if (ax >= 0x3ff00000) {                   // x <= -1
      return x == -1.0 ? -__longlong_as_double(0x7ff0000000000000LL)
                       : nan("");
    }
    if (ax < 0x3e200000) {                    // |x| < 2^-29
      if (ax < 0x3c900000) return x;          // |x| < 2^-54
      return __fma_rn(-__dmul_rn(x, x), 0.5, x);
    }
    if (hx > 0 || hx <= static_cast<int>(0xbfd2bec3)) {
      k = 0;                                  // -0.2929 < x < 0.41422
      f = x;
      hu = 1;
    }
  } else if (hx >= 0x7ff00000) {
    return __dadd_rn(x, x);
  }
  if (k != 0) {
    if (hx < 0x43400000) {
      u = __dadd_rn(1.0, x);
      hu = __double2hiint(u);
      k = (hu >> 20) - 1023;
      c = k > 0 ? __dsub_rn(1.0, __dsub_rn(u, x))
                : __dsub_rn(x, __dsub_rn(u, 1.0));
      c = __ddiv_rn(c, u);
    } else {
      u = x;
      hu = __double2hiint(u);
      k = (hu >> 20) - 1023;
      c = 0.0;
    }
    hu &= 0x000fffff;
    if (hu < 0x6a09e) {                       // normalise u
      u = __hiloint2double(hu | 0x3ff00000, __double2loint(u));
    } else {                                  // normalise u / 2
      k += 1;
      u = __hiloint2double(hu | 0x3fe00000, __double2loint(u));
      hu = (0x00100000 - hu) >> 2;
    }
    f = __dsub_rn(u, 1.0);
  }
  const double hfsq = __dmul_rn(__dmul_rn(0.5, f), f);
  const double kd = static_cast<double>(k);
  if (hu == 0) {                              // |f| < 2^-20
    if (f == 0.0) {
      if (k == 0) return 0.0;
      return __fma_rn(kd, ln2_hi, __fma_rn(kd, ln2_lo, c));
    }
    const double R = __dmul_rn(__fma_rn(-f, 0.66666666666666666, 1.0), hfsq);
    if (k == 0) return __dsub_rn(f, R);
    return __fma_rn(kd, ln2_hi,
                    -__dsub_rn(__dsub_rn(R, __fma_rn(kd, ln2_lo, c)), f));
  }
  const double s = __ddiv_rn(f, __dadd_rn(2.0, f));
  const double z = __dmul_rn(s, s);
  const double R2 = __fma_rn(z, Lp3, Lp2), R3 = __fma_rn(z, Lp5, Lp4),
               R4 = __fma_rn(z, Lp7, Lp6);
  const double z2 = __dmul_rn(z, z), z4 = __dmul_rn(z2, z2);
  const double z6 = __dmul_rn(z2, z4);
  const double R = __fma_rn(
      z6, R4, __fma_rn(z4, R3, __fma_rn(z, Lp1, __dmul_rn(z2, R2))));
  const double w = __dmul_rn(s, __dadd_rn(hfsq, R));
  if (k == 0) return __dsub_rn(f, __dsub_rn(hfsq, w));
  const double t = __dadd_rn(__fma_rn(kd, ln2_lo, c), w);
  return __fma_rn(kd, ln2_hi, -__dsub_rn(__dsub_rn(hfsq, t), f));
}

// glibc's exp as its x86-64 FMA build computes it (e_exp.c: exp(x) =
// 2^(k/128) exp(r), the table's 2^(k/128) as scale (1 + tail)), each
// fused multiply-add where that build fuses one and no other. For |x| <
// 512: the wedge test's argument, -x^2 / 2 with |x| < R, lies in (-6.7,
// 0], so glibc's branch for large |x| is not carried
__device__ double exp_glibc_fma(double x) {
  const unsigned abstop =
      static_cast<unsigned>(__double_as_longlong(x) >> 52) & 0x7ffu;
  if (abstop < 0x3c9u) return __dadd_rn(1.0, x);   // |x| < 2^-54
  const double shifted = __fma_rn(x, GLIBC_EXP_INVLN2N, GLIBC_EXP_SHIFT);
  const u64 ki = static_cast<u64>(__double_as_longlong(shifted));
  const double kd = __dsub_rn(shifted, GLIBC_EXP_SHIFT);
  const double r = __fma_rn(kd, GLIBC_EXP_NEGLN2LON,
                            __fma_rn(kd, GLIBC_EXP_NEGLN2HIN, x));
  const unsigned idx = 2u * static_cast<unsigned>(ki & 0x7f);
  const double tail = __longlong_as_double(glibc_exp_tab[idx]);
  const double scale =
      __longlong_as_double(glibc_exp_tab[idx + 1] + (ki << 45));
  const double r2 = __dmul_rn(r, r);
  const double tmp = __fma_rn(
      __dmul_rn(r2, r2), __fma_rn(r, GLIBC_EXP_C5, GLIBC_EXP_C4),
      __fma_rn(__fma_rn(r, GLIBC_EXP_C3, GLIBC_EXP_C2), r2,
               __dadd_rn(r, tail)));
  return __fma_rn(scale, tmp, scale);
}

// the ziggurat's tables, copied to shared memory by each block
struct Tables {
  u64 ki[256];
  double wi[256], fi[256];
};

__device__ void load_tables(Tables& t) {
  for (int i = threadIdx.x + threadIdx.y * blockDim.x; i < 256;
       i += blockDim.x * blockDim.y) {
    t.ki[i] = npy_zig_ki[i];
    t.wi[i] = npy_zig_wi[i];
    t.fi[i] = npy_zig_fi[i];
  }
  __syncthreads();
}

// one normal: numpy's random_standard_normal on the stream
__device__ double normal(Stream& g, const Tables& t) {
  for (;;) {
    u64 r = g.next();
    const int idx = static_cast<int>(r & 0xff);
    r >>= 8;
    const bool sign = r & 1;
    const u64 rabs = (r >> 1) & 0x000fffffffffffffULL;
    double x = __dmul_rn(__ull2double_rn(rabs), t.wi[idx]);
    if (sign) x = -x;
    if (rabs < t.ki[idx]) return x;           // 99.3% of draws
    if (idx == 0) {                           // the tail, beyond R
      for (;;) {
        const double xx = __dmul_rn(-NPY_ZIGGURAT_NOR_INV_R,
                                    log1p_glibc_fma(-g.next_double()));
        const double yy = -log1p_glibc_fma(-g.next_double());
        if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
          const double v = __dadd_rn(NPY_ZIGGURAT_NOR_R, xx);
          return ((rabs >> 8) & 1) ? -v : v;
        }
      }
    }
    const double test = __dadd_rn(
        __dmul_rn(__dsub_rn(t.fi[idx - 1], t.fi[idx]), g.next_double()),
        t.fi[idx]);
    if (test < exp_glibc_fma(__dmul_rn(__dmul_rn(-0.5, x), x))) return x;
  }
}

struct Plan {
  U128 s0, inc;
  long long n, chunk, entries, chunks, group, groups;
};

// the normals that start in chunk c from position c * chunk + e (e <
// chunk), and where the next one starts, past the chunk's end
__device__ int2 parse_chunk(const Plan& p, const Tables& t, long long c,
                            long long e) {
  const u64 end = static_cast<u64>((c + 1) * p.chunk);
  Stream g(p.s0, p.inc, static_cast<u64>(c * p.chunk + e));
  int count = 0;
  while (g.pos < end) {
    normal(g, t);
    ++count;
  }
  return make_int2(count, static_cast<int>(g.pos - end));
}

// one chunk of the walk: from entry e (the next normal starts at
// c * chunk + e), add its normals to `count` and move e to the next
// chunk's entry. An entry past the maps is parsed from the stream
__device__ void step(const Plan& p, const Tables& t, const int2* maps,
                     long long c, long long& e, long long& count) {
  if (e >= p.chunk) {                         // no normal starts in c
    e -= p.chunk;
    return;
  }
  const int2 m = e < p.entries ? maps[c * p.entries + e]
                               : parse_chunk(p, t, c, e);
  count += m.x;
  e = m.y;
}

constexpr int kMapThreads = 256;
constexpr int kWalkThreads = 1024;

__global__ void __launch_bounds__(kMapThreads)
seeded_chunk_maps(Plan p, int2* maps) {
  __shared__ Tables t;
  load_tables(t);
  const long long i =
      static_cast<long long>(blockIdx.x) * kMapThreads + threadIdx.x;
  if (i >= p.chunks * p.entries) return;
  maps[i] = parse_chunk(p, t, i / p.entries, i % p.entries);
}

__global__ void __launch_bounds__(kWalkThreads)
seeded_walk(Plan p, const int2* maps, long long* group_count,
            long long* group_exit, long long* group_entry,
            long long* group_base, long long* entry, long long* base) {
  __shared__ Tables t;
  load_tables(t);
  // each group's map for each entry offset
  for (long long i = threadIdx.x; i < p.groups * p.entries;
       i += kWalkThreads) {
    const long long g = i / p.entries;
    const long long last = min((g + 1) * p.group, p.chunks);
    long long e = i % p.entries, count = 0;
    for (long long c = g * p.group; c < last; ++c) step(p, t, maps, c, e, count);
    group_count[i] = count;
    group_exit[i] = e;
  }
  __syncthreads();
  // across the groups in order, from entry 0 of chunk 0
  if (threadIdx.x == 0) {
    long long e = 0, count = 0;
    for (long long g = 0; g < p.groups; ++g) {
      group_entry[g] = e;
      group_base[g] = count;
      if (e < p.entries) {
        count += group_count[g * p.entries + e];
        e = group_exit[g * p.entries + e];
      } else {
        const long long last = min((g + 1) * p.group, p.chunks);
        for (long long c = g * p.group; c < last; ++c)
          step(p, t, maps, c, e, count);
      }
    }
  }
  __syncthreads();
  // inside each group from its true entry
  for (long long g = threadIdx.x; g < p.groups; g += kWalkThreads) {
    const long long last = min((g + 1) * p.group, p.chunks);
    long long e = group_entry[g], count = group_base[g];
    for (long long c = g * p.group; c < last; ++c) {
      entry[c] = e;
      base[c] = count;
      step(p, t, maps, c, e, count);
    }
  }
}

__global__ void __launch_bounds__(kMapThreads)
seeded_emit(Plan p, const long long* entry, const long long* base,
            double* out) {
  __shared__ Tables t;
  load_tables(t);
  const long long c =
      static_cast<long long>(blockIdx.x) * kMapThreads + threadIdx.x;
  if (c >= p.chunks) return;
  long long k = base[c];
  const bool last = c == p.chunks - 1;
  if (k >= p.n || (!last && entry[c] >= p.chunk)) return;
  // the last chunk parses on until every normal is written
  const u64 end = static_cast<u64>((c + 1) * p.chunk);
  Stream g(p.s0, p.inc, static_cast<u64>(c * p.chunk + entry[c]));
  while (k < p.n && (last || g.pos < end)) out[k++] = normal(g, t);
}

constexpr int kSumCols = 4;       // columns a block chains (one sector)
constexpr int kSumRows = 512;     // rows a tile
constexpr int kSumThreads = 256;
constexpr int kSumLoads = kSumRows * kSumCols / kSumThreads;

// each column's sum of squares in row order, one add at a time (numpy's
// axis-0 reduction of a C-contiguous (N, M0) array, M0 >= 2), then its
// square root. Every thread loads the next tile while the chain threads
// sum the current one
__global__ void __launch_bounds__(kSumThreads)
seeded_column_norms(const double* w, long long N, long long M0,
                    double* norms) {
  __shared__ double buf[2][kSumRows][kSumCols];
  const long long j0 = static_cast<long long>(blockIdx.x) * kSumCols;
  const int cols = static_cast<int>(min(static_cast<long long>(kSumCols), M0 - j0));
  const int tid = threadIdx.x;
  const long long tiles = (N + kSumRows - 1) / kSumRows;
  double regs[kSumLoads];
  auto load = [&](long long tile) {
#pragma unroll
    for (int i = 0; i < kSumLoads; ++i) {
      const int q = tid + i * kSumThreads;
      const long long r = tile * kSumRows + q / kSumCols;
      const int j = q % kSumCols;
      regs[i] = (r < N && j < cols) ? w[r * M0 + j0 + j] : 0.0;
    }
  };
  auto store = [&](int b) {
#pragma unroll
    for (int i = 0; i < kSumLoads; ++i) {
      const int q = tid + i * kSumThreads;
      buf[b][q / kSumCols][q % kSumCols] = regs[i];
    }
  };
  load(0);
  store(0);
  __syncthreads();
  double acc = 0.0;
  for (long long tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) load(tile + 1);
    if (tid < cols) {
      const int rows = static_cast<int>(
          min(static_cast<long long>(kSumRows), N - tile * kSumRows));
      const double(*cur)[kSumCols] = buf[tile & 1];
      for (int r = 0; r < rows; ++r) {
        const double v = cur[r][tid];
        acc = __dadd_rn(acc, __dmul_rn(v, v));
      }
    }
    if (tile + 1 < tiles) store((tile + 1) & 1);
    __syncthreads();
  }
  if (tid < cols) norms[j0 + tid] = __dsqrt_rn(acc);
}

// numpy's pairwise_sum (loops_utils.h) over the squares of a[0..n)
__device__ double pairwise_squares(const double* a, long long n) {
  if (n < 8) {
    double res = 0.0;
    for (long long i = 0; i < n; ++i) res = __dadd_rn(res, __dmul_rn(a[i], a[i]));
    return res;
  }
  if (n <= 128) {
    double r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = __dmul_rn(a[j], a[j]);
    long long i = 8;
    for (; i < n - (n % 8); i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], __dmul_rn(a[i + j], a[i + j]));
    }
    double res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                           __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
    for (; i < n; ++i) res = __dadd_rn(res, __dmul_rn(a[i], a[i]));
    return res;
  }
  long long n2 = n / 2;
  n2 -= n2 % 8;
  return __dadd_rn(pairwise_squares(a, n2), pairwise_squares(a + n2, n - n2));
}

constexpr int kPairThreads = 128;

// M0 = 1: numpy reduces the contiguous column in blocks of its buffer
// size, pairwise inside a block, the blocks' sums added in order
__global__ void __launch_bounds__(kPairThreads)
seeded_pairwise_blocks(const double* w, long long N, long long block,
                       double* partial) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kPairThreads + threadIdx.x;
  if (b * block >= N) return;
  partial[b] = pairwise_squares(w + b * block, min(block, N - b * block));
}

__global__ void seeded_pairwise_norm(const double* partial, long long blocks,
                                     double* norms) {
  double acc = 0.0;
  for (long long b = 0; b < blocks; ++b) acc = __dadd_rn(acc, partial[b]);
  norms[0] = __dsqrt_rn(acc);
}

constexpr int kScaleCols = 32, kScaleRows = 8;
constexpr long long kScaleBlocks = 132LL * 16;

__global__ void __launch_bounds__(kScaleCols * kScaleRows)
seeded_scale(double* w, long long N, long long M0, const double* norms) {
  for (long long r = static_cast<long long>(blockIdx.x) * kScaleRows + threadIdx.y;
       r < N; r += static_cast<long long>(gridDim.x) * kScaleRows) {
    for (long long j = threadIdx.x; j < M0; j += kScaleCols) {
      double* v = w + r * M0 + j;
      *v = static_cast<double>(__double2float_rn(__ddiv_rn(*v, norms[j])));
    }
  }
}

// the edges of log1p's and exp's branches, after the stream's uniforms
__device__ const double kLog1pEdges[] = {
    -0.0, 0.0, -0x1.0p-60, -0x1.0p-54, -0x1.0p-53, -0x1.0p-30, -0x1.0p-29,
    -0x1.0p-20, -0.29289, -0.2929, -0.5, -0.5 + 0x1.0p-40, -0.75,
    -(1.0 - 0x1.0p-53), 0x1.0p-40, 0.41421, 0.41422, 0.5, 1.0, 3.0, 1e300};
__device__ const double kExpEdges[] = {
    -0.0, 0.0, -0x1.0p-60, -0x1.0p-55, -0x1.0p-54, -0x1.0p-53, -1e-300,
    -0x1.0p-9, -0.00270760617, -0.00270760618, -0.5, -1.0, -0.6931471805599453,
    -3.0, -6.676414, -6.7, 0.5, 1.0, 20.0, -20.0, -511.0};
constexpr int kLog1pEdgeCount = sizeof(kLog1pEdges) / sizeof(double);
constexpr int kExpEdgeCount = sizeof(kExpEdges) / sizeof(double);
constexpr int kProbeEdgeCount =
    kLog1pEdgeCount > kExpEdgeCount ? kLog1pEdgeCount : kExpEdgeCount;

// at i < n the stream's uniform U at position i: lx = -U (as the tail
// negates it), ex = -x^2 / 2 for x = R U (as the wedge test squares it);
// then the edges (the shorter list's last repeated); ly, ey the card's
// log1p and exp of them
__global__ void seeded_libm_probe(U128 s0, U128 inc, long long n, double* lx,
                                  double* ly, double* ex, double* ey) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n + kProbeEdgeCount) return;
  double l, e;
  if (i < n) {
    Stream g(s0, inc, static_cast<u64>(i));
    const double u = g.next_double();
    const double x = __dmul_rn(NPY_ZIGGURAT_NOR_R, u);
    l = -u;
    e = __dmul_rn(__dmul_rn(-0.5, x), x);
  } else {
    const long long j = i - n;
    l = kLog1pEdges[min(j, static_cast<long long>(kLog1pEdgeCount - 1))];
    e = kExpEdges[min(j, static_cast<long long>(kExpEdgeCount - 1))];
  }
  lx[i] = l;
  ly[i] = log1p_glibc_fma(l);
  ex[i] = e;
  ey[i] = exp_glibc_fma(e);
}

unsigned int blocks_for(long long work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}

}  // namespace

extern "C" {

// The draw of N * M0 normals into `out` (row-major (N, M0) float64) and
// its normalisation. `chunks` chunks of `chunk` stream positions, maps of
// `entries` entry offsets, walked in groups of `group` chunks; `block` is
// numpy's buffer size (read where M0 = 1). Scratch, from the wrapper:
// maps (chunks * entries int2), group_* (groups * entries, then groups,
// int64), entry and base (chunks int64), norms (M0 float64), partial
// (ceil(N / block) float64, where M0 = 1).
int seeded_draw_f64(u64 s_lo, u64 s_hi, u64 inc_lo, u64 inc_hi, long long N,
                    long long M0, long long chunk, long long entries,
                    long long chunks, long long group, long long block,
                    int2* maps, long long* group_count, long long* group_exit,
                    long long* group_entry, long long* group_base,
                    long long* entry, long long* base, double* norms,
                    double* partial, double* out, void* stream) {
  if (N <= 0 || M0 <= 0 || chunk <= 0 || entries <= 0 || entries > chunk ||
      chunks <= 0 || group <= 0 || block <= 0 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  p.s0 = U128{s_lo, s_hi};
  p.inc = U128{inc_lo, inc_hi};
  p.n = N * M0;
  p.chunk = chunk;
  p.entries = entries;
  p.chunks = chunks;
  p.group = group;
  p.groups = (chunks + group - 1) / group;
  seeded_chunk_maps<<<blocks_for(chunks * entries, kMapThreads), kMapThreads,
                      0, st>>>(p, maps);
  seeded_walk<<<1, kWalkThreads, 0, st>>>(p, maps, group_count, group_exit,
                                          group_entry, group_base, entry,
                                          base);
  seeded_emit<<<blocks_for(chunks, kMapThreads), kMapThreads, 0, st>>>(
      p, entry, base, out);
  if (M0 >= 2) {
    seeded_column_norms<<<blocks_for(M0, kSumCols), kSumThreads, 0, st>>>(
        out, N, M0, norms);
  } else {
    const long long blocks = (N + block - 1) / block;
    seeded_pairwise_blocks<<<blocks_for(blocks, kPairThreads), kPairThreads,
                             0, st>>>(out, N, block, partial);
    seeded_pairwise_norm<<<1, 1, 0, st>>>(partial, blocks, norms);
  }
  const long long rows = (N + kScaleRows - 1) / kScaleRows;
  seeded_scale<<<static_cast<unsigned int>(min(rows, kScaleBlocks)),
                 dim3(kScaleCols, kScaleRows), 0, st>>>(out, N, M0, norms);
  return static_cast<int>(cudaGetLastError());
}

// The inputs of the wrapper's check of log1p and exp against the host's:
// n uniforms of the stream (s, inc), then the edges of their branches
int seeded_libm_probe_edges() { return kProbeEdgeCount; }

// log1p_xy: x then log1p_glibc_fma(x), exp_xy: x then exp_glibc_fma(x),
// each x n + seeded_libm_probe_edges() long
int seeded_libm_probe_f64(u64 s_lo, u64 s_hi, u64 inc_lo, u64 inc_hi,
                          long long n, double* log1p_xy, double* exp_xy,
                          void* stream) {
  if (n < 0 || log1p_xy == nullptr || exp_xy == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = n + kProbeEdgeCount;
  seeded_libm_probe<<<blocks_for(total, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      U128{s_lo, s_hi}, U128{inc_lo, inc_hi}, n, log1p_xy, log1p_xy + total,
      exp_xy, exp_xy + total);
  return static_cast<int>(cudaGetLastError());
}

const char* seeded_draw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
