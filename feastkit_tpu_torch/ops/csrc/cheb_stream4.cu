// Two or four fused Chebyshev steps per pass for Hopper (sm_90a), as
// streamed strips: cheb_step2_f32, cheb_step2_f64, cheb_step4_f32 and
// cheb_step4_f64.
//
// Replaces the Pallas TPU kernels of feastkit_tpu/ops/cheb_pallas.py
//   cheb_step2_f32 <- _cheb_f32_2_kernel (body :749, pallas_call :799)
//   cheb_step2_f64 <- _cheb_ds2_kernel   (body :370, pallas_call :449)
//   cheb_step4_f32 <- _cheb_f32_4_kernel (body :847, pallas_call :916)
//   cheb_step4_f64 <- _cheb_ds4_kernel   (body :522, pallas_call :630)
// (the double-single kernels become native fp64 here, as in cheb_step.cu).
// Column-major (M, N) carries, row-aligned DIA diagonals (nd, N) with
// offsets off_k, S = 2 or 4 steps:
//
//   for s in 0..S-1:
//     T_{s+2}[i] = 2 (sc sum_k diags[k, i] T_{s+1}[i + off_k] - sh T_{s+1}[i])
//                  - T_s[i]          (terms with i + off_k outside [0, N)
//                                     are skipped)
//   acc[i] = ((acc[i] + c_0 T_2[i]) + c_1 T_3[i]) ...  + c_{S-1} T_{S+1}[i]
//   out0 = T_S, out1 = T_{S+1}       (T0 and T1 are left as they are)
//
// What bounds it on this card: device memory. A pass must move 6 planes
// (T0, T1 and acc read; T_S, T_{S+1} and acc written) and the diagonals
// once: 6 sizeof(T) B per element plus nd sizeof(T) B per row; its
// arithmetic, S (2 nd + 6) operations per element, is far below the ridge
// in both types. An overlapped-tile body (one column's tile per block, the
// intermediate levels recomputed on halos) reloads all nd diagonals through
// L1/L2 for every row of every level of every column: 155 B per element
// requested at the main shapes for four f32 steps against the 24 B the
// bound counts, and 394 B in fp64 against 48.
//
// This body is the TPU kernel's sequential ring discipline done inside one
// block. A block of 256 threads owns a strip of `tile` rows for a group of
// COLS columns (1, 2 or 4 in f32, 1 or 2 in fp64, a template parameter; the
// widest whose rings fit) and walks down it in chunks of 256 rows, one
// thread per row. Level s (computing T_{s+2}) trails level s-1 by
// L = 1 + ceil(halo / 256) chunks, so at every iteration the S levels
// work on S different chunks whose inputs were all finished in earlier
// iterations: one __syncthreads per iteration, no drain inside the strip.
// The levels live in shared-memory rings, indexed by chunk mod ring length
// (ring_len below):
//
//   S = 4:  T1  2L+1 chunks   level 0's stencil source and level 1's prev
//           T2  3L+1 chunks   level 1's source, level 2's prev, and read
//                             once more by level 3 for acc (so acc is summed
//                             in the plain version's order, read and
//                             written once per row)
//           T3  2L+1 chunks   level 2's source, level 3's prev
//           T4  2L   chunks   level 3's source
//   S = 2:  T1  2L+1 chunks   level 0's source, level 1's prev
//           T2  2L   chunks   level 1's source, read at its own row for acc
//
// (the ring lengths make every slot written in an iteration differ from
// every slot read in it, so the levels need no barrier between them).
// Halo rows are recomputed only at a strip's two ends: level s covers the
// strip's own chunks plus (S-1-s) ceil(halo/256) chunks each side, clipped
// to the matrix. A ring row holds the group's columns side by side, so one
// shared-memory access of up to 16 bytes (4 f32 or 2 fp64 columns) reads
// or writes a row of all of them, and a thread loads each diagonal once
// per (row, level) and applies it to all its columns from a register: a
// block reads the diagonals of a row S times for COLS columns, not
// (S + recompute) COLS times as a tiled body does.
//
// The grid is strips x column groups, the group the fast index, so the
// blocks of one strip read the same diagonals at about the same time,
// from L2: one wave of resident blocks at the main shapes in f32, several
// where the plan cuts the strips finer than one wave because the groups
// alone would leave multiprocessors idle (36 fp64 groups of 2 columns
// fill 108 of 132 SMs in one wave; 396 blocks fill all of them in 3).
//
// What limits it: few resident blocks of 256 threads per multiprocessor
// (the rings take much of its shared memory; one for the four-step f32
// shapes of the main path) leave few warps to hide latency, so the loop is
// bound by the instructions a thread issues per iteration as much as by
// the bytes it moves. So, besides the vector ring rows:
// - the global loads an iteration needs (T1 for the T1 ring, T0 for level
//   0, acc for the last level and, where the registers allow, each level's
//   diagonals) are issued one iteration ahead into registers, in flight
//   during the previous iteration's arithmetic; stores are coalesced and
//   never waited on. A variant (ASYNC: four steps, f32, 4 columns and five
//   or nine diagonals; `depth` > 0 in the plan) brings T1, T0 and acc in
//   with cp.async instead, `depth` iterations ahead, into a ring of
//   depth + 1 stage slots after the level rings; chip_smoke.py
//   --stream-sweep times it against the register prefetch, which the plan
//   uses;
// - the body computes all levels first (every ring read, no store in
//   between) and then stores them, so the compiler keeps the ring reads of
//   all levels in flight together;
// - a steady iteration (all levels inside their ranges, no row of their
//   chunks with a neighbour outside the matrix, a full column group: all
//   but a few iterations at each end of a strip) runs a copy of the body
//   with no mask, no range test and no select, and its fetch the same way;
//   the stencil sums with fused multiply-adds;
// - every ring position (each level's source, prev and destination, and
//   for five, seven and nine diagonals each neighbour) advances by one
//   chunk per iteration with one compare, no division; global addresses
//   are a column group's base plus a 32-bit offset.
// A warp covers 32 consecutive rows, so global accesses are coalesced and
// ring accesses are free of bank conflicts.
//
// The register budget a thread has (Budget below) follows from how many
// blocks should share a multiprocessor, and an fp64 value takes two
// registers: the diagonals are prefetched only where two iterations' worth
// of them (2 S ND values) take at most a third of that budget.
//
// The diagonal count is a template parameter for the five-point (the main
// path), the seven-point (the 3D Laplacian) and the nine-point (the
// consistent-mass pencils) stencils, with a run-time count for every other
// operator; -DCHEB_RUNTIME_COUNT_ONLY builds the run-time-count body
// only. The element type and the step count are template parameters.
//
// Plain C interface (bound with ctypes). The entry points launch on the
// given stream, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxDiags = 32;     // bcoo_to_dia keeps at most 32 diagonals
constexpr int kChunk = 256;       // R: rows per chunk, threads per block
constexpr long long kMaxSharedBytes = 232448;   // 227 KB, sm_90 opt-in

struct DiaOffsets {
  int v[kMaxDiags];
};

template <typename T>
struct Coeffs {
  T v[4];
};

// One row of a column group in a ring: the group's columns side by side,
// so that one shared-memory access (up to 16 bytes) serves all of them.
template <typename T, int C>
struct alignas(sizeof(T) * C) Row {
  T v[C];
};

// The launch plan (ops/cheb_kernels.py, multistep_plan; the column
// group's width is COLS).
struct Plan {
  int n, m;      // rows, columns
  int groups;    // column groups, ceil(m / COLS)
  int tile;      // strip rows (a multiple of R)
  int lag;       // L = 1 + ceil(halo / R)
  int halo;      // max |offset| of the diagonals inside the matrix
  int depth;     // ASYNC: iterations of copies in flight (1..8)
};

// The length in chunks of ring r (holding T_{r+1}) for S steps at lag L:
// from the chunk written in an iteration back to the oldest chunk read in
// it, plus one. T1 is written L chunks ahead of level 0 and read by level
// 1 as its prev 2 L behind that; T2 is read 3 L behind its write by the
// last of four levels for acc; an inner ring by the next level's prev 2 L
// behind; the last ring only by its level's stencil, 2 L - 1 behind.
template <int S>
__host__ __device__ __forceinline__ int ring_len(int r, int lag) {
  return r == 0       ? 2 * lag + 1
         : r == S - 1 ? 2 * lag
         : r == 1     ? (S - 1) * lag + 1
                      : 2 * lag + 1;
}

// The 32-bit registers a thread may use: 64 K over the 256 threads of
// each block that should share a multiprocessor. Four steps: as many as
// the rings' shared memory lets in at the widest halo of the block shape,
// f32 4 / COLS; fp64 1 (a 1-column fp64 block could share its SM only at
// halos up to 1024 rows, and its run-time-count body spills within 128
// registers). Two steps (rings of 4 L + 1 chunks, not 9 L + 3): 2 in both
// types, 128 registers, the two levels' values with their positions and
// loads in flight. A value of T takes kWords registers.
template <typename T, int COLS, int S>
struct Budget {
  static constexpr int kWords = static_cast<int>(sizeof(T) / 4);
  static constexpr int kMinBlocks = S == 2 ? 2 : kWords == 1 ? 4 / COLS : 1;
  static constexpr int kRegs = 65536 / (kChunk * kMinBlocks);
};

// one element from device memory into shared memory, asynchronously; with
// valid false nothing is read and the element is zero
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)), "r"(valid ? int(sizeof(T)) : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0..7) of this thread's groups are in flight
__device__ __forceinline__ void copy_wait(int pending) {
  switch (pending) {
#define CHEB_WAIT(N)                                                      \
  case N:                                                                 \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory");          \
    break;
    CHEB_WAIT(0) CHEB_WAIT(1) CHEB_WAIT(2) CHEB_WAIT(3) CHEB_WAIT(4)
    CHEB_WAIT(5) CHEB_WAIT(6)
#undef CHEB_WAIT
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

template <typename T, int S, int ND, int COLS, bool ASYNC>
__global__ void __launch_bounds__(kChunk, Budget<T, COLS, S>::kMinBlocks)
cheb_stream_kernel(const T* __restrict__ diags, DiaOffsets offs, int nd_rt,
                   const T* __restrict__ t0, const T* __restrict__ t1,
                   T* __restrict__ acc, T* __restrict__ out0,
                   T* __restrict__ out1, Plan pl, T sc, T sh, Coeffs<T> ck) {
  static_assert(S == 2 || S == 4, "two or four steps");
  static_assert(!ASYNC || S == 4, "the cp.async variant takes four steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the diagonals are fetched an iteration ahead where two iterations' S
  // ND values take at most a third of the thread's register budget, else
  // loaded at use
  using B = Budget<T, COLS, S>;
  constexpr bool kFetchD = ND > 0 && 2 * S * ND * B::kWords <= B::kRegs / 3;
  constexpr int kPre = kFetchD ? ND : 1;
  constexpr int R = kChunk;
  constexpr int kLast = S - 1;
  using RowT = Row<T, COLS>;
  const int n = pl.n;
  const int L = pl.lag;
  const int H = L - 1;   // halo in chunks
  // ring lengths (chunks) of T1..T_S, their spans and offsets (rows; a row
  // holds the group's columns)
  int len[S], span[S];
  RowT* ring[S];
  {
    RowT* next = reinterpret_cast<RowT*>(smem_raw);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      len[r] = ring_len<S>(r, L);
      span[r] = len[r] * R;
      ring[r] = next;
      next += span[r];
    }
  }

  // the column group is the fast grid index: the blocks of one strip read
  // the same diagonals at about the same time, from L2
  const int group = static_cast<int>(blockIdx.x) % pl.groups;
  const int strip = static_cast<int>(blockIdx.x) / pl.groups;
  const int p = static_cast<int>(threadIdx.x);
  const int col0 = group * COLS;
  const int ncols = min(COLS, pl.m - col0);
  const long long cbase = static_cast<long long>(col0) * n;

  // own rows [s0, own_end); chunk c of the strip holds rows s0 + c R + [0, R)
  const int s0 = strip * pl.tile;
  const int own_end = min(s0 + pl.tile, n);
  const int k_own = (own_end - s0 + R - 1) / R;
  const int k_max = (n - s0 + R - 1) / R;
  const int top = s0 / R;
  // level s computes chunks [lo[s], hi[s]): the own chunks and (S-1-s) H
  // more each side, clipped to the matrix
  int lo[S], hi[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    lo[s] = max(-(kLast - s) * H, -top);
    hi[s] = min(k_own + (kLast - s) * H, k_max);
  }
  const int base = lo[0] - H;            // chunk c sits in slot (c - base) mod len
  const int c_end = hi[kLast] + kLast * L;   // level 0's chunk index ends here

  auto in_rows = [n](int row) {
    return static_cast<unsigned>(row) < static_cast<unsigned>(n);
  };
  // the planes of the block's column group; column j of a plane at
  // element j n (+ row), in unsigned 32-bit arithmetic (4 n < 2^32)
  const T* const t0b = t0 + cbase;
  const T* const t1b = t1 + cbase;
  T* const accb = acc + cbase;
  T* const o0b = out0 + cbase;
  T* const o1b = out1 + cbase;
  auto at_col = [n](int j, int row) {
    return static_cast<unsigned>(j) * static_cast<unsigned>(n) +
           static_cast<unsigned>(row);
  };
  const bool full = ncols == COLS;
  // this thread's row of chunk c in ring r (c may precede base for a level
  // before its range)
  auto at = [&](int r, int c) {
    return (((c - base) % len[r] + len[r]) % len[r]) * R + p;
  };
  // the row off away from the row at pos in ring r (|off| < a ring's span)
  auto neighbour = [&](int r, int pos, int off) {
    int q = pos + off;
    q += q < 0 ? span[r] : 0;
    q -= q >= span[r] ? span[r] : 0;
    return q;
  };

  // ASYNC: depth + 1 stage slots after the rings, each the T1, T0 and acc
  // chunks of one iteration (3 R rows); a thread copies and reads only its
  // own row of each, so cp.async.wait_group orders them without a barrier
  RowT* const stage = ring[kLast] + span[kLast];
  const int slots = pl.depth + 1;
  auto issue = [&](int c0, int slot) {
    if (c0 < c_end) {
      const int r0 = s0 + c0 * R + p;
      const int r1 = r0 + L * R;
      const int r3 = r0 - kLast * L * R;
      const int c3 = c0 - kLast * L;
      const bool g1 = c0 + L < hi[0] + H && in_rows(r1);
      const bool g0 = c0 < hi[0] && in_rows(r0);
      const bool g3 = c3 >= lo[kLast] && c3 < hi[kLast] && in_rows(r3);
      RowT* const dst = stage + slot * 3 * R + p;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const bool on = j < ncols;
        copy_async(&dst[0].v[j], on && g1 ? t1b + at_col(j, r1) : t1b,
                   on && g1);
        copy_async(&dst[R].v[j], on && g0 ? t0b + at_col(j, r0) : t0b,
                   on && g0);
        copy_async(&dst[2 * R].v[j], on && g3 ? accb + at_col(j, r3) : accb,
                   on && g3);
      }
    }
    copy_commit();   // one group per iteration, empty past the strip's end
  };
  int rd_slot = 0, wr_slot = pl.depth;
  if constexpr (ASYNC) {
    for (int i = 0; i < pl.depth; ++i) issue(lo[0] + i, i);
  }

  // T1 chunks [lo0 - H, lo0 + H] before the first iteration (a column the
  // group lacks is zero)
  for (int c = lo[0] - H; c <= lo[0] + H; ++c) {
    const int row = s0 + c * R + p;
    const bool on = c < hi[0] + H && in_rows(row);
    RowT w;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      w.v[j] = on && j < ncols ? __ldg(t1b + at_col(j, row)) : T(0);
    }
    ring[0][at(0, c)] = w;
  }

  // what iteration c0 reads from device memory, fetched one iteration
  // ahead: T1 chunk c0 + L (stored into its ring at the iteration's end),
  // T0 chunk c0 (level 0's prev), acc chunk c0 - (S-1) L (the last level)
  // and each level's diagonals. `inside`: every row of those chunks lies
  // in the matrix and the group is full, so nothing is masked (a chunk no
  // level needs is then loaded and never used)
  T t1n[COLS], t0n[COLS], accn[COLS], dn[S][kPre];
  auto fetch = [&](int c0, auto inside) {
    constexpr bool kIn = decltype(inside)::value;
    const int r0 = s0 + c0 * R + p;
    const int r1 = r0 + L * R;
    const int r3 = r0 - kLast * L * R;
    const int c3 = c0 - kLast * L;
    const bool g1 = kIn || (c0 + L < hi[0] + H && in_rows(r1));
    const bool g0 = kIn || (c0 < hi[0] && in_rows(r0));
    const bool g3 = kIn || (c3 >= lo[kLast] && c3 < hi[kLast] && in_rows(r3));
    if constexpr (!ASYNC) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const bool on = kIn || j < ncols;
        t1n[j] = on && g1 ? __ldg(t1b + at_col(j, r1)) : T(0);
        t0n[j] = on && g0 ? __ldg(t0b + at_col(j, r0)) : T(0);
        accn[j] = on && g3 ? __ldg(accb + at_col(j, r3)) : T(0);
      }
    }
    if constexpr (kFetchD) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int row = r0 - s * L * R;
        const bool ok = kIn || in_rows(row);
        const T* const diag_row = diags + row;
#pragma unroll
        for (int k = 0; k < kPre; ++k) {
          dn[s][k] = ok ? __ldg(diag_row + static_cast<long long>(k) * n)
                        : T(0);
        }
      }
    }
  };
  auto fetch_inside = [&](int c0) {
    return full && s0 + (c0 - kLast * L) * R >= 0 &&
           s0 + (c0 + L + 1) * R <= n;
  };

  // ring positions of this thread's row, for the chunks the levels of
  // iteration c0 touch; each advances one chunk per iteration
  int psrc[S], pprv[S], pdst[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int c = lo[0] - s * L;
    psrc[s] = at(s, c);                            // T_{s+1}, the source
    pprv[s] = at(s > 0 ? s - 1 : 0, c);            // T_s, the prev (s >= 1)
    pdst[s] = at(s < kLast ? s + 1 : kLast, c);    // T_{s+2} (s < S-1)
  }
  // four steps: T2 of the last level's chunk (two: that is its source)
  int pt2 = at(1, lo[0] - kLast * L);
  int pst = at(0, lo[0] + L);             // T1 chunk stored this iteration
  // for five, seven and nine diagonals, each neighbour's position too
  constexpr int kQ = ND > 0 ? ND : 1;
  int qn[S][kQ];
  if constexpr (ND > 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        qn[s][k] = neighbour(s, psrc[s], offs.v[k]);
      }
    }
  }
  auto advance = [&](int& pos, int r) {
    pos += R;
    pos -= pos >= span[r] ? span[r] : 0;
  };

  T t1c[COLS], t0c[COLS], accc[COLS], dc[S][kPre];
  // one iteration's arithmetic and stores. `steady`: all levels are inside
  // their ranges, no row of their chunks has a neighbour outside the matrix
  // and the group is full, so nothing is masked
  auto step = [&](int c0, auto steady) {
    constexpr bool kSt = decltype(steady)::value;
    // all levels, all columns: reads and arithmetic only
    T v[S][COLS], a[COLS];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int first = s0 + (c0 - s * L) * R;
      const int row = first + p;
      const int pos = psrc[s];
      // with a neighbour outside the matrix, the term is dropped (its load
      // reads the row itself, finite, with a zero weight)
      const bool masked =
          !kSt && !(first - pl.halo >= 0 && first + R - 1 + pl.halo < n);
      // the stencil sum of every column, one diagonal at a time in the
      // plain version's order, the diagonal held in a register
      T y[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) y[j] = T(0);
      auto term = [&](int k, T dk, int q) {
        const int off = offs.v[k];
        if (masked) {
          const bool ok = in_rows(row + off);
          dk = ok ? dk : T(0);
          q = ok ? q : pos;
        }
        const RowT x = ring[s][q];
#pragma unroll
        for (int j = 0; j < COLS; ++j) y[j] = fma(dk, x.v[j], y[j]);
      };
      if constexpr (ND > 0) {
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          T dk;
          if constexpr (kFetchD) {
            dk = dc[s][k];
          } else {
            dk = kSt || in_rows(row)
                     ? __ldg(diags + static_cast<long long>(k) * n + row)
                     : T(0);
          }
          term(k, dk, qn[s][k]);
        }
      } else {
        // a run-time count: the level's diagonals loaded a batch at a time,
        // all of a batch first so that their latencies overlap, then its
        // terms (bounded by kMaxDiags; one batch in four-step f32, batches
        // of 16 in fp64 and in two-step f32, where 32 values would not fit
        // the registers beside the rest, each after the first only where
        // the count reaches it)
        constexpr int kBatch =
            kMaxDiags / (S == 4 ? B::kWords : 2);
        const bool live = in_rows(row);
#pragma unroll
        for (int k0 = 0; k0 < kMaxDiags; k0 += kBatch) {
          if (k0 > 0 && k0 >= nd_rt) break;   // uniform
          T d[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            d[k] = live && k0 + k < nd_rt
                       ? __ldg(diags + static_cast<long long>(k0 + k) * n +
                               row)
                       : T(0);
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            if (k0 + k < nd_rt) {
              term(k0 + k, d[k], neighbour(s, pos, offs.v[k0 + k]));
            }
          }
        }
      }
      const RowT center = ring[s][pos];
      RowT prev;
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) prev.v[j] = t0c[j];
      } else {
        prev = ring[s > 0 ? s - 1 : 0][pprv[s]];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        v[s][j] = T(2) * (sc * y[j] - sh * center.v[j]) - prev.v[j];
      }
      if (s == kLast) {
        if constexpr (S == 4) {
          // T2, T3 (= prev) and T4 (= center) of the row, then T5
          const RowT t2 = ring[1][pt2];
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            a[j] = (((accc[j] + ck.v[0] * t2.v[j]) + ck.v[1] * prev.v[j]) +
                    ck.v[2] * center.v[j]) + ck.v[3] * v[s][j];
          }
        } else {
          // T2 (= center) of the row, then T3
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            a[j] = (accc[j] + ck.v[0] * center.v[j]) + ck.v[1] * v[s][j];
          }
        }
      }
    }
    // then the stores of the levels inside their ranges
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = c0 - s * L;
      if (!kSt && (c < lo[s] || c >= hi[s])) continue;   // uniform
      const int row = s0 + c * R + p;            // >= 0: lo[s] >= -top
      const bool live = kSt || row < n;
      if (s < kLast) {
        RowT w;
#pragma unroll
        for (int j = 0; j < COLS; ++j) w.v[j] = v[s][j];
        ring[s < kLast ? s + 1 : kLast][pdst[s]] = w;
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (!kSt && j >= ncols) continue;
        const unsigned g = at_col(j, row);
        if (s == kLast - 1 && live && c >= 0 && c < k_own) o0b[g] = v[s][j];
        if (s == kLast && live) {
          accb[g] = a[j];
          o1b[g] = v[s][j];
        }
      }
    }
  };
  auto steady_at = [&](int c0) {
    bool in = full && s0 + (c0 - kLast * L) * R - pl.halo >= 0 &&
              s0 + (c0 + 1) * R + pl.halo <= n;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      in = in && c0 - s * L >= lo[s] && c0 - s * L < hi[s];
    }
    return in;
  };

  if (fetch_inside(lo[0])) {
    fetch(lo[0], std::true_type{});
  } else {
    fetch(lo[0], std::false_type{});
  }
  __syncthreads();

  for (int c0 = lo[0]; c0 < c_end; ++c0) {
    if constexpr (ASYNC) {
      // this thread's copies of iteration c0 have landed; then the copies
      // of iteration c0 + depth go out
      copy_wait(pl.depth - 1);
      const RowT* const got = stage + rd_slot * 3 * R + p;
      const RowT w1 = got[0], w0 = got[R], wa = got[2 * R];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        t1c[j] = w1.v[j];
        t0c[j] = w0.v[j];
        accc[j] = wa.v[j];
      }
      issue(c0 + pl.depth, wr_slot);
      rd_slot = rd_slot + 1 == slots ? 0 : rd_slot + 1;
      wr_slot = wr_slot + 1 == slots ? 0 : wr_slot + 1;
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        t1c[j] = t1n[j];
        t0c[j] = t0n[j];
        accc[j] = accn[j];
      }
    }
    if constexpr (kFetchD) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int k = 0; k < kPre; ++k) dc[s][k] = dn[s][k];
      }
    }
    if (c0 + 1 < c_end) {
      if (fetch_inside(c0 + 1)) {
        fetch(c0 + 1, std::true_type{});
      } else {
        fetch(c0 + 1, std::false_type{});
      }
    }
    if (steady_at(c0)) {
      step(c0, std::true_type{});
    } else {
      step(c0, std::false_type{});
    }
    // T1 chunk c0 + L into its ring: read from the next iteration on
    {
      RowT w;
#pragma unroll
      for (int j = 0; j < COLS; ++j) w.v[j] = t1c[j];
      ring[0][pst] = w;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      advance(psrc[s], s);
      if (s > 0) advance(pprv[s], s - 1);
      if (s < kLast) advance(pdst[s], s + 1);
      if constexpr (ND > 0) {
#pragma unroll
        for (int k = 0; k < kQ; ++k) advance(qn[s][k], s);
      }
    }
    if constexpr (S == 4) advance(pt2, 1);
    advance(pst, 0);
    __syncthreads();
  }
}

template <typename T, int S, int ND, int COLS, bool ASYNC>
int launch_nd(const T* diags, const DiaOffsets& offs, int nd, const T* t0,
              const T* t1, T* acc, T* out0, T* out1, const Plan& pl,
              int threads, unsigned int blocks, size_t bytes, T sc, T sh,
              Coeffs<T> ck, cudaStream_t st) {
  auto kernel = cheb_stream_kernel<T, S, ND, COLS, ASYNC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks), dim3(threads), bytes, st>>>(
      diags, offs, nd, t0, t1, acc, out0, out1, pl, sc, sh, ck);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S, int COLS>
int launch_cols(const T* diags, const DiaOffsets& offs, int nd, const T* t0,
                const T* t1, T* acc, T* out0, T* out1, const Plan& pl,
                int threads, unsigned int blocks, size_t bytes, T sc, T sh,
                Coeffs<T> ck, cudaStream_t st) {
#define CHEB_LAUNCH(ND, ASYNC)                                               \
  launch_nd<T, S, ND, COLS, ASYNC>(diags, offs, nd, t0, t1, acc, out0, out1, \
                                   pl, threads, blocks, bytes, sc, sh, ck,   \
                                   st)
#ifdef CHEB_RUNTIME_COUNT_ONLY
  if (pl.depth > 0) return static_cast<int>(cudaErrorInvalidValue);
  return CHEB_LAUNCH(0, false);
#else
  if (pl.depth > 0) {
    // the cp.async variant: four steps, f32, four columns, five or nine
    // diagonals
    if constexpr (S == 4 && COLS == 4 && std::is_same_v<T, float>) {
      if (nd == 5) return CHEB_LAUNCH(5, true);
      if (nd == 9) return CHEB_LAUNCH(9, true);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return nd == 5   ? CHEB_LAUNCH(5, false)
         : nd == 7 ? CHEB_LAUNCH(7, false)
         : nd == 9 ? CHEB_LAUNCH(9, false)
                   : CHEB_LAUNCH(0, false);
#endif
#undef CHEB_LAUNCH
}

template <typename T, int S>
int launch(const T* diags, const long long* offsets, int nd, const T* t0,
           const T* t1, T* acc, T* out0, T* out1, long long n, long long m,
           long long chunk, long long cols, long long tile, long long depth,
           T sc, T sh, Coeffs<T> ck, void* stream) {
  // fp64 takes 1 or 2 columns per block (a ring row of 16 bytes at most)
  const bool cols_ok =
      cols == 1 || cols == 2 || (cols == 4 && sizeof(T) == 4);
  if (nd < 0 || nd > kMaxDiags || n < 0 || m < 0 || chunk != kChunk ||
      !cols_ok || tile <= 0 || tile % chunk != 0 || depth < 0 || depth > 8 ||
      (S != 4 && depth != 0)) {
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
  const long long lag = 1 + (halo + chunk - 1) / chunk;
  const long long groups = (m + cols - 1) / cols;
  const long long strips = (n + tile - 1) / tile;
  // the level rings per column (9 L + 3 chunks for four steps, 4 L + 1 for
  // two) and the stage slots
  long long ring_chunks = depth > 0 ? 3 * (depth + 1) : 0;
  for (int r = 0; r < S; ++r) {
    ring_chunks += ring_len<S>(r, static_cast<int>(lag));
  }
  const long long bytes =
      cols * ring_chunks * chunk * static_cast<long long>(sizeof(T));
  // row indices (a strip's chunks with the levels' lags, plus an offset)
  // must fit an int, and so must the block count
  if (bytes > kMaxSharedBytes || n + tile > 0x7fffffffLL ||
      2 * n + (2 * S * lag + 4) * chunk > 0x7fffffffLL ||
      groups > 0x7fffffffLL / strips) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = {static_cast<int>(n),    static_cast<int>(m),
                   static_cast<int>(groups), static_cast<int>(tile),
                   static_cast<int>(lag),  static_cast<int>(halo),
                   static_cast<int>(depth)};
  const int threads = static_cast<int>(chunk);
  const unsigned int blocks = static_cast<unsigned int>(strips * groups);
  const size_t sbytes = static_cast<size_t>(bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 1:
      return launch_cols<T, S, 1>(diags, offs, nd, t0, t1, acc, out0, out1,
                                  pl, threads, blocks, sbytes, sc, sh, ck,
                                  st);
    case 2:
      return launch_cols<T, S, 2>(diags, offs, nd, t0, t1, acc, out0, out1,
                                  pl, threads, blocks, sbytes, sc, sh, ck,
                                  st);
    default:
      if constexpr (sizeof(T) == 4) {
        return launch_cols<T, S, 4>(diags, offs, nd, t0, t1, acc, out0, out1,
                                    pl, threads, blocks, sbytes, sc, sh, ck,
                                    st);
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int cheb_step2_f32(const float* diags, const long long* offsets, int nd,
                   const float* t0, const float* t1, float* acc, float* out0,
                   float* out1, long long n, long long m, long long chunk,
                   long long cols, long long tile, long long depth,
                   float sc, float sh, float c0, float c1, void* stream) {
  return launch<float, 2>(diags, offsets, nd, t0, t1, acc, out0, out1, n, m,
                          chunk, cols, tile, depth, sc, sh,
                          Coeffs<float>{{c0, c1, 0.0f, 0.0f}}, stream);
}

int cheb_step2_f64(const double* diags, const long long* offsets, int nd,
                   const double* t0, const double* t1, double* acc,
                   double* out0, double* out1, long long n, long long m,
                   long long chunk, long long cols, long long tile,
                   long long depth, double sc, double sh, double c0,
                   double c1, void* stream) {
  return launch<double, 2>(diags, offsets, nd, t0, t1, acc, out0, out1, n, m,
                           chunk, cols, tile, depth, sc, sh,
                           Coeffs<double>{{c0, c1, 0.0, 0.0}}, stream);
}

int cheb_step4_f32(const float* diags, const long long* offsets, int nd,
                   const float* t0, const float* t1, float* acc, float* out0,
                   float* out1, long long n, long long m, long long chunk,
                   long long cols, long long tile, long long depth,
                   float sc, float sh, float c0, float c1, float c2,
                   float c3, void* stream) {
  return launch<float, 4>(diags, offsets, nd, t0, t1, acc, out0, out1, n, m,
                          chunk, cols, tile, depth, sc, sh,
                          Coeffs<float>{{c0, c1, c2, c3}}, stream);
}

int cheb_step4_f64(const double* diags, const long long* offsets, int nd,
                   const double* t0, const double* t1, double* acc,
                   double* out0, double* out1, long long n, long long m,
                   long long chunk, long long cols, long long tile,
                   long long depth, double sc, double sh, double c0,
                   double c1, double c2, double c3, void* stream) {
  return launch<double, 4>(diags, offsets, nd, t0, t1, acc, out0, out1, n, m,
                           chunk, cols, tile, depth, sc, sh,
                           Coeffs<double>{{c0, c1, c2, c3}}, stream);
}

const char* cheb_stream4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
