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
// entries; the operands lie b * N * M elements apart):
//
//   y[b, i, j] = sum_k diags[k, i] * x[b, i + off_k, j]
//
// where terms with i + off_k outside [0, N) are dropped (the diagonal is
// zero there). Complex operands come in as their real view: a complex
// (N, K) tensor is a real (N, 2K) one with the same real diagonals, so one
// launch does the whole complex product.
//
// What bounds it: memory. Each output element needs nd diagonal values and
// nd x values for 2 nd operations: 0.25 operation per byte in f32, far
// below the card's ridge. The least a launch can move is x and y once and
// the diagonals once. Two hand-written bodies; the host's plan
// (ops/dia.py, dia_plan) picks one by shape before the launch:
//
// The ring body (dia_ring_kernel), for operands whose rows are whole
// 16-byte pieces (M a multiple of 4 f32 or 2 fp64 columns). A block owns
// a strip of `tile` rows for a column group: `cols` columns of every one
// of the g operands, so one block serves its strip for the whole batch and
// reads each diagonal once per row for all of it. A ring row is the
// group's columns side by side, operand after operand; `lanes` = g cols /
// V neighbouring threads take neighbouring 16-byte pieces of a row (V = 4
// f32 or 2 fp64 columns), so a warp's loads, ring accesses and stores are
// coalesced and free of bank conflicts, and `chunk` = 256 / lanes rows make
// one iteration's chunk (one row a thread). The block walks its strip one
// chunk an iteration; with halo h = max |off_k| over the diagonals inside
// the matrix and lag L = ceil(h / chunk), the output chunk c needs the x
// chunks c - L .. c + L. They sit in a shared-memory ring of Q = 2 L + 1 +
// D chunks (chunk c in slot (c + L) mod Q), filled by cp.async (16 bytes a
// thread, L2 only) D chunks ahead of the last one an iteration reads. The
// diagonal values of an own chunk's rows come in the same copy groups,
// into a stage of D + 1 chunks of nd values a row: a one-level stencil
// does so little arithmetic an iteration that a load outside the copy
// pipeline would put its round trip into every iteration (a first version
// that loaded them into registers one iteration ahead ran at the speed of
// that round trip). At iteration j the block waits for the copies of step
// j + L, passes one barrier, issues the copies of step j + L + D into the
// slots chunk j - L - 1 and the diagonals of chunk j - 1 left, and computes
// chunk j. The lengths make every slot written in an iteration differ from
// every slot read in it (the replay in tests/test_torch_dia_stream.py
// asserts it on every access), so one barrier an iteration suffices, and D
// chunks of copies stay in flight across the arithmetic. So each x element
// is read from device memory and L2 once per strip, not once per diagonal,
// and each diagonal value once per row for the whole group; only the L
// chunks each side of a strip are read twice, by it and its neighbour.
// Strips walk in alternate directions (even strips down, odd ones up), so
// two neighbours reach their common boundary at about the same time and
// the second read of its halo finds it in L2; the plan makes two blocks a
// multiprocessor in one wave (the fastest in chip_smoke.py --dia-sweep,
// though a quarter of x is then read twice at the Krylov shapes). Each
// diagonal value is applied to the thread's V columns from a register by
// fused multiply-adds; rows and columns outside the operand are
// zero-filled by the copy, and the few iterations whose chunk lies within
// h of the matrix's first or last row drop out-of-range terms by a test (a
// copy of the body without it runs every other iteration). Every index is
// 32-bit (the plan asks g N M < 2^31 and nd N < 2^31), and no division
// runs per element.
//
// The flat body (dia_matvec_kernel), for every other shape: one thread per
// output element of a flat grid over N * M (the batch the grid's y), each
// reading its nd neighbours and diagonal values through L1/L2. The plan
// takes it where a row is not whole 16-byte pieces (M = 1, the Lanczos
// vectors, and odd M), where two blocks' rings do not fit a multiprocessor
// (halos of 1024 rows and more, as in the P=10 Rayleigh-Ritz product,
// where the sweep timed a ring no faster), and where 32-bit indices would
// not do.
//
// The diagonal count is a template parameter for 3, 5, 7 and 9 diagonals,
// with a run-time loop for any other count up to 32, in both bodies.
//
// Plain C interface (bound with ctypes). Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the kernel does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 32;   // bcoo_to_dia keeps at most 32 diagonals
constexpr int kThreadsPerBlock = 256;
constexpr int kMaxSharedBytes = 232448;   // 227 KB, the sm_90 opt-in
constexpr int kMaxDepth = 8;

struct DiaOffsets {
  long long v[kMaxDiags];
};

// ---------------------------------------------------------------- flat body

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

// ---------------------------------------------------------------- ring body

// V values of T in 16 bytes: one thread's piece of a ring row
template <typename T>
struct alignas(16) Vec {
  static constexpr int kWidth = static_cast<int>(16 / sizeof(T));
  T v[kWidth];
};

// The ring body's launch plan (ops/dia.py, dia_plan, and the checks in
// launch_ring): the diagonals inside the matrix and their rows in diags.
struct RingPlan {
  int n, m;            // rows, columns of an operand
  int cols;            // columns of each operand in a group (a multiple of V)
  int groups;          // ceil(m / cols)
  int lanes;           // threads a row: g cols / V
  int chunk;           // rows an iteration, 256 / lanes at most
  int tile;            // strip rows, a multiple of chunk
  int lag;             // L = ceil(halo / chunk)
  int depth;           // D: chunks of copies in flight, 1..8
  int ring;            // Q = 2 L + 1 + D chunks (ring_chunks)
  int halo;            // max |off| inside the matrix
  int nd;              // diagonals inside the matrix
  int off[kMaxDiags];  // their offsets
  int row[kMaxDiags];  // their rows in diags (row * n < 2^31)
};

// The ring's length in chunks: the 2 L + 1 chunks an iteration reads and
// the D chunks whose copies are in flight while it does.
__host__ __device__ __forceinline__ int ring_chunks(int lag, int depth) {
  return 2 * lag + 1 + depth;
}

// Shared memory of a block: the x ring (Q chunks of R rows of lanes
// 16-byte pieces) and the diagonal stage (D + 1 chunks of nd R values: the
// chunk an iteration reads and the D in flight).
template <typename T>
long long ring_bytes(const RingPlan& p) {
  return static_cast<long long>(p.ring) * p.chunk * p.lanes * 16 +
         static_cast<long long>(p.depth + 1) * p.nd * p.chunk * sizeof(T);
}

// 16 bytes from device memory into shared memory, through L2 only; with
// valid false nothing is read and the 16 bytes are zero
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// one element (4 or 8 bytes) from device memory into shared memory; with
// valid false nothing is read and the element is zero
template <typename T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src, bool valid) {
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
#define DIA_WAIT(N)                                                       \
  case N:                                                                 \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory");          \
    break;
    DIA_WAIT(0) DIA_WAIT(1) DIA_WAIT(2) DIA_WAIT(3) DIA_WAIT(4)
    DIA_WAIT(5) DIA_WAIT(6)
#undef DIA_WAIT
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return fma(a, b, c);
}

// One ring row's piece for output row r (ring position base): the sum over
// the diagonals, each value (from the diagonal stage: k's value of the row
// at dcol[k R]) applied to the thread's V columns. EDGE: terms whose
// neighbour row lies outside the matrix are dropped (else the chunk is
// inside it).
template <typename T, int ND, bool EDGE>
__device__ __forceinline__ Vec<T> ring_row(const Vec<T>* ring, int base,
                                           int span, int lanes, int lane,
                                           const RingPlan& p, const T* dcol,
                                           int r) {
  Vec<T> acc;
#pragma unroll
  for (int v = 0; v < Vec<T>::kWidth; ++v) acc.v[v] = T(0);
  const int R = p.chunk;
  auto term = [&](int k) {
    const int off = p.off[k];
    if (EDGE && static_cast<unsigned>(r + off) >=
                    static_cast<unsigned>(p.n)) {
      return;
    }
    int pos = base + off;
    pos += pos < 0 ? span : 0;
    pos -= pos >= span ? span : 0;
    const T d = dcol[k * R];
    const Vec<T> xv = ring[pos * lanes + lane];
#pragma unroll
    for (int v = 0; v < Vec<T>::kWidth; ++v) {
      acc.v[v] = mul_add(d, xv.v[v], acc.v[v]);
    }
  };
  if constexpr (ND > 0) {
#pragma unroll
    for (int k = 0; k < ND; ++k) term(k);
  } else {
#pragma unroll 4
    for (int k = 0; k < p.nd; ++k) term(k);
  }
  return acc;
}

template <typename T, int ND>
__global__ void __launch_bounds__(kThreadsPerBlock, 2)
dia_ring_kernel(const T* __restrict__ diags, const RingPlan p,
                const T* __restrict__ x, T* __restrict__ y) {
  using VecT = Vec<T>;
  constexpr int kV = VecT::kWidth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lanes = p.lanes, R = p.chunk, L = p.lag, Q = p.ring;
  const int D = p.depth;
  const int nd = ND > 0 ? ND : p.nd;
  const int span = Q * R;     // ring rows
  const int n = p.n, m = p.m;
  // the x ring, then the diagonal stage: D + 1 slots of nd x R values
  VecT* const ring = reinterpret_cast<VecT*>(smem_raw);
  T* const stage = reinterpret_cast<T*>(ring + span * lanes);

  // this thread: row q of each chunk, piece `lane` of a ring row, which is
  // V columns of operand b
  const int q = static_cast<int>(threadIdx.x) / lanes;
  const int lane = static_cast<int>(threadIdx.x) - q * lanes;
  const int per_op = p.cols / kV;
  const int b = lane / per_op;
  // the column group is the fast grid index: the blocks of one strip read
  // the same diagonals at about the same time, from L2
  const int group = static_cast<int>(blockIdx.x) % p.groups;
  const int strip = static_cast<int>(blockIdx.x) / p.groups;
  const int col = group * p.cols + (lane - b * per_op) * kV;
  const bool col_ok = col < m;
  const int xoff = b * n * m + col;   // this piece's column in operand b

  // own rows [s0, s0 + rows) in nch chunks; chunk c of the strip holds rows
  // s0 + c R + [0, R), c in [-L, nch + L) with the halo chunks
  const int s0 = strip * p.tile;
  const int rows = min(p.tile, n - s0);
  const int nch = (rows + R - 1) / R;
  // even strips walk down, odd ones up: step u of the walk is chunk u or
  // nch - 1 - u, own chunks at u = 0 .. nch - 1
  const bool down = (strip & 1) == 0;
  const int dir = down ? 1 : -1;
  auto chunk_at = [&](int u) { return down ? u : nch - 1 - u; };
  auto slot_of = [&](int c) { return ((c + L) % Q + Q) % Q; };
  // the copies of step u: its x chunk into ring slot `slot` (none past the
  // last halo chunk) and the diagonal values of own chunk u - L into stage
  // slot `dslot` (the thread's row, diagonals lane, lane + lanes, ...)
  auto issue = [&](int u, int slot, int dslot) {
    if (u < nch + L) {
      const int r = s0 + chunk_at(u) * R + q;
      const bool ok = col_ok && static_cast<unsigned>(r) <
                                    static_cast<unsigned>(n);
      copy16(&ring[(slot * R + q) * lanes + lane], ok ? x + xoff + r * m : x,
             ok);
    }
    if (u >= L && u < nch + L) {
      const int r = s0 + chunk_at(u - L) * R + q;
      const bool ok = r < n;
      T* const dst = stage + dslot * nd * R + q;
      for (int k = lane; k < nd; k += lanes) {
        copy_elem(dst + k * R, ok ? diags + p.row[k] * n + r : diags, ok);
      }
    }
  };

  // prologue: one group for chunks -L .. L of the walk (with the diagonals
  // of own chunk 0), then one for each of the next D - 1
  for (int u = -L; u <= L; ++u) issue(u, slot_of(chunk_at(u)), 0);
  copy_commit();
  for (int u = L + 1; u < L + D; ++u) {
    issue(u, slot_of(chunk_at(u)), u - L);
    copy_commit();
  }

  // the thread's row of the current chunk, its ring and stage slots and
  // the slots the next copies go to, each one step of the walk further per
  // iteration
  int r = s0 + chunk_at(0) * R + q;
  int cur = slot_of(chunk_at(0));
  int ld = slot_of(chunk_at(L + D));
  int dcur = 0, dld = D;
  auto step = [&](int s) {
    s += dir;
    return s == Q ? 0 : s < 0 ? Q - 1 : s;
  };
  // the chunks within h of the matrix's first or last row test each term
  const int h = p.halo;
  for (int j = 0; j < nch; ++j) {
    copy_wait(D - 1);   // this thread's copies of step j + L landed
    __syncthreads();    // everyone's; chunk j - L - 1 is read out
    issue(j + L + D, ld, dld);
    copy_commit();
    const int top = r - q;    // the chunk's first row
    const bool edge = top - h < 0 || top + R + h > n;
    if (r < n) {
      const int base = cur * R + q;
      const T* const dcol = stage + dcur * nd * R + q;
      const VecT acc =
          edge ? ring_row<T, ND, true>(ring, base, span, lanes, lane, p,
                                       dcol, r)
               : ring_row<T, ND, false>(ring, base, span, lanes, lane, p,
                                        dcol, r);
      if (col_ok) *reinterpret_cast<VecT*>(y + xoff + r * m) = acc;
    }
    r += dir * R;
    cur = step(cur);
    ld = step(ld);
    dcur = dcur == D ? 0 : dcur + 1;
    dld = dld == D ? 0 : dld + 1;
  }
  copy_wait(0);   // no copy outlives the block
}

// ------------------------------------------------------------------ launch

// Sets the ring kernel's shared-memory limit to the opt-in maximum, once per
// instantiation and device.
template <typename T, int ND>
cudaError_t allow_shared() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(dia_ring_kernel<T, ND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int ND>
int ring_launch(const T* diags, const RingPlan& p, const T* x, T* y,
                unsigned blocks, int threads, int bytes, cudaStream_t s) {
  const cudaError_t err = allow_shared<T, ND>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dia_ring_kernel<T, ND><<<blocks, threads, bytes, s>>>(diags, p, x, y);
  return static_cast<int>(cudaGetLastError());
}

// plan (ops/dia.py, RING_PLAN_FIELDS): cols, chunk, lanes, lag, depth, tile
template <typename T>
int launch_ring(const T* diags, const long long* offsets, int nd, const T* x,
                T* y, long long n, long long m, long long g, const int* plan,
                cudaStream_t s) {
  constexpr int kV = Vec<T>::kWidth;
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  RingPlan p = {};
  p.cols = plan[0];
  p.chunk = plan[1];
  p.lanes = plan[2];
  p.lag = plan[3];
  p.depth = plan[4];
  p.tile = plan[5];
  // 32-bit indices: g n m and nd n below 2^31
  if (n <= 0 || m <= 0 || g <= 0 || n * m * g >= (1LL << 31) ||
      static_cast<long long>(nd) * n >= (1LL << 31) || m % kV != 0 ||
      p.cols <= 0 || p.cols % kV != 0 || p.chunk <= 0 || p.lanes <= 0 ||
      static_cast<long long>(p.lanes) * kV != g * p.cols ||
      p.lanes * p.chunk > kThreadsPerBlock || p.depth < 1 ||
      p.depth > kMaxDepth || p.lag < 0 || p.tile <= 0 ||
      p.tile % p.chunk != 0) {
    return bad;
  }
  p.n = static_cast<int>(n);
  p.m = static_cast<int>(m);
  p.groups = static_cast<int>((m + p.cols - 1) / p.cols);
  p.ring = ring_chunks(p.lag, p.depth);
  // the diagonals inside the matrix (the others add nothing)
  for (int k = 0; k < nd; ++k) {
    const long long o = offsets[k];
    if (o > -n && o < n) {
      p.off[p.nd] = static_cast<int>(o);
      p.row[p.nd] = k;
      const int a = static_cast<int>(o < 0 ? -o : o);
      p.halo = a > p.halo ? a : p.halo;
      ++p.nd;
    }
  }
  const long long bytes = ring_bytes<T>(p);
  const long long tiles = (n + p.tile - 1) / p.tile;
  if (static_cast<long long>(p.lag) * p.chunk < p.halo ||
      bytes > kMaxSharedBytes || tiles * p.groups > 0x7fffffffLL) {
    return bad;
  }
  const auto blocks = static_cast<unsigned>(tiles * p.groups);
  const int threads = p.lanes * p.chunk;
  const int nbytes = static_cast<int>(bytes);
  switch (p.nd) {
    case 3: return ring_launch<T, 3>(diags, p, x, y, blocks, threads, nbytes, s);
    case 5: return ring_launch<T, 5>(diags, p, x, y, blocks, threads, nbytes, s);
    case 7: return ring_launch<T, 7>(diags, p, x, y, blocks, threads, nbytes, s);
    case 9: return ring_launch<T, 9>(diags, p, x, y, blocks, threads, nbytes, s);
    default:
      return ring_launch<T, 0>(diags, p, x, y, blocks, threads, nbytes, s);
  }
}

template <typename T>
int launch_flat(const T* diags, const long long* offsets, int nd, const T* x,
                T* y, long long n, long long m, long long g, cudaStream_t s) {
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

// plan: null for the flat body, else the ring body's fields (launch_ring)
template <typename T>
int launch(const T* diags, const long long* offsets, int nd, const T* x,
           T* y, long long n, long long m, long long g, const int* plan,
           void* stream) {
  if (nd < 0 || nd > kMaxDiags || n < 0 || m < 0 || g < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0 || g == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plan ? launch_ring<T>(diags, offsets, nd, x, y, n, m, g, plan, s)
              : launch_flat<T>(diags, offsets, nd, x, y, n, m, g, s);
}

}  // namespace

extern "C" {

// y = A x for one row-major (n, m) operand; plan as launch() takes it
int dia_matvec_f32(const float* diags, const long long* offsets, int nd,
                   const float* x, float* y, long long n, long long m,
                   const int* plan, void* stream) {
  return launch<float>(diags, offsets, nd, x, y, n, m, 1, plan, stream);
}

int dia_matvec_f64(const double* diags, const long long* offsets, int nd,
                   const double* x, double* y, long long n, long long m,
                   const int* plan, void* stream) {
  return launch<double>(diags, offsets, nd, x, y, n, m, 1, plan, stream);
}

// y[b] = A x[b] for g contiguous row-major (n, m) operands sharing the
// diagonals
int dia_matvec_batched_f32(const float* diags, const long long* offsets,
                           int nd, const float* x, float* y, long long n,
                           long long m, long long g, const int* plan,
                           void* stream) {
  return launch<float>(diags, offsets, nd, x, y, n, m, g, plan, stream);
}

int dia_matvec_batched_f64(const double* diags, const long long* offsets,
                           int nd, const double* x, double* y, long long n,
                           long long m, long long g, const int* plan,
                           void* stream) {
  return launch<double>(diags, offsets, nd, x, y, n, m, g, plan, stream);
}

const char* dia_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
