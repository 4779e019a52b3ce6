// The sparse feature products of a PaddedSparse (ELL rows + a column-sorted
// CSC view), two kernels:
//
//   A. ell_margin_loss: per row i, z_i = sum_k values[i,k] c[indices[i,k]]
//      (+ o_i).  Margins mode writes z.  Loss mode computes
//      (l, l') = loss(z_i, y_i), writes u_i = w_i l'_i and reduces
//      value = sum_i w_i l_i.
//   B. csc_column_sum: g_j = sum_{p in [end_j, end_{j+1})} val_p^POW u[row_p],
//      POW 1 (X^T u) or 2 ((X*X)^T u).
//
// A value+gradient pass is A in loss mode then B with POW 1: two launches.
// A Hessian-vector product is A in margins mode then B; the Hessian
// diagonal is B with POW 2.  These replace what the JAX package computes in
// XLA outside Pallas, photon_ml_tpu/ops/features.py:237-350: `matvec` on a
// PaddedSparse (the gather and row sum, :238-249) and `rmatvec` /
// `sq_rmatvec` (the chunked prefix-scan segment sum `_csc_segment_sum`,
// :254-307, and its callers :310-350).  No TPU kernel (pl.pallas_call)
// computes them.  The values come in float32 or bfloat16 storage (the JAX
// package's bf16 feature storage; its products promote, jnp.promote_types
// at features.py:273, :322, :343): both kernels are templates on the value
// type, a bf16 value becomes a float by __bfloat162float (exact), and
// every product and sum is f32.  B's power 2 squares a bf16 value in bf16,
// one rounding (__float2bfloat16_rn of the exact f32 square), as the JAX
// package's x.csc_val * x.csc_val does before it promotes.
//
// Bound on an H100: memory.  A reads the ELL arrays once, n*k*(4 + 4)
// bytes, plus y, w, o and writes u: ~106 MB at [200,000 x 250,000] with
// k = 65, 0.032 ms at the data sheet's 3.35 TB/s; ~61 MB at config 7's
// fixed effect [285,135 x 14,983], k = 25.  B reads the stream once,
// nnz*(4 + 4) bytes, plus end and u, and writes g: ~106 MB at config 6.
// With bf16 values each nonzero is 4 + 2 bytes: ~80.6 MB for A at config 6.
// The gathers of c (A, d*4 bytes: 1 MB at d = 250,000, 60 KB at 14,983)
// and of u (B, n*4 bytes) hit vectors that stay resident in the 50 MB L2;
// one random 4-byte read is one 32-byte L2 sector, so A's and B's
// gathers from L2 cost more than their HBM stream (B's gather floor,
// torch.index_select of u, measured 0.106 ms at config 6).  The
// arithmetic is 2 flops per nonzero, far below the card's rate.
//
// What the design does about it (a simple first version, right before fast):
//   - A (redesigned for Hopper), staged rows, where c (4*d bytes) fits
//     in shared memory beside a ring of 2 stages and each block gathers
//     at least d times (config 7's fixed effect: c is 60 KB): the ELL
//     arrays are read as one flat stream.  A persistent grid, one block
//     per SM, walks tiles of R whole rows (R * k contiguous indices and
//     values) in turn; one producer thread copies c once, then each tile,
//     into shared memory with cp.async.bulk (a ring of stages with
//     full/empty mbarriers; the <= 3 words (7 bf16 values) at a span's
//     unaligned ends, and a view at any element offset, by ordinary
//     loads), so the loads
//     are whole 16-byte chunks whatever k is.  Each of the 256 consumer
//     threads takes one row at a time (rows t, t + 256, ... of the tile)
//     and computes its margin, loss, u and value: every lane is busy and
//     every lane applies the loss.  A row's y, w, o are loaded before its
//     gathers; its slots are read in groups of kUnroll = 8, all 8 gathers
//     of c (from shared memory) in flight before any is used, into 8
//     partial sums met in a fixed tree.  With k even, row r starts at slot
//     r % k (an effective stride of k + 1 across the warp: no bank
//     conflicts); with k odd, at slot 0.
//   - A, lanes per row, everywhere else (config 6's c is 1 MB): P =
//     min(32, next power of two >= k) lanes per row straight from device
//     memory, c gathered through the read-only path, no dynamic shared
//     memory, up to 8 blocks of 256 per SM.  Measured on an H100 at config
//     6, staging the rows there cost more than it saved: the ring takes
//     the shared memory that L1 would otherwise give to c's random
//     gathers (PERF.md §6).
//   - A's value reduces per block in a fixed order; each block writes one
//     partial, takes a ticket, and the last block sums the partials in
//     block order and resets the ticket (as fused_value_and_gradient.cu
//     does), so the result is bit-stable for a given plan.
//   - B (redesigned for Hopper): the column-sorted stream is cut into
//     tiles of kTile = kThreads * kRun = 2048 nonzeros, one block per
//     tile, and each thread takes a contiguous run of kRun = 8 of them.
//     * Its columns come from a tile map made once per column view on the
//       host (tile_col[t] = the first column whose segment reaches into
//       tile t; tile_col[tiles] = d): no search over end[] on the card.
//       The block stages the column ends it needs in shared memory, in
//       chunks of kChunk, in the same pass that loads the stream; a tile
//       that meets more columns (empty ones, in the main) takes several
//       chunks inside the one launch.
//     * A thread loads its run with 16-byte loads (int4 rows, float4
//       values: tile starts are multiples of kTile, so a 16-byte aligned
//       view stays aligned; the wrapper refuses any other) and issues all
//       kRun gathers of u before it uses one.  Products are rounded as the
//       plain version rounds them (__fmul_rn, never contracted).
//     * Columns reduce by a segmented reduction over the runs, the
//       merge-based load balancing of Merrill & Garland (SC'16): a thread
//       sums its run, splitting it at the column ends in shared memory; a
//       column that lies inside one run is written by its thread; the
//       partials of columns that cross runs meet in a block-wide
//       segmented scan with head flags (warp shuffles, then the warps in
//       order).  So no warp waits on one long column and no column waits
//       on a global load of end[].
//     * A tile owns the columns that START in it (empty ones get 0).  The
//       one owned column that runs past the tile's end leaves its portion
//       in first[tile] (and its id in span_col[tile]); the tile's portion
//       of a column begun earlier goes to cont[tile] (0 when there is
//       none).  The last block to finish (by ticket) completes the
//       spanning columns: the tiles' (cont, first) pairs in tile order are
//       one more segmented scan, with a head at each span_col >= 0, over
//       all its threads.  The intercept column of config 6 (98 tiles) so
//       sums as a tree across threads.
//     No atomics touch g and every sum has a fixed order for a given
//     plan: results are bit-stable.
//   - f32 (values also bf16) inputs, f32 accumulation.  Indices are int32
//     (the wrapper checks
//     n*k < 2^31 and nnz < 2^31).  Weights default to 1 and offsets to 0
//     (null pointers).
// A's mode, tiles, stages, grid and c placement and B's tiles come from
// the pure Python functions photon_ml_tpu_torch/ops/sparse_kernels.py::
// plan_margins and ::plan_columns (with B's tile map, ::tile_map), which
// the CPU tests replay; A's entry refuses a plan whose shared-memory size
// differs from margin_layout() below, B's one that differs from
// sizeof(ColumnSmem).
//
// Plain C interface, bound with ctypes.  Build (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libell_sparse.so ell_sparse.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;                  // kernel B: stream elements per thread
constexpr int kTile = kThreads * kRun;   // kernel B: stream elements per block
constexpr int kChunk = 1024;             // kernel B: column ends staged at a time
constexpr int kFinishRun = 8;            // kernel B's finish: tiles per thread per round
constexpr int kMargins = -1;  // kernel A without a loss

enum Loss : int { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ float pm1(float y) { return y > 0.5f ? 1.0f : -1.0f; }

// softplus(t) and sigmoid(t) without overflow, from one e = exp(-|t|)
__device__ __forceinline__ void softplus_sigmoid(float t, float& sp, float& sg) {
  const float e = expf(-fabsf(t));
  sp = fmaxf(t, 0.0f) + log1pf(e);
  sg = t >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

// (l, dl/dz) of photon_ml_tpu/ops/losses.py, labels {0,1} remapped to +-1
// (the same functions as fused_value_and_gradient.cu)
template <int LOSS>
__device__ __forceinline__ void loss_and_dz(float z, float y, float& l, float& dl) {
  if constexpr (LOSS == kLogistic) {
    const float yy = pm1(y);
    float sg;
    softplus_sigmoid(-yy * z, l, sg);
    dl = -yy * sg;
  } else if constexpr (LOSS == kSquared) {
    const float r = z - y;
    l = 0.5f * r * r;
    dl = r;
  } else if constexpr (LOSS == kPoisson) {
    const float e = expf(z);
    l = e - y * z;
    dl = e - y;
  } else {  // smoothed hinge, piecewise in t = yy * z
    const float yy = pm1(y);
    const float t = yy * z;
    if (t < 0.0f) {
      l = 0.5f - t;
      dl = -yy;
    } else if (t < 1.0f) {
      const float u = 1.0f - t;
      l = 0.5f * u * u;
      dl = yy * (t - 1.0f);
    } else {
      l = 0.0f;
      dl = 0.0f;
    }
  }
}

// a value as a float: exact for both storage types
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v, in a fixed order (shuffles, then warps in order);
// every thread of the block must call it.  `red` holds WARPS floats.
template <int WARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int t = threadIdx.x;
  __syncthreads();  // red may still be read by an earlier call
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (t == 0) {
    for (int w = 0; w < WARPS; ++w) s += red[w];
  }
  return s;  // meaningful on thread 0
}

// ---------------------------------------------------------------- kernel A

constexpr int kConsumers = kThreads;        // kernel A: threads that take rows
constexpr int kThreadsA = kConsumers + 32;  // + one producer warp
constexpr int kUnroll = 8;                  // kernel A: gathers in flight per thread
// dynamic shared memory a plan may ask for: Hopper's 232,448 bytes per
// block less 1 KB for the kernel's static shared memory
constexpr int kMaxSmem = 232448 - 1024;

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Kernel A's dynamic shared memory (staged rows), in words from the
// (16-byte aligned) base: c [cols] (cols = d), then `stages` stages of
// [the tile's indices (rows * k words) | its values (rows * k elements of
// vbytes bytes)], then 2 * stages + 1 mbarriers (full, empty, c).  Each
// span starts on 16 bytes and leaves 16 - E bytes of room (E its element
// size): element j of a span sits at its address's phase
// ((address / E) % (16 / E)) + j, so that its 16-byte chunks line up.
// sparse_kernels.margin_smem_bytes reproduces `bytes`.
struct MarginLayout {
  int ring, span, vspan, stage, bars, bytes;
};

__host__ __device__ inline MarginLayout margin_layout(int k, int rows, int stages, int cols,
                                                      int vbytes) {
  MarginLayout L;
  L.ring = round4(cols + 3);
  L.span = round4(rows * k + 3);
  L.vspan = round4((vbytes * rows * k + 19 - vbytes) / 4);
  L.stage = L.span + L.vspan;
  L.bars = L.ring + stages * L.stage;
  L.bytes = L.bars * 4 + (2 * stages + 1) * 8;
  return L;
}

// The 16-byte aligned interior [a, b) of the byte span of `count`
// elements of type E (4 or 2 bytes) at `src`.  Element j of the span lives
// at buf[phase + j].
template <typename E>
struct Span {
  const E* src;
  int count, phase, head, tail;  // head: elements before a; tail: first element at/after b
  uint32_t bytes;                // b - a, 0 when there is no aligned interior
};

template <typename E>
__device__ __forceinline__ Span<E> span_of(const E* p, int64_t count) {
  constexpr int kE = (int)sizeof(E);
  Span<E> s;
  s.src = p;
  s.count = (int)count;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p);
  const uintptr_t hi = lo + (uint64_t)kE * (uint64_t)count;
  const uintptr_t a = (lo + 15) & ~uintptr_t(15);
  const uintptr_t b = hi & ~uintptr_t(15);
  s.phase = (int)((lo & 15) / kE);
  if (p != nullptr && b > a) {
    s.head = (int)((a - lo) / kE);
    s.tail = (int)((b - lo) / kE);
    s.bytes = (uint32_t)(b - a);
  } else {
    s.head = s.count;
    s.tail = s.count;
    s.bytes = 0;
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// A wait lasts at most one tile's copy (microseconds); one that outlasts
// 2^24 polls (seconds) is a fault, and traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// Copy the aligned interior of `s` into buf (element j at buf[phase + j]).
template <typename E>
__device__ __forceinline__ void bulk_load(E* buf, const Span<E>& s, uint64_t* bar) {
  if (s.bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(buf + s.phase + s.head)), "l"(s.src + s.head), "r"(s.bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// The elements of `s` the bulk copy cannot take (<= 16 / E - 1 at either
// end, or all of a span without an aligned interior: < 32 / E), by
// ordinary loads.
template <typename E>
__device__ __forceinline__ void load_edges(E* buf, const Span<E>& s, int t) {
  if (t < s.head) buf[s.phase + t] = s.src[t];
  const int j = s.tail + t;
  if (j < s.count && j >= s.head) buf[s.phase + j] = s.src[j];
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

struct MarginArgs {
  const int* idx;    // [n, k]
  const void* val;   // [n, k], float or __nv_bfloat16
  const float* c;    // [d]
  const float* y;    // [n] (loss mode)
  const float* w;    // [n] or null
  const float* o;    // [n] or null
  float* out;        // [n]: z (margins mode) or u = w*l' (loss mode)
  float* partial;    // [gridDim.x] (loss mode)
  unsigned int* ticket;
  float* value;      // [1] (loss mode)
  int64_t n;
  int k, d;
  int rows, stages;  // staged rows: rows per tile, ring stages
  int log2p;         // lanes per row: log2 of the lanes
};

// Row r's margin from its k slots at ir/vr and c at cs, all in shared
// memory.  The visits start at slot `first` and wrap; visit i goes into
// partial i % kUnroll, so each thread has kUnroll gathers of c in flight
// before it uses one; the partials meet in a fixed tree.
template <typename T>
__device__ __forceinline__ float row_dot(const int* ir, const T* vr, const float* cs,
                                         int k, int first) {
  float p[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) p[q] = 0.0f;
  for (int base = 0; base < k; base += kUnroll) {
    int ii[kUnroll];
    float vv[kUnroll], cc[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      int s = first + base + q;
      if (s >= k) s -= k;
      const bool in = base + q < k;
      ii[q] = in ? ir[s] : 0;
      vv[q] = in ? to_f(vr[s]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) cc[q] = base + q < k ? cs[ii[q]] : 0.0f;
#pragma unroll
    for (int q = 0; q < kUnroll; ++q)
      if (base + q < k) p[q] = fmaf(vv[q], cc[q], p[q]);
  }
  return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
}

// A row's label, weight and offset, loaded before its gathers so that
// their latency hides behind them.
struct RowIn {
  float y, w, o;
};

template <int LOSS>
__device__ __forceinline__ RowIn load_row(const MarginArgs& a, int64_t row) {
  return RowIn{LOSS != kMargins ? a.y[row] : 0.0f, a.w != nullptr ? a.w[row] : 1.0f,
               a.o != nullptr ? a.o[row] : 0.0f};
}

// Row `row`'s output from its margin (+ o): z, or u = w l' with w l added
// to v_acc.
template <int LOSS>
__device__ __forceinline__ void finish_row(const MarginArgs& a, int64_t row, float dot,
                                           const RowIn& in, float& v_acc) {
  const float z = a.o != nullptr ? dot + in.o : dot;
  if constexpr (LOSS == kMargins) {
    a.out[row] = z;
  } else {
    float l, dl;
    loss_and_dz<LOSS>(z, in.y, l, dl);
    a.out[row] = in.w * dl;
    v_acc += in.w * l;
  }
}

// The value: each block's sum of v_acc in a fixed order; the last block to
// finish (by ticket) sums the partials in block order and resets the
// ticket, so the result is bit-stable for a given plan.
template <int WARPS>
__device__ __forceinline__ void finish_value(const MarginArgs& a, float v_acc, float* red,
                                             bool& is_last) {
  const int t = threadIdx.x;
  const float block_v = block_sum<WARPS>(v_acc, red);
  if (t == 0) a.partial[blockIdx.x] = block_v;
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float s = 0.0f;
  for (int b = t; b < (int)gridDim.x; b += WARPS * 32) s += __ldcg(a.partial + b);
  s = block_sum<WARPS>(s, red);
  if (t == 0) {
    a.value[0] = s;
    *a.ticket = 0u;  // ready for the next call on this stream
  }
}

// Staged rows: a persistent grid, block b taking tiles b, b + grid, ... of
// a.rows whole rows, i.e. rows * k contiguous indices and values, through a
// ring of a.stages stages in shared memory filled by one producer thread
// with cp.async.bulk copies (full/empty mbarriers).  Consumer thread t
// takes rows t, t + kConsumers, ... of each tile: every lane computes a
// row's margin, loss, u and value.  Row r of a tile starts at slot r % k
// when k is even (an odd effective stride, k + 1, across the warp: no bank
// conflicts) and at slot 0 when k is odd.  c is copied once per block
// into shared memory (the same way, overlapped with the first tiles) and
// gathered there.  T: the values' element type, float or __nv_bfloat16.
template <int LOSS, typename T>
__global__ void __launch_bounds__(kThreadsA, 1) ell_margin_loss(const MarginArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float red[kThreadsA / 32];
  __shared__ bool is_last;
  const int64_t n = a.n;
  const int k = a.k, rows = a.rows, stages = a.stages;
  const MarginLayout L = margin_layout(k, rows, stages, a.d, (int)sizeof(T));
  const T* val = static_cast<const T*>(a.val);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  uint64_t* c_full = empty + stages;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t first_row = (int64_t)blockIdx.x * rows;
  const int64_t row_step = (int64_t)gridDim.x * rows;
  const Span<float> sc = span_of(a.c, a.d);

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(c_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float v_acc = 0.0f;
  if (t >= kConsumers) {
    // producer warp: lane 0 copies c (once) and keeps the ring full
    if (lane == 0) {
      if (sc.bytes == 0) {
        mbar_arrive(c_full);
      } else {
        mbar_arrive_expect_tx(c_full, sc.bytes);
        bulk_load(reinterpret_cast<float*>(smem), sc, c_full);
      }
      int stage = 0;
      uint32_t parity = 1;  // a fresh barrier's previous phase counts as complete
      for (int64_t r0 = first_row; r0 < n; r0 += row_step) {
        mbar_wait(&empty[stage], parity);
        const int64_t nr = n - r0 < rows ? n - r0 : rows;
        uint32_t* buf = smem + L.ring + stage * L.stage;
        const Span<int> si = span_of(a.idx + r0 * k, nr * k);
        const Span<T> sv = span_of(val + r0 * k, nr * k);
        const uint32_t bytes = si.bytes + sv.bytes;
        if (bytes == 0) {
          mbar_arrive(&full[stage]);
        } else {
          mbar_arrive_expect_tx(&full[stage], bytes);
          bulk_load(reinterpret_cast<int*>(buf), si, &full[stage]);
          bulk_load(reinterpret_cast<T*>(buf + L.span), sv, &full[stage]);
        }
        if (++stage == stages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    load_edges(reinterpret_cast<float*>(smem), sc, t);  // c's ragged ends
    consumer_sync();
    mbar_wait(c_full, 0);
    const float* cs = reinterpret_cast<const float*>(smem + sc.phase);
    int stage = 0;
    uint32_t parity = 0;
    for (int64_t r0 = first_row; r0 < n; r0 += row_step) {
      mbar_wait(&full[stage], parity);
      const int nr = (int)(n - r0 < rows ? n - r0 : rows);
      uint32_t* buf = smem + L.ring + stage * L.stage;
      const Span<int> si = span_of(a.idx + r0 * k, (int64_t)nr * k);
      const Span<T> sv = span_of(val + r0 * k, (int64_t)nr * k);
      // the same on every thread: words the bulk copies did not bring?
      const bool edges =
          si.head > 0 || si.tail < si.count || sv.head > 0 || sv.tail < sv.count;
      if (edges) {
        load_edges(reinterpret_cast<int*>(buf), si, t);
        load_edges(reinterpret_cast<T*>(buf + L.span), sv, t);
        consumer_sync();
      }
      const int* bi = reinterpret_cast<const int*>(buf + si.phase);
      const T* bv = reinterpret_cast<const T*>(buf + L.span) + sv.phase;
      for (int r = t; r < nr; r += kConsumers) {
        const RowIn in = load_row<LOSS>(a, r0 + r);
        const int first = (k & 1) ? 0 : r % k;
        const float dot = row_dot(bi + r * k, bv + r * k, cs, k, first);
        finish_row<LOSS>(a, r0 + r, dot, in, v_acc);
      }
      // our generic writes to the stage happen before the next bulk copy into it
      if (edges) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
    }
  }
  if constexpr (LOSS != kMargins) finish_value<kThreadsA / 32>(a, v_acc, red, is_last);
}

// Lanes per row, where c is gathered from L2 (it does not fit beside the
// ring, the rows are too long for a staged tile, or a block would gather
// fewer than d times): P = 2^log2p lanes per row, lane j taking slots
// j, j + P, ... straight from device memory, c through the read-only path,
// no dynamic shared memory, so the SM's L1 caches what it can of c; the
// row's sum meets in log2(P) shuffles and its first lane applies the
// loss.  A block of kThreads takes kThreads / P rows per round, block b
// rounds b, b + gridDim.x, ...; every thread runs the same rounds (the
// shuffles need all 32 lanes of each warp).
template <int LOSS, typename T>
__global__ void __launch_bounds__(kThreads) ell_margin_loss_lanes(const MarginArgs a) {
  __shared__ float red[kWarps];
  __shared__ bool is_last;
  const int t = threadIdx.x;
  const int P = 1 << a.log2p;
  const int sub = t & (P - 1);
  const int rows_per_round = kThreads >> a.log2p;
  const int64_t step = (int64_t)gridDim.x * rows_per_round;
  const int k = a.k;
  float v_acc = 0.0f;
  for (int64_t base = (int64_t)blockIdx.x * rows_per_round; base < a.n; base += step) {
    const int64_t r = base + (t >> a.log2p);
    float dot = 0.0f;
    RowIn in{0.0f, 1.0f, 0.0f};
    if (r < a.n) {
      in = load_row<LOSS>(a, r);
      const int* __restrict__ ir = a.idx + r * k;
      const T* __restrict__ vr = static_cast<const T*>(a.val) + r * k;
#pragma unroll 4
      for (int j = sub; j < k; j += P) dot = fmaf(to_f(vr[j]), __ldg(a.c + ir[j]), dot);
    }
    for (int off = P >> 1; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (sub == 0 && r < a.n) finish_row<LOSS>(a, r, dot, in, v_acc);
  }
  if constexpr (LOSS != kMargins) finish_value<kWarps>(a, v_acc, red, is_last);
}

template <int LOSS, typename T>
cudaError_t launch_a(const MarginArgs& a, int grid, int smem, cudaStream_t s) {
  if (a.stages == 0) {
    ell_margin_loss_lanes<LOSS, T><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  const cudaError_t e = cudaFuncSetAttribute(
      ell_margin_loss<LOSS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  ell_margin_loss<LOSS, T><<<grid, kThreadsA, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_a(int loss, const MarginArgs& a, int grid, int smem, cudaStream_t s) {
  switch (loss) {
    case kMargins: return launch_a<kMargins, T>(a, grid, smem, s);
    case kLogistic: return launch_a<kLogistic, T>(a, grid, smem, s);
    case kSquared: return launch_a<kSquared, T>(a, grid, smem, s);
    case kPoisson: return launch_a<kPoisson, T>(a, grid, smem, s);
    case kSmoothedHinge: return launch_a<kSmoothedHinge, T>(a, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- kernel B

struct ColumnArgs {
  const int* row;       // [nnz] row ids, column-sorted (16-byte aligned)
  const void* val;      // [nnz] float or __nv_bfloat16 (16-byte aligned)
  const int* end;       // [d + 1]: column j is [end[j], end[j+1])
  const int* tile_col;  // [tiles + 1]: the first column reaching into tile t; d
  const float* u;       // [n]
  float* g;             // [d]
  float* first;         // [tiles]: portion of the owned column that runs on
  float* cont;          // [tiles]: portion of the column begun in an earlier tile, or 0
  int* span_col;        // [tiles]: the owned column that runs on, or -1
  unsigned int* ticket;
  int64_t nnz;
  int d, tiles;
};

// Kernel B's shared memory (sparse_kernels.plan_columns reproduces its
// size; the entry point refuses a plan that does not).
struct ColumnSmem {
  int ends[kChunk];      // a chunk of column ends, relative to the tile's start
  float scan_v[kWarps];  // each warp's total in a segmented scan
  int scan_c[kWarps];
  int is_last;
};

// An element of a segmented scan: a partial sum v, and c >= 0 when a
// segment starts inside the element (c is then that segment's column,
// where the caller needs one).
struct Seg {
  float v;
  int c;
};

// a, then b in stream order
__device__ __forceinline__ Seg seg_op(const Seg a, const Seg b) {
  return b.c >= 0 ? b : Seg{a.v + b.v, a.c};
}

// The block's exclusive segmented scan of s in thread order, after
// `carry`: shuffles within each warp, then the warps in order.  *total
// (if given) gets carry then every thread's s, with the same bits on
// every thread.  Every thread of the block must call it.
__device__ __forceinline__ Seg block_seg_scan(Seg s, const Seg carry, ColumnSmem& sm,
                                              Seg* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg y{__shfl_up_sync(0xffffffffu, s.v, off), __shfl_up_sync(0xffffffffu, s.c, off)};
    if (lane >= off) s = seg_op(y, s);
  }
  const Seg ex{__shfl_up_sync(0xffffffffu, s.v, 1), __shfl_up_sync(0xffffffffu, s.c, 1)};
  __syncthreads();  // the scan area may still be read by an earlier call
  if (lane == 31) {
    sm.scan_v[warp] = s.v;
    sm.scan_c[warp] = s.c;
  }
  __syncthreads();
  Seg pre = carry;
  for (int w = 0; w < warp; ++w) pre = seg_op(pre, Seg{sm.scan_v[w], sm.scan_c[w]});
  if (total != nullptr) {
    Seg all = pre;
    for (int w = warp; w < kWarps; ++w) all = seg_op(all, Seg{sm.scan_v[w], sm.scan_c[w]});
    *total = all;
  }
  return lane == 0 ? pre : seg_op(pre, ex);
}

// how many of s[0, len) are <= x (s non-decreasing)
__device__ __forceinline__ int count_le(const int* s, int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// val^2 in the values' storage type (a bf16 square rounds once to bf16,
// as the plain version's vals * vals does)
__device__ __forceinline__ float square(float v, float) { return __fmul_rn(v, v); }
__device__ __forceinline__ float square(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, v)));
}

// val^POW * u, each product rounded as the plain version rounds it
template <int POW, typename T>
__device__ __forceinline__ float term(float v, float uu) {
  return __fmul_rn(POW == 2 ? square(v, T()) : v, uu);
}

// A run of kRun values at p (16-byte aligned) as floats, by 16-byte loads
__device__ __forceinline__ void load_run(const float* p, float (&v)[kRun]) {
  const float4* vp = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) {
    const float4 vq = __ldcs(vp + q);
    v[4 * q] = vq.x; v[4 * q + 1] = vq.y; v[4 * q + 2] = vq.z; v[4 * q + 3] = vq.w;
  }
}

__device__ __forceinline__ void load_run(const __nv_bfloat16* p, float (&v)[kRun]) {
  static_assert(kRun == 8, "one 16-byte load holds 8 bf16 values");
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < kRun / 2; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The last block: the spanning columns.  Tile q contributes cont[q] to the
// column open at its start, then, when span_col[q] >= 0, opens column
// span_col[q] with first[q].  In tile order these form one segmented
// stream; each thread takes kFinishRun tiles per round, writes the
// columns that open and close inside its tiles, and the block's segmented
// scan carries the rest, so the intercept sums as a tree across threads.
__device__ void finish_spans(const ColumnArgs& a, ColumnSmem& sm) {
  const int t = threadIdx.x;
  Seg carry{0.0f, -1};
  for (int base = 0; base < a.tiles; base += kThreads * kFinishRun) {
    const int q0 = base + t * kFinishRun;
    float cv[kFinishRun], fv[kFinishRun];
    int sc[kFinishRun];
#pragma unroll
    for (int i = 0; i < kFinishRun; ++i) {
      const bool in = q0 + i < a.tiles;
      cv[i] = in ? __ldcg(a.cont + q0 + i) : 0.0f;
      sc[i] = in ? __ldcg(a.span_col + q0 + i) : -1;
      fv[i] = in ? __ldcg(a.first + q0 + i) : 0.0f;
    }
    float acc = 0.0f, head = 0.0f;
    int col = -1;
#pragma unroll
    for (int i = 0; i < kFinishRun; ++i) {
      acc += cv[i];
      if (sc[i] >= 0) {
        if (col < 0) head = acc;  // closes the column open before this thread
        else a.g[col] = acc;
        acc = fv[i];
        col = sc[i];
      }
    }
    Seg total;
    const Seg ex = block_seg_scan(Seg{acc, col}, carry, sm, &total);
    if (col >= 0 && ex.c >= 0) a.g[ex.c] = ex.v + head;
    carry = total;
  }
  if (t == 0) {
    if (carry.c >= 0) a.g[carry.c] = carry.v;
    *a.ticket = 0u;  // ready for the next call on this stream
  }
}

template <int POW, typename T>
__global__ void __launch_bounds__(kThreads) csc_column_sum(const ColumnArgs a) {
  const T* val = static_cast<const T*>(a.val);
  __shared__ ColumnSmem sm;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int64_t lo = (int64_t)tile * kTile;
  const int len = (int)((lo + kTile < a.nnz ? lo + kTile : a.nnz) - lo);
  // this thread's run: tile positions [r0, r0 + mine)
  const int r0 = t * kRun;
  const int mine = len - r0 >= kRun ? kRun : (len > r0 ? len - r0 : 0);
  // columns [j0, j1) start in this tile (in the last tile, also those
  // that start at nnz); column j0 - 1 may reach into it from before
  const int j0 = __ldg(a.tile_col + tile), j1 = __ldg(a.tile_col + tile + 1);

  // the run's loads and all its gathers, in flight together
  int r[kRun];
  float v[kRun], uu[kRun];
  if (mine == kRun) {
    const int4* rp = reinterpret_cast<const int4*>(a.row + lo + r0);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const int4 rq = __ldcs(rp + q);
      r[4 * q] = rq.x; r[4 * q + 1] = rq.y; r[4 * q + 2] = rq.z; r[4 * q + 3] = rq.w;
    }
    load_run(val + lo + r0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      r[i] = i < mine ? __ldcs(a.row + lo + r0 + i) : 0;
      v[i] = i < mine ? to_f(val[lo + r0 + i]) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) uu[i] = i < mine ? __ldg(a.u + r[i]) : 0.0f;

  // chunks of kChunk - 1 owned columns, each with the kChunk ends that
  // bound them; chunk 0 also holds column j0 - 1's end
  const int chunks = j1 > j0 ? (j1 - j0 + kChunk - 2) / (kChunk - 1) : 1;
  float x[kRun];
  for (int k = 0; k < chunks; ++k) {
    const int cb = j0 + k * (kChunk - 1);
    const int m = j1 - cb < kChunk - 1 ? j1 - cb : kChunk - 1;
    for (int i = t; i <= m; i += kThreads) sm.ends[i] = (int)(__ldg(a.end + cb + i) - lo);
    __syncthreads();
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) x[i] = term<POW, T>(v[i], uu[i]);
      if (t == 0 && sm.ends[0] <= 0) a.cont[tile] = 0.0f;  // nothing reaches in
    }
    if (k == chunks - 1 && t == 0)
      a.span_col[tile] = sm.ends[m] > len && j1 > j0 ? j1 - 1 : -1;
    for (int i = t; i < m; i += kThreads)
      if (sm.ends[i] == sm.ends[i + 1]) a.g[cb + i] = 0.0f;  // empty column

    // this run's part of the chunk's stream positions [p0, p1)
    const int p0 = k == 0 ? 0 : sm.ends[0];
    const int p1 = sm.ends[m] < len ? sm.ends[m] : len;
    const int b0 = r0 > p0 ? r0 : p0;
    const int b1 = r0 + mine < p1 ? r0 + mine : p1;
    float acc = 0.0f, head = 0.0f;
    int head_col = -1;  // the first column that ends in this run
    int cur = -1;       // the column of the current position
    bool open = false;  // acc holds a part of column cur not yet handed on
    if (b0 < b1) {
      cur = cb - 1 + count_le(sm.ends, m + 1, b0);
      int stop = sm.ends[cur + 1 - cb];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int p = r0 + i;
        if (p >= b0 && p < b1) {
          acc += x[i];
          open = true;
          if (p + 1 == stop) {  // column cur ends here
            if (head_col < 0) {
              head = acc;
              head_col = cur;
            } else {
              a.g[cur] = acc;  // it lies inside this run
            }
            acc = 0.0f;
            open = false;
            if (p + 1 < b1) {  // the next non-empty column
              cur = sm.ends[cur + 2 - cb] > p + 1
                        ? cur + 1 : cb - 1 + count_le(sm.ends, m + 1, p + 1);
              stop = sm.ends[cur + 1 - cb];
            }
          }
        }
      }
    }
    const Seg ex = block_seg_scan(Seg{acc, head_col >= 0 ? 0 : -1}, Seg{0.0f, -1}, sm,
                                  nullptr);
    if (head_col >= 0) {
      const float total = ex.v + head;
      if (head_col < j0) a.cont[tile] = total;
      else a.g[head_col] = total;
    }
    if (open && b1 == len) {  // the column that runs past the tile's end
      const float total = head_col >= 0 ? acc : ex.v + acc;
      if (cur < j0) a.cont[tile] = total;
      else a.first[tile] = total;
    }
  }

  // the last block to finish completes the columns that span tiles
  __threadfence();
  __syncthreads();
  if (t == 0) sm.is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sm.is_last) return;
  __threadfence();
  finish_spans(a, sm);
}

template <int POW, typename T>
cudaError_t launch_b(const ColumnArgs& a, cudaStream_t s) {
  csc_column_sum<POW, T><<<a.tiles, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A on `stream`; returns the cudaError_t of the launch (0 on
// success).  loss: a kernel_id of ops/losses.py, or -1 for margins only (y,
// partial, ticket and value unused).  vbytes: the values' element size, 4
// (float32) or 2 (bfloat16); every other float operand is float32.
// out: [n].  partial: [grid] scratch;
// ticket: one zeroed uint32 that every loss-mode launch leaves zeroed;
// value: [1].  w and o may be null.  The plan (lanes, rows, stages, grid,
// smem_bytes) comes from sparse_kernels.plan_margins: stages > 0 is the
// staged kernel (lanes 1, c in shared memory), whose smem_bytes must be
// margin_layout(k, rows, stages, d).bytes; stages 0 the lanes kernel
// (lanes P = 1, 2, ..., 32, rows kThreads / P, no dynamic shared
// memory).  A plan that does not fit is refused.
int pmt_ell_margin_loss(int loss, int vbytes, const void* idx, const void* val, const void* c,
                        const void* y, const void* w, const void* o, void* out,
                        void* partial, void* ticket, void* value, long long n, int k, int d,
                        int lanes, int rows, int stages, int grid, int smem_bytes,
                        void* stream) {
  int log2p = 0;
  while (log2p < 5 && (1 << log2p) < lanes) ++log2p;
  bool plan_ok;
  if (stages > 0) {
    plan_ok = lanes == 1 && rows >= 1 && static_cast<long long>(rows) * k <= kMaxSmem / 8 &&
              d <= kMaxSmem / 4 && smem_bytes <= kMaxSmem &&
              margin_layout(k, rows, stages, d, vbytes).bytes == smem_bytes;
  } else {
    plan_ok = (1 << log2p) == lanes && rows == (kThreads >> log2p) && stages == 0 &&
              smem_bytes == 0;
  }
  // an empty tensor's pointer may be null: y only when there are no rows
  if (n < 0 || k < 1 || d < 1 || grid < 1 || !plan_ok || (vbytes != 4 && vbytes != 2) ||
      (loss != kMargins && ((y == nullptr && n > 0) || partial == nullptr ||
                            ticket == nullptr || value == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MarginArgs a{static_cast<const int*>(idx), val,
                     static_cast<const float*>(c), static_cast<const float*>(y),
                     static_cast<const float*>(w), static_cast<const float*>(o),
                     static_cast<float*>(out), static_cast<float*>(partial),
                     static_cast<unsigned int*>(ticket), static_cast<float*>(value),
                     n, k, d, rows, stages, log2p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vbytes == 4 ? dispatch_a<float>(loss, a, grid, smem_bytes, s)
                                      : dispatch_a<__nv_bfloat16>(loss, a, grid, smem_bytes, s));
}

// Kernel B on `stream`.  power 1 or 2; vbytes: val's element size, 4
// (float32) or 2 (bfloat16); row and val 16-byte aligned;
// tile_col: [tiles + 1], sparse_kernels.tile_map of end; g: [d]; first,
// cont: [tiles] float scratch; span_col: [tiles] int scratch; ticket: one
// zeroed uint32 that every launch leaves zeroed.  tiles must be
// max(1, ceil(nnz / kTile)) and smem_bytes sizeof(ColumnSmem)
// (sparse_kernels.plan_columns).
int pmt_csc_column_sum(int power, int vbytes, const void* row, const void* val,
                       const void* end,
                       const void* tile_col, const void* u, void* g, void* first,
                       void* cont, void* span_col, void* ticket, long long nnz, int d,
                       int tiles, int smem_bytes, void* stream) {
  const long long want = nnz > 0 ? (nnz + kTile - 1) / kTile : 1;
  const uintptr_t misaligned =
      (reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(val)) & 15u;
  if (nnz < 0 || d < 1 || tiles != want || (power != 1 && power != 2) ||
      (vbytes != 4 && vbytes != 2) ||
      tile_col == nullptr || smem_bytes != static_cast<int>(sizeof(ColumnSmem)) ||
      (nnz > 0 && misaligned != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const ColumnArgs a{static_cast<const int*>(row), val,
                     static_cast<const int*>(end), static_cast<const int*>(tile_col),
                     static_cast<const float*>(u), static_cast<float*>(g),
                     static_cast<float*>(first), static_cast<float*>(cont),
                     static_cast<int*>(span_col), static_cast<unsigned int*>(ticket), nnz,
                     d, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vbytes == 2)
    return static_cast<int>(power == 1 ? launch_b<1, __nv_bfloat16>(a, s)
                                       : launch_b<2, __nv_bfloat16>(a, s));
  return static_cast<int>(power == 1 ? launch_b<1, float>(a, s) : launch_b<2, float>(a, s));
}

const char* pmt_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
