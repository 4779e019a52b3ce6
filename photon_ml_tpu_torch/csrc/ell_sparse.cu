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
// computes them.
//
// Bound on an H100: memory.  A reads the ELL arrays once, n*k*(4 + 4)
// bytes, plus y, w, o and writes u: ~106 MB at [200,000 x 250,000] with
// k = 65, 0.032 ms at the data sheet's 3.35 TB/s.  B reads the stream once,
// nnz*(4 + 4) bytes, plus end and u, and writes g: ~106 MB there too.  The
// gathers of c (A, d*4 bytes: 1 MB at d = 250,000) and of u (B, n*4
// bytes) hit vectors that stay resident in the 50 MB L2.  The arithmetic is
// 2 flops per nonzero, far below the card's rate.
//
// What the design does about it (a simple first version, right before fast):
//   - A: P = min(32, next power of two >= k) threads per row, each taking
//     every P-th slot, so neighbouring threads read neighbouring bytes and a
//     warp's loads cover whole rows; the row's sum meets in log2(P)
//     shuffles and the row's first thread applies the loss.  A grid of at
//     most 8 blocks of 256 threads per SM walks the rows in rounds.  The
//     value reduces per block in a fixed order; each block writes one
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
//   - f32 inputs, f32 accumulation.  Indices are int32 (the wrapper checks
//     n*k < 2^31 and nnz < 2^31).  Weights default to 1 and offsets to 0
//     (null pointers).
// The grid of A and the tiles of B come from the pure Python functions
// photon_ml_tpu_torch/ops/sparse_kernels.py::plan_margins and
// ::plan_columns (with B's tile map, ::tile_map), which the CPU tests
// replay; B's entry refuses a plan whose shared-memory size differs from
// sizeof(ColumnSmem) below.
//
// Plain C interface, bound with ctypes.  Build (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libell_sparse.so ell_sparse.cu
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v, in a fixed order (shuffles, then warps in order);
// every thread of the block must call it.  `red` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int t = threadIdx.x;
  __syncthreads();  // red may still be read by an earlier call
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (t == 0) {
    for (int w = 0; w < kWarps; ++w) s += red[w];
  }
  return s;  // meaningful on thread 0
}

// ---------------------------------------------------------------- kernel A

struct MarginArgs {
  const int* idx;    // [n, k]
  const float* val;  // [n, k]
  const float* c;    // [d]
  const float* y;    // [n] (loss mode)
  const float* w;    // [n] or null
  const float* o;    // [n] or null
  float* out;        // [n]: z (margins mode) or u = w*l' (loss mode)
  float* partial;    // [gridDim.x] (loss mode)
  unsigned int* ticket;
  float* value;      // [1] (loss mode)
  int64_t n;
  int k, log2p;      // slots per row; log2 of the threads per row
};

template <int LOSS>
__global__ void __launch_bounds__(kThreads) ell_margin_loss(const MarginArgs a) {
  __shared__ float red[kWarps];
  __shared__ bool is_last;
  const int t = threadIdx.x;
  const int P = 1 << a.log2p;
  const int sub = t & (P - 1);
  const int rows_per_round = kThreads >> a.log2p;
  const int64_t step = (int64_t)gridDim.x * rows_per_round;
  const int k = a.k;
  float v_acc = 0.0f;
  // every thread of the block runs the same rounds: the shuffles below
  // need all 32 lanes of each warp
  for (int64_t base = (int64_t)blockIdx.x * rows_per_round; base < a.n; base += step) {
    const int64_t r = base + (t >> a.log2p);
    float dot = 0.0f;
    if (r < a.n) {
      const int* __restrict__ ir = a.idx + r * k;
      const float* __restrict__ vr = a.val + r * k;
      for (int j = sub; j < k; j += P) dot += vr[j] * __ldg(a.c + ir[j]);
    }
    for (int off = P >> 1; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (sub == 0 && r < a.n) {
      const float z = a.o != nullptr ? dot + a.o[r] : dot;
      if constexpr (LOSS == kMargins) {
        a.out[r] = z;
      } else {
        float l, dl;
        loss_and_dz<LOSS>(z, a.y[r], l, dl);
        const float wt = a.w != nullptr ? a.w[r] : 1.0f;
        a.out[r] = wt * dl;
        v_acc += wt * l;
      }
    }
  }
  if constexpr (LOSS != kMargins) {
    const float block_v = block_sum(v_acc, red);
    if (t == 0) a.partial[blockIdx.x] = block_v;
    // the last block to finish sums the partials in block order
    __threadfence();
    __syncthreads();
    if (t == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    float s = 0.0f;
    for (int b = t; b < (int)gridDim.x; b += kThreads) s += __ldcg(a.partial + b);
    s = block_sum(s, red);
    if (t == 0) {
      a.value[0] = s;
      *a.ticket = 0u;  // ready for the next call on this stream
    }
  }
}

template <int LOSS>
cudaError_t launch_a(const MarginArgs& a, int grid, cudaStream_t s) {
  ell_margin_loss<LOSS><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- kernel B

struct ColumnArgs {
  const int* row;       // [nnz] row ids, column-sorted (16-byte aligned)
  const float* val;     // [nnz] (16-byte aligned)
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

// val^POW * u, each product rounded as the plain version rounds it
template <int POW>
__device__ __forceinline__ float term(float v, float uu) {
  return __fmul_rn(POW == 2 ? __fmul_rn(v, v) : v, uu);
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

template <int POW>
__global__ void __launch_bounds__(kThreads) csc_column_sum(const ColumnArgs a) {
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
    const float4* vp = reinterpret_cast<const float4*>(a.val + lo + r0);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const int4 rq = __ldcs(rp + q);
      const float4 vq = __ldcs(vp + q);
      r[4 * q] = rq.x; r[4 * q + 1] = rq.y; r[4 * q + 2] = rq.z; r[4 * q + 3] = rq.w;
      v[4 * q] = vq.x; v[4 * q + 1] = vq.y; v[4 * q + 2] = vq.z; v[4 * q + 3] = vq.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      r[i] = i < mine ? __ldcs(a.row + lo + r0 + i) : 0;
      v[i] = i < mine ? __ldcs(a.val + lo + r0 + i) : 0.0f;
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
      for (int i = 0; i < kRun; ++i) x[i] = term<POW>(v[i], uu[i]);
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

template <int POW>
cudaError_t launch_b(const ColumnArgs& a, cudaStream_t s) {
  csc_column_sum<POW><<<a.tiles, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A on `stream`; returns the cudaError_t of the launch (0 on
// success).  loss: a kernel_id of ops/losses.py, or -1 for margins only (y,
// partial, ticket and value unused).  out: [n].  partial: [grid] scratch;
// ticket: one zeroed uint32 that every loss-mode launch leaves zeroed;
// value: [1].  w and o may be null.  lanes (threads per row, a power of
// two <= 32) and grid come from sparse_kernels.plan_margins.
int pmt_ell_margin_loss(int loss, const void* idx, const void* val, const void* c,
                        const void* y, const void* w, const void* o, void* out,
                        void* partial, void* ticket, void* value, long long n, int k,
                        int lanes, int grid, void* stream) {
  int log2p = 0;
  while ((1 << log2p) < lanes) ++log2p;
  // an empty tensor's pointer may be null: y only when there are no rows
  if (n < 0 || k < 1 || lanes < 1 || lanes > 32 || (1 << log2p) != lanes || grid < 1 ||
      (loss != kMargins && ((y == nullptr && n > 0) || partial == nullptr ||
                            ticket == nullptr || value == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const MarginArgs a{static_cast<const int*>(idx), static_cast<const float*>(val),
                     static_cast<const float*>(c), static_cast<const float*>(y),
                     static_cast<const float*>(w), static_cast<const float*>(o),
                     static_cast<float*>(out), static_cast<float*>(partial),
                     static_cast<unsigned int*>(ticket), static_cast<float*>(value),
                     n, k, log2p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kMargins: return static_cast<int>(launch_a<kMargins>(a, grid, s));
    case kLogistic: return static_cast<int>(launch_a<kLogistic>(a, grid, s));
    case kSquared: return static_cast<int>(launch_a<kSquared>(a, grid, s));
    case kPoisson: return static_cast<int>(launch_a<kPoisson>(a, grid, s));
    case kSmoothedHinge: return static_cast<int>(launch_a<kSmoothedHinge>(a, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel B on `stream`.  power 1 or 2; row and val 16-byte aligned;
// tile_col: [tiles + 1], sparse_kernels.tile_map of end; g: [d]; first,
// cont: [tiles] float scratch; span_col: [tiles] int scratch; ticket: one
// zeroed uint32 that every launch leaves zeroed.  tiles must be
// max(1, ceil(nnz / kTile)) and smem_bytes sizeof(ColumnSmem)
// (sparse_kernels.plan_columns).
int pmt_csc_column_sum(int power, const void* row, const void* val, const void* end,
                       const void* tile_col, const void* u, void* g, void* first,
                       void* cont, void* span_col, void* ticket, long long nnz, int d,
                       int tiles, int smem_bytes, void* stream) {
  const long long want = nnz > 0 ? (nnz + kTile - 1) / kTile : 1;
  const uintptr_t misaligned =
      (reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(val)) & 15u;
  if (nnz < 0 || d < 1 || tiles != want || (power != 1 && power != 2) ||
      tile_col == nullptr || smem_bytes != static_cast<int>(sizeof(ColumnSmem)) ||
      (nnz > 0 && misaligned != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const ColumnArgs a{static_cast<const int*>(row), static_cast<const float*>(val),
                     static_cast<const int*>(end), static_cast<const int*>(tile_col),
                     static_cast<const float*>(u), static_cast<float*>(g),
                     static_cast<float*>(first), static_cast<float*>(cont),
                     static_cast<int*>(span_col), static_cast<unsigned int*>(ticket), nnz,
                     d, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(power == 1 ? launch_b<1>(a, s) : launch_b<2>(a, s));
}

const char* pmt_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
