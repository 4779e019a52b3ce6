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
//   - B: the column-sorted stream is cut into tiles of kTile = 2048
//     nonzeros, one block per tile.  The block stages val^POW * u[row] for
//     its tile in shared memory with coalesced loads, then its warps sum
//     the columns that meet the tile from shared memory, one warp per
//     column portion.  So no column is summed by one warp across the whole
//     stream: the intercept column (every row: 200,000 entries at config 6
//     against a mean of ~51) is split across ~98 tiles that run in
//     parallel.  A tile owns the columns that START in it; a column that
//     ends in the tile where it starts is written there.  The one owned
//     column that runs past the tile's end writes its portion to
//     first[tile]; a tile's leading portion of a column begun earlier goes
//     to cont[tile].  The last block to finish (by ticket) adds, for each
//     such column, first[tile] and the cont[] of the tiles it runs through,
//     in tile order.  No atomics touch g, and every sum has a fixed order:
//     results are bit-stable.  Empty columns are owned by the tile their
//     position falls in, and get 0.
//   - f32 inputs, f32 accumulation.  Indices are int32 (the wrapper checks
//     n*k < 2^31 and nnz < 2^31).  Weights default to 1 and offsets to 0
//     (null pointers).
// The grid of A and the tiles of B come from the pure Python functions
// photon_ml_tpu_torch/ops/sparse_kernels.py::plan_margins and
// ::plan_columns, which the CPU tests replay.
//
// Plain C interface, bound with ctypes.  Build (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libell_sparse.so ell_sparse.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;  // stream elements per block of kernel B
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
  const int* row;    // [nnz] row ids, column-sorted
  const float* val;  // [nnz]
  const int* end;    // [d + 1]: column j is [end[j], end[j+1])
  const float* u;    // [n]
  float* g;          // [d]
  float* first;      // [tiles]: portion of the owned column that runs on
  float* cont;       // [tiles]: portion of the column begun in an earlier tile
  int* span_col;     // [tiles]: the owned column that runs on, or -1
  unsigned int* ticket;
  int64_t nnz;
  int d, tiles;
};

// the first j in [0, d) with end[j] >= p, or d
__device__ int lower_bound(const int* end, int d, int64_t p) {
  int lo = 0, hi = d;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)end[mid] < p) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int POW>
__global__ void __launch_bounds__(kThreads) csc_column_sum(const ColumnArgs a) {
  __shared__ float prod[kTile];
  __shared__ int cols[2];
  __shared__ bool is_last;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int tile = blockIdx.x;
  const int64_t lo = (int64_t)tile * kTile;
  const int64_t hi = lo + kTile < a.nnz ? lo + kTile : a.nnz;
  const int len = (int)(hi - lo);
  for (int e = t; e < len; e += kThreads) {
    const float v = a.val[lo + e];
    prod[e] = (POW == 2 ? v * v : v) * __ldg(a.u + a.row[lo + e]);
  }
  // owned columns [j0, j1): those whose start falls in [lo, hi), and in
  // the last tile also those that start at nnz (empty trailing columns)
  if (t == 0) {
    cols[0] = lower_bound(a.end, a.d, lo);
    a.span_col[tile] = -1;
  }
  if (t == 32) cols[1] = tile == a.tiles - 1 ? a.d : lower_bound(a.end, a.d, hi);
  __syncthreads();
  const int j0 = cols[0], j1 = cols[1];
  // column j0 - 1 began before this tile and reaches into it
  const int has_cont = (j0 > 0 && (int64_t)a.end[j0] > lo) ? 1 : 0;
  const int items = j1 - j0 + has_cont;
  for (int it = warp; it < items; it += kWarps) {
    const int j = j0 + it - has_cont;
    const int64_t s = (has_cont && it == 0) ? lo : (int64_t)a.end[j];
    const int64_t stop = (int64_t)a.end[j + 1];
    const int64_t e = stop < hi ? stop : hi;
    float sum = 0.0f;
    for (int64_t p = s + lane; p < e; p += 32) sum += prod[p - lo];
    sum = warp_sum(sum);
    if (lane == 0) {
      if (has_cont && it == 0) {
        a.cont[tile] = sum;
      } else if (stop > hi) {
        a.first[tile] = sum;
        a.span_col[tile] = j;
      } else {
        a.g[j] = sum;
      }
    }
  }

  // the last block to finish completes the columns that span tiles, each
  // in tile order
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int q = t; q < a.tiles; q += kThreads) {
    const int j = __ldcg(a.span_col + q);
    if (j < 0) continue;
    float sum = __ldcg(a.first + q);
    const int last = (int)(((int64_t)a.end[j + 1] - 1) / kTile);
    for (int r = q + 1; r <= last; ++r) sum += __ldcg(a.cont + r);
    a.g[j] = sum;
  }
  __syncthreads();
  if (t == 0) *a.ticket = 0u;  // ready for the next call on this stream
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

// Kernel B on `stream`.  power 1 or 2; g: [d]; first, cont: [tiles] float
// scratch; span_col: [tiles] int scratch; ticket: one zeroed uint32 that
// every launch leaves zeroed.  tiles must be max(1, ceil(nnz / 2048))
// (sparse_kernels.plan_columns).
int pmt_csc_column_sum(int power, const void* row, const void* val, const void* end,
                       const void* u, void* g, void* first, void* cont, void* span_col,
                       void* ticket, long long nnz, int d, int tiles, void* stream) {
  const long long want = nnz > 0 ? (nnz + kTile - 1) / kTile : 1;
  if (nnz < 0 || d < 1 || tiles != want || (power != 1 && power != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const ColumnArgs a{static_cast<const int*>(row), static_cast<const float*>(val),
                     static_cast<const int*>(end), static_cast<const float*>(u),
                     static_cast<float*>(g), static_cast<float*>(first),
                     static_cast<float*>(cont), static_cast<int*>(span_col),
                     static_cast<unsigned int*>(ticket), nnz, d, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(power == 1 ? launch_b<1>(a, s) : launch_b<2>(a, s));
}

const char* pmt_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
