// Fused GLM value + gradient in ONE pass over a dense row-major X [n, d]:
//
//   z_i   = x_i . c (+ o_i) (+ b)
//   value = sum_i [m_i != 0] w_i l(z_i, y_i)
//   grad  = sum_i [m_i != 0] w_i l'(z_i, y_i) x_i   (= X^T (w * l'))
//   swl   = sum_i [m_i != 0] w_i l'(z_i, y_i)
//
// The row mask m is a select, not a multiply (as jnp.where in
// photon_ml_tpu/ops/aggregators.py): a masked row adds nothing, even where
// its loss is not finite.  b is one device scalar, the normalization shift
// -(c . s) folded into every margin; with swl the caller finishes the
// standardized gradient as grad - s * swl.
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_kernels.py::
// fused_value_and_gradient (pl.pallas_call at line 150, body _kernel at
// lines 54-86), for all four pointwise losses of ops/losses.py.  As the
// TPU kernel (xb = x_ref[:].astype(jnp.float32)), X comes in float32 or
// bfloat16 storage: the kernel is a template on X's element type, and a
// bf16 element becomes a float by __bfloat162float (exact) where it is
// read from shared memory; every other operand and every sum is f32.
//
// Bound on an H100: memory.  One pass must read X once, n*d*4 bytes (815 MB
// at the a1a config [1,643,520 x 124], 0.245 ms at the data sheet's
// 3.35 TB/s); the arithmetic is 4*n*d flops, ~0.01 ms at the f32 peak.  To
// reach the bound each SM needs ~18 KB of loads in flight at all times.
// With bf16 storage the pass reads n*d*2 bytes (408 MB at a1a, ~0.124 ms
// with the labels).
// What the design does about it:
//   - A persistent grid, one block per SM; block b takes tiles b, b + grid,
//     ...  A tile of R rows is one contiguous span of R*d*E bytes (~48 KB,
//     E = 4 or 2 bytes an element); R is a multiple of 16 / E where it can
//     be, so tiles of a 16-byte aligned X start on 16-byte boundaries.
//     (Tiles dealt out in turn measured a little faster than one
//     contiguous range per block.)
//   - A ring of S stages in dynamic shared memory.  One producer thread
//     fills each stage with cp.async.bulk copies (X's tile and the tile's
//     y, w, o, m) that complete on the stage's "full" mbarrier; the consumers
//     release it on its "empty" mbarrier.  The ring holds >= 96 KB of X
//     per SM (two 48 KB stages at d = 124), against the ~18 KB in flight
//     that the HBM rate needs.  A bulk copy needs a 16-byte aligned address
//     and size: it takes the aligned interior of each span, and the
//     consumers load the <= 16 / E - 1 elements at either ragged end (3
//     floats, 7 bf16) with ordinary loads (misaligned views, d not a
//     multiple of 16 / E, the last tile).
//   - The 256 consumer threads read only shared memory.  Margins: P
//     threads per row (P = 256 / R rounded down to a power of two <= 32)
//     take every P-th column and meet in log2(P) shuffles; the row's first
//     thread then computes the loss and s_r = w_r l'_r.  Gradient: thread t
//     owns the flat offsets t + 256 i of a group of K = 256 / d rows
//     (K = 1 when d > 256), i.e. fixed columns, and accumulates them in
//     registers across every tile of its block.  Neighbouring threads read
//     neighbouring floats, so neither phase has bank conflicts at d = 124.
//     X is read from device memory once, and nothing is read-modify-written
//     per row.  The tile's s lives in one of two buffers, by tile parity,
//     so a tile without ragged ends needs one consumer barrier.
//   - One launch per pass: each block writes one partial [value, grad] row,
//     takes a ticket, and the last block sums the partial rows in block
//     order and resets the ticket.  The sums run in a fixed order for a
//     given plan, so results are bit-stable from call to call.
//   - Weights default to 1, offsets and b to 0, and the mask to all rows
//     in-kernel (null pointers).  The mask is one more [rows] stream per
//     stage beside y, w and o.
//   - f32 (X also bf16) inputs, f32 accumulation, as the TPU kernel, but every running
//     sum (a thread's gradient registers, its value and sum(w l'), the
//     block's and the last block's sums) is compensated (Kahan): a thread
//     adds hundreds to thousands of terms in turn, and an uncompensated f32
//     sum of k terms drifts by up to ~k ulps, which the solvers' f32
//     line searches then amplify differently for a resident pass and a
//     streamed one.  Three adds per term, hidden behind the copies.
// The tile, stage and grid choice is made by the pure Python function
// photon_ml_tpu_torch/ops/hopper_kernels.py::plan_fused, which the CPU
// tests replay; smem_layout() below must agree with it, and the entry point
// refuses a plan whose shared-memory size it does not reproduce.
//
// Plain C interface, bound with ctypes.  Build (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_value_and_gradient.so \
//        fused_value_and_gradient.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;             // threads 0..255
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
// dynamic shared memory a plan may ask for: Hopper's 232,448 bytes per
// block less 1 KB for the kernel's static shared memory
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kReduceUnroll = 16;

enum Loss : int { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ float pm1(float y) { return y > 0.5f ? 1.0f : -1.0f; }

// softplus(t) = log(1 + exp(t)) = max(t, 0) + log1p(exp(-|t|)) and
// sigmoid(t) = 1 / (1 + exp(-t)), both without overflow, from one
// e = exp(-|t|)
__device__ __forceinline__ void softplus_sigmoid(float t, float& sp, float& sg) {
  const float e = expf(-fabsf(t));
  sp = fmaxf(t, 0.0f) + log1pf(e);
  sg = t >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

// (l, dl/dz) of photon_ml_tpu/ops/losses.py, labels {0,1} remapped to +-1
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

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// X's element as a float: exact for both storage types
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A compensated (Kahan) running sum: the rounding error of each addition
// is carried into the next, so value() is within a few ulps of the exact
// sum however many terms it took.  (nvcc keeps the order: no fast math.)
struct KahanSum {
  float s = 0.0f, c = 0.0f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
  __device__ __forceinline__ float value() const { return s - c; }
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Shared memory, in floats from the (16-byte aligned) base: S stages of
// [X tile | y | w | o | m], then c [d], two buffers of the tiles' s = w*l'
// [R], a reduction area [3 * kConsumers], then 2*S mbarriers (full,
// empty).  Each array starts on 16 bytes and leaves 16 - E bytes of room
// (E = xbytes for the X tile, 4 for the rest), because element k of a
// span sits at (address / E) % (16 / E) + k so that its 16-byte chunks
// line up.
struct Layout {
  int stage_x, stage_v, stage, c, s, red, bars, bytes;
};

__host__ __device__ Layout smem_layout(int d, int rows, int stages, int xbytes) {
  Layout L;
  L.stage_x = round4((xbytes * rows * d + 19 - xbytes) / 4);
  L.stage_v = round4(rows + 3);
  L.stage = L.stage_x + 4 * L.stage_v;
  L.c = stages * L.stage;
  L.s = L.c + round4(d);
  L.red = L.s + 2 * round4(rows);
  L.bars = L.red + 3 * kConsumers;
  L.bytes = L.bars * 4 + 2 * stages * 8;
  return L;
}

// The 16-byte aligned interior [a, b) of the byte span of `count` elements
// of type E at `src`.  Element k of the span lives at buf[phase + k].
template <typename E>
struct Span {
  const E* src;
  int count, phase, head, tail;  // head: elements before a; tail: first element at/after b
  uint32_t bytes;                // b - a, 0 when there is no aligned interior
};

template <typename E>
__device__ __forceinline__ Span<E> span_of(const E* src, int count) {
  constexpr int kE = (int)sizeof(E);
  Span<E> s;
  s.src = src;
  s.count = count;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src);
  const uintptr_t hi = lo + (uint64_t)kE * (uint64_t)count;
  const uintptr_t a = (lo + 15) & ~uintptr_t(15);
  const uintptr_t b = hi & ~uintptr_t(15);
  s.phase = (int)((lo & 15) / kE);
  if (src != nullptr && b > a) {
    s.head = (int)((a - lo) / kE);
    s.tail = (int)((b - lo) / kE);
    s.bytes = (uint32_t)(b - a);
  } else {
    s.head = count;
    s.tail = count;
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

// Copy the aligned interior of `s` into buf (element k at buf[phase + k]).
template <typename E>
__device__ __forceinline__ void bulk_load(E* buf, const Span<E>& s, uint64_t* bar) {
  if (s.bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(buf + s.phase + s.head)), "l"(s.src + s.head), "r"(s.bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// The elements of `s` the bulk copy cannot take, by ordinary loads.
template <typename E>
__device__ __forceinline__ void load_edges(E* buf, const Span<E>& s, int t) {
  if (t < s.head) buf[s.phase + t] = s.src[t];
  const int k = s.tail + t;
  if (k < s.count && k >= s.head) buf[s.phase + k] = s.src[k];
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The kernel's operands.  w, o, m and b may be null.
struct Args {
  const void* x;   // [n, d] row-major, float or __nv_bfloat16
  const float* y;
  const float* w;
  const float* o;
  const float* m;        // row mask [n]
  const float* b;        // margin shift, one scalar
  const float* c;        // [d]
  float* partial;        // [gridDim.x, d + 2] scratch
  unsigned int* ticket;  // zero before and after every launch
  float* out;            // [d + 2] = [value, grad, swl]
  int64_t n;
  int d, rows, stages;   // rows per tile, ring stages
  int xbytes;            // X's element size: 4 (float) or 2 (__nv_bfloat16)
};

// One block per SM.  Block b takes tiles b, b + gridDim.x, ... of `rows`
// rows each: at any moment the blocks stream one window of X, and no block
// has more than one tile more than another.  NACC: gradient registers per
// consumer thread (1 when d <= 256; else ceil(d / 256) rounded up to the
// instantiated size).  T: X's element type, float or __nv_bfloat16.
template <int LOSS, int NACC, typename T>
__global__ void __launch_bounds__(kThreads, 1) fvg_tma(const Args a) {
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const float* __restrict__ y = a.y;
  const float* __restrict__ w = a.w;
  const float* __restrict__ o = a.o;
  const float* __restrict__ m = a.m;
  const int64_t n = a.n;
  const int d = a.d, rows = a.rows, stages = a.stages;
  extern __shared__ __align__(16) float smem[];
  const Layout L = smem_layout(d, rows, stages, (int)sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  float* c_s = smem + L.c;
  float* s_s = smem + L.s;
  float* red = smem + L.red;
  __shared__ bool is_last;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int64_t first_row = (int64_t)blockIdx.x * rows;
  const int64_t row_step = (int64_t)gridDim.x * rows;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int j = t; j < d; j += kThreads) c_s[j] = a.c[j];
  __syncthreads();

  KahanSum acc[NACC];
  KahanSum v_acc, s_acc;

  if (t >= kConsumers) {
    // producer warp: lane 0 keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t parity = 1;  // a fresh barrier's previous phase counts as complete
      for (int64_t r0 = first_row; r0 < n; r0 += row_step) {
        mbar_wait(&empty[stage], parity);
        const int nr = (int)min64(rows, n - r0);
        float* buf = smem + stage * L.stage;
        const Span<T> sx = span_of(x + r0 * d, nr * d);
        const Span<float> sy = span_of(y + r0, nr);
        const Span<float> sw = span_of(w == nullptr ? nullptr : w + r0, nr);
        const Span<float> so = span_of(o == nullptr ? nullptr : o + r0, nr);
        const Span<float> sm = span_of(m == nullptr ? nullptr : m + r0, nr);
        const uint32_t bytes = sx.bytes + sy.bytes + sw.bytes + so.bytes + sm.bytes;
        if (bytes == 0) {
          mbar_arrive(&full[stage]);
        } else {
          mbar_arrive_expect_tx(&full[stage], bytes);
          bulk_load(reinterpret_cast<T*>(buf), sx, &full[stage]);
          bulk_load(buf + L.stage_x, sy, &full[stage]);
          bulk_load(buf + L.stage_x + L.stage_v, sw, &full[stage]);
          bulk_load(buf + L.stage_x + 2 * L.stage_v, so, &full[stage]);
          bulk_load(buf + L.stage_x + 3 * L.stage_v, sm, &full[stage]);
        }
        if (++stage == stages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // consumers
    const int log2p = rows <= 8 ? 5 : (rows >= kConsumers ? 0 : 31 - __clz(kConsumers / rows));
    const int P = 1 << log2p;
    const int rows_per_pass = kConsumers >> log2p;
    const int sub = t & (P - 1);
    const int row_in_pass = t >> log2p;
    const int K = NACC == 1 ? kConsumers / d : 1;  // rows per gradient group
    const int span = K * d;
    const int kt = NACC == 1 ? t / d : 0;
    const float zb = a.b != nullptr ? *a.b : 0.0f;
    int stage = 0;
    uint32_t parity = 0;
    int sbuf = 0;
    for (int64_t r0 = first_row; r0 < n; r0 += row_step) {
      mbar_wait(&full[stage], parity);
      const int nr = (int)min64(rows, n - r0);
      float* buf = smem + stage * L.stage;
      const Span<T> sx = span_of(x + r0 * d, nr * d);
      const Span<float> sy = span_of(y + r0, nr);
      const Span<float> sw = span_of(w == nullptr ? nullptr : w + r0, nr);
      const Span<float> so = span_of(o == nullptr ? nullptr : o + r0, nr);
      const Span<float> sm = span_of(m == nullptr ? nullptr : m + r0, nr);
      const T* bx = reinterpret_cast<const T*>(buf) + sx.phase;
      float* by = buf + L.stage_x + sy.phase;
      float* bw = buf + L.stage_x + L.stage_v + sw.phase;
      float* bo = buf + L.stage_x + 2 * L.stage_v + so.phase;
      float* bm = buf + L.stage_x + 3 * L.stage_v + sm.phase;
      float* s_t = s_s + sbuf * round4(rows);
      // the same on every thread: does this tile have floats the bulk
      // copies did not bring?
      const bool edges = sx.head > 0 || sx.tail < sx.count || sy.head > 0 ||
                         sy.tail < sy.count ||
                         (w != nullptr && (sw.head > 0 || sw.tail < sw.count)) ||
                         (o != nullptr && (so.head > 0 || so.tail < so.count)) ||
                         (m != nullptr && (sm.head > 0 || sm.tail < sm.count));
      if (edges) {
        load_edges(reinterpret_cast<T*>(buf), sx, t);
        load_edges(buf + L.stage_x, sy, t);
        if (w != nullptr) load_edges(buf + L.stage_x + L.stage_v, sw, t);
        if (o != nullptr) load_edges(buf + L.stage_x + 2 * L.stage_v, so, t);
        if (m != nullptr) load_edges(buf + L.stage_x + 3 * L.stage_v, sm, t);
        consumer_sync();
      }

      // margins, then the loss on each row's first thread
      const int passes = (nr + rows_per_pass - 1) / rows_per_pass;
      for (int q = 0; q < passes; ++q) {
        const int r = q * rows_per_pass + row_in_pass;
        float dot = 0.0f;
        if (r < nr) {
          const T* xr = bx + r * d;
#pragma unroll 8
          for (int j = sub; j < d; j += P) dot += to_f(xr[j]) * c_s[j];
        }
        for (int off = P >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (sub == 0 && r < nr) {
          float z = dot + zb;
          if (o != nullptr) z += bo[r];
          float l, dl;
          loss_and_dz<LOSS>(z, by[r], l, dl);
          const float wt = w != nullptr ? bw[r] : 1.0f;
          // a select: a masked row's (possibly non-finite) terms never enter
          const bool keep = m == nullptr || bm[r] != 0.0f;
          const float sr = keep ? wt * dl : 0.0f;
          s_t[r] = sr;
          s_acc.add(sr);
          if (keep) v_acc.add(wt * l);
        }
      }
      consumer_sync();

      // gradient: registers over fixed columns
      if constexpr (NACC == 1) {
        if (t < span) {
          const int groups = (nr - kt + K - 1) / K;
#pragma unroll 8
          for (int g = 0; g < groups; ++g) acc[0].add(to_f(bx[g * span + t]) * s_t[g * K + kt]);
        }
      } else {
        for (int r = 0; r < nr; ++r) {
          const float sr = s_t[r];
          const T* xr = bx + r * d;
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const int f = t + i * kConsumers;
            if (f < d) acc[i].add(to_f(xr[f]) * sr);
          }
        }
      }
      // our generic writes to the stage happen before the next bulk copy into it
      if (edges) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
      sbuf ^= 1;
    }
  }

  // block partial [value, grad, swl] in a fixed order
  __syncthreads();
  if (t < kConsumers) {
    red[t] = v_acc.value();
    if (NACC == 1) red[kConsumers + t] = acc[0].value();
    red[2 * kConsumers + t] = s_acc.value();
  }
  __syncthreads();
  float* prow = a.partial + (int64_t)blockIdx.x * (d + 2);
  if (t == 0) {
    KahanSum v, sw;
    for (int k = 0; k < kConsumers; ++k) {
      v.add(red[k]);
      sw.add(red[2 * kConsumers + k]);
    }
    prow[0] = v.value();
    prow[d + 1] = sw.value();
  }
  if constexpr (NACC == 1) {
    const int K = kConsumers / d;
    for (int j = t; j < d; j += kThreads) {
      KahanSum g;
      for (int k = 0; k < K; ++k) g.add(red[kConsumers + k * d + j]);
      prow[1 + j] = g.value();
    }
  } else if (t < kConsumers) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int f = t + i * kConsumers;
      if (f < d) prow[1 + f] = acc[i].value();
    }
  }

  // the last block to finish sums the partial rows in block order
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int width = d + 2;
  const int blocks = gridDim.x;
  for (int col = t; col < width; col += kThreads) {
    KahanSum sum;
    int b = 0;
    for (; b + kReduceUnroll <= blocks; b += kReduceUnroll) {
      float v[kReduceUnroll];
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u)
        v[u] = __ldcg(a.partial + (int64_t)(b + u) * width + col);
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) sum.add(v[u]);
    }
    for (; b < blocks; ++b) sum.add(__ldcg(a.partial + (int64_t)b * width + col));
    a.out[col] = sum.value();
  }
  if (t == 0) *a.ticket = 0u;  // ready for the next call on this stream
}

template <int LOSS, int NACC, typename T>
cudaError_t launch_as(const Args& a, int grid, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      fvg_tma<LOSS, NACC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fvg_tma<LOSS, NACC, T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation for X's storage type
template <int LOSS, int NACC>
cudaError_t launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  return a.xbytes == 2 ? launch_as<LOSS, NACC, __nv_bfloat16>(a, grid, smem, stream)
                       : launch_as<LOSS, NACC, float>(a, grid, smem, stream);
}

template <int LOSS>
cudaError_t dispatch_acc(int nacc, const Args& a, int grid, int smem, cudaStream_t s) {
  switch (nacc) {
    case 1: return launch<LOSS, 1>(a, grid, smem, s);
    case 2: return launch<LOSS, 2>(a, grid, smem, s);
    case 8: return launch<LOSS, 8>(a, grid, smem, s);
    case 32: return launch<LOSS, 32>(a, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the one kernel of a pass on `stream`; returns the cudaError_t of
// the launch (0 on success).  The plan (rows, stages, grid, acc_per_thread,
// smem_bytes) comes from hopper_kernels.plan_fused; a plan that does not
// fit this source's layout is refused.  xbytes: X's element size, 4
// (float32) or 2 (bfloat16); every other operand is float32.  partial:
// [grid, d + 2] scratch;
// ticket: one zeroed uint32 that every launch leaves zeroed; out: [d + 2] =
// [value, grad[0..d), swl].  w, o, m (row mask) and b (one margin shift)
// may be null.
int pmt_fused_value_and_gradient(int loss, int xbytes, const void* x, const void* y,
                                 const void* w, const void* o, const void* m,
                                 const void* b, const void* c,
                                 void* partial, void* ticket, void* out, long long n,
                                 int d, int rows, int stages, int grid,
                                 int acc_per_thread, int smem_bytes, void* stream) {
  const bool acc_ok = acc_per_thread == 1 ? d <= kConsumers
                                          : d <= acc_per_thread * kConsumers;
  if (n < 0 || d < 1 || rows < 1 || stages < 1 || grid < 1 || !acc_ok ||
      (xbytes != 4 && xbytes != 2) || smem_bytes > kMaxSmem ||
      smem_layout(d, rows, stages, xbytes).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(y),
               static_cast<const float*>(w), static_cast<const float*>(o),
               static_cast<const float*>(m), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(partial),
               static_cast<unsigned int*>(ticket), static_cast<float*>(out),
               n, d, rows, stages, xbytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (loss) {
    case kLogistic: e = dispatch_acc<kLogistic>(acc_per_thread, a, grid, smem_bytes, s); break;
    case kSquared: e = dispatch_acc<kSquared>(acc_per_thread, a, grid, smem_bytes, s); break;
    case kPoisson: e = dispatch_acc<kPoisson>(acc_per_thread, a, grid, smem_bytes, s); break;
    case kSmoothedHinge:
      e = dispatch_acc<kSmoothedHinge>(acc_per_thread, a, grid, smem_bytes, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* pmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
