// Fused GLM value + gradient for K coefficient vectors ("candidate lanes")
// in ONE pass over a dense row-major X [n, d]:
//
//   z_ik    = x_i . c_k + o_ki + b_k
//   u_ik    = w_i * bit_k(q_i)
//   value_k = sum_i [m_i != 0] u_ik l(z_ik, y_i)
//   grad_k  = sum_i [m_i != 0] u_ik l'(z_ik, y_i) x_i
//   swl_k   = sum_i [m_i != 0] u_ik l'(z_ik, y_i)
//
// for k < K <= 16, all four pointwise losses of ops/losses.py.  The mask
// is a select (a masked row adds nothing, even a non-finite loss); w, o, m,
// b and q may be null (1, 0, every row, 0, every bit set).  b_k is the
// normalization shift -(c_k (.) f) . s of lane k, and with swl_k the caller
// finishes a standardized gradient as grad_k - s * swl_k, as for the single
// kernel.  q is the lane mask, one 32-bit word per row whose bit k says
// whether lane k keeps the row: a 0/1 factor on the row's weight, not a
// select, so lane k's terms are exactly those of weights w * bit_k (a
// dropped row whose loss is not finite gives NaN in that lane alone, 0 *
// inf).  A bootstrap's replicas are such lanes
// (photon_ml_tpu/diagnostics/bootstrap.py:86-92, jax.vmap of the solve
// over weight rows member_k * w).
//
// No TPU kernel behind it: this is the port's hand kernel for the fixed
// effect's visit of a hyperparameter sweep's candidate lane,
// photon_ml_tpu/hyperparameter/vectorized.py::_fe_sweep_update (:92-112),
// where jax.vmap of the solve over the candidates turns XLA's
// value_and_gradient (photon_ml_tpu/ops/aggregators.py) into X C^T and
// X^T S, one read of X for all K candidates.  Launching the single fused
// kernel K times would read X K times.
//
// Bound on an H100: memory.  A pass must read X once, O once and y, w
// once: at config 4's fixed effect (n = 950,051, d = 31, K = 16) about
// 182 MB, 0.055 ms at the data sheet's 3.35 TB/s.  The arithmetic is two
// skinny products, Z = X C^T [n x K] and G = X^T S [d x K], 4 n d K flops
// (1.9 GFLOP at config 4, 13 GFLOP at config 1's width [1,643,520 x 124]).
// On CUDA cores, with a compensated add per term, that arithmetic held the
// first version of this kernel at ~10 % of its bound; here it runs on the
// tensor cores.  The design:
//   - A persistent grid, one block per SM: 512 consumer threads (16
//     warps) and one producer warp.  Block b takes row tiles b, b + grid,
//     ...; a tile holds R rows, R a multiple of 8 (so tiles of a 16-byte
//     aligned X stay aligned).  The producer warp fills a ring of S >= 2
//     whole tiles on full/empty mbarriers, as the single kernel does, one
//     span of a tile per lane: X's R d contiguous floats, y, w, m, and each
//     lane's run of O.  A lane copies its span's 16-byte aligned interior
//     by one cp.async.bulk and the <= 3 floats at either ragged end (a
//     misaligned view, the last tile) by 4-byte cp.async copies the same
//     barrier tracks, so the K + 4 copies of a tile are issued side by side
//     and no lane waits for them.  (17 warps leave 96 registers a thread,
//     and the gradient slots of the widest widths spill a little; on an
//     H100 the pass without the producer warp, warp 0 refilling the ring
//     between phases, took 11-15 % longer.)  O keeps its [K, n] layout: at an odd n,
//     lane k's run starts on k n floats and is misaligned, which only moves
//     which <= 6 floats of the run its lane loads itself.
//   - Both products on the tensor cores, mma.sync m16n8k8 in TF32, each
//     operand split v = hi + lo into two TF32 numbers and three products
//     taken (hi hi, and lo hi + hi lo), which keeps float32's accuracy.
//     Each starts from zero and its sum of 8 terms is added to a float32
//     accumulator, so no long chain of tensor-core sums forms.
//     Margins: Z [16 rows x 8 lanes] += X_tile [16 x 8 columns] C^T; C
//     sits in shared memory once per block, in B-fragment order, zero past
//     K and d.  When a tile has fewer than 8 m-tiles of 16 rows, warps that
//     share an m-tile take a slice of the columns each and the loss step
//     adds their partial margins in a fixed order.  Gradient: G [16 columns
//     x 8 lanes] += X_tile^T [16 x 8 rows] S_tile, the units (16 columns,
//     8 rows) of a tile dealt to the warps in 16 equal runs.  Fragments are
//     gathered from the tile as copied (row stride d); X entries past d or
//     past the tile's rows are selected to 0, so a neighbouring row never
//     enters a sum.  At an odd d a warp's fragment loads meet up to 4-way
//     bank conflicts; row orders that avoid them cost registers at the
//     96-register cap and measured slower.
//   - The loss step: each warp takes (8 rows, 8 lanes) blocks of s, each
//     thread the two elements the gradient's B fragment gives it (a fixed
//     lane, rows tig and tig + 4); it adds the partial margins, o and b,
//     computes the loss, w l and s = w l', and writes s, split into hi and
//     lo, as one float2 of that fragment (a warp writes 256 contiguous
//     bytes).
//   - Compensation once per tile, not once per term: each gradient unit's
//     float32 sum over the tile's rows is folded into a Kahan pair per
//     entry; values and sums of w l' are compensated per thread, then per
//     block.  A candidate's pass lands where an isolated fit's does.
//   - Two consumer barriers a tile: margins -> loss -> gradient.
//   - One launch per pass: each block writes a partial [K, d + 2] row
//     block, takes a ticket, and the last block sums the partials in block
//     order and resets the ticket, so results are bit-stable from call to
//     call.
// The tile, ring and grid come from the pure Python function
// photon_ml_tpu_torch/ops/hopper_kernels.py::plan_lanes (the CPU tests
// replay it); smem_layout() below must agree with it, and the entry point
// refuses a plan whose shared-memory size it does not reproduce.
//
// The lane mask is one more per-row span of a stage (after O's runs), and
// the kernel that reads it is its own instantiation (LM = true), so the
// sweep's instantiations (LM = false) are the ones they were.
//
// bfloat16 storage: X's element type XT is a template parameter (float or
// __nv_bfloat16), as in the single fused kernel; every other operand stays
// float32.  The ring holds X's 2-byte elements as they are (a stage's X
// tile is half as large), the bulk copy takes the tile's 16-byte aligned
// interior and the producer lane copies the <= 7 elements at either ragged
// end by ordinary 2-byte loads and stores, which the stage's full barrier
// orders like the rest (its arrive releases them).  A bf16 value is exact
// in TF32 (8 significand bits of TF32's 11), so X enters both products as
// a native operand: its TF32 bits are the bf16 bits shifted up, its lo
// part is zero, and of the three products of the float32 path the one
// that takes X's lo is dropped (lo hi of C and S stays).
//
// LANES_PHASES (scripts/lanes_sweep.py builds the ablations): 1 = the
// ring alone (consumers wait for each tile and release it), 2 = the ring,
// the margins and the loss, 3 = the whole pass (the default).
//
// Plain C interface, bound with ctypes.  Build (sm_90a; add
// -DLANES_XBYTES=2 for the bf16 X library):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_value_and_gradient_lanes.so \
//        fused_value_and_gradient_lanes.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LANES_PHASES
#define LANES_PHASES 3
#endif

// X's element size this library's instantiations take: 4 (float) or, built
// with -DLANES_XBYTES=2, 2 (__nv_bfloat16).  ops/_build.py builds both
// libraries from this source, side by side, so neither build carries the
// other's instantiations; the entry refuses the other size.
#ifndef LANES_XBYTES
#define LANES_XBYTES 4
#endif

namespace {

constexpr int kConsumers = 512;             // threads 0..511
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kMaxLanes = 16;
// dynamic shared memory a plan may ask for: Hopper's 232,448 bytes per
// block less 1 KB for the kernel's static shared memory
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kReduceUnroll = 16;

enum Loss : int { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ float pm1(float y) { return y > 0.5f ? 1.0f : -1.0f; }

__device__ __forceinline__ void softplus_sigmoid(float t, float& sp, float& sg) {
  const float e = expf(-fabsf(t));
  sp = fmaxf(t, 0.0f) + log1pf(e);
  sg = t >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

// (l, dl/dz) of photon_ml_tpu/ops/losses.py, labels {0,1} remapped to +-1;
// the same code as the single kernel's, the loss chosen per launch
__device__ __forceinline__ void loss_and_dz(int loss, float z, float y, float& l, float& dl) {
  if (loss == kLogistic) {
    const float yy = pm1(y);
    float sg;
    softplus_sigmoid(-yy * z, l, sg);
    dl = -yy * sg;
  } else if (loss == kSquared) {
    const float r = z - y;
    l = 0.5f * r * r;
    dl = r;
  } else if (loss == kPoisson) {
    const float e = expf(z);
    l = e - y * z;
    dl = e - y;
  } else {
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
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// n-tiles of 8 lanes: 1 for K <= 8, else 2
__host__ __device__ constexpr int lane_tiles(int lanes) { return lanes > 8 ? 2 : 1; }

// the partial margins' row stride, 8 or 24 floats: the margins' float2
// writes (rows by gid) and the loss step's reads (rows by tig) spread over
// the banks
__host__ __device__ constexpr int zp_row(int nt) { return 8 * nt + 8 * (nt - 1); }

// The margins' m-tiles of 16 rows in a tile, and the warps that share one
// (each a slice of the columns) when there are fewer than 8.
__host__ __device__ constexpr int margin_tiles(int rows) { return cdiv(rows, 16); }
__host__ __device__ constexpr int margin_split(int rows) {
  return margin_tiles(rows) < kConsumerWarps ? kConsumerWarps / margin_tiles(rows) : 1;
}

// The gradient's units (m-tile of 16 columns, chunk of 8 rows), numbered
// m-tile by m-tile: warp w takes units [unit_lo(w), unit_lo(w + 1)).
__host__ __device__ constexpr int unit_lo(int w, int units) {
  return (int)((int64_t)w * units / kConsumerWarps);
}

// the most m-tiles (accumulator slots) one warp's run of units touches
__host__ __device__ inline int grad_slots(int d, int rows) {
  const int q = cdiv(rows, 8), units = cdiv(d, 16) * q;
  int most = 0;
  for (int w = 0; w < kConsumerWarps; ++w) {
    const int lo = unit_lo(w, units), hi = unit_lo(w + 1, units);
    const int s = hi > lo ? (hi - 1) / q - lo / q + 1 : 0;
    most = s > most ? s : most;
  }
  return most;
}

// Shared memory, in floats from the (16-byte aligned) base: `stages`
// stages of [X tile (rows d elements of xbytes bytes, and 16 - xbytes
// bytes of room) | y | w | m | O (K runs) | q (with a lane mask)], each
// array on 16 bytes with room for its phase (element k of a span sits at
// its phase + k); after the last tile the gradient's per-warp sums reuse the ring
// (cf is past whichever is larger); then C in B-fragment order
// [ceil(d / 8) chunks][n-tiles][32][2], the partial margins [split][16 m-
// tiles][zp_row floats], s in B-fragment order
// [ceil(rows / 8)][n-tiles][hi,
// lo][32][2], the value/sum(w l') reduction area [2][512], then 2 stages
// mbarriers (full, empty).
struct Layout {
  int stage_x, stage_v, stage, cf, zp, sf, vs, bars, bytes;
};

__host__ __device__ inline Layout smem_layout(int d, int lanes, int rows, int stages,
                                              bool lane_mask, int xbytes) {
  Layout L;
  const int kp = 8 * lane_tiles(lanes);
  L.stage_x = round4((xbytes * rows * d + 19 - xbytes) / 4);
  L.stage_v = round4(rows + 3);
  L.stage = L.stage_x + (3 + lanes + (lane_mask ? 1 : 0)) * L.stage_v;
  const int ring = stages * L.stage;
  const int gred = kConsumerWarps * grad_slots(d, rows) * lane_tiles(lanes) * 128;
  L.cf = ring > gred ? ring : gred;
  L.zp = L.cf + cdiv(d, 8) * 8 * kp;
  L.sf = L.zp + margin_split(rows) * margin_tiles(rows) * 16 * zp_row(lane_tiles(lanes));
  L.vs = L.sf + cdiv(rows, 8) * 8 * kp * 2;
  L.bars = L.vs + 2 * kConsumers;
  L.bytes = L.bars * 4 + 2 * stages * 8;
  return L;
}

// The 16-byte aligned interior [a, b) of the byte span of `count`
// elements of `es` bytes (4, or 2 for a bf16 X) at `src`.  Element k of
// the span lives at element phase + k of its buffer.
struct Span {
  const char* src;
  int es;
  int count, phase, head, tail;  // head: elements before a; tail: first element at/after b
  uint32_t bytes;                // b - a, 0 when there is no aligned interior
};

__device__ __forceinline__ Span span_of(const void* src, int count, int es = 4) {
  Span s;
  s.src = static_cast<const char*>(src);
  s.es = es;
  s.count = count;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src);
  const uintptr_t hi = lo + (uint64_t)es * (uint64_t)count;
  const uintptr_t a = (lo + 15) & ~uintptr_t(15);
  const uintptr_t b = hi & ~uintptr_t(15);
  s.phase = (int)((lo & 15) / es);
  if (src != nullptr && b > a) {
    s.head = (int)((a - lo) / es);
    s.tail = (int)((b - lo) / es);
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

// Copy the aligned interior of `s` into buf (element k at element
// phase + k of buf).
__device__ __forceinline__ void bulk_load(char* buf, const Span& s, uint64_t* bar) {
  if (s.bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(buf + (s.phase + s.head) * s.es)), "l"(s.src + s.head * s.es),
      "r"(s.bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// One element of a span's ragged end: a 4-byte cp.async copy, or for a
// 2-byte element (cp.async copies 4 bytes or more) an ordinary load and
// store, which the stage's full barrier orders (the lane arrives on it
// after its stores).
__device__ __forceinline__ void copy_edge(char* buf, const Span& s, int k) {
  char* dst = buf + (s.phase + k) * s.es;
  if (s.es == 4) cp_async4(reinterpret_cast<float*>(dst),
                           reinterpret_cast<const float*>(s.src) + k);
  else *reinterpret_cast<uint16_t*>(dst) = reinterpret_cast<const uint16_t*>(s.src)[k];
}

// The elements of `s` the bulk copy cannot take (<= 16 / es - 1 at either
// end), copied by one thread; `bar` tracks the cp.async copies, so the
// thread goes on without waiting for them.
__device__ __forceinline__ void load_edges(char* buf, const Span& s, uint64_t* bar) {
  for (int k = 0; k < s.head; ++k) copy_edge(buf, s, k);
  for (int k = s.tail > s.head ? s.tail : s.head; k < s.count; ++k) copy_edge(buf, s, k);
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// v = hi + lo, both TF32 (lo carries the bits hi drops)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// d += a b, one m16n8k8 TF32 product with float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b to float32's accuracy, as big + small: the product hi hi summed
// from zero and added to big by a rounded float32 add, the two small ones
// lo hi + hi lo (2^-11 of it) summed into small on the tensor cores.  (The
// tensor cores' own sums round toward zero: a long chain of them drifts
// one way, one group of 8 terms at most an ulp; in small that drift is
// 2^-11 smaller.)  SPLIT_A false: a is exact in TF32 (a bf16 X), al is
// zero and its product is not taken.
template <bool SPLIT_A>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, ah, bh);
  if constexpr (SPLIT_A) mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] += t[e];
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// X_tile[r][col], 0 past the tile's rows or X's columns
template <typename XT>
__device__ __forceinline__ float x_at(const XT* xs, int r, int col, int nr, int d) {
  return (r < nr && col < d) ? to_f(xs[r * d + col]) : 0.0f;
}

// An X entry as the A operand: float32 split into TF32 hi and lo; a bf16
// value's float32 bits are already TF32 (lo = 0, never read)
template <typename XT>
__device__ __forceinline__ void split_x(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(XT) == 4) split_tf32(v, hi, lo);
  else hi = __float_as_uint(v);
}

// The kernel's operands.  w, o, m, b and q may be null.
struct Args {
  const void* x;         // [n, d] row-major, float or __nv_bfloat16
  const float* y;        // [n]
  const float* w;        // [n]
  const float* o;        // [K, n]
  const float* m;        // row mask [n]
  const float* b;        // margin shift per lane [K]
  const uint32_t* q;     // lane mask [n]: bit k set = lane k keeps the row
  const float* c;        // [K, d]
  float* partial;        // [gridDim.x, K, d + 2] scratch
  unsigned int* ticket;  // zero before and after every launch
  float* out;            // [K, d + 2] = [value_k, grad_k, swl_k]
  int64_t n;
  int loss, d, lanes, rows, stages;
  int xbytes;            // X's element size: 4 (float) or 2 (__nv_bfloat16)
};

// Span j of the tile of nr rows at r0: 0 = X, 1, 2, 3 = y, w, m, 4 + k =
// lane k's run of O, 4 + K = q; empty where the operand is null or past K.
__device__ __forceinline__ Span tile_span(const Args& a, int j, int64_t r0, int nr) {
  const float* src = nullptr;
  if (j == 0)
    return span_of(static_cast<const char*>(a.x) + r0 * a.d * a.xbytes, nr * a.d, a.xbytes);
  if (j < 4) src = j == 1 ? a.y : (j == 2 ? a.w : a.m);
  else if (a.o != nullptr && j - 4 < a.lanes) src = a.o + (int64_t)(j - 4) * a.n;
  else if (a.q != nullptr && j - 4 == a.lanes) src = reinterpret_cast<const float*>(a.q);
  return src == nullptr ? span_of(nullptr, 0) : span_of(src + r0, nr);
}

// where span j sits in a stage (element k of it at the span's phase + k)
__device__ __forceinline__ int stage_offset(const Layout& L, int j) {
  return j == 0 ? 0 : L.stage_x + (j - 1) * L.stage_v;
}

__device__ __forceinline__ int phase_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// NT: n-tiles of 8 lanes (lane_tiles(K)); NSLOT: gradient m-tiles a warp
// accumulates, >= grad_slots(d, rows); LM: a lane mask q is given; XT:
// X's element type, float or __nv_bfloat16.
template <int NT, int NSLOT, bool LM, typename XT>
__global__ void __launch_bounds__(kThreads, 1) lanes_value_gradient(const Args a) {
  constexpr bool kSplitX = sizeof(XT) == 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool is_last;
  const int64_t n = a.n;
  const int d = a.d, lanes = a.lanes, rows = a.rows, stages = a.stages;
  const Layout L = smem_layout(d, lanes, rows, stages, LM, (int)sizeof(XT));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  float* cf = smem + L.cf;
  float* zp = smem + L.zp;
  float* sf = smem + L.sf;
  float* vs = smem + L.vs;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t first_row = (int64_t)blockIdx.x * rows;
  const int64_t row_step = (int64_t)gridDim.x * rows;
  const int chunks = cdiv(d, 8);  // margins: column chunks of 8
  const int qn = cdiv(rows, 8);   // gradient: row chunks of 8
  const int units = cdiv(d, 16) * qn;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 33);  // lane 0's expect_tx, then every producer lane
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // C: chunk c, n-tile j, lane (gid, tig) holds (C[8j + gid][8c + tig],
  // C[8j + gid][8c + tig + 4]); zero past K and d
  for (int i = t; i < chunks * NT * 64; i += kThreads) {
    const int which = i & 1, ln = (i >> 1) & 31, cj = i >> 6;
    const int c = cj / NT, j = cj - c * NT;
    const int col = 8 * c + (ln & 3) + 4 * which, k = 8 * j + (ln >> 2);
    cf[i] = (k < lanes && col < d) ? a.c[(int64_t)k * d + col] : 0.0f;
  }
  __syncthreads();

  KahanSum v_acc, s_acc;         // the loss step's lane
  KahanSum kh[NSLOT][NT][4];     // the gradient's slots

  if (t >= kConsumers) {
    // producer warp: lane j copies span j of every tile, its aligned
    // interior by a bulk copy and its ragged ends by 4-byte cp.async
    // copies, all completing on the stage's full barrier
    int stage = 0;
    uint32_t parity = 1;  // a fresh barrier's previous phase counts as complete
    for (int64_t r0 = first_row; r0 < n; r0 += row_step) {
      if (lane == 0) mbar_wait(&empty[stage], parity);
      __syncwarp();
      const int nr = (int)min64(rows, n - r0);
      const Span sp = tile_span(a, lane, r0, nr);
      uint32_t bytes = sp.bytes;
      for (int off = 16; off > 0; off >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, off);
      if (lane == 0) {
        if (bytes == 0) mbar_arrive(&full[stage]);
        else mbar_arrive_expect_tx(&full[stage], bytes);
      }
      __syncwarp();
      char* buf = reinterpret_cast<char*>(smem + stage * L.stage + stage_offset(L, lane));
      // this lane's earlier writes into the ring come before its bulk copy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(buf, sp, &full[stage]);
      load_edges(buf, sp, &full[stage]);
      mbar_arrive(&full[stage]);
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
    }
    __syncwarp();
  } else {
    // consumers
    // the loss step: warp w takes the (8 rows, 8 lanes) blocks of n-tile
    // w % NT, lane (gid, tig) lane 8 (w % NT) + gid of the block's rows tig
    // and tig + 4, as the gradient's B fragment holds them
    const int my_j = warp % NT, my_k = 8 * my_j + gid;
    const float bk = (a.b != nullptr && my_k < lanes) ? a.b[my_k] : 0.0f;
    constexpr int zrow = zp_row(NT);
    // margins: this warp's m-tiles and column chunks
    const int mtiles = margin_tiles(rows), split = margin_split(rows);
    const int m_count = mtiles < kConsumerWarps ? 1 : mtiles / kConsumerWarps;
    const int m_first = mtiles < kConsumerWarps ? warp % mtiles : warp;
    const int m_part = mtiles < kConsumerWarps ? warp / mtiles : 0;
    const int c_lo = m_part * chunks / split, c_hi = (m_part + 1) * chunks / split;
    const int zstride = mtiles * 16 * zrow;  // one column slice's partial margins
    // gradient: this warp's run of units
    const int u_lo = unit_lo(warp, units), u_hi = unit_lo(warp + 1, units);
    const int g_first = u_lo / qn;
    int stage = 0;
    uint32_t parity = 0;
    for (int64_t r0 = first_row; r0 < n; r0 += row_step) {
      mbar_wait(&full[stage], parity);
      const int nr = (int)min64(rows, n - r0);
      const float* buf = smem + stage * L.stage;
      const XT* xs = reinterpret_cast<const XT*>(buf) +
                     (int)((reinterpret_cast<uintptr_t>(static_cast<const XT*>(a.x) + r0 * d) & 15) /
                           sizeof(XT));
#if LANES_PHASES >= 2
      // margins: Z = X_tile C^T, this warp's m-tiles over its column slice
      for (int mi = 0; mi < m_count; ++mi) {
        const int m0 = 16 * (m_first + mi * kConsumerWarps);
        const int ra = m0 + gid, rb = ra + 8;
        const bool rows_in = m0 + 16 <= nr;
        float z[NT][4] = {}, zs[NT][4] = {};
#pragma unroll 2
        for (int c = c_lo; c < c_hi; ++c) {
          const int ca = 8 * c + tig, cb = ca + 4;
          float v[4];
          if (rows_in && 8 * c + 8 <= d) {  // the same on the whole warp
            v[0] = to_f(xs[ra * d + ca]);
            v[1] = to_f(xs[rb * d + ca]);
            v[2] = to_f(xs[ra * d + cb]);
            v[3] = to_f(xs[rb * d + cb]);
          } else {
            v[0] = x_at(xs, ra, ca, nr, d);
            v[1] = x_at(xs, rb, ca, nr, d);
            v[2] = x_at(xs, ra, cb, nr, d);
            v[3] = x_at(xs, rb, cb, nr, d);
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_x<XT>(v[e], ah[e], al[e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 cv = reinterpret_cast<const float2*>(cf)[(c * NT + j) * 32 + lane];
            uint32_t bh[2], bl[2];
            split_tf32(cv.x, bh[0], bl[0]);
            split_tf32(cv.y, bh[1], bl[1]);
            mma3<kSplitX>(z[j], zs[j], ah, al, bh, bl);
          }
        }
        float* zo = zp + m_part * zstride;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<float2*>(zo + ra * zrow + 8 * j + 2 * tig) =
              make_float2(z[j][0] + zs[j][0], z[j][1] + zs[j][1]);
          *reinterpret_cast<float2*>(zo + rb * zrow + 8 * j + 2 * tig) =
              make_float2(z[j][2] + zs[j][2], z[j][3] + zs[j][3]);
        }
      }
      consumer_sync();

      // the loss on this thread's lane and rows: margins, w l, s = w l'
      // (zero past the tile's rows), s split into hi and lo in the
      // gradient's B-fragment order
      {
        const float* yb = buf + stage_offset(L, 1) + phase_of(a.y + r0);
        const float* wb = a.w == nullptr ? nullptr : buf + stage_offset(L, 2) + phase_of(a.w + r0);
        const float* mb = a.m == nullptr ? nullptr : buf + stage_offset(L, 3) + phase_of(a.m + r0);
        const float* ob = a.o == nullptr || my_k >= lanes
                              ? nullptr
                              : buf + stage_offset(L, 4 + my_k) +
                                    phase_of(a.o + (int64_t)my_k * n + r0);
        const uint32_t* qb = nullptr;
        if constexpr (LM) {
          const float* qrow = reinterpret_cast<const float*>(a.q) + r0;
          qb = reinterpret_cast<const uint32_t*>(buf + stage_offset(L, 4 + lanes) +
                                                 phase_of(qrow));
        }
        auto loss_at = [&](int r) {
          if (my_k >= lanes || r >= nr) return 0.0f;
          float zz = 0.0f;
          for (int p = 0; p < split; ++p) zz += zp[p * zstride + r * zrow + my_k];
          float z = zz + bk;
          if (ob != nullptr) z += ob[r];
          float l, dl;
          loss_and_dz(a.loss, z, yb[r], l, dl);
          float wt = wb != nullptr ? wb[r] : 1.0f;
          // this lane's bit, a 0/1 factor on the weight (0 * inf = NaN)
          if constexpr (LM) wt *= (float)((qb[r] >> my_k) & 1u);
          // a select: a masked row's (possibly non-finite) terms never enter
          const bool keep = mb == nullptr || mb[r] != 0.0f;
          const float s = keep ? wt * dl : 0.0f;
          s_acc.add(s);
          if (keep) v_acc.add(wt * l);
          return s;
        };
        float2* s2 = reinterpret_cast<float2*>(sf) + my_j * 64 + lane;
#pragma unroll 2
        for (int q = warp / NT; q < qn; q += kConsumerWarps / NT) {
          const float sa = loss_at(8 * q + tig), sb = loss_at(8 * q + tig + 4);
          uint32_t ha, la, hb, lb;
          split_tf32(sa, ha, la);
          split_tf32(sb, hb, lb);
          s2[q * NT * 64] = make_float2(__uint_as_float(ha), __uint_as_float(hb));
          s2[q * NT * 64 + 32] = make_float2(__uint_as_float(la), __uint_as_float(lb));
        }
      }
      consumer_sync();
#endif
#if LANES_PHASES >= 3
      // gradient: G += X_tile^T S over this warp's units, one float32 sum
      // per slot and tile, folded into the slot's Kahan pairs
      const int qe = cdiv(nr, 8);
#pragma unroll
      for (int i = 0; i < NSLOT; ++i) {
        const int mt = g_first + i;
        const int q0 = max(u_lo - mt * qn, 0);
        const int q1 = min(min(u_hi - mt * qn, qn), qe);
        if (q0 < q1) {
          float acc[NT][4] = {}, accs[NT][4] = {};
          const int ca = 16 * mt + gid, cb = ca + 8;
          const bool cols_in = 16 * mt + 16 <= d;
#pragma unroll 2
          for (int q = q0; q < q1; ++q) {
            const int ra = 8 * q + tig, rb = ra + 4;
            float v[4];
            if (cols_in && 8 * q + 8 <= nr) {  // the same on the whole warp
              v[0] = to_f(xs[ra * d + ca]);
              v[1] = to_f(xs[ra * d + cb]);
              v[2] = to_f(xs[rb * d + ca]);
              v[3] = to_f(xs[rb * d + cb]);
            } else {
              v[0] = x_at(xs, ra, ca, nr, d);
              v[1] = x_at(xs, ra, cb, nr, d);
              v[2] = x_at(xs, rb, ca, nr, d);
              v[3] = x_at(xs, rb, cb, nr, d);
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_x<XT>(v[e], ah[e], al[e]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const float2* s2 = reinterpret_cast<const float2*>(sf) + (q * NT + j) * 64 + lane;
              const float2 sh = s2[0], sl = s2[32];
              const uint32_t bh[2] = {__float_as_uint(sh.x), __float_as_uint(sh.y)};
              const uint32_t bl[2] = {__float_as_uint(sl.x), __float_as_uint(sl.y)};
              mma3<kSplitX>(acc[j], accs[j], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) kh[i][j][e].add(acc[j][e] + accs[j][e]);
        }
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
    }
  }

  // every tile consumed: the ring holds the warps' gradient sums
  // [warp][slot][n-tile][32][4], then the block partial in a fixed order
  __syncthreads();
  const int gslots = grad_slots(d, rows);
  float* gred = smem;
  if (t < kConsumers) {
#pragma unroll
    for (int i = 0; i < NSLOT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i < gslots) gred[(((warp * gslots + i) * NT + j) * 32 + lane) * 4 + e] = kh[i][j][e].value();
    vs[t] = v_acc.value();
    vs[kConsumers + t] = s_acc.value();
  }
  __syncthreads();
  const int row = d + 2;
  const int width = lanes * row;
  float* prow = a.partial + (int64_t)blockIdx.x * width;
  for (int k = t; k < lanes; k += kThreads) {
    KahanSum v, sw;
    for (int w = k >> 3; w < kConsumerWarps; w += NT)
      for (int i = 32 * w + 4 * (k & 7); i < 32 * w + 4 * (k & 7) + 4; ++i) {
        v.add(vs[i]);
        sw.add(vs[kConsumers + i]);
      }
    prow[k * row] = v.value();
    prow[k * row + d + 1] = sw.value();
  }
  for (int e = t; e < d * lanes; e += kThreads) {
    const int k = e / d, col = e - k * d;
    const int mt = col >> 4, cc = col & 15, j = k >> 3, kk = k & 7;
    const int at = ((cc & 7) * 4 + (kk >> 1)) * 4 + (cc >> 3) * 2 + (kk & 1);
    KahanSum g;
    for (int w = 0; w < kConsumerWarps; ++w) {
      const int lo = unit_lo(w, units), hi = unit_lo(w + 1, units);
      if (hi > lo && lo < (mt + 1) * qn && hi > mt * qn)
        g.add(gred[((w * gslots + mt - lo / qn) * NT + j) * 128 + at]);
    }
    prow[k * row + 1 + col] = g.value();
  }

  // the last block to finish sums the partials in block order
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
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

template <int NT, int NSLOT, bool LM, typename XT>
cudaError_t launch_as(const Args& a, int grid, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      lanes_value_gradient<NT, NSLOT, LM, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  lanes_value_gradient<NT, NSLOT, LM, XT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NT, int NSLOT, bool LM>
cudaError_t launch(const Args& a, int grid, int smem, cudaStream_t stream) {
#if LANES_XBYTES == 2
  return launch_as<NT, NSLOT, LM, __nv_bfloat16>(a, grid, smem, stream);
#else
  return launch_as<NT, NSLOT, LM, float>(a, grid, smem, stream);
#endif
}

template <bool LM>
cudaError_t dispatch(int slots, const Args& a, int grid, int smem, cudaStream_t s) {
  if (lane_tiles(a.lanes) == 1) {
    switch (slots) {
      case 1: return launch<1, 1, LM>(a, grid, smem, s);
      case 2: return launch<1, 2, LM>(a, grid, smem, s);
      case 4: return launch<1, 4, LM>(a, grid, smem, s);
      case 8: return launch<1, 8, LM>(a, grid, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (slots) {
    case 1: return launch<2, 1, LM>(a, grid, smem, s);
    case 2: return launch<2, 2, LM>(a, grid, smem, s);
    case 4: return launch<2, 4, LM>(a, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the one kernel of a K-lane pass on `stream`; returns the
// cudaError_t of the launch (0 on success).  The plan (rows, stages, grid,
// slots, smem_bytes) comes from hopper_kernels.plan_lanes; a plan that
// does not fit this source's layout is refused.  partial: [grid, K, d + 2]
// scratch; ticket: one zeroed uint32 that every launch leaves zeroed; out:
// [K, d + 2] = [value_k, grad_k[0..d), swl_k].  w, o ([K, n]), m (row
// mask), b ([K] margin shifts) and q (lane mask, uint32 [n]) may be null.
// xbytes: X's element size, LANES_XBYTES (4, float32; 2, bfloat16, in the
// library built with -DLANES_XBYTES=2); every other operand is float32.
int pmt_fused_value_and_gradient_lanes(int loss, int xbytes, const void* x, const void* y,
                                       const void* w, const void* o, const void* m,
                                       const void* b, const void* q, const void* c,
                                       void* partial,
                                       void* ticket, void* out, long long n, int d,
                                       int lanes, int rows, int stages, int grid, int slots,
                                       int smem_bytes, void* stream) {
  const int mt = margin_tiles(rows);
  const bool rows_ok = rows >= 8 && rows % 8 == 0 &&
                       (mt < kConsumerWarps ? (mt & (mt - 1)) == 0 : mt % kConsumerWarps == 0);
  if (n < 0 || d < 1 || lanes < 1 || lanes > kMaxLanes || !rows_ok || stages < 2 ||
      grid < 1 || loss < kLogistic || loss > kSmoothedHinge || grad_slots(d, rows) > slots ||
      xbytes != LANES_XBYTES || smem_bytes > kMaxSmem ||
      smem_layout(d, lanes, rows, stages, q != nullptr, xbytes).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(y),
               static_cast<const float*>(w), static_cast<const float*>(o),
               static_cast<const float*>(m), static_cast<const float*>(b),
               static_cast<const uint32_t*>(q), static_cast<const float*>(c),
               static_cast<float*>(partial), static_cast<unsigned int*>(ticket),
               static_cast<float*>(out), n, loss, d, lanes, rows, stages, xbytes};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(q != nullptr ? dispatch<true>(slots, a, grid, smem_bytes, st)
                                       : dispatch<false>(slots, a, grid, smem_bytes, st));
}

const char* pmt_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
