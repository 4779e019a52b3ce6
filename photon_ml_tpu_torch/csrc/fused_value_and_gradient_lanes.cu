// Fused GLM value + gradient for K coefficient vectors ("candidate lanes")
// in ONE pass over a dense row-major X [n, d]:
//
//   z_ik    = x_i . c_k + o_ki + b_k
//   value_k = sum_i [m_i != 0] w_i l(z_ik, y_i)
//   grad_k  = sum_i [m_i != 0] w_i l'(z_ik, y_i) x_i
//   swl_k   = sum_i [m_i != 0] w_i l'(z_ik, y_i)
//
// for k < K <= 16, all four pointwise losses of ops/losses.py.  The mask
// is a select (a masked row adds nothing, even a non-finite loss); w, o, m
// and b may be null (1, 0, every row, 0).  b_k is the normalization shift
// -(c_k (.) f) . s of lane k, and with swl_k the caller finishes a
// standardized gradient as grad_k - s * swl_k, as for the single kernel.
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
// 186 MB, 0.056 ms at the data sheet's 3.35 TB/s; the arithmetic is
// 4 n d K flops (1.9 GFLOP, 0.03 ms at the f32 peak).  The design is the
// simple one first:
//   - a persistent grid (one or two blocks per SM); block b takes row
//     tiles b, b + grid, ...; C lives in shared memory, transposed and
//     padded to a multiple of 4 lanes ([d][4G], G = ceil(K / 4) lane
//     groups of 4), so a thread reads 4 lanes' c_kj with one 16-byte load;
//   - each tile (X rows, y, w, m and the tile's K runs of O) is copied
//     once into a ring of three stages with 4-byte cp.async copies, issued
//     two tiles ahead; X rows are stored with an odd row stride so that
//     the margins phase, one row per thread, is free of bank conflicts;
//   - margins: thread t takes lane group t / (256 / G) and the rows
//     r = t mod (256 / G) + i 256 / G; it computes its 4 lanes' margins,
//     losses and s_rk = w_r l'_rk, and writes s into shared memory;
//   - gradient: thread t owns fixed (column j, lane group) entries and
//     adds x_rj s_rk for 4 lanes per entry in registers, across every tile
//     of its block;
//   - every running sum (gradient registers, values, sum(w l'), the
//     block's and the last block's sums) is compensated (Kahan), as in
//     the single kernel: a candidate's results are held against isolated
//     fits, which use compensated sums;
//   - one launch per pass: each block writes a partial [K, d + 2] row
//     block, takes a ticket, and the last block sums the partials in block
//     order and resets the ticket, so results are bit-stable from call to
//     call.
// The tile and grid come from the pure Python function
// photon_ml_tpu_torch/ops/hopper_kernels.py::plan_lanes (the CPU tests
// replay it); smem_layout() below must agree with it, and the entry point
// refuses a plan whose shared-memory size it does not reproduce.
//
// Plain C interface, bound with ctypes.  Build (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_value_and_gradient_lanes.so \
//        fused_value_and_gradient_lanes.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 16;
constexpr int kStages = 3;
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
// the same code as the single kernel's
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

// lane groups of 4: 1, 2 or 4 of them
__host__ __device__ constexpr int lane_groups(int lanes) {
  return lanes <= 4 ? 1 : (lanes <= 8 ? 2 : 4);
}

// Shared memory, in floats from the (16-byte aligned) base: kStages stages
// of [X tile (rows x ld, ld = d | 1) | y | w | m (rows each) | O (K runs
// of rows)], then C^T [d][4G], the tile's s [rows][4G], and a reduction
// area [2][4G x 256 / G].  Every array starts on 16 bytes.
struct Layout {
  int ld, groups, stage_x, stage_v, stage_o, stage, c, s, red, bytes;
};

__host__ __device__ Layout smem_layout(int d, int lanes, int rows) {
  Layout L;
  L.ld = d | 1;
  L.groups = lane_groups(lanes);
  const int kp = 4 * L.groups;
  L.stage_x = round4(rows * L.ld);
  L.stage_v = round4(rows);
  L.stage_o = round4(lanes * rows);
  L.stage = L.stage_x + 3 * L.stage_v + L.stage_o;
  L.c = kStages * L.stage;
  L.s = L.c + d * kp;
  L.red = L.s + rows * kp;
  L.bytes = (L.red + 2 * 4 * kThreads) * 4;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The kernel's operands.  w, o, m and b may be null.
struct Args {
  const float* x;        // [n, d] row-major
  const float* y;        // [n]
  const float* w;        // [n]
  const float* o;        // [K, n]
  const float* m;        // row mask [n]
  const float* b;        // margin shift per lane [K]
  const float* c;        // [K, d]
  float* partial;        // [gridDim.x, K, d + 2] scratch
  unsigned int* ticket;  // zero before and after every launch
  float* out;            // [K, d + 2] = [value_k, grad_k, swl_k]
  int64_t n;
  int d, lanes, rows;
};

// NACC: 4-lane gradient accumulators per thread, G d <= 256 NACC.
template <int LOSS, int NACC>
__global__ void __launch_bounds__(kThreads, NACC <= 2 ? 2 : 1)
    lanes_value_gradient(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool is_last;
  const int64_t n = a.n;
  const int d = a.d, lanes = a.lanes, rows = a.rows;
  const Layout L = smem_layout(d, lanes, rows);
  const int ld = L.ld, G = L.groups, kp = 4 * G;
  float* c_s = smem + L.c;
  float* s_s = smem + L.s;
  float* red = smem + L.red;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;

  // C^T, lanes at or above K zero
  for (int i = t; i < d * kp; i += kThreads) {
    const int j = i / kp, k = i - j * kp;
    c_s[i] = k < lanes ? a.c[(int64_t)k * d + j] : 0.0f;
  }

  const int64_t tiles = (n + rows - 1) / rows;
  const int64_t my_tiles =
      (int64_t)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  // the i-th tile of this block into stage `stage`
  auto load_tile = [&](int64_t i, int stage) {
    const int64_t r0 = ((int64_t)blockIdx.x + i * gridDim.x) * rows;
    const int nr = (int)min64(rows, n - r0);
    float* xb = smem + stage * L.stage;
    float* yb = xb + L.stage_x;
    float* wb = yb + L.stage_v;
    float* mb = wb + L.stage_v;
    float* ob = mb + L.stage_v;
    const float* xsrc = a.x + r0 * d;
    for (int r = warp; r < nr; r += kWarps)
      for (int j = lane; j < d; j += 32) cp_async4(xb + r * ld + j, xsrc + (int64_t)r * d + j);
    for (int r = t; r < nr; r += kThreads) {
      cp_async4(yb + r, a.y + r0 + r);
      if (a.w != nullptr) cp_async4(wb + r, a.w + r0 + r);
      if (a.m != nullptr) cp_async4(mb + r, a.m + r0 + r);
    }
    if (a.o != nullptr)
      for (int k = 0; k < lanes; ++k)
        for (int r = t; r < nr; r += kThreads)
          cp_async4(ob + k * rows + r, a.o + (int64_t)k * n + r0 + r);
  };

  // margins phase: lane group g, rows r_first + i * rp
  const int rp = kThreads / G;
  const int g = t / rp, r_first = t - g * rp;
  float bk[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = 4 * g + q;
    bk[q] = (a.b != nullptr && k < lanes) ? a.b[k] : 0.0f;
  }
  KahanSum v_acc[4], s_acc[4];

  // gradient phase: entries e = t + 256 i, column e % d, lane group e / d
  KahanSum acc[NACC][4];
  int jcol[NACC], gcol[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = t + i * kThreads;
    gcol[i] = e / d;
    jcol[i] = e - gcol[i] * d;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) load_tile(s, s);
    cp_commit();
  }
  __syncthreads();  // C^T written

  for (int64_t i = 0; i < my_tiles; ++i) {
    const int64_t next = i + kStages - 1;
    if (next < my_tiles) load_tile(next, (int)(next % kStages));
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();

    const int stage = (int)(i % kStages);
    const int64_t r0 = ((int64_t)blockIdx.x + i * gridDim.x) * rows;
    const int nr = (int)min64(rows, n - r0);
    const float* xb = smem + stage * L.stage;
    const float* yb = xb + L.stage_x;
    const float* wb = yb + L.stage_v;
    const float* mb = wb + L.stage_v;
    const float* ob = mb + L.stage_v;

    // margins, losses and s = w l' for this thread's 4 lanes
    const float4* c4 = reinterpret_cast<const float4*>(c_s) + g;
    for (int r = r_first; r < nr; r += rp) {
      const float* xr = xb + r * ld;
      float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f, z3 = 0.0f;
#pragma unroll 4
      for (int j = 0; j < d; ++j) {
        const float xv = xr[j];
        const float4 cv = c4[j * G];
        z0 = fmaf(xv, cv.x, z0);
        z1 = fmaf(xv, cv.y, z1);
        z2 = fmaf(xv, cv.z, z2);
        z3 = fmaf(xv, cv.w, z3);
      }
      const float zz[4] = {z0, z1, z2, z3};
      float sv[4];
      const float yr = yb[r];
      const float wt = a.w != nullptr ? wb[r] : 1.0f;
      // a select: a masked row's (possibly non-finite) terms never enter
      const bool keep = a.m == nullptr || mb[r] != 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * g + q;
        sv[q] = 0.0f;
        if (k < lanes) {
          float z = zz[q] + bk[q];
          if (a.o != nullptr) z += ob[k * rows + r];
          float l, dl;
          loss_and_dz<LOSS>(z, yr, l, dl);
          const float sr = keep ? wt * dl : 0.0f;
          sv[q] = sr;
          s_acc[q].add(sr);
          if (keep) v_acc[q].add(wt * l);
        }
      }
      reinterpret_cast<float4*>(s_s)[r * G + g] = make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
    __syncthreads();

    // gradient: x_rj s_rk into this thread's (column, 4 lanes) registers
    for (int r = 0; r < nr; ++r) {
      const float* xr = xb + r * ld;
      const float4* sr4 = reinterpret_cast<const float4*>(s_s) + r * G;
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        if (gcol[e] < G) {
          const float xv = xr[jcol[e]];
          const float4 sv = sr4[gcol[e]];
          acc[e][0].add(xv * sv.x);
          acc[e][1].add(xv * sv.y);
          acc[e][2].add(xv * sv.z);
          acc[e][3].add(xv * sv.w);
        }
      }
    }
    __syncthreads();  // the stage and s are free for the next tile
  }
  cp_wait<0>();

  // block partial [K][value, grad, swl] in a fixed order
  float* red_v = red;
  float* red_s = red + kp * rp;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    red_v[(4 * g + q) * rp + r_first] = v_acc[q].value();
    red_s[(4 * g + q) * rp + r_first] = s_acc[q].value();
  }
  __syncthreads();
  const int row = d + 2;
  const int width = lanes * row;
  float* prow = a.partial + (int64_t)blockIdx.x * width;
  for (int k = t; k < lanes; k += kThreads) {
    KahanSum v, sw;
    for (int i = 0; i < rp; ++i) {
      v.add(red_v[k * rp + i]);
      sw.add(red_s[k * rp + i]);
    }
    prow[k * row] = v.value();
    prow[k * row + d + 1] = sw.value();
  }
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    if (gcol[e] < G) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * gcol[e] + q;
        if (k < lanes) prow[k * row + 1 + jcol[e]] = acc[e][q].value();
      }
    }
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

template <int LOSS, int NACC>
cudaError_t launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      lanes_value_gradient<LOSS, NACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lanes_value_gradient<LOSS, NACC><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int LOSS>
cudaError_t dispatch_acc(int nacc, const Args& a, int grid, int smem, cudaStream_t s) {
  switch (nacc) {
    case 1: return launch<LOSS, 1>(a, grid, smem, s);
    case 2: return launch<LOSS, 2>(a, grid, smem, s);
    case 4: return launch<LOSS, 4>(a, grid, smem, s);
    case 8: return launch<LOSS, 8>(a, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the one kernel of a K-lane pass on `stream`; returns the
// cudaError_t of the launch (0 on success).  The plan (rows, grid,
// acc_per_thread, smem_bytes) comes from hopper_kernels.plan_lanes; a plan
// that does not fit this source's layout is refused.  partial: [grid, K,
// d + 2] scratch; ticket: one zeroed uint32 that every launch leaves
// zeroed; out: [K, d + 2] = [value_k, grad_k[0..d), swl_k].  w, o ([K, n]),
// m (row mask) and b ([K] margin shifts) may be null.
int pmt_fused_value_and_gradient_lanes(int loss, const void* x, const void* y,
                                       const void* w, const void* o, const void* m,
                                       const void* b, const void* c, void* partial,
                                       void* ticket, void* out, long long n, int d,
                                       int lanes, int rows, int grid, int acc_per_thread,
                                       int smem_bytes, void* stream) {
  if (n < 0 || d < 1 || lanes < 1 || lanes > kMaxLanes || rows < 1 || grid < 1 ||
      acc_per_thread < 1 || lane_groups(lanes) * d > acc_per_thread * kThreads ||
      smem_bytes > kMaxSmem || smem_layout(d, lanes, rows).bytes != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(y),
               static_cast<const float*>(w), static_cast<const float*>(o),
               static_cast<const float*>(m), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(partial),
               static_cast<unsigned int*>(ticket), static_cast<float*>(out),
               n, d, lanes, rows};
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

const char* pmt_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
