// Fused GLM value + gradient in ONE pass over a dense row-major X [n, d]:
//
//   z_i   = x_i . c (+ o_i)
//   value = sum_i w_i l(z_i, y_i)
//   grad  = sum_i w_i l'(z_i, y_i) x_i            (= X^T (w * l'))
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_kernels.py::
// fused_value_and_gradient (pl.pallas_call at line 150, body _kernel at
// lines 54-86), for all four pointwise losses of ops/losses.py.
//
// Bound on an H100: memory.  One pass must read X once, n*d*4 bytes (815 MB
// at the a1a config [1,643,520 x 124], ~0.24 ms at the data sheet's
// 3.35 TB/s); the arithmetic is 4*n*d flops, ~0.01 ms at the f32 peak.
// What the design does about it:
//   - X is read from device memory once.  A warp owns a row: it loads the
//     row (16-byte vector loads when d % 4 == 0 and X is 16-byte aligned,
//     scalar loads otherwise), reduces the margin with warp shuffles, and
//     re-reads the same row for the gradient update while it is still in
//     L1.  No padded copy of X is ever made: the ragged row and column
//     edges are masked by the loop bounds.
//   - Each warp accumulates its gradient in its own row of shared memory
//     (lanes own disjoint columns), so there are no atomics.  Each block
//     writes one partial [value, grad[0..d)] row to scratch; a second
//     kernel reduces the partial rows in a fixed order.  Results are
//     bit-stable from run to run for a given grid.
//   - Weights default to 1 and offsets to 0 in-kernel (null pointers).
//   - f32 inputs, f32 accumulation, as the TPU kernel.
// Shared memory per block is (kWarps + 1) * d * 4 bytes (c plus one
// gradient row per warp), which sets the width limit the wrapper enforces
// (photon_ml_tpu_torch/ops/hopper_kernels.py::D_MAX).
//
// Plain C interface, bound with ctypes.  Build (sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_value_and_gradient.so \
//        fused_value_and_gradient.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kReduceRows = 32;  // y-extent of the reduction block

enum Loss : int { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ float pm1(float y) { return y > 0.5f ? 1.0f : -1.0f; }

// log(1 + exp(t)) without overflow: max(t, 0) + log1p(exp(-|t|))
__device__ __forceinline__ float softplus(float t) {
  return fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)));
}

__device__ __forceinline__ float sigmoid(float t) {
  if (t >= 0.0f) return 1.0f / (1.0f + expf(-t));
  const float e = expf(t);
  return e / (1.0f + e);
}

// (l, dl/dz) of photon_ml_tpu/ops/losses.py, labels {0,1} remapped to +-1
template <int LOSS>
__device__ __forceinline__ void loss_and_dz(float z, float y, float& l, float& dl) {
  if constexpr (LOSS == kLogistic) {
    const float yy = pm1(y);
    const float t = -yy * z;
    l = softplus(t);
    dl = -yy * sigmoid(t);
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

// Pass 1: each block walks rows blockIdx.x*kWarps + warp, stepping by
// gridDim.x*kWarps, and writes partial[blockIdx.x] = [value, grad[0..d)].
template <int LOSS, bool VEC4>
__global__ void __launch_bounds__(kThreads)
fvg_partial(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ w, const float* __restrict__ o,
            const float* __restrict__ c, float* __restrict__ partial,
            int64_t n, int d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float v_s[kWarps];
  float* c_s = smem;      // [d]
  float* g_s = smem + d;  // [kWarps, d], one gradient row per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < d; j += kThreads) c_s[j] = c[j];
  for (int j = threadIdx.x; j < kWarps * d; j += kThreads) g_s[j] = 0.0f;
  __syncthreads();

  float* g_w = g_s + warp * d;
  const int d4 = d / 4;
  float v_acc = 0.0f;  // identical on every lane of the warp
  const int64_t step = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < n; row += step) {
    const float* xr = x + row * d;
    float dot = 0.0f;
    if constexpr (VEC4) {
      const float4* xr4 = reinterpret_cast<const float4*>(xr);
      const float4* c4 = reinterpret_cast<const float4*>(c_s);
      for (int j = lane; j < d4; j += 32) {
        const float4 a = xr4[j];
        const float4 b = c4[j];
        dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
      for (int j = lane; j < d; j += 32) dot += xr[j] * c_s[j];
    }
    // butterfly: every lane ends with the same (bitwise) sum
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);

    const float z = o != nullptr ? dot + o[row] : dot;
    float l, dl;
    loss_and_dz<LOSS>(z, y[row], l, dl);
    const float wt = w != nullptr ? w[row] : 1.0f;
    const float wdl = wt * dl;
    v_acc += wt * l;

    if constexpr (VEC4) {
      const float4* xr4 = reinterpret_cast<const float4*>(xr);
      float4* g4 = reinterpret_cast<float4*>(g_w);
      for (int j = lane; j < d4; j += 32) {
        const float4 a = xr4[j];
        float4 g = g4[j];
        g.x += wdl * a.x;
        g.y += wdl * a.y;
        g.z += wdl * a.z;
        g.w += wdl * a.w;
        g4[j] = g;
      }
    } else {
      for (int j = lane; j < d; j += 32) g_w[j] += wdl * xr[j];
    }
  }

  if (lane == 0) v_s[warp] = v_acc;
  __syncthreads();

  float* out = partial + (int64_t)blockIdx.x * (d + 1);
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int k = 0; k < kWarps; ++k) v += v_s[k];
    out[0] = v;
  }
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float g = 0.0f;
    for (int k = 0; k < kWarps; ++k) g += g_s[k * d + j];
    out[1 + j] = g;
  }
}

// Pass 2: out[col] = sum over the `rows` partial rows, in a fixed order.
// Block (32, kReduceRows) covers 32 columns; thread (tx, ty) sums rows
// ty, ty + kReduceRows, ...; then the kReduceRows sums are added in order.
__global__ void __launch_bounds__(32 * kReduceRows)
fvg_reduce(const float* __restrict__ partial, float* __restrict__ out,
           int rows, int width) {
  __shared__ float acc[kReduceRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (col < width)
    for (int r = threadIdx.y; r < rows; r += kReduceRows)
      s += partial[(int64_t)r * width + col];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = 0.0f;
    for (int k = 0; k < kReduceRows; ++k) t += acc[k][threadIdx.x];
    out[col] = t;
  }
}

template <int LOSS, bool VEC4>
cudaError_t launch(const float* x, const float* y, const float* w,
                   const float* o, const float* c, float* partial, float* out,
                   int64_t n, int d, int grid, cudaStream_t stream) {
  const size_t smem = (size_t)(kWarps + 1) * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fvg_partial<LOSS, VEC4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fvg_partial<LOSS, VEC4><<<grid, kThreads, smem, stream>>>(
      x, y, w, o, c, partial, n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 block(32, kReduceRows);
  fvg_reduce<<<(d + 1 + 31) / 32, block, 0, stream>>>(partial, out, grid, d + 1);
  return cudaGetLastError();
}

template <int LOSS>
cudaError_t dispatch_vec(bool vec4, const float* x, const float* y,
                         const float* w, const float* o, const float* c,
                         float* partial, float* out, int64_t n, int d,
                         int grid, cudaStream_t stream) {
  return vec4 ? launch<LOSS, true>(x, y, w, o, c, partial, out, n, d, grid, stream)
              : launch<LOSS, false>(x, y, w, o, c, partial, out, n, d, grid, stream);
}

}  // namespace

extern "C" {

// Launches both passes on `stream`; returns the cudaError_t of the launches
// (0 on success).  partial: [grid, d + 1] scratch; out: [d + 1] =
// [value, grad[0..d)].  w and o may be null.
int pmt_fused_value_and_gradient(int loss, const void* x, const void* y,
                                 const void* w, const void* o, const void* c,
                                 void* partial, void* out, long long n, int d,
                                 int grid, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  const float* of = static_cast<const float*>(o);
  const float* cf = static_cast<const float*>(c);
  float* pf = static_cast<float*>(partial);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t e;
  switch (loss) {
    case kLogistic:
      e = dispatch_vec<kLogistic>(vec4, xf, yf, wf, of, cf, pf, outf, n, d, grid, s);
      break;
    case kSquared:
      e = dispatch_vec<kSquared>(vec4, xf, yf, wf, of, cf, pf, outf, n, d, grid, s);
      break;
    case kPoisson:
      e = dispatch_vec<kPoisson>(vec4, xf, yf, wf, of, cf, pf, outf, n, d, grid, s);
      break;
    case kSmoothedHinge:
      e = dispatch_vec<kSmoothedHinge>(vec4, xf, yf, wf, of, cf, pf, outf, n, d, grid, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* pmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
