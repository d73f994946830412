// RMSNorm (CUDA C++, sm_90a).
//
// out = (x * rsqrt(mean(x^2) + eps)) * w over the last axis, computed in
// float32 and written in x's type.  Replaces the Pallas kernel `rmsnorm`
// (`_kernel`) of the JAX package's kernels/rmsnorm.py.
//
// Bound: bytes.  Each row is read, reduced and written once; the arithmetic
// is four operations an element.  The design is one block of 128 threads
// per row: the threads stride over the row (neighbouring threads on
// neighbouring addresses), fold their float32 sums of squares with warp
// shuffles and one shared-memory step, then read the row a second time —
// from L1/L2, where a row of a few KB still lies — to scale and write it.
// The Pallas wrapper shrinks its row block to a divisor of the row count;
// here every row is its own block, so a ragged row count needs no masking.
//
// Order of operations as in the reference (models/layers.py rms_norm):
// mean = sum / d, r = rsqrt(mean + eps), out = (x * r) * w.  `rsqrtf` is
// within 2 ulp of the correctly rounded value.
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  __shared__ float scale;
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(kFullMask, ss, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
    scale = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float r = scale;
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f32<TX>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<(unsigned)rows, kThreads, 0, stream>>>(
      (const TX*)x, (const TW*)w, (TX*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (rows, d) contiguous; w: (d,).  x_bf16 / w_bf16 pick bfloat16
// over float32 for each.  rows must be at least 1 and below 2^31.
int rmsnorm_fwd(const void* x, const void* w, void* out, long long rows,
                int d, double eps, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float e = (float)eps;
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, e, s);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, w, out, rows, d, e, s);
  if (w_bf16) return launch<float, __nv_bfloat16>(x, w, out, rows, d, e, s);
  return launch<float, float>(x, w, out, rows, d, e, s);
}

}  // extern "C"
