// Mamba1 selective scan, forward (CUDA C++, sm_90a).
//
// For each batch b and channel d, over t = 0 .. S-1 in order:
//   h[n] = exp(dt[t] * A[d, n]) * h[n] + (dt[t] * x[t]) * B[t, n]
//   y[t] = sum_n h[n] * C[t, n]
// with h starting at h0 (zeros when none is given).  Returns y (B, S, D) and
// the final state (B, D, N), both float32.  Replaces the Pallas kernel
// `selective_scan` (`_kernel`) of the JAX package's
// kernels/selective_scan.py.
//
// Bound: bytes.  Each of x, dt, B, C is read once and y written once; the
// (B, S, D, N) trajectory of the state, the term that makes a naive scan
// memory-bound, never reaches device memory, which is the point of the
// Pallas kernel.  Design: one thread per (batch, channel).  It keeps its N
// state values and its row of A in registers and walks the sequence in
// order; the recurrence has no parallelism along t, so the parallelism is
// B x D threads (32,768 for falcon-mamba-7b at batch 4).  Time advances in
// chunks of 16 steps: the block stages the chunk's B and C rows (shared by
// all channels) in shared memory, and each thread issues the chunk's 32
// loads of its x and dt at once, so their latency overlaps instead of
// stalling every step.  Neighbouring threads hold neighbouring channels, so
// every load of x, dt and store of y is coalesced.  x, dt, B and C are
// given by their batch and time strides (the last axis has unit stride): the
// model's dt, B and C are column slices of one projection, read in place.
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;      // channels per block
constexpr int kChunk = 16;        // time steps staged at once
constexpr int kNMax = 16;         // largest state size

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out,
                      long long x_sb, long long x_st, long long dt_sb,
                      long long dt_st, long long b_sb, long long b_st,
                      long long c_sb, long long c_st, int len, int d, int n) {
  __shared__ float bs[kChunk][kNMax];
  __shared__ float cs[kChunk][kNMax];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool active = ch < d;
  const long long state = ((long long)b * d + ch) * n;

  float av[kNMax], h[kNMax];
#pragma unroll
  for (int k = 0; k < kNMax; ++k) {
    const bool in = active && k < n;
    av[k] = in ? a[(long long)ch * n + k] : 0.f;
    h[k] = in && h0 != nullptr ? h0[state + k] : 0.f;
  }

  const T* xb = x + b * x_sb + ch;
  const T* db = dt + b * dt_sb + ch;
  float* yb = y + (long long)b * len * d + ch;
  for (int t0 = 0; t0 < len; t0 += kChunk) {
    const int steps = min(kChunk, len - t0);
    __syncthreads();                      // the previous chunk is consumed
    for (int i = threadIdx.x; i < kChunk * kNMax; i += kThreads) {
      const int t = i / kNMax, k = i % kNMax;
      const bool in = t < steps && k < n;
      const long long tt = t0 + t;
      bs[t][k] = in ? to_f32(bm[b * b_sb + tt * b_st + k]) : 0.f;
      cs[t][k] = in ? to_f32(cm[b * c_sb + tt * c_st + k]) : 0.f;
    }
    float xv[kChunk], dv[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const bool in = active && t < steps;
      const long long tt = t0 + t;
      xv[t] = in ? to_f32(xb[tt * x_st]) : 0.f;
      dv[t] = in ? to_f32(db[tt * dt_st]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < steps) {
        const float dtx = dv[t] * xv[t];
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kNMax; ++k) {
          if (k < n) {
            h[k] = expf(dv[t] * av[k]) * h[k] + dtx * bs[t][k];
            acc += h[k] * cs[t][k];
          }
        }
        yb[(long long)(t0 + t) * d] = acc;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kNMax; ++k)
      if (k < n) h_out[state + k] = h[k];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* h_out,
           long long x_sb, long long x_st, long long dt_sb, long long dt_st,
           long long b_sb, long long b_st, long long c_sb, long long c_st,
           long long batch, long long len, int d, int n,
           cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, (unsigned)batch);
  selective_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)dt, (const T*)bm, (const T*)cm, (const float*)a,
      (const float*)h0, (float*)y, (float*)h_out, x_sb, x_st, dt_sb, dt_st,
      b_sb, b_st, c_sb, c_st, (int)len, d, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dt: (batch, len, d); B, C: (batch, len, n), each by its batch and time
// strides (elements, unit stride on the last axis), all four float32
// (bf16 == 0) or all bfloat16 (bf16 == 1).  A: (d, n) float32 contiguous;
// h0: (batch, d, n) float32 contiguous or NULL for zeros; y: (batch, len, d)
// and h_out: (batch, d, n) float32 contiguous.  1 <= n <= 16, batch below
// 65,536, len below 2^31.
int selective_scan_fwd(const void* x, const void* dt, const void* bm,
                       const void* cm, const void* a, const void* h0, void* y,
                       void* h_out, long long x_sb, long long x_st,
                       long long dt_sb, long long dt_st, long long b_sb,
                       long long b_st, long long c_sb, long long c_st,
                       long long batch, long long len, int d, int n, int bf16,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || n > kNMax) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, bm, cm, a, h0, y, h_out, x_sb, x_st,
                                 dt_sb, dt_st, b_sb, b_st, c_sb, c_st, batch,
                                 len, d, n, s);
  return launch<float>(x, dt, bm, cm, a, h0, y, h_out, x_sb, x_st, dt_sb,
                       dt_st, b_sb, b_st, c_sb, c_st, batch, len, d, n, s);
}

}  // extern "C"
