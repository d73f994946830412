// RMSNorm, and RMSNorm of a residual sum (CUDA C++, sm_90a).
//
// rmsnorm:      y = (x * rsqrt(mean(x^2) + eps)) * w over the last axis,
//               computed in float32 and written in x's type.  Replaces the
//               Pallas kernel `rmsnorm` (`_kernel`) of the JAX package's
//               kernels/rmsnorm.py.
// add_rmsnorm:  s = x + r, rounded to x's type as PyTorch's add rounds it
//               (both operands to float32, one float32 add, round to
//               nearest even), stored; then y = rmsnorm(s).  The model's
//               residual stream goes through it: one launch for the add
//               and the norm that follows it, where there were two.
//
// Bound: bytes.  Each row is read, reduced and written once; the arithmetic
// is four operations an element (five with the add).  The design is one
// block of 128 threads per row: the threads stride over the row in 16-byte
// packs (8 bfloat16 or 4 float32 values, neighbouring threads on
// neighbouring packs) where the row width and every pointer allow it, one
// element at a time otherwise; they fold their float32 sums of squares with
// warp shuffles and one shared-memory step, then read the row a second time
// — from L1/L2, where a row of a few KB still lies — to scale and write it.
// The add form sums the squares of the rounded s, stores s in the first
// pass and reads it back in the second (each thread reads only the packs it
// wrote, after a barrier).  Every row is its own block, so a ragged row
// count needs no masking.
//
// Order of operations as in the reference (models/layers.py rms_norm):
// mean = sum / d, r = rsqrt(mean + eps), out = (x * r) * w.  `rsqrtf` is
// within 2 ulp of the correctly rounded value.  The library is built with
// -fmad=false, so s is bit-equal to PyTorch's x + r.
//
// rmsnorm_bwd: the gradient of either form, for the training path (the
// JAX package differentiates its plain jnp norm by autodiff and has no
// backward kernel; this one exists because the port's forward is a kernel).
// With r = rsqrt(mean(x^2) + eps) and g = w * dy,
//   dx = r * g - x * r^3 * mean(x * g)  (+ ds_in for the residual form,
//        whose stored sum s is also read by the residual stream; dr = dx),
//   dw = sum over rows of dy * (x * r), in float32.
// Three kernels, all deterministic (no atomics): one block per row for dx,
// which also stores the row's r; then per-chunk partial sums of dw over a
// fixed split of the rows (one thread a column, rows in order), and a fold
// of the chunks' partials in chunk order, cast to w's type.  Bound: bytes
// (x and dy read twice — the second time from L2 for dx, again for dw —
// dx written once).
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// kVec values of one type, loaded and stored as one aligned access.
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename TX, typename TW, bool kAdd, int kVec>
__global__ void __launch_bounds__(kThreads)
norm_kernel(const TX* __restrict__ x, const TX* __restrict__ r,
            const TW* __restrict__ w, TX* s, TX* __restrict__ y, int d,
            float eps) {
  using PX = Pack<TX, kVec>;
  using PW = Pack<TW, kVec>;
  __shared__ float partial[kThreads / 32];
  __shared__ float scale;
  const long long off = (long long)blockIdx.x * d;
  const int packs = d / kVec;
  const PX* xr = reinterpret_cast<const PX*>(x + off);
  PX* sr = kAdd ? reinterpret_cast<PX*>(s + off) : nullptr;

  float ss = 0.f;
  for (int i = threadIdx.x; i < packs; i += kThreads) {
    PX a = xr[i];
    if constexpr (kAdd) {
      const PX b = reinterpret_cast<const PX*>(r + off)[i];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        a.v[k] = from_f32<TX>(to_f32(a.v[k]) + to_f32(b.v[k]));
      sr[i] = a;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float v = to_f32(a.v[k]);
      ss += v * v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFullMask, ss, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
    scale = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float rs = scale;
  const PX* src = kAdd ? sr : xr;
  const PW* wr = reinterpret_cast<const PW*>(w);
  PX* yr = reinterpret_cast<PX*>(y + off);
  for (int i = threadIdx.x; i < packs; i += kThreads) {
    const PX a = src[i];
    const PW g = wr[i];
    PX o;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o.v[k] = from_f32<TX>((to_f32(a.v[k]) * rs) * to_f32(g.v[k]));
    yr[i] = o;
  }
}

// Backward, pass 1: one block per row.  dx = r*g - x*(r^3 * dot / d) with
// g = w*dy and dot = sum(x*g); the sum of squares folds in the forward's
// order, so r is the forward's.  `ds` (may be null) is added in float32
// before the one rounding of dx.  r goes to rstd[row] for the dw passes.
template <typename TX, typename TW, int kVec>
__global__ void __launch_bounds__(kThreads)
norm_bwd_rows(const TX* __restrict__ x, const TW* __restrict__ w,
              const TX* __restrict__ dy, const TX* __restrict__ ds,
              TX* __restrict__ dx, float* __restrict__ rstd, int d,
              float eps) {
  using PX = Pack<TX, kVec>;
  using PW = Pack<TW, kVec>;
  __shared__ float partial[2][kThreads / 32];
  __shared__ float coef[2];
  const long long off = (long long)blockIdx.x * d;
  const int packs = d / kVec;
  const PX* xr = reinterpret_cast<const PX*>(x + off);
  const PX* gr = reinterpret_cast<const PX*>(dy + off);
  const PW* wr = reinterpret_cast<const PW*>(w);

  float ss = 0.f, dot = 0.f;
  for (int i = threadIdx.x; i < packs; i += kThreads) {
    const PX a = xr[i], g = gr[i];
    const PW c = wr[i];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float v = to_f32(a.v[k]);
      ss += v * v;
      dot += v * (to_f32(c.v[k]) * to_f32(g.v[k]));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(kFullMask, ss, o);
    dot += __shfl_xor_sync(kFullMask, dot, o);
  }
  if ((threadIdx.x & 31) == 0) {
    partial[0][threadIdx.x >> 5] = ss;
    partial[1][threadIdx.x >> 5] = dot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tss = 0.f, tdot = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      tss += partial[0][i];
      tdot += partial[1][i];
    }
    const float r = rsqrtf(tss / (float)d + eps);
    coef[0] = r;
    coef[1] = r * r * r * (tdot / (float)d);
    rstd[blockIdx.x] = r;
  }
  __syncthreads();
  const float r = coef[0], c3 = coef[1];
  PX* out = reinterpret_cast<PX*>(dx + off);
  const PX* sr = ds ? reinterpret_cast<const PX*>(ds + off) : nullptr;
  for (int i = threadIdx.x; i < packs; i += kThreads) {
    const PX a = xr[i], g = gr[i];
    const PW c = wr[i];
    PX o;
    if (sr) {
      const PX e = sr[i];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        o.v[k] = from_f32<TX>(r * (to_f32(c.v[k]) * to_f32(g.v[k])) -
                              to_f32(a.v[k]) * c3 + to_f32(e.v[k]));
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        o.v[k] = from_f32<TX>(r * (to_f32(c.v[k]) * to_f32(g.v[k])) -
                              to_f32(a.v[k]) * c3);
    }
    out[i] = o;
  }
}

constexpr int kDwThreads = 256;
// Row chunks of the dw partial sums (fewer when there are fewer rows).
constexpr int kDwChunks = 64;

// Backward, pass 2: partial[chunk][col] = sum over the chunk's rows, in
// order, of dy * (x * r).  One thread a column, neighbouring threads on
// neighbouring columns.
template <typename TX>
__global__ void __launch_bounds__(kDwThreads)
norm_bwd_dw_partial(const TX* __restrict__ x, const TX* __restrict__ dy,
                    const float* __restrict__ rstd,
                    float* __restrict__ partial, long long rows, int d,
                    long long rows_per_chunk) {
  const int col = blockIdx.x * kDwThreads + threadIdx.x;
  if (col >= d) return;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 =
      r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  float acc = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const long long i = r * d + col;
    acc += to_f32(dy[i]) * (to_f32(x[i]) * rstd[r]);
  }
  partial[(long long)blockIdx.y * d + col] = acc;
}

// Backward, pass 3: dw[col] = the chunks' partials summed in chunk order.
template <typename TW>
__global__ void __launch_bounds__(kDwThreads)
norm_bwd_dw_fold(const float* __restrict__ partial, TW* __restrict__ dw,
                 int chunks, int d) {
  const int col = blockIdx.x * kDwThreads + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += partial[(long long)c * d + col];
  dw[col] = from_f32<TW>(acc);
}

inline bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

// 16-byte packs where the width and every pointer allow them, else one
// element at a time.
template <typename TX, typename TW, bool kAdd>
int launch(const void* x, const void* r, const void* w, void* s, void* y,
           long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool packed = d % kVec == 0 && aligned(x, 16) && aligned(y, 16) &&
                      aligned(w, sizeof(TW) * kVec) &&
                      (!kAdd || (aligned(r, 16) && aligned(s, 16)));
  if (packed)
    norm_kernel<TX, TW, kAdd, kVec><<<(unsigned)rows, kThreads, 0, stream>>>(
        (const TX*)x, (const TX*)r, (const TW*)w, (TX*)s, (TX*)y, d, eps);
  else
    norm_kernel<TX, TW, kAdd, 1><<<(unsigned)rows, kThreads, 0, stream>>>(
        (const TX*)x, (const TX*)r, (const TW*)w, (TX*)s, (TX*)y, d, eps);
  return (int)cudaGetLastError();
}

// types: bit 0 set for a bfloat16 x (and r, s, y), bit 1 for a bfloat16 w;
// float32 otherwise.
template <bool kAdd>
int dispatch(const void* x, const void* r, const void* w, void* s, void* y,
             long long rows, int d, double eps, int types, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float e = (float)eps;
  switch (types) {
    case 0:
      return launch<float, float, kAdd>(x, r, w, s, y, rows, d, e, st);
    case 1:
      return launch<__nv_bfloat16, float, kAdd>(x, r, w, s, y, rows, d, e,
                                                st);
    case 2:
      return launch<float, __nv_bfloat16, kAdd>(x, r, w, s, y, rows, d, e,
                                                st);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16, kAdd>(x, r, w, s, y, rows,
                                                        d, e, st);
  }
}

template <typename TX, typename TW>
int launch_bwd(const void* x, const void* w, const void* dy, const void* ds,
               void* dx, void* dw, float* work, long long rows, int d,
               float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool packed = d % kVec == 0 && aligned(x, 16) && aligned(dy, 16) &&
                      aligned(dx, 16) && aligned(w, sizeof(TW) * kVec) &&
                      (!ds || aligned(ds, 16));
  float* rstd = work;
  float* partial = work + rows;
  if (packed)
    norm_bwd_rows<TX, TW, kVec><<<(unsigned)rows, kThreads, 0, stream>>>(
        (const TX*)x, (const TW*)w, (const TX*)dy, (const TX*)ds, (TX*)dx,
        rstd, d, eps);
  else
    norm_bwd_rows<TX, TW, 1><<<(unsigned)rows, kThreads, 0, stream>>>(
        (const TX*)x, (const TW*)w, (const TX*)dy, (const TX*)ds, (TX*)dx,
        rstd, d, eps);
  const int chunks = rows < kDwChunks ? (int)rows : kDwChunks;
  const long long per = (rows + chunks - 1) / chunks;
  const unsigned col_blocks = (unsigned)((d + kDwThreads - 1) / kDwThreads);
  norm_bwd_dw_partial<TX><<<dim3(col_blocks, chunks), kDwThreads, 0,
                            stream>>>((const TX*)x, (const TX*)dy, rstd,
                                      partial, rows, d, per);
  norm_bwd_dw_fold<TW><<<col_blocks, kDwThreads, 0, stream>>>(
      partial, (TW*)dw, chunks, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, ds (null: none), dx: (rows, d) contiguous, x's type; w, dw: (d,),
// w's type; work: a float32 workspace of rows + min(rows, 64) * d values
// (each row's r, then the dw partials).  x is the norm's input (the stored
// sum s for the residual form).
int rmsnorm_bwd(const void* x, const void* w, const void* dy, const void* ds,
                void* dx, void* dw, void* work, long long rows, int d,
                double eps, int types, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float e = (float)eps;
  float* wk = (float*)work;
  switch (types) {
    case 0:
      return launch_bwd<float, float>(x, w, dy, ds, dx, dw, wk, rows, d, e,
                                      st);
    case 1:
      return launch_bwd<__nv_bfloat16, float>(x, w, dy, ds, dx, dw, wk, rows,
                                              d, e, st);
    case 2:
      return launch_bwd<float, __nv_bfloat16>(x, w, dy, ds, dx, dw, wk, rows,
                                              d, e, st);
    default:
      return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, dy, ds, dx, dw, wk,
                                                      rows, d, e, st);
  }
}


// x, y: (rows, d) contiguous; w: (d,).  rows at least 1 and below 2^31.
int rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int d,
                double eps, int types, void* stream) {
  return dispatch<false>(x, nullptr, w, nullptr, y, rows, d, eps, types,
                         stream);
}

// x, r, s, y: (rows, d) contiguous, one type; w: (d,).
int add_rmsnorm_fwd(const void* x, const void* r, const void* w, void* s,
                    void* y, long long rows, int d, double eps, int types,
                    void* stream) {
  return dispatch<true>(x, r, w, s, y, rows, d, eps, types, stream);
}

}  // extern "C"
