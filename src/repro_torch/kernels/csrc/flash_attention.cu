// Causal / sliding-window GQA softmax attention, forward (CUDA C++, sm_90a).
//
// o[b, h, i] = sum_j softmax_j(s_ij) v[b, h / g, j] with
// s_ij = (q[b, h, i] / sqrt(D)) . k[b, h / g, j], over the keys j allowed by
// the mask: j < Sk, and i >= j when causal, and i - j < window when
// window > 0.  A row with no allowed key is 0.  Replaces the Pallas kernel
// `flash_attention` (`_kernel`) of the JAX package's
// kernels/flash_attention.py.
//
// Bound: on the model's prefill shapes the bytes (each of q, k, v read once,
// o written once) take longer than the operations at the tensor cores' rate;
// this first kernel does its products on the CUDA cores in float32, so its
// arithmetic, not its bytes, is what limits it.  Design: one block of four
// warps per (q tile of 32 rows, head, batch).  A loop over key tiles of 32
// replaces the TPU's sequential grid axis: each tile of K and V is staged in
// shared memory as float32 and used by all 32 query rows of the block,
// while each row keeps its running maximum m, sum l and accumulator acc in
// registers (online softmax, float32).  A warp owns eight rows; lane j
// scores key j of the tile against each of them (float4 reads of the q rows,
// broadcast, and of the padded K row), then the warp holds the 32 weights
// and each lane accumulates D/32 columns of p.V.  Key tiles that no row of
// the block may see (past the diagonal, or wholly before the window) are
// skipped.  GQA comes from the index: head h reads KV head h / g, and no
// repeated KV is written.  Ragged tails of Sq and Sk are masked, so no
// length has to be a multiple of the tile.  The strides of the batch, head
// and sequence axes are arguments (the head axis of the last dimension has
// unit stride), so the model's (B, S, H, D) tensors are read in place.
//
// Masked scores take NEG_INF = -1e30 and go through the same online-softmax
// update as the reference, so partly masked rows agree with it; a row whose
// running maximum is still NEG_INF at the end returns 0.
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                      // query rows per warp
constexpr int kBlockQ = kWarps * kRows;       // 32
constexpr int kBlockK = 32;                   // one key per lane
constexpr float kNegInf = -1e30f;
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

struct Strides {
  long long b, h, s;  // in elements; the last axis has unit stride
};

// a K row is padded to D + 4 floats, so that the lanes' float4 reads of
// their rows fall in distinct banks
template <int D>
struct Tile {
  static constexpr int kStride = D + 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBlockQ * D + kBlockK * kStride + kBlockK * D);
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int group, int len_q,
                 int len_k, float scale, int causal, int window) {
  constexpr int KS = Tile<D>::kStride;
  constexpr int DC = (D + 31) / 32;           // columns of p.V per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBlockQ x D, scaled
  float* ks = qs + kBlockQ * D;                 // kBlockK x KS
  float* vs = ks + kBlockK * KS;                // kBlockK x D

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kWarps * 32) {
    const int r = idx / D, c = idx - r * D;
    const int qi = q0 + r;
    qs[idx] = qi < len_q ? to_f32(qb[qi * sq.s + c]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // keys that some row of this block may see: [k_lo, k_hi)
  const int q_last = min(q0 + kBlockQ, len_q) - 1;
  const int k_hi = causal ? min(len_k, q_last + 1) : len_k;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kWarps * 32) {
      const int r = idx / D, c = idx - r * D;
      const int kj = k0 + r;
      const bool in = kj < len_k;
      ks[r * KS + c] = in ? to_f32(kb[kj * sk.s + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vb[kj * sv.s + c]) : 0.f;
    }
    __syncthreads();

    // scores: lane = key of the tile, one per row of the warp
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ks + lane * KS;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + (warp * kRows + r) * D + c);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // mask and online-softmax update, per row
    const int kj = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const int delta = qi - kj;
      bool ok = kj < len_k;
      if (causal) ok = ok && delta >= 0;
      if (window > 0) ok = ok && delta < window;
      const float sv_ = ok ? s[r] : kNegInf;
      float tmax = sv_;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      p[r] = expf(sv_ - m_new);
      const float corr = expf(m[r] - m_new);
      float psum = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kFullMask, psum, off);
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }

    // acc += p . V: lane owns columns lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < D ? vs[j * D + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFullMask, p[r], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= len_q) continue;
    const bool empty = m[r] <= kNegInf * 0.5f;
    const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < D)
        ob[qi * so.s + col] = from_f32<T>(empty ? 0.f : acc[r][c] / lr);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int batch, int heads,
           int group, int len_q, int len_k, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmemBytes;
  // once per instantiation (and so never inside a CUDA-graph capture after
  // a first eager call): allow more than 48 KB of dynamic shared memory
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (configured != cudaSuccess) return (int)configured;
  const dim3 grid((len_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, sv, so, group,
      len_q, len_k, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             void* o, Strides sq, Strides sk, Strides sv, Strides so,
             int batch, int heads, int group, int len_q, int len_k,
             float scale, int causal, int window, cudaStream_t s) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, sq, sk, sv, so, batch, heads, group,
                           len_q, len_k, scale, causal, window, s);
    case 32:
      return launch<T, 32>(q, k, v, o, sq, sk, sv, so, batch, heads, group,
                           len_q, len_k, scale, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, o, sq, sk, sv, so, batch, heads, group,
                           len_q, len_k, scale, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, sq, sk, sv, so, batch, heads, group,
                            len_q, len_k, scale, causal, window, s);
    case 256:
      return launch<T, 256>(q, k, v, o, sq, sk, sv, so, batch, heads, group,
                            len_q, len_k, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (batch, heads, len_q, head_dim); k, v: (batch, kv_heads, len_k,
// head_dim), each given by its batch, head and sequence strides (elements).
// head_dim is one of 16, 32, 64, 128, 256; heads % kv_heads == 0; len_q
// and len_k at least 1 and below 2^31; window <= 0 means no window, and
// a window is below 2^31.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        int batch, int heads, int kv_heads, long long len_q,
                        long long len_k, int head_dim, double scale,
                        int causal, long long window, int bf16,
                        void* stream) {
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  const int group = heads / kv_heads;
  const int win = window > 0 ? (int)window : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, sq, sk, sv, so,
                                   batch, heads, group, (int)len_q,
                                   (int)len_k, (float)scale, causal, win, s);
  return dispatch<float>(head_dim, q, k, v, o, sq, sk, sv, so, batch, heads,
                         group, (int)len_q, (int)len_k, (float)scale, causal,
                         win, s);
}

}  // extern "C"
