// Causal / sliding-window GQA softmax attention, forward and backward (CUDA
// C++, sm_90a).  The forward's kernels are described here; the backward's,
// for the training path, in their own section below.
//
// o[b, h, i] = sum_j softmax_j(s_ij) v[b, h / g, j] with
// s_ij = (q[b, h, i] / sqrt(D)) . k[b, h / g, j], over the keys j allowed by
// the mask: j < Sk, and p_i >= j when causal, and p_i - j < window when
// window > 0, where query row i sits at position p_i = q_off + i (q_off 0
// but for a share of a sequence's rows: the sequence-sharded attention of
// the model under a tensor-parallel context).  A row with no allowed key
// is 0.  Every tile range and mask test below reads the position; the
// index of a row in q, o, lse stays i, and with q_off = 0 each kernel
// computes what it did before the offset.  The heavy-first tile orders
// stay heaviest-first under an offset (a query tile's key count still
// grows with its index, a key tile's query count still falls), with less
// spread between the first and the last.  Replaces the Pallas kernel
// `flash_attention` (`_kernel`) of the JAX package's
// kernels/flash_attention.py.
//
// Two kernels; the inputs' type picks one, and both count as launches of
// the one wrapper.
//
// bfloat16: tensor cores (flash_fwd_bf16_mma).  Bound: on the model's
// prefill shapes the bytes (each of q, k, v read once, o written once) take
// longer than the operations at the tensor cores' rate, so the design keeps
// the products on the tensor cores and every intermediate on chip, in the
// manner of FlashAttention-2:
//   - one block of four warps per (64 query rows, head, batch); each warp
//     owns 16 rows (one m16 tile); its Q fragments are loaded once with
//     `ldmatrix` and stay in registers (D <= 128; for D = 136 and 256 they
//     are read from shared memory at every key tile, to keep the registers
//     free of spills);
//   - K and V tiles of 64 keys (32 for D > 128) go through a two-stage
//     `cp.async` ring in dynamic shared memory, 16-byte chunks XOR-swizzled
//     by row so that the `ldmatrix` / `ldmatrix.trans` reads of eight rows
//     hit eight distinct bank groups (a row of 12, 14 or 18 chunks — D = 96,
//     112, 144 — is padded in shared memory to 16 or 24, so that the XOR
//     stays inside the row);
//   - the products walk D rounded up to 16 (whole k-steps): D = 136 runs a
//     144-wide tile whose 17th chunk is zero-filled on load and whose last
//     8 columns are never stored, with the scale of the true D;
//   - S = Q K^T and O += P V are `mma.sync.m16n8k16` with bf16 operands and
//     f32 accumulators; V is read with `ldmatrix.trans`; P goes from the f32
//     accumulator fragment to the bf16 A-operand fragment in registers (the
//     C layout of m16n8k16 is its A layout), never through shared memory;
//   - online softmax on the fragments: running (m, l) per row in f32, the
//     row max across the quad of lanes that share a row by two
//     __shfl_xor_sync, and the row sum across the quad once at the end;
//     the softmax scale multiplies the f32 score inside one exp2f argument,
//     fmaf(s, scale * log2 e, -m * scale * log2 e) (the library is built
//     with -fmad=false, so this fmaf is the only contraction);
//   - the per-element mask (causal, window, ragged Sk) runs only on key
//     tiles that straddle an edge; tiles no row of the block may see are
//     skipped; ragged Sq / Sk rows are zero-filled by cp.async's src-size
//     form; query tiles run heavy first (the block index counts down the
//     query tiles, so the causal blocks with the most key tiles start
//     first).
// Numerics: bf16 x bf16 products are exact in f32, so S differs from the
// float32 plain version only in summation order.  P is rounded to bf16 for
// P V (a relative error <= 2^-9 per weight) while l sums the f32 p.  At unit-
// scale inputs the expected error against the plain version is <= 0.01; the
// tolerance is the reference's bf16 2e-2.  Masked scores take
// NEG_INF = -1e30 and go through the same update as in the reference; while
// a row's running max is still NEG_INF its masked weights are 0 here where
// the reference has exp(0) = 1, which it then multiplies by
// exp(NEG_INF - m) = 0 at the row's first allowed key, or drops when the
// row returns 0 — the output is the same.  16-byte cp.async needs every row
// of q, k, v 16-byte aligned: the wrapper checks pointers and strides.
//
// float32: CUDA cores (flash_fwd_f32).  Tensor cores would mean TF32, ten
// bits of mantissa, which breaks the float32 tolerance of 2e-5.  One block
// of four warps per (q tile of 32 rows, head, batch).  A loop over key tiles
// of 32 replaces the TPU's sequential grid axis: each tile of K and V is
// staged in shared memory and used by all 32 query rows of the block, while
// each row keeps its running maximum m, sum l and accumulator acc in
// registers.  A warp owns eight rows; lane j scores key j of the tile
// against each of them (float4 reads of the q rows, broadcast, and of the
// padded K row), then the warp holds the 32 weights and each lane
// accumulates D/32 columns of p.V.  Arithmetic on the CUDA cores bounds it.
//
// Both: GQA comes from the index (head h reads KV head h / g, no repeated KV
// is written); no length has to be a multiple of a tile; the strides of the
// batch, head and sequence axes are arguments (the head dimension has unit
// stride), so the model's (B, S, H, D) tensors are read in place and the
// output keeps q's stride order.  A row whose running maximum is still
// NEG_INF at the end returns 0.
//
// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

struct Strides {
  long long b, h, s;  // in elements; the last axis has unit stride
};

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kWarps = 4;
constexpr int kRows = 8;                      // query rows per warp
constexpr int kBlockQ = kWarps * kRows;       // 32
constexpr int kBlockK = 32;                   // one key per lane

// a K row is padded to D + 4 floats, so that the lanes' float4 reads of
// their rows fall in distinct banks
template <int D>
struct Tile {
  static constexpr int kStride = D + 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBlockQ * D + kBlockK * kStride + kBlockK * D);
};

template <int D, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, Strides sq,
              Strides sk, Strides sv, Strides so, int group, int len_q,
              int len_k, float scale, int causal, int window, int q_off) {
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
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kWarps * 32) {
    const int r = idx / D, c = idx - r * D;
    const int qi = q0 + r;
    qs[idx] = qi < len_q ? qb[qi * sq.s + c] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // keys that some row of this block may see: [k_lo, k_hi); row i sits at
  // position q_off + i
  const int q_last = min(q0 + kBlockQ, len_q) - 1;
  const int k_hi = causal ? min(len_k, q_off + q_last + 1) : len_k;
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;

  for (int k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();                 // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kWarps * 32) {
      const int r = idx / D, c = idx - r * D;
      const int kj = k0 + r;
      const bool in = kj < len_k;
      ks[r * KS + c] = in ? kb[kj * sk.s + c] : 0.f;
      vs[r * D + c] = in ? vb[kj * sv.s + c] : 0.f;
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
      const int delta = q_off + qi - kj;
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
      if (col < D) ob[qi * so.s + col] = empty ? 0.f : acc[r][c] / lr;
    }
    if constexpr (kLse) {              // the scores here carry the scale
      if (lane == 0)
        lse[((long long)b * gridDim.y + h) * len_q + qi] =
            empty ? INFINITY : m[r] + logf(lr);
    }
  }
}

template <int D, bool kLse>
int launch_one(const void* q, const void* k, const void* v, void* o,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int batch, int heads, int group, int len_q, int len_k,
               float scale, int causal, int window, int q_off,
               cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmemBytes;
  // once per instantiation (and so never inside a CUDA-graph capture after
  // a first eager call): allow more than 48 KB of dynamic shared memory
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_f32<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (configured != cudaSuccess) return (int)configured;
  const dim3 grid((len_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_f32<D, kLse><<<grid, kWarps * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, sq,
      sk, sv, so, group, len_q, len_k, scale, causal, window, q_off);
  return (int)cudaGetLastError();
}

// the lse store is a separate instance, so the kernel that generation runs
// is the same code as before the training path asked for it
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides sq, Strides sk, Strides sv, Strides so, int batch,
           int heads, int group, int len_q, int len_k, float scale,
           int causal, int window, int q_off, cudaStream_t stream) {
  return lse ? launch_one<D, true>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                   heads, group, len_q, len_k, scale, causal,
                                   window, q_off, stream)
             : launch_one<D, false>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                    heads, group, len_q, len_k, scale,
                                    causal, window, q_off, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;          // 64 query rows, 16 per warp

// Chunks a row of C 16-byte chunks takes in shared memory: C below 8 (a
// power of two), else C rounded up to a multiple of 8, so that swz's XOR
// with r & 7 keeps every chunk inside its row (12 -> 16, 14 -> 16,
// 18 -> 24; 8, 16 and 32 stay as they are).
template <int C>
__host__ __device__ constexpr int pitch() {
  static_assert(C >= 8 || (C & (C - 1)) == 0, "C below 8 is a power of 2");
  return C >= 8 ? (C + 7) / 8 * 8 : C;
}

// A bf16 row of head dim D in shared memory: the products walk kDim, D
// rounded up to 16 (whole m16n8k16 k-steps), that is kChunks 16-byte
// chunks, of which the first kLoaded hold the row and the rest (one, at
// D = 136) are zero-filled on load; kBytes a row with its padding.
template <int D>
struct Row {
  static_assert(D % 8 == 0, "whole 16-byte chunks");
  static constexpr int kDim = (D + 15) / 16 * 16;
  static constexpr int kChunks = kDim / 8;
  static constexpr int kLoaded = D / 8;
  static constexpr int kBytes = pitch<kChunks>() * 16;
};

template <int D>
struct Cfg {
  static constexpr int kChunks = Row<D>::kChunks;
  static constexpr int kBlockK = Row<D>::kDim > 128 ? 32 : 64;
  static constexpr bool kQInRegs = Row<D>::kDim <= 128;
  static constexpr int kTileBytes = kBlockK * Row<D>::kBytes;  // K or V
  static constexpr int kQBytes = kBlockQ * Row<D>::kBytes;
  static constexpr int kRingBytes = 2 * 2 * kTileBytes;  // 2 stages x (K, V)
  // Q is staged in stage 1 when it moves on to registers before the ring
  // needs that stage; else it keeps a region of its own
  static constexpr int kSmemBytes =
      kQInRegs ? kRingBytes : kRingBytes + kQBytes;
  static_assert(!kQInRegs || kQBytes <= 2 * kTileBytes, "Q fits stage 1");
};

// Byte offset of 16-byte chunk c of row r in a tile of C chunks a row.
// The chunk index is XORed with the row's place among the rows that share
// a 128-byte line pattern, so the eight row addresses of one ldmatrix 8x8
// read fall in eight distinct bank groups.
template <int C>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kRowsPerLine = C >= 8 ? 1 : 8 / C;
  constexpr int kMask = (C >= 8 ? 8 : C) - 1;
  constexpr int kPitch = pitch<C>();
  return (uint32_t)((r * kPitch + (c ^ ((r / kRowsPerLine) & kMask))) * 16);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// the first two matrices of ldsm_x4_trans (addresses from lanes 0-15)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a . b on a 16x8x16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a (len, D) matrix with row stride `stride`
// into a swizzled tile at `dst`; rows at or past `len`, and the chunks past
// D of a row padded to Row<D>::kDim, are zero-filled.  The last round of
// copies is partial when ROWS * kChunks is not a multiple of the block
// (32 x 18 chunks at D = 136).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long stride, int row0,
                                          int len, int tid) {
  constexpr int C = Row<D>::kChunks, CL = Row<D>::kLoaded, N = ROWS * C;
#pragma unroll
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + tid;
    if (N % kThreads == 0 || i < N) {
      const int r = i / C, c = i % C;
      const bool in = row0 + r < len && (CL == C || c < CL);
      const bf16* src = base + (in ? (long long)(row0 + r) * stride + c * 8
                                   : 0);
      cp_async16(dst + swz<C>(r, c), src, in);
    }
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, Strides sq, Strides sk,
                   Strides sv, Strides so, int heads,
                   int batch, int group, int len_q, int len_k,
                   float scale_log2, int causal, int window, int q_off,
                   int n_qtiles) {
  using Cf = Cfg<D>;
  constexpr int C = Cf::kChunks;
  constexpr int BK = Cf::kBlockK;
  constexpr int NT = BK / 8;        // key n-tiles of S
  constexpr int KD = Row<D>::kDim / 16;   // k-steps of Q K^T
  constexpr int DT = Row<D>::kDim / 8;    // d n-tiles of O
  extern __shared__ uint4 smem_tc[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem_tc);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;     // fragment row, column pair
  const int hb = heads * batch;
  // heavy first: the first blocks take the last (causally largest) q tile
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % heads;
  const int b = (int)(blockIdx.x % hb) / heads;
  const int kvh = h / group;
  const int q0 = qt * kBlockQ;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  bf16* ob = o + b * so.b + h * so.h;

  const uint32_t ring = sbase;
  const uint32_t qsm =
      Cf::kQInRegs ? ring + 2 * Cf::kTileBytes : ring + Cf::kRingBytes;

  // keys that some row of this block may see: [k_lo, k_hi); row i sits at
  // position q_off + i
  const int q_last = min(q0 + kBlockQ, len_q) - 1;
  const int k_hi = causal ? min(len_k, q_off + q_last + 1) : len_k;
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int t_first = k_lo / BK;
  const int t_end = (k_hi + BK - 1) / BK;

  load_tile<D, kBlockQ>(qsm, qb, sq.s, q0, len_q, tid);
  cp_async_commit();
  if (t_first < t_end) {
    load_tile<D, BK>(ring, kb, sk.s, t_first * BK, len_k, tid);
    load_tile<D, BK>(ring + Cf::kTileBytes, vb, sv.s, t_first * BK, len_k,
                     tid);
  }
  cp_async_commit();
  cp_async_wait<1>();               // this thread's Q copies have landed
  __syncthreads();                  // and everyone's

  // Q fragments of this warp's 16 rows: ldmatrix x4 = (rows 0-7, 8-15) x
  // (columns 0-7, 8-15) of each 16-wide k-step
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = lane >> 4;
  uint32_t qf[Cf::kQInRegs ? KD : 1][4];
  if constexpr (Cf::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qsm + swz<C>(a_row, kk * 2 + a_col), qf[kk]);
    __syncthreads();                // stage 1 is free for the ring
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;        // rows of c0,c1; +8 for c2,c3

  // ldmatrix lane addressing of the K (S = Q K^T) and V (O += P V) tiles
  const int kb_row = (lane & 7) + (lane >> 4) * 8, kb_col = (lane >> 3) & 1;
  const int vb_row = (lane & 7) + ((lane >> 3) & 1) * 8, vb_col = lane >> 4;

  for (int t = t_first; t < t_end; ++t) {
    const uint32_t ks = ring + ((t - t_first) & 1) * 2 * Cf::kTileBytes;
    const uint32_t vs = ks + Cf::kTileBytes;
    if (t + 1 < t_end) {            // the next tile, into the other stage
      const uint32_t nk = ring + ((t + 1 - t_first) & 1) * 2 * Cf::kTileBytes;
      load_tile<D, BK>(nk, kb, sk.s, (t + 1) * BK, len_k, tid);
      load_tile<D, BK>(nk + Cf::kTileBytes, vb, sv.s, (t + 1) * BK, len_k,
                       tid);
    }
    cp_async_commit();
    cp_async_wait<1>();             // tile t has landed
    __syncthreads();

    // S = Q K^T: 16 rows x BK keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (Cf::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(qsm + swz<C>(a_row, kk * 2 + a_col), a);
      }
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4];
        ldsm_x4(ks + swz<C>(nn * 16 + kb_row, kk * 2 + kb_col), bk);
        mma(s[2 * nn], a, bk[0], bk[1]);
        mma(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // the mask, only on tiles that straddle an edge
    const int k0 = t * BK;
    if (k0 + BK > len_k || (causal && k0 + BK - 1 > q_off + q0) ||
        (window > 0 && k0 < q_off + q0 + kBlockQ - window)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q_off + row0 + (e >> 1) * 8;   // its position
          const int kj = k0 + nt * 8 + 2 * tq + (e & 1);
          bool ok = kj < len_k;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && qi - kj < window;
          if (!ok) s[nt][e] = kNegInf;
        }
    }

    // online softmax, per row half (c0,c1: row g; c2,c3: row g + 8)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m_r[half];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float corr = exp2f((m_r[half] - mx) * scale_log2);
      m_r[half] = mx;
      const float msc = mx == kNegInf ? 0.f : mx * scale_log2;
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = exp2f(fmaf(s[nt][e], scale_log2, -msc));
          s[nt][e] = p;
          psum += p;
        }
      l_r[half] = fmaf(l_r[half], corr, psum);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * half] *= corr;
        acc[dt][2 * half + 1] *= corr;
      }
    }

    // O += P V: P's C fragments are the A fragments of the next product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t bv[4];
        ldsm_x4_trans(vs + swz<C>(kk * 16 + vb_row, dn * 2 + vb_col), bv);
        mma(acc[2 * dn], a, bv[0], bv[1]);
        mma(acc[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();                // stage read; the next prefetch reuses it
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_r[half];
    l += __shfl_xor_sync(kFullMask, l, 1);
    l += __shfl_xor_sync(kFullMask, l, 2);
    const int qi = row0 + half * 8;
    if (qi >= len_q) continue;
    const bool empty = m_r[half] <= kNegInf * 0.5f;
    const float inv = empty ? 0.f : 1.f / fmaxf(l, 1e-30f);
    if constexpr (kLse) {            // natural log, scale applied
      if (tq == 0)
        lse[((long long)b * heads + h) * len_q + qi] =
            empty ? INFINITY
                  : (m_r[half] * scale_log2 + log2f(fmaxf(l, 1e-30f))) *
                        0.69314718055994531f;
    }
    bf16* orow = ob + (long long)qi * so.s + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)     // the padded columns stay unwritten
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * half] * inv, acc[dt][2 * half + 1] * inv);
  }
}

template <int D, bool kLse>
int launch_one(const void* q, const void* k, const void* v, void* o,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int batch, int heads, int group, int len_q, int len_k,
               float scale_log2, int causal, int window, int q_off,
               cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kSmemBytes;
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_bf16_mma<D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return (int)configured;
  const int n_qtiles = (len_q + kBlockQ - 1) / kBlockQ;
  const long long blocks = (long long)n_qtiles * heads * batch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_bf16_mma<D, kLse><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, sq, sk,
      sv, so, heads, batch, group, len_q, len_k, scale_log2, causal, window,
      q_off, n_qtiles);
  return (int)cudaGetLastError();
}

// the lse store is a separate instance, so the kernel that generation runs
// is the same code as before the training path asked for it
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           Strides sq, Strides sk, Strides sv, Strides so, int batch,
           int heads, int group, int len_q, int len_k, float scale_log2,
           int causal, int window, int q_off, cudaStream_t stream) {
  return lse ? launch_one<D, true>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                   heads, group, len_q, len_k, scale_log2,
                                   causal, window, q_off, stream)
             : launch_one<D, false>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                    heads, group, len_q, len_k, scale_log2,
                                    causal, window, q_off, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// backward: the shared delta pass, float32 on the CUDA cores
// ---------------------------------------------------------------------------
//
// The gradient of the forward above from its log-sum-exp, in the manner of
// FlashAttention-2's backward, for the training path.  The JAX package has
// no backward kernel (it differentiates its plain jnp attention by
// autodiff); this one exists because the port's forward is a kernel.
//   delta_i = sum_d dO_id O_id, P_ij = exp(s_ij - lse_i) over allowed keys
//   (0 elsewhere; lse is +inf for a row with no allowed key),
//   dV_j = sum_i P_ij dO_i, dS_ij = P_ij (dO_i . V_j - delta_i),
//   dQ_i = scale sum_j dS_ij K_j, dK_j = scale sum_i dS_ij Q_i,
// with s_ij = scale Q_i . K_j.  No kernel of either type uses atomics:
// every sum runs in a fixed order, so the gradients are the same bits on
// every run (a resumed training run repeats the uninterrupted one).
//
// float32 (this namespace): three kernels on the CUDA cores, everything
// float32 inside, since tensor cores would mean TF32 and break the 1e-4
// tolerance.  `delta` (one warp a row);
// `dq` (one block per 32 query rows, head, batch: a loop over the key
// tiles the rows may see, as in the float32 forward: lane = key for the
// dot products, lane = column for the sum into dQ); `dkv` (one block per
// 32 keys, KV head, batch: a loop over the group's query heads, in order,
// and over the query tiles that may see the keys; lane = query row for
// the dot products, lane = column for the sums into dK and dV).  Bound:
// operations (5 products of the forward's size against its 2) at the CUDA
// cores' float32 rate.

namespace bwd {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                     // rows (queries or keys) a warp
constexpr int kBlock = kWarps * kRows;       // 32

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// query row qi (at position q_off + qi) and key kj
__device__ __forceinline__ bool allowed(int qi, int kj, int len_q, int len_k,
                                        int causal, int window, int q_off) {
  bool ok = qi < len_q && kj < len_k;
  const int pos = q_off + qi;
  if (causal) ok = ok && pos >= kj;
  if (window > 0) ok = ok && pos - kj < window;
  return ok;
}

// delta[row] = O_row . dO_row for the rows (b, h, i) in that order
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
          float* __restrict__ delta, Strides so, Strides sd, int heads,
          int len_q, long long rows) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                   // a whole warp at once
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % len_q);
  const long long bh = row / len_q;
  const int h = (int)(bh % heads), b = (int)(bh / heads);
  const float* orow = o + b * so.b + h * so.h + i * so.s;
  const float* drow = dout + b * sd.b + h * sd.h + i * sd.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
struct DqTile {                               // rows padded to D + 4 floats
  static constexpr int kStride = D + 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kBlock * D + 2 * kBlock * kStride);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sd,
       Strides sdq, int group, int len_q, int len_k, float scale,
       int causal, int window, int q_off) {
  constexpr int KS = DqTile<D>::kStride;
  constexpr int DC = (D + 31) / 32;           // columns of dQ a lane
  extern __shared__ float4 smem_dq[];
  float* qs = reinterpret_cast<float*>(smem_dq);  // kBlock x D
  float* gs = qs + kBlock * D;                    // dO rows, kBlock x D
  float* ks = gs + kBlock * D;                    // kBlock x KS
  float* vs = ks + kBlock * KS;                   // kBlock x KS

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int kvh = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = dout + b * sd.b + h * sd.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const long long stat = ((long long)b * heads + h) * len_q;

  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int qi = q0 + r;
    const bool in = qi < len_q;
    qs[idx] = in ? qb[qi * sq.s + c] : 0.f;
    gs[idx] = in ? gb[qi * sd.s + c] : 0.f;
  }
  float lse_r[kRows], dl_r[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    lse_r[r] = qi < len_q ? lse[stat + qi] : 0.f;
    dl_r[r] = qi < len_q ? delta[stat + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBlock, len_q) - 1;
  const int k_hi = causal ? min(len_k, q_off + q_last + 1) : len_k;
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;

  for (int k0 = (k_lo / kBlock) * kBlock; k0 < k_hi; k0 += kBlock) {
    __syncthreads();                          // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      const int kj = k0 + r;
      const bool in = kj < len_k;
      ks[r * KS + c] = in ? kb[kj * sk.s + c] : 0.f;
      vs[r * KS + c] = in ? vb[kj * sv.s + c] : 0.f;
    }
    __syncthreads();

    // lane = key of the tile: s = q_r . k_lane, dp = dO_r . v_lane
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* krow = ks + lane * KS;
    const float* vrow = vs + lane * KS;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + c);
      const float4 vv4 = *reinterpret_cast<const float4*>(vrow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = (warp * kRows + r) * D + c;
        s[r] = dot4(*reinterpret_cast<const float4*>(qs + row), kv4, s[r]);
        dp[r] = dot4(*reinterpret_cast<const float4*>(gs + row), vv4, dp[r]);
      }
    }
    const int kj = k0 + lane;
    float g[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const float p = allowed(qi, kj, len_q, len_k, causal, window, q_off)
                          ? expf(s[r] * scale - lse_r[r]) : 0.f;
      g[r] = p * (dp[r] - dl_r[r]);
    }
    // acc += dS . K: lane owns columns lane, lane + 32, ...
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float kc[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = lane + 32 * c;
        kc[c] = col < D ? ks[j * KS + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float gj = __shfl_sync(kFullMask, g[r], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(gj, kc[c], acc[r][c]);
      }
    }
  }

  float* db = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= len_q) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) db[qi * sdq.s + col] = acc[r][c] * scale;
    }
  }
}

template <int D>
struct DkvTile {
  static constexpr int kStride = D + 4;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * kBlock * D + 2 * kBlock * kStride + 2 * kBlock);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, Strides sq,
        Strides sk, Strides sv, Strides sd, Strides sdk, Strides sdv,
        int heads, int group, int len_q, int len_k, float scale, int causal,
        int window, int q_off) {
  constexpr int QS = DkvTile<D>::kStride;
  constexpr int DC = (D + 31) / 32;
  extern __shared__ float4 smem_dkv[];
  float* ks = reinterpret_cast<float*>(smem_dkv);  // kBlock x D
  float* vs = ks + kBlock * D;                      // kBlock x D
  float* qs = vs + kBlock * D;                      // kBlock x QS
  float* gs = qs + kBlock * QS;                     // dO rows, kBlock x QS
  float* lse_s = gs + kBlock * QS;                  // kBlock
  float* dl_s = lse_s + kBlock;                     // kBlock

  const int k0 = blockIdx.x * kBlock;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int kj = k0 + r;
    const bool in = kj < len_k;
    ks[idx] = in ? kb[kj * sk.s + c] : 0.f;
    vs[idx] = in ? vb[kj * sv.s + c] : 0.f;
  }
  float acc_k[kRows][DC], acc_v[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // query rows that may see some key of this block: [q_lo, q_hi)
  const int k_last = min(k0 + kBlock, len_k) - 1;
  const int q_lo = causal ? max(0, k0 - q_off) : 0;
  const int q_hi = window > 0 ? min(len_q, k_last + window - q_off) : len_q;

  for (int hh = 0; hh < group; ++hh) {       // the group's heads, in order
    const int h = kvh * group + hh;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* gb = dout + b * sd.b + h * sd.h;
    const long long stat = ((long long)b * heads + h) * len_q;
    for (int q0 = (q_lo / kBlock) * kBlock; q0 < q_hi; q0 += kBlock) {
      __syncthreads();                        // the previous tile is consumed
      for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
        const int r = idx / D, c = idx - r * D;
        const int qi = q0 + r;
        const bool in = qi < len_q;
        qs[r * QS + c] = in ? qb[qi * sq.s + c] : 0.f;
        gs[r * QS + c] = in ? gb[qi * sd.s + c] : 0.f;
      }
      if (threadIdx.x < kBlock) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < len_q ? lse[stat + qi] : 0.f;
        dl_s[threadIdx.x] = qi < len_q ? delta[stat + qi] : 0.f;
      }
      __syncthreads();

      // lane = query row of the tile: s = q_lane . k_r, dp = dO_lane . v_r
      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
      const float* qrow = qs + lane * QS;
      const float* grow = gs + lane * QS;
#pragma unroll 2
      for (int c = 0; c < D; c += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + c);
        const float4 g4 = *reinterpret_cast<const float4*>(grow + c);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int row = (warp * kRows + r) * D + c;
          s[r] = dot4(q4, *reinterpret_cast<const float4*>(ks + row), s[r]);
          dp[r] = dot4(g4, *reinterpret_cast<const float4*>(vs + row), dp[r]);
        }
      }
      const int qi = q0 + lane;
      const float lse_i = lse_s[lane], dl_i = dl_s[lane];
      float p[kRows], g[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kj = k0 + warp * kRows + r;
        p[r] = allowed(qi, kj, len_q, len_k, causal, window, q_off)
                   ? expf(s[r] * scale - lse_i) : 0.f;
        g[r] = p[r] * (dp[r] - dl_i);
      }
      // acc_v += P^T dO, acc_k += dS^T Q: lane owns columns
#pragma unroll 2
      for (int i = 0; i < kBlock; ++i) {
        float gc[DC], qc[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = lane + 32 * c;
          gc[c] = col < D ? gs[i * QS + col] : 0.f;
          qc[c] = col < D ? qs[i * QS + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pi = __shfl_sync(kFullMask, p[r], i);
          const float gi = __shfl_sync(kFullMask, g[r], i);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc_v[r][c] = fmaf(pi, gc[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(gi, qc[c], acc_k[r][c]);
          }
        }
      }
    }
  }

  float* dkb = dk + b * sdk.b + kvh * sdk.h;
  float* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + warp * kRows + r;
    if (kj >= len_k) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        dkb[kj * sdk.s + col] = acc_k[r][c] * scale;
        dvb[kj * sdv.s + col] = acc_v[r][c];
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  float* work;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
  int batch, heads, group, kv_heads, len_q, len_k;
  float scale;
  int causal, window, q_off;
};

template <int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem_dq = DqTile<D>::kSmemBytes;
  constexpr size_t smem_dkv = DkvTile<D>::kSmemBytes;
  // once per instantiation: allow more than 48 KB of dynamic shared memory
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DqTile<D>::kSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(bwd_dkv<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)DkvTile<D>::kSmemBytes);
  }();
  if (configured != cudaSuccess) return (int)configured;
  const long long rows = (long long)a.batch * a.heads * a.len_q;
  const long long delta_blocks = (rows + kWarps - 1) / kWarps;
  if (delta_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_delta<D><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(
      (const float*)a.o, (const float*)a.dout, a.delta, a.so, a.sd, a.heads,
      a.len_q, rows);
  const dim3 grid_q((a.len_q + kBlock - 1) / kBlock, a.heads, a.batch);
  bwd_dq<D><<<grid_q, kThreads, smem_dq, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, a.lse, a.delta, (float*)a.dq, a.sq, a.sk, a.sv,
      a.sd, a.sdq, a.group, a.len_q, a.len_k, a.scale, a.causal, a.window,
      a.q_off);
  const dim3 grid_k((a.len_k + kBlock - 1) / kBlock, a.kv_heads, a.batch);
  bwd_dkv<D><<<grid_k, kThreads, smem_dkv, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, a.lse, a.delta, (float*)a.dk, (float*)a.dv, a.sq,
      a.sk, a.sv, a.sd, a.sdk, a.sdv, a.heads, a.group, a.len_q, a.len_k,
      a.scale, a.causal, a.window, a.q_off);
  return (int)cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// backward, bfloat16: tensor cores
// ---------------------------------------------------------------------------
//
// The same gradient on the tensor cores, in the manner of FlashAttention-2's
// backward, with the forward's tools: `tc::swz` swizzled tiles, `ldmatrix`
// / `ldmatrix.trans`, `mma.sync.m16n8k16` bf16 -> f32 and the `cp.async`
// tile loader.  Bound: at the training shapes the bytes (q, k, v, o, dout
// read once, the three gradients written once) and the ten products'
// operations at 989 TFLOP/s are of one size, so the design keeps every
// product on the tensor cores and every intermediate (S, P, dP, dS) in
// registers.  Four launches, none with atomics:
//   - `delta` (bwd_delta_packed): D / 8 lanes a row (rounded up to a
//     power of two), 16-byte packs.
//   - `dkv` (bwd_dkv_mma): one block of four warps per (64 keys, query head,
//     batch) — per (32 keys, ...) for D > 128 — so a GQA group's heads run
//     in parallel blocks (448 blocks at q (2, 28, 512, 128) where a block
//     per KV head gave 128).  K and V of the block stay in swizzled shared
//     memory; Q, dO, lse and delta tiles of the query rows that may see the
//     keys stream through a two-stage cp.async ring (32 rows a stage for
//     D > 64, else 64); key tile 0, which a causal mask lets see the most
//     query tiles, starts first.  A warp owns 16 keys (and, for D > 128,
//     half of the columns of dK and dV: two warps share the keys and both
//     compute their S^T; at D = 136 each half is 72 columns, 9 n-tiles, the
//     last read by an ldmatrix .x2) and computes S^T = K Q^T and dP^T = V dO^T, then
//     P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
//     delta) in f32 on the accumulator fragments, and dV += P^T dO, dK +=
//     dS^T Q with P^T, dS^T moved from the C fragments to bf16 A fragments
//     in registers (dO and Q read by ldmatrix.trans).  With one head a
//     group the block writes dK (scaled) and dV in bf16; else it writes its
//     head's float32 partials into the workspace (B, H, Sk, D), each twice.
//   - `fold` (bwd_fold, only when a group has more than one head): for each
//     KV head, the group's partials summed in head order, dK scaled, each
//     rounded once to bf16.  This fixed order replaces the head loop of the
//     float32 kernel's dkv pass.
//   - `dq` (bwd_dq_mma): the forward's layout, one block of four warps per
//     (64 query rows, head, batch), heavy query tiles first; Q and dO tiles
//     stay in shared memory, K and V tiles of 64 keys (32 for D > 128) go
//     through the ring; S = Q K^T, dP = dO V^T, dS in f32, dQ += dS K with
//     dS rounded to bf16 as the A operand and K read by ldmatrix.trans.
//     The dQ pass recomputes S and dP, so the backward runs seven products
//     where the math has five: that is the price of writing every gradient
//     from the one block that owns it, with no atomics.
// Numerics: P is rounded to bf16 for P^T dO and dS for dS^T Q and dS K,
// as FlashAttention-2 does; lse, delta, the exponent and every accumulator
// stay f32.  The wrapper checks that every row of q, k, v, o, dout is
// 16-byte aligned for cp.async and the packed loads.  Head dims that are
// not a multiple of 16 (136) run on the forward's zero-padded tiles: the
// padded columns add 0 to every product and are never stored, and the
// workspace keeps the true D.

namespace tc_bwd {

using bf16 = __nv_bfloat16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x2_trans;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::load_tile;
using tc::mma;
using tc::pack_bf16;
using tc::Row;
using tc::swz;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

// whether some (query, key) pair of [q0, q0 + bq) x [k0, k0 + bk) is not
// allowed (query row i at position q_off + i): only such tiles run the
// per-element mask
__device__ __forceinline__ bool straddles(int q0, int bq, int k0, int bk,
                                          int len_q, int len_k, int causal,
                                          int window, int q_off) {
  return q0 + bq > len_q || k0 + bk > len_k ||
         (causal && k0 + bk - 1 > q_off + q0) ||
         (window > 0 && q_off + q0 + bq - 1 - k0 >= window);
}

// lanes of bwd_delta_packed a row: D / 8 (one 16-byte pack each) rounded
// up to a power of two, so that a warp's rows are aligned groups of lanes
// (16 for D = 96 and 112, 32 for D = 136)
template <int D>
__host__ __device__ constexpr int delta_lanes() {
  static_assert(D % 8 == 0 && D <= 256, "whole packs, a row in a warp");
  int l = 1;
  while (l < D / 8) l *= 2;
  return l;
}

// delta[row] = O_row . dO_row for bfloat16 rows that are 16-byte aligned:
// delta_lanes<D>() lanes a row, the first D / 8 each reading 8 values of O
// and of dO as one pack, the lanes' sums folded by shuffles
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_packed(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, Strides so, Strides sd,
                 int heads, int len_q, long long rows) {
  constexpr int L = delta_lanes<D>();   // lanes a row
  constexpr int R = 32 / L;             // rows a warp
  const int lane = threadIdx.x & 31;
  const long long row =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * R + lane / L;
  const int c = (lane % L) * 8;
  float acc = 0.f;
  if (row < rows && (L == D / 8 || c < D)) {
    const int i = (int)(row % len_q);
    const long long bh = row / len_q;
    const int h = (int)(bh % heads), b = (int)(bh / heads);
    const uint4 a = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + i * so.s + c);
    const uint4 e = *reinterpret_cast<const uint4*>(
        dout + b * sd.b + h * sd.h + i * sd.s + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&e);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]);
      const float2 y = __bfloat1622float2(e2[j]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (row < rows && lane % L == 0) delta[row] = acc;
}

template <int D>
struct Dkv {
  static constexpr int kC = Row<D>::kChunks;            // chunks of a row
  static constexpr int kDim = Row<D>::kDim;             // D rounded to 16
  static constexpr int kSplit = kDim > 128 ? 2 : 1;     // warps on 16 keys
  static constexpr int kBlockK = 16 * kWarps / kSplit;  // 64, 32 past 128
  static constexpr int kCols = kDim / kSplit;           // dK, dV cols a warp
  static constexpr int kBlockQ = kCols > 64 ? 32 : 64;  // query rows a stage
  static constexpr int kKvBytes = kBlockK * Row<D>::kBytes;  // K or V
  static constexpr int kQBytes = kBlockQ * Row<D>::kBytes;   // Q or dO
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kBlockQ * 4;
  static constexpr int kSmemBytes = 2 * kKvBytes + 2 * kStageBytes;
  static_assert(kCols % 8 == 0, "whole n-tiles a warp");
  static_assert(2 * kBlockQ <= kThreads, "one lse or delta value a thread");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ dkp, float* __restrict__ dvp, Strides sq,
            Strides sk, Strides sv, Strides sd, Strides sdk, Strides sdv,
            int heads, int batch, int group, int len_q, int len_k,
            float scale, float scale_log2, int causal, int window,
            int q_off) {
  using Cf = Dkv<D>;
  constexpr int C = Cf::kC;
  constexpr int BK = Cf::kBlockK;
  constexpr int BQ = Cf::kBlockQ;
  constexpr int NQ = BQ / 8;            // query n-tiles of S^T
  constexpr int KD = Cf::kDim / 16;     // k-steps of K Q^T
  constexpr int CT = Cf::kCols / 8;     // column n-tiles of dK, dV (9, odd,
                                        // at D = 136: the last one by x2)
  extern __shared__ uint4 smem_dkv_tc[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem_dkv_tc);
  const char* sgen = reinterpret_cast<const char*>(smem_dkv_tc);
  const uint32_t ks = sbase, vs = sbase + Cf::kKvBytes;
  const int ring = 2 * Cf::kKvBytes;    // byte offset of stage 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;     // fragment row, column pair
  const int hb = heads * batch;
  // key tile 0 first: under a causal mask it sees the most query tiles
  const int kt = (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % heads;
  const int b = (int)(blockIdx.x % hb) / heads;
  const int kvh = h / group;
  const int k0 = kt * BK;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* gb = dout + b * sd.b + h * sd.h;
  const long long bh = (long long)b * heads + h;
  const long long stat = bh * len_q;

  // query rows that may see some key of this block: [q_lo, q_hi)
  const int k_last = min(k0 + BK, len_k) - 1;
  const int q_lo = causal ? max(0, k0 - q_off) : 0;
  const int q_hi = window > 0 ? min(len_q, k_last + window - q_off) : len_q;
  const int t_first = q_lo / BQ;
  const int t_end = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : t_first;

  // Q, dO, lse, delta of query tile t into its stage of the ring
  auto load_stage = [&](int t) {
    const uint32_t st = sbase + ring + ((t - t_first) & 1) * Cf::kStageBytes;
    const int q0 = t * BQ;
    load_tile<D, BQ>(st, qb, sq.s, q0, len_q, tid);
    load_tile<D, BQ>(st + Cf::kQBytes, gb, sd.s, q0, len_q, tid);
    if (tid < 2 * BQ) {                 // lse, then delta
      const int r = tid % BQ;
      const bool in = q0 + r < len_q;
      const float* src = (tid < BQ ? lse : delta) + stat + (in ? q0 + r : 0);
      cp_async4(st + 2 * Cf::kQBytes + tid * 4, src, in);
    }
  };

  load_tile<D, BK>(ks, k + b * sk.b + kvh * sk.h, sk.s, k0, len_k, tid);
  load_tile<D, BK>(vs, v + b * sv.b + kvh * sv.h, sv.s, k0, len_k, tid);
  if (t_first < t_end) load_stage(t_first);
  cp_async_commit();

  float acc_k[CT][4], acc_v[CT][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[ct][e] = acc_v[ct][e] = 0.f;

  const int rw = warp / Cf::kSplit, cw = warp % Cf::kSplit;
  const int key0 = k0 + rw * 16 + g;          // keys of c0,c1; +8 for c2,c3
  // ldmatrix lane addressing: A (K, V rows of this warp), B (Q, dO rows as
  // the n axis), transposed B (dO, Q rows as the k axis)
  const int a_row = rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = (lane >> 3) & 1;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = lane >> 4;

  for (int t = t_first; t < t_end; ++t) {
    const int off = ring + ((t - t_first) & 1) * Cf::kStageBytes;
    const uint32_t qs = sbase + off, gs = qs + Cf::kQBytes;
    const float* lse_s =
        reinterpret_cast<const float*>(sgen + off + 2 * Cf::kQBytes);
    const float* dl_s = lse_s + BQ;
    if (t + 1 < t_end) load_stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile t (and K, V) have landed
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ks + swz<C>(a_row, kk * 2 + a_col), ak);
      ldsm_x4(vs + swz<C>(a_row, kk * 2 + a_col), av);
#pragma unroll
      for (int nn = 0; nn < NQ / 2; ++nn) {
        uint32_t bq[4], bg[4];
        ldsm_x4(qs + swz<C>(nn * 16 + b_row, kk * 2 + b_col), bq);
        ldsm_x4(gs + swz<C>(nn * 16 + b_row, kk * 2 + b_col), bg);
        mma(s[2 * nn], ak, bq[0], bq[1]);
        mma(s[2 * nn + 1], ak, bq[2], bq[3]);
        mma(dp[2 * nn], av, bg[0], bg[1]);
        mma(dp[2 * nn + 1], av, bg[2], bg[3]);
      }
    }

    // P^T and dS^T on the fragments (row = key, column = query); the mask
    // only on tiles that straddle an edge
    const int q0 = t * BQ;
    const bool edge =
        straddles(q0, BQ, k0, BK, len_q, len_k, causal, window, q_off);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lse_s + nt * 8 + 2 * tq);
      const float2 d2 =
          *reinterpret_cast<const float2*>(dl_s + nt * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float li = (e & 1) ? l2.y : l2.x;
        const float di = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(s[nt][e], scale_log2, -(li * kLog2e)));
        if (edge && !bwd::allowed(q0 + nt * 8 + 2 * tq + (e & 1),
                                  key0 + (e >> 1) * 8, len_q, len_k, causal,
                                  window, q_off))
          p = 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - di);
      }
    }

    // dV += P^T dO, dK += dS^T Q: the C fragments are the A fragments
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t ad[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2],
                                        dp[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < CT / 2; ++dn) {
        const int chunk = cw * CT + dn * 2 + t_col;
        uint32_t bg[4], bq[4];
        ldsm_x4_trans(gs + swz<C>(kk * 16 + t_row, chunk), bg);
        ldsm_x4_trans(qs + swz<C>(kk * 16 + t_row, chunk), bq);
        mma(acc_v[2 * dn], ap, bg[0], bg[1]);
        mma(acc_v[2 * dn + 1], ap, bg[2], bg[3]);
        mma(acc_k[2 * dn], ad, bq[0], bq[1]);
        mma(acc_k[2 * dn + 1], ad, bq[2], bq[3]);
      }
      if constexpr (CT % 2 != 0) {
        const int chunk = cw * CT + CT - 1;
        uint32_t bg[2], bq[2];
        ldsm_x2_trans(gs + swz<C>(kk * 16 + t_row, chunk), bg);
        ldsm_x2_trans(qs + swz<C>(kk * 16 + t_row, chunk), bq);
        mma(acc_v[CT - 1], ap, bg[0], bg[1]);
        mma(acc_k[CT - 1], ad, bq[0], bq[1]);
      }
    }
    __syncthreads();                  // stage read; the next prefetch reuses it
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = key0 + half * 8;
    if (kj >= len_k) continue;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int col = cw * Cf::kCols + ct * 8 + 2 * tq;
      if (D != Cf::kDim && col >= D) continue;   // a padded column
      const float k0v = acc_k[ct][2 * half], k1v = acc_k[ct][2 * half + 1];
      const float v0v = acc_v[ct][2 * half], v1v = acc_v[ct][2 * half + 1];
      if (dkp != nullptr) {           // this head's partials, unscaled
        const long long at = (bh * len_k + kj) * D + col;
        *reinterpret_cast<float2*>(dkp + at) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(dvp + at) = make_float2(v0v, v1v);
      } else {
        *reinterpret_cast<uint32_t*>(dk + b * sdk.b + kvh * sdk.h +
                                     kj * sdk.s + col) =
            pack_bf16(k0v * scale, k1v * scale);
        *reinterpret_cast<uint32_t*>(dv + b * sdv.b + kvh * sdv.h +
                                     kj * sdv.s + col) = pack_bf16(v0v, v1v);
      }
    }
  }
}

// dK, dV of KV head kvh = scale * (sum over the group's heads, in order, of
// the partials), one thread per 4 columns of a key row
template <int D>
__global__ void __launch_bounds__(256)
bwd_fold(const float* __restrict__ dkp, const float* __restrict__ dvp,
         bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
         Strides sdv, int kv_heads, int group, int len_k, float scale,
         long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  constexpr int kQuads = D / 4;
  const int c = (int)(i % kQuads) * 4;
  const long long row = i / kQuads;           // (b, kvh, j)
  const int j = (int)(row % len_k);
  const long long bk = row / len_k;
  const int kvh = (int)(bk % kv_heads), b = (int)(bk / kv_heads);
  const long long head = (long long)len_k * D;
  const long long base = bk * group * head + (long long)j * D + c;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int hh = 0; hh < group; ++hh) {
    const float4 a = *reinterpret_cast<const float4*>(dkp + base + hh * head);
    const float4 e = *reinterpret_cast<const float4*>(dvp + base + hh * head);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
  }
  *reinterpret_cast<uint2*>(dk + b * sdk.b + kvh * sdk.h + j * sdk.s + c) =
      make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                 pack_bf16(sk.z * scale, sk.w * scale));
  *reinterpret_cast<uint2*>(dv + b * sdv.b + kvh * sdv.h + j * sdv.s + c) =
      make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
}

template <int D>
struct Dq {
  static constexpr int kC = Row<D>::kChunks;
  static constexpr int kDim = Row<D>::kDim;
  static constexpr int kBlockQ = kWarps * 16;           // 64, 16 a warp
  static constexpr int kBlockK = kDim > 128 ? 32 : 64;
  static constexpr int kQBytes = kBlockQ * Row<D>::kBytes;   // Q or dO
  static constexpr int kKvBytes = kBlockK * Row<D>::kBytes;  // K or V
  static constexpr int kSmemBytes = 2 * kQBytes + 2 * 2 * kKvBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
           Strides sd, Strides sdq, int heads, int batch, int group,
           int len_q, int len_k, float scale, float scale_log2, int causal,
           int window, int q_off, int n_qtiles) {
  using Cf = Dq<D>;
  constexpr int C = Cf::kC;
  constexpr int BQ = Cf::kBlockQ;
  constexpr int BK = Cf::kBlockK;
  constexpr int NT = BK / 8;            // key n-tiles of S
  constexpr int KD = Cf::kDim / 16;     // k-steps of Q K^T
  constexpr int DT = Cf::kDim / 8;      // d n-tiles of dQ
  extern __shared__ uint4 smem_dq_tc[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem_dq_tc);
  const uint32_t qs = sbase, gs = sbase + Cf::kQBytes;
  const uint32_t ring = sbase + 2 * Cf::kQBytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int hb = heads * batch;
  // heavy first: the first blocks take the last (causally largest) q tile
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % heads;
  const int b = (int)(blockIdx.x % hb) / heads;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const long long stat = ((long long)b * heads + h) * len_q;

  // keys that some row of this block may see: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, len_q) - 1;
  const int k_hi = causal ? min(len_k, q_off + q_last + 1) : len_k;
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int t_first = k_lo / BK;
  const int t_end = (k_hi + BK - 1) / BK;

  load_tile<D, BQ>(qs, q + b * sq.b + h * sq.h, sq.s, q0, len_q, tid);
  load_tile<D, BQ>(gs, dout + b * sd.b + h * sd.h, sd.s, q0, len_q, tid);
  if (t_first < t_end) {
    load_tile<D, BK>(ring, kb, sk.s, t_first * BK, len_k, tid);
    load_tile<D, BK>(ring + Cf::kKvBytes, vb, sv.s, t_first * BK, len_k,
                     tid);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;        // rows of c0,c1; +8 for c2,c3
  float lse2[2], dl[2];                       // lse in log2 units, delta
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + half * 8;
    lse2[half] = qi < len_q ? lse[stat + qi] * kLog2e : INFINITY;
    dl[half] = qi < len_q ? delta[stat + qi] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = (lane >> 3) & 1;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = lane >> 4;

  for (int t = t_first; t < t_end; ++t) {
    const uint32_t ks = ring + ((t - t_first) & 1) * 2 * Cf::kKvBytes;
    const uint32_t vs = ks + Cf::kKvBytes;
    if (t + 1 < t_end) {            // the next tile, into the other stage
      const uint32_t nk = ring + ((t + 1 - t_first) & 1) * 2 * Cf::kKvBytes;
      load_tile<D, BK>(nk, kb, sk.s, (t + 1) * BK, len_k, tid);
      load_tile<D, BK>(nk + Cf::kKvBytes, vb, sv.s, (t + 1) * BK, len_k,
                       tid);
    }
    cp_async_commit();
    cp_async_wait<1>();             // tile t (and Q, dO) have landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ag[4];
      ldsm_x4(qs + swz<C>(a_row, kk * 2 + a_col), aq);
      ldsm_x4(gs + swz<C>(a_row, kk * 2 + a_col), ag);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4], bv[4];
        ldsm_x4(ks + swz<C>(nn * 16 + b_row, kk * 2 + b_col), bk);
        ldsm_x4(vs + swz<C>(nn * 16 + b_row, kk * 2 + b_col), bv);
        mma(s[2 * nn], aq, bk[0], bk[1]);
        mma(s[2 * nn + 1], aq, bk[2], bk[3]);
        mma(dp[2 * nn], ag, bv[0], bv[1]);
        mma(dp[2 * nn + 1], ag, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta), P = exp2(S scale log2 e - lse log2 e); the mask
    // only on tiles that straddle an edge
    const int k0 = t * BK;
    const bool edge =
        straddles(q0, BQ, k0, BK, len_q, len_k, causal, window, q_off);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float p = exp2f(fmaf(s[nt][e], scale_log2, -lse2[half]));
        if (edge && !bwd::allowed(row0 + half * 8, k0 + nt * 8 + 2 * tq +
                                  (e & 1), len_q, len_k, causal, window,
                                  q_off))
          p = 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[half]);
      }

    // dQ += dS K: dS's C fragments are the A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t bk[4];
        ldsm_x4_trans(ks + swz<C>(kk * 16 + t_row, dn * 2 + t_col), bk);
        mma(acc[2 * dn], a, bk[0], bk[1]);
        mma(acc[2 * dn + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();                // stage read; the next prefetch reuses it
  }

  bf16* db = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + half * 8;
    if (qi >= len_q) continue;
    bf16* drow = db + (long long)qi * sdq.s + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)     // the padded columns stay unwritten
      *reinterpret_cast<uint32_t*>(drow + dt * 8) =
          pack_bf16(acc[dt][2 * half] * scale, acc[dt][2 * half + 1] * scale);
  }
}

template <int D>
int launch(const bwd::BwdArgs& a, cudaStream_t stream) {
  using Kv = Dkv<D>;
  using Qc = Dq<D>;
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkv_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Kv::kSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(bwd_dq_mma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Qc::kSmemBytes);
  }();
  if (configured != cudaSuccess) return (int)configured;
  const bool fold = a.group > 1;
  if (fold && a.work == nullptr) return (int)cudaErrorInvalidValue;
  const long long hb = (long long)a.heads * a.batch;
  const long long rows = hb * a.len_q;
  constexpr int kDeltaLanes = delta_lanes<D>();
  const long long delta_rows = kWarps * (32 / kDeltaLanes);  // a block's
  const long long delta_blocks = (rows + delta_rows - 1) / delta_rows;
  const long long kv_blocks = (a.len_k + Kv::kBlockK - 1) / Kv::kBlockK * hb;
  const int n_qtiles = (a.len_q + Qc::kBlockQ - 1) / Qc::kBlockQ;
  const long long q_blocks = (long long)n_qtiles * hb;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL ||
      delta_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long part = hb * a.len_k * D;    // one partial, in floats
  const float scale_log2 = a.scale * kLog2e;
  bwd_delta_packed<D><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(
      (const bf16*)a.o, (const bf16*)a.dout, a.delta, a.so, a.sd, a.heads,
      a.len_q, rows);
  bwd_dkv_mma<D><<<(unsigned)kv_blocks, kThreads, Kv::kSmemBytes, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, a.lse, a.delta, (bf16*)a.dk, (bf16*)a.dv,
      fold ? a.work : nullptr, fold ? a.work + part : nullptr, a.sq, a.sk,
      a.sv, a.sd, a.sdk, a.sdv, a.heads, a.batch, a.group, a.len_q, a.len_k,
      a.scale, scale_log2, a.causal, a.window, a.q_off);
  bwd_dq_mma<D><<<(unsigned)q_blocks, kThreads, Qc::kSmemBytes, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, a.lse, a.delta, (bf16*)a.dq, a.sq, a.sk, a.sv,
      a.sd, a.sdq, a.heads, a.batch, a.group, a.len_q, a.len_k, a.scale,
      scale_log2, a.causal, a.window, a.q_off, n_qtiles);
  if (fold) {
    const long long n4 = (long long)a.batch * a.kv_heads * a.len_k * D / 4;
    const long long blocks = (n4 + 255) / 256;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    bwd_fold<D><<<(unsigned)blocks, 256, 0, stream>>>(
        a.work, a.work + part, (bf16*)a.dk, (bf16*)a.dv, a.sdk, a.sdv,
        a.kv_heads, a.group, a.len_k, a.scale, n4);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc_bwd

// f(std::integral_constant<int, D>) for the head dim D: one instance of
// either kernel per head dim
template <class F>
int by_head_dim(int head_dim, F f) {
  switch (head_dim) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 136: return f(std::integral_constant<int, 136>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// dynamic shared memory and blocks an SM of one kernel, by the CUDA
// runtime's occupancy calculator (no launch)
template <class K>
int occupancy_of(K kernel, int threads, int smem, int* smem_bytes,
                 int* blocks_per_sm) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *smem_bytes = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, smem);
}

}  // namespace

extern "C" {

// q, o: (batch, heads, len_q, head_dim); k, v: (batch, kv_heads, len_k,
// head_dim), each given by its batch, head and sequence strides (elements).
// lse: null, or (batch, heads, len_q) float32, contiguous: each row's
// log-sum-exp of its scaled scores over the allowed keys (natural log),
// +inf for a row with no allowed key, so that exp(s - lse) is 0 there.
// head_dim is one of 16, 32, 64, 96, 112, 128, 136, 256 (136 runs the
// bfloat16 kernel's 144-wide tile, zero-padded, scaled by the given
// scale); heads % kv_heads == 0; len_q
// and len_k at least 1 and below 2^31; window <= 0 means no window, and
// a window is below 2^31.  bf16 != 0: bfloat16 tensors, every row 16-byte
// aligned (the tensor-core kernel); else float32 (the CUDA-core kernel).
// q_offset >= 0: query row i sits at position q_offset + i, with
// q_offset + len_q below 2^31.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, long long q_sb, long long q_sh,
                        long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        int batch, int heads, int kv_heads, long long len_q,
                        long long len_k, int head_dim, double scale,
                        int causal, long long window, long long q_offset,
                        int bf16, void* stream) {
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  const int group = heads / kv_heads;
  const int win = window > 0 ? (int)window : 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int lq = (int)len_q, lk = (int)len_k, qo = (int)q_offset;
  if (bf16) {  // the scale folded with log2 e into the exp2 argument
    const float scale_log2 = (float)(scale * 1.4426950408889634);
    return by_head_dim(head_dim, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, o, (float*)lse, sq, sk,
                                            sv, so, batch, heads, group, lq,
                                            lk, scale_log2, causal, win, qo,
                                            s);
    });
  }
  return by_head_dim(head_dim, [&](auto d) {
    return f32::launch<decltype(d)::value>(q, k, v, o, (float*)lse, sq, sk,
                                           sv, so, batch, heads, group, lq,
                                           lk, (float)scale, causal, win, qo,
                                           s);
  });
}

// The gradient of flash_attention_fwd: dq, dk, dv (each of its input's
// shape, type and given strides) from q, k, v, the forward's output o, its
// lse (batch, heads, len_q) and the output's gradient dout.  delta is a
// float32 workspace of batch * heads * len_q values; work is a float32
// workspace of 2 * batch * heads * len_k * head_dim values (each query
// head's partial dK and dV) when bf16 and heads > kv_heads, and may be
// null otherwise.  Types, head dims and sizes as for the forward; for
// bf16 every row of q, k, v and dout is 16-byte aligned, and every row of
// dq, dk, dv 8-byte aligned.
// Dynamic shared memory and blocks an SM of the bfloat16 tensor-core
// instance for head_dim: pass 0 the forward (without the lse store), 1 the
// backward's dK/dV pass, 2 its dQ pass.  Launches nothing.
int flash_attention_occupancy(int head_dim, int pass, int* smem_bytes,
                              int* blocks_per_sm) {
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    switch (pass) {
      case 0:
        return occupancy_of(tc::flash_fwd_bf16_mma<D, false>, tc::kThreads,
                            tc::Cfg<D>::kSmemBytes, smem_bytes,
                            blocks_per_sm);
      case 1:
        return occupancy_of(tc_bwd::bwd_dkv_mma<D>, tc_bwd::kThreads,
                            tc_bwd::Dkv<D>::kSmemBytes, smem_bytes,
                            blocks_per_sm);
      case 2:
        return occupancy_of(tc_bwd::bwd_dq_mma<D>, tc_bwd::kThreads,
                            tc_bwd::Dq<D>::kSmemBytes, smem_bytes,
                            blocks_per_sm);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}

int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* work, void* dq, void* dk, void* dv,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        long long d_sb, long long d_sh, long long d_ss,
                        long long dq_sb, long long dq_sh, long long dq_ss,
                        long long dk_sb, long long dk_sh, long long dk_ss,
                        long long dv_sb, long long dv_sh, long long dv_ss,
                        int batch, int heads, int kv_heads, long long len_q,
                        long long len_k, int head_dim, double scale,
                        int causal, long long window, long long q_offset,
                        int bf16, void* stream) {
  bwd::BwdArgs a{q, k, v, o, dout, (const float*)lse, (float*)delta,
                 (float*)work, dq, dk, dv,
                 Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
                 Strides{v_sb, v_sh, v_ss}, Strides{o_sb, o_sh, o_ss},
                 Strides{d_sb, d_sh, d_ss}, Strides{dq_sb, dq_sh, dq_ss},
                 Strides{dk_sb, dk_sh, dk_ss}, Strides{dv_sb, dv_sh, dv_ss},
                 batch, heads, heads / kv_heads, kv_heads, (int)len_q,
                 (int)len_k, (float)scale, causal,
                 window > 0 ? (int)window : 0, (int)q_offset};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return by_head_dim(head_dim, [&](auto d) {
      return tc_bwd::launch<decltype(d)::value>(a, s);
    });
  return by_head_dim(head_dim, [&](auto d) {
    return bwd::launch<decltype(d)::value>(a, s);
  });
}

}  // extern "C"
