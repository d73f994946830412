// Causal / sliding-window GQA softmax attention, forward and backward (CUDA
// C++, sm_90a).  The forward's kernels are described here; the backward's,
// for the training path, in their own sections below, and the float32
// kernels of both directions in the last section.
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
// float32: CUDA cores (flash_fwd_f32_tiled, in the float32 section at the
// end, beside its backward).  Tensor cores would mean TF32, ten bits of
// mantissa, which breaks the float32 tolerance of 2e-5; so the products
// are register-tiled outer products of fmaf on the CUDA cores, whose
// float32 rate bounds the kernel.
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
// backward: what both types share
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
// every run (a resumed training run repeats the uninterrupted one).  Both
// types run the same four passes: delta, a dK/dV pass per (key tile, query
// head, batch) that writes each head's float32 partials into a workspace
// when a KV group has more than one head, a fold of those partials in
// head order, and a dQ pass in the forward's layout.

namespace bwd {

// query row qi (at position q_off + qi) and key kj
__device__ __forceinline__ bool allowed(int qi, int kj, int len_q, int len_k,
                                        int causal, int window, int q_off) {
  bool ok = qi < len_q && kj < len_k;
  const int pos = q_off + qi;
  if (causal) ok = ok && pos >= kj;
  if (window > 0) ok = ok && pos - kj < window;
  return ok;
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
//     rounded once to bf16 (its float32 instance, for the float32
//     backward, stores float32).
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

// lanes of a delta pass a row of C 16-byte packs: C rounded up to a power
// of two, so that a warp's rows are aligned groups of lanes, and at most a
// warp (bfloat16: 16 for D = 96 and 112, 32 for D = 136; float32: 32 from
// D = 128 on, a lane then summing more than one pack)
template <int C>
__host__ __device__ constexpr int pack_lanes() {
  int l = 1;
  while (l < C && l < 32) l *= 2;
  return l;
}

// delta[row] = O_row . dO_row for bfloat16 rows that are 16-byte aligned:
// pack_lanes<D / 8>() lanes a row, the first D / 8 each reading 8 values of
// O and of dO as one pack, the lanes' sums folded by shuffles
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_packed(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, Strides so, Strides sd,
                 int heads, int len_q, long long rows) {
  static_assert(D % 8 == 0 && D <= 256, "whole packs, a row in a warp");
  constexpr int L = pack_lanes<D / 8>();   // lanes a row
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
// the partials), one thread per 4 columns of a key row, stored as T: bf16
// (8-byte stores, rows 8-byte aligned), or float32 (one 16-byte store where
// vec, else four 4-byte ones)
template <int D, class T>
__global__ void __launch_bounds__(256)
bwd_fold(const float* __restrict__ dkp, const float* __restrict__ dvp,
         T* __restrict__ dk, T* __restrict__ dv, Strides sdk,
         Strides sdv, int kv_heads, int group, int len_k, float scale,
         long long n4, int vec) {
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
  T* dkr = dk + b * sdk.b + kvh * sdk.h + j * sdk.s + c;
  T* dvr = dv + b * sdv.b + kvh * sdv.h + j * sdv.s + c;
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<uint2*>(dkr) =
        make_uint2(pack_bf16(sk.x * scale, sk.y * scale),
                   pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dvr) =
        make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  } else {
    const float4 ok = make_float4(sk.x * scale, sk.y * scale, sk.z * scale,
                                  sk.w * scale);
    if (vec) {
      *reinterpret_cast<float4*>(dkr) = ok;
      *reinterpret_cast<float4*>(dvr) = sv;
    } else {
      dkr[0] = ok.x; dkr[1] = ok.y; dkr[2] = ok.z; dkr[3] = ok.w;
      dvr[0] = sv.x; dvr[1] = sv.y; dvr[2] = sv.z; dvr[3] = sv.w;
    }
  }
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
  constexpr int kDeltaLanes = pack_lanes<D / 8>();
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
    bwd_fold<D, bf16><<<(unsigned)blocks, 256, 0, stream>>>(
        a.work, a.work + part, (bf16*)a.dk, (bf16*)a.dv, a.sdk, a.sdv,
        a.kv_heads, a.group, a.len_k, a.scale, n4, 1);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc_bwd

// ---------------------------------------------------------------------------
// float32: CUDA cores, register-tiled outer products (forward and backward)
// ---------------------------------------------------------------------------
//
// Everything float32 inside: tensor cores would mean TF32 and break the
// forward's 2e-5 and the backward's 1e-4 tolerances, so every product is
// an fmaf on the CUDA cores (the library is built with -fmad=false; these
// are its only contractions besides the exponent's), whose float32 rate
// bounds the kernels.  The design keeps that pipe busy:
//   - a block is 128 threads: 16 row groups x 8 column groups, lane =
//     column group + 8 x (row group mod 4), so the 8 threads that share a
//     tile's rows are 8 lanes of one warp, and a warp owns its rows alone;
//   - every product is a register-tiled outer product: a thread owns rows
//     rg + 16 i (i < TR) of a tile and columns cg + 8 j (j < TC) of S (or
//     S^T in the dK/dV pass), and per 4 values of the inner dimension reads
//     TR + TC float4s from shared memory for 4 TR TC fmaf (8 to 10.7 fmaf a
//     16-byte read, where one lane a key would do about 4); the TR row
//     reads are one address for the 8 lanes that share them;
//   - tiles sit in shared memory with rows of D + 4 floats: the chunk pitch
//     D / 4 + 1 is odd for every head dim, so the 16-byte reads of 8
//     consecutive rows at one column fall in 8 distinct bank groups;
//   - P (or dS) goes through shared memory once a tile, transposed, in a
//     buffer each warp owns (__syncwarp, no block barrier), and the second
//     product reads it back as one float4 (float2) a key for the thread's
//     rows: O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K take a thread's
//     TR rows x its 16-byte column chunks cg + 8 u of the result, one float4
//     of the right operand a key and chunk, and never a shuffle;
//   - the streamed tiles go through a two-stage cp.async ring (16-byte
//     copies where every row of every tensor is 16-byte aligned, else 4-byte
//     copies of the same layout, picked at launch: the same kernel takes a
//     view of any row alignment), ragged rows zero-filled;
//   - the exponent is exp2f(fmaf(s, scale log2 e, -m scale log2 e)) as in
//     the bfloat16 kernels; tiles that no row may see are skipped and only
//     tiles that straddle an edge run the per-element mask.
// Tiles (Fwd, Dkv, Dq below) are picked so that two blocks fit an SM's
// shared memory at the path's head dim 64 (and up to 128), since the
// training shapes' grids (192 blocks at q (4, 12, 256, 64) and at granite's
// (2, 12, 512, 64)) are about one wave of 132 SMs.
// Forward (flash_fwd_f32_tiled): a block per (64 query rows — 32 for
// D > 128 — head, batch), heavy query tiles first; Q staged once; K, V
// tiles of 64 keys (32 for D > 64) through the ring; online softmax on the
// thread's tile, the row max across the 8 lanes of a row by three
// __shfl_xor_sync, the row sum kept per thread and summed once at the end.
// Backward: `delta` (bwd_delta_f32: 16-byte packs, D / 4 lanes a row up to
// a warp), then one launch (bwd_dkv_dq_f32) for two independent passes
// whose blocks are interleaved, each pass's heaviest items first, so that
// the light items of one fill the SMs the heavy items of the other leave
// idle (the key tile 0 item walks every query tile under a causal mask):
//   - `dkv` items (dkv_item: 64 keys — 32 for D > 64 — query head,
//     batch): K and V staged once, Q, dO, lse, delta tiles of 32 query
//     rows through the ring; S^T = K Q^T and dP^T = V dO^T, then dV +=
//     P^T dO and dK += dS^T Q; with one head a group the block writes dK
//     (scaled) and dV, else its head's partials into the (2, B, H, Sk, D)
//     workspace, which bwd_fold<D, float> sums in head order;
//   - `dq` items (dq_item: the forward's layout with 64 query rows — 32
//     for D > 64): Q and dO staged once, K, V tiles of 32 keys through the
//     ring, S and dP recomputed, dQ += dS K.

namespace f32 {

using bwd::allowed;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc_bwd::kLog2e;
using tc_bwd::straddles;

constexpr int kThreads = 128;
constexpr int kRowGroups = 16;     // threads along a tile's rows
constexpr int kColGroups = 8;      // along its columns: lane & 7
// blocks an SM the tiled kernels are built for: shared memory holds two at
// D <= 128 anyway, so each thread may take up to 255 registers
constexpr int kMinBlocks = 2;

// floats a tile row of head dim D takes in shared memory
template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }

// 16-byte chunks of a D-wide result row a thread owns: cg + 8 u, u < this
template <int D>
__host__ __device__ constexpr int chunks() {
  return (D / 4 + kColGroups - 1) / kColGroups;
}

// whether column group cg owns chunk cg + 8 u (not all do at D = 16, 112,
// 136: 4, 28, 34 chunks a row)
template <int D>
__device__ __forceinline__ bool owns(int cg, int u) {
  return (D / 4) % kColGroups == 0 || cg + kColGroups * u < D / 4;
}

// whether every row of a float32 (nb, nh, ns, D) tensor with these strides
// is 16-byte aligned
inline bool rows16(const void* p, Strides s, int nb, int nh, int ns) {
  return ((uintptr_t)p & 15) == 0 && (nb == 1 || s.b % 4 == 0) &&
         (nh == 1 || s.h % 4 == 0) && (ns == 1 || s.s % 4 == 0);
}

// rows [row0, row0 + ROWS) of a (len, D) float32 matrix with row stride
// `stride` into a tile of pitch D + 4 at shared address dst; rows at or past
// len are zero-filled.  vec: 16-byte copies, else four 4-byte ones a chunk.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* base,
                                          long long stride, int row0,
                                          int len, int tid, bool vec) {
  constexpr int C = D / 4, N = ROWS * C;
#pragma unroll 4
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + tid;
    if (N % kThreads == 0 || i < N) {
      const int r = i / C, c = i - r * C;
      const bool in = row0 + r < len;
      const float* src =
          base + (in ? (long long)(row0 + r) * stride + 4 * c : 0);
      const uint32_t at = dst + (uint32_t)((r * pitch<D>() + 4 * c) * 4);
      if (vec) {
        tc::cp_async16(at, src, in);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tc_bwd::cp_async4(at + 4 * e, src + (in ? e : 0), in);
      }
    }
  }
}

// acc[i][j] += A[rg + 16 i] . B[cg + 8 j] over D, with a = A + rg pitch and
// b = B + cg pitch (tiles of pitch D + 4); the inner sum runs in column
// order
template <int D, int TR, int TC>
__device__ __forceinline__ void dots(float (&acc)[TR][TC], const float* a,
                                     const float* b) {
  constexpr int P = pitch<D>();
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 av[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * kRowGroups * P + c);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + j * kColGroups * P + c);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// v[TR] <-> TR consecutive floats of a transposed P buffer (a float4 or a
// float2, aligned by the buffer's layout)
template <int TR>
__device__ __forceinline__ void read_col(float (&v)[TR], const float* p) {
  static_assert(TR == 2 || TR == 4, "two or four rows a thread");
  if constexpr (TR == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}
template <int TR>
__device__ __forceinline__ void write_col(float* p, const float (&v)[TR]) {
  if constexpr (TR == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// the thread's tile t[i][j] into the transposed buffer: row cg + 8 j
// (pitch PP) holds column j's values at rg TR + i
template <int TR, int TC, int PP>
__device__ __forceinline__ void stash(float* buf, const float (&t)[TR][TC],
                                      int rg, int cg) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    float v[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) v[i] = t[i][j];
    write_col<TR>(buf + (cg + kColGroups * j) * PP + rg * TR, v);
  }
}

// acc[i][u] += sum_j T[j][rg TR + i] M[j][4 (cg + 8 u) ...] over j < N, in
// order: T a transposed buffer of pitch PP (t = T + rg TR), M a tile of
// pitch D + 4
template <int D, int TR, int N, int PP>
__device__ __forceinline__ void accumulate(float4 (&acc)[TR][chunks<D>()],
                                           const float* t, const float* m,
                                           int cg) {
  constexpr int P = pitch<D>();
#pragma unroll 4
  for (int j = 0; j < N; ++j) {
    float pv[TR];
    read_col<TR>(pv, t + j * PP);
#pragma unroll
    for (int u = 0; u < chunks<D>(); ++u) {
      if (!owns<D>(cg, u)) continue;
      const float4 mv = *reinterpret_cast<const float4*>(
          m + j * P + 4 * (cg + kColGroups * u));
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        acc[i][u].x = fmaf(pv[i], mv.x, acc[i][u].x);
        acc[i][u].y = fmaf(pv[i], mv.y, acc[i][u].y);
        acc[i][u].z = fmaf(pv[i], mv.z, acc[i][u].z);
        acc[i][u].w = fmaf(pv[i], mv.w, acc[i][u].w);
      }
    }
  }
}

__device__ __forceinline__ void store4(float* dst, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// the sum (max) of v over the 8 lanes of a row: lanes that differ in their
// low three bits
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  v += __shfl_xor_sync(kFullMask, v, 2);
  return v + __shfl_xor_sync(kFullMask, v, 4);
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 4));
}

// ---------------------------------------------------------------- forward

template <int D>
struct Fwd {
  static constexpr int kTR = D > 128 ? 2 : 4;           // query rows a thread
  static constexpr int kTC = D > 64 ? 4 : 8;            // keys a thread
  static constexpr int kBlockQ = kRowGroups * kTR;      // 64, 32 past 128
  static constexpr int kBlockK = kColGroups * kTC;      // 64, 32 past 64
  static constexpr int kPP = kBlockQ + 4;               // P^T buffer pitch
  static constexpr int kQFloats = kBlockQ * pitch<D>();
  static constexpr int kKvFloats = kBlockK * pitch<D>();  // K or V
  static constexpr int kSmemBytes =
      4 * (kQFloats + 2 * 2 * kKvFloats + kBlockK * kPP);
};

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, Strides so, int heads, int batch, int group,
                    int len_q, int len_k, float scale_log2, int causal,
                    int window, int q_off, int n_qtiles, int vec) {
  using Cf = Fwd<D>;
  constexpr int TR = Cf::kTR, TC = Cf::kTC, NU = chunks<D>();
  constexpr int BQ = Cf::kBlockQ, BK = Cf::kBlockK, P = pitch<D>();
  extern __shared__ float4 smem_f32_fwd[];
  float* qs = reinterpret_cast<float*>(smem_f32_fwd);
  float* ring = qs + Cf::kQFloats;                  // 2 stages x (K, V)
  float* pt = ring + 2 * 2 * Cf::kKvFloats;         // P^T, BK x kPP
  const uint32_t qs_a = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t ring_a = (uint32_t)__cvta_generic_to_shared(ring);

  const int tid = threadIdx.x, lane = tid & 31;
  const int cg = lane & 7, rg = (tid >> 5) * 4 + (lane >> 3);
  const int hb = heads * batch;
  // heavy first: the first blocks take the last (causally largest) q tile
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % heads;
  const int b = (int)(blockIdx.x % hb) / heads;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  // keys that some row of this block may see: [k_lo, k_hi); row i sits at
  // position q_off + i
  const int q_last = min(q0 + BQ, len_q) - 1;
  const int k_hi = causal ? min(len_k, q_off + q_last + 1) : len_k;
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int t_first = k_lo / BK;
  const int t_end = (k_hi + BK - 1) / BK;

  load_rows<D, BQ>(qs_a, q + b * sq.b + h * sq.h, sq.s, q0, len_q, tid, vec);
  cp_async_commit();
  if (t_first < t_end) {
    load_rows<D, BK>(ring_a, kb, sk.s, t_first * BK, len_k, tid, vec);
    load_rows<D, BK>(ring_a + 4 * Cf::kKvFloats, vb, sv.s, t_first * BK,
                     len_k, tid, vec);
  }
  cp_async_commit();

  float4 acc[TR][NU];
  float m_r[TR], l_r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    const float* ks = ring + stage * 2 * Cf::kKvFloats;
    const float* vs = ks + Cf::kKvFloats;
    if (t + 1 < t_end) {            // the next tile, into the other stage
      const uint32_t nk = ring_a + (1 - stage) * 2 * Cf::kKvFloats * 4;
      load_rows<D, BK>(nk, kb, sk.s, (t + 1) * BK, len_k, tid, vec);
      load_rows<D, BK>(nk + 4 * Cf::kKvFloats, vb, sv.s, (t + 1) * BK,
                       len_k, tid, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();             // tile t (and Q) have landed
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    dots<D, TR, TC>(s, qs + rg * P, ks + cg * P);

    // the mask, only on tiles that straddle an edge
    const int k0 = t * BK;
    if (k0 + BK > len_k || (causal && k0 + BK - 1 > q_off + q0) ||
        (window > 0 && k0 < q_off + q0 + BQ - window)) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int qi = q_off + q0 + rg + kRowGroups * i;   // its position
          const int kj = k0 + cg + kColGroups * j;
          bool ok = kj < len_k;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && qi - kj < window;
          if (!ok) s[i][j] = kNegInf;
        }
    }

    // online softmax on the thread's rows: the max across the row's lanes,
    // the sum kept per thread (the same correction on every lane of a row)
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int j = 0; j < TC; ++j) mx = fmaxf(mx, s[i][j]);
      mx = row_max(mx);
      const float corr = exp2f((m_r[i] - mx) * scale_log2);
      m_r[i] = mx;
      const float msc = mx == kNegInf ? 0.f : mx * scale_log2;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = exp2f(fmaf(s[i][j], scale_log2, -msc));
        s[i][j] = p;
        psum += p;
      }
      l_r[i] = fmaf(l_r[i], corr, psum);
#pragma unroll
      for (int u = 0; u < NU; ++u) acc[i][u] = scaled(acc[i][u], corr);
    }

    // O += P V: P through the warp's own rows of the P^T buffer
    stash<TR, TC, Cf::kPP>(pt, s, rg, cg);
    __syncwarp();
    accumulate<D, TR, BK, Cf::kPP>(acc, pt + rg * TR, vs, cg);
    __syncthreads();                // stage and P^T read; both are reused
  }

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const float l = row_sum(l_r[i]);
    const int qi = q0 + rg + kRowGroups * i;
    if (qi >= len_q) continue;
    const bool empty = m_r[i] <= kNegInf * 0.5f;
    const float inv = empty ? 0.f : 1.f / fmaxf(l, 1e-30f);
    if constexpr (kLse) {            // natural log, scale applied
      if (cg == 0)
        lse[((long long)b * heads + h) * len_q + qi] =
            empty ? INFINITY
                  : (m_r[i] * scale_log2 + log2f(fmaxf(l, 1e-30f))) *
                        0.69314718055994531f;
    }
    float* orow = ob + (long long)qi * so.s;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (owns<D>(cg, u))
        store4(orow + 4 * (cg + kColGroups * u), scaled(acc[i][u], inv), vec);
  }
}

template <int D, bool kLse>
int launch_fwd_one(const void* q, const void* k, const void* v, void* o,
                   float* lse, Strides sq, Strides sk, Strides sv,
                   Strides so, int batch, int heads, int kv_heads, int group,
                   int len_q, int len_k, float scale_log2, int causal,
                   int window, int q_off, cudaStream_t stream) {
  constexpr int smem = Fwd<D>::kSmemBytes;
  // once per instantiation (and so never inside a CUDA-graph capture after
  // a first eager call): allow more than 48 KB of dynamic shared memory
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_f32_tiled<D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return (int)configured;
  const int n_qtiles = (len_q + Fwd<D>::kBlockQ - 1) / Fwd<D>::kBlockQ;
  const long long blocks = (long long)n_qtiles * heads * batch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = rows16(q, sq, batch, heads, len_q) &&
                   rows16(k, sk, batch, kv_heads, len_k) &&
                   rows16(v, sv, batch, kv_heads, len_k) &&
                   rows16(o, so, batch, heads, len_q);
  flash_fwd_f32_tiled<D, kLse><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, sq,
      sk, sv, so, heads, batch, group, len_q, len_k, scale_log2, causal,
      window, q_off, n_qtiles, (int)vec);
  return (int)cudaGetLastError();
}

// the lse store is a separate instance, so the kernel that generation runs
// does not carry it
template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, Strides sq, Strides sk, Strides sv, Strides so,
               int batch, int heads, int kv_heads, int len_q, int len_k,
               float scale_log2, int causal, int window, int q_off,
               cudaStream_t stream) {
  const int group = heads / kv_heads;
  return lse ? launch_fwd_one<D, true>(q, k, v, o, lse, sq, sk, sv, so,
                                       batch, heads, kv_heads, group, len_q,
                                       len_k, scale_log2, causal, window,
                                       q_off, stream)
             : launch_fwd_one<D, false>(q, k, v, o, lse, sq, sk, sv, so,
                                        batch, heads, kv_heads, group, len_q,
                                        len_k, scale_log2, causal, window,
                                        q_off, stream);
}

// --------------------------------------------------------------- backward

// delta[row] = O_row . dO_row for the rows (b, h, i) in that order: L lanes
// a row, each summing its packs of 4 floats (one 16-byte read where vec,
// else four 4-byte ones: the same sum in the same order), the lanes' sums
// folded by shuffles
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_f32(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ delta, Strides so, Strides sd, int heads,
              int len_q, long long rows, int vec) {
  constexpr int C = D / 4;              // packs a row
  constexpr int L = tc_bwd::pack_lanes<C>();   // lanes a row
  constexpr int R = 32 / L;             // rows a warp
  const int lane = threadIdx.x & 31;
  const long long row =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * R +
      lane / L;
  float acc = 0.f;
  if (row < rows) {
    const int i = (int)(row % len_q);
    const long long bh = row / len_q;
    const int h = (int)(bh % heads), b = (int)(bh / heads);
    const float* orow = o + b * so.b + h * so.h + i * so.s;
    const float* drow = dout + b * sd.b + h * sd.h + i * sd.s;
    for (int c = lane % L; c < C; c += L) {
      float4 x, y;
      if (vec) {
        x = *reinterpret_cast<const float4*>(orow + 4 * c);
        y = *reinterpret_cast<const float4*>(drow + 4 * c);
      } else {
        x = make_float4(orow[4 * c], orow[4 * c + 1], orow[4 * c + 2],
                        orow[4 * c + 3]);
        y = make_float4(drow[4 * c], drow[4 * c + 1], drow[4 * c + 2],
                        drow[4 * c + 3]);
      }
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (row < rows && lane % L == 0) delta[row] = acc;
}

// the float32 backward's arguments, as the kernel takes them
struct BwdF32 {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv, *dkp, *dvp;  // dkp, dvp: partials, or null
  Strides sq, sk, sv, sd, sdq, sdk, sdv;
  int heads, batch, group, len_q, len_k;
  float scale, scale_log2;
  int causal, window, q_off;
  int n_kv_items, n_q_items, n_qtiles, vec;
};

template <int D>
struct Dkv {
  static constexpr int kTR = D > 64 ? 2 : 4;            // keys a thread
  static constexpr int kTC = 4;                         // queries a thread
  static constexpr int kBlockK = kRowGroups * kTR;      // 64, 32 past 64
  static constexpr int kBlockQ = kColGroups * kTC;      // 32
  static constexpr int kPP = kBlockK + 4;               // P^T, dS^T pitch
  static constexpr int kKvFloats = kBlockK * pitch<D>();   // K or V
  static constexpr int kQFloats = kBlockQ * pitch<D>();    // Q or dO
  // a stage: Q, dO, then lse and delta of its rows (a multiple of 16 bytes)
  static constexpr int kStageFloats = 2 * kQFloats + 2 * kBlockQ;
  static constexpr int kSmemBytes =
      4 * (2 * kKvFloats + 2 * kStageFloats + 2 * kBlockQ * kPP);
};

// dK, dV of one (key tile, query head, batch) item, key tile 0 (under a
// causal mask the one that sees the most query tiles) first
template <int D>
__device__ __forceinline__ void dkv_item(const BwdF32& a, int item,
                                         float* smem) {
  using Cf = Dkv<D>;
  constexpr int TR = Cf::kTR, TC = Cf::kTC, NU = chunks<D>();
  constexpr int BK = Cf::kBlockK, BQ = Cf::kBlockQ, P = pitch<D>();
  float* ks = smem;
  float* vs = ks + Cf::kKvFloats;
  float* ring = vs + Cf::kKvFloats;                 // 2 stages
  float* pt = ring + 2 * Cf::kStageFloats;          // P^T, BQ x kPP
  float* dst = pt + BQ * Cf::kPP;                   // dS^T, BQ x kPP
  const uint32_t ks_a = (uint32_t)__cvta_generic_to_shared(ks);
  const uint32_t ring_a = (uint32_t)__cvta_generic_to_shared(ring);

  const int tid = threadIdx.x, lane = tid & 31;
  const int cg = lane & 7, rg = (tid >> 5) * 4 + (lane >> 3);
  const int hb = a.heads * a.batch;
  const int kt = item / hb;
  const int h = (item % hb) % a.heads;
  const int b = (item % hb) / a.heads;
  const int kvh = h / a.group;
  const int k0 = kt * BK;
  const int len_q = a.len_q, len_k = a.len_k;
  const bool vec = a.vec;
  const float* qb = a.q + b * a.sq.b + h * a.sq.h;
  const float* gb = a.dout + b * a.sd.b + h * a.sd.h;
  const long long bh = (long long)b * a.heads + h;
  const long long stat = bh * len_q;

  // query rows that may see some key of this block: [q_lo, q_hi)
  const int k_last = min(k0 + BK, len_k) - 1;
  const int q_lo = a.causal ? max(0, k0 - a.q_off) : 0;
  const int q_hi =
      a.window > 0 ? min(len_q, k_last + a.window - a.q_off) : len_q;
  const int t_first = q_lo / BQ;
  const int t_end = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : t_first;

  // Q, dO, lse, delta of query tile t into its stage of the ring
  auto load_stage = [&](int t) {
    const uint32_t st = ring_a + ((t - t_first) & 1) * Cf::kStageFloats * 4;
    const int q0 = t * BQ;
    load_rows<D, BQ>(st, qb, a.sq.s, q0, len_q, tid, vec);
    load_rows<D, BQ>(st + Cf::kQFloats * 4, gb, a.sd.s, q0, len_q, tid, vec);
    if (tid < 2 * BQ) {                 // lse, then delta
      const int r = tid % BQ;
      const bool in = q0 + r < len_q;
      const float* src =
          (tid < BQ ? a.lse : a.delta) + stat + (in ? q0 + r : 0);
      tc_bwd::cp_async4(st + (2 * Cf::kQFloats + tid) * 4, src, in);
    }
  };

  load_rows<D, BK>(ks_a, a.k + b * a.sk.b + kvh * a.sk.h, a.sk.s, k0, len_k,
                   tid, vec);
  load_rows<D, BK>(ks_a + Cf::kKvFloats * 4, a.v + b * a.sv.b + kvh * a.sv.h,
                   a.sv.s, k0, len_k, tid, vec);
  if (t_first < t_end) load_stage(t_first);
  cp_async_commit();

  float4 acc_k[TR][NU], acc_v[TR][NU];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u)
      acc_k[i][u] = acc_v[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = t_first; t < t_end; ++t) {
    const float* qs = ring + ((t - t_first) & 1) * Cf::kStageFloats;
    const float* gs = qs + Cf::kQFloats;
    const float* lse_s = gs + Cf::kQFloats;
    const float* dl_s = lse_s + BQ;
    if (t + 1 < t_end) load_stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();               // tile t (and K, V) have landed
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T on the thread's keys x queries
    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    dots<D, TR, TC>(s, ks + rg * P, qs + cg * P);
    dots<D, TR, TC>(dp, vs + rg * P, gs + cg * P);

    // P^T and dS^T; the mask only on tiles that straddle an edge
    const int q0 = t * BQ;
    const bool edge = straddles(q0, BQ, k0, BK, len_q, len_k, a.causal,
                                a.window, a.q_off);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int qj = cg + kColGroups * j;
      const float l2 = lse_s[qj] * kLog2e, dl = dl_s[qj];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float p = exp2f(fmaf(s[i][j], a.scale_log2, -l2));
        if (edge && !allowed(q0 + qj, k0 + rg + kRowGroups * i, len_q, len_k,
                             a.causal, a.window, a.q_off))
          p = 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl);
      }
    }

    // dV += P^T dO, dK += dS^T Q, through the warp's own buffer rows
    stash<TR, TC, Cf::kPP>(pt, s, rg, cg);
    stash<TR, TC, Cf::kPP>(dst, dp, rg, cg);
    __syncwarp();
    accumulate<D, TR, BQ, Cf::kPP>(acc_v, pt + rg * TR, gs, cg);
    accumulate<D, TR, BQ, Cf::kPP>(acc_k, dst + rg * TR, qs, cg);
    __syncthreads();                  // stage and buffers read; reused
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int kj = k0 + rg + kRowGroups * i;
    if (kj >= len_k) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (!owns<D>(cg, u)) continue;
      const int col = 4 * (cg + kColGroups * u);
      if (a.dkp != nullptr) {         // this head's partials, unscaled
        const long long at = (bh * len_k + kj) * D + col;
        *reinterpret_cast<float4*>(a.dkp + at) = acc_k[i][u];
        *reinterpret_cast<float4*>(a.dvp + at) = acc_v[i][u];
      } else {
        store4(a.dk + b * a.sdk.b + kvh * a.sdk.h + kj * a.sdk.s + col,
               scaled(acc_k[i][u], a.scale), vec);
        store4(a.dv + b * a.sdv.b + kvh * a.sdv.h + kj * a.sdv.s + col,
               acc_v[i][u], vec);
      }
    }
  }
}

template <int D>
struct Dq {
  static constexpr int kTR = D > 64 ? 2 : 4;            // query rows a thread
  static constexpr int kTC = 4;                         // keys a thread
  static constexpr int kBlockQ = kRowGroups * kTR;      // 64, 32 past 64
  static constexpr int kBlockK = kColGroups * kTC;      // 32
  static constexpr int kPP = kBlockQ + 4;               // dS^T pitch
  static constexpr int kQFloats = kBlockQ * pitch<D>();    // Q or dO
  static constexpr int kKvFloats = kBlockK * pitch<D>();   // K or V
  static constexpr int kSmemBytes =
      4 * (2 * kQFloats + 2 * 2 * kKvFloats + kBlockK * kPP);
};

// dQ of one (query tile, head, batch) item, the last (under a causal mask
// the heaviest) query tile first
template <int D>
__device__ __forceinline__ void dq_item(const BwdF32& a, int item,
                                        float* smem) {
  using Cf = Dq<D>;
  constexpr int TR = Cf::kTR, TC = Cf::kTC, NU = chunks<D>();
  constexpr int BQ = Cf::kBlockQ, BK = Cf::kBlockK, P = pitch<D>();
  float* qs = smem;
  float* gs = qs + Cf::kQFloats;
  float* ring = gs + Cf::kQFloats;                  // 2 stages x (K, V)
  float* dst = ring + 2 * 2 * Cf::kKvFloats;        // dS^T, BK x kPP
  const uint32_t qs_a = (uint32_t)__cvta_generic_to_shared(qs);
  const uint32_t ring_a = (uint32_t)__cvta_generic_to_shared(ring);

  const int tid = threadIdx.x, lane = tid & 31;
  const int cg = lane & 7, rg = (tid >> 5) * 4 + (lane >> 3);
  const int hb = a.heads * a.batch;
  const int qt = a.n_qtiles - 1 - item / hb;
  const int h = (item % hb) % a.heads;
  const int b = (item % hb) / a.heads;
  const int kvh = h / a.group;
  const int q0 = qt * BQ;
  const int len_q = a.len_q, len_k = a.len_k;
  const bool vec = a.vec;
  const float* kb = a.k + b * a.sk.b + kvh * a.sk.h;
  const float* vb = a.v + b * a.sv.b + kvh * a.sv.h;
  const long long stat = ((long long)b * a.heads + h) * len_q;

  // keys that some row of this block may see: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, len_q) - 1;
  const int k_hi = a.causal ? min(len_k, a.q_off + q_last + 1) : len_k;
  const int k_lo = a.window > 0 ? max(0, a.q_off + q0 - a.window + 1) : 0;
  const int t_first = k_lo / BK;
  const int t_end = (k_hi + BK - 1) / BK;

  load_rows<D, BQ>(qs_a, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, len_q,
                   tid, vec);
  load_rows<D, BQ>(qs_a + Cf::kQFloats * 4, a.dout + b * a.sd.b + h * a.sd.h,
                   a.sd.s, q0, len_q, tid, vec);
  if (t_first < t_end) {
    load_rows<D, BK>(ring_a, kb, a.sk.s, t_first * BK, len_k, tid, vec);
    load_rows<D, BK>(ring_a + Cf::kKvFloats * 4, vb, a.sv.s, t_first * BK,
                     len_k, tid, vec);
  }
  cp_async_commit();

  float lse2[TR], dl[TR];                 // lse in log2 units, delta
  float4 acc[TR][NU];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + rg + kRowGroups * i;
    lse2[i] = qi < len_q ? a.lse[stat + qi] * kLog2e : INFINITY;
    dl[i] = qi < len_q ? a.delta[stat + qi] : 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    const float* ks = ring + stage * 2 * Cf::kKvFloats;
    const float* vs = ks + Cf::kKvFloats;
    if (t + 1 < t_end) {            // the next tile, into the other stage
      const uint32_t nk = ring_a + (1 - stage) * 2 * Cf::kKvFloats * 4;
      load_rows<D, BK>(nk, kb, a.sk.s, (t + 1) * BK, len_k, tid, vec);
      load_rows<D, BK>(nk + Cf::kKvFloats * 4, vb, a.sv.s, (t + 1) * BK,
                       len_k, tid, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();             // tile t (and Q, dO) have landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T on the thread's rows x keys
    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = dp[i][j] = 0.f;
    dots<D, TR, TC>(s, qs + rg * P, ks + cg * P);
    dots<D, TR, TC>(dp, gs + rg * P, vs + cg * P);

    // dS = P (dP - delta); the mask only on tiles that straddle an edge
    const int k0 = t * BK;
    const bool edge = straddles(q0, BQ, k0, BK, len_q, len_k, a.causal,
                                a.window, a.q_off);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float p = exp2f(fmaf(s[i][j], a.scale_log2, -lse2[i]));
        if (edge && !allowed(q0 + rg + kRowGroups * i,
                             k0 + cg + kColGroups * j, len_q, len_k, a.causal,
                             a.window, a.q_off))
          p = 0.f;
        s[i][j] = p * (dp[i][j] - dl[i]);
      }

    // dQ += dS K, through the warp's own buffer rows
    stash<TR, TC, Cf::kPP>(dst, s, rg, cg);
    __syncwarp();
    accumulate<D, TR, BK, Cf::kPP>(acc, dst + rg * TR, ks, cg);
    __syncthreads();                // stage and buffer read; both reused
  }

  float* db = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + rg + kRowGroups * i;
    if (qi >= len_q) continue;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (owns<D>(cg, u))
        store4(db + (long long)qi * a.sdq.s + 4 * (cg + kColGroups * u),
               scaled(acc[i][u], a.scale), vec);
  }
}

// the dK/dV and dQ passes in one launch: the two are independent, so their
// items (each heaviest first) are interleaved — block 2i the dK/dV pass's
// item i, block 2i + 1 the dQ pass's — and the longer list's tail follows;
// each pass's light items then fill the SMs that the other's heavy items
// leave idle.  Every item is one block's, so no sum depends on the order.
template <int D>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return Dkv<D>::kSmemBytes > Dq<D>::kSmemBytes ? Dkv<D>::kSmemBytes
                                                : Dq<D>::kSmemBytes;
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bwd_dkv_dq_f32(const BwdF32 a) {
  extern __shared__ float4 smem_f32_bwd[];
  float* smem = reinterpret_cast<float*>(smem_f32_bwd);
  const int i = (int)blockIdx.x;
  const int both = 2 * min(a.n_kv_items, a.n_q_items);
  if (i < both ? (i & 1) == 0 : a.n_kv_items > a.n_q_items)
    dkv_item<D>(a, i < both ? i >> 1 : i - both / 2, smem);
  else
    dq_item<D>(a, i < both ? i >> 1 : i - both / 2, smem);
}

template <int D>
int launch_bwd(const bwd::BwdArgs& a, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  static const cudaError_t configured = cudaFuncSetAttribute(
      bwd_dkv_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return (int)configured;
  const bool fold = a.group > 1;
  if (fold && a.work == nullptr) return (int)cudaErrorInvalidValue;
  const long long hb = (long long)a.heads * a.batch;
  const long long rows = hb * a.len_q;
  const bool vec =
      rows16(a.q, a.sq, a.batch, a.heads, a.len_q) &&
      rows16(a.k, a.sk, a.batch, a.kv_heads, a.len_k) &&
      rows16(a.v, a.sv, a.batch, a.kv_heads, a.len_k) &&
      rows16(a.o, a.so, a.batch, a.heads, a.len_q) &&
      rows16(a.dout, a.sd, a.batch, a.heads, a.len_q) &&
      rows16(a.dq, a.sdq, a.batch, a.heads, a.len_q) &&
      rows16(a.dk, a.sdk, a.batch, a.kv_heads, a.len_k) &&
      rows16(a.dv, a.sdv, a.batch, a.kv_heads, a.len_k);
  const long long delta_rows =
      (kThreads / 32) * (32 / tc_bwd::pack_lanes<D / 4>());
  const long long delta_blocks = (rows + delta_rows - 1) / delta_rows;
  const long long kv_items =
      (a.len_k + Dkv<D>::kBlockK - 1) / Dkv<D>::kBlockK * hb;
  const int n_qtiles = (a.len_q + Dq<D>::kBlockQ - 1) / Dq<D>::kBlockQ;
  const long long q_items = (long long)n_qtiles * hb;
  if (kv_items + q_items > 0x7fffffffLL || delta_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long part = hb * a.len_k * D;    // one partial, in floats
  const BwdF32 args{(const float*)a.q, (const float*)a.k, (const float*)a.v,
                    (const float*)a.dout, a.lse, a.delta, (float*)a.dq,
                    (float*)a.dk, (float*)a.dv, fold ? a.work : nullptr,
                    fold ? a.work + part : nullptr, a.sq, a.sk, a.sv, a.sd,
                    a.sdq, a.sdk, a.sdv, a.heads, a.batch, a.group, a.len_q,
                    a.len_k, a.scale, a.scale * kLog2e, a.causal, a.window,
                    a.q_off, (int)kv_items, (int)q_items, n_qtiles,
                    (int)vec};
  bwd_delta_f32<D><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(
      (const float*)a.o, (const float*)a.dout, a.delta, a.so, a.sd, a.heads,
      a.len_q, rows, (int)vec);
  bwd_dkv_dq_f32<D><<<(unsigned)(kv_items + q_items), kThreads, smem,
                      stream>>>(args);
  if (fold) {
    const long long n4 = (long long)a.batch * a.kv_heads * a.len_k * D / 4;
    const long long blocks = (n4 + 255) / 256;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    tc_bwd::bwd_fold<D, float><<<(unsigned)blocks, 256, 0, stream>>>(
        a.work, a.work + part, (float*)a.dk, (float*)a.dv, a.sdk, a.sdv,
        a.kv_heads, a.group, a.len_k, a.scale, n4, (int)vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace f32

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
// aligned (the tensor-core kernel); else float32 (the CUDA-core kernel,
// any row alignment: 16-byte copies where every row is aligned, else
// 4-byte ones).
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
  // the scale folded with log2 e into the exp2 argument
  const float scale_log2 = (float)(scale * 1.4426950408889634);
  if (bf16)
    return by_head_dim(head_dim, [&](auto d) {
      return tc::launch<decltype(d)::value>(q, k, v, o, (float*)lse, sq, sk,
                                            sv, so, batch, heads, group, lq,
                                            lk, scale_log2, causal, win, qo,
                                            s);
    });
  return by_head_dim(head_dim, [&](auto d) {
    return f32::launch_fwd<decltype(d)::value>(q, k, v, o, (float*)lse, sq,
                                               sk, sv, so, batch, heads,
                                               kv_heads, lq, lk, scale_log2,
                                               causal, win, qo, s);
  });
}

// The gradient of flash_attention_fwd: dq, dk, dv (each of its input's
// shape, type and given strides) from q, k, v, the forward's output o, its
// lse (batch, heads, len_q) and the output's gradient dout.  delta is a
// float32 workspace of batch * heads * len_q values; work is a float32
// workspace of 2 * batch * heads * len_k * head_dim values (each query
// head's partial dK and dV) when heads > kv_heads, in either type, and may
// be null otherwise.  Types, head dims and sizes as for the forward; for
// bf16 every row of q, k, v and dout is 16-byte aligned, and every row of
// dq, dk, dv 8-byte aligned; float32 takes any row alignment.
// Dynamic shared memory and blocks an SM of an attention instance for
// head_dim: pass 0 the bfloat16 forward (without the lse store), 1 its
// backward's dK/dV pass, 2 its dQ pass; 3 the float32 forward, 4 the
// float32 backward's dK/dV and dQ kernel.  Launches nothing.
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
      case 3:
        return occupancy_of(f32::flash_fwd_f32_tiled<D, false>,
                            f32::kThreads, f32::Fwd<D>::kSmemBytes,
                            smem_bytes, blocks_per_sm);
      case 4:
        return occupancy_of(f32::bwd_dkv_dq_f32<D>, f32::kThreads,
                            f32::bwd_smem_bytes<D>(), smem_bytes,
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
    return f32::launch_bwd<decltype(d)::value>(a, s);
  });
}

}  // extern "C"
