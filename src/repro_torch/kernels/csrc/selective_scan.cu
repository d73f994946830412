// Mamba1 selective scan (CUDA C++, sm_90a): the forward in two forms, the
// fused form's backward, and the fused form's forward and backward with
// the bfloat16 working type.
//
// For each batch b and channel d, over t = 0 .. S-1 in order:
//   h[n] = exp(dt[t] * A[d, n]) * h[n] + (dt[t] * x[t]) * B[t, n]
//   y[t] = sum_n h[n] * C[t, n]
// with h starting at h0 (zeros when none is given).  Replaces the Pallas
// kernel `selective_scan` (`_kernel`) of the JAX package's
// kernels/selective_scan.py.
//
// selective_scan_fwd (plain form): y (B, S, D) and the final state
// (B, D, N), both float32, as the Pallas kernel returns them.
//
// selective_scan_fused_fwd (Mamba1 form): the same recurrence with the
// block's prologue and epilogue folded in, replaying the order and the
// roundings of the ATen sequence it replaces (io = x's type):
//   s     = round_io(dt_raw + round_io(dt_bias))
//   dt    = round_io(max(s, 0) + round_io(log1p(round_io(exp(-|s|)))))
//           (JAX's softplus, logaddexp(s, 0), with each op in io's type)
//   A     = -exp(A_log)
//   (step: dt * x is rounded to io before the recurrence, as the one-step
//   update does for a bfloat16 product)
//   out   = round_io((y + D * x) * (z * sigmoid(z)))
// so the float32 y, the softplus and the gate never reach device memory.
// The softplus is libdevice's expf and log1pf, as ATen's, rounded as
// ATen rounds each op, so dt takes the same io value and the state agrees
// to float32 rounding; the gate, which only feeds `out`, takes __expf
// and __fdividef (a few ulp).
// h_out may be h0 itself: every lane reads its states before it writes
// them, and no other thread touches them.  Given a `bound` buffer (the
// training path, over a sequence), a third instance (BOUND) also stores
// each lane's float32 state entering every chunk of kChunk steps, for the
// backward; generation launches the two others, compiled as before.
//
// Bound: the exponentials.  Each (t, d) takes N of them, b*S*D*N in all
// (268 M for falcon-mamba-7b at batch 4, prompt 512), and the special
// function units issue 16 a clock on each SM: 0.064 ms on an H100 at
// 1.98 GHz, above the 0.041 ms the bytes take (x, dt, B, C read once, y
// written once; the (B, S, D, N) trajectory of the state never reaches
// device memory, which is the point of the Pallas kernel).  Design:
//  * kLanes (4) lanes per channel, each holding N/4 of its states and the
//    matching part of A's row, pre-multiplied by log2 e, in registers; a
//    thread holds kPerThread neighbouring channels, so the B and C values
//    it reads serve both.  2, 4 and 8 lanes were timed on an H100 and 4
//    was the fastest in both forms (PERF.md).  32 channels a block:
//    falcon's 8192 channels at batch 4 run as 1,024 blocks of 64 threads,
//    all resident at once.
//  * Time goes in chunks of kChunk steps.  The chunk's x, dt, B, C (and z)
//    tiles are staged in shared memory by cp.async in a ring of kStages
//    slots: two chunks are in flight while one is computed, with one
//    wait_group and two __syncthreads a chunk.  Copies are 16 bytes where
//    the view is aligned, 4 bytes where that is, else element by element;
//    no view is refused.
//  * One pass a chunk turns dt and x into float32 dt and dt * x once for
//    all lanes (the fused form takes the softplus there); a step reads
//    those and its N/L values of B and C (bfloat16 pairs unpacked in
//    registers) from shared memory, then does one ex2.approx and two fmaf
//    a state (the library is built with -fmad=false; contraction is asked
//    for here by name).
//  * Each lane's share of y goes to shared memory, where the store pass
//    sums the L shares and writes coalesced rows of 32 channels; the fused
//    form applies the D skip and the gate there.
//  * On an H100 the kernel stays about 2.2x above that bound (PERF.md,
//    which says what else was tried and what is left open: more resident
//    warps an SM, or splitting time across blocks).
//
// selective_scan_fused_bwd (backward of the fused form over a sequence;
// no TPU counterpart: the JAX package differentiates its plain jnp): the
// nine gradients dx, d(dt_raw), dz (b, S, D) and dB, dC (b, S, N) in the
// inputs' type, d(dt_bias), dD (D,), dA_log (D, N) and dh0 (b, D, N) in
// float32.  With a_t = exp(dt_t A), y_t the scan's output before the skip
// and g = silu(z):
//   dz = dout (y + D x) silu'(z),  dy = dout g
//   dh_t = a_{t+1} dh_{t+1} + dy_t C_t        (from dh_final, or 0)
//   dC_t = sum_D dy_t h_t,  dB_t = sum_D dh_t dt_t x_t
//   d(dt)_t = sum_N dh_t (A a_t h_{t-1} + x_t B_t)
//   dx = dy D + dt sum_N dh_t B_t
//   dA_log = A sum_{b,t} dh_t dt_t a_t h_{t-1},  dD = sum_{b,t} dy x
//   d(dt_raw) = d(dt) sigmoid(dt_raw + dt_bias),  d(dt_bias) its sum
//   dh0 = a_1 dh_1
// Bound: the same b*S*D*N exponentials as the forward (0.032 ms for
// falcon-mamba-7b's training microbatch, 2 x 512 x 8192 x 16, on an
// H100), just above its bytes (0.035 ms: x, dt, z, dout read and dx,
// ddt, dz written in bfloat16).  A direct design (a thread's chunk of
// states in registers, a forward walk to find the chunk boundaries, plain
// loads, per-channel work on every lane) is bound far above that by
// latency: 224 registers leave 8 warps an SM.  Design:
//  * The forward hands over its chunk boundaries: the fused forward's
//    BOUND instance (what the training path launches) stores the float32
//    state entering every kChunk (= kBwdChunk) steps, (b, chunks, D, N),
//    with the arithmetic this kernel recomputes with.  No forward walk.
//  * A block of kBwdChannels channels, 4 lanes a channel (N/4 states a
//    thread), walks the chunks in reverse.  The states are recomputed from
//    the chunk's boundary with the forward's arithmetic (the bfloat16
//    softplus replay, one ex2.approx of dt * A * log2 e and one fmaf a
//    state and step, y summed over the lanes in the forward's order) in
//    halves of kBwdHalf steps: the first half walked to its end, its
//    states kept in shared memory; the second half's recomputed into
//    registers and walked back; then the first half's.  Two ex2 a state
//    and step (the reverse computes a_t again), and a thread holds 8 steps
//    of states, so 128 registers do: kBwdBlocksPerSM (4) blocks, 16 warps,
//    an SM, and the training shape's 512 blocks run in one wave.  Its
//    shared memory (53 KB in bfloat16) is dynamic, the SM's carveout at its
//    largest.
//  * Per (t, channel) work is done once for the block, not on every lane:
//    a prologue turns the chunk's tiles into dt, dt * x, dy = dout
//    silu(z), the softplus' slope and silu'(z) (and B, C into float32,
//    zeros past the chunk's rows, which makes a step past them a no-op:
//    no branch between steps); a store pass after the walks forms dx,
//    d(dt_raw) and dz in coalesced rows and the sums of d(dt_bias) and dD.
//    A reverse step holds the per-state recurrence, the sums over the
//    channel's 4 lanes (shuffles) and over the warp's 8 channels.
//  * Tiles arrive by cp.async into a ring of kBwdStages slots: chunk k-1's
//    (x, dt, z, dout, B, C) are in flight while chunk k is walked; the
//    boundary of chunk k-1 is loaded into registers meanwhile.
//  * No float atomics: dB and dC (sums over D) leave each block as float32
//    partials (2, b, blocks, S, N), summed first over a warp's 8 channels
//    by a butterfly of shuffles and then over the block's 4 warps in
//    order; dA_log, dD and d(dt_bias) (sums over the batch) as per-sequence
//    partials.  A second launch folds every partial in a fixed order (dB,
//    dC by kFoldSplit slices of the blocks a output).  So two launches give
//    the same bits, which a bitwise training resume needs.
//
// selective_scan_fused_bf16_fwd / _bwd (the fused form over a sequence
// with the bfloat16 working type, cfg.scan_dtype "bfloat16"; no Pallas
// counterpart: the JAX package computes it in plain jnp,
// models/mamba.py::selective_scan(work_dtype=bfloat16)).  In chunks of q
// steps (the reference's, any divisor of len up to 128): a = exp(dt A) and
// u = (dt x) B in float32, each rounded to bfloat16; their inclusive scan
// under (a_l a_r, u_l a_r + u_r) in jax.lax.associative_scan's odd/even
// tree, every product and sum computed in float32 and rounded to bfloat16
// on its own, as the reference's op-by-op bfloat16 rounds them (a native
// bfloat16 multiply-add rounds once from the exact value and lands a step
// away in rare double-rounding cases, which a chunk carries); then h_t =
// a_cum h + u_scan in float32 from the float32 state carried across
// chunks, and the fused form's prologue and epilogue as above.  Bound:
// the same b*S*D*N exponentials as the float32 form (the tree adds some
// six bfloat16 operations a state and step).  Design:
//  * The tree's operations run natively on pairs of lanes (states n and
//    n + 8 of a channel in one 32-bit word: mul.rn.bf16x2, add.rn.bf16x2),
//    each rounding once, which for bfloat16 operands gives the bits of the
//    float32 operation rounded (a probe entry holds the two equal on the
//    card); a combine is three instructions for two lanes.
//  * A lane pair's chunk is split over 16 threads of one warp, 8 steps
//    each, in registers: the tree's levels 0-2 inside a thread (their
//    combines independent, so they overlap), levels 3-6 between the
//    threads' last elements by shuffles.  A warp holds one lane pair of a
//    channel pair (a lane a channel and segment), a block the 8 pairs: 256
//    threads.  Each level's combines touch disjoint elements, so the split
//    gives the tree's bits.  8 steps a thread keep the backward's arrays
//    (the tree's values, its outputs at odd steps, the two gradients)
//    within 128 registers; 16 spilled.
//  * Forward: a block of 16 channels, a channel pair at a time; per chunk B
//    and C and each (t, channel)'s dt and dt * x staged once in shared
//    memory, read by 16-byte loads; each lane pair's share of y (its two
//    terms added) goes to shared memory and a pass sums the 8 shares of
//    each (t, channel) in the butterfly's order (xor 8, 4, 2, 1 over the
//    states), so the state, the boundaries and out keep the bits of a
//    thread-a-state walk.  64 registers: 4 blocks, 32 warps, an SM.
//  * Backward: a block of 32 channels (the float32 backward's partials and
//    fold), its 16 channel pairs in turn for each chunk in reverse: the
//    chunk's tree rebuilt from its boundary with the up-sweep's values
//    kept in registers, g = dy C (plus the carry at the chunk's last step),
//    g h_in and g rounded to bfloat16, the tree's transpose in bfloat16
//    (the down-sweep's combines from level 0 up, then the up-sweep's from
//    the top down; an a_r inside a segment rebuilt from level 0's a by the
//    forward's products, between segments kept from the forward), then ds
//    = da exp(dt A) (the exponential taken again: keeping it would cost
//    the registers) and du into the nine gradients.  dB and dC are summed
//    over the block's channels in shared memory in pair order (channel
//    2 m + 1 onto 2 m by a shuffle, then the pairs in order) and leave as
//    the per-32-channel partials: no atomics, no read-modify-write of
//    device memory in a step loop.  The carried gradient and dA add the
//    segments' sums by a butterfly over the segments.  2 blocks, 16
//    warps, an SM (128 registers).
//  * Both take a compile-time instance for q = 128 (every path shape) and
//    one for any other q <= 128.

// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;     // channels per block
constexpr int kChunk = 16;        // time steps per ring slot
constexpr int kStages = 3;        // ring slots
constexpr int kNMax = 16;         // largest state size
constexpr int kLanes = 4;         // threads that share a channel's states
constexpr int kPerThread = 2;     // channels a thread holds
constexpr float kLog2e = 1.4426950408889634f;

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

// v rounded to T and read back as float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* x;
  const void* dt;
  const void* bm;
  const void* cm;
  const void* z;            // fused form only
  const float* a;           // A (plain form) or A_log (fused form), (d, n)
  const float* dt_bias;     // fused form only
  const float* dskip;       // fused form only
  const float* h0;          // may be h_out itself, or NULL
  float* h_out;
  float* bound;             // (batch, chunks, d, n): the state entering
                            // each chunk (the BOUND instance only)
  void* y;                  // float32 (plain) or x's type (fused)
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st, z_sb, z_st;
  int len, d, n;
  int vx, vdt, vb, vc, vz;  // copy width of each view: 16, 4 or 0 bytes
  int step;
  int q;                    // the bfloat16 working type's chunk
};

// The ring slots (in the inputs' type), the float32 dt and dt * x of the
// chunk being computed, and each lane's share of its y.
template <typename T, bool FUSED>
struct __align__(16) Smem {
  T xs[kStages][kChunk][kChannels];
  T ds[kStages][kChunk][kChannels];
  T zs[FUSED ? kStages : 1][kChunk][kChannels];
  T bs[kStages][kChunk][kNMax];
  T cs[kStages][kChunk][kNMax];
  float delta[kChunk][kChannels];
  float dtx[kChunk][kChannels];
  float ys[kChunk][kChannels * kLanes];
  float bias[kChannels];
  float dskip[kChannels];
};

// Copies rows [0, rows) and columns [c0, c0 + W) of a view (row stride st,
// `cols` columns) into dense shared rows of W elements, BYTES at a time by
// cp.async (16 or 4), or element by element (0).  Elements out of range are
// left as they are.  Every count is known at compile time but the rows.
template <int BYTES, int NT, typename T, int W>
__device__ __forceinline__ void stage_rows(T (*dst)[W], const T* src,
                                           long long st, int rows, int c0,
                                           int cols, int tid) {
  constexpr int vec = BYTES ? BYTES / (int)sizeof(T) : 1;
  constexpr int per_row = W / vec;
#pragma unroll
  for (int i0 = 0; i0 < kChunk * per_row; i0 += NT) {
    const int i = i0 + tid;
    const int t = i / per_row, e = (i % per_row) * vec;
    if ((kChunk * per_row % NT == 0 || i < kChunk * per_row) && t < rows &&
        c0 + e < cols) {
      const T* s = src + t * st + c0 + e;
      if (BYTES == 16)
        cp_async16(&dst[t][e], s);
      else if (BYTES == 4)
        cp_async4(&dst[t][e], s);
      else
        dst[t][e] = *s;
    }
  }
}

template <int NT, typename T, int W>
__device__ __forceinline__ void stage(T (*dst)[W], const T* src,
                                      long long st, int rows, int c0,
                                      int cols, int bytes, int tid) {
  if (bytes == 16)
    stage_rows<16, NT>(dst, src, st, rows, c0, cols, tid);
  else if (bytes == 4)
    stage_rows<4, NT>(dst, src, st, rows, c0, cols, tid);
  else
    stage_rows<0, NT>(dst, src, st, rows, c0, cols, tid);
}

// Two bfloat16 values packed in a 32-bit word, as float32 (little endian:
// the first in the low half), or one float32.
__device__ __forceinline__ void unpack(float* v, unsigned w, float) {
  v[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(float* v, unsigned w, __nv_bfloat16) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive values of type T from shared memory (4, 8 or a multiple of
// 16 bytes, aligned to that), as float32, in the widest loads.
template <int N, typename T>
__device__ __forceinline__ void load_f32(float (&v)[N], const T* p) {
  constexpr int kPer = 4 / (int)sizeof(T);     // values a 32-bit word holds
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      unpack(v + (4 * q + 0) * kPer, u.x, T());
      unpack(v + (4 * q + 1) * kPer, u.y, T());
      unpack(v + (4 * q + 2) * kPer, u.z, T());
      unpack(v + (4 * q + 3) * kPer, u.w, T());
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack(v, u.x, T());
    unpack(v + kPer, u.y, T());
  } else {
    static_assert(kBytes == 4, "N values must fill 4, 8 or 16k bytes");
    unpack(v, *reinterpret_cast<const unsigned*>(p), T());
  }
}

// L lanes share each channel's states; a thread holds K neighbouring
// channels (their N/L states each).  BOUND (the fused form over a sequence
// under a gradient) also stores the float32 state entering every chunk.
template <typename T, bool FUSED, bool BOUND>
__global__ void __launch_bounds__(kChannels * kLanes / kPerThread)
scan_kernel(const Args p) {
  constexpr int L = kLanes, K = kPerThread;
  constexpr int kThreads = kChannels * L / K;
  constexpr int NL = kNMax / L;           // states a lane holds
  __shared__ Smem<T, FUSED> sm;
  const int tid = threadIdx.x;
  const int lane = tid % L, cl = tid / L * K;   // first channel in block
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int d = p.d, n = p.n, len = p.len;
  const int chunks = (len + kChunk - 1) / kChunk;

  const T* xg = (const T*)p.x + b * p.x_sb;
  const T* dg = (const T*)p.dt + b * p.dt_sb;
  const T* bg = (const T*)p.bm + b * p.b_sb;
  const T* cg = (const T*)p.cm + b * p.c_sb;
  const T* zg = FUSED ? (const T*)p.z + b * p.z_sb : nullptr;

  // this lane's states and its part of A's rows, times log2 e
  float a2[K][NL], h[K][NL];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ch = c0 + cl + j;
    const long long state = ((long long)b * d + ch) * n;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int k = lane * NL + i;
      const bool in = ch < d && k < n;
      float av = in ? p.a[(long long)ch * n + k] : 0.f;
      if (FUSED && in) av = -expf(av);
      a2[j][i] = av * kLog2e;
      h[j][i] = in && p.h0 != nullptr ? p.h0[state + k] : 0.f;
    }
  }
  if (n < kNMax) {    // B and C columns past n stay zero in every slot
    for (int i = tid; i < kStages * kChunk * kNMax; i += kThreads) {
      if (i % kNMax >= n) {
        (&sm.bs[0][0][0])[i] = from_f32<T>(0.f);
        (&sm.cs[0][0][0])[i] = from_f32<T>(0.f);
      }
    }
  }
  if (FUSED) {
    for (int c = tid; c < kChannels; c += kThreads) {
      const bool in = c0 + c < d;
      sm.bias[c] = in ? round_to<T>(p.dt_bias[c0 + c]) : 0.f;
      sm.dskip[c] = in ? p.dskip[c0 + c] : 0.f;
    }
  }

  auto issue = [&](int k) {
    if (k < chunks) {
      const int t0 = k * kChunk, rows = min(kChunk, len - t0);
      const int slot = k % kStages;
      stage<kThreads>(sm.xs[slot], xg + t0 * p.x_st, p.x_st, rows, c0, d,
                      p.vx, tid);
      stage<kThreads>(sm.ds[slot], dg + t0 * p.dt_st, p.dt_st, rows, c0, d,
                      p.vdt, tid);
      if (FUSED)
        stage<kThreads>(sm.zs[slot], zg + t0 * p.z_st, p.z_st, rows, c0, d,
                        p.vz, tid);
      stage<kThreads>(sm.bs[slot], bg + t0 * p.b_st, p.b_st, rows, 0, n,
                      p.vb, tid);
      stage<kThreads>(sm.cs[slot], cg + t0 * p.c_st, p.c_st, rows, 0, n,
                      p.vc, tid);
    }
    cp_async_commit();                    // an empty group past the end
  };

  // y of chunk k (the lanes' shares in sm.ys) out to device memory, a row
  // of 32 channels at a time; the fused form adds D * x and applies the
  // gate on the way
  auto epilogue = [&](int k) {
    const int t0 = k * kChunk, rows = min(kChunk, len - t0);
    const int slot = k % kStages;
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      if (t >= rows || c0 + c >= d) continue;
      const long long o = ((long long)b * len + t0 + t) * d + c0 + c;
      float part[L];
      load_f32<L>(part, &sm.ys[t][c * L]);
      float y = part[0];
#pragma unroll
      for (int l = 1; l < L; ++l) y += part[l];
      if (FUSED) {
        y = y + sm.dskip[c] * to_f32(sm.xs[slot][t][c]);
        const float zf = to_f32(sm.zs[slot][t][c]);
        const float gate = __fdividef(zf, 1.f + __expf(-zf));
        ((T*)p.y)[o] = from_f32<T>(y * gate);
      } else {
        ((float*)p.y)[o] = y;
      }
    }
  };

  // dt (the softplus of dt_raw + bias in the fused form) and dt * x of the
  // chunk in float32, once for all lanes; zeros out of range
  auto prologue = [&](int k) {
    const int t0 = k * kChunk, rows = min(kChunk, len - t0);
    const int slot = k % kStages;
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      float dl = 0.f, dx = 0.f;
      if (t < rows && c0 + c < d) {
        dl = to_f32(sm.ds[slot][t][c]);
        const float xv = to_f32(sm.xs[slot][t][c]);
        if (FUSED) {
          const float s = round_to<T>(dl + sm.bias[c]);
          const float e = round_to<T>(expf(-fabsf(s)));
          dl = round_to<T>(fmaxf(s, 0.f) + round_to<T>(log1pf(e)));
        }
        dx = dl * xv;
        if (FUSED && p.step) dx = round_to<T>(dx);
      }
      sm.delta[t][c] = dl;
      sm.dtx[t][c] = dx;
    }
  };

  // the state entering chunk k, for the backward: a lane's NL states in
  // one 16-byte store where N is a multiple of 4, else one by one
  auto store_bound = [&](int k) {
    static_assert(NL == 4, "a lane's states are one float4");
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int ch = c0 + cl + j;
      if (ch >= d) continue;
      float* bo = p.bound + (((long long)b * chunks + k) * d + ch) * n +
                  lane * NL;
      if (n % 4 == 0) {
        if (lane * NL < n)
          *reinterpret_cast<float4*>(bo) =
              make_float4(h[j][0], h[j][1], h[j][2], h[j][3]);
      } else {
#pragma unroll
        for (int i = 0; i < NL; ++i)
          if (lane * NL + i < n) bo[i] = h[j][i];
      }
    }
  };

  // a step reads this lane's B and C straight from the ring slot; a
  // channel out of range runs on zeros and stores nothing
  auto compute = [&](int k) {
    const int rows = min(kChunk, len - k * kChunk);
    const int slot = k % kStages;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < rows) {
        float dl[K], dx[K], bv[NL], cv[NL];
        load_f32<K>(dl, &sm.delta[t][cl]);
        load_f32<K>(dx, &sm.dtx[t][cl]);
        load_f32<NL>(bv, &sm.bs[slot][t][lane * NL]);
        load_f32<NL>(cv, &sm.cs[slot][t][lane * NL]);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < NL; ++i) {
            h[j][i] = fmaf(ex2(dl[j] * a2[j][i]), h[j][i], dx[j] * bv[i]);
            acc = fmaf(h[j][i], cv[i], acc);
          }
          sm.ys[t][(cl + j) * L + lane] = acc;
        }
      }
    }
  };

  issue(0);
  issue(1);
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<1>();                   // chunk k has landed
    __syncthreads();                      // ... for every thread
    if (k > 0) epilogue(k - 1);
    prologue(k);
    __syncthreads();                      // slot k-1 and sm.ys are free
    issue(k + 2);
    if constexpr (BOUND) store_bound(k);
    compute(k);
  }
  cp_async_wait<0>();
  __syncthreads();
  epilogue(chunks - 1);

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ch = c0 + cl + j;
    const long long state = ((long long)b * d + ch) * n;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int k = lane * NL + i;
      if (ch < d && k < n) p.h_out[state + k] = h[j][i];
    }
  }
}

// Widest copy (16 or 4 bytes, else 0) that every row piece of a view
// (batch and time strides sb, st; `cols` columns of `es` bytes) allows.
int copy_bytes(const void* ptr, long long sb, long long st, long long cols,
               int es) {
  const int widths[2] = {16, 4};
  for (int w : widths)
    if ((uintptr_t)ptr % w == 0 && (sb * es) % w == 0 && (st * es) % w == 0 &&
        (cols * es) % w == 0)
      return w;
  return 0;
}

template <typename T, bool FUSED, bool BOUND>
int launch(Args& p, long long batch, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  p.vx = copy_bytes(p.x, p.x_sb, p.x_st, p.d, es);
  p.vdt = copy_bytes(p.dt, p.dt_sb, p.dt_st, p.d, es);
  p.vb = copy_bytes(p.bm, p.b_sb, p.b_st, p.n, es);
  p.vc = copy_bytes(p.cm, p.c_sb, p.c_st, p.n, es);
  p.vz = FUSED ? copy_bytes(p.z, p.z_sb, p.z_st, p.d, es) : 0;
  const dim3 grid((p.d + kChannels - 1) / kChannels, (unsigned)batch);
  scan_kernel<T, FUSED, BOUND>
      <<<grid, kChannels * kLanes / kPerThread, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(Args& p, long long batch, int bf16, cudaStream_t stream) {
  if (p.n < 1 || p.n > kNMax) return (int)cudaErrorInvalidValue;
  if (p.bound != nullptr)       // the fused form over a sequence only
    return bf16 ? launch<__nv_bfloat16, true, true>(p, batch, stream)
                : launch<float, true, true>(p, batch, stream);
  return bf16 ? launch<__nv_bfloat16, FUSED, false>(p, batch, stream)
              : launch<float, FUSED, false>(p, batch, stream);
}


// ---------------------------------------------------------------------------
// backward of the fused form
// ---------------------------------------------------------------------------

constexpr int kBwdChannels = 32;                 // channels per block
constexpr int kBwdChunk = kChunk;                // the forward's boundaries
constexpr int kBwdHalf = kBwdChunk / 2;          // states a thread holds
constexpr int kBwdStages = 2;                    // ring slots
constexpr int kBwdNL = kNMax / kLanes;           // states a lane holds
constexpr int kBwdThreads = kBwdChannels * kLanes;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdBlocksPerSM = 4;               // 16 warps: <= 128 registers
constexpr int kFoldOut = 32, kFoldSplit = 8;     // the fold's block: outputs
                                                 // x slices of the partials

struct BwdArgs {
  const void* x;
  const void* dt;
  const void* bm;
  const void* cm;
  const void* z;
  const void* dout;
  const float* a_log;
  const float* dt_bias;
  const float* dskip;
  const float* h0;          // or NULL
  const float* dh_final;    // or NULL
  const float* bound;       // (batch, chunks, d, n), from the forward
  void* dx;
  void* ddt;
  void* dbm;
  void* dcm;
  void* dz;
  float* ddt_bias;
  float* ddskip;
  float* da_log;
  float* dh0;               // or NULL
  float* bc_part;           // (2, batch, blocks, len, n): dB, dC
  float* da_part;           // (batch, d, n)
  float* vec_part;          // (2, batch, d): d(dt_bias), dD
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st, z_sb, z_st,
      o_sb, o_st;
  int batch, len, d, n, chunks, blocks;
  int vx, vdt, vb, vc, vz, vo;  // copy width of each view: 16, 4 or 0 bytes
  int q;                        // the bfloat16 working type's chunk
};

// The ring slots (in the inputs' type); what the chunk's prologue computes
// once per (t, channel); what its walks leave for the store pass.
template <typename T>
struct __align__(16) BwdSmem {
  T xs[kBwdStages][kBwdChunk][kBwdChannels];
  T ds[kBwdStages][kBwdChunk][kBwdChannels];
  T zs[kBwdStages][kBwdChunk][kBwdChannels];
  T os[kBwdStages][kBwdChunk][kBwdChannels];
  T bs[kBwdStages][kBwdChunk][kNMax];
  T cs[kBwdStages][kBwdChunk][kNMax];
  // dt (after the softplus), dt * x, dy = dout silu(z), sigmoid(dt_raw +
  // bias): the softplus' slope
  float4 step[kBwdChunk][kBwdChannels];
  float dsilu[kBwdChunk][kBwdChannels];   // silu'(z)
  // the chunk's B and C in float32, zeros past its rows and past n
  float bf[kBwdChunk][kNMax];
  float cf[kBwdChunk][kNMax];
  float ys[kBwdChunk][kBwdChannels];      // the forward's y
  float2 sums[kBwdChunk][kBwdChannels];   // sum_N dh B, sum_N dh h a A
  float4 hfirst[kBwdHalf][kBwdThreads];   // the first half's states
  float red[kBwdChunk][kBwdWarps][2][kNMax];   // each warp's dB, dC sums
  // d(dt_bias), dD of each channel by the store pass' rows of threads
  float acc[2][kBwdThreads / kBwdChannels][kBwdChannels];
  float bias[kBwdChannels];
  float dskip[kBwdChannels];
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSM)
scan_bwd_kernel(const BwdArgs p) {
  constexpr int L = kLanes, NL = kBwdNL, TC = kBwdChunk, TH = kBwdHalf;
  static_assert(2 * NL == 32 / L, "the butterfly scatters a thread's 2 NL "
                "dB, dC terms over a warp's 32 / L channels");
  static_assert(kBwdThreads % kBwdChannels == 0, "the store pass keeps a "
                "channel per thread");
  static_assert(NL == 4, "a lane's states are one float4");
  constexpr int kRows = kBwdThreads / kBwdChannels;   // its rows of threads
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  BwdSmem<T>& sm = *reinterpret_cast<BwdSmem<T>*>(bwd_smem);
  const int tid = threadIdx.x;
  const int lane = tid % L, c = tid / L;        // channel within the block
  const int warp = tid / 32, wl = tid % 32;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int c0 = blk * kBwdChannels, ch = c0 + c;
  const int d = p.d, n = p.n, len = p.len, chunks = p.chunks;
  const bool ch_in = ch < d;
  const unsigned full = 0xffffffffu;

  const T* xg = (const T*)p.x + b * p.x_sb;
  const T* dg = (const T*)p.dt + b * p.dt_sb;
  const T* bg = (const T*)p.bm + b * p.b_sb;
  const T* cg = (const T*)p.cm + b * p.c_sb;
  const T* zg = (const T*)p.z + b * p.z_sb;
  const T* og = (const T*)p.dout + b * p.o_sb;
  const long long state = ((long long)b * d + ch) * n;

  // A (for dA and d(dt)), A * log2 e (the forward's exponent), the
  // gradient of the state (from dh_final) and the sums of dA
  float aneg[NL], a2[NL], carry[NL], dA[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int k = lane * NL + i;
    const bool in = ch_in && k < n;
    const float av = in ? -expf(p.a_log[(long long)ch * n + k]) : 0.f;
    aneg[i] = av;
    a2[i] = av * kLog2e;
    carry[i] = in && p.dh_final != nullptr ? p.dh_final[state + k] : 0.f;
    dA[i] = 0.f;
  }
  for (int i = tid; i < kBwdChannels; i += kBwdThreads) {
    const bool in = c0 + i < d;
    sm.bias[i] = in ? round_to<T>(p.dt_bias[c0 + i]) : 0.f;
    sm.dskip[i] = in ? p.dskip[c0 + i] : 0.f;
  }

  // chunk k's tiles into its ring slot; an empty group before the first
  auto issue = [&](int k) {
    if (k >= 0) {
      const int t0 = k * TC, rows = min(TC, len - t0);
      const int slot = k % kBwdStages;
      stage<kBwdThreads>(sm.xs[slot], xg + t0 * p.x_st, p.x_st, rows, c0, d,
                         p.vx, tid);
      stage<kBwdThreads>(sm.ds[slot], dg + t0 * p.dt_st, p.dt_st, rows, c0,
                         d, p.vdt, tid);
      stage<kBwdThreads>(sm.zs[slot], zg + t0 * p.z_st, p.z_st, rows, c0, d,
                         p.vz, tid);
      stage<kBwdThreads>(sm.os[slot], og + t0 * p.o_st, p.o_st, rows, c0, d,
                         p.vo, tid);
      stage<kBwdThreads>(sm.bs[slot], bg + t0 * p.b_st, p.b_st, rows, 0, n,
                         p.vb, tid);
      stage<kBwdThreads>(sm.cs[slot], cg + t0 * p.c_st, p.c_st, rows, 0, n,
                         p.vc, tid);
    }
    cp_async_commit();
  };

  // this lane's part of the state entering chunk k, as the forward wrote it
  auto load_bound = [&](int k, float (&h)[NL]) {
    const float* bo = p.bound + (((long long)b * chunks + k) * d + ch) * n;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      h[i] = ch_in && lane * NL + i < n ? bo[lane * NL + i] : 0.f;
  };

  float hin[NL], hnext[NL];
  load_bound(chunks - 1, hnext);
  issue(chunks - 1);
  // the sums over t of the store pass' channel (tid % kBwdChannels) in the
  // rows t = tid / kBwdChannels + kRows j
  float acc_bias = 0.f, acc_d = 0.f;
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * TC, rows = min(TC, len - t0);
    const int slot = k % kBwdStages;
    cp_async_wait<0>();                // chunk k has landed
    __syncthreads();                   // ... for every thread; chunk k+1's
                                       // slot and scratch are free
    issue(k - 1);
#pragma unroll
    for (int i = 0; i < NL; ++i) hin[i] = hnext[i];
    if (k > 0) load_bound(k - 1, hnext);   // read during this chunk

    // once per (t, channel): dt (the forward's bfloat16 softplus replay),
    // dt * x, dy, the softplus' slope and silu'(z); zeros out of range, so
    // that a step past the chunk's rows leaves the states and the carried
    // gradient as they are (a = 1, no input, no dy)
    for (int i = tid; i < TC * kBwdChannels; i += kBwdThreads) {
      const int t = i / kBwdChannels, cc = i % kBwdChannels;
      float dl = 0.f, dx = 0.f, dy = 0.f, sg = 0.f, dsl = 0.f;
      if (t < rows && c0 + cc < d) {
        const float raw = to_f32(sm.ds[slot][t][cc]);
        const float xv = to_f32(sm.xs[slot][t][cc]);
        const float s = round_to<T>(raw + sm.bias[cc]);
        const float e = round_to<T>(expf(-fabsf(s)));
        dl = round_to<T>(fmaxf(s, 0.f) + round_to<T>(log1pf(e)));
        dx = dl * xv;
        sg = __fdividef(1.f, 1.f + __expf(-s));
        const float zf = to_f32(sm.zs[slot][t][cc]);
        const float sz = __fdividef(1.f, 1.f + __expf(-zf));
        const float gate = zf * sz;
        dy = to_f32(sm.os[slot][t][cc]) * gate;
        dsl = sz + gate * (1.f - sz);
      }
      sm.step[t][cc] = make_float4(dl, dx, dy, sg);
      sm.dsilu[t][cc] = dsl;
    }
    for (int i = tid; i < TC * kNMax; i += kBwdThreads) {
      const int t = i / kNMax, k2 = i % kNMax;
      const bool in = t < rows && k2 < n;
      sm.bf[t][k2] = in ? to_f32(sm.bs[slot][t][k2]) : 0.f;
      sm.cf[t][k2] = in ? to_f32(sm.cs[slot][t][k2]) : 0.f;
    }
    __syncthreads();

    // y of step t: the lanes' shares summed in the forward's order
    auto store_y = [&](int t, float acc) {
      const float p1 = __shfl_down_sync(full, acc, 1);
      const float p2 = __shfl_down_sync(full, acc, 2);
      const float p3 = __shfl_down_sync(full, acc, 3);
      if (lane == 0) sm.ys[t][c] = acc + p1 + p2 + p3;
    };

    // the states of steps lo .. lo + TH - 1 into hs, from the state `from`
    // entering step lo, as the forward computes them, and y
    float hs[TH][NL];
    auto recompute = [&](int lo, const float (&from)[NL]) {
#pragma unroll
      for (int j = 0; j < TH; ++j) {
        const int t = lo + j;
        const float4 st = sm.step[t][c];
        float bv[NL], cv[NL];
        load_f32<NL>(bv, &sm.bf[t][lane * NL]);
        load_f32<NL>(cv, &sm.cf[t][lane * NL]);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float prev = j > 0 ? hs[j > 0 ? j - 1 : 0][i] : from[i];
          hs[j][i] = fmaf(ex2(st.x * a2[i]), prev, st.y * bv[i]);
          acc = fmaf(hs[j][i], cv[i], acc);
        }
        store_y(t, acc);
      }
    };

    // the reverse recurrence over steps lo + TH - 1 .. lo, whose states
    // are in hs (`from` entering step lo): this thread's dA, the channel's
    // sums over N and the warp's sums of dB, dC over its 8 channels
    auto reverse = [&](int lo, const float (&from)[NL]) {
#pragma unroll
      for (int j = TH - 1; j >= 0; --j) {
        const int t = lo + j;
        const float4 st = sm.step[t][c];        // dt, dt * x, dy
        float bv[NL], cv[NL];
        load_f32<NL>(bv, &sm.bf[t][lane * NL]);
        load_f32<NL>(cv, &sm.cf[t][lane * NL]);
        float vals[2 * NL];            // this thread's dB, dC terms
        float sb = 0.f, sa = 0.f;      // sum_N dh B, sum_N dh h_prev a A
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          const float a = ex2(st.x * a2[i]);
          const float g = fmaf(st.z, cv[i], carry[i]);          // dL/dh_t
          const float prev = j > 0 ? hs[j > 0 ? j - 1 : 0][i] : from[i];
          const float gha = g * prev * a;
          sb = fmaf(g, bv[i], sb);
          sa = fmaf(gha, aneg[i], sa);
          dA[i] = fmaf(gha, st.x, dA[i]);
          vals[i] = g * st.y;
          vals[NL + i] = st.z * hs[j][i];
          carry[i] = a * g;
        }
        // over the channel's 4 lanes
        sb += __shfl_xor_sync(full, sb, 1);
        sb += __shfl_xor_sync(full, sb, 2);
        sa += __shfl_xor_sync(full, sa, 1);
        sa += __shfl_xor_sync(full, sa, 2);
        // over the warp's 8 channels: a butterfly that leaves the sum of
        // value (wl >> 2) & 7 on each thread
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int half = NL >> s, mask = 16 >> s;
          const bool upper = (wl & mask) != 0;
#pragma unroll
          for (int q = 0; q < half; ++q) {
            const float send = upper ? vals[q] : vals[q + half];
            const float keep = upper ? vals[q + half] : vals[q];
            vals[q] = keep + __shfl_xor_sync(full, send, mask);
          }
        }
        const int sel = (wl >> 2) & 7;
        sm.red[t][warp][sel / NL][lane * NL + sel % NL] = vals[0];
        if (lane == 0) sm.sums[t][c] = make_float2(sb, sa);
      }
    };

    // the first half walked to its end (y on the way, its states kept in
    // shared memory), the second half's states recomputed into registers
    // and walked back, then the first half's
    float hmid[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) hmid[i] = hin[i];
#pragma unroll
    for (int t = 0; t < TH; ++t) {
      const float4 st = sm.step[t][c];
      float bv[NL], cv[NL];
      load_f32<NL>(bv, &sm.bf[t][lane * NL]);
      load_f32<NL>(cv, &sm.cf[t][lane * NL]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        hmid[i] = fmaf(ex2(st.x * a2[i]), hmid[i], st.y * bv[i]);
        acc = fmaf(hmid[i], cv[i], acc);
      }
      store_y(t, acc);
      sm.hfirst[t][tid] = make_float4(hmid[0], hmid[1], hmid[2], hmid[3]);
    }
    if (rows > TH) {
      recompute(TH, hmid);
      reverse(TH, hmid);
    }
#pragma unroll
    for (int j = 0; j < TH; ++j) {
      const float4 v = sm.hfirst[j][tid];
      hs[j][0] = v.x;
      hs[j][1] = v.y;
      hs[j][2] = v.z;
      hs[j][3] = v.w;
    }
    reverse(0, hin);
    __syncthreads();

    // once per (t, channel): the chunk's dx, ddt_raw and dz in rows, and
    // the sums of d(dt_bias) and dD; then its dB, dC partials
    for (int i = tid; i < TC * kBwdChannels; i += kBwdThreads) {
      const int t = i / kBwdChannels, cc = i % kBwdChannels;
      if (t >= rows || c0 + cc >= d) continue;
      const float4 st = sm.step[t][cc];
      const float2 sum = sm.sums[t][cc];
      const float xv = to_f32(sm.xs[slot][t][cc]);
      const float go = to_f32(sm.os[slot][t][cc]);
      const float ddt = (sum.y + xv * sum.x) * st.w;
      const long long o = ((long long)b * len + t0 + t) * d + c0 + cc;
      ((T*)p.dx)[o] = from_f32<T>(st.z * sm.dskip[cc] + st.x * sum.x);
      ((T*)p.ddt)[o] = from_f32<T>(ddt);
      ((T*)p.dz)[o] = from_f32<T>(
          go * (sm.ys[t][cc] + sm.dskip[cc] * xv) * sm.dsilu[t][cc]);
      acc_bias += ddt;
      acc_d += st.z * xv;
    }
    for (int i = tid; i < 2 * TC * kNMax; i += kBwdThreads) {
      const int which = i / (TC * kNMax), r = i % (TC * kNMax);
      const int t = r / kNMax, k2 = r % kNMax;
      if (t >= rows || k2 >= n) continue;
      float v = sm.red[t][0][which][k2];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) v += sm.red[t][w][which][k2];
      p.bc_part[((((long long)which * p.batch + b) * p.blocks + blk) * len +
                 t0 + t) * n + k2] = v;
    }
  }

  if (ch_in) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int k = lane * NL + i;
      if (k >= n) continue;
      p.da_part[state + k] = dA[i];
      if (p.dh0 != nullptr) p.dh0[state + k] = carry[i];
    }
  }
  // each channel's sums over the rows of threads, in order
  sm.acc[0][tid / kBwdChannels][tid % kBwdChannels] = acc_bias;
  sm.acc[1][tid / kBwdChannels][tid % kBwdChannels] = acc_d;
  __syncthreads();
  if (tid < kBwdChannels && c0 + tid < d) {
    float vb = sm.acc[0][0][tid], vd = sm.acc[1][0][tid];
#pragma unroll
    for (int r = 1; r < kRows; ++r) {
      vb += sm.acc[0][r][tid];
      vd += sm.acc[1][r][tid];
    }
    p.vec_part[(long long)b * d + c0 + tid] = vb;
    p.vec_part[((long long)p.batch + b) * d + c0 + tid] = vd;
  }
}

// Every partial folded in a fixed order: dB, dC over the blocks (rounded
// to T once), by blocks of kFoldOut outputs, each thread of a block summing
// every kFoldSplit-th partial of its output and the first thread the
// slices in order; dA_log, d(dt_bias), dD over the batch (float32), a
// thread an output, in the blocks after those.
template <typename T>
__global__ void __launch_bounds__(kFoldOut * kFoldSplit)
scan_bwd_fold(const BwdArgs p) {
  __shared__ float part[kFoldSplit][kFoldOut];
  const long long seq = (long long)p.batch * p.len * p.n;
  const long long dn = (long long)p.d * p.n;
  const long long bc_blocks = (2 * seq + kFoldOut - 1) / kFoldOut;
  if (blockIdx.x < bc_blocks) {
    const int o = threadIdx.x % kFoldOut, sl = threadIdx.x / kFoldOut;
    const long long i = (long long)blockIdx.x * kFoldOut + o;
    const int which = (int)(i / seq);
    const long long r = i % seq;
    float v = 0.f;
    if (i < 2 * seq) {
      const long long bb = r / ((long long)p.len * p.n);
      const long long tn = r % ((long long)p.len * p.n);
      const float* src = p.bc_part +
                         ((long long)which * p.batch + bb) * p.blocks *
                             p.len * p.n + tn;
      for (int blk = sl; blk < p.blocks; blk += kFoldSplit)
        v += src[(long long)blk * p.len * p.n];
    }
    part[sl][o] = v;
    __syncthreads();
    if (sl == 0 && i < 2 * seq) {
#pragma unroll
      for (int q = 1; q < kFoldSplit; ++q) v += part[q][o];
      ((T*)(which ? p.dcm : p.dbm))[r] = from_f32<T>(v);
    }
    return;
  }
  const long long j =
      (long long)(blockIdx.x - bc_blocks) * blockDim.x + threadIdx.x;
  if (j < dn) {
    float v = 0.f;
    for (int bb = 0; bb < p.batch; ++bb) v += p.da_part[bb * dn + j];
    p.da_log[j] = -expf(p.a_log[j]) * v;
  } else if (j < dn + 2 * (long long)p.d) {
    const long long jj = j - dn;
    const int which = (int)(jj / p.d);
    const long long q = jj % p.d;
    float v = 0.f;
    for (int bb = 0; bb < p.batch; ++bb)
      v += p.vec_part[((long long)which * p.batch + bb) * p.d + q];
    (which ? p.ddskip : p.ddt_bias)[q] = v;
  }
}

// Dynamic shared memory above 48 KB, with the SM's carveout at its largest.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// The main kernel's shared memory, above the 48 KB a block may hold
// statically, allowed so that kBwdBlocksPerSM blocks fit.  Returns its
// bytes, or minus the error.
template <typename T>
int bwd_smem_setup() {
  const int smem = (int)sizeof(BwdSmem<T>);
  const cudaError_t e = allow_smem(scan_bwd_kernel<T>, smem);
  return e == cudaSuccess ? smem : -(int)e;
}

template <typename T>
int launch_fold(const BwdArgs& p, cudaStream_t stream);

template <typename T>
int launch_bwd(BwdArgs& p, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  p.vx = copy_bytes(p.x, p.x_sb, p.x_st, p.d, es);
  p.vdt = copy_bytes(p.dt, p.dt_sb, p.dt_st, p.d, es);
  p.vb = copy_bytes(p.bm, p.b_sb, p.b_st, p.n, es);
  p.vc = copy_bytes(p.cm, p.c_sb, p.c_st, p.n, es);
  p.vz = copy_bytes(p.z, p.z_sb, p.z_st, p.d, es);
  p.vo = copy_bytes(p.dout, p.o_sb, p.o_st, p.d, es);
  const int smem = bwd_smem_setup<T>();
  if (smem < 0) return -smem;
  const dim3 grid(p.blocks, p.batch);
  scan_bwd_kernel<T><<<grid, kBwdThreads, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_fold<T>(p, stream);
}

// The fold of a backward's partials (either working type's): its second
// launch.
template <typename T>
int launch_fold(const BwdArgs& p, cudaStream_t stream) {
  const int threads = kFoldOut * kFoldSplit;
  const long long bc_blocks =
      (2LL * p.batch * p.len * p.n + kFoldOut - 1) / kFoldOut;
  const long long rest = (long long)p.d * p.n + 2LL * p.d;
  scan_bwd_fold<T><<<(unsigned)(bc_blocks + (rest + threads - 1) / threads),
                     threads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}



// ---------------------------------------------------------------------------
// the fused form with the bfloat16 working type (cfg.scan_dtype "bfloat16")
// ---------------------------------------------------------------------------

constexpr int kWChunkMax = 128;                 // the reference's chunk target
constexpr int kWPairs = kNMax / 2;              // lane pairs (n, n + 8)
constexpr int kWThreads = 32 * kWPairs;         // a warp a lane pair
// A chunk's kWChunkMax steps split over the threads of one warp: kWSeg
// steps each (segment j: steps kWSeg j ..), kWSegs threads a lane pair,
// kWGroup channels a warp (the pair 2 m, 2 m + 1; a lane a channel and
// segment); the tree's kWInner lowest levels run inside a thread, its
// kWOuter top ones between threads.
constexpr int kWSeg = 8, kWSegs = kWChunkMax / kWSeg, kWGroup = 32 / kWSegs;
constexpr int kWInner = 3, kWOuter = 4;
constexpr int kWFwdChannels = 16;               // forward: channels a block
constexpr int kWBwdGroups = kBwdChannels / kWGroup;
constexpr int kWFwdBlocksPerSM = 4, kWBwdBlocksPerSM = 2;
constexpr int kWPitch = kWChunkMax + 4;         // a row of steps: a warp's
                                                // 16-byte loads conflict-free
constexpr int kWRedPitch = kWChunkMax + 16;     // a row of the pairs' shares:
                                                // (t, channel) reads too
constexpr int kWAccPitch = kWChunkMax + 10;     // a row of dB or dC sums
constexpr unsigned kFull = 0xffffffffu;
static_assert((1 << kWInner) == kWSeg && (1 << kWOuter) == kWSegs &&
                  kWGroup == 2,
              "a warp: one channel pair, 16 segments of 8 steps");

// Two lanes' bfloat16 values in one word (the first in the low half), and
// the native operations on both: each rounds once from the exact product
// or sum, which for two bfloat16 operands is the float32 operation rounded
// to bfloat16 (float32 holds the exact product of two 8-bit significands,
// and a sum rounded to 24 bits and then to 8 cannot land on a tie that the
// exact sum missed); the library's probe entry holds the two to the same
// bits on the card, subnormals, infinities and NaN included.  No fused
// multiply-add: u_l a_r + u_r rounds twice, as the reference's op-by-op
// bfloat16 does.
__device__ __forceinline__ unsigned bmul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned badd2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float lo2(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi2(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One combine of the reference's scan, (a_l a_r, u_l a_r + u_r), into the
// right element (a, u); and its transpose, with the gradients (ga_r, gu_r)
// at the right element and the forward's a_l, u_l, a_r: g_a[l] += gA a_r,
// g_u[l] += gU a_r, g_a[r] = gA a_l + gU u_l (g_u[r] stays).
__device__ __forceinline__ void comb2(unsigned al, unsigned ul, unsigned& a,
                                      unsigned& u) {
  u = badd2(bmul2(ul, a), u);
  a = bmul2(al, a);
}
__device__ __forceinline__ void uncomb2(unsigned& gal, unsigned& gul,
                                        unsigned& gar, unsigned gur,
                                        unsigned al, unsigned ul,
                                        unsigned ar) {
  gal = badd2(gal, bmul2(gar, ar));
  gul = badd2(gul, bmul2(gur, ar));
  gar = badd2(bmul2(gar, al), bmul2(gur, ul));
}

// jax.lax.associative_scan's odd/even tree over a chunk of q steps, in
// place: the up-sweep's level l combines element r - 2^l into every r < q
// with r = -1 mod 2^(l+1); the down-sweep's level l, from the top, element
// pos - 2^l into every pos < q with pos = 2^l - 1 mod 2^(l+1) and pos >=
// 3 2^l - 1.  A level's combines touch disjoint elements, so any split of
// a level gives the same bits.  A lane pair's chunk lies in registers over
// kWSegs threads of a warp, kWGroup lanes apart: up2 runs the
// up-sweep's levels inside each segment, then those between segments'
// last elements (shuffles); apre keeps the last element's a before each
// level between segments (the backward's a_r there).
__device__ __forceinline__ void up2(unsigned (&a)[kWSeg],
                                    unsigned (&u)[kWSeg], int j, int q,
                                    unsigned (&apre)[kWOuter]) {
  constexpr int SEG = kWSeg;
  const int base = SEG * j;
#pragma unroll
  for (int l = 0; l < kWInner; ++l) {
    const int h = 1 << l;
#pragma unroll
    for (int r = 2 * h - 1; r < SEG; r += 2 * h)
      if (base + r < q) comb2(a[r - h], u[r - h], a[r], u[r]);
  }
#pragma unroll
  for (int s = 0; s < kWOuter; ++s) {
    const int h = 1 << s;
    const unsigned la = __shfl_up_sync(kFull, a[SEG - 1], kWGroup * h);
    const unsigned lu = __shfl_up_sync(kFull, u[SEG - 1], kWGroup * h);
    apre[s] = a[SEG - 1];
    if ((j + 1) % (2 * h) == 0 && SEG * (j + 1) <= q)
      comb2(la, lu, a[SEG - 1], u[SEG - 1]);
  }
}

// The down-sweep: its levels between segments' last elements, then those
// inside, where a segment's first combine of a level takes the previous
// segment's last element (pa, pu: final by then).
__device__ __forceinline__ void down2(unsigned (&a)[kWSeg],
                                      unsigned (&u)[kWSeg], int j, int q,
                                      unsigned& pa, unsigned& pu) {
  constexpr int SEG = kWSeg;
#pragma unroll
  for (int s = kWOuter - 1; s >= 0; --s) {
    const int h = 1 << s;
    const unsigned la = __shfl_up_sync(kFull, a[SEG - 1], kWGroup * h);
    const unsigned lu = __shfl_up_sync(kFull, u[SEG - 1], kWGroup * h);
    if ((j + 1) % (2 * h) == h && j + 1 >= 3 * h && SEG * (j + 1) <= q)
      comb2(la, lu, a[SEG - 1], u[SEG - 1]);
  }
  pa = __shfl_up_sync(kFull, a[SEG - 1], kWGroup);
  pu = __shfl_up_sync(kFull, u[SEG - 1], kWGroup);
  const int base = SEG * j;
#pragma unroll
  for (int l = kWInner - 1; l >= 0; --l) {
    const int h = 1 << l;
#pragma unroll
    for (int i = h - 1; i < SEG; i += 2 * h) {
      const int t = base + i;
      if (t >= 3 * h - 1 && t < q) {
        if (i >= h)
          comb2(a[i - h], u[i - h], a[i], u[i]);
        else
          comb2(pa, pu, a[i], u[i]);
      }
    }
  }
}

// Four consecutive floats of a shared row (16-byte aligned), and back.
__device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A channel's sum over its 16 states at step t from the pairs' shares
// (share p = term n + term n + 8, rows kWGroup * kWRedPitch apart), in the
// order of the butterfly xor 8, 4, 2, 1 over the states.
__device__ __forceinline__ float pairs_sum(const float* r) {
  constexpr int S = kWGroup * kWRedPitch;
  return __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[4 * S]),
                             __fadd_rn(r[2 * S], r[6 * S])),
                   __fadd_rn(__fadd_rn(r[S], r[5 * S]),
                             __fadd_rn(r[3 * S], r[7 * S])));
}

// Element (t, col) of sequence b of a (batch, len, cols) view in T, as
// float32; the address formed where it is read, so that no pointer stays
// live across the tree.
template <typename T>
__device__ __forceinline__ float ld_io(const void* v, long long sb,
                                       long long st, int b, long long t,
                                       int col) {
  return to_f32(((const T*)v)[b * sb + t * st + col]);
}

// The dt of the fused form (JAX's softplus of dt_raw + bias, replayed in
// T) of one (t, channel), from s = round_T(dt_raw + round_T(bias)).
template <typename T>
__device__ __forceinline__ float softplus_io(float s) {
  const float e = round_to<T>(expf(-fabsf(s)));
  return round_to<T>(fmaxf(s, 0.f) + round_to<T>(log1pf(e)));
}

// Shared memory of a forward block: the chunk's B and C in float32 ([n][t],
// zeros past n), dt and dt * x of each (channel, t) (dt's rows take y once
// a group's is summed), each lane pair's share of y, A and the state
// entering the chunk of each (channel, n).
struct __align__(16) WorkFwdSmem {
  float b[kNMax][kWPitch];
  float c[kNMax][kWPitch];
  float dt[kWFwdChannels][kWPitch];
  float dx[kWFwdChannels][kWPitch];
  float red[kWPairs][kWGroup][kWRedPitch];
  float a[kWFwdChannels][kNMax];
  float h[kWFwdChannels][kNMax];
};

// The forward: a block of kWFwdChannels channels in groups of a channel
// pair, a warp a lane pair (n, n + 8) of the group, a lane a (channel,
// segment) (see up2); Q is q where it is known at compile time (the chunk
// every path shape takes), else 0.  BOUND (the training path) also stores
// the float32 state entering every chunk of q steps, for the backward.
template <typename T, bool BOUND, int Q>
__global__ void __launch_bounds__(kWThreads, kWFwdBlocksPerSM)
scan_bf16_kernel(const Args p) {
  constexpr int SEG = kWSeg, G = kWGroup;
  extern __shared__ __align__(16) unsigned char work_smem[];
  WorkFwdSmem& sm = *reinterpret_cast<WorkFwdSmem*>(work_smem);
  const int q = Q ? Q : p.q;
  const int tid = threadIdx.x, pr = tid / 32, lane = tid % 32;
  const int c = lane % G, j = lane / G, base = SEG * j;
  const int b = blockIdx.y, c0 = blockIdx.x * kWFwdChannels;
  const int d = p.d, n = p.n, chunks = p.len / q;
  // a thread's (channel, n) of the block: A and the first state
  const int my_c = tid / kNMax, my_k = tid % kNMax, my_ch = c0 + my_c;
  const bool my_in = my_ch < d && my_k < n;
  sm.a[my_c][my_k] = my_in ? -expf(p.a[(long long)my_ch * n + my_k]) : 0.f;
  sm.h[my_c][my_k] = my_in && p.h0 != nullptr
                         ? p.h0[((long long)b * d + my_ch) * n + my_k]
                         : 0.f;

#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    const long long t0 = (long long)kc * q;
    __syncthreads();                 // the last chunk's y is out; h is in
    if (BOUND && my_in)
      p.bound[(((long long)b * chunks + kc) * d + my_ch) * n + my_k] =
          sm.h[my_c][my_k];
#pragma unroll 1
    for (int i = tid; i < q * kNMax; i += kWThreads) {
      const int t = i / kNMax, k = i % kNMax;
      const bool in = k < n;
      sm.b[k][t] = in ? ld_io<T>(p.bm, p.b_sb, p.b_st, b, t0 + t, k) : 0.f;
      sm.c[k][t] = in ? ld_io<T>(p.cm, p.c_sb, p.c_st, b, t0 + t, k) : 0.f;
    }
    // dt and dt * x once per (t, channel); zeros past d
#pragma unroll 1
    for (int i = tid; i < q * kWFwdChannels; i += kWThreads) {
      const int t = i / kWFwdChannels, cc = i % kWFwdChannels;
      const int ch = c0 + cc;
      float dl = 0.f, dx = 0.f;
      if (ch < d) {
        dl = softplus_io<T>(
            round_to<T>(ld_io<T>(p.dt, p.dt_sb, p.dt_st, b, t0 + t, ch) +
                        round_to<T>(p.dt_bias[ch])));
        dx = dl * ld_io<T>(p.x, p.x_sb, p.x_st, b, t0 + t, ch);
      }
      sm.dt[cc][t] = dl;
      sm.dx[cc][t] = dx;
    }
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < kWFwdChannels / G; ++g) {
      const int cc = g * G + c;
      const float a_lo = sm.a[cc][pr], a_hi = sm.a[cc][pr + kWPairs];
      // a = exp(dt A) and u = (dt x) B in float32, each rounded to bfloat16
      unsigned a[SEG], u[SEG];
#pragma unroll
      for (int i0 = 0; i0 < SEG; i0 += 4) {
        float dl[4], dx[4], bl[4], bh[4];
        ld4(dl, &sm.dt[cc][base + i0]);
        ld4(dx, &sm.dx[cc][base + i0]);
        ld4(bl, &sm.b[pr][base + i0]);
        ld4(bh, &sm.b[pr + kWPairs][base + i0]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          a[i0 + m] = pack2(expf(dl[m] * a_lo), expf(dl[m] * a_hi));
          u[i0 + m] = pack2(dx[m] * bl[m], dx[m] * bh[m]);
        }
      }
      unsigned apre[kWOuter], pa, pu;
      up2(a, u, j, q, apre);
      down2(a, u, j, q, pa, pu);
      // h_t = a_cum h + u_scan in float32 from the state entering the
      // chunk; the pair's share of y (its two terms added, the butterfly's
      // first level)
      const float h_lo = sm.h[cc][pr], h_hi = sm.h[cc][pr + kWPairs];
#pragma unroll
      for (int i0 = 0; i0 < SEG; i0 += 4) {
        float cl[4], chh[4], part[4];
        ld4(cl, &sm.c[pr][base + i0]);
        ld4(chh, &sm.c[pr + kWPairs][base + i0]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = i0 + m;
          const float hl = __fadd_rn(__fmul_rn(lo2(a[i]), h_lo), lo2(u[i]));
          const float hh = __fadd_rn(__fmul_rn(hi2(a[i]), h_hi), hi2(u[i]));
          part[m] = __fadd_rn(__fmul_rn(hl, cl[m]), __fmul_rn(hh, chh[m]));
          if (base + i == q - 1) {     // the state entering the next chunk
            sm.h[cc][pr] = hl;
            sm.h[cc][pr + kWPairs] = hh;
          }
        }
        st4(&sm.red[pr][c][base + i0], part);
      }
      __syncthreads();
      // y of the group's (t, channel): the pairs' shares summed
#pragma unroll 1
      for (int i = tid; i < q * G; i += kWThreads) {
        const int t = i / G, c2 = i % G;
        sm.dt[g * G + c2][t] = pairs_sum(&sm.red[0][c2][t]);
      }
      __syncthreads();                 // red is free
    }
    // the D skip and the gate, as the float32 instance takes them
#pragma unroll 1
    for (int i = tid; i < q * kWFwdChannels; i += kWThreads) {
      const int t = i / kWFwdChannels, cc = i % kWFwdChannels;
      const int ch = c0 + cc;
      if (ch >= d) continue;
      const long long tt = t0 + t;
      const float y = sm.dt[cc][t] +
                      p.dskip[ch] * ld_io<T>(p.x, p.x_sb, p.x_st, b, tt, ch);
      const float zf = ld_io<T>(p.z, p.z_sb, p.z_st, b, tt, ch);
      const float gate = __fdividef(zf, 1.f + __expf(-zf));
      ((T*)p.y)[((long long)b * p.len + tt) * d + ch] = from_f32<T>(y * gate);
    }
  }
  __syncthreads();
  if (my_in)
    p.h_out[((long long)b * d + my_ch) * n + my_k] = sm.h[my_c][my_k];
}

// The blocks of a kernel an SM holds with `bytes` of dynamic shared memory.
template <typename K>
cudaError_t occupancy(K kernel, int bytes, int* blocks) {
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kWThreads, bytes);
}

template <typename T, bool BOUND, int Q>
int launch_bf16_q(Args& p, long long batch, cudaStream_t stream) {
  const int smem = (int)sizeof(WorkFwdSmem);
  const cudaError_t e = allow_smem(scan_bf16_kernel<T, BOUND, Q>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.d + kWFwdChannels - 1) / kWFwdChannels, (unsigned)batch);
  scan_bf16_kernel<T, BOUND, Q><<<grid, kWThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool BOUND>
int launch_bf16(Args& p, long long batch, cudaStream_t stream) {
  return p.q == kWChunkMax
             ? launch_bf16_q<T, BOUND, kWChunkMax>(p, batch, stream)
             : launch_bf16_q<T, BOUND, 0>(p, batch, stream);
}

// Shared memory of a backward block (kBwdChannels channels, a warp's
// channels at a time): the chunk's B and C in float32 ([n][t]); a group's
// dt, dt * x and dy = dout silu(z) of each (channel, t), in two buffers
// taken in turns; each lane pair's share of y, sum_N ds A and sum_N du B;
// dB and dC over the block's channels so far ([n][acc_col(t)]: a warp's
// accesses to distinct banks); each thread's a before the up-sweep's
// levels between segments; A, the gradient carried into the chunk before,
// and dA of each (channel, n); each warp's sums of d(dt_bias) and dD of a
// group's channels; the bias (rounded to T) and D of each channel.
struct __align__(16) WorkBwdSmem {
  static constexpr int G = kWGroup;
  float b[kNMax][kWPitch];
  float c[kNMax][kWPitch];
  float dt[2][G][kWPitch];
  float dx[2][G][kWPitch];
  float dy[2][G][kWPitch];
  float red[3][kWPairs][G][kWRedPitch];
  float acc[2][kNMax][kWAccPitch];
  unsigned apre[kWOuter][kWThreads];
  float a[kBwdChannels][kNMax];
  float carry[kBwdChannels][kNMax];
  float da[kBwdChannels][kNMax];
  float part[2][kBwdChannels / G][kWPairs][G];
  float bias[kBwdChannels];
  float dskip[kBwdChannels];
};

// A step's column in a row of sums: a warp's 16 segments on distinct
// banks.
__device__ __forceinline__ int acc_col(int t) { return t + (t >> 4); }

// A lane's term and its neighbouring channel's (lane c ^ 1: the channel
// pair 2 m, 2 m + 1) summed, for the state the lane keeps: lo (state pr)
// on c = 0, hi (pr + kWPairs) on c = 1.
__device__ __forceinline__ float pair_channels(int c, float lo, float hi) {
  const float got = __shfl_xor_sync(kFull, c ? lo : hi, 1);
  return __fadd_rn(c ? hi : lo, got);
}

// The pair's dB or dC term w of step t of the lane's kept state added to
// the block's sum over its channels, in the pairs' order.
__device__ __forceinline__ void join_pair(float w, float (*acc)[kWAccPitch],
                                          int c, int pr, int t, int q,
                                          bool first) {
  if (t < q) {
    float& s = acc[pr + kWPairs * c][acc_col(t)];
    s = first ? w : __fadd_rn(s, w);
  }
}

// The backward: a block of kBwdChannels channels (its dB, dC partials,
// its dA_log, d(dt_bias), dD partials and their fold are the float32
// backward's), the chunks in reverse from the forward's boundaries, each
// chunk's channel pairs in turn with the forward's layout: a warp a lane
// pair, a lane a (channel, segment).
template <typename T, int Q>
__global__ void __launch_bounds__(kWThreads, kWBwdBlocksPerSM)
scan_bf16_bwd_kernel(const BwdArgs p) {
  constexpr int SEG = kWSeg, G = kWGroup, kGroups = kWBwdGroups;
  extern __shared__ __align__(16) unsigned char work_smem[];
  WorkBwdSmem& sm = *reinterpret_cast<WorkBwdSmem*>(work_smem);
  const int q = Q ? Q : p.q;
  const int tid = threadIdx.x, pr = tid / 32, lane = tid % 32;
  const int c = lane % G, j = lane / G, base = SEG * j;
  const int b = blockIdx.y, blk = blockIdx.x, c0 = blk * kBwdChannels;
  const int d = p.d, n = p.n, len = p.len, chunks = len / q;
#pragma unroll 1
  for (int i = tid; i < kBwdChannels * kNMax; i += kWThreads) {
    const int cc = i / kNMax, k = i % kNMax, ch = c0 + cc;
    const bool in = ch < d && k < n;
    sm.a[cc][k] = in ? -expf(p.a_log[(long long)ch * n + k]) : 0.f;
    sm.carry[cc][k] = in && p.dh_final != nullptr
                          ? p.dh_final[((long long)b * d + ch) * n + k]
                          : 0.f;
    sm.da[cc][k] = 0.f;
  }
#pragma unroll 1
  for (int i = tid; i < kBwdChannels; i += kWThreads) {
    const bool in = c0 + i < d;
    sm.bias[i] = in ? round_to<T>(p.dt_bias[c0 + i]) : 0.f;
    sm.dskip[i] = in ? p.dskip[c0 + i] : 0.f;
  }
#pragma unroll 1
  for (int i = tid; i < 2 * kGroups * kWPairs * G; i += kWThreads)
    (&sm.part[0][0][0][0])[i] = 0.f;

#pragma unroll 1
  for (int kc = chunks - 1; kc >= 0; --kc) {
    const long long t0 = (long long)kc * q;
#pragma unroll 1
    for (int g = 0; g < kGroups; ++g) {
      const int buf = g & 1;
      // the chunk's B and C (with its first group), and once per (t,
      // channel) of the group: dt (the forward's bfloat16 softplus
      // replay), dt * x and dy; zeros past d
      if (g == 0) {
#pragma unroll 1
        for (int i = tid; i < q * kNMax; i += kWThreads) {
          const int t = i / kNMax, k = i % kNMax;
          const bool in = k < n;
          sm.b[k][t] =
              in ? ld_io<T>(p.bm, p.b_sb, p.b_st, b, t0 + t, k) : 0.f;
          sm.c[k][t] =
              in ? ld_io<T>(p.cm, p.c_sb, p.c_st, b, t0 + t, k) : 0.f;
        }
      }
#pragma unroll 1
      for (int i = tid; i < q * G; i += kWThreads) {
        const int t = i / G, c2 = i % G;
        const int cc = g * G + c2, ch = c0 + cc;
        float dl = 0.f, dx = 0.f, dy = 0.f;
        if (ch < d) {
          const long long tt = t0 + t;
          dl = softplus_io<T>(round_to<T>(
              ld_io<T>(p.dt, p.dt_sb, p.dt_st, b, tt, ch) + sm.bias[cc]));
          dx = dl * ld_io<T>(p.x, p.x_sb, p.x_st, b, tt, ch);
          const float zf = ld_io<T>(p.z, p.z_sb, p.z_st, b, tt, ch);
          const float sz = __fdividef(1.f, 1.f + __expf(-zf));
          const float gate = zf * sz;
          dy = ld_io<T>(p.dout, p.o_sb, p.o_st, b, tt, ch) * gate;
        }
        sm.dt[buf][c2][t] = dl;
        sm.dx[buf][c2][t] = dx;
        sm.dy[buf][c2][t] = dy;
      }
      __syncthreads();

      {
        const int cc = g * G + c, ch = c0 + cc;
        const bool ch_in = ch < d;
        const float a_lo = sm.a[cc][pr], a_hi = sm.a[cc][pr + kWPairs];
        // the forward's a and u and its tree: a0 (level 0), (ua, uu) as
        // the up-sweep leaves them, (fa, fu) its outputs
        unsigned a0[SEG], ua[SEG], uu[SEG], fa[SEG], fu[SEG];
#pragma unroll
        for (int i0 = 0; i0 < SEG; i0 += 4) {
          float dl[4], dx[4], bl[4], bh[4];
          ld4(dl, &sm.dt[buf][c][base + i0]);
          ld4(dx, &sm.dx[buf][c][base + i0]);
          ld4(bl, &sm.b[pr][base + i0]);
          ld4(bh, &sm.b[pr + kWPairs][base + i0]);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            a0[i0 + m] = pack2(expf(dl[m] * a_lo), expf(dl[m] * a_hi));
            uu[i0 + m] = pack2(dx[m] * bl[m], dx[m] * bh[m]);
            ua[i0 + m] = a0[i0 + m];
          }
        }
        {
          unsigned apre[kWOuter], pa, pu;
          up2(ua, uu, j, q, apre);
#pragma unroll
          for (int s = 0; s < kWOuter; ++s) sm.apre[s][tid] = apre[s];
#pragma unroll
          for (int i = 0; i < SEG; ++i) {
            fa[i] = ua[i];
            fu[i] = uu[i];
          }
          down2(fa, fu, j, q, pa, pu);
        }

        // the states, y's shares and dC's terms; g = dL/dh_t (the carry
        // joins at the chunk's last step); the gradients of a_cum (g h_in)
        // and u_scan (g) rounded to bfloat16; this segment's sum of
        // g a_cum, in order
        unsigned ga[SEG], gu[SEG];
        {
          const float* bo =
              p.bound + (((long long)b * chunks + kc) * d + ch) * n;
          const float h_lo = ch_in && pr < n ? bo[pr] : 0.f;
          const float h_hi = ch_in && pr + kWPairs < n ? bo[pr + kWPairs]
                                                       : 0.f;
          const float cr_lo = sm.carry[cc][pr];
          const float cr_hi = sm.carry[cc][pr + kWPairs];
          float cs_lo = 0.f, cs_hi = 0.f;
#pragma unroll
          for (int i0 = 0; i0 < SEG; i0 += 4) {
            float dyv[4], cl[4], chh[4], part[4];
            ld4(dyv, &sm.dy[buf][c][base + i0]);
            ld4(cl, &sm.c[pr][base + i0]);
            ld4(chh, &sm.c[pr + kWPairs][base + i0]);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int i = i0 + m, t = base + i;
              float hl = 0.f, hh = 0.f, gl = 0.f, gh = 0.f;
              part[m] = 0.f;
              if (t < q) {
                hl = __fadd_rn(__fmul_rn(lo2(fa[i]), h_lo), lo2(fu[i]));
                hh = __fadd_rn(__fmul_rn(hi2(fa[i]), h_hi), hi2(fu[i]));
                part[m] =
                    __fadd_rn(__fmul_rn(hl, cl[m]), __fmul_rn(hh, chh[m]));
                gl = __fmul_rn(dyv[m], cl[m]);
                gh = __fmul_rn(dyv[m], chh[m]);
                if (t == q - 1) {
                  gl = __fadd_rn(gl, cr_lo);
                  gh = __fadd_rn(gh, cr_hi);
                }
                cs_lo = __fadd_rn(cs_lo, __fmul_rn(gl, lo2(fa[i])));
                cs_hi = __fadd_rn(cs_hi, __fmul_rn(gh, hi2(fa[i])));
              }
              ga[i] = pack2(__fmul_rn(gl, h_lo), __fmul_rn(gh, h_hi));
              gu[i] = pack2(gl, gh);
              // dC's terms dy h
              join_pair(pair_channels(c, __fmul_rn(dyv[m], hl),
                                      __fmul_rn(dyv[m], hh)),
                        sm.acc[1], c, pr, t, q, g == 0);
            }
            st4(&sm.red[0][pr][c][base + i0], part);
          }
          // the carry into the chunk before, sum_t g a_cum: the segments'
          // sums added by a butterfly over the segments (the last
          // segment's lane keeps a fixed order)
#pragma unroll
          for (int m = G; m < 32; m <<= 1) {
            cs_lo = __fadd_rn(cs_lo, __shfl_xor_sync(kFull, cs_lo, m));
            cs_hi = __fadd_rn(cs_hi, __shfl_xor_sync(kFull, cs_hi, m));
          }
          if (j == kWSegs - 1) {
            sm.carry[cc][pr] = cs_lo;
            sm.carry[cc][pr + kWPairs] = cs_hi;
          }
        }

        // the transposed tree: the down-sweep's combines from level 0 up
        // (a segment's first one of a level adds to the previous segment's
        // last element, sent there and added level by level), then the
        // up-sweep's from the top down, an a_r inside a segment rebuilt
        // from a0 by the forward's products
        const unsigned pa = __shfl_up_sync(kFull, fa[SEG - 1], G);
        const unsigned pu = __shfl_up_sync(kFull, fu[SEG - 1], G);
#pragma unroll
        for (int l = 0; l < kWInner; ++l) {
          const int h = 1 << l;
          unsigned ca = 0u, cu = 0u;
#pragma unroll
          for (int i = h - 1; i < SEG; i += 2 * h) {
            const int t = base + i;
            if (t >= 3 * h - 1 && t < q) {
              if (i >= h) {
                uncomb2(ga[i - h], gu[i - h], ga[i], gu[i], fa[i - h],
                        fu[i - h], ua[i]);
              } else {
                ca = bmul2(ga[i], ua[i]);
                cu = bmul2(gu[i], ua[i]);
                ga[i] = badd2(bmul2(ga[i], pa), bmul2(gu[i], pu));
              }
            }
          }
          const unsigned ra = __shfl_down_sync(kFull, ca, G);
          const unsigned ru = __shfl_down_sync(kFull, cu, G);
          if (SEG * (j + 1) + h - 1 < q) {
            ga[SEG - 1] = badd2(ga[SEG - 1], ra);
            gu[SEG - 1] = badd2(gu[SEG - 1], ru);
          }
        }
#pragma unroll
        for (int s = 0; s < kWOuter; ++s) {  // down-sweep between segments
          const int h = 1 << s, dl = G * h;
          const unsigned gA = __shfl_down_sync(kFull, ga[SEG - 1], dl);
          const unsigned gU = __shfl_down_sync(kFull, gu[SEG - 1], dl);
          const unsigned ar = __shfl_down_sync(kFull, ua[SEG - 1], dl);
          const unsigned al = __shfl_up_sync(kFull, fa[SEG - 1], dl);
          const unsigned ul = __shfl_up_sync(kFull, fu[SEG - 1], dl);
          const int r = j + h + 1;                  // the right, if j is left
          if (r % (2 * h) == h && r >= 3 * h && SEG * r <= q) {
            ga[SEG - 1] = badd2(ga[SEG - 1], bmul2(gA, ar));
            gu[SEG - 1] = badd2(gu[SEG - 1], bmul2(gU, ar));
          }
          if ((j + 1) % (2 * h) == h && j + 1 >= 3 * h && SEG * (j + 1) <= q)
            ga[SEG - 1] =
                badd2(bmul2(ga[SEG - 1], al), bmul2(gu[SEG - 1], ul));
        }
#pragma unroll
        for (int s = kWOuter - 1; s >= 0; --s) {  // up-sweep between them
          const int h = 1 << s, dl = G * h;
          const unsigned gA = __shfl_down_sync(kFull, ga[SEG - 1], dl);
          const unsigned gU = __shfl_down_sync(kFull, gu[SEG - 1], dl);
          const unsigned ar = __shfl_down_sync(kFull, sm.apre[s][tid], dl);
          const unsigned al = __shfl_up_sync(kFull, ua[SEG - 1], dl);
          const unsigned ul = __shfl_up_sync(kFull, uu[SEG - 1], dl);
          const int r = j + h + 1;
          if (r % (2 * h) == 0 && SEG * r <= q) {
            ga[SEG - 1] = badd2(ga[SEG - 1], bmul2(gA, ar));
            gu[SEG - 1] = badd2(gu[SEG - 1], bmul2(gU, ar));
          }
          if ((j + 1) % (2 * h) == 0 && SEG * (j + 1) <= q)
            ga[SEG - 1] =
                badd2(bmul2(ga[SEG - 1], al), bmul2(gu[SEG - 1], ul));
        }
#pragma unroll
        for (int l = kWInner - 1; l >= 0; --l) {  // up-sweep inside
          const int h = 1 << l;
#pragma unroll
          for (int r = 2 * h - 1; r < SEG; r += 2 * h) {
            if (base + r < q) {
              unsigned ar = a0[r];
#pragma unroll
              for (int j2 = 0; j2 < l; ++j2)
                ar = bmul2(ua[r - (1 << j2)], ar);
              // u at an even step is level 0's: formed again, not kept
              const int e = base + r - 1;
              const unsigned ul =
                  l > 0 ? uu[r - h]
                        : pack2(sm.dx[buf][c][e] * sm.b[pr][e],
                                sm.dx[buf][c][e] * sm.b[pr + kWPairs][e]);
              uncomb2(ga[r - h], gu[r - h], ga[r], gu[r], ua[r - h], ul, ar);
            }
          }
        }

        // da through exp (ds = da exp(dt A)), du through (dt x) B: this
        // segment's sum of dA terms, the pairs' shares of sum_N ds A and
        // sum_N du B, dB's terms du dt x
        float da_lo = 0.f, da_hi = 0.f;
#pragma unroll
        for (int i0 = 0; i0 < SEG; i0 += 4) {
          float dl[4], dx[4], bl[4], bh[4], sa[4], sb[4];
          ld4(dl, &sm.dt[buf][c][base + i0]);
          ld4(dx, &sm.dx[buf][c][base + i0]);
          ld4(bl, &sm.b[pr][base + i0]);
          ld4(bh, &sm.b[pr + kWPairs][base + i0]);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = i0 + m, t = base + i;
            float db_lo = 0.f, db_hi = 0.f;
            sa[m] = sb[m] = 0.f;
            if (t < q) {
              const float ds_lo = __fmul_rn(lo2(ga[i]), expf(dl[m] * a_lo));
              const float ds_hi = __fmul_rn(hi2(ga[i]), expf(dl[m] * a_hi));
              const float w_lo = lo2(gu[i]), w_hi = hi2(gu[i]);
              da_lo = __fadd_rn(da_lo, __fmul_rn(ds_lo, dl[m]));
              da_hi = __fadd_rn(da_hi, __fmul_rn(ds_hi, dl[m]));
              sa[m] =
                  __fadd_rn(__fmul_rn(ds_lo, a_lo), __fmul_rn(ds_hi, a_hi));
              sb[m] =
                  __fadd_rn(__fmul_rn(w_lo, bl[m]), __fmul_rn(w_hi, bh[m]));
              db_lo = __fmul_rn(w_lo, dx[m]);
              db_hi = __fmul_rn(w_hi, dx[m]);
            }
            join_pair(pair_channels(c, db_lo, db_hi), sm.acc[0], c, pr, t, q,
                      g == 0);
          }
          st4(&sm.red[1][pr][c][base + i0], sa);
          st4(&sm.red[2][pr][c][base + i0], sb);
        }
        // dA's sum, as the carry's
#pragma unroll
        for (int m = G; m < 32; m <<= 1) {
          da_lo = __fadd_rn(da_lo, __shfl_xor_sync(kFull, da_lo, m));
          da_hi = __fadd_rn(da_hi, __shfl_xor_sync(kFull, da_hi, m));
        }
        if (j == kWSegs - 1) {
          sm.da[cc][pr] = __fadd_rn(sm.da[cc][pr], da_lo);
          sm.da[cc][pr + kWPairs] = __fadd_rn(sm.da[cc][pr + kWPairs], da_hi);
        }
      }
      __syncthreads();

      // once per (t, channel) of the group: the channel's sums over N, dx,
      // d(dt_raw) and dz; each warp's sums of d(dt_bias) and dD
      {
        float acc_bias = 0.f, acc_d = 0.f;
#pragma unroll 1
        for (int i = tid; i < q * G; i += kWThreads) {
          const int t = i / G, c2 = i % G;
          const int cc = g * G + c2, ch = c0 + cc;
          if (ch >= d) continue;
          const float y = pairs_sum(&sm.red[0][0][c2][t]);
          const float sa = pairs_sum(&sm.red[1][0][c2][t]);
          const float sb = pairs_sum(&sm.red[2][0][c2][t]);
          const long long tt = t0 + t;
          const float s = round_to<T>(
              ld_io<T>(p.dt, p.dt_sb, p.dt_st, b, tt, ch) + sm.bias[cc]);
          const float sg = __fdividef(1.f, 1.f + __expf(-s));
          const float xv = ld_io<T>(p.x, p.x_sb, p.x_st, b, tt, ch);
          const float zf = ld_io<T>(p.z, p.z_sb, p.z_st, b, tt, ch);
          const float sz = __fdividef(1.f, 1.f + __expf(-zf));
          const float gate = zf * sz;
          const float go = ld_io<T>(p.dout, p.o_sb, p.o_st, b, tt, ch);
          const float dsl = sz + gate * (1.f - sz);
          const float dl = sm.dt[buf][c2][t], dyv = sm.dy[buf][c2][t];
          const float dskip = sm.dskip[cc];
          const float ddt = (sa + xv * sb) * sg;
          const long long o = ((long long)b * len + tt) * d + ch;
          ((T*)p.dx)[o] = from_f32<T>(dyv * dskip + dl * sb);
          ((T*)p.ddt)[o] = from_f32<T>(ddt);
          ((T*)p.dz)[o] = from_f32<T>(go * (y + dskip * xv) * dsl);
          acc_bias += ddt;
          acc_d += dyv * xv;
        }
        // a thread keeps one channel (tid % G): the warp's rows
#pragma unroll
        for (int m = G; m < 32; m <<= 1) {
          acc_bias += __shfl_xor_sync(kFull, acc_bias, m);
          acc_d += __shfl_xor_sync(kFull, acc_d, m);
        }
        if (lane < G) {
          sm.part[0][g][pr][lane] += acc_bias;
          sm.part[1][g][pr][lane] += acc_d;
        }
      }
      // the chunk's dB, dC partials, once its last group is in
      if (g == kGroups - 1) {
#pragma unroll 1
        for (int i = tid; i < 2 * q * kNMax; i += kWThreads) {
          const int which = i / (q * kNMax), r = i % (q * kNMax);
          const int t = r / kNMax, k = r % kNMax;
          if (k < n)
            p.bc_part[((((long long)which * p.batch + b) * p.blocks + blk) *
                           len + t0 + t) * n + k] =
                sm.acc[which][k][acc_col(t)];
        }
      }
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < kBwdChannels * kNMax; i += kWThreads) {
    const int cc = i / kNMax, k = i % kNMax, ch = c0 + cc;
    if (ch >= d || k >= n) continue;
    const long long state = ((long long)b * d + ch) * n + k;
    p.da_part[state] = sm.da[cc][k];
    if (p.dh0 != nullptr) p.dh0[state] = sm.carry[cc][k];
  }
  if (tid < kBwdChannels && c0 + tid < d) {
    const int g = tid / G, c2 = tid % G;
    float vb = sm.part[0][g][0][c2], vd = sm.part[1][g][0][c2];
#pragma unroll
    for (int w = 1; w < kWPairs; ++w) {
      vb += sm.part[0][g][w][c2];
      vd += sm.part[1][g][w][c2];
    }
    p.vec_part[(long long)b * d + c0 + tid] = vb;
    p.vec_part[((long long)p.batch + b) * d + c0 + tid] = vd;
  }
}

template <typename T, int Q>
int launch_bf16_bwd_q(BwdArgs& p, cudaStream_t stream) {
  const int smem = (int)sizeof(WorkBwdSmem);
  const cudaError_t e = allow_smem(scan_bf16_bwd_kernel<T, Q>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.blocks, p.batch);
  scan_bf16_bwd_kernel<T, Q><<<grid, kWThreads, smem, stream>>>(p);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  return launch_fold<T>(p, stream);
}

template <typename T>
int launch_bf16_bwd(BwdArgs& p, cudaStream_t stream) {
  return p.q == kWChunkMax ? launch_bf16_bwd_q<T, kWChunkMax>(p, stream)
                           : launch_bf16_bwd_q<T, 0>(p, stream);
}

// The native bfloat16 pair operations of the working type's tree beside
// the float32 operation rounded to bfloat16 (as the reference rounds it),
// on n pairs of packed operands: out[4 i ..] = the native product, the
// float32 product rounded, the native sum, the float32 sum rounded.
__global__ void bf16_ops_probe_kernel(const unsigned* a, const unsigned* b,
                                      unsigned* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned x = a[i], y = b[i];
  auto rounded = [](float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  };
  out[4 * i] = bmul2(x, y);
  out[4 * i + 1] = rounded(__fmul_rn(lo2(x), lo2(y)),
                           __fmul_rn(hi2(x), hi2(y)));
  out[4 * i + 2] = badd2(x, y);
  out[4 * i + 3] = rounded(__fadd_rn(lo2(x), lo2(y)),
                           __fadd_rn(hi2(x), hi2(y)));
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
  Args p = {};
  p.x = x;
  p.dt = dt;
  p.bm = bm;
  p.cm = cm;
  p.a = (const float*)a;
  p.h0 = (const float*)h0;
  p.h_out = (float*)h_out;
  p.y = y;
  p.x_sb = x_sb;
  p.x_st = x_st;
  p.dt_sb = dt_sb;
  p.dt_st = dt_st;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.len = (int)len;
  p.d = d;
  p.n = n;
  return dispatch<false>(p, batch, bf16, (cudaStream_t)stream);
}

// The fused Mamba1 form.  x, dt (dt_raw, before the bias), B, C and z:
// (batch, len, d) and (batch, len, n) views by their batch and time
// strides, all float32 or all bfloat16; a_log: (d, n), dt_bias and dskip:
// (d,), float32 contiguous; h0: (batch, d, n) float32 contiguous, NULL for
// zeros, or h_out itself; out: (batch, len, d) contiguous, x's type;
// h_out: (batch, d, n) float32 contiguous.  step: round dt * x to x's type
// (a one-step update).  bound: NULL, or (batch, ceil(len / 16), d, n)
// float32 contiguous, which then takes the state entering every 16 steps
// (what selective_scan_fused_bwd reads; not with step).  Limits as above.
int selective_scan_fused_fwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* z, const void* a_log, const void* dt_bias, const void* dskip,
    const void* h0, void* out, void* h_out, void* bound, long long x_sb,
    long long x_st, long long dt_sb, long long dt_st, long long b_sb,
    long long b_st, long long c_sb, long long c_st, long long z_sb,
    long long z_st, long long batch, long long len, int d, int n, int bf16,
    int step, void* stream) {
  if (bound != nullptr && step) return (int)cudaErrorInvalidValue;
  Args p = {};
  p.x = x;
  p.dt = dt;
  p.bm = bm;
  p.cm = cm;
  p.z = z;
  p.a = (const float*)a_log;
  p.dt_bias = (const float*)dt_bias;
  p.dskip = (const float*)dskip;
  p.h0 = (const float*)h0;
  p.h_out = (float*)h_out;
  p.bound = (float*)bound;
  p.y = out;
  p.x_sb = x_sb;
  p.x_st = x_st;
  p.dt_sb = dt_sb;
  p.dt_st = dt_st;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.z_sb = z_sb;
  p.z_st = z_st;
  p.len = (int)len;
  p.d = d;
  p.n = n;
  p.step = step;
  return dispatch<true>(p, batch, bf16, (cudaStream_t)stream);
}


// The backward of the fused form over a sequence (not a step).  x, dt
// (dt_raw), B, C, z and dout: views by their batch and time strides, all
// float32 or all bfloat16, as the forward's; a_log (d, n), dt_bias and
// dskip (d,), h0 and dh_final (batch, d, n) float32 contiguous, h0 and
// dh_final NULL for zeros; bound: the (batch, chunks, d, n) float32 states
// that selective_scan_fused_fwd wrote for these inputs (chunks =
// ceil(len / chunk)), never NULL.  Writes dx, ddt, dz (batch, len, d) and
// dB, dC (batch, len, n) contiguous in x's type, d(dt_bias), dD (d,),
// dA_log (d, n) and, when h0 is given, dh0 (batch, d, n) float32
// contiguous.  work: work_floats float32 elements, at least 2 * batch *
// blocks * len * n + batch * d * n + 2 * batch * d (blocks = ceil(d /
// channels)); chunk and channels must be kBwdChunk and kBwdChannels (else,
// with too small a workspace or no bound, cudaErrorInvalidValue).  Two
// launches: the reverse scan, then the fold of its partials.
int selective_scan_fused_bwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* z, const void* a_log, const void* dt_bias, const void* dskip,
    const void* h0, const void* dout, const void* dh_final,
    const void* bound, void* dx, void* ddt, void* dbm, void* dcm, void* dz,
    void* ddt_bias, void* ddskip, void* da_log, void* dh0, void* work,
    long long work_floats, long long x_sb, long long x_st,
    long long dt_sb, long long dt_st, long long b_sb, long long b_st,
    long long c_sb, long long c_st, long long z_sb, long long z_st,
    long long o_sb, long long o_st, long long batch, long long len, int d,
    int n, int chunk, int channels, int bf16, void* stream) {
  if (n < 1 || n > kNMax || chunk != kBwdChunk || channels != kBwdChannels ||
      batch < 1 || batch >= 65536 || len < 1 || d < 1 || bound == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdArgs p = {};
  p.x = x;
  p.dt = dt;
  p.bm = bm;
  p.cm = cm;
  p.z = z;
  p.dout = dout;
  p.a_log = (const float*)a_log;
  p.dt_bias = (const float*)dt_bias;
  p.dskip = (const float*)dskip;
  p.h0 = (const float*)h0;
  p.dh_final = (const float*)dh_final;
  p.bound = (const float*)bound;
  p.dx = dx;
  p.ddt = ddt;
  p.dbm = dbm;
  p.dcm = dcm;
  p.dz = dz;
  p.ddt_bias = (float*)ddt_bias;
  p.ddskip = (float*)ddskip;
  p.da_log = (float*)da_log;
  p.dh0 = (float*)dh0;
  p.x_sb = x_sb;
  p.x_st = x_st;
  p.dt_sb = dt_sb;
  p.dt_st = dt_st;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.z_sb = z_sb;
  p.z_st = z_st;
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.batch = (int)batch;
  p.len = (int)len;
  p.d = d;
  p.n = n;
  p.chunks = (int)((len + kBwdChunk - 1) / kBwdChunk);
  p.blocks = (d + kBwdChannels - 1) / kBwdChannels;
  if (work_floats < 2 * batch * p.blocks * len * n +
                        batch * (long long)d * n + 2 * batch * d)
    return (int)cudaErrorInvalidValue;
  float* w = (float*)work;
  p.bc_part = w;
  w += 2 * batch * p.blocks * len * n;
  p.da_part = w;
  w += batch * (long long)d * n;
  p.vec_part = w;
  return bf16 ? launch_bwd<__nv_bfloat16>(p, (cudaStream_t)stream)
              : launch_bwd<float>(p, (cudaStream_t)stream);
}

// The fused Mamba1 form with the bfloat16 working type over a sequence:
// arguments as selective_scan_fused_fwd's (no step), and q, the chunk of
// the reference's scan (1 <= q <= 128, dividing len).  bound: NULL, or
// (batch, len / q, d, n) float32 contiguous, which then takes the state
// entering every chunk (what selective_scan_fused_bf16_bwd reads).
int selective_scan_fused_bf16_fwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* z, const void* a_log, const void* dt_bias, const void* dskip,
    const void* h0, void* out, void* h_out, void* bound, long long x_sb,
    long long x_st, long long dt_sb, long long dt_st, long long b_sb,
    long long b_st, long long c_sb, long long c_st, long long z_sb,
    long long z_st, long long batch, long long len, int d, int n, int q,
    int bf16, void* stream) {
  if (n < 1 || n > kNMax || q < 1 || q > kWChunkMax || len % q != 0 ||
      batch < 1 || batch >= 65536 || d < 1)
    return (int)cudaErrorInvalidValue;
  Args p = {};
  p.x = x;
  p.dt = dt;
  p.bm = bm;
  p.cm = cm;
  p.z = z;
  p.a = (const float*)a_log;
  p.dt_bias = (const float*)dt_bias;
  p.dskip = (const float*)dskip;
  p.h0 = (const float*)h0;
  p.h_out = (float*)h_out;
  p.bound = (float*)bound;
  p.y = out;
  p.x_sb = x_sb;
  p.x_st = x_st;
  p.dt_sb = dt_sb;
  p.dt_st = dt_st;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.z_sb = z_sb;
  p.z_st = z_st;
  p.len = (int)len;
  p.d = d;
  p.n = n;
  p.q = q;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bound != nullptr)
    return bf16 ? launch_bf16<__nv_bfloat16, true>(p, batch, st)
                : launch_bf16<float, true>(p, batch, st);
  return bf16 ? launch_bf16<__nv_bfloat16, false>(p, batch, st)
              : launch_bf16<float, false>(p, batch, st);
}

// Its backward: arguments as selective_scan_fused_bwd's, with q in place
// of (chunk, channels) and bound the (batch, len / q, d, n) states that
// selective_scan_fused_bf16_fwd wrote; the same workspace (blocks of 32
// channels) and the same fold.
int selective_scan_fused_bf16_bwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* z, const void* a_log, const void* dt_bias, const void* dskip,
    const void* h0, const void* dout, const void* dh_final,
    const void* bound, void* dx, void* ddt, void* dbm, void* dcm, void* dz,
    void* ddt_bias, void* ddskip, void* da_log, void* dh0, void* work,
    long long work_floats, long long x_sb, long long x_st,
    long long dt_sb, long long dt_st, long long b_sb, long long b_st,
    long long c_sb, long long c_st, long long z_sb, long long z_st,
    long long o_sb, long long o_st, long long batch, long long len, int d,
    int n, int q, int bf16, void* stream) {
  if (n < 1 || n > kNMax || q < 1 || q > kWChunkMax || len % q != 0 ||
      batch < 1 || batch >= 65536 || d < 1 || bound == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdArgs p = {};
  p.x = x;
  p.dt = dt;
  p.bm = bm;
  p.cm = cm;
  p.z = z;
  p.dout = dout;
  p.a_log = (const float*)a_log;
  p.dt_bias = (const float*)dt_bias;
  p.dskip = (const float*)dskip;
  p.h0 = (const float*)h0;
  p.dh_final = (const float*)dh_final;
  p.bound = (const float*)bound;
  p.dx = dx;
  p.ddt = ddt;
  p.dbm = dbm;
  p.dcm = dcm;
  p.dz = dz;
  p.ddt_bias = (float*)ddt_bias;
  p.ddskip = (float*)ddskip;
  p.da_log = (float*)da_log;
  p.dh0 = (float*)dh0;
  p.x_sb = x_sb;
  p.x_st = x_st;
  p.dt_sb = dt_sb;
  p.dt_st = dt_st;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.z_sb = z_sb;
  p.z_st = z_st;
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.batch = (int)batch;
  p.len = (int)len;
  p.d = d;
  p.n = n;
  p.q = q;
  p.chunks = (int)(len / q);
  p.blocks = (d + kBwdChannels - 1) / kBwdChannels;
  if (work_floats < 2 * batch * p.blocks * len * n +
                        batch * (long long)d * n + 2 * batch * d)
    return (int)cudaErrorInvalidValue;
  float* w = (float*)work;
  p.bc_part = w;
  w += 2 * batch * p.blocks * len * n;
  p.da_part = w;
  w += batch * (long long)d * n;
  p.vec_part = w;
  return bf16 ? launch_bf16_bwd<__nv_bfloat16>(p, (cudaStream_t)stream)
              : launch_bf16_bwd<float>(p, (cudaStream_t)stream);
}

// The backward's main kernel as the card holds it: the dynamic shared
// memory of a block (bytes) and the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for bfloat16 (bf16 == 1)
// or float32 inputs.
int selective_scan_fused_bwd_occupancy(int bf16, int* smem_bytes,
                                       int* blocks_per_sm) {
  const int smem = bf16 ? bwd_smem_setup<__nv_bfloat16>()
                        : bwd_smem_setup<float>();
  if (smem < 0) return -smem;
  *smem_bytes = smem;
  return bf16 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, scan_bwd_kernel<__nv_bfloat16>,
                    kBwdThreads, smem)
              : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks_per_sm, scan_bwd_kernel<float>, kBwdThreads,
                    smem);
}

// The bfloat16 working type's kernels at the chunk every path shape takes
// (q = 128) as the card holds them: which 0 the forward, 1 its instance
// that keeps the chunk boundaries, 2 the backward's main kernel; the
// dynamic shared memory of a block (bytes) and the blocks an SM holds at
// once, for bfloat16 (bf16 == 1) or float32 inputs.
int selective_scan_fused_bf16_occupancy(int bf16, int which, int* smem_bytes,
                                        int* blocks_per_sm) {
  cudaError_t e;
  if (which == 2) {
    *smem_bytes = (int)sizeof(WorkBwdSmem);
    e = bf16 ? occupancy(scan_bf16_bwd_kernel<__nv_bfloat16, kWChunkMax>,
                         *smem_bytes, blocks_per_sm)
             : occupancy(scan_bf16_bwd_kernel<float, kWChunkMax>,
                         *smem_bytes, blocks_per_sm);
  } else {
    *smem_bytes = (int)sizeof(WorkFwdSmem);
    if (which == 1)
      e = bf16 ? occupancy(scan_bf16_kernel<__nv_bfloat16, true, kWChunkMax>,
                           *smem_bytes, blocks_per_sm)
               : occupancy(scan_bf16_kernel<float, true, kWChunkMax>,
                           *smem_bytes, blocks_per_sm);
    else
      e = bf16 ? occupancy(scan_bf16_kernel<__nv_bfloat16, false, kWChunkMax>,
                           *smem_bytes, blocks_per_sm)
               : occupancy(scan_bf16_kernel<float, false, kWChunkMax>,
                           *smem_bytes, blocks_per_sm);
  }
  return (int)e;
}

// n pairs of packed bfloat16 operands (two lanes a 32-bit word) through
// the native bfloat16 pair operations the working type's kernels use and
// through the float32 operation rounded to bfloat16: out (n, 4) words,
// the native product, the rounded float32 product, the native sum, the
// rounded float32 sum.
int selective_scan_bf16_ops_probe(const void* a, const void* b, void* out,
                                  long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  bf16_ops_probe_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>(
      (const unsigned*)a, (const unsigned*)b, (unsigned*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
