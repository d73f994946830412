// Mamba1 selective scan, forward (CUDA C++, sm_90a), in two forms.
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
// them, and no other thread touches them.
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
  void* y;                  // float32 (plain) or x's type (fused)
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st, z_sb, z_st;
  int len, d, n;
  int vx, vdt, vb, vc, vz;  // copy width of each view: 16, 4 or 0 bytes
  int step;
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
// channels (their N/L states each).
template <typename T, bool FUSED>
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

template <typename T, bool FUSED>
int launch(Args& p, long long batch, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  p.vx = copy_bytes(p.x, p.x_sb, p.x_st, p.d, es);
  p.vdt = copy_bytes(p.dt, p.dt_sb, p.dt_st, p.d, es);
  p.vb = copy_bytes(p.bm, p.b_sb, p.b_st, p.n, es);
  p.vc = copy_bytes(p.cm, p.c_sb, p.c_st, p.n, es);
  p.vz = FUSED ? copy_bytes(p.z, p.z_sb, p.z_st, p.d, es) : 0;
  const dim3 grid((p.d + kChannels - 1) / kChannels, (unsigned)batch);
  scan_kernel<T, FUSED>
      <<<grid, kChannels * kLanes / kPerThread, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(Args& p, long long batch, int bf16, cudaStream_t stream) {
  if (p.n < 1 || p.n > kNMax) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16, FUSED>(p, batch, stream)
              : launch<float, FUSED>(p, batch, stream);
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
// (a one-step update).  Limits as above.
int selective_scan_fused_fwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* z, const void* a_log, const void* dt_bias, const void* dskip,
    const void* h0, void* out, void* h_out, long long x_sb, long long x_st,
    long long dt_sb, long long dt_st, long long b_sb, long long b_st,
    long long c_sb, long long c_st, long long z_sb, long long z_st,
    long long batch, long long len, int d, int n, int bf16, int step,
    void* stream) {
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

}  // extern "C"
