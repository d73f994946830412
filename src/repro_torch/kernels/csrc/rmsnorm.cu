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
//   dw = sum over rows of dy * (x * r), in float32, cast to w's type.
// Bound: bytes (x, dy, ds_in read once, dx written once).  One cooperative
// launch of at most 128 blocks, all resident at once on the H100's 132
// SMs.  Block b owns one run of consecutive rows; the split depends only
// on the row count (rows / blocks rows a run, the first rows % blocks runs
// one longer), so dw's bits do not depend on the card.
//   - The ring: a block's rows stream through shared memory, each row's x,
//     dy (and ds) staged by TMA bulk copies (cp.async.bulk) that complete
//     on the stage's mbarrier, while the next rows' bytes are in flight.
//     Both sums and the dx pass read the staged row, so x, dy and ds cross
//     HBM once; each thread reads its packs of w once, into registers;
//     dx leaves in 16-byte packs.
//   - Latency, not bytes, bounds one row of a few thousand columns: a row
//     is a chain of shared loads, a warp reduction and a barrier.  So
//     where a row is at most 4096 wide and four rings fit, a block is four
//     groups of 128 threads, each on a consecutive quarter of the run with
//     its own ring and named barrier, and four rows are in work at once.
//   - r stays the forward's: a thread reads the packs the forward's thread
//     of the same index sums, in the same order, and the row's sum folds
//     as norm_kernel's does (the shuffle, then the four warp partials).
//     The other products (the dot, dx, the dw terms) have no bits to match
//     and fold into fused multiply-adds, a third fewer instructions a row.
//   - dw: each thread keeps its columns' sums, its group's rows in order,
//     in registers (64 with one group, rows up to 8192 wide; 32 with
//     four); the groups' sums are added in group order into the block's
//     partial row.  After a grid-wide sync each block folds a slice of the
//     columns over the blocks' partial rows in block order (cut into runs
//     of at most 16 blocks where the slice is narrow, the runs then added
//     in order) and writes dw.  No atomics: the same inputs give the same
//     bits, launch after launch and under a CUDA-graph replay.
//   - Rows of a ragged width, behind an unaligned pointer, or wider than
//     the ring takes, go through the same launch without it: one group a
//     block, each row read from global memory for the sums and again
//     (from L2) for dx, element by element where the packs do not fit,
//     the dw sums growing in the block's partial row.

// Plain C interface for ctypes: launches on the given stream, does not
// synchronise, allocates nothing, returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Most blocks of the backward's grid: under the H100's 132 SMs, so that its
// cooperative launch finds every block resident.  The wrapper passes
// min(rows, kMaxBlocks).
constexpr int kMaxBlocks = 128;
// Groups of kThreads threads a block in the ring's four-group instances.
constexpr int kMaxGroups = 4;
constexpr int kMaxStages = 8;
// Dynamic shared memory the ring may take: the 227 KB a block may opt in
// to, less room for the kernel's static shared memory (2,560 bytes).
constexpr int kSmemBudget = 232448 - 3072;

// dw sums a thread keeps in registers: 64 with one group (rows up to 8192
// wide), 32 with four (up to 4096), where 512 threads leave 128 registers
// a thread.
template <int kGroups>
__host__ __device__ constexpr int reg_elems() {
  return kGroups == 1 ? 64 : 32;
}

struct BwdArgs {
  const void* x;
  const void* w;
  const void* dy;
  const void* ds;  // null: no ds_in
  void* dx;
  void* dw;
  float* partial;  // (blocks, d) float32: each block's dw sums
  long long rows;
  int d;
  int blocks;
  int stages;      // rows each group's ring holds (ring instances)
  float eps;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// The issuing thread's arrival, and the bytes the stage's copies will
// complete: the phase ends when they have all landed.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// The kThreads threads of group g meet at named barrier 1 + g.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(kThreads) : "memory");
}

// (r, r^3 * mean(x*g)) of a group's row i from each thread's float32 sums:
// the sum of squares folds as norm_kernel folds it (the shuffle, then the
// four warp partials in order), so r is the forward's.  One barrier a row:
// every thread then folds the partials itself, from slots that alternate
// with the row (a warp writes row i + 2's only after the group has passed
// row i + 1's barrier, and so has read row i's).  `at_barrier` runs in the
// group's first thread right after the barrier.
template <typename F>
__device__ __forceinline__ float2 row_coefs(float ss, float dot, int d,
                                            float eps, int g, int i,
                                            F&& at_barrier) {
  __shared__ float partial[kMaxGroups][2][2][kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(kFullMask, ss, o);
    dot += __shfl_xor_sync(kFullMask, dot, o);
  }
  float(*slot)[kThreads / 32] = partial[g][i & 1];
  const int t = threadIdx.x % kThreads;
  if ((t & 31) == 0) {
    slot[0][t >> 5] = ss;
    slot[1][t >> 5] = dot;
  }
  group_sync(g);
  if (t == 0) at_barrier();
  float tss = 0.f, tdot = 0.f;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    tss += slot[0][k];
    tdot += slot[1][k];
  }
  const float r = rsqrtf(tss / (float)d + eps);
  return make_float2(r, r * r * r * (tdot / (float)d));
}

// One pack of dx = r*g - x*c3 (+ e), g = w*dy, rounded once to x's type,
// and its dw terms dy*(x*r) added to `acc`.  Nothing here has to match
// another kernel's bits, so the products fold into fused multiply-adds.
template <typename TX, typename TW, int kVec>
__device__ __forceinline__ Pack<TX, kVec> dx_pack(
    const Pack<TX, kVec> a, const Pack<TX, kVec> g, const Pack<TW, kVec> c,
    const Pack<TX, kVec>* e, float r, float c3, float (&acc)[kVec]) {
  Pack<TX, kVec> o;
  Pack<TX, kVec> ev;
  if (e) ev = *e;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float x = to_f32(a.v[k]), dy = to_f32(g.v[k]);
    float v = fmaf(r, to_f32(c.v[k]) * dy, -(x * c3));
    if (e) v += to_f32(ev.v[k]);
    o.v[k] = from_f32<TX>(v);
    acc[k] = fmaf(dy, x * r, acc[k]);
  }
  return o;
}

// Phase one of a pack: the sum of squares as norm_kernel sums it (a product,
// then an add: no contraction, so r is the forward's) and the dot x.(w*dy).
template <typename TX, typename TW, int kVec>
__device__ __forceinline__ void sums_pack(const Pack<TX, kVec> a,
                                          const Pack<TX, kVec> g,
                                          const Pack<TW, kVec> c, float& ss,
                                          float& dot) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float v = to_f32(a.v[k]);
    ss += v * v;
    dot = fmaf(v, to_f32(c.v[k]) * to_f32(g.v[k]), dot);
  }
}

// The ring: a block's rows r0 .. r0 + n - 1, of 16-byte packs, cut into
// kGroups consecutive sub-runs, one a group of kThreads threads (rows up to
// kThreads * reg_elems<kGroups>() wide).  Shared memory holds each group's
// `stages` (2 to kMaxStages) row stages of x, dy (and ds), each filled by
// one TMA bulk copy an array and waited for on its mbarrier.  A group
// issues its row i + stages - 1 into the stage its row i - 1 left, after
// row i's barrier (by which the group is done with row i - 1).  Each
// thread keeps its packs of w, read once, and its columns' dw sums over
// its group's rows, in order, in registers; the groups' sums are then
// added in group order into the block's partial row.
template <typename TX, typename TW, int kVec, int kGroups>
__device__ __forceinline__ void staged_rows(const BwdArgs& a, long long r0,
                                            int n, float* prow) {
  using PX = Pack<TX, kVec>;
  using PW = Pack<TW, kVec>;
  using PF = Pack<float, kVec>;
  constexpr int kRegPacks = reg_elems<kGroups>() / kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned long long full[kMaxGroups * kMaxStages];
  const int g = threadIdx.x / kThreads, t = threadIdx.x % kThreads;
  const int d = a.d, packs = d / kVec, stages = a.stages;
  const int arrays = a.ds ? 3 : 2;
  const unsigned row_bytes = (unsigned)(packs * sizeof(PX));
  PX* ring = reinterpret_cast<PX*>(smem);
  PX* mine = ring + (size_t)g * stages * arrays * packs;
  unsigned long long* bars = full + g * kMaxStages;
  // the group's sub-run
  const int base = n / kGroups, extra = n % kGroups;
  const long long g0 = r0 + g * base + (g < extra ? g : extra);
  const int gn = base + (g < extra ? 1 : 0);

  auto issue = [&](int i) {
    if (i >= gn) return;
    const int st = i % stages;
    PX* dst = mine + (size_t)st * arrays * packs;
    const long long off = (g0 + i) * packs;
    mbar_expect(&bars[st], arrays * row_bytes);
    bulk_load(dst, reinterpret_cast<const PX*>(a.x) + off, row_bytes,
              &bars[st]);
    bulk_load(dst + packs, reinterpret_cast<const PX*>(a.dy) + off,
              row_bytes, &bars[st]);
    if (a.ds)
      bulk_load(dst + 2 * packs, reinterpret_cast<const PX*>(a.ds) + off,
                row_bytes, &bars[st]);
  };
  if (t == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i + 1 < stages; ++i) issue(i);
  }
  PW wv[kRegPacks];
  float acc[kRegPacks][kVec];
#pragma unroll
  for (int j = 0; j < kRegPacks; ++j) {
    const int p = t + j * kThreads;
    if (p < packs) wv[j] = reinterpret_cast<const PW*>(a.w)[p];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[j][k] = 0.f;
  }
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < gn; ++i) {
    mbar_wait(&bars[i % stages], (unsigned)(i / stages) & 1u);
    const PX* xs = mine + (size_t)(i % stages) * arrays * packs;
    const PX* gs = xs + packs;
    const PX* es = a.ds ? xs + 2 * packs : nullptr;
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < kRegPacks; ++j) {
      const int p = t + j * kThreads;
      if (p >= packs) break;
      const PX xv = xs[p], gv = gs[p];  // one 16-byte load each
      sums_pack<TX, TW, kVec>(xv, gv, wv[j], ss, dot);
    }
    const float2 rc = row_coefs(ss, dot, d, a.eps, g, i,
                                [&] { issue(i + stages - 1); });
    PX* out = reinterpret_cast<PX*>(a.dx) + (g0 + i) * packs;
#pragma unroll
    for (int j = 0; j < kRegPacks; ++j) {
      const int p = t + j * kThreads;
      if (p >= packs) break;
      const PX xv = xs[p], gv = gs[p];
      out[p] = dx_pack<TX, TW, kVec>(xv, gv, wv[j], es ? es + p : nullptr,
                                     rc.x, rc.y, acc[j]);
    }
  }
  // every group is past its last row: the ring holds the groups' sums,
  // added in group order into the block's partial row
  __syncthreads();
  PF* sums = reinterpret_cast<PF*>(ring);
#pragma unroll
  for (int j = 0; j < kRegPacks; ++j) {
    const int p = t + j * kThreads;
    if (p >= packs) break;
    PF f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) f.v[k] = acc[j][k];
    sums[(size_t)g * packs + p] = f;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < packs; p += kThreads * kGroups) {
    PF f = sums[p];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) {
      const PF h = sums[(size_t)q * packs + p];
#pragma unroll
      for (int k = 0; k < kVec; ++k) f.v[k] += h.v[k];
    }
    reinterpret_cast<PF*>(prow)[p] = f;
  }
}

// Without the ring (one group): each row read from global memory for the
// sums and again for dx; the dw sums grow in the block's partial row (each
// thread its own columns, rows in order).
template <typename TX, typename TW, int kVec>
__device__ __forceinline__ void direct_rows(const BwdArgs& a, long long r0,
                                            int n, float* prow) {
  using PX = Pack<TX, kVec>;
  using PW = Pack<TW, kVec>;
  using PF = Pack<float, kVec>;
  const int t = threadIdx.x, packs = a.d / kVec;
  const PW* wr = reinterpret_cast<const PW*>(a.w);
  PF* pr = reinterpret_cast<PF*>(prow);
  for (int i = 0; i < n; ++i) {
    const long long off = (r0 + i) * packs;
    const PX* xr = reinterpret_cast<const PX*>(a.x) + off;
    const PX* gr = reinterpret_cast<const PX*>(a.dy) + off;
    const PX* er = a.ds ? reinterpret_cast<const PX*>(a.ds) + off : nullptr;
    float ss = 0.f, dot = 0.f;
    for (int p = t; p < packs; p += kThreads) {
      const PX xv = xr[p], gv = gr[p];
      const PW c = wr[p];
      sums_pack<TX, TW, kVec>(xv, gv, c, ss, dot);
    }
    const float2 rc = row_coefs(ss, dot, a.d, a.eps, 0, i, [] {});
    PX* out = reinterpret_cast<PX*>(a.dx) + off;
    for (int p = t; p < packs; p += kThreads) {
      float f[kVec];
      if (i == 0) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) f[k] = 0.f;
      } else {
        const PF h = pr[p];
#pragma unroll
        for (int k = 0; k < kVec; ++k) f[k] = h.v[k];
      }
      const PX xv = xr[p], gv = gr[p];
      const PW c = wr[p];
      out[p] = dx_pack<TX, TW, kVec>(xv, gv, c, er ? er + p : nullptr, rc.x,
                                     rc.y, f);
      PF h;
#pragma unroll
      for (int k = 0; k < kVec; ++k) h.v[k] = f[k];
      pr[p] = h;
    }
  }
}

// Sum of partial rows b0 .. b1 - 1 at one column, in block order; the loads
// go out 16 at a time.
__device__ __forceinline__ float sum_blocks(const float* partial, int d,
                                            int col, int b0, int b1) {
  float acc = 0.f;
  int b = b0;
  for (; b + 16 <= b1; b += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = __ldcg(partial + (long long)(b + k) * d + col);
#pragma unroll
    for (int k = 0; k < 16; ++k) acc += v[k];
  }
  for (; b < b1; ++b) acc += __ldcg(partial + (long long)b * d + col);
  return acc;
}

// dw from the blocks' partial rows, by the T threads of each block.  Block
// b folds columns [b*C, b*C + C), C = ceil(d / blocks).  Where C < T the
// block order is cut into `parts` runs of at most 16 consecutive blocks,
// one thread a (part, column), and the parts' sums are added in order.
// The order depends on (blocks, d, T) alone.
template <typename TW, int T>
__device__ __forceinline__ void fold_dw(const float* partial, TW* dw,
                                        int blocks, int d) {
  __shared__ float sums[kThreads * kMaxGroups];
  const int t = threadIdx.x;
  const int cols = (d + blocks - 1) / blocks;
  const int c0 = blockIdx.x * cols;
  const int c1 = min(d, c0 + cols);
  if (c0 >= c1) return;
  if (cols >= T) {
    for (int c = c0 + t; c < c1; c += T)
      dw[c] = from_f32<TW>(sum_blocks(partial, d, c, 0, blocks));
    return;
  }
  const int parts = min(T / cols, (blocks + 15) / 16);
  const int q = t / cols, col = c0 + t - q * cols;
  if (q < parts && col < c1) {
    const int base = blocks / parts, extra = blocks % parts;
    const int b0 = q * base + min(q, extra);
    sums[t] = sum_blocks(partial, d, col, b0, b0 + base + (q < extra));
  }
  __syncthreads();
  if (t < c1 - c0) {
    float acc = 0.f;
    for (int k = 0; k < parts; ++k) acc += sums[k * cols + t];
    dw[c0 + t] = from_f32<TW>(acc);
  }
}

// Block b's run: rows / blocks rows, the first rows % blocks runs one more.
// Launched cooperatively: the grid-wide sync needs every block resident.
template <typename TX, typename TW, int kVec, int kGroups, bool kStaged>
__global__ void __launch_bounds__(kThreads* kGroups, 1)
    norm_bwd(const BwdArgs a) {
  const long long b = blockIdx.x;
  const long long base = a.rows / a.blocks, extra = a.rows % a.blocks;
  const long long r0 = b * base + (b < extra ? b : extra);
  const int n = (int)(base + (b < extra ? 1 : 0));
  float* prow = a.partial + b * a.d;
  if constexpr (kStaged)
    staged_rows<TX, TW, kVec, kGroups>(a, r0, n, prow);
  else
    direct_rows<TX, TW, kVec>(a, r0, n, prow);
  cg::this_grid().sync();
  fold_dw<TW, kThreads * kGroups>(a.partial, reinterpret_cast<TW*>(a.dw),
                                  a.blocks, a.d);
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

template <typename TX, typename TW, int kVec, int kGroups, bool kStaged>
int launch_one_bwd(BwdArgs a, size_t smem, cudaStream_t stream) {
  const void* fn = (const void*)norm_bwd<TX, TW, kVec, kGroups, kStaged>;
  if constexpr (kStaged) {
    // once per instance, before any CUDA-graph capture (the first call of
    // a shape is eager): allow the ring's dynamic shared memory
    static const cudaError_t configured = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (configured != cudaSuccess) return (int)configured;
  }
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(a.blocks), dim3(kThreads * kGroups), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Row stages a group's ring can hold (0: not two), at most kMaxStages and
// no more than its rows need, two at least.
inline int ring_stages(const BwdArgs& a, size_t stage, int groups) {
  long long stages = (long long)((size_t)kSmemBudget / (stage * groups));
  if (stages < 2) return 0;
  const long long run = (a.rows + a.blocks - 1) / a.blocks;
  const long long need = (run + groups - 1) / groups;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages > need) stages = need < 2 ? 2 : need;
  return (int)stages;
}

// Packed rows take the ring: four groups where a row is at most 4096 wide
// and four groups' two stages fit, one group up to 8192 wide; the
// unstaged instances otherwise.  The choice depends on the shape, the
// types and the pointers' alignment, never on the card.
template <typename TX, typename TW>
int launch_bwd(BwdArgs a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool packed = a.d % kVec == 0 && aligned(a.x, 16) &&
                      aligned(a.dy, 16) && aligned(a.dx, 16) &&
                      aligned(a.w, sizeof(TW) * kVec) &&
                      (!a.ds || aligned(a.ds, 16));
  if (packed) {
    const size_t stage = (size_t)(a.ds ? 3 : 2) * a.d * sizeof(TX);
    if (a.d <= kThreads * reg_elems<kMaxGroups>()) {
      a.stages = ring_stages(a, stage, kMaxGroups);
      if (a.stages)
        return launch_one_bwd<TX, TW, kVec, kMaxGroups, true>(
            a, kMaxGroups * a.stages * stage, stream);
    }
    if (a.d <= kThreads * reg_elems<1>()) {
      a.stages = ring_stages(a, stage, 1);
      if (a.stages)
        return launch_one_bwd<TX, TW, kVec, 1, true>(a, a.stages * stage,
                                                     stream);
    }
    return launch_one_bwd<TX, TW, kVec, 1, false>(a, 0, stream);
  }
  return launch_one_bwd<TX, TW, 1, 1, false>(a, 0, stream);
}

}  // namespace

extern "C" {

// x, dy, ds (null: none), dx: (rows, d) contiguous, x's type; w, dw: (d,),
// w's type; work: a float32 workspace of blocks * d values (each block's dw
// sums).  x is the norm's input (the stored sum s for the residual form).
// blocks: min(rows, 128), the wrapper's split.
int rmsnorm_bwd(const void* x, const void* w, const void* dy, const void* ds,
                void* dx, void* dw, void* work, long long rows, int d,
                double eps, int types, int blocks, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks || blocks > rows || d < 1)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, w, dy, ds, dx, dw, (float*)work, rows, d, blocks, 0,
                  (float)eps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (types) {
    case 0:
      return launch_bwd<float, float>(a, st);
    case 1:
      return launch_bwd<__nv_bfloat16, float>(a, st);
    case 2:
      return launch_bwd<float, __nv_bfloat16>(a, st);
    default:
      return launch_bwd<__nv_bfloat16, __nv_bfloat16>(a, st);
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
