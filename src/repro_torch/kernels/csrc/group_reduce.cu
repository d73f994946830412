// Group-reduce kernels of the annealing engine's score (CUDA C++, sm_90a).
//
// group_min_scale: per communicator group, the minimum link bandwidth of an
//   (m, m) sub-matrix turned into a slowdown scale ref_bw / min, or 1.0 when
//   the minimum is not finite or not positive.  Replaces the Pallas kernel
//   group_min_scale / _min_scale_kernel of the JAX package's
//   kernels/group_reduce.py.  It has two addressings of one fold:
//   - the sub form takes the gathered (n_groups, m, m) sub-matrices;
//   - the gather form, which the annealing engine calls, takes the (n, n)
//     bandwidth table, a (rows, width) permutation and the group geometry,
//     and per row folds every group's scale into max(., 1.0).  Group
//     gi = (a, t), a = gi / inner, t = gi % inner, has member j at
//     perm[row, a * outer + t + j * step]; its sub-matrix is
//     table[member i, member j], read in place and never written out.  One
//     launch replaces gather + sub kernel + amax + clamp_min.
// group_max: row-wise maximum of an (n_rows, m) matrix.  Replaces group_max /
//   _max_kernel of the same file.  It too has a gather form, which the
//   annealing engine's tiered score calls: it takes the (n,) per-GPU
//   slowdowns, a (rows, pp * nc) permutation and the (rows, pp) stage
//   weights, and per row writes c_x[s] = cw[s] * max_j slow[perm[s * nc + j]]
//   and c_max = max_s c_x[s].  One launch replaces the gather, the row-max
//   kernel, the multiply and amax.
//
// Bound: all are bound by bytes.  Every input value is read once and takes
// part in one comparison; one value per group (or per row of the gather
// form) goes out.  The design is one warp per group (or row): the lanes
// stride over the group's values, then fold with shuffles; lane 0 applies
// the guard and the divide.  The gather form runs one block per permutation
// row with a warp per group, up to 32 warps (they take the row's groups in
// turn when there are more), so that the dependent loads of the groups
// (permutation, then table) are in flight together; the warps' maxima fold
// through shared memory.  The gather form of group_max has the same layout:
// one block per row, a warp per stage, lanes over the stage's nc members
// (the slowdown vector is a few KB and stays in L1/L2), and lane 0 applies
// the stage weight.  There is no padding of the group count to
// a block multiple: the ragged edge is masked by the `group < n_groups`
// test.
//
// Bit contract: min and max do not depend on the order of the fold, the
// divide is a correctly rounded IEEE divide (`/` on double; `__fdiv_rn` on
// float), the stage weight is one correctly rounded multiply, and
// max(., 1.0) is exact, so the results equal the plain PyTorch versions bit
// for bit.  The library is built with -fmad=false.  Inputs are
// NaN-free by contract (the
// bandwidth and slowdown matrices the engine gathers from hold no NaN):
// fmin/fmax would drop a NaN where torch.amin/amax propagate it.
//
// Plain C interface for ctypes: each function launches on the given stream,
// does not synchronise, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxGatherWarps = 32;      // a block of the gather form
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ double rn_div(double a, double b) { return a / b; }
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T inf_of();
template <>
__device__ __forceinline__ double inf_of<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <>
__device__ __forceinline__ float inf_of<float>() {
  return __int_as_float(0x7f800000);
}

template <typename T>
__global__ void min_scale_kernel(const T* __restrict__ sub, T ref_bw,
                                 T* __restrict__ out, long long n_groups,
                                 int mm) {
  const long long group =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (group >= n_groups) return;  // whole warp leaves together
  const T* g = sub + group * (long long)mm;
  T v = inf_of<T>();
  for (int i = lane; i < mm; i += kWarp) v = fmin(v, g[i]);
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmin(v, __shfl_down_sync(kFullMask, v, off));
  if (lane == 0) {
    const bool ok = isfinite(v) && v > T(0);
    out[group] = ok ? rn_div(ref_bw, v) : T(1);
  }
}

// One block per permutation row: max over the row's groups of the group's
// min scale, clamped below at 1.0.
template <typename T>
__global__ void gather_min_scale_kernel(const T* __restrict__ table,
                                        long long n_tab,
                                        const long long* __restrict__ perm,
                                        long long width, T ref_bw,
                                        T* __restrict__ out, int n_groups,
                                        int m, int inner, int outer,
                                        int step) {
  __shared__ T warp_max[kMaxGatherWarps];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const long long* row = perm + (long long)blockIdx.x * width;
  const int mm = m * m;
  T best = -inf_of<T>();
  for (int gi = warp; gi < n_groups; gi += n_warps) {
    const long long* g = row + (long long)(gi / inner) * outer + gi % inner;
    T v = inf_of<T>();
    for (int e = lane; e < mm; e += kWarp) {
      const int i = e / m, j = e - i * m;
      v = fmin(v, table[g[i * step] * n_tab + g[j * step]]);
    }
    for (int off = kWarp / 2; off > 0; off >>= 1)
      v = fmin(v, __shfl_xor_sync(kFullMask, v, off));
    const bool ok = isfinite(v) && v > T(0);
    best = fmax(best, ok ? rn_div(ref_bw, v) : T(1));
  }
  if (lane == 0) warp_max[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    T r = warp_max[0];
    for (int w = 1; w < n_warps; ++w) r = fmax(r, warp_max[w]);
    out[blockIdx.x] = fmax(r, T(1));
  }
}

template <typename T>
__global__ void row_max_kernel(const T* __restrict__ vals,
                               T* __restrict__ out, long long n_rows, int m) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;
  const T* r = vals + row * (long long)m;
  T v = -inf_of<T>();
  for (int i = lane; i < m; i += kWarp) v = fmax(v, r[i]);
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmax(v, __shfl_down_sync(kFullMask, v, off));
  if (lane == 0) out[row] = v;
}

// One block per permutation row: per stage s (a warp each, warps taking
// stages in turn when pp > 32) the largest member slowdown times the stage
// weight, and the row's largest such product.
template <typename T>
__global__ void gather_max_kernel(const T* __restrict__ slow,
                                  const long long* __restrict__ perm,
                                  const T* __restrict__ cw,
                                  T* __restrict__ c_x, T* __restrict__ c_max,
                                  int pp, int nc) {
  __shared__ T warp_max[kMaxGatherWarps];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const long long first = (long long)blockIdx.x * pp;   // row's first stage
  T best = -inf_of<T>();
  for (int s = warp; s < pp; s += n_warps) {
    const long long* g = perm + (first + s) * nc;
    T v = -inf_of<T>();
    for (int j = lane; j < nc; j += kWarp) v = fmax(v, slow[g[j]]);
    for (int off = kWarp / 2; off > 0; off >>= 1)
      v = fmax(v, __shfl_xor_sync(kFullMask, v, off));
    const T c = cw[first + s] * v;
    if (lane == 0) c_x[first + s] = c;
    best = fmax(best, c);
  }
  if (lane == 0) warp_max[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    T r = warp_max[0];
    for (int w = 1; w < n_warps; ++w) r = fmax(r, warp_max[w]);
    c_max[blockIdx.x] = r;
  }
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline unsigned gather_threads(int n_groups) {
  return (unsigned)(kWarp * (n_groups < kMaxGatherWarps ? n_groups
                                                         : kMaxGatherWarps));
}

}  // namespace

extern "C" {

int group_min_scale_f64(const void* sub, double ref_bw, void* out,
                        long long n_groups, int mm, void* stream) {
  min_scale_kernel<double>
      <<<blocks_for(n_groups), kWarp * kWarpsPerBlock, 0,
         (cudaStream_t)stream>>>((const double*)sub, ref_bw, (double*)out,
                                 n_groups, mm);
  return (int)cudaGetLastError();
}

int group_min_scale_f32(const void* sub, double ref_bw, void* out,
                        long long n_groups, int mm, void* stream) {
  min_scale_kernel<float>
      <<<blocks_for(n_groups), kWarp * kWarpsPerBlock, 0,
         (cudaStream_t)stream>>>((const float*)sub, (float)ref_bw,
                                 (float*)out, n_groups, mm);
  return (int)cudaGetLastError();
}

// table: (n_tab, n_tab); perm: (rows, width) int64 entries in [0, n_tab);
// out: (rows,).  Every group position a * outer + t + j * step lies in
// [0, width) (the wrapper checks it).
int group_min_scale_gather_f64(const void* table, long long n_tab,
                               const void* perm, long long rows,
                               long long width, double ref_bw, void* out,
                               int n_groups, int m, int inner, int outer,
                               int step, void* stream) {
  gather_min_scale_kernel<double>
      <<<(unsigned)rows, gather_threads(n_groups), 0, (cudaStream_t)stream>>>(
          (const double*)table, n_tab, (const long long*)perm, width, ref_bw,
          (double*)out, n_groups, m, inner, outer, step);
  return (int)cudaGetLastError();
}

int group_min_scale_gather_f32(const void* table, long long n_tab,
                               const void* perm, long long rows,
                               long long width, double ref_bw, void* out,
                               int n_groups, int m, int inner, int outer,
                               int step, void* stream) {
  gather_min_scale_kernel<float>
      <<<(unsigned)rows, gather_threads(n_groups), 0, (cudaStream_t)stream>>>(
          (const float*)table, n_tab, (const long long*)perm, width,
          (float)ref_bw, (float*)out, n_groups, m, inner, outer, step);
  return (int)cudaGetLastError();
}

int group_max_f64(const void* vals, void* out, long long n_rows, int m,
                  void* stream) {
  row_max_kernel<double>
      <<<blocks_for(n_rows), kWarp * kWarpsPerBlock, 0,
         (cudaStream_t)stream>>>((const double*)vals, (double*)out, n_rows,
                                 m);
  return (int)cudaGetLastError();
}

int group_max_f32(const void* vals, void* out, long long n_rows, int m,
                  void* stream) {
  row_max_kernel<float>
      <<<blocks_for(n_rows), kWarp * kWarpsPerBlock, 0,
         (cudaStream_t)stream>>>((const float*)vals, (float*)out, n_rows, m);
  return (int)cudaGetLastError();
}

// slow: (n,); perm: (rows, pp * nc) int64 entries in [0, n); cw, c_x:
// (rows, pp); c_max: (rows,).  rows >= 1, pp >= 1, nc >= 1.
int group_max_gather_f64(const void* slow, const void* perm, const void* cw,
                         void* c_x, void* c_max, long long rows, int pp,
                         int nc, void* stream) {
  gather_max_kernel<double>
      <<<(unsigned)rows, gather_threads(pp), 0, (cudaStream_t)stream>>>(
          (const double*)slow, (const long long*)perm, (const double*)cw,
          (double*)c_x, (double*)c_max, pp, nc);
  return (int)cudaGetLastError();
}

int group_max_gather_f32(const void* slow, const void* perm, const void* cw,
                         void* c_x, void* c_max, long long rows, int pp,
                         int nc, void* stream) {
  gather_max_kernel<float>
      <<<(unsigned)rows, gather_threads(pp), 0, (cudaStream_t)stream>>>(
          (const float*)slow, (const long long*)perm, (const float*)cw,
          (float*)c_x, (float*)c_max, pp, nc);
  return (int)cudaGetLastError();
}

}  // extern "C"
