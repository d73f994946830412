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
//   _max_kernel of the same file.
//
// Bound: all are bound by bytes.  Every input value is read once and takes
// part in one comparison; one value per group (or per row of the gather
// form) goes out.  The design is one warp per group (or row): the lanes
// stride over the group's values, then fold with shuffles; lane 0 applies
// the guard and the divide.  The gather form runs one block per permutation
// row with a warp per group, up to 32 warps (they take the row's groups in
// turn when there are more), so that the dependent loads of the groups
// (permutation, then table) are in flight together; the warps' maxima fold
// through shared memory.  There is no padding of the group count to
// a block multiple: the ragged edge is masked by the `group < n_groups`
// test.
//
// Bit contract: min and max do not depend on the order of the fold, and the
// divide is a correctly rounded IEEE divide (`/` on double; `__fdiv_rn` on
// float), and max(., 1.0) is exact, so the results equal the plain PyTorch
// versions bit for bit.  The library is built with -fmad=false.  Inputs are
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

}  // extern "C"
