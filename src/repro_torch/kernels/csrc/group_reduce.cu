// Group-reduce kernels of the annealing engine's score (CUDA C++, sm_90a).
//
// group_min_scale: per communicator group, the minimum link bandwidth of an
//   (m, m) sub-matrix turned into a slowdown scale ref_bw / min, or 1.0 when
//   the minimum is not finite or not positive.  Replaces the Pallas kernel
//   group_min_scale / _min_scale_kernel of the JAX package's
//   kernels/group_reduce.py.
// group_max: row-wise maximum of an (n_rows, m) matrix.  Replaces group_max /
//   _max_kernel of the same file.
//
// Bound: both are bound by bytes.  Every input value is read once and takes
// part in one comparison; one value per group goes out.  The design is one
// warp per group (or row): the lanes stride over the group's contiguous
// values, so neighbouring lanes read neighbouring addresses, then fold with
// shuffles; lane 0 applies the guard and the divide.  There is no padding of
// the group count to a block multiple: the ragged edge is masked by the
// `group < n_groups` test.  Nothing is staged in shared memory, because no
// value is used twice.
//
// Bit contract: min and max do not depend on the order of the fold, and the
// divide is a correctly rounded IEEE divide (`/` on double; `__fdiv_rn` on
// float), so the results equal the plain PyTorch versions bit for bit.  The
// library is built with -fmad=false.  Inputs are NaN-free by contract (the
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
