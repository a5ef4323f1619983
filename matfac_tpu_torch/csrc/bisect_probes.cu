// Toolchain probes on Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the five Pallas TPU kernels of scripts/tpu_pallas_bisect.py,
// which bisected which Pallas construct a TPU compile helper refused. Each
// probe here is one small kernel that exercises the CUDA counterpart of its
// construct and computes the same function:
//   1 add_one_kernel        (:49)  x + 1, elementwise, one grid-stride pass
//   2 grid_matmul_kernel    (:59)  a @ b over a grid of blocks, each owning
//                                  a band of output rows (BlockSpec tiling)
//   3 batch_update_kernel   (:80)  tab + the bf16-rounded gradient rows
//                                  scatter-added by row id, summed in f32 (the
//                                  one-hot matmul of the TPU's batch update)
//   4 prefetch_double_kernel (:96) 2 x each block of x, reached through a
//                                  permutation the kernel reads itself (scalar
//                                  prefetch)
//   5 slice_loop_kernel     (:115) a copy of x, then + 1 on each of its row
//                                  slices in a loop inside one block
//                                  (fori_loop over dynamic slices)
// What bounds them: each moves at most a few hundred KB (microseconds at
// 3.35 TB/s) and the launch itself dominates; they exist to show that the
// toolchain builds and runs each construct, not to be fast. Every result is
// computed in one fixed order per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
add_one_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    out[i] = x[i] + 1.f;
}

// Block b computes rows [b * rows, (b + 1) * rows) of out = a @ b, each
// element summed over d = 0..K-1 in order.
__global__ void __launch_bounds__(kThreads)
grid_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int K, int N, int rows) {
  const size_t r0 = static_cast<size_t>(blockIdx.x) * rows;
  for (int idx = threadIdx.x; idx < rows * N; idx += kThreads) {
    const size_t r = r0 + idx / N;
    const int c = idx % N;
    float acc = 0.f;
    for (int d = 0; d < K; ++d)
      acc = fmaf(a[r * K + d], b[static_cast<size_t>(d) * N + c], acc);
    out[r * N + c] = acc;
  }
}

// out[r] = tab[r] + sum over slots s with ids[s] == r of bf16(g[s]), the sum
// in f32 in slot order (ids outside [0, rows) touch nothing).
__global__ void __launch_bounds__(kThreads)
batch_update_kernel(const int* __restrict__ ids, const float* __restrict__ g,
                    const float* __restrict__ tab, float* __restrict__ out,
                    int bs, int rows, int k) {
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < rows * k;
       idx += gridDim.x * kThreads) {
    const int r = idx / k, d = idx % k;
    float acc = 0.f;
    for (int s = 0; s < bs; ++s)
      if (ids[s] == r)
        acc += __bfloat162float(
            __float2bfloat16_rn(g[static_cast<size_t>(s) * k + d]));
    out[idx] = tab[idx] + acc;
  }
}

// Block t doubles block sel[t] of x (blk floats each).
__global__ void __launch_bounds__(kThreads)
prefetch_double_kernel(const int* __restrict__ sel, const float* __restrict__ x,
                       float* __restrict__ out, int blk) {
  const size_t base = static_cast<size_t>(sel[blockIdx.x]) * blk;
  for (int i = threadIdx.x; i < blk; i += kThreads)
    out[base + i] = x[base + i] * 2.f;
}

// One block: out = x, then out's slice j (rows x cols) + 1, j in order.
__global__ void __launch_bounds__(kThreads)
slice_loop_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int n_slices, int slice) {
  for (int i = threadIdx.x; i < n_slices * slice; i += kThreads) out[i] = x[i];
  __syncthreads();
  for (int j = 0; j < n_slices; ++j) {
    float* s = out + static_cast<size_t>(j) * slice;
    for (int i = threadIdx.x; i < slice; i += kThreads) s[i] = s[i] + 1.f;
    __syncthreads();
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1024 ? (b < 1 ? 1 : b) : 1024);
}

}  // namespace

extern "C" {

// Each entry launches its probe on `stream` and returns the launch's
// cudaError_t. Pointers are device pointers of contiguous f32 / int32 data.

int probe_add_one(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  add_one_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}

// a [M, K] @ b [K, N] into out [M, N], M / rows blocks.
int probe_grid_matmul(const void* a, const void* b, void* out, int M, int K,
                      int N, int rows, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || rows <= 0 || M % rows)
    return cudaErrorInvalidValue;
  grid_matmul_kernel<<<M / rows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), K, N, rows);
  return cudaGetLastError();
}

// ids [bs] int32, g [bs, k], tab and out [rows, k].
int probe_batch_update(const void* ids, const void* g, const void* tab,
                       void* out, int bs, int rows, int k, void* stream) {
  if (bs <= 0 || rows <= 0 || k <= 0) return cudaErrorInvalidValue;
  batch_update_kernel<<<blocks_for(1LL * rows * k), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(g),
      static_cast<const float*>(tab), static_cast<float*>(out), bs, rows, k);
  return cudaGetLastError();
}

// sel [nb] int32, a permutation of the nb blocks of x and out (blk floats).
int probe_prefetch_double(const void* sel, const void* x, void* out, int nb,
                          int blk, void* stream) {
  if (nb <= 0 || blk <= 0) return cudaErrorInvalidValue;
  prefetch_double_kernel<<<nb, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sel), static_cast<const float*>(x),
      static_cast<float*>(out), blk);
  return cudaGetLastError();
}

// x and out hold n_slices slices of `slice` floats.
int probe_slice_loop(const void* x, void* out, int n_slices, int slice,
                     void* stream) {
  if (n_slices <= 0 || slice <= 0) return cudaErrorInvalidValue;
  slice_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n_slices,
      slice);
  return cudaGetLastError();
}

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
