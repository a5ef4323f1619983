// The ordered scatter's device code and its launch, shared by
// ordered_scatter.cu (the C entry ordered_scatter, whose top comment gives
// the design) and sgd_step.cu (the sgd engine's fused batch step, which
// scatters its two gradient buffers by the batch's staged plans).
//
// launch<T, I>(...) enqueues ordered_scatter_kernel on a stream and
// returns cudaGetLastError(); it allocates nothing and does not
// synchronise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;     // warps a block, one position of the plan each
constexpr int kAhead = 16;    // source rows loaded before their adds
constexpr unsigned kFull = 0xffffffffu;

// the table's type T and the type its sums are taken in (PyTorch's opmath)
template <typename T> struct Num;
template <> struct Num<float> {
  using A = float;
  static __device__ __forceinline__ A up(float x) { return x; }
  static __device__ __forceinline__ float down(A x) { return x; }
};
template <> struct Num<double> {
  using A = double;
  static __device__ __forceinline__ A up(double x) { return x; }
  static __device__ __forceinline__ double down(A x) { return x; }
};
template <> struct Num<__nv_bfloat16> {
  using A = float;
  static __device__ __forceinline__ A up(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 down(A x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Num<__half> {
  using A = float;
  static __device__ __forceinline__ A up(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half down(A x) {
    return __float2half_rn(x);
  }
};

// V adjacent values of T, loaded and stored as one vector
template <typename T, int V> struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* row, int c,
                                           long long col_stride) {
  if constexpr (V == 1) {
    Pack<T, 1> p;
    p.v[0] = row[static_cast<long long>(c) * col_stride];
    return p;
  } else {
    return *reinterpret_cast<const Pack<T, V>*>(row + c);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* row, int c, long long col_stride,
                                      const Pack<T, V>& p) {
  if constexpr (V == 1) {
    row[static_cast<long long>(c) * col_stride] = p.v[0];
  } else {
    *reinterpret_cast<Pack<T, V>*>(row + c) = p;
  }
}

// One group of 32 plan positions from m: whether each lane's position is
// in the run of `row`, and its source position (0 outside the run).
template <typename I>
__device__ __forceinline__ void plan_group(const I* __restrict__ order,
                                           const I* __restrict__ rows,
                                           long long n, long long m,
                                           int lane, long long row, bool& in,
                                           long long& o) {
  const long long p = m + lane;
  const bool ok = p < n;
  const long long r = ok ? static_cast<long long>(rows[p]) : -1;
  const long long op = ok ? static_cast<long long>(order[p]) : 0;
  in = ok && r == row;
  o = in ? op : 0;
}

template <typename T, typename I, int V>
__global__ void __launch_bounds__(kWarps * 32)
    ordered_scatter_kernel(T* __restrict__ table, const T* __restrict__ src,
                           const I* __restrict__ order,
                           const I* __restrict__ rows, long long n,
                           long long n_rows, int k, long long t_row,
                           long long t_col, long long s_row,
                           long long s_col) {
  using N = Num<T>;
  using A = typename N::A;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n) return;
  // the run's first group, the head test and the previous row, loaded at
  // once (the head's row is lane 0's)
  const long long p0 = j + lane;
  const long long r0 = p0 < n ? static_cast<long long>(rows[p0]) : -1;
  const long long o0 = p0 < n ? static_cast<long long>(order[p0]) : 0;
  const long long prev = j > 0 ? static_cast<long long>(rows[j - 1]) : -1;
  const long long row = __shfl_sync(kFull, r0, 0);
  if (j > 0 && prev == row) return;   // not the head of its run
  if (row < 0 || row >= n_rows) __trap();
  T* trow = table + row * t_row;
  for (int c0 = 0; c0 < k; c0 += 32 * V) {
    const int c = c0 + lane * V;
    const bool on = c < k;
    A acc[V];
    if (on) {
      const Pack<T, V> t = load<T, V>(trow, c, t_col);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = N::up(t.v[e]);
    }
    bool in = r0 == row && p0 < n;
    long long o = in ? o0 : 0;
    for (long long m = j;; m += 32) {
      const unsigned mask = __ballot_sync(kFull, in);
      // rows ascend, so the run's positions in this group are a prefix
      const int cnt = mask == kFull ? 32 : __ffs(~mask) - 1;
      // the next group's plan, loaded while this group's rows are added
      bool in_next = false;
      long long o_next = 0;
      if (cnt == 32)
        plan_group(order, rows, n, m + 32, lane, row, in_next, o_next);
      for (int q = 0; q < cnt; q += kAhead) {
        Pack<T, V> g[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long s = __shfl_sync(kFull, o, (q + u) & 31);
          if (on && q + u < cnt) g[u] = load<T, V>(src + s * s_row, c, s_col);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (on && q + u < cnt) {
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[e] = N::up(N::down(acc[e] + N::up(g[u].v[e])));
          }
        }
      }
      if (cnt < 32) break;
      in = in_next;
      o = o_next;
    }
    if (on) {
      Pack<T, V> t;
#pragma unroll
      for (int e = 0; e < V; ++e) t.v[e] = N::down(acc[e]);
      store<T, V>(trow, c, t_col, t);
    }
  }
}

// The widest V (values a lane) that is a power of two, at most 16 bytes,
// no wider than a warp needs for k columns, and that the strides and the
// two base addresses allow; 1 where the columns are not contiguous.
int vector_width(int esize, int k, long long t_row, long long t_col,
                 long long s_row, long long s_col, const void* table,
                 const void* src) {
  if (t_col != 1 || s_col != 1) return 1;
  int v = 1;
  while (v * esize < 16 && 32 * v < k) v *= 2;
  const auto tp = reinterpret_cast<uintptr_t>(table);
  const auto sp = reinterpret_cast<uintptr_t>(src);
  while (v > 1 && (k % v || t_row % v || s_row % v ||
                   tp % (static_cast<uintptr_t>(v) * esize) ||
                   sp % (static_cast<uintptr_t>(v) * esize)))
    v /= 2;
  return v;
}

template <typename T, typename I, int V>
void launch_v(void* table, const void* src, const void* order,
              const void* rows, long long n, long long n_rows, int k,
              long long t_row, long long t_col, long long s_row,
              long long s_col, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  ordered_scatter_kernel<T, I, V><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<T*>(table), static_cast<const T*>(src),
      static_cast<const I*>(order), static_cast<const I*>(rows), n, n_rows, k,
      t_row, t_col, s_row, s_col);
}

template <typename T, typename I>
int launch(void* table, const void* src, const void* order, const void* rows,
           long long n, long long n_rows, int k, long long t_row,
           long long t_col, long long s_row, long long s_col,
           cudaStream_t stream) {
  const int v = vector_width(sizeof(T), k, t_row, t_col, s_row, s_col, table,
                             src);
  switch (v) {
    case 1:
      launch_v<T, I, 1>(table, src, order, rows, n, n_rows, k, t_row, t_col,
                        s_row, s_col, stream);
      break;
    case 2:
      launch_v<T, I, 2>(table, src, order, rows, n, n_rows, k, t_row, t_col,
                        s_row, s_col, stream);
      break;
    case 4:
      if constexpr (sizeof(T) <= 4)
        launch_v<T, I, 4>(table, src, order, rows, n, n_rows, k, t_row,
                          t_col, s_row, s_col, stream);
      break;
    case 8:
      if constexpr (sizeof(T) <= 2)
        launch_v<T, I, 8>(table, src, order, rows, n, n_rows, k, t_row,
                          t_col, s_row, s_col, stream);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(int index_bytes, void* table, const void* src, const void* order,
             const void* rows, long long n, long long n_rows, int k,
             long long t_row, long long t_col, long long s_row,
             long long s_col, cudaStream_t stream) {
  if (index_bytes == 4)
    return launch<T, int32_t>(table, src, order, rows, n, n_rows, k, t_row,
                              t_col, s_row, s_col, stream);
  return launch<T, int64_t>(table, src, order, rows, n, n_rows, k, t_row,
                            t_col, s_row, s_col, stream);
}

}  // namespace
