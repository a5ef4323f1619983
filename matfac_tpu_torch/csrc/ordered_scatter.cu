// Scatter-add in a fixed order on Hopper (sm_90a), CUDA C++ on the CUDA
// cores: the route of ops/scatter.index_add_ordered_ on a CUDA tensor.
//
// Replaces no Pallas kernel. The JAX engines sum a batch's colliding rows
// with `.at[].add`, which is XLA's scatter-add (matfac_tpu/solvers/sgd.py,
// solvers/bpr.py, ...), not a kernel of the JAX package. The port added
// this kernel because PyTorch's one fixed-order route, index_put_(
// accumulate=True), sorts its indices again on every call and pays
// advanced indexing's dispatch on the host, while the scatter engines'
// indices are mostly static: their order can be sorted once, and no
// PyTorch call takes an order sorted in advance.
//
// The input is a PLAN: rows[j], the table rows of the scatter in ascending
// order, and order[j], the position in the source of the j-th of them,
// where equal rows keep their order in the index (a stable sort). For each
// run of equal rows the kernel loads the table row once, adds each of the
// run's source rows in the plan's order, rounds to the table's type after
// every add (the sum itself in f32, or f64 for an f64 table), and stores
// the row once. These are the semantics of PyTorch's indexing_backward_
// kernel, which index_put_(accumulate=True) runs for a 2-D table after its
// stable radix sort, so for a 2-D table the bits equal that route's.
//
// Layout: one warp per position of the plan. A warp loads its position's
// group of 32 (rows and order, coalesced) and rows[j - 1] at once; a warp
// whose position is not the head of its run returns; the head's warp walks
// the run 32 positions at a time (a ballot for where the run ends, the
// next group's plan loaded while this group's rows are added), with its
// lanes across the row's columns: each lane takes V adjacent columns by
// one vector load where the columns are contiguous and aligned (V up to 16
// bytes), else one strided column. The run's source rows are loaded kAhead
// at a time before their adds, so a hot row's chain of adds (a 16,384-
// rating batch draws ML-20M's hottest item ~480 times) waits on one L2
// latency every kAhead rows, not on every row. The grid is sized by the
// plan's length and the heads are found from the plan itself, so the host
// never counts the runs (no sync).
//
// What bounds it: bytes. Each source row is read once and each touched
// table row read and written once, plus 8 or 16 bytes of plan a position;
// at the sgd engine's batch (16,384 x 64 f32) that is ~4.5 MB, 1.3 us at
// 3.35 TB/s, below a launch's own cost. The hottest run's chain is the
// longest path; the loads ahead keep it near kAhead adds an L2 round trip.
//
// Bounds: the table's and the source's row and column strides are
// arguments, so a scatter along dim 1 runs in place on a strided view. A
// row outside [0, n_rows) is never written: the head's warp traps (as
// PyTorch's device-side index assert does), with no host sync.
//
// Call contract: ordered_scatter launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

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

extern "C" {

// table[rows[j]] += src[order[j]] for j = 0..n-1 in that order, each add
// rounded to the table's type (see the top of the file). dtype: 0 f32, 1
// bf16, 2 f16, 3 f64; index_bytes: 4 (int32 order and rows) or 8 (int64).
// A table row is table + row * t_row, its column c at + c * t_col (the
// same for src with s_row, s_col); k columns. Launches on `stream`, on
// CUDA device `device` (the caller's current device is restored). Returns
// a cudaError_t; cudaErrorInvalidValue for an argument it does not take.
int ordered_scatter(void* table, const void* src, const void* order,
                    const void* rows, long long n, long long n_rows, int k,
                    long long t_row, long long t_col, long long s_row,
                    long long s_col, int dtype, int index_bytes, int device,
                    void* stream) {
  if (n < 0 || k <= 0 || (index_bytes != 4 && index_bytes != 8) ||
      dtype < 0 || dtype > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(stream);
  int err = 0;
  switch (dtype) {
    case 0:
      err = launch_t<float>(index_bytes, table, src, order, rows, n, n_rows,
                            k, t_row, t_col, s_row, s_col, s);
      break;
    case 1:
      err = launch_t<__nv_bfloat16>(index_bytes, table, src, order, rows, n,
                                    n_rows, k, t_row, t_col, s_row, s_col, s);
      break;
    case 2:
      err = launch_t<__half>(index_bytes, table, src, order, rows, n, n_rows,
                             k, t_row, t_col, s_row, s_col, s);
      break;
    case 3:
      err = launch_t<double>(index_bytes, table, src, order, rows, n, n_rows,
                             k, t_row, t_col, s_row, s_col, s);
      break;
  }
  if (prev != device) cudaSetDevice(prev);
  return err;
}

const char* ordered_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
