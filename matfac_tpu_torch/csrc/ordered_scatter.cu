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
// The device code and its launch are in ordered_scatter.cuh, shared with
// sgd_step.cu (the sgd engine's fused step scatters through it).
//
// Call contract: ordered_scatter launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include "ordered_scatter.cuh"

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
