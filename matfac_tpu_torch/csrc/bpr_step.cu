// The stream-BPR engine's batch on Hopper (sm_90a), CUDA C++ on the CUDA
// cores: the route of ops/bpr_step.BPRStep on CUDA tables, two host calls
// a batch of solvers/bpr.py's stream.
//
// Replaces no Pallas kernel. The JAX engine (matfac_tpu/solvers/bpr.py)
// samples and steps with XLA gathers, elementwise ops, reductions and a
// scatter-add, which XLA fuses. The port ran a batch as ~90 eager PyTorch
// ops (~25 a try of the rank-gap sampler, ~30 of the pair terms, a sort of
// the item ids), and at the BPR cell's 148 batches an epoch their dispatch
// on the host set the epoch's time, while every [B, k] intermediate went
// to HBM and back.
//
// bpr_sample enqueues one kernel, bpr_sample_kernel: one thread a positive
// of the batch, the rank-gap sampler's tries in order over the same 32-bit
// words (held in int64, `% deg` as the eager sampler takes it), the first
// try that succeeds taken. Integer arithmetic only: the negatives are the
// eager sampler's, bit for bit. It writes the batch's negatives neg [B]
// and weights w = valid * found [B] to scratch.
//
// bpr_step enqueues, on the caller's stream:
//   1. bpr_grad_kernel: for each triple (u, p, n), the rows p_u, q_p, q_n
//      read once (16-byte loads where the layout allows), r_uij = <p_u o m,
//      q_p> - <p_u o m, q_n>, the three gradients, and -lr * g written in
//      the table's type to scratch rows: gu [B, k], gi [2B, k] (the
//      positives' rows, then the negatives'); the triple's loss
//      w * logaddexp(0, -r_uij) and inversion (-r_uij > eps, w > 0) summed
//      over the block in a fixed order; the item ids [p; n] written as the
//      item sort's keys;
//   2. bpr_sum_kernel: the blocks' partial sums added in a fixed order, and
//      the batch's sums added to the epoch's loss and inversion scalars;
//   3. the user side's plan: the batch's staged plan, or, for ids given by
//      the caller (posneg), a stable radix sort of the ids (CUB's
//      DeviceRadixSort over the low bits that cover the table's rows);
//      then the ordered scatter of gu into U (ordered_scatter.cuh);
//   4. the item side's plan, the stable radix sort of [p; n], and the
//      ordered scatter of gi into I. A stable sort gives the plan that
//      ops/scatter.plan_ordered gives the same ids, so each row's adds keep
//      the eager route's order.
// Neither entry allocates or synchronises; the sort's scratch is staged
// once a solver (bpr_sort_bytes says how much).
//
// Arithmetic: f32, the eager chain's order of operations (ops/bpr_step.py,
// bpr_pair_terms), each product and sum rounded on its own (__fmul_rn /
// __fadd_rn: nothing contracts into an FMA), -1 / (1 + e^r) as the
// reciprocal times -1 (PyTorch's scalar / tensor), accurate expf and
// log1pf; 2 * reg, -lr and eps come from the host as doubles and are
// rounded to f32 once, as PyTorch rounds a Python scalar. The differences
// from the eager chain are the dot products' order of summation (each lane
// sums its columns in order, then the 16 lanes of a triple add by a
// butterfly, whose every lane ends with the same bits) and the batch
// loss's (block partials, then one pass). bf16 tables are read into f32
// and the gradients computed in f32 (the eager chain rounds its bf16
// products to bf16); the scatter rounds each add to bf16 as for f32.
//
// Layout: 16 lanes a triple (a half-warp), 16 triples a block. Lane l
// holds columns (j * 16 + l) * V .. + V - 1 for j < J, V values a 16-byte
// vector (4 f32, 8 bf16) where the columns and the rows allow, else 1; J
// the least power of two that covers k. At k 64 f32 each row is one
// 16-byte load a lane.
//
// What bounds it: bytes. Each triple reads three table rows and writes
// three scratch rows (4 k bytes each in f32) plus 40 bytes of ids, weight
// and keys: ~100 MB a batch of 65,536 at k 64, 30 us at 3.35 TB/s; both
// tables of the BPR cell (20.6 MB) sit in the 50 MB L2. The scatters' time
// is the item side's hottest row's chain (ordered_scatter.cu).

#include <cub/device/device_radix_sort.cuh>

#include "ordered_scatter.cuh"

// What the two entries are given: the solver's staged positives, CSR rows
// and rank-gap tables, the scratch and each batch's staged user plan (set
// once a solver), the epoch's words, tables and sums (set once an epoch).
// Every field is 8 bytes, so ops/bpr_step.py's ctypes Structure has the
// same layout. The kernels take it by value. It lies outside the unnamed
// namespace: a C entry whose parameter's type is internal is not exported.
struct BprArgs {
  const int64_t* pos_u;         // [n_batches * B] the positives' users
  const int64_t* pos_i;         // their items
  const float* pos_valid;       // 1 real, 0 padding
  const int64_t* pos_start;     // each positive's user row in the CSR
  const int64_t* pos_deg;       // and its length (at least 1)
  const int64_t* csr_cols;      // [nnz] the train rows' items
  const float* csr_vals;        // their ratings (0: an explicit zero)
  const int64_t* cum_lo;        // [nnz] each entry's gap: first rank
  const int64_t* cnt;           // and count into sel_items; or null
  const int64_t* sel_items;     // [n_sel] the train items, ascending
  long long nnz;
  long long n_sel;
  long long batch;              // B
  long long n_batches;
  long long n_tries;
  double two_u_reg;             // 2 * u_reg
  double two_i_reg;
  double eps;                   // the inversion threshold
  void* gu;                     // scratch [B, k] in the tables' type
  void* gi;                     // [2B, k]: positives, then negatives
  int64_t* neg;                 // [B] the sampler's negatives
  float* w;                     // [B] and weights
  uint32_t* i_keys;             // [2B] the item sort's keys
  uint32_t* u_keys;             // [B] the user sort's keys
  const int32_t* iota;          // [2B] 0, 1, ..., 2B - 1
  uint32_t* i_rows;             // [2B] the item plan
  int32_t* i_order;
  uint32_t* u_rows;             // [B] a user plan sorted in the call
  int32_t* u_order;
  float* loss_part;             // [blocks] a block's sums
  long long* inv_part;
  void* sort_tmp;               // the sorts' scratch
  long long sort_bytes;
  const int64_t* bits;          // [n_steps, 2, n_tries, B] the words
  long long n_steps;
  void* u_fac;                  // the tables
  void* i_fac;
  long long k;
  long long n_users;            // rows of each table
  long long n_items;
  long long u_row;              // row strides, in elements
  long long i_row;
  long long dtype;              // 0 f32, 1 bf16
  double neg_lr;                // -lr
  float* loss;                  // the epoch's sums, added to
  long long* inv;
  long long device;
  void* stream;
  // host arrays [n_batches]: batch b's staged user plan (int32 order and
  // rows, device pointers), or null where none is staged
  const void* const* plan_order;
  const void* const* plan_rows;
};

namespace {

constexpr int kLanes = 16;                   // lanes a triple
constexpr int kTriples = 8 * 32 / kLanes;    // triples a block of 8 warps
constexpr int kSample = 256;                 // sampler threads a block
constexpr int kSum = 512;                    // threads of the final sum

__global__ void __launch_bounds__(kSample)
    bpr_sample_kernel(const BprArgs a, const long long t, const long long b) {
  const long long e = static_cast<long long>(blockIdx.x) * kSample +
                      threadIdx.x;
  const long long B = a.batch;
  if (e >= B) return;
  const long long at = b * B + e;
  const long long start = a.pos_start[at];
  const long long deg = a.pos_deg[at];
  // bits[t, 0, try, e] and bits[t, 1, try, e]
  const int64_t* jj = a.bits + (t * 2) * a.n_tries * B + e;
  const int64_t* jb = a.bits + (t * 2 + 1) * a.n_tries * B + e;
  const long long last = a.nnz > 0 ? a.nnz - 1 : 0;
  long long vr = 0;
  bool is_rank = false, ok = false;
  for (long long q = 0; q < a.n_tries; ++q) {
    long long p = start + jj[q * B] % deg;
    p = p < 0 ? 0 : (p > last ? last : p);
    const bool expl = a.csr_vals[p] == 0.0f;
    const long long c = a.cnt[p];
    const bool gap_ok = c > 0;
    const long long m = jb[q * B] % (c > 1 ? c : 1);
    const bool cand_ok = expl || gap_ok;
    if (cand_ok && !ok) {
      vr = expl ? a.csr_cols[p] : a.cum_lo[p] + m;
      is_rank = !expl && gap_ok;
    }
    ok = ok || cand_ok;
  }
  if (is_rank) {
    const long long hi = a.n_sel - 1;
    vr = a.sel_items[vr < 0 ? 0 : (vr > hi ? hi : vr)];
  }
  a.neg[e] = vr;
  a.w[e] = __fmul_rn(a.pos_valid[at], ok ? 1.0f : 0.0f);
}

// What bpr_step is given for a batch: its triples' ids and weights, and
// the rank mask m [B, k] (row stride m_row), null where the model gives
// none.
struct Batch {
  const int64_t* u;
  const int64_t* p;
  const int64_t* n;
  const float* w;
  const float* m;
  long long m_row;
  uint32_t* u_keys;             // the user sort's keys, or null (staged)
};

template <typename T, int V, int J>
__global__ void __launch_bounds__(kTriples * kLanes)
    bpr_grad_kernel(const BprArgs a, const Batch h) {
  using N = Num<T>;
  __shared__ float s_loss[kTriples];
  __shared__ long long s_inv[kTriples];
  const int slot = threadIdx.x / kLanes;
  const int e = blockIdx.x * kTriples + slot;
  const int lane = threadIdx.x % kLanes;
  const long long B = a.batch;
  const bool live = e < B;
  // a slot past the batch reads triple 0 and writes nothing: its lanes
  // still take part in the shuffles
  const int x = live ? e : 0;
  const long long u = h.u[x], p = h.p[x], n = h.n[x];
  const float w = h.w[x];
  if (u < 0 || u >= a.n_users || p < 0 || p >= a.n_items || n < 0 ||
      n >= a.n_items)
    __trap();   // as PyTorch's device-side index assert
  const int k = static_cast<int>(a.k);
  const T* urow = static_cast<const T*>(a.u_fac) + u * a.u_row;
  const T* prow = static_cast<const T*>(a.i_fac) + p * a.i_row;
  const T* nrow = static_cast<const T*>(a.i_fac) + n * a.i_row;

  float pu[J][V], qp[J][V], qn[J][V];
  float d_p = 0.0f, d_n = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (j * kLanes + lane) * V;
    if (c < k) {
      const Pack<T, V> ra = load<T, V>(urow, c, 1);
      const Pack<T, V> rb = load<T, V>(prow, c, 1);
      const Pack<T, V> rc = load<T, V>(nrow, c, 1);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        pu[j][t] = N::up(ra.v[t]);
        qp[j][t] = N::up(rb.v[t]);
        qn[j][t] = N::up(rc.v[t]);
        float pm = pu[j][t];
        if (h.m) pm = __fmul_rn(pm, h.m[x * h.m_row + c + t]);
        d_p = __fadd_rn(d_p, __fmul_rn(pm, qp[j][t]));
        d_n = __fadd_rn(d_n, __fmul_rn(pm, qn[j][t]));
      }
    }
  }
#pragma unroll
  for (int s = kLanes / 2; s > 0; s /= 2) {
    d_p = __fadd_rn(d_p, __shfl_xor_sync(kFull, d_p, s, kLanes));
    d_n = __fadd_rn(d_n, __shfl_xor_sync(kFull, d_n, s, kLanes));
  }
  const float r = __fsub_rn(d_p, d_n);
  if (lane == 0) {
    // logaddexp(0, -r) as PyTorch takes it: max + log1p(exp(-|a - b|))
    const float lae = __fadd_rn(fmaxf(0.0f, -r), log1pf(expf(-fabsf(r))));
    s_loss[slot] = live ? __fmul_rn(w, lae) : 0.0f;
    s_inv[slot] = live && -r > static_cast<float>(a.eps) && w > 0.0f;
    if (live) {
      a.i_keys[e] = static_cast<uint32_t>(p);
      a.i_keys[B + e] = static_cast<uint32_t>(n);
      if (h.u_keys) h.u_keys[e] = static_cast<uint32_t>(u);
    }
  }
  // w * (1 / (1 + e^r) * -1), 2 reg * w, -lr: the host's doubles rounded
  // to f32 once
  const float coeff = __fmul_rn(w, -__frcp_rn(__fadd_rn(1.0f, expf(r))));
  const float ru = __fmul_rn(static_cast<float>(a.two_u_reg), w);
  const float ri = __fmul_rn(static_cast<float>(a.two_i_reg), w);
  const float neg_lr = static_cast<float>(a.neg_lr);
  if (live) {
    T* gu = static_cast<T*>(a.gu) + static_cast<long long>(e) * k;
    T* gp = static_cast<T*>(a.gi) + static_cast<long long>(e) * k;
    T* gn = static_cast<T*>(a.gi) + (B + e) * k;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (j * kLanes + lane) * V;
      if (c >= k) continue;
      Pack<T, V> ou, op, on;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        float g_u = __fadd_rn(__fmul_rn(coeff, __fsub_rn(qp[j][t], qn[j][t])),
                              __fmul_rn(ru, pu[j][t]));
        float g_p = __fadd_rn(__fmul_rn(coeff, pu[j][t]),
                              __fmul_rn(ri, qp[j][t]));
        float g_n = __fadd_rn(__fmul_rn(-coeff, pu[j][t]),
                              __fmul_rn(ri, qn[j][t]));
        if (h.m) {
          const float mv = h.m[e * h.m_row + c + t];
          g_u = __fmul_rn(g_u, mv);
          g_p = __fmul_rn(g_p, mv);
          g_n = __fmul_rn(g_n, mv);
        }
        ou.v[t] = N::down(__fmul_rn(neg_lr, g_u));
        op.v[t] = N::down(__fmul_rn(neg_lr, g_p));
        on.v[t] = N::down(__fmul_rn(neg_lr, g_n));
      }
      store<T, V>(gu, c, 1, ou);
      store<T, V>(gp, c, 1, op);
      store<T, V>(gn, c, 1, on);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    long long c = 0;
#pragma unroll
    for (int i = 0; i < kTriples; ++i) {
      s = __fadd_rn(s, s_loss[i]);
      c += s_inv[i];
    }
    a.loss_part[blockIdx.x] = s;
    a.inv_part[blockIdx.x] = c;
  }
}

// The blocks' partial sums, in one fixed order (each thread its strided
// share in order, then a tree), added to the epoch's sums.
__global__ void __launch_bounds__(kSum)
    bpr_sum_kernel(const float* part, const long long* ipart, int n,
                   float* loss, long long* inv) {
  __shared__ float s[kSum];
  __shared__ long long si[kSum];
  float acc = 0.0f;
  long long ia = 0;
  for (int i = threadIdx.x; i < n; i += kSum) {
    acc = __fadd_rn(acc, part[i]);
    ia += ipart[i];
  }
  s[threadIdx.x] = acc;
  si[threadIdx.x] = ia;
  __syncthreads();
  for (int h = kSum / 2; h > 0; h /= 2) {
    if (threadIdx.x < h) {
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + h]);
      si[threadIdx.x] += si[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *loss = __fadd_rn(*loss, s[0]);
    *inv += si[0];
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// the least number of low bits that holds every row id below n_rows
int id_bits(long long n_rows) {
  int bits = 1;
  while (bits < 32 && (1LL << bits) < n_rows) ++bits;
  return bits;
}

// the stable sort of n ids (keys) into a plan (rows, order)
int sort_plan(const BprArgs& a, const uint32_t* keys, uint32_t* rows,
              int32_t* order, long long n, long long n_rows,
              cudaStream_t stream) {
  size_t bytes = static_cast<size_t>(a.sort_bytes);
  return static_cast<int>(cub::DeviceRadixSort::SortPairs(
      a.sort_tmp, bytes, keys, rows, a.iota, order, static_cast<int>(n), 0,
      id_bits(n_rows), stream));
}

template <typename T, int V, int J>
void grad_j(const BprArgs& a, const Batch& h, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((a.batch + kTriples - 1) / kTriples);
  bpr_grad_kernel<T, V, J><<<blocks, kTriples * kLanes, 0, stream>>>(a, h);
}

// chunks a lane holds: the least of 1, 2, 4, 8, 16 that covers k; 0 where
// none does
int chunks(long long k, int v) {
  const long long need = (k / v + kLanes - 1) / kLanes;
  for (int j = 1; j <= 16; j *= 2)
    if (need <= j) return j;
  return 0;
}

template <typename T, int V>
bool grad_v(const BprArgs& a, const Batch& h, cudaStream_t stream) {
  switch (chunks(a.k, V)) {
    case 1: grad_j<T, V, 1>(a, h, stream); return true;
    case 2: grad_j<T, V, 2>(a, h, stream); return true;
    case 4: grad_j<T, V, 4>(a, h, stream); return true;
    case 8: grad_j<T, V, 8>(a, h, stream); return true;
    case 16: grad_j<T, V, 16>(a, h, stream); return true;
  }
  return false;
}

// the gradient kernel, the sums, then each side's plan and scatter,
// counted in *scatters as each scatter is enqueued; a cudaError_t
template <typename T>
int step(const BprArgs& a, const Batch& h, long long b, cudaStream_t stream,
         int* scatters) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = a.k % kVec == 0 && a.u_row % kVec == 0 &&
                    a.i_row % kVec == 0 && aligned(a.u_fac, 16) &&
                    aligned(a.i_fac, 16) && aligned(a.gu, 16) &&
                    aligned(a.gi, 16);
  if (!(wide ? grad_v<T, kVec>(a, h, stream) : grad_v<T, 1>(a, h, stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int blocks = static_cast<int>((a.batch + kTriples - 1) / kTriples);
  bpr_sum_kernel<<<1, kSum, 0, stream>>>(a.loss_part, a.inv_part, blocks,
                                         a.loss, a.inv);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const long long B = a.batch;
  const int k = static_cast<int>(a.k);
  const void *uo, *ur;
  if (h.u_keys) {
    if ((err = sort_plan(a, a.u_keys, a.u_rows, a.u_order, B, a.n_users,
                         stream)))
      return err;
    uo = a.u_order;
    ur = a.u_rows;
  } else {
    uo = a.plan_order[b];
    ur = a.plan_rows[b];
  }
  if ((err = launch<T, int32_t>(a.u_fac, a.gu, uo, ur, B, a.n_users, k,
                                a.u_row, 1, k, 1, stream)))
    return err;
  ++*scatters;
  if ((err = sort_plan(a, a.i_keys, a.i_rows, a.i_order, 2 * B, a.n_items,
                       stream)))
    return err;
  if ((err = launch<T, int32_t>(a.i_fac, a.gi, a.i_order, a.i_rows, 2 * B,
                                a.n_items, k, a.i_row, 1, k, 1, stream)))
    return err;
  ++*scatters;
  return 0;
}

// the C entries' device guard: runs fn on device a->device (the caller's
// current device is restored)
template <typename F>
int on_device(long long device, F fn) {
  int prev = -1;
  cudaGetDevice(&prev);
  const int d = static_cast<int>(device);
  if (prev != d) cudaSetDevice(d);
  const int err = fn();
  if (prev != d) cudaSetDevice(prev);
  return err;
}

}  // namespace

extern "C" {

// Bytes of scratch the stable sort of n ids below 2^32 takes, in *bytes,
// on CUDA device `device`. Returns a cudaError_t.
int bpr_sort_bytes(long long n, long long device, long long* bytes) {
  return on_device(device, [&] {
    size_t out = 0;
    const cudaError_t err = cub::DeviceRadixSort::SortPairs(
        nullptr, out, static_cast<const uint32_t*>(nullptr),
        static_cast<uint32_t*>(nullptr), static_cast<const int32_t*>(nullptr),
        static_cast<int32_t*>(nullptr), static_cast<int>(n), 0, 32);
    *bytes = static_cast<long long>(out);
    return static_cast<int>(err);
  });
}

// The negatives and weights of batch b (the positives at [b B, (b + 1) B)
// of the staged stream) from the words bits[t], into a->neg and a->w.
// Launches on a->stream. Returns a cudaError_t; cudaErrorInvalidValue for
// an argument it does not take (no rank-gap tables, t or b out of range).
int bpr_sample(const BprArgs* a, long long t, long long b) {
  if (a->batch <= 0 || !a->bits || !a->cnt || !a->cum_lo || !a->sel_items ||
      a->nnz <= 0 || a->n_sel <= 0 || a->n_tries <= 0 || t < 0 ||
      t >= a->n_steps || b < 0 || b >= a->n_batches)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(a->device, [&] {
    const unsigned blocks =
        static_cast<unsigned>((a->batch + kSample - 1) / kSample);
    bpr_sample_kernel<<<blocks, kSample, 0,
                        static_cast<cudaStream_t>(a->stream)>>>(*a, t, b);
    return static_cast<int>(cudaGetLastError());
  });
}

// Batch b's step: the triples (u, p, n) with weights w [B] (f32) and the
// rank mask m (f32, row stride m_row; null for none). u and p null take
// batch b of the staged positives and its staged user plan; given (int64
// [B]), the user side is sorted here. n and w are int64 and f32 [B].
// Launches on a->stream and sets *scatters to the ordered scatter
// launches it enqueued. Returns a cudaError_t; cudaErrorInvalidValue for
// an argument it does not take.
int bpr_step(const BprArgs* a, long long b, const void* u, const void* p,
             const void* n, const void* w, const void* m, long long m_row,
             int* scatters) {
  *scatters = 0;
  const bool staged = u == nullptr;
  if (a->batch <= 0 || a->k <= 0 || a->dtype < 0 || a->dtype > 1 || !n ||
      !w || b < 0 || b >= a->n_batches || staged != (p == nullptr) ||
      (staged && !a->plan_order) || 2 * a->batch > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long at = b * a->batch;
  const Batch h{staged ? a->pos_u + at : static_cast<const int64_t*>(u),
                staged ? a->pos_i + at : static_cast<const int64_t*>(p),
                static_cast<const int64_t*>(n), static_cast<const float*>(w),
                static_cast<const float*>(m), m_row,
                staged ? nullptr : a->u_keys};
  return on_device(a->device, [&] {
    auto s = static_cast<cudaStream_t>(a->stream);
    return a->dtype == 1 ? step<__nv_bfloat16>(*a, h, b, s, scatters)
                         : step<float>(*a, h, b, s, scatters);
  });
}

const char* bpr_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
