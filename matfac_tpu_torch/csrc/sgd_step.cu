// The sgd engine's batch step on Hopper (sm_90a), CUDA C++ on the CUDA
// cores: the route of ops/sgd_step.SGDStep on CUDA tables, one host call a
// batch of solvers/sgd.py's staged stream.
//
// Replaces no Pallas kernel. The JAX engine (matfac_tpu/solvers/sgd.py)
// computes this step with XLA gathers, elementwise ops and a scatter-add,
// which XLA fuses. The port ran it as ~30 eager PyTorch ops a batch, and
// at the sgd cell's 1,038 batches an epoch their dispatch on the host set
// the epoch's time, while every [B, k] intermediate went to HBM and back.
//
// One call of sgd_step enqueues, on the caller's stream:
//   1. sgd_grad_kernel: for each example of the batch, its user and item
//      rows read once (16-byte loads where the layout allows), the
//      prediction (a dot product summed in one fixed order), the residual,
//      both gradients, and -lr * g written in the table's type to two
//      [B, k] scratch rows (and, for a bias model, two [B] scratch
//      values);
//   2. the ordered scatter (ordered_scatter.cuh, the device code of
//      ordered_scatter.cu) of those rows into U and I, and of the bias
//      values into bu and bi, by the batch's staged plans.
// It allocates nothing and does not synchronise.
//
// Arithmetic: f32, the eager chain's order of operations, each product and
// sum rounded on its own (__fmul_rn / __fadd_rn: nothing contracts into an
// FMA); the scalars 2 * reg and -lr come from the host as doubles and are
// rounded to f32 once, as PyTorch does with a Python scalar. The one
// difference from the eager chain is the dot product's order of
// summation: each lane sums its columns in order, then the 16 lanes of an
// example add by a butterfly, whose every lane ends with the same bits.
// Every optional input (weights are always given) is a pointer that may be
// null: the rank mask m [B, k], the side gates (each [B, k] or [B, 1]),
// the collision scales 1 / n_u, 1 / n_i, the per-entity regularization
// scales (gathered here), and the per-dim rates reg_vec [k].
//
// Layout: 16 lanes an example (a half-warp), 16 examples a block. Lane l
// holds columns (j * 16 + l) * V .. + V - 1 for j < J, V values a 16-byte
// vector (4 f32, 8 bf16) where the columns and the rows allow, else 1;
// J the least power of two that covers k. At k 64 f32 an example's row is
// one 16-byte load a lane.
//
// What bounds it: bytes. Each example reads two table rows and writes two
// scratch rows (4 k bytes each in f32) plus 28 bytes of ids, rating,
// valid flag and weight: ~17.2 MB a batch of 16,384 at k 64, 5.1 us at
// 3.35 TB/s. Both tables of the sgd cell (42 MB) fit the 50 MB L2. The
// scatter's time is its hottest row's chain (ordered_scatter.cu).

#include "ordered_scatter.cuh"

// What sgd_step is given: the solver's staged stream, its static scales
// and each batch's plans (set once a solver), the tables and the scratch
// rows (set once an epoch). Every field is 8 bytes, so ops/sgd_step.py's
// ctypes Structure has the same layout. The gradient kernel takes it by
// value. It lies outside the unnamed namespace: a C entry whose
// parameter's type is internal is not exported.
struct StepArgs {
  const int64_t* rows;          // the staged stream's user ids
  const int64_t* cols;          // item ids
  const float* vals;            // ratings
  const float* valid;           // 1 real, 0 padding
  const float* inv_nu;          // collision scales, or null
  const float* inv_ni;
  const float* reg_scale_u;     // [n_users] per-entity scales, or null
  const float* reg_scale_i;
  const float* reg_vec;         // [k] per-dim rates, or null
  double two_u_reg;             // 2 * u_reg (unused with reg_vec)
  double two_i_reg;
  long long batch;              // B
  long long k;
  long long use_factors;
  long long use_bias;
  void* gu;                     // scratch [B, k] in the factors' type
  void* gi;
  void* gbu;                    // scratch [B] in the biases' type
  void* gbi;
  void* u_fac;                  // the tables
  void* i_fac;
  void* u_bias;
  void* i_bias;
  long long n_users;            // rows of each table
  long long n_items;
  long long u_row;              // row strides, in elements
  long long i_row;
  long long bu_stride;
  long long bi_stride;
  long long dtype;              // factors: 0 f32, 1 bf16
  long long bias_dtype;         // biases: 0 f32, 1 bf16
  double neg_lr;                // -lr
  long long device;
  void* stream;
  long long n_batches;
  // host arrays [n_batches]: batch b's staged plan (int32 order and rows,
  // device pointers) of its user and its item ids
  const void* const* u_order;
  const void* const* u_rows;
  const void* const* i_order;
  const void* const* i_rows;
};

namespace {

constexpr int kLanes = 16;                   // lanes an example
constexpr int kExamples = 8 * 32 / kLanes;   // examples a block of 8 warps

// What the model's hooks give a batch: its weights w [B], and the rank
// mask m and the side gates su, si, each null where the hook gives none.
struct Hooks {
  const float* w;
  const float* m;
  long long m_row;
  const float* su;
  long long su_row, su_col;
  const float* si;
  long long si_row, si_col;
};

__device__ __forceinline__ float bias_load(const void* t, long long at,
                                           bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(t)[at])
              : static_cast<const float*>(t)[at];
}

__device__ __forceinline__ void bias_store(void* t, long long at, float x,
                                           bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(t)[at] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(t)[at] = x;
}

template <typename T, int V, int J>
__global__ void __launch_bounds__(kExamples * kLanes)
    sgd_grad_kernel(const StepArgs a, const Hooks h, const long long at) {
  using N = Num<T>;
  const int e = blockIdx.x * kExamples + (threadIdx.x / kLanes);
  const int lane = threadIdx.x % kLanes;
  const bool live = e < a.batch;
  // a slot past the batch reads example 0 and writes nothing: its lanes
  // still take part in the shuffles
  const int x = live ? e : 0;
  const long long u = a.rows[at + x];
  const long long i = a.cols[at + x];
  const float r = a.vals[at + x];
  const float v = a.valid[at + x];
  const float w = h.w[x];
  const int k = static_cast<int>(a.k);
  const bool bias_bf16 = a.bias_dtype == 1;

  float pu[J][V], qi[J][V];
  float pred = 0.0f;
  if (a.use_factors) {
    const T* urow = static_cast<const T*>(a.u_fac) + u * a.u_row;
    const T* irow = static_cast<const T*>(a.i_fac) + i * a.i_row;
    float dot = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (j * kLanes + lane) * V;
      if (c < k) {
        const Pack<T, V> pa = load<T, V>(urow, c, 1);
        const Pack<T, V> pb = load<T, V>(irow, c, 1);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          pu[j][t] = N::up(pa.v[t]);
          qi[j][t] = N::up(pb.v[t]);
          float pm = pu[j][t];
          if (h.m) pm = __fmul_rn(pm, h.m[x * h.m_row + c + t]);
          dot = __fadd_rn(dot, __fmul_rn(pm, qi[j][t]));
        }
      }
    }
#pragma unroll
    for (int s = kLanes / 2; s > 0; s /= 2)
      dot = __fadd_rn(dot, __shfl_xor_sync(kFull, dot, s, kLanes));
    pred = dot;
  }
  float bu_old = 0.0f, bi_old = 0.0f;
  if (a.use_bias) {
    bu_old = bias_load(a.u_bias, u * a.bu_stride, bias_bf16);
    bi_old = bias_load(a.i_bias, i * a.bi_stride, bias_bf16);
    pred = __fadd_rn(__fadd_rn(pred, bu_old), bi_old);
  }
  const float diff = __fsub_rn(r, pred);
  const float ru = a.reg_scale_u ? __fmul_rn(a.reg_scale_u[u], v) : v;
  const float ri = a.reg_scale_i ? __fmul_rn(a.reg_scale_i[i], v) : v;
  const float fit = __fmul_rn(-2.0f, __fmul_rn(w, diff));   // -2 w e
  if (!live) return;
  // the host's doubles rounded to f32 once, as PyTorch rounds a scalar
  const float cu0 = static_cast<float>(a.two_u_reg);
  const float ci0 = static_cast<float>(a.two_i_reg);
  const float neg_lr = static_cast<float>(a.neg_lr);
  const float inu = a.inv_nu ? a.inv_nu[at + e] : 1.0f;
  const float ini = a.inv_nu ? a.inv_ni[at + e] : 1.0f;

  if (a.use_factors) {
    T* gu = static_cast<T*>(a.gu) + static_cast<long long>(e) * k;
    T* gi = static_cast<T*>(a.gi) + static_cast<long long>(e) * k;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = (j * kLanes + lane) * V;
      if (c >= k) continue;
      Pack<T, V> ou, oi;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int cc = c + t;
        const float cu = a.reg_vec ? __fmul_rn(2.0f, a.reg_vec[cc]) : cu0;
        const float ci = a.reg_vec ? __fmul_rn(2.0f, a.reg_vec[cc]) : ci0;
        float g_u = __fadd_rn(__fmul_rn(fit, qi[j][t]),
                              __fmul_rn(cu, __fmul_rn(ru, pu[j][t])));
        float g_i = __fadd_rn(__fmul_rn(fit, pu[j][t]),
                              __fmul_rn(ci, __fmul_rn(ri, qi[j][t])));
        if (h.m) {
          const float mv = h.m[e * h.m_row + cc];
          g_u = __fmul_rn(g_u, mv);
          g_i = __fmul_rn(g_i, mv);
        }
        if (h.su) g_u = __fmul_rn(g_u, h.su[e * h.su_row + cc * h.su_col]);
        if (h.si) g_i = __fmul_rn(g_i, h.si[e * h.si_row + cc * h.si_col]);
        if (a.inv_nu) {
          g_u = __fmul_rn(g_u, inu);
          g_i = __fmul_rn(g_i, ini);
        }
        ou.v[t] = N::down(__fmul_rn(neg_lr, g_u));
        oi.v[t] = N::down(__fmul_rn(neg_lr, g_i));
      }
      store<T, V>(gu, c, 1, ou);
      store<T, V>(gi, c, 1, oi);
    }
  }
  if (a.use_bias && lane == 0) {
    // the eager chain's (2 reg * ru) * b, not 2 reg * (ru * b)
    float g_u = __fadd_rn(fit, __fmul_rn(__fmul_rn(cu0, ru), bu_old));
    float g_i = __fadd_rn(fit, __fmul_rn(__fmul_rn(ci0, ri), bi_old));
    if (h.su) g_u = __fmul_rn(g_u, h.su[e * h.su_row]);
    if (h.si) g_i = __fmul_rn(g_i, h.si[e * h.si_row]);
    if (a.inv_nu) {
      g_u = __fmul_rn(g_u, inu);
      g_i = __fmul_rn(g_i, ini);
    }
    bias_store(a.gbu, e, __fmul_rn(neg_lr, g_u), bias_bf16);
    bias_store(a.gbi, e, __fmul_rn(neg_lr, g_i), bias_bf16);
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T, int V, int J>
void grad_j(const StepArgs& a, const Hooks& h, long long at,
            cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((a.batch + kExamples - 1) / kExamples);
  sgd_grad_kernel<T, V, J><<<blocks, kExamples * kLanes, 0, stream>>>(a, h,
                                                                     at);
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
bool grad_v(const StepArgs& a, const Hooks& h, long long at,
            cudaStream_t stream) {
  switch (chunks(a.k, V)) {
    case 1: grad_j<T, V, 1>(a, h, at, stream); return true;
    case 2: grad_j<T, V, 2>(a, h, at, stream); return true;
    case 4: grad_j<T, V, 4>(a, h, at, stream); return true;
    case 8: grad_j<T, V, 8>(a, h, at, stream); return true;
    case 16: grad_j<T, V, 16>(a, h, at, stream); return true;
  }
  return false;
}

// the gradient kernel, then the scatters of batch b, counted in
// *scatters as each is enqueued; a cudaError_t
template <typename T>
int step(const StepArgs& a, const Hooks& h, long long b,
         cudaStream_t stream, int* scatters) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = a.k % kVec == 0 && a.u_row % kVec == 0 &&
                    a.i_row % kVec == 0 && aligned(a.u_fac, 16) &&
                    aligned(a.i_fac, 16) && aligned(a.gu, 16) &&
                    aligned(a.gi, 16);
  const long long at = b * a.batch;
  if (!(wide ? grad_v<T, kVec>(a, h, at, stream)
             : grad_v<T, 1>(a, h, at, stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n = a.batch;
  const int k = static_cast<int>(a.k);
  const void *uo = a.u_order[b], *ur = a.u_rows[b];
  const void *io = a.i_order[b], *ir = a.i_rows[b];
  auto scatter = [&](auto tag, void* table, const void* src, const void* o,
                     const void* r, long long n_rows, int width,
                     long long row) {
    using S = decltype(tag);
    const int e = launch<S, int32_t>(table, src, o, r, n, n_rows, width,
                                     row, 1, width, 1, stream);
    if (!e) ++*scatters;
    return e;
  };
  if (a.use_factors) {
    if ((err = scatter(T{}, a.u_fac, a.gu, uo, ur, a.n_users, k, a.u_row)))
      return err;
    if ((err = scatter(T{}, a.i_fac, a.gi, io, ir, a.n_items, k, a.i_row)))
      return err;
  }
  if (a.use_bias && a.bias_dtype == 1) {
    if ((err = scatter(__nv_bfloat16{}, a.u_bias, a.gbu, uo, ur, a.n_users,
                       1, a.bu_stride)))
      return err;
    err = scatter(__nv_bfloat16{}, a.i_bias, a.gbi, io, ir, a.n_items, 1,
                  a.bi_stride);
  } else if (a.use_bias) {
    if ((err = scatter(float{}, a.u_bias, a.gbu, uo, ur, a.n_users, 1,
                       a.bu_stride)))
      return err;
    err = scatter(float{}, a.i_bias, a.gbi, io, ir, a.n_items, 1,
                  a.bi_stride);
  }
  return err;
}

}  // namespace

extern "C" {

// Batch b of the sgd engine: the examples at [b B, (b + 1) B) of the
// staged stream in `a`, scattered by batch b's plans; their weights w [B]
// (f32), the rank mask m (f32, row stride m_row) and the side gates su, si
// (f32, each with a row and a column stride; column stride 0 for a [B, 1]
// gate), each but w a pointer that may be null. Launches on a->stream, on
// CUDA device a->device (the caller's current device is restored), and
// sets *scatters to the ordered scatter launches it enqueued. Returns a
// cudaError_t; cudaErrorInvalidValue for an argument it does not take.
int sgd_step(const StepArgs* a, long long b, const void* w, const void* m,
             long long m_row, const void* su, long long su_row,
             long long su_col, const void* si, long long si_row,
             long long si_col, int* scatters) {
  *scatters = 0;
  if (a->batch <= 0 || a->k <= 0 || a->dtype < 0 || a->dtype > 1 ||
      a->bias_dtype < 0 || a->bias_dtype > 1 || !w || b < 0 ||
      b >= a->n_batches || (!a->use_factors && !a->use_bias) ||
      ((a->inv_nu == nullptr) != (a->inv_ni == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hooks h{static_cast<const float*>(w), static_cast<const float*>(m),
                m_row, static_cast<const float*>(su), su_row, su_col,
                static_cast<const float*>(si), si_row, si_col};
  int prev = -1;
  cudaGetDevice(&prev);
  const int device = static_cast<int>(a->device);
  if (prev != device) cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(a->stream);
  const int err = a->dtype == 1
                      ? step<__nv_bfloat16>(*a, h, b, s, scatters)
                      : step<float>(*a, h, b, s, scatters);
  if (prev != device) cudaSetDevice(prev);
  return err;
}

const char* sgd_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
