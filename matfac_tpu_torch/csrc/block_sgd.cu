// Resident-cell minibatch SGD on Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces two Pallas TPU kernels, which compute the same update:
//   * matfac_tpu/ops/block_sgd_kernel.py:148 block_sgd_epoch (body
//     _make_kernel, math _batch_update): the row-schedule epoch over
//     (user-block x item-block) cells, with bf16 one-hot products, IFWMF
//     weights, TMF rank masks and host-staged collision counts. Its
//     _batch_update is also the step of the diag schedule
//     (block_sweep_diag), which the port's main path runs.
//   * matfac_tpu/ops/sgd_kernel.py:73 fused_cell_update: one cell's stream
//     in f32, no collision norm, no mask, batch offset 0.
//
// A launch takes a list of LANES, int4 (user block, item block, stream
// row, batch offset). CTA b walks lanes [b * cells_per_cta, (b + 1) *
// cells_per_cta) in order. The three uses:
//   * diag schedule: one launch per round, one lane per CTA. The lanes of a
//     round are disjoint in both axes, so no CTA touches another's blocks.
//   * row schedule: one launch per user-block row, ONE CTA walking the
//     row's cells in their random order. Every cell depends on the one
//     before it (U is shared along the row, I across rows): this is the
//     TPU kernel's sequential grid, kept on purpose.
//   * fused_cell_update: one lane.
//
// Within a lane, minibatch s of n_steps = S / bs reads the stream slice
// starting at ((s + boff) % n_steps) * bs and does, per rating,
//   pu = U[u], qi = I[i]                 (bf16-rounded when MMBF16)
//   pred = sum_{d < lam} pu qi,  coeff = w (r - pred),  vm = (w > 0)
//   gu = -2 coeff qi + 2 u_reg vm pu,   gi = -2 coeff pu + 2 i_reg vm qi
//   (times the rank mask; divided by the host-staged counts when CN)
//   dU[u] += bf16?(-lr gu),  dI[i] += bf16?(-lr gi)
// then, after EVERY gather of the step (a barrier), U += dU and I += dI
// once per touched row. So all gathers read the pre-step blocks, each row
// adds the f32 sum of its (rounded) terms once, and repeated ids within a
// batch are handled, as the one-hot products of the TPU kernel do. Every
// elementwise step uses __f*_rn intrinsics (no FMA contraction), so given
// the same pred, each term rounds exactly as the plain PyTorch version's
// separate tensor ops do; only the order of the sums (pred over k, the
// per-row delta sums) differs. Padding slots (w == 0) are skipped: their
// terms are exactly 0 unless the row already holds a NaN.
//
// The deltas [bu + bi, k] f32 live in dynamic shared memory when they fit
// (2 x 96 KB at bu = bi = 384, k = 64; shared-memory atomics), else in a
// per-CTA slice of a global scratch that the wrapper allocates zeroed and
// the kernel leaves zeroed (global atomics, L2). block_sgd_scratch_floats
// is the one place that decides between the two routes. Touched-row flags
// (bu + bi bytes) stay in shared memory in both routes.
//
// What bounds it: per rating, two k-float row gathers from L2 (the blocks
// are a few hundred KB and stay there) and 2k shared-memory atomics; per
// step, the apply pass over the touched rows. Each warp walks its ratings
// one after another, so a step is latency-bound on the gathers; the diag
// schedule at the bench's full shape keeps only G = 53 of 132 SMs busy per
// round (one 1024-thread CTA each), in 265 launches per epoch. Measured on
// an H100 80GB HBM3 at 700 W: ~71 us of device time per round there (32
// ratings per warp at ~2 us each, the row loads waiting on the id loads).
// A later PR would give each warp several ratings in flight, fuse a whole
// diag epoch into one persistent launch with a grid barrier per round, and
// split a lane over a thread-block cluster to fill the idle SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;
constexpr int kPerLane = kMaxK / 32;
constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on H100

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

inline size_t delta_floats(int bu, int bi, int k) {
  return (static_cast<size_t>(bu) + bi) * k;
}

inline size_t flag_bytes(int bu, int bi) {
  return static_cast<size_t>(bu) + bi;
}

inline bool deltas_fit_smem(int bu, int bi, int k) {
  return delta_floats(bu, bi, k) * sizeof(float) + flag_bytes(bu, bi) <=
         kMaxSmem;
}

template <bool MMBF16, bool CN, bool MASK, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1)
cell_sgd_kernel(float* __restrict__ u_tab, float* __restrict__ i_tab,
                const int* __restrict__ u_loc, const int* __restrict__ i_loc,
                const float* __restrict__ vals, const float* __restrict__ wts,
                const float* __restrict__ cnu, const float* __restrict__ cni,
                const int* __restrict__ lam, const int4* __restrict__ lanes,
                int cells_per_cta, int S, int bs, int bu, int bi, int k,
                float neg_lr, float two_ureg, float two_ireg,
                float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const size_t n_delta = static_cast<size_t>(bu + bi) * k;
  float* dU = SMEM ? smem : scratch + blockIdx.x * n_delta;
  float* dI = dU + static_cast<size_t>(bu) * k;
  unsigned char* flags =
      reinterpret_cast<unsigned char*>(SMEM ? smem + n_delta : smem);
  unsigned char* fu = flags;
  unsigned char* fi = flags + bu;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  if (SMEM)
    for (size_t idx = tid; idx < n_delta; idx += kThreads) dU[idx] = 0.f;
  for (int idx = tid; idx < bu + bi; idx += kThreads) flags[idx] = 0;
  __syncthreads();

  const int n_steps = S / bs;
  for (int c = 0; c < cells_per_cta; ++c) {
    const int4 lane = lanes[static_cast<size_t>(blockIdx.x) * cells_per_cta + c];
    float* U = u_tab + static_cast<size_t>(lane.x) * bu * k;
    float* I = i_tab + static_cast<size_t>(lane.y) * bi * k;
    const size_t row0 = static_cast<size_t>(lane.z) * S;
    for (int s = 0; s < n_steps; ++s) {
      const size_t start = row0 + static_cast<size_t>((s + lane.w) % n_steps) * bs;
      // phase 1: every gather reads the pre-step blocks
      for (int e = warp; e < bs; e += kWarps) {
        const size_t q = start + e;
        const float w = wts[q];
        if (w == 0.f) continue;  // padding slot (warp-uniform)
        const int u = u_loc[q];
        const int i = i_loc[q];
        const float r = vals[q];
        const int lm = MASK ? lam[q] : k;
        const float* urow = U + static_cast<size_t>(u) * k;
        const float* irow = I + static_cast<size_t>(i) * k;
        float pu[kPerLane], qi[kPerLane];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int d = ln + 32 * j;
          pu[j] = 0.f;
          qi[j] = 0.f;
          if (d < k) {
            float a = urow[d];
            float b = irow[d];
            if (MMBF16) {
              a = bf16_round(a);
              b = bf16_round(b);
            }
            pu[j] = a;
            qi[j] = b;
            if (!MASK || d < lm) part = fmaf(a, b, part);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        const float coeff = __fmul_rn(w, __fsub_rn(r, part));
        const float vm = w > 0.f ? 1.f : 0.f;
        const float c2 = __fmul_rn(-2.f, coeff);
        const float ru = __fmul_rn(two_ureg, vm);
        const float ri = __fmul_rn(two_ireg, vm);
        const float nu = CN ? cnu[q] : 1.f;
        const float ni = CN ? cni[q] : 1.f;
        float* du = dU + static_cast<size_t>(u) * k;
        float* di = dI + static_cast<size_t>(i) * k;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int d = ln + 32 * j;
          if (d < k) {
            float gu = __fadd_rn(__fmul_rn(c2, qi[j]), __fmul_rn(ru, pu[j]));
            float gi = __fadd_rn(__fmul_rn(c2, pu[j]), __fmul_rn(ri, qi[j]));
            if (MASK) {
              const float m = d < lm ? 1.f : 0.f;
              gu = __fmul_rn(gu, m);
              gi = __fmul_rn(gi, m);
            }
            if (CN) {
              gu = __fdiv_rn(gu, nu);
              gi = __fdiv_rn(gi, ni);
            }
            float tu = __fmul_rn(neg_lr, gu);
            float ti = __fmul_rn(neg_lr, gi);
            if (MMBF16) {
              tu = bf16_round(tu);
              ti = bf16_round(ti);
            }
            atomicAdd(du + d, tu);
            atomicAdd(di + d, ti);
          }
        }
        if (ln == 0) {
          fu[u] = 1;
          fi[i] = 1;
        }
      }
      __syncthreads();
      // phase 2: each touched row adds its summed delta once, one warp per
      // row; the warp then clears the row's delta and flag
      for (int row = warp; row < bu + bi; row += kWarps) {
        if (!flags[row]) continue;  // warp-uniform
        float* tab = row < bu ? U + static_cast<size_t>(row) * k
                              : I + static_cast<size_t>(row - bu) * k;
        float* del = dU + static_cast<size_t>(row) * k;  // dI follows dU
        for (int d = ln; d < k; d += 32) {
          tab[d] = __fadd_rn(tab[d], del[d]);
          del[d] = 0.f;
        }
        __syncwarp();
        if (ln == 0) flags[row] = 0;
      }
      __syncthreads();
    }
  }
}

struct Args {
  float* u_tab;
  float* i_tab;
  const int* u_loc;
  const int* i_loc;
  const float* vals;
  const float* wts;
  const float* cnu;
  const float* cni;
  const int* lam;
  const int4* lanes;
  int n_ctas, cells_per_cta, S, bs, bu, bi, k;
  float neg_lr, two_ureg, two_ireg;
  float* scratch;
  cudaStream_t stream;
};

template <bool MMBF16, bool CN, bool MASK, bool SMEM>
cudaError_t launch(const Args& a) {
  auto kernel = cell_sgd_kernel<MMBF16, CN, MASK, SMEM>;
  const size_t bytes =
      SMEM ? delta_floats(a.bu, a.bi, a.k) * sizeof(float) +
                 flag_bytes(a.bu, a.bi)
           : flag_bytes(a.bu, a.bi);
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<a.n_ctas, kThreads, bytes, a.stream>>>(
      a.u_tab, a.i_tab, a.u_loc, a.i_loc, a.vals, a.wts, a.cnu, a.cni, a.lam,
      a.lanes, a.cells_per_cta, a.S, a.bs, a.bu, a.bi, a.k, a.neg_lr,
      a.two_ureg, a.two_ireg, a.scratch);
  return cudaGetLastError();
}

template <bool MMBF16, bool CN, bool MASK>
cudaError_t pick_route(const Args& a) {
  return a.scratch ? launch<MMBF16, CN, MASK, false>(a)
                   : launch<MMBF16, CN, MASK, true>(a);
}

template <bool MMBF16, bool CN>
cudaError_t pick_mask(const Args& a, int use_mask) {
  return use_mask ? pick_route<MMBF16, CN, true>(a)
                  : pick_route<MMBF16, CN, false>(a);
}

template <bool MMBF16>
cudaError_t pick_cn(const Args& a, int cn, int use_mask) {
  return cn ? pick_mask<MMBF16, true>(a, use_mask)
            : pick_mask<MMBF16, false>(a, use_mask);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a CTA of the shared-memory route needs:
// the [bu + bi, k] f32 deltas and bu + bi touched-row flags.
size_t block_sgd_smem_bytes(int bu, int bi, int k) {
  return delta_floats(bu, bi, k) * sizeof(float) + flag_bytes(bu, bi);
}

// f32 values of global scratch a launch of n_ctas CTAs needs: 0 when the
// deltas fit shared memory (the shared-memory route), else one zeroed
// [bu + bi, k] slice per CTA.
size_t block_sgd_scratch_floats(int n_ctas, int bu, int bi, int k) {
  if (deltas_fit_smem(bu, bi, k)) return 0;
  return static_cast<size_t>(n_ctas) * delta_floats(bu, bi, k);
}

// One launch on `stream`. u_tab [*, k] and i_tab [*, k] f32 hold the
// blocks (block b at row b * bu / b * bi); the streams are [n_rows, S]
// (u_loc, i_loc, lam int32; vals, wts, cnu, cni f32; cnu / cni read only
// when collision_norm, lam only when use_mask). `lanes` is a device array
// of n_ctas * cells_per_cta int4 (user block, item block, stream row,
// batch offset). `scratch` is null for the shared-memory route, else
// block_sgd_scratch_floats(n_ctas, bu, bi, k) zeroed f32. neg_lr = -lr,
// two_ureg = 2 * u_reg, two_ireg = 2 * i_reg, each rounded to f32.
// Returns the cudaError_t of the launch.
int block_sgd_run(int mm_bf16, int collision_norm, int use_mask, void* u_tab,
                  void* i_tab, const void* u_loc, const void* i_loc,
                  const void* vals, const void* wts, const void* cnu,
                  const void* cni, const void* lam, const void* lanes,
                  int n_ctas, int cells_per_cta, int S, int bs, int bu,
                  int bi, int k, float neg_lr, float two_ureg,
                  float two_ireg, void* scratch, void* stream) {
  if (n_ctas <= 0 || cells_per_cta <= 0 || bs <= 0 || S <= 0 || S % bs ||
      bu <= 0 || bi <= 0 || k <= 0 || k > kMaxK)
    return cudaErrorInvalidValue;
  if ((collision_norm && (!cnu || !cni)) || (use_mask && !lam))
    return cudaErrorInvalidValue;
  if (!scratch && !deltas_fit_smem(bu, bi, k)) return cudaErrorInvalidValue;
  Args a{static_cast<float*>(u_tab),
         static_cast<float*>(i_tab),
         static_cast<const int*>(u_loc),
         static_cast<const int*>(i_loc),
         static_cast<const float*>(vals),
         static_cast<const float*>(wts),
         static_cast<const float*>(cnu),
         static_cast<const float*>(cni),
         static_cast<const int*>(lam),
         static_cast<const int4*>(lanes),
         n_ctas,
         cells_per_cta,
         S,
         bs,
         bu,
         bi,
         k,
         neg_lr,
         two_ureg,
         two_ireg,
         static_cast<float*>(scratch),
         static_cast<cudaStream_t>(stream)};
  return mm_bf16 ? pick_cn<true>(a, collision_norm, use_mask)
                 : pick_cn<false>(a, collision_norm, use_mask);
}

const char* block_sgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
