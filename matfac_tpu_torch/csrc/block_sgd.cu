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
// ONE launch runs a whole epoch (or one fused_cell_update call). It walks a
// device table of LANES, int4 (user block, item block, stream row, batch
// offset; user block -1 for a dummy lane), laid out [n_rounds, n_par]:
//   * diag schedule: one round per DSGD round, n_par = G lanes, disjoint in
//     both axes within a round; a grid-wide barrier between rounds;
//   * row schedule: n_par = 1, one round per cell in the epoch's order (user
//     rows in row_of order, each sweeping its cells in ib_seq order): one
//     serial chain, since U is shared along a row and I across rows (the
//     TPU kernel's sequential grid);
//   * fused_cell_update: one round of one lane.
//
// Each lane runs on a thread-block CLUSTER of C CTAs (1024 threads each).
// Cluster q takes the lanes q, q + Q, ... of every round; the Q clusters
// are all co-resident (the host checks with cudaOccupancyMaxActiveClusters
// and refuses a grid that is not: the round barrier would deadlock; a grid
// of several clusters is a cooperative launch, so CUDA holds it to that
// beside other work on the card too). The barrier's two counters
// serve one stream: launches on several streams each need their own.
// Within a lane, minibatch s of n_steps = S / bs reads the stream slice
// starting at ((s + boff) % n_steps) * bs and does, per rating,
//   pu = U[u], qi = I[i]                 (bf16-rounded when mm_bf16)
//   pred = sum_{d < lam} pu qi,  coeff = w (r - pred),  vm = (w > 0)
//   gu = -2 coeff qi + 2 u_reg vm pu,   gi = -2 coeff pu + 2 i_reg vm qi
//   (times the rank mask; divided by the host-staged counts when cn)
//   dU[u] += bf16?(-lr gu),  dI[i] += bf16?(-lr gi)
// then, after EVERY gather of the step (a cluster barrier), U += dU and
// I += dI once per touched row. So all gathers read the pre-step blocks,
// each row adds the f32 sum of its (rounded) terms once, and repeated ids
// within a batch are handled, as the one-hot products of the TPU kernel do.
// Every elementwise step uses __f*_rn intrinsics (no FMA contraction), so
// given the same pred, each term rounds exactly as the plain PyTorch
// version's separate tensor ops do; only the order of the sums (pred over
// k, the per-row delta sums) differs.
//
// The step (the measurements behind each choice: scripts/torch_block_micro.py
// and PERF.md, which also lists the designs tried and not kept):
//   * NO ATOMICS. An f32 add into shared or distributed shared memory is a
//     CAS loop on this card (ATOMS.CAST.SPIN), and the adds into L2 are
//     bound by its atomic rate; both bounded the first designs. Instead the
//     wrapper stages every batch slice twice (block_sgd_kernel.
//     slice_tables): its valid slots sorted by user row and by item row
//     (stable), with per-slot metadata (other row | lam << 16, r, w, the
//     side's collision count), each slot's own row and SEGMENT, and one
//     entry per touched row.
//   * RANGES. A group of 16 lanes (32 at k > 64) takes a range of 8
//     sorted slots of one side (4 where ranges of 8 would leave groups
//     idle, as at one lane): one coalesced load of their metadata, the own
//     and partner rows of 4 slots in flight (ld.global.cg, from L2: other
//     CTAs write them between steps and rounds), each slot's prediction
//     (fma is symmetric, so both sides of a rating get it bit for bit), its
//     term summed in registers while the own row stays the same. A SEGMENT
//     is a run of one row within a range; its sum goes once to its slot in
//     the cluster's distributed shared memory (or the global scratch).
//     Every group gets the same slots whatever the rows' degrees, so the
//     hot items of power-law data do not serialise a step.
//   * APPLY. After a cluster barrier, one group per touched row adds the
//     row's segment sums, in order, to the row once; a fence and a second
//     cluster barrier end the step.
//   * the step's ranges and rows are spread over the cluster's C CTAs;
//     block_sgd_plan picks C (2 for the diag schedule's 53 lanes, 16 for
//     the row schedule's one chain), the range and the scratch route, where
//     a CTA's share of the segment sums misses its shared memory even at
//     C = 16.
//   * a step whose slice holds no valid slot is skipped: exact, such a step
//     adds nothing and touches no row.
//
// What bounds it: per step, a chain of slice loads -> row gathers from L2
// -> segment sums -> cluster barrier -> apply (L2 read + write) -> cluster
// barrier; at the diag schedule's 53 lanes the row gathers come near the
// L2's bandwidth (4 rows of k floats a slot). The diag epoch is 265 such
// rounds at the bench's full shape, the row epoch ~nnz / bs steps.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 256;
constexpr int kMaxCluster = 16;     // non-portable above 8
constexpr int kAutoCluster = 8;     // the portable limit: the plan's ceiling
constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on H100
constexpr int kMaxRange = 8;        // sorted slots a lane group takes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 32767;     // a block's rows: 15 bits of an entry
constexpr int kMaxBatch = 16384;    // slots of a batch: segments in 15 bits

// kRouteCluster: the segment sums in the cluster's shared memory;
// kRouteScratch: in a global scratch
enum { kRouteCluster = 0, kRouteScratch = 1 };

struct Params {
  float* u_tab;
  float* i_tab;
  const int4* meta_u;   // [slices, bs] by user row: (item | lam << 16, r, w,
  const int4* meta_i;   //   cnu); by item row: (user | lam << 16, r, w, cni)
  const short* own_u;   // [slices, bs] the sorted slots' own rows
  const short* own_i;
  const short* seg_u;   // [slices, bs] the sorted slots' segments
  const short* seg_i;
  const int* ent_u;     // [slices, bs] (first segment << 16) | row, a row
  const int* ent_i;     //   each
  const int4* cnt;      // [slices, 2] (user rows, item rows, valid slots,
                        //   user segments), (item segments, 0, 0, 0)
  const int4* lanes;    // [n_rounds, n_par]
  int n_rounds, n_par, n_batch, bs, bu, bi, k;
  int lc;               // log2 of the cluster size
  int mm_bf16, cn, mask;
  float neg_lr, two_ureg, two_ireg;
  int part_rows;        // segment sums a CTA holds
  int range;            // sorted slots a lane group takes: 4 or 8
  float* scratch;       // scratch route: [Q, part_rows * C, k]
  unsigned* bar;        // round barrier: arrivals, generation
  unsigned long long* cells;   // (lane, cell) pairs finished
  float* sink;          // a cut stage's one possible write
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA of the grid, all co-resident (checked by the host). Thread 0
// fences after the block barrier (fences are cumulative), so the CTA's
// writes reach the others; the reads after it go to L2.
__device__ void grid_barrier(unsigned* bar, unsigned n_ctas) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == n_ctas - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // bounded: a barrier that never opens (a fault elsewhere) traps
      // after ~10 s instead of hanging the card
      for (long long spin = 0; ld_acquire(bar + 1) == gen; ++spin)
        if (spin > (1ll << 27)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// segments of one slice, at most: every row of both blocks once, plus one
// more for every range of `range` sorted slots of each side
inline size_t max_entries(int bs, int bu, int bi, int range) {
  const size_t extra = 2 * ((static_cast<size_t>(bs) + range - 1) / range);
  return std::min<size_t>(bs, bu) + std::min<size_t>(bs, bi) + extra;
}

// segment sums one CTA of a cluster of C holds
inline size_t part_rows(int bs, int bu, int bi, int C, int range) {
  return (max_entries(bs, bu, bi, range) + C - 1) / C;
}

// dynamic shared memory of one CTA: its segment sums (cluster route)
inline size_t smem_bytes(int route, int bs, int bu, int bi, int k, int C,
                         int range) {
  return route == kRouteCluster
             ? part_rows(bs, bu, bi, C, range) * k * sizeof(float)
             : 0;
}

// ST: the stage the step is cut after (block_sgd_ablate): 0 the slices
// (sorted slot metadata), 1 + row gathers and the predictions, 2 + the
// segment sums, 3 full (the apply). A slot is served by LPR lanes holding
// EPL elements each (k <= LPR * EPL); RIF slots' rows are in flight per
// lane group. Every loop is warp-uniform: the groups of a warp step
// together, idle ones predicated off.
template <int LPR, int EPL, bool DSM, int ST>
__global__ void __launch_bounds__(kThreads, 1) cell_sgd_kernel(const Params p) {
  constexpr int G = 32 / LPR;              // lane groups per warp
  constexpr int RIF = EPL <= 4 ? 4 : 2;    // slots in flight per group
  extern __shared__ __align__(16) float partial[];   // [part_rows, k]
  cg::cluster_group cluster = cg::this_cluster();
  const int lc = p.lc;
  const int C = 1 << lc;
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = p.k;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int grp = ln / LPR;     // lane group within the warp
  const int gl = ln % LPR;      // lane within the group
  const int n_grp = (kWarps * G) << lc;          // groups of the cluster
  const int wbase = (rank * kWarps + warp) * G;  // this warp's first group
  const int cl = blockIdx.x >> lc;
  const int n_cl = gridDim.x >> lc;
  // scratch route: the cluster's segment sums [part_rows << lc, k]
  float* gpart = DSM ? nullptr
                     : p.scratch + (static_cast<size_t>(cl) * p.part_rows
                                    << lc) * k;
  const int nb = p.n_batch;
  float acc0 = 0.f;
  // distributed shared memory is touched only once every CTA has started
  cluster.sync();

  for (int t = 0; t < p.n_rounds; ++t) {
    for (int slot = cl; slot < p.n_par; slot += n_cl) {
      const int4 lane = p.lanes[static_cast<size_t>(t) * p.n_par + slot];
      if (lane.x < 0) continue;   // dummy lane
      float* U = p.u_tab + static_cast<size_t>(lane.x) * p.bu * k;
      float* I = p.i_tab + static_cast<size_t>(lane.y) * p.bi * k;
      for (int s = 0; s < nb; ++s) {
        const size_t sl = static_cast<size_t>(lane.z) * nb + (s + lane.w) % nb;
        const int4 c0 = p.cnt[2 * sl];
        if (c0.z == 0) continue;   // all padding: adds nothing
        const int segs_u = c0.w;
        const int segs_i = p.cnt[2 * sl + 1].x;
        const int rg = p.range;
        const int R = (c0.z + rg - 1) / rg;   // ranges a side
        const size_t base = sl * p.bs;
        // ---- ranges: each segment's terms summed from the pre-step blocks
        for (int q0 = wbase; q0 < 2 * R; q0 += n_grp) {
          const int q = q0 + grp;
          const bool is_i = q >= R;
          const int pos0 = (is_i ? q - R : q) * rg;
          const int n = q < 2 * R ? min(rg, c0.z - pos0) : 0;
          const int4* meta = (is_i ? p.meta_i : p.meta_u) + base + pos0;
          const short* ownr = (is_i ? p.own_i : p.own_u) + base + pos0;
          const short* segr = (is_i ? p.seg_i : p.seg_u) + base + pos0;
          int4 mt = make_int4(0, 0, 0, 0);
          int own = 0, sg = 0;
          if (gl < n) {
            mt = meta[gl];
            own = ownr[gl];
            sg = segr[gl];
          }
          if (ST == 0) {
            acc0 += __int_as_float(mt.y) + __int_as_float(mt.z) +
                    __int_as_float(mt.w) + static_cast<float>(mt.x + own + sg);
            continue;
          }
          const float* own_tab = is_i ? I : U;
          const float* oth_tab = is_i ? U : I;
          const float two_reg = is_i ? p.two_ireg : p.two_ureg;
          const int seg0 = is_i ? segs_u : 0;
          float acc[EPL];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
#pragma unroll 1
          for (int x0 = 0; x0 < rg; x0 += RIF) {
            if (!__any_sync(kFull, x0 < n)) break;   // warp-uniform
            float po[RIF][EPL], pp[RIF][EPL];
#pragma unroll
            for (int x = 0; x < RIF; ++x) {
              const int j = x0 + x;
              const bool act = j < n;
              const int jj = act ? j : 0;
              const int o = __shfl_sync(kFull, own, jj, LPR);
              const int qx = __shfl_sync(kFull, mt.x, jj, LPR) & 0xffff;
              const float* orow = own_tab + static_cast<size_t>(o) * k;
              const float* prow = oth_tab + static_cast<size_t>(qx) * k;
#pragma unroll
              for (int e = 0; e < EPL; ++e) {
                const int d = gl + LPR * e;
                const bool ok = act && d < k;
                po[x][e] = ok ? __ldcg(orow + d) : 0.f;
                pp[x][e] = ok ? __ldcg(prow + d) : 0.f;
              }
            }
#pragma unroll
            for (int x = 0; x < RIF; ++x) {
              const int j = x0 + x;
              const bool act = j < n;
              const int jj = act ? j : 0;
              const int px = __shfl_sync(kFull, mt.x, jj, LPR);
              const float r = __int_as_float(__shfl_sync(kFull, mt.y, jj, LPR));
              const float w = __int_as_float(__shfl_sync(kFull, mt.z, jj, LPR));
              const float cv = __int_as_float(__shfl_sync(kFull, mt.w, jj, LPR));
              const int o = __shfl_sync(kFull, own, jj, LPR);
              const int sj = __shfl_sync(kFull, sg, jj, LPR);
              const int on = __shfl_sync(kFull, own, min(j + 1, rg - 1), LPR);
              // the segment's last slot: its sum is whole
              const bool last = act && (j + 1 >= n || on != o);
              const int lm = p.mask ? (px >> 16) : k;
              float part = 0.f;
#pragma unroll
              for (int e = 0; e < EPL; ++e) {
                const int d = gl + LPR * e;
                if (p.mm_bf16) {
                  po[x][e] = bf16_round(po[x][e]);
                  pp[x][e] = bf16_round(pp[x][e]);
                }
                // fma is symmetric in its factors: the user and the item
                // side of a rating get the same prediction bit for bit
                if (d < k && d < lm) part = fmaf(po[x][e], pp[x][e], part);
              }
#pragma unroll
              for (int sh = LPR / 2; sh > 0; sh >>= 1)
                part += __shfl_xor_sync(kFull, part, sh, LPR);
              const float coeff = __fmul_rn(w, __fsub_rn(r, part));
              if (ST == 1) {
                acc0 += act ? coeff : 0.f;
                continue;
              }
              const float vm = w > 0.f ? 1.f : 0.f;
              const float c2 = __fmul_rn(-2.f, coeff);
              const float rv = __fmul_rn(two_reg, vm);
#pragma unroll
              for (int e = 0; e < EPL; ++e) {
                const int d = gl + LPR * e;
                // user: -2 coeff qi + 2 u_reg vm pu; item: -2 coeff pu +
                // 2 i_reg vm qi (the own row second, as the plain one)
                float g = __fadd_rn(__fmul_rn(c2, pp[x][e]),
                                    __fmul_rn(rv, po[x][e]));
                if (p.mask) g = __fmul_rn(g, d < lm ? 1.f : 0.f);
                if (p.cn) g = __fdiv_rn(g, cv);
                float tm = __fmul_rn(p.neg_lr, g);
                if (p.mm_bf16) tm = bf16_round(tm);
                if (act) acc[e] = __fadd_rn(acc[e], tm);
              }
              if (last) {
                const int m = seg0 + sj;
                float* dst =
                    DSM ? cluster.map_shared_rank(
                              partial + static_cast<size_t>(m >> lc) * k,
                              m & (C - 1))
                        : gpart + static_cast<size_t>(m) * k;
#pragma unroll
                for (int e = 0; e < EPL; ++e) {
                  const int d = gl + LPR * e;
                  if (d < k) dst[d] = acc[e];
                  acc[e] = 0.f;
                }
              }
            }
          }
        }
        cluster.sync();   // every segment's sum is in place
        if (ST == 3) {
          // ---- apply: each touched row adds its segment sums, in order,
          // once
          const int rows_u = c0.x;
          const int n_ent = rows_u + c0.y;
          for (int e0 = wbase; e0 < n_ent; e0 += n_grp) {
            const int e = e0 + grp;
            const bool act = e < n_ent;
            const bool is_i = e >= rows_u;
            const int es = is_i ? e - rows_u : e;
            const int* ent = (is_i ? p.ent_i : p.ent_u) + base;
            const int n_rows_side = is_i ? c0.y : rows_u;
            const int pk = act ? ent[es] : 0;
            const int first = pk >> 16;
            const int nseg =
                act ? (es + 1 < n_rows_side ? ent[es + 1] >> 16
                                            : (is_i ? segs_i : segs_u)) -
                          first
                    : 0;
            const int m0 = first + (is_i ? segs_u : 0);
            const int nmax = __reduce_max_sync(kFull, nseg);
            float sum[EPL];
#pragma unroll
            for (int e2 = 0; e2 < EPL; ++e2) sum[e2] = 0.f;
            for (int j = 0; j < nmax; ++j) {
              if (j >= nseg) continue;
              const int m = m0 + j;
              const float* src =
                  DSM ? cluster.map_shared_rank(
                            partial + static_cast<size_t>(m >> lc) * k,
                            m & (C - 1))
                      : gpart + static_cast<size_t>(m) * k;
#pragma unroll
              for (int e2 = 0; e2 < EPL; ++e2) {
                const int d = gl + LPR * e2;
                if (d < k)
                  sum[e2] = __fadd_rn(sum[e2], DSM ? src[d] : __ldcg(src + d));
              }
            }
            if (act) {
              float* tab = (is_i ? I : U) +
                           static_cast<size_t>(pk & 0x7fff) * k;
#pragma unroll
              for (int e2 = 0; e2 < EPL; ++e2) {
                const int d = gl + LPR * e2;
                if (d < k) tab[d] = __fadd_rn(__ldcg(tab + d), sum[e2]);
              }
            }
          }
          __threadfence();   // the rows reach L2 before the barrier
        }
        cluster.sync();   // the next gathers see the stepped blocks
      }
      if (rank == 0 && tid == 0) atomicAdd(p.cells, 1ull);
    }
    if (n_cl > 1 && t + 1 < p.n_rounds) grid_barrier(p.bar, gridDim.x);
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  if (ST < 2 && acc0 == 1.2345e-30f) p.sink[0] = acc0;  // keeps the loads
}

using KernelFn = void (*)(const Params);

template <int ST>
KernelFn pick(int k, bool dsm) {
  if constexpr (ST == 3) {
    if (k <= 16) return dsm ? cell_sgd_kernel<16, 1, true, 3>
                            : cell_sgd_kernel<16, 1, false, 3>;
    if (k <= 32) return dsm ? cell_sgd_kernel<16, 2, true, 3>
                            : cell_sgd_kernel<16, 2, false, 3>;
    if (k <= 64) return dsm ? cell_sgd_kernel<16, 4, true, 3>
                            : cell_sgd_kernel<16, 4, false, 3>;
    if (k <= 128) return dsm ? cell_sgd_kernel<32, 4, true, 3>
                             : cell_sgd_kernel<32, 4, false, 3>;
    return dsm ? cell_sgd_kernel<32, 8, true, 3>
               : cell_sgd_kernel<32, 8, false, 3>;
  } else {
    // the probe's shapes only (k <= 128)
    if (k <= 64) return dsm ? cell_sgd_kernel<16, 4, true, ST>
                            : cell_sgd_kernel<16, 4, false, ST>;
    if (k <= 128) return dsm ? cell_sgd_kernel<32, 4, true, ST>
                             : cell_sgd_kernel<32, 4, false, ST>;
    return nullptr;
  }
}

// attributes set and co-resident clusters asked once per configuration
struct Seen {
  int dev;
  KernelFn fn;
  int C;
  size_t smem;
  int max_clusters;
};
std::mutex seen_mu;
Seen seen[64];
int n_seen = 0;

cudaError_t prepare(KernelFn fn, int C, size_t smem, int* max_clusters) {
  std::lock_guard<std::mutex> lock(seen_mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int s = 0; s < n_seen; ++s)
    if (seen[s].dev == dev && seen[s].fn == fn && seen[s].C == C &&
        seen[s].smem == smem) {
      *max_clusters = seen[s].max_clusters;
      return cudaSuccess;
    }
  // the cap, not the size: a launch asks for its own bytes below it
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int mx = 0;
  err = cudaOccupancyMaxActiveClusters(&mx, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (n_seen < 64) seen[n_seen++] = Seen{dev, fn, C, smem, mx};
  *max_clusters = mx;
  return cudaSuccess;
}

bool pow2_cluster(int C) {
  return C >= 1 && C <= kMaxCluster && (C & (C - 1)) == 0;
}

int route_of(int bs, int bu, int bi, int k, int C, int range) {
  return smem_bytes(kRouteCluster, bs, bu, bi, k, C, range) <= kMaxSmem
             ? kRouteCluster
             : kRouteScratch;
}

// out = {route, C, clusters Q, shared bytes per CTA, co-resident clusters,
// range}
cudaError_t plan(int n_par, int bs, int bu, int bi, int k, int want_C,
                 int* out) {
  if (n_par <= 0 || bs <= 0 || bs > kMaxBatch || bu <= 0 || bi <= 0 ||
      bu > kMaxRows || bi > kMaxRows || k <= 0 || k > kMaxK ||
      (want_C && !pow2_cluster(want_C)))
    return cudaErrorInvalidValue;
  int C = want_C;
  if (!C) {
    // the smallest cluster whose shared memory holds the segment sums...
    int fit = 0;
    for (int c = 1; c <= kMaxCluster && !fit; c *= 2)
      if (route_of(bs, bu, bi, k, c, kMaxRange) == kRouteCluster) fit = c;
    C = fit ? fit : 1;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // ...grown to spread the step: one chain takes 8 SMs; parallel lanes
    // double C while every lane still has SMs of its own
    if (n_par == 1)
      C = C < kAutoCluster ? kAutoCluster : C;
    else
      while (C * 2 <= kAutoCluster &&
             static_cast<long>(n_par) * C * 2 <= n_sm)
        C *= 2;
  }
  // ranges of 8 slots, or of 4 where those would leave lane groups idle
  auto settle = [&](int c) -> cudaError_t {
    const int groups = kWarps * (k <= 64 ? 2 : 1) * c;
    int range = kMaxRange;
    if (2 * ((bs + kMaxRange - 1) / kMaxRange) < groups &&
        route_of(bs, bu, bi, k, c, kMaxRange / 2) ==
            route_of(bs, bu, bi, k, c, kMaxRange))
      range = kMaxRange / 2;
    const int route = route_of(bs, bu, bi, k, c, range);
    const size_t smem = smem_bytes(route, bs, bu, bi, k, c, range);
    int mx = 0;
    cudaError_t e = prepare(pick<3>(k, route == kRouteCluster), c, smem, &mx);
    out[0] = route;
    out[1] = c;
    out[2] = n_par < mx ? n_par : mx;
    out[3] = static_cast<int>(smem);
    out[4] = mx;
    out[5] = range;
    return e;
  };
  // one chain takes 16 CTAs where the card can host such a cluster
  if (n_par == 1 && !want_C) {
    if (settle(kMaxCluster) == cudaSuccess && out[4] > 0) return cudaSuccess;
    (void)cudaGetLastError();   // a refused size leaves no error behind
  }
  cudaError_t err = settle(C);
  if (err != cudaSuccess) return err;
  return out[4] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int ST>
cudaError_t launch(Params prm, int C, int n_clusters, int range,
                   cudaStream_t stream) {
  if (!pow2_cluster(C) || n_clusters <= 0 ||
      (range != kMaxRange && range != kMaxRange / 2))
    return cudaErrorInvalidValue;
  const int route = route_of(prm.bs, prm.bu, prm.bi, prm.k, C, range);
  if ((route == kRouteScratch) != (prm.scratch != nullptr))
    return cudaErrorInvalidValue;
  KernelFn fn = pick<ST>(prm.k, route == kRouteCluster);
  if (!fn) return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(route, prm.bs, prm.bu, prm.bi, prm.k, C, range);
  int mx = 0;
  cudaError_t err = prepare(fn, C, smem, &mx);
  if (err != cudaSuccess) return err;
  // the round barrier needs every CTA of the grid resident at once
  if (n_clusters > mx) return cudaErrorCooperativeLaunchTooLarge;
  int lc = 0;
  while ((1 << lc) < C) ++lc;
  prm.lc = lc;
  prm.range = range;
  prm.part_rows =
      static_cast<int>(part_rows(prm.bs, prm.bu, prm.bi, C, range));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a grid of several clusters meets at the round barrier: a cooperative
  // launch is scheduled all at once, beside whatever else runs on the
  // card, or refused (cudaErrorCooperativeLaunchTooLarge)
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(n_clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n_clusters > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, fn, prm);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan of n_par parallel lanes of bs-slot steps on (bu, bi)
// blocks of k columns, at cluster size want_C (0: chosen here). out[6] =
// {route (0: the segment sums in the cluster's shared memory, 1: in a
// global scratch), cluster size C, clusters to launch Q (at most the
// co-resident ones; each takes every Q-th lane of a round), shared bytes
// per CTA, co-resident clusters, range (sorted slots a lane group takes:
// 8, or 4 where ranges of 8 would be fewer than the cluster's lane
// groups)}. The route is the cluster's shared memory when a CTA's share of
// a step's segment sums fits the opt-in limit, else the scratch. Auto C:
// for one lane 16 where the card can host a cluster of 16, else the
// smallest that fits raised to 8; for several, the smallest that fits,
// doubled (up to 8) while n_par * 2C <= the SM count.
int block_sgd_plan(int n_par, int bs, int bu, int bi, int k, int want_C,
                   int* out) {
  return plan(n_par, bs, bu, bi, k, want_C, out);
}

// f32 values of global scratch a launch of n_clusters clusters of C at
// `range` needs: 0 on the cluster route, else n_clusters * C * part_rows *
// k (the kernel writes each sum before it reads it).
size_t block_sgd_scratch_floats(int n_clusters, int C, int bs, int bu, int bi,
                                int k, int range) {
  if (!pow2_cluster(C) || n_clusters <= 0 || bs <= 0 || k <= 0 ||
      range <= 0)
    return 0;
  if (route_of(bs, bu, bi, k, C, range) == kRouteCluster) return 0;
  return static_cast<size_t>(n_clusters) * C *
         part_rows(bs, bu, bi, C, range) * k;
}

// One launch on `stream` for a whole epoch (or call). u_tab [*, k] and
// i_tab [*, k] f32 hold the blocks (block b at row b * bu / b * bi). The
// staged slices (block_sgd_kernel.slice_tables), slice = stream row *
// n_batch + batch, each side's valid slots sorted by row (stable):
// meta_u / meta_i [slices, bs] int4 (other row | lam << 16, then the f32
// bits of r, w and the side's collision count); own_u / own_i [slices, bs]
// int16, the slots' own rows; seg_u / seg_i [slices, bs] int16, their
// segments (runs of one row within a range of `range` sorted slots,
// numbered per side; the slices staged for the plan's range); ent_u /
// ent_i [slices, bs] int32, one entry a touched row: (its first segment <<
// 16) | row; cnt [slices, 2] int4 (user rows, item rows, valid slots, user
// segments), (item segments, 0, 0, 0). `lanes`: n_rounds * n_par int4 on
// the device (user block or -1, item block, stream row, batch offset). C,
// n_clusters and range as block_sgd_plan gives them; `scratch` null on the
// cluster route, else block_sgd_scratch_floats f32. `bar`: two uint32,
// zeroed once (the kernel leaves the arrivals at 0 and steps a generation
// count), one per stream, as is the scratch; `cells`: a uint64 the kernel
// adds each
// finished (lane, cell) to. neg_lr = -lr, two_ureg = 2 * u_reg, two_ireg =
// 2 * i_reg, each rounded to f32. Returns the cudaError_t of the launch:
// cudaErrorCooperativeLaunchTooLarge when the n_clusters clusters cannot
// all be resident at once.
int block_sgd_run(int mm_bf16, int collision_norm, int use_mask, void* u_tab,
                  void* i_tab, const void* meta_u, const void* meta_i,
                  const void* own_u, const void* own_i, const void* seg_u,
                  const void* seg_i, const void* ent_u, const void* ent_i,
                  const void* cnt, const void* lanes, int n_rounds, int n_par,
                  int n_batch, int bs, int bu, int bi, int k, float neg_lr,
                  float two_ureg, float two_ireg, int C, int n_clusters,
                  int range, void* scratch, void* bar, void* cells,
                  void* stream) {
  if (n_rounds <= 0 || n_par <= 0 || n_batch <= 0 || bs <= 0 ||
      bs > kMaxBatch || bu <= 0 || bi <= 0 || bu > kMaxRows ||
      bi > kMaxRows || k <= 0 || k > kMaxK || !meta_u || !meta_i || !own_u ||
      !own_i || !seg_u || !seg_i || !ent_u || !ent_i || !cnt || !lanes ||
      !bar || !cells)
    return cudaErrorInvalidValue;
  Params prm{static_cast<float*>(u_tab),
             static_cast<float*>(i_tab),
             static_cast<const int4*>(meta_u),
             static_cast<const int4*>(meta_i),
             static_cast<const short*>(own_u),
             static_cast<const short*>(own_i),
             static_cast<const short*>(seg_u),
             static_cast<const short*>(seg_i),
             static_cast<const int*>(ent_u),
             static_cast<const int*>(ent_i),
             static_cast<const int4*>(cnt),
             static_cast<const int4*>(lanes),
             n_rounds, n_par, n_batch, bs, bu, bi, k, 0,
             mm_bf16 != 0, collision_norm != 0, use_mask != 0,
             neg_lr, two_ureg, two_ireg, 0, 0,
             static_cast<float*>(scratch),
             static_cast<unsigned*>(bar),
             static_cast<unsigned long long*>(cells),
             nullptr};
  return launch<3>(prm, C, n_clusters, range,
                   static_cast<cudaStream_t>(stream));
}

// The probe's entry (scripts/torch_block_micro.py): the bf16-product,
// no-norm, no-mask kernel cut after `stage` (0 the sorted slices, 1 + row
// gathers and the predictions, 2 + the segment sums, 3 full), k <= 128,
// over a [n_rounds, n_par] lane table in one launch, staged slices as for
// block_sgd_run (for the plan's range), at cluster size `cluster` (0: the
// auto plan's).
// `work`: 32 zeroed bytes (the round barrier, then a cell count); `sink`:
// one float a cut stage might write.
int block_sgd_ablate(int stage, void* u_tab, void* i_tab, const void* meta_u,
                     const void* meta_i, const void* own_u, const void* own_i,
                     const void* seg_u, const void* seg_i, const void* ent_u,
                     const void* ent_i, const void* cnt, const void* lanes,
                     int n_rounds, int n_par, int n_batch, int bs, int bu,
                     int bi, int k, float neg_lr, float two_ureg,
                     float two_ireg, void* scratch, void* work, void* sink,
                     void* stream, int cluster) {
  if (stage < 0 || stage > 3 || !work || !meta_u || !meta_i || !own_u ||
      !own_i || !seg_u || !seg_i || !ent_u || !ent_i || !cnt || !lanes ||
      n_rounds <= 0 || n_batch <= 0)
    return cudaErrorInvalidValue;
  int out[6];
  cudaError_t err = plan(n_par, bs, bu, bi, k, cluster, out);
  if (err != cudaSuccess) return err;
  unsigned char* w = static_cast<unsigned char*>(work);
  Params prm{static_cast<float*>(u_tab),
             static_cast<float*>(i_tab),
             static_cast<const int4*>(meta_u),
             static_cast<const int4*>(meta_i),
             static_cast<const short*>(own_u),
             static_cast<const short*>(own_i),
             static_cast<const short*>(seg_u),
             static_cast<const short*>(seg_i),
             static_cast<const int*>(ent_u),
             static_cast<const int*>(ent_i),
             static_cast<const int4*>(cnt),
             static_cast<const int4*>(lanes),
             n_rounds, n_par, n_batch, bs, bu, bi, k, 0, 1, 0, 0,
             neg_lr, two_ureg, two_ireg, 0, 0,
             static_cast<float*>(scratch),
             reinterpret_cast<unsigned*>(w),
             reinterpret_cast<unsigned long long*>(w + 16),
             static_cast<float*>(sink)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return launch<0>(prm, out[1], out[2], out[5], st);
    case 1: return launch<1>(prm, out[1], out[2], out[5], st);
    case 2: return launch<2>(prm, out[1], out[2], out[5], st);
    default: return launch<3>(prm, out[1], out[2], out[5], st);
  }
}

const char* block_sgd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
