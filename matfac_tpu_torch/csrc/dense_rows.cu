// Row-stripe dense SGD epoch on Hopper (sm_90a): bf16 tensor cores.
//
// Replaces the two Pallas TPU kernels of matfac_tpu/ops/dense_row_kernel.py:
//   * dense_rows_epoch_pallas (float R + W tiles)   -> RT = f32 / bf16,
//                                                      WT = int8 / bf16 / f32
//   * dense_rows_codes_pallas (int8 rating codes)   -> RT = int8 codes, no W
// Each stripe step computes ops/dense_block_kernel.cell_dense_update on one
// full-catalog user stripe (U [bu,k], I [ni_pad,k], tiles [bu,ni_pad]):
//   P = U I^T,  E = W (R - P)      (codes: R = code*r_scale, W = code != 0)
//   I <- I - lr * norm(-2 E^T U_old + 2 i_reg cnt_i I_old)
//   U <- U - lr * norm(-2 E I_old   + 2 u_reg cnt_u U_old)
// with counts from validity (W > 0 / code != 0), never from the weights,
// and norm = division by max(cnt, 1) when collision_norm is set. With
// mm_bf16, U, I and E are rounded to bf16 (round to nearest even) and the
// products sum in f32; the regularization terms use the unrounded f32
// values.
//
// One C call runs a whole epoch on the caller's stream, which sequences its
// rounds (the SGD semantics of README deviation #1). A round is a set of
// cells disjoint in users and in items, each cell a (lane, user block)
// pair: a lane's item rows I_l [ni_pad, k] against a user block's rows
// U_s [bu, k] through the tile of cell t = s * lanes + l. The stripe entry
// runs one cell a round (lane 0, the whole catalog; the order array's
// stripe), the cell-grid entry all of a DSGD round's live cells (below).
// With the tensor cores the epoch first converts U to a bf16 copy, k
// zero-padded to KP (one launch: a block's U rows change only in its own
// user step, after the panel kernel has read them). Then, per round:
//   A. the panel kernel. Each cell is cut into units of (128-item panel,
//      64-user chunk), ordered (cell, panel, chunk); a persistent grid of a
//      fixed number of CTAs an SM (ctas_per_sm) gives each CTA an equal run
//      of the round's units, so every SM carries the same work whatever the
//      cell and panel counts. A CTA keeps its current (cell, panel)'s OLD
//      item rows in shared memory as bf16. Per unit, on bf16 tensor cores
//      with f32 accumulation (mma.sync.m16n8k16 fed by ldmatrix):
//        P  = U_c I_p^T    (64 x 128, K = k padded to KP, a multiple of 16)
//        Gi += E_c^T U_c   (128 x KP, in registers while the CTA stays on
//                           the (cell, panel), then added to the lane's
//                           [ni_pad, k] item gradient)
//        Gu  = E_c I_p     (64 x KP, added to the lane's [bu, k] user
//                           gradient)
//      P's accumulators never leave registers: the epilogue reads R and W
//      for each pair of elements from shared memory, forms E and stores it
//      once as bf16 to shared memory.
//   B. the step kernel steps the round's item rows and user rows from the
//      summed gradients and leaves both sums zeroed for the next round. No
//      kernel writes I or U while A reads them, so "items step from the old
//      U, users from the old I" holds.
// The validity counts (W > 0 / code != 0) depend on the tiles alone; the
// caller computes them once per tile set ([NU, bu] per user, [NU, ni_pad]
// per item) and the kernels read them.
//
// Determinism. Each CTA's partial of Gu and Gi is an f32 sum in a fixed
// order inside the CTA. It is rounded once to 64-bit fixed point (units of
// 2^-kFixBits, one scale for every epoch) and added with 64-bit integer
// atomics: integer addition is associative, so the order in which CTAs
// arrive no longer matters, and the step kernel turns each exact sum into
// f32 once. The units a CTA sums depend on the round's cell count, the
// cells' geometry and the grid alone, which is fixed by k and the card
// (not by the tile type or the run), so the same inputs give
// bit-identical factors from run to run, and int8 codes give the same
// factors as float tiles holding code * r_scale. The host bounds each
// partial so that no sum leaves +-2^60: a partial beyond that bound, or not
// finite, sets its element to kFixPoison instead, from which no sum of
// in-range partials comes back within +-2^61, and the step kernel turns it into NaN, so a diverging
// run goes non-finite as the f32 sum of the plain version does.
// A cell of at most kMaxGuSlots tensor-core panels (the cell grid's 512-item
// lanes: 4) takes Gu another way: each unit stores its f32 partial once
// in its panel's slot of a [panels, lanes, bu, k] scratch, and the step
// kernel sums a value's slots in panel order. No atomics, no zeroing, and
// the same determinism (fixed partials, fixed order). On the stripe (157
// panels at 100k x 20k) the slots would be 4.1 GB written and read an
// epoch, which an earlier version of this kernel paid for; its fixed-point
// Gu sums stay in L2 (a stripe's [bu, k] is 1.3 MB). A round of the cell
// grid sums 52 MB of Gu at 40 lanes of 2560 users, k 64, more than the
// L2, and as 64-bit REDs its Gu stage and step took 8.5 + 6.4 ms an epoch
// where the stripe's took 3.9 + 0.5 (scripts/torch_stripe_ablate.py); in
// slots, 2.8-3.1 + 3.7.
//
// Tiles and bf16 U chunks arrive in a two-stage shared-memory ring by
// cp.async 16-byte copies (zero-filled past the ragged stripe and catalog
// edges), so the next chunk loads while this chunk's products run.
// Shapes whose tile rows are not 16-byte multiples (only the small test
// shapes) take element loads into the same ring.
//
// Why mma.sync and not wgmma: the three products read one E tile in two
// orientations, P's epilogue needs each accumulator element beside its R
// and W, and K is as small as 16 (k = 10); mma.sync's explicit fragment
// layout gives all three from one shared tile via ldmatrix / ldmatrix.trans.
// What bounds the work on the card is the tile read (1-8 bytes a slot:
// 6.2 GB an epoch at 100k x 20k with bf16 R + int8 W, 1.86 ms at 3.35 TB/s),
// not the 6k FLOP a slot (0.8 ms at the bf16 tensor-core peak), so
// wgmma's higher rate is not what this kernel needs first.
//
// mm_bf16=False (f32 products: TF32 would drop bits) and k > 128 run the
// CUDA-core panel kernel (namespace cc): one CTA per (cell, 64-item panel)
// of the round walking all the cell's users, scalar f32 FMAs out of shared
// memory, the same fixed-point user gradient, and the same step kernel.
//
// Rank masks (TMF, TMF+Dropout), instantiated for int8 codes and int8 W,
// the tiles of those models' 0/1 weights. Ranks are prefixes, Mu[u, d] =
// [d < r_u], and the masked step of cell_dense_update is
//   P  = (U o Mu)(I o Mi)^T,            E as above,
//   gu = Mu o (-2 E (I o Mi))   + 2 u_reg cntm_u o U,  cntm_u = (vm Mi) o Mu
//   gi = Mi o (-2 E^T (U o Mu)) + 2 i_reg cntm_i o I,  cntm_i = (vm^T Mu) o Mi
// normalized by the UNMASKED counts. The operands the kernel stages carry
// the masks: the bf16 U copy and the item panel are zeroed at and past each
// entity's rank (exact zeros in bf16; the CUDA-core kernel zeroes its f32
// operands), so the three products run unchanged. Entity e's rank is
// qs[s][L_e - 1]: its lambda (TMF: its rank) L_e looked up in the rank row
// of stripe s's visit (TMF: 1..k; TMF+Dropout: that visit's Poisson
// quantiles, staged by the caller from the stripe order). The masked counts
// are read, not multiplied: a rank row is nondecreasing in lambda, so the
// valid partners of rank > d are those of lambda > j, j = first_above(row,
// d), which a suffix histogram of the partners' lambdas counts, staged once
// with the tiles (hist_u [NU, bu, k] int32, hist_i [NU, ni_pad, k] int16)
// and gathered by the step kernel. Chosen over two more tensor-core products
// (vm Mi and vm^T Mu, exact with 0/1 operands) because the gather adds no
// product and no accumulator to panel kernels that sit at the 128-register
// cap for KP <= 64. What the masks cost: hist_i, 2k bytes an item a stripe
// (2.6 MB a stripe at (d), ~1.7% of its bf16 R + int8 W tile), hist_u, and
// no FLOP saved (masked dims are multiplied as zeros); the tile read still
// bounds the masked epoch. At full rank the masked instantiation gives the
// unmasked factors bit for bit (sgd_value).
//
// The cell-grid entry (dense_cells_epoch) replaces the diag cell grid of
// the JAX dense engine (matfac_tpu/ops/dense_block_kernel.py:110
// dense_sweep_diag, which XLA computes there): tiles [NU * NI + 1, bu,
// bi], cell c = ub * NI + l, the dummy cell last. Each DSGD round gives
// lane l (item block l) a user block ub_idx[t][l], with the item block's
// rows as I_l and ni_pad = bi. The cells of one round are disjoint in
// users and in items, so one panel launch takes all of the round's units
// and one step launch all of its rows, from the round's old tables as JAX
// runs it: 2 launches a round (81 an epoch at 40 x 40 cells with the bf16
// copy). A dummy lane (ub = NU, the all-invalid dummy cell) leaves both
// tables as they are and contributes no unit; a round without a live cell
// launches nothing. The caller puts the epoch's live cells, (lane, ub)
// round by round, on the device once an epoch, and passes each round's
// count. The gradients are a slice a lane: Gu in per-panel slots [P, NI,
// bu, k] (above), Gi in fixed point [NI, bi, k]. Under this schedule a
// user block is visited NI
// times an epoch, so the bf16 copy of U made at the epoch's start would go
// stale after the first visit: the step kernel rewrites the block's bf16
// rows from the f32 rows it has just stepped (the same rounding the copy
// kernel does). A cell's validity counts are staged once per cell, and the
// partition (so every partial), the Gi fixed-point bound and the Gu slot
// order come from the cells' geometry and the round's cell count, so the
// epoch is bit-reproducible and codes equal float tiles as on the stripe.
// Bound: the tile read, as for the stripe (the same slots over the epoch).
//
// The ablation entry (dense_rows_ablate) runs the tensor-core kernel on
// int8 codes truncated after a stage: tile loads only, + P, + E, + item
// step, full (scripts/torch_stripe_ablate.py).
//
// Offsets into the tiles are size_t: NU * bu * ni_pad exceeds 2^31 at the
// ML-20M shape (54 * 2560 * 27008 = 3.7e9).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

enum RType { kRF32 = 0, kRBF16 = 1, kRCodes = 2 };
enum WType { kWInt8 = 0, kWBF16 = 1, kWF32 = 2 };
enum Stage { kStream = 0, kPmm = 1, kElem = 2, kItem = 3, kFull = 4 };

constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on H100
constexpr int kThreads = 256;

// Gradient sums in 64-bit fixed point: units of 2^-kFixBits (finer than an
// f32 ulp above 0.5). The host bounds each partial so that the sum of all
// of an element's partials stays within +-2^60 (fix_limit); a sum beyond
// +-kFixMax is a poisoned one.
constexpr int kFixBits = 24;
constexpr float kFixScale = static_cast<float>(1 << kFixBits);
constexpr float kFixUnit = 1.f / kFixScale;
constexpr long long kFixMax = 1LL << 61;
constexpr long long kFixPoison = -0x7fffffffffffffffLL - 1;  // INT64_MIN

// Add an f32 partial to a fixed-point sum: |x| <= lim (the host's bound for
// this many partials) keeps the sum within +-2^60; anything else
// (beyond it, or not finite) poisons the element. Every sum of in-range
// partials added after a poison stays beyond +-kFixMax.
__device__ __forceinline__ void add_fixed(long long* p, float x, float lim) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  if (fabsf(x) <= lim)
    atomicAdd(q, static_cast<unsigned long long>(__float2ll_rn(x * kFixScale)));
  else
    atomicExch(q, static_cast<unsigned long long>(kFixPoison));
}

// The same for the only partial of an element: a plain store.
__device__ __forceinline__ void store_fixed(long long* p, float x, float lim) {
  *p = fabsf(x) <= lim ? __float2ll_rn(x * kFixScale) : kFixPoison;
}

// A fixed-point sum as f32 (one rounding); a poisoned sum is NaN.
__device__ __forceinline__ float from_fixed(long long s) {
  if (s > kFixMax || s < -kFixMax) return __int_as_float(0x7fffffff);
  return __ll2float_rn(s) * kFixUnit;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}


// An unsigned integer of a tile element's size: element loads copy bits.
template <int N> struct RawOf;
template <> struct RawOf<1> { using type = uint8_t; };
template <> struct RawOf<2> { using type = uint16_t; };
template <> struct RawOf<4> { using type = uint32_t; };

// (rating, weight) of one tile element; codes: weight = code != 0.
template <typename RT, typename WT, bool CODES>
__device__ __forceinline__ void rating_weight(const unsigned char* r,
                                              const unsigned char* w,
                                              float r_scale, float& rv,
                                              float& wv) {
  const float x = to_f32(*reinterpret_cast<const RT*>(r));
  if (CODES) {
    wv = x != 0.f ? 1.f : 0.f;
    rv = __fmul_rn(x, r_scale);
  } else {
    rv = x;
    wv = to_f32(*reinterpret_cast<const WT*>(w));
  }
}

// Two neighbouring tile elements as floats, in one shared-memory load.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}

// One SGD step of one value, x - lr * norm(m (-2 acc) + 2 reg cr x): m the
// value's rank mask (1 at full rank), cr the count that scales its
// regularization (the masked count), c the unmasked count that normalizes.
// Each operation rounds once, in the plain version's order, and none is
// contracted into an FMA, so the masked instantiation at full rank (m = 1,
// cr = c) gives the unmasked one's factors bit for bit.
__device__ __forceinline__ float sgd_value(float x, float acc, float m,
                                           float cr, float c, float lr,
                                           float reg, int cn) {
  float g = __fadd_rn(__fmul_rn(m, -2.f * acc),
                      __fmul_rn(__fmul_rn(2.f * reg, cr), x));
  if (cn) g = __fdiv_rn(g, fmaxf(c, 1.f));
  return __fsub_rn(x, __fmul_rn(lr, g));
}

// The first index j of a nondecreasing rank row q[0..k) with q[j] > d, or k:
// an entity of lambda L has rank q[L - 1] > d iff L - 1 >= j.
__device__ __forceinline__ int first_above(const int* q, int k, int d) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (q[mid] > d) hi = mid; else lo = mid + 1;
  }
  return lo;
}

constexpr int kChunkUsers = 64;   // users per unit of the tensor-core kernel
constexpr int kPanelItems = 128;  // items per panel of the tensor-core kernel
// A cell of at most this many tensor-core panels sums its user gradient in
// per-panel f32 slots, not in 64-bit fixed point (Tabs, gu_slots)
constexpr int kMaxGuSlots = 8;

// The user gradient's per-panel slots: the cell's panel count where the
// tensor cores run (kp > 0) and it is at most kMaxGuSlots, else 0.
__host__ __device__ constexpr int gu_slots(int ni_pad, int kp) {
  return kp > 0 && (ni_pad + kPanelItems - 1) / kPanelItems <= kMaxGuSlots
             ? (ni_pad + kPanelItems - 1) / kPanelItems
             : 0;
}

// Users of a block in the bf16 copy of U: whole chunks.
__host__ __device__ constexpr int bu_pad(int bu) {
  return (bu + kChunkUsers - 1) / kChunkUsers * kChunkUsers;
}

// The tables of an epoch, as the kernels of a round address them. A cell
// (lane l, user block s) reads the item rows I + l * ni_pad * k, the user
// rows U + s * bu * k, their bf16 copy Ub + s * bu_pad * kp and the tile
// and counts of cell t = s * lanes + l; it sums into the lane's gradient
// slices, gi + l * ni_pad * k and gu + l * bu * k. Rank masks (stripes
// only, lane 0): lu [NU, bu] and li [ni_pad] lambdas, qs [NU, k] each
// block's rank row, hist_u [NU, bu, k] and hist_i [NU, ni_pad, k].
// The user gradient: with `slots` (a cell of few tensor-core panels), gup
// [slots, lanes, bu, k] f32, one slot a panel, each unit's partial stored
// once and the slots summed in panel order by the step kernel; else gu,
// 64-bit fixed point as the item gradient.
struct Tabs {
  float* U;                  // [NU, bu, k]
  float* I;                  // [lanes, ni_pad, k]
  __nv_bfloat16* Ub;         // [NU, bu_pad, kp] (tensor cores) or null
  long long* gu;             // [lanes, bu, k] fixed point (slots == 0)
  float* gup;                // [slots, lanes, bu, k] (slots > 0)
  long long* gi;             // [lanes, ni_pad, k] fixed point
  const float* cnt_u;        // [tiles, bu]
  const float* cnt_i;        // [tiles, ni_pad]
  const int* lu;
  const int* li;
  const int* qs;
  const int* hist_u;
  const int16_t* hist_i;
  int lanes, bu, ni_pad, k, kp, slots;
};

// B. Step the round's item rows and user rows from their summed gradients,
// the counts and the old rows, and leave both sums zeroed for the next
// round. Block row blockIdx.y takes cell cells[blockIdx.y] (lane, user
// block): its item rows first, then its user rows, PER consecutive values
// of a row a thread (4 when k % 4 == 0, else 1). refresh (the cell grid,
// tensor cores): the block's rows of the bf16 copy of U are rewritten from
// the new rows. MASK: entity e of lambda L[e] has rank r = qrow[L[e] - 1]
// at this visit; a value at d >= r is left as it is (m = 0), and below it
// the regularization counts the valid partners of rank > d,
// hist[e][first_above(qrow, d)] (the stripe's suffix histogram of partner
// lambdas, exact integers).
template <bool MASK, int PER>
__global__ void __launch_bounds__(kThreads)
step_kernel(Tabs tb, const int2* __restrict__ cells, float lr, float i_reg,
            float u_reg, int collision_norm, int refresh) {
  const int k = tb.k;
  const int n_i = tb.ni_pad * k / PER, n_u = tb.bu * k / PER;
  int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n_i + n_u) return;
  const bool item = q < n_i;
  if (!item) q -= n_i;
  const int e = q * PER / k;                  // the entity's row
  const int d0 = q * PER - e * k;
  const int2 cell = cells[blockIdx.y];        // (lane, user block)
  const int rows = item ? tb.ni_pad : tb.bu;
  const size_t t = static_cast<size_t>(cell.y) * tb.lanes + cell.x;
  const size_t own = (item ? static_cast<size_t>(cell.x) * tb.ni_pad
                           : static_cast<size_t>(cell.y) * tb.bu) + e;
  const size_t lane_row = static_cast<size_t>(cell.x) * rows + e;
  float* x = (item ? tb.I : tb.U) + own * k + d0;
  long long* acc = (item ? tb.gi : tb.gu) + lane_row * k + d0;
  const float c = (item ? tb.cnt_i : tb.cnt_u)[t * rows + e];
  const float reg = item ? i_reg : u_reg;
  const int* qrow = MASK ? tb.qs + static_cast<size_t>(cell.y) * k : nullptr;
  int rank = k;
  if (MASK)
    rank = qrow[(item ? tb.li[e]
                      : tb.lu[static_cast<size_t>(cell.y) * tb.bu + e]) - 1];
  float g[PER], xs[PER];
  if (PER == 4) {
    const float4 v = *reinterpret_cast<const float4*>(x);
    xs[0] = v.x, xs[1] = v.y, xs[2] = v.z, xs[3] = v.w;
  } else {
    xs[0] = *x;
  }
  if (!item && tb.slots) {
    // the per-panel slots in panel order; every round writes them all
    const float* src = tb.gup + (static_cast<size_t>(cell.x) * tb.bu + e) *
                                    k + d0;
    const size_t slot = static_cast<size_t>(tb.lanes) * tb.bu * k;
    for (int p = 0; p < tb.slots; ++p, src += slot) {
      float v4[4];
      if (PER == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        v4[0] = v.x, v4[1] = v.y, v4[2] = v.z, v4[3] = v.w;
      } else {
        v4[0] = *src;
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) g[j] = p ? __fadd_rn(g[j], v4[j]) : v4[j];
    }
  } else if (PER == 4) {
    longlong2* a2 = reinterpret_cast<longlong2*>(acc);
    const longlong2 s0 = a2[0], s1 = a2[1];
    a2[0] = make_longlong2(0, 0);
    a2[1] = make_longlong2(0, 0);
    g[0] = from_fixed(s0.x), g[1] = from_fixed(s0.y);
    g[2] = from_fixed(s1.x), g[3] = from_fixed(s1.y);
  } else {
    g[0] = from_fixed(*acc);
    *acc = 0;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = d0 + j;
    float m = 1.f, cr = c;
    if (MASK) {
      const int h = first_above(qrow, k, d);
      m = d < rank ? 1.f : 0.f;
      const size_t he = static_cast<size_t>(cell.y) * rows + e;
      cr = d < rank && h < k
               ? static_cast<float>(item ? tb.hist_i[he * k + h]
                                         : tb.hist_u[he * k + h])
               : 0.f;
    }
    xs[j] = sgd_value(xs[j], g[j], m, cr, c, lr, reg, collision_norm);
  }
  __nv_bfloat16* b =
      refresh && !item
          ? tb.Ub + (static_cast<size_t>(cell.y) * bu_pad(tb.bu) + e) *
                        tb.kp + d0
          : nullptr;
  if (PER == 4) {
    *reinterpret_cast<float4*>(x) = make_float4(xs[0], xs[1], xs[2], xs[3]);
    if (b != nullptr) {   // the cell grid: the bf16 operand rows follow
      const __nv_bfloat162 lo = __floats2bfloat162_rn(xs[0], xs[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(xs[2], xs[3]);
      uint2 pack;
      pack.x = *reinterpret_cast<const uint32_t*>(&lo);
      pack.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(b) = pack;
    }
  } else {
    *x = xs[0];
    if (b != nullptr) *b = __float2bfloat16_rn(xs[0]);
  }
}

// ---------------------------------------------------------------------
// A, tensor cores (mm_bf16, k <= 128)
// ---------------------------------------------------------------------
namespace tc {

constexpr int kPanel = kPanelItems;   // items per CTA
constexpr int kChunk = kChunkUsers;   // users per step of the user loop
constexpr int kEStride = kPanel + 8;  // bf16 per row of E (16 B of pad)

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the shared-memory regions. Per ring stage: the R tile,
// the W tile (sw = 0: codes, none) and the bf16 U chunk; then the bf16 item
// panel and bf16 E. Tile and bf16 rows carry 16 bytes of pad, so ldmatrix
// and the epilogue's reads hit distinct banks.
struct Smem {
  size_t rt, wt, ub, stage, ib, es, total;
};
__host__ __device__ constexpr Smem smem_layout(int sr, int sw, int kp) {
  Smem m{};
  m.rt = 0;
  m.wt = align16(static_cast<size_t>(kChunk) * (kPanel * sr + 16));
  m.ub = align16(m.wt + (sw ? static_cast<size_t>(kChunk) *
                                  (kPanel * sw + 16)
                            : 0));
  m.stage = align16(m.ub + static_cast<size_t>(kChunk) * (kp + 8) * 2);
  m.ib = 2 * m.stage;
  m.es = align16(m.ib + static_cast<size_t>(kPanel) * (kp + 8) * 2);
  m.total = m.es + static_cast<size_t>(kChunk) * kEStride * 2;
  return m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a b on one 16x8x16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Add partials (a, b) to p[0], p[1] of a row of k fixed-point sums; d is
// p's column.
__device__ __forceinline__ void add2(long long* p, int d, int k, float a,
                                     float b, float lim) {
  if (d < k) add_fixed(p, a, lim);
  if (d + 1 < k) add_fixed(p + 1, b, lim);
}

// One chunk's [kChunk][kPanel] tile of T into the ring: 16-byte cp.async
// copies when every row is a whole number of 16-byte pieces (vec), else
// element copies. Rows past bu and columns past ni_pad are zero.
template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          int u0, int p0, int bu,
                                          int ni_pad, bool vec) {
  constexpr int kRow = kPanel * static_cast<int>(sizeof(T));
  constexpr int kStr = kRow + 16;
  if (vec) {
    constexpr int kPieces = kRow / 16;
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    for (int q = threadIdx.x; q < kChunk * kPieces; q += kThreads) {
      const int u = q / kPieces, c = q % kPieces;
      const int col = p0 + c * kPer;
      const bool ok = u0 + u < bu && col < ni_pad;
      const T* s = ok ? src + static_cast<size_t>(u0 + u) * ni_pad + col
                      : src;
      cp_async16(smem_addr(dst + u * kStr + c * 16), s, ok ? 16 : 0);
    }
  } else {
    using Raw = typename RawOf<sizeof(T)>::type;
    const Raw* s = reinterpret_cast<const Raw*>(src);
    for (int q = threadIdx.x; q < kChunk * kPanel; q += kThreads) {
      const int u = q / kPanel, p = q % kPanel;
      Raw v = 0;
      if (u0 + u < bu && p0 + p < ni_pad)
        v = s[static_cast<size_t>(u0 + u) * ni_pad + p0 + p];
      *reinterpret_cast<Raw*>(dst + u * kStr + p * sizeof(T)) = v;
    }
  }
}

// The epoch's U as bf16, [NU, bu_pad, kp], zero past bu and k: the
// operand copy every panel of a stripe reads. With rank tables (lu3 [NU,
// bu], qs [NU, k]: stripe s's rank row is that of its visit), also zero at
// and past each user's rank at its stripe's visit, U o Mu.
__global__ void __launch_bounds__(kThreads)
u_bf16_kernel(const float* __restrict__ U, __nv_bfloat16* __restrict__ Ub,
              int n_stripes, int bu, int k, int kp,
              const int* __restrict__ lu3, const int* __restrict__ qs) {
  const int bp = bu_pad(bu);
  const size_t q = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<size_t>(n_stripes) * bp * kp / 2) return;
  const size_t row = q / (kp / 2);
  const int d = static_cast<int>(q % (kp / 2)) * 2;
  const int s = static_cast<int>(row / bp), u = static_cast<int>(row % bp);
  const size_t ur = static_cast<size_t>(s) * bu + u;
  const float* src = U + ur * k;
  int r = k;
  if (lu3 != nullptr && u < bu)
    r = qs[static_cast<size_t>(s) * k + lu3[ur] - 1];
  const float a = u < bu && d < r ? src[d] : 0.f;
  const float b = u < bu && d + 1 < r ? src[d + 1] : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(Ub + row * kp + d) =
      __floats2bfloat162_rn(a, b);
}

// CTAs of the persistent grid per SM: fixed by KP alone, so the partition
// of a stripe into CTAs, and with it every f32 partial, is the same for
// every tile type (codes and float tiles sum the same partials). A tile
// type whose shared memory fits fewer CTAs per SM runs the grid's CTAs
// one after another where they do not fit at once.
__host__ __device__ constexpr int ctas_per_sm(int kp) {
  return kp <= 64 ? 2 : 1;
}

// Each CTA of a persistent grid takes an equal run of the round's units,
// ordered (cell, 128-item panel, 64-user chunk), so every SM carries the
// same work whatever the cell and panel counts, and a CTA's run stays on
// one (cell, panel) across chunks. On leaving a (cell, panel) it adds its
// share of that panel's item gradient to the lane's gi slice.
// MASK (stripes): the item panel is zeroed at and past each item's rank,
// qrow[li[p] - 1] (the bf16 U copy is masked already), so the three
// products are those of U o Mu and I o Mi.
template <typename RT, typename WT, bool CODES, bool MASK, int KP, int STAGE>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(KP))
panel_kernel(Tabs tb, const int2* __restrict__ cells, int n_cells,
             const RT* __restrict__ R,       // [tiles, bu, ni_pad]
             const WT* __restrict__ W,       // [tiles, bu, ni_pad] / null
             int vec, float r_scale, float lim) {
  static_assert(KP % 16 == 0 && KP <= 128, "KP: k padded to 16..128");
  constexpr int SR = sizeof(RT);
  constexpr int SW = CODES ? 0 : sizeof(WT);
  constexpr int RSTR = kPanel * SR + 16;     // bytes per R tile row
  constexpr int WSTR = kPanel * SW + 16;     // bytes per W tile row
  constexpr int USTR = KP + 8;               // bf16 per U / I row
  constexpr Smem L = smem_layout(SR, SW, KP);

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ib = reinterpret_cast<__nv_bfloat16*>(smem + L.ib);
  __nv_bfloat16* Es = reinterpret_cast<__nv_bfloat16*>(smem + L.es);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, nh = warp >> 2;   // P / Gu: user tile, half
  const int bu = tb.bu, ni_pad = tb.ni_pad, k = tb.k;
  const int n_chunks = (bu + kChunk - 1) / kChunk;
  const int n_panels = (ni_pad + kPanel - 1) / kPanel;
  const long long n_units =
      static_cast<long long>(n_cells) * n_panels * n_chunks;
  const long long begin = n_units * blockIdx.x / gridDim.x;
  const long long end = n_units * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;

  // unit q is chunk q % n_chunks of run q / n_chunks, the (cell, panel)
  // pair run / n_panels, run % n_panels
  auto cell_of = [&](long long run) { return cells[run / n_panels]; };
  auto panel_of = [&](long long run) {
    return static_cast<int>(run % n_panels) * kPanel;
  };
  // a panel's OLD item rows, bf16-rounded, k zero-padded to KP (MASK:
  // zero from each item's rank on)
  auto load_panel = [&](long long run) {
    const int2 c = cell_of(run);
    const int p0 = panel_of(run);
    const float* Il = tb.I + static_cast<size_t>(c.x) * ni_pad * k;
    const int* qrow = MASK ? tb.qs + static_cast<size_t>(c.y) * k : nullptr;
    for (int q = tid; q < kPanel * KP / 2; q += kThreads) {
      const int p = q / (KP / 2), d = (q % (KP / 2)) * 2;
      float a = 0.f, b = 0.f;
      if (p0 + p < ni_pad) {
        const float* row = Il + static_cast<size_t>(p0 + p) * k;
        const int r = MASK ? qrow[tb.li[p0 + p] - 1] : k;
        if (d < r) a = row[d];
        if (d + 1 < r) b = row[d + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(Ib + p * USTR + d) =
          __floats2bfloat162_rn(a, b);
    }
  };
  auto load_unit = [&](long long q, int s) {
    unsigned char* st = smem + s * L.stage;
    const long long run = q / n_chunks;
    const int2 c = cell_of(run);
    const int p0 = panel_of(run);
    const int u0 = static_cast<int>(q % n_chunks) * kChunk;
    const size_t tile = (static_cast<size_t>(c.y) * tb.lanes + c.x) * bu *
                        static_cast<size_t>(ni_pad);
    load_tile<RT>(st + L.rt, R + tile, u0, p0, bu, ni_pad, vec != 0);
    if (!CODES)
      load_tile<WT>(st + L.wt, W + tile, u0, p0, bu, ni_pad, vec != 0);
    const __nv_bfloat16* Ubg =
        tb.Ub + static_cast<size_t>(c.y) * bu_pad(bu) * KP;
    constexpr int kPieces = KP / 8;   // 16-byte pieces per U row
    for (int i = tid; i < kChunk * kPieces; i += kThreads) {
      const int u = i / kPieces, c8 = (i % kPieces) * 8;
      cp_async16(smem_addr(st + L.ub + (u * USTR + c8) * 2),
                 Ubg + static_cast<size_t>(u0 + u) * KP + c8, 16);
    }
  };

  float gi_acc[KP / 8][4];   // Gi of items 16*warp.. x KP, this panel
  auto zero_gi = [&]() {
#pragma unroll
    for (int j = 0; j < KP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gi_acc[j][e] = 0.f;
  };
  auto flush_gi = [&](long long run) {
    const int p0 = panel_of(run);
    long long* gil =
        tb.gi + static_cast<size_t>(cell_of(run).x) * ni_pad * k;
#pragma unroll
    for (int j = 0; j < KP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 16 * warp + g + 8 * h, d = 8 * j + 2 * t;
        if (p < ni_pad && d < k)
          add2(gil + static_cast<size_t>(p) * k + d, d, k, gi_acc[j][2 * h],
               gi_acc[j][2 * h + 1], lim);
      }
  };

  long long run = begin / n_chunks;
  load_panel(run);
  zero_gi();
  load_unit(begin, 0);
  cp_async_commit();

  for (long long q = begin; q < end; ++q) {
    const int s = static_cast<int>(q - begin) & 1;
    if (q + 1 < end) load_unit(q + 1, s ^ 1);
    cp_async_commit();   // possibly empty: one group per unit
    cp_async_wait1();    // this unit's group has landed
    __syncthreads();
    if (q / n_chunks != run) {
      // a new (cell, panel): every warp is done with the old one's rows
      if (STAGE >= kItem) flush_gi(run);
      zero_gi();
      run = q / n_chunks;
      load_panel(run);
      __syncthreads();
    }

    const unsigned char* st = smem + s * L.stage;
    const __nv_bfloat16* Ub =
        reinterpret_cast<const __nv_bfloat16*>(st + L.ub);
    const int u0 = static_cast<int>(q % n_chunks) * kChunk;
    // the unit's Gu partial: this panel's slot, or the lane's fixed point
    long long* gul = tb.gu + static_cast<size_t>(cell_of(run).x) * bu * k;
    float* gus = tb.gup + (static_cast<size_t>(run % n_panels) * tb.lanes +
                           cell_of(run).x) * bu * static_cast<size_t>(k);

    if (STAGE >= kPmm) {
      // P = U_c I_p^T: users 16*mt.., items 64*nh.. (8 n-tiles)
      float pacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP; kk += 16) {
        uint32_t a[4];
        ldsm_x4(smem_addr(Ub + (16 * mt + (lane & 15)) * USTR + kk +
                          (lane >> 4) * 8),
                a);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t b[4];
          const int n0 = 64 * nh + 8 * j;
          ldsm_x4(smem_addr(Ib + (n0 + (lane & 7) + ((lane >> 4) << 3)) *
                                     USTR +
                            kk + ((lane >> 3) & 1) * 8),
                  b);
          mma(pacc[j], a, b[0], b[1]);
          mma(pacc[j + 1], a, b[2], b[3]);
        }
      }
      if (STAGE >= kElem) {
        // epilogue: E = W (R - P) straight from the accumulators
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * nh + 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int u = 16 * mt + g + 8 * h;
            const float2 x = load_pair(
                reinterpret_cast<const RT*>(st + L.rt + u * RSTR) + col);
            float2 r, w;
            if (CODES) {
              r = make_float2(__fmul_rn(x.x, r_scale),
                              __fmul_rn(x.y, r_scale));
              w = make_float2(x.x != 0.f ? 1.f : 0.f,
                              x.y != 0.f ? 1.f : 0.f);
            } else {
              r = x;
              w = load_pair(
                  reinterpret_cast<const WT*>(st + L.wt + u * WSTR) + col);
            }
            *reinterpret_cast<__nv_bfloat162*>(Es + u * kEStride + col) =
                __floats2bfloat162_rn(w.x * (r.x - pacc[j][2 * h]),
                                      w.y * (r.y - pacc[j][2 * h + 1]));
          }
        }
      }
    }
    __syncthreads();   // E is complete

    if (STAGE >= kItem) {
      // Gi += E_c^T U_c: items 16*warp.., all KP columns
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        uint32_t a[4];
        ldsm_x4_t(smem_addr(Es + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                     kEStride +
                            16 * warp + ((lane >> 3) & 1) * 8),
                  a);
#pragma unroll
        for (int j = 0; j < KP / 8; j += 2) {
          uint32_t b[4];
          ldsm_x4_t(smem_addr(Ub + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       USTR +
                              8 * j + (lane >> 4) * 8),
                    b);
          mma(gi_acc[j], a, b[0], b[1]);
          mma(gi_acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    if (STAGE >= kFull) {
      // Gu_c = E_c I_p: users 16*mt.., columns (KP/2)*nh.., into gu
      constexpr int NT = KP / 16;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kPanel; kk += 16) {
        uint32_t a[4];
        ldsm_x4(smem_addr(Es + (16 * mt + (lane & 15)) * kEStride + kk +
                          (lane >> 4) * 8),
                a);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b[2];
          ldsm_x2_t(smem_addr(Ib + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       USTR +
                              nh * (KP / 2) + 8 * j),
                    b);
          mma(acc[j], a, b[0], b[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int d = nh * (KP / 2) + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = u0 + 16 * mt + g + 8 * h;
          if (u >= bu || d >= k) continue;
          if (tb.slots) {
            float* o = gus + static_cast<size_t>(u) * k + d;
            o[0] = acc[j][2 * h];
            if (d + 1 < k) o[1] = acc[j][2 * h + 1];
          } else {
            add2(gul + static_cast<size_t>(u) * k + d, d, k, acc[j][2 * h],
                 acc[j][2 * h + 1], lim);
          }
        }
      }
    }
    __syncthreads();   // the stage, E and the panel rows are free
  }
  if (STAGE >= kItem) flush_gi(run);
}

}  // namespace tc

// ---------------------------------------------------------------------
// A, CUDA cores (f32 products, or k > 128)
// ---------------------------------------------------------------------
namespace cc {

constexpr int kPanel = 64;    // items per block
constexpr int kChunk = 32;    // users per chunk inside a block
constexpr int kUserGroups = kThreads / kPanel;         // 4
constexpr int kUsersPerThread = kChunk / kUserGroups;  // 8

// A matmul operand: bf16-rounded (kept in f32 registers) when MMBF16.
template <bool MMBF16>
__device__ __forceinline__ float mm_operand(float x) {
  if (MMBF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Shared-memory floats of the kernel.
__host__ __device__ inline size_t smem_floats(int k) {
  const size_t ks = static_cast<size_t>(k) + 1;
  return kPanel * ks                          // Im
         + static_cast<size_t>(kChunk) * k    // Us
         + kChunk * (kPanel + 1)              // Es
         + kChunk * kPanel                    // Ws
         + static_cast<size_t>(kPanel) * k;   // Gi
}

// Block b of the round's grid takes panel b % n_panels of cell
// cells[b / n_panels]. MASK (stripes): the item rows and the user chunk
// are zeroed at and past each entity's rank, qrow[l[e] - 1], as they are
// staged.
template <typename RT, typename WT, bool CODES, bool MMBF16, bool MASK>
__global__ void __launch_bounds__(kThreads)
panel_kernel(Tabs tb, const int2* __restrict__ cells, int n_cells,
             const RT* __restrict__ R, const WT* __restrict__ W, int vec,
             float r_scale, float lim) {
  extern __shared__ float smem[];
  const int bu = tb.bu, ni_pad = tb.ni_pad, k = tb.k;
  const int ks = k + 1;  // padded stride: item rows hit distinct banks
  float* Im = smem;                                   // [kPanel][ks]
  float* Us = Im + kPanel * ks;                       // [kChunk][k]
  float* Es = Us + kChunk * k;                        // [kChunk][kPanel+1]
  float* Ws = Es + kChunk * (kPanel + 1);             // [kChunk][kPanel]
  float* Gi = Ws + kChunk * kPanel;                   // [kPanel][k]

  const int tid = threadIdx.x;
  const int n_panels = (ni_pad + kPanel - 1) / kPanel;
  const int2 cell = cells[blockIdx.x / n_panels];
  const int p0 = static_cast<int>(blockIdx.x % n_panels) * kPanel;
  const int np_here = min(kPanel, ni_pad - p0);  // ragged last panel
  const size_t tile = (static_cast<size_t>(cell.y) * tb.lanes + cell.x) *
                      bu * static_cast<size_t>(ni_pad);
  R += tile;
  if (!CODES) W += tile;
  const float* I = tb.I + static_cast<size_t>(cell.x) * ni_pad * k;
  const float* U = tb.U + static_cast<size_t>(cell.y) * bu * k;
  long long* gu = tb.gu + static_cast<size_t>(cell.x) * bu * k;
  long long* gi = tb.gi + static_cast<size_t>(cell.x) * ni_pad * k;
  const int* li = tb.li;
  const int* lu = MASK ? tb.lu + static_cast<size_t>(cell.y) * bu : nullptr;
  const int* qrow = MASK ? tb.qs + static_cast<size_t>(cell.y) * k : nullptr;

  for (int idx = tid; idx < kPanel * k; idx += kThreads) {
    const int p = idx / k, d = idx % k;
    const bool live = p < np_here && (!MASK || d < qrow[li[p0 + p] - 1]);
    const float v = live ? I[static_cast<size_t>(p0 + p) * k + d] : 0.f;
    Im[p * ks + d] = mm_operand<MMBF16>(v);   // the old rows, as operand
    Gi[idx] = 0.f;
  }
  __syncthreads();

  for (int u0 = 0; u0 < bu; u0 += kChunk) {
    const int nu_here = min(kChunk, bu - u0);
    for (int idx = tid; idx < kChunk * k; idx += kThreads) {
      const int u = idx / k, d = idx % k;
      const bool live =
          u < nu_here && (!MASK || d < qrow[lu[u0 + u] - 1]);
      Us[idx] = live
                    ? mm_operand<MMBF16>(U[static_cast<size_t>(u0 + u) * k + d])
                    : 0.f;
    }
    // ratings go to Es (overwritten by the residual below), weights to Ws
    for (int idx = tid; idx < kChunk * kPanel; idx += kThreads) {
      const int u = idx / kPanel, p = idx % kPanel;
      float r = 0.f, w = 0.f;
      if (u < nu_here && p < np_here) {
        const size_t off = static_cast<size_t>(u0 + u) * ni_pad + p0 + p;
        rating_weight<RT, WT, CODES>(
            reinterpret_cast<const unsigned char*>(R + off),
            reinterpret_cast<const unsigned char*>(CODES ? nullptr : W + off),
            r_scale, r, w);
      }
      Es[u * (kPanel + 1) + p] = r;
      Ws[u * kPanel + p] = w;
    }
    __syncthreads();

    {  // P = U I^T and E = W (R - P): one item, kUsersPerThread users each
      const int p = tid % kPanel;
      const int ug = tid / kPanel;
      float acc[kUsersPerThread];
#pragma unroll
      for (int q = 0; q < kUsersPerThread; ++q) acc[q] = 0.f;
      for (int d = 0; d < k; ++d) {
        const float iv = Im[p * ks + d];
#pragma unroll
        for (int q = 0; q < kUsersPerThread; ++q)
          acc[q] += Us[(ug + q * kUserGroups) * k + d] * iv;
      }
#pragma unroll
      for (int q = 0; q < kUsersPerThread; ++q) {
        const int u = ug + q * kUserGroups;
        const float e =
            Ws[u * kPanel + p] * (Es[u * (kPanel + 1) + p] - acc[q]);
        Es[u * (kPanel + 1) + p] = mm_operand<MMBF16>(e);
      }
    }
    __syncthreads();

    // item gradient of the panel: Gi[p][d] += sum_u E[u][p] U[u][d]
    for (int idx = tid; idx < kPanel * k; idx += kThreads) {
      const int p = idx / k, d = idx % k;
      float acc = 0.f;
      for (int u = 0; u < kChunk; ++u)
        acc += Es[u * (kPanel + 1) + p] * Us[u * k + d];
      Gi[idx] += acc;
    }
    // this panel's share of the user gradient
    for (int idx = tid; idx < nu_here * k; idx += kThreads) {
      const int u = idx / k, d = idx % k;
      float acc = 0.f;
      for (int p = 0; p < kPanel; ++p)
        acc += Es[u * (kPanel + 1) + p] * Im[p * ks + d];
      add_fixed(gu + static_cast<size_t>(u0 + u) * k + d, acc, lim);
    }
    __syncthreads();
  }

  // the panel's item gradient (the only block on these rows)
  for (int idx = tid; idx < np_here * k; idx += kThreads)
    store_fixed(gi + static_cast<size_t>(p0) * k + idx, Gi[idx], lim);
}

}  // namespace cc

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

int rtype_bytes(int rtype) {
  return rtype == kRF32 ? 4 : rtype == kRBF16 ? 2 : 1;
}
int wtype_bytes(int wtype) {
  return wtype == kWF32 ? 4 : wtype == kWBF16 ? 2 : 1;
}

// k padded to the tensor-core kernel's K, or 0: the CUDA-core kernel.
int tc_kp(int k, int mm_bf16) {
  if (!mm_bf16 || k > 128) return 0;
  return k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : 128;
}

size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// Byte offsets in the scratch: the user gradient (per-panel f32 slots
// [slots, lanes, bu, k], or 64-bit fixed point [lanes, bu, k]) and the
// item gradient [lanes, ni_pad, k] in fixed point, then (tensor cores) the
// bf16 U [NU, bu_pad, KP].
size_t scratch_gi(int lanes, int bu, int ni_pad, int k, int kp) {
  const size_t row = static_cast<size_t>(lanes) * bu * k;
  const int slots = gu_slots(ni_pad, kp);
  return align256(slots ? slots * row * sizeof(float)
                        : row * sizeof(long long));
}
size_t scratch_ub(int lanes, int bu, int ni_pad, int k, int kp) {
  return scratch_gi(lanes, bu, ni_pad, k, kp) +
         align256(static_cast<size_t>(lanes) * ni_pad * k *
                  sizeof(long long));
}

// The largest |partial| that keeps the sum of `parts` partials within
// +-2^60 units (below kFixMax, so no in-range sum reads as poisoned).
float fix_limit(long long parts) {
  return static_cast<float>(std::ldexp(1.0, 60 - kFixBits) /
                            static_cast<double>(std::max(parts, 1LL)) *
                            (1.0 - 1e-6));
}

struct Epoch {
  Tabs tb;
  const void* R;
  const void* W;
  const int2* cells;    // device: the epoch's (lane, user block) cells
  const int* counts;    // host: each round's cells; null: one a round
  int n_rounds, n_ublocks, vec, collision_norm;
  float lr, r_scale, u_reg, i_reg;
  cudaStream_t stream;
  long long* failed;
  long long* launched;
  int refresh;          // the step rewrites the block's bf16 U rows
};

Epoch make_epoch(void* u3, void* i_tab, const void* R, const void* W,
                 const void* cnt_u, const void* cnt_i, void* scratch,
                 const void* cells, const int* counts, int n_rounds,
                 int lanes, int n_ublocks, int bu, int ni_pad, int k,
                 int mm_bf16, int collision_norm, float lr, float r_scale,
                 float u_reg, float i_reg, void* stream, long long* failed,
                 long long* launched) {
  char* base = static_cast<char*>(scratch);
  const int kp = tc_kp(k, mm_bf16);
  *failed = -1;
  *launched = 0;
  Epoch e{};
  e.tb.U = static_cast<float*>(u3);
  e.tb.I = static_cast<float*>(i_tab);
  e.tb.gu = reinterpret_cast<long long*>(base);
  e.tb.gup = reinterpret_cast<float*>(base);
  e.tb.slots = gu_slots(ni_pad, kp);
  e.tb.gi = reinterpret_cast<long long*>(
      base + scratch_gi(lanes, bu, ni_pad, k, kp));
  e.tb.Ub = reinterpret_cast<__nv_bfloat16*>(
      base + scratch_ub(lanes, bu, ni_pad, k, kp));
  e.tb.cnt_u = static_cast<const float*>(cnt_u);
  e.tb.cnt_i = static_cast<const float*>(cnt_i);
  e.tb.lanes = lanes;
  e.tb.bu = bu;
  e.tb.ni_pad = ni_pad;
  e.tb.k = k;
  e.R = R;
  e.W = W;
  e.cells = static_cast<const int2*>(cells);
  e.counts = counts;
  e.n_rounds = n_rounds;
  e.n_ublocks = n_ublocks;
  e.collision_norm = collision_norm;
  e.lr = lr;
  e.r_scale = r_scale;
  e.u_reg = u_reg;
  e.i_reg = i_reg;
  e.stream = static_cast<cudaStream_t>(stream);
  e.failed = failed;
  e.launched = launched;
  return e;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// The epoch's rounds in order: the panel kernel on `grid` CTAs (0: one a
// (cell, CUDA-core panel)), then (step) the step kernel over the round's
// rows. ``kernel`` is an instantiation of either panel kernel; they share
// their signature. `lim` bounds each gradient partial. A round without a
// cell launches nothing.
template <bool MASK, typename RT, typename WT, typename Kernel>
cudaError_t walk(const Epoch& e, Kernel kernel, unsigned grid, size_t smem,
                 bool step, float lim) {
  const unsigned cc_panels =
      static_cast<unsigned>((e.tb.ni_pad + cc::kPanel - 1) / cc::kPanel);
  long long start = 0;
  for (int r = 0; r < e.n_rounds; ++r) {
    const int n = e.counts ? e.counts[r] : 1;
    const int2* cells = e.cells + start;
    start += n;
    if (n <= 0) continue;
    kernel<<<grid ? grid : n * cc_panels, kThreads, smem, e.stream>>>(
        e.tb, cells, n, static_cast<const RT*>(e.R),
        static_cast<const WT*>(e.W), e.vec, e.r_scale, lim);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*e.launched;
    if (err == cudaSuccess && step) {
      const int per = e.tb.k % 4 ? 1 : 4;
      const dim3 g(blocks_for(static_cast<size_t>(e.tb.ni_pad + e.tb.bu) *
                              e.tb.k / per),
                   n);
      if (per == 4)
        step_kernel<MASK, 4><<<g, kThreads, 0, e.stream>>>(
            e.tb, cells, e.lr, e.i_reg, e.u_reg, e.collision_norm,
            e.refresh);
      else
        step_kernel<MASK, 1><<<g, kThreads, 0, e.stream>>>(
            e.tb, cells, e.lr, e.i_reg, e.u_reg, e.collision_norm,
            e.refresh);
      err = cudaGetLastError();
      if (err == cudaSuccess) ++*e.launched;
    }
    if (err != cudaSuccess) {
      *e.failed = r;
      return err;
    }
  }
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename RT, typename WT, bool CODES, bool MASK, int KP, int STAGE>
cudaError_t run_tc(Epoch e) {
  constexpr tc::Smem L =
      tc::smem_layout(sizeof(RT), CODES ? 0 : sizeof(WT), KP);
  auto kernel = tc::panel_kernel<RT, WT, CODES, MASK, KP, STAGE>;
  cudaError_t err = set_smem(kernel, L.total);
  // the persistent grid: ctas_per_sm(KP) CTAs an SM, whatever the tile type
  // and the round (CTAs past a small round's units return at once)
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long panels = (e.tb.ni_pad + tc::kPanel - 1) / tc::kPanel;
  const long long chunks = (e.tb.bu + tc::kChunk - 1) / tc::kChunk;
  const unsigned grid = static_cast<unsigned>(sms * tc::ctas_per_sm(KP));
  // Partials an element: Gu (fixed point), one a unit on its chunk, so one
  // a panel of the cell; Gi, one a CTA whose run covers the (cell, panel),
  // so at most one a chunk. Both are fixed by the cell's geometry alone.
  const float lim = fix_limit(std::max(panels, chunks));
  const size_t n =
      static_cast<size_t>(e.n_ublocks) * bu_pad(e.tb.bu) * KP / 2;
  tc::u_bf16_kernel<<<blocks_for(n), kThreads, 0, e.stream>>>(
      e.tb.U, e.tb.Ub, e.n_ublocks, e.tb.bu, e.tb.k, KP,
      MASK ? e.tb.lu : nullptr, MASK ? e.tb.qs : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*e.launched;
  e.tb.kp = KP;
  e.refresh = e.counts != nullptr;   // the cell grid revisits blocks
  return walk<MASK, RT, WT>(e, kernel, grid, L.total, STAGE == kFull, lim);
}

template <typename RT, typename WT, bool CODES, bool MMBF16, bool MASK>
cudaError_t run_cc(const Epoch& e) {
  auto kernel = cc::panel_kernel<RT, WT, CODES, MMBF16, MASK>;
  const size_t smem = cc::smem_floats(e.tb.k) * sizeof(float);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // Gu: one partial a panel of the cell; Gi: one, stored
  const long long panels = (e.tb.ni_pad + cc::kPanel - 1) / cc::kPanel;
  return walk<MASK, RT, WT>(e, kernel, 0, smem, true, fix_limit(panels));
}

template <typename RT, typename WT, bool CODES, bool MASK>
cudaError_t run_rw(const Epoch& e, int mm_bf16) {
  switch (tc_kp(e.tb.k, mm_bf16)) {
    case 16: return run_tc<RT, WT, CODES, MASK, 16, kFull>(e);
    case 32: return run_tc<RT, WT, CODES, MASK, 32, kFull>(e);
    case 64: return run_tc<RT, WT, CODES, MASK, 64, kFull>(e);
    case 128: return run_tc<RT, WT, CODES, MASK, 128, kFull>(e);
    default:
      return mm_bf16 ? run_cc<RT, WT, CODES, true, MASK>(e)
                     : run_cc<RT, WT, CODES, false, MASK>(e);
  }
}

// Rank masks are instantiated for the tiles of the 0/1-weight models that
// carry them: int8 validity W (beside f32 / bf16 R) and int8 codes.
template <typename RT>
cudaError_t run_w(const Epoch& e, int wtype, int mm_bf16) {
  const bool masked = e.tb.qs != nullptr;
  switch (wtype) {
    case kWInt8:
      return masked ? run_rw<RT, int8_t, false, true>(e, mm_bf16)
                    : run_rw<RT, int8_t, false, false>(e, mm_bf16);
    case kWBF16:
      if (masked) return cudaErrorInvalidValue;
      return run_rw<RT, __nv_bfloat16, false, false>(e, mm_bf16);
    case kWF32:
      if (masked) return cudaErrorInvalidValue;
      return run_rw<RT, float, false, false>(e, mm_bf16);
    default: return cudaErrorInvalidValue;
  }
}

bool vec_tiles(const void* R, const void* W, int cols, int rtype,
               int wtype) {
  const int rb = rtype_bytes(rtype), wb = W ? wtype_bytes(wtype) : 1;
  return (static_cast<size_t>(cols) * rb) % 16 == 0 &&
         (static_cast<size_t>(cols) * wb) % 16 == 0 && aligned16(R) &&
         (W == nullptr || aligned16(W));
}

}  // namespace

extern "C" {

// Bytes of the scratch an epoch needs, zeroed by the caller: the lanes'
// user gradients (per-panel f32 slots for a cell of at most kMaxGuSlots
// tensor-core panels, each written before it is read, else [lanes, bu, k]
// in 64-bit fixed point) and item gradients [lanes, ni_pad, k] in fixed
// point (the kernels leave the fixed-point sums zeroed) and, with the
// tensor cores, the epoch's bf16 copy of the n_ublocks user blocks [NU,
// bu_pad, KP]. Stripes: one lane.
size_t dense_rows_scratch_bytes(int lanes, int n_ublocks, int bu,
                                int ni_pad, int k, int mm_bf16) {
  const int kp = tc_kp(k, mm_bf16);
  return scratch_ub(lanes, bu, ni_pad, k, kp) +
         static_cast<size_t>(n_ublocks) * bu_pad(bu) * kp * 2;
}

// Shared-memory bytes of the panel kernel the epoch would launch.
size_t dense_rows_smem_bytes(int rtype, int wtype, int k, int mm_bf16) {
  const int kp = tc_kp(k, mm_bf16);
  if (kp == 0) return cc::smem_floats(k) * sizeof(float);
  return tc::smem_layout(rtype_bytes(rtype),
                         rtype == kRCodes ? 0 : wtype_bytes(wtype), kp)
      .total;
}

// One epoch on `stream`: with the tensor cores the bf16 copy of U, then for
// each stripe visit the panel and step kernels, a round of one cell.
// Tiles are [n_stripes, bu, ni_pad] (R of rtype 0 f32 / 1 bf16 / 2 int8
// codes; W of wtype 0 int8 / 1 bf16 / 2 f32, or null for codes), u3 is
// [n_stripes, bu, k], i_tab [ni_pad, k], cnt_u [n_stripes, bu] and cnt_i
// [n_stripes, ni_pad] the tiles' f32 validity counts, `scratch` holds
// dense_rows_scratch_bytes(1, n_stripes, ...) zeroed bytes; `cells` is a
// device int32 [n_order, 2] array, (0, stripe) for each visit in order.
// Rank masks (codes or int8 W only; all five null for full rank): lu
// [n_stripes, bu] and li [ni_pad] int32 lambdas (or ranks) in [1, k], qs
// [n_stripes, k] int32 each stripe's nondecreasing rank row (rank of lambda
// L = qs[s][L - 1]), hist_u [n_stripes, bu, k] int32 and hist_i
// [n_stripes, ni_pad, k] int16 the stripes' counts of valid partners of
// lambda >= l + 1. Returns the cudaError_t of the first launch that failed
// (its visit in *failed_stripe, -1 for the U copy), else cudaSuccess;
// *launched counts the kernels launched.
int dense_rows_epoch(int rtype, int wtype, int mm_bf16, int collision_norm,
                     void* u3, void* i_tab, const void* R, const void* W,
                     const void* lu, const void* li, const void* qs,
                     const void* hist_u, const void* hist_i,
                     const void* cnt_u, const void* cnt_i, void* scratch,
                     const void* cells, int n_order, int n_stripes, int bu,
                     int ni_pad, int k, float lr, float r_scale, float u_reg,
                     float i_reg, void* stream, long long* failed_stripe,
                     long long* launched) {
  if (bu <= 0 || ni_pad <= 0 || k <= 0 || n_order < 0 || n_stripes <= 0)
    return cudaErrorInvalidValue;
  if ((rtype == kRCodes) != (W == nullptr)) return cudaErrorInvalidValue;
  const int n_masks = (lu != nullptr) + (li != nullptr) + (qs != nullptr) +
                      (hist_u != nullptr) + (hist_i != nullptr);
  if (n_masks != 0 && n_masks != 5) return cudaErrorInvalidValue;
  Epoch e = make_epoch(u3, i_tab, R, W, cnt_u, cnt_i, scratch, cells,
                       nullptr, n_order, 1, n_stripes, bu, ni_pad, k,
                       mm_bf16, collision_norm, lr, r_scale, u_reg, i_reg,
                       stream, failed_stripe, launched);
  e.tb.lu = static_cast<const int*>(lu);
  e.tb.li = static_cast<const int*>(li);
  e.tb.qs = static_cast<const int*>(qs);
  e.tb.hist_u = static_cast<const int*>(hist_u);
  e.tb.hist_i = static_cast<const int16_t*>(hist_i);
  e.vec = vec_tiles(R, W, ni_pad, rtype, wtype);
  switch (rtype) {
    case kRF32: return run_w<float>(e, wtype, mm_bf16);
    case kRBF16: return run_w<__nv_bfloat16>(e, wtype, mm_bf16);
    case kRCodes:
      return n_masks ? run_rw<int8_t, int8_t, true, true>(e, mm_bf16)
                     : run_rw<int8_t, int8_t, true, false>(e, mm_bf16);
    default: return cudaErrorInvalidValue;
  }
}

// One epoch of the diag cell grid on `stream`: with the tensor cores the
// bf16 copy of U, then for each round the panel kernel over all of the
// round's live cells and the step kernel over their rows. `cells` is a
// device int32 [n_live, 2] array of (lane, user block) pairs, round by
// round (dummy lanes left out), and counts[0..n_rounds) a host array of
// each round's cells; a round of none launches nothing. Tiles are
// [n_ublocks * n_lanes + 1, bu, bi] (types as dense_rows_epoch; no rank
// masks), u3 [n_ublocks, bu, k], i3 [n_lanes, bi, k], cnt_u [n_cells + 1,
// bu] and cnt_i [n_cells + 1, bi] the cells' f32 validity counts,
// `scratch` holds dense_rows_scratch_bytes(n_lanes, n_ublocks, bu, bi, k,
// mm_bf16) zeroed bytes. Returns as dense_rows_epoch, the failing round
// in *failed_round.
int dense_cells_epoch(int rtype, int wtype, int mm_bf16, int collision_norm,
                      void* u3, void* i3, const void* R, const void* W,
                      const void* cnt_u, const void* cnt_i, void* scratch,
                      const void* cells, const int* counts, int n_rounds,
                      int n_lanes, int n_ublocks, int bu, int bi, int k,
                      float lr, float r_scale, float u_reg, float i_reg,
                      void* stream, long long* failed_round,
                      long long* launched) {
  if (bu <= 0 || bi <= 0 || k <= 0 || n_rounds < 0 || n_lanes <= 0 ||
      n_lanes > 65535 || n_ublocks <= 0)   // the step grid's rows: cells
    return cudaErrorInvalidValue;
  if ((rtype == kRCodes) != (W == nullptr)) return cudaErrorInvalidValue;
  for (int r = 0; r < n_rounds; ++r)
    if (counts[r] < 0 || counts[r] > n_lanes) return cudaErrorInvalidValue;
  Epoch e = make_epoch(u3, i3, R, W, cnt_u, cnt_i, scratch, cells, counts,
                       n_rounds, n_lanes, n_ublocks, bu, bi, k, mm_bf16,
                       collision_norm, lr, r_scale, u_reg, i_reg, stream,
                       failed_round, launched);
  e.vec = vec_tiles(R, W, bi, rtype, wtype);
  switch (rtype) {
    case kRF32: return run_w<float>(e, wtype, mm_bf16);
    case kRBF16: return run_w<__nv_bfloat16>(e, wtype, mm_bf16);
    case kRCodes: return run_rw<int8_t, int8_t, true, false>(e, mm_bf16);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core kernel on int8 codes, k in 33..64, truncated after
// `stage` (0 tile loads, 1 + P, 2 + E, 3 + Gi, 4 + Gu and the step
// kernel: the full epoch): stripes as dense_rows_epoch (counts null,
// lanes 1), or the cell grid's rounds as dense_cells_epoch (counts[0..
// n_rounds) the cells a round, `lanes` item blocks); scratch as either.
int dense_rows_ablate(int stage, void* u3, void* i_tab, const void* R,
                      const void* cnt_u, const void* cnt_i, void* scratch,
                      const void* cells, const int* counts, int n_rounds,
                      int lanes, int n_ublocks, int bu, int ni_pad, int k,
                      float lr, float r_scale, float u_reg, float i_reg,
                      void* stream, long long* failed, long long* launched) {
  if (tc_kp(k, 1) != 64 || bu <= 0 || ni_pad <= 0 || n_ublocks <= 0 ||
      lanes <= 0 || lanes > 65535)
    return cudaErrorInvalidValue;
  Epoch e = make_epoch(u3, i_tab, R, nullptr, cnt_u, cnt_i, scratch, cells,
                       counts, n_rounds, lanes, n_ublocks, bu, ni_pad, k, 1,
                       1, lr, r_scale, u_reg, i_reg, stream, failed,
                       launched);
  e.vec = ni_pad % 16 == 0 && aligned16(R);
  switch (stage) {
    case kStream: return run_tc<int8_t, int8_t, true, false, 64, kStream>(e);
    case kPmm: return run_tc<int8_t, int8_t, true, false, 64, kPmm>(e);
    case kElem: return run_tc<int8_t, int8_t, true, false, 64, kElem>(e);
    case kItem: return run_tc<int8_t, int8_t, true, false, 64, kItem>(e);
    case kFull: return run_tc<int8_t, int8_t, true, false, 64, kFull>(e);
    default: return cudaErrorInvalidValue;
  }
}

const char* dense_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
