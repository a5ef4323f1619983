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
// One C call runs a whole epoch on the caller's stream, which sequences the
// stripes (the SGD semantics of README deviation #1). With the tensor cores
// it first converts the epoch's U to a bf16 copy, k zero-padded to KP (one
// launch: a stripe's U rows change only in its own user step, after its
// panel kernel has read them). Then, for each stripe of the order array:
//   A. the panel kernel. The stripe is cut into units of (128-item panel,
//      64-user chunk); a persistent grid of a fixed number of CTAs an SM
//      (ctas_per_sm) gives each CTA an equal run of units, panel-major, so
//      every SM carries the same work whatever the panel count. A CTA keeps its
//      current panel's OLD item rows in shared memory as bf16. Per unit, on
//      bf16 tensor cores with f32 accumulation (mma.sync.m16n8k16 fed by
//      ldmatrix):
//        P  = U_c I_p^T    (64 x 128, K = k padded to KP, a multiple of 16)
//        Gi += E_c^T U_c   (128 x KP, in registers while the CTA stays on
//                           the panel, then added to the stripe's
//                           [ni_pad, k] item gradient)
//        Gu  = E_c I_p     (64 x KP, added to the stripe's [bu, k] user
//                           gradient)
//      P's accumulators never leave registers: the epilogue reads R and W
//      for each pair of elements from shared memory, forms E and stores it
//      once as bf16 to shared memory.
//   B. the step kernel steps the item rows and the stripe's U rows from the
//      summed gradients and leaves both sums zeroed for the next stripe. No
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
// f32 once. The units a CTA sums depend on the grid alone, which is fixed
// by k and the card (not by the tile type), so the same inputs give
// bit-identical factors from run to run, and int8 codes give the same
// factors as float tiles holding code * r_scale. The host bounds each
// partial so that no sum leaves +-2^60: a partial beyond that bound, or not
// finite, sets its element to kFixPoison instead, from which no sum of
// in-range partials comes back within +-2^61, and the step kernel turns it into NaN, so a diverging
// run goes non-finite as the f32 sum of the plain version does.
// Rejected: a fixed-order scratch of per-panel partials reduced in index
// order, [NP, bu, k] f32 for Gu (4.1 GB written and read an epoch at
// 100k x 20k), which an earlier version of this kernel paid for.
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
// CUDA-core panel kernel (namespace cc): one CTA per 64-item panel walking
// all the stripe's users, scalar f32 FMAs out of shared memory, the same
// fixed-point user gradient, and the same step kernel.
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
// lane l (item block l) a user block ub_idx[t][l]; the epoch walks
// (round, lane) in order and runs the same panel and step kernels on the
// cell, with the item block's rows as I and ni_pad = bi. The cells of one
// round are disjoint in users and in items, so running them one after
// another equals running them together; a dummy lane (ub = NU, the
// all-invalid dummy cell) leaves both tables as they are and is skipped.
// Under this schedule a user block is visited NI times an epoch, so the
// bf16 copy of U made at the epoch's start would go stale after the first
// visit: the step kernel rewrites the block's bf16 rows from the f32 rows
// it has just stepped (the same rounding the copy kernel does). A cell's
// validity counts are staged once per cell, and the fixed-point bound
// comes from the cell's geometry (panels of bi, chunks of bu), so the
// epoch is bit-reproducible and codes equal float tiles as on the stripe.
// Bound: the tile read, as for the stripe (the same slots over the
// epoch); a cell of 2560 x 512 (the JAX package's measured grid at 100k x
// 20k) is a grid of 160 CTAs on 132 SMs, launch after launch: putting a
// round's cells into one launch is later work.
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

// B. Step the item rows and the stripe's user rows from their summed
// gradients, the counts and the old rows, and leave both sums zeroed for
// the next stripe. Threads take four values of a row each when k % 4 == 0,
// else one (the other lanes are padding). ub_rows (the cell grid, tensor
// cores): the block's rows of the bf16 copy of U, [bu_pad, kp], rewritten
// from the new rows. MASK: entity e of lambda L[e]
// has rank r = qrow[L[e] - 1] at this visit; a value at d >= r is left as
// it is (m = 0), and below it the regularization counts the valid partners
// of rank > d, hist[e][first_above(qrow, d)] (the stripe's suffix
// histogram of partner lambdas, exact integers).
template <bool MASK>
__global__ void __launch_bounds__(kThreads)
stripe_step_kernel(float* __restrict__ I, long long* __restrict__ gi,
                   const float* __restrict__ cnt_i, int ni_pad,
                   float* __restrict__ U, long long* __restrict__ gu,
                   const float* __restrict__ cnt_u, int bu, int k, float lr,
                   float i_reg, float u_reg, int collision_norm,
                   const int* __restrict__ li, const int* __restrict__ lu,
                   const int* __restrict__ qrow,
                   const int16_t* __restrict__ hist_i,
                   const int* __restrict__ hist_u,
                   __nv_bfloat16* __restrict__ ub_rows, int kp) {
  const int per = (k & 3) == 0 ? 4 : 1;
  const size_t n_i = static_cast<size_t>(ni_pad) * k / per;
  const size_t n_u = static_cast<size_t>(bu) * k / per;
  size_t q = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_i + n_u) return;
  const bool item = q < n_i;
  if (!item) q -= n_i;
  const size_t e = q * per / k;               // the entity's row
  const int d0 = static_cast<int>(q * per % k);
  float* x = (item ? I : U) + q * per;
  long long* acc = (item ? gi : gu) + q * per;
  const float c = (item ? cnt_i : cnt_u)[e];
  const float reg = item ? i_reg : u_reg;
  int rank = k;
  if (MASK) rank = qrow[(item ? li : lu)[e] - 1];
  long long sums[4] = {0, 0, 0, 0};
  float xs[4] = {0.f, 0.f, 0.f, 0.f};
  if (per == 4) {
    longlong2* a2 = reinterpret_cast<longlong2*>(acc);
    const longlong2 s0 = a2[0], s1 = a2[1];
    a2[0] = make_longlong2(0, 0);
    a2[1] = make_longlong2(0, 0);
    sums[0] = s0.x, sums[1] = s0.y, sums[2] = s1.x, sums[3] = s1.y;
    const float4 v = *reinterpret_cast<const float4*>(x);
    xs[0] = v.x, xs[1] = v.y, xs[2] = v.z, xs[3] = v.w;
  } else {
    sums[0] = *acc;
    *acc = 0;
    xs[0] = *x;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= per) break;
    const int d = d0 + j;
    float m = 1.f, cr = c;
    if (MASK) {
      const int h = first_above(qrow, k, d);
      m = d < rank ? 1.f : 0.f;
      cr = d < rank && h < k
               ? static_cast<float>(item ? hist_i[e * k + h]
                                         : hist_u[e * k + h])
               : 0.f;
    }
    xs[j] = sgd_value(xs[j], from_fixed(sums[j]), m, cr, c, lr, reg,
                      collision_norm);
  }
  if (per == 4)
    *reinterpret_cast<float4*>(x) = make_float4(xs[0], xs[1], xs[2], xs[3]);
  else
    *x = xs[0];
  if (ub_rows != nullptr && !item) {
    // the cell grid: the block's bf16 operand rows follow its f32 rows
    __nv_bfloat16* b = ub_rows + e * kp + d0;
    for (int j = 0; j < per; ++j) b[j] = __float2bfloat16_rn(xs[j]);
  }
}

// ---------------------------------------------------------------------
// A, tensor cores (mm_bf16, k <= 128)
// ---------------------------------------------------------------------
namespace tc {

constexpr int kPanel = 128;           // items per CTA
constexpr int kChunk = 64;            // users per step of the user loop
constexpr int kEStride = kPanel + 8;  // bf16 per row of E (16 B of pad)

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Users of a stripe in the bf16 copy of U: whole chunks.
__host__ __device__ constexpr int bu_pad(int bu) {
  return (bu + kChunk - 1) / kChunk * kChunk;
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
// type whose shared memory fits fewer CTAs per SM runs the grid in waves.
__host__ __device__ constexpr int ctas_per_sm(int kp) {
  return kp <= 64 ? 2 : 1;
}

// Each CTA of a persistent grid takes an equal run of the stripe's
// (panel, 64-user chunk) units, panel-major, so every SM carries the same
// work whatever the panel count. On leaving a panel it adds its share of
// that panel's item gradient to gi.
// MASK: the item panel is zeroed at and past each item's rank,
// qrow[li[p] - 1] (the bf16 U copy is masked already), so the three
// products are those of U o Mu and I o Mi.
template <typename RT, typename WT, bool CODES, bool MASK, int KP, int STAGE>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(KP))
panel_kernel(const float* __restrict__ U,            // unused: bf16 copy
             const __nv_bfloat16* __restrict__ Ubg,  // [bu_pad, KP]
             const float* __restrict__ I,            // [ni_pad, k], old
             const RT* __restrict__ R,               // [bu, ni_pad]
             const WT* __restrict__ W,               // [bu, ni_pad] / null
             long long* __restrict__ gu,             // [bu, k], fixed point
             long long* __restrict__ gi,             // [ni_pad, k], same
             int bu, int ni_pad, int k, int vec, float r_scale, float lim,
             const int* __restrict__ li,             // [ni_pad] (MASK)
             const int* __restrict__ lu,             // unused: bf16 copy
             const int* __restrict__ qrow) {         // [k] (MASK)
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
  const int n_chunks = (bu + kChunk - 1) / kChunk;
  const long long n_units =
      static_cast<long long>((ni_pad + kPanel - 1) / kPanel) * n_chunks;
  const long long begin = n_units * blockIdx.x / gridDim.x;
  const long long end = n_units * (blockIdx.x + 1) / gridDim.x;
  if (begin >= end) return;

  // a panel's OLD item rows, bf16-rounded, k zero-padded to KP (MASK:
  // zero from each item's rank on)
  auto load_panel = [&](int p0) {
    for (int q = tid; q < kPanel * KP / 2; q += kThreads) {
      const int p = q / (KP / 2), d = (q % (KP / 2)) * 2;
      float a = 0.f, b = 0.f;
      if (p0 + p < ni_pad) {
        const float* row = I + static_cast<size_t>(p0 + p) * k;
        const int r = MASK ? qrow[li[p0 + p] - 1] : k;
        if (d < r) a = row[d];
        if (d + 1 < r) b = row[d + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(Ib + p * USTR + d) =
          __floats2bfloat162_rn(a, b);
    }
  };
  auto load_unit = [&](long long q, int s) {
    unsigned char* st = smem + s * L.stage;
    const int p0 = static_cast<int>(q / n_chunks) * kPanel;
    const int u0 = static_cast<int>(q % n_chunks) * kChunk;
    load_tile<RT>(st + L.rt, R, u0, p0, bu, ni_pad, vec != 0);
    if (!CODES) load_tile<WT>(st + L.wt, W, u0, p0, bu, ni_pad, vec != 0);
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
  auto flush_gi = [&](int p0) {
#pragma unroll
    for (int j = 0; j < KP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 16 * warp + g + 8 * h, d = 8 * j + 2 * t;
        if (p < ni_pad && d < k)
          add2(gi + static_cast<size_t>(p) * k + d, d, k, gi_acc[j][2 * h],
               gi_acc[j][2 * h + 1], lim);
      }
  };

  int p0 = static_cast<int>(begin / n_chunks) * kPanel;
  load_panel(p0);
  zero_gi();
  load_unit(begin, 0);
  cp_async_commit();

  for (long long q = begin; q < end; ++q) {
    const int s = static_cast<int>(q - begin) & 1;
    if (q + 1 < end) load_unit(q + 1, s ^ 1);
    cp_async_commit();   // possibly empty: one group per unit
    cp_async_wait1();    // this unit's group has landed
    __syncthreads();
    if (static_cast<int>(q / n_chunks) * kPanel != p0) {
      // a new panel: every warp is done with the old one's rows
      if (STAGE >= kItem) flush_gi(p0);
      zero_gi();
      p0 = static_cast<int>(q / n_chunks) * kPanel;
      load_panel(p0);
      __syncthreads();
    }

    const unsigned char* st = smem + s * L.stage;
    const __nv_bfloat16* Ub =
        reinterpret_cast<const __nv_bfloat16*>(st + L.ub);
    const int u0 = static_cast<int>(q % n_chunks) * kChunk;

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
          if (u < bu && d < k)
            add2(gu + static_cast<size_t>(u) * k + d, d, k, acc[j][2 * h],
                 acc[j][2 * h + 1], lim);
        }
      }
    }
    __syncthreads();   // the stage, E and the panel rows are free
  }
  if (STAGE >= kItem) flush_gi(p0);
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

// MASK: the item rows and the user chunk are zeroed at and past each
// entity's rank, qrow[l[e] - 1], as they are staged.
template <typename RT, typename WT, bool CODES, bool MMBF16, bool MASK>
__global__ void __launch_bounds__(kThreads)
panel_kernel(const float* __restrict__ U,
             const __nv_bfloat16* __restrict__ Ubg,  // unused
             const float* __restrict__ I, const RT* __restrict__ R,
             const WT* __restrict__ W, long long* __restrict__ gu,
             long long* __restrict__ gi, int bu, int ni_pad, int k, int vec,
             float r_scale, float lim, const int* __restrict__ li,
             const int* __restrict__ lu, const int* __restrict__ qrow) {
  extern __shared__ float smem[];
  const int ks = k + 1;  // padded stride: item rows hit distinct banks
  float* Im = smem;                                   // [kPanel][ks]
  float* Us = Im + kPanel * ks;                       // [kChunk][k]
  float* Es = Us + kChunk * k;                        // [kChunk][kPanel+1]
  float* Ws = Es + kChunk * (kPanel + 1);             // [kChunk][kPanel]
  float* Gi = Ws + kChunk * kPanel;                   // [kPanel][k]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPanel;
  const int np_here = min(kPanel, ni_pad - p0);  // ragged last panel

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

// Byte offsets in the scratch: the user gradient [bu, k] and the item
// gradient [ni_pad, k], both 64-bit fixed point, then (tensor cores) the
// bf16 U [NU, bu_pad, KP].
size_t scratch_gi(int bu, int k) {
  return align256(static_cast<size_t>(bu) * k * sizeof(long long));
}
size_t scratch_ub(int bu, int ni_pad, int k) {
  return scratch_gi(bu, k) +
         align256(static_cast<size_t>(ni_pad) * k * sizeof(long long));
}

// The largest |partial| that keeps the sum of `parts` partials within
// +-2^60 units (below kFixMax, so no in-range sum reads as poisoned).
float fix_limit(long long parts) {
  return static_cast<float>(std::ldexp(1.0, 60 - kFixBits) /
                            static_cast<double>(std::max(parts, 1LL)) *
                            (1.0 - 1e-6));
}

struct Epoch {
  float* u3;
  float* I;
  const void* R;
  const void* W;
  const float* cnt_u;   // [NU, bu]
  const float* cnt_i;   // [NU, ni_pad]
  long long* gu;        // [bu, k]
  long long* gi;        // [ni_pad, k]
  __nv_bfloat16* ub;    // [NU, bu_pad, KP] (tensor cores)
  const long long* order;
  // rank masks, or all null: lambda / rank tables, each stripe's rank row
  // (that of its visit) and the stripes' suffix histograms of partner
  // lambdas
  const int* lu;        // [NU, bu]
  const int* li;        // [ni_pad]
  const int* qs;        // [NU, k]
  const int* hist_u;    // [NU, bu, k]
  const int16_t* hist_i;  // [NU, ni_pad, k]
  int n_order, n_stripes, bu, ni_pad, k, vec, collision_norm;
  float lr, r_scale, u_reg, i_reg;
  cudaStream_t stream;
  long long* failed;
  long long* launched;
  // 0: order holds stripes. The cell grid: order holds the rounds' user
  // blocks lane by lane, lane b of `lanes` is item block b
  int lanes = 0;
};

Epoch make_epoch(void* u3, void* i_tab, const void* R, const void* W,
                 const void* cnt_u, const void* cnt_i, void* scratch,
                 const long long* order, int n_order, int n_stripes, int bu,
                 int ni_pad, int k, int collision_norm, float lr,
                 float r_scale, float u_reg, float i_reg, void* stream,
                 long long* failed, long long* launched) {
  char* base = static_cast<char*>(scratch);
  *failed = -1;
  *launched = 0;
  return Epoch{static_cast<float*>(u3), static_cast<float*>(i_tab), R, W,
               static_cast<const float*>(cnt_u),
               static_cast<const float*>(cnt_i),
               reinterpret_cast<long long*>(base),
               reinterpret_cast<long long*>(base + scratch_gi(bu, k)),
               reinterpret_cast<__nv_bfloat16*>(base +
                                                scratch_ub(bu, ni_pad, k)),
               order, nullptr, nullptr, nullptr, nullptr, nullptr, n_order,
               n_stripes, bu, ni_pad, k, 0, collision_norm, lr, r_scale,
               u_reg, i_reg, static_cast<cudaStream_t>(stream), failed,
               launched};
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// The epoch's stripes in order: the panel kernel on `grid` CTAs, then
// (step) the step kernel. ``kernel`` is an instantiation of either panel
// kernel; they share their signature. `lim` bounds each gradient partial.
template <bool MASK, typename RT, typename WT, typename Kernel>
cudaError_t walk(const Epoch& e, Kernel kernel, unsigned grid, size_t smem,
                 int kp, bool step, float lim) {
  const size_t bp = static_cast<size_t>(tc::bu_pad(e.bu));
  for (int i = 0; i < e.n_order; ++i) {
    // the visit's user block s, item block b and tile t: a stripe is
    // (s, 0, s); a cell is (s, lane, s * lanes + lane), and a dummy lane
    // (s = NU) is skipped
    const long long s = e.order[i];
    const int b = e.lanes ? i % e.lanes : 0;
    const long long t = e.lanes ? s * e.lanes + b : s;
    if (s < 0 || s > e.n_stripes || (s == e.n_stripes && !e.lanes)) {
      *e.failed = t;
      return cudaErrorInvalidValue;
    }
    if (s == e.n_stripes) continue;
    const size_t tile = static_cast<size_t>(t) * e.bu * e.ni_pad;
    float* U = e.u3 + static_cast<size_t>(s) * e.bu * e.k;
    float* I = e.I + static_cast<size_t>(b) * e.ni_pad * e.k;
    __nv_bfloat16* Ub = e.ub + static_cast<size_t>(s) * bp * kp;
    const RT* R = static_cast<const RT*>(e.R) + tile;
    const WT* W = e.W ? static_cast<const WT*>(e.W) + tile : nullptr;
    const int* lu = MASK ? e.lu + static_cast<size_t>(s) * e.bu : nullptr;
    const int* qrow = MASK ? e.qs + static_cast<size_t>(s) * e.k : nullptr;
    kernel<<<grid, kThreads, smem, e.stream>>>(
        U, Ub, I, R, W, e.gu, e.gi, e.bu, e.ni_pad, e.k, e.vec, e.r_scale,
        lim, e.li, lu, qrow);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++*e.launched;
    if (err == cudaSuccess && step) {
      const size_t n = (static_cast<size_t>(e.ni_pad) + e.bu) * e.k;
      const size_t hk = static_cast<size_t>(s) * e.k;
      stripe_step_kernel<MASK><<<blocks_for(e.k % 4 ? n : n / 4), kThreads,
                                 0, e.stream>>>(
          I, e.gi, e.cnt_i + static_cast<size_t>(t) * e.ni_pad, e.ni_pad,
          U, e.gu, e.cnt_u + static_cast<size_t>(t) * e.bu, e.bu, e.k, e.lr,
          e.i_reg, e.u_reg, e.collision_norm, e.li, lu, qrow,
          MASK ? e.hist_i + hk * e.ni_pad : nullptr,
          MASK ? e.hist_u + hk * e.bu : nullptr,
          e.lanes && kp ? Ub : nullptr, kp);
      err = cudaGetLastError();
      if (err == cudaSuccess) ++*e.launched;
    }
    if (err != cudaSuccess) {
      *e.failed = t;
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
cudaError_t run_tc(const Epoch& e) {
  constexpr tc::Smem L =
      tc::smem_layout(sizeof(RT), CODES ? 0 : sizeof(WT), KP);
  auto kernel = tc::panel_kernel<RT, WT, CODES, MASK, KP, STAGE>;
  cudaError_t err = set_smem(kernel, L.total);
  // the persistent grid: ctas_per_sm(KP) CTAs an SM, whatever the tile type
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long panels = (e.ni_pad + tc::kPanel - 1) / tc::kPanel;
  const long long chunks = (e.bu + tc::kChunk - 1) / tc::kChunk;
  const unsigned grid = static_cast<unsigned>(
      std::min<long long>(panels * chunks, 1LL * sms * tc::ctas_per_sm(KP)));
  // Gu: one partial a panel; Gi: one a CTA on the panel, at most a chunk's
  const float lim = fix_limit(std::max(panels, chunks));
  const size_t n =
      static_cast<size_t>(e.n_stripes) * tc::bu_pad(e.bu) * KP / 2;
  tc::u_bf16_kernel<<<blocks_for(n), kThreads, 0, e.stream>>>(
      e.u3, e.ub, e.n_stripes, e.bu, e.k, KP, MASK ? e.lu : nullptr,
      MASK ? e.qs : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*e.launched;
  return walk<MASK, RT, WT>(e, kernel, grid, L.total, KP, STAGE == kFull,
                            lim);
}

template <typename RT, typename WT, bool CODES, bool MMBF16, bool MASK>
cudaError_t run_cc(const Epoch& e) {
  auto kernel = cc::panel_kernel<RT, WT, CODES, MMBF16, MASK>;
  const size_t smem = cc::smem_floats(e.k) * sizeof(float);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid =
      static_cast<unsigned>((e.ni_pad + cc::kPanel - 1) / cc::kPanel);
  // Gu: one partial a panel; Gi: one, stored
  return walk<MASK, RT, WT>(e, kernel, grid, smem, 0, true, fix_limit(grid));
}

template <typename RT, typename WT, bool CODES, bool MASK>
cudaError_t run_rw(const Epoch& e, int mm_bf16) {
  switch (tc_kp(e.k, mm_bf16)) {
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
  const bool masked = e.qs != nullptr;
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

}  // namespace

extern "C" {

// Bytes of the scratch an epoch needs, zeroed by the caller: the stripe's
// user gradient [bu, k] and item gradient [ni_pad, k] in 64-bit fixed point
// (the kernels leave them zeroed) and, with the tensor cores, the epoch's bf16 copy of U
// [NU, bu_pad, KP].
size_t dense_rows_scratch_bytes(int n_stripes, int bu, int ni_pad, int k,
                                int mm_bf16) {
  return scratch_ub(bu, ni_pad, k) +
         static_cast<size_t>(n_stripes) * tc::bu_pad(bu) * tc_kp(k, mm_bf16) *
             2;
}

// Kernel launches of one epoch: the panel and step kernels of each stripe,
// and with the tensor cores the bf16 copy of U.
long long dense_rows_epoch_launches(int n_stripes, int k, int mm_bf16) {
  return 2LL * n_stripes + (tc_kp(k, mm_bf16) != 0);
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
// each stripe of order[0..n_order) the panel and step kernels.
// Tiles are [n_stripes, bu, ni_pad] (R of rtype 0 f32 / 1 bf16 / 2 int8
// codes; W of wtype 0 int8 / 1 bf16 / 2 f32, or null for codes), u3 is
// [n_stripes, bu, k], i_tab [ni_pad, k], cnt_u [n_stripes, bu] and cnt_i
// [n_stripes, ni_pad] the tiles' f32 validity counts, `scratch` holds
// dense_rows_scratch_bytes zeroed bytes; `order` is a host array.
// Rank masks (codes or int8 W only; all five null for full rank): lu
// [n_stripes, bu] and li [ni_pad] int32 lambdas (or ranks) in [1, k], qs
// [n_stripes, k] int32 each stripe's nondecreasing rank row (rank of lambda
// L = qs[s][L - 1]), hist_u [n_stripes, bu, k] int32 and hist_i
// [n_stripes, ni_pad, k] int16 the stripes' counts of valid partners of
// lambda >= l + 1. Returns the cudaError_t of the first launch that failed
// (its stripe in *failed_stripe, -1 for the U copy), else cudaSuccess;
// *launched counts the kernels launched.
int dense_rows_epoch(int rtype, int wtype, int mm_bf16, int collision_norm,
                     void* u3, void* i_tab, const void* R, const void* W,
                     const void* lu, const void* li, const void* qs,
                     const void* hist_u, const void* hist_i,
                     const void* cnt_u, const void* cnt_i, void* scratch,
                     const long long* order, int n_order, int n_stripes,
                     int bu, int ni_pad, int k, float lr, float r_scale,
                     float u_reg, float i_reg, void* stream,
                     long long* failed_stripe, long long* launched) {
  if (bu <= 0 || ni_pad <= 0 || k <= 0 || n_order < 0 || n_stripes <= 0)
    return cudaErrorInvalidValue;
  if ((rtype == kRCodes) != (W == nullptr)) return cudaErrorInvalidValue;
  const int n_masks = (lu != nullptr) + (li != nullptr) + (qs != nullptr) +
                      (hist_u != nullptr) + (hist_i != nullptr);
  if (n_masks != 0 && n_masks != 5) return cudaErrorInvalidValue;
  const int rb = rtype_bytes(rtype), wb = W ? wtype_bytes(wtype) : 1;
  Epoch e = make_epoch(u3, i_tab, R, W, cnt_u, cnt_i, scratch, order,
                       n_order, n_stripes, bu, ni_pad, k, collision_norm, lr,
                       r_scale, u_reg, i_reg, stream, failed_stripe, launched);
  e.lu = static_cast<const int*>(lu);
  e.li = static_cast<const int*>(li);
  e.qs = static_cast<const int*>(qs);
  e.hist_u = static_cast<const int*>(hist_u);
  e.hist_i = static_cast<const int16_t*>(hist_i);
  e.vec = (static_cast<size_t>(ni_pad) * rb) % 16 == 0 &&
          (static_cast<size_t>(ni_pad) * wb) % 16 == 0 && aligned16(R) &&
          (W == nullptr || aligned16(W));
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
// bf16 copy of U, then for each (round, lane) of ub_idx[n_rounds][n_lanes]
// (a host array; user block n_ublocks marks a dummy lane, skipped) the
// panel and step kernels on cell ub * n_lanes + lane. Tiles are [n_ublocks
// * n_lanes + 1, bu, bi] (types as dense_rows_epoch; no rank masks), u3
// [n_ublocks, bu, k], i3 [n_lanes, bi, k], cnt_u [n_cells + 1, bu] and
// cnt_i [n_cells + 1, bi] the cells' f32 validity counts, `scratch` holds
// dense_rows_scratch_bytes(n_ublocks, bu, bi, k, mm_bf16) zeroed bytes.
// Returns as dense_rows_epoch, the failing cell in *failed_cell.
int dense_cells_epoch(int rtype, int wtype, int mm_bf16, int collision_norm,
                      void* u3, void* i3, const void* R, const void* W,
                      const void* cnt_u, const void* cnt_i, void* scratch,
                      const long long* ub_idx, int n_rounds, int n_lanes,
                      int n_ublocks, int bu, int bi, int k, float lr,
                      float r_scale, float u_reg, float i_reg, void* stream,
                      long long* failed_cell, long long* launched) {
  if (bu <= 0 || bi <= 0 || k <= 0 || n_rounds < 0 || n_lanes <= 0 ||
      n_ublocks <= 0 || 1LL * n_rounds * n_lanes > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if ((rtype == kRCodes) != (W == nullptr)) return cudaErrorInvalidValue;
  const int rb = rtype_bytes(rtype), wb = W ? wtype_bytes(wtype) : 1;
  Epoch e = make_epoch(u3, i3, R, W, cnt_u, cnt_i, scratch, ub_idx,
                       n_rounds * n_lanes, n_ublocks, bu, bi, k,
                       collision_norm, lr, r_scale, u_reg, i_reg, stream,
                       failed_cell, launched);
  e.lanes = n_lanes;
  e.vec = (static_cast<size_t>(bi) * rb) % 16 == 0 &&
          (static_cast<size_t>(bi) * wb) % 16 == 0 && aligned16(R) &&
          (W == nullptr || aligned16(W));
  switch (rtype) {
    case kRF32: return run_w<float>(e, wtype, mm_bf16);
    case kRBF16: return run_w<__nv_bfloat16>(e, wtype, mm_bf16);
    case kRCodes: return run_rw<int8_t, int8_t, true, false>(e, mm_bf16);
    default: return cudaErrorInvalidValue;
  }
}

// The tensor-core kernel on int8 codes, k in 33..64, truncated after
// `stage` (0 tile loads, 1 + P, 2 + E, 3 + Gi, 4 + Gu and the step
// kernel: the full epoch); arguments as dense_rows_epoch.
int dense_rows_ablate(int stage, void* u3, void* i_tab, const void* R,
                      const void* cnt_u, const void* cnt_i, void* scratch,
                      const long long* order, int n_order, int n_stripes,
                      int bu, int ni_pad, int k, float lr, float r_scale,
                      float u_reg, float i_reg, void* stream,
                      long long* failed_stripe, long long* launched) {
  if (tc_kp(k, 1) != 64 || bu <= 0 || ni_pad <= 0 || n_stripes <= 0)
    return cudaErrorInvalidValue;
  Epoch e = make_epoch(u3, i_tab, R, nullptr, cnt_u, cnt_i, scratch, order,
                       n_order, n_stripes, bu, ni_pad, k, 1, lr, r_scale,
                       u_reg, i_reg, stream, failed_stripe, launched);
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
