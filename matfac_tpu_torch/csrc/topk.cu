// Full-catalog top-N for a set of queried users on Hopper (sm_90a), CUDA C++
// on the CUDA cores.
//
// Replaces the Pallas TPU kernel matfac_tpu/ops/topk_kernel.py:topk_tiles.
// For each queried user u and every catalog item i:
//   score = ((<U[u], I[i]> + mu) + ub[u]) + ib[i]     (the XLA scorer's order,
//                                                     eval/ranking.py:82-84)
// with <U[u], I[i]> summed over d = 0..k-1 in that order by fmaf, so a
// user's scores are bitwise the same whatever user set, chunk or tile they
// are computed in; invalid items and the items of u's train row are not
// scorable (-3e38), and the result is the n best scorable items,
// descending, equal scores going to the smallest item id; slots with no
// scorable item carry id -1 and -3e38. Each candidate is the 64-bit key
// (order-preserving score bits << 32 | ~id): keys are unique, so the top-n
// set is exact and independent of the order in which keys are seen.
//
// Two routes.
//
// FUSED (n <= kFusedMaxN = 128; topk_fused): one kernel sweeps the whole
// catalog for a tile of 64 users and writes no score to device memory, as
// topk_tiles kept its score tiles in VMEM.
//   * Score tiles of 64 users x 256 items, f32 FMAs on the CUDA cores: each
//     thread holds an 8 x 8 register tile (8 users of its warp x 8 items
//     lane + 32 j) and reads its operands as float4 along k from shared
//     memory, 16 floats for 64 FMAs each 4 steps of d (4 FMAs a float loaded;
//     the radix route's 4x4 tile does 2). Item and user rows arrive by
//     16-byte cp.async in 16-deep k slices, a 3-stage ring loaded two
//     stages ahead with one barrier a stage; the row stride of 80 B keeps a
//     quarter warp's float4 loads on distinct banks.
//   * Selection in the epilogue of each item tile. A warp owns its 8 users'
//     selection: a threshold key (the n-th best at the last cut-back) and a
//     buffer of cap keys in shared memory (cap = a power of 2 >= n + 32, at
//     least 64). Each score is compared with its user's threshold score (3
//     adds and a compare); for a user with candidates the warp appends the
//     tile's keys in one go (a warp scan places each lane's). Where they
//     would not fit (the first tiles), the tile goes in rounds of 32, and
//     before a round that might overflow the warp sorts the buffer
//     (bitonic, in shared memory), keeps the best n and raises the
//     threshold to the n-th key: no candidate that could still be among the
//     best n is ever dropped.
//   * Exclusion without staging. A user's train row is sorted, so a cursor
//     per user walks it as the item tiles advance (one warp-wide load per
//     user and tile); the tile's excluded columns become bits in a per-lane
//     byte for each user in shared memory, which the lane reads with one
//     8-byte load. Invalid items are a bit per lane from the invalid mask.
//   * Filling the card. With B / 64 user tiles at least the card's resident
//     CTAs, each CTA sweeps the whole catalog (1 launch). Otherwise the
//     catalog is split into S slices (grid.y); each slice's CTA binary-
//     searches its user rows' start once and writes its best n keys to a
//     [B, S, n] scratch, and topk_merge_kernel picks the final n (2
//     launches). The host picks S (ops/topk_kernel.py:fused_plan).
// What bounds it: the scores' 2 k FLOP a (user, item) pair at the f32
// CUDA-core peak (3.8 ms at 100k users x 20k items, k 64); the item table
// (5 MB there) is read from L2 by every user tile.
//
// RADIX (n up to kMaxN = 4096; topk_catalog_chunk). One call handles a
// chunk of B users with two kernels on one stream:
//   A. score_kernel: a tiled f32 product (64 users x 64 items per block, a
//      4x4 register tile per thread, 32-deep k slices in shared memory) with
//      the bias / invalid epilogue, written to a [B, n_items] f32 scratch.
//   B. select_kernel: one block per user. It writes -3e38 over the user's
//      train row (CSR, sorted columns: O(row) work, no per-tile staging),
//      finds the n-th largest scorable score by a 4-pass 8-bit radix select
//      on order-preserving uint32 keys, gathers every score above it plus
//      the smallest-id ties at it (a block scan keeps id order), and sorts
//      those n candidates by (score desc, id asc) with a bitonic sort of
//      64-bit (key, ~id) words in shared memory.
// The TPU kernel's n passes of max-extraction and its [n_tiles, BU, c_max]
// rated-in-tile lists were VMEM devices; radix select costs the same for
// n = 1 and n = 4096 (kMaxN), and CSR exclusion costs the row's length.
//
// What bounds it on this card: a full pass at 100k users x 20k items, k=64,
// is 2.6e11 FLOP of scores (about 4 ms at the 67 TFLOP/s f32 CUDA-core peak;
// kernel A, bound by its shared-memory loads, reaches a fraction of that)
// and 8 GB of scores written once and read five times by kernel B (the
// radix passes and the gather; a 80 KB row mostly stays in L2 between
// passes). The route serves n above the fused route's limit (ARHR at
// n = 1000).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kTU = 64;          // users per score block
constexpr int kTI = 64;          // items per score block
constexpr int kKC = 32;          // k slice held in shared memory
constexpr int kScoreThreads = 256;
constexpr int kSelThreads = 512;
constexpr int kMaxN = 4096;      // candidates sorted in shared memory
static_assert(kScoreThreads == 256, "the 4x4 tile mapping needs 16 x 16");
static_assert(kSelThreads % 32 == 0, "the eq scan works in whole warps");

__device__ __forceinline__ uint32_t ord_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const float* __restrict__ U, const long long* __restrict__ users,
             const float* __restrict__ I, const float* __restrict__ ib,
             const float* __restrict__ ub, const float* __restrict__ mu,
             const uint8_t* __restrict__ invalid, float* __restrict__ S,
             int B, int n_items, int k) {
  __shared__ float As[kKC][kTU + 4];
  __shared__ float Bs[kKC][kTI + 4];
  __shared__ long long urow[kTU];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int u0 = blockIdx.y * kTU, i0 = blockIdx.x * kTI;
  if (tid < kTU) urow[tid] = u0 + tid < B ? users[u0 + tid] : -1;
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;

  for (int d0 = 0; d0 < k; d0 += kKC) {
    for (int idx = tid; idx < kTU * kKC; idx += kScoreThreads) {
      const int u = idx / kKC, d = idx % kKC;
      const long long r = urow[u];
      As[d][u] = (r >= 0 && d0 + d < k) ? U[r * k + d0 + d] : 0.f;
    }
    for (int idx = tid; idx < kTI * kKC; idx += kScoreThreads) {
      const int i = idx / kKC, d = idx % kKC;
      const int it = i0 + i;
      Bs[d][i] = (it < n_items && d0 + d < k)
                     ? I[static_cast<size_t>(it) * k + d0 + d]
                     : 0.f;
    }
    __syncthreads();
    const int dn = min(kKC, k - d0);
    for (int d = 0; d < dn; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = As[d][ty + 16 * q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[d][tx + 16 * j];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] = fmaf(a[q], b[j], acc[q][j]);
    }
    __syncthreads();
  }

  const float m = mu[0];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ul = ty + 16 * q;
    if (u0 + ul >= B) continue;
    const float ubv = ub[urow[ul]];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int it = i0 + tx + 16 * j;
      if (it >= n_items) continue;
      float s = ((acc[q][j] + m) + ubv) + ib[it];
      if (invalid[it]) s = kNegInf;
      if (s == 0.f) s = 0.f;  // -0 and +0 are one score: one key
      S[static_cast<size_t>(u0 + ul) * n_items + it] = s;
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
select_kernel(float* __restrict__ S, const long long* __restrict__ users,
              const long long* __restrict__ indptr,
              const int* __restrict__ indices, int n_items, int n, int ncap,
              float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ unsigned long long cand[];   // [ncap]
  __shared__ unsigned int hist[256];
  __shared__ unsigned int warp_eq[kSelThreads / 32];
  __shared__ unsigned int s_prefix, s_mask, s_target, s_need_eq, s_gt,
      s_eq_base;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  float* Srow = S + static_cast<size_t>(row) * n_items;
  const long long u = users[row];

  // exclusion: the user's train row
  for (long long e = indptr[u] + tid; e < indptr[u + 1]; e += kSelThreads)
    Srow[indices[e]] = kNegInf;
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_gt = 0;
    s_eq_base = 0;
  }
  __syncthreads();

  // radix select of the target-th largest scorable key, 8 bits a pass
  const uint32_t masked = ord_key(kNegInf);
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = tid; b < 256; b += kSelThreads) hist[b] = 0;
    __syncthreads();
    const uint32_t prefix = s_prefix, mask = s_mask;
    for (int i = tid; i < n_items; i += kSelThreads) {
      const uint32_t key = ord_key(Srow[i]);
      if (key > masked && (key & mask) == prefix)
        atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      if (pass == 0) {
        unsigned int m = 0;
        for (int b = 0; b < 256; ++b) m += hist[b];
        s_target = min(static_cast<unsigned int>(n), m);
        s_need_eq = s_target;
      }
      const unsigned int rem = s_need_eq;
      if (rem > 0) {
        unsigned int cum = 0;
        int b = 255;
        for (; b > 0; --b) {
          if (cum + hist[b] >= rem) break;
          cum += hist[b];
        }
        s_need_eq = rem - cum;
        s_prefix = prefix | (static_cast<uint32_t>(b) << shift);
        s_mask = mask | (255u << shift);
      }
    }
    __syncthreads();
    if (s_target == 0) break;
  }
  const unsigned int target = s_target;
  const unsigned int need_eq = s_need_eq;   // ties at T to take, id order
  const unsigned int c_gt = target - need_eq;
  const uint32_t T = s_prefix;

  // gather: keys above T anywhere in [0, c_gt), the first need_eq keys
  // equal to T in id order after them
  for (int i = tid; i < ncap; i += kSelThreads) cand[i] = 0ull;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  if (target > 0) {
    for (int base = 0; base < n_items; base += kSelThreads) {
      const int i = base + tid;
      bool eq = false;
      uint32_t key = 0;
      if (i < n_items) {
        key = ord_key(Srow[i]);
        if (key > masked) {
          if (key > T) {
            const unsigned int p = atomicAdd(&s_gt, 1u);
            cand[p] = (static_cast<unsigned long long>(key) << 32) |
                      (0xffffffffu - static_cast<uint32_t>(i));
          } else {
            eq = key == T;
          }
        }
      }
      const unsigned int ballot = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) warp_eq[warp] = __popc(ballot);
      __syncthreads();
      unsigned int before = s_eq_base, total = 0;
      for (int w = 0; w < kSelThreads / 32; ++w) {
        if (w < warp) before += warp_eq[w];
        total += warp_eq[w];
      }
      before += __popc(ballot & ((1u << lane) - 1u));
      if (eq && before < need_eq)
        cand[c_gt + before] = (static_cast<unsigned long long>(key) << 32) |
                              (0xffffffffu - static_cast<uint32_t>(i));
      const unsigned int next_base = s_eq_base + total;
      __syncthreads();
      if (tid == 0) s_eq_base = next_base;
    }
  }
  __syncthreads();

  // bitonic sort, descending on (key, ~id): score desc, then id asc
  for (int size = 2; size <= ncap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < ncap; i += kSelThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = cand[i], b = cand[j];
          const bool desc = (i & size) == 0;
          if (desc ? a < b : a > b) {
            cand[i] = b;
            cand[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += kSelThreads) {
    float s = kNegInf;
    int id = -1;
    if (static_cast<unsigned int>(i) < target) {
      const unsigned long long c = cand[i];
      s = key_float(static_cast<uint32_t>(c >> 32));
      id = static_cast<int>(0xffffffffu - static_cast<uint32_t>(c));
    }
    out_s[static_cast<size_t>(row) * n + i] = s;
    out_i[static_cast<size_t>(row) * n + i] = id;
  }
}

// ---------------------------------------------------------------------
// the fused route
// ---------------------------------------------------------------------

// n of the fused route, set by shared memory: at n = 128 the 64 users'
// candidate buffers of 256 keys take 128 KB and, with the 75 KB ring, 207
// KB of the 227 KB a block may have; n = 256 would need 512-key buffers
constexpr int kFusedMaxN = 128;
constexpr int kFTU = 64;          // users per CTA (8 a warp)
constexpr int kFTI = 256;         // items per tile (8 a lane)
constexpr int kFKC = 16;          // k slice per ring stage
constexpr int kFStr = kFKC + 4;   // floats per staged row: 80 B
constexpr int kFThreads = 256;
constexpr int kExWords = 18;      // exclusion words a lane: 64 user bytes
constexpr int kMaxMerge = 4096;   // keys a merge block sorts (S * n)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 3;        // the ring of k slices
constexpr int kFusedCtas = 1;     // CTAs an SM the registers are sized for
// the sweep cut after a stage, for scripts/torch_topk_probe.py: 0 the
// loads, 1 + the scores, 2 + exclusion bits and the threshold filter,
// 3 the kernel (+ the keys into the queues and the flushes)
constexpr int kCut = 3;
// 1: the probe's counts of the selection's work, added to out_s[0, 0..1]
// (tiles with a candidate, users with one)
constexpr int kStats = 0;
constexpr int kStageFloats = (kFTI + kFTU) * kFStr;
static_assert(kFThreads == 32 * (kFTU / 8), "a warp owns 8 users");
static_assert(kFTI == 8 * 32, "a lane owns 8 items of a tile");

// every key of a scorable item is above this one (score -3e38, any id)
__device__ __forceinline__ unsigned long long thr0() {
  return (static_cast<unsigned long long>(ord_key(kNegInf)) << 32) |
         0xffffffffull;
}

__device__ __forceinline__ unsigned long long item_key(float s, int item) {
  if (s == 0.f) s = 0.f;   // -0 and +0 are one score: one key
  return (static_cast<unsigned long long>(ord_key(s)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(item));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

struct FusedSmem {
  size_t ring, buf, thr, cnt, ex, rows, cur, end, total;
};
__host__ __device__ constexpr FusedSmem fused_smem(int cap) {
  FusedSmem m{};
  m.ring = 0;
  m.buf = m.ring + kStages * kStageFloats * sizeof(float);
  m.thr = m.buf + static_cast<size_t>(kFTU) * cap * 8;
  m.cnt = m.thr + kFTU * 8;
  m.ex = m.cnt + kFTU * 4;
  m.rows = m.ex + 32 * kExWords * 4;
  m.cur = m.rows + kFTU * 8;
  m.end = m.cur + kFTU * 8;
  m.total = m.end + kFTU * 8;
  return m;
}

// Sort the cap keys at b descending, by one warp.
__device__ void warp_sort_desc(unsigned long long* b, int cap, int lane) {
  for (int size = 2; size <= cap; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < cap / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long x = b[lo], y = b[hi];
        if ((lo & size) == 0 ? x < y : x > y) {
          b[lo] = y;
          b[hi] = x;
        }
      }
      __syncwarp();
    }
}

// The selection state of the CTA's users, in shared memory.
struct Sel {
  unsigned long long* buf;   // [kFTU][cap] candidate keys
  unsigned long long* thr;   // [kFTU] threshold key: the n-th best at the
                             // last cut-back
  int* cnt;                  // [kFTU] live keys in buf
  int cap, n;
};

// Exclusive prefix sum of x over the warp's lanes; total: the sum.
__device__ __forceinline__ int warp_scan(int x, int lane, int& total) {
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  total = __shfl_sync(kFull, incl, 31);
  return incl - x;
}

// Warp-wide: sort user lu's buffer, keep its best n, raise its threshold
// to the n-th key once there are n.
__device__ __noinline__ void cut_back(Sel s, int lu, int lane) {
  unsigned long long* b = s.buf + static_cast<size_t>(lu) * s.cap;
  const int c = s.cnt[lu];
  for (int i = c + lane; i < s.cap; i += 32) b[i] = 0ull;
  __syncwarp();
  warp_sort_desc(b, s.cap, lane);
  if (lane == 0) {
    const int keep = min(c, s.n);
    s.cnt[lu] = keep;
    if (keep == s.n) s.thr[lu] = b[s.n - 1];
  }
  __syncwarp();
}

// Warp-wide: append each lane's key (0: none) for user lu if it beats the
// threshold, cutting the buffer back first if the keys might not fit (the
// 32 keys of a round always fit after a cut: cap >= n + 32).
__device__ __noinline__ void insert(Sel s, int lu, unsigned long long key,
                                    int lane) {
  bool ok = key > s.thr[lu];
  unsigned b = __ballot_sync(kFull, ok);
  if (b == 0) return;
  int c = s.cnt[lu];
  if (c + __popc(b) > s.cap) {
    cut_back(s, lu, lane);
    ok = key > s.thr[lu];
    b = __ballot_sync(kFull, ok);
    c = s.cnt[lu];
    if (b == 0) return;
  }
  if (ok)
    s.buf[static_cast<size_t>(lu) * s.cap + c +
          __popc(b & ((1u << lane) - 1u))] = key;
  __syncwarp();
  if (lane == 0) s.cnt[lu] = c + __popc(b);
  __syncwarp();
}

__global__ void __launch_bounds__(kFThreads, kFusedCtas)
topk_fused_kernel(const float* __restrict__ U,
                  const long long* __restrict__ users,
                  const float* __restrict__ I, const float* __restrict__ ib,
                  const float* __restrict__ ub, const float* __restrict__ mu,
                  const uint8_t* __restrict__ invalid,
                  const long long* __restrict__ indptr,
                  const int* __restrict__ indices, int B, int n_items, int k,
                  int n, int cap, int vec, unsigned long long* __restrict__ keys,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FusedSmem L = fused_smem(cap);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  const Sel sel{reinterpret_cast<unsigned long long*>(smem + L.buf),
                reinterpret_cast<unsigned long long*>(smem + L.thr),
                reinterpret_cast<int*>(smem + L.cnt), cap, n};
  uint32_t* ex = reinterpret_cast<uint32_t*>(smem + L.ex);
  long long* rows = reinterpret_cast<long long*>(smem + L.rows);
  long long* cur = reinterpret_cast<long long*>(smem + L.cur);
  long long* end = reinterpret_cast<long long*>(smem + L.end);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * kFTU;
  const int S = gridDim.y, split = blockIdx.y;
  const int n_tiles = (n_items + kFTI - 1) / kFTI;
  const int t0 = static_cast<int>(1LL * n_tiles * split / S);
  const int t1 = static_cast<int>(1LL * n_tiles * (split + 1) / S);

  if (tid < kFTU) {
    const long long r = u0 + tid < B ? users[u0 + tid] : -1;
    rows[tid] = r;
    sel.cnt[tid] = 0;
    sel.thr[tid] = thr0();
    long long lo = 0, hi = 0;
    if (r >= 0) {
      // the slice's first train entry of this row: binary search, once
      lo = indptr[r];
      hi = indptr[r + 1];
      long long a = lo, b = hi;
      const int first = t0 * kFTI;
      while (a < b) {
        const long long m = (a + b) >> 1;
        if (indices[m] < first) a = m + 1; else b = m;
      }
      lo = a;
    }
    cur[tid] = lo;
    end[tid] = hi;
  }
  __syncthreads();

  // per user of the warp: its bias and threshold score (+inf past B:
  // nothing passes)
  const float m = mu[0];
  float ubv[8], thr_s[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const long long r = rows[warp * 8 + q];
    ubv[q] = r >= 0 ? ub[r] : 0.f;
    thr_s[q] = r >= 0 ? key_float(static_cast<uint32_t>(thr0() >> 32))
                      : __int_as_float(0x7f800000);
  }

  // the sweep in stages of one k slice of one item tile: items in rows
  // [0, kFTI), users in [kFTI, kFTI + kFTU), a ring of kStages loaded
  // kStages - 1 ahead of the compute, one barrier a stage
  const int nks = (k + kFKC - 1) / kFKC;
  const int n_stages = (t1 - t0) * nks;
  int lt = t0, ls = 0;   // the next stage to load: tile, k slice
  auto load_next = [&](int buf) {
    float* st = ring + buf * kStageFloats;
    const int it0 = lt * kFTI, d0 = ls * kFKC;
    if (vec) {
      for (int p = tid; p < (kFTI + kFTU) * (kFKC / 4); p += kFThreads) {
        const int row = p / (kFKC / 4), d = d0 + (p % (kFKC / 4)) * 4;
        const float* src = I;
        bool ok = d < k;
        if (row < kFTI) {
          ok = ok && it0 + row < n_items;
          if (ok) src = I + static_cast<size_t>(it0 + row) * k + d;
        } else {
          const long long r = rows[row - kFTI];
          ok = ok && r >= 0;
          if (ok) src = U + static_cast<size_t>(r) * k + d;
        }
        cp_async16(st + row * kFStr + (d - d0), src, ok ? 16 : 0);
      }
    } else {
      for (int p = tid; p < (kFTI + kFTU) * kFKC; p += kFThreads) {
        const int row = p / kFKC, d = d0 + p % kFKC;
        float v = 0.f;
        if (d < k) {
          if (row < kFTI) {
            if (it0 + row < n_items)
              v = I[static_cast<size_t>(it0 + row) * k + d];
          } else if (rows[row - kFTI] >= 0) {
            v = U[static_cast<size_t>(rows[row - kFTI]) * k + d];
          }
        }
        st[row * kFStr + (d - d0)] = v;
      }
    }
    if (++ls == nks) {
      ls = 0;
      ++lt;
    }
  };

  float acc[8][8], sink = 0.f;
  unsigned stats[2] = {0, 0};
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[q][j] = 0.f;

  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n_stages) load_next(q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int ct = t0, cs = 0, buf = 0;   // the stage computed: tile, k slice, ring
  for (int q = 0; q < n_stages; ++q) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();   // stage q landed; every warp is done with q - 1
    if (q + kStages - 1 < n_stages)
      load_next((buf + kStages - 1) % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* st = ring + buf * kStageFloats;
#pragma unroll
    for (int d4 = 0; d4 < kFKC; d4 += 4) {
      float4 iv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        iv[j] = *reinterpret_cast<const float4*>(st + (lane + 32 * j) * kFStr +
                                                 d4);
      if (kCut >= 1) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 uv = *reinterpret_cast<const float4*>(
              st + (kFTI + warp * 8 + u) * kFStr + d4);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[u][j] = fmaf(uv.x, iv[j].x, acc[u][j]);
            acc[u][j] = fmaf(uv.y, iv[j].y, acc[u][j]);
            acc[u][j] = fmaf(uv.z, iv[j].z, acc[u][j]);
            acc[u][j] = fmaf(uv.w, iv[j].w, acc[u][j]);
          }
        }
      }
    }
    buf = buf + 1 == kStages ? 0 : buf + 1;
    if (++cs < nks) continue;
    if (kCut < 2) {   // the probe's cuts: consume the scores, no selection
      cs = 0;
      ++ct;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sink += acc[u][j];
          acc[u][j] = 0.f;
        }
      continue;
    }

    // the tile's scores are complete: select
    const int it0 = ct * kFTI;
    cs = 0;
    ++ct;
    float ibv[8];
    unsigned inv = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int item = it0 + lane + 32 * j;
      ibv[j] = 0.f;
      if (item < n_items) {
        ibv[j] = ib[item];
        if (invalid[item]) inv |= 1u << j;
      } else {
        inv |= 1u << j;
      }
    }
    // this tile's train entries of the warp's users, as bits
    uint32_t* exw = ex + lane * kExWords + 2 * warp;
    exw[0] = 0u;
    exw[1] = 0u;
    __syncwarp();
    for (int u = 0; u < 8; ++u) {
      const int lu = warp * 8 + u;
      long long c = cur[lu];
      const long long e = end[lu];
      while (c < e) {
        const long long pos = c + lane;
        const int idx = pos < e ? indices[pos] : 0x7fffffff;
        const bool in = idx < it0 + kFTI;
        const unsigned b = __ballot_sync(kFull, in);
        if (in) {
          const int rel = idx - it0;
          atomicOr(ex + (rel & 31) * kExWords + (lu >> 2),
                   1u << ((lu & 3) * 8 + (rel >> 5)));
        }
        c += __popc(b);
        if (b != kFull) break;
      }
      __syncwarp();
      if (lane == 0) cur[lu] = c;
    }
    __syncwarp();
    const uint32_t w0 = exw[0], w1 = exw[1];
    unsigned pass_lo = 0, pass_hi = 0;   // bit 8 u + j
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned rej =
          (((u < 4 ? w0 >> (8 * u) : w1 >> (8 * (u - 4)))) & 0xffu) | inv;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = ((acc[u][j] + m) + ubv[u]) + ibv[j];
        const bool p = !(s < thr_s[u]) && !((rej >> j) & 1u);
        if (u < 4) pass_lo |= static_cast<unsigned>(p) << (8 * u + j);
        else pass_hi |= static_cast<unsigned>(p) << (8 * (u - 4) + j);
      }
    }
    if (kCut < 3) {
      sink += __popc(pass_lo | pass_hi);
    } else if (__any_sync(kFull, (pass_lo | pass_hi) != 0)) {
      const unsigned any_lo = __reduce_or_sync(kFull, pass_lo);
      const unsigned any_hi = __reduce_or_sync(kFull, pass_hi);
      if (kStats) ++stats[0];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int lu = warp * 8 + u;
        if (!((((u < 4 ? any_lo : any_hi) >> (8 * (u & 3))) & 0xffu)))
          continue;
        if (kStats) ++stats[1];
        // this lane's passing items of user u, and where they go: one
        // warp scan appends the whole tile's candidates of the user
        const unsigned bits =
            ((u < 4 ? pass_lo : pass_hi) >> (8 * (u & 3))) & 0xffu;
        int total;
        const int at = warp_scan(__popc(bits), lane, total);
        const int c = sel.cnt[lu];
        if (c + total <= cap) {
          unsigned long long* b =
              sel.buf + static_cast<size_t>(lu) * cap + c + at;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if ((bits >> j) & 1u)
              *b++ = item_key(((acc[u][j] + m) + ubv[u]) + ibv[j],
                              it0 + lane + 32 * j);
          __syncwarp();
          if (lane == 0) sel.cnt[lu] = c + total;
          __syncwarp();
        } else {
          // more than the buffer holds (the first tiles): a round of 32
          // at a time, cutting the buffer back between rounds
#pragma unroll
          for (int j = 0; j < 8; ++j)
            insert(sel, lu,
                   (bits >> j) & 1u
                       ? item_key(((acc[u][j] + m) + ubv[u]) + ibv[j],
                                  it0 + lane + 32 * j)
                       : 0ull,
                   lane);
          thr_s[u] = key_float(static_cast<uint32_t>(sel.thr[lu] >> 32));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[u][j] = 0.f;
  }

  if (kCut < 3 && sink == 1234.5f) out_s[0] = sink;   // keeps the cut alive
  if (kStats) {
    __syncthreads();
    for (int i = 0; i < 2; ++i)
      if (lane == 0) atomicAdd(out_s + i, static_cast<float>(stats[i]));
    return;
  }
  // the best n of each user, sorted: to the output, or to this slice's keys
  for (int u = 0; u < 8; ++u) {
    const int lu = warp * 8 + u;
    if (u0 + lu >= B) break;
    cut_back(sel, lu, lane);
    const unsigned long long* b = sel.buf + static_cast<size_t>(lu) * cap;
    const int c = sel.cnt[lu];
    const size_t row = static_cast<size_t>(u0 + lu);
    for (int i = lane; i < n; i += 32) {
      const unsigned long long key = i < c ? b[i] : 0ull;
      if (S > 1) {
        keys[(row * S + split) * n + i] = key;
      } else {
        out_s[row * n + i] =
            i < c ? key_float(static_cast<uint32_t>(key >> 32)) : kNegInf;
        out_i[row * n + i] =
            i < c ? static_cast<int>(0xffffffffu - static_cast<uint32_t>(key))
                  : -1;
      }
    }
  }
}

// The best n of each user's S slices' keys ([B, S, n]; 0: empty), by a
// bitonic sort of the m = pow2 >= S n keys in shared memory.
__global__ void __launch_bounds__(kFThreads)
topk_merge_kernel(const unsigned long long* __restrict__ keys, int S, int n,
                  int m, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ unsigned long long mk[];
  const size_t row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < m; i += kFThreads)
    mk[i] = i < S * n ? keys[row * S * n + i] : 0ull;
  __syncthreads();
  for (int size = 2; size <= m; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < m / 2; i += kFThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long x = mk[lo], y = mk[hi];
        if ((lo & size) == 0 ? x < y : x > y) {
          mk[lo] = y;
          mk[hi] = x;
        }
      }
      __syncthreads();
    }
  for (int i = tid; i < n; i += kFThreads) {
    const unsigned long long key = mk[i];
    const bool ok = key > thr0();
    out_s[row * n + i] =
        ok ? key_float(static_cast<uint32_t>(key >> 32)) : kNegInf;
    out_i[row * n + i] =
        ok ? static_cast<int>(0xffffffffu - static_cast<uint32_t>(key)) : -1;
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

int topk_max_n() { return kMaxN; }

// Top-n of B queried users (users [B] int64 rows of U and of the CSR) over
// n_items items, on `stream`: kernel A then kernel B. U [*, k], I [n_items,
// k], ib [n_items], ub [*], mu [1] are f32; invalid [n_items] uint8 (1 =
// excluded); indptr int64 / indices int32 are the train CSR (sorted rows,
// columns < n_items); S is [B, n_items] f32 scratch; out_s [B, n] f32 and
// out_i [B, n] int32. Returns the cudaError_t of the first launch that
// failed, else cudaSuccess.
int topk_catalog_chunk(const void* U, const void* users, const void* I,
                       const void* ib, const void* ub, const void* mu,
                       const void* invalid, const void* indptr,
                       const void* indices, void* S, void* out_s, void* out_i,
                       int B, int n_items, int k, int n, void* stream) {
  if (B <= 0 || n_items <= 0 || k <= 0 || n <= 0 || n > kMaxN)
    return cudaErrorInvalidValue;
  if ((B + kTU - 1) / kTU > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_items + kTI - 1) / kTI, (B + kTU - 1) / kTU);
  score_kernel<<<grid, kScoreThreads, 0, s>>>(
      static_cast<const float*>(U), static_cast<const long long*>(users),
      static_cast<const float*>(I), static_cast<const float*>(ib),
      static_cast<const float*>(ub), static_cast<const float*>(mu),
      static_cast<const uint8_t*>(invalid), static_cast<float*>(S), B,
      n_items, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncap = pow2_at_least(n);
  select_kernel<<<B, kSelThreads, ncap * sizeof(unsigned long long), s>>>(
      static_cast<float*>(S), static_cast<const long long*>(users),
      static_cast<const long long*>(indptr), static_cast<const int*>(indices),
      n_items, n, ncap, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// Dynamic shared memory of the fused kernel whose users each keep cap
// candidate keys.
size_t topk_fused_smem(int cap) { return fused_smem(cap).total; }

// CTAs of the fused kernel with cap keys a user that the card holds at
// once (all SMs); a negative cudaError_t on failure.
int topk_fused_resident(int cap) {
  const size_t smem = fused_smem(cap).total;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      topk_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, topk_fused_kernel, kFThreads, smem);
  return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

// Top-n (n <= topk_fused_max_n()) of B queried users over n_items items on
// `stream`, the fused route: the score-and-select kernel on a grid of
// (ceil(B / 64), splits) CTAs, then, with splits > 1, the merge kernel.
// Inputs as topk_catalog_chunk; cap: each user's candidate keys (a power of
// 2 >= n + 32, at least 64, at most 256); keys: [B, splits, n] uint64
// scratch (splits > 1, else null); splits <= the catalog's 256-item tiles
// and splits * n <= 4096. Returns the cudaError_t of the first launch that
// failed, else cudaSuccess.
int topk_fused(const void* U, const void* users, const void* I, const void* ib,
               const void* ub, const void* mu, const void* invalid,
               const void* indptr, const void* indices, void* keys,
               void* out_s, void* out_i, int B, int n_items, int k, int n,
               int cap, int splits, void* stream) {
  const int n_tiles = (n_items + kFTI - 1) / kFTI;
  if (B <= 0 || n_items <= 0 || k <= 0 || n <= 0 || n > kFusedMaxN ||
      cap < 64 || cap > 256 || (cap & (cap - 1)) || cap < n + 32 ||
      splits < 1 || splits > n_tiles || splits * n > kMaxMerge ||
      (splits > 1) != (keys != nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = fused_smem(cap).total;
  cudaError_t err = cudaFuncSetAttribute(
      topk_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 16-byte copies of factor rows
  const uintptr_t align = reinterpret_cast<uintptr_t>(U) |
                          reinterpret_cast<uintptr_t>(I);
  const int vec = k % 4 == 0 && (align & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_fused_kernel<<<dim3((B + kFTU - 1) / kFTU, splits), kFThreads, smem,
                      s>>>(
      static_cast<const float*>(U), static_cast<const long long*>(users),
      static_cast<const float*>(I), static_cast<const float*>(ib),
      static_cast<const float*>(ub), static_cast<const float*>(mu),
      static_cast<const uint8_t*>(invalid),
      static_cast<const long long*>(indptr), static_cast<const int*>(indices),
      B, n_items, k, n, cap, vec, static_cast<unsigned long long*>(keys),
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int m = pow2_at_least(splits * n);
  topk_merge_kernel<<<B, kFThreads, m * sizeof(unsigned long long), s>>>(
      static_cast<const unsigned long long*>(keys), splits, n, m,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return cudaGetLastError();
}

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
