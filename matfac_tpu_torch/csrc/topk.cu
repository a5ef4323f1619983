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
//     memory, 16 floats for 64 FMAs each 4 steps of d (4 FMAs a float
//     loaded). Item and user rows arrive by
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
// chunk of B users with two kernels on one stream, through a [B, n_items]
// f32 score scratch that each score is written to once and read from once:
//   A. radix_score_kernel: the fused route's sweep (the same 8 x 8 register
//      tile, float4 operands, 3-stage cp.async ring and cursor exclusion,
//      so a user's scores are bitwise the fused route's), its epilogue
//      writing each tile's scores, -3e38 where the item is invalid or in
//      the user's train row. The catalog is cut into slices (grid.y) so
//      the user tiles x slices fill the card several times over. Bound by
//      the sweep's FMA tile, as the fused route (scripts/
//      torch_topk_probe.py).
//   B. radix_select_kernel: one 512-thread block per user. It reads the
//      row once, into shared memory as order-preserving uint32 keys where
//      n_items x 4 B fits beside the histograms (20,000 items: 80 KB, two
//      blocks an SM; a wider catalog streams the row from device memory
//      on each pass), and finds the row's scorable count and key range.
//      Every scorable key at or above a bound is a candidate; the bound
//      starts below every key and rises by 8-bit radix passes whose first
//      digit starts at the highest bit where the row's scorable keys
//      differ (a trained model's scores share their sign and exponent, so
//      a fixed first digit would put them in one or two bins), each pass
//      a histogram of the keys still at the bound's prefix (a histogram a
//      warp: no two warps' increments meet on one word) and a block scan
//      of its bins from the top (no thread walks them alone), until the
//      candidates fit in the sort buffer (ncap = a power of 2 >= n) —
//      one or two passes at 20,000 items. Then one gather of the
//      candidates (a warp places 128 keys' takers with one atomic), a
//      bitonic sort of the 64-bit (key, ~id) words (score desc, id asc;
//      strides below 32 in registers by shuffle) and the first n out.
//      Where more keys tie at the n-th score than the buffer holds, the
//      ties are taken in id order by a scan of per-warp id segments. The
//      sort is the select stage's largest step (scripts/
//      torch_topk_probe.py's kSelCut / kSelSort variants).
// What bounds it on this card: a full pass at 100k users x 20k items, k=64,
// is 2.6e11 FLOP of scores (3.9 ms at the 67 TFLOP/s f32 CUDA-core peak)
// and 8 GB of scores written once and read once (2.4 ms each way at 3.35
// TB/s). The route serves n above the fused route's limit (ARHR at
// n = 1000). The TPU kernel's n passes of max-extraction and its
// [n_tiles, BU, c_max] rated-in-tile lists were VMEM devices; the radix
// bound costs the same for n = 1 and n = 4096 (kMaxN).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kMaxN = 4096;      // candidates sorted in shared memory

__device__ __forceinline__ uint32_t ord_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---------------------------------------------------------------------
// the sweep: the fused route, and the radix route's score stage
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
constexpr int kScoreWaves = 8;    // the radix score grid, in card-fulls
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

// The sweep of a CTA's user tile over its catalog slice. SCORES (the radix
// route's score stage): each tile's scores go to out_s [B, n_items] (-3e38
// where the item is invalid or excluded, -0 as +0) and nothing is
// selected; n, cap, keys and out_i are unused.
template <bool SCORES>
__device__ __forceinline__ void sweep(
    const float* __restrict__ U, const long long* __restrict__ users,
    const float* __restrict__ I, const float* __restrict__ ib,
    const float* __restrict__ ub, const float* __restrict__ mu,
    const uint8_t* __restrict__ invalid, const long long* __restrict__ indptr,
    const int* __restrict__ indices, int B, int n_items, int k, int n,
    int cap, int vec, unsigned long long* __restrict__ keys,
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
      if (SCORES || kCut >= 1) {
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
    if (!SCORES && kCut < 2) {   // the probe's cuts: no selection
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
    if (SCORES) {
      // the tile's scores, once: a warp's lanes store 128 B of a row each
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int lu = warp * 8 + u;
        if (rows[lu] < 0) continue;
        const unsigned rej =
            (((u < 4 ? w0 >> (8 * u) : w1 >> (8 * (u - 4)))) & 0xffu) | inv;
        float* srow = out_s + static_cast<size_t>(u0 + lu) * n_items;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int item = it0 + lane + 32 * j;
          if (item >= n_items) continue;
          float s = ((acc[u][j] + m) + ubv[u]) + ibv[j];
          if ((rej >> j) & 1u) s = kNegInf;
          if (s == 0.f) s = 0.f;  // -0 and +0 are one score: one key
          srow[item] = s;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[u][j] = 0.f;
      continue;
    }
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

  if (SCORES) return;
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
  sweep<false>(U, users, I, ib, ub, mu, invalid, indptr, indices, B, n_items,
               k, n, cap, vec, keys, out_s, out_i);
}

// A. The radix route's score stage: S [B, n_items], each score once.
__global__ void __launch_bounds__(kFThreads, kFusedCtas)
radix_score_kernel(const float* __restrict__ U,
                   const long long* __restrict__ users,
                   const float* __restrict__ I, const float* __restrict__ ib,
                   const float* __restrict__ ub, const float* __restrict__ mu,
                   const uint8_t* __restrict__ invalid,
                   const long long* __restrict__ indptr,
                   const int* __restrict__ indices, int B, int n_items, int k,
                   int vec, float* __restrict__ S) {
  sweep<true>(U, users, I, ib, ub, mu, invalid, indptr, indices, B, n_items,
              k, 0, 0, vec, nullptr, S, nullptr);
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

// ---------------------------------------------------------------------
// the radix route's select stage
// ---------------------------------------------------------------------

constexpr int kSelThreads = 512;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kBins = 256;             // an 8-bit digit
// dynamic shared memory a select block may have beside its static words
constexpr size_t kSelSmem = 232448 - 1024;
// the select stage cut after a step, for scripts/torch_topk_probe.py: 0
// the row's read, 1 + the radix passes, 2 + the gather, 3 the kernel
constexpr int kSelCut = 3;
// 0: the probe's select kernel without its sort (the candidates out in
// the order gathered)
constexpr int kSelSort = 1;
static_assert(kBins <= kSelThreads, "a thread a bin in the scan");

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Bytes of the histograms (a [kBins] array a warp) or, after the passes,
// the ncap candidate keys (at least 32): one region.
__host__ __device__ constexpr size_t sel_work(int ncap) {
  return static_cast<size_t>(kSelWarps) * kBins * 4 >
                 8 * static_cast<size_t>(ncap > 32 ? ncap : 32)
             ? static_cast<size_t>(kSelWarps) * kBins * 4
             : 8 * static_cast<size_t>(ncap > 32 ? ncap : 32);
}

// Dynamic shared memory of a select block: the row's keys (RES), then the
// work region.
__host__ __device__ constexpr size_t sel_smem(int n_items, int ncap,
                                              bool res) {
  return (res ? align16(static_cast<size_t>(n_items) * 4) : 0) +
         sel_work(ncap);
}

__device__ __forceinline__ unsigned long long cand_key(uint32_t key, int i) {
  return (static_cast<unsigned long long>(key) << 32) |
         (0xffffffffu - static_cast<uint32_t>(i));
}

// B. The best n scorable scores of row blockIdx.x of S [B, n_items] (-3e38
// and below: not scorable), descending, equal scores by id; ncap = a power
// of 2 >= n. RES: the row's keys stay in shared memory after one read,
// else each pass reads the row again.
template <bool RES>
__global__ void __launch_bounds__(kSelThreads)
radix_select_kernel(const float* __restrict__ S, int n_items, int n,
                    int ncap, float* __restrict__ out_s,
                    int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);   // [n_items] (RES)
  unsigned char* work =
      smem + (RES ? align16(static_cast<size_t>(n_items) * 4) : 0);
  uint32_t* hist = reinterpret_cast<uint32_t*>(work);   // [warps][kBins]
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(work);      // [ncap], after
  __shared__ uint32_t s_red[3][kSelWarps];
  __shared__ uint32_t s_scan[kBins / 32];
  __shared__ uint32_t s_eq[kSelWarps];
  __shared__ uint32_t s_bin, s_above, s_cnt, s_app;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* Srow = S + row * n_items;
  const uint32_t masked = ord_key(kNegInf);
  auto key_at = [&](int i) -> uint32_t {
    return RES ? keys[i] : ord_key(__ldcs(Srow + i));
  };

  // 1. the row, read once: its scorable count m and key range [lo, hi]
  uint32_t m = 0, lo = 0xffffffffu, hi = 0;
  auto see = [&](uint32_t key) {
    if (key > masked) {
      ++m;
      lo = min(lo, key);
      hi = max(hi, key);
    }
  };
  if ((n_items & 3) == 0 && (reinterpret_cast<uintptr_t>(S) & 15) == 0) {
    const float4* S4 = reinterpret_cast<const float4*>(Srow);
    const int n4 = n_items / 4;
    for (int i = tid; i < n4; i += 4 * kSelThreads) {
      float4 v[4];   // four 16-byte loads in flight a thread
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i + r * kSelThreads < n4) v[r] = __ldcs(S4 + i + r * kSelThreads);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = i + r * kSelThreads;
        if (j >= n4) break;
        const uint4 q = make_uint4(ord_key(v[r].x), ord_key(v[r].y),
                                   ord_key(v[r].z), ord_key(v[r].w));
        if (RES) reinterpret_cast<uint4*>(keys)[j] = q;
        see(q.x), see(q.y), see(q.z), see(q.w);
      }
    }
  } else {
    for (int i = tid; i < n_items; i += kSelThreads) {
      const uint32_t key = ord_key(__ldcs(Srow + i));
      if (RES) keys[i] = key;
      see(key);
    }
  }
  m = __reduce_add_sync(kFull, m);
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    s_red[0][warp] = m;
    s_red[1][warp] = lo;
    s_red[2][warp] = hi;
  }
  if (tid == 0) s_app = 0;
  __syncthreads();
  m = 0, lo = 0xffffffffu, hi = 0;
  for (int w = 0; w < kSelWarps; ++w) {
    m += s_red[0][w];
    lo = min(lo, s_red[1][w]);
    hi = max(hi, s_red[2][w]);
  }
  const uint32_t target = min(static_cast<uint32_t>(n), m);
  if (kSelCut == 0) {   // the probe's cuts keep their work alive
    if (tid == 0) out_s[row * n] = static_cast<float>(m ^ lo ^ hi);
    return;
  }

  // 2. the bound: every scorable key >= lower is a candidate (at first all
  // m of them). While they would not fit in ncap, a radix pass raises it.
  // cut: more keys tie at the n-th key `tie` than fit; c_gt keys above it
  // and need_eq of the ties, in id order, are the result.
  uint32_t lower = masked + 1, tie = 0, c_gt = 0, need_eq = 0;
  bool cut = false;
  if (m > static_cast<uint32_t>(ncap)) {
    if (lo == hi) {
      cut = true;
      tie = lo;
      need_eq = target;
    } else {
      // the first digit's top bit: the highest where the keys differ;
      // every scorable key shares the bits above it (prefix under mask)
      int top = 31 - __clz(lo ^ hi);
      uint32_t mask = top == 31 ? 0u : ~((2u << top) - 1u);
      uint32_t prefix = hi & mask, rem = target;
      uint32_t* wh = hist + warp * kBins;
      for (;;) {
        const int shift = max(top - 7, 0);
        const uint32_t dmask = (2u << (top - shift)) - 1u;
        for (int b = lane; b < kBins; b += 32) wh[b] = 0;
        __syncwarp();
#pragma unroll 4
        for (int i = tid; i < n_items; i += kSelThreads) {
          const uint32_t key = key_at(i);
          if (key > masked && (key & mask) == prefix)
            atomicAdd(wh + ((key >> shift) & dmask), 1u);
        }
        __syncthreads();
        // thread t takes bin kBins - 1 - t: an inclusive scan over t
        // counts the keys at or above each bin
        uint32_t c = 0, incl = 0;
        if (tid < kBins) {
          const int b = kBins - 1 - tid;
          for (int w = 0; w < kSelWarps; ++w) c += hist[w * kBins + b];
          incl = c;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const uint32_t x = __shfl_up_sync(kFull, incl, off);
            if (lane >= off) incl += x;
          }
          if (lane == 31) s_scan[warp] = incl;
        }
        __syncthreads();
        if (tid < kBins) {
          for (int w = 0; w < warp; ++w) incl += s_scan[w];
          const uint32_t above = incl - c;
          if (c > 0 && above < rem && rem <= incl) {
            s_bin = kBins - 1 - tid;
            s_above = above;
            s_cnt = c;
          }
        }
        __syncthreads();
        c_gt += s_above;
        rem -= s_above;
        prefix |= s_bin << shift;
        mask |= dmask << shift;
        if (c_gt + s_cnt <= static_cast<uint32_t>(ncap)) {
          lower = prefix;
          break;
        }
        if (shift == 0) {
          cut = true;
          tie = prefix;
          need_eq = rem;
          break;
        }
        top = shift - 1;
      }
    }
  }

  if (kSelCut == 1) {
    if (tid == 0) out_s[row * n] = static_cast<float>(lower ^ tie ^ c_gt);
    return;
  }

  // 3. the candidates into the work region (the histograms are done): a
  // warp takes 4 x 32 keys a step and places its takers with one atomic;
  // every scorable key >= lower, or (cut) every key above the tie
  const unsigned below = (1u << lane) - 1u;
  for (int base = warp * 128; base < n_items; base += 4 * kSelThreads) {
    uint32_t key[4];
    unsigned b[4];
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = base + 32 * r + lane;
      key[r] = i < n_items ? key_at(i) : 0u;
      b[r] = __ballot_sync(kFull, key[r] > masked &&
                                      (cut ? key[r] > tie : key[r] >= lower));
      cnt += __popc(b[r]);
    }
    if (cnt == 0) continue;
    uint32_t at = 0;
    if (lane == 0) at = atomicAdd(&s_app, static_cast<uint32_t>(cnt));
    at = __shfl_sync(kFull, at, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if ((b[r] >> lane) & 1u)
        cand[at + __popc(b[r] & below)] = cand_key(key[r], base + 32 * r +
                                                              lane);
      at += __popc(b[r]);
    }
  }
  if (cut && need_eq > 0) {
    // the first need_eq ties by id: each warp counts its id segment's,
    // then writes its own from the ties of the warps before it on
    const int seg =
        ((n_items + kSelWarps - 1) / kSelWarps + 31) / 32 * 32;
    const int i0 = warp * seg, i1 = min(i0 + seg, n_items);
    uint32_t cnt = 0;
    for (int base = i0; base < i1; base += 32) {
      const int i = base + lane;
      cnt += __popc(__ballot_sync(kFull, i < i1 && key_at(i) == tie));
    }
    if (lane == 0) s_eq[warp] = cnt;
    __syncthreads();
    uint32_t before = s_app;   // the c_gt keys above the tie come first
    for (int w = 0; w < warp; ++w) before += s_eq[w];
    const uint32_t end = s_app + need_eq;
    for (int base = i0; base < i1 && before < end; base += 32) {
      const int i = base + lane;
      const bool eq = i < i1 && key_at(i) == tie;
      const unsigned b = __ballot_sync(kFull, eq);
      const uint32_t at = before + __popc(b & ((1u << lane) - 1u));
      if (eq && at < end) cand[at] = cand_key(tie, i);
      before += __popc(b);
    }
  }
  __syncthreads();

  // 4. sort the candidates (a power of 2 of them, at least 32, zero-
  // padded) descending on (key, ~id): score desc, then id asc; the first n
  // out. A bitonic network: strides of 32 and up on pairs in shared
  // memory, each followed by a block barrier; the strides below 32 of each
  // size in registers, a warp on each 32 consecutive keys, partners by
  // shuffle (21 barriers for 1,024 keys, not 55).
  const int total =
      static_cast<int>(cut ? s_app + need_eq : s_app);   // <= ncap
  if (kSelCut == 2) {
    if (tid == 0) out_s[row * n] = static_cast<float>(total);
    return;
  }
  int p = 32;
  while (p < total) p <<= 1;
  for (int i = total + tid; i < p; i += kSelThreads) cand[i] = 0ull;
  __syncthreads();
  // sizes up to `size` at strides below 32, in registers
  auto warp_stages = [&](int size) {
    for (int seg = warp; seg < p / 32; seg += kSelWarps) {
      const int i = seg * 32 + lane;
      unsigned long long x = cand[i];
      for (int sz = size > 32 ? size : 2; sz <= size; sz <<= 1)
        for (int st = min(sz, 32) >> 1; st > 0; st >>= 1) {
          const unsigned long long y = __shfl_xor_sync(kFull, x, st);
          const bool keep_max = ((lane & st) == 0) == ((i & sz) == 0);
          x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
        }
      cand[i] = x;
    }
    __syncthreads();
  };
  if (kSelSort) warp_stages(32);
  for (int size = 64; kSelSort && size <= p; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      for (int i = tid; i < p / 2; i += kSelThreads) {
        const int a = 2 * i - (i & (stride - 1)), b = a + stride;
        const unsigned long long x = cand[a], y = cand[b];
        if ((a & size) == 0 ? x < y : x > y) {
          cand[a] = y;
          cand[b] = x;
        }
      }
      __syncthreads();
    }
    warp_stages(size);
  }
  for (int i = tid; i < n; i += kSelThreads) {
    float sc = kNegInf;
    int id = -1;
    if (static_cast<uint32_t>(i) < target) {
      const unsigned long long c = cand[i];
      sc = key_float(static_cast<uint32_t>(c >> 32));
      id = static_cast<int>(0xffffffffu - static_cast<uint32_t>(c));
    }
    out_s[row * n + i] = sc;
    out_i[row * n + i] = id;
  }
}

// The radix kernels' attributes: their shared-memory caps (a launch asks
// for its own bytes below them) and, for the select kernel, the whole
// carveout as shared memory, so two resident blocks of 96 KB fit an SM;
// with the card's SMs and the score kernel's resident CTAs.
struct RadixSetup {
  int sms = 0, score_per_sm = 0;
};
cudaError_t radix_setup(RadixSetup& su) {
  const size_t ring = fused_smem(0).total;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(radix_score_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ring));
  for (auto select : {radix_select_kernel<true>, radix_select_kernel<false>}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(select,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSelSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          select, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&su.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &su.score_per_sm, radix_score_kernel, kFThreads, ring);
  return err;
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

int topk_radix_scores(const void* U, const void* users, const void* I,
                      const void* ib, const void* ub, const void* mu,
                      const void* invalid, const void* indptr,
                      const void* indices, void* S, int B, int n_items, int k,
                      void* stream);

int topk_max_n() { return kMaxN; }

// Top-n of B queried users (users [B] int64 rows of U and of the CSR) over
// n_items items, on `stream`: the score kernel then the select kernel. U
// [*, k], I [n_items, k], ib [n_items], ub [*], mu [1] are f32; invalid
// [n_items] uint8 (1 = excluded); indptr int64 / indices int32 are the
// train CSR (sorted rows, columns < n_items); S is [B, n_items] f32
// scratch; out_s [B, n] f32 and out_i [B, n] int32. Returns the
// cudaError_t of the first launch that failed, else cudaSuccess.
int topk_catalog_chunk(const void* U, const void* users, const void* I,
                       const void* ib, const void* ub, const void* mu,
                       const void* invalid, const void* indptr,
                       const void* indices, void* S, void* out_s, void* out_i,
                       int B, int n_items, int k, int n, void* stream) {
  if (n <= 0 || n > kMaxN) return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(
      topk_radix_scores(U, users, I, ib, ub, mu, invalid, indptr, indices, S,
                        B, n_items, k, stream));
  if (err != cudaSuccess) return err;
  // B: a block a user, its row kept in shared memory where it fits
  const int ncap = pow2_at_least(n);
  const bool res = sel_smem(n_items, ncap, true) <= kSelSmem;
  const size_t smem = sel_smem(n_items, ncap, res);
  auto select = res ? radix_select_kernel<true> : radix_select_kernel<false>;
  select<<<B, kSelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), n_items, n, ncap,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// The radix route's score stage alone: S [B, n_items] f32, each score of
// the B users once (-3e38 where not scorable); inputs as
// topk_catalog_chunk. One launch.
int topk_radix_scores(const void* U, const void* users, const void* I,
                      const void* ib, const void* ub, const void* mu,
                      const void* invalid, const void* indptr,
                      const void* indices, void* S, int B, int n_items, int k,
                      void* stream) {
  if (B <= 0 || n_items <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the user tiles x catalog slices, kScoreWaves times the CTAs the card
  // holds at once (at most a slice a 256-item tile)
  RadixSetup su;
  const cudaError_t err = radix_setup(su);
  if (err != cudaSuccess) return err;
  const size_t ring = fused_smem(0).total;
  const long long user_tiles = (B + kFTU - 1) / kFTU;
  const long long n_tiles = (n_items + kFTI - 1) / kFTI;
  const long long want =
      (kScoreWaves * su.sms * std::max(su.score_per_sm, 1) + user_tiles -
       1) / user_tiles;
  const int slices = static_cast<int>(
      std::max(1LL, std::min({want, n_tiles, 65535LL})));
  const uintptr_t align = reinterpret_cast<uintptr_t>(U) |
                          reinterpret_cast<uintptr_t>(I);
  const int vec = k % 4 == 0 && (align & 15) == 0;
  radix_score_kernel<<<dim3(static_cast<unsigned>(user_tiles), slices),
                       kFThreads, ring, s>>>(
      static_cast<const float*>(U), static_cast<const long long*>(users),
      static_cast<const float*>(I), static_cast<const float*>(ib),
      static_cast<const float*>(ub), static_cast<const float*>(mu),
      static_cast<const uint8_t*>(invalid),
      static_cast<const long long*>(indptr), static_cast<const int*>(indices),
      B, n_items, k, vec, static_cast<float*>(S));
  return cudaGetLastError();
}

// The widest catalog whose rows the select kernel keeps in shared memory
// at this n (wider ones stream the row from device memory on each pass).
int topk_radix_resident_items(int n) {
  const int ncap = pow2_at_least(n);
  return static_cast<int>((kSelSmem - sel_work(ncap)) / 4);
}

// Select blocks an SM holds at once for a catalog of n_items at this n; a
// negative cudaError_t on failure.
int topk_radix_select_per_sm(int n_items, int n) {
  const int ncap = pow2_at_least(n);
  const bool res = sel_smem(n_items, ncap, true) <= kSelSmem;
  const size_t smem = sel_smem(n_items, ncap, res);
  auto select = res ? radix_select_kernel<true> : radix_select_kernel<false>;
  int per_sm = 0;
  RadixSetup su;
  cudaError_t err = radix_setup(su);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select,
                                                        kSelThreads, smem);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
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
