// Full-catalog top-N for a set of queried users on Hopper (sm_90a), CUDA C++
// on the CUDA cores.
//
// Replaces the Pallas TPU kernel matfac_tpu/ops/topk_kernel.py:topk_tiles.
// For each queried user u and every catalog item i:
//   score = ((<U[u], I[i]> + mu) + ub[u]) + ib[i]     (the XLA scorer's order,
//                                                     eval/ranking.py:82-84)
// invalid items and the items of u's train row are set to -3e38, and the
// result is the n best scorable items, descending, equal scores going to the
// smallest item id; slots with no scorable item carry id -1 and -3e38.
//
// One call handles a chunk of B users with two kernels on one stream:
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
// passes). Both are of the same order, so the design keeps kernel B's work
// per score to one load and one compare per pass, and leaves a fused
// tensor-core score tile with an in-register threshold filter to later PRs.
// Equal scores are kept apart by item id alone, so ties are exact whatever
// the summation order of kernel A.

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

const char* topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
