// Row-stripe dense SGD step on Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the two Pallas TPU kernels of matfac_tpu/ops/dense_row_kernel.py:
//   * dense_rows_epoch_pallas (float R + W tiles)   -> RT = float / bf16, W int8
//   * dense_rows_codes_pallas (int8 rating codes)   -> RT = int8 codes, no W
// Both compute ops/dense_block_kernel.cell_dense_update on one full-catalog
// user stripe (U [bu,k], I [ni_pad,k], tiles [bu,ni_pad]):
//   P = U I^T,  E = W (R - P)      (codes: R = code*r_scale, W = code != 0)
//   I <- I - lr * norm(-2 E^T U_old + 2 i_reg cnt_i I_old)
//   U <- U - lr * norm(-2 E I_old   + 2 u_reg cnt_u U_old)
// with counts from validity (W > 0 / code != 0), never from the weights,
// and norm = division by max(cnt, 1) when collision_norm is set.
//
// One stripe per call; the caller walks the stripes in the epoch's order on
// one stream, which sequences them (the SGD semantics of README deviation
// #1). Each call launches two kernels:
//   A. stripe_panel_kernel, one block per 64-item panel. The block holds its
//      panel's OLD item rows in shared memory, walks the stripe's users in
//      chunks of 32, forms P and E for the chunk, accumulates the panel's
//      item gradient E^T U and item counts, and writes a per-panel partial
//      of the user gradient E I_old and of the user counts to scratch
//      ([NP, bu, k] and [NP, bu]). At the end it writes its own item rows.
//      No other block reads or writes those rows, so "items step from the
//      old U, users from the old I" holds without atomics.
//   B. stripe_user_kernel sums the NP partials per user (a deterministic
//      split reduction, no atomics) and steps the stripe's U rows.
// mm_bf16 rounds every matmul operand (U, I, E) to bf16 with
// __float2bfloat16_rn and accumulates in f32, as the plain PyTorch version
// emulates; the regularization terms use the unrounded f32 values.
//
// What bounds it on the card: an epoch does 6k FLOP per dense slot (three
// products of the stripe), about 8e11 FLOP at 100k x 20k, k = 64. That is
// compute, not the tile read (1-6 bytes per slot, computed from the
// shapes: about 2-12 GB per epoch there). This first version runs
// the three products as plain f32 FMAs out of shared memory with little
// register blocking, so it is bound by shared-memory loads (about two per
// FMA in the item-gradient and user-gradient products). wgmma / mma.sync on
// bf16 operands, TMA loads of the tiles and a persistent grid are left to
// later, tensor-core versions.
//
// Offsets into the tiles are size_t: NU * bu * ni_pad exceeds 2^31 at the
// ML-20M shape (54 * 2560 * 27008 = 3.7e9).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 64;    // items per block of kernel A
constexpr int kChunk = 32;    // users per chunk inside a block
constexpr int kThreads = 256;
constexpr int kUserGroups = kThreads / kPanel;      // 4
constexpr int kUsersPerThread = kChunk / kUserGroups;  // 8
constexpr size_t kMaxSmem = 232448;  // per-block opt-in limit on H100
static_assert(kThreads % kPanel == 0, "P mapping needs whole user groups");
static_assert(kChunk % kUserGroups == 0, "P mapping needs whole users");

enum RType { kRF32 = 0, kRBF16 = 1, kRCodes = 2 };

inline int n_panels_of(int ni_pad) { return (ni_pad + kPanel - 1) / kPanel; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// A matmul operand: bf16-rounded (kept in f32 registers) when MMBF16.
template <bool MMBF16>
__device__ __forceinline__ float mm_operand(float x) {
  if (MMBF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Shared-memory floats of kernel A. The matmul copy of the item panel is
// needed only when it differs from the f32 one (mm_bf16).
__host__ __device__ inline size_t panel_smem_floats(int k, bool mm_bf16) {
  const size_t ks = static_cast<size_t>(k) + 1;
  return (mm_bf16 ? 2 : 1) * kPanel * ks      // Is (+ Im)
         + static_cast<size_t>(kChunk) * k    // Us
         + kChunk * (kPanel + 1)              // Es
         + kChunk * kPanel                    // Vs
         + static_cast<size_t>(kPanel) * k    // Gi
         + kPanel;                            // Ci
}

template <typename RT, bool CODES, bool MMBF16>
__global__ void __launch_bounds__(kThreads)
stripe_panel_kernel(const float* __restrict__ U,     // [bu, k], old
                    float* __restrict__ I,           // [ni_pad, k]
                    const RT* __restrict__ R,        // [bu, ni_pad]
                    const int8_t* __restrict__ W,    // [bu, ni_pad] / null
                    float* __restrict__ part,        // [NP, bu, k]
                    float* __restrict__ cntp,        // [NP, bu]
                    int bu, int ni_pad, int k, float lr, float r_scale,
                    float i_reg, int collision_norm) {
  extern __shared__ float smem[];
  const int ks = k + 1;  // padded stride: item rows hit distinct banks
  float* Is = smem;                                   // [kPanel][ks]
  float* Im = MMBF16 ? Is + kPanel * ks : Is;         // [kPanel][ks]
  float* Us = Im + kPanel * ks;                       // [kChunk][k]
  float* Es = Us + kChunk * k;                        // [kChunk][kPanel+1]
  float* Vs = Es + kChunk * (kPanel + 1);             // [kChunk][kPanel]
  float* Gi = Vs + kChunk * kPanel;                   // [kPanel][k]
  float* Ci = Gi + kPanel * k;                        // [kPanel]

  const int tid = threadIdx.x;
  const int j = blockIdx.x;
  const int p0 = j * kPanel;
  const int np_here = min(kPanel, ni_pad - p0);  // ragged last panel

  for (int idx = tid; idx < kPanel * k; idx += kThreads) {
    const int p = idx / k, d = idx % k;
    const float v =
        p < np_here ? I[static_cast<size_t>(p0 + p) * k + d] : 0.f;
    Is[p * ks + d] = v;
    if (MMBF16) Im[p * ks + d] = mm_operand<true>(v);
    Gi[idx] = 0.f;
  }
  for (int p = tid; p < kPanel; p += kThreads) Ci[p] = 0.f;
  __syncthreads();

  for (int u0 = 0; u0 < bu; u0 += kChunk) {
    const int nu_here = min(kChunk, bu - u0);
    for (int idx = tid; idx < kChunk * k; idx += kThreads) {
      const int u = idx / k, d = idx % k;
      Us[idx] = u < nu_here
                    ? mm_operand<MMBF16>(U[static_cast<size_t>(u0 + u) * k + d])
                    : 0.f;
    }
    // ratings go to Es (overwritten by the residual below), weights to Vs
    for (int idx = tid; idx < kChunk * kPanel; idx += kThreads) {
      const int u = idx / kPanel, p = idx % kPanel;
      float r = 0.f, w = 0.f;
      if (u < nu_here && p < np_here) {
        const size_t off = static_cast<size_t>(u0 + u) * ni_pad + p0 + p;
        const float rv = to_f32(R[off]);
        if (CODES) {
          w = rv != 0.f ? 1.f : 0.f;
          r = rv * r_scale;
        } else {
          w = to_f32(W[off]);
          r = rv;
        }
      }
      Es[u * (kPanel + 1) + p] = r;
      Vs[u * kPanel + p] = w;
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
        const float e = Vs[u * kPanel + p] * (Es[u * (kPanel + 1) + p] - acc[q]);
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
    for (int p = tid; p < kPanel; p += kThreads) {
      float c = 0.f;
      for (int u = 0; u < kChunk; ++u) c += Vs[u * kPanel + p] > 0.f ? 1.f : 0.f;
      Ci[p] += c;
    }
    // this panel's partial of the user gradient and counts
    for (int idx = tid; idx < nu_here * k; idx += kThreads) {
      const int u = idx / k, d = idx % k;
      float acc = 0.f;
      for (int p = 0; p < kPanel; ++p)
        acc += Es[u * (kPanel + 1) + p] * Im[p * ks + d];
      part[(static_cast<size_t>(j) * bu + u0 + u) * k + d] = acc;
    }
    for (int u = tid; u < nu_here; u += kThreads) {
      float c = 0.f;
      for (int p = 0; p < kPanel; ++p) c += Vs[u * kPanel + p] > 0.f ? 1.f : 0.f;
      cntp[static_cast<size_t>(j) * bu + u0 + u] = c;
    }
    __syncthreads();
  }

  // item step from the old U (every chunk above read the old U rows)
  for (int idx = tid; idx < np_here * k; idx += kThreads) {
    const int p = idx / k, d = idx % k;
    const float c = Ci[p];
    const float iv = Is[p * ks + d];
    float g = -2.f * Gi[idx] + (2.f * i_reg) * c * iv;
    if (collision_norm) g = g / fmaxf(c, 1.f);
    I[static_cast<size_t>(p0 + p) * k + d] = iv - lr * g;
  }
}

__global__ void __launch_bounds__(kThreads)
stripe_user_kernel(float* __restrict__ U, const float* __restrict__ part,
                   const float* __restrict__ cntp, int n_panels, int bu, int k,
                   float lr, float u_reg, int collision_norm) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t n = static_cast<size_t>(bu) * k;
  if (idx >= n) return;
  const int u = static_cast<int>(idx / k);
  float acc = 0.f, c = 0.f;
  for (int j = 0; j < n_panels; ++j) {
    acc += part[static_cast<size_t>(j) * n + idx];
    c += cntp[static_cast<size_t>(j) * bu + u];
  }
  const float uv = U[idx];
  float g = -2.f * acc + (2.f * u_reg) * c * uv;
  if (collision_norm) g = g / fmaxf(c, 1.f);
  U[idx] = uv - lr * g;
}

template <typename RT, bool CODES, bool MMBF16>
cudaError_t launch_panels(float* U, float* I, const void* R, const int8_t* W,
                          float* part, float* cntp, int bu, int ni_pad, int k,
                          float lr, float r_scale, float i_reg,
                          int collision_norm, cudaStream_t stream) {
  auto kernel = stripe_panel_kernel<RT, CODES, MMBF16>;
  const size_t bytes = panel_smem_floats(k, MMBF16) * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<n_panels_of(ni_pad), kThreads, bytes, stream>>>(
      U, I, static_cast<const RT*>(R), W, part, cntp, bu, ni_pad, k, lr,
      r_scale, i_reg, collision_norm);
  return cudaGetLastError();
}

template <bool MMBF16>
cudaError_t dispatch_rtype(int rtype, float* U, float* I, const void* R,
                           const int8_t* W, float* part, float* cntp, int bu,
                           int ni_pad, int k, float lr, float r_scale,
                           float i_reg, int collision_norm,
                           cudaStream_t stream) {
  switch (rtype) {
    case kRF32:
      return launch_panels<float, false, MMBF16>(
          U, I, R, W, part, cntp, bu, ni_pad, k, lr, r_scale, i_reg,
          collision_norm, stream);
    case kRBF16:
      return launch_panels<__nv_bfloat16, false, MMBF16>(
          U, I, R, W, part, cntp, bu, ni_pad, k, lr, r_scale, i_reg,
          collision_norm, stream);
    case kRCodes:
      return launch_panels<int8_t, true, MMBF16>(
          U, I, R, W, part, cntp, bu, ni_pad, k, lr, r_scale, i_reg,
          collision_norm, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t rtype_bytes(int rtype) { return rtype == kRF32 ? 4 : rtype == kRBF16 ? 2 : 1; }

}  // namespace

extern "C" {

// Shared-memory bytes one block of kernel A needs (0 < result).
size_t dense_rows_smem_bytes(int k, int mm_bf16) {
  return panel_smem_floats(k, mm_bf16 != 0) * sizeof(float);
}

// f32 values of the scratch one stripe step needs: the per-panel partials
// of the user gradient [NP, bu, k] followed by the per-panel user counts
// [NP, bu], NP = ceil(ni_pad / kPanel).
size_t dense_rows_scratch_floats(int bu, int ni_pad, int k) {
  return static_cast<size_t>(n_panels_of(ni_pad)) * bu * (k + 1);
}

// One stripe step: kernel A then kernel B on `stream`. Tiles are
// [NU, bu, ni_pad] (R of rtype 0 f32 / 1 bf16 / 2 int8 codes; W int8 or
// null for codes), u3 is [NU, bu, k], i_tab [ni_pad, k], `scratch` holds
// dense_rows_scratch_floats(bu, ni_pad, k) f32. Returns the cudaError_t of
// the first launch that failed, else cudaSuccess.
int dense_rows_stripe(int rtype, int mm_bf16, int collision_norm, void* u3,
                      void* i_tab, const void* R, const void* W,
                      void* scratch, long long stripe, int bu, int ni_pad,
                      int k, float lr, float r_scale, float u_reg,
                      float i_reg, void* stream) {
  if (bu <= 0 || ni_pad <= 0 || k <= 0 || stripe < 0)
    return cudaErrorInvalidValue;
  if ((rtype == kRCodes) != (W == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tile = static_cast<size_t>(stripe) * bu * ni_pad;
  float* U = static_cast<float*>(u3) + static_cast<size_t>(stripe) * bu * k;
  const void* Rs = static_cast<const char*>(R) + tile * rtype_bytes(rtype);
  const int8_t* Ws = W ? static_cast<const int8_t*>(W) + tile : nullptr;
  float* I = static_cast<float*>(i_tab);
  const int n_panels = n_panels_of(ni_pad);
  float* P = static_cast<float*>(scratch);
  float* C = P + static_cast<size_t>(n_panels) * bu * k;
  cudaError_t err =
      mm_bf16 ? dispatch_rtype<true>(rtype, U, I, Rs, Ws, P, C, bu, ni_pad, k,
                                     lr, r_scale, i_reg, collision_norm, s)
              : dispatch_rtype<false>(rtype, U, I, Rs, Ws, P, C, bu, ni_pad,
                                      k, lr, r_scale, i_reg, collision_norm, s);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(bu) * k;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  stripe_user_kernel<<<blocks, kThreads, 0, s>>>(U, P, C, n_panels, bu, k, lr,
                                                 u_reg, collision_norm);
  return cudaGetLastError();
}

const char* dense_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
