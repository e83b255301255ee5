// One-pass Adam for the GQE train step, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of graphqembed_tpu/ops/fused_adam.py:
//   gqe_fused_adam_f32     <- fused_adam_leaf    (_adam_kernel)
//   gqe_fused_adam_sr      <- fused_adam_leaf_sr (_adam_kernel_sr)
//   gqe_fused_adam_rows_sr <- fused_adam_table_sorted_rows_sr
//                             (_adam_kernel_rows_sr); see its own note below
//
//   mu' = b1*mu + (1-b1)*g
//   nu' = b2*nu + (1-b2)*(g*g)
//   p'  = p - lr*(mu'*c1) / (sqrt(nu'*c2) + eps)
//
// p, mu and nu are updated in place. Both kernels are elementwise and bound
// by device-memory bytes: 28 B per element for the float32 leaf (read p, g,
// mu, nu; write p, mu, nu), 14 B for the bfloat16 table with a bfloat16
// gradient. The design does one grid-stride pass with every intermediate
// in registers, so each byte moves once. The TPU's [M, d] tiling has no
// counterpart here: any numel works.
//
// Numerics: built with -fmad=false and without fast math, so every
// operation rounds as the plain PyTorch version's separate operations do
// (IEEE sqrtf and division); the two agree bit for bit.
//
// Stochastic rounding (bfloat16 storage): each float32 result gets 16
// random low bits added and is truncated to its top 16 bits, which is
// unbiased. The random bits are a counter-based hash of (seed, element
// index, stream), streams 0/1/2 for p/mu/nu, so there is no generator
// state; the plain version in ops/fused_adam.py computes the same hash.
//
// Each entry point returns cudaGetLastError() after its launch (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond this
constexpr uint32_t kGolden = 0x9E3779B9u;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t sr_bits(uint32_t key, int64_t i) {
  uint32_t h = fmix32(static_cast<uint32_t>(i) ^ key);
  return fmix32(h + static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32));
}

__device__ __forceinline__ uint16_t sr_bf16(float x, uint32_t bits) {
  uint32_t u = __float_as_uint(x);
  u = (u + (bits & 0xFFFFu)) & 0xFFFF0000u;
  return static_cast<uint16_t>(u >> 16);
}

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ float load_g(const float* g, int64_t i) { return g[i]; }
__device__ __forceinline__ float load_g(const uint16_t* g, int64_t i) {
  return bf16_to_f32(g[i]);
}

struct AdamScalars {
  float lr, b1, b2, eps, c1, c2;
};

__global__ void adam_f32_kernel(float* __restrict__ p, const float* __restrict__ g,
                                float* __restrict__ mu, float* __restrict__ nu,
                                int64_t n, AdamScalars s) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float m = s.b1 * mu[i] + (1.0f - s.b1) * gi;
    const float v = s.b2 * nu[i] + (1.0f - s.b2) * (gi * gi);
    mu[i] = m;
    nu[i] = v;
    p[i] = p[i] - s.lr * (m * s.c1) / (sqrtf(v * s.c2) + s.eps);
  }
}

template <typename G>
__global__ void adam_sr_kernel(uint16_t* __restrict__ p, const G* __restrict__ g,
                               uint16_t* __restrict__ mu, uint16_t* __restrict__ nu,
                               int64_t n, AdamScalars s, uint32_t seed) {
  const uint32_t key_p = fmix32(seed + kGolden * 1u);
  const uint32_t key_mu = fmix32(seed + kGolden * 2u);
  const uint32_t key_nu = fmix32(seed + kGolden * 3u);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = load_g(g, i);
    const float m = s.b1 * bf16_to_f32(mu[i]) + (1.0f - s.b1) * gi;
    const float v = s.b2 * bf16_to_f32(nu[i]) + (1.0f - s.b2) * (gi * gi);
    const float pn = bf16_to_f32(p[i]) - s.lr * (m * s.c1) / (sqrtf(v * s.c2) + s.eps);
    p[i] = sr_bf16(pn, sr_bits(key_p, i));
    mu[i] = sr_bf16(m, sr_bits(key_mu, i));
    nu[i] = sr_bf16(v, sr_bits(key_nu, i));
  }
}

// ---- gqe_fused_adam_rows_sr: the bfloat16 table from sorted row gradients.
//
// Bound by device-memory bytes: 12 B per table element (read p, mu, nu in
// bfloat16, write them back) plus L*d*2 B of bfloat16 row gradients (plus
// 4 B per entry of `order` and per row of `starts`). At [35200, 128] and
// L = 2,560: 54.07 + 0.66 MB = 54.7 MB (54.9 MB with order and starts),
// 16.3 us at 3.35 TB/s.
//
// Dense semantics in one pass over the whole table: every one of the N*d
// elements is read and written once, including rows no id names (g = 0, so
// their moments decay), and no [N, d] gradient exists in device memory.
// Each thread owns one (row, 8-column group): it reads its row's run of the
// sorted entries, [starts[r], starts[r+1]), takes row order[j] of the row
// gradients with one 16-byte load per entry, sums in float32 in sorted
// order starting from 0, then applies the update in registers and writes
// p, mu, nu with 16-byte stores. No atomics and no shared memory: the TPU
// kernel built each tile's gradient with a one-hot matmul on the MXU, a
// scatter the GPU does not need. A thread whose row is a hub (many entries)
// loops longer; that is correct, and costs that block time. The order of
// the sum is the plain version's (ops/fused_adam.py::_rows_grad_plain), and
// the update, hash, element index r*d + c and stream keys are those of
// adam_sr_kernel, so for the same seed and gradient it writes the same bits.

constexpr int kRowVec = 8;  // bfloat16 values per 16-byte load

__device__ __forceinline__ void unpack8(const uint4& v, float* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = bf16_to_f32(static_cast<uint16_t>(w[k] & 0xFFFFu));
    x[2 * k + 1] = bf16_to_f32(static_cast<uint16_t>(w[k] >> 16));
  }
}

__device__ __forceinline__ uint4 pack8(const uint16_t* h) {
  uint4 v;
  v.x = static_cast<uint32_t>(h[0]) | (static_cast<uint32_t>(h[1]) << 16);
  v.y = static_cast<uint32_t>(h[2]) | (static_cast<uint32_t>(h[3]) << 16);
  v.z = static_cast<uint32_t>(h[4]) | (static_cast<uint32_t>(h[5]) << 16);
  v.w = static_cast<uint32_t>(h[6]) | (static_cast<uint32_t>(h[7]) << 16);
  return v;
}

__global__ void adam_rows_sr_kernel(uint16_t* __restrict__ p, uint16_t* __restrict__ mu,
                                    uint16_t* __restrict__ nu,
                                    const int32_t* __restrict__ order,
                                    const uint16_t* __restrict__ rows,
                                    const int32_t* __restrict__ starts, int64_t n, int d,
                                    AdamScalars s, uint32_t seed) {
  const uint32_t key_p = fmix32(seed + kGolden * 1u);
  const uint32_t key_mu = fmix32(seed + kGolden * 2u);
  const uint32_t key_nu = fmix32(seed + kGolden * 3u);
  const int groups = d / kRowVec;
  const int64_t total = n * groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / groups;
    const int c0 = static_cast<int>(t - r * groups) * kRowVec;
    float g[kRowVec];
#pragma unroll
    for (int e = 0; e < kRowVec; ++e) g[e] = 0.0f;
    const int j1 = starts[r + 1];
    for (int j = starts[r]; j < j1; ++j) {
      const int64_t src = static_cast<int64_t>(order[j]) * d + c0;
      float x[kRowVec];
      unpack8(*reinterpret_cast<const uint4*>(rows + src), x);
#pragma unroll
      for (int e = 0; e < kRowVec; ++e) g[e] = g[e] + x[e];
    }
    const int64_t i0 = r * d + c0;
    float pf[kRowVec], mf[kRowVec], vf[kRowVec];
    unpack8(*reinterpret_cast<const uint4*>(p + i0), pf);
    unpack8(*reinterpret_cast<const uint4*>(mu + i0), mf);
    unpack8(*reinterpret_cast<const uint4*>(nu + i0), vf);
    uint16_t po[kRowVec], mo[kRowVec], vo[kRowVec];
#pragma unroll
    for (int e = 0; e < kRowVec; ++e) {
      const float gi = g[e];
      const float m = s.b1 * mf[e] + (1.0f - s.b1) * gi;
      const float v = s.b2 * vf[e] + (1.0f - s.b2) * (gi * gi);
      const float pn = pf[e] - s.lr * (m * s.c1) / (sqrtf(v * s.c2) + s.eps);
      const int64_t i = i0 + e;
      po[e] = sr_bf16(pn, sr_bits(key_p, i));
      mo[e] = sr_bf16(m, sr_bits(key_mu, i));
      vo[e] = sr_bf16(v, sr_bits(key_nu, i));
    }
    *reinterpret_cast<uint4*>(p + i0) = pack8(po);
    *reinterpret_cast<uint4*>(mu + i0) = pack8(mo);
    *reinterpret_cast<uint4*>(nu + i0) = pack8(vo);
  }
}

unsigned int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace

extern "C" {

int gqe_fused_adam_f32(void* p, const void* g, void* mu, void* nu, int64_t n,
                       float lr, float b1, float b2, float eps, float c1, float c2,
                       void* stream) {
  AdamScalars s{lr, b1, b2, eps, c1, c2};
  adam_f32_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(mu),
      static_cast<float*>(nu), n, s);
  return static_cast<int>(cudaGetLastError());
}

// g_is_f32: 1 when the gradient is float32, 0 when it is bfloat16.
int gqe_fused_adam_sr(void* p, const void* g, int g_is_f32, void* mu, void* nu,
                      int64_t n, float lr, float b1, float b2, float eps, float c1,
                      float c2, uint32_t seed, void* stream) {
  AdamScalars s{lr, b1, b2, eps, c1, c2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_is_f32) {
    adam_sr_kernel<float><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<uint16_t*>(p), static_cast<const float*>(g),
        static_cast<uint16_t*>(mu), static_cast<uint16_t*>(nu), n, s, seed);
  } else {
    adam_sr_kernel<uint16_t><<<grid_for(n), kThreads, 0, st>>>(
        static_cast<uint16_t*>(p), static_cast<const uint16_t*>(g),
        static_cast<uint16_t*>(mu), static_cast<uint16_t*>(nu), n, s, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// order [L] and starts [n+1] int32 (ops/fused_adam.py::presort_row_ids),
// rows [L, d] bfloat16 in the ids' original order. d must be a multiple of
// 8 and every pointer 16-byte aligned (PyTorch's allocations are).
int gqe_fused_adam_rows_sr(void* p, void* mu, void* nu, const void* order,
                           const void* rows, const void* starts, int64_t n, int d,
                           float lr, float b1, float b2, float eps, float c1, float c2,
                           uint32_t seed, void* stream) {
  if (d <= 0 || d % kRowVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  AdamScalars s{lr, b1, b2, eps, c1, c2};
  adam_rows_sr_kernel<<<grid_for(n * (d / kRowVec)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(p), static_cast<uint16_t*>(mu), static_cast<uint16_t*>(nu),
      static_cast<const int32_t*>(order), static_cast<const uint16_t*>(rows),
      static_cast<const int32_t*>(starts), n, d, s, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
