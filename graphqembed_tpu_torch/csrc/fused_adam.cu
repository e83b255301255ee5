// One-pass Adam for the GQE train step, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of graphqembed_tpu/ops/fused_adam.py:
//   gqe_fused_adam_f32 <- fused_adam_leaf    (_adam_kernel)
//   gqe_fused_adam_sr  <- fused_adam_leaf_sr (_adam_kernel_sr)
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

}  // extern "C"
