// Gather, scoring and intersection kernels of GQE, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of graphqembed_tpu/ops/kernels.py:
//   gqe_gather_normalize_f32   <- gather_normalize   (_gather_norm_kernel)
//   gqe_sddmm_scores_f32       <- sddmm_scores       (_sddmm_kernel)
//   gqe_fused_intersection_f32 <- fused_intersection (_intersection_kernel)
//
// All three take float32 data and int32 ids, contiguous, with d % 4 == 0
// (16-byte vector loads); the wrappers in ops/kernels.py check this. Ids
// outside [0, N) are the caller's error, as in the JAX package.
//
// gather_normalize: out[b] = row / sqrt(max(sum(row^2), 1e-24)), row =
//   table[ids[b]]. Bound by bytes (each row read once and written once:
//   2*B*d*4 + 4*B). One warp per output row, 16-byte loads per lane, the
//   sum of squares by warp shuffle; the second pass over the row hits L1.
// sddmm_scores: scores[b,k] = q[b] . normalize(table[cands[b,k]]). Bound by
//   bytes (B*K*d*4 candidate rows dominate). One warp per (b, k): a single
//   pass over the candidate row forms sum(c^2) and q.c together, and the
//   score is q.c / sqrt(max(sum(c^2), 1e-24)). JAX normalizes c first; the
//   two orders differ by rounding only.
// fused_intersection: out = Phi_i relu(zs[i] @ pre) @ post, Phi = min or
//   mean over the k branches. Bound by float32 operations (2*B*d*d*(k+1)).
//   A block owns a tile of 32 rows. pre is staged in shared memory once,
//   each branch's z tile in turn, and the running min/sum stays in shared
//   memory; then the same buffer takes post and the block writes agg @ post.
//   Each thread computes 4x4 outputs from 16-byte shared-memory loads, on
//   the CUDA cores (no tensor cores: the JAX kernel is float32 and so is
//   this one). At d = 128 it needs 96 KB of dynamic shared memory, above
//   the 48 KB default, so the launch first raises the limit.
//
// Each entry point returns the first CUDA error of its launch (0 = ok).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kTileRows = 32;  // fused_intersection rows per block
constexpr float kEps = 1e-24f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__global__ void gather_normalize_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ ids,
                                        float* __restrict__ out, int64_t b,
                                        int64_t d) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= b) return;  // uniform across the warp
  const float4* src = reinterpret_cast<const float4*>(table + static_cast<int64_t>(ids[row]) * d);
  float4* dst = reinterpret_cast<float4*>(out + row * d);
  const int64_t d4 = d / 4;
  float sq = 0.0f;
  for (int64_t j = lane; j < d4; j += 32) {
    const float4 v = __ldg(src + j);
    sq += dot4(v, v);
  }
  const float n = sqrtf(fmaxf(warp_sum(sq), kEps));
  for (int64_t j = lane; j < d4; j += 32) {
    const float4 v = __ldg(src + j);
    dst[j] = make_float4(v.x / n, v.y / n, v.z / n, v.w / n);
  }
}

__global__ void sddmm_kernel(const float* __restrict__ q,
                             const float* __restrict__ table,
                             const int32_t* __restrict__ cands,
                             float* __restrict__ out, int64_t bk, int64_t k,
                             int64_t d) {
  const int64_t pair = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= bk) return;  // uniform across the warp
  const float4* c = reinterpret_cast<const float4*>(table + static_cast<int64_t>(cands[pair]) * d);
  const float4* qb = reinterpret_cast<const float4*>(q + (pair / k) * d);
  const int64_t d4 = d / 4;
  float dot = 0.0f, sq = 0.0f;
  for (int64_t j = lane; j < d4; j += 32) {
    const float4 cv = __ldg(c + j);
    dot += dot4(__ldg(qb + j), cv);
    sq += dot4(cv, cv);
  }
  dot = warp_sum(dot);
  sq = warp_sum(sq);
  if (lane == 0) out[pair] = dot / sqrtf(fmaxf(sq, kEps));
}

// acc[4][4] = X[r0:r0+4, :] @ W[:, c0:c0+4] with X [rows, d] and W [d, d]
// in shared memory (row-major, row stride d).
__device__ __forceinline__ void tile_product(const float* X, const float* W, int r0,
                                             int c0, int d, float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  for (int j = 0; j < d; j += 4) {
    float4 x[4], w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = *reinterpret_cast<const float4*>(X + (r0 + r) * d + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      w[jj] = *reinterpret_cast<const float4*>(W + (j + jj) * d + c0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float xs[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[r][0] += xs[jj] * w[jj].x;
        acc[r][1] += xs[jj] * w[jj].y;
        acc[r][2] += xs[jj] * w[jj].z;
        acc[r][3] += xs[jj] * w[jj].w;
      }
    }
  }
}

// Copy rows [row0, row0 + kTileRows) of a [b, d] matrix into shared memory,
// zeros past row b.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row0,
                                          int64_t b, int d) {
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kTileRows * d4; i += blockDim.x) {
    const int r = i / d4;
    const int64_t g = row0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < b) v = __ldg(reinterpret_cast<const float4*>(src + g * d) + (i % d4));
    reinterpret_cast<float4*>(dst)[i] = v;
  }
}

__device__ __forceinline__ void load_matrix(float* dst, const float* src, int d) {
  const int n4 = d * d / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
}

__global__ void fused_intersection_kernel(const float* __restrict__ zs,
                                          const float* __restrict__ pre,
                                          const float* __restrict__ post,
                                          float* __restrict__ out, int k, int64_t b,
                                          int d, int is_mean) {
  extern __shared__ float4 smem4[];
  float* W = reinterpret_cast<float*>(smem4);  // [d, d]: pre, then post
  float* Z = W + d * d;                        // [kTileRows, d]: one branch
  float* A = Z + kTileRows * d;                // [kTileRows, d]: min or sum
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int col_groups = d / 4;
  const int n_micro = (kTileRows / 4) * col_groups;

  load_matrix(W, pre, d);
  for (int i = 0; i < k; ++i) {
    load_tile(Z, zs + static_cast<int64_t>(i) * b * d, row0, b, d);
    __syncthreads();
    for (int m = threadIdx.x; m < n_micro; m += blockDim.x) {
      const int r0 = (m / col_groups) * 4, c0 = (m % col_groups) * 4;
      float acc[4][4];
      tile_product(Z, W, r0, c0, d, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* a = A + (r0 + r) * d + c0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float h = fmaxf(acc[r][c], 0.0f);
          a[c] = i == 0 ? h : (is_mean ? a[c] + h : fminf(a[c], h));
        }
      }
    }
    __syncthreads();  // Z is rewritten next; A is complete after the last
  }
  if (is_mean) {
    const float kf = static_cast<float>(k);
    for (int i = threadIdx.x; i < kTileRows * d; i += blockDim.x) A[i] = A[i] / kf;
  }
  load_matrix(W, post, d);
  __syncthreads();
  for (int m = threadIdx.x; m < n_micro; m += blockDim.x) {
    const int r0 = (m / col_groups) * 4, c0 = (m % col_groups) * 4;
    float acc[4][4];
    tile_product(A, W, r0, c0, d, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t g = row0 + r0 + r;
      if (g < b)
        *reinterpret_cast<float4*>(out + g * d + c0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// Dynamic shared memory of the intersection kernel at width d, in bytes.
int64_t intersection_smem(int64_t d) {
  return (d * d + 2 * kTileRows * d) * static_cast<int64_t>(sizeof(float));
}

unsigned int blocks_for_warps(int64_t warps) {
  return static_cast<unsigned int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

int gqe_gather_normalize_f32(const void* table, const void* ids, void* out, int64_t b,
                             int64_t d, void* stream) {
  if (b == 0) return 0;
  gather_normalize_kernel<<<blocks_for_warps(b), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), b, d);
  return static_cast<int>(cudaGetLastError());
}

int gqe_sddmm_scores_f32(const void* q, const void* table, const void* cands, void* out,
                         int64_t b, int64_t k, int64_t d, void* stream) {
  if (b * k == 0) return 0;
  sddmm_kernel<<<blocks_for_warps(b * k), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(table),
      static_cast<const int32_t*>(cands), static_cast<float*>(out), b * k, k, d);
  return static_cast<int>(cudaGetLastError());
}

int gqe_fused_intersection_f32(const void* zs, const void* pre, const void* post,
                               void* out, int64_t k, int64_t b, int64_t d, int is_mean,
                               void* stream) {
  if (b == 0) return 0;
  const int64_t smem = intersection_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_intersection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((b + kTileRows - 1) / kTileRows);
  fused_intersection_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zs), static_cast<const float*>(pre),
      static_cast<const float*>(post), static_cast<float*>(out), static_cast<int>(k), b,
      static_cast<int>(d), is_mean);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
