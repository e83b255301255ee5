// Gather, scoring and intersection kernels of GQE, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of graphqembed_tpu/ops/kernels.py:
//   gqe_gather_normalize_f32   <- gather_normalize   (_gather_norm_kernel)
//   gqe_sddmm_scores_f32       <- sddmm_scores       (_sddmm_kernel)
//   gqe_fused_intersection_f32 <- fused_intersection (_intersection_kernel)
//
// All three take float32 data and int32 ids, contiguous, with d % 4 == 0
// (16-byte vector loads and copies); the wrappers in ops/kernels.py check
// this. Ids outside [0, N) are the caller's error, as in the JAX package.
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
//   mean over the k branches, at float32 accuracy (the JAX model's products
//   are float32 at Precision.HIGHEST).
//   Bound: 2*B*d*d*(k+1) operations. On the CUDA cores (67 TFLOP/s float32)
//   that is 2.0 us at eval's [3,1024,128] and 8.0 us at [3,4096,128]. This
//   kernel runs the products on the tensor cores as 3xTF32, the split
//   CUTLASS uses for float32 GEMMs: each operand x becomes hi = tf32(x) and
//   lo = tf32(x - hi), both rounded to nearest, and hi*hi' + hi*lo' +
//   lo*hi' is summed in float32 (lo*lo' lies below float32's last bit).
//   Three TF32 products at 495 TFLOP/s: 0.81 us at [3,1024,128], 3.25 us at
//   [3,4096,128]. Single-pass TF32 keeps 11 significant bits and is not used.
//   Grid: eval pads every formula batch to B = 1024 rows, where 32-row blocks
//   of the whole width gave 32 blocks for 132 SMs. Here a cluster of two
//   CTAs owns 16 rows (the mma's M) and CTA r computes the output columns
//   [r*D/2, (r+1)*D/2) of both products (D = d padded to 32, or to 16 above
//   128): 2*ceil(B/16) CTAs, 128 at B = 1024, 512 at B = 4096.
//   Work: mma.sync m16n8k8 tf32. At d <= 128 a CTA has 8 warps: 4 column
//   groups of 16 columns times 2 halves of the k steps, summed through
//   shared memory; a warp splits its columns of pre (later post) once and
//   keeps them in registers for every branch (64 registers). Each branch's
//   z tile is split once per CTA into the A-fragment layout, so that a warp
//   reads a k step with two 16-byte loads and issues six mma on them.
//   Stage 1 keeps the running min or sum of relu(z_i @ pre) in registers.
//   Each CTA writes its columns of agg into its own shared memory and into
//   its peer's (distributed shared memory); after a cluster barrier both
//   hold all of agg, and stage 2 computes agg @ post for their columns. No
//   stage-1 work is done twice.
//   Staging: cp.async brings pre's column slice with the first z tile, then
//   post's slice and the next z tile, which land under the first branch; z
//   tiles are double-buffered across branches, and the split rows take pre's
//   place once it is in registers. Rows past B and columns past d are
//   zero-filled by the copies and masked at the store. The kernel is
//   compiled for each padded width (32 ... 208), so every loop has a fixed
//   trip count: runtime guards in the unrolled loops serialized their loads.
//   At [3,1024,128] one CTA runs on each SM, and its time is a chain: the
//   wait for pre's slice and the first z tile, four phases of split and mma
//   (three branches, then post), and the cluster exchange of agg between
//   them (PERF.md).
//
// Each entry point returns the first CUDA error of its launch (0 = ok).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr float kEps = 1e-24f;

// fused_intersection launch geometry (mirrored by ops/kernels.py::
// intersection_launch).
constexpr int kTileRows = 16;   // rows per cluster: the mma's M
constexpr int kCluster = 2;     // CTAs per cluster, each owning D/2 columns
constexpr int kMaxWidth = 208;  // the widest d whose shared memory fits

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

// ---------- fused_intersection ----------

// Output tiles of 8 columns per warp: two where a warp's split columns of
// pre or post fit in registers (d <= 128), one above.
__host__ __device__ constexpr int tiles_per_warp(int dp) { return dp <= 128 ? 2 : 1; }

// Warps per column group, each taking a share of the k steps (d <= 128: two,
// for twice the warps and half the registers of split columns each).
__host__ __device__ constexpr int k_splits(int dp) { return dp <= 128 ? 2 : 1; }

// d padded to the mma's granularity: K steps of 8, and two CTAs of warps of
// 8 * nt columns. The kernel is compiled for each padded width, so that its
// loops have fixed trip counts and its staging no division.
constexpr int padded_width(int64_t d) {
  return d <= 128 ? static_cast<int>((d + 31) / 32 * 32) : static_cast<int>((d + 15) / 16 * 16);
}

// Shared-memory row strides in floats at padded width dp. The pads keep the
// fragment reads free of bank conflicts at d = 128: a B fragment reads rows
// t and t+4 at column g (stride 8 mod 32), the split pass rows g and g+8 at
// column t (stride 4 or 20 mod 32).
__host__ __device__ constexpr int slice_stride(int dp) { return dp / 2 + 8; }
__host__ __device__ constexpr int tile_stride(int dp) { return dp + 4; }

// Floats of the first region: pre's column slice [dp][dp/2 + 8], later the
// split A fragments (hi and lo, 8 floats per lane and k step).
__host__ __device__ constexpr int first_region(int dp) {
  return dp * slice_stride(dp) > 32 * dp ? dp * slice_stride(dp) : 32 * dp;
}

// Dynamic shared memory of the intersection kernel at padded width dp, in
// bytes: the first region, post's column slice, two raw z tiles [16][dp + 4]
// (the first later holds agg) and the partial products of the k-split warps.
int64_t intersection_smem(int dp) {
  return (static_cast<int64_t>(first_region(dp)) + dp * slice_stride(dp) +
          2LL * kTileRows * tile_stride(dp) + (k_splits(dp) - 1) * 8LL * dp) *
         static_cast<int64_t>(sizeof(float));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Arrive without ordering this thread's earlier memory accesses (cheaper
// than a release arrive): only where a __syncthreads() has already
// completed them.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copy the column slice [c0, c0 + dp/2) of a [d, d] matrix into w [dp][ws],
// zeros past row or column d.
template <int kDP, int kThreads>
__device__ __forceinline__ void stage_slice(float* w, const float* src, int c0, int d) {
  constexpr int ws = slice_stride(kDP), q = kDP / 8;  // 16-byte chunks per slice row
#pragma unroll 4
  for (int i = threadIdx.x; i < kDP * q; i += kThreads) {
    const int r = i / q, c = (i % q) * 4;
    const bool ok = r < d && c0 + c < d;
    cp_async16(w + r * ws + c, ok ? src + static_cast<int64_t>(r) * d + c0 + c : src, ok);
  }
}

// Copy rows [row0, row0 + kTileRows) of a [b, d] matrix into z [kTileRows][ts],
// zeros past row b or column d.
template <int kDP, int kThreads>
__device__ __forceinline__ void stage_tile(float* z, const float* src, int64_t row0,
                                           int64_t b, int d) {
  constexpr int ts = tile_stride(kDP), q = kDP / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTileRows * q; i += kThreads) {
    const int r = i / q, c = (i % q) * 4;
    const bool ok = row0 + r < b && c < d;
    cp_async16(z + r * ts + c, ok ? src + (row0 + r) * d + c : src, ok);
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds; on the integer pipe, where cvt runs on the
// slower conversion unit.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-23 |x|), both TF32; x - hi is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a @ b for one m16n8k8 tile: a 16x8 (row), b 8x8 (col), TF32, float32 c.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint4& a,
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A holds rows g,
// g+8 at columns t, t+4; B rows t, t+4 at column g; C rows g, g+8 at
// columns 2t, 2t+1.
//
// Split x [16][dp] (row stride ts) into A fragments once for the whole CTA:
// a_hi[s * 32 + lane] and a_lo[...] hold lane's four values of k step s, so
// a warp reads a k step's fragment with one 16-byte load per lane.
template <int kDP, int kThreads>
__device__ __forceinline__ void split_rows(uint4* a_hi, uint4* a_lo, const float* x) {
  constexpr int ts = tile_stride(kDP);
#pragma unroll
  for (int i = threadIdx.x; i < kDP * 4; i += kThreads) {
    const int s = i >> 5, g = (i >> 2) & 7, t = i & 3;
    const float* p = x + g * ts + 8 * s + t;
    uint4 h, l;
    split_tf32(p[0], h.x, l.x);
    split_tf32(p[8 * ts], h.y, l.y);
    split_tf32(p[4], h.z, l.z);
    split_tf32(p[8 * ts + 4], h.w, l.w);
    a_hi[i] = h;
    a_lo[i] = l;
  }
}

// A warp's B fragments: its nt 8-column tiles of pre or post for its kSteps
// k steps, split, in registers.
template <int kSteps, int kNT>
struct SplitColumns {
  uint32_t hi[kSteps][kNT][2], lo[kSteps][kNT][2];
};

// From the staged column slice w [dp][dp/2 + 8] (row stride ws): columns n0 +
// 8n (+ g) of k steps s0 ... s0 + kSteps - 1.
template <int kSteps, int kNT>
__device__ __forceinline__ void load_columns(SplitColumns<kSteps, kNT>& f, const float* w,
                                             int ws, int n0, int s0, int g, int t) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float* p = w + (8 * (s0 + s) + t) * ws + n0 + 8 * n + g;
      split_tf32(p[0], f.hi[s][n][0], f.lo[s][n][0]);
      split_tf32(p[4 * ws], f.hi[s][n][1], f.lo[s][n][1]);
    }
}

// c[n] = x @ (the warp's column tile n) in 3xTF32 from the split rows of x.
// c[n][0..1]: row g, columns 2t, 2t+1; c[n][2..3]: row g+8.
template <int kSteps, int kNT>
__device__ __forceinline__ void warp_product(const uint4* a_hi, const uint4* a_lo,
                                             const SplitColumns<kSteps, kNT>& f, int s0,
                                             int lane, float (&c)[kNT][4]) {
  float acc[kNT][3][4] = {};  // [tile][hi*hi, hi*lo, lo*hi]: independent sums
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint4 hi = a_hi[(s0 + s) * 32 + lane], lo = a_lo[(s0 + s) * 32 + lane];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mma_tf32(acc[n][0], hi, f.hi[s][n]);
      mma_tf32(acc[n][1], hi, f.lo[s][n]);
      mma_tf32(acc[n][2], lo, f.hi[s][n]);
    }
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // the small terms first
      c[n][j] = (acc[n][1][j] + acc[n][2][j]) + acc[n][0][j];
}

// Sum the k-split warps' partial products into the first share's warps
// (kh == 0), in k order, through red [kKS - 1][kWarpsN][32][4 nt].
template <int kKS, int kWarpsN, int kNT>
__device__ __forceinline__ void reduce_k_splits(float* red, float (&c)[kNT][4], int kh,
                                                int grp, int lane) {
  if (kKS == 1) return;
  auto* r = reinterpret_cast<float4*>(red);
  if (kh > 0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      r[(((kh - 1) * kWarpsN + grp) * 32 + lane) * kNT + n] =
          make_float4(c[n][0], c[n][1], c[n][2], c[n][3]);
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int q = 1; q < kKS; ++q)
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float4 v = r[(((q - 1) * kWarpsN + grp) * 32 + lane) * kNT + n];
        c[n][0] += v.x;
        c[n][1] += v.y;
        c[n][2] += v.z;
        c[n][3] += v.w;
      }
  }
}

// At padded width kDP: column groups of kDP / (16 * nt) warps, each warp
// owning nt tiles of 8 columns, times kKS shares of the k steps.
template <int kDP, int kNT = tiles_per_warp(kDP), int kKS = k_splits(kDP),
          int kThreads = 2 * kDP * kKS / kNT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    fused_intersection_kernel(const float* __restrict__ zs, const float* __restrict__ pre,
                              const float* __restrict__ post, float* __restrict__ out,
                              int k, int64_t b, int d, int is_mean) {
  extern __shared__ float4 smem4[];
  constexpr int dp = kDP, ws = slice_stride(dp), ts = tile_stride(dp);
  float* w_pre = reinterpret_cast<float*>(smem4);  // [dp][ws]: pre's column slice
  uint4* a_hi = reinterpret_cast<uint4*>(smem4);   // then split rows [dp/8][32]
  uint4* a_lo = a_hi + dp * 4;                     // [dp/8][32]
  float* w_post = w_pre + first_region(dp);        // [dp][ws]: post's column slice
  float* z_buf = w_post + dp * ws;                 // [2][kTileRows][ts]: raw z tiles
  float* agg = z_buf;                              // [kTileRows][ts]: all of agg, last
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / kCluster) * kTileRows;
  float* red = z_buf + 2 * kTileRows * ts;        // the k-split warps' partial products
  constexpr int kWarpsN = kDP / (16 * kNT), kSteps = kDP / 8 / kKS;
  const int c0 = rank * (dp / 2);  // this CTA's first column
  const int warp = threadIdx.x >> 5, grp = warp % kWarpsN, kh = warp / kWarpsN;
  const int n0 = grp * 8 * kNT;  // the warp's first column in the slice
  const int s0 = kh * kSteps;    // and its first k step
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // Copy groups: {pre, z_0}, {post, z_1}, then z_{i+2} (or nothing) once
  // z_i is split, so that "all but the newest group" is always z_i.
  stage_slice<kDP, kThreads>(w_pre, pre, c0, d);
  stage_tile<kDP, kThreads>(z_buf, zs, row0, b, d);
  cp_async_commit();
  stage_slice<kDP, kThreads>(w_post, post, c0, d);
  if (k > 1) stage_tile<kDP, kThreads>(z_buf + kTileRows * ts, zs + b * d, row0, b, d);
  cp_async_commit();
  SplitColumns<kSteps, kNT> cols;
  float run[kNT][4] = {};  // min or sum of relu(z_i @ pre)
  for (int i = 0; i < k; ++i) {
    float* z = z_buf + (i & 1) * kTileRows * ts;
    cp_async_wait<1>();
    __syncthreads();  // z_i has landed; at i > 0 every warp is done with a_hi/a_lo
    if (i == 0) {
      load_columns(cols, w_pre, ws, n0, s0, g, t);
      __syncthreads();  // pre's slice is read; the split rows take its place
    }
    split_rows<kDP, kThreads>(a_hi, a_lo, z);
    __syncthreads();
    if (i + 2 < k) stage_tile<kDP, kThreads>(z, zs + (i + 2) * b * d, row0, b, d);
    cp_async_commit();
    float c[kNT][4];
    warp_product(a_hi, a_lo, cols, s0, lane, c);
    reduce_k_splits<kKS, kWarpsN>(red, c, kh, grp, lane);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h = fmaxf(c[n][j], 0.0f);
        run[n][j] = i == 0 ? h : (is_mean ? run[n][j] + h : fminf(run[n][j], h));
      }
  }
  cp_async_wait<0>();  // post's slice (k == 1); the later groups are empty
  if (is_mean) {
    // times 1/k: an IEEE division per element branches to a slow path
    const float inv_k = 1.0f / static_cast<float>(k);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) run[n][j] *= inv_k;
  }

  // This CTA's columns of agg, into its own shared memory and its peer's.
  // agg takes the first z buffer, so the peer may write only once every
  // thread here is past its last split (whose reads the __syncthreads after
  // it completed) and its copies (cp_async_wait<0> above).
  cluster_arrive_relaxed();
  float* peer_agg = cluster.map_shared_rank(agg, rank ^ 1);
  const int col = c0 + n0 + 2 * t;  // + 8n for tile n
  cluster_wait();
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = make_float2(run[n][2 * h], run[n][2 * h + 1]);
        const int o = (g + 8 * h) * ts + col + 8 * n;
        *reinterpret_cast<float2*>(agg + o) = v;
        *reinterpret_cast<float2*>(peer_agg + o) = v;
      }
  }
  cluster_arrive();
  cluster_wait();  // both CTAs hold all of agg, and post's slice has landed

  split_rows<kDP, kThreads>(a_hi, a_lo, agg);
  load_columns(cols, w_post, ws, n0, s0, g, t);
  __syncthreads();
  float c[kNT][4];
  warp_product(a_hi, a_lo, cols, s0, lane, c);
  reduce_k_splits<kKS, kWarpsN>(red, c, kh, grp, lane);
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + g + 8 * h;
        if (r < b && col + 8 * n < d)
          *reinterpret_cast<float2*>(out + r * d + col + 8 * n) =
              make_float2(c[n][2 * h], c[n][2 * h + 1]);
      }
  }
}

template <int kDP>
int launch_intersection(const float* zs, const float* pre, const float* post, float* out,
                        int64_t k, int64_t b, int64_t d, int is_mean,
                        cudaStream_t stream) {
  const int64_t smem = intersection_smem(kDP);
  cudaError_t err =
      cudaFuncSetAttribute(fused_intersection_kernel<kDP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int ctas =
      kCluster * static_cast<unsigned int>((b + kTileRows - 1) / kTileRows);
  fused_intersection_kernel<kDP><<<ctas, 2 * kDP * k_splits(kDP) / tiles_per_warp(kDP),
                                   static_cast<size_t>(smem), stream>>>(
      zs, pre, post, out, static_cast<int>(k), b, static_cast<int>(d), is_mean);
  return static_cast<int>(cudaGetLastError());
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
  if (b == 0 || d == 0 || k == 0) return 0;
  const auto* z = static_cast<const float*>(zs);
  const auto* w1 = static_cast<const float*>(pre);
  const auto* w2 = static_cast<const float*>(post);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d > kMaxWidth ? 0 : padded_width(d)) {
    case 32: return launch_intersection<32>(z, w1, w2, o, k, b, d, is_mean, s);
    case 64: return launch_intersection<64>(z, w1, w2, o, k, b, d, is_mean, s);
    case 96: return launch_intersection<96>(z, w1, w2, o, k, b, d, is_mean, s);
    case 128: return launch_intersection<128>(z, w1, w2, o, k, b, d, is_mean, s);
    case 144: return launch_intersection<144>(z, w1, w2, o, k, b, d, is_mean, s);
    case 160: return launch_intersection<160>(z, w1, w2, o, k, b, d, is_mean, s);
    case 176: return launch_intersection<176>(z, w1, w2, o, k, b, d, is_mean, s);
    case 192: return launch_intersection<192>(z, w1, w2, o, k, b, d, is_mean, s);
    case 208: return launch_intersection<208>(z, w1, w2, o, k, b, d, is_mean, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
