// The backward of take_rows (ops/grads.py) for Hopper (sm_90a): the table
// gradient g[r] = the sum of the cotangent rows whose id is r, added in the
// order of the ids' positions, in the table's dtype, with no float atomics.
//
//   gqe_scatter_rows <- the sorted scatter of take_rows' custom VJP
//                       (graphqembed_tpu/ops/grads.py::_take_rows_for: a
//                       stable argsort, then `.at[sorted].add(...)`; plain
//                       XLA there, no Pallas kernel)
//
// Inputs: the flat ids [L] (int64, any order, repeats allowed) and the
// cotangent rows ct [L, d] in the table's dtype (float32 or bfloat16).
// Output g [n, d] in the same dtype; every element is written, rows no id
// names as 0, so no zero fill runs before it.
//
// Bound by bytes: the n*d gradient is written once (9.0 MB for the bf16
// [35200, 128] table, 2.7 us at 3.35 TB/s); the L*d cotangent and the ids
// are read once from device memory (0.7 MB at L = 2,560; each block reads
// the ids again from L2).
//
// A global stable sort of the ids costs more than the whole pass (PyTorch's
// sort of 2,560 int64 keys is a one-block radix sort, 14-19 us on an H100);
// a thread walking a run of dependent global loads, or scanning a dense
// tile's entries for its row, sets the kernel's time (a bench 3i batch
// names one row 34 times, and hubs crowd a few tiles). So each block owns a
// tile of rows (up to kRows; fewer for a small table, so that every SM gets
// a block) and sorts only the entries in its tile, in shared memory:
//   1. the block reads a pass of up to kPass ids (8 a thread, all loads in
//      flight), then writes zeros over its whole tile (on the first pass;
//      the stores drain while it sorts); each warp counts the ids in the
//      tile in its own span of positions (ballots), then lists them after
//      the spans before it, so the list is in position order; per-row
//      counts are integer atomics (their order does not change them);
//   2. warp 0 sorts the list by row (a counting sort: the counts scanned
//      into run starts, the list placed chunk by chunk, __match_any_sync
//      ranking equal rows within a chunk), so each row's run lists its
//      entries in position order, while the other warps stage the
//      entries' cotangent rows in shared memory with every load in flight;
//   3. each thread, for each (row, VEC columns) it owns, adds its run in
//      order from shared memory and rounds each sum to the dtype, as JAX's
//      scatter-add and the plain version's index_add_ do, then writes it;
//   4. a tile with more entries than the stage holds (kStage bytes of
//      rows) takes them in batches of the list; a run that continues in a
//      later batch or pass (L > kPass) reads its partial sum back and goes
//      on, so the bits are those of one sum.
// The order of every sum is the ids' position order, so every run gives the
// same bits (CUDA's index_add_ adds with float atomics in whatever order its
// threads meet). The launch geometry is ops/grads.py::scatter_launch.
//
// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for a geometry it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;                 // most rows of the gradient per block
constexpr int kPerThread = 8;              // ids a thread reads per pass
constexpr int kPass = kThreads * kPerThread;  // ids per pass: 4,096
constexpr int kStage = 65536;              // bytes of staged cotangent rows (dynamic)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// acc + x rounded to the storage type: float32 adds as they are; bfloat16
// rounds each sum to nearest even, as a bfloat16 add in PyTorch and XLA does.
__device__ __forceinline__ float add_in(float acc, float x, const float*) { return acc + x; }
__device__ __forceinline__ float add_in(float acc, float x, const uint16_t*) {
  return __bfloat162float(__float2bfloat16_rn(acc + x));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = static_cast<uint16_t>(__float_as_uint(v) >> 16);  // v is bf16 already
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Copy the cotangent rows of list entries [b0, b0 + nb) into s_ct, row i
// of the batch at s_ct + i * d: threads `first`, first + stride, ... each
// take one 16-byte (VEC-element) piece.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* s_ct, const T* __restrict__ ct, const int* s_list,
                                      int64_t base, int b0, int nb, int d, int groups,
                                      int first, int stride) {
  for (int u = first; u < nb * groups; u += stride) {
    const int i = u / groups;
    const int c = (u - i * groups) * VEC;
    const int64_t j = base + (s_list[b0 + i] >> 8);
    *reinterpret_cast<Pack<T, VEC>*>(s_ct + i * d + c) =
        *reinterpret_cast<const Pack<T, VEC>*>(ct + j * d + c);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
scatter_rows_kernel(T* __restrict__ out, const T* __restrict__ ct,
                    const int64_t* __restrict__ ids, int64_t length, int64_t n, int d,
                    int tile) {
  __shared__ int s_list[kPass];        // (position << 8) | row, position order
  __shared__ uint16_t s_pos[kPass];     // list indices, grouped by row
  __shared__ int s_start[kRows + 1];    // row r's run: s_pos[s_start[r], s_start[r+1])
  __shared__ int s_fill[kRows];
  __shared__ int s_count[kWarps];       // entries each warp's span holds
  extern __shared__ __align__(16) unsigned char s_stage[];  // kStage: a batch's ct rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int rows = static_cast<int>(n - r0 < tile ? n - r0 : tile);
  const int groups = d / VEC;
  const int vecs = rows * groups;
  const int cap = kStage / (d * static_cast<int>(sizeof(T))) > 0
                      ? kStage / (d * static_cast<int>(sizeof(T))) : 1;
  T* s_ct = reinterpret_cast<T*>(s_stage);
  constexpr int kSpan = kPass / kWarps;  // positions per warp per pass: 256

  for (int64_t base = 0;; base += kPass) {
    const int seg = static_cast<int>(length - base < kPass ? length - base : kPass);
    // 1. the tile's entries of the pass in position order: each warp counts
    // those of its span, then lists them after the spans before it. The id
    // loads go out first; on the first pass the block then writes zeros
    // over its whole tile, which drain while it sorts (the rows some id
    // names are written again in step 3 by the same thread).
    int64_t my[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int p = warp * kSpan + k * 32 + lane;
      my[k] = p < seg ? ids[base + p] - r0 : -1;
    }
    if (base == 0) {
      for (int v = tid; v < vecs; v += kThreads) {
        const int lr = v / groups;
        *reinterpret_cast<Pack<T, VEC>*>(out + (r0 + lr) * d + (v - lr * groups) * VEC) =
            Pack<T, VEC>{};
      }
    }
    int found = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      found += __popc(__ballot_sync(kFull, my[k] >= 0 && my[k] < rows));
    if (lane == 0) s_count[warp] = found;
    for (int i = tid; i <= kRows; i += kThreads) s_start[i] = 0;
    __syncthreads();
    int off = 0, m = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_count[w] : 0;
      m += s_count[w];
    }
    found = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool in = my[k] >= 0 && my[k] < rows;
      const unsigned ball = __ballot_sync(kFull, in);
      if (in) {
        s_list[off + found + __popc(ball & lt)] =
            ((warp * kSpan + k * 32 + lane) << 8) | static_cast<int>(my[k]);
        atomicAdd(&s_start[static_cast<int>(my[k]) + 1], 1);  // integer counts
      }
      found += __popc(ball);
    }
    __syncthreads();

    // 2. warp 0: a counting sort by row, stable: it scans the counts into
    // run starts (8 rows a lane), then places the list's indices chunk by
    // chunk, so each row's run lists its entries in position order. The
    // other warps meanwhile stage the first batch's cotangent rows (list
    // order) in shared memory, every load in flight at once.
    int nb = m < cap ? m : cap;
    if (warp == 0) {
      constexpr int kLaneRows = kRows / 32;
      int c[kLaneRows], sum = 0;
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        c[k] = s_start[kLaneRows * lane + k + 1];
        sum += c[k];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      int at = incl - sum;  // entries of the rows before this lane's
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        s_fill[kLaneRows * lane + k] = at;
        at += c[k];
        s_start[kLaneRows * lane + k + 1] = at;
      }
      __syncwarp();
      for (int c0 = 0; c0 < m; c0 += 32) {
        const int i = c0 + lane;
        const int row = i < m ? s_list[i] & 0xFF : 0;
        // lanes past the list get keys no row has, one each
        const unsigned mm = __match_any_sync(kFull, i < m ? row : -1 - lane);
        int slot = 0;
        if (i < m) {
          slot = s_fill[row] + __popc(mm & lt);
          s_pos[slot] = static_cast<uint16_t>(i);
        }
        __syncwarp();
        if (i < m && lane == __ffs(mm) - 1) s_fill[row] = slot + __popc(mm);
        __syncwarp();
      }
    } else {
      stage<T, VEC>(s_ct, ct, s_list, base, 0, nb, d, groups, tid - 32, kThreads - 32);
    }
    __syncthreads();

    // 3. the list in batches of up to `cap` entries: each (row, column
    // group) adds its run's entries that fall in the batch, in order, and
    // writes the sum. A run that goes on from an earlier batch or pass reads
    // its partial sum back and continues it.
    for (int b0 = 0; b0 < m; b0 += cap) {
      if (b0 > 0) {
        nb = m - b0 < cap ? m - b0 : cap;
        __syncthreads();  // every thread is done with the last batch's stage
        stage<T, VEC>(s_ct, ct, s_list, base, b0, nb, d, groups, tid, kThreads);
        __syncthreads();
      }
      for (int v = tid; v < vecs; v += kThreads) {
        const int lr = v / groups;
        const int p0 = s_start[lr], p1 = s_start[lr + 1];
        if (p0 == p1 || s_pos[p1 - 1] < b0 || s_pos[p0] >= b0 + nb) continue;
        const int c0 = (v - lr * groups) * VEC;
        T* dst = out + (r0 + lr) * d + c0;
        float acc[VEC];
        if (base == 0 && s_pos[p0] >= b0) {  // the run starts in this batch
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
        } else {
          const Pack<T, VEC> o = *reinterpret_cast<const Pack<T, VEC>*>(dst);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = to_f32(o.v[e]);
        }
#pragma unroll 4
        for (int p = p0; p < p1; ++p) {
          const int i = s_pos[p] - b0;
          if (i < 0) continue;
          if (i >= nb) break;
          const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(s_ct + i * d + c0);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = add_in(acc[e], to_f32(x.v[e]), ct);
        }
        Pack<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) store(&o.v[e], acc[e]);
        *reinterpret_cast<Pack<T, VEC>*>(dst) = o;
      }
    }
    if (base + kPass >= length) break;
    __syncthreads();  // the next pass reuses the shared arrays
  }
}

template <typename T, int VEC>
int launch(void* out, const void* ct, const void* ids, int64_t length, int64_t n, int d,
           int tile, unsigned int blocks, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      scatter_rows_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStage);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scatter_rows_kernel<T, VEC><<<blocks, kThreads, kStage, st>>>(
      static_cast<T*>(out), static_cast<const T*>(ct), static_cast<const int64_t*>(ids),
      length, n, d, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16 out/ct, 0 for float32. vec: columns per thread,
// 16 bytes' worth (8 bf16, 4 float32) or 1; d % vec == 0 and, for vec > 1,
// out and ct 16-byte aligned. tile: rows per block, 1 to 256; blocks:
// ceil(n / tile), one per tile of rows.
int gqe_scatter_rows(void* out, const void* ct, int is_bf16, const void* ids, int64_t length,
                     int64_t n, int d, int vec, int tile, unsigned int blocks, void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  if (d <= 0 || n <= 0 || length < 0 || (vec != 1 && vec != wide) || d % vec != 0 ||
      tile < 1 || tile > kRows || static_cast<int64_t>(blocks) * tile < n ||
      static_cast<int64_t>(blocks - 1) * tile >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ct)) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec == 8 ? launch<uint16_t, 8>(out, ct, ids, length, n, d, tile, blocks, st)
                    : launch<uint16_t, 1>(out, ct, ids, length, n, d, tile, blocks, st);
  }
  return vec == 4 ? launch<float, 4>(out, ct, ids, length, n, d, tile, blocks, st)
                  : launch<float, 1>(out, ct, ids, length, n, d, tile, blocks, st);
}

}  // extern "C"
