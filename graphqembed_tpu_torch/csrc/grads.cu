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
// Bound by bytes: the n*d gradient written once, the L*d cotangent and the
// ids read once (9.7 MB for the bf16 [35200, 128] table at L = 2,560: 2.89
// us at 3.35 TB/s). The zeros are nearly all of those bytes; the time goes
// to the chain of dependent steps that find and sum each row's entries,
// which waits on memory wherever the zeros' stores crowd it (PERF.md).
//
// No global sort runs (PyTorch's sort of 2,560 int64 keys alone takes
// longer than the whole pass). Each CTA owns a tile of up to kMaxRows rows
// and sums only the entries in its tile, in shared memory; a cluster of
// kCluster CTAs owns kCluster consecutive tiles, so that each id is read
// once per cluster and not once per tile:
//   1. CTA k of a cluster reads the k-th of kCluster slices of a pass of up
//      to kPass ids (at most 2 a thread) and pushes each id that falls in
//      the cluster's rows into its destination CTA's shared memory
//      (distributed shared memory), in the part kept for source k, in
//      position order (per-warp ballots, then the counts of the (chunk,
//      warp) groups before), and its counts to every CTA of the cluster.
//      One cluster barrier publishes the pushes.
//   2. Each CTA reads its list in source order, which is position order.
//   3. On the 16-byte route each source then copies the cotangent row of
//      each entry it pushed into the destination's stage in shared memory,
//      one bulk copy (TMA) per row, completing on the destination's
//      mbarrier, for the first kStage bytes of each list, so that a tile
//      many ids name does not fetch all its rows alone (on the route of
//      single elements each CTA copies its own rows). A longer list goes in
//      batches, which the CTA stages itself with cp.async.
//   4. A parallel stable rank by row: each warp ranks a contiguous range of
//      the list (__match_any_sync) and counts per (row, warp); one
//      block-wide exclusive scan of the counts, row-major, gives each entry
//      its slot in its row's run, which lists the entries in position order,
//      and lists the rows with entries. Then the threads write zeros over
//      the rows that no id names, 16-byte stores, so that every byte of g
//      is written once (no row gets both zeros and a sum; with L > kPass a
//      row zeroed in the first pass may get a sum in a later one, after the
//      barriers between passes). Issued here, after the chain's loads,
//      the stores delay it least (PERF.md).
//   5. Each (row with entries, column piece) item adds its run in order
//      from shared memory, two 16-byte pieces of the row per thread where
//      the row has an even number of them, four entries' loads ahead of
//      their adds, and writes the sums. bfloat16 adds go two at a time
//      (add.rn.bf16x2: one rounding of the exact sum, which for two
//      bfloat16 operands is float32 addition rounded to bfloat16, as
//      PyTorch's and XLA's bfloat16 adds compute it). A run that continues
//      in a later batch or pass (L > kPass) reads its partial sum back and
//      goes on, so the bits are those of one sum.
// Tiles of up to 128 rows at 75 KB of shared memory give three CTAs per SM
// (280 CTAs for the bench table, one wave), and the bench batches' busiest
// tile (178 entries) fits one batch of the stage. A last cluster barrier
// keeps every CTA until no copy into its memory is in flight. The order of
// every sum is the ids' position order, so every run gives the same bits
// (CUDA's index_add_ adds with float atomics in whatever order its threads
// meet). The launch geometry is ops/grads.py::scatter_launch.
//
// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for a geometry it does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                   // CTAs per cluster: the portable maximum
constexpr int kMaxRows = 128;                 // most rows of the gradient per CTA
constexpr int kPerThread = 2;                 // ids a thread reads per pass
constexpr int kSlice = 384;                   // most ids a CTA reads per pass
constexpr int kPass = kCluster * kSlice;       // ids a cluster reads per pass: 3,072
constexpr int kStage = 51200;                 // bytes of staged cotangent rows (dynamic)
constexpr int kScan = kMaxRows * kWarps / kThreads;  // (row, warp) counts a thread scans
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kScan == 4 && kWarps == 8, "the scan gives each row two threads of 4 counts");
static_assert(kPass <= 4096 && kMaxRows <= 256, "entries pack 12 bits of position, 8 of row");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a + b for two pairs of bfloat16, each sum rounded to nearest even. Both
// operands are bfloat16, so their float32 sum is exact wherever the rounding
// could depend on it: this equals float32 addition rounded to bfloat16, as
// PyTorch's and XLA's bfloat16 adds compute it.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The running sum of VEC consecutive elements of a gradient row, rounded
// to the storage type after every add. Piece is what one load brings.
template <typename T, int VEC>
struct Acc;

template <>
struct Acc<uint16_t, 8> {  // bfloat16, 16 bytes: four bf16x2 words
  using Piece = uint4;
  uint4 a;
  __device__ static Piece ld(const uint16_t* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ void zero() { a = make_uint4(0u, 0u, 0u, 0u); }
  __device__ void set(const uint16_t* p) { a = ld(p); }
  __device__ void add(Piece x) {
    a.x = add_bf16x2(a.x, x.x);
    a.y = add_bf16x2(a.y, x.y);
    a.z = add_bf16x2(a.z, x.z);
    a.w = add_bf16x2(a.w, x.w);
  }
  __device__ void put(uint16_t* p) const { *reinterpret_cast<uint4*>(p) = a; }
};

template <>
struct Acc<float, 4> {  // float32, 16 bytes
  using Piece = float4;
  float4 a;
  __device__ static Piece ld(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ void zero() { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ void set(const float* p) { a = ld(p); }
  __device__ void add(Piece x) {
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  __device__ void put(float* p) const { *reinterpret_cast<float4*>(p) = a; }
};

template <>
struct Acc<float, 1> {
  using Piece = float;
  float a;
  __device__ static Piece ld(const float* p) { return *p; }
  __device__ void zero() { a = 0.0f; }
  __device__ void set(const float* p) { a = *p; }
  __device__ void add(Piece x) { a += x; }
  __device__ void put(float* p) const { *p = a; }
};

template <>
struct Acc<uint16_t, 1> {  // one bfloat16, summed in float32 and rounded
  using Piece = uint16_t;
  float a;
  __device__ static Piece ld(const uint16_t* p) { return *p; }
  __device__ void zero() { a = 0.0f; }
  __device__ void set(const uint16_t* p) { a = __uint_as_float(static_cast<uint32_t>(*p) << 16); }
  __device__ void add(Piece x) {
    a = __bfloat162float(__float2bfloat16_rn(a + __uint_as_float(static_cast<uint32_t>(x) << 16)));
  }
  __device__ void put(uint16_t* p) const {
    *p = static_cast<uint16_t>(__float_as_uint(a) >> 16);  // a is bf16 already
  }
};

// Copy the cotangent rows of list entries [b0, b0 + nb) into s_ct, row i of
// the batch at s_ct + i * d, one VEC-element piece per step: 16-byte
// cp.async copies (completed by cp.async.wait_all) where VEC elements are
// 16 bytes, plain copies for VEC = 1. at(i) is list entry i.
template <typename T, int VEC, typename At>
__device__ __forceinline__ void stage(T* s_ct, const T* __restrict__ ct, At at, int64_t base,
                                      int b0, int nb, int d, int groups) {
  auto copy = [&](int i, int c) {
    const T* src = ct + (base + ((at(b0 + i) >> 8) & 0xFFF)) * d + c;
    if constexpr (sizeof(T) * VEC == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s_ct + i * d + c)),
                   "l"(src)
                   : "memory");
    } else {
      s_ct[i * d + c] = *src;
    }
  };
  if (kThreads % groups == 0) {  // a thread keeps one column piece
    const int c = (static_cast<int>(threadIdx.x) % groups) * VEC;
    for (int i = threadIdx.x / groups; i < nb; i += kThreads / groups) copy(i, c);
  } else {
    for (int u = threadIdx.x; u < nb * groups; u += kThreads) copy(u / groups, u % groups * VEC);
  }
}

// acc[k] += piece k (at src + k * far) of the staged rows of U consecutive
// run entries, for K pieces; all loads ahead of the adds, which go in run
// order.
template <typename A, int U, int K, typename T>
__device__ __forceinline__ void add_run(A* acc, const T* src, int far, const uint16_t* pos,
                                        int b0, int d) {
  typename A::Piece x[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* row = src + (pos[u] - b0) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) x[u][k] = A::ld(row + k * far);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k].add(x[u][k]);
}

// The first index in [lo, hi) whose value in the ascending a is at least v.
__device__ __forceinline__ int first_at_least(const uint16_t* a, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 3)
    scatter_rows_kernel(T* __restrict__ out, const T* __restrict__ ct,
                        const int64_t* __restrict__ ids, int64_t length, int64_t n, int d,
                        int tile) {
  constexpr bool kWide = sizeof(T) * VEC == 16;
  __shared__ int s_in[kCluster * kSlice];     // entries pushed by each source CTA, in turn:
                                              // rank << 20 | position in the pass << 8 | row
  __shared__ int s_cnt[kCluster][kCluster];   // entries source s pushed to CTA e
  __shared__ __align__(8) uint64_t s_bar;     // the first batch's rows have landed
  __shared__ uint16_t s_pos[kPass];           // list indices grouped by row
  __shared__ int s_rc[kMaxRows * kWarps];     // per (row, warp): count, then first slot
  __shared__ int s_wc[kPerThread * kWarps][kCluster];  // per (chunk, warp, destination) counts
  __shared__ int s_scan[kWarps];
  __shared__ int2 s_nz[kMaxRows];             // rows with entries, in order: {p0 << 8 | row, p1}
  __shared__ int s_nzw[kWarps];               // how many in each warp's rows of the scan
  __shared__ unsigned s_hb[kWarps];           // which of them: bit 2j, row 16 w + j
  extern __shared__ __align__(16) unsigned char s_stage[];  // kStage: a batch's ct rows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t c_r0 = r0 - static_cast<int64_t>(rank) * tile;  // the cluster's first row
  const int rows = static_cast<int>(n - r0 < tile ? (n > r0 ? n - r0 : 0) : tile);
  const int groups = d / VEC;
  const int cap = kStage / (d * static_cast<int>(sizeof(T)));
  T* s_ct = reinterpret_cast<T*>(s_stage);
  using A = Acc<T, VEC>;

  if (kWide && tid == 0) {  // published to the cluster by the barrier after the pushes
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&s_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster runs before any pushes into another's memory
  cluster_arrive_relaxed();

  // 0. on the route of single elements, zeros over the whole tile now (the
  // rows some id names are written again in step 5, after barriers that
  // order the two); the wide route writes its zeros in step 4.
  if constexpr (!kWide) {
    for (int v = tid; v < rows * d; v += kThreads) out[r0 * d + v] = T{};
  }

  for (int64_t base = 0, pass = 0;; base += kPass, ++pass) {
    const int seg = static_cast<int>(length - base < kPass ? length - base : kPass);
    const int slice = (seg + kCluster - 1) / kCluster;
    const int p_lo = rank * slice;
    const int p_hi = p_lo + slice < seg ? p_lo + slice : seg;

    // 1. this CTA's slice of the pass; the ids in the cluster's rows go to
    // their destination CTA's memory, each source's entries for a
    // destination in position order (per-warp ballots, then the counts of
    // the (chunk, warp) groups before).
    int64_t my[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int p = p_lo + k * kThreads + tid;
      my[k] = p < p_hi ? ids[base + p] - c_r0 : -1;
    }
#pragma unroll
    for (int e = 0; e < kScan; ++e) s_rc[tid * kScan + e] = 0;
    int dest[kPerThread], slot[kPerThread];
    unsigned mine[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool in = my[k] >= 0 && my[k] < static_cast<int64_t>(kCluster) * tile;
      dest[k] = in ? static_cast<int>(my[k]) / tile : -1;
      unsigned count = 0;
      mine[k] = 0;
#pragma unroll
      for (int e = 0; e < kCluster; ++e) {
        const unsigned b = __ballot_sync(kFull, dest[k] == e);
        if (dest[k] == e) mine[k] = b;
        if (lane == e) count = __popc(b);
      }
      if (lane < kCluster) s_wc[k * kWarps + warp][lane] = count;
    }
    __syncthreads();
    if (base == 0) cluster_wait();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (dest[k] < 0) continue;
      const int j = k * kWarps + warp;
      slot[k] = __popc(mine[k] & lt);
#pragma unroll
      for (int jj = 0; jj < kPerThread * kWarps; ++jj) slot[k] += jj < j ? s_wc[jj][dest[k]] : 0;
      cluster.map_shared_rank(s_in, dest[k])[rank * kSlice + slot[k]] =
          ((p_lo + k * kThreads + tid) << 8) |
          static_cast<int>(my[k] - static_cast<int64_t>(dest[k]) * tile);
    }
    if (tid < kCluster * kCluster) {  // this slice's counts to every CTA of the cluster
      const int e = tid % kCluster;
      int total = 0;
#pragma unroll
      for (int jj = 0; jj < kPerThread * kWarps; ++jj) total += s_wc[jj][e];
      cluster.map_shared_rank(&s_cnt[0][0], tid / kCluster)[rank * kCluster + e] = total;
    }
    cluster.sync();

    // 2. this CTA's list: the sources' entries in rank order, which is
    // position order; entry i lies in source s's part, pre[s] <= i < pre[s+1].
    int pre[kCluster + 1];
    pre[0] = 0;
#pragma unroll
    for (int s = 0; s < kCluster; ++s) pre[s + 1] = pre[s] + s_cnt[s][rank];
    const int m = pre[kCluster];
    auto slot_of = [&](int i) {  // where list entry i lies in s_in
      int off = i;
#pragma unroll
      for (int s = 1; s < kCluster; ++s)
        if (i >= pre[s]) off = s * kSlice + i - pre[s];
      return off;
    };
    auto at = [&](int i) { return s_in[slot_of(i)]; };

    // 3. the first batch's cotangent rows on their way to shared memory: on
    // the wide route each source CTA copies the rows of the entries it
    // pushed (list index < cap at their destination), one bulk copy (TMA)
    // each, into the destination's stage, completing on its mbarrier.
    int nb = m < cap ? m : cap;
    if constexpr (kWide) {
      const unsigned row_bytes = static_cast<unsigned>(d * sizeof(T));
      if (tid == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_addr(&s_bar)),
                     "r"(static_cast<unsigned>(nb) * row_bytes)
                     : "memory");
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (dest[k] < 0) continue;
        int i = slot[k];
        for (int s = 0; s < rank; ++s) i += s_cnt[s][dest[k]];
        if (i >= cap) continue;
        unsigned dst, bar;
        asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_addr(s_ct + i * d)),
            "r"(dest[k]));
        asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(bar) : "r"(smem_addr(&s_bar)),
            "r"(dest[k]));
        const T* src = ct + (base + p_lo + k * kThreads + tid) * d;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(dst),
            "l"(src), "r"(row_bytes), "r"(bar)
            : "memory");
      }
    } else {
      stage<T, VEC>(s_ct, ct, at, base, 0, nb, d, groups);
    }

    // 4. the stable rank: warp w ranks list entries [w*q, (w+1)*q) by row
    // and counts them per (row, w); the exclusive scan of the counts, row
    // by row and warp by warp, is each (row, w) group's first slot.
    const int q = (m + kWarps - 1) / kWarps;
    const int i_hi = (warp + 1) * q < m ? (warp + 1) * q : m;
    for (int c0 = warp * q; c0 < i_hi; c0 += 32) {
      const int i = c0 + lane;
      const bool v = i < i_hi;
      const int off = v ? slot_of(i) : 0;
      const int row = v ? s_in[off] & 0xFF : 0;
      const unsigned mm = __match_any_sync(kFull, v ? row : -1 - lane);
      if (v)
        s_in[off] |= static_cast<int>(
            static_cast<unsigned>(s_rc[row * kWarps + warp] + __popc(mm & lt)) << 20);
      __syncwarp();
      if (v && lane == __ffs(mm) - 1) s_rc[row * kWarps + warp] += __popc(mm);
      __syncwarp();
    }
    __syncthreads();
    {
      // thread t scans (row t / 2, warps 4 (t % 2) ... + 3); the same pass
      // lists the rows with entries in order (s_nz), the sum's work list
      int c[kScan], sum = 0;
#pragma unroll
      for (int e = 0; e < kScan; ++e) {
        c[e] = s_rc[tid * kScan + e];
        sum += c[e];
      }
      const int pair = sum + __shfl_xor_sync(kFull, sum, 1);  // the row's entries
      const bool has = (lane & 1) == 0 && pair > 0;
      const unsigned hb = __ballot_sync(kFull, has);
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) {
        s_scan[warp] = incl;
        s_nzw[warp] = __popc(hb);
        s_hb[warp] = hb;  // bit 2j: row 16 warp + j has entries
      }
      __syncthreads();
      int a = incl - sum, nz = __popc(hb & lt);
      for (int w = 0; w < warp; ++w) {
        a += s_scan[w];
        nz += s_nzw[w];
      }
      if (has) s_nz[nz] = make_int2(a << 8 | tid >> 1, a + pair);  // the row's run
#pragma unroll
      for (int e = 0; e < kScan; ++e) {
        s_rc[tid * kScan + e] = a;
        a += c[e];
      }
    }
    __syncthreads();
    if (kWide && base == 0) {  // zeros over the rows that no id names
      const int per_row = d * static_cast<int>(sizeof(T)) / 16;
      uint4* g = reinterpret_cast<uint4*>(out + r0 * d);
      for (int v = tid; v < rows * per_row; v += kThreads) {
        const int r = v / per_row;
        if (!(s_hb[r >> 4] >> (2 * (r & 15)) & 1u)) g[v] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = tid; i < m; i += kThreads) {
      const int e = at(i);
      s_pos[s_rc[(e & 0xFF) * kWarps + i / q] + (static_cast<unsigned>(e) >> 20)] =
          static_cast<uint16_t>(i);
    }
    if constexpr (kWide) {  // the first batch's rows, from their sources
      unsigned landed = 0;
      while (!landed)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(landed)
            : "r"(smem_addr(&s_bar)), "r"(static_cast<unsigned>(pass & 1))
            : "memory");
    } else {
      stage_wait();
    }
    __syncthreads();
    const bool last = base + kPass >= length;
    if (last) cluster_arrive_relaxed();  // every copy into this CTA's memory has landed

    // 5. the list in batches of up to `cap` entries: each (row with
    // entries, column piece) item adds its run's entries that fall in the
    // batch, in order, VEC columns at a time and two pieces of the row at
    // once where the row has an even number of them, rounding every sum to
    // the dtype, and writes the sums. A run that goes on from an earlier
    // batch or pass reads its partial sum back and continues it.
    const int pieces = groups % 2 == 0 ? 2 : 1, half = groups / pieces;
    int items = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) items += s_nzw[w];
    items *= half;
    for (int b0 = 0; b0 < m; b0 += cap) {
      if (b0 > 0) {
        nb = m - b0 < cap ? m - b0 : cap;
        __syncthreads();  // every thread is done with the last batch's stage
        stage<T, VEC>(s_ct, ct, at, base, b0, nb, d, groups);
        stage_wait();
        __syncthreads();
      }
      for (int t = tid; t < items; t += kThreads) {
        const int jr = t / half;
        const int2 run = s_nz[jr];
        const int lr = run.x & 0xFF, p0 = run.x >> 8, p1 = run.y;
        // the run's entries in this batch, [q0, q1) (all of it in one batch)
        int q0 = p0, q1 = p1;
        if (m > cap) {  // the run lists its entries in order: two binary searches
          q0 = first_at_least(s_pos, p0, p1, b0);
          q1 = first_at_least(s_pos, q0, p1, b0 + nb);
          if (q0 == q1) continue;
        }
        const int c0 = (t - jr * half) * VEC;
        T* dst = out + (r0 + lr) * d + c0;
        const T* src = s_ct + c0;  // entry i of the batch at src + (i - b0) * d
        const int far = half * VEC;  // the second piece's offset
        A acc[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (k < pieces) {
            if (base == 0 && q0 == p0) {  // the run starts here
              acc[k].zero();
            } else {
              acc[k].set(dst + k * far);
            }
          }
        }
        int p = q0;
        if (pieces == 2) {
          for (; p + 4 <= q1; p += 4) add_run<A, 4, 2>(acc, src, far, s_pos + p, b0, d);
          for (; p < q1; ++p) add_run<A, 1, 2>(acc, src, far, s_pos + p, b0, d);
        } else {
          for (; p + 4 <= q1; p += 4) add_run<A, 4, 1>(acc, src, far, s_pos + p, b0, d);
          for (; p < q1; ++p) add_run<A, 1, 1>(acc, src, far, s_pos + p, b0, d);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (k < pieces) acc[k].put(dst + k * far);
      }
    }
    if (last) {
      cluster_wait();  // so no copy this CTA issued is still in flight when it exits
      break;
    }
    cluster.sync();  // every CTA is done with its entries before the next pushes
  }
}

template <typename T, int VEC>
int launch(void* out, const void* ct, const void* ids, int64_t length, int64_t n, int d,
           int tile, unsigned int blocks, cudaStream_t st) {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_rows_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStage);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(scatter_rows_kernel<T, VEC>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
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
// out and ct 16-byte aligned.
// tile: rows per CTA, 1 to 128; blocks: ceil(n / tile) rounded up to a
// multiple of the cluster (8), one CTA per tile, the last tiles empty; a row
// of d elements fits the stage (kStage bytes).
int gqe_scatter_rows(void* out, const void* ct, int is_bf16, const void* ids, int64_t length,
                     int64_t n, int d, int vec, int tile, unsigned int blocks, void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  const int64_t row_bytes = static_cast<int64_t>(d) * (is_bf16 ? 2 : 4);
  if (d <= 0 || n <= 0 || length < 0 || (vec != 1 && vec != wide) || d % vec != 0 ||
      row_bytes > kStage || tile < 1 || tile > kMaxRows || blocks == 0 ||
      blocks % kCluster != 0 || static_cast<int64_t>(blocks) * tile < n ||
      static_cast<int64_t>(blocks - kCluster) * tile >= n)
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
