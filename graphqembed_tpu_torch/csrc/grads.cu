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
// Two routes, picked by L alone (ops/grads.py::scatter_launch):
//   - the cluster route (gqe_scatter_rows, below), up to the crossover of
//     12,288 ids (four passes). Every cluster reads every id, so its work
//     grows as clusters x passes: 13.3 ms for 2,621,440 ids on the
//     [100320, 128] float32 table, where one CTA also sums a run of 133,507
//     padded ids on row 0 alone.
//   - the bucket route (gqe_scatter_rows_bucket, further down), above it:
//     a stable partition of the positions by tile, then sums in which each
//     CTA reads one tile's segment, and the tiles with many entries are
//     split into column slices over several CTAs; its work grows as L + n,
//     with a fixed cost of some 40 us (the partition's two grid barriers
//     and its per-chunk steps), which the cluster route beats up to four
//     passes on the tables the train paths use (PERF.md).
//
// The cluster route. No global sort runs (PyTorch's sort of 2,560 int64 keys alone takes
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
struct Acc<uint16_t, 2> {  // bfloat16, one bf16x2 word
  using Piece = uint32_t;
  uint32_t a;
  __device__ static Piece ld(const uint16_t* p) { return *reinterpret_cast<const uint32_t*>(p); }
  __device__ void zero() { a = 0u; }
  __device__ void set(const uint16_t* p) { a = ld(p); }
  __device__ void add(Piece x) { a = add_bf16x2(a, x); }
  __device__ void put(uint16_t* p) const { *reinterpret_cast<uint32_t*>(p) = a; }
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

// The stable rank's scan: s_rc holds each (row, warp) group's count, row by
// row and warp by warp; thread t scans (row t / 2, warps 4 (t % 2) ... + 3)
// and leaves there each group's first slot. The same pass lists the rows with
// entries in order in s_nz ({first slot << 8 | row, end}), the sum's work
// list, with how many of them each warp's rows hold (s_nzw) and which (s_hb:
// bit 2j of word w, row 16 w + j).
__device__ __forceinline__ void scan_runs(int* s_rc, int2* s_nz, int* s_scan, int* s_nzw,
                                          unsigned* s_hb) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
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
    s_hb[warp] = hb;
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
    scan_runs(s_rc, s_nz, s_scan, s_nzw, s_hb);
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

// ---- the bucket route: long id lists ----
//
// Two launches, both named scatter_rows_kernel_*: the partition (one
// cooperative launch, grid barriers between its three steps) writes each
// position, with its row in the tile, into its tile's segment, in position
// order; the sums (a persistent grid) take work items, a tile or a column
// slice of one, by ticket, the split tiles first. An item ranks its tile's
// entries by row in shared memory, stages the slice of each entry's
// cotangent row in run order with cp.async, and adds each run in position
// order; a tile's rows that no id names get zeros. Each element of g is
// still one chain of adds in position order, so the bits are the cluster
// route's and the plain version's. Bound as the cluster route (bytes); a
// long run is bound by its chain instead, one add's latency an entry
// (about 4 cycles), which the column split shares among 8 threads of each
// of up to 16 CTAs but cannot shorten.

constexpr int kChunk = 4096;                       // ids of one chunk of the partition
constexpr int kIdsPerLane = kChunk / kThreads;     // 16
constexpr int kMaxTiles = 4096;                    // most tiles the partition takes
constexpr int kList = 4096;                        // entries a CTA of the sum ranks at once
constexpr int kHalf = 36864;                       // bytes of each of the two stage buffers
constexpr int kMaxSlices = 16;                     // most column slices of one tile
constexpr int kSliceBytes = 32;                    // fewest bytes of a column slice
constexpr int kPartSmem = 24;                      // the partition's shared bytes per tile
constexpr int kCarry = 512;                        // bytes of a run's slice carried in shared memory
enum { kHeavy, kLight, kTicket, kSplitRuns, kCtrl };  // the words of ctrl
static_assert(kIdsPerLane * kThreads == kChunk && kList <= 4096, "slots pack 12 bits");

// The keys of one chunk's ids: lane l of warp w holds positions
// p0 + 32 k (p0 = chunk start + w kChunk / kWarps + l), key = tile << 7 | row
// in the tile, or -1 past the end or for an id outside [0, n).
__device__ __forceinline__ void chunk_keys(int* key, const int64_t* __restrict__ ids,
                                           int64_t length, int64_t n, int tile, int64_t p0) {
  int64_t id[kIdsPerLane];
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k)  // every load in flight at once: no branch
    id[k] = ids[min(p0 + k * 32, length - 1)];
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k) {
    const int v = static_cast<int>(id[k]);
    key[k] = p0 + k * 32 < length && id[k] >= 0 && id[k] < n ? (v / tile) << 7 | (v % tile) : -1;
  }
}

// The lanes whose value equals this lane's, among the lanes with ok set; v
// in [0, 2^bits), one ballot a bit (__match_any_sync's equal, in a fixed
// bits + 1 steps whatever the number of distinct values).
__device__ __forceinline__ unsigned match_bits(int v, bool ok, int bits) {
  unsigned m = __ballot_sync(kFull, ok);
  for (int b = 0; b < bits; ++b) {
    const bool on = v >> b & 1;
    const unsigned w = __ballot_sync(kFull, on);
    m &= on ? w : ~w;
  }
  return m;
}

// s_wc[tile * kWarps + warp] += this warp's keys in the tile.
__device__ __forceinline__ void count_keys(const int* key, uint16_t* s_wc, int warp, int lane,
                                           int bits) {
#pragma unroll
  for (int k = 0; k < kIdsPerLane; ++k) {
    const int t = key[k] >> 7;
    const unsigned mm = match_bits(t, t >= 0, bits);
    if (t >= 0 && lane == __ffs(mm) - 1) s_wc[t * kWarps + warp] += __popc(mm);
    __syncwarp();
  }
}

__device__ __forceinline__ int sum_halves(uint4 w) {
  return (w.x & 0xFFFF) + (w.x >> 16) + (w.y & 0xFFFF) + (w.y >> 16) + (w.z & 0xFFFF) +
         (w.z >> 16) + (w.w & 0xFFFF) + (w.w >> 16);
}

// The stable partition of the positions by tile, one cooperative launch:
//   1. each chunk of kChunk ids counts its ids per tile (cnt[chunk][tile]);
//   2. a warp per tile turns its column of counts into each chunk's first
//      slot within the tile (an exclusive scan, chunk by chunk), totals the
//      tile (tot) and lists the sum's work items: (tile, column slice), the
//      slices as many as the tile's bytes over item_bytes (at most
//      max_slices, each at least slice_min pieces), tiles of one slice in
//      the light list, the others in the heavy one, which the sum takes
//      first;
//   3. each CTA scans the totals into the tiles' first slots (base), and each
//      chunk writes its positions, pos << 7 | row, into its tiles' segments:
//      per warp a contiguous range, ranked in order (match_bits) after the
//      scan of the (tile, warp) counts, so every segment lists its
//      positions in order.
// ctrl is zeroed here for the sum (its lists' lengths and its ticket).
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel_bucket(const int64_t* __restrict__ ids, int64_t length, int64_t n,
                               int tile, int tiles, int chunks, int* __restrict__ cnt,
                               unsigned* __restrict__ sorted, int* __restrict__ tot,
                               int* __restrict__ base, int2* __restrict__ items,
                               int* __restrict__ ctrl, int groups, int slice_min, int max_slices,
                               int64_t item_bytes, int row_bytes) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  uint16_t* s_wc = reinterpret_cast<uint16_t*>(s_dyn);  // per (tile, warp): count, then offset
  uint4* s_wc4 = reinterpret_cast<uint4*>(s_dyn);        // a tile's eight
  int* s_base = reinterpret_cast<int*>(s_dyn + static_cast<size_t>(tiles) * 16);
  int* s_cb = s_base + tiles;  // this chunk's first slot in each tile
  __shared__ int s_scan[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t lane0 = static_cast<int64_t>(warp) * (kChunk / kWarps) + lane;
  const int bits = 32 - __clz(tiles - 1 | 1);  // a tile's bits
  int key[kIdsPerLane];

  if (blockIdx.x == 0 && tid < kCtrl) ctrl[tid] = 0;
  // 1. counts
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    chunk_keys(key, ids, length, n, tile, static_cast<int64_t>(c) * kChunk + lane0);
    for (int t = tid; t < tiles; t += kThreads) s_wc4[t] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    count_keys(key, s_wc, warp, lane, bits);
    __syncthreads();
    for (int t = tid; t < tiles; t += kThreads)
      cnt[static_cast<int64_t>(c) * tiles + t] = sum_halves(s_wc4[t]);
    __syncthreads();
  }
  grid.sync();

  // 2. each chunk's first slot within each tile, the totals, the work items
  const int heavy_cap = tiles * max_slices;
  for (int t = blockIdx.x * kWarps + warp; t < tiles; t += gridDim.x * kWarps) {
    constexpr int kAhead = 8;  // loads of the column in flight
    int run = 0;
    for (int c0 = 0; c0 < chunks; c0 += 32 * kAhead) {
      int v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int c = c0 + u * 32 + lane;
        const int x = cnt[static_cast<int64_t>(min(c, chunks - 1)) * tiles + t];
        v[u] = c < chunks ? x : 0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int c = c0 + u * 32 + lane;
        int incl = v[u];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int w = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += w;
        }
        if (c < chunks) cnt[static_cast<int64_t>(c) * tiles + t] = run + incl - v[u];
        run += __shfl_sync(kFull, incl, 31);
      }
    }
    if (lane == 0) {
      tot[t] = run;
      const int64_t want = (static_cast<int64_t>(run) * row_bytes + item_bytes - 1) / item_bytes;
      const int s_want = want < 1 ? 1 : (want > max_slices ? max_slices : static_cast<int>(want));
      int per = (groups + s_want - 1) / s_want;
      per = (per + slice_min - 1) / slice_min * slice_min;
      if (per > groups) per = groups;
      const int s = (groups + per - 1) / per;
      if (s == 1) {
        items[heavy_cap + atomicAdd(&ctrl[kLight], 1)] = make_int2(t, groups);
      } else {
        const int h = atomicAdd(&ctrl[kHeavy], s);
        for (int j = 0; j < s; ++j)
          items[h + j] = make_int2(t, j * per << 16 | min(groups, (j + 1) * per));
      }
    }
  }
  grid.sync();

  // 3. the tiles' first slots (every CTA), then each chunk's positions
  {
    constexpr int kPer = kMaxTiles / kThreads;  // 16: the thread's totals in registers
    const int per = (tiles + kThreads - 1) / kThreads;
    const int lo = min(tiles, tid * per), hi = min(tiles, lo + per);
    int v[kPer], sum = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int x = tot[min(lo + u, tiles - 1)];  // no branch: loads in flight at once
      v[u] = lo + u < hi ? x : 0;
      sum += v[u];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    int a = incl - sum;
    for (int w = 0; w < warp; ++w) a += s_scan[w];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (lo + u < hi) {
        s_base[lo + u] = a;
        if (blockIdx.x == 0) base[lo + u] = a;
      }
      a += v[u];
    }
    if (blockIdx.x == 0 && tid == kThreads - 1) base[tiles] = a;
    __syncthreads();
  }
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t p0 = static_cast<int64_t>(c) * kChunk + lane0;
    chunk_keys(key, ids, length, n, tile, p0);
    for (int t = tid; t < tiles; t += kThreads) s_wc4[t] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    count_keys(key, s_wc, warp, lane, bits);
    __syncthreads();
    {
      int first[kMaxTiles / kThreads];  // this chunk's first slot in each of the thread's tiles
#pragma unroll
      for (int u = 0; u < kMaxTiles / kThreads; ++u) {
        const int t = tid + u * kThreads;
        first[u] = cnt[static_cast<int64_t>(c) * tiles + min(t, tiles - 1)];
      }
#pragma unroll
      for (int u = 0; u < kMaxTiles / kThreads; ++u) {
        const int t = tid + u * kThreads;
        if (t < tiles) {  // counts -> offsets, warp by warp
          uint4 w = s_wc4[t];
          unsigned h[kWarps] = {w.x & 0xFFFF, w.x >> 16, w.y & 0xFFFF, w.y >> 16,
                                w.z & 0xFFFF, w.z >> 16, w.w & 0xFFFF, w.w >> 16};
          unsigned a = 0;
#pragma unroll
          for (int k = 0; k < kWarps; ++k) {
            const unsigned x = h[k];
            h[k] = a;
            a += x;
          }
          s_wc4[t] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                                h[6] | h[7] << 16);
          s_cb[t] = s_base[t] + first[u];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kIdsPerLane; ++k) {
      const int t = key[k] >> 7;
      const unsigned mm = match_bits(t, t >= 0, bits);
      if (t >= 0)
        sorted[s_cb[t] + s_wc[t * kWarps + warp] + __popc(mm & lt)] =
            static_cast<unsigned>(p0 + k * 32) << 7 | static_cast<unsigned>(key[k] & 127);
      __syncwarp();
      if (t >= 0 && lane == __ffs(mm) - 1) s_wc[t * kWarps + warp] += __popc(mm);
      __syncwarp();
    }
    __syncthreads();
  }
}

// acc += count pieces at src, src + stride, ... in order, the next U
// pieces' loads issued before the adds of these U (two register sets in
// turn, so no copies between them): 16 of a word, 8 of 16 bytes.
template <typename A, typename T>
__device__ __forceinline__ void add_chain(A& acc, const T* src, int stride, int count) {
  using P = typename A::Piece;
  constexpr int U = sizeof(P) <= 4 ? 16 : 8;
  P x[U], y[U];
  auto load = [&](P* r, int q) {
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = A::ld(src + (q + u) * stride);
  };
  auto add = [&](const P* r) {
#pragma unroll
    for (int u = 0; u < U; ++u) acc.add(r[u]);
  };
  int q = 0;
  if (count >= U) {
    load(x, 0);
    for (q = U; q + 2 * U <= count; q += 2 * U) {
      load(y, q);
      add(x);
      load(x, q + U);
      add(y);
    }
    if (q + U <= count) {
      load(y, q);
      add(x);
      add(y);
      q += U;
    } else {
      add(x);
    }
  }
  for (; q < count; ++q) acc.add(A::ld(src + q * stride));
}

// The even bits of x (bit 2j to bit j).
__device__ __forceinline__ unsigned even_bits(unsigned x) {
  x &= 0x55555555u;
  x = (x | x >> 1) & 0x33333333u;
  x = (x | x >> 2) & 0x0F0F0F0Fu;
  x = (x | x >> 4) & 0x00FF00FFu;
  return (x | x >> 8) & 0x0000FFFFu;
}

template <typename B>
struct Use {  // an accumulator type, handed to a generic lambda
  using type = B;
};

// The sums, a persistent grid taking work items by ticket, the heavy list's
// first. An item is a tile and a slice of its column pieces [p0, p1); it
// reads the tile's segment alone, in lists of up to kList entries in
// position order, ranks each list by row (scatter_rows_kernel's step 4,
// with match_bits and scan_runs),
// and stages the slice of each entry's cotangent row in run order, in
// sub-batches of up to kHalf bytes, two buffers, cp.async filling one while
// the other is summed. Each (run, unit) item adds its run's entries of the
// sub-batch in order, a unit 16 bytes of the row, or 4 on a split tile, so
// that a long run's chain is spread over as many threads as its slice has
// words and each runs at the add's latency. A run that goes on into the next
// sub-batch leaves its partial sum in shared memory (s_carry, rows of up to
// kCarry bytes), one that goes on from an earlier list reads it back from g,
// so each element is one chain in position order. Rows that no id names get
// zeros at the end. A tile of more than one slice adds its rows with entries
// to ctrl[kSplitRuns].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    scatter_rows_kernel_sum(T* __restrict__ out, const T* __restrict__ ct,
                            const unsigned* __restrict__ sorted, const int* __restrict__ base,
                            const int2* __restrict__ items, int* __restrict__ ctrl, int64_t n,
                            int d, int tile, int heavy_cap) {
  constexpr bool kWide = sizeof(T) * VEC == 16;
  using A = Acc<T, VEC>;
  __shared__ unsigned s_ent[kList];            // the list: pos << 7 | row
  __shared__ uint16_t s_rk[kList];             // each entry's rank in its (row, warp) group
  __shared__ uint16_t s_pos[kList];            // list indices in run order
  __shared__ int s_rc[kMaxRows * kWarps];
  __shared__ int2 s_nz[kMaxRows];
  __shared__ int s_scan[kWarps], s_nzw[kWarps];
  __shared__ unsigned s_hb[kWarps];
  __shared__ unsigned s_seen[kMaxRows / 32];   // rows with entries in the lists before
  __shared__ int2 s_item;
  __shared__ __align__(16) unsigned char s_carry[2][kCarry];  // by sub-batch parity
  extern __shared__ __align__(16) unsigned char s_stage[];  // two buffers of kHalf bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int groups = d / VEC;
  const int row_bits = 32 - __clz(tile - 1 | 1);
  const int n_heavy = ctrl[kHeavy], n_items = n_heavy + ctrl[kLight];

  for (;;) {
    if (tid == 0) {
      const int k = atomicAdd(&ctrl[kTicket], 1);
      s_item = k < n_heavy   ? items[k]
               : k < n_items ? items[heavy_cap + k - n_heavy]
                             : make_int2(-1, 0);
    }
    if (tid < kMaxRows / 32) s_seen[tid] = 0u;
    __syncthreads();
    const int2 item = s_item;
    if (item.x < 0) break;
    const int p0 = item.y >> 16, np = (item.y & 0xFFFF) - p0;
    const int64_t r0 = static_cast<int64_t>(item.x) * tile;
    const int rows = static_cast<int>(n - r0 < tile ? n - r0 : tile);
    const int seg = base[item.x], total = base[item.x + 1] - seg;
    const int sw = np * VEC;  // elements of a staged entry
    const int cap = kHalf / (sw * static_cast<int>(sizeof(T)));
    const bool carry = sw * static_cast<int>(sizeof(T)) <= kCarry;
    T* const col = out + r0 * d + p0 * VEC;     // row r, piece j at col + r d + j VEC
    const T* const src = ct + p0 * VEC;

    for (int b0 = 0; b0 < total; b0 += kList) {
      const int m = min(kList, total - b0);
      {
        unsigned e[kList / kThreads];  // every load in flight at once: no branch
#pragma unroll
        for (int u = 0; u < kList / kThreads; ++u)
          e[u] = sorted[seg + b0 + min(tid + u * kThreads, m - 1)];
#pragma unroll
        for (int u = 0; u < kList / kThreads; ++u)
          if (tid + u * kThreads < m) s_ent[tid + u * kThreads] = e[u];
      }
#pragma unroll
      for (int e = 0; e < kScan; ++e) s_rc[tid * kScan + e] = 0;
      __syncthreads();
      // the stable rank: warp w ranks entries [w q, (w + 1) q) by row
      const int q = (m + kWarps - 1) / kWarps;
      const int i_hi = min((warp + 1) * q, m);
      for (int c0 = warp * q; c0 < i_hi; c0 += 32) {
        const int i = c0 + lane;
        const bool v = i < i_hi;
        const int row = v ? static_cast<int>(s_ent[i] & 127u) : 0;
        const unsigned mm = match_bits(row, v, row_bits);
        if (v) s_rk[i] = static_cast<uint16_t>(s_rc[row * kWarps + warp] + __popc(mm & lt));
        __syncwarp();
        if (v && lane == __ffs(mm) - 1) s_rc[row * kWarps + warp] += __popc(mm);
        __syncwarp();
      }
      __syncthreads();
      scan_runs(s_rc, s_nz, s_scan, s_nzw, s_hb);
      __syncthreads();
      for (int i = tid; i < m; i += kThreads)
        s_pos[s_rc[(s_ent[i] & 127u) * kWarps + i / q] + s_rk[i]] = static_cast<uint16_t>(i);
      int runs = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) runs += s_nzw[w];
      __syncthreads();

      // the list in run order, sub-batches of cap entries
      const int nsub = (m + cap - 1) / cap;
      auto stage_sub = [&](int k) {
        T* buf = reinterpret_cast<T*>(s_stage + (k & 1) * kHalf);
        const int lo = k * cap, nq = min(cap, m - lo);
        auto copy = [&](int qi, int j) {
          const T* from = src + static_cast<int64_t>(s_ent[s_pos[lo + qi]] >> 7) * d + j * VEC;
          T* to = buf + qi * sw + j * VEC;
          if constexpr (kWide) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(to)),
                         "l"(from)
                         : "memory");
          } else {
            *to = *from;
          }
        };
        if (kThreads % np == 0) {  // a thread keeps one piece
          const int j = tid % np;
          for (int qi = tid / np; qi < nq; qi += kThreads / np) copy(qi, j);
        } else {
          for (int u = tid; u < nq * np; u += kThreads) copy(u / np, u % np);
        }
        if constexpr (kWide) asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      stage_sub(0);
      for (int k = 0; k < nsub; ++k) {
        if (k + 1 < nsub) {
          stage_sub(k + 1);
          if constexpr (kWide) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else if constexpr (kWide) {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const T* buf = reinterpret_cast<const T*>(s_stage + (k & 1) * kHalf);
        const int lo = k * cap, hi = min(m, lo + cap);
        // the runs that meet [lo, hi): from the first that ends past lo to
        // the first that starts at hi or later
        int j_lo = 0, j_hi = runs;
        for (int b = runs; j_lo < b;) {
          const int mid = (j_lo + b) >> 1;
          if (s_nz[mid].y <= lo) {
            j_lo = mid + 1;
          } else {
            b = mid;
          }
        }
        for (int a = j_lo; a < j_hi;) {
          const int mid = (a + j_hi) >> 1;
          if ((s_nz[mid].x >> 8) < hi) {
            a = mid + 1;
          } else {
            j_hi = mid;
          }
        }
        // each (run, unit) item: unit = epu elements at e0 of the slice
        auto sum_runs = [&](auto use) {
          using B = typename decltype(use)::type;
          constexpr int epu = static_cast<int>(sizeof(typename B::Piece) / sizeof(T));
          const int units = sw / epu;
          T* const next = reinterpret_cast<T*>(s_carry[k & 1]);
          const T* const prev = reinterpret_cast<const T*>(s_carry[(k + 1) & 1]);
          for (int it = tid; it < (j_hi - j_lo) * units; it += kThreads) {
            const int jr = j_lo + it / units, e0 = it % units * epu;
            const int2 run = s_nz[jr];
            const int rs = run.x >> 8, row = run.x & 0xFF;
            const int a = max(rs, lo), b = min(run.y, hi);
            T* dst = col + row * d + e0;
            B acc;
            if (a == rs && !(s_seen[row >> 5] >> (row & 31) & 1u)) {
              acc.zero();  // the row's run starts here
            } else if (carry && a > rs) {
              acc.set(prev + e0);  // from the last sub-batch
            } else {
              acc.set(dst);  // from an earlier list
            }
            add_chain(acc, buf + (a - lo) * sw + e0, sw, b - a);
            acc.put(carry && b < run.y ? next + e0 : dst);
          }
        };
        if constexpr (kWide) {
          if (np < groups) {
            sum_runs(Use<Acc<T, 4 / static_cast<int>(sizeof(T))>>{});
          } else {
            sum_runs(Use<A>{});
          }
        } else {
          sum_runs(Use<A>{});
        }
        __syncthreads();
      }
      if (tid < kMaxRows / 32)
        s_seen[tid] |= even_bits(s_hb[2 * tid]) | even_bits(s_hb[2 * tid + 1]) << 16;
      __syncthreads();
    }
    for (int v = tid; v < rows * np; v += kThreads) {  // zeros over the rows no id names
      const int r = v / np, j = v - r * np;
      if (!(s_seen[r >> 5] >> (r & 31) & 1u)) {
        A z;
        z.zero();
        z.put(col + r * d + j * VEC);
      }
    }
    if (tid == 0 && p0 == 0 && np < groups)
      atomicAdd(&ctrl[kSplitRuns], __popc(s_seen[0]) + __popc(s_seen[1]) + __popc(s_seen[2]) +
                                       __popc(s_seen[3]));
    __syncthreads();
  }
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return sms;
}

// The scratch layout of the bucket route, in int32 words from its start:
// sorted [L], cnt [chunks][tiles], tot [tiles], base [tiles + 1], then on an
// even word the items [tiles * max_slices + tiles] (int2).
struct Scratch {
  int64_t cnt, tot, base, items, words;
  Scratch(int64_t length, int tiles, int chunks, int max_slices) {
    cnt = length;
    tot = cnt + static_cast<int64_t>(chunks) * tiles;
    base = tot + tiles;
    items = (base + tiles + 1 + 1) / 2 * 2;
    words = items + 2 * (static_cast<int64_t>(tiles) * max_slices + tiles);
  }
};

template <typename T, int VEC>
int launch_bucket(void* out, const void* ct, const int64_t* ids, int64_t length, int64_t n,
                  int d, int tile, int* scratch, int64_t scratch_words, int* ctrl,
                  int64_t item_bytes, cudaStream_t st) {
  static const int part_attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(scatter_rows_kernel_bucket,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxTiles * kPartSmem);
    return e == cudaSuccess ? 0 : -static_cast<int>(e);
  }();
  static const int sum_blocks = [] {
    auto k = scatter_rows_kernel_sum<T, VEC>;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * kHalf);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 2 * kHalf);
    return e == cudaSuccess ? per_sm * sm_count() : -static_cast<int>(e);
  }();
  if (part_attr < 0) return -part_attr;
  if (sum_blocks <= 0) return sum_blocks < 0 ? -sum_blocks : static_cast<int>(cudaErrorInvalidConfiguration);

  const int tiles = static_cast<int>((n + tile - 1) / tile);
  const int chunks = static_cast<int>((length + kChunk - 1) / kChunk);
  const int groups = d / VEC;
  const int piece = VEC * static_cast<int>(sizeof(T));
  const int slice_min = piece >= kSliceBytes ? 1 : kSliceBytes / piece;
  const int max_slices = min(kMaxSlices, (groups + slice_min - 1) / slice_min);
  const Scratch sc(length, tiles, chunks, max_slices);
  if (scratch_words < sc.words) return static_cast<int>(cudaErrorInvalidValue);

  // the partition: a cooperative grid, every CTA resident for its grid syncs
  const int smem = tiles * kPartSmem;
  static int occ_smem = -1, occ_blocks = 0;
  if (smem != occ_smem) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_rows_kernel_bucket, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    occ_smem = smem;
    occ_blocks = per_sm * sm_count();
  }
  int grid = max(chunks, (tiles + kWarps - 1) / kWarps);
  if (grid > occ_blocks) grid = occ_blocks;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int* cnt = scratch + sc.cnt;
  unsigned* sorted = reinterpret_cast<unsigned*>(scratch);
  int* tot = scratch + sc.tot;
  int* base = scratch + sc.base;
  int2* items = reinterpret_cast<int2*>(scratch + sc.items);
  const int row_bytes = d * static_cast<int>(sizeof(T));
  void* args[] = {(void*)&ids,   (void*)&length,    (void*)&n,          (void*)&tile,
                  (void*)&tiles, (void*)&chunks,    (void*)&cnt,        (void*)&sorted,
                  (void*)&tot,   (void*)&base,      (void*)&items,      (void*)&ctrl,
                  (void*)&groups, (void*)&slice_min, (void*)&max_slices, (void*)&item_bytes,
                  (void*)&row_bytes};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(scatter_rows_kernel_bucket),
                                              dim3(grid), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int heavy_cap = tiles * max_slices;
  scatter_rows_kernel_sum<T, VEC><<<sum_blocks, kThreads, 2 * kHalf, st>>>(
      static_cast<T*>(out), static_cast<const T*>(ct), sorted, base, items, ctrl, n, d, tile,
      heavy_cap);
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

// The bucket route (ops/grads.py picks it for long id lists): the same
// gradient from two launches, the partition and the sums. length: 1 to
// 2^25 - 1 ids; tile: rows per tile, 1 to 128, and ceil(n / tile) at most
// kMaxTiles; a row of d elements fits one stage buffer (kHalf bytes);
// scratch: int32 words, at least Scratch(...).words; ctrl: kCtrl int32 words,
// of which ctrl[kSplitRuns] ends as the count of runs summed by more than one
// CTA; item_bytes: the cotangent bytes a work item aims at.
int gqe_scatter_rows_bucket(void* out, const void* ct, int is_bf16, const void* ids,
                            int64_t length, int64_t n, int d, int vec, int tile, void* scratch,
                            int64_t scratch_words, void* ctrl, int64_t item_bytes, void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  const int64_t row_bytes = static_cast<int64_t>(d) * (is_bf16 ? 2 : 4);
  if (d <= 0 || n <= 0 || length <= 0 || length >= (int64_t{1} << 25) ||
      (vec != 1 && vec != wide) || d % vec != 0 || row_bytes > kHalf || tile < 1 ||
      tile > kMaxRows || (n + tile - 1) / tile > kMaxTiles || item_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec > 1 && ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ct)) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* id = static_cast<const int64_t*>(ids);
  int* sc = static_cast<int*>(scratch);
  int* cw = static_cast<int*>(ctrl);
  if (is_bf16) {
    return vec == 8 ? launch_bucket<uint16_t, 8>(out, ct, id, length, n, d, tile, sc,
                                                 scratch_words, cw, item_bytes, st)
                    : launch_bucket<uint16_t, 1>(out, ct, id, length, n, d, tile, sc,
                                                 scratch_words, cw, item_bytes, st);
  }
  return vec == 4 ? launch_bucket<float, 4>(out, ct, id, length, n, d, tile, sc, scratch_words,
                                            cw, item_bytes, st)
                  : launch_bucket<float, 1>(out, ct, id, length, n, d, tile, sc, scratch_words,
                                            cw, item_bytes, st);
}

}  // extern "C"
