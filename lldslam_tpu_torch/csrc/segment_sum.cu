// Fixed-order segment sums: the solvers' out[s, c] += src[perm[i], c] for i
// from offsets[s] to offsets[s + 1] - 1, and the line detector's Hough vote
// out[b] = sum of w[i] over the pixels i of bin b with w[i] != 0; both in
// ascending row (pixel) order, one IEEE add (__fadd_rn: no contraction into
// an FMA, no reassociation) at a time.
//
// Replaces, on the card, the atomic `index_add_` of the sparse solvers of a
// loop event (global BA, the joint point+line global BA, the line refinement
// and the pose graph) and of the native detector's vote
// (lldslam_tpu_torch/ops/segment_sum.py). The JAX package writes these sums
// as XLA scatters (`.at[].add`: lldslam_tpu/optim/ba.py:104-108, 208,
// 217-222; lldslam_tpu/optim/lines_ba.py:115-119, 398-428, 542-547;
// lldslam_tpu/optim/pose_graph.py:80-84, 104-105;
// lldslam_tpu/frontend/line_extract.py:93), not as Pallas kernels. Each
// output takes its rows in ascending row order: the sequence of float adds
// of the CPU's serial `index_add_`, hence the CPU's bits, on every run. A
// tree order would be faster and would not be bit-equal.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip runs of
// tools/torch_segment_sum_ms.py). Not the bytes: a global BA's sums move a
// few hundred KB (well under a microsecond at 3.35 TB/s), the vote's passes
// a few MB. Each output is one chain of dependent adds as long as its
// segment (4 cycles an add once its operands are in registers), and each
// row of the chain needs two dependent loads (perm, then src). One warp
// cannot keep enough of those gathers in flight to feed its chains: a
// thread that prefetched its own rows (in registers or by cp.async) was
// slower than the atomics on the pose side's 287-row segments, however far
// ahead it loaded. Short segments are bound by the launch and two load
// latencies.
//
// Solver sums (lld_segment_sum). The mode comes from the shapes the host
// knows (rows O, segments n), never from a device read.
//  - Short segments (O < kShortMean n: the point side, the pose graph, the
//    line side, the dense BA's keyframe x point cells): one thread per
//    (sorted row, column); only a segment's first row works, so an empty
//    segment costs nothing. Its first kShort rows' perm and sorted segment
//    entries load together with the test of whether the row leads, so a
//    short segment costs two load latencies, like the atomic.
//  - Long segments (the pose side: 29 keyframes of ~287 observations): a
//    block per (segment, 32 columns); warp 0 holds one thread per output
//    column and adds, kProducers warps gather the rows, 32 a batch, into a
//    ring of kSlots batches in shared memory (cp.async, copies of 4 or 2
//    floats spread over all 32 lanes, so a narrow segment's idle lanes
//    copy too). Per-slot flags hand a batch from its producer to the
//    adding warp and back; no block barrier runs in the loop. A segment
//    of at most kSoloBatches batches skips the ring: warp 0 issues all of
//    its loads, then adds.
// C is a template parameter for the widths the solvers use (no division
// per float); other widths up to kMaxCols take a generic instance. Rows
// past a segment's end are padded with -0.0f, the exact identity of IEEE
// addition (x + -0 = x for every x, -0 included), so a chain needs no
// branch.
//
// The vote (lld_bin_layout, lld_bin_reduce). Most pixels do not vote (2.8%
// of a KITTI view do), so the layout is built over the voting pixels only
// and with no sort: (1) count the voting pixels of each bin (integer
// atomics, exact); (2) scan the counts into offsets in one pass over tiles
// with a decoupled look-back, listing the bins of more than kSmallBin
// pixels with their first slot and length; (3) each voting pixel takes a
// slot in its bin through an atomic cursor, in an arbitrary order; (4)
// restore the order: a thread per bin orders a short bin's pixels in
// registers (selection of the next larger index) and adds their votes; a
// long bin (a straight edge; chip_smoke.py logs the longest on a KITTI
// view of the lines world) goes to a block of its own, which ranks each
// pixel by counting the bin's pixels below it (up to kRankBin pixels) or
// marks them
// in a shared-memory bitmap window of kWindowWords x 32 pixels and ranks
// them by a popcount scan (a bin of any length and span: as many windows
// and chunks as it needs), stages the votes in that order and lets one
// thread add them. Every bin's sum starts at +0.0 and the pixels that do
// not vote add +0.0 on the CPU, which changes nothing, so the result is
// the CPU's `index_add_` over every pixel, bit for bit.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;
constexpr int kProducers = 5;        // warps that fill a long segment's ring
constexpr int kSlots = 2 * kProducers;  // ring slots of 32 rows x 32 columns
constexpr int kSoloBatches = 2;      // batches warp 0 gathers alone
constexpr int kShort = 8;            // rows a short-segment thread loads
constexpr int kShortMean = 8;        // mean rows under which rows lead
constexpr int kSpreadThreads = 32;   // block of a small grid, over more SMs
constexpr int kThreads = 128;
constexpr int kSms = 132;

__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void copy_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most n of this thread's committed copy groups are pending.
template <int n>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// A block per (segment, up to 32 columns), for long segments: lane l of
// warp 0 adds column c0 + l of segment s, acc + src[perm[r] * C + c0 + l]
// for r = offsets[s] .. offsets[s + 1] - 1, in batches of 32 rows, from a
// ring of kSlots batches in shared memory. One warp cannot keep enough
// loads in flight to feed a chain, so kProducers other warps fill the
// ring: producer p copies
// batches p, p + kProducers, ... (each lane one perm entry, shuffled to
// the warp; the 32 x w values by cp.async, in copies of vec floats spread
// over all 32 lanes), waits for its own copies and raises the slot's
// `ready` flag; warp 0 waits for the flag, adds the batch and raises
// `freed`, which the producer waits for before it refills the slot. The
// flags are per slot and per batch (batch j sets j + 1), so no block
// barrier runs in the loop; one at the start publishes the zeroed flags.
// A segment of at most kSoloBatches batches is warp 0's alone, with no
// ring and no barrier.
template <int C>
__global__ void __launch_bounds__(32 * (kProducers + 1))
    sum_long(const float* __restrict__ src, const int64_t* __restrict__ perm,
             const int64_t* __restrict__ offsets, float* __restrict__ out,
             int cols, int vec) {
  __shared__ __align__(16) float ring[kSlots][32 * 32];   // [row][column]
  __shared__ int ready[kSlots], freed[kSlots];
  const int cc = C > 0 ? C : cols;
  const int chunks = (cc + 31) >> 5;
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - s * chunks) * 32;
  const int w = cc - c0 < 32 ? cc - c0 : 32;
  const int beg = (int)offsets[s], end = (int)offsets[s + 1];
  if (beg >= end) return;
  const int batches = (end - beg + 31) >> 5;
  if (batches <= kSoloBatches) {  // warp 0 alone: every load, then the adds
    if (wib != 0) return;
    const bool on = lane < w;
    int row[kSoloBatches];
#pragma unroll
    for (int b = 0; b < kSoloBatches; ++b) {
      const int r = beg + 32 * b + lane;
      row[b] = r < end ? (int)perm[r] : 0;
    }
    float v[32 * kSoloBatches];
    const float* col = src + c0 + lane;
#pragma unroll
    for (int u = 0; u < 32 * kSoloBatches; ++u) {
      const int at = __shfl_sync(0xffffffffu, row[u >> 5], u & 31);
      v[u] = on && beg + u < end ? col[(unsigned)(at * cc)] : -0.0f;
    }
    if (on) {
      float acc = out[s * cc + c0 + lane];
#pragma unroll
      for (int u = 0; u < 32 * kSoloBatches; ++u) acc = __fadd_rn(acc, v[u]);
      out[s * cc + c0 + lane] = acc;
    }
    return;
  }
  if (threadIdx.x < kSlots) {
    ready[threadIdx.x] = 0;
    freed[threadIdx.x] = 0;
  }
  __syncthreads();
  volatile int* vready = ready;
  volatile int* vfreed = freed;
  if (wib == 0) {
    const bool on = lane < w;
    float acc = on ? out[s * cc + c0 + lane] : 0.0f;
    for (int j = 0; j < batches; ++j) {
      const int slot = j % kSlots;
      while (vready[slot] != j + 1) {
      }
      __threadfence_block();
      if (on) {
        const float* vs = ring[slot] + lane;
        const int m = end - beg - 32 * j;
        if (m >= 32) {
#pragma unroll
          for (int u = 0; u < 32; ++u) acc = __fadd_rn(acc, vs[32 * u]);
        } else {
#pragma unroll
          for (int u = 0; u < 32; ++u)
            acc = __fadd_rn(acc, u < m ? vs[32 * u] : -0.0f);
        }
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        vfreed[slot] = j + 1;
      }
    }
    if (on) out[s * cc + c0 + lane] = acc;
    return;
  }
  // the copies of a batch: group g (vec columns) of rows u0 + i R
  const int groups = w / vec, R = 32 / groups;
  const int g = lane % groups, u0 = lane / groups;
  const int steps = (32 + R - 1) / R;
  const bool copies = lane < R * groups;
  const float* col = src + c0 + g * vec;
  for (int j = wib - 1; j < batches; j += kProducers) {
    const int slot = j % kSlots;
    if (j >= kSlots)
      while (vfreed[slot] != j + 1 - kSlots) {
      }
    __threadfence_block();
    const int r = beg + 32 * j + lane;
    const int row = r < end ? (int)perm[r] : 0;
    const int m = end - beg - 32 * j;
    float* vs = ring[slot] + g * vec;
    for (int i = 0; i < steps; ++i) {
      const int u = u0 + i * R;
      const int at = __shfl_sync(0xffffffffu, row, u & 31);
      if (copies && u < m && u < 32) {
        const float* from = col + (unsigned)(at * cc);
        if (vec == 4)
          copy_async16(vs + 32 * u, from);
        else if (vec == 2)
          copy_async8(vs + 32 * u, from);
        else
          copy_async4(vs + 32 * u, from);
      }
    }
    copy_commit();
    copy_wait<0>();
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      vready[slot] = j + 1;
    }
  }
}

// A thread per (sorted row i, column c), for short segments: only the
// first row of a segment works, and adds its segment's rows (those that
// follow while ordered[r] stays the segment), kShort at a time. The first
// kShort rows' perm and ordered entries load together with the test of
// whether the row is a segment's first, so a short segment costs two load
// latencies (those, then src and out). Rows whose index lies outside
// [0, n) belong to no segment.
template <int C>
__global__ void __launch_bounds__(kThreads)
    sum_short(const float* __restrict__ src, const int64_t* __restrict__ perm,
              const int64_t* __restrict__ ordered, float* __restrict__ out,
              int rows, int n, int cols) {
  const int cc = C > 0 ? C : cols;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * cc) return;
  const int i = t / cc, c = t - i * cc;
  int64_t seg[kShort];
  int p[kShort];
  const int64_t before = i > 0 ? ordered[i - 1] : -1;
#pragma unroll
  for (int u = 0; u < kShort; ++u) {
    seg[u] = i + u < rows ? ordered[i + u] : -1;
    p[u] = i + u < rows ? (int)perm[i + u] : 0;
  }
  const int64_t s = seg[0];
  if (s < 0 || s >= n || before == s) return;
  float* o = out + s * cc + c;
  float acc = *o;
  for (int r = i;; r += kShort) {
    float v[kShort];
#pragma unroll
    for (int u = 0; u < kShort; ++u)
      v[u] = seg[u] == s ? src[(int64_t)p[u] * cc + c] : -0.0f;
#pragma unroll
    for (int u = 0; u < kShort; ++u) acc = __fadd_rn(acc, v[u]);
    if (seg[kShort - 1] != s) break;
#pragma unroll
    for (int u = 0; u < kShort; ++u) {
      const int q = r + kShort + u;
      seg[u] = q < rows ? ordered[q] : -1;
      p[u] = q < rows ? (int)perm[q] : 0;
    }
  }
  *o = acc;
}

template <int C>
cudaError_t launch_sum(const float* src, const int64_t* perm,
                       const int64_t* ordered, const int64_t* offsets,
                       float* out, int rows, int n, int cols,
                       cudaStream_t stream) {
  if (rows < (long long)kShortMean * n) {
    const long long total = (long long)rows * cols;
    const int threads = total > (long long)kSms * kThreads ? kThreads
                                                           : kSpreadThreads;
    sum_short<C><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   stream>>>(src, perm, ordered, out, rows, n, cols);
  } else {
    // copies of 4 or 2 floats where every row's columns are so aligned
    const auto at = reinterpret_cast<uintptr_t>(src);
    const int vec = cols % 4 == 0 && at % 16 == 0 ? 4
                    : cols % 2 == 0 && at % 8 == 0 ? 2 : 1;
    sum_long<C><<<(unsigned)(n * ((cols + 31) / 32)), 32 * (kProducers + 1),
                  0, stream>>>(src, perm, offsets, out, cols, vec);
  }
  return cudaGetLastError();
}

// ---- the vote ----

constexpr int kSmallBin = 16;        // pixels a thread orders in registers
constexpr int kScanThreads = 256;    // a scan tile: one int4 a thread
constexpr int kBinThreads = 256;
constexpr int kWindowWords = 4096;   // bitmap window: 131,072 pixels
constexpr int kWordsPerThread = kWindowWords / kBinThreads;
constexpr int kChunk = 4096;         // votes staged in order at once
constexpr int kRankBin = 1024;       // longer bins take the bitmap windows
static_assert(kRankBin <= kWindowWords && kRankBin <= kChunk,
              "a ranked bin's pixels and votes fit the bitmap and the stage");
constexpr int kLongBlocks = 2 * kSms;

__global__ void bin_count(const int* __restrict__ bins,
                          const float* __restrict__ w, int* __restrict__ count,
                          int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows || !(w[i] != 0.0f)) return;
  const unsigned b = (unsigned)bins[i];
  if (b < (unsigned)n) atomicAdd(count + b, 1);
}

// (count << 32) | (count > kSmallBin): one 64-bit scan gives both the
// offsets and each long bin's place in the list of long bins.
__device__ __forceinline__ unsigned long long pack(int count) {
  return ((unsigned long long)(unsigned)count << 32) |
         (unsigned long long)(count > kSmallBin);
}

// Exclusive scan of count[0 .. n4 * 4) (zero past n) into offsets, in one
// pass over tiles of kScanThreads int4 (a tile's block takes its number from
// a counter, so every tile before it has started): a block scans its tile,
// publishes the tile's sum (flag 1), adds the sums of the tiles before it,
// back to the first whose running total is published (flag 2), reading 32
// tiles at a time in one warp, and publishes its own running total.
__global__ void __launch_bounds__(kScanThreads)
    bin_scan(const int* __restrict__ count, int* __restrict__ offsets,
             int* __restrict__ long_bins, int* __restrict__ n_long,
             unsigned long long* tile_sum, unsigned long long* tile_total,
             int* flag, int n4, int tiles) {
  __shared__ unsigned long long warp_sum[kScanThreads / 32];
  __shared__ unsigned long long prefix_s;
  __shared__ int tile_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) tile_s = atomicAdd(flag + tiles, 1);
  __syncthreads();
  const int tile = tile_s;
  const int q = tile * kScanThreads + t;
  const int4 cur =
      q < n4 ? reinterpret_cast<const int4*>(count)[q] : make_int4(0, 0, 0, 0);
  const int cnt[4] = {cur.x, cur.y, cur.z, cur.w};
  const unsigned long long mine =
      pack(cnt[0]) + pack(cnt[1]) + pack(cnt[2]) + pack(cnt[3]);
  unsigned long long x = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  unsigned long long before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kScanThreads / 32; ++k) {
    before += k < warp ? warp_sum[k] : 0ull;
    total += warp_sum[k];
  }
  if (warp == 0) {  // look back over the tiles before, 32 at a time
    volatile unsigned long long* vsum = tile_sum;
    volatile unsigned long long* vtot = tile_total;
    volatile int* vflag = flag;
    unsigned long long prefix = 0;
    if (tile > 0 && lane == 0) {
      vsum[tile] = total;
      __threadfence();
      vflag[tile] = 1;
    }
    for (int j = tile - 1 - lane;; j -= 32) {
      int f = 2;
      unsigned long long v = 0;
      if (j >= 0) {
        while ((f = vflag[j]) == 0) {
        }
        __threadfence();
        v = f == 2 ? vtot[j] : vsum[j];
      }
      const unsigned done = __ballot_sync(0xffffffffu, f == 2);
      const int last = done ? __ffs(done) - 1 : 31;
      v = lane <= last ? v : 0ull;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, d);
      prefix += v;
      if (done) break;
    }
    if (lane == 0) {
      vtot[tile] = prefix + total;
      __threadfence();
      vflag[tile] = 2;
      prefix_s = prefix;
      if (tile == tiles - 1) *n_long = (int)(unsigned)(prefix + total);
    }
  }
  __syncthreads();
  if (q >= n4) return;
  unsigned long long pre = prefix_s + before + x - mine;
  int at[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    at[j] = (int)(pre >> 32);
    if (cnt[j] > kSmallBin)
      reinterpret_cast<int4*>(long_bins)[(unsigned)pre] =
          make_int4(4 * q + j, at[j], cnt[j], 0);
    pre += pack(cnt[j]);
  }
  reinterpret_cast<int4*>(offsets)[q] = make_int4(at[0], at[1], at[2], at[3]);
}

__global__ void bin_scatter(const int* __restrict__ bins,
                            const float* __restrict__ w,
                            const int* __restrict__ offsets,
                            int* __restrict__ cursor, int* __restrict__ slots,
                            int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows || !(w[i] != 0.0f)) return;
  const unsigned b = (unsigned)bins[i];
  if (b < (unsigned)n) slots[offsets[b] + atomicSub(cursor + b, 1) - 1] = i;
}

// x reduced over the block with op, returned to every thread; scratch holds
// one value a warp.
template <class Op>
__device__ __forceinline__ int block_all(int x, Op op, int* scratch) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    x = op(x, __shfl_xor_sync(0xffffffffu, x, d));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  x = scratch[0];
  for (int k = 1; k < kBinThreads / 32; ++k) x = op(x, scratch[k]);
  __syncthreads();
  return x;
}

// The sum of x over the threads before this one; *total the block's sum.
__device__ __forceinline__ int block_exclusive(int x, int* total,
                                               int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int y = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int z = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) y += z;
  }
  if (lane == 31) scratch[warp] = y;
  __syncthreads();
  int before = y - x, all = 0;
  for (int k = 0; k < kBinThreads / 32; ++k) {
    if (k < warp) before += scratch[k];
    all += scratch[k];
  }
  __syncthreads();
  *total = all;
  return before;
}

struct Min {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Blocks [0, small_blocks): a thread per bin, bins of at most kSmallBin
// voting pixels (empty bins write +0.0). Blocks past them: the long bins.
__global__ void __launch_bounds__(kBinThreads)
    bin_reduce(const float* __restrict__ w, const int* __restrict__ offsets,
               const int* __restrict__ slots,
               const int* __restrict__ long_bins,
               const int* __restrict__ n_long, float* __restrict__ out, int n,
               int small_blocks) {
  __shared__ unsigned bits[kWindowWords];
  __shared__ float staged[kChunk];
  __shared__ int scratch[kBinThreads / 32];
  const int t = threadIdx.x;
  if ((int)blockIdx.x < small_blocks) {
    const int b = blockIdx.x * kBinThreads + t;
    if (b >= n) return;
    const int beg = offsets[b], len = offsets[b + 1] - beg;
    if (len > kSmallBin) return;
    int p[kSmallBin];
    float v[kSmallBin];
#pragma unroll
    for (int u = 0; u < kSmallBin; ++u)
      p[u] = u < len ? slots[beg + u] : INT_MAX;
#pragma unroll
    for (int u = 0; u < kSmallBin; ++u) v[u] = u < len ? w[p[u]] : -0.0f;
    float acc = 0.0f;
    int last = -1;
    for (int k = 0; k < len; ++k) {  // the next larger pixel, its vote
      int best = INT_MAX;
      float bv = -0.0f;
#pragma unroll
      for (int u = 0; u < kSmallBin; ++u) {
        const bool take = p[u] > last && p[u] < best;
        best = take ? p[u] : best;
        bv = take ? v[u] : bv;
      }
      acc = __fadd_rn(acc, bv);
      last = best;
    }
    out[b] = acc;
    return;
  }
  const int total_long = *n_long;
  const int workers = gridDim.x - small_blocks;
  for (int k = blockIdx.x - small_blocks; k < total_long; k += workers) {
    const int4 e = reinterpret_cast<const int4*>(long_bins)[k];
    const int b = e.x, beg = e.y, len = e.z;
    if (len <= kRankBin) {  // each pixel's rank: the bin's pixels below it
      int* keys = reinterpret_cast<int*>(bits);
      for (int j = t; j < len; j += kBinThreads) keys[j] = slots[beg + j];
      __syncthreads();
      for (int j = t; j < len; j += kBinThreads) {
        const int key = keys[j];
        const float v = w[key];
        int rank = 0;
        for (int q = 0; q < len; ++q) rank += keys[q] < key;
        staged[rank] = v;
      }
      __syncthreads();
      if (t == 0) {
        float acc = 0.0f;
#pragma unroll 8
        for (int q = 0; q < len; ++q) acc = __fadd_rn(acc, staged[q]);
        out[b] = acc;
      }
      __syncthreads();
      continue;
    }
    int lo = INT_MAX, hi = -1;
    for (int j = t; j < len; j += kBinThreads) {
      const int q = slots[beg + j];
      lo = q < lo ? q : lo;
      hi = q > hi ? q : hi;
    }
    lo = block_all(lo, Min(), scratch);
    hi = block_all(hi, Max(), scratch);
    float acc = 0.0f;  // thread 0's
    const unsigned* mine = bits + t * kWordsPerThread;
    for (long long ws = lo; ws <= hi; ws += 32LL * kWindowWords) {
      for (int q = t; q < kWindowWords; q += kBinThreads) bits[q] = 0u;
      __syncthreads();
      for (int j = t; j < len; j += kBinThreads) {
        const long long d = slots[beg + j] - ws;
        if (d >= 0 && d < 32LL * kWindowWords)
          atomicOr(bits + (d >> 5), 1u << (d & 31));
      }
      __syncthreads();
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kWordsPerThread; ++i) cnt += __popc(mine[i]);
      int total;
      const int first = block_exclusive(cnt, &total, scratch);
      for (int c0 = 0; c0 < total; c0 += kChunk) {
        if (first < c0 + kChunk && first + cnt > c0) {
          int r = first;
          for (int i = 0; i < kWordsPerThread; ++i) {
            unsigned word = mine[i];
            const long long px = ws + 32LL * (t * kWordsPerThread + i);
            while (word) {
              const int bit = __ffs(word) - 1;
              word &= word - 1;
              if (r >= c0 && r < c0 + kChunk) staged[r - c0] = w[px + bit];
              ++r;
            }
          }
        }
        __syncthreads();
        if (t == 0) {
          const int m = total - c0 < kChunk ? total - c0 : kChunk;
#pragma unroll 8
          for (int q = 0; q < m; ++q) acc = __fadd_rn(acc, staged[q]);
        }
        __syncthreads();
      }
    }
    if (t == 0) out[b] = acc;
  }
}

}  // namespace

// src (n_rows, C) float32, perm and ordered (n_rows,) int64 (the stable
// sort order of the rows' segments and those segments, sorted), offsets
// (n_segments + 1,) int64, out (n_segments, C) float32, all contiguous on
// the current device; adds into out. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int lld_segment_sum(const void* src, const void* perm,
                               const void* ordered, const void* offsets,
                               void* out, long long n_rows, int n_segments,
                               int C, void* stream) {
  if (C < 1 || C > kMaxCols || n_segments < 0 || n_rows < 0 ||
      n_rows > INT_MAX / kMaxCols || n_segments > INT_MAX / kMaxCols)
    return (int)cudaErrorInvalidValue;
  if (n_segments == 0 || n_rows == 0) return (int)cudaGetLastError();
  const auto* s = static_cast<const float*>(src);
  const auto* p = static_cast<const int64_t*>(perm);
  const auto* ix = static_cast<const int64_t*>(ordered);
  const auto* o = static_cast<const int64_t*>(offsets);
  auto* d = static_cast<float*>(out);
  const int rows = (int)n_rows;
  auto st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch_sum<1>(s, p, ix, o, d, rows, n_segments, C, st);
    case 3: return (int)launch_sum<3>(s, p, ix, o, d, rows, n_segments, C, st);
    case 4: return (int)launch_sum<4>(s, p, ix, o, d, rows, n_segments, C, st);
    case 6: return (int)launch_sum<6>(s, p, ix, o, d, rows, n_segments, C, st);
    case 7: return (int)launch_sum<7>(s, p, ix, o, d, rows, n_segments, C, st);
    case 9: return (int)launch_sum<9>(s, p, ix, o, d, rows, n_segments, C, st);
    case 16: return (int)launch_sum<16>(s, p, ix, o, d, rows, n_segments, C,
                                        st);
    case 18: return (int)launch_sum<18>(s, p, ix, o, d, rows, n_segments, C,
                                        st);
    case 36: return (int)launch_sum<36>(s, p, ix, o, d, rows, n_segments, C,
                                        st);
    case 49: return (int)launch_sum<49>(s, p, ix, o, d, rows, n_segments, C,
                                        st);
    default: return (int)launch_sum<0>(s, p, ix, o, d, rows, n_segments, C,
                                       st);
  }
}

// The vote's layout over bins (n_rows,) int32 and w (n_rows,) float32,
// with n4 * 4 >= n_bins + 1 and tiles = ceil(n4 / kScanThreads): zeroed
// (n4 * 4 + tiles + 1,) int32 scratch (the counts, the scan's tile flags
// and its tile counter; this call zeroes it), offsets (n4 * 4,) int32 (bin
// b's voting pixels are slots[offsets[b] .. offsets[b + 1])), tile_sums
// (2 * tiles,) uint64 scratch, long_bins (n_bins, 4) int32 and n_long (1,)
// int32 (the bins of more than kSmallBin voting pixels as (bin, first
// slot, length, 0), the first n_long rows), slots (n_rows,) int32. Three
// kernels (count, scan, scatter) after a memset of the zeroed scratch.
extern "C" int lld_bin_layout(const void* bins, const void* w, void* zeroed,
                              void* offsets, void* tile_sums, void* long_bins,
                              void* n_long, void* slots, long long n_rows,
                              int n_bins, int n4, void* stream) {
  if (n_rows < 0 || n_rows > INT_MAX - 32LL * kWindowWords || n_bins < 1 ||
      4LL * n4 < n_bins + 1LL)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int rows = (int)n_rows, threads = 256;
  const int tiles = (n4 + kScanThreads - 1) / kScanThreads;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  int* count = static_cast<int*>(zeroed);
  const cudaError_t err = cudaMemsetAsync(
      count, 0, sizeof(int) * (4 * (size_t)n4 + tiles + 1), st);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0)
    bin_count<<<blocks, threads, 0, st>>>(static_cast<const int*>(bins),
                                          static_cast<const float*>(w), count,
                                          rows, n_bins);
  auto* sums = static_cast<unsigned long long*>(tile_sums);
  bin_scan<<<tiles, kScanThreads, 0, st>>>(
      count, static_cast<int*>(offsets), static_cast<int*>(long_bins),
      static_cast<int*>(n_long), sums, sums + tiles, count + 4 * n4, n4,
      tiles);
  if (rows > 0)
    bin_scatter<<<blocks, threads, 0, st>>>(
        static_cast<const int*>(bins), static_cast<const float*>(w),
        static_cast<const int*>(offsets), count, static_cast<int*>(slots),
        rows, n_bins);
  return (int)cudaGetLastError();
}

// out (n_bins,) float32: every bin's sum of its voting pixels' w in
// ascending pixel order, from lld_bin_layout's offsets, slots and long
// bins. One kernel.
extern "C" int lld_bin_reduce(const void* w, const void* offsets,
                              const void* slots, const void* long_bins,
                              const void* n_long, void* out, long long n_rows,
                              int n_bins, void* stream) {
  if (n_rows < 0 || n_bins < 1) return (int)cudaErrorInvalidValue;
  const int small_blocks = (n_bins + kBinThreads - 1) / kBinThreads;
  const long long most_long = n_rows / (kSmallBin + 1);
  const int long_blocks =
      (int)(most_long < kLongBlocks ? (most_long > 0 ? most_long : 1)
                                    : kLongBlocks);
  bin_reduce<<<small_blocks + long_blocks, kBinThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int*>(offsets),
      static_cast<const int*>(slots), static_cast<const int*>(long_bins),
      static_cast<const int*>(n_long), static_cast<float*>(out), n_bins,
      small_blocks);
  return (int)cudaGetLastError();
}
