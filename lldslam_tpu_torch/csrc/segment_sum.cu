// Fixed-order segment sum: out[s, c] += src[perm[i], c] for i from
// offsets[s] to offsets[s + 1] - 1, in that order, one IEEE add at a time.
//
// Replaces, on the card, the atomic `index_add_` of the sparse solvers of a
// loop event (global BA, the joint point+line global BA, the line refinement
// and the pose graph; lldslam_tpu_torch/ops/segment_sum.py). The JAX package
// writes these sums as XLA scatters (`.at[].add`: lldslam_tpu/optim/ba.py:
// 104-108, 208, 217-222; lldslam_tpu/optim/lines_ba.py:115-119, 398-428,
// 542-547; lldslam_tpu/optim/pose_graph.py:80-84, 104-105), not as Pallas
// kernels. perm is the stable sort order of the scatter index, so each
// output takes its rows in ascending row order: the sequence of float adds of
// the CPU's serial `index_add_`, hence the CPU's bits, on every run. The adds
// are __fadd_rn (no contraction into an FMA, no reassociation); a tree order
// would be faster and would not be bit-equal.
//
// Design. One block per segment. The block stages its rows through shared
// memory in tiles of tile_rows x C floats, loaded by every thread (a row's C
// floats are contiguous, so neighbouring threads read neighbouring
// addresses), and thread t adds columns t and t + blockDim.x of the tile, row
// after row, into registers. The host picks the block from the shapes it
// knows: 512 threads where segments average 32 rows or more (the pose side
// of global BA: tens of keyframes, hundreds to thousands of observations
// each, C = 36 or 6), one warp otherwise (the point side: thousands of
// points, about 4 observations each, C <= 9). The choice changes the speed,
// never the order of the adds.
//
// What bounds it on an H100: the bytes, O x C x 4 in, O x 8 of perm, and
// n_segments x C x 4 read and written (a few hundred KB for a global BA:
// well under a microsecond at 3.35 TB/s), against one serial add chain per
// output, as long as the longest segment (a few microseconds for thousands
// of rows), and the launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 64;         // two columns a thread at one warp
constexpr int kLongThreads = 512;
constexpr int kShortThreads = 32;
constexpr int kLongRows = 32;        // mean rows per segment for 512 threads
constexpr int kTileFloats = 16;      // staged floats per thread

__global__ void segment_sum_kernel(const float* __restrict__ src,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ offsets,
                                   float* __restrict__ out, int C,
                                   int tile_rows) {
  extern __shared__ float tile[];
  const int64_t beg = offsets[blockIdx.x], end = offsets[blockIdx.x + 1];
  if (beg >= end) return;  // uniform over the block
  const int t = threadIdx.x, nt = blockDim.x;
  const int c0 = t, c1 = t + nt;
  float* o = out + (int64_t)blockIdx.x * C;
  float acc0 = c0 < C ? o[c0] : 0.0f;
  float acc1 = c1 < C ? o[c1] : 0.0f;
  for (int64_t r0 = beg; r0 < end; r0 += tile_rows) {
    const int nr = (int)(end - r0 < tile_rows ? end - r0 : tile_rows);
    const int n = nr * C;
    for (int e = t; e < n; e += nt) {
      const int r = e / C;
      tile[e] = src[perm[r0 + r] * C + (e - r * C)];
    }
    __syncthreads();
    if (c0 < C)
      for (int r = 0; r < nr; ++r) acc0 = __fadd_rn(acc0, tile[r * C + c0]);
    if (c1 < C)
      for (int r = 0; r < nr; ++r) acc1 = __fadd_rn(acc1, tile[r * C + c1]);
    __syncthreads();
  }
  if (c0 < C) o[c0] = acc0;
  if (c1 < C) o[c1] = acc1;
}

}  // namespace

// src (n_rows, C) float32, perm (n_rows,) int64, offsets (n_segments + 1,)
// int64, out (n_segments, C) float32, all contiguous on the current device;
// adds into out. Returns the CUDA error code of the launch (0 on success).
extern "C" int lld_segment_sum(const void* src, const void* perm,
                               const void* offsets, void* out, long long n_rows,
                               int n_segments, int C, void* stream) {
  if (C < 1 || C > kMaxCols || n_segments < 0 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_segments == 0 || n_rows == 0) return (int)cudaGetLastError();
  const int threads = n_rows >= (long long)kLongRows * n_segments
                          ? kLongThreads : kShortThreads;
  int tile_rows = threads * kTileFloats / C;
  if (tile_rows < 1) tile_rows = 1;
  const size_t smem = (size_t)tile_rows * C * sizeof(float);
  segment_sum_kernel<<<(unsigned)n_segments, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets), static_cast<float*>(out), C,
      tile_rows);
  return (int)cudaGetLastError();
}
