// K2: fused masked Hamming best-2 matching of 256-bit descriptors.
//
// Replaces the Pallas kernel lldslam_tpu/ops/pallas_match.py:masked_best2
// (body `_kernel`). The TPU version computed distances on the MXU through the
// bit-matmul identity |a| + |b| - 2 A.B^T over (256, 256) tiles and folded a
// running best-2 across a sequential column grid in VMEM scratch. Hopper has a
// population-count instruction and no sequential grid, so the design here is:
//
//   * one warp per row; the row's 8 descriptor words live in registers;
//   * lanes stride over the columns, read the mask row coalesced (one byte per
//     lane per step) and, only where the mask is set, load the column's 32
//     descriptor bytes (two 16-byte loads) and take __popc of the 8 XORs;
//   * each lane keeps its two lexicographically smallest (distance, column)
//     pairs, and a shuffle reduction merges the 32 lane states.
//
// Tie contract (the XLA sequence of lldslam_tpu/frontend/matching.py, not the
// Pallas fold): best_idx is the lowest column at the minimum; second and
// second_idx are the minimum, and the lowest column at it, over all other
// columns; a row with no candidate (or no second candidate) reports
// INF_DIST = 10000 and column 0, as XLA argmin of an all-INF row does.
//
// What bounds it on an H100: the (M, N) bool mask is the only large operand
// (8 MB at 4096 x 2048, ~2.5 us at 3.35 TB/s); the descriptors (64-128 KB) sit
// in L1/L2 and only masked-in columns (~2% in the tracker) are loaded. So the
// kernel is bound by launch latency; the (M, N) distance matrix is never
// materialised, which is what the Pallas kernel was for.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInfDist = 10000;

__device__ __forceinline__ void push(int& d1, int& i1, int& d2, int& i2,
                                     int d, int i) {
  if (d < d1 || (d == d1 && i < i1)) {
    d2 = d1;
    i2 = i1;
    d1 = d;
    i1 = i;
  } else if (d < d2 || (d == d2 && i < i2)) {
    d2 = d;
    i2 = i;
  }
}

__global__ void masked_best2_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    const uint8_t* __restrict__ mask, int M,
                                    int N, int32_t* __restrict__ best_idx,
                                    int32_t* __restrict__ best,
                                    int32_t* __restrict__ second,
                                    int32_t* __restrict__ second_idx) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // uniform per warp: blockDim is a multiple of 32
  const uint4* arow = reinterpret_cast<const uint4*>(a + (size_t)row * 8);
  const uint4 a0 = __ldg(arow), a1 = __ldg(arow + 1);
  const uint8_t* mrow = mask + (size_t)row * N;
  int d1 = kInfDist, i1 = INT_MAX, d2 = kInfDist, i2 = INT_MAX;
  for (int j = lane; j < N; j += 32) {
    if (__ldg(mrow + j)) {
      const uint4* bcol = reinterpret_cast<const uint4*>(b + (size_t)j * 8);
      const uint4 b0 = __ldg(bcol), b1 = __ldg(bcol + 1);
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      push(d1, i1, d2, i2, d, j);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int od1 = __shfl_down_sync(0xffffffffu, d1, off);
    const int oi1 = __shfl_down_sync(0xffffffffu, i1, off);
    const int od2 = __shfl_down_sync(0xffffffffu, d2, off);
    const int oi2 = __shfl_down_sync(0xffffffffu, i2, off);
    push(d1, i1, d2, i2, od1, oi1);
    push(d1, i1, d2, i2, od2, oi2);
  }
  if (lane == 0) {
    best[row] = d1;
    best_idx[row] = d1 < kInfDist ? i1 : 0;
    second[row] = d2;
    second_idx[row] = d2 < kInfDist ? i2 : 0;
  }
}

}  // namespace

// a (M, 8) and b (N, 8) uint32 descriptors (16-byte aligned rows), mask (M, N)
// bytes. Outputs (M,) int32 each. Returns cudaGetLastError().
extern "C" int lld_masked_best2(const void* a, const void* b, const void* mask,
                                int M, int N, void* best_idx, void* best,
                                void* second, void* second_idx, void* stream) {
  if (M == 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 rows per block
  const unsigned blocks = (unsigned)(((long long)M * 32 + threads - 1) / threads);
  masked_best2_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint8_t*>(mask), M, N, static_cast<int32_t*>(best_idx),
      static_cast<int32_t*>(best), static_cast<int32_t*>(second),
      static_cast<int32_t*>(second_idx));
  return (int)cudaGetLastError();
}
