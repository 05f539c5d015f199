// K2g: gated Hamming best-2 matching of 256-bit descriptors — the projection
// gates of ORBmatcher::SearchByProjection evaluated in the kernel, so the
// (M, N) candidate mask is never built. One launch serves S independent
// problems (the multi-sequence driver's S frames; grid dimension y is the
// sequence, and sequence s's rows see only sequence s's columns); a single
// problem is S = 1.
//
// Replaces the Pallas kernel lldslam_tpu/ops/pallas_match.py:masked_best2
// (body `_kernel`). The TPU version read an (M, N) mask that XLA built from
// the projections, computed distances on the MXU through the bit-matmul
// identity |a| + |b| - 2 A.B^T over (256, 256) tiles and folded a running
// best-2 across a sequential column grid in VMEM scratch. Hopper has a
// population-count instruction and no sequential grid, and the mask costs
// more to build and to read than the matching itself, so the design here is:
//
//   * each block stages the frame's keypoint fields (x, y, right u, octave;
//     16 B per keypoint, 32 KB at N = 2048) in shared memory once and serves
//     kRows rows from it; an invalid keypoint gets x = NaN, which fails every
//     window test;
//   * one warp per row: the row's 8 descriptor words and its gate fields
//     (u, v, ur, radius, predicted octave) live in registers; lanes stride
//     over the keypoints, test the gate
//
//       |u - x| <= r && |v - y| <= r && po - 1 <= oct <= po
//         && (kp_ur < 0 || |ur - kp_ur| <= r)
//
//     and, only where it passes, load the keypoint's 32 descriptor bytes (two
//     16-byte loads) and take __popc of the 8 XORs; a row outside the
//     frustum tests nothing;
//   * each lane keeps its two lexicographically smallest (distance, column)
//     pairs, and a shuffle reduction merges the 32 lane states.
//
// The gates are single IEEE subtractions, absolute values and comparisons
// (__fsub_rn: no FMA can form), bit for bit those of the plain version
// (ops/match_best2.py:gate_mask).
//
// Tie contract (the XLA sequence of lldslam_tpu/frontend/matching.py, not the
// Pallas fold): best_idx is the lowest column at the minimum; second and
// second_idx are the minimum, and the lowest column at it, over all other
// columns; a row with no candidate (or no second candidate) reports
// INF_DIST = 10000 and column 0, as XLA argmin of an all-INF row does.
//
// What bounds it on an H100: the operands are 0.4 MB at M = 4096, N = 2048
// (0.1 us at 3.35 TB/s) and the M x N gate tests are a few float operations
// each (8.4 M tests, about 0.4 us at 67 TFLOP/s); it is bound by launch
// latency.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInfDist = 10000;
constexpr int kWarps = 8;
constexpr int kRows = 16;  // rows per block, kRows / kWarps per warp

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

__global__ void __launch_bounds__(kWarps * 32) gated_best2_kernel(
    const uint32_t* __restrict__ a, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ ur,
    const float* __restrict__ r, const int32_t* __restrict__ pred_oct,
    const uint8_t* __restrict__ in_frustum, int M,
    const uint32_t* __restrict__ b, const float2* __restrict__ xy,
    const float* __restrict__ kp_ur, const int32_t* __restrict__ octave,
    const uint8_t* __restrict__ valid, int N, int32_t* __restrict__ out,
    size_t out_stride) {
  extern __shared__ float4 cols[];  // (x, y, kp_ur, octave bits) per column
  // this block's sequence: its rows, its columns, its slice of each output
  const size_t seq = blockIdx.y;
  a += seq * M * 8;
  u += seq * M;
  v += seq * M;
  ur += seq * M;
  r += seq * M;
  pred_oct += seq * M;
  in_frustum += seq * M;
  b += seq * N * 8;
  xy += seq * N;
  kp_ur += seq * N;
  octave += seq * N;
  valid += seq * N;
  out += seq * M;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float2 p = __ldg(xy + j);
    cols[j] = make_float4(__ldg(valid + j) ? p.x : __int_as_float(0x7fc00000),
                          p.y, __ldg(kp_ur + j), __int_as_float(__ldg(octave + j)));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_end = min(M, (int)(blockIdx.x + 1) * kRows);
  for (int row = blockIdx.x * kRows + warp; row < row_end; row += kWarps) {
    int d1 = kInfDist, i1 = INT_MAX, d2 = kInfDist, i2 = INT_MAX;
    if (__ldg(in_frustum + row)) {
      const uint4* arow = reinterpret_cast<const uint4*>(a + (size_t)row * 8);
      const uint4 a0 = __ldg(arow), a1 = __ldg(arow + 1);
      const float ru = __ldg(u + row), rv = __ldg(v + row);
      const float rur = __ldg(ur + row), rr = __ldg(r + row);
      const int po = __ldg(pred_oct + row);
      for (int j = lane; j < N; j += 32) {
        const float4 c = cols[j];
        const int o = __float_as_int(c.w);
        if (fabsf(__fsub_rn(ru, c.x)) <= rr && fabsf(__fsub_rn(rv, c.y)) <= rr &&
            o >= po - 1 && o <= po &&
            (c.z < 0.f || fabsf(__fsub_rn(rur, c.z)) <= rr)) {
          const uint4* bcol = reinterpret_cast<const uint4*>(b + (size_t)j * 8);
          const uint4 b0 = __ldg(bcol), b1 = __ldg(bcol + 1);
          const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                        __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                        __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                        __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
          push(d1, i1, d2, i2, d, j);
        }
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
      out[row] = d1 < kInfDist ? i1 : 0;
      out[out_stride + row] = d1;
      out[2 * out_stride + row] = d2;
      out[3 * out_stride + row] = d2 < kInfDist ? i2 : 0;
    }
  }
}

}  // namespace

// S problems. Rows: a (S, M, 8) uint32 descriptors (16-byte aligned rows);
// u, v, ur, r (S, M) float32; pred_oct (S, M) int32; in_frustum (S, M) bool.
// Columns: b (S, N, 8) uint32 descriptors (16-byte aligned rows); xy (S, N,
// 2) float32; kp_ur (S, N) float32; octave (S, N) int32; valid (S, N) bool.
// out (4, S, M) int32: best_idx, best, second, second_idx. Returns a CUDA
// error code.
extern "C" int lld_gated_best2(const void* a, const void* u, const void* v,
                               const void* ur, const void* r,
                               const void* pred_oct, const void* in_frustum,
                               int S, int M, const void* b, const void* xy,
                               const void* kp_ur, const void* octave,
                               const void* valid, int N, void* out,
                               void* stream) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)N * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gated_best2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((M + kRows - 1) / kRows);
  gated_best2_kernel<<<dim3(blocks, (unsigned)S), kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const float*>(ur),
      static_cast<const float*>(r), static_cast<const int32_t*>(pred_oct),
      static_cast<const uint8_t*>(in_frustum), M,
      static_cast<const uint32_t*>(b), static_cast<const float2*>(xy),
      static_cast<const float*>(kp_ur), static_cast<const int32_t*>(octave),
      static_cast<const uint8_t*>(valid), N, static_cast<int32_t*>(out),
      (size_t)S * M);
  return (int)cudaGetLastError();
}
