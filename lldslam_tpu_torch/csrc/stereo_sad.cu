// K1b: fused stereo SAD refinement — the 11x11 sum-of-absolute-differences
// sweep over +-5 disparities and its parabola fit, one warp per keypoint,
// one launch for the keypoints of S frames (grid dimension y is the
// sequence; a single frame is S = 1).
//
// Replaces, for the stereo windows of the frame build, the Pallas kernel
// lldslam_tpu/ops/patch_sample.py:sample_patches (body `_kernel`): the JAX
// package gathers an (n, 11, 11) patch and an (n, 11, 21) strip through it,
// one call per level and view, and runs the SAD sweep, argmin and parabola
// as XLA ops. Here one kernel does it all and writes three numbers per
// keypoint:
//
//   best_d  first disparity index (0..10) of the smallest centred SAD,
//   best_c  that SAD,
//   delta   the clamped parabola vertex offset from best_d's neighbours.
//
// Design: the warp stages the left patch (121 values) and the right strip
// (231 values) of its keypoint in shared memory, rows and columns clamped
// to the keypoint's level (h, w); lanes then split the 121 terms of each of
// the 11 SADs (352 loads serve 1331 differences), shuffle reductions finish
// the sums, and lane 0 does the argmin and the parabola. Block (x, s) reads
// only frame s's stack and keypoints; the level shapes in the image table are
// shared by the S frames, so S is not bounded by kMaxImages.
//
// Exactness against the plain version (ops/stereo_sad.py): integer-valued
// images make every SAD an integer below 2^24, exact in any order; the
// parabola follows the plain operation order (2*best_c, cm1 + cp1, the
// difference, times 2, clamp at 1e-6, IEEE division) with __fmul_rn,
// __fadd_rn, __fsub_rn and __fdiv_rn, so no FMA forms.
//
// What bounds it on an H100: 2048 x 352 x 4 B = 2.9 MB of taps at the KITTI
// frame (0.9 us at 3.35 TB/s); it is bound by launch latency, which S frames
// a launch share.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // keypoints per block
constexpr int kW = 5;      // half window: 11 x 11
constexpr int kL = 5;      // disparity sweep: +-5
constexpr int kSide = 2 * kW + 1;               // 11
constexpr int kStrip = kSide + 2 * kL;          // 21
constexpr int kD = 2 * kL + 1;                  // 11 disparities
constexpr int kPatchN = kSide * kSide;          // 121
constexpr int kStripN = kSide * kStrip;         // 231
constexpr int kMaxImages = 64;

// per-image (h, w) of the level images inside the zero-padded stack
struct ImageDims {
  int n;
  int h[kMaxImages];
  int w[kMaxImages];
};

__global__ void __launch_bounds__(kWarps * 32) stereo_sad_kernel(
    const float* __restrict__ pyr, int H, int W, ImageDims dims,
    const int32_t* __restrict__ lvl, const int32_t* __restrict__ ul,
    const int32_t* __restrict__ vl, const int32_t* __restrict__ ur, int n,
    int32_t* __restrict__ best_d, float* __restrict__ best_c,
    float* __restrict__ delta) {
  __shared__ float win[kWarps][kPatchN + kStripN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + warp;
  if (kp >= n) return;  // uniform per warp; no block-wide barrier follows
  // this block's frame of the batch
  const size_t seq = blockIdx.y;
  pyr += seq * dims.n * (size_t)H * W;
  lvl += seq * n;
  ul += seq * n;
  vl += seq * n;
  ur += seq * n;
  best_d += seq * n;
  best_c += seq * n;
  delta += seq * n;
  const int l = min(max(__ldg(lvl + kp), 0), dims.n / 2 - 1);
  const int h = dims.h[2 * l], w = dims.w[2 * l];
  const float* left = pyr + (size_t)(2 * l) * H * W;
  const float* right = left + (size_t)H * W;
  const int u = __ldg(ul + kp), v = __ldg(vl + kp), u_r = __ldg(ur + kp);
  float* patch = win[warp];
  float* strip = patch + kPatchN;
  for (int t = lane; t < kPatchN; t += 32) {
    const int y = min(max(v + t / kSide - kW, 0), h - 1);
    const int x = min(max(u + t % kSide - kW, 0), w - 1);
    patch[t] = __ldg(left + (size_t)y * W + x);
  }
  for (int t = lane; t < kStripN; t += 32) {
    const int y = min(max(v + t / kStrip - kW, 0), h - 1);
    const int x = min(max(u_r + t % kStrip - kW - kL, 0), w - 1);
    strip[t] = __ldg(right + (size_t)y * W + x);
  }
  __syncwarp();

  const float pc = patch[kW * kSide + kW];
  float sad[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const float sc = strip[kW * kStrip + kW + d];
    float acc = 0.f;
    for (int t = lane; t < kPatchN; t += 32) {
      const int r = t / kSide, c = t % kSide;
      acc += fabsf((patch[t] - pc) - (strip[r * kStrip + c + d] - sc));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    sad[d] = acc;
  }
  if (lane != 0) return;
  int bd = 0;
  float bc = sad[0], cm1 = sad[0], cp1 = sad[1];
#pragma unroll
  for (int d = 1; d < kD; ++d) {
    if (sad[d] < bc) {  // strict: the first minimum, as torch.argmin
      bd = d;
      bc = sad[d];
    }
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) {  // static indices keep sad[] in registers
    if (d == max(bd - 1, 0)) cm1 = sad[d];
    if (d == min(bd + 1, kD - 1)) cp1 = sad[d];
  }
  float den = __fmul_rn(2.0f, __fsub_rn(__fadd_rn(cm1, cp1), __fmul_rn(2.0f, bc)));
  den = den < 1e-6f ? 1e-6f : den;
  float dl = __fdiv_rn(__fsub_rn(cm1, cp1), den);
  dl = (bd > 0 && bd < kD - 1) ? dl : 0.0f;
  dl = fminf(fmaxf(dl, -1.0f), 1.0f);
  best_d[kp] = bd;
  best_c[kp] = bc;
  delta[kp] = dl;
}

}  // namespace

// pyr: (S, n_images, H, W) float32 stacks, left level l at image 2l, right
// at 2l + 1; img_h/img_w: host arrays of the n_images level shapes, shared by
// the S frames; lvl, ul, vl, ur: (S, n) int32 (level, left u and v, right u
// at that level). Outputs best_d (S, n) int32, best_c and delta (S, n)
// float32. Returns a CUDA error code.
extern "C" int lld_stereo_sad(const void* pyr, int S, int n_images, int H, int W,
                              const int* img_h, const int* img_w,
                              const void* lvl, const void* ul, const void* vl,
                              const void* ur, int n, void* best_d,
                              void* best_c, void* delta, void* stream) {
  if (n_images < 2 || n_images > kMaxImages || S < 1 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  ImageDims dims;
  dims.n = n_images;
  for (int i = 0; i < n_images; ++i) {
    dims.h[i] = img_h[i];
    dims.w[i] = img_w[i];
  }
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  stereo_sad_kernel<<<dim3(blocks, (unsigned)S), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), H, W, dims,
      static_cast<const int32_t*>(lvl), static_cast<const int32_t*>(ul),
      static_cast<const int32_t*>(vl), static_cast<const int32_t*>(ur), n,
      static_cast<int32_t*>(best_d), static_cast<float*>(best_c),
      static_cast<float*>(delta));
  return (int)cudaGetLastError();
}
