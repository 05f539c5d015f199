// K1a: fused ORB describe — intensity-centroid angle and rotated BRIEF-256 of
// every keypoint of S frames, one warp per keypoint, one launch for all S
// (grid dimension y is the sequence: the multi-sequence driver builds S
// frames with one launch; a single frame is S = 1).
//
// Replaces, for the orientation and descriptor gathers of the frame build, the
// Pallas kernel lldslam_tpu/ops/patch_sample.py:sample_patches (body
// `_kernel`): the JAX package hands it a caller-built (n, 512) tap array and
// compares and bit-packs the gathered values with XLA ops afterwards. Here the
// kernel knows its taps and writes what its consumers need:
//
//   angle[i] = atan2(m01, m10) over the radius-15 circular patch (IC_Angle),
//   desc[i]  = 256 comparisons blur(a_k) < blur(b_k) of the rotated pattern,
//              bit k of word w being comparison 32w + k (hamming.pack_bits).
//
// Design:
//   * moments: the warp walks the 31 rows of the patch; lane dx = lane - 15
//     reads one pixel of the row where |dx| <= umax[|dy|] (a coalesced row
//     read), and a shuffle reduction finishes m10 = sum dx*I, m01 = sum dy*I;
//   * BRIEF: for word w, lane k rotates pair 32w + k, reads its two taps and
//     compares them; __ballot_sync gives the word, which lane w stores.
//   The level stacks (16 x 376 x 1241 float32, 30 MB each a frame) stay in
//   the 50 MB L2 from the pyramid and blur passes at S = 1; no window is
//   staged in shared memory, since 749 + 512 taps read fewer pixels than the
//   31x31 and 37x37 windows.
//   * sequences: block (x, s) reads only frame s's stacks and keypoints; the
//     image table (kMaxImages) holds the I level shapes that every frame of
//     the batch shares, so S is not bounded by it.
//
// Exactness against the plain version (ops/orb_describe.py):
//   * integer-valued images: every partial moment sum is an integer below
//     2^24, so the sums are exact in any order;
//   * atan2f, cosf and sinf are the CUDA math library's, as PyTorch's CUDA
//     atan2/cos/sin call them;
//   * the tap rotation rounds each product and the sum separately
//     (__fmul_rn, __fsub_rn, __fadd_rn: no FMA contraction, as eager PyTorch
//     computes it) and rounds half to even (__float2int_rn, as torch.round);
//   * BRIEF taps are clamped to the keypoint's level image (h, w), moment
//     taps to the stack's (H, W), as the plain version's gather does.
//
// What bounds it on an H100: the taps, 4000 x (749 + 512) x 4 B = 20 MB at the
// KITTI frame (6 us at 3.35 TB/s), read from L2; the arithmetic is a few
// flops per tap. At one launch per frame it is bound by launch latency and L2
// gather latency; S frames a launch spread that latency over S frames.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 keypoints per block
constexpr int kHalf = 15;      // IC patch radius
constexpr int kMaxImages = 64;

// per-image (h, w) of the level images inside the zero-padded stack, passed
// by value so that no host-to-device copy precedes the launch
struct ImageDims {
  int n;
  int h[kMaxImages];
  int w[kMaxImages];
};

// umax[|dy|]: half-width of row dy of the radius-15 circular patch
// (ORBextractor's umax table; ops/orb_describe.py:umax_table)
__constant__ int kUmax[kHalf + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                     13, 12, 11, 10, 9,  8,  6,  3};

// the 256 BRIEF point pairs (ax, ay, bx, by): ops/orb_pattern.npy
__device__ const signed char kPattern[256 * 4] = {
    8, -3, 9, 5, 4, 2, 7, -12, -11, 9, -8, 2, 7, -12, 12, -13,
    2, -13, 2, 12, 1, -7, 1, 6, -2, -10, -2, -4, -13, -13, -11, -8,
    -13, -3, -12, -9, 10, 4, 11, 9, -13, -8, -8, -9, -11, 7, -9, 12,
    7, 7, 12, 6, -4, -5, -3, 0, -13, 2, -12, -3, -9, 0, -7, 5,
    12, -6, 12, -1, -3, 6, -2, 12, -6, -13, -4, -8, 11, -13, 12, -8,
    4, 7, 5, 1, 5, -3, 10, -3, 3, -7, 6, 12, -8, -7, -6, -2,
    -2, 11, -1, -10, -13, 12, -8, 10, -7, 3, -5, -3, -4, 2, -3, 7,
    -10, -12, -6, 11, 5, -12, 6, -7, 5, -6, 7, -1, 1, 0, 4, -5,
    9, 11, 11, -13, 4, 7, 4, 12, 2, -1, 4, 4, -4, -12, -2, 7,
    -8, -5, -7, -10, 4, 11, 9, 12, 0, -8, 1, -13, -13, -2, -8, 2,
    -3, -2, -2, 3, -6, 9, -4, -9, 8, 12, 10, 7, 0, 9, 1, 3,
    7, -5, 11, -10, -13, -6, -11, 0, 10, 7, 12, 1, -6, -3, -6, 12,
    10, -9, 12, -4, -13, 8, -8, -12, -13, 0, -8, -4, 3, 3, 7, 8,
    5, 7, 10, -7, -1, 7, 1, -12, 3, -10, 5, 6, 2, -4, 3, -10,
    -13, 0, -13, 5, -13, -7, -12, 12, -13, 3, -11, 8, -7, 12, -4, 7,
    6, -10, 12, 8, -9, -1, -7, -6, -2, -5, 0, 12, -12, 5, -7, 5,
    3, -10, 8, -13, -7, -7, -4, 5, -3, -2, -1, -7, 2, 9, 5, -11,
    -11, -13, -5, -13, -1, 6, 0, -1, 5, -3, 5, 2, -4, -13, -4, 12,
    -9, -6, -9, 6, -12, -10, -8, -4, 10, 2, 12, -3, 7, 12, 12, 12,
    -7, -13, -6, 5, -4, 9, -3, 4, 7, -1, 12, 2, -7, 6, -5, 1,
    -13, 11, -12, 5, -3, 7, -2, -6, 7, -8, 12, -7, -13, -7, -11, -12,
    1, -3, 12, 12, 2, -6, 3, 0, -4, 3, -2, -13, -1, -13, 1, 9,
    7, 1, 8, -6, 1, -1, 3, 12, 9, 1, 12, 6, -1, -9, -1, 3,
    -13, -13, -10, 5, 7, 7, 10, 12, 12, -5, 12, 9, 6, 3, 7, 11,
    5, -13, 6, 10, 2, -12, 2, 3, 3, 8, 4, -6, 2, 6, 12, -13,
    9, -12, 10, 3, -8, 4, -7, 9, -11, 12, -4, -6, 1, 12, 2, -8,
    6, -9, 7, -4, 2, 3, 3, -2, 6, 3, 11, 0, 3, -3, 8, -8,
    7, 8, 9, 3, -11, -5, -6, -4, -10, 11, -5, 10, -5, -8, -3, 12,
    -10, 5, -9, 0, 8, -1, 12, -6, 4, -6, 6, -11, -10, 12, -8, 7,
    4, -2, 6, 7, -2, 0, -2, 12, -5, -8, -5, 2, 7, -6, 10, 12,
    -9, -13, -8, -8, -5, -13, -5, -2, 8, -8, 9, -13, -9, -11, -9, 0,
    1, -8, 1, -2, 7, -4, 9, 1, -2, 1, -1, -4, 11, -6, 12, -11,
    -12, -9, -6, 4, 3, 7, 7, 12, 5, 5, 10, 8, 0, -4, 2, 8,
    -9, 12, -5, -13, 0, 7, 2, 12, -1, 2, 1, 7, 5, 11, 7, -9,
    3, 5, 6, -8, -13, -4, -8, 9, -5, 9, -3, -3, -4, -7, -3, -12,
    6, 5, 8, 0, -7, 6, -6, 12, -13, 6, -5, -2, 1, -10, 3, 10,
    4, 1, 8, -4, -2, -2, 2, -13, 2, -12, 12, 12, -2, -13, 0, -6,
    4, 1, 9, 3, -6, -10, -3, -5, -3, -13, -1, 1, 7, 5, 12, -11,
    4, -2, 5, -7, -13, 9, -9, -5, 7, 1, 8, 6, 7, -8, 7, 6,
    -7, -4, -7, 1, -8, 11, -7, -8, -13, 6, -12, -8, 2, 4, 3, 9,
    10, -5, 12, 3, -6, -5, -6, 7, 8, -3, 9, -8, 2, -12, 2, 8,
    -11, -2, -10, 3, -12, -13, -7, -9, -11, 0, -10, -5, 5, -3, 11, 8,
    -2, -13, -1, 12, -1, -8, 0, 9, -13, -11, -12, -5, -10, -2, -10, 11,
    -3, 9, -2, -13, 2, -3, 3, 2, -9, -13, -4, 0, -4, 6, -3, -10,
    -4, 12, -2, -7, -6, -11, -4, 9, 6, -3, 6, 11, -13, 11, -5, 5,
    11, 11, 12, 6, 7, -5, 12, -2, -1, 12, 0, 7, -4, -8, -3, -2,
    -7, 1, -6, 7, -13, -12, -8, -13, -7, -2, -6, -8, -8, 5, -6, -9,
    -5, -1, -4, 5, -13, 7, -8, 10, 1, 5, 5, -13, 1, 0, 10, -13,
    9, 12, 10, -1, 5, -8, 10, -9, -1, 11, 1, -13, -9, -3, -6, 2,
    -1, -10, 1, 12, -13, 1, -8, -10, 8, -11, 10, -6, 2, -13, 3, -6,
    7, -13, 12, -9, -10, -10, -5, -7, -10, -8, -8, -13, 4, -6, 8, 5,
    3, 12, 8, -13, -4, 2, -3, -3, 5, -13, 10, -12, 4, -13, 5, -1,
    -9, 9, -4, 3, 0, 3, 3, -9, -12, 1, -6, 1, 3, 2, 4, -8,
    -10, -10, -10, 9, 8, -13, 12, 12, -8, -12, -6, -5, 2, 2, 3, 7,
    10, 6, 11, -8, 6, 8, 8, -12, -7, 10, -6, 5, -3, -9, -3, 9,
    -1, -13, -1, 5, -3, -7, -3, 4, -8, -2, -8, 3, 4, 2, 12, 12,
    2, -5, 3, 11, 6, -9, 11, -13, 3, -1, 7, 12, 11, -1, 12, 4,
    -3, 0, -3, 6, 4, -11, 4, 12, 2, -4, 2, 1, -10, -6, -8, 1,
    -13, 7, -11, 1, -13, 12, -11, -13, 6, 0, 11, -13, 0, -1, 1, 4,
    -13, 3, -9, -2, -9, 8, -6, -3, -13, -6, -8, -2, 5, -9, 8, 10,
    2, 7, 3, -9, -1, -6, -1, -1, 9, 5, 11, -2, 11, -3, 12, -8,
    3, 0, 3, 5, -1, 4, 0, 10, 3, -6, 4, 5, -13, 0, -10, 5,
    5, 8, 12, 11, 8, 9, 9, -6, 7, -4, 8, -12, -10, 4, -10, 9,
    7, 3, 12, 4, 9, -7, 10, -2, 7, 0, 12, -2, -1, -6, 0, -11,
};

__device__ __forceinline__ float brief_tap(const float* __restrict__ im,
                                           int W, int x, int y, float px,
                                           float py, float ca, float sa,
                                           int h, int w) {
  const int rx = __float2int_rn(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
  const int ry = __float2int_rn(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
  const int gx = min(max(x + rx, 0), w - 1);
  const int gy = min(max(y + ry, 0), h - 1);
  return __ldg(im + (size_t)gy * W + gx);
}

__global__ void __launch_bounds__(kThreads) orb_describe_kernel(
    const float* __restrict__ pyr, const float* __restrict__ blur, int H,
    int W, ImageDims dims, const int32_t* __restrict__ xy,
    const int32_t* __restrict__ img_idx, int n, float* __restrict__ angle,
    int32_t* __restrict__ desc) {
  const int kp = (int)((blockIdx.x * (unsigned)kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n) return;  // uniform per warp
  const size_t plane = (size_t)H * W;
  // this block's frame of the batch
  const size_t seq = blockIdx.y;
  pyr += seq * dims.n * plane;
  blur += seq * dims.n * plane;
  xy += seq * 2 * n;
  img_idx += seq * n;
  angle += seq * n;
  desc += seq * 8 * n;
  const int img = min(max(__ldg(img_idx + kp), 0), dims.n - 1);
  const int x = __ldg(xy + 2 * kp), y = __ldg(xy + 2 * kp + 1);

  // intensity-centroid moments
  const float* im = pyr + img * plane;
  const int dx = lane - kHalf;
  const int xc = min(max(x + dx, 0), W - 1);
  float m10 = 0.f, m01 = 0.f;
#pragma unroll 4
  for (int dy = -kHalf; dy <= kHalf; ++dy) {
    if (lane < 2 * kHalf + 1 && abs(dx) <= kUmax[abs(dy)]) {
      const int yc = min(max(y + dy, 0), H - 1);
      const float v = __ldg(im + (size_t)yc * W + xc);
      m10 += (float)dx * v;
      m01 += (float)dy * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  const float ang = atan2f(m01, m10);
  if (lane == 0) angle[kp] = ang;

  // rotated BRIEF on the blurred level image
  const float ca = cosf(ang), sa = sinf(ang);
  const float* bl = blur + img * plane;
  const int h = dims.h[img], w = dims.w[img];
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const signed char* p = kPattern + 4 * (32 * k + lane);
    const float va = brief_tap(bl, W, x, y, p[0], p[1], ca, sa, h, w);
    const float vb = brief_tap(bl, W, x, y, p[2], p[3], ca, sa, h, w);
    const uint32_t bits = __ballot_sync(0xffffffffu, va < vb);
    if (lane == k) word = bits;
  }
  if (lane < 8) desc[8 * kp + lane] = (int32_t)word;
}

}  // namespace

// pyr, blur: (S, n_images, H, W) float32 stacks; img_h/img_w: host arrays of
// the n_images level shapes, shared by the S frames; xy (S, n, 2) int32 level
// coords; img_idx (S, n) int32, an image of the keypoint's own frame. Outputs
// angle (S, n) float32 and desc (S, n, 8) int32. Returns a CUDA error code.
extern "C" int lld_orb_describe(const void* pyr, const void* blur, int S,
                                int n_images, int H, int W, const int* img_h,
                                const int* img_w, const void* xy,
                                const void* img_idx, int n, void* angle,
                                void* desc, void* stream) {
  if (n_images < 1 || n_images > kMaxImages || S < 1 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  ImageDims dims;
  dims.n = n_images;
  for (int i = 0; i < n_images; ++i) {
    dims.h[i] = img_h[i];
    dims.w[i] = img_w[i];
  }
  const unsigned blocks = (unsigned)(((long long)n * 32 + kThreads - 1) / kThreads);
  orb_describe_kernel<<<dim3(blocks, (unsigned)S), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<const float*>(blur), H, W,
      dims, static_cast<const int32_t*>(xy),
      static_cast<const int32_t*>(img_idx), n, static_cast<float*>(angle),
      static_cast<int32_t*>(desc));
  return (int)cudaGetLastError();
}
