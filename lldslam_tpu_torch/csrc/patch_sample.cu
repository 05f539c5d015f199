// K1: batched per-keypoint patch sampling (a data-dependent 2-D gather).
//
// Replaces the Pallas kernel lldslam_tpu/ops/patch_sample.py:sample_patches
// (body `_kernel`). That kernel turned the gather into MXU work (one-hot row
// and column selectors over an aligned (48, 256) window per keypoint) because
// the TPU has no fast gather. Hopper gathers natively, so this kernel keeps
// only the contract:
//
//     out[i, s] = img[meta[i,0], meta[i,1] + iy[i,s], meta[i,2] + ix[i,s]]
//
// without the Mosaic preconditions (no window, no 8/128-aligned origins, no
// n % 8, S % 128 or Wp % 128 requirements). Reads are clamped into the image
// (every caller already clips, so results do not change).
//
// What bounds it on an H100: the images (at most ~3.7 MB for the float32
// level-0 pair at 1241x376, 16 levels x 2 views padded ~30 MB) sit in the
// 50 MB L2, and the output is n*S floats written once, so the kernel moves a
// few MB and is bound by launch latency and L2 gather latency, not by HBM.
// The design therefore is one thread per output element with consecutive
// threads on consecutive taps s (coalesced index reads and output writes),
// and one launch per consumer over a padded stack of all pyramid levels of
// both views (meta[i,0] selects the level image) instead of one launch per
// level. Integer-valued images are exact as uint8 or float32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void sample_patches_kernel(const T* __restrict__ img, int V, int H,
                                      int W, const int32_t* __restrict__ meta,
                                      const int32_t* __restrict__ iy,
                                      const int32_t* __restrict__ ix,
                                      float* __restrict__ out, int n, int S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * S) return;
  const int i = (int)(idx / S);
  const int v = min(max(__ldg(meta + 4 * i), 0), V - 1);
  const int y = min(max(__ldg(meta + 4 * i + 1) + __ldg(iy + idx), 0), H - 1);
  const int x = min(max(__ldg(meta + 4 * i + 2) + __ldg(ix + idx), 0), W - 1);
  out[idx] = static_cast<float>(__ldg(img + ((size_t)v * H + y) * W + x));
}

}  // namespace

// dtype: 0 = uint8 image, 1 = float32 image. Returns cudaGetLastError().
extern "C" int lld_sample_patches(const void* img, int dtype, int V, int H,
                                  int W, const void* meta, const void* iy,
                                  const void* ix, void* out, int n, int S,
                                  void* stream) {
  const long long total = (long long)n * S;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    sample_patches_kernel<uint8_t><<<blocks, threads, 0, st>>>(
        static_cast<const uint8_t*>(img), V, H, W,
        static_cast<const int32_t*>(meta), static_cast<const int32_t*>(iy),
        static_cast<const int32_t*>(ix), static_cast<float*>(out), n, S);
  } else {
    sample_patches_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(img), V, H, W,
        static_cast<const int32_t*>(meta), static_cast<const int32_t*>(iy),
        static_cast<const int32_t*>(ix), static_cast<float*>(out), n, S);
  }
  return (int)cudaGetLastError();
}
