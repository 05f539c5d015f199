// The points-only pose LM: `rounds` x `iters` Levenberg-Marquardt steps on
// one frame pose with Huber IRLS and round-based inlier reclassification,
// the whole solve in one launch. One launch serves S independent problems
// (the multi-sequence driver's S frames): one thread block a problem.
//
// It replaces no Pallas kernel. It replaces the XLA-compiled `optimize_pose`
// of lldslam_tpu/optim/pose_opt.py without lines, which the port ran eagerly
// (optim/pose_opt.py `optimize_pose_plain`): some 150 small launches an
// iteration, 6,000 a call, whose host dispatch took most of a tracked
// frame's time while the card idled.
//
// What it computes, as the plain version does: the stereo point residual
// (uL, v, uR) with the uR row dropped for mono edges and per-octave
// information; the Huber IRLS weight and cost (deltas 5.991 mono, 7.815
// stereo); the analytic 3x6 pose Jacobian; H and b over the current inliers,
// Hd = H + lambda diag(H) + 1e-8 I and the 6x6 solve; exp(dx) T with the
// same small-angle coefficients; the candidate's cost and the accept test
// cost_new < cost, lambda x0.5 on accept and x4 on reject, clamped to
// [1e-9, 1e3] and reset to 1e-5 each round; after each round every valid
// edge reclassified against its chi2 threshold.
//
// What bounds it on an H100: neither bytes (28 B a row, 57 KB a pass at
// N = 2048) nor operations (about 300 a row a pass), but the latency of a
// chain of 44 dependent block-wide reductions (4 x 10 iterations and one a
// round), each followed by a serial 6x6 solve. What the design does about
// it:
//
//   * one block of 512 threads a problem; thread t owns rows t, t + 512, ...
//     and keeps their valid, stereo and inlier flags as bits of three
//     registers (so N <= 512 x 32); the rows' floats are read through the
//     L1 cache in every pass;
//   * one pass an iteration, not two: the pass at the candidate pose sums
//     the candidate's cost together with H and b there. On accept they are
//     the next iteration's system; on reject the pose and the inliers are
//     unchanged, so the system is too, and only lambda moves. The cost at an
//     accepted pose is thus carried, never recomputed: the same function of
//     the same pose. A round's reclassification and the next round's first
//     system are one pass. So 1 + rounds x (iters + 1) passes in all;
//   * a pass's 29 sums (21 of H, 6 of b, the cost, the inlier count) are
//     reduced without atomics in a fixed order: each thread sums its own
//     rows in float32, a warp folds its 32 lanes' partials in float64 by a
//     transposing butterfly (31 shuffles, after which lane l holds sum l),
//     and warp 0 adds the 16 warps' sums in order. Two calls give the same
//     bits;
//   * thread 0 solves the damped system by Cholesky in float64 (Hd is
//     symmetric positive definite: a sum of J^T W J with W >= 0, plus
//     1e-8 I; a non-finite system gives a non-finite step, whose cost is
//     rejected, as the plain version's failed solve is), applies the
//     exponential map in float32 and hands the pose to the block through
//     shared memory: two barriers an iteration.
//
// No value is held below float32. The launch uses the caller's stream,
// allocates nothing and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 32;  // one bit a row in a 32-bit register
constexpr int kSlots = 32;          // the reduction's width: one a lane
constexpr int kB = 21, kCost = 27, kCount = 28;
constexpr float kChi2Mono = 5.991f, kChi2Stereo = 7.815f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ float safe_z(float z) {
  return fabsf(z) < 1e-9f ? 1e-9f : z;
}

// torch.clamp(x, min=m): a NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}

// index of (a, c), a <= c, in a 6x6 upper triangle stored row by row
__host__ __device__ constexpr int upper(int a, int c) {
  return a * 6 - a * (a - 1) / 2 + (c - a);
}

// index of (i, j), j <= i, in a lower triangle stored row by row
__host__ __device__ constexpr int lower(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// The thread's rows at pose P (row-major 4x4): their H (upper triangle, row
// by row), b, cost and count, summed in float32 into acc. With `reclass`,
// each valid row's inlier bit is first set to chi2 <= its threshold.
__device__ __forceinline__ void row_sums(
    const float* P, const float* __restrict__ X, const float* __restrict__ obs,
    const float* __restrict__ info, int N, const Cam& cam, uint32_t valid,
    uint32_t stereo, uint32_t& inl, bool reclass, float (&acc)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
  const float r00 = P[0], r01 = P[1], r02 = P[2], t0 = P[3];
  const float r10 = P[4], r11 = P[5], r12 = P[6], t1 = P[7];
  const float r20 = P[8], r21 = P[9], r22 = P[10], t2 = P[11];
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= N) break;
    const uint32_t bit = 1u << k;
    if (!(reclass ? (valid & bit) : (inl & bit))) continue;
    const float X0 = __ldg(X + 3 * i), X1 = __ldg(X + 3 * i + 1),
                X2 = __ldg(X + 3 * i + 2);
    const float o0 = __ldg(obs + 3 * i), o1 = __ldg(obs + 3 * i + 1),
                o2 = __ldg(obs + 3 * i + 2);
    const float w_info = __ldg(info + i);
    const float x = r00 * X0 + r01 * X1 + r02 * X2 + t0;
    const float y = r10 * X0 + r11 * X1 + r12 * X2 + t1;
    const float zr = r20 * X0 + r21 * X1 + r22 * X2 + t2;
    const float z = safe_z(zr);
    const float u = cam.fx * x / z + cam.cx;
    const float e0 = o0 - u;
    const float e1 = o1 - (cam.fy * y / z + cam.cy);
    const float e2 = o2 - (u - cam.bf / z);
    const bool st = stereo & bit;
    const float chi2 =
        w_info * (e0 * e0 + e1 * e1 + (st ? e2 * e2 : 0.f));
    const float dsq = st ? kChi2Stereo : kChi2Mono;
    if (reclass) {
      if (chi2 <= dsq) {
        inl |= bit;
      } else {
        inl &= ~bit;
        continue;
      }
    }
    const bool inside = chi2 <= dsq;
    const float rho =
        inside ? chi2 : 2.f * sqrtf(dsq * clamp_min(chi2, 0.f)) - dsq;
    const float w =
        w_info * (inside ? 1.f : sqrtf(dsq / clamp_min(chi2, 1e-12f)));
    // d(uL, v, uR)/d Xc rows a_r; J_r = [-a_r | a_r x Xc]
    const float iz = 1.f / z, iz2 = iz * iz;
    const float ax = cam.fx * iz, ay = cam.fy * iz;
    const float az0 = -cam.fx * x * iz2, az1 = -cam.fy * y * iz2;
    const float az2 = az0 + cam.bf * iz2;
    float J[3][6];
    J[0][0] = -ax;  J[0][1] = 0.f;  J[0][2] = -az0;
    J[0][3] = -az0 * y;             // a0 = (ax, 0, az0)
    J[0][4] = az0 * x - ax * zr;
    J[0][5] = ax * y;
    J[1][0] = 0.f;  J[1][1] = -ay;  J[1][2] = -az1;
    J[1][3] = ay * zr - az1 * y;    // a1 = (0, ay, az1)
    J[1][4] = az1 * x;
    J[1][5] = -ay * x;
    J[2][0] = -ax;  J[2][1] = 0.f;  J[2][2] = -az2;
    J[2][3] = -az2 * y;             // a2 = (ax, 0, az2)
    J[2][4] = az2 * x - ax * zr;
    J[2][5] = ax * y;
    // the uR row weighs 0 on a mono edge, as in the plain version
    const float W[3] = {w, w, st ? w : 0.f};
    const float e[3] = {e0, e1, e2};
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float g = 0.f;
#pragma unroll
      for (int c = a; c < 6; ++c) {
        float h = 0.f;
#pragma unroll
        for (int r = 0; r < 3; ++r) h += J[r][a] * W[r] * J[r][c];
        acc[upper(a, c)] += h;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) g += J[r][a] * W[r] * e[r];
      acc[kB + a] -= g;
    }
    acc[kCost] += rho;
    acc[kCount] += 1.f;
  }
}

// One step of the transposing butterfly at lane offset O over 2 O sums:
// the lane keeps the half its bit O selects and adds its partner's copy.
template <int O>
__device__ __forceinline__ void fold(double (&v)[kSlots], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const double send = up ? v[k] : v[k + O];
    const double keep = up ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// One pass of the block at pose P: every thread's row sums, reduced in
// float64 in a fixed order into tot (valid after the call in warp 0).
__device__ __forceinline__ void block_pass(
    const float* P, const float* __restrict__ X, const float* __restrict__ obs,
    const float* __restrict__ info, int N, const Cam& cam, uint32_t valid,
    uint32_t stereo, uint32_t& inl, bool reclass,
    double (*red)[kSlots], double* tot) {
  float acc[kSlots];
  row_sums(P, X, obs, info, N, cam, valid, stereo, inl, reclass, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double v[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) v[s] = (double)acc[s];
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  red[warp][lane] = v[0];  // this warp's sum of slot `lane`
  __syncthreads();
  if (warp == 0) {
    double t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w][lane];
    tot[lane] = t;
    __syncwarp();
  }
}

// Thread 0: the candidate exp(dx) T into C, dx solving the damped system
// of sys (H's upper triangle, then b) at lambda lam.
__device__ __forceinline__ void candidate(const double* sys, float lam,
                                          const float* T, float* C) {
  // Cholesky Hd = L L^T (L packed by `lower`), then L y = b, L^T dx = y;
  // one division a column, multiplications by its reciprocal after
  double L[21], inv[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const double hjj = sys[upper(j, j)];
    double d = hjj + (double)lam * hjj + 1e-8;
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[lower(j, k)] * L[lower(j, k)];
    L[lower(j, j)] =
        d > 0.0 ? sqrt(d) : __longlong_as_double(0x7ff8000000000000LL);
    inv[j] = 1.0 / L[lower(j, j)];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      double t = sys[upper(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[lower(i, k)] * L[lower(j, k)];
      L[lower(i, j)] = t * inv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double t = sys[kB + i];
#pragma unroll
    for (int k = 0; k < i; ++k) t -= L[lower(i, k)] * y[k];
    y[i] = t * inv[i];
  }
  float dx[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double t = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t -= L[lower(k, i)] * y[k];
    y[i] = t * inv[i];
    dx[i] = (float)y[i];
  }
  // exp(dx) as geometry/se3.exp: (upsilon, omega), Taylor below 1e-5 rad^2
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  float cA, cB, cC;
  if (th2 < 1e-5f) {
    cA = 1.f - th2 / 6.f;
    cB = 0.5f - th2 / 24.f;
    cC = 1.f / 6.f - th2 / 120.f;
  } else {
    const float th = sqrtf(th2);
    cA = sinf(th) / th;
    cB = (1.f - cosf(th)) / th2;
    cC = (1.f - cA) / th2;
  }
  const float Wm[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  float E[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float tv = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ww =
          Wm[a][0] * Wm[0][c] + Wm[a][1] * Wm[1][c] + Wm[a][2] * Wm[2][c];
      const float I = a == c ? 1.f : 0.f;
      E[a][c] = I + cA * Wm[a][c] + cB * ww;
      tv += (I + cB * Wm[a][c] + cC * ww) * dx[c];
    }
    E[a][3] = tv;
  }
  // C = [E; 0 0 0 1] T
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      C[4 * a + c] = E[a][0] * T[c] + E[a][1] * T[4 + c] + E[a][2] * T[8 + c] +
                     E[a][3] * T[12 + c];
#pragma unroll
  for (int c = 0; c < 4; ++c) C[12 + c] = T[12 + c];
}

__global__ void __launch_bounds__(kThreads, 1) pose_lm_kernel(
    const float* __restrict__ T_init, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ info,
    const uint8_t* __restrict__ is_stereo, const uint8_t* __restrict__ valid,
    int N, Cam cam, int rounds, int iters, float* __restrict__ T_out,
    uint8_t* __restrict__ inl_out, int32_t* __restrict__ n_out) {
  __shared__ float sT[16];        // the accepted pose
  __shared__ float sC[16];        // the pose of the current pass
  __shared__ double sys[kSlots];  // the sums at the accepted pose
  __shared__ double red[kWarps][kSlots];
  __shared__ double tot[kSlots];
  const size_t seq = blockIdx.x;
  T_init += seq * 16;
  X += seq * N * 3;
  obs += seq * N * 3;
  info += seq * N;
  is_stereo += seq * N;
  valid += seq * N;
  uint32_t vbits = 0, sbits = 0;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= N) break;
    vbits |= (__ldg(valid + i) ? 1u : 0u) << k;
    sbits |= (__ldg(is_stereo + i) ? 1u : 0u) << k;
  }
  uint32_t inl = vbits;
  if (threadIdx.x < 16) sT[threadIdx.x] = sC[threadIdx.x] = T_init[threadIdx.x];
  __syncthreads();
  const bool lead = threadIdx.x == 0;
  float lam = 1e-5f;  // thread 0's
  // the first round's system: every valid row an inlier
  block_pass(sC, X, obs, info, N, cam, vbits, sbits, inl, false, red, tot);
  if (lead)
    for (int s = 0; s < kSlots; ++s) sys[s] = tot[s];
  for (int round = 0; round < rounds; ++round) {
    lam = 1e-5f;
    for (int it = 0; it < iters; ++it) {
      if (lead) candidate(sys, lam, sT, sC);
      __syncthreads();
      block_pass(sC, X, obs, info, N, cam, vbits, sbits, inl, false, red,
                 tot);
      if (lead) {
        if (tot[kCost] < sys[kCost]) {  // accept: the pose and its sums
          for (int s = 0; s < 16; ++s) sT[s] = sC[s];
          for (int s = 0; s < kSlots; ++s) sys[s] = tot[s];
          lam *= 0.5f;
        } else {
          lam *= 4.f;
        }
        lam = fminf(fmaxf(lam, 1e-9f), 1e3f);
      }
    }
    // reclassify at the accepted pose; the sums are the next round's system
    if (lead)
      for (int s = 0; s < 16; ++s) sC[s] = sT[s];
    __syncthreads();
    block_pass(sC, X, obs, info, N, cam, vbits, sbits, inl, true, red, tot);
    if (lead)
      for (int s = 0; s < kSlots; ++s) sys[s] = tot[s];
  }
  inl_out += seq * N;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= N) break;
    inl_out[i] = (inl >> k) & 1u;
  }
  if (lead) {
    for (int s = 0; s < 16; ++s) T_out[seq * 16 + s] = sT[s];
    n_out[seq] = (int32_t)sys[kCount];
  }
}

}  // namespace

// S problems of N rows each: T_init (S, 4, 4) float32; X, obs (S, N, 3)
// float32 (obs = uL, v, uR); info (S, N) float32; is_stereo, valid (S, N)
// bool. Outputs: T_out (S, 4, 4) float32, inl_out (S, N) bool, n_out (S,)
// int32. N <= 16384. Returns a CUDA error code.
extern "C" int lld_pose_lm(const void* T_init, const void* X, const void* obs,
                           const void* info, const void* is_stereo,
                           const void* valid, int S, int N, float fx, float fy,
                           float cx, float cy, float bf, int rounds, int iters,
                           void* T_out, void* inl_out, void* n_out,
                           void* stream) {
  if (N < 0 || N > kThreads * kRowsPerThread || rounds < 0 || iters < 0 ||
      S < 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  pose_lm_kernel<<<(unsigned)S, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T_init), static_cast<const float*>(X),
      static_cast<const float*>(obs), static_cast<const float*>(info),
      static_cast<const uint8_t*>(is_stereo),
      static_cast<const uint8_t*>(valid), N, Cam{fx, fy, cx, cy, bf}, rounds,
      iters, static_cast<float*>(T_out), static_cast<uint8_t*>(inl_out),
      static_cast<int32_t*>(n_out));
  return (int)cudaGetLastError();
}
