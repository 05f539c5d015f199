// The frame-pose LM: `rounds` x `iters` Levenberg-Marquardt steps on one
// frame pose with Huber IRLS and round-based inlier reclassification, the
// whole solve in one launch, over point rows alone or point rows and line
// rows (the tracker's joint point+line step). One launch serves S
// independent problems (the multi-sequence driver's S frames): one thread
// block a problem.
//
// It replaces no Pallas kernel. It replaces the XLA-compiled `optimize_pose`
// of lldslam_tpu/optim/pose_opt.py, which the port ran eagerly
// (optim/pose_opt.py `optimize_pose_plain`): some 150 small launches an
// iteration for points, 6,000 a call, and some 14,000 for a 2 x 6 joint
// call, whose host dispatch took most of a tracked frame's time while the
// card idled.
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
// Line rows (fixed 3D lines (X0, d) and their observed endpoints): two
// edges a row, the left view and, where the row has a right observation,
// the right view T_rl T. Each edge's residual is the signed distance of the
// two observed endpoints to the projected infinite line (geometry/lines.py
// `endpoint_residual`), its information gamma^2 / 1.44^(2 octave), its Huber
// delta chi2(mono or stereo, by the row's right observation) x gamma^2;
// its analytic 2x6 Jacobian is taken for the increment of the left pose
// that the step moves (exp(xi) T, so the right view sees T_rl exp(xi) T);
// after each round a valid row is an inlier when its two edges' chi2 sum to
// at most twice its delta. Line rows add to H, b and the cost, not to the
// point inlier count.
//
// What bounds it on an H100: neither bytes (31 B a point row and 63 B a
// line row with their flags and inlier out: 63 KB at N = 2048, 16 KB more
// at M = 256) nor float32 operations a pass (about 340 a point row; 1,015 a
// line row with both views: 45 for its two points in the camera and 485 an
// edge, of which 284 the residual and its Jacobian and 201 the Huber weight
// and the sums; 73 more for the row in a reclassification pass), but the
// latency of a chain of dependent block-wide reductions (1 + rounds x
// (iters + 1) of them), each followed by a serial 6x6 solve.
// What the design does about it:
//
//   * one block of 512 threads a problem; thread t owns point rows t,
//     t + 512, ... and line rows t, t + 512, ..., and keeps their valid,
//     stereo (right observation) and inlier flags as bits of registers (so
//     N, M <= 512 x 32); the rows' floats are read through the L1 cache in
//     every pass. Line rows are templated out of a points-only launch,
//     whose code is the points-only kernel's;
//   * one pass an iteration, not two: the pass at the candidate pose sums
//     the candidate's cost together with H and b there. On accept they are
//     the next iteration's system; on reject the pose and the inliers are
//     unchanged, so the system is too, and only lambda moves. The cost at an
//     accepted pose is thus carried, never recomputed: the same function of
//     the same pose. A round's reclassification and the next round's first
//     system are one pass. So 1 + rounds x (iters + 1) passes in all;
//   * a pass's 29 sums (21 of H, 6 of b, the cost, the point inlier count)
//     are reduced without atomics in a fixed order: each thread sums its own
//     rows in float32 (point rows, then line rows), a warp folds its 32
//     lanes' partials in float64 by a transposing butterfly (31 shuffles,
//     after which lane l holds sum l), and warp 0 adds the 16 warps' sums in
//     order. Two calls give the same bits;
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

// A problem's line rows: world lines (X0, d), the observed endpoints in the
// left and right views, octave, right-observation and valid flags; the
// information's gamma^2, the Huber deltas and the stereo baseline.
struct Lines {
  const float *X0, *d, *x1l, *x2l, *x1r, *x2r;
  const int32_t* octave;
  const uint8_t *has_right, *valid;
  int M;
  float g2, dsq_mono, dsq_stereo, baseline;
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

// One line edge: the residual r (2) of the observed endpoints q (x1, y1,
// x2, y2) to the line through the projections of the line's two points, at
// camera-frame x coordinates xc (this view's) and y, z of C (the left
// camera's points, the same in the right view); with kJac, its Jacobian J
// (2 x 6) along the left pose's increment, in which each point moves by
// (upsilon + omega x C). As geometry/lines.py `endpoint_residual` and
// optim/residuals.py `_endpoint_jacobian` (no z derivative where z is
// clamped; no norm derivative where the norm is).
template <bool kJac>
__device__ __forceinline__ void line_edge(const float (&C)[2][3],
                                          const float (&xc)[2],
                                          const Cam& cam, const float (&q)[4],
                                          float (&r)[2], float (&J)[2][6]) {
  float u[2], v[2], au[2][3], av[2][3];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const bool small = fabsf(C[p][2]) < 1e-9f;
    const float z = small ? 1e-9f : C[p][2];
    u[p] = cam.fx * xc[p] / z + cam.cx;
    v[p] = cam.fy * C[p][1] / z + cam.cy;
    if constexpr (kJac) {
      const float iz = 1.f / z, iz2 = iz * iz;
      au[p][0] = cam.fx * iz;  au[p][1] = 0.f;
      au[p][2] = small ? 0.f : -cam.fx * xc[p] * iz2;
      av[p][0] = 0.f;  av[p][1] = cam.fy * iz;
      av[p][2] = small ? 0.f : -cam.fy * C[p][1] * iz2;
    }
  }
  // m = (u0, v0, 1) x (u1, v1, 1), l = m / |m[:2]|
  const float m0 = v[0] - v[1], m1 = u[1] - u[0];
  const float m2 = u[0] * v[1] - v[0] * u[1];
  const float nrm = sqrtf(m0 * m0 + m1 * m1);
  const float nc = clamp_min(nrm, 1e-9f);
  const float l0 = m0 / nc, l1 = m1 / nc, l2 = m2 / nc;
  r[0] = l0 * q[0] + l1 * q[1] + l2;
  r[1] = l0 * q[2] + l1 * q[3] + l2;
  if constexpr (kJac) {
    const float inc2 = 1.f / (nc * nc);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      // d(u, v)/d xi_j of both points: a . e_j along upsilon_j,
      // (C x a)_j along omega_j
      float du[2], dv[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float *a = au[p], *b = av[p], *c = C[p];
        const int k1 = (j + 1) % 3, k2 = (j + 2) % 3;  // of omega_(j-3)
        du[p] = j < 3 ? a[j] : c[k1] * a[k2] - c[k2] * a[k1];
        dv[p] = j < 3 ? b[j] : c[k1] * b[k2] - c[k2] * b[k1];
      }
      const float dm0 = dv[0] - dv[1], dm1 = du[1] - du[0];
      const float dm2 =
          du[0] * v[1] + u[0] * dv[1] - dv[0] * u[1] - v[0] * du[1];
      const float dn = nrm > 1e-9f ? (m0 * dm0 + m1 * dm1) / nc : 0.f;
      const float d0 = dm0 / nc - m0 * dn * inc2;
      const float d1 = dm1 / nc - m1 * dn * inc2;
      const float d2 = dm2 / nc - m2 * dn * inc2;
      J[0][j] = d0 * q[0] + d1 * q[1] + d2;
      J[1][j] = d0 * q[2] + d1 * q[3] + d2;
    }
  }
}

// Adds one line edge's Huber-weighted H (upper triangle), b and cost at
// information w_info and delta dsq into acc.
__device__ __forceinline__ void add_line_edge(const float (&C)[2][3],
                                              const float (&xc)[2],
                                              const Cam& cam,
                                              const float (&q)[4],
                                              float w_info, float dsq,
                                              float (&acc)[kSlots]) {
  float r[2], J[2][6];
  line_edge<true>(C, xc, cam, q, r, J);
  const float chi2 = w_info * (r[0] * r[0] + r[1] * r[1]);
  const bool inside = chi2 <= dsq;
  const float rho =
      inside ? chi2 : 2.f * sqrtf(dsq * clamp_min(chi2, 0.f)) - dsq;
  const float w =
      w_info * (inside ? 1.f : sqrtf(dsq / clamp_min(chi2, 1e-12f)));
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float g = 0.f;
#pragma unroll
    for (int c = a; c < 6; ++c) {
      float h = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) h += J[k][a] * w * J[k][c];
      acc[upper(a, c)] += h;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) g += J[k][a] * w * r[k];
    acc[kB + a] -= g;
  }
  acc[kCost] += rho;
}

// The thread's line rows at pose P, added to acc (H, b and the cost; not
// the point count). With `reclass`, each valid row's inlier bit is first
// set to (left chi2 + right chi2) <= 2 x its delta.
__device__ __forceinline__ void line_sums(const float* P, const Lines& ln,
                                          const Cam& cam, uint32_t valid,
                                          uint32_t right, uint32_t& inl,
                                          bool reclass, float (&acc)[kSlots]) {
  const float r00 = P[0], r01 = P[1], r02 = P[2], t0 = P[3];
  const float r10 = P[4], r11 = P[5], r12 = P[6], t1 = P[7];
  const float r20 = P[8], r21 = P[9], r22 = P[10], t2 = P[11];
  const float t0r = t0 - ln.baseline;  // T_rl T: row 0 less b x row 3
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= ln.M) break;
    const uint32_t bit = 1u << k;
    if (!(reclass ? (valid & bit) : (inl & bit))) continue;
    float A[3], B[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      A[c] = __ldg(ln.X0 + 3 * i + c);
      B[c] = A[c] + __ldg(ln.d + 3 * i + c);  // X0 + d
    }
    // the rotated points (R X), then the left camera's (R X + t)
    const float ra = r00 * A[0] + r01 * A[1] + r02 * A[2];
    const float rb = r00 * B[0] + r01 * B[1] + r02 * B[2];
    const float C[2][3] = {
        {ra + t0, r10 * A[0] + r11 * A[1] + r12 * A[2] + t1,
         r20 * A[0] + r21 * A[1] + r22 * A[2] + t2},
        {rb + t0, r10 * B[0] + r11 * B[1] + r12 * B[2] + t1,
         r20 * B[0] + r21 * B[1] + r22 * B[2] + t2}};
    const float xl[2] = {C[0][0], C[1][0]};
    const float xr[2] = {ra + t0r, rb + t0r};
    const float ql[4] = {__ldg(ln.x1l + 2 * i), __ldg(ln.x1l + 2 * i + 1),
                         __ldg(ln.x2l + 2 * i), __ldg(ln.x2l + 2 * i + 1)};
    const float qr[4] = {__ldg(ln.x1r + 2 * i), __ldg(ln.x1r + 2 * i + 1),
                         __ldg(ln.x2r + 2 * i), __ldg(ln.x2r + 2 * i + 1)};
    const float w_info =
        ln.g2 / powf(1.44f, 2.f * (float)__ldg(ln.octave + i));
    const bool st = right & bit;
    const float dsq = st ? ln.dsq_stereo : ln.dsq_mono;
    if (reclass) {
      float r[2], J[2][6];
      line_edge<false>(C, xl, cam, ql, r, J);
      float chi2 = w_info * (r[0] * r[0] + r[1] * r[1]);
      if (st) {
        line_edge<false>(C, xr, cam, qr, r, J);
        chi2 += w_info * (r[0] * r[0] + r[1] * r[1]);
      }
      if (chi2 <= 2.f * dsq) {
        inl |= bit;
      } else {
        inl &= ~bit;
        continue;
      }
    }
    add_line_edge(C, xl, cam, ql, w_info, dsq, acc);
    if (st) add_line_edge(C, xr, cam, qr, w_info, dsq, acc);
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

// One pass of the block at pose P: every thread's row sums (point rows,
// then with kLines its line rows), reduced in float64 in a fixed order into
// tot (valid after the call in warp 0).
template <bool kLines>
__device__ __forceinline__ void block_pass(
    const float* P, const float* __restrict__ X, const float* __restrict__ obs,
    const float* __restrict__ info, int N, const Cam& cam, uint32_t valid,
    uint32_t stereo, uint32_t& inl, const Lines& ln, uint32_t lvalid,
    uint32_t lright, uint32_t& linl, bool reclass, double (*red)[kSlots],
    double* tot) {
  float acc[kSlots];
  row_sums(P, X, obs, info, N, cam, valid, stereo, inl, reclass, acc);
  if constexpr (kLines)
    line_sums(P, ln, cam, lvalid, lright, linl, reclass, acc);
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

template <bool kLines>
__global__ void __launch_bounds__(kThreads, 1) pose_lm_kernel(
    const float* __restrict__ T_init, const float* __restrict__ X,
    const float* __restrict__ obs, const float* __restrict__ info,
    const uint8_t* __restrict__ is_stereo, const uint8_t* __restrict__ valid,
    int N, Cam cam, int rounds, int iters, Lines ln,
    float* __restrict__ T_out, uint8_t* __restrict__ inl_out,
    int32_t* __restrict__ n_out, uint8_t* __restrict__ lin_out) {
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
  uint32_t lvbits = 0, lrbits = 0;
  if constexpr (kLines) {
    const size_t M = ln.M;
    ln.X0 += seq * M * 3;
    ln.d += seq * M * 3;
    ln.x1l += seq * M * 2;
    ln.x2l += seq * M * 2;
    ln.x1r += seq * M * 2;
    ln.x2r += seq * M * 2;
    ln.octave += seq * M;
    ln.has_right += seq * M;
    ln.valid += seq * M;
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= ln.M) break;
      lvbits |= (__ldg(ln.valid + i) ? 1u : 0u) << k;
      lrbits |= (__ldg(ln.has_right + i) ? 1u : 0u) << k;
    }
  }
  uint32_t linl = lvbits;
  if (threadIdx.x < 16) sT[threadIdx.x] = sC[threadIdx.x] = T_init[threadIdx.x];
  __syncthreads();
  const bool lead = threadIdx.x == 0;
  float lam = 1e-5f;  // thread 0's
  // the first round's system: every valid row an inlier
  block_pass<kLines>(sC, X, obs, info, N, cam, vbits, sbits, inl, ln, lvbits,
                     lrbits, linl, false, red, tot);
  if (lead)
    for (int s = 0; s < kSlots; ++s) sys[s] = tot[s];
  for (int round = 0; round < rounds; ++round) {
    lam = 1e-5f;
    for (int it = 0; it < iters; ++it) {
      if (lead) candidate(sys, lam, sT, sC);
      __syncthreads();
      block_pass<kLines>(sC, X, obs, info, N, cam, vbits, sbits, inl, ln,
                         lvbits, lrbits, linl, false, red, tot);
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
    block_pass<kLines>(sC, X, obs, info, N, cam, vbits, sbits, inl, ln,
                       lvbits, lrbits, linl, true, red, tot);
    if (lead)
      for (int s = 0; s < kSlots; ++s) sys[s] = tot[s];
  }
  inl_out += seq * N;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= N) break;
    inl_out[i] = (inl >> k) & 1u;
  }
  if constexpr (kLines) {
    lin_out += seq * ln.M;
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= ln.M) break;
      lin_out[i] = (linl >> k) & 1u;
    }
  }
  if (lead) {
    for (int s = 0; s < 16; ++s) T_out[seq * 16 + s] = sT[s];
    n_out[seq] = (int32_t)sys[kCount];
  }
}

}  // namespace

// S problems of N point rows each and, where X0 is not null, M line rows
// each: T_init (S, 4, 4) float32; X, obs (S, N, 3) float32 (obs = uL, v,
// uR); info (S, N) float32; is_stereo, valid (S, N) bool; X0, d (S, M, 3)
// float32; x1l, x2l, x1r, x2r (S, M, 2) float32; octave (S, M) int32;
// has_right, lvalid (S, M) bool; g2 = gamma^2, the line Huber deltas and
// the stereo baseline. Outputs: T_out (S, 4, 4) float32, inl_out (S, N)
// bool, n_out (S,) int32 (point inliers), lin_out (S, M) bool. N, M <=
// 16384. Returns a CUDA error code.
extern "C" int lld_pose_lm(const void* T_init, const void* X, const void* obs,
                           const void* info, const void* is_stereo,
                           const void* valid, int S, int N, float fx, float fy,
                           float cx, float cy, float bf, int rounds, int iters,
                           const void* X0, const void* d, const void* x1l,
                           const void* x2l, const void* x1r, const void* x2r,
                           const void* octave, const void* has_right,
                           const void* lvalid, int M, float g2, float dsq_mono,
                           float dsq_stereo, float baseline, void* T_out,
                           void* inl_out, void* n_out, void* lin_out,
                           void* stream) {
  const int cap = kThreads * kRowsPerThread;
  if (N < 0 || N > cap || M < 0 || M > cap || rounds < 0 || iters < 0 ||
      S < 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const Lines ln{static_cast<const float*>(X0),
                 static_cast<const float*>(d),
                 static_cast<const float*>(x1l),
                 static_cast<const float*>(x2l),
                 static_cast<const float*>(x1r),
                 static_cast<const float*>(x2r),
                 static_cast<const int32_t*>(octave),
                 static_cast<const uint8_t*>(has_right),
                 static_cast<const uint8_t*>(lvalid),
                 M, g2, dsq_mono, dsq_stereo, baseline};
  auto kernel = X0 ? pose_lm_kernel<true> : pose_lm_kernel<false>;
  kernel<<<(unsigned)S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T_init), static_cast<const float*>(X),
      static_cast<const float*>(obs), static_cast<const float*>(info),
      static_cast<const uint8_t*>(is_stereo),
      static_cast<const uint8_t*>(valid), N, Cam{fx, fy, cx, cy, bf}, rounds,
      iters, ln, static_cast<float*>(T_out), static_cast<uint8_t*>(inl_out),
      static_cast<int32_t*>(n_out), static_cast<uint8_t*>(lin_out));
  return (int)cudaGetLastError();
}
