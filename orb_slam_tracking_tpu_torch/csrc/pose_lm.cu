// The pose-only Levenberg-Marquardt of optim/pose_opt.py (optimize_pose) for
// B streams in one launch, one thread block a stream.
//
// Replaces no TPU kernel: the JAX package's pose LM
// (orb_slam_tracking_tpu/optim/pose_opt.py) is plain XLA, which fuses each
// iteration into a few programs. The port's plain PyTorch version runs every
// pass of every iteration as separate launches over all P map slots, masked:
// ~6-7 thousand launches a batched tracking frame and more than 94 %
// padding in the localization cells. This kernel runs the whole call.
//
// What bounds it on this card: latency. A stream has at most nFeatures
// matched rows (1,000-2,000; the localization cells' LM iterates ~147 /
// ~384); a pass reads each row's point, pixel and weight (24 bytes,
// gathered by slot) and does ~173 flops on it, and an iteration is one
// pass, a block reduction and the serial 6x6 solve: 1 + rounds x
// (iterations + 1) passes a call. On an H100 (700 W) chip_smoke.py reads
// 0.065 ms a call at B = 384 x P = 8,192 with the main path's 56,295
// matched rows and 0.105 ms at 256 x 16,384 with 97,883, against bounds of
// 0.0023 / 0.0036 ms (3.6 / 3.4 %) and the plain version's 112.9 / 149.1 ms
// and ~4,200 launches. The time is the chain of dependent steps: each
// pass's gathers (the row list, then the row's data, from L2), then the
// reduction's barriers, then the solve.
//
// Design:
// - The block first compacts its stream's rows where `valid` is set, in
//   ascending slot order (each warp a contiguous segment of the slots,
//   ballots, one scan of the warps' counts), into the `rows` scratch, and
//   writes `inlier` false on every other slot. Every later pass walks the
//   compacted rows only, row k in thread k % kThreads. Bit 31 of a row's
//   entry marks it inactive (left out by the last reclassification); a
//   thread only ever rewrites its own rows.
// - One pass at a candidate pose gives its robust cost and, in the same
//   sweep, the 21 + 6 sums of H and b that the next iteration needs if the
//   candidate is accepted (the plain version's carried r and J are those
//   at the accepted pose, so recomputing them there gives the same
//   values). So an iteration is one pass, not two; a rejected candidate's
//   sums are dropped. The reclassification after a round
//   (inlier = valid & chi2 <= 5.991 & z > 0) is folded into the next
//   round's first pass, and after the last round into the pass that writes
//   the outputs.
// - Sums: each thread adds its rows in order, then a fixed shuffle tree in
//   each warp, then the warps in order: the same bits on every run, and a
//   stream's answer depends only on its own rows (not on B or on the other
//   streams). No atomics, nothing read on the host.
// - The damped solve (closed-form solve_spd6 or partial-pivot LU, as the
//   caller asks), se3_exp, g2o's predicted gain, Nielsen's update and the
//   accept test are computed by every thread from the reduced sums in
//   shared memory: the same instructions on the same values, so every
//   thread holds the same pose and damping without another barrier. Two
//   buffers of sums alternate: the accepted pose's and the candidate's.
// The arithmetic is the plain version's, in float32, with sums in another
// order: a stream's pose agrees to float32 rounding, not bit for bit. The
// file is built with -fmad=false (kernels/__init__.py), so every product
// and sum is rounded apart, as in the plain version's separate PyTorch ops:
// with products contracted into FMAs, the localization cells' poses parted
// from the plain arithmetic's reference by a median 6.2e-5-7.0e-5 deg, not
// 8.0e-6-8.5e-6, and twice the frames had a match or inlier count apart.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;       // H's upper triangle (21), b (6), the robust cost
constexpr int kCost = 27;
constexpr float kChi2 = 5.991f;  // 95 % for 2 dof
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInactive = static_cast<int>(0x80000000u);

struct Cam {
  float fx, fy, cx, cy;
};

struct Pose {
  float R[9];
  float t[3];
};

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// the row's residual, depth and chi2 under pose P, as _residuals_jac
struct Row {
  float x, y, z, zi, r0, r1, chi2;
};

__device__ __forceinline__ Row project(const Pose& P, const Cam& c, const float* p,
                                       const float* uv, float w_obs) {
  const float X = p[0], Y = p[1], Z = p[2];
  Row o;
  o.x = P.R[0] * X + P.R[1] * Y + P.R[2] * Z + P.t[0];
  o.y = P.R[3] * X + P.R[4] * Y + P.R[5] * Z + P.t[1];
  o.z = P.R[6] * X + P.R[7] * Y + P.R[8] * Z + P.t[2];
  o.zi = 1.f / (fabsf(o.z) < 1e-9f ? 1e-9f : o.z);
  o.r0 = c.fx * o.x * o.zi + c.cx - uv[0];
  o.r1 = c.fy * o.y * o.zi + c.cy - uv[1];
  o.chi2 = (o.r0 * o.r0 + o.r1 * o.r1) * w_obs;
  return o;
}

// adds the row's robust cost and its IRLS-weighted J^T J and J^T r
__device__ __forceinline__ void accumulate(const Row& o, const Cam& c, float w_obs, bool huber,
                                           float delta2, float (&acc)[kSums]) {
  float rho = o.chi2, w = 1.f;
  if (huber && !(o.chi2 <= delta2)) {
    rho = 2.f * sqrtf(delta2 * o.chi2) - delta2;
    w = sqrtf(delta2 / clamp_min(o.chi2, 1e-20f));
  }
  w *= w_obs;
  // J = J_proj [2, 3] @ [-hat(pc) | I] [3, 6], xi = (omega, v)
  const float a0 = c.fx * o.zi, a2 = -c.fx * o.x * o.zi * o.zi;
  const float b1 = c.fy * o.zi, b2 = -c.fy * o.y * o.zi * o.zi;
  const float J0[6] = {a2 * o.y, a0 * o.z - a2 * o.x, -a0 * o.y, a0, 0.f, a2};
  const float J1[6] = {b2 * o.y - b1 * o.z, -b2 * o.x, b1 * o.x, 0.f, b1, b2};
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float w0 = J0[i] * w, w1 = J1[i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += w0 * J0[j] + w1 * J1[j];
    acc[21 + i] += w0 * o.r0 + w1 * o.r1;
  }
  acc[kCost] += rho;
}

// sums v over the block into out, by a fixed tree; every thread reads out
// after the return
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*part)[kSums], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// optim/lm.py inv3x3: adjugate over the determinant, |det| < 1e-12 -> 1e-12
__device__ __forceinline__ void inv3x3(const float (&m)[9], float (&o)[9]) {
  const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7],
              i = m[8];
  const float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  float det = a * A + b * B + c * C;
  if (fabsf(det) < 1e-12f) det = 1e-12f;
  const float adj[9] = {A, -(b * i - c * h), b * f - c * e,
                        B, a * i - c * g,    -(a * f - c * d),
                        C, -(a * h - b * g), a * e - b * d};
#pragma unroll
  for (int k = 0; k < 9; ++k) o[k] = adj[k] / det;
}

// optim/lm.py solve_spd6: 3x3 block Schur elimination with adjugate inverses
__device__ __forceinline__ void solve_spd6(const float (&M)[6][6], const float (&rhs)[6],
                                           float (&x)[6]) {
  float A[9], Bm[9], D[9], Ai[9], AiB[9], S[9], Si[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = M[i][j];
      Bm[3 * i + j] = M[i][3 + j];
      D[3 * i + j] = M[3 + i][3 + j];
    }
  inv3x3(A, Ai);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      AiB[3 * i + j] = Ai[3 * i] * Bm[j] + Ai[3 * i + 1] * Bm[3 + j] + Ai[3 * i + 2] * Bm[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      S[3 * i + j] = D[3 * i + j] - (Bm[i] * AiB[j] + Bm[3 + i] * AiB[3 + j] +
                                     Bm[6 + i] * AiB[6 + j]);
  inv3x3(S, Si);
  float y1[3], r2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y1[i] = Ai[3 * i] * rhs[0] + Ai[3 * i + 1] * rhs[1] + Ai[3 * i + 2] * rhs[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r2[i] = rhs[3 + i] - (Bm[i] * y1[0] + Bm[3 + i] * y1[1] + Bm[6 + i] * y1[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[3 + i] = Si[3 * i] * r2[0] + Si[3 * i + 1] * r2[1] + Si[3 * i + 2] * r2[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = y1[i] - (AiB[3 * i] * x[3] + AiB[3 * i + 1] * x[4] + AiB[3 * i + 2] * x[5]);
}

// Gaussian elimination with partial pivoting (the first largest |pivot|, as
// LAPACK's getrf), then back substitution; a zero pivot gives non-finite x,
// which the caller's cost test rejects. Rows swap by selects, so the
// matrix stays in registers.
__device__ __forceinline__ void solve_lu6(float (&A)[6][6], float (&x)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float a = fabsf(A[i][k]);
      if (a > best) {
        best = a;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool sw = p == i;
#pragma unroll
      for (int j = k; j < 6; ++j) {
        const float hi = A[k][j];
        A[k][j] = sw ? A[i][j] : hi;
        A[i][j] = sw ? hi : A[i][j];
      }
      const float hx = x[k];
      x[k] = sw ? x[i] : hx;
      x[i] = sw ? hx : x[i];
    }
    const float inv = 1.f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      x[i] -= l * x[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// geometry/se3.py se3_exp, then the candidate T <- exp(dx) T
__device__ __forceinline__ Pose step_pose(const Pose& P, const float (&dx)[6]) {
  const float wx = dx[0], wy = dx[1], wz = dx[2];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(th2 + 1e-8f);
  const bool small = th2 < 1e-8f;
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / (th2 + 1e-8f);
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th + 1e-8f);
  const float K[9] = {0.f, -wz, wy, wz, 0.f, -wx, -wy, wx, 0.f};
  float K2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
  float dR[9], V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.f : 0.f;
    dR[k] = eye + a * K[k] + b * K2[k];
    V[k] = eye + b * K[k] + c * K2[k];
  }
  Pose o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.R[3 * i + j] = dR[3 * i] * P.R[j] + dR[3 * i + 1] * P.R[3 + j] + dR[3 * i + 2] * P.R[6 + j];
    const float dt = V[3 * i] * dx[3] + V[3 * i + 1] * dx[4] + V[3 * i + 2] * dx[5];
    o.t[i] = dR[3 * i] * P.t[0] + dR[3 * i + 1] * P.t[1] + dR[3 * i + 2] * P.t[2] + dt;
  }
  return o;
}

// the row passes: kSumsOnly over the active rows; kReclassify first sets
// each row's flag from the pose, then sums over the new active set
enum Pass { kSumsOnly, kReclassify };

template <Pass kMode>
__device__ __forceinline__ void row_pass(const Pose& P, const Cam& c, const float* pts,
                                         const float* uv, const float* w_obs, int* rows, int n,
                                         bool huber, float delta2, float (&acc)[kSums]) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int e = rows[k];
    const int s = e & 0x7fffffff;
    const Row o = project(P, c, pts + 3 * (size_t)s, uv + 2 * (size_t)s, w_obs[s]);
    bool active = e >= 0;
    if (kMode == kReclassify) {
      active = o.chi2 <= kChi2 && o.z > 0.f;
      rows[k] = active ? s : (s | kInactive);
    }
    if (active) accumulate(o, c, w_obs[s], huber, delta2, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
               const float* __restrict__ pts_all, int pts_batched, const float* __restrict__ uv_all,
               const float* __restrict__ w_all, const unsigned char* __restrict__ valid_all,
               const float* __restrict__ K, int n_slots, int rounds, int iters,
               float delta2_coarse, int closed_form, int* __restrict__ rows_all,
               float* __restrict__ R_out, float* __restrict__ t_out,
               unsigned char* __restrict__ inlier_all, int* __restrict__ n_inliers,
               float* __restrict__ chi2_out) {
  __shared__ int counts[kWarps];
  __shared__ float part[kWarps][kSums];
  __shared__ float sums[2][kSums];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)b * n_slots;
  const float* pts = pts_all + (pts_batched ? 3 * base : 0);
  const float* uv = uv_all + 2 * base;
  const float* w_obs = w_all + base;
  const unsigned char* valid = valid_all + base;
  unsigned char* inlier = inlier_all + base;
  int* rows = rows_all + base;

  // compaction: warp w takes slots [lo, hi) in steps of 32
  const int seg = (n_slots + kWarps - 1) / kWarps;
  const int lo = min(n_slots, warp * seg), hi = min(n_slots, lo + seg);
  int mine = 0;
#pragma unroll 4
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    mine += __popc(__ballot_sync(kFull, s < hi && valid[s]));
  }
  if (lane == 0) counts[warp] = mine;
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? counts[w] : 0;
    n += counts[w];
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    const bool v = s < hi && valid[s];
    const unsigned m = __ballot_sync(kFull, v);
    if (v) rows[off + __popc(m & below)] = s;
    else if (s < hi) inlier[s] = 0;
    off += __popc(m);
  }
  __syncthreads();

  const Cam c = {K[0], K[4], K[2], K[5]};
  Pose P;
#pragma unroll
  for (int k = 0; k < 9; ++k) P.R[k] = R0[9 * b + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) P.t[k] = t0[3 * b + k];

  float acc[kSums];
  int cur = 0;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    const float delta2 = rnd == 0 ? delta2_coarse : kChi2;
    if (rnd == 0)
      row_pass<kSumsOnly>(P, c, pts, uv, w_obs, rows, n, huber, delta2, acc);
    else
      row_pass<kReclassify>(P, c, pts, uv, w_obs, rows, n, huber, delta2, acc);
    block_sum(acc, part, sums[cur]);
    float cost = sums[cur][kCost];
    float lam = 1e-4f, nu = 2.f;
    for (int it = 0; it < iters; ++it) {
      const float* S = sums[cur];
      float H[6][6], g[6], dx[6];
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = S[k++];
        g[i] = S[21 + i];
      }
      float Hd[6][6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) Hd[i][j] = H[i][j];
        Hd[i][i] = H[i][i] + lam * H[i][i];
        dx[i] = -g[i];
      }
      if (closed_form) {
        const float rhs[6] = {dx[0], dx[1], dx[2], dx[3], dx[4], dx[5]};
        solve_spd6(Hd, rhs, dx);
      } else {
        solve_lu6(Hd, dx);
      }
      const Pose Pn = step_pose(P, dx);
      // g2o's predicted decrease: 0.5 dx^T (lam D dx - b)
      float pred = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) pred += dx[i] * (lam * H[i][i] * dx[i] - g[i]);
      pred *= 0.5f;

      row_pass<kSumsOnly>(Pn, c, pts, uv, w_obs, rows, n, huber, delta2, acc);
      block_sum(acc, part, sums[cur ^ 1]);
      const float new_cost = sums[cur ^ 1][kCost];
      // optim/lm.py nielsen_update
      const float rho = (cost - new_cost) / clamp_min(fabsf(pred), 1e-9f);
      if (rho > 0.f) {
        const float q = 2.f * rho - 1.f;
        lam *= clamp_min(1.f - q * q * q, 1.f / 3.f);
        nu = 2.f;
      } else {
        lam *= nu;
        nu *= 2.f;
      }
      if (new_cost < cost) {
        P = Pn;
        cost = new_cost;
        cur ^= 1;
      }
    }
  }

  // the last reclassification (none without rounds: the inliers are the
  // valid rows), the inlier mask and the inliers' chi2
  float fin[2] = {0.f, 0.f};
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int s = rows[k] & 0x7fffffff;
    const Row o = project(P, c, pts + 3 * (size_t)s, uv + 2 * (size_t)s, w_obs[s]);
    const bool in = rounds == 0 || (o.chi2 <= kChi2 && o.z > 0.f);
    inlier[s] = in;
    if (in) {
      fin[0] += o.chi2;
      fin[1] += 1.f;
    }
  }
  block_sum(fin, part, sums[cur ^ 1]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R_out[9 * b + k] = P.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[3 * b + k] = P.t[k];
    chi2_out[b] = sums[cur ^ 1][0];
    n_inliers[b] = static_cast<int>(sums[cur ^ 1][1]);
  }
}

}  // namespace

// batch streams of n_slots rows each: R0 [batch, 3, 3], t0 [batch, 3] f32;
// pts [batch, n_slots, 3] f32, or [n_slots, 3] shared when pts_batched is 0;
// uv [batch, n_slots, 2], w (inverse sigma^2) [batch, n_slots] f32; valid
// [batch, n_slots] bool; K [3, 3] f32; delta2_coarse the first round's Huber
// threshold; closed_form selects solve_spd6 over LU; rows [batch, n_slots]
// int32 scratch; out: R [batch, 3, 3], t [batch, 3] f32, inlier [batch,
// n_slots] bool, n_inliers [batch] int32, chi2 [batch] f32.
extern "C" int osltt_pose_lm(const float* R0, const float* t0, const float* pts, int pts_batched,
                             const float* uv, const float* w, const void* valid, const float* K,
                             int batch, int n_slots, int rounds, int iters, float delta2_coarse,
                             int closed_form, int* rows, float* R, float* t, void* inlier,
                             int* n_inliers, float* chi2, void* stream) {
  pose_lm_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      R0, t0, pts, pts_batched, uv, w, static_cast<const unsigned char*>(valid), K, n_slots,
      rounds, iters, delta2_coarse, closed_form, rows, R, t, static_cast<unsigned char*>(inlier),
      n_inliers, chi2);
  return static_cast<int>(cudaGetLastError());
}
