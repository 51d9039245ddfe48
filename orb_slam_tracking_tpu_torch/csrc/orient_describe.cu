// Orientation and rBRIEF description of keypoints in one pass, one warp per
// keypoint ("B4f").
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py, moments_at_pallas
// (B4) on the atlas extractor's path, together with what the JAX extractor
// runs between it and the descriptor words: the angle (ops/atlas.py,
// degrees(arctan2) + 360 where negative), the pattern rotation and cvRound
// and the rint of the blurred level (ops/brief.py, descriptors_at), and
// brief_sample_pallas (B2) with its compare and pack_bits.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. A
// keypoint reads its 31 x 31 disc window (~3.8 KB, mostly from L2) and 512
// scattered samples of the blurred canvas (within a 39 x 39 window) and
// writes one angle and 8 words; at 1,000-2,000 keypoints that is ~3-5 MB of
// distinct pixels (~1-1.5 us at 3.35 TB/s) and ~3 MFLOP. The time is one
// warp's dependent chain: the window load, the disc sums, atan2f / cosf /
// sinf, then the sample gathers, whose 32 lanes touch up to 32 cache
// sectors each. On an H100 (700 W) chip_smoke.py reads 0.0081 ms at 1,000
// keypoints and 0.0105 at 2,000, against a bytes bound of 0.0009 / 0.0014
// and a 1-element fill_ of 0.0010: more than the standalone moments and
// BRIEF kernels together (0.0058 / 0.0079), but one launch in place of
// the ~27 of the chain it replaces (PERF.md).
//
// Design: the warp first takes the disc moments exactly as moments_at.cu
// does (disc_moments.cuh, explicitly rounded, so equal to
// moments_at_reference bit for bit), in every lane. Each lane then computes
// the angle as the plain chain does on the card: atan2f times torch's f32
// rad2deg multiplier, + 360 where negative (lane 0 writes it out), then
// theta by torch's f32 deg2rad multiplier, cosf and sinf. Lane k handles
// pairs j*32 + k for j = 0..7: it rotates both pattern points with
// separately rounded products (__fmul_rn / __fsub_rn / __fadd_rn, so no
// FMA moves a coordinate across .5), rounds with rintf as torch.round,
// truncates xy + r to int before adding the pad (as .to(int32) + pad),
// clamps to the canvas, and samples rintf(blurred): rounding the sample
// equals rounding the canvas first, so the canvas-wide round pass is gone.
// All 16 gathers of a lane are issued before the first ballot, so they
// are in flight together. __ballot_sync over I(p1) < I(p2) yields word j
// in pack_bits' order (bit k = pair j*32 + k). The pattern (2 x 512
// floats) sits in shared memory, its loads issued at the start and stored
// after the moments, so their latency hides behind the disc sums; lanes
// read consecutive entries, so there are no bank conflicts. Only the [N] angles and [N, 8] words reach device memory.
// Any N is taken.
//
// Batched: B sequences' keypoints, [B, N], in one launch. Warp k takes
// keypoint k % N of sequence k / N and reads that sequence's canvas (stride
// h * w) and blurred canvas (stride hp * wp); the disc window and the
// samples are clamped to the sequence's own canvas, as in the single call,
// so no read crosses into a neighbour. The multi-sequence tracking step
// orients and describes all B x N keypoints this way ([B, 1000] keypoints
// on [B, 2514, 768] canvases): 0.0186 / 0.0372 ms at B = 4 / 8 against
// 0.0287 / 0.0686 for B single launches (chip_smoke.py [multiseq], H100
// 80GB HBM3 at 700 W).
#include <cuda_runtime.h>

#include "disc_moments.cuh"

namespace {

// one warp a block: every warp runs its chain without waiting at a block
// barrier for the others' disc sums (faster on the card than 2, 4 or 8)
constexpr int kWarpsPerBlock = 1;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kPairs = 256;
constexpr int kPoints = 2 * kPairs;
constexpr int kWords = kPairs / 32;
constexpr int kPatternPerThread = 2 * kPoints / kThreads;
constexpr float kRad2Deg = 57.29577951308232f;    // torch.rad2deg's f32 multiplier
constexpr float kDeg2Rad = 0.017453292519943295f;  // torch.deg2rad's f32 multiplier

__global__ void __launch_bounds__(kThreads)
orient_describe_kernel(const float* __restrict__ img, int h, int w,
                       const float* __restrict__ blurred, int hp, int wp,
                       const int* __restrict__ yc, const int* __restrict__ xc,
                       const float* __restrict__ xy, const float* __restrict__ pattern_xy,
                       osltt::Umax umax, int pad, float* __restrict__ angle_out,
                       int* __restrict__ desc_out, int n, int total) {
  __shared__ float win[kWarpsPerBlock][osltt::kDiscWindow];
  __shared__ float pat[2 * kPoints];  // the x row, then the y row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kp = blockIdx.x * kWarpsPerBlock + warp;
  const bool active = kp < total;  // uniform across the warp
  const int seq = active ? kp / n : 0;
  img += (size_t)seq * h * w;
  blurred += (size_t)seq * hp * wp;

  // the pattern's loads go out first and land in shared memory after the
  // moments, so their latency hides behind the disc sums
  float staged[kPatternPerThread];
#pragma unroll
  for (int k = 0; k < kPatternPerThread; ++k)
    staged[k] = __ldg(pattern_xy + k * kThreads + threadIdx.x);
  float2 m = make_float2(0.f, 0.f);
  if (active) m = osltt::warp_disc_moments(img, h, w, yc[kp], xc[kp], umax, win[warp], lane);
#pragma unroll
  for (int k = 0; k < kPatternPerThread; ++k) pat[k * kThreads + threadIdx.x] = staged[k];
  __syncthreads();
  if (!active) return;

  float angle = __fmul_rn(atan2f(m.y, m.x), kRad2Deg);
  if (angle < 0.f) angle = __fadd_rn(angle, 360.f);
  if (lane == 0) angle_out[kp] = angle;

  const float theta = __fmul_rn(angle, kDeg2Rad);
  const float ca = cosf(theta);
  const float sa = sinf(theta);
  const float x = xy[2 * kp];
  const float y = xy[2 * kp + 1];

  auto sample = [&](int p) {
    const float px = pat[p];
    const float py = pat[kPoints + p];
    const float rx = rintf(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sa)));
    const float ry = rintf(__fadd_rn(__fmul_rn(px, sa), __fmul_rn(py, ca)));
    const int sx = osltt::clamp_index(static_cast<int>(__fadd_rn(x, rx)) + pad, wp - 1);
    const int sy = osltt::clamp_index(static_cast<int>(__fadd_rn(y, ry)) + pad, hp - 1);
    return rintf(__ldg(blurred + (size_t)sy * wp + sx));
  };

  // all 16 gathers first, so they are in flight together; then the ballots
  float first[kWords];
  float second[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    first[j] = sample(j * 32 + lane);
    second[j] = sample(kPairs + j * 32 + lane);
  }
  unsigned mine = 0u;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const unsigned word = __ballot_sync(0xffffffffu, first[j] < second[j]);
    if (lane == j) mine = word;
  }
  if (lane < kWords) desc_out[(size_t)kp * kWords + lane] = static_cast<int>(mine);
}

}  // namespace

// img: [batch, h, w] f32 canvases; blurred: [batch, hp, wp] f32 blurred
// canvases (not rounded); yc, xc: [batch, n] int32 absolute canvas pixels of
// the disc centres; xy: [batch, n, 2] f32 integer-valued keypoint coords
// (x, y) inside the pad; pattern_xy: [2, 512] f32 (x row, y row; pair i is
// points i and 256 + i); umax_host: 16 host ints; angle: [batch, n] f32;
// desc: [batch, n, 8] int32.
extern "C" int osltt_orient_describe(const float* img, int h, int w, const float* blurred,
                                     int hp, int wp, const int* yc, const int* xc,
                                     const float* xy, const float* pattern_xy,
                                     const int* umax_host, int pad, float* angle, int* desc,
                                     int batch, int n, void* stream) {
  osltt::Umax umax;
  for (int i = 0; i <= osltt::kDiscR; ++i) umax.v[i] = umax_host[i];
  const int total = batch * n;
  const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  orient_describe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, h, w, blurred, hp, wp, yc, xc, xy, pattern_xy, umax, pad, angle, desc, n, total);
  return static_cast<int>(cudaGetLastError());
}
