// Intensity-centroid disc moments (m10, m01) at given keypoints, one warp
// per keypoint.
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py, moments_at_pallas
// (body _moments_kernel), which the JAX atlas extractor calls instead of the
// dense moment_maps canvas pass when ORB_TPU_KP_MOMENTS=1. The port's atlas
// extractor runs the same body inside orient_describe.cu (B4f); this
// standalone kernel is kept, and checked, for callers that need only the
// moments.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. Each
// keypoint reads its 31 x 31 window (~3.8 KB, mostly from L2: the canvas is
// ~7.6 MB at 640x480) and does ~1,900 f32 operations; at 2,000 keypoints
// the discs cover ~2.7 MB of distinct pixels (0.8 us at 3.35 TB/s) and
// ~4 MFLOP, so the time is one warp's load-then-sum chain.
// 2,000 warps (250 blocks of 8) fill the 132 SMs about twice.
//
// Design: the TPU kernel DMA'd 8x128-aligned 40x256 patches and masked a
// dense [16, 40, 256] product with a 16-term select chain for umax. Here
// one warp takes one keypoint (disc_moments.cuh, shared with
// orient_describe.cu, which runs the same body on the extractor's path):
// the window in shared memory, one row per lane from the kernel's by-value
// umax table, the rows summed in order by shuffles, every operation
// explicitly rounded, so the result equals moments_at_reference bit for
// bit. Any N is taken.
#include <cuda_runtime.h>

#include "disc_moments.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
moments_at_kernel(const float* __restrict__ img, int h, int w,
                  const int* __restrict__ yc, const int* __restrict__ xc, osltt::Umax umax,
                  float* __restrict__ m10, float* __restrict__ m01, int n) {
  __shared__ float win[kWarpsPerBlock][osltt::kDiscWindow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kp = blockIdx.x * kWarpsPerBlock + warp;
  if (kp >= n) return;  // uniform across the warp
  const float2 m = osltt::warp_disc_moments(img, h, w, yc[kp], xc[kp], umax, win[warp], lane);
  if (lane == 0) {
    m10[kp] = m.x;
    m01[kp] = m.y;
  }
}

}  // namespace

// img: [h, w] f32; yc, xc: [n] int32 absolute canvas pixels; umax_host: 16
// host ints (the disc half-width per |dy|, each <= 15); m10, m01: [n] f32.
extern "C" int osltt_moments_at(const float* img, int h, int w, const int* yc,
                                const int* xc, const int* umax_host, float* m10,
                                float* m01, int n, void* stream) {
  osltt::Umax umax;
  for (int i = 0; i <= osltt::kDiscR; ++i) umax.v[i] = umax_host[i];
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  moments_at_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(img, h, w, yc, xc, umax, m10,
                                                           m01, n);
  return static_cast<int>(cudaGetLastError());
}
