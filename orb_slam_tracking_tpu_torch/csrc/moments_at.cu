// Intensity-centroid disc moments (m10, m01) at given keypoints, one warp
// per keypoint.
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py, moments_at_pallas
// (body _moments_kernel), which the JAX atlas extractor calls instead of the
// dense moment_maps canvas pass when ORB_TPU_KP_MOMENTS=1. The port's atlas
// extractor always takes this kernel.
//
// What bounds it on this card: latency, not bandwidth or arithmetic. Each
// keypoint reads its 31 x 31 window (~3.8 KB, mostly from L2: the canvas is
// ~7.6 MB at 640x480) and does ~1,900 f32 operations; at 2,000 keypoints
// the discs cover ~2.7 MB of distinct pixels (0.8 us at 3.35 TB/s) and
// ~4 MFLOP, so the time is one warp's load-then-sum chain.
// 2,000 warps (250 blocks of 8) fill the 132 SMs about twice.
//
// Design: the TPU kernel DMA'd 8x128-aligned 40x256 patches and masked a
// dense [16, 40, 256] product with a 16-term select chain for umax. Here the
// warp loads its window row by row (lane c takes column c, so each row is
// one coalesced 124-byte read) into shared memory padded to 33 floats a row,
// then lane r takes row dy = r - 15: it walks dx = 1..umax[|dy|] from the
// kernel's by-value umax table and builds that row's t and u in the plain
// version's order (t += dx * (plus - minus); u = (u + plus) + minus). The
// warp then sums the rows in dy order with shuffles: m10 += t_row for
// dy = -15..15, m01 += dy * u_row for dy != 0. Every operation is an
// explicitly rounded __fadd_rn / __fsub_rn / __fmul_rn, so nothing is
// contracted into an FMA and the result equals moments_at_reference (and
// the dense moment_maps at that pixel) bit for bit. Reads are clamped to
// the canvas, as in the plain version; any N is taken.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 15;              // HALF_PATCH_SIZE
constexpr int kSide = 2 * kR + 1;   // window rows and columns
constexpr int kStride = kSide + 2;  // 33: lane r reading column c hits bank (r + c) mod 32
constexpr int kWarpsPerBlock = 8;

struct Umax {
  int v[kR + 1];
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
moments_at_kernel(const float* __restrict__ img, int h, int w,
                  const int* __restrict__ yc, const int* __restrict__ xc, Umax umax,
                  float* __restrict__ m10, float* __restrict__ m01, int n) {
  __shared__ float win[kWarpsPerBlock][kSide * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kp = blockIdx.x * kWarpsPerBlock + warp;
  if (kp >= n) return;  // uniform across the warp
  float* s = win[warp];

  if (lane < kSide) {
    const int y0 = yc[kp] - kR;
    const int x = clampi(xc[kp] - kR + lane, w - 1);
#pragma unroll
    for (int r = 0; r < kSide; ++r)
      s[r * kStride + lane] = __ldg(img + (size_t)clampi(y0 + r, h - 1) * w + x);
  }
  __syncwarp();

  float t = 0.f;  // this lane's row: sum of dx * (plus - minus)
  float u = 0.f;  // dy * (sum of the row's pixels)
  if (lane < kSide) {
    const float* row = s + lane * kStride + kR;
    const int dy = lane - kR;
    const int half = umax.v[dy < 0 ? -dy : dy];
    u = row[0];
    for (int dx = 1; dx <= half; ++dx) {
      const float plus = row[dx];
      const float minus = row[-dx];
      t = __fadd_rn(t, __fmul_rn(static_cast<float>(dx), __fsub_rn(plus, minus)));
      u = __fadd_rn(__fadd_rn(u, plus), minus);
    }
    u = __fmul_rn(static_cast<float>(dy), u);
  }

  float a10 = 0.f;
  float a01 = 0.f;
#pragma unroll
  for (int k = 0; k < kSide; ++k) {
    const float tk = __shfl_sync(0xffffffffu, t, k);
    const float uk = __shfl_sync(0xffffffffu, u, k);
    a10 = __fadd_rn(a10, tk);
    if (k != kR) a01 = __fadd_rn(a01, uk);
  }
  if (lane == 0) {
    m10[kp] = a10;
    m01[kp] = a01;
  }
}

}  // namespace

// img: [h, w] f32; yc, xc: [n] int32 absolute canvas pixels; umax_host: 16
// host ints (the disc half-width per |dy|, each <= 15); m10, m01: [n] f32.
extern "C" int osltt_moments_at(const float* img, int h, int w, const int* yc,
                                const int* xc, const int* umax_host, float* m10,
                                float* m01, int n, void* stream) {
  Umax umax;
  for (int i = 0; i <= kR; ++i) umax.v[i] = umax_host[i];
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  moments_at_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(img, h, w, yc, xc, umax, m10,
                                                           m01, n);
  return static_cast<int>(cudaGetLastError());
}
