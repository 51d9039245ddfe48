// Intensity-centroid disc moments (m10, m01) of one keypoint, taken by one
// warp: the body that moments_at.cu (B4) and orient_describe.cu (B4f) share.
//
// The warp loads the keypoint's 31 x 31 window row by row (lane c takes
// column c, so each row is one coalesced 124-byte read) into its shared
// memory, padded to 33 floats a row; then lane r takes row dy = r - 15: it
// walks dx = 1..umax[|dy|] and builds that row's t and u in the plain
// version's order (t += dx * (plus - minus); u = (u + plus) + minus). The
// warp sums the rows in dy order with shuffles: m10 += t_row for
// dy = -15..15, m01 += dy * u_row for dy != 0. Every operation is an
// explicitly rounded __fadd_rn / __fsub_rn / __fmul_rn, so nothing is
// contracted into an FMA and the result equals moments_at_reference (and
// the dense moment_maps at that pixel) bit for bit. Reads are clamped to
// the canvas, as in the plain version.
#pragma once

#include <cuda_runtime.h>

namespace osltt {

constexpr int kDiscR = 15;                   // HALF_PATCH_SIZE
constexpr int kDiscSide = 2 * kDiscR + 1;    // window rows and columns
constexpr int kDiscStride = kDiscSide + 2;   // 33: lane r reading column c hits bank (r + c) mod 32
constexpr int kDiscWindow = kDiscSide * kDiscStride;  // floats of shared memory a warp needs

// the disc half-width per |dy|, passed to a kernel by value
struct Umax {
  int v[kDiscR + 1];
};

__device__ __forceinline__ int clamp_index(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// (m10, m01) of the disc around canvas pixel (yc, xc), returned in every
// lane. win: this warp's kDiscWindow floats of shared memory.
__device__ __forceinline__ float2 warp_disc_moments(const float* __restrict__ img, int h,
                                                    int w, int yc, int xc, const Umax& umax,
                                                    float* win, int lane) {
  if (lane < kDiscSide) {
    const int y0 = yc - kDiscR;
    const int x = clamp_index(xc - kDiscR + lane, w - 1);
#pragma unroll
    for (int r = 0; r < kDiscSide; ++r)
      win[r * kDiscStride + lane] = __ldg(img + (size_t)clamp_index(y0 + r, h - 1) * w + x);
  }
  __syncwarp();

  float t = 0.f;  // this lane's row: sum of dx * (plus - minus)
  float u = 0.f;  // dy * (sum of the row's pixels)
  if (lane < kDiscSide) {
    const float* row = win + lane * kDiscStride + kDiscR;
    const int dy = lane - kDiscR;
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
  for (int k = 0; k < kDiscSide; ++k) {
    const float tk = __shfl_sync(0xffffffffu, t, k);
    const float uk = __shfl_sync(0xffffffffu, u, k);
    a10 = __fadd_rn(a10, tk);
    if (k != kDiscR) a01 = __fadd_rn(a01, uk);
  }
  return make_float2(a10, a01);
}

}  // namespace osltt
