// FAST-9/16 corner score, one thread per output pixel.
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py, fast_score_pallas
// (body _fast_kernel), the TPU kernel that scores the padded atlas canvas.
//
// What bounds it on this card: arithmetic, narrowly. Each output pixel
// needs one f32 read and one f32 write (about 15 MB at the 640x480 atlas
// canvas, [2514, 768] in, [2476, 730] out: 4.5 us at 3.35 TB/s), and the
// 16 ring differences and 2 x 16 nine-tap arc minima are ~305 register
// ops per pixel (0.55 G ops: 8.2 us at the 67 T/s of 32-bit arithmetic).
//
// Design: 2-D blocks of 32 x 8 threads. The block stages its tile plus a
// 3-px apron (38 x 14 floats) in shared memory once, so each input pixel is
// read from device memory about 1.3 times instead of 17. The 16 differences
// (ring - centre) and the per-arc minima live in registers; the dark side
// is the negated difference, as in the plain version, so the result equals
// it bit for bit (only subtraction, negation, min and max are used).
// Any shape is taken: the block masks the ragged right and bottom edge.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kR = 3;  // ring radius = apron
constexpr int kArc = 9;

// fast.RING_OFFSETS as (dx, dy), clockwise from 12 o'clock
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__global__ void __launch_bounds__(kTX * kTY)
fast_score_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int hp, int wp, int pad) {
  __shared__ float tile[kTY + 2 * kR][kTX + 2 * kR];
  const int h = hp - 2 * pad;
  const int w = wp - 2 * pad;
  const int ox0 = blockIdx.x * kTX;
  const int oy0 = blockIdx.y * kTY;

  // output (oy, ox) is centred on input (oy + pad, ox + pad)
  for (int i = threadIdx.y * kTX + threadIdx.x; i < (kTY + 2 * kR) * (kTX + 2 * kR);
       i += kTX * kTY) {
    const int ty = i / (kTX + 2 * kR);
    const int tx = i - ty * (kTX + 2 * kR);
    const int gy = oy0 + pad - kR + ty;
    const int gx = ox0 + pad - kR + tx;
    float v = 0.0f;
    if (gy >= 0 && gy < hp && gx >= 0 && gx < wp) v = in[(size_t)gy * wp + gx];
    tile[ty][tx] = v;
  }
  __syncthreads();

  const int ox = ox0 + threadIdx.x;
  const int oy = oy0 + threadIdx.y;
  if (ox >= w || oy >= h) return;

  const int cy = threadIdx.y + kR;
  const int cx = threadIdx.x + kR;
  const float c = tile[cy][cx];
  float db[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) db[k] = tile[cy + kRingDy[k]][cx + kRingDx[k]] - c;

  float best_b = -INFINITY;
  float best_d = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mb = db[s];
    float md = -db[s];
#pragma unroll
    for (int k = 1; k < kArc; ++k) {
      mb = fminf(mb, db[(s + k) & 15]);
      md = fminf(md, -db[(s + k) & 15]);
    }
    best_b = fmaxf(best_b, mb);
    best_d = fmaxf(best_d, md);
  }
  out[(size_t)oy * w + ox] = fmaxf(best_b, best_d);
}

}  // namespace

// in: [hp, wp] f32 contiguous; out: [hp - 2 pad, wp - 2 pad] f32 contiguous.
extern "C" int osltt_fast_score(const float* in, float* out, int hp, int wp,
                                int pad, void* stream) {
  const int h = hp - 2 * pad;
  const int w = wp - 2 * pad;
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, hp, wp, pad);
  return static_cast<int>(cudaGetLastError());
}
