// FAST-9/16 corner score at every output pixel, four pixels per thread.
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py, fast_score_pallas
// (body _fast_kernel), the TPU kernel that scores the padded atlas canvas.
//
// What bounds it on this card: the min/max instructions. Each output pixel
// needs one f32 read and one f32 write (about 15 MB at the 640x480 atlas
// canvas, [2514, 768] in, [2476, 730] out: 4.5 us at 3.35 TB/s). The score
// is max(bright, dark) over the 16 cyclic 9-arcs of the ring differences d;
// the TPU kernel and this port's first version took each arc's minimum from
// scratch (8 min per arc and side, 289 FMNMX a pixel in its SASS), and
// min/max issues at half the f32 add rate on Hopper (tools/probe_rates.py).
//
// Design: the nine-tap arc extrema are shared, not recomputed. The dark
// side, max_k min_arc(-d), is -(min_k max_arc d): the bright side's scheme
// with max, negated once. The extrema are taken with Hopper's three-input
// integer min/max (__vimin3_s32, one DPX instruction at the FMNMX rate) on
// an order-preserving int32 key of each f32 difference,
// b ^ ((b >> 31) & 0x7fffffff), mapped back exactly at the end. With
// indices mod 16, m3[k] = min3(d[k], d[k+1], d[k+2]) and the arc minimum
// w9[k] = min3(m3[k], m3[k+3], m3[k+6]); the 16 arc minima take 5 + 2 + 1
// more. 40 three-input min/max per side. The key orders -0 below +0,
// which fminf does not; a difference is -0 only from a -0 pixel, and
// either way the score equals the plain version's in value. (An f32
// doubling form with fminf/fmaxf, 64 minima and 15 maxima per side, was
// tried first and was slower on the card; it is not kept.)
//
// Each step selects an input or negates one, so the score equals
// fast_score_reference exactly (chip_smoke.py holds it so on the card);
// only the sign of a zero score could differ, where a pixel is -0.
//
// 2-D blocks of 32 x 8 threads; a thread scores pixels x, x + 32, x + 64
// and x + 96 of its row (independent chains; every load and store of a
// warp covers 32 consecutive floats). The block stages its 128 x 8 tile
// plus a 3-px apron (134 x 14 floats) in shared memory once. Any shape is
// taken: the block masks the ragged right and bottom edge.
//
// Measured on an H100 80GB HBM3 at 700 W, on the 640x480 atlas canvas:
// 0.021 ms (chip_smoke.py), against 0.047 ms for the form that recomputed
// every arc; ~206 instructions a pixel (tools/probe_rates.py's SASS
// counts), about 60 % of the SM's issue slots.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kPX = 4;  // pixels per thread, kTX apart
constexpr int kR = 3;   // ring radius = apron
constexpr int kTileW = kTX * kPX + 2 * kR;
constexpr int kTileH = kTY + 2 * kR;

// fast.RING_OFFSETS as (dx, dy), clockwise from 12 o'clock; constexpr, so
// that the unrolled taps become immediate shared-memory offsets
__device__ constexpr int ring_dx(int k) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[k];
}
__device__ constexpr int ring_dy(int k) {
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[k];
}

// f32 <-> an int32 key of the same order (-0 just below +0); an involution
__device__ __forceinline__ int order_key(int b) { return b ^ ((b >> 31) & 0x7fffffff); }

__device__ __forceinline__ int max16(const int (&v)[16]) {
  int m[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) m[i] = __vimax3_s32(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
  m[5] = v[15];
  return max(__vimax3_s32(m[0], m[1], m[2]), __vimax3_s32(m[3], m[4], m[5]));
}

__device__ __forceinline__ int min16(const int (&v)[16]) {
  int m[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) m[i] = __vimin3_s32(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
  m[5] = v[15];
  return min(__vimin3_s32(m[0], m[1], m[2]), __vimin3_s32(m[3], m[4], m[5]));
}

__device__ __forceinline__ float arc_score(const float (&d)[16]) {
  int k[16], lo3[16], hi3[16], lo9[16], hi9[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) k[i] = order_key(__float_as_int(d[i]));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo3[i] = __vimin3_s32(k[i], k[(i + 1) & 15], k[(i + 2) & 15]);
    hi3[i] = __vimax3_s32(k[i], k[(i + 1) & 15], k[(i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo9[i] = __vimin3_s32(lo3[i], lo3[(i + 3) & 15], lo3[(i + 6) & 15]);
    hi9[i] = __vimax3_s32(hi3[i], hi3[(i + 3) & 15], hi3[(i + 6) & 15]);
  }
  const float bright = __int_as_float(order_key(max16(lo9)));
  const float dark = __int_as_float(order_key(min16(hi9)));
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(kTX * kTY)
fast_score_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int hp, int wp, int pad) {
  __shared__ float tile[kTileH][kTileW];
  const int h = hp - 2 * pad;
  const int w = wp - 2 * pad;
  const int ox0 = blockIdx.x * kTX * kPX;
  const int oy0 = blockIdx.y * kTY;

  // output (oy, ox) is centred on input (oy + pad, ox + pad)
  for (int i = threadIdx.y * kTX + threadIdx.x; i < kTileH * kTileW; i += kTX * kTY) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int gy = oy0 + pad - kR + ty;
    const int gx = ox0 + pad - kR + tx;
    float v = 0.0f;
    if (gy >= 0 && gy < hp && gx >= 0 && gx < wp) v = in[(size_t)gy * wp + gx];
    tile[ty][tx] = v;
  }
  __syncthreads();

  const int oy = oy0 + threadIdx.y;
  if (oy >= h) return;
  const int cy = threadIdx.y + kR;
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
    const int cx = threadIdx.x + p * kTX + kR;
    const float c = tile[cy][cx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[cy + ring_dy(k)][cx + ring_dx(k)] - c;
    const int ox = ox0 + threadIdx.x + p * kTX;
    if (ox < w) out[(size_t)oy * w + ox] = arc_score(d);
  }
}

}  // namespace

// in: [hp, wp] f32 contiguous; out: [hp - 2 pad, wp - 2 pad] f32 contiguous.
extern "C" int osltt_fast_score(const float* in, float* out, int hp, int wp,
                                int pad, void* stream) {
  const int h = hp - 2 * pad;
  const int w = wp - 2 * pad;
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX * kPX - 1) / (kTX * kPX), (h + kTY - 1) / kTY);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, hp, wp, pad);
  return static_cast<int>(cudaGetLastError());
}
