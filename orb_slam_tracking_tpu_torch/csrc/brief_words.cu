// rBRIEF sampling, comparison and bit packing, one warp per keypoint.
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py, brief_sample_pallas
// (body _brief_kernel_int on the main path), together with its consumer in
// ops/brief.py: the compare of the two sample halves and pack_bits.
//
// What bounds it on this card: gather latency. Each keypoint reads 512
// scattered pixels of the rint'ed blurred canvas (within a 39 x 39 window)
// and 2 x 512 int32 coordinates; 1024 keypoints move ~6 MB, so the time is
// the dependent load chain, not bandwidth.
//
// Design: lane k of a keypoint's warp handles pairs j*32 + k for j = 0..7.
// Coordinate loads are coalesced (consecutive lanes, consecutive pairs);
// the pixel loads go through the read-only cache, where a keypoint's
// window stays resident. __ballot_sync over I(p1) < I(p2) yields word j
// directly, in pack_bits' little-endian order (bit k = pair j*32 + k), so
// the [N, 512] samples never reach device memory and only [N, 8] words are
// written. Coordinates are clamped to the image, as in the plain version;
// any N is taken, the last block masking the ragged warps.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPairs = 256;

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
brief_words_kernel(const float* __restrict__ img, int hp, int wp,
                   const int* __restrict__ sy, const int* __restrict__ sx,
                   int* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (kp >= n) return;  // uniform across the warp
  const int* ry = sy + (size_t)kp * (2 * kPairs);
  const int* rx = sx + (size_t)kp * (2 * kPairs);
  unsigned mine = 0u;
#pragma unroll
  for (int j = 0; j < kPairs / 32; ++j) {
    const int i = j * 32 + lane;
    const int y1 = clampi(ry[i], hp - 1);
    const int x1 = clampi(rx[i], wp - 1);
    const int y2 = clampi(ry[kPairs + i], hp - 1);
    const int x2 = clampi(rx[kPairs + i], wp - 1);
    const float a = __ldg(img + (size_t)y1 * wp + x1);
    const float b = __ldg(img + (size_t)y2 * wp + x2);
    const unsigned word = __ballot_sync(0xffffffffu, a < b);
    if (lane == j) mine = word;
  }
  if (lane < kPairs / 32) out[(size_t)kp * (kPairs / 32) + lane] = static_cast<int>(mine);
}

}  // namespace

// img: [hp, wp] f32; sy, sx: [n, 512] int32; out: [n, 8] int32 (all contiguous).
extern "C" int osltt_brief_words(const float* img, int hp, int wp, const int* sy,
                                 const int* sx, int* out, int n, void* stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  brief_words_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(img, hp, wp, sy, sx, out, n);
  return static_cast<int>(cudaGetLastError());
}
