// All-pairs Hamming distance of packed 256-bit descriptors (XOR + popcount).
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py,
// hamming_matrix_pallas (body _hamming_kernel). On the TPU the main path
// took a bf16 bit-plane matmul instead; this card has a popcount
// instruction, so the kernel serves the tracking match directly.
//
// What bounds it on this card: the write of the result. At the main-path
// shape, 8192 map points x 1024 keypoints, the inputs are 288 KB and the
// int32 output is 32 MB; each output costs 8 XOR + 8 popcount + 8 adds.
//
// Design: a block of 32 x 8 threads owns a 64-row x 64-column output tile.
// The 64 row descriptors are staged in shared memory (2 KB) and read as
// warp-wide broadcasts; each thread keeps its two column descriptors in
// registers and computes 8 rows x 2 columns. Consecutive lanes write
// consecutive columns, so every store is a coalesced 128-byte row segment.
// Any shape is taken: rows and columns past the edge are masked.
#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kTileRows = 64;
constexpr int kColsPerThread = 2;
constexpr int kTileCols = kBX * kColsPerThread;
constexpr int kWords = 8;

__global__ void __launch_bounds__(kBX * kBY)
hamming_matrix_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                      int* __restrict__ out, int p, int n) {
  __shared__ unsigned as[kTileRows][kWords];
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kTileRows * kWords; i += kBX * kBY) {
    const int r = i / kWords;
    const int gr = row0 + r;
    as[r][i % kWords] = gr < p ? a[(size_t)gr * kWords + i % kWords] : 0u;
  }
  unsigned bw[kColsPerThread][kWords];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int gc = col0 + threadIdx.x + c * kBX;
#pragma unroll
    for (int w = 0; w < kWords; ++w) bw[c][w] = gc < n ? b[(size_t)gc * kWords + w] : 0u;
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kTileRows / kBY; ++rr) {
    const int r = threadIdx.y + rr * kBY;
    const int gr = row0 + r;
    if (gr >= p) break;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int gc = col0 + threadIdx.x + c * kBX;
      if (gc < n) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) d += __popc(as[r][w] ^ bw[c][w]);
        out[(size_t)gr * n + gc] = d;
      }
    }
  }
}

}  // namespace

// a: [p, 8] int32; b: [n, 8] int32; out: [p, n] int32 (all contiguous).
extern "C" int osltt_hamming_matrix(const void* a, const void* b, int* out, int p,
                                    int n, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((n + kTileCols - 1) / kTileCols, (p + kTileRows - 1) / kTileRows);
  hamming_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b), out, p, n);
  return static_cast<int>(cudaGetLastError());
}
