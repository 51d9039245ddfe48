// Issue-rate probes behind the kernel designs of csrc/: how many of each
// instruction an H100 SM retires per clock, measured rather than assumed.
//
// Each probe kernel runs kChains independent dependency chains per thread
// over `iters` steps, so that with a full grid the pipe under test, not
// latency, is the limit. The Python side (probe_rates.py) times each
// launch with CUDA events and divides the instructions issued by the time.
//
// mma_b1_tile computes one 16 x 8 tile of popc(a & b) over 256-bit rows
// with mma.m16n8k256 .b1 and.popc, for checking the fragment layout that
// csrc/hamming_matrix.cu relies on.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__global__ void fadd_probe(float* out, int iters) {
  float a[kChains], b[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    a[k] = threadIdx.x * 1e-3f + k;
    b[k] = 0.5f * k - 1.0f;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      a[k] = __fadd_rn(a[k], b[k]);
      b[k] = __fadd_rn(b[k], a[(k + 3) % kChains]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += a[k] + b[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void fmnmx_probe(float* out, int iters) {
  float a[kChains], b[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    a[k] = threadIdx.x * 1e-3f + k;
    b[k] = 0.5f * k - 1.0f;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      a[k] = fminf(a[k], b[k]);
      b[k] = fmaxf(b[k], a[(k + 3) % kChains]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += a[k] + b[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// Hopper's DPX three-input minimum: two minima per instruction
__global__ void vimin3_probe(int* out, int iters) {
  int a[kChains], b[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    a[k] = threadIdx.x * 7 + k;
    b[k] = 13 * k - 40;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      a[k] = __vimin3_s32(a[k], b[k], a[(k + 1) % kChains]);
      b[k] = __vimax3_s32(b[k], a[(k + 3) % kChains], b[(k + 5) % kChains]);
    }
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += a[k] + b[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the CUDA-core Hamming inner step: xor, popcount, add
__global__ void popc_probe(int* out, int iters) {
  unsigned x[kChains];
  int acc[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    x[k] = (threadIdx.x + 1u) * 0x9E3779B9u * (k + 1u);
    acc[k] = 0;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) acc[k] += __popc(x[k] ^ static_cast<unsigned>(i));
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kMmaChains = 4;

__global__ void mma_b1_probe(int* out, int iters) {
  const unsigned a0 = (threadIdx.x + 1u) * 0x9E3779B9u;
  const unsigned a1 = a0 ^ 0x55555555u, a2 = ~a0, a3 = a0 * 3u;
  const unsigned b0 = a0 + 7u, b1 = a1 ^ 0x0F0F0F0Fu;
  int c[kMmaChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < kMmaChains; ++s)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[s][0]), "+r"(c[s][1]), "+r"(c[s][2]), "+r"(c[s][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kMmaChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void mma_s8_probe(int* out, int iters) {
  const unsigned a0 = (threadIdx.x + 1u) * 0x01010101u & 0x01010101u;
  const unsigned a1 = a0 ^ 0x01000100u, a2 = a0 ^ 0x00010001u, a3 = 0x01010101u;
  const unsigned b0 = a1, b1 = a2;
  int c[kMmaChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int s = 0; s < kMmaChains; ++s)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[s][0]), "+r"(c[s][1]), "+r"(c[s][2]), "+r"(c[s][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kMmaChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warp: out[16][8] = popc(a[r] & b[c]) over 8 words, with a [16][8] and
// b [8][8] row-major words. Thread (g = lane / 4, q = lane % 4) holds words
// q and q + 4 of A rows g and g + 8 and of B column g; `rows_first` picks
// which of the two register orders {g, g+8, g, g+8} (0) or {g, g, g+8, g+8}
// (1) the fragment takes.
__global__ void mma_b1_tile(const unsigned* a, const unsigned* b, int* out, int rows_first) {
  const int g = threadIdx.x >> 2, q = threadIdx.x & 3;
  unsigned a0, a1, a2, a3;
  if (rows_first) {
    a0 = a[g * 8 + q]; a1 = a[g * 8 + q + 4]; a2 = a[(g + 8) * 8 + q]; a3 = a[(g + 8) * 8 + q + 4];
  } else {
    a0 = a[g * 8 + q]; a1 = a[(g + 8) * 8 + q]; a2 = a[g * 8 + q + 4]; a3 = a[(g + 8) * 8 + q + 4];
  }
  const unsigned b0 = b[g * 8 + q], b1 = b[g * 8 + q + 4];
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  out[g * 8 + 2 * q] = c0;
  out[g * 8 + 2 * q + 1] = c1;
  out[(g + 8) * 8 + 2 * q] = c2;
  out[(g + 8) * 8 + 2 * q + 1] = c3;
}

}  // namespace

// which: 0 fadd, 1 fmnmx, 2 vimin3, 3 popc, 4 mma_b1, 5 mma_s8
extern "C" int probe_launch(int which, void* out, int iters, int blocks, int threads,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: fadd_probe<<<blocks, threads, 0, s>>>(static_cast<float*>(out), iters); break;
    case 1: fmnmx_probe<<<blocks, threads, 0, s>>>(static_cast<float*>(out), iters); break;
    case 2: vimin3_probe<<<blocks, threads, 0, s>>>(static_cast<int*>(out), iters); break;
    case 3: popc_probe<<<blocks, threads, 0, s>>>(static_cast<int*>(out), iters); break;
    case 4: mma_b1_probe<<<blocks, threads, 0, s>>>(static_cast<int*>(out), iters); break;
    case 5: mma_s8_probe<<<blocks, threads, 0, s>>>(static_cast<int*>(out), iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_mma_b1_tile(const void* a, const void* b, void* out, int rows_first,
                                 void* stream) {
  mma_b1_tile<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b), static_cast<int*>(out),
      rows_first);
  return static_cast<int>(cudaGetLastError());
}
