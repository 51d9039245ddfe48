// Hamming distances of packed 256-bit descriptors on the tensor cores, with
// two epilogues: the all-pairs matrix, and the matchers' gated row minima.
//
// Replaces: orb_slam_tracking_tpu/ops/pallas_kernels.py,
// hamming_matrix_pallas (body _hamming_kernel). On the TPU the main path
// took a bf16 bit-plane matmul instead, then masked the [P, N] matrix and
// reduced its rows in further passes.
//
// Mainloop. One warp computes the inner products popc(a & b) of 16 rows x 8
// columns of descriptors with one mma.m16n8k256 .b1 and.popc: a fragment
// register holds one 32-bit descriptor word, so the [*, 8] int32 layout
// feeds the tensor cores as it is. The distance is pop(a) + pop(b) -
// 2 popc(a & b), exact in int32. Measured on the H100 (tools/probe_rates.py),
// that mma retires 128 pairs of 256 bits per issue where the CUDA cores
// retire about 2 per clock and SM through __popc, which issues at an eighth
// of the f32 add rate; an s8 mma would need eight issues for the same work.
//
// A block of 16 warps owns a band of 16 x WR rows; its warps split the
// columns WC = 16 / WR ways. Column tiles of 256 descriptors, with their
// popcounts (and, for the gated epilogue, the column gate vectors), are
// staged in shared memory, double-buffered: the next tile's loads are in
// flight while the warps compute on the current one. Descriptor words are
// stored word-major with 8 words of padding, so that a warp's fragment
// loads hit 32 distinct banks. WR is picked per call so that the grid
// holds about one wave of 132 SMs ([8192, N]: 64-row bands; [2048, N]:
// 16-row bands).
//
// Epilogue (a), hamming_matrix: the [P, N] int32 matrix. Bound on this
// card by writing it (32 MB at [8192, 1024]: 10 us at 3.35 TB/s).
//
// Epilogue (b), hamming_gated_min: per row the least distance over the
// eligible columns, its column and the second least. A pair is eligible
// when row_ok & col_ok & |u - x| <= r & |v - y| <= r & lo <= oct <= hi,
// with r = use_row_r ? r_row : r_col; the gate subtractions are __fsub_rn,
// so they equal PyTorch's bit for bit. Each pair becomes one int32 key,
// (distance, or 257 when ineligible) << 21 | column, so that the running
// (best, second) per row is two integer min/max per pair and ties go to the
// lower column, as torch.argmin. Partials merge exactly as best = min(b1,
// b2), second = min(s1, s2, max(b1, b2)): first across the four lanes of a
// quad by shuffles, then across the block's warps in shared memory. The
// [P, N] matrix is never written, so the kernel is bound by its gate and
// reduction instructions (~15 per pair), not by device memory.
//
// Any P and N (N < 2^21) are taken; rows and columns past the edge are
// masked.
//
// Batched: B independent problems [B, P, 8] x [B, N, 8] (with [B, P] row
// gates and [B, N] column gates) in one launch, grid.y over the batch. A
// block offsets every pointer to its problem once at the start, so the
// tile loop, the keys and the merges are the single problem's; the column
// limit and the 16-byte alignment hold per problem (each [N, 8] slab is a
// multiple of 32 bytes). The multi-sequence tracking step takes the gated
// row minima of its B sequences this way, twice a frame ([B, 8192, 8] x
// [B, 1024, 8]): 0.0414 / 0.0784 ms at B = 4 / 8 against 0.0448 / 0.0898
// for B single launches; a bf16 bit-plane torch.bmm of the same inner
// products alone takes 0.0601 / 0.1161 (chip_smoke.py [multiseq], H100
// 80GB HBM3 at 700 W).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): the matrix in
// 0.0135 ms at [8192, 1024] and 0.0070 at [2048, 2048] (a bf16 bit-plane
// torch.mm takes 0.0154 / 0.0087; the __popc kernel this replaces took
// 0.0229 / 0.0129); the gated row minima in 0.0114 ms at the tracking
// step's [8192, 1024] gates and 0.0106 at the init pair's [2048, 2048].
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWords = 8;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kTileCols = kThreads / 2;  // columns staged per step (2 staging threads each)
constexpr int kColPad = kTileCols + 8;
constexpr int kSubtiles = kTileCols / 8;  // mma column groups per tile
constexpr int kIndexBits = 21;
constexpr int kNoPair = 257;  // key value of an ineligible pair: above any distance
constexpr int kBig = 1 << 20;  // the matchers' "nothing eligible" distance
constexpr int kEmptyKey = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == 2 * kTileCols, "two staging threads per column");

struct Params {
  const unsigned* a;  // [p, 8]
  const unsigned* b;  // [n, 8], 16-byte aligned
  int p, n;
  int* out;  // [p, n] (matrix epilogue)
  // gated epilogue: per row
  const float* row_uv;  // [p, 2]
  const float* row_r;
  const unsigned char* row_use;
  const int* row_lo;
  const int* row_hi;
  const unsigned char* row_ok;
  // per column
  const float* col_xy;  // [n, 2]
  const float* col_r;
  const int* col_oct;
  const unsigned char* col_ok;
  int* best;
  int* best_j;
  int* second;
};

__device__ __forceinline__ void mma_and_popc(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (best, second) keys of one row, merged with another partial
__device__ __forceinline__ void merge(int& kb, int& ks, int ob, int os) {
  ks = min(min(ks, os), max(kb, ob));
  kb = min(kb, ob);
}

__device__ __forceinline__ void push(int& kb, int& ks, int key) {
  ks = min(ks, max(kb, key));
  kb = min(kb, key);
}

struct RowGate {
  float u, v, r;  // u is NaN where the row is not ok: every |u - x| <= r fails
  bool use_r;
  int lo, hi;
};

template <int WR, bool kGated>
__global__ void __launch_bounds__(kThreads) hamming_kernel(const Params P) {
  constexpr int WC = kWarps / WR;
  constexpr int kV = kGated ? kTileCols : 1;
  __shared__ unsigned bs[2][kWords][kColPad];
  __shared__ __align__(16) int pbs[2][kTileCols];
  __shared__ __align__(16) int cidx[2][kV];  // column index, all ones past n
  __shared__ __align__(16) float cxs[2][kV];  // NaN where the column is not ok
  __shared__ __align__(16) float cys[2][kV];
  __shared__ __align__(16) float crs[2][kV];
  __shared__ __align__(16) int cos_[2][kV];
  __shared__ int red_b[kGated ? WC : 1][16 * WR];
  __shared__ int red_s[kGated ? WC : 1][16 * WR];

  const int p = P.p, n = P.n;
  const size_t zb = blockIdx.y;  // this block's problem of the batch
  const unsigned* __restrict__ pa_ = P.a + zb * p * kWords;
  const unsigned* __restrict__ pb_ = P.b + zb * n * kWords;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp % WR, wc = warp / WR;
  const int band = blockIdx.x * 16 * WR;
  const int row[2] = {band + wr * 16 + g, band + wr * 16 + g + 8};

  // A fragments: rows g and g + 8 of the warp's 16, words q and q + 4
  unsigned af[2][2] = {{0u, 0u}, {0u, 0u}};
  int pa[2];
  RowGate rg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] < p) {
      af[i][0] = pa_[(size_t)row[i] * kWords + q];
      af[i][1] = pa_[(size_t)row[i] * kWords + q + 4];
    }
    pa[i] = __popc(af[i][0]) + __popc(af[i][1]);
    pa[i] += __shfl_xor_sync(kFull, pa[i], 1);
    pa[i] += __shfl_xor_sync(kFull, pa[i], 2);
    if constexpr (kGated) {
      rg[i] = {__int_as_float(0x7fc00000), 0.0f, 0.0f, true, 0, 0};
      if (row[i] < p) {
        const size_t gr = zb * p + row[i];
        if (P.row_ok[gr]) rg[i].u = P.row_uv[2 * gr];
        rg[i].v = P.row_uv[2 * gr + 1];
        rg[i].r = P.row_r[gr];
        rg[i].use_r = P.row_use[gr] != 0;
        rg[i].lo = P.row_lo[gr];
        rg[i].hi = P.row_hi[gr];
      }
    }
  }

  // staging: thread t takes column t / 2 of a tile, words 4 (t % 2) .. + 3
  const int sc = threadIdx.x >> 1, sh = threadIdx.x & 1;
  uint4 w;
  float sx = 0.0f, sy = 0.0f;  // half 0: x (NaN where not ok), y; half 1: r, oct
  int so = 0;
  auto load = [&](int tile) {
    const int j = tile * kTileCols + sc;
    w = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) w = *reinterpret_cast<const uint4*>(pb_ + (size_t)j * kWords + 4 * sh);
    if constexpr (kGated) {
      if (j >= n) return;
      const size_t gj = zb * n + j;
      if (sh == 0) {
        sx = P.col_ok[gj] ? P.col_xy[2 * gj] : __int_as_float(0x7fc00000);
        sy = P.col_xy[2 * gj + 1];
      } else {
        sx = P.col_r[gj];
        so = P.col_oct[gj];
      }
    }
  };
  auto store = [&](int tile, int buf) {
    bs[buf][4 * sh + 0][sc] = w.x;
    bs[buf][4 * sh + 1][sc] = w.y;
    bs[buf][4 * sh + 2][sc] = w.z;
    bs[buf][4 * sh + 3][sc] = w.w;
    int pc = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    pc += __shfl_xor_sync(kFull, pc, 1);
    if (sh == 0) pbs[buf][sc] = pc;
    if constexpr (kGated) {
      const int j = tile * kTileCols + sc;
      if (sh == 0) {
        cidx[buf][sc] = j < n ? j : kEmptyKey;
        cxs[buf][sc] = sx;
        cys[buf][sc] = sy;
      } else {
        crs[buf][sc] = sx;
        cos_[buf][sc] = so;
      }
    }
  };

  int kb[2] = {kEmptyKey, kEmptyKey}, ks[2] = {kEmptyKey, kEmptyKey};
  const int ntiles = (n + kTileCols - 1) / kTileCols;
  load(0);
  store(0, 0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) load(t + 1);
#pragma unroll
    for (int s = 0; s < kSubtiles / WC; ++s) {
      const int cb = (wc + s * WC) * 8;
      int c[4] = {0, 0, 0, 0};
      mma_and_popc(c, af[0][0], af[1][0], af[0][1], af[1][1], bs[buf][q][cb + g],
                   bs[buf][q + 4][cb + g]);
      const int j = cb + 2 * q;  // this thread's columns j, j + 1 of the tile
      const int2 pb = *reinterpret_cast<const int2*>(&pbs[buf][j]);
      // c[0], c[1]: row g, columns j, j + 1; c[2], c[3]: row g + 8
      int d[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        d[i][0] = pa[i] + pb.x - 2 * c[2 * i];
        d[i][1] = pa[i] + pb.y - 2 * c[2 * i + 1];
      }
      if constexpr (!kGated) {
        const int gj = t * kTileCols + j;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row[i] >= p) continue;
          int* o = P.out + (zb * p + row[i]) * n + gj;
          if (gj + 1 < n && (n & 1) == 0) {
            *reinterpret_cast<int2*>(o) = make_int2(d[i][0], d[i][1]);
          } else {
            if (gj < n) o[0] = d[i][0];
            if (gj + 1 < n) o[1] = d[i][1];
          }
        }
      } else {
        const int2 ci = *reinterpret_cast<const int2*>(&cidx[buf][j]);
        const float2 cx = *reinterpret_cast<const float2*>(&cxs[buf][j]);
        const float2 cy = *reinterpret_cast<const float2*>(&cys[buf][j]);
        const float2 cr = *reinterpret_cast<const float2*>(&crs[buf][j]);
        const int2 co = *reinterpret_cast<const int2*>(&cos_[buf][j]);
        const int idx[2] = {ci.x, ci.y};
        const float xs[2] = {cx.x, cx.y}, ys[2] = {cy.x, cy.y}, rs[2] = {cr.x, cr.y};
        const int os[2] = {co.x, co.y};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float r = rg[i].use_r ? rg[i].r : rs[k];
            const bool ok = (fabsf(__fsub_rn(rg[i].u, xs[k])) <= r) &
                            (fabsf(__fsub_rn(rg[i].v, ys[k])) <= r) &
                            (os[k] >= rg[i].lo) & (os[k] <= rg[i].hi);
            // all-ones index (past n) makes the key kEmptyKey
            push(kb[i], ks[i], ((ok ? d[i][k] : kNoPair) << kIndexBits) | idx[k]);
          }
        }
      }
    }
    if (t + 1 < ntiles) store(t + 1, buf ^ 1);
    __syncthreads();
  }
  if constexpr (kGated) {
    // merge the four lanes of a quad (same rows), then the WC warps of a band
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        const int ob = __shfl_xor_sync(kFull, kb[i], m);
        const int os = __shfl_xor_sync(kFull, ks[i], m);
        merge(kb[i], ks[i], ob, os);
      }
    }
    if (q == 0) {
      red_b[wc][wr * 16 + g] = kb[0];
      red_s[wc][wr * 16 + g] = ks[0];
      red_b[wc][wr * 16 + g + 8] = kb[1];
      red_s[wc][wr * 16 + g + 8] = ks[1];
    }
    __syncthreads();
    if (threadIdx.x < 16 * WR) {
      const int r = band + threadIdx.x;
      int b = red_b[0][threadIdx.x], s = red_s[0][threadIdx.x];
#pragma unroll
      for (int k = 1; k < WC; ++k) merge(b, s, red_b[k][threadIdx.x], red_s[k][threadIdx.x]);
      if (r < p) {
        const int bv = b >> kIndexBits, sv = s >> kIndexBits;
        const size_t gr = zb * p + r;
        P.best[gr] = bv >= kNoPair ? kBig : bv;
        P.best_j[gr] = b & ((1 << kIndexBits) - 1);
        P.second[gr] = sv >= kNoPair ? kBig : sv;
      }
    }
  }
}

// rows per warp band: the most (up to 4 warps' 64) that still gives the
// grid (bands times problems) about one wave of the card's 132 SMs
int rows_per_block(int p, int batch) {
  int wr = 4;
  while (wr > 1 && (p + 16 * wr - 1) / (16 * wr) * batch < 120) wr /= 2;
  return wr;
}

template <bool kGated>
int launch(const Params& P, int batch, void* stream) {
  const int wr = rows_per_block(P.p, batch);
  const dim3 grid((P.p + 16 * wr - 1) / (16 * wr), batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wr == 4) {
    hamming_kernel<4, kGated><<<grid, kThreads, 0, s>>>(P);
  } else if (wr == 2) {
    hamming_kernel<2, kGated><<<grid, kThreads, 0, s>>>(P);
  } else {
    hamming_kernel<1, kGated><<<grid, kThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: [p, 8] int32; b: [n, 8] int32, 16-byte aligned; out: [p, n] int32
// (all contiguous).
extern "C" int osltt_hamming_matrix(const void* a, const void* b, int* out, int p, int n,
                                    void* stream) {
  Params P = {};
  P.a = static_cast<const unsigned*>(a);
  P.b = static_cast<const unsigned*>(b);
  P.p = p;
  P.n = n;
  P.out = out;
  return launch<false>(P, 1, stream);
}

// A batch of problems: a [batch, p, 8] and b [batch, n, 8] int32, the gates
// (row_uv [batch, p, 2] f32, row_r f32, row_use bool, row_lo / row_hi
// int32, row_ok bool, each [batch, p]; col_xy [batch, n, 2] f32, col_r f32,
// col_oct int32, col_ok bool, each [batch, n]) and the outputs best,
// best_j, second [batch, p] int32.
extern "C" int osltt_hamming_gated_min(const void* a, const void* b, int batch, int p, int n,
                                       const void* row_uv, const void* row_r,
                                       const void* row_use, const void* row_lo,
                                       const void* row_hi, const void* row_ok,
                                       const void* col_xy, const void* col_r,
                                       const void* col_oct, const void* col_ok, int* best,
                                       int* best_j, int* second, void* stream) {
  Params P = {};
  P.a = static_cast<const unsigned*>(a);
  P.b = static_cast<const unsigned*>(b);
  P.p = p;
  P.n = n;
  P.row_uv = static_cast<const float*>(row_uv);
  P.row_r = static_cast<const float*>(row_r);
  P.row_use = static_cast<const unsigned char*>(row_use);
  P.row_lo = static_cast<const int*>(row_lo);
  P.row_hi = static_cast<const int*>(row_hi);
  P.row_ok = static_cast<const unsigned char*>(row_ok);
  P.col_xy = static_cast<const float*>(col_xy);
  P.col_r = static_cast<const float*>(col_r);
  P.col_oct = static_cast<const int*>(col_oct);
  P.col_ok = static_cast<const unsigned char*>(col_ok);
  P.best = best;
  P.best_j = best_j;
  P.second = second;
  return launch<true>(P, batch, stream);
}
