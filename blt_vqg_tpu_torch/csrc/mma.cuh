// Tensor-core building blocks shared by the bf16 attention kernels
// (csrc/ring_attention.cu, csrc/flash_attention.cu), on the primitives of
// common.cuh (16-byte cp.async loads into shared memory, ldmatrix
// fragments, mma.sync m16n8k16, bf16 x bf16 -> f32): whole-tile products
// and the backward's products of f32 values fed as hi + lo bf16 pairs.
// Each 16-deep slice is summed by the tensor core from zero and added in
// f32: the tensor core truncates its own sums.
#pragma once

#include "common.cuh"

namespace bvq {

constexpr int MMA_DT = 128 / 8;  // head-dim columns of 8, up to a head dim of 128

__device__ __forceinline__ void rb_load4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(rf_sa(dst)), "l"(src)
               : "memory");
}

// two 8x8 b16 matrices from shared memory: lanes 0-15 give the addresses
// (lane l: row l % 8 of matrix l / 8); register i holds matrix i
__device__ __forceinline__ void rf_ldsm2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(rf_sa(p))
               : "memory");
}

// The head-dim-256 forwards (flash_fwd_mma_kernel<256>, ring_fwd_mma_kernel
// <256>) give each 16-row tile two warps, one for each half of the output's
// columns; the pair meets at a named barrier of its own (id 1 + the block's
// row tile, up to 4 tiles; 0 is __syncthreads).  Constant ids: ptxas then
// reserves only the barriers used, not all 16.
__device__ __forceinline__ void pair_sync(int tile) {
  switch (tile) {
    case 0: asm volatile("bar.sync 1, 64;\n" ::: "memory"); break;
    case 1: asm volatile("bar.sync 2, 64;\n" ::: "memory"); break;
    case 2: asm volatile("bar.sync 3, 64;\n" ::: "memory"); break;
    default: asm volatile("bar.sync 4, 64;\n" ::: "memory"); break;
  }
}

// the columns of an output split between the two warps of a row tile, in
// whole 16-column slices: half 0 takes the first ceil(dp / 32) slices
struct PairCols {
  int c0;  // the warp's first column
  int cw;  // its columns (a multiple of 16, at most 128)
};

__device__ __forceinline__ PairCols pair_cols(int dp, int half) {
  const int n16 = dp / 16, lo = (n16 + 1) / 2;
  return half ? PairCols{16 * lo, 16 * (n16 - lo)} : PairCols{0, 16 * lo};
}

// The pair's exchange, for the rows gr and gr + 8 of its tile.  The row
// maxima over both halves: each warp's own (mx, over its key columns)
// reduced over the lane quad, through red ([16][2]: the tile's rows, each
// half's maximum) at the pair's barrier.
__device__ __forceinline__ void pair_row_max(float (&m)[2], const float (&mx)[2], float* red,
                                             int gr, int tq, int half, int tile) {
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    m[y] = fmaxf(mx[y], __shfl_xor_sync(0xffffffffu, mx[y], 1));
    m[y] = fmaxf(m[y], __shfl_xor_sync(0xffffffffu, m[y], 2));
    if (tq == 0) red[(gr + 8 * y) * 2 + half] = m[y];
  }
  pair_sync(tile);
#pragma unroll
  for (int y = 0; y < 2; ++y) m[y] = fmaxf(red[(gr + 8 * y) * 2], red[(gr + 8 * y) * 2 + 1]);
}

// Keys 16 jp .. + 15 of the tile's f32 p rows (pf: row gr of the tile, row
// stride pld), written by both warps: the A operand of o += p v, rounded to
// bf16, and psum[y] += the lane's p of row gr + 8y, in the order of a warp
// that holds the whole row (key columns of 8, then the lane's two keys)
__device__ __forceinline__ void pair_p_slice(uint32_t (&pa)[4], float (&psum)[2], const float* pf,
                                             int pld, int jp, int tq) {
  float2 v[2][2];  // [8-key half x][row gr + 8 y]: the lane's two keys
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      v[x][y] = *reinterpret_cast<const float2*>(pf + 8 * y * pld + 16 * jp + 8 * x + 2 * tq);
      psum[y] += v[x][y].x;
      psum[y] += v[x][y].y;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) pa[r] = rf_pack(v[r >> 1][r & 1].x, v[r >> 1][r & 1].y);
}

// x (a 16 x 16 tile held as two m16n8 accumulators) as the A operands hi
// and lo of a product over its 16 columns
__device__ __forceinline__ void rb_split(const float (&x)[2][4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = x[r >> 1][2 * (r & 1)], x1 = x[r >> 1][2 * (r & 1) + 1];
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&v);
    lo[r] = rf_pack(x0 - __low2float(v), x1 - __high2float(v));
  }
}

// acc[2n], acc[2n + 1] += a x the 16 x 16 tile at p (rows: the
// contraction; read transposed), for every 16 columns n of the head dim,
// each 16-deep sum from zero
__device__ __forceinline__ void rf_mma_tile_t(float (&acc)[MMA_DT][4], const uint32_t (&a)[4],
                                              const __nv_bfloat16* p, int lds, int dp,
                                              int lane) {
  const int mi = lane / 8, lr8 = lane % 8;
#pragma unroll
  for (int np = 0; np < MMA_DT / 2; ++np) {
    if (np < dp / 16) {
      uint32_t bf[4];
      rf_ldsm_t(bf, p + (8 * (mi & 1) + lr8) * lds + 16 * np + 8 * (mi >> 1));
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      rf_mma(t0, a, bf[0], bf[1]);
      rf_mma(t1, a, bf[2], bf[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[2 * np][c] += t0[c];
        acc[2 * np + 1][c] += t1[c];
      }
    }
  }
}

// acc[2n], acc[2n + 1] += (hi + lo) x the 16 x 16 tile at p (rows: the
// contraction; read transposed), for every 16 columns n of the head dim
__device__ __forceinline__ void rb_mma_pair(float (&acc)[MMA_DT][4], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], const __nv_bfloat16* p,
                                            int lds, int dp, int lane) {
  const int mi = lane / 8, lr8 = lane % 8;
#pragma unroll
  for (int np = 0; np < MMA_DT / 2; ++np) {
    if (np < dp / 16) {
      uint32_t bf[4];
      rf_ldsm_t(bf, p + (8 * (mi & 1) + lr8) * lds + 16 * np + 8 * (mi >> 1));
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      rf_mma(t0, hi, bf[0], bf[1]);
      rf_mma(t0, lo, bf[0], bf[1]);
      rf_mma(t1, hi, bf[2], bf[3]);
      rf_mma(t1, lo, bf[2], bf[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[2 * np][c] += t0[c];
        acc[2 * np + 1][c] += t1[c];
      }
    }
  }
}

// s[j] += a x rows 16 j' .. of the tile at p (row-major, the contraction
// along each row), two 8-column halves, each 16-deep slice from zero
__device__ __forceinline__ void rb_scores(float (&s)[2][4], const uint32_t (&a)[4],
                                          const __nv_bfloat16* p, int lds, int lane) {
  const int mi = lane / 8, lr8 = lane % 8;
  uint32_t bf[4];
  rf_ldsm(bf, p + (8 * (mi >> 1) + lr8) * lds + 8 * (mi & 1));
  float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
  rf_mma(t0, a, bf[0], bf[1]);
  rf_mma(t1, a, bf[2], bf[3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s[0][c] += t0[c];
    s[1][c] += t1[c];
  }
}

}  // namespace bvq
