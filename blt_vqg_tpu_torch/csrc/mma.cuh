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
