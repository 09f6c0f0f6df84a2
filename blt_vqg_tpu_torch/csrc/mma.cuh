// Tensor-core building blocks shared by the bf16 attention kernels
// (csrc/ring_attention.cu, csrc/flash_attention.cu): 16-byte cp.async loads
// into shared memory, ldmatrix fragments, mma.sync m16n8k16 (bf16 x bf16 ->
// f32), and the backward's products of f32 values fed as hi + lo bf16
// pairs.  In the fragments of mma.m16n8k16, lane 4 gr + tq holds rows gr
// and gr + 8, columns 2 tq and 2 tq + 1 of each 8 columns.  Each 16-deep
// slice is summed by the tensor core from zero and added in f32: the tensor
// core truncates its own sums.
#pragma once

#include "common.cuh"

namespace bvq {

constexpr int MMA_DT = 128 / 8;  // head-dim columns of 8, up to a head dim of 128

__device__ __forceinline__ uint32_t rf_sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes of E elements (16 / sizeof(E) of them) from src into shared dst:
// one cp.async where all are valid and src is 16-byte aligned, else element
// loads, `fill` from index `valid` on
template <typename E>
__device__ __forceinline__ void rf_load16(E* dst, const E* src, int valid, E fill) {
  constexpr int N = 16 / sizeof(E);
  if (valid == N && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(rf_sa(dst)), "l"(src)
                 : "memory");
  } else {
    uint4 u;
    E* el = reinterpret_cast<E*>(&u);
    for (int i = 0; i < N; ++i) el[i] = i < valid ? src[i] : fill;
    *reinterpret_cast<uint4*>(dst) = u;
  }
}

__device__ __forceinline__ void rf_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8; register i holds matrix i (row lane / 4, columns
// 2 (lane % 4) and + 1; transposed with .trans)
__device__ __forceinline__ void rf_ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(rf_sa(p))
               : "memory");
}
__device__ __forceinline__ void rf_ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(rf_sa(p))
               : "memory");
}

// d += a (16 x 16 bf16, row major) * b (16 x 8 bf16, column major), in f32
__device__ __forceinline__ void rf_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo (the lower column) in the low half
__device__ __forceinline__ uint32_t rf_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
