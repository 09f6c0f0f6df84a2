// Hopper (sm_90a) building blocks: mbarriers, tile loads by the Tensor
// Memory Accelerator (TMA) described by tensor maps, and the warpgroup
// matrix multiply (wgmma) with A in registers (int8 weights widened to
// bf16 there) and B in shared memory.
//
// A kernel built on them keeps a ring of shared-memory stages: one
// producer thread issues a stage's TMA loads, which report their bytes to
// the stage's "full" mbarrier; the consumer warps wait on it, run their
// products, and arrive on the stage's "empty" mbarrier, which the producer
// waits on before it loads the stage again.  Tensor maps are encoded on the
// host (encode_tiled_2d, through the entry point of cuTensorMapEncodeTiled
// that the CUDA runtime hands out, so the library needs no -lcuda) and
// passed to the kernel as `const __grid_constant__ CUtensorMap`
// parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bvq {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers (64-bit, in shared memory)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// waits until the phase of parity `parity` has completed (a barrier's
// phases complete in order 0, 1, 0, ...: the c-th completion, from 0, has
// parity c & 1)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box of `map` at coordinates (c0 innermost, c1) into shared dst; its
// bytes complete on bar (elements outside the tensor arrive as zeros and
// count as bytes too)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The descriptor of a K-major operand tile in shared memory written by TMA
// with 128-byte swizzling: rows of 64 bf16 (128 bytes), 8-row groups 1,024
// bytes apart, the tile 1,024-byte aligned.  The k-th 16-deep slice starts
// 32 k bytes further on.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4)           // start address, 16-byte units
         | (1ull << 16)                    // leading byte offset (unused when swizzled)
         | (uint64_t(1024 >> 4) << 32)     // stride byte offset: one 8-row group
         | (1ull << 62);                   // layout: 128-byte swizzle
}

// d[64 x 64] += a[64 x 16] (bf16, registers) * b[16 x 64] (bf16, shared
// memory, K-major, descriptor desc_b), f32 accumulators (always added to:
// start them at zero).  Per warp w of the warpgroup, a holds rows 16 w ..
// 16 w + 15 in mma.m16n8k16's A layout (lane 4 g + t: rows g and g + 8,
// columns 2 t, 2 t + 1 and + 8); d[4 j + i] is row 16 w + g + 8 (i / 2),
// column 8 j + 2 t + i % 2.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p_acc;\n"
      "setp.ne.b32 p_acc, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p_acc, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// ---------------------------------------------------------------------------
// int8 weights as wgmma's A operand, widened to bf16 in registers (exact).

// v holds four int8 (bytes 0-3): even = bf16x2 (byte 0, byte 2), odd =
// bf16x2 (byte 1, byte 3), the first of each pair in the low half.  Each
// byte, biased by 128, becomes the low bits of the f32 2^23 + u, from
// which 2^23 + 128 is subtracted exactly.
__device__ __forceinline__ void widen_i8x4(uint32_t v, uint32_t& even, uint32_t& odd) {
  const uint32_t u = v ^ 0x80808080u, magic = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(u, magic, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, magic, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, magic, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, magic, 0x7443)) - 8388736.f;
  const __nv_bfloat162 e = __floats2bfloat162_rn(f0, f2), o = __floats2bfloat162_rn(f1, f3);
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// A warp's A fragments of two 16-deep slices, into a[s] and a[s + 1]:
// rows [32 h, 32 h + 32) of a [K, 64 N] int8 tile stored by TMA with
// 64-byte swizzling (row r's 16-byte chunk c at chunk c ^ ((r >> 1) & 3));
// the warp's 16 columns are chunk `chunk`.  One transposing ldmatrix of 8
// rows x 8 byte pairs hands lane 4 g + t the pairs (2 g, 2 g + 1) of rows
// 2 t and 2 t + 1, so a fragment's row g stands for column 2 g of the
// chunk and row g + 8 for column 2 g + 1: the product's row 16 w + g + 8 e
// is weight column 16 chunk + 2 g + e.
template <int S>
__device__ __forceinline__ void i8_tile_a_frags(uint32_t (&a)[S][4], int s,
                                                const unsigned char* tile, int h, int chunk,
                                                int lane) {
  const int r = 32 * h + lane;
  uint32_t q[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
               : "r"(smem_addr(tile + r * 64 + ((chunk ^ ((r >> 1) & 3)) << 4)))
               : "memory");
  widen_i8x4(q[0], a[s][0], a[s][1]);
  widen_i8x4(q[1], a[s][2], a[s][3]);
  widen_i8x4(q[2], a[s + 1][0], a[s + 1][1]);
  widen_i8x4(q[3], a[s + 1][2], a[s + 1][3]);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps

// A 2-D tensor map over a row-major [rows, cols] matrix of `elem_bytes`
// elements at ptr (the row stride cols * elem_bytes a multiple of 16, ptr
// 16-byte aligned), boxes of [box_rows, box_cols] with the given swizzle;
// elements outside the matrix load as zeros.
static cudaError_t encode_tiled_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                                   const void* ptr, long rows, long cols, int box_rows,
                                   int box_cols, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace bvq
