// W8A16 product: y[M, N] = (x[M, K] @ w8[K, N]) * scale[N].
//
// Replaces the TPU kernel `int8_matmul` (`_kernel`) of
// blt_vqg_tpu/ops/pallas/int8_matmul.py: the weights stay int8 in device
// memory and are widened inside the kernel, the product accumulates in f32,
// and the per-column scale is applied to the f32 sum before the result is
// rounded to x's type, as the TPU kernel does.
//
// At the shapes it serves (a vocab head or an FFN product at decode batch
// sizes) the product is bound by the int8 weight bytes: 12.3 MB at the
// vocab head (M 64, K 1,024, N 12,000), 3.7 us at 3.35 TB/s.
//
// bf16 x with K % 8 == 0, N % 16 == 0 and 16-byte aligned x and w8 (the
// strides and addresses TMA takes; ops/kernels/int8_matmul.py tma_columns
// decides, from the shapes, before the launch): int8_wgmma_kernel, one
// launch and no workspace.  Block (BN-column tile, 64-row tile of x) walks
// K in 128-deep stages through a ring of I8_STAGES shared-memory stages:
//  - one producer thread issues each stage's TMA loads, the x tile as two
//    [64 rows, 64 K] bf16 boxes with 128-byte swizzling and, per 64
//    columns, a w8 tile [128 K, 64 columns] int8 with 64-byte swizzling
//    (rows and columns past the matrices arrive as zeros), completing on
//    the stage's mbarrier;
//  - each consumer warpgroup computes y^T for its 64 weight columns: the
//    int8 tile becomes wgmma's A operand in registers (transposing
//    ldmatrix, widened to bf16 exactly, hopper.cuh), x^T is B, read by the
//    wgmma from the swizzled tile; a stage's eight 16-deep products are
//    one committed group, and the next stage is widened while they run;
//  - the epilogue scales the f32 accumulators by column (scales loaded
//    before the first stage lands) and stores bf16 pairs, masked at the
//    ragged edges of M and N.
// BN is 128 where 128-column tiles still give about two thirds of a wave
// (the vocab head: 94 blocks of 2 consumer warpgroups), else 64 (FFN in at
// beam width: 128 blocks of 1).  On the card the m64n64 register-A products
// set the pace (about a third of the tensor cores' rate), and 128-deep
// stages halve the waits and commits per byte against 64-deep ones.  Three
// designs measured slower are in PERF.md (row 5): 64-deep stages;
// widening into a shared-memory B tile for m64n128 products on both
// operands in shared memory (the widening, its proxy fence and warpgroup
// barrier each stage cost more than the products saved); two warpgroups a
// column tile splitting each stage's K.  Every 16-deep slice adds into one
// f32 accumulator on the tensor core, as the split-K engine's WMMA does.
//
// Other calls (f32 activations, where the product is f32 FMA; shapes or
// addresses TMA cannot take) run on the split-K weight-streaming product of
// common.cuh: blocks stage one int8 weight tile each with 16-byte loads,
// widen it to bf16 in shared memory (exact), multiply on the tensor cores
// (f32 activations: FMA), and a second launch sums the f32 partials in
// split order and applies the scale.  Any N works there.
#include "common.cuh"
#include "hopper.cuh"

namespace bvq {

struct Int8Args {
  int act_bf16;  // x and y bf16, else f32
  int m, k, n;
  int bn;              // columns of an int8_wgmma_kernel block (64 or 128); 0: split-K
  const void* x;       // [M, K]
  const int8_t* w8;    // [K, N]
  const float* scale;  // [N]
  void* y;             // [M, N]
  float* part;         // split-K: bvq_int8_matmul_workspace() floats
};

static Gemm int8_gemm(const Int8Args& a) {
  Gemm g{};
  g.x = a.x;
  g.xs_b = a.k;
  g.w = a.w8;
  g.B = a.m;
  g.Kg = a.k;
  g.N = a.n;
  g.G = 1;
  g.part = a.part;
  g.scale = a.scale;
  g.out = a.y;
  return g;
}

// ---------------------------------------------------------------------------
// The TMA + wgmma kernel
constexpr int I8_BK = 128;                     // K depth of a stage
constexpr int I8_XK = 64;                      // K depth of an x box (one 128-byte row)
constexpr int I8_BM = 64;                      // x rows of a block (the wgmma's N)
constexpr int I8_WN = 64;                      // weight columns of a warpgroup (its M)
constexpr int I8_STAGES = 4;
constexpr int I8_X_BYTES = I8_BM * I8_BK * 2;  // 16 KB: I8_BK / I8_XK boxes of 8 KB
constexpr int I8_W_BYTES = I8_BK * I8_WN;      // 8 KB
constexpr int I8_SLICES = I8_BK / 16;          // 16-deep products a stage

// a block of BN columns: one consumer warpgroup per 64 columns
template <int BN> __host__ __device__ constexpr int i8_consumers() { return 128 * (BN / I8_WN); }
template <int BN> __host__ __device__ constexpr int i8_stage_bytes() {
  return I8_X_BYTES + (BN / I8_WN) * I8_W_BYTES;
}
// the stages, their 2 mbarriers each, and slack to align the stages to 1 KB
template <int BN> constexpr int i8_smem() {
  return I8_STAGES * i8_stage_bytes<BN>() + 2 * I8_STAGES * 8 + 1024;
}

// One stage of a consumer warp: waits for it, widens its column tile's
// weights into a, and issues the stage's 16-deep products as one group.
template <int BN>
__device__ __forceinline__ void i8_consume(float (&acc)[32], uint32_t (&a)[I8_SLICES][4],
                                           const unsigned char* smem, uint64_t* full, int kt,
                                           int cw, int chunk, int lane) {
  using namespace hopper;
  const int s = kt % I8_STAGES;
  mbar_wait(&full[s], (kt / I8_STAGES) & 1);
  __syncwarp();  // the ldmatrix and wgmma below are warp-collective
  const unsigned char* st = smem + s * i8_stage_bytes<BN>();
#pragma unroll
  for (int h = 0; h < I8_SLICES / 2; ++h)
    i8_tile_a_frags(a, 2 * h, st + I8_X_BYTES + cw * I8_W_BYTES, h, chunk, lane);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < I8_SLICES; ++j)
    wgmma_m64n64k16_rs(acc, a[j],
                       wgmma_desc_sw128(st + (j / 4) * (I8_BM * I8_XK * 2)) + 2 * (j % 4));
  wgmma_commit();
}

template <int BN>
__global__ void __launch_bounds__(i8_consumers<BN>() + 32) int8_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  using namespace hopper;
  constexpr int SB = i8_stage_bytes<BN>(), CW = BN / I8_WN, CONSUMERS = i8_consumers<BN>();
  extern __shared__ __align__(1024) unsigned char i8_raw[];
  unsigned char* smem = i8_raw + ((1024 - (smem_addr(i8_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + I8_STAGES * SB);
  uint64_t* empty = full + I8_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * I8_BM;
  const int stages = (K + I8_BK - 1) / I8_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < I8_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      for (int kt = 0; kt < stages; ++kt) {
        const int s = kt % I8_STAGES;
        if (kt >= I8_STAGES) mbar_wait(&empty[s], ((kt / I8_STAGES) - 1) & 1);
        unsigned char* st = smem + s * SB;
        mbar_arrive_expect_tx(&full[s], SB);
        for (int x = 0; x < I8_BK / I8_XK; ++x)
          tma_load_2d(st + x * (I8_BM * I8_XK * 2), &xmap, &full[s], kt * I8_BK + x * I8_XK,
                      m0);
        for (int c = 0; c < CW; ++c)
          tma_load_2d(st + I8_X_BYTES + c * I8_W_BYTES, &wmap, &full[s], n0 + c * I8_WN,
                      kt * I8_BK);
      }
    }
    return;
  }

  // consumer warp `chunk` of warpgroup cw: weight columns n0 + 64 cw + 16
  // chunk .. + 15, the product's rows 16 chunk .. 16 chunk + 15; its
  // scales while the first stage lands
  const int cw = warp / 4, chunk = warp % 4, g = lane >> 2, t = lane & 3;
  const int n = n0 + cw * I8_WN + chunk * 16 + 2 * g;  // N is even: n < N means n + 1 < N
  const float s0 = n < N ? scale[n] : 0.f, s1 = n < N ? scale[n + 1] : 0.f;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a0[I8_SLICES][4], a1[I8_SLICES][4];
  // two stages in flight: stage kt's products run while kt + 1 is widened;
  // a stage goes back to the producer once its products are done
  for (int kt = 0; kt < stages; kt += 2) {
    i8_consume<BN>(acc, a0, smem, full, kt, cw, chunk, lane);
    if (kt > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % I8_STAGES]);
    }
    if (kt + 1 < stages) {
      i8_consume<BN>(acc, a1, smem, full, kt + 1, cw, chunk, lane);
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&empty[kt % I8_STAGES]);
    }
  }
  wgmma_wait<0>();

  // acc[4 j + i]: weight column n + i / 2, x row m0 + 8 j + 2 t + i % 2
  if (n >= N) return;
#pragma unroll
  for (int j = 0; j < I8_BM / 8; ++j) {
    const int m = m0 + 8 * j + 2 * t;
    if (m < M)
      *reinterpret_cast<uint32_t*>(y + (size_t)m * N + n) =
          rf_pack(acc[4 * j] * s0, acc[4 * j + 2] * s1);
    if (m + 1 < M)
      *reinterpret_cast<uint32_t*>(y + (size_t)(m + 1) * N + n) =
          rf_pack(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
  }
}

// what int8_wgmma_kernel takes (the wrapper's tma_columns decides the same)
static bool int8_tma_ok(const Int8Args& a) {
  const auto aligned = [](const void* p, int b) { return reinterpret_cast<uintptr_t>(p) % b == 0; };
  return a.act_bf16 && (a.bn == 64 || a.bn == 128) && a.m > 0 && a.k > 0 && a.n > 0 &&
         a.k % 8 == 0 && a.n % 16 == 0 && aligned(a.x, 16) && aligned(a.w8, 16) &&
         aligned(a.y, 4);
}

template <int BN>
static cudaError_t launch_int8_wgmma(const Int8Args& a, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  BVQ_TRY(hopper::encode_tiled_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.m, a.k,
                                  I8_BM, I8_XK, CU_TENSOR_MAP_SWIZZLE_128B));
  BVQ_TRY(hopper::encode_tiled_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.w8, a.k, a.n,
                                  I8_BK, I8_WN, CU_TENSOR_MAP_SWIZZLE_64B));
  constexpr int smem = i8_smem<BN>();
  static int done[BVQ_DEVICES];
  BVQ_TRY(allow_smem_once((const void*)int8_wgmma_kernel<BN>, smem, done));
  const dim3 grid(cdiv(a.n, BN), cdiv(a.m, I8_BM));
  int8_wgmma_kernel<BN><<<grid, i8_consumers<BN>() + 32, smem, s>>>(
      xmap, wmap, a.scale, static_cast<__nv_bfloat16*>(a.y), a.m, a.k, a.n);
  return cudaGetLastError();
}

}  // namespace bvq

extern "C" int bvq_int8_matmul(const bvq::Int8Args* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->bn != 0) {
    if (!bvq::int8_tma_ok(*a)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(a->bn == 64 ? bvq::launch_int8_wgmma<64>(*a, s)
                                        : bvq::launch_int8_wgmma<128>(*a, s));
  }
  const bvq::Gemm g = bvq::int8_gemm(*a);
  const cudaError_t e = a->act_bf16 ? bvq::launch_gemm<__nv_bfloat16>(g, true, false, s)
                                    : bvq::launch_gemm<float>(g, true, false, s);
  return static_cast<int>(e);
}

extern "C" long bvq_int8_matmul_workspace(const bvq::Int8Args* a) {
  return static_cast<long>(a->act_bf16
                               ? bvq::gemm_partial_floats<__nv_bfloat16>(a->m, a->k, a->n, 1)
                               : bvq::gemm_partial_floats<float>(a->m, a->k, a->n, 1));
}
