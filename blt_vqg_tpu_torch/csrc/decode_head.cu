// Fused decode head: final LayerNorm -> vocab projection (x per-column
// scale when int8) + bias -> greedy argmax, with no [B, V] logits stored.
//
// Replaces the TPU kernel `head_argmax` (`_head_kernel`) of
// blt_vqg_tpu/ops/pallas/decode_head.py.
//
// At decode batch sizes the head's least time is that of the bytes of its
// [D, Vp] weight matrix (12.6 MB int8 at D=1024, Vp=12288; b64: 13.1 MB in
// all, 3.9 us).  The TPU kernel walks the vocab chunks in order and carries
// a running (max, argmax) in scratch; blocks on this card run in no order,
// so every reduction here has a fixed order instead.
//
// bf16 activations (bf16 or int8 weights), 3 launches, no logits and no
// partial product in device memory (the first design's 4 launches wrote
// 12.6 MB of f32 partial logits and read them back):
//  1. the row LayerNorm (f32 statistics, eps 1e-6, rounded to bf16) into
//     a [B, D] scratch;
//  2. the product on common.cuh's cluster split-K product: at the flagship
//     a cluster of 2 blocks splits a 64-column vocab tile's 1,024-deep K
//     (384 blocks at Vp 12,288, one wave; 4 ranks took two waves and were
//     slower); the rank that sums a column share of the tile through
//     distributed shared memory multiplies by the int8 column scale and
//     adds the bias (both loaded before the cluster barrier) and writes
//     each row's (max, first index) of its share: one pair per (row,
//     block);
//  3. one warp per row reduces its pairs, the lowest index winning ties,
//     as in the TPU kernel.
// On an H100 the product is latency-bound, not byte-bound: about 16 us of
// device time, 20 us for the call (22 us with the L2 cold; common.cuh,
// PERF.md).
//
// f32 activations keep the first design's launch chain: the LayerNorm, the
// split-K product of common.cuh (f32 partial logits in device memory),
// block (tile of HEAD_TILE columns, row) summing a tile's partials in split
// order into its (max, first argmax), and one thread per row over the
// tiles.  Padded vocab columns carry bias -1e30 and never win.
#include "common.cuh"

namespace bvq {

constexpr int HEAD_TILE = 256;  // vocab columns per block of step 3

struct HeadArgs {
  int act_bf16, w_i8;
  int batch, dim, vocab;
  int cluster, kslice;  // bf16: the K split (ops/kernels/decode_stream.py cluster_split)
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const void* w;
  const float* scales;
  const float* bias;
  void* xn;     // [B, D] scratch in the activation type
  float* part;  // workspace of part_floats floats (sized by the wrapper):
                // f32, the partial logits first; then each (row, tile)'s
                // max and first argmax
  long part_floats;
  int* tokens;
};

static int head_tiles(const HeadArgs& a) { return cdiv(a.vocab, HEAD_TILE); }

// (v, i) beats (bv, bi) when greater, or equal at a lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

static Gemm head_gemm(const HeadArgs& a) {
  Gemm g{};
  g.x = a.xn;
  g.xs_b = a.dim;
  g.w = a.w;
  g.B = a.batch;
  g.Kg = a.dim;
  g.N = a.vocab;
  g.G = 1;
  g.part = a.part;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(HEAD_TILE)
    head_tiles_kernel(HeadArgs a, int Bp, int Np, float* part_max, int* part_idx) {
  __shared__ float best_v[HEAD_TILE / 32];
  __shared__ int best_i[HEAD_TILE / 32];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int n = blockIdx.x * HEAD_TILE + tid;
  const int splits = gemm_splits<T>(a.dim);
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  if (n < a.vocab) {
    float logit = 0.f;
    for (int s = 0; s < splits; ++s) logit += a.part[((size_t)s * Bp + b) * Np + n];
    if (a.scales) logit = logit * a.scales[n];
    bv = logit + a.bias[n];
    bi = n;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (beats(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (tid % 32 == 0) {
    best_v[tid / 32] = bv;
    best_i[tid / 32] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < HEAD_TILE / 32; ++w)
      if (beats(best_v[w], best_i[w], bv, bi)) {
        bv = best_v[w];
        bi = best_i[w];
      }
    part_max[(size_t)b * gridDim.x + blockIdx.x] = bv;
    part_idx[(size_t)b * gridDim.x + blockIdx.x] = bi;
  }
}

__global__ void head_reduce_kernel(const float* part_max, const int* part_idx,
                                   int* tokens, int batch, int tiles) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= batch) return;
  float best = -INFINITY;
  int arg = 0;
  for (int t = 0; t < tiles; ++t) {
    const float v = part_max[(size_t)row * tiles + t];
    if (v > best) {
      best = v;
      arg = part_idx[(size_t)row * tiles + t];
    }
  }
  tokens[row] = arg;
}

// floats of the partial logits at the start of the workspace
static size_t head_partial_floats(const HeadArgs& a) {
  const Gemm g = head_gemm(a);
  return gemm_partial_floats<float>(g.B, g.Kg, g.N, g.G);
}

static cudaError_t head_argmax_f32(const HeadArgs& a, cudaStream_t s) {
  const int tiles = head_tiles(a);
  if (head_partial_floats(a) + 2 * (size_t)a.batch * tiles > (size_t)a.part_floats)
    return cudaErrorInvalidValue;
  float* part_max = a.part + head_partial_floats(a);
  int* part_idx = reinterpret_cast<int*>(part_max + (size_t)a.batch * tiles);
  BVQ_TRY(launch_layernorm<float>(static_cast<const float*>(a.x), a.ln_scale, a.ln_bias,
                                  static_cast<float*>(a.xn), a.batch, a.dim, s));
  BVQ_TRY(launch_gemm_partials<float>(head_gemm(a), a.w_i8, s));
  const int Bp = cdiv(a.batch, BM) * BM, Np = cdiv(a.vocab, BN) * BN;
  head_tiles_kernel<float><<<dim3(tiles, a.batch), HEAD_TILE, 0, s>>>(a, Bp, Np, part_max,
                                                                      part_idx);
  BVQ_TRY(cudaGetLastError());
  head_reduce_kernel<<<cdiv(a.batch, 128), 128, 0, s>>>(part_max, part_idx, a.tokens,
                                                        a.batch, tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 activations.  Block (rank of a vocab tile's cluster of C, -, row
// tile): the rank sums its column share of the tile's logits over the
// ranks, applies the int8 scale and the bias (loaded before the barrier),
// and writes each row's (max, first index) of the share: pair_max and
// pair_idx [B, pairs], column blockIdx.x (pairs = gridDim.x, ascending
// in the vocab).  The S4 lanes that share a row reduce by shuffles.
template <bool I8, int C>
__global__ void __launch_bounds__(CK_THREADS)
    head_cluster_kernel(CkGemm p, int kslice, const float* __restrict__ scales,
                        const float* __restrict__ bias, float* __restrict__ pair_max,
                        int* __restrict__ pair_idx) {
  extern __shared__ __align__(128) unsigned char ck_shared[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), pairs = gridDim.x;
  const int m0 = blockIdx.z * CK_BM, n0 = (blockIdx.x / C) * CK_BN, k0 = rank * kslice;
  ck_partials<I8>(p, 0, 1, m0, n0, k0, min(p.K, k0 + kslice), ck_shared);
  float* part = ck_part_tiles<I8>(ck_shared, 1);
  constexpr int S4 = ck_share4(C), ITEMS = ck_items(C);
  float4 bs[ITEMS], sc[ITEMS];  // N % 8 == 0
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int it = threadIdx.x + j * CK_THREADS, n = n0 + (rank * S4 + it % S4) * 4;
    const bool in = n < p.N;
    bs[j] = in ? *reinterpret_cast<const float4*>(bias + n) : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (I8)
      sc[j] = in ? *reinterpret_cast<const float4*>(scales + n) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cluster.sync();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int it = threadIdx.x + j * CK_THREADS, row = it / S4;
    const int col = (rank * S4 + it % S4) * 4, n = n0 + col;
    const float4 v4 = ck_sum4<C>(cluster, part, row, col);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float b4[4] = {bs[j].x, bs[j].y, bs[j].z, bs[j].w};
    float s4[4] = {1.f, 1.f, 1.f, 1.f};
    if constexpr (I8) {
      s4[0] = sc[j].x;
      s4[1] = sc[j].y;
      s4[2] = sc[j].z;
      s4[3] = sc[j].w;
    }
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float logit = __fadd_rn(I8 ? __fmul_rn(v[e], s4[e]) : v[e], b4[e]);
      if (n + e < p.N && beats(logit, n + e, bv, bi)) {
        bv = logit;
        bi = n + e;
      }
    }
#pragma unroll
    for (int o = S4 / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (it % S4 == 0 && m0 + row < p.B) {
      pair_max[(size_t)(m0 + row) * pairs + blockIdx.x] = bv;
      pair_idx[(size_t)(m0 + row) * pairs + blockIdx.x] = bi;
    }
  }
  cluster.sync();  // the peers have read this block's partials
}

template <bool I8> static auto head_kernel(int C) {
  return C == 1 ? head_cluster_kernel<I8, 1> : C == 2 ? head_cluster_kernel<I8, 2>
                : C == 4 ? head_cluster_kernel<I8, 4> : head_cluster_kernel<I8, 8>;
}

// One warp per row: the row's pairs, lanes strided over them, then the
// warp; the lowest index wins ties.
constexpr int PICK_ROWS = 4;

__global__ void __launch_bounds__(PICK_ROWS * 32)
    head_pick_kernel(const float* __restrict__ pair_max, const int* __restrict__ pair_idx,
                     int* __restrict__ tokens, int batch, int pairs) {
  const int row = blockIdx.x * PICK_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= batch) return;  // whole warps
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int t = lane; t < pairs; t += 32) {
    const float v = pair_max[(size_t)row * pairs + t];
    const int i = pair_idx[(size_t)row * pairs + t];
    if (beats(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (beats(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) tokens[row] = bi;
}

static cudaError_t head_argmax_bf16(const HeadArgs& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int B = a.batch, C = a.cluster, pairs = cdiv(a.vocab, CK_BN) * C;
  if (!ck_split_ok(C, a.kslice, a.dim) || a.vocab % 8 || 2 * (long)B * pairs > a.part_floats)
    return cudaErrorInvalidValue;
  float* pair_max = a.part;
  int* pair_idx = reinterpret_cast<int*>(a.part + (size_t)B * pairs);
  BVQ_TRY(launch_layernorm<bf16>(static_cast<const bf16*>(a.x), a.ln_scale, a.ln_bias,
                                 static_cast<bf16*>(a.xn), B, a.dim, s));
  const CkGemm g{static_cast<const bf16*>(a.xn), 0, a.dim, a.w, B, a.dim, a.vocab, 1};
  const dim3 grid(pairs, 1, cdiv(B, CK_BM));
  static CkLaunch st[2][4];
  if (a.w_i8)
    BVQ_TRY(launch_cluster(head_kernel<true>(C), st[1][ck_size_index(C)], grid, C,
                           ck_smem<true>(1, 0), s, g, a.kslice, a.scales, a.bias, pair_max,
                           pair_idx));
  else
    BVQ_TRY(launch_cluster(head_kernel<false>(C), st[0][ck_size_index(C)], grid, C,
                           ck_smem<false>(1, 0), s, g, a.kslice, a.scales, a.bias, pair_max,
                           pair_idx));
  head_pick_kernel<<<cdiv(B, PICK_ROWS), PICK_ROWS * 32, 0, s>>>(pair_max, pair_idx, a.tokens,
                                                                 B, pairs);
  return cudaGetLastError();
}

}  // namespace bvq

extern "C" int bvq_head_argmax(const bvq::HeadArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? bvq::head_argmax_bf16(*a, s) : bvq::head_argmax_f32(*a, s);
  return static_cast<int>(e);
}
