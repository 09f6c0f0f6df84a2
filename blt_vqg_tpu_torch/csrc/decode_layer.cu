// The per-layer decode step as two fused ops.
//
// Replaces the TPU kernels of blt_vqg_tpu/ops/pallas/decode_layer.py:
//  - bvq_self_attn_step  for `self_attn_step` (`_self_attn_kernel`):
//    LayerNorm -> per-head QKV -> K/V written into the caches at pos, in
//    place -> causal cached attention (optional pad-key mask) -> out
//    projection summed over heads -> residual;
//  - bvq_cross_ffn_step  for `cross_ffn_step` (`_cross_ffn_kernel`):
//    LayerNorm -> cross-attention over the precomputed encoder K/V with the
//    source pad mask -> out projection -> residual -> LayerNorm -> FFN (ReLU,
//    biases) -> residual.
//
// At decode batch sizes both are bound by the bytes they read: the layer's
// weights (each used for only B rows) and, in the self-attention, the cache
// rows 0..pos (b64 pos 25: 8.4 MB of weights and 6.8 MB of cache rows).
//
// bvq_self_attn_step with bf16 activations, 4 launches, no f32 partial
// product in device memory:
//  1. the row LayerNorm into xn;
//  2. the QKV product on common.cuh's cluster split-K product, one group a
//     head (at b64 a cluster of 4 splits the 1,024-deep K; partials summed
//     in distributed shared memory); its epilogue rounds k and v to the
//     cache type and writes them into the caches at row pos, in place, and
//     writes q * Dh^-0.5 in f32 to a [H, B, Dh] scratch;
//  3. the attention, one warp per (b, h), over cache rows 0..pos (row pos
//     read back, as the TPU kernel does): each lane group holds a key row's
//     16-byte chunks, 16 passes of loads in flight (and the v rows sent to
//     L2 beside them), the softmax over the warp, ctx [H, B, Dh] rounded to
//     bf16;
//  4. the out projection and the residual in one launch: a cluster of the
//     head blocks per column tile (a block takes several heads where H >
//     8), each computing ctx_h . w_out[h]; the column share of each rank
//     sums them through distributed shared memory starting from x, in head
//     order 0..H-1, rounding to bf16 after each head: the TPU grid's order.
// The first design's 6 launches wrote 3.1 MB of QKV partials, 0.8 MB of
// qkv and 2.1 MB of out partials in f32 and read them back.  On an H100
// the four launches are latency-bound, not byte-bound (common.cuh): about
// 28-29 us of device time at b64 pos 25 against a 4.6 us bound.
//
// With f32 activations both steps keep the first design, a launch chain on
// common.cuh's split-K product (f32 partials in device memory, FMA tiles):
//  - self_attn_step is 6 launches: LayerNorm, the QKV partials, their
//    epilogue into qkv [H, B, 3*Dh], the attention (block (b, h)), the out
//    partials (one per head) and residual_epilogue_kernel, which adds them
//    to x in head order;
//  - cross_ffn_step (both dtypes: it was redesigned apart from this one) is
//    9 launches, its cross-attention summing its q from the q product's
//    partials and the cross-out residual's epilogue writing the FFN's
//    LayerNorm too (residual_ln_kernel), as in decode_stream.cu.
//
// The attention reads only cache rows 0..pos.  The TPU kernel fills rows
// past pos with NEG_INF, whose exponent underflows to exactly 0, so this is
// the same function under the documented precondition that key_pad never
// marks a row past pos (the pad fill, applied to every row, would otherwise
// lift such a row above NEG_INF; JAX ops/transformer.py DecoderLayer.step
// states the same precondition).
#include <algorithm>

#include "common.cuh"

namespace bvq {

constexpr float NEG_INF = -1e30f;
constexpr float PAD_FILL = MASK_FILL;  // strictly above NEG_INF

struct SelfAttnArgs {
  int act_bf16;  // activations, weights and caches bf16, else f32
  int batch, dim, heads, head_dim, lmax, pos;
  // bf16: the cluster plans (ops/kernels/decode_layer.py self_plan): the
  // QKV product's ranks and depth per rank, the out product's ranks and
  // heads per rank
  int qkv_cluster, qkv_kslice, out_cluster, out_heads;
  long kp_sl, kp_sb;  // key_pad strides (row, batch) in elements
  float q_scale;      // head_dim ** -0.5 (q stays f32)
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const void* w_qkv;  // [H, D, 3*Dh]
  const void* w_out;  // [H, Dh, D]
  void* cache_k;      // [H, Lmax, B, Dh], row pos written here
  void* cache_v;
  const float* key_pad;  // [Lmax, B] (strided) or null
  void* out;             // [B, D]
  // scratch, one allocation sized by the wrapper
  void* xn;      // [B, D]
  float* qkv;    // f32: [H, B, 3*Dh]; bf16: q [H, B, Dh], scaled by Dh^-0.5
  void* ctx;     // [H, B, Dh]
  float* part;   // f32: the split-K partials, part_floats floats
  long part_floats;
};

struct CrossFfnArgs {
  int act_bf16;
  int batch, dim, heads, head_dim, tc, ffn;
  long sp_sb, sp_st;  // src_pad strides (batch, key) in elements
  float q_scale;
  const void* x;
  const float* ln_c_scale;
  const float* ln_c_bias;
  const void* wq;     // [D, D]
  const void* ck;     // [B, Tc, H, Dh]
  const void* cv;
  const bool* src_pad;  // [B, Tc] (strided), true = masked
  const void* wo;     // [D, D]
  const float* ln_f_scale;
  const float* ln_f_bias;
  const void* w1;     // [D, F]
  const float* b1;    // [F]
  const void* w2;     // [F, D]
  const float* b2;    // [D]
  void* out;          // [B, D]
  // scratch
  void* xn;    // [B, D]
  void* ctx;   // [B, D]
  float* x1;   // [B, D] the residual after cross-attention, f32
  void* h1;    // [B, F]
  float* part;  // partial products: part_floats floats
  long part_floats;
};

// ---------------------------------------------------------------------------
// out[b, n] = res[b, n], then for each group g in order: + the sum of its
// split-K partials, rounded to T after each group when round_groups; then
// + bias[n]; stored as TO.  One thread per output element.
template <typename T, typename TR, typename TO>
__global__ void __launch_bounds__(256)
    residual_epilogue_kernel(const float* __restrict__ part, int G, int splits, int Bp,
                             int Np, int B, int N, const TR* __restrict__ res,
                             const float* __restrict__ bias, TO* __restrict__ out,
                             int round_groups) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int n = idx % N, b = idx / N;
  float v = to_f<TR>(res[idx]);
  for (int g = 0; g < G; ++g) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(((size_t)g * splits + s) * Bp + b) * Np + n];
    v = v + acc;
    if (round_groups) v = round_to<T>(v);
  }
  if (bias) v = v + bias[n];
  out[idx] = from_f<TO>(v);
}

template <typename T, typename TR, typename TO>
static cudaError_t launch_residual(const Gemm& g, const TR* res, const float* bias, TO* out,
                                   bool round_groups, cudaStream_t s) {
  BVQ_TRY(launch_gemm_partials<T>(g, false, s));
  const int Bp = cdiv(g.B, BM) * BM, Np = cdiv(g.N, BN) * BN;
  const long outputs = (long)g.B * g.N;
  residual_epilogue_kernel<T, TR, TO><<<(int)((outputs + 255) / 256), 256, 0, s>>>(
      g.part, g.G, gemm_splits<T>(g.Kg), Bp, Np, g.B, g.N, res, bias, out, round_groups);
  return cudaGetLastError();
}

// A product over groups g of x[g] (rows xs_b apart, groups xs_g apart) and
// w[g] [Kg, N], partials into part.
static Gemm make_gemm(const void* x, long xs_g, long xs_b, const void* w, int B, int Kg,
                      int N, int G, float* part) {
  Gemm g{};
  g.x = x;
  g.xs_g = xs_g;
  g.xs_b = xs_b;
  g.w = w;
  g.B = B;
  g.Kg = Kg;
  g.N = N;
  g.G = G;
  g.part = part;
  return g;
}

// ---------------------------------------------------------------------------
// Self-attention of one layer: block (b, h).  qkv [H, B, 3*Dh] f32 from the
// QKV product.  k and v are rounded to T and written into the caches at
// pos; the scores of rows 0..pos (row pos from the values just written) are
// f32 sums of f32 products, the softmax and the context f32; ctx [H, B, Dh]
// is rounded to T.
template <typename T>
__global__ void __launch_bounds__(128)
    layer_self_attn_kernel(const float* __restrict__ qkv, T* __restrict__ ck,
                           T* __restrict__ cv, const float* __restrict__ kpad, long kp_sl,
                           long kp_sb, T* __restrict__ ctx, int B, int Dh, int Lmax, int pos,
                           float q_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = smem + Dh;
  float* vs = smem + 2 * Dh;
  float* sc = smem + 3 * Dh;  // pos + 1 scores, then their weights
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const float* row = qkv + ((size_t)h * B + b) * 3 * Dh;
  const size_t hb = ((size_t)h * B + b) * Dh;
  T* kc = ck + (size_t)h * Lmax * B * Dh;
  T* vc = cv + (size_t)h * Lmax * B * Dh;
  for (int d = tid; d < Dh; d += blockDim.x) {
    qs[d] = row[d] * q_scale;
    ks[d] = round_to<T>(row[Dh + d]);
    vs[d] = round_to<T>(row[2 * Dh + d]);
    kc[((size_t)pos * B + b) * Dh + d] = from_f<T>(ks[d]);
    vc[((size_t)pos * B + b) * Dh + d] = from_f<T>(vs[d]);
  }
  __syncthreads();

  for (int n = warp; n <= pos; n += nwarps) {
    float s = 0.f;
    if (n < pos) {
      const T* kr = kc + ((size_t)n * B + b) * Dh;
      for (int d = lane; d < Dh; d += 32) s += qs[d] * to_f<T>(kr[d]);
    } else {
      for (int d = lane; d < Dh; d += 32) s += qs[d] * ks[d];
    }
    s = warp_sum(s);
    if (lane == 0) {
      const bool masked = kpad != nullptr && kpad[n * kp_sl + b * kp_sb] != 0.f;
      sc[n] = masked ? PAD_FILL : s;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int n = 0; n <= pos; ++n) m = fmaxf(m, sc[n]);
  float den = 0.f;
  for (int n = 0; n <= pos; ++n) den += expf(sc[n] - m);
  __syncthreads();  // every thread has read the scores
  for (int n = tid; n <= pos; n += blockDim.x) sc[n] = expf(sc[n] - m) / den;
  __syncthreads();
  for (int d = tid; d < Dh; d += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < pos; ++n) acc += sc[n] * to_f<T>(vc[((size_t)n * B + b) * Dh + d]);
    acc += sc[pos] * vs[d];
    ctx[hb + d] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// Cross-attention of one layer: block (b, h).  q: the q product's
// partials, head h's outputs (b, h*Dh..) summed here (f32); ck/cv [B, Tc,
// H, Dh]; masked keys take NEG_INF, so a row whose every key is masked
// comes out uniform.  ctx [B, D] rounded to T.
template <typename T>
__global__ void __launch_bounds__(128)
    layer_cross_attn_kernel(GemmOut q, const T* __restrict__ ck,
                            const T* __restrict__ cv, const bool* __restrict__ src_pad,
                            long sp_sb, long sp_st, T* __restrict__ ctx, int H, int Dh,
                            int Tc, float q_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* sc = smem + Dh;  // Tc scores, then their weights
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int D = H * Dh;
  const size_t qrow = (size_t)b * D + (size_t)h * Dh;
  for (int d = tid; d < Dh; d += blockDim.x) qs[d] = q.at(0, b, h * Dh + d) * q_scale;
  __syncthreads();
  for (int t = warp; t < Tc; t += nwarps) {
    const T* kr = ck + (((size_t)b * Tc + t) * H + h) * Dh;
    float s = 0.f;
    for (int d = lane; d < Dh; d += 32) s += qs[d] * to_f<T>(kr[d]);
    s = warp_sum(s);
    if (lane == 0) sc[t] = src_pad[b * sp_sb + t * sp_st] ? NEG_INF : s;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = 0; t < Tc; ++t) m = fmaxf(m, sc[t]);
  float den = 0.f;
  for (int t = 0; t < Tc; ++t) den += expf(sc[t] - m);
  __syncthreads();
  for (int t = tid; t < Tc; t += blockDim.x) sc[t] = expf(sc[t] - m) / den;
  __syncthreads();
  for (int d = tid; d < Dh; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < Tc; ++t)
      acc += sc[t] * to_f<T>(cv[(((size_t)b * Tc + t) * H + h) * Dh + d]);
    ctx[qrow + d] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// The bf16 self-attention step's kernels.
using bf16 = __nv_bfloat16;

// QKV product, block (rank of a column tile's cluster of C, head g, row
// tile): the epilogue of the rank's column share writes q * q_scale (f32)
// to q [H, B, Dh] and k, v rounded to bf16 into the caches [H, L, B, Dh]
// at pos (4 columns an item, all of q, of k or of v: Dh % 8 == 0).
template <int C>
__global__ void __launch_bounds__(CK_THREADS)
    qkv_cluster_kernel(CkGemm p, int kslice, float* __restrict__ q, bf16* __restrict__ ck,
                       bf16* __restrict__ cv, int Dh, int Lmax, int pos, float q_scale) {
  extern __shared__ __align__(128) unsigned char ck_shared[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int g = blockIdx.y, m0 = blockIdx.z * CK_BM, n0 = (blockIdx.x / C) * CK_BN;
  const int k0 = rank * kslice;
  ck_partials<false>(p, g, 1, m0, n0, k0, min(p.K, k0 + kslice), ck_shared);
  float* part = ck_part_tiles<false>(ck_shared, 1);
  cluster.sync();
  constexpr int S4 = ck_share4(C);
#pragma unroll
  for (int j = 0; j < ck_items(C); ++j) {
    const int it = threadIdx.x + j * CK_THREADS, row = it / S4;
    const int col = (rank * S4 + it % S4) * 4, b = m0 + row, n = n0 + col;
    const float4 v = ck_sum4<C>(cluster, part, row, col);
    if (b >= p.B || n >= p.N) continue;
    if (n < Dh) {
      *reinterpret_cast<float4*>(q + ((size_t)g * p.B + b) * Dh + n) =
          make_float4(v.x * q_scale, v.y * q_scale, v.z * q_scale, v.w * q_scale);
    } else {
      bf16* cache = n < 2 * Dh ? ck : cv;
      const int d = n < 2 * Dh ? n - Dh : n - 2 * Dh;
      *reinterpret_cast<uint2*>(cache + (((size_t)g * Lmax + pos) * p.B + b) * Dh + d) =
          make_uint2(rf_pack(v.x, v.y), rf_pack(v.z, v.w));
    }
  }
  cluster.sync();  // the peers have read this block's partials
}

// Self-attention over cache rows 0..pos, one warp per (b, h); a block takes
// SA_WARPS rows b of one head (adjacent in the caches).  A lane group of G
// lanes (the power of two >= Dh / 8) holds a key row, 8 elements a lane, so
// a pass covers 32 / G rows; SA_PASSES passes' loads are issued together.
// Scores are f32 sums of f32 products with q (f32, scaled); pad-marked keys
// take PAD_FILL; the softmax is f32 over the warp; ctx [H, B, Dh] bf16.
constexpr int SA_WARPS = 4, SA_PASSES = 16;

__global__ void __launch_bounds__(SA_WARPS * 32)
    self_attn_warp_kernel(const float* __restrict__ q, const bf16* __restrict__ ck,
                          const bf16* __restrict__ cv, const float* __restrict__ kpad,
                          long kp_sl, long kp_sb, bf16* __restrict__ ctx, int B, int Dh,
                          int Lmax, int pos) {
  extern __shared__ float sa_scores[];  // SA_WARPS x (pos + 1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.x * SA_WARPS + warp;
  if (b >= B) return;  // no barrier below spans the block
  float* sc = sa_scores + (size_t)warp * (pos + 1);
  const int chunks = Dh / 8;
  int G = 1;
  while (G < chunks) G <<= 1;
  const int rows = 32 / G, sub = lane % G, rsel = lane / G;
  const bool live = sub < chunks;
  const size_t rs = (size_t)B * Dh;  // cache row stride
  const size_t base = ((size_t)h * Lmax * B + b) * Dh + sub * 8;
  float qv[8];
  {
    const float* qr = q + ((size_t)h * B + b) * Dh + sub * 8;
    const float4 a = live ? *reinterpret_cast<const float4*>(qr) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 c = live ? *reinterpret_cast<const float4*>(qr + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
    qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
    qv[4] = c.x; qv[5] = c.y; qv[6] = c.z; qv[7] = c.w;
  }
  for (int n0 = 0; n0 <= pos; n0 += rows * SA_PASSES) {
    uint4 kr[SA_PASSES];
#pragma unroll
    for (int u = 0; u < SA_PASSES; ++u) {
      const int n = n0 + u * rows + rsel;
      kr[u] = live && n <= pos ? *reinterpret_cast<const uint4*>(ck + base + n * rs)
                               : make_uint4(0, 0, 0, 0);
      if (live && n <= pos)  // the same row of v, on its way to L2 for the context
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(cv + base + n * rs));
    }
#pragma unroll
    for (int u = 0; u < SA_PASSES; ++u) {
      const int n = n0 + u * rows + rsel;
      const bf16* e = reinterpret_cast<const bf16*>(&kr[u]);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += qv[j] * __bfloat162float(e[j]);
      for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (sub == 0 && n <= pos) {
        const bool masked = kpad != nullptr && kpad[n * kp_sl + b * kp_sb] != 0.f;
        sc[n] = masked ? PAD_FILL : s;
      }
    }
  }
  __syncwarp();
  float m = -INFINITY;
  for (int n = lane; n <= pos; n += 32) m = fmaxf(m, sc[n]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float den = 0.f;
  for (int n = lane; n <= pos; n += 32) den += expf(sc[n] - m);
  den = warp_sum(den);
  __syncwarp();  // every lane has read the scores
  for (int n = lane; n <= pos; n += 32) sc[n] = expf(sc[n] - m) / den;
  __syncwarp();
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 <= pos; n0 += rows * SA_PASSES) {
    uint4 vr[SA_PASSES];
#pragma unroll
    for (int u = 0; u < SA_PASSES; ++u) {
      const int n = n0 + u * rows + rsel;
      vr[u] = live && n <= pos ? *reinterpret_cast<const uint4*>(cv + base + n * rs)
                               : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < SA_PASSES; ++u) {
      const int n = n0 + u * rows + rsel;
      const float w = n <= pos ? sc[n] : 0.f;
      const bf16* e = reinterpret_cast<const bf16*>(&vr[u]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += w * __bfloat162float(e[j]);
    }
  }
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (rsel == 0 && live) {
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = rf_pack(acc[2 * j], acc[2 * j + 1]);
    *reinterpret_cast<uint4*>(ctx + ((size_t)h * B + b) * Dh + sub * 8) = out;
  }
}

// Out projection and residual, block (rank of a column tile's cluster of
// C, -, row tile): rank r computes ctx_h . w_out[h] for its heads h in
// [r hpb, (r + 1) hpb); the epilogue of the rank's column share adds them
// to x (loaded before the barrier) in head order 0..H-1, rounding to bf16
// after each head.
template <int C>
__global__ void __launch_bounds__(CK_THREADS)
    out_cluster_kernel(CkGemm p, int hpb, const bf16* __restrict__ x, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ck_shared[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int m0 = blockIdx.z * CK_BM, n0 = (blockIdx.x / C) * CK_BN, N = p.N;
  ck_partials<false>(p, rank * hpb, hpb, m0, n0, 0, p.K, ck_shared);
  float* part = ck_part_tiles<false>(ck_shared, hpb);
  constexpr int S4 = ck_share4(C), ITEMS = ck_items(C);
  uint2 xr[ITEMS];  // 4 bf16 of x an item (N % 8 == 0)
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int it = threadIdx.x + j * CK_THREADS;
    const int b = m0 + it / S4, n = n0 + (rank * S4 + it % S4) * 4;
    xr[j] = b < p.B && n < N ? *reinterpret_cast<const uint2*>(x + (size_t)b * N + n)
                             : make_uint2(0, 0);
  }
  cluster.sync();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int it = threadIdx.x + j * CK_THREADS, row = it / S4;
    const int col = (rank * S4 + it % S4) * 4, b = m0 + row, n = n0 + col;
    if (b >= p.B || n >= N) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&xr[j]);
    float v[4] = {__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                  __bfloat162float(e[3])};
#pragma unroll 8
    for (int h = 0; h < p.G; ++h) {
      const float4 ph = ck_peer4(cluster, part, h / hpb, h % hpb, row, col);
      v[0] = round_to<bf16>(v[0] + ph.x);
      v[1] = round_to<bf16>(v[1] + ph.y);
      v[2] = round_to<bf16>(v[2] + ph.z);
      v[3] = round_to<bf16>(v[3] + ph.w);
    }
    *reinterpret_cast<uint2*>(out + (size_t)b * N + n) =
        make_uint2(rf_pack(v[0], v[1]), rf_pack(v[2], v[3]));
  }
  cluster.sync();  // the peers have read this block's partials
}

// the instantiations for cluster size C (1, 2, 4 or 8)
static auto qkv_kernel(int C) {
  return C == 1 ? qkv_cluster_kernel<1> : C == 2 ? qkv_cluster_kernel<2>
                : C == 4 ? qkv_cluster_kernel<4> : qkv_cluster_kernel<8>;
}
static auto out_kernel(int C) {
  return C == 1 ? out_cluster_kernel<1> : C == 2 ? out_cluster_kernel<2>
                : C == 4 ? out_cluster_kernel<4> : out_cluster_kernel<8>;
}

static cudaError_t self_attn_step_bf16(const SelfAttnArgs& a, cudaStream_t s) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  const int oc = a.out_cluster;
  if (!ck_split_ok(a.qkv_cluster, a.qkv_kslice, D) || oc < 1 || oc > CK_MAX_CLUSTER ||
      (oc & (oc - 1)) || a.out_heads < 1 || oc * a.out_heads < H || Dh % 8 || Dh > 256)
    return cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* xn = static_cast<bf16*>(a.xn);
  bf16* ctx = static_cast<bf16*>(a.ctx);
  bf16* ck = static_cast<bf16*>(a.cache_k);
  bf16* cv = static_cast<bf16*>(a.cache_v);
  const int row_tiles = cdiv(B, CK_BM);
  BVQ_TRY(launch_layernorm<bf16>(x, a.ln_scale, a.ln_bias, xn, B, D, s));
  static CkLaunch qkv_launch[4], out_launch[4];
  const CkGemm qkv{xn, 0, D, a.w_qkv, B, D, 3 * Dh, H};
  BVQ_TRY(launch_cluster(qkv_kernel(a.qkv_cluster), qkv_launch[ck_size_index(a.qkv_cluster)],
                         dim3(cdiv(3 * Dh, CK_BN) * a.qkv_cluster, H, row_tiles),
                         a.qkv_cluster, ck_smem<false>(1, 0), s, qkv, a.qkv_kslice, a.qkv, ck,
                         cv, Dh, a.lmax, a.pos, a.q_scale));
  static int attn_smem[BVQ_DEVICES];
  const int smem = SA_WARPS * (a.pos + 1) * (int)sizeof(float);
  BVQ_TRY(allow_smem((const void*)self_attn_warp_kernel, smem, attn_smem));
  self_attn_warp_kernel<<<dim3(cdiv(B, SA_WARPS), H), SA_WARPS * 32, smem, s>>>(
      a.qkv, ck, cv, a.key_pad, a.kp_sl, a.kp_sb, ctx, B, Dh, a.lmax, a.pos);
  BVQ_TRY(cudaGetLastError());
  const CkGemm outg{ctx, (long)B * Dh, Dh, a.w_out, B, Dh, D, H};
  return launch_cluster(out_kernel(oc), out_launch[ck_size_index(oc)],
                        dim3(cdiv(D, CK_BN) * oc, 1, row_tiles),
                        oc, ck_smem<false>(a.out_heads, 0), s, outg, a.out_heads, x,
                        static_cast<bf16*>(a.out));
}

// ---------------------------------------------------------------------------
// The f32 self-attention step: the launch chain on the split-K product.
static void self_gemms(const SelfAttnArgs& a, Gemm g[2]) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  g[0] = make_gemm(a.xn, 0, D, a.w_qkv, B, D, 3 * Dh, H, a.part);  // QKV
  g[0].out = a.qkv;
  g[1] = make_gemm(a.ctx, (long)B * Dh, Dh, a.w_out, B, Dh, D, H, a.part);  // out
}

static cudaError_t self_attn_step_f32(const SelfAttnArgs& a, cudaStream_t s) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  Gemm g[2];
  self_gemms(a, g);
  for (const Gemm& p : g)
    if (gemm_partial_floats<float>(p.B, p.Kg, p.N, p.G) > (size_t)a.part_floats)
      return cudaErrorInvalidValue;
  BVQ_TRY(launch_layernorm<float>(static_cast<const float*>(a.x), a.ln_scale, a.ln_bias,
                                  static_cast<float*>(a.xn), B, D, s));
  BVQ_TRY(launch_gemm<float>(g[0], false, true, s));
  const size_t smem = sizeof(float) * (3 * Dh + a.pos + 1);
  layer_self_attn_kernel<float><<<dim3(B, H), 128, smem, s>>>(
      a.qkv, static_cast<float*>(a.cache_k), static_cast<float*>(a.cache_v), a.key_pad,
      a.kp_sl, a.kp_sb, static_cast<float*>(a.ctx), B, Dh, a.lmax, a.pos, a.q_scale);
  BVQ_TRY(cudaGetLastError());
  return launch_residual<float, float, float>(g[1], static_cast<const float*>(a.x), nullptr,
                                              static_cast<float*>(a.out), true, s);
}

static void cross_gemms(const CrossFfnArgs& a, Gemm g[4]) {
  const int B = a.batch, D = a.dim, F = a.ffn;
  g[0] = make_gemm(a.xn, 0, D, a.wq, B, D, D, 1, a.part);   // q: summed by the attention
  g[1] = make_gemm(a.ctx, 0, D, a.wo, B, D, D, 1, a.part);  // cross out
  g[2] = make_gemm(a.xn, 0, D, a.w1, B, D, F, 1, a.part);   // FFN in
  g[2].bias = a.b1;
  g[2].relu = 1;
  g[2].out = a.h1;
  g[3] = make_gemm(a.h1, 0, F, a.w2, B, F, D, 1, a.part);   // FFN out
}

// Whether the caller's workspace holds every product's partials
// (ops/kernels/decode_layer.py sizes it).
template <typename T> static bool cross_workspace_ok(const CrossFfnArgs& a) {
  Gemm g[4];
  cross_gemms(a, g);
  for (const Gemm& p : g)
    if (gemm_partial_floats<T>(p.B, p.Kg, p.N, p.G) > (size_t)a.part_floats) return false;
  return true;
}

template <typename T>
static cudaError_t cross_ffn_step(const CrossFfnArgs& a, cudaStream_t s) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  if (!cross_workspace_ok<T>(a)) return cudaErrorInvalidValue;
  Gemm g[4];
  cross_gemms(a, g);
  T* xn = static_cast<T*>(a.xn);
  // ---- cross-attention (its q summed from the q partials); x1 = x + ctx @
  // wo stays f32, its epilogue also writes LN(x1)
  BVQ_TRY(launch_layernorm<T>(static_cast<const T*>(a.x), a.ln_c_scale, a.ln_c_bias, xn, B,
                              D, s));
  BVQ_TRY(launch_gemm_partials<T>(g[0], false, s));
  const size_t smem = sizeof(float) * (Dh + a.tc);
  layer_cross_attn_kernel<T><<<dim3(B, H), 128, smem, s>>>(
      gemm_out<T>(g[0]), static_cast<const T*>(a.ck), static_cast<const T*>(a.cv), a.src_pad,
      a.sp_sb, a.sp_st, static_cast<T*>(a.ctx), H, Dh, a.tc, a.q_scale);
  BVQ_TRY(cudaGetLastError());
  Gemm out = g[1];
  out.reduce = 1;
  out.res = a.x;
  out.out = a.x1;
  BVQ_TRY((launch_residual_ln<T, T, float>(out, false, false, true, a.ln_f_scale, a.ln_f_bias,
                                           xn, s)));
  // ---- FFN: h1 = relu(LN(x1) @ w1 + b1) in T; out = (x1 + h1 @ w2) + b2
  BVQ_TRY(launch_gemm<T>(g[2], false, false, s));
  return launch_residual<T, float, T>(g[3], a.x1, a.b2, static_cast<T*>(a.out), false, s);
}

}  // namespace bvq

extern "C" int bvq_self_attn_step(const bvq::SelfAttnArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? bvq::self_attn_step_bf16(*a, s)
                                    : bvq::self_attn_step_f32(*a, s);
  return static_cast<int>(e);
}

extern "C" int bvq_cross_ffn_step(const bvq::CrossFfnArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? bvq::cross_ffn_step<__nv_bfloat16>(*a, s)
                                    : bvq::cross_ffn_step<float>(*a, s);
  return static_cast<int>(e);
}
