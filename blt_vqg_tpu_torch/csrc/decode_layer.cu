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
// rows 0..pos.  This first design is simple and right, built from the
// pieces of common.cuh:
//  - the products are its split-K weight-streaming product (hundreds of
//    blocks stage one weight tile each with 16-byte loads, WMMA on bf16,
//    f32 partials); the epilogues that fuse residuals are local (below);
//  - the TPU grid runs the heads in sequence and rounds the running output
//    to x's type after each head.  Here the heads run in parallel blocks, so
//    the out projection leaves one f32 partial product per head (the split-K
//    partials, grouped by head), and one epilogue pass adds them to the
//    residual in head order 0..H-1, rounding after each: the TPU result;
//  - the attention reads only cache rows 0..pos.  The TPU kernel fills rows
//    past pos with NEG_INF, whose exponent underflows to exactly 0, so this
//    is the same function under the documented precondition that key_pad
//    never marks a row past pos (the pad fill, applied to every row, would
//    otherwise lift such a row above NEG_INF; JAX ops/transformer.py
//    DecoderLayer.step states the same precondition);
//  - self_attn_step is 6 launches on the caller's stream; cross_ffn_step
//    9, its cross-attention summing its q from the q product's partials
//    and the cross-out residual's epilogue writing the FFN's LayerNorm
//    too (residual_ln_kernel), as in decode_stream.cu.
// Left for later work: the same fusions in self_attn_step, fewer launches
// a layer, and a pipelined product.
#include <algorithm>

#include "common.cuh"

namespace bvq {

constexpr float NEG_INF = -1e30f;
constexpr float PAD_FILL = MASK_FILL;  // strictly above NEG_INF

struct SelfAttnArgs {
  int act_bf16;  // activations, weights and caches bf16, else f32
  int batch, dim, heads, head_dim, lmax, pos;
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
  // scratch
  void* xn;      // [B, D]
  float* qkv;    // [H, B, 3*Dh]
  void* ctx;     // [H, B, Dh]
  float* part;   // partial products, bvq_self_attn_workspace() floats
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
static void self_gemms(const SelfAttnArgs& a, Gemm g[2]) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  g[0] = make_gemm(a.xn, 0, D, a.w_qkv, B, D, 3 * Dh, H, a.part);  // QKV
  g[0].out = a.qkv;
  g[1] = make_gemm(a.ctx, (long)B * Dh, Dh, a.w_out, B, Dh, D, H, a.part);  // out
}

template <typename T> static size_t self_workspace(const SelfAttnArgs& a) {
  Gemm g[2];
  self_gemms(a, g);
  size_t floats = 0;
  for (const Gemm& p : g) floats = std::max(floats, gemm_partial_floats<T>(p.B, p.Kg, p.N, p.G));
  return floats;
}

template <typename T>
static cudaError_t self_attn_step(const SelfAttnArgs& a, cudaStream_t s) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  Gemm g[2];
  self_gemms(a, g);
  BVQ_TRY(launch_layernorm<T>(static_cast<const T*>(a.x), a.ln_scale, a.ln_bias,
                              static_cast<T*>(a.xn), B, D, s));
  BVQ_TRY(launch_gemm<T>(g[0], false, true, s));
  const size_t smem = sizeof(float) * (3 * Dh + a.pos + 1);
  layer_self_attn_kernel<T><<<dim3(B, H), 128, smem, s>>>(
      a.qkv, static_cast<T*>(a.cache_k), static_cast<T*>(a.cache_v), a.key_pad, a.kp_sl,
      a.kp_sb, static_cast<T*>(a.ctx), B, Dh, a.lmax, a.pos, a.q_scale);
  BVQ_TRY(cudaGetLastError());
  return launch_residual<T, T, T>(g[1], static_cast<const T*>(a.x), nullptr,
                                  static_cast<T*>(a.out), true, s);
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
  const cudaError_t e = a->act_bf16 ? bvq::self_attn_step<__nv_bfloat16>(*a, s)
                                    : bvq::self_attn_step<float>(*a, s);
  return static_cast<int>(e);
}

extern "C" long bvq_self_attn_workspace(const bvq::SelfAttnArgs* a) {
  return static_cast<long>(a->act_bf16 ? bvq::self_workspace<__nv_bfloat16>(*a)
                                       : bvq::self_workspace<float>(*a));
}

extern "C" int bvq_cross_ffn_step(const bvq::CrossFfnArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? bvq::cross_ffn_step<__nv_bfloat16>(*a, s)
                                    : bvq::cross_ffn_step<float>(*a, s);
  return static_cast<int>(e);
}
