// One greedy-decode step of the whole decoder stack.
//
// Replaces the TPU kernel `decode_stack_step` (`_stream_kernel`) of
// blt_vqg_tpu/ops/pallas/decode_stream.py.  Per layer: LayerNorm -> per-head
// QKV -> attention over the cached rows < pos plus the in-flight K/V at pos
// (optional pad-key mask) -> out projection -> residual; LayerNorm ->
// cross-attention over the precomputed encoder K/V with the source mask ->
// residual; LayerNorm -> FFN (ReLU, biases) -> residual.
//
// At decode batch sizes (tens of rows) the step is bound by the bytes of
// weights and KV cache it reads, not by arithmetic: every weight is used
// for only B rows.  This first design keeps it simple and right:
//  - one split-K weight-streaming product (common.cuh) serves all six
//    weight kinds, bf16 or int8: hundreds of blocks each stage one weight
//    tile with 16-byte loads, so every SM streams weight bytes; the
//    tensor cores multiply; a second launch sums the f32 partials in a
//    fixed order and applies the int8 scale, bias, ReLU, residual and
//    output type;
//  - the per-head and per-chunk weight slices stay in the TPU kernel's
//    stacked layouts; the out-projection products sum their head (or chunk)
//    groups in order into the residual, the TPU kernel's accumulation order;
//  - self-attention reads only the cache rows < pos, one block per
//    (batch row, head), so the cache bytes read grow with pos;
//  - the attention kernels sum their own q, k and v from the QKV and
//    cross-q partials, and each residual product's epilogue also writes
//    the LayerNorm that comes next, so the step is 12 launches per layer
//    and one LayerNorm (73 at 6 layers): per layer 6 products,
//    2 attention kernels, 3 residual epilogues with LayerNorm (the last
//    layer's last without) and the FFN-in epilogue.
// Left for later work: a pipelined product (TMA, wgmma), a weight stream
// that runs on across launches (the TPU kernel fetches stage i + 1 during
// stage i) and fewer launches a layer.
#include <algorithm>

#include "common.cuh"

namespace bvq {

struct StackArgs {
  int act_bf16;  // activations (and caches) bf16, else f32
  int batch, dim, layers, heads, head_dim, lmax, pos, tc, hc, fc, ffn;
  int w_i8[6];   // per weight kind (qkv, out, qc, oc, w1, w2): int8 + scales
  float q_scale;  // head_dim ** -0.5, rounded to the activation type
  const void* x;
  const float* lns;
  const void* w[6];
  const float* s[6];
  const void* cache_k;
  const void* cache_v;
  const void* ckc;
  const void* cvc;
  const int* smask;
  const float* b1;
  const float* b2;
  const float* key_pad;
  const float* key_pad_cur;
  void* x_out;
  void* k_new;
  void* v_new;
  // scratch
  void* xn;
  void* ctx;
  void* ctxc;
  void* h1;
  float* part;  // partial products: part_floats floats
  long part_floats;
};

// ---------------------------------------------------------------------------
// Cached self-attention of one layer: block (b, h).  qkv: the QKV
// product's partials, head h's outputs (b, 0..3*Dh) summed here (f32);
// caches [Lmax, B, Dh] per (layer, head).  Rows >= pos are never read: the
// TPU kernel fills them with 1e3 * MASK_FILL, whose exponent underflows to
// exactly 0, so skipping them is the same function.
// Writes k_new/v_new [H, B, Dh] and ctx [H, B, Dh].
template <typename T>
__global__ void __launch_bounds__(128)
    self_attn_kernel(GemmOut qkv, const T* __restrict__ ck,
                     const T* __restrict__ cv, const float* __restrict__ kpad,
                     const float* __restrict__ kpad_cur, T* __restrict__ k_new,
                     T* __restrict__ v_new, T* __restrict__ ctx, int B, int H,
                     int Dh, int Lmax, int pos, float q_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = smem + Dh;
  float* vs = smem + 2 * Dh;
  float* sc = smem + 3 * Dh;  // pos + 1 scores, then their exponentials
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const size_t hb = ((size_t)h * B + b) * Dh;
  for (int d = tid; d < Dh; d += blockDim.x) {
    float o[3];  // q, k, v
    qkv.at(h, b, d, Dh, o);
    // q is rounded to the activation type, then scaled in it
    qs[d] = round_to<T>(round_to<T>(o[0]) * q_scale);
    ks[d] = round_to<T>(o[1]);
    vs[d] = round_to<T>(o[2]);
    k_new[hb + d] = from_f<T>(ks[d]);
    v_new[hb + d] = from_f<T>(vs[d]);
  }
  __syncthreads();

  const T* kc = ck + (size_t)h * Lmax * B * Dh;
  const T* vc = cv + (size_t)h * Lmax * B * Dh;
  for (int n = warp; n <= pos; n += nwarps) {
    float s = 0.f;
    if (n < pos) {
      const T* kr = kc + ((size_t)n * B + b) * Dh;
      for (int d = lane; d < Dh; d += 32) s += round_to<T>(qs[d] * to_f<T>(kr[d]));
    } else {
      for (int d = lane; d < Dh; d += 32) s += round_to<T>(qs[d] * ks[d]);
    }
    s = warp_sum(s);
    if (lane == 0) {
      const bool masked =
          kpad != nullptr && (n < pos ? kpad[(size_t)n * B + b] != 0.f : kpad_cur[b] != 0.f);
      sc[n] = masked ? MASK_FILL : s;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int n = 0; n <= pos; ++n) m = fmaxf(m, sc[n]);
  __syncthreads();
  for (int n = tid; n <= pos; n += blockDim.x) sc[n] = expf(sc[n] - m);
  __syncthreads();
  float den = 0.f;
  for (int n = 0; n < pos; ++n) den += sc[n];
  den += sc[pos];
  for (int d = tid; d < Dh; d += blockDim.x) {
    float acc = 0.f;
    // the unnormalized weights are rounded to the activation type before
    // the V sum; the in-flight row is summed in f32
    for (int n = 0; n < pos; ++n)
      acc += round_to<T>(round_to<T>(sc[n]) * to_f<T>(vc[((size_t)n * B + b) * Dh + d]));
    acc += sc[pos] * vs[d];
    ctx[hb + d] = from_f<T>(acc / den);
  }
}

// ---------------------------------------------------------------------------
// Cross-attention of one layer: block (b, h), h = j * hpc + i.  q: the
// cross-q product's partials, group j's outputs (b, i*Dh..) summed here
// (f32); ckc/cvc [Hc, Tc, B, hpc*Dh]; smask [Tc, B] (1 = masked).  Writes
// ctx [Hc, B, hpc*Dh].  Scores, softmax and context in f32.
template <typename T>
__global__ void __launch_bounds__(128)
    cross_attn_kernel(GemmOut q, const T* __restrict__ ck,
                      const T* __restrict__ cv, const int* __restrict__ smask,
                      T* __restrict__ ctx, int B, int H, int Hc, int Dh, int Tc,
                      float q_scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* sc = smem + Dh;
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int hpc = H / Hc, j = h / hpc, i = h % hpc, W = hpc * Dh;
  const size_t qrow = ((size_t)j * B + b) * W + (size_t)i * Dh;
  for (int d = tid; d < Dh; d += blockDim.x)
    qs[d] = round_to<T>(round_to<T>(q.at(j, b, i * Dh + d)) * q_scale);
  __syncthreads();
  const T* ckj = ck + (size_t)j * Tc * B * W;
  const T* cvj = cv + (size_t)j * Tc * B * W;
  for (int t = warp; t < Tc; t += nwarps) {
    const T* kr = ckj + ((size_t)t * B + b) * W + (size_t)i * Dh;
    float s = 0.f;
    for (int d = lane; d < Dh; d += 32) s += qs[d] * to_f<T>(kr[d]);
    s = warp_sum(s);
    if (lane == 0) sc[t] = smask[(size_t)t * B + b] != 0 ? MASK_FILL : s;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int t = 0; t < Tc; ++t) m = fmaxf(m, sc[t]);
  float den = 0.f;
  for (int t = 0; t < Tc; ++t) den += expf(sc[t] - m);
  for (int d = tid; d < Dh; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < Tc; ++t)
      acc += (expf(sc[t] - m) / den) *
             to_f<T>(cvj[((size_t)t * B + b) * W + (size_t)i * Dh + d]);
    ctx[qrow + d] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// The six products of layer l (qkv, out, qc, oc, w1, w2) over the scratch
// buffers; the epilogue of each fuses its int8 scale, bias, ReLU, residual
// and output type.  `out` and `oc` and `w2` add into x_out, `out` starting
// from the layer's input, and their epilogue also writes the LayerNorm of
// x_out that comes next (residual_ln_kernel).
template <typename T>
static void layer_gemms(const StackArgs& a, int l, Gemm g[6]) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  const int Hc = a.hc, Fc = a.fc;
  const int W = (H / Hc) * Dh, fch = a.ffn / Fc;
  // [Kg, N] of each kind, the group count, and x's group and row strides
  const int kg[6] = {D, Dh, D, W, D, fch};
  const int n[6] = {3 * Dh, D, W, D, fch, D};
  const int groups[6] = {H, H, Hc, Hc, Fc, Fc};
  const long xs_g[6] = {0, (long)B * Dh, 0, (long)B * W, 0, (long)B * fch};
  const void* xs[6] = {a.xn, a.ctx, a.xn, a.ctxc, a.xn, a.h1};
  // qkv and qc have no epilogue: the attention kernels sum their partials
  void* outs[6] = {nullptr, a.x_out, nullptr, a.x_out, a.h1, a.x_out};
  for (int i = 0; i < 6; ++i) {
    const size_t layer_elems = (size_t)groups[i] * kg[i] * n[i];
    const size_t wsize = a.w_i8[i] ? 1 : sizeof(T);
    g[i] = Gemm{};
    g[i].x = xs[i];
    g[i].xs_g = xs_g[i];
    g[i].xs_b = kg[i];
    g[i].w = static_cast<const char*>(a.w[i]) + wsize * layer_elems * l;
    g[i].B = B;
    g[i].Kg = kg[i];
    g[i].N = n[i];
    g[i].G = groups[i];
    g[i].part = a.part;
    g[i].scale = a.s[i] ? a.s[i] + (size_t)groups[i] * n[i] * l : nullptr;
    g[i].out = outs[i];
    g[i].reduce = i % 2;
  }
  g[1].res = l == 0 ? a.x : a.x_out;
  g[3].res = a.x_out;
  g[4].bias = a.b1 + (size_t)l * Fc * fch;
  g[4].relu = 1;
  g[5].res = a.x_out;
  g[5].bias = a.b2 + (size_t)l * D;
}

// Whether the caller's workspace holds every product's partials
// (ops/kernels/decode_stream.py sizes it).
template <typename T>
static bool stack_workspace_ok(const StackArgs& a) {
  Gemm g[6];
  layer_gemms<T>(a, 0, g);
  for (const Gemm& p : g)
    if (gemm_partial_floats<T>(p.B, p.Kg, p.N, p.G) > (size_t)a.part_floats) return false;
  return true;
}

template <typename T>
static cudaError_t stack_step(const StackArgs& a, cudaStream_t s) {
  const int B = a.batch, D = a.dim, H = a.heads, Dh = a.head_dim;
  const int Hc = a.hc, Tc = a.tc, Lmax = a.lmax;
  const int W = (H / Hc) * Dh;
  T* xn = static_cast<T*>(a.xn);
  const size_t cache_layer = (size_t)H * Lmax * B * Dh;
  const size_t cross_layer = (size_t)Hc * Tc * B * W;
  if (!stack_workspace_ok<T>(a)) return cudaErrorInvalidValue;

  // LayerNorm of the layer's input: the first is a launch of its own, the
  // others come with the residual products before them (residual_ln_kernel)
  const float* ln0 = a.lns;
  BVQ_TRY(launch_layernorm<T>(static_cast<const T*>(a.x), ln0, ln0 + D, xn, B, D, s));
  for (int l = 0; l < a.layers; ++l) {
    const float* ln = a.lns + (size_t)l * 6 * D;
    Gemm g[6];
    layer_gemms<T>(a, l, g);

    // ---- self-attention: sums its head's q, k, v from the QKV partials
    BVQ_TRY(launch_gemm_partials<T>(g[0], a.w_i8[0], s));
    T* kn = static_cast<T*>(a.k_new) + (size_t)l * H * B * Dh;
    T* vn = static_cast<T*>(a.v_new) + (size_t)l * H * B * Dh;
    const size_t self_smem = sizeof(float) * (3 * Dh + Lmax + 1);
    self_attn_kernel<T><<<dim3(B, H), 128, self_smem, s>>>(
        gemm_out<T>(g[0]), static_cast<const T*>(a.cache_k) + cache_layer * l,
        static_cast<const T*>(a.cache_v) + cache_layer * l, a.key_pad, a.key_pad_cur, kn, vn,
        static_cast<T*>(a.ctx), B, H, Dh, Lmax, a.pos, a.q_scale);
    BVQ_TRY(cudaGetLastError());
    BVQ_TRY((launch_residual_ln<T, T, T>(g[1], a.w_i8[1], false, false, ln + 2 * D, ln + 3 * D,
                                         xn, s)));

    // ---- cross-attention: sums its q from the cross-q partials
    BVQ_TRY(launch_gemm_partials<T>(g[2], a.w_i8[2], s));
    const size_t cross_smem = sizeof(float) * (Dh + Tc);
    cross_attn_kernel<T><<<dim3(B, H), 128, cross_smem, s>>>(
        gemm_out<T>(g[2]), static_cast<const T*>(a.ckc) + cross_layer * l,
        static_cast<const T*>(a.cvc) + cross_layer * l, a.smask, static_cast<T*>(a.ctxc), B, H,
        Hc, Dh, Tc, a.q_scale);
    BVQ_TRY(cudaGetLastError());
    BVQ_TRY((launch_residual_ln<T, T, T>(g[3], a.w_i8[3], false, false, ln + 4 * D, ln + 5 * D,
                                         xn, s)));

    // ---- FFN; the next layer's first LayerNorm comes with the last product
    BVQ_TRY(launch_gemm<T>(g[4], a.w_i8[4], false, s));
    if (l + 1 < a.layers) {
      const float* next = ln + 6 * D;
      BVQ_TRY((launch_residual_ln<T, T, T>(g[5], a.w_i8[5], false, false, next, next + D, xn,
                                           s)));
    } else {
      BVQ_TRY(launch_gemm<T>(g[5], a.w_i8[5], false, s));
    }
  }
  return cudaSuccess;
}

}  // namespace bvq

extern "C" int bvq_decode_stack_step(const bvq::StackArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? bvq::stack_step<__nv_bfloat16>(*a, s)
                                    : bvq::stack_step<float>(*a, s);
  return static_cast<int>(e);
}

extern "C" const char* bvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
