// Fused decode head: final LayerNorm -> vocab projection (x per-column
// scale when int8) + bias -> greedy argmax, with no [B, V] logits stored.
//
// Replaces the TPU kernel `head_argmax` (`_head_kernel`) of
// blt_vqg_tpu/ops/pallas/decode_head.py.
//
// At decode batch sizes the head is bound by the bytes of its [D, Vp]
// weight matrix (12.6 MB int8 at D=1024, Vp=12288).  The TPU kernel walks
// the vocab chunks in order and carries a running (max, argmax) in scratch;
// blocks on this card run in no order, so the design is a chain of
// launches whose every reduction has a fixed order:
//  1. the row LayerNorm (f32 statistics, eps 1e-6, rounded to the
//     activation type) into a [B, D] scratch;
//  2. the split-K weight-streaming product of common.cuh, which spreads the
//     weight bytes over every SM and writes f32 partial logits;
//  3. block (vocab tile of HEAD_TILE columns, row) sums a tile's partials
//     in split order, applies scale and bias, and writes the tile's (max,
//     first argmax) into the workspace;
//  4. one thread per row reduces the tiles in order with a strictly-greater
//     test, so the lowest index wins ties, as in the TPU kernel.
// Padded vocab columns carry bias -1e30 and never win.
#include "common.cuh"

namespace bvq {

constexpr int HEAD_TILE = 256;  // vocab columns per block of step 3

struct HeadArgs {
  int act_bf16, w_i8;
  int batch, dim, vocab;
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const void* w;
  const float* scales;
  const float* bias;
  void* xn;     // [B, D] scratch in the activation type
  float* part;  // workspace of bvq_head_workspace() floats: the partial
                // logits, then each (row, tile)'s max and first argmax
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
template <typename T> static size_t head_partial_floats(const HeadArgs& a) {
  const Gemm g = head_gemm(a);
  return gemm_partial_floats<T>(g.B, g.Kg, g.N, g.G);
}

template <typename T>
static cudaError_t head_argmax(const HeadArgs& a, cudaStream_t s) {
  const int tiles = head_tiles(a);
  float* part_max = a.part + head_partial_floats<T>(a);
  int* part_idx = reinterpret_cast<int*>(part_max + (size_t)a.batch * tiles);
  BVQ_TRY(launch_layernorm<T>(static_cast<const T*>(a.x), a.ln_scale, a.ln_bias,
                              static_cast<T*>(a.xn), a.batch, a.dim, s));
  BVQ_TRY(launch_gemm_partials<T>(head_gemm(a), a.w_i8, s));
  const int Bp = cdiv(a.batch, BM) * BM, Np = cdiv(a.vocab, BN) * BN;
  head_tiles_kernel<T><<<dim3(tiles, a.batch), HEAD_TILE, 0, s>>>(a, Bp, Np, part_max,
                                                                  part_idx);
  BVQ_TRY(cudaGetLastError());
  head_reduce_kernel<<<cdiv(a.batch, 128), 128, 0, s>>>(part_max, part_idx, a.tokens,
                                                        a.batch, tiles);
  return cudaGetLastError();
}

}  // namespace bvq

extern "C" int bvq_head_argmax(const bvq::HeadArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? bvq::head_argmax<__nv_bfloat16>(*a, s)
                                    : bvq::head_argmax<float>(*a, s);
  return static_cast<int>(e);
}

// floats of the workspace `part` that a call needs (int32 argmaxes count as
// one float each)
extern "C" long bvq_head_workspace(const bvq::HeadArgs* a) {
  const size_t partial = a->act_bf16 ? bvq::head_partial_floats<__nv_bfloat16>(*a)
                                     : bvq::head_partial_floats<float>(*a);
  return static_cast<long>(partial + 2 * (size_t)a->batch * bvq::head_tiles(*a));
}
