// W8A16 product: y[M, N] = (x[M, K] @ w8[K, N]) * scale[N].
//
// Replaces the TPU kernel `int8_matmul` (`_kernel`) of
// blt_vqg_tpu/ops/pallas/int8_matmul.py: the weights stay int8 in device
// memory and are widened inside the kernel, the product accumulates in f32,
// and the per-column scale is applied to the f32 sum before the result is
// rounded to x's type, as the TPU kernel does.
//
// At the shapes it serves (a vocab head or an FFN product at decode batch
// sizes) the product is bound by the int8 weight bytes.  It runs on the
// split-K weight-streaming product of common.cuh, whose int8 form is the one
// the stack and head kernels use: blocks stage one int8 weight tile each
// with 16-byte loads, widen it to bf16 in shared memory (exact), multiply on
// the tensor cores (f32 activations: FMA), and a second launch sums the f32
// partials in split order and applies the scale.  Any N works: the ragged
// edge is masked by index, with no padded copy of the weights.
#include "common.cuh"

namespace bvq {

struct Int8Args {
  int act_bf16;  // x and y bf16, else f32
  int m, k, n;
  const void* x;       // [M, K]
  const int8_t* w8;    // [K, N]
  const float* scale;  // [N]
  void* y;             // [M, N]
  float* part;         // bvq_int8_matmul_workspace() floats
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

}  // namespace bvq

extern "C" int bvq_int8_matmul(const bvq::Int8Args* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
