// Shared pieces of the decode kernels: element conversions, reductions, the
// row LayerNorm and the weight-streaming product both kernels are built on.
//
// Activations are float or __nv_bfloat16 (the model's compute dtype);
// weights are the activation type or int8 with per-column f32 scales.
// Every product accumulates in f32.  bf16*bf16 and bf16*int8 products are
// exact in f32, so only the order of the sums differs from the reference.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace bvq {

constexpr float MASK_FILL = -1e18f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// rounds v to T's precision (a value of T, held as float)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

#define BVQ_TRY(expr)                    \
  do {                                   \
    const cudaError_t e_ = (expr);       \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

// ---------------------------------------------------------------------------
// 16 bytes of TS elements at p: one load where p is 16-byte aligned and
// all are valid, else element loads (zeros from index `valid` on).
template <typename TS>
__device__ __forceinline__ uint4 load16(const TS* p, int valid) {
  constexpr int E = 16 / sizeof(TS);
  if (valid >= E && reinterpret_cast<uintptr_t>(p) % 16 == 0)
    return *reinterpret_cast<const uint4*>(p);
  uint4 u = make_uint4(0, 0, 0, 0);
  TS* e = reinterpret_cast<TS*>(&u);
  for (int i = 0; i < E && i < valid; ++i) e[i] = p[i];
  return u;
}

// The 16 / sizeof(TS) elements held in raw, converted to TD, stored at a
// 16-byte aligned dst.
template <typename TS, typename TD>
__device__ __forceinline__ void store16(TD* dst, uint4 raw) {
  constexpr int E = 16 / sizeof(TS);
  if constexpr (sizeof(TS) == sizeof(TD)) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    const TS* e = reinterpret_cast<const TS*>(&raw);
    alignas(16) TD out[E];
    for (int i = 0; i < E; ++i) out[i] = from_f<TD>(to_f<TS>(e[i]));
    for (int j = 0; j < (int)(E * sizeof(TD) / 16); ++j)
      reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(out)[j];
  }
}

// ---------------------------------------------------------------------------
// Row LayerNorm, one block per row with the row held in registers: f32
// statistics (two passes: mean, then the mean squared deviation), eps 1e-6,
// the result rounded to TO (by default the input type T).  Rows of up to
// LN_MAX_DIM elements.
constexpr int LN_THREADS = 128, LN_CHUNKS = 4;
constexpr int LN_MAX_DIM = LN_THREADS * LN_CHUNKS * 8;

// the sum of v over the block, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by the previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) t += red[w];
  return t;
}

// The LayerNorm of one row of d elements of T, held by the block as raw
// 16-byte chunks (thread t: chunk c holds elements (c * LN_THREADS + t) * E
// onwards, zeros past d), written to orow as TO.
template <typename T>
using ln_chunks = uint4[LN_CHUNKS * 8 / (16 / sizeof(T))];

template <typename T, typename TO>
__device__ __forceinline__ void layernorm_row(const ln_chunks<T>& raw,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              TO* __restrict__ orow, int d, float* red) {
  constexpr int E = 16 / sizeof(T);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS * 8 / E; ++c) {
    const T* e = reinterpret_cast<const T*>(&raw[c]);
    for (int j = 0; j < E; ++j) s += to_f<T>(e[j]);
  }
  const float mean = block_sum(s, red) / d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS * 8 / E; ++c) {
    const int i = (c * LN_THREADS + threadIdx.x) * E;
    const T* e = reinterpret_cast<const T*>(&raw[c]);
    for (int j = 0; j < E && i + j < d; ++j) {
      const float dv = to_f<T>(e[j]) - mean;
      q += dv * dv;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / d + 1e-6f);
#pragma unroll
  for (int c = 0; c < LN_CHUNKS * 8 / E; ++c) {
    const int i = (c * LN_THREADS + threadIdx.x) * E;
    const T* e = reinterpret_cast<const T*>(&raw[c]);
    for (int j = 0; j < E && i + j < d; ++j)
      orow[i + j] = from_f<TO>((to_f<T>(e[j]) - mean) * rstd * scale[i + j] + bias[i + j]);
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(LN_THREADS)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, TO* __restrict__ out, int d) {
  __shared__ float red[LN_THREADS / 32];
  constexpr int E = 16 / sizeof(T);
  const T* xr = x + (size_t)blockIdx.x * d;
  ln_chunks<T> raw;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS * 8 / E; ++c) {
    const int i = (c * LN_THREADS + threadIdx.x) * E;
    raw[c] = load16<T>(xr + i, d - i);
  }
  layernorm_row<T, TO>(raw, scale, bias, out + (size_t)blockIdx.x * d, d, red);
}

template <typename T, typename TO = T>
static cudaError_t launch_layernorm(const T* x, const float* scale,
                                    const float* bias, TO* out, int rows, int d,
                                    cudaStream_t s) {
  if (d > LN_MAX_DIM) return cudaErrorInvalidValue;
  layernorm_kernel<T, TO><<<rows, LN_THREADS, 0, s>>>(x, scale, bias, out, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight-streaming product, split over K.
//
// At decode batch sizes a product [B, K] x [K, N] with B <= 64 reads each
// weight once and uses it B times, so it is bound by the weight bytes.  To
// keep every SM streaming, block (column tile, group g, K split) stages one
// [GK, BN] weight tile and the matching [BM, GK] slice of x in shared memory
// (16-byte loads, every one issued before the first store), multiplies them,
// and writes its f32 partial product; a second launch (gemm_epilogue_kernel)
// sums the partials in a fixed order, so the result does not depend on
// block scheduling.  bf16 tiles go through the tensor cores (WMMA, f32
// accumulation); int8 weights are widened to bf16 in shared memory, which
// is exact; f32 activations take plain FMA.
//
// Operand layout: group g has x element (b, k) at x[g*xs_g + b*xs_b + k] and
// the weights w[g] of [Kg, N] (row-major, groups contiguous).
constexpr int BM = 64, BN = 64, GEMM_THREADS = 128;

// K depth of one block: shared memory is BM*(GK+8) + GK*(BN+8) elements
template <typename T> __host__ __device__ constexpr int gemm_depth() {
  return sizeof(T) == 2 ? 256 : 128;
}
template <typename T> __host__ __device__ constexpr int gemm_smem() {
  return (BM * (gemm_depth<T>() + 8) + gemm_depth<T>() * (BN + 8)) * (int)sizeof(T);
}

struct Gemm {
  const void* x;
  long xs_g, xs_b;
  const void* w;
  int B, Kg, N, G;
  float* part;  // [G * splits, Bp, Np] f32, Bp = BM * row tiles, Np = BN * column tiles
  // epilogue
  const float* scale;  // [G, N] or null
  const float* bias;   // [G, N] (separate) or [N] (reduce) or null
  const void* res;     // reduce: [B, N] in T, added first; may alias out
  void* out;           // separate: [G, B, N]; reduce: [B, N]
  int reduce, relu;
};

template <typename T> __host__ __device__ inline int gemm_splits(int kg) {
  return (kg + gemm_depth<T>() - 1) / gemm_depth<T>();
}
// floats of the partial buffer of one product
template <typename T> inline size_t gemm_partial_floats(int B, int Kg, int N, int G) {
  return (size_t)G * gemm_splits<T>(Kg) * cdiv(B, BM) * BM * cdiv(N, BN) * BN;
}

// The output (g, b, n) of a product before its epilogue's bias, ReLU or
// residual: the partials of group g summed in split order, then scaled
// (int8) once.  A kernel that needs only a few of a product's outputs (an
// attention block its head's q, k and v) sums them itself, in place of an
// epilogue launch.
struct GemmOut {
  const float* part;
  const float* scale;  // [G, N] or null
  long Bp;
  int Np, N, splits;

  __device__ __forceinline__ float at(int g, int b, int n) const {
    float v[1];
    at(g, b, n, 0, v);
    return v[0];
  }

  // v[k] = out(g, b, n + k * stride): the K sums' loads issued together
  template <int K>
  __device__ __forceinline__ void at(int g, int b, int n, int stride, float (&v)[K]) const {
    const float* p = part + ((size_t)g * splits * Bp + b) * Np + n;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] += p[(size_t)s * Bp * Np + k * stride];
    if (scale)
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] *= scale[(size_t)g * N + n + k * stride];
  }
};

template <typename T> static GemmOut gemm_out(const Gemm& p) {
  return GemmOut{p.part, p.scale, (long)cdiv(p.B, BM) * BM, cdiv(p.N, BN) * BN, p.N,
                 gemm_splits<T>(p.Kg)};
}

template <typename T, typename TW>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_partial_kernel(Gemm p) {
  constexpr int GK = gemm_depth<T>(), XLD = GK + 8, WLD = BN + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [BM][XLD]
  T* ws = xs + BM * XLD;                   // [GK][WLD]
  const int tid = threadIdx.x;
  const int splits = gemm_splits<T>(p.Kg);
  const int g = blockIdx.y / splits, split = blockIdx.y % splits;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM, k0 = split * GK;
  const int kn = min(GK, p.Kg - k0);
  const T* xg = static_cast<const T*>(p.x) + g * p.xs_g + k0;
  const TW* wg = static_cast<const TW*>(p.w) + ((size_t)g * p.Kg + k0) * p.N + n0;

  // 16-byte chunks: x holds E elements of T, w EW of TW
  constexpr int E = 16 / sizeof(T), EW = 16 / sizeof(TW);
  constexpr int XC = BM * GK / E / GEMM_THREADS, WC = GK * BN / EW / GEMM_THREADS;
  uint4 xr[XC], wr[WC];
#pragma unroll
  for (int i = 0; i < WC; ++i) {
    const int c = tid + i * GEMM_THREADS;
    const int k = c / (BN / EW), n = (c % (BN / EW)) * EW;
    wr[i] = load16<TW>(wg + (size_t)k * p.N + n, k < kn ? p.N - n0 - n : 0);
  }
#pragma unroll
  for (int i = 0; i < XC; ++i) {
    const int c = tid + i * GEMM_THREADS;
    const int m = c / (GK / E), k = (c % (GK / E)) * E;
    xr[i] = load16<T>(xg + (size_t)(m0 + m) * p.xs_b + k, m0 + m < p.B ? kn - k : 0);
  }
#pragma unroll
  for (int i = 0; i < WC; ++i) {
    const int c = tid + i * GEMM_THREADS;
    store16<TW, T>(ws + (c / (BN / EW)) * WLD + (c % (BN / EW)) * EW, wr[i]);
  }
#pragma unroll
  for (int i = 0; i < XC; ++i) {
    const int c = tid + i * GEMM_THREADS;
    store16<T, T>(xs + (c / (GK / E)) * XLD + (c % (GK / E)) * E, xr[i]);
  }
  __syncthreads();

  const int Np = gridDim.x * BN;
  const size_t Bp = (size_t)gridDim.z * BM;
  float* part = p.part + ((size_t)blockIdx.y * Bp + m0) * Np + n0;
  if constexpr (sizeof(T) == 2) {
    // warp w: all 64 rows x columns [16w, 16w + 16)
    using namespace nvcuda;
    const int warp = tid / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16];
    for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < kn; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, ws + k * WLD + warp * 16, WLD);
      for (int i = 0; i < BM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, xs + i * 16 * XLD + k, XLD);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    for (int i = 0; i < BM / 16; ++i)
      wmma::store_matrix_sync(part + (size_t)i * 16 * Np + warp * 16, acc[i], Np,
                              wmma::mem_row_major);
  } else {
    // thread: rows [8 ty, 8 ty + 8) x columns [4 tx, 4 tx + 4)
    const int tx = tid % 16, ty = tid / 16;
    float acc[8][4] = {};
    for (int k = 0; k < kn; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[k * WLD + tx * 4]);
      for (int i = 0; i < 8; ++i) {
        const float a = to_f<T>(xs[(ty * 8 + i) * XLD + k]);
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(part + (size_t)(ty * 8 + i) * Np + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// One thread per output element.  The partials of a group are summed in
// split order, then scaled (int8) once: acc_g * scale[g, n].
//  separate: out[g, b, n] = relu?(acc_g * scale + bias[g, n])
//  reduce:   out[b, n] = (res[b, n] + bias[n]) + sum_g acc_g * scale[g, n],
//            the groups added in order (the TPU kernel's stage order)
template <typename T, typename TO>
__global__ void __launch_bounds__(256) gemm_epilogue_kernel(Gemm p, int Bp, int Np) {
  const int splits = gemm_splits<T>(p.Kg);
  const int gcount = p.reduce ? 1 : p.G;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)gcount * p.B * p.N) return;
  const int n = idx % p.N, b = (idx / p.N) % p.B, go = idx / ((long)p.N * p.B);
  const GemmOut o{p.part, p.scale, Bp, Np, p.N, splits};
  float v;
  if (p.reduce) {
    v = p.res ? to_f<T>(static_cast<const T*>(p.res)[(size_t)b * p.N + n]) : 0.f;
    if (p.bias) v = v + p.bias[n];
    for (int g = 0; g < p.G; ++g) v += o.at(g, b, n);
  } else {
    v = o.at(go, b, n);
    if (p.bias) v = v + p.bias[(size_t)go * p.N + n];
    if (p.relu) v = fmaxf(v, 0.f);
  }
  static_cast<TO*>(p.out)[idx] = from_f<TO>(v);
}

// Allows a kernel its dynamic shared memory once per device: `done` is
// the kernel's own flag per device (cudaFuncSetAttribute is a host call of
// its own, too dear for every launch).
constexpr int BVQ_DEVICES = 16;

static cudaError_t allow_smem_once(const void* kernel, int bytes, int (&done)[BVQ_DEVICES]) {
  int dev = 0;
  BVQ_TRY(cudaGetDevice(&dev));
  if (dev < BVQ_DEVICES && done[dev]) return cudaSuccess;
  BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (dev < BVQ_DEVICES) done[dev] = 1;
  return cudaSuccess;
}

// The partial products of p into p.part (no epilogue).
template <typename T>
static cudaError_t launch_gemm_partials(const Gemm& p, bool w_i8, cudaStream_t s) {
  const dim3 grid(cdiv(p.N, BN), p.G * gemm_splits<T>(p.Kg), cdiv(p.B, BM));
  constexpr int smem = gemm_smem<T>();
  if (w_i8) {
    static int done[BVQ_DEVICES];
    BVQ_TRY(allow_smem_once((const void*)gemm_partial_kernel<T, int8_t>, smem, done));
    gemm_partial_kernel<T, int8_t><<<grid, GEMM_THREADS, smem, s>>>(p);
  } else {
    static int done[BVQ_DEVICES];
    BVQ_TRY(allow_smem_once((const void*)gemm_partial_kernel<T, T>, smem, done));
    gemm_partial_kernel<T, T><<<grid, GEMM_THREADS, smem, s>>>(p);
  }
  return cudaGetLastError();
}

// The whole product: partials, then the epilogue into p.out (f32 or T).
template <typename T>
static cudaError_t launch_gemm(const Gemm& p, bool w_i8, bool out_f32, cudaStream_t s) {
  BVQ_TRY(launch_gemm_partials<T>(p, w_i8, s));
  const int Bp = cdiv(p.B, BM) * BM, Np = cdiv(p.N, BN) * BN;
  const long outputs = (long)(p.reduce ? 1 : p.G) * p.B * p.N;
  const int blocks = (int)((outputs + 255) / 256);
  if (out_f32)
    gemm_epilogue_kernel<T, float><<<blocks, 256, 0, s>>>(p, Bp, Np);
  else
    gemm_epilogue_kernel<T, T><<<blocks, 256, 0, s>>>(p, Bp, Np);
  return cudaGetLastError();
}

// A reduce product's epilogue fused with the LayerNorm of its output, one
// block per row b:
//   v[n] = res[b, n] (TR) (+ bias[n] unless bias_last), + the groups in
//          order (rounded to T after each when round_groups), (+ bias[n]
//          when bias_last); out[b, n] = v as TO;
//   xn[b, :] = LayerNorm(out[b, :]) rounded to T,
// with each thread holding the elements of layernorm_kernel's own chunks,
// so both results are the separate launches' to the bit.  A thread loads
// RLN_LOADS partials of all its elements at once, with the int8 scales of
// the groups they finish (up to 32 16-byte loads in flight).
constexpr int RLN_LOADS = 2;

// x[n..n+3], zeros past N: one 16-byte load where `vec` (x 16-byte aligned
// and N a multiple of 4).
__device__ __forceinline__ float4 load4(const float* x, int n, int N, bool vec) {
  if (vec && n + 3 < N) return *reinterpret_cast<const float4*>(x + n);
  float e[4];
  for (int j = 0; j < 4; ++j) e[j] = n + j < N ? x[n + j] : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <typename T, typename TR, typename TO>
__global__ void __launch_bounds__(LN_THREADS)
    residual_ln_kernel(Gemm p, int Bp, int Np, int round_groups, int bias_last,
                       const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                       T* __restrict__ xn) {
  __shared__ float red[LN_THREADS / 32];
  constexpr int E = 16 / sizeof(TO), C = LN_CHUNKS * 8 / E;
  const int b = blockIdx.x, N = p.N, splits = gemm_splits<T>(p.Kg);
  const float* part = p.part + (size_t)b * Np;
  float v[C][E], acc[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = (c * LN_THREADS + threadIdx.x) * E;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      float r = 0.f;
      if (i + j < N) {
        if (p.res) r = to_f<TR>(static_cast<const TR*>(p.res)[(size_t)b * N + i + j]);
        if (p.bias && !bias_last) r = r + p.bias[i + j];
      }
      v[c][j] = r;
    }
  }
  // partial q = g * splits + split, RLN_LOADS of them loaded at a time
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < E; ++j) acc[c][j] = 0.f;
  const int nq = p.G * splits;
  const bool vec_scale = N % 4 == 0 && reinterpret_cast<uintptr_t>(p.scale) % 16 == 0;
  for (int q0 = 0; q0 < nq; q0 += RLN_LOADS) {
    float4 in[RLN_LOADS][C][E / 4], sc[RLN_LOADS][C][E / 4];
#pragma unroll
    for (int l = 0; l < RLN_LOADS; ++l) {
      const int q = q0 + l;
      const float* src = part + (size_t)q * Bp * Np;
      // the scales of group q / splits, where q is its last split
      const float* scale = p.scale && q < nq && (q + 1) % splits == 0
                               ? p.scale + (size_t)(q / splits) * N
                               : nullptr;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = (c * LN_THREADS + threadIdx.x) * E;
#pragma unroll
        for (int j4 = 0; j4 < E / 4; ++j4) {
          in[l][c][j4] = q < nq && i < Np  // past the padded width: zeros
                             ? *reinterpret_cast<const float4*>(src + i + 4 * j4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
          if (scale) sc[l][c][j4] = load4(scale, i + 4 * j4, N, vec_scale);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < RLN_LOADS; ++l) {
      const int q = q0 + l;
      if (q >= nq) break;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j4 = 0; j4 < E / 4; ++j4) {
          acc[c][4 * j4] += in[l][c][j4].x;
          acc[c][4 * j4 + 1] += in[l][c][j4].y;
          acc[c][4 * j4 + 2] += in[l][c][j4].z;
          acc[c][4 * j4 + 3] += in[l][c][j4].w;
        }
      if ((q + 1) % splits) continue;
      // group q / splits is summed: scale it and add it in
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = (c * LN_THREADS + threadIdx.x) * E;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if (i + j < N) {
            const float4 s4 = sc[l][c][j / 4];
            const float s1 = j % 4 == 0 ? s4.x : j % 4 == 1 ? s4.y : j % 4 == 2 ? s4.z : s4.w;
            v[c][j] += p.scale ? acc[c][j] * s1 : acc[c][j];
            if (round_groups) v[c][j] = round_to<T>(v[c][j]);
          }
          acc[c][j] = 0.f;
        }
      }
    }
  }
  ln_chunks<TO> raw;
  TO* orow = static_cast<TO*>(p.out) + (size_t)b * N;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = (c * LN_THREADS + threadIdx.x) * E;
    TO* e = reinterpret_cast<TO*>(&raw[c]);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      float r = v[c][j];
      if (p.bias && bias_last && i + j < N) r = r + p.bias[i + j];
      e[j] = from_f<TO>(i + j < N ? r : 0.f);
      if (i + j < N) orow[i + j] = e[j];
    }
  }
  layernorm_row<TO, T>(raw, ln_scale, ln_bias, xn + (size_t)b * N, N, red);
}

// The reduce product p (partials, then residual_ln_kernel): out = p's
// epilogue, xn = LayerNorm(out) with ln_scale and ln_bias.
template <typename T, typename TR, typename TO>
static cudaError_t launch_residual_ln(const Gemm& p, bool w_i8, bool round_groups,
                                      bool bias_last, const float* ln_scale,
                                      const float* ln_bias, T* xn, cudaStream_t s) {
  if (p.N > LN_MAX_DIM || !p.reduce) return cudaErrorInvalidValue;
  BVQ_TRY(launch_gemm_partials<T>(p, w_i8, s));
  const int Bp = cdiv(p.B, BM) * BM, Np = cdiv(p.N, BN) * BN;
  residual_ln_kernel<T, TR, TO><<<p.B, LN_THREADS, 0, s>>>(
      p, Bp, Np, (int)round_groups, (int)bias_last, ln_scale, ln_bias, xn);
  return cudaGetLastError();
}

}  // namespace bvq
