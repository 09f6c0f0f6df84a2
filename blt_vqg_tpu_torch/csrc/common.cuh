// Shared pieces of the decode kernels: element conversions, reductions, the
// row LayerNorm, the tensor-core primitives, and the two weight-streaming
// products the kernels are built on (the split-K product with f32 partials
// in device memory; the cluster split-K product that sums its partials in
// distributed shared memory).
//
// Activations are float or __nv_bfloat16 (the model's compute dtype);
// weights are the activation type or int8 with per-column f32 scales.
// Every product accumulates in f32.  bf16*bf16 and bf16*int8 products are
// exact in f32, so only the order of the sums differs from the reference.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cooperative_groups.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

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
// Tensor-core primitives (also the bf16 attention kernels', csrc/mma.cuh).
// In the fragments of mma.m16n8k16, lane 4 gr + tq holds rows gr and
// gr + 8, columns 2 tq and 2 tq + 1 of each 8 columns.
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

// ---------------------------------------------------------------------------
// Cluster split-K product (Hopper): bf16 activations, bf16 or int8 weights,
// f32 sums; the per-layer self-attention step's QKV and out products and
// the fused head (csrc/decode_layer.cu, csrc/decode_head.cu) run on it.
// The stack step and the cross/FFN step (their launch sequences were cut
// apart from this product) stay on the split-K product above; moving
// them onto this one is left to a later change that measures it.
//
// At decode batch sizes such a product is bound by its weight bytes.  The
// product above writes each K split's f32 partial tile to device memory
// and sums the partials in another launch.  Here the C blocks of a thread-
// block cluster split one [CK_BM, CK_BN] output tile's K and keep their
// partial tiles in shared memory; after a cluster barrier, rank r sums
// columns [r BN / C, (r + 1) BN / C) of the tile from every rank, in rank
// order 0..C-1 (a fixed order), through distributed shared memory, and
// applies the caller's epilogue; a second barrier keeps each rank's shared
// memory alive until its peers have read it.  No partial leaves the chip.
//
// Each block streams its K slice through a ring of CK_STAGES cp.async
// stages of CK_KS rows (two chunks in flight while a third is used), the
// matching x columns beside the weights; int8 weights stay int8 in shared
// memory and are widened exactly to bf16 as each B fragment is built in
// registers.  The products run on mma.sync m16n8k16 with f32 accumulators
// in registers: warp w owns columns [CK_WN w, CK_WN (w + 1)) of the tile
// and every 16-row slice that holds a live row.  The accumulators stay in the tensor
// core's sums, as the split-K product's WMMA: summing each 16-deep slice
// from zero and adding it in f32 tripled the instructions per product, and
// the loop was bound by their issue.
// The plan (C, each rank's depth, the groups a block takes) comes from the
// caller (ops/kernels/decode_stream.py cluster_split and cluster_heads) and
// is checked here; it takes the fewest ranks that fit the card in one wave
// of blocks.
//
// What bounds it on an H100 (PERF.md; tools/cluster_diag.py): not the
// bytes.  At the flagship shapes a launch takes 8-16 us against a 1-4 us
// bound, nearly the same with the L2 warm or cold and with 2, 3 or 4
// stages, and 10-12 us with no global loads at all: each block is a chain
// of latencies (the first chunk, about 1.4 us a further 64-deep chunk, the
// cluster barrier, the epilogue, the last barrier), and a launch lasts
// about one block's chain per wave of blocks.
namespace cg = cooperative_groups;

constexpr int CK_BM = 64, CK_BN = 64, CK_KS = 64, CK_STAGES = 3;
constexpr int CK_WARPS = 4, CK_THREADS = 32 * CK_WARPS;
constexpr int CK_WN = CK_BN / CK_WARPS, CK_NJ = CK_WN / 8;  // a warp's columns, its n8 tiles
constexpr int CK_MAX_CLUSTER = 8;  // the portable cluster size
constexpr int CK_XLD = CK_KS + 8, CK_WLD = CK_BN + 8;  // bf16 pitches: ldmatrix without conflicts
constexpr int CK_RLD = CK_BN + 16;  // int8 pitch: 16-byte rows, fragment bytes without conflicts
constexpr int CK_PLD = CK_BN + 4;   // f32 pitch of a partial tile
constexpr int CK_XBYTES = CK_BM * CK_XLD * 2, CK_WBYTES = CK_KS * CK_WLD * 2;
constexpr int CK_RBYTES = CK_KS * CK_RLD;
constexpr int CK_PART_BYTES = CK_BM * CK_PLD * 4;

template <bool I8> __host__ __device__ constexpr int ck_stage_bytes() {
  return CK_XBYTES + (I8 ? CK_RBYTES : CK_WBYTES);
}
// byte offset of a block's partial tiles: with one tile it reuses the
// stages, idle by then
template <bool I8> __host__ __device__ constexpr int ck_part_offset(int parts) {
  return parts == 1 ? 0 : CK_STAGES * ck_stage_bytes<I8>();
}
// dynamic shared memory of a block keeping `parts` partial tiles, then
// `extra` bytes for its epilogue
template <bool I8> __host__ __device__ constexpr int ck_smem(int parts, int extra) {
  return (parts == 1 ? (CK_STAGES * ck_stage_bytes<I8>() > CK_PART_BYTES
                            ? CK_STAGES * ck_stage_bytes<I8>()
                            : CK_PART_BYTES)
                     : CK_STAGES * ck_stage_bytes<I8>() + parts * CK_PART_BYTES) +
         extra;
}

// Group g's x element (b, k) is x[g xs_g + b xs_b + k]; its weights w[g]
// are [K, N], row-major, groups contiguous.
struct CkGemm {
  const __nv_bfloat16* x;
  long xs_g, xs_b;
  const void* w;
  int B, K, N, G;
};

// whether (C, kslice) splits depth K over a cluster
static inline bool ck_split_ok(int C, int kslice, int K) {
  return C >= 1 && C <= CK_MAX_CLUSTER && (C & (C - 1)) == 0 && kslice > 0 &&
         kslice % 16 == 0 && (long)C * kslice >= K;
}

// The block's partial products into its shared memory, one [CK_BM][CK_PLD]
// f32 tile each for groups g0 .. g0 + parts - 1 (those below G):
// P[m][n] = sum over k in [k0, k1) of x[g][m0 + m][k] w[g][k][n0 + n], rows
// past B and columns past N zero.
template <bool I8>
__device__ void ck_partials(const CkGemm& p, int g0, int parts, int m0, int n0, int k0,
                            int k1, unsigned char* smem) {
  using bf = __nv_bfloat16;
  using TW = typename std::conditional<I8, int8_t, bf>::type;
  constexpr int SB = ck_stage_bytes<I8>(), E = 16 / sizeof(TW);
  constexpr int WLD = I8 ? CK_RLD : CK_WLD;  // pitch of the weights as loaded
  float* part = reinterpret_cast<float*>(smem + ck_part_offset<I8>(parts));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mi = lane / 8, lr8 = lane % 8, gr = lane / 4, tq = lane % 4;
  const int live = min(CK_BM, p.B - m0);
  const int nch = k1 > k0 ? (k1 - k0 + CK_KS - 1) / CK_KS : 0;
  const bf zero = __float2bfloat16_rn(0.f);
  TW wzero;
  if constexpr (I8) wzero = 0; else wzero = zero;
  for (int i = 0; i < parts && g0 + i < p.G; ++i) {
    const int g = g0 + i;
    const bf* xg = p.x + g * p.xs_g + (size_t)m0 * p.xs_b;
    const TW* wg = static_cast<const TW*>(p.w) + (size_t)g * p.K * p.N + n0;
    // chunk c (K rows k0 + c CK_KS onwards) into stage c % CK_STAGES
    auto load = [&](int c) {
      unsigned char* st = smem + (c % CK_STAGES) * SB;
      bf* xs = reinterpret_cast<bf*>(st);
      TW* ws = reinterpret_cast<TW*>(st + CK_XBYTES);
      const int kc = k0 + c * CK_KS, kn = min(CK_KS, k1 - kc);
#pragma unroll
      for (int j = 0; j < CK_BM * CK_KS / 8 / CK_THREADS; ++j) {
        const int ch = tid + j * CK_THREADS, m = ch / (CK_KS / 8), k = (ch % (CK_KS / 8)) * 8;
        rf_load16(xs + m * CK_XLD + k, xg + (size_t)m * p.xs_b + kc + k,
                  m < live ? max(0, min(8, kn - k)) : 0, zero);
      }
#pragma unroll
      for (int j = 0; j < CK_KS * CK_BN / E / CK_THREADS; ++j) {
        const int ch = tid + j * CK_THREADS, k = ch / (CK_BN / E), n = (ch % (CK_BN / E)) * E;
        rf_load16(ws + k * WLD + n, wg + (size_t)(kc + k) * p.N + n,
                  k < kn ? max(0, min(E, p.N - n0 - n)) : 0, wzero);
      }
    };
    float acc[CK_BM / 16][CK_NJ][4];
#pragma unroll
    for (int t = 0; t < CK_BM / 16; ++t)
#pragma unroll
      for (int j = 0; j < CK_NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[t][j][q] = 0.f;
#pragma unroll
    for (int c = 0; c < CK_STAGES - 1; ++c) {
      if (c < nch) load(c);
      rf_commit();
    }
    for (int c = 0; c < nch; ++c) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(CK_STAGES - 2) : "memory");  // chunk c
      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's stage
      if (c + CK_STAGES - 1 < nch) load(c + CK_STAGES - 1);  // into chunk c - 1's stage
      rf_commit();
      const unsigned char* st = smem + (c % CK_STAGES) * SB;
      const bf* xs = reinterpret_cast<const bf*>(st);
      const TW* ws = reinterpret_cast<const TW*>(st + CK_XBYTES);
      const int kn = min(CK_KS, k1 - (k0 + c * CK_KS));
#pragma unroll
      for (int kk = 0; kk < CK_KS; kk += 16) {
        if (kk >= kn) break;
        uint32_t bw[CK_NJ][2];  // B fragments of the warp's n8 tiles j: columns CK_WN warp + 8 j
        if constexpr (I8) {
          // widened exactly to bf16 in registers: rows kk + 2 tq (+1, +8, +9), column gr
#pragma unroll
          for (int j = 0; j < CK_NJ; ++j) {
            const int8_t* r = ws + (kk + 2 * tq) * CK_RLD + CK_WN * warp + 8 * j + gr;
            bw[j][0] = rf_pack((float)r[0], (float)r[CK_RLD]);
            bw[j][1] = rf_pack((float)r[8 * CK_RLD], (float)r[9 * CK_RLD]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < CK_NJ; j += 2) {
            uint32_t f[4];
            rf_ldsm_t(f, ws + (kk + 8 * (mi & 1) + lr8) * CK_WLD + CK_WN * warp + 8 * j +
                             8 * (mi >> 1));
            bw[j][0] = f[0];
            bw[j][1] = f[1];
            bw[j + 1][0] = f[2];
            bw[j + 1][1] = f[3];
          }
        }
#pragma unroll
        for (int t = 0; t < CK_BM / 16; ++t) {
          if (16 * t < live) {
            uint32_t ax[4];
            rf_ldsm(ax, xs + (16 * t + 8 * (mi & 1) + lr8) * CK_XLD + kk + 8 * (mi >> 1));
#pragma unroll
            for (int j = 0; j < CK_NJ; ++j) rf_mma(acc[t][j], ax, bw[j][0], bw[j][1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the stages (the partial may reuse them)
    float* pt = part + (size_t)i * CK_BM * CK_PLD;
#pragma unroll
    for (int t = 0; t < CK_BM / 16; ++t)
#pragma unroll
      for (int j = 0; j < CK_NJ; ++j) {
        const int row = 16 * t + gr, col = CK_WN * warp + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(pt + row * CK_PLD + col) = make_float2(acc[t][j][0], acc[t][j][1]);
        *reinterpret_cast<float2*>(pt + (row + 8) * CK_PLD + col) =
            make_float2(acc[t][j][2], acc[t][j][3]);
      }
  }
}

template <bool I8> __device__ __forceinline__ float* ck_part_tiles(unsigned char* smem, int parts) {
  return reinterpret_cast<float*>(smem + ck_part_offset<I8>(parts));
}

// columns (float4 groups) of rank r's share of a tile: [r s, (r + 1) s), s = CK_BN / 4 / C;
// a thread takes ck_items(C) of the share's (row, float4) items, item j being
// it = threadIdx.x + j CK_THREADS: row it / s, float4 r s + it % s (so s
// consecutive lanes share a row)
__host__ __device__ constexpr int ck_share4(int C) { return CK_BN / 4 / C; }
__host__ __device__ constexpr int ck_items(int C) { return CK_BM * CK_BN / 4 / C / CK_THREADS; }

// the float4 at (row, col) of partial tile `tile` in rank r's shared memory
__device__ __forceinline__ float4 ck_peer4(cg::cluster_group& cl, float* tiles, int r,
                                           int tile, int row, int col) {
  return *cl.map_shared_rank(
      reinterpret_cast<float4*>(tiles + ((size_t)tile * CK_BM + row) * CK_PLD + col), r);
}

// (row, col) of partial tile 0 summed over the C ranks in rank order
template <int C>
__device__ __forceinline__ float4 ck_sum4(cg::cluster_group& cl, float* tiles, int row, int col) {
  float4 v[C];
#pragma unroll
  for (int r = 0; r < C; ++r) v[r] = ck_peer4(cl, tiles, r, 0, row, col);
  float4 s = v[0];
#pragma unroll
  for (int r = 1; r < C; ++r) {
    s.x += v[r].x;
    s.y += v[r].y;
    s.z += v[r].z;
    s.w += v[r].w;
  }
  return s;
}

// Raises kernel's dynamic shared memory allowance to `bytes` where the
// allowance set so far (`set`, the kernel's own per device) is lower;
// `max_carveout` also asks for the largest shared-memory carveout: left to
// choose, CUDA gave the cluster kernels a carveout that held fewer blocks
// than their shared memory allows, and they ran slower.
static cudaError_t allow_smem(const void* kernel, int bytes, int (&set)[BVQ_DEVICES],
                              bool max_carveout = false) {
  int dev = 0;
  BVQ_TRY(cudaGetDevice(&dev));
  if (dev < BVQ_DEVICES && set[dev] >= bytes) return cudaSuccess;
  BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (max_carveout)
    BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared));
  if (dev < BVQ_DEVICES) set[dev] = bytes;
  return cudaSuccess;
}

// A cluster kernel's state per device: its shared-memory allowance and the
// last (cluster, shared memory) shape found schedulable.
struct CkLaunch {
  int smem[BVQ_DEVICES];
  long shape[BVQ_DEVICES];
};

// index of a cluster size (1, 2, 4, 8) among a kernel's instantiations
static inline int ck_size_index(int C) { return C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3; }

// Launches kernel on `grid` in clusters of `cluster` blocks along x, with
// `smem` bytes of dynamic shared memory.  The allowance is raised first,
// then the card is asked once per shape whether it can hold one such
// cluster at all (cudaOccupancyMaxActiveClusters): a shape it cannot
// schedule is an error, never another path.
template <typename... KArgs, typename... Args>
static cudaError_t launch_cluster(void (*kernel)(KArgs...), CkLaunch& st, dim3 grid,
                                  int cluster, int smem, cudaStream_t s, Args&&... args) {
  if (cluster < 1 || cluster > CK_MAX_CLUSTER || grid.x % cluster) return cudaErrorInvalidValue;
  int dev = 0;
  BVQ_TRY(cudaGetDevice(&dev));
  BVQ_TRY(allow_smem((const void*)kernel, smem, st.smem, true));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CK_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long shape = ((long)cluster << 32) | (unsigned)smem;
  if (dev >= BVQ_DEVICES || st.shape[dev] != shape) {
    int clusters = 0;
    BVQ_TRY(cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg));
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (dev < BVQ_DEVICES) st.shape[dev] = shape;
  }
  BVQ_TRY(cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...));
  return cudaGetLastError();
}

}  // namespace bvq
