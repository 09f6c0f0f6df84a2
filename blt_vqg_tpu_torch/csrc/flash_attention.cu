// Blockwise flash attention, forward and FlashAttention-2 backward.
//
// Replaces the TPU kernels `_fwd_kernel`, `_dkdv_kernel` and `_dq_kernel` of
// blt_vqg_tpu/ops/pallas/flash_attention.py (`flash_attention` :391, under
// the custom VJP of `_make_flash`).  q [B, Tq, H, D] arrives already scaled;
// k, v [B, Tk, H, D]; an optional key-pad mask [B, Tk] (nonzero = masked);
// `causal` masks key j > query i.  Activations f32 or bf16, D a multiple of
// 8 up to FA_DMAX.  The [B, T, H, D] tensors are read in place through
// their strides: no copy to the TPU kernel's folded [B*H, T, D] layout.
//
// What the TPU kernels compute, and this file copies:
//  - masked logits take NEG_INF = -1e30, and a row whose every visible key
//    is masked outputs ZERO (its running max never rose above the fill);
//    its residual l is 1 here (the backward never reads it: such a row's
//    probabilities are zeroed, so its gradients are zero);
//  - the residuals are (m, l), not lse = m + log(l): f32 would absorb
//    log(l) entirely at the -1e30 fill; l is "safe" (1 where it is 0);
//  - p is rounded to the activation type before the PV product; every sum
//    is f32; the outputs are written in the activation type;
//  - in the backward, ds is zeroed at masked logits, and dO, q, k, v enter
//    every product as f32 values;
//  - a key tile whose every key lies in the future of every query row of
//    the tile contributes nothing and is skipped.
//
// Blocks run in no order on this card, so each block's inner loop takes the
// place of the TPU's sequential grid axis: forward and dQ loop over key
// tiles for one (b*h, 64-row query tile); dK/dV loops over query tiles for
// one (b*h, 64-key tile).  Tiles live in shared memory as f32 rows padded
// by one word (no bank conflicts on the row-parallel reads); the products
// are plain f32 FMA.  On the training path the shapes are tiny (T <= 21,
// B*H = 512), so one call moves about a megabyte and is bound by launch
// latency, not by arithmetic or bytes.  Left for later work: tensor-core
// products (wgmma) and bf16 tiles for long sequences.
//
// delta = rowsum(dO * O) is computed by the caller (the TPU package also
// computes it outside its kernels).
#include "common.cuh"

namespace bvq {

constexpr float FA_NEG_INF = -1e30f;
constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256, FA_DMAX = 128;
constexpr int FA_DC = FA_DMAX / 4;    // d columns a thread owns: d = lane4 + 4c
constexpr int FA_JC = FA_BK / 4;      // key columns a thread scores: j = lane4 + 4c
constexpr int FA_PLD = FA_BK + 1;     // row stride of the [64][64] score tiles

struct FlashArgs {
  int act_bf16, causal;
  int batch, heads, tq, tk, dim;
  const void* q;                // [B, Tq, H, D]
  const void* k;                // [B, Tk, H, D]
  const void* v;                // [B, Tk, H, D]
  const unsigned char* kv_pad;  // [B, Tk] or null
  void* o;                      // [B, Tq, H, D]
  float* m;                     // [B, H, Tq]
  float* l;                     // [B, H, Tq]
  const void* dout;             // [B, Tq, H, D]
  const float* delta;           // [B, H, Tq]
  void* dq;                     // [B, Tq, H, D]
  void* dk;                     // [B, Tk, H, D]
  void* dv;                     // [B, Tk, H, D]
};

// rows [r0, r0 + 64) of x [B, T, H, D] at (b, h) into dst [64][D + 1] as
// f32; rows at or past `len` are zero
template <typename T>
__device__ void flash_load_tile(float* dst, const void* x, int b, int h, int r0,
                                int len, const FlashArgs& a) {
  const int D = a.dim;
  const T* src = static_cast<const T*>(x);
  for (int e = threadIdx.x; e < 64 * D; e += blockDim.x) {
    const int r = e / D, d = e % D, t = r0 + r;
    dst[r * (D + 1) + d] =
        t < len ? to_f<T>(src[(((size_t)b * len + t) * a.heads + h) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ float dot_rows(const float* x, const float* y, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(x[d], y[d], s);
  return s;
}

// key j (< Tk) of batch row b is masked for query i
__device__ __forceinline__ bool flash_masked(const FlashArgs& a, int b, int i, int j) {
  return (a.kv_pad && a.kv_pad[(size_t)b * a.tk + j]) || (a.causal && j > i);
}

// the 4 lanes of a query row reduce together (lanes 4r .. 4r + 3)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Forward: block (b*h, query tile); thread (row = tid / 4, lane4 = tid % 4)
// scores key columns lane4 + 4c and owns output columns lane4 + 4c of its row.
template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float fa_smem[];
  const int D = a.dim, LD = D + 1;
  float* qs = fa_smem;          // [BQ][LD]
  float* ks = qs + FA_BQ * LD;  // [BK][LD]
  float* vs = ks + FA_BK * LD;  // [BK][LD]
  float* ps = vs + FA_BK * LD;  // [BQ][PLD] p rounded to T
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, row = tid / 4, lane4 = tid % 4, i = q0 + row;

  flash_load_tile<T>(qs, a.q, b, h, q0, a.tq, a);
  float m = FA_NEG_INF, l = 0.f, acc[FA_DC];
#pragma unroll
  for (int c = 0; c < FA_DC; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < a.tk; k0 += FA_BK) {
    if (a.causal && k0 > q0 + FA_BQ - 1) break;  // every key in the future
    __syncthreads();  // the previous tile's reads are done
    flash_load_tile<T>(ks, a.k, b, h, k0, a.tk, a);
    flash_load_tile<T>(vs, a.v, b, h, k0, a.tk, a);
    __syncthreads();
    float s[FA_JC];
    float mcur = -INFINITY;
#pragma unroll
    for (int c = 0; c < FA_JC; ++c) {
      const int j = lane4 + 4 * c, kj = k0 + j;
      const bool valid = kj < a.tk;
      s[c] = !valid || flash_masked(a, b, i, kj) ? FA_NEG_INF
                                                 : dot_rows(qs + row * LD, ks + j * LD, D);
      if (valid) mcur = fmaxf(mcur, s[c]);
    }
    const float m_new = fmaxf(m, quad_max(mcur));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < FA_JC; ++c) {
      const int j = lane4 + 4 * c;
      const float p = k0 + j < a.tk ? expf(s[c] - m_new) : 0.f;
      psum += p;
      ps[row * FA_PLD + j] = round_to<T>(p);
    }
    l = l * alpha + quad_sum(psum);
    m = m_new;
    __syncwarp();  // the row's p was written by the 4 lanes that read it
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) {
        float pv = 0.f;
        for (int j = 0; j < FA_BK; ++j) pv = fmaf(ps[row * FA_PLD + j], vs[j * LD + d], pv);
        acc[c] = acc[c] * alpha + pv;
      }
    }
  }

  if (i < a.tq) {
    const bool dead = m <= 0.5f * FA_NEG_INF;
    const float safe = l == 0.f ? 1.f : l;
    T* o = static_cast<T*>(a.o) + (((size_t)b * a.tq + i) * a.heads + h) * D;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) o[d] = from_f<T>(dead ? 0.f : acc[c] / safe);
    }
    if (lane4 == 0) {
      a.m[(size_t)bh * a.tq + i] = m;
      a.l[(size_t)bh * a.tq + i] = dead ? 1.f : safe;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, shared by both kernels: for query row `row` of the tile at q0
// and key columns lane4 + 4c of the tile at k0, the probabilities p and
// ds = p * (dp - delta) (zeroed at masked logits), into ps / dss rows.
struct FlashRows {
  float* m;      // [BQ] the saved running max
  float* linv;   // [BQ] 1 / l
  float* delta;  // [BQ]
};

__device__ void flash_load_rows(const FlashArgs& a, const FlashRows& r, int bh, int q0) {
  for (int t = threadIdx.x; t < FA_BQ; t += blockDim.x) {
    const int i = q0 + t;
    const bool in = i < a.tq;
    r.m[t] = in ? a.m[(size_t)bh * a.tq + i] : 0.f;
    r.linv[t] = in ? 1.f / a.l[(size_t)bh * a.tq + i] : 0.f;
    r.delta[t] = in ? a.delta[(size_t)bh * a.tq + i] : 0.f;
  }
}

__device__ void flash_scores_bwd(const FlashArgs& a, const FlashRows& r, const float* qs,
                                 const float* dos, const float* ks, const float* vs,
                                 float* ps, float* dss, int b, int q0, int k0) {
  const int D = a.dim, LD = D + 1;
  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4, i = q0 + row;
  const float m = r.m[row], linv = r.linv[row], delta = r.delta[row];
  const bool dead = m <= 0.5f * FA_NEG_INF;
#pragma unroll 4
  for (int c = 0; c < FA_JC; ++c) {
    const int j = lane4 + 4 * c, kj = k0 + j;
    float p = 0.f, ds = 0.f;
    if (i < a.tq && kj < a.tk) {
      const float s = flash_masked(a, b, i, kj) ? FA_NEG_INF
                                                : dot_rows(qs + row * LD, ks + j * LD, D);
      p = dead ? 0.f : expf(s - m) * linv;
      ds = s <= 0.5f * FA_NEG_INF ? 0.f
                                   : p * (dot_rows(dos + row * LD, vs + j * LD, D) - delta);
    }
    if (ps) ps[row * FA_PLD + j] = p;
    dss[row * FA_PLD + j] = ds;
  }
}

// dK/dV: block (b*h, key tile); thread (key row jr = tid / 4, lane4) owns
// columns lane4 + 4c of dk and dv for its key.
template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_bwd_dkdv_kernel(FlashArgs a) {
  extern __shared__ float fa_smem[];
  const int D = a.dim, LD = D + 1;
  float* ks = fa_smem;
  float* vs = ks + FA_BK * LD;
  float* qs = vs + FA_BK * LD;
  float* dos = qs + FA_BQ * LD;
  float* ps = dos + FA_BQ * LD;   // [BQ][PLD]
  float* dss = ps + FA_BQ * FA_PLD;
  const FlashRows rows{dss + FA_BQ * FA_PLD, dss + FA_BQ * FA_PLD + FA_BQ,
                       dss + FA_BQ * FA_PLD + 2 * FA_BQ};
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * FA_BK;
  const int tid = threadIdx.x, jr = tid / 4, lane4 = tid % 4;

  flash_load_tile<T>(ks, a.k, b, h, k0, a.tk, a);
  flash_load_tile<T>(vs, a.v, b, h, k0, a.tk, a);
  float dk[FA_DC], dv[FA_DC];
#pragma unroll
  for (int c = 0; c < FA_DC; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < a.tq; q0 += FA_BQ) {
    if (a.causal && k0 > q0 + FA_BQ - 1) continue;  // every key in the future
    __syncthreads();
    flash_load_tile<T>(qs, a.q, b, h, q0, a.tq, a);
    flash_load_tile<T>(dos, a.dout, b, h, q0, a.tq, a);
    flash_load_rows(a, rows, bh, q0);
    __syncthreads();
    flash_scores_bwd(a, rows, qs, dos, ks, vs, ps, dss, b, q0, k0);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < FA_BQ; ++r) {
          sv = fmaf(ps[r * FA_PLD + jr], dos[r * LD + d], sv);
          sk = fmaf(dss[r * FA_PLD + jr], qs[r * LD + d], sk);
        }
        dv[c] += sv;
        dk[c] += sk;
      }
    }
  }

  const int kj = k0 + jr;
  if (kj < a.tk) {
    const size_t off = (((size_t)b * a.tk + kj) * a.heads + h) * D;
    T* dkp = static_cast<T*>(a.dk) + off;
    T* dvp = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) {
        dkp[d] = from_f<T>(dk[c]);
        dvp[d] = from_f<T>(dv[c]);
      }
    }
  }
}

// dQ: block (b*h, query tile); thread (row, lane4) owns columns lane4 + 4c of
// its row's dq.
template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_bwd_dq_kernel(FlashArgs a) {
  extern __shared__ float fa_smem[];
  const int D = a.dim, LD = D + 1;
  float* qs = fa_smem;
  float* dos = qs + FA_BQ * LD;
  float* ks = dos + FA_BQ * LD;
  float* vs = ks + FA_BK * LD;
  float* dss = vs + FA_BK * LD;   // [BQ][PLD]
  const FlashRows rows{dss + FA_BQ * FA_PLD, dss + FA_BQ * FA_PLD + FA_BQ,
                       dss + FA_BQ * FA_PLD + 2 * FA_BQ};
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, row = tid / 4, lane4 = tid % 4, i = q0 + row;

  flash_load_tile<T>(qs, a.q, b, h, q0, a.tq, a);
  flash_load_tile<T>(dos, a.dout, b, h, q0, a.tq, a);
  flash_load_rows(a, rows, bh, q0);
  float dq[FA_DC];
#pragma unroll
  for (int c = 0; c < FA_DC; ++c) dq[c] = 0.f;

  for (int k0 = 0; k0 < a.tk; k0 += FA_BK) {
    if (a.causal && k0 > q0 + FA_BQ - 1) break;  // every key in the future
    __syncthreads();
    flash_load_tile<T>(ks, a.k, b, h, k0, a.tk, a);
    flash_load_tile<T>(vs, a.v, b, h, k0, a.tk, a);
    __syncthreads();
    flash_scores_bwd(a, rows, qs, dos, ks, vs, nullptr, dss, b, q0, k0);
    __syncwarp();  // the row's ds was written by the 4 lanes that read it
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) {
        float s = 0.f;
        for (int j = 0; j < FA_BK; ++j) s = fmaf(dss[row * FA_PLD + j], ks[j * LD + d], s);
        dq[c] += s;
      }
    }
  }

  if (i < a.tq) {
    T* dqp = static_cast<T*>(a.dq) + (((size_t)b * a.tq + i) * a.heads + h) * D;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) dqp[d] = from_f<T>(dq[c]);
    }
  }
}

// ---------------------------------------------------------------------------
enum FlashKernel { FA_FWD, FA_DKDV, FA_DQ };

static size_t flash_smem(FlashKernel which, int D) {
  const size_t tile = (size_t)64 * (D + 1);
  const size_t scores = (size_t)FA_BQ * FA_PLD;
  switch (which) {
    case FA_FWD: return (3 * tile + scores) * sizeof(float);
    case FA_DKDV: return (4 * tile + 2 * scores + 3 * FA_BQ) * sizeof(float);
    default: return (4 * tile + scores + 3 * FA_BQ) * sizeof(float);
  }
}

template <typename T>
static cudaError_t flash_launch(const FlashArgs& a, FlashKernel which, cudaStream_t s) {
  if (a.dim % 8 != 0 || a.dim <= 0 || a.dim > FA_DMAX || a.tq <= 0 || a.tk <= 0)
    return cudaErrorInvalidValue;
  void (*kernel)(FlashArgs) = which == FA_FWD    ? flash_fwd_kernel<T>
                              : which == FA_DKDV ? flash_bwd_dkdv_kernel<T>
                                                 : flash_bwd_dq_kernel<T>;
  const int smem = (int)flash_smem(which, a.dim);
  BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const int tiles = which == FA_DKDV ? cdiv(a.tk, FA_BK) : cdiv(a.tq, FA_BQ);
  kernel<<<dim3(a.batch * a.heads, tiles), FA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

static int flash_entry(const FlashArgs* a, FlashKernel which, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? flash_launch<__nv_bfloat16>(*a, which, s)
                                    : flash_launch<float>(*a, which, s);
  return static_cast<int>(e);
}

}  // namespace bvq

extern "C" int bvq_flash_fwd(const bvq::FlashArgs* a, void* stream) {
  return bvq::flash_entry(a, bvq::FA_FWD, stream);
}

extern "C" int bvq_flash_bwd_dkdv(const bvq::FlashArgs* a, void* stream) {
  return bvq::flash_entry(a, bvq::FA_DKDV, stream);
}

extern "C" int bvq_flash_bwd_dq(const bvq::FlashArgs* a, void* stream) {
  return bvq::flash_entry(a, bvq::FA_DQ, stream);
}
