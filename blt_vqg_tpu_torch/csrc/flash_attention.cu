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
//    every product as f32 values (on the tensor cores they are exact bf16
//    operands, and the f32 p and ds go in as hi + lo bf16 pairs);
//  - a key tile whose every key lies in the future of every query row of
//    the tile contributes nothing and is skipped.
//
// Blocks run in no order on this card, so each block's inner loop takes the
// place of the TPU's sequential grid axis.
//  - f32 (a check path, not a speed target): plain f32 FMA tiles of 64
//    rows, one (b, h) per block.  Forward and dQ loop over key tiles for
//    one (b*h, 64-row query tile); dK/dV loops over query tiles for one
//    (b*h, 64-key tile).  Tiles live in shared memory as f32 rows padded by
//    one word.
//  - bf16: flash_fwd_mma_kernel, flash_bwd_dkdv_mma_kernel and
//    flash_bwd_dq_mma_kernel, tensor cores (mma.sync m16n8k16, csrc/mma.cuh;
//    the forward's S excepted, below) on the tiling of the ring kernels
//    (csrc/ring_attention.cu).  A warp owns 16 rows: the forward's and
//    dQ's are queries, dK/dV's keys.  A (b, h) takes 1, 2 or 4 warps for an
//    owned length up to 16, up to 32, or longer; a block of 4 warps holds
//    4 / wq (b, h), neighbouring heads of one batch row.  The walked operand
//    comes in tiles of its length rounded up to 16, at most 64, through two
//    cp.async stages when there is more than one tile; the head dim is
//    zero-padded to 16.  The tiling (`FlashGeom`) is computed on the host
//    (ops/kernels/flash_attention.py `mma_geom`) and checked here.
//
// Bound on this card: the bytes of the operands once each at 3.35 TB/s, or
// the operations of the visible (query, key) pairs at 989 TF/s (bf16);
// chip_smoke.py computes both per call.  At the flagship's training shapes
// (B 64, H 8, Dh 128; Tq x Tk = 3 x 3, 21 x 21, 20 x 20 causal, 20 x 3)
// all three kernels are bound by bytes: over a latent step's 24 calls,
// 52.6 us (forward), 74.9 us (dK/dV) and 67.8 us (dQ) on an NVIDIA H100
// 80GB HBM3 at 700 W.  What costs there is the latency of each block's few
// loads and the share of the card a launch fills: 64-row f32 tiles at T <=
// 21 left 89-99.8% of each score tile dead, and one (b, h) per block took
// one or two blocks per SM.  The bf16 kernels size their tiles by the
// sequence (16-row steps), give every (b, h) its own warps, and fit 2
// blocks per SM, so a training call runs in one wave (21 x 21: 256 blocks;
// 3 x 3: 128).  Left for later work: wgmma fed by TMA for long sequences.
//
// delta = rowsum(dO * O) is computed by the caller (the TPU package also
// computes it outside its kernels).
#include "mma.cuh"

namespace bvq {

constexpr float FA_NEG_INF = -1e30f;
constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256, FA_DMAX = 128;
constexpr int FA_DC = FA_DMAX / 4;    // d columns a thread owns: d = lane4 + 4c
constexpr int FA_JC = FA_BK / 4;      // key columns a thread scores: j = lane4 + 4c
constexpr int FA_PLD = FA_BK + 1;     // row stride of the [64][64] score tiles

// The bf16 kernels' tiling, computed on the host (`mma_geom` in
// ops/kernels/flash_attention.py, which a CPU test covers), passed beside
// the operands in a launch's FlashCall, and checked by flash_geom_ok.
// "Owned" rows are a warp's own (dK/dV: keys, length Tk; forward and dQ:
// queries, length Tq); "walked" rows are the other side's, which the block
// walks in tiles.
struct FlashGeom {
  int wq;      // warps per (b, h): 1, 2 or 4, each owning 16 rows
  int groups;  // (b, h) per block, FM_WARPS / wq
  int kt;      // rows of a walked tile: the walked length rounded up to 16, at most
               // 64, less where a block would not fit twice on an SM
  int dp;      // D rounded up to 16 (zero-padded in shared memory and registers)
  int lds;     // shared row stride in elements, dp + 8: the 8 rows an ldmatrix
               // reads fall 16 bytes apart modulo 128, on distinct banks
  int fixed;   // bytes a group holds for the whole launch (dK/dV: its K and V;
               // the forward: its q rows in f32, rows of dp + 4)
  int stage;   // bytes of one stage of the walked rows, per group
  int nst;     // stages: 2 when the walked length spans more than one tile
  int smem;    // dynamic shared bytes of a block, groups * (fixed + nst * stage)
  int grid_x;  // blocks over the B * H (b, h): cdiv(B * H, groups)
  int grid_y;  // blocks over the owned rows: cdiv(owned length, 16 * wq)
};

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

// What the host passes to an entry point: the operands, and the bf16
// kernels' tiling (unread by the f32 kernels).  The FMA kernels take
// FlashArgs alone: with the tiling inside their parameter, the compiler
// scheduled the forward otherwise (more registers), and its device time
// rose 1.7x at the training shapes (chip_smoke.py phase 7, NVIDIA H100
// 80GB HBM3 at 700 W).
struct FlashCall {
  FlashArgs a;
  FlashGeom geom;
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
// Forward, f32: block (b*h, query tile); thread (row = tid / 4, lane4 =
// tid % 4) scores key columns lane4 + 4c and owns output columns lane4 + 4c
// of its row.
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
// bf16: tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32), 4 warps a
// block.  The forward's products are S = q k^T and o += p v, p rounded to
// bf16 as the contract rounds it.  The backward's five are S = q k^T and
// dP = dO v^T (recomputed by both kernels), dV += p^T dO, dK += ds^T q and
// dQ += ds k.  q, k, v and dO are bf16 inputs, exact as operands; in the
// backward p and ds are f32 values, and the contract runs their products
// in f32: each is fed as a pair hi = bf16(x), lo = bf16(x - hi) (rb_split,
// rb_mma_pair).
//
// Rows past the sequence are filled so that no element test is needed for
// them: a query row past Tq is a dead row (m = NEG_INF, so p = 0, l = 1,
// delta = 0, and q and dO zero), a key past Tk a masked key (K and V zero,
// its pad byte set).  In the backward a dead row (m <= NEG_INF / 2) has p =
// 0 at every key, so it adds nothing to any gradient; the forward writes
// it o = 0.
constexpr int FM_WARPS = 4;
constexpr int FM_THREADS = 32 * FM_WARPS;
constexpr int FM_BLOCKS_PER_SM = 2;
constexpr int FM_SMEM_MAX = 232448;  // dynamic shared memory a block may take on sm_90

// offset of element (b, t, h, 0) of a [B, T, H, D] operand
__device__ __forceinline__ size_t fa_at(int b, int t, int h, int T, int H, int D) {
  return (((size_t)b * T + t) * H + h) * D;
}

// the key tile at k0 of (b, h) into a stage, by the group's threads: K and,
// with `with_v`, V rows (zeros past Tk and the dim), then the keys' pad
// bytes (1 past Tk, so that keys past the sequence are masked keys)
__device__ __forceinline__ void flash_stage_kv(const FlashArgs& a, const FlashGeom& g,
                                               unsigned char* stage, int b, int h, int k0,
                                               bool with_v, int gtid, int gthreads) {
  using T = __nv_bfloat16;
  const int D = a.dim, H = a.heads, Tk = a.tk, nd = g.dp / 8;
  const T zero = __float2bfloat16_rn(0.f);
  T* ks = reinterpret_cast<T*>(stage);
  T* vs = ks + g.kt * g.lds;
  unsigned char* ps = reinterpret_cast<unsigned char*>(vs + g.kt * g.lds);
  for (int c = gtid; c < g.kt * nd; c += gthreads) {
    const int r = c / nd, d0 = (c % nd) * 8, kj = k0 + r;
    const int valid = kj < Tk ? max(0, min(8, D - d0)) : 0;
    const size_t off = kj < Tk ? fa_at(b, kj, h, Tk, H, D) + d0 : 0;
    rf_load16(ks + r * g.lds + d0, static_cast<const T*>(a.k) + off, valid, zero);
    if (with_v) rf_load16(vs + r * g.lds + d0, static_cast<const T*>(a.v) + off, valid, zero);
  }
  for (int c = gtid; c < g.kt / 16; c += gthreads) {
    const int kj = k0 + 16 * c, valid = max(0, min(16, Tk - kj));
    if (a.kv_pad) {
      rf_load16(ps + 16 * c, a.kv_pad + (size_t)b * Tk + kj, valid, (unsigned char)1);
    } else {
      for (int e = 0; e < 16; ++e) ps[16 * c + e] = e < valid ? 0 : 1;
    }
  }
}

// S for 2 query rows (qa, qb: f32, shared memory) and 4 keys (k[]: bf16
// rows, shared memory): s[x][y][e] += q_y . k_{2x+e} as f32 FMA chains
// over d = 0 .. D - 1 in order, the order of the plain version's f32
// product (and of the FMA kernel's dot_rows)
__device__ __forceinline__ void fwd_scores_fma(float (&s)[2][2][2], const float* qa,
                                               const float* qb,
                                               const __nv_bfloat16* const (&k)[4], int D) {
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 8) {
    float q[2][8];
    *reinterpret_cast<float4*>(&q[0][0]) = *reinterpret_cast<const float4*>(qa + d0);
    *reinterpret_cast<float4*>(&q[0][4]) = *reinterpret_cast<const float4*>(qa + d0 + 4);
    *reinterpret_cast<float4*>(&q[1][0]) = *reinterpret_cast<const float4*>(qb + d0);
    *reinterpret_cast<float4*>(&q[1][4]) = *reinterpret_cast<const float4*>(qb + d0 + 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 raw = *reinterpret_cast<const uint4*>(k[j] + d0);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 kv = __bfloat1622float2(k2[t]);
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          float& acc = s[j >> 1][y][j & 1];
          acc = fmaf(q[y][2 * t], kv.x, acc);
          acc = fmaf(q[y][2 * t + 1], kv.y, acc);
        }
      }
    }
  }
}

// Forward: block ((b, h) group, 16 * wq query rows).  Replaces the TPU
// kernel `_fwd_kernel` (blt_vqg_tpu/ops/pallas/flash_attention.py:45);
// bound by bytes at the training shapes (52.6 us over a latent step's 24
// calls on an NVIDIA H100 80GB HBM3 at 700 W), so it takes the dQ kernel's
// tiling, which fills the card with short tiles.  Warp w owns query rows
// r0 .. r0 + 15 of its group's (b, h): their running max m, sum l and o (16
// rows x D) in registers, q in f32 in the group's fixed shared memory; the
// block walks the key tiles (K, V and the keys' pad bytes) through the
// stages, the load of the next tile issued before the products of this
// one.  o += p v runs on the tensor cores, p rounded to bf16 as the A
// operand, as the contract rounds it.
//
// S = q k^T runs as f32 FMA chains in the plain version's order, not on
// the tensor cores: m and l are held to 4e-7 of their largest value, about
// one f32 ulp of the largest logit, and S summed in any other order (16- or
// 8-deep tensor-core sums added in f32) put l past that at long rows.
//
// p is rounded to bf16 against the row's final max, as the TPU kernel
// rounds it wherever Tk fits its one 512-key block.  A max that each tile
// moves would round the p of the earlier tiles at other points than the
// plain version does: at Tq 16 x Tk 1,024 that alone puts o past the norm
// limit it is held to.  So a block that walks more than one key tile walks
// them twice: first K alone, for the rows' max, then K and V, the online
// update starting from that max (alpha = 1).  The one-tile blocks of the
// training shapes walk once.
__global__ void __launch_bounds__(FM_THREADS, FM_BLOCKS_PER_SM)
    flash_fwd_mma_kernel(const __grid_constant__ FlashArgs a,
                         const __grid_constant__ FlashGeom g) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int D = a.dim, H = a.heads, Tq = a.tq, Tk = a.tk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq4 = lane % 4;
  const int grp = warp / g.wq;
  const int gtid = threadIdx.x - grp * 32 * g.wq, gthreads = 32 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;            // the last block's groups may be idle
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int own = 16 * g.wq;
  const int qb = blockIdx.y * own;                 // the block's first query row
  const int rw = 16 * (warp % g.wq);               // the warp's first row in the tile
  const int r0 = qb + rw;
  const bool live = active && r0 < Tq;             // the warp has a row to own
  const int qlast = min(Tq, qb + own) - 1;         // the block's last row
  const int ntk = (Tk + g.kt - 1) / g.kt, qld = g.dp + 4;
  unsigned char* gsm = fm_smem + (size_t)grp * (g.fixed + g.nst * g.stage);
  float* qs = reinterpret_cast<float*>(gsm);       // [own][qld] f32
  unsigned char* stg = gsm + g.fixed;

  // the group's q rows in f32, zero past Tq (rows of 16 bytes a thread)
  if (active) {
    const int nd = D / 8;
    for (int c = gtid; c < own * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, i = qb + r;
      const uint4 raw =
          load16(static_cast<const T*>(a.q) + (i < Tq ? fa_at(b, i, h, Tq, H, D) + d0 : 0),
                 i < Tq ? 8 : 0);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 v0 = __bfloat1622float2(q2[0]), v1 = __bfloat1622float2(q2[1]);
      const float2 v2 = __bfloat1622float2(q2[2]), v3 = __bfloat1622float2(q2[3]);
      *reinterpret_cast<float4*>(qs + r * qld + d0) = make_float4(v0.x, v0.y, v1.x, v1.y);
      *reinterpret_cast<float4*>(qs + r * qld + d0 + 4) = make_float4(v2.x, v2.y, v3.x, v3.y);
    }
  }

  // causal: key tiles wholly after the block's last row are skipped (the
  // TPU kernel's `live` test); the warp computes its 16-key slices up to
  // its last visible key
  const int nt = a.causal ? min(ntk, qlast / g.kt + 1) : ntk;
  const int klast = a.causal ? min(Tk, r0 + 16) - 1 : Tk - 1;
  // steps: npre tiles for the max alone (none for a one-tile block), then
  // the nt tiles of the online pass
  const int npre = nt > 1 ? nt : 0, nsteps = npre + nt;
  auto load = [&](int u, int st) {
    if (active)
      flash_stage_kv(a, g, stg + (size_t)st * g.stage, b, h, (u < npre ? u : u - npre) * g.kt,
                     u >= npre, gtid, gthreads);
  };

  // the rows r0 + gr + 8y: running max, sum of p, and o (acc[n][2y + c]
  // is column 8n + 2 tq4 + c)
  float mr[2] = {FA_NEG_INF, FA_NEG_INF}, lr[2] = {0.f, 0.f}, acc[MMA_DT][4];
#pragma unroll
  for (int n = 0; n < MMA_DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  load(0, 0);
  rf_commit();
  for (int u = 0, st = 0; u < nsteps; ++u, st ^= 1) {
    if (u + 1 < nsteps) load(u + 1, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // step u's tile has landed
    __syncthreads();  // (and, at u = 0, the q rows are stored)

    const int k0 = (u < npre ? u : u - npre) * g.kt;
    const int nsl = live && klast >= k0 ? min(g.kt / 16, (klast - k0) / 16 + 1) : 0;
    if (nsl > 0) {
      const T* ks = reinterpret_cast<const T*>(stg + (size_t)st * g.stage);
      const T* vs = ks + g.kt * g.lds;
      const unsigned char* ps = reinterpret_cast<const unsigned char*>(vs + g.kt * g.lds);
      // S: the warp's rows x 16 keys per slice jp, in the accumulator
      // layout of mma.m16n8k16 (s[jp][x][c]: row gr + 8 (c >> 1), key
      // 16 jp + 8 x + 2 tq4 + (c & 1))
      float s[FA_BK / 16][2][4];
#pragma unroll
      for (int jp = 0; jp < FA_BK / 16; ++jp) {
        float t[2][2][2] = {};
        if (jp < nsl) {
          const T* const kr[4] = {ks + (16 * jp + 2 * tq4) * g.lds,
                                  ks + (16 * jp + 2 * tq4 + 1) * g.lds,
                                  ks + (16 * jp + 8 + 2 * tq4) * g.lds,
                                  ks + (16 * jp + 8 + 2 * tq4 + 1) * g.lds};
          fwd_scores_fma(t, qs + (rw + gr) * qld, qs + (rw + gr + 8) * qld, kr, D);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[jp][x][c] = t[x][c >> 1][c & 1];
      }
      // masked logits take NEG_INF: padded keys and keys past Tk (pad byte
      // 1), and causal keys after the row.  Only a tile with a pad byte set
      // or a key after the warp's first row needs the tests.
      const int kn = 16 * nsl;
      const bool edge = __any_sync(0xffffffffu, (lane < kn && ps[lane]) ||
                                                    (lane + 32 < kn && ps[lane + 32])) ||
                        (a.causal && k0 + kn - 1 > r0);
      float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
      for (int jp = 0; jp < FA_BK / 16; ++jp) {
        if (jp < nsl) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int col = 16 * jp + 8 * x + 2 * tq4 + (c & 1), i = r0 + gr + 8 * (c >> 1);
              if (edge && (ps[col] || (a.causal && k0 + col > i))) s[jp][x][c] = FA_NEG_INF;
              mx[c >> 1] = fmaxf(mx[c >> 1], s[jp][x][c]);
            }
          }
        }
      }
      if (u < npre) {
#pragma unroll
        for (int y = 0; y < 2; ++y) mr[y] = fmaxf(mr[y], quad_max(mx[y]));
      } else {
        // the online update; p from the unrounded logits, l sums the f32 p
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const float m_new = fmaxf(mr[y], quad_max(mx[y]));
          alpha[y] = expf(mr[y] - m_new);
          mr[y] = m_new;
        }
#pragma unroll
        for (int jp = 0; jp < FA_BK / 16; ++jp) {
          if (jp < nsl) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float p = expf(s[jp][x][c] - mr[c >> 1]);
                s[jp][x][c] = p;
                psum[c >> 1] += p;
              }
            }
          }
        }
#pragma unroll
        for (int y = 0; y < 2; ++y) lr[y] = lr[y] * alpha[y] + quad_sum(psum[y]);
#pragma unroll
        for (int n = 0; n < MMA_DT; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
        // o += p v, p rounded to bf16 as the A operand, keys 16 jp .. + 15
#pragma unroll
        for (int jp = 0; jp < FA_BK / 16; ++jp) {
          if (jp < nsl) {
            const uint32_t pa[4] = {rf_pack(s[jp][0][0], s[jp][0][1]),
                                    rf_pack(s[jp][0][2], s[jp][0][3]),
                                    rf_pack(s[jp][1][0], s[jp][1][1]),
                                    rf_pack(s[jp][1][2], s[jp][1][3])};
            rf_mma_tile_t(acc, pa, vs + 16 * jp * g.lds, g.lds, g.dp, lane);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // a dead row (no visible key: m never rose above the fill) writes o = 0,
  // l = 1; a live row o = acc / safe-l in bf16; rows past Tq store nothing
  if (!active) return;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    if (i >= Tq) continue;
    const bool dead = mr[y] <= 0.5f * FA_NEG_INF;
    const float safe = lr[y] == 0.f ? 1.f : lr[y];
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(a.o) + fa_at(b, i, h, Tq, H, D));
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = 8 * n + 2 * tq4;
      if (d < D)
        o[d / 2] = dead ? __floats2bfloat162_rn(0.f, 0.f)
                        : __floats2bfloat162_rn(acc[n][2 * y] / safe, acc[n][2 * y + 1] / safe);
    }
    if (tq4 == 0) {
      a.m[(size_t)bh * Tq + i] = mr[y];
      a.l[(size_t)bh * Tq + i] = dead ? 1.f : safe;
    }
  }
}

// dK/dV: block ((b, h) group, 16 * wq keys).  Replaces the TPU kernel
// `_dkdv_kernel` (blt_vqg_tpu/ops/pallas/flash_attention.py:110); bound by
// bytes, not operations, at the training shapes (74.9 us over a latent
// step's 24 calls on an NVIDIA H100 80GB HBM3 at 700 W), so the design
// spends its effort on filling the card with short tiles and overlapping
// the loads.  Warp w owns keys
// kb0 + 16 (w % wq) .. + 15 of its group's (b, h): K and V stay in shared
// memory, dk and dv in registers (accumulators of 16 keys x D), and the
// block walks the query tiles (q, dO, m, l, delta) through the stages.  It
// computes S^T = k q^T and dP^T = v dO^T, so p^T and ds^T come out of the
// accumulators as the A operands of dV += p^T dO and dK += ds^T q (dO and
// q read by ldmatrix.trans).
__global__ void __launch_bounds__(FM_THREADS, FM_BLOCKS_PER_SM)
    flash_bwd_dkdv_mma_kernel(const __grid_constant__ FlashArgs a,
                              const __grid_constant__ FlashGeom g) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int D = a.dim, H = a.heads, Tq = a.tq, Tk = a.tk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq4 = lane % 4;
  const int grp = warp / g.wq;
  const int gtid = threadIdx.x - grp * 32 * g.wq, gthreads = 32 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;  // the last block's groups may be idle
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int own = 16 * g.wq;
  const int kb0 = blockIdx.y * own;            // the block's first key
  const int kw = 16 * (warp % g.wq);           // the warp's keys in the owned tile
  const bool live = active && kb0 + kw < Tk;   // the warp has a key to own
  const int nd = g.dp / 8, ntq = (Tq + g.kt - 1) / g.kt;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  unsigned char* gsm = fm_smem + (size_t)grp * (g.fixed + g.nst * g.stage);
  T* ks = reinterpret_cast<T*>(gsm);
  T* vs = ks + own * g.lds;
  unsigned char* stg = gsm + g.fixed;
  const int mi = lane / 8, lr8 = lane % 8;
  const T zero = __float2bfloat16_rn(0.f);

  // the owned K and V, zeros past Tk and the dim
  if (active) {
    for (int c = gtid; c < own * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = kb0 + r;
      const int valid = kj < Tk ? max(0, min(8, D - d0)) : 0;
      const size_t off = kj < Tk ? fa_at(b, kj, h, Tk, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, static_cast<const T*>(a.k) + off, valid, zero);
      rf_load16(vs + r * g.lds + d0, static_cast<const T*>(a.v) + off, valid, zero);
    }
  }
  rf_commit();
  // the warp's keys kb0 + kw + gr + 8y: in the sequence, and masked for
  // every query (past Tk or padded)
  bool kin[2], kmask[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int kj = kb0 + kw + gr + 8 * y;
    kin[y] = active && kj < Tk;
    kmask[y] = !kin[y] || (a.kv_pad && a.kv_pad[(size_t)b * Tk + kj]);
  }

  // causal: query rows i < kb0 see none of the block's keys.  Their p is 0
  // there (a live row: exp(NEG_INF - m) = 0; a dead row: zeroed), and ds is
  // zeroed at masked logits, so the query tiles wholly before kb0 add
  // nothing to dk or dv and are skipped.  (The ring backward, whose dead
  // rows attend uniformly over masked keys, may skip them only up to the
  // first dead row; flash zeroes dead rows, so it needs no such vote.)
  const int qstart = a.causal ? min(ntq, kb0 / g.kt) : 0;

  // query tile t into stage st: q and dO rows, and the rows' m, l, delta
  auto load = [&](int t, int st) {
    if (!active) return;
    const int q0 = t * g.kt;
    T* qs = reinterpret_cast<T*>(stg + (size_t)st * g.stage);
    T* os = qs + g.kt * g.lds;
    float* rm = reinterpret_cast<float*>(os + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, i = q0 + r;
      const int valid = i < Tq ? max(0, min(8, D - d0)) : 0;
      const size_t off = i < Tq ? fa_at(b, i, h, Tq, H, D) + d0 : 0;
      rf_load16(qs + r * g.lds + d0, q + off, valid, zero);
      rf_load16(os + r * g.lds + d0, dout + off, valid, zero);
    }
    const size_t rows = (size_t)bh * Tq;
    for (int r = gtid; r < g.kt; r += gthreads) {
      const int i = q0 + r;
      if (i < Tq) {
        rb_load4(rm + r, a.m + rows + i);
        rb_load4(rm + g.kt + r, a.l + rows + i);
        rb_load4(rm + 2 * g.kt + r, a.delta + rows + i);
      } else {
        rm[r] = FA_NEG_INF;
        rm[g.kt + r] = 1.f;
        rm[2 * g.kt + r] = 0.f;
      }
    }
  };

  float dk[MMA_DT][4], dv[MMA_DT][4];
#pragma unroll
  for (int n = 0; n < MMA_DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;

  if (qstart < ntq) load(qstart, 0);
  rf_commit();
  for (int t = qstart, st = 0; t < ntq; ++t, st ^= 1) {
    if (t + 1 < ntq) load(t + 1, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t (and K, V) landed
    __syncthreads();

    if (live) {
      const int q0 = t * g.kt;
      const T* qs = reinterpret_cast<const T*>(stg + (size_t)st * g.stage);
      const T* os = qs + g.kt * g.lds;
      const float* rm = reinterpret_cast<const float*>(os + g.kt * g.lds);
      const float* rl = rm + g.kt;
      const float* rd = rl + g.kt;
#pragma unroll 1
      for (int qc = 0; qc < g.kt / 16 && q0 + 16 * qc < Tq; ++qc) {
        // causal: 16 queries wholly before the warp's keys add nothing
        if (a.causal && q0 + 16 * qc + 15 < kb0 + kw) continue;
        // S^T and dP^T: the warp's 16 keys x 16 queries
        float s[2][4] = {}, dpv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < FA_DMAX / 16; ++kk) {
          if (kk < g.dp / 16) {
            uint32_t af[4];
            rf_ldsm(af, ks + (kw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
            rb_scores(s, af, qs + 16 * qc * g.lds + 16 * kk, g.lds, lane);
            rf_ldsm(af, vs + (kw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
            rb_scores(dpv, af, os + 16 * qc * g.lds + 16 * kk, g.lds, lane);
          }
        }
        // p^T and ds^T: key kb0 + kw + gr + 8 (c >> 1), query column ii
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int y = c >> 1, kj = kb0 + kw + gr + 8 * y;
            const int ii = 16 * qc + 8 * jn + 2 * tq4 + (c & 1);
            const float m = rm[ii];
            float p = 0.f, ds = 0.f;
            if (!kmask[y] && !(a.causal && kj > q0 + ii) && m > 0.5f * FA_NEG_INF) {
              p = expf(s[jn][c] - m) * (1.f / rl[ii]);
              ds = p * (dpv[jn][c] - rd[ii]);
            }
            s[jn][c] = p;
            dpv[jn][c] = ds;
          }
        }
        uint32_t hi[4], lo[4];
        rb_split(s, hi, lo);
        rb_mma_pair(dv, hi, lo, os + 16 * qc * g.lds, g.lds, g.dp, lane);
        rb_split(dpv, hi, lo);
        rb_mma_pair(dk, hi, lo, qs + 16 * qc * g.lds, g.lds, g.dp, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // dk and dv in bf16: lane (gr, tq4) holds columns 8n + 2 tq4 and + 1
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    if (!kin[y]) continue;
    const size_t off = fa_at(b, kb0 + kw + gr + 8 * y, h, Tk, H, D);
    __nv_bfloat162* dkp = reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(a.dk) + off);
    __nv_bfloat162* dvp = reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(a.dv) + off);
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = 8 * n + 2 * tq4;
      if (d < D) {
        dkp[d / 2] = __floats2bfloat162_rn(dk[n][2 * y], dk[n][2 * y + 1]);
        dvp[d / 2] = __floats2bfloat162_rn(dv[n][2 * y], dv[n][2 * y + 1]);
      }
    }
  }
}

// dQ: block ((b, h) group, 16 * wq query rows).  Replaces the TPU kernel
// `_dq_kernel` (blt_vqg_tpu/ops/pallas/flash_attention.py:169); bound by
// bytes at the training shapes (67.8 us over a latent step's 24 calls on
// an NVIDIA H100 80GB HBM3 at 700 W), so, as dK/dV, it fills the card with
// short tiles.  Warp w owns query rows r0 .. r0 + 15 of its group's (b, h):
// q and dO as A fragments and dq (16 rows x D) in registers; the block
// walks the key tiles (K, V and the keys' pad bytes) through the stages and
// computes S = q k^T, dP = dO v^T and dQ += ds k.
__global__ void __launch_bounds__(FM_THREADS, FM_BLOCKS_PER_SM)
    flash_bwd_dq_mma_kernel(const __grid_constant__ FlashArgs a,
                            const __grid_constant__ FlashGeom g) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char fm_smem[];
  const int D = a.dim, H = a.heads, Tq = a.tq, Tk = a.tk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq4 = lane % 4;
  const int grp = warp / g.wq;
  const int gtid = threadIdx.x - grp * 32 * g.wq, gthreads = 32 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int own = 16 * g.wq;
  const int qb = blockIdx.y * own;                 // the block's first query row
  const int r0 = qb + 16 * (warp % g.wq);          // the warp's
  const bool live = active && r0 < Tq;             // the warp has a row to own
  const int qlast = min(Tq, qb + own) - 1;         // the block's last row
  const int ntk = (Tk + g.kt - 1) / g.kt;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  unsigned char* gsm = fm_smem + (size_t)grp * g.nst * g.stage;

  // q and dO rows r0 + gr and + 8 as A fragments, zero past Tq and the dim
  uint32_t qf[FA_DMAX / 16][4], of[FA_DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < FA_DMAX / 16; ++kk) {
    if (kk < g.dp / 16) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = r0 + gr + 8 * (y & 1), d = 16 * kk + 8 * (y >> 1) + 2 * tq4;
        uint32_t qv = 0u, ov = 0u;
        if (active && i < Tq && d < D) {  // D is a multiple of 8: d + 1 < D too
          const size_t off = fa_at(b, i, h, Tq, H, D) + d;
          qv = *reinterpret_cast<const uint32_t*>(q + off);
          ov = *reinterpret_cast<const uint32_t*>(dout + off);
        }
        qf[kk][y] = qv;
        of[kk][y] = ov;
      }
    }
  }
  // the rows' m, 1 / l and delta; a row past Tq is a dead row
  float mrow[2], lrow[2], drow[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    mrow[y] = FA_NEG_INF;
    lrow[y] = 1.f;
    drow[y] = 0.f;
    if (active && i < Tq) {
      const size_t ri = (size_t)bh * Tq + i;
      mrow[y] = a.m[ri];
      lrow[y] = 1.f / a.l[ri];
      drow[y] = a.delta[ri];
    }
  }

  // causal: key tiles wholly after the block's last row add nothing (ds is
  // zeroed at masked logits) and are not walked
  const int nt = a.causal ? min(ntk, qlast / g.kt + 1) : ntk;

  // key tile t into stage st: K, V and the keys' pad bytes
  auto load = [&](int t, int st) {
    if (active)
      flash_stage_kv(a, g, gsm + (size_t)st * g.stage, b, h, t * g.kt, true, gtid, gthreads);
  };

  float dq[MMA_DT][4];
#pragma unroll
  for (int n = 0; n < MMA_DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  load(0, 0);
  rf_commit();
  for (int t = 0, st = 0; t < nt; ++t, st ^= 1) {
    if (t + 1 < nt) load(t + 1, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t has landed
    __syncthreads();

    if (live) {
      const int k0 = t * g.kt;
      const T* ks = reinterpret_cast<const T*>(gsm + (size_t)st * g.stage);
      const T* vs = ks + g.kt * g.lds;
      const unsigned char* ps = reinterpret_cast<const unsigned char*>(vs + g.kt * g.lds);
#pragma unroll 1
      for (int kc = 0; kc < g.kt / 16 && k0 + 16 * kc < Tk; ++kc) {
        // causal: 16 keys wholly after the warp's rows add nothing
        if (a.causal && k0 + 16 * kc > r0 + 15) break;
        // S and dP: the warp's 16 rows x 16 keys
        float s[2][4] = {}, dpv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < FA_DMAX / 16; ++kk) {
          if (kk < g.dp / 16) {
            rb_scores(s, qf[kk], ks + 16 * kc * g.lds + 16 * kk, g.lds, lane);
            rb_scores(dpv, of[kk], vs + 16 * kc * g.lds + 16 * kk, g.lds, lane);
          }
        }
        // ds: row r0 + gr + 8 (c >> 1), key column jj
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int y = c >> 1, i = r0 + gr + 8 * y;
            const int jj = 16 * kc + 8 * jn + 2 * tq4 + (c & 1);
            float ds = 0.f;
            if (!ps[jj] && !(a.causal && k0 + jj > i) && mrow[y] > 0.5f * FA_NEG_INF)
              ds = expf(s[jn][c] - mrow[y]) * lrow[y] * (dpv[jn][c] - drow[y]);
            s[jn][c] = ds;
          }
        }
        uint32_t hi[4], lo[4];
        rb_split(s, hi, lo);
        rb_mma_pair(dq, hi, lo, ks + 16 * kc * g.lds, g.lds, g.dp, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (!active) return;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    if (i >= Tq) continue;
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(a.dq) + fa_at(b, i, h, Tq, H, D));
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = 8 * n + 2 * tq4;
      if (d < D) p[d / 2] = __floats2bfloat162_rn(dq[n][2 * y], dq[n][2 * y + 1]);
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

// the host's tiling of a bf16 kernel is one it can run: whole 16-row
// steps, stages large enough, every (b, h) and owned row covered
static bool flash_geom_ok(const FlashArgs& a, const FlashGeom& g, FlashKernel which) {
  const bool dkdv = which == FA_DKDV;
  const int owned = dkdv ? a.tk : a.tq, walked = dkdv ? a.tq : a.tk;
  const int tile = g.kt * g.lds * 2;
  const int need = dkdv ? 2 * tile + 3 * g.kt * 4 : 2 * tile + g.kt;
  return (g.wq == 1 || g.wq == 2 || g.wq == 4) && g.groups * g.wq == FM_WARPS &&
         g.kt >= 16 && g.kt <= 64 && g.kt % 16 == 0 && g.dp >= a.dim && g.dp <= FA_DMAX &&
         g.dp % 16 == 0 && g.lds == g.dp + 8 && g.stage % 16 == 0 && g.stage >= need &&
         g.fixed == (dkdv            ? 2 * 16 * g.wq * g.lds * 2
                     : which == FA_FWD ? 16 * g.wq * (g.dp + 4) * 4
                                       : 0) &&
         (g.nst == 2 || (g.nst == 1 && walked <= g.kt)) &&
         g.smem == g.groups * (g.fixed + g.nst * g.stage) && g.smem <= FM_SMEM_MAX &&
         (long)g.grid_x * g.groups >= (long)a.batch * a.heads && g.grid_y * 16 * g.wq >= owned;
}

static cudaError_t flash_mma_launch(const FlashArgs& a, const FlashGeom& g, FlashKernel which,
                                    cudaStream_t s) {
  if (!flash_geom_ok(a, g, which)) return cudaErrorInvalidValue;
  const dim3 grid(g.grid_x, g.grid_y);
  const cudaFuncAttribute smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (which == FA_FWD) {
    BVQ_TRY(cudaFuncSetAttribute(flash_fwd_mma_kernel, smem, g.smem));
    flash_fwd_mma_kernel<<<grid, FM_THREADS, g.smem, s>>>(a, g);
  } else if (which == FA_DKDV) {
    BVQ_TRY(cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel, smem, g.smem));
    flash_bwd_dkdv_mma_kernel<<<grid, FM_THREADS, g.smem, s>>>(a, g);
  } else {
    BVQ_TRY(cudaFuncSetAttribute(flash_bwd_dq_mma_kernel, smem, g.smem));
    flash_bwd_dq_mma_kernel<<<grid, FM_THREADS, g.smem, s>>>(a, g);
  }
  return cudaGetLastError();
}

// bf16 on the tensor cores; f32 on the FMA tiles
static cudaError_t flash_launch(const FlashCall& c, FlashKernel which, cudaStream_t s) {
  const FlashArgs& a = c.a;
  if (a.dim % 8 != 0 || a.dim <= 0 || a.dim > FA_DMAX || a.tq <= 0 || a.tk <= 0)
    return cudaErrorInvalidValue;
  if (a.act_bf16) return flash_mma_launch(a, c.geom, which, s);
  void (*kernel)(FlashArgs) = which == FA_DKDV ? flash_bwd_dkdv_kernel<float>
                              : which == FA_DQ ? flash_bwd_dq_kernel<float>
                                               : flash_fwd_kernel<float>;
  const int smem = (int)flash_smem(which, a.dim);
  BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const int tiles = which == FA_DKDV ? cdiv(a.tk, FA_BK) : cdiv(a.tq, FA_BQ);
  kernel<<<dim3(a.batch * a.heads, tiles), FA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

static int flash_entry(const FlashCall* c, FlashKernel which, void* stream) {
  return static_cast<int>(flash_launch(*c, which, static_cast<cudaStream_t>(stream)));
}

}  // namespace bvq

extern "C" int bvq_flash_fwd(const bvq::FlashCall* c, void* stream) {
  return bvq::flash_entry(c, bvq::FA_FWD, stream);
}

extern "C" int bvq_flash_bwd_dkdv(const bvq::FlashCall* c, void* stream) {
  return bvq::flash_entry(c, bvq::FA_DKDV, stream);
}

extern "C" int bvq_flash_bwd_dq(const bvq::FlashCall* c, void* stream) {
  return bvq::flash_entry(c, bvq::FA_DQ, stream);
}
