// Block arithmetic of ring attention: the online-softmax forward and the
// FlashAttention-2 backward of one rank against the K/V blocks that visit it
// at one ring step.
//
// Replaces the block arithmetic of the four TPU ring kernels of
// blt_vqg_tpu/ops/pallas/ring_attention.py: `_ring_fwd_kernel` (under
// `ring_attention_fwd_shard` :186), `_ring_fwd_bidir_kernel`
// (`ring_attention_fwd_bidir_shard` :373), `_ring_bwd_kernel`
// (`ring_attention_bwd_shard` :573) and `_ring_bwd_bidir_kernel`
// (`ring_attention_bwd_bidir_shard` :815).  Each TPU kernel runs the whole
// ring in one call, with its remote copies and semaphores inside.  Here the
// schedule and the hops live in ops/kernels/ring_attention.py and
// parallel/mesh.py (`LocalRing`: copies into double-buffered slots on a
// side stream, ordered by CUDA events), and each rank's work at one step is
// one launch of these kernels on the compute stream:
//  - ring_fwd_kernel: the carry (acc [B, C, H, D], m and l [B, C, H], all
//    f32) updated from one or two visiting blocks, in schedule order (the
//    clockwise block, then the counter-clockwise one);
//  - ring_finalize_kernel: o = acc / safe-l in the activation type, l made
//    safe (1 where it is 0), once per rank after the last step;
//  - ring_bwd_dkdv_kernel: each visiting block's contribution added to its
//    f32 dK/dV rider (the rider travels with its block and lands home);
//  - ring_bwd_dq_kernel: the contributions of all visiting blocks added to
//    the rank's f32 dq;
//  - ring_land_kernel: dq, and dk/dv from the landed riders (the two-way
//    ring sums clockwise + counter-clockwise, in that order), in the
//    activation type, once per rank at the end.
//
// What the TPU kernels compute, and this file copies:
//  - masked logits take NEG_INF = -1e30 and the running max starts there,
//    so a query row whose every visible key is masked attends UNIFORMLY over
//    the keys of the blocks it computed (causally masked keys of a live
//    block included): p = exp(-1e30 - (-1e30)) = 1.  Unlike the flash
//    kernels, such a row is not zeroed, and no key tile inside a live block
//    is skipped;
//  - the residuals are (m, safe-l), not lse; the backward takes
//    p = exp(s - m) / l and zeroes ds at masked logits;
//  - p is rounded to the activation type before the PV product; the
//    backward runs every product in f32 (dO, q, k, v as f32 values); the
//    riders and dq accumulate in f32 and are rounded once, when they land.
//
// Layouts: a rank's local operands (q, dO, o, the acc and dq carries, dq/dk/
// dv) are [B, C, H, D] rows of the [B, T, H, D] sequence, batch stride `sb`
// elements; its rows (m, l, delta) are [B, C, H] of [B, T, H], batch stride
// sb / D.  A visiting block (slot of the ring) is [B, C, H, D] contiguous,
// its key-pad mask [B, C] bytes (nonzero = masked), a rider [2, B, C, H, D]
// f32 (dk, dv).
//
// Blocks run in no order on this card, so each block loops over the tiles
// the TPU kernel holds whole in VMEM: 64 query rows x 64 keys, f32 rows
// padded by one word in shared memory, plain f32 FMA products.  Bound on
// this card: the bytes of q, k, v, o, m, l, dO, dq, dk and dv once each at
// 3.35 TB/s, or the operations of the live blocks at 989 TF/s (bf16);
// chip_smoke.py computes both per call.  The hop bytes (slots and riders)
// are counted apart by the ring (`LocalRing.hop_bytes`) and are not part of
// the bound.  Left for later work: tensor-core products (wgmma), the carry
// kept in registers across ring steps (one launch per rank for the whole
// ring), all ranks of a step in one launch, and a hop fused into the block
// kernel.
#include "common.cuh"

namespace bvq {

constexpr float RA_NEG_INF = -1e30f;
constexpr int RA_T = 64, RA_THREADS = 256, RA_DMAX = 128;
constexpr int RA_DC = RA_DMAX / 4;   // d columns a thread owns: d = lane4 + 4c
constexpr int RA_JC = RA_T / 4;      // key columns a thread scores: j = lane4 + 4c
constexpr int RA_PLD = RA_T + 1;     // row stride of the [64][64] score tiles

struct RingArgs {
  int act_bf16, causal, first, nblk;
  int batch, heads, chunk, dim;
  int q_off;                        // the rank's first query position
  int k_off[2];                     // each visiting block's first key position
  long sb;                          // batch stride of the local operands
  const void* q;                    // local [B, C, H, D]
  const void* dout;                 // local [B, C, H, D]
  const void* k[2];                 // visiting blocks [B, C, H, D]
  const void* v[2];
  const unsigned char* pad[2];      // [B, C]
  float* acc;                       // local f32 carry
  float* m;                         // local rows: running max / residual
  float* l;                         // local rows: running denominator / safe l
  const float* delta;               // local rows: rowsum(dO * O)
  float* dq;                        // local f32 carry
  float* rider[2];                  // [2, B, C, H, D] f32 per visiting block
  void* o;                          // local outputs, activation type
  void* dq_out;
  void* dk;
  void* dv;
  const float* ret[2];              // landed riders [2, B, C, H, D] (ret[1] may be null)
};

// offset of element (b, t, h, 0) of a [B, rows, H, D] operand
__device__ __forceinline__ size_t ra_at(long sb, int b, int t, int h, int H, int D) {
  return (size_t)b * sb + ((size_t)t * H + h) * D;
}

// the rows a tile holds: 64, or the whole chunk when it is shorter (the
// shared memory of a block is sized by it, so short chunks fill the card)
__host__ __device__ __forceinline__ int ra_tile_rows(int chunk) {
  return chunk < RA_T ? chunk : RA_T;
}

// rows [r0, r0 + 64) of x at (b, h), as far as the chunk goes, into dst
// [rows][D + 1] as f32.  Rows past the chunk are never read: every loop
// over a tile stops at the chunk's edge.
template <typename T>
__device__ void ra_load_tile(float* dst, const T* src, long sb, int b, int h, int r0,
                             const RingArgs& a) {
  const int D = a.dim, n = min(RA_T, a.chunk - r0) * D;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = to_f<T>(src[ra_at(sb, b, r0 + r, h, a.heads, D) + d]);
  }
}

__device__ __forceinline__ float ra_dot(const float* x, const float* y, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(x[d], y[d], s);
  return s;
}

// one visiting block's operands (the argument arrays indexed by constants)
struct RingBlock {
  const void* k;
  const void* v;
  const unsigned char* pad;
  float* rider;
  int k_off;
};

__device__ __forceinline__ RingBlock ra_block(const RingArgs& a, int blk) {
  return blk == 0 ? RingBlock{a.k[0], a.v[0], a.pad[0], a.rider[0], a.k_off[0]}
                  : RingBlock{a.k[1], a.v[1], a.pad[1], a.rider[1], a.k_off[1]};
}

// key kj (< C) of visiting block kb is masked for local query i
__device__ __forceinline__ bool ra_masked(const RingArgs& a, const RingBlock& kb, int b,
                                          int i, int kj) {
  return kb.pad[(size_t)b * a.chunk + kj] || (a.causal && kb.k_off + kj > a.q_off + i);
}

// the 4 lanes of a query row reduce together (lanes 4r .. 4r + 3)
__device__ __forceinline__ float ra_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float ra_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Forward: block (b*h, query tile); thread (row = tid / 4, lane4 = tid % 4)
// scores key columns lane4 + 4c and owns carry columns lane4 + 4c of its row.
template <typename T>
__global__ void __launch_bounds__(RA_THREADS) ring_fwd_kernel(RingArgs a) {
  extern __shared__ float ra_smem[];
  const int D = a.dim, LD = D + 1, C = a.chunk, H = a.heads, TR = ra_tile_rows(C);
  float* qs = ra_smem;          // [TR][LD]
  float* ks = qs + TR * LD;     // [TR][LD]
  float* vs = ks + TR * LD;     // [TR][LD]
  float* ps = vs + TR * LD;     // [TR][PLD] p rounded to T
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * RA_T;
  const int tid = threadIdx.x, row = tid / 4, lane4 = tid % 4, i = q0 + row;
  const long sbk = (long)C * H * D;
  const size_t ri = (size_t)b * (a.sb / D) + (size_t)i * H + h;
  const size_t oi = ra_at(a.sb, b, i, h, H, D);

  ra_load_tile<T>(qs, static_cast<const T*>(a.q), a.sb, b, h, q0, a);
  float m = RA_NEG_INF, l = 0.f, acc[RA_DC];
#pragma unroll
  for (int c = 0; c < RA_DC; ++c) acc[c] = 0.f;
  if (!a.first && i < C) {
    m = a.m[ri];
    l = a.l[ri];
#pragma unroll
    for (int c = 0; c < RA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) acc[c] = a.acc[oi + d];
    }
  }

  for (int blk = 0; blk < a.nblk; ++blk) {
    const RingBlock kb = ra_block(a, blk);
    for (int k0 = 0; k0 < C; k0 += RA_T) {
      __syncthreads();  // the previous tile's reads are done
      ra_load_tile<T>(ks, static_cast<const T*>(kb.k), sbk, b, h, k0, a);
      ra_load_tile<T>(vs, static_cast<const T*>(kb.v), sbk, b, h, k0, a);
      __syncthreads();
      float s[RA_JC];
      float mcur = -INFINITY;
#pragma unroll
      for (int c = 0; c < RA_JC; ++c) {
        const int j = lane4 + 4 * c, kj = k0 + j;
        const bool valid = kj < C;
        // rows past the chunk take part in the row reductions only
        s[c] = !valid || i >= C || ra_masked(a, kb, b, i, kj)
                   ? RA_NEG_INF
                   : ra_dot(qs + row * LD, ks + j * LD, D);
        if (valid) mcur = fmaxf(mcur, s[c]);
      }
      const float m_new = fmaxf(m, ra_quad_max(mcur));
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < RA_JC; ++c) {
        const int j = lane4 + 4 * c;
        const float p = k0 + j < C ? expf(s[c] - m_new) : 0.f;
        psum += p;
        if (row < TR) ps[row * RA_PLD + j] = round_to<T>(p);
      }
      l = l * alpha + ra_quad_sum(psum);
      m = m_new;
      __syncwarp();  // the row's p was written by the 4 lanes that read it
      // keys past the chunk have p = 0: the sum stops at the chunk's edge
      const int jn = min(RA_T, C - k0);
#pragma unroll
      for (int c = 0; c < RA_DC; ++c) {
        const int d = lane4 + 4 * c;
        if (d < D && i < C) {
          float pv = 0.f;
          for (int j = 0; j < jn; ++j) pv = fmaf(ps[row * RA_PLD + j], vs[j * LD + d], pv);
          acc[c] = acc[c] * alpha + pv;
        }
      }
    }
  }

  if (i < C) {
    if (lane4 == 0) {
      a.m[ri] = m;
      a.l[ri] = l;
    }
#pragma unroll
    for (int c = 0; c < RA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) a.acc[oi + d] = acc[c];
    }
  }
}

// o = acc / safe-l in T and l := safe-l, one warp per local row (b, t, h)
template <typename T>
__global__ void ring_finalize_kernel(RingArgs a) {
  const int D = a.dim, C = a.chunk, H = a.heads;
  const long w = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long)a.batch * C * H) return;
  const int h = w % H, t = (w / H) % C, b = w / ((long)H * C);
  const size_t ri = (size_t)b * (a.sb / D) + (size_t)t * H + h;
  const size_t oi = ra_at(a.sb, b, t, h, H, D);
  const float l = a.l[ri];
  const float safe = l == 0.f ? 1.f : l;
  T* o = static_cast<T*>(a.o);
  for (int d = lane; d < D; d += 32) o[oi + d] = from_f<T>(a.acc[oi + d] / safe);
  __syncwarp();
  if (lane == 0) a.l[ri] = safe;
}

// ---------------------------------------------------------------------------
// Backward, shared by both kernels: for query row `row` of the tile at q0
// and key columns lane4 + 4c of the tile at k0 of visiting block blk, the
// probabilities p = exp(s - m) / l and ds = p * (dp - delta) (zeroed at
// masked logits), into ps / dss rows.
struct RingRows {
  float* m;      // [T] the saved running max
  float* linv;   // [T] 1 / l
  float* delta;  // [T]
};

__device__ void ra_load_rows(const RingArgs& a, const RingRows& r, int b, int h, int q0) {
  const long sr = a.sb / a.dim;
  for (int t = threadIdx.x; t < RA_T; t += blockDim.x) {
    const int i = q0 + t;
    const bool in = i < a.chunk;
    const size_t ri = (size_t)b * sr + (size_t)i * a.heads + h;
    r.m[t] = in ? a.m[ri] : 0.f;
    r.linv[t] = in ? 1.f / a.l[ri] : 0.f;
    r.delta[t] = in ? a.delta[ri] : 0.f;
  }
}

__device__ void ra_scores_bwd(const RingArgs& a, const RingBlock& kb, const RingRows& r,
                              const float* qs, const float* dos, const float* ks,
                              const float* vs, float* ps, float* dss, int b, int q0,
                              int k0) {
  const int D = a.dim, LD = D + 1;
  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4, i = q0 + row;
  const float m = r.m[row], linv = r.linv[row], delta = r.delta[row];
#pragma unroll 4
  for (int c = 0; c < RA_JC; ++c) {
    const int j = lane4 + 4 * c, kj = k0 + j;
    float p = 0.f, ds = 0.f;
    if (i < a.chunk && kj < a.chunk) {
      const bool masked = ra_masked(a, kb, b, i, kj);
      const float s = masked ? RA_NEG_INF : ra_dot(qs + row * LD, ks + j * LD, D);
      p = expf(s - m) * linv;
      ds = masked ? 0.f : p * (ra_dot(dos + row * LD, vs + j * LD, D) - delta);
    }
    if (row < ra_tile_rows(a.chunk)) {
      if (ps) ps[row * RA_PLD + j] = p;
      dss[row * RA_PLD + j] = ds;
    }
  }
}

// dK/dV: block (b*h, key tile, visiting block); thread (key row jr = tid / 4,
// lane4) owns columns lane4 + 4c of dk and dv for its key, and adds them to
// the block's rider.
template <typename T>
__global__ void __launch_bounds__(RA_THREADS) ring_bwd_dkdv_kernel(RingArgs a) {
  extern __shared__ float ra_smem[];
  const int D = a.dim, LD = D + 1, C = a.chunk, H = a.heads, TR = ra_tile_rows(C);
  float* ks = ra_smem;           // [TR][LD]
  float* vs = ks + TR * LD;
  float* qs = vs + TR * LD;
  float* dos = qs + TR * LD;
  float* ps = dos + TR * LD;     // [TR][PLD]
  float* dss = ps + TR * RA_PLD;
  const RingRows rows{dss + TR * RA_PLD, dss + TR * RA_PLD + RA_T,
                      dss + TR * RA_PLD + 2 * RA_T};
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * RA_T;
  const int tid = threadIdx.x, jr = tid / 4, lane4 = tid % 4;
  const long sbk = (long)C * H * D;
  const RingBlock kb = ra_block(a, blockIdx.z);

  ra_load_tile<T>(ks, static_cast<const T*>(kb.k), sbk, b, h, k0, a);
  ra_load_tile<T>(vs, static_cast<const T*>(kb.v), sbk, b, h, k0, a);
  float dk[RA_DC], dv[RA_DC];
#pragma unroll
  for (int c = 0; c < RA_DC; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < C; q0 += RA_T) {
    __syncthreads();
    ra_load_tile<T>(qs, static_cast<const T*>(a.q), a.sb, b, h, q0, a);
    ra_load_tile<T>(dos, static_cast<const T*>(a.dout), a.sb, b, h, q0, a);
    ra_load_rows(a, rows, b, h, q0);
    __syncthreads();
    ra_scores_bwd(a, kb, rows, qs, dos, ks, vs, ps, dss, b, q0, k0);
    __syncthreads();
    // query rows past the chunk have p = ds = 0
    const int rn = min(RA_T, C - q0);
#pragma unroll
    for (int c = 0; c < RA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D && k0 + jr < C) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < rn; ++r) {
          sv = fmaf(ps[r * RA_PLD + jr], dos[r * LD + d], sv);
          sk = fmaf(dss[r * RA_PLD + jr], qs[r * LD + d], sk);
        }
        dv[c] += sv;
        dk[c] += sk;
      }
    }
  }

  const int kj = k0 + jr;
  if (kj < C) {
    float* rk = kb.rider + ra_at(sbk, b, kj, h, H, D);
    float* rv = rk + (size_t)a.batch * sbk;
#pragma unroll
    for (int c = 0; c < RA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) {
        rk[d] += dk[c];
        rv[d] += dv[c];
      }
    }
  }
}

// dQ: block (b*h, query tile); thread (row, lane4) owns columns lane4 + 4c of
// its row's dq, summed over every visiting block, in order, then added to
// the carry (or written, at the first step).
template <typename T>
__global__ void __launch_bounds__(RA_THREADS) ring_bwd_dq_kernel(RingArgs a) {
  extern __shared__ float ra_smem[];
  const int D = a.dim, LD = D + 1, C = a.chunk, H = a.heads, TR = ra_tile_rows(C);
  float* qs = ra_smem;           // [TR][LD]
  float* dos = qs + TR * LD;
  float* ks = dos + TR * LD;
  float* vs = ks + TR * LD;
  float* dss = vs + TR * LD;     // [TR][PLD]
  const RingRows rows{dss + TR * RA_PLD, dss + TR * RA_PLD + RA_T,
                      dss + TR * RA_PLD + 2 * RA_T};
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * RA_T;
  const int tid = threadIdx.x, row = tid / 4, lane4 = tid % 4, i = q0 + row;
  const long sbk = (long)C * H * D;

  ra_load_tile<T>(qs, static_cast<const T*>(a.q), a.sb, b, h, q0, a);
  ra_load_tile<T>(dos, static_cast<const T*>(a.dout), a.sb, b, h, q0, a);
  ra_load_rows(a, rows, b, h, q0);
  float dq[RA_DC];
#pragma unroll
  for (int c = 0; c < RA_DC; ++c) dq[c] = 0.f;

  for (int blk = 0; blk < a.nblk; ++blk) {
    const RingBlock kb = ra_block(a, blk);
    for (int k0 = 0; k0 < C; k0 += RA_T) {
      __syncthreads();
      ra_load_tile<T>(ks, static_cast<const T*>(kb.k), sbk, b, h, k0, a);
      ra_load_tile<T>(vs, static_cast<const T*>(kb.v), sbk, b, h, k0, a);
      __syncthreads();
      ra_scores_bwd(a, kb, rows, qs, dos, ks, vs, nullptr, dss, b, q0, k0);
      __syncwarp();  // the row's ds was written by the 4 lanes that read it
      const int jn = min(RA_T, C - k0);   // ds = 0 past the chunk's edge
#pragma unroll
      for (int c = 0; c < RA_DC; ++c) {
        const int d = lane4 + 4 * c;
        if (d < D && i < C) {
          float s = 0.f;
          for (int j = 0; j < jn; ++j) s = fmaf(dss[row * RA_PLD + j], ks[j * LD + d], s);
          dq[c] += s;
        }
      }
    }
  }

  if (i < C) {
    float* dqp = a.dq + ra_at(a.sb, b, i, h, H, D);
#pragma unroll
    for (int c = 0; c < RA_DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) dqp[d] = a.first ? dq[c] : dqp[d] + dq[c];
    }
  }
}

// dq, dk, dv in T from the f32 dq carry and the landed riders, one thread
// per element of the rank's [B, C, H, D]
template <typename T>
__global__ void ring_land_kernel(RingArgs a) {
  const long per_b = (long)a.chunk * a.heads * a.dim;
  const long n = (long)a.batch * per_b;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const size_t li = (size_t)(e / per_b) * a.sb + e % per_b;
  static_cast<T*>(a.dq_out)[li] = from_f<T>(a.dq[li]);
  const float* r0 = a.ret[0];
  const float* r1 = a.ret[1];
  const float dk = r1 ? r0[e] + r1[e] : r0[e];
  const float dv = r1 ? r0[n + e] + r1[n + e] : r0[n + e];
  static_cast<T*>(a.dk)[li] = from_f<T>(dk);
  static_cast<T*>(a.dv)[li] = from_f<T>(dv);
}

// ---------------------------------------------------------------------------
enum RingKernel { RA_FWD, RA_FINALIZE, RA_DKDV, RA_DQ, RA_LAND };

static size_t ring_smem(RingKernel which, int D, int chunk) {
  const size_t tr = ra_tile_rows(chunk);
  const size_t tile = tr * (D + 1);
  const size_t scores = tr * RA_PLD;
  switch (which) {
    case RA_FWD: return (3 * tile + scores) * sizeof(float);
    case RA_DKDV: return (4 * tile + 2 * scores + 3 * RA_T) * sizeof(float);
    case RA_DQ: return (4 * tile + scores + 3 * RA_T) * sizeof(float);
    default: return 0;
  }
}

template <typename T>
static cudaError_t ring_launch(const RingArgs& a, RingKernel which, cudaStream_t s) {
  if (a.dim <= 0 || a.dim > RA_DMAX || a.chunk <= 0 || a.batch <= 0 || a.heads <= 0 ||
      a.nblk < 0 || a.nblk > 2 || a.sb < (long)a.chunk * a.heads * a.dim)
    return cudaErrorInvalidValue;
  const int bh = a.batch * a.heads;
  if (which == RA_FINALIZE) {
    const long rows = (long)bh * a.chunk;
    ring_finalize_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (which == RA_LAND) {
    const long n = (long)bh * a.chunk * a.dim;
    ring_land_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (a.nblk < 1) return cudaErrorInvalidValue;
  void (*kernel)(RingArgs) = which == RA_FWD    ? ring_fwd_kernel<T>
                             : which == RA_DKDV ? ring_bwd_dkdv_kernel<T>
                                                : ring_bwd_dq_kernel<T>;
  const int smem = (int)ring_smem(which, a.dim, a.chunk);
  BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid(bh, cdiv(a.chunk, RA_T), which == RA_DKDV ? a.nblk : 1);
  kernel<<<grid, RA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

static int ring_entry(const RingArgs* a, RingKernel which, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->act_bf16 ? ring_launch<__nv_bfloat16>(*a, which, s)
                                    : ring_launch<float>(*a, which, s);
  return static_cast<int>(e);
}

}  // namespace bvq

extern "C" int bvq_ring_fwd(const bvq::RingArgs* a, void* stream) {
  return bvq::ring_entry(a, bvq::RA_FWD, stream);
}

extern "C" int bvq_ring_finalize(const bvq::RingArgs* a, void* stream) {
  return bvq::ring_entry(a, bvq::RA_FINALIZE, stream);
}

extern "C" int bvq_ring_bwd_dkdv(const bvq::RingArgs* a, void* stream) {
  return bvq::ring_entry(a, bvq::RA_DKDV, stream);
}

extern "C" int bvq_ring_bwd_dq(const bvq::RingArgs* a, void* stream) {
  return bvq::ring_entry(a, bvq::RA_DQ, stream);
}

extern "C" int bvq_ring_land(const bvq::RingArgs* a, void* stream) {
  return bvq::ring_entry(a, bvq::RA_LAND, stream);
}
