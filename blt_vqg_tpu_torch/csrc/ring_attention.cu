// Block arithmetic of ring attention: the online-softmax forward and the
// FlashAttention-2 backward of the ranks of a ring against the K/V blocks
// that visit them at one ring step.
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
// side stream, ordered by CUDA events), and the work of one ring step is
// launched on the compute stream.  Both directions launch on one plan
// (`ring_plan`): per ring step, one launch (per kernel) covers every rank
// that has a live block there, read from the step's table (`RingStep`); a
// rank's rows sit at rank stride C*H*D, its visiting blocks at rank stride
// B*C*H*D of the step's slots.
//  - forward (both schedules): ONE launch per ring step (grid dimension z:
//    the step's ranks).  A rank carries (acc [B, C, H, D], m and l
//    [B, C, H], all f32) from step to step in device memory; at its last
//    live step the same launch finalizes it (o = acc / safe-l in the
//    activation type, l := safe-l), so there is no finalize launch.  At
//    seq 4, causal, that is 3 launches per two-way call and 4 per one-way
//    call.
//    bf16: ring_fwd_mma_kernel, tensor cores (mma.sync m16n8k16, bf16 x bf16
//    -> f32, as the TPU's MXU).  A warp owns 16 query rows: q in registers,
//    K/V tiles of up to 64 keys in bf16 in shared memory, loaded by 16-byte
//    cp.async into two stages so the next tile's load overlaps this tile's
//    products; the online softmax in registers; p rounded to bf16 in
//    registers is the A operand of PV.  A block has 4 warps, and the
//    registers are capped so that 3 blocks share an SM (12 warps; uncapped,
//    the kernel takes 207 registers and 2 blocks).  Chunks of 33 rows or
//    more: the 4 warps share the K/V tiles of one (b, h) and 64 query rows.
//    Shorter chunks (the decoder's C 5, the encoders' C 7 and C 1): a block
//    holds 2 or 4 (b, h), 1 or 2 warps each, and key tiles of the chunk
//    rounded up to 16, so the step's ranks x B x H warps fill the card.
//    The head dim is zero-padded to 16 in shared memory and registers (any
//    dim 1-128; 129-256 on a second instantiation, `DMAX` 256).  Only a tile with a padded key, a key past the chunk or a
//    key after the warp's first row is masked element by element; once
//    every row of a block has seen a visible key, key tiles wholly in its
//    future are skipped (they would add p = 0 exactly).
//    f32 (a check path, not a speed target): ring_fwd_fma_kernel, plain f32
//    FMA tiles of 64 x 64 in the same launch structure (TF32 would keep
//    about 3 digits);
//  - backward (both schedules): per ring step ONE dK/dV launch (grid
//    dimension z: the step's (rank, visiting block) pairs; each pair adds
//    its block's contribution to the f32 dK/dV rider that travels with the
//    block and lands home) and ONE dQ launch (z: the step's ranks; the
//    contributions of the rank's visiting blocks, in order, added to its
//    f32 dq carry, which starts at the rank's first live step); per call
//    ONE landing launch for every rank (dq, and dk/dv from the landed
//    riders: the two-way ring sums clockwise + counter-clockwise, in that
//    order, in the activation type).  At seq 4, causal, that is 7 launches
//    per two-way call and 9 per one-way call.
//    bf16: ring_bwd_dkdv_mma_kernel and ring_bwd_dq_mma_kernel, tensor
//    cores on the forward's tiling (the short-chunk groups of (b, h), 64-row
//    tiles from C 33 on, cp.async in two stages, head dims zero-padded to
//    16).  dK/dV: a warp owns 16 keys (K, V in shared memory, dk and dv in
//    registers) and walks the query tiles; it computes S^T = k q^T and
//    dP^T = v dO^T so that p^T and ds^T come out of the accumulators as the
//    A operands of dV += p^T dO and dK += ds^T q.  dQ: a warp owns 16 query
//    rows (q and dO as A fragments, dq in registers) and walks the key
//    tiles of the rank's visiting blocks.  p and ds are f32 values: each
//    is fed to the tensor core as hi = bf16(x) and lo = bf16(x - hi).  Key
//    tiles wholly after a dQ block's rows are not walked (ds = 0 there);
//    query tiles wholly before a dK/dV block's keys are skipped only up to
//    the first that holds a dead row (a block vote), since a dead row's p
//    is 1 / l at every masked key of a live block and reaches dv.
//    f32 (a check path): ring_bwd_dkdv_fma_kernel and ring_bwd_dq_fma_kernel,
//    the FMA tiles of 64 x 64, one (b, h) per block, in the same launch
//    structure.
//
// What the TPU kernels compute, and this file copies:
//  - masked logits take NEG_INF = -1e30 and the running max starts there,
//    so a query row whose every visible key is masked attends UNIFORMLY over
//    the keys of the blocks it computed (causally masked keys of a live
//    block included): p = exp(-1e30 - (-1e30)) = 1.  Unlike the flash
//    kernels, such a row is not zeroed; a key tile is skipped only once no
//    row of the block is in that state;
//  - keys past a chunk's edge (only a padded tile has them) take p = 0 and
//    are never "masked keys";
//  - the residuals are (m, safe-l), not lse; the backward takes
//    p = exp(s - m) / l and zeroes ds at masked logits;
//  - p is rounded to the activation type before the PV product, l sums the
//    unrounded p; the backward runs every product in f32 (dO, q, k, v as
//    f32 values; on the tensor cores they are exact bf16 operands, and the
//    f32 p and ds go in as hi + lo pairs); the riders and dq accumulate in
//    f32 and are rounded once, when they land.
//
// Layouts: a rank's local operands (q, dO, o, the acc and dq carries, dq/dk/
// dv) are [B, C, H, D] rows of the [B, T, H, D] sequence, batch stride `sb`
// elements; its rows (m, l, delta) are [B, C, H] of [B, T, H], batch stride
// sb / D.  A visiting block (slot of the ring) is [B, C, H, D] contiguous,
// its key-pad mask [B, C] bytes (nonzero = masked), a rider [2, B, C, H, D]
// f32 (dk, dv).  Rows past the chunk are never stored: a chunk is a view
// into the whole sequence, and the next rank's rows follow it.
//
// Bound on this card: the bytes of q, k, v, o, m, l (and dO, dq, dk, dv)
// once each at 3.35 TB/s, or the operations of the live blocks at 989 TF/s
// (bf16); chip_smoke.py computes both per call.  At the flagship's training
// shape (B 64, H 8, Dh 128, T 20 on seq 4, causal) both directions are
// bound by bytes (3.15 us per forward call, 6.28 us per backward call);
// what costs there is launches and the latency of each block's few loads,
// so the design launches once per ring step and kernel and gives every
// (rank, b, h) its own warp.  At the long shape (B 2, T 4096 on seq 4,
// C 1024, causal) both are bound by operations (the forward 86.9 us, the
// backward's five products about 217 us per call): there the tensor-core
// tiles, the overlapped loads and the skipped tiles do the work; the
// backward computes S and dP in both of its kernels and runs its last
// three products twice (hi and lo), about twice the bound's operations
// (at head dim 256 as at 128: each pair computes S and dP once).
// The hop bytes (slots and riders) are counted apart by the ring
// (`LocalRing.hop_bytes`) and are not part of the bound.  Left for later
// work: wgmma (warpgroup products from shared memory, fed by TMA), the
// carry kept on chip across ring steps, and a hop fused into the block
// kernel.
//
// Head dims 129-256 (the reference tune space's hidden 1024 over 4 heads)
// run instantiations of the same kernels with `DMAX` 256: the f32 FMA tiles
// hold 32 rows, and each bf16 kernel splits its accumulators' columns (the
// forward's carry, dk and dv, dq) between the two warps of a pair, which
// compute S (and dP) once and split it by columns of the walked tile
// (ring_fwd_mma_kernel<256>, ring_bwd_dkdv_mma_kernel<256>,
// ring_bwd_dq_mma_kernel<256>).  The instantiations up to 128 are the ones
// measured above, unchanged.
#include "mma.cuh"

namespace bvq {

constexpr float RA_NEG_INF = -1e30f;
constexpr int RA_DMAX = 256;         // the largest head dim

// The f32 FMA tiles of the kernels instantiated for head dims up to DMAX
// (128 or 256): T-row tiles, 4 threads a row; 64 rows up to D 128, 32 above
// it (four 64-row f32 tiles of D 256 would not fit in shared memory).
template <int DMAX>
struct RaTile {
  static constexpr int T = DMAX > 128 ? 32 : 64, THREADS = 4 * T;
  static constexpr int DC = DMAX / 4;  // d columns a thread owns: d = lane4 + 4c
  static constexpr int JC = T / 4;     // key columns a thread scores: j = lane4 + 4c
  static constexpr int PLD = T + 1;    // row stride of the [T][T] score tiles
};

// offset of element (b, t, h, 0) of a [B, rows, H, D] operand
__device__ __forceinline__ size_t ra_at(long sb, int b, int t, int h, int H, int D) {
  return (size_t)b * sb + ((size_t)t * H + h) * D;
}

// the rows a tile holds: RT (64 or 32), or the whole chunk when it is
// shorter (the shared memory of a block is sized by it, so short chunks fill
// the card)
template <int RT>
__host__ __device__ __forceinline__ int ra_tile_rows(int chunk) {
  return chunk < RT ? chunk : RT;
}

// rows [r0, r0 + RT) of x at (b, h), as far as the chunk C goes, into dst
// [rows][D + 1] as f32.  Rows past the chunk are never read: every loop
// over a tile stops at the chunk's edge.
template <typename T, int RT>
__device__ void ra_load_tile(float* dst, const T* src, long sb, int b, int h, int r0,
                             int D, int C, int H) {
  const int n = min(RT, C - r0) * D;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = to_f<T>(src[ra_at(sb, b, r0 + r, h, H, D) + d]);
  }
}

__device__ __forceinline__ float ra_dot(const float* x, const float* y, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(x[d], y[d], s);
  return s;
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
// The plan both directions launch on: one launch per ring step (and kernel)
// for every rank with a live block there.
constexpr int RING_RMAX = 64;       // ranks a launch takes

// The ranks live at one step.  Entry e is rank rank[e]; it computes nblk =
// info & 3 visiting blocks, block j through direction (info >> (4 + j)) & 1
// (0 clockwise, 1 counter-clockwise) from source rank src[2e + j].  info & 4:
// the rank's first live step (its carry starts empty); info & 8: its last
// (the forward launch finalizes it).  pair[p] = 2e + j, p < npair, lists the
// step's (entry, visiting block) pairs: the grid of the backward's dK/dV
// launch.
struct RingStep {
  int nent;
  int npair;
  int rank[RING_RMAX];
  int info[RING_RMAX];
  int src[2 * RING_RMAX];
  int pair[2 * RING_RMAX];
};

// ---------------------------------------------------------------------------
// Forward: grid dimension z runs over the step's entries.
constexpr int RF_WARPS = 4;         // tensor-core kernel: warps per block
constexpr int RF_BLOCKS_PER_SM = 3; // its registers are capped for 3 blocks per SM
constexpr int RF_THREADS = 32 * RF_WARPS;
constexpr int RF_KT = 64;           // keys per tile of the tensor-core kernel
constexpr int RF_NT = RF_KT / 8;    // its key columns of 8

struct RingFwdArgs {
  int act_bf16, causal, batch, heads, chunk, dim;
  long rs;                      // rank stride of the local operands (C*H*D)
  long sb;                      // their batch stride
  long slot_rs;                 // rank stride of a slot (B*C*H*D)
  const void* q;                // rank 0's local operands [B, C, H, D]
  float* acc;                   // f32 carry, laid out as q
  float* m;                     // rows [B, C, H]: rank stride rs / D, batch stride sb / D
  float* l;
  void* o;                      // laid out as q
  const void* k[2];             // the step's slot of each direction [n, B, C, H, D]
  const void* v[2];
  const unsigned char* pad[2];  // [n, B, C]
  RingStep step;
};

// entry e's local operands, at its rank's offsets
template <typename T>
struct RfLocal {
  const T* q;
  float* acc;
  float* m;
  float* l;
  T* o;
  int nblk, q_off;
  bool first, last;
};

template <typename T>
__device__ __forceinline__ RfLocal<T> rf_local(const RingFwdArgs& a, int e) {
  const int rank = a.step.rank[e], info = a.step.info[e];
  const size_t off = (size_t)rank * a.rs, roff = off / a.dim;
  return RfLocal<T>{static_cast<const T*>(a.q) + off, a.acc + off, a.m + roff, a.l + roff,
                    static_cast<T*>(a.o) + off, info & 3, rank * a.chunk, (info & 4) != 0,
                    (info & 8) != 0};
}

// visiting block j of entry e
template <typename T>
struct RfBlock {
  const T* k;
  const T* v;
  const unsigned char* pad;
  int k_off;
};

template <typename T>
__device__ __forceinline__ RfBlock<T> rf_block(const RingFwdArgs& a, int e, int j) {
  const int rank = a.step.rank[e];
  const bool ccw = (a.step.info[e] >> (4 + j)) & 1;
  const size_t off = (size_t)rank * a.slot_rs;
  return RfBlock<T>{static_cast<const T*>(ccw ? a.k[1] : a.k[0]) + off,
                    static_cast<const T*>(ccw ? a.v[1] : a.v[0]) + off,
                    (ccw ? a.pad[1] : a.pad[0]) + (size_t)rank * a.batch * a.chunk,
                    a.step.src[2 * e + j] * a.chunk};
}

// f32: block (b*h, 64-row query tile, entry); thread (row = tid / 4, lane4 =
// tid % 4) scores key columns lane4 + 4c and owns carry columns lane4 + 4c
// of its row.
template <int DMAX>
__global__ void __launch_bounds__(RaTile<DMAX>::THREADS)
    ring_fwd_fma_kernel(const __grid_constant__ RingFwdArgs a) {
  using F = RaTile<DMAX>;
  extern __shared__ float ra_smem[];
  const int D = a.dim, LD = D + 1, C = a.chunk, H = a.heads, TR = ra_tile_rows<F::T>(C);
  float* qs = ra_smem;          // [TR][LD]
  float* ks = qs + TR * LD;     // [TR][LD]
  float* vs = ks + TR * LD;     // [TR][LD]
  float* ps = vs + TR * LD;     // [TR][PLD] p
  const int e = blockIdx.z;
  const RfLocal<float> x = rf_local<float>(a, e);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * F::T;
  const int tid = threadIdx.x, row = tid / 4, lane4 = tid % 4, i = q0 + row;
  const long sbk = (long)C * H * D;
  const size_t ri = (size_t)b * (a.sb / D) + (size_t)i * H + h;
  const size_t oi = ra_at(a.sb, b, i, h, H, D);

  ra_load_tile<float, F::T>(qs, x.q, a.sb, b, h, q0, D, C, H);
  float m = RA_NEG_INF, l = 0.f, acc[F::DC];
#pragma unroll
  for (int c = 0; c < F::DC; ++c) acc[c] = 0.f;
  if (!x.first && i < C) {
    m = x.m[ri];
    l = x.l[ri];
#pragma unroll
    for (int c = 0; c < F::DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) acc[c] = x.acc[oi + d];
    }
  }

  for (int blk = 0; blk < x.nblk; ++blk) {
    const RfBlock<float> kb = rf_block<float>(a, e, blk);
    for (int k0 = 0; k0 < C; k0 += F::T) {
      __syncthreads();  // the previous tile's reads are done
      ra_load_tile<float, F::T>(ks, kb.k, sbk, b, h, k0, D, C, H);
      ra_load_tile<float, F::T>(vs, kb.v, sbk, b, h, k0, D, C, H);
      __syncthreads();
      float s[F::JC];
      float mcur = -INFINITY;
#pragma unroll
      for (int c = 0; c < F::JC; ++c) {
        const int j = lane4 + 4 * c, kj = k0 + j;
        const bool valid = kj < C;
        // rows past the chunk take part in the row reductions only
        s[c] = !valid || i >= C || kb.pad[(size_t)b * C + kj] ||
                       (a.causal && kb.k_off + kj > x.q_off + i)
                   ? RA_NEG_INF
                   : ra_dot(qs + row * LD, ks + j * LD, D);
        if (valid) mcur = fmaxf(mcur, s[c]);
      }
      const float m_new = fmaxf(m, ra_quad_max(mcur));
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < F::JC; ++c) {
        const int j = lane4 + 4 * c;
        const float p = k0 + j < C ? expf(s[c] - m_new) : 0.f;
        psum += p;
        if (row < TR) ps[row * F::PLD + j] = p;
      }
      l = l * alpha + ra_quad_sum(psum);
      m = m_new;
      __syncwarp();  // the row's p was written by the 4 lanes that read it
      // keys past the chunk have p = 0: the sum stops at the chunk's edge
      const int jn = min(F::T, C - k0);
#pragma unroll
      for (int c = 0; c < F::DC; ++c) {
        const int d = lane4 + 4 * c;
        if (d < D && i < C) {
          float pv = 0.f;
          for (int j = 0; j < jn; ++j) pv = fmaf(ps[row * F::PLD + j], vs[j * LD + d], pv);
          acc[c] = acc[c] * alpha + pv;
        }
      }
    }
  }

  if (i >= C) return;
  if (x.last) {  // o = acc / safe-l, l := safe-l
    const float safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < F::DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) x.o[oi + d] = acc[c] / safe;
    }
    l = safe;
  } else {
#pragma unroll
    for (int c = 0; c < F::DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) x.acc[oi + d] = acc[c];
    }
  }
  if (lane4 == 0) {
    x.m[ri] = m;
    x.l[ri] = l;
  }
}

// ---- the tensor-core kernel (bf16)
// the tensor-core kernel's tiling of a chunk of C rows at head dim D
struct RfGeom {
  int wq;      // warps per (b, h): the block's 16 * wq query rows
  int groups;  // (b, h) per block, RF_WARPS / wq
  int kt;      // keys per tile: C rounded up to 16, at most 64
  int dp;      // D rounded up to 16 (zero-padded)
  int lds;     // shared row stride in elements, dp + 8: the 8 rows an ldmatrix
               // reads fall 16 bytes apart modulo 128, on distinct banks
  int stage;   // bytes of one stage of one group: K and V tiles, the keys' pads
};

__host__ __device__ __forceinline__ RfGeom rf_geom(int C, int D) {
  RfGeom g;
  g.wq = C <= 16 ? 1 : C <= 32 ? 2 : RF_WARPS;
  g.groups = RF_WARPS / g.wq;
  const int c16 = (C + 15) / 16 * 16;
  g.kt = c16 < RF_KT ? c16 : RF_KT;
  g.dp = (D + 15) / 16 * 16;
  g.lds = g.dp + 8;
  g.stage = (2 * g.kt * g.lds * 2 + g.kt + 15) / 16 * 16;
  return g;
}

// bf16: block ((b, h) group, 16 * wq query rows, entry).  Warp w serves the
// block's (b, h) number w / wq and its query rows 16 (w % wq) .. + 15.  In
// the fragments of mma.m16n8k16, lane 4 gr + tq holds rows gr and gr + 8,
// columns 2 tq and 2 tq + 1 of each 8 columns.  The key tiles of the entry's
// blocks run in schedule order through two shared stages per group: the
// load of the next tile is issued before the products of this one.
//
// Head dims up to 128 take this DMAX 128 kernel, registers capped for 3
// blocks per SM; 136-256 take the DMAX 256 kernel below, which splits the
// carry's columns between the two warps of a pair.  The template is only
// declared: each head-dim bound is an explicit specialization with launch
// bounds or a register cap of its own (a specialization would inherit the
// primary template's, and __launch_bounds__ and __maxnreg__ do not mix).
template <int DMAX>
__global__ void ring_fwd_mma_kernel(const __grid_constant__ RingFwdArgs a);

template <>
__global__ void __launch_bounds__(RF_THREADS, RF_BLOCKS_PER_SM)
    ring_fwd_mma_kernel<128>(const __grid_constant__ RingFwdArgs a) {
  constexpr int DMAX = 128;
  constexpr int RF_DT = DMAX / 8;  // head-dim columns of 8
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rf_smem[];
  const int C = a.chunk, D = a.dim, H = a.heads, e = blockIdx.z;
  const RfGeom g = rf_geom(C, D);
  const RfLocal<T> x = rf_local<T>(a, e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int grp = warp / g.wq;
  const int gtid = threadIdx.x - grp * 32 * g.wq, gthreads = 32 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;  // the last block's groups may be idle
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int qb = blockIdx.y * 16 * g.wq;           // the block's first query row
  const int r0 = qb + 16 * (warp % g.wq);          // the warp's
  const int qlast = min(C, qb + 16 * g.wq) - 1;    // the block's last row in the chunk
  const int nd = g.dp / 8, ntk = (C + g.kt - 1) / g.kt, nt = x.nblk * ntk;
  const long sbk = (long)C * H * D, sr = a.sb / D;
  unsigned char* gsm = rf_smem + (size_t)grp * 2 * g.stage;
  const int mi = lane / 8, lr8 = lane % 8;         // ldmatrix: matrix and row

  // q rows r0 + gr and + 8 as A fragments, zero past the chunk and the dim
  uint32_t qf[DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < g.dp / 16) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = r0 + gr + 8 * (y & 1), d = 16 * kk + 8 * (y >> 1) + 2 * tq;
        float lo = 0.f, hi = 0.f;
        if (active && i < C) {
          const T* p = x.q + ra_at(a.sb, b, i, h, H, D);
          if (d < D) lo = __bfloat162float(p[d]);
          if (d + 1 < D) hi = __bfloat162float(p[d + 1]);
        }
        qf[kk][y] = rf_pack(lo, hi);
      }
    }
  }

  // the carry of rows r0 + gr + 8y: acc[n][2y + c] is column 8n + 2tq + c
  float mr[2], lr[2], acc[RF_DT][4];
#pragma unroll
  for (int n = 0; n < RF_DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    mr[y] = RA_NEG_INF;
    lr[y] = 0.f;
    if (!x.first && active && i < C) {
      const size_t ri = (size_t)b * sr + (size_t)i * H + h, oi = ra_at(a.sb, b, i, h, H, D);
      mr[y] = x.m[ri];
      lr[y] = x.l[ri];
#pragma unroll
      for (int n = 0; n < RF_DT; ++n) {
        const int d = 8 * n + 2 * tq;
        if (d < D) acc[n][2 * y] = x.acc[oi + d];
        if (d + 1 < D) acc[n][2 * y + 1] = x.acc[oi + d + 1];
      }
    }
  }

  // tile t: key tile t % ntk of visiting block t / ntk, into stage st
  auto load = [&](int t, int st) {
    if (!active) return;
    const int k0 = (t % ntk) * g.kt;
    const RfBlock<T> kb = rf_block<T>(a, e, t / ntk);
    T* ks = reinterpret_cast<T*>(gsm + st * g.stage);
    T* vs = ks + g.kt * g.lds;
    unsigned char* ps = reinterpret_cast<unsigned char*>(vs + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = k0 + r;
      const int valid = kj < C ? max(0, min(8, D - d0)) : 0;  // zeros past the edges
      const size_t off = kj < C ? ra_at(sbk, b, kj, h, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, kb.k + off, valid, __float2bfloat16_rn(0.f));
      rf_load16(vs + r * g.lds + d0, kb.v + off, valid, __float2bfloat16_rn(0.f));
    }
    // the keys' pad bytes, 1 past the chunk's edge
    for (int c = gtid; c < g.kt / 16; c += gthreads) {
      const int kj = k0 + 16 * c;
      rf_load16(ps + 16 * c, kb.pad + (size_t)b * C + kj, max(0, min(16, C - kj)),
                (unsigned char)1);
    }
  };
  // every key of tile t lies after every query row of the block
  auto future = [&](int t) {
    return a.causal && a.step.src[2 * e + t / ntk] * C + (t % ntk) * g.kt > x.q_off + qlast;
  };

  load(0, 0);
  rf_commit();
  bool all_live = false;  // every row of the block has seen a visible key
  for (int t = 0, st = 0; t < nt; st ^= 1) {
    // a tile in the future of every row would add p = 0 once all are live
    int tn = t + 1;
    while (tn < nt && all_live && future(tn)) ++tn;
    if (tn < nt) load(tn, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t has landed
    __syncthreads();

    if (active) {
      const int k0 = (t % ntk) * g.kt;
      const int k_off = a.step.src[2 * e + t / ntk] * C;
      const T* ks = reinterpret_cast<const T*>(gsm + st * g.stage);
      const T* vs = ks + g.kt * g.lds;
      const unsigned char* ps = reinterpret_cast<const unsigned char*>(vs + g.kt * g.lds);
      // S = q k^T, key columns 16 jp .. + 15 at a time.  Each 16-deep
      // slice of the head dim is summed by the tensor core from zero and
      // added here in f32, rounded to nearest: accumulated inside the
      // tensor core over the whole dim (which truncates its sums), m and l
      // read up to 1.09e-6 relative off the plain version's f32 products at
      // C 1,024 (chip_smoke.py phase 12, NVIDIA H100 80GB HBM3, 700 W).
      float s[RF_NT][4];
#pragma unroll
      for (int j = 0; j < RF_NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < RF_NT / 2; ++jp) {
        if (jp < g.kt / 16) {
#pragma unroll
          for (int kk = 0; kk < DMAX / 16; ++kk) {
            if (kk < g.dp / 16) {
              uint32_t kf[4];
              rf_ldsm(kf, ks + (16 * jp + 8 * (mi >> 1) + lr8) * g.lds + 16 * kk + 8 * (mi & 1));
              float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
              rf_mma(s0, qf[kk], kf[0], kf[1]);
              rf_mma(s1, qf[kk], kf[2], kf[3]);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                s[2 * jp][c] += s0[c];
                s[2 * jp + 1][c] += s1[c];
              }
            }
          }
        }
      }
      // masked logits take NEG_INF; keys past the chunk stay out of the max.
      // Only a tile with a padded key, a key past the chunk (pad byte 1) or
      // a key after the warp's first row needs the masks.
      const bool edge =
          __any_sync(0xffffffffu, (lane < g.kt && ps[lane]) ||
                                      (lane + 32 < g.kt && ps[lane + 32])) ||
          (a.causal && k_off + k0 + g.kt - 1 > x.q_off + r0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < RF_NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * tq + (c & 1), kj = k0 + col, i = r0 + gr + 8 * (c >> 1);
          if (j < g.kt / 8 && kj < C) {
            if (edge && (ps[col] || (a.causal && k_off + kj > x.q_off + i)))
              s[j][c] = RA_NEG_INF;
            mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
          }
        }
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const float m_new = fmaxf(mr[y], ra_quad_max(mx[y]));
        alpha[y] = expf(mr[y] - m_new);
        mr[y] = m_new;
      }
#pragma unroll
      for (int j = 0; j < RF_NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kj = k0 + 8 * j + 2 * tq + (c & 1);
          const float p = j < g.kt / 8 && kj < C ? expf(s[j][c] - mr[c >> 1]) : 0.f;
          s[j][c] = p;
          psum[c >> 1] += p;
        }
      }
#pragma unroll
      for (int y = 0; y < 2; ++y) lr[y] = lr[y] * alpha[y] + ra_quad_sum(psum[y]);
#pragma unroll
      for (int n = 0; n < RF_DT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // acc += p v with p rounded to bf16 as the A operand, keys 16 kp .. + 15
#pragma unroll
      for (int kp = 0; kp < RF_NT / 2; ++kp) {
        if (kp < g.kt / 16) {
          const uint32_t pa[4] = {rf_pack(s[2 * kp][0], s[2 * kp][1]),
                                  rf_pack(s[2 * kp][2], s[2 * kp][3]),
                                  rf_pack(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                                  rf_pack(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
          for (int np = 0; np < RF_DT / 2; ++np) {
            if (np < g.dp / 16) {
              uint32_t vf[4];
              rf_ldsm_t(vf, vs + (16 * kp + 8 * (mi & 1) + lr8) * g.lds + 16 * np + 8 * (mi >> 1));
              rf_mma(acc[2 * np], pa, vf[0], vf[1]);
              rf_mma(acc[2 * np + 1], pa, vf[2], vf[3]);
            }
          }
        }
      }
    }

    bool live = true;
#pragma unroll
    for (int y = 0; y < 2; ++y)
      live = live && (!active || r0 + gr + 8 * y >= C || mr[y] > RA_NEG_INF);
    // also: every warp is done with stage st before the next load refills it
    all_live = __syncthreads_and(live);
    t = tn;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (!active) return;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    if (i >= C) continue;  // rows past the chunk belong to the next rank
    const size_t ri = (size_t)b * sr + (size_t)i * H + h, oi = ra_at(a.sb, b, i, h, H, D);
    float l = lr[y];
    if (x.last) {  // o = acc / safe-l in bf16, l := safe-l
      l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int n = 0; n < RF_DT; ++n) {
        const int d = 8 * n + 2 * tq;
        if (d + 1 < D && D % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(x.o + oi + d) =
              __floats2bfloat162_rn(acc[n][2 * y] / l, acc[n][2 * y + 1] / l);
        } else {
          if (d < D) x.o[oi + d] = __float2bfloat16_rn(acc[n][2 * y] / l);
          if (d + 1 < D) x.o[oi + d + 1] = __float2bfloat16_rn(acc[n][2 * y + 1] / l);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < RF_DT; ++n) {
        const int d = 8 * n + 2 * tq;
        if (d < D) x.acc[oi + d] = acc[n][2 * y];
        if (d + 1 < D) x.acc[oi + d + 1] = acc[n][2 * y + 1];
      }
    }
    if (tq == 0) {
      x.m[ri] = mr[y];
      x.l[ri] = l;
    }
  }
}

// ---- head dims 136-256: ring_fwd_mma_kernel<256>
// At DMAX 256 the kernel above would hold q's fragments and the carry of 16
// rows x 256 a warp: twice a warp's registers, so it would spill and hold
// an SM alone.  Here each 16-row tile is served by a PAIR of warps of one block
// (warp 2 rt + half), one for each half of the carry's columns
// (pair_cols: 128 each at Dh 256).  A block of 4 warps holds two row tiles:
// two (b, h) of 16 rows each (C <= 16) or one (b, h) and 32 rows (C <= 32);
// longer chunks take blocks of 8 warps, one (b, h) and 64 rows, so that a
// key tile serves as many rows as in the kernel above.
//  - q stays in shared memory in bf16; each 16-deep slice's A fragment is
//    read there by ldmatrix, not held in registers.
//  - S: the pair splits the tile's keys in columns of 8, half + 2 i, and
//    each warp sums its columns over every 16-deep slice of the head dim,
//    each slice from zero on the tensor cores, added in f32 in order: every
//    S element sums as in the kernel above, and so m does.
//  - The halves' row maxima meet in shared memory at the pair's named
//    barrier; each warp writes its p (f32) into the tile's p rows, and
//    after a second barrier both warps read the whole rows: l sums them in
//    the order of the kernel above, and each warp rounds them to bf16 as
//    the A operand of acc += p v over its own columns.  So o (or the
//    carry), m and l are the arithmetic of the kernel above, bit for bit.
//  - The carried m and l: warp `half` 0 alone reads them from device
//    memory (into `red`, which its partner reads after a block barrier)
//    and alone writes them, after the tile loop's last block barrier.  Each
//    warp reads and writes its own columns of the acc carry.  (Two blocks
//    splitting the columns, as the backward does, would both read and
//    write the same m and l.)
//  - A group holds q, the p rows, the row maxima and its first stage; the
//    second stages follow all groups and are allocated only when an entry
//    of the step walks more than one tile (ring_fwd_kernels).  At C 5 a
//    group takes 27,024 bytes with one stage and 43,936 with two, so a
//    one-way step (one tile an entry) fits 3 blocks an SM (4 by shared
//    memory, 3 by registers) and a two-way step 2; at C 21, 2; from C 33
//    on (48- and 64-key tiles), one 8-warp block.
//  - Key tiles of C rounded up to 16, at most 64, as above (the tile sets
//    the points where p is rounded against the running max).
//  - Registers are capped at 168 a thread, so that 3 blocks of 4 warps
//    share an SM (__maxnreg__: the 8-warp blocks need launch bounds of 256
//    threads, which alone would cap them at 255).
constexpr int RS_MAX_REGS = 168;

struct RsGeom {
  int wq;      // row tiles of 16 per (b, h) in a block, each a pair of warps: 1, 2 or 4
  int tiles;   // row tiles of a block: 2, or 4 (wq 4: blocks of 8 warps)
  int groups;  // (b, h) per block, tiles / wq
  int own;     // query rows of a group, 16 * wq
  int kt, dp, lds, stage;  // as RfGeom
  int pld;     // row stride of the f32 p rows, kt + 8
  int gbytes;  // bytes of a group: q (bf16), p (f32), 2 f32 a row, one stage
};

__host__ __device__ __forceinline__ RsGeom rs_geom(int C, int D) {
  const RfGeom f = rf_geom(C, D);
  RsGeom g;
  g.wq = C <= 16 ? 1 : C <= 32 ? 2 : 4;
  g.tiles = g.wq == 4 ? 4 : 2;
  g.groups = g.tiles / g.wq;
  g.own = 16 * g.wq;
  g.kt = f.kt;
  g.dp = f.dp;
  g.lds = f.lds;
  g.stage = f.stage;
  g.pld = g.kt + 8;
  g.gbytes = g.own * g.lds * 2 + g.own * g.pld * 4 + g.own * 8 + g.stage;
  return g;
}

template <>
__global__ void __maxnreg__(RS_MAX_REGS)
    ring_fwd_mma_kernel<256>(const __grid_constant__ RingFwdArgs a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rf_smem[];
  const int C = a.chunk, D = a.dim, H = a.heads, e = blockIdx.z;
  const RsGeom g = rs_geom(C, D);
  const RfLocal<T> x = rf_local<T>(a, e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int rt = warp / 2, half = warp % 2;        // the warp's row tile and column half
  const int grp = rt / g.wq;
  const int gtid = threadIdx.x - grp * 64 * g.wq, gthreads = 64 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;  // the last block's groups may be idle
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int qb = blockIdx.y * g.own;               // the group's first query row
  const int rw = 16 * (rt % g.wq);                 // the tile's first row in the group
  const int r0 = qb + rw;
  const int qlast = min(C, qb + g.own) - 1;        // the block's last row in the chunk
  const int nd = g.dp / 8, ntk = (C + g.kt - 1) / g.kt, nt = x.nblk * ntk;
  const long sbk = (long)C * H * D, sr = a.sb / D;
  const PairCols cols = pair_cols(g.dp, half);
  unsigned char* gsm = rf_smem + (size_t)grp * g.gbytes;
  T* qs = reinterpret_cast<T*>(gsm);                          // [own][lds] q, bf16
  float* pf = reinterpret_cast<float*>(qs + g.own * g.lds);   // [own][pld] p, f32
  float* red = pf + g.own * g.pld;                            // [own][2]
  unsigned char* stg0 = reinterpret_cast<unsigned char*>(red + 2 * g.own);
  unsigned char* stg1 = rf_smem + (size_t)g.groups * g.gbytes + (size_t)grp * g.stage;
  const int mi = lane / 8, lr8 = lane % 8;         // ldmatrix: matrix and row
  const T zero = __float2bfloat16_rn(0.f);

  // the group's q rows, zeros past the chunk and the dim (in the first
  // tile's cp.async group)
  if (active) {
    for (int c = gtid; c < g.own * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, i = qb + r;
      const int valid = i < C ? max(0, min(8, D - d0)) : 0;
      rf_load16(qs + r * g.lds + d0, x.q + (i < C ? ra_at(a.sb, b, i, h, H, D) + d0 : 0), valid,
                zero);
    }
  }

  // the carry of rows r0 + gr + 8y over the warp's columns: acc[n][2y + c]
  // is column cols.c0 + 8n + 2tq + c; m and l through `red`
  float mr[2], lr[2], acc[MMA_DT][4];
#pragma unroll
  for (int n = 0; n < MMA_DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    const bool carried = !x.first && active && i < C;
    const size_t ri = (size_t)b * sr + (size_t)i * H + h, oi = ra_at(a.sb, b, i, h, H, D);
    if (half == 0 && tq == 0) {
      red[(rw + gr + 8 * y) * 2] = carried ? x.m[ri] : RA_NEG_INF;
      red[(rw + gr + 8 * y) * 2 + 1] = carried ? x.l[ri] : 0.f;
    }
    if (carried) {
#pragma unroll
      for (int n = 0; n < MMA_DT; ++n) {
        const int d = cols.c0 + 8 * n + 2 * tq;
        if (8 * n < cols.cw) {
          if (d < D) acc[n][2 * y] = x.acc[oi + d];
          if (d + 1 < D) acc[n][2 * y + 1] = x.acc[oi + d + 1];
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    mr[y] = red[(rw + gr + 8 * y) * 2];
    lr[y] = red[(rw + gr + 8 * y) * 2 + 1];
  }

  // tile t: key tile t % ntk of visiting block t / ntk, into stage st
  auto load = [&](int t, int st) {
    if (!active) return;
    const int k0 = (t % ntk) * g.kt;
    const RfBlock<T> kb = rf_block<T>(a, e, t / ntk);
    T* ks = reinterpret_cast<T*>((st ? stg1 : stg0));
    T* vs = ks + g.kt * g.lds;
    unsigned char* ps = reinterpret_cast<unsigned char*>(vs + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = k0 + r;
      const int valid = kj < C ? max(0, min(8, D - d0)) : 0;  // zeros past the edges
      const size_t off = kj < C ? ra_at(sbk, b, kj, h, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, kb.k + off, valid, zero);
      rf_load16(vs + r * g.lds + d0, kb.v + off, valid, zero);
    }
    // the keys' pad bytes, 1 past the chunk's edge
    for (int c = gtid; c < g.kt / 16; c += gthreads) {
      const int kj = k0 + 16 * c;
      rf_load16(ps + 16 * c, kb.pad + (size_t)b * C + kj, max(0, min(16, C - kj)),
                (unsigned char)1);
    }
  };
  // every key of tile t lies after every query row of the block
  auto future = [&](int t) {
    return a.causal && a.step.src[2 * e + t / ntk] * C + (t % ntk) * g.kt > x.q_off + qlast;
  };

  load(0, 0);
  rf_commit();
  bool all_live = false;  // every row of the block has seen a visible key
  for (int t = 0, st = 0; t < nt; st ^= 1) {
    // a tile in the future of every row would add p = 0 once all are live
    int tn = t + 1;
    while (tn < nt && all_live && future(tn)) ++tn;
    if (tn < nt) load(tn, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t (and q) landed
    __syncthreads();

    if (active) {
      const int k0 = (t % ntk) * g.kt;
      const int k_off = a.step.src[2 * e + t / ntk] * C;
      const T* ks = reinterpret_cast<const T*>((st ? stg1 : stg0));
      const T* vs = ks + g.kt * g.lds;
      const unsigned char* ps = reinterpret_cast<const unsigned char*>(vs + g.kt * g.lds);
      // S = q k^T over the warp's key columns half + 2 i (s[i][c]: row gr +
      // 8 (c >> 1), key 8 (half + 2 i) + 2 tq + (c & 1)); each 16-deep
      // slice from zero, added in f32 in order, as above
      float s[RF_NT / 2][4];
#pragma unroll
      for (int i = 0; i < RF_NT / 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < RA_DMAX / 16; ++kk) {
        if (kk < g.dp / 16) {
          uint32_t qa[4];
          rf_ldsm(qa, qs + (rw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
#pragma unroll
          for (int i = 0; i < RF_NT / 2; ++i) {
            if (i < g.kt / 16) {
              uint32_t kf[2];
              rf_ldsm2(kf, ks + (8 * (half + 2 * i) + lr8) * g.lds + 16 * kk + 8 * (mi & 1));
              float s0[4] = {0.f, 0.f, 0.f, 0.f};
              rf_mma(s0, qa, kf[0], kf[1]);
#pragma unroll
              for (int c = 0; c < 4; ++c) s[i][c] += s0[c];
            }
          }
        }
      }
      // masked logits take NEG_INF; keys past the chunk stay out of the max
      const bool edge =
          __any_sync(0xffffffffu, (lane < g.kt && ps[lane]) ||
                                      (lane + 32 < g.kt && ps[lane + 32])) ||
          (a.causal && k_off + k0 + g.kt - 1 > x.q_off + r0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < RF_NT / 2; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * (half + 2 * i) + 2 * tq + (c & 1), kj = k0 + col;
          const int r = r0 + gr + 8 * (c >> 1);
          if (i < g.kt / 16 && kj < C) {
            if (edge && (ps[col] || (a.causal && k_off + kj > x.q_off + r)))
              s[i][c] = RA_NEG_INF;
            mx[c >> 1] = fmaxf(mx[c >> 1], s[i][c]);
          }
        }
      }
      float tmax[2], alpha[2];  // the tile's row maxima over both halves
      pair_row_max(tmax, mx, red + 2 * rw, gr, tq, half, rt);
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const float m_new = fmaxf(mr[y], tmax[y]);
        alpha[y] = expf(mr[y] - m_new);
        mr[y] = m_new;
      }
      // p (0 past the chunk) into the tile's p rows, f32
#pragma unroll
      for (int i = 0; i < RF_NT / 2; ++i) {
        if (i < g.kt / 16) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int kj = k0 + 8 * (half + 2 * i) + 2 * tq + (c & 1);
            s[i][c] = kj < C ? expf(s[i][c] - mr[c >> 1]) : 0.f;
          }
          float* p0 = pf + (rw + gr) * g.pld + 8 * (half + 2 * i) + 2 * tq;
          *reinterpret_cast<float2*>(p0) = make_float2(s[i][0], s[i][1]);
          *reinterpret_cast<float2*>(p0 + 8 * g.pld) = make_float2(s[i][2], s[i][3]);
        }
      }
      pair_sync(rt);
#pragma unroll
      for (int n = 0; n < MMA_DT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // the whole rows' p: l sums them in the order of the kernel above (per
      // lane: key columns of 8, the lane's two keys; then the quad), and
      // acc += p v over the warp's columns, p rounded to bf16 as the A
      // operand, keys 16 kp .. + 15
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int kp = 0; kp < RF_NT / 2; ++kp) {
        if (kp < g.kt / 16) {
          uint32_t pa[4];
          pair_p_slice(pa, psum, pf + (rw + gr) * g.pld, g.pld, kp, tq);
#pragma unroll
          for (int np = 0; np < MMA_DT / 2; ++np) {
            if (16 * np < cols.cw) {
              uint32_t vf[4];
              rf_ldsm_t(vf, vs + (16 * kp + 8 * (mi & 1) + lr8) * g.lds + cols.c0 + 16 * np +
                                8 * (mi >> 1));
              rf_mma(acc[2 * np], pa, vf[0], vf[1]);
              rf_mma(acc[2 * np + 1], pa, vf[2], vf[3]);
            }
          }
        }
      }
#pragma unroll
      for (int y = 0; y < 2; ++y) lr[y] = lr[y] * alpha[y] + ra_quad_sum(psum[y]);
    }

    bool live = true;
#pragma unroll
    for (int y = 0; y < 2; ++y)
      live = live && (!active || r0 + gr + 8 * y >= C || mr[y] > RA_NEG_INF);
    // also: every warp is done with stage st and the p rows before they are refilled
    all_live = __syncthreads_and(live);
    t = tn;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (!active) return;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    if (i >= C) continue;  // rows past the chunk belong to the next rank
    const size_t ri = (size_t)b * sr + (size_t)i * H + h, oi = ra_at(a.sb, b, i, h, H, D);
    float l = lr[y];
    if (x.last) {  // o = acc / safe-l in bf16, l := safe-l
      l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int n = 0; n < MMA_DT; ++n) {
        const int d = cols.c0 + 8 * n + 2 * tq;
        if (8 * n >= cols.cw) continue;
        if (d + 1 < D && D % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(x.o + oi + d) =
              __floats2bfloat162_rn(acc[n][2 * y] / l, acc[n][2 * y + 1] / l);
        } else {
          if (d < D) x.o[oi + d] = __float2bfloat16_rn(acc[n][2 * y] / l);
          if (d + 1 < D) x.o[oi + d + 1] = __float2bfloat16_rn(acc[n][2 * y + 1] / l);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < MMA_DT; ++n) {
        const int d = cols.c0 + 8 * n + 2 * tq;
        if (8 * n >= cols.cw) continue;
        if (d < D) x.acc[oi + d] = acc[n][2 * y];
        if (d + 1 < D) x.acc[oi + d + 1] = acc[n][2 * y + 1];
      }
    }
    if (tq == 0 && half == 0) {
      x.m[ri] = mr[y];
      x.l[ri] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: per ring step one dK/dV launch (grid dimension z over the step's
// (entry, visiting block) pairs) and one dQ launch (z over its entries); one
// landing launch per call for every rank.
struct RingBwdArgs {
  int act_bf16, causal, ranks, batch, heads, chunk, dim;
  long rs;                      // rank stride of the local operands (C*H*D)
  long sb;                      // their batch stride
  long slot_rs;                 // rank stride of a K/V slot (B*C*H*D); a rider's is twice it
  const void* q;                // rank 0's local operands [B, C, H, D]
  const void* dout;
  const float* m;               // rows [B, C, H]: rank stride rs / D, batch stride sb / D
  const float* l;               // the forward's safe l
  const float* delta;           // rowsum(dO * O)
  float* dq;                    // f32 carry, laid out as q
  const void* k[2];             // the step's slot of each direction [n, B, C, H, D]
  const void* v[2];
  const unsigned char* pad[2];  // [n, B, C]
  float* rider[2];              // the step's riders of each direction [n, 2, B, C, H, D]
  void* dq_out;                 // outputs, laid out as q
  void* dk;
  void* dv;
  const float* ret[2];          // landed riders [n, 2, B, C, H, D] (ret[1] null one-way)
  RingStep step;
};

// entry e's local operands, at its rank's offsets
template <typename T>
struct RbLocal {
  const T* q;
  const T* dout;
  const float* m;
  const float* l;
  const float* delta;
  float* dq;
  int nblk, q_off;
  bool first;
};

template <typename T>
__device__ __forceinline__ RbLocal<T> rb_local(const RingBwdArgs& a, int e) {
  const int rank = a.step.rank[e], info = a.step.info[e];
  const size_t off = (size_t)rank * a.rs, roff = off / a.dim;
  return RbLocal<T>{static_cast<const T*>(a.q) + off, static_cast<const T*>(a.dout) + off,
                    a.m + roff, a.l + roff, a.delta + roff, a.dq + off, info & 3,
                    rank * a.chunk, (info & 4) != 0};
}

// visiting block j of entry e, with the rider that travels with it
template <typename T>
struct RbBlock {
  const T* k;
  const T* v;
  const unsigned char* pad;
  float* rider;  // [2, B, C, H, D]: dk, dv
  int k_off;
};

template <typename T>
__device__ __forceinline__ RbBlock<T> rb_block(const RingBwdArgs& a, int e, int j) {
  const int rank = a.step.rank[e];
  const bool ccw = (a.step.info[e] >> (4 + j)) & 1;
  const size_t off = (size_t)rank * a.slot_rs;
  return RbBlock<T>{static_cast<const T*>(ccw ? a.k[1] : a.k[0]) + off,
                    static_cast<const T*>(ccw ? a.v[1] : a.v[0]) + off,
                    (ccw ? a.pad[1] : a.pad[0]) + (size_t)rank * a.batch * a.chunk,
                    (ccw ? a.rider[1] : a.rider[0]) + 2 * off, a.step.src[2 * e + j] * a.chunk};
}

// ---- f32 (a check path): FMA tiles of 64 x 64, 256 threads, one (b, h) per
// block.  For query row `row` of the tile at q0 and key columns lane4 + 4c of
// the tile at k0, p = exp(s - m) / l and ds = p * (dp - delta) (zeroed at
// masked logits), into ps / dss rows.
template <int RT>
__device__ void rb_load_rows(float* rm, float* rl, float* rd, const RbLocal<float>& x,
                             long sr, int b, int h, int H, int C, int q0) {
  for (int t = threadIdx.x; t < RT; t += blockDim.x) {
    const int i = q0 + t;
    const bool in = i < C;
    const size_t ri = (size_t)b * sr + (size_t)i * H + h;
    rm[t] = in ? x.m[ri] : 0.f;
    rl[t] = in ? 1.f / x.l[ri] : 0.f;
    rd[t] = in ? x.delta[ri] : 0.f;
  }
}

template <int DMAX>
__device__ void rb_scores_fma(const RingBwdArgs& a, const RbLocal<float>& x,
                              const RbBlock<float>& kb, const float* rows, const float* qs,
                              const float* dos, const float* ks, const float* vs, float* ps,
                              float* dss, int b, int q0, int k0) {
  using F = RaTile<DMAX>;
  const int D = a.dim, LD = D + 1, C = a.chunk;
  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4, i = q0 + row;
  const float m = rows[row], linv = rows[F::T + row], delta = rows[2 * F::T + row];
#pragma unroll 4
  for (int c = 0; c < F::JC; ++c) {
    const int j = lane4 + 4 * c, kj = k0 + j;
    float p = 0.f, ds = 0.f;
    if (i < C && kj < C) {
      const bool masked = kb.pad[(size_t)b * C + kj] || (a.causal && kb.k_off + kj > x.q_off + i);
      const float s = masked ? RA_NEG_INF : ra_dot(qs + row * LD, ks + j * LD, D);
      p = expf(s - m) * linv;
      ds = masked ? 0.f : p * (ra_dot(dos + row * LD, vs + j * LD, D) - delta);
    }
    if (row < ra_tile_rows<F::T>(C)) {
      if (ps) ps[row * F::PLD + j] = p;
      dss[row * F::PLD + j] = ds;
    }
  }
}

// dK/dV: block (b*h, key tile, pair); thread (key row jr = tid / 4, lane4)
// owns columns lane4 + 4c of dk and dv for its key, and adds them to the
// block's rider.
template <int DMAX>
__global__ void __launch_bounds__(RaTile<DMAX>::THREADS)
    ring_bwd_dkdv_fma_kernel(const __grid_constant__ RingBwdArgs a) {
  using F = RaTile<DMAX>;
  extern __shared__ float ra_smem[];
  const int D = a.dim, LD = D + 1, C = a.chunk, H = a.heads, TR = ra_tile_rows<F::T>(C);
  float* ks = ra_smem;           // [TR][LD]
  float* vs = ks + TR * LD;
  float* qs = vs + TR * LD;
  float* dos = qs + TR * LD;
  float* ps = dos + TR * LD;     // [TR][PLD]
  float* dss = ps + TR * F::PLD;
  float* rows = dss + TR * F::PLD;  // m, 1 / l, delta: [3][T]
  const int pr = a.step.pair[blockIdx.z];
  const RbLocal<float> x = rb_local<float>(a, pr >> 1);
  const RbBlock<float> kb = rb_block<float>(a, pr >> 1, pr & 1);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * F::T;
  const int tid = threadIdx.x, jr = tid / 4, lane4 = tid % 4;
  const long sbk = (long)C * H * D, sr = a.sb / D;

  ra_load_tile<float, F::T>(ks, kb.k, sbk, b, h, k0, D, C, H);
  ra_load_tile<float, F::T>(vs, kb.v, sbk, b, h, k0, D, C, H);
  float dk[F::DC], dv[F::DC];
#pragma unroll
  for (int c = 0; c < F::DC; ++c) dk[c] = dv[c] = 0.f;

  for (int q0 = 0; q0 < C; q0 += F::T) {
    __syncthreads();
    ra_load_tile<float, F::T>(qs, x.q, a.sb, b, h, q0, D, C, H);
    ra_load_tile<float, F::T>(dos, x.dout, a.sb, b, h, q0, D, C, H);
    rb_load_rows<F::T>(rows, rows + F::T, rows + 2 * F::T, x, sr, b, h, H, C, q0);
    __syncthreads();
    rb_scores_fma<DMAX>(a, x, kb, rows, qs, dos, ks, vs, ps, dss, b, q0, k0);
    __syncthreads();
    // query rows past the chunk have p = ds = 0
    const int rn = min(F::T, C - q0);
#pragma unroll
    for (int c = 0; c < F::DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D && k0 + jr < C) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < rn; ++r) {
          sv = fmaf(ps[r * F::PLD + jr], dos[r * LD + d], sv);
          sk = fmaf(dss[r * F::PLD + jr], qs[r * LD + d], sk);
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
    for (int c = 0; c < F::DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) {
        rk[d] += dk[c];
        rv[d] += dv[c];
      }
    }
  }
}

// dQ: block (b*h, query tile, entry); thread (row, lane4) owns columns
// lane4 + 4c of its row's dq, summed over the entry's visiting blocks in
// order, then added to the carry (written at the rank's first live step).
template <int DMAX>
__global__ void __launch_bounds__(RaTile<DMAX>::THREADS)
    ring_bwd_dq_fma_kernel(const __grid_constant__ RingBwdArgs a) {
  using F = RaTile<DMAX>;
  extern __shared__ float ra_smem[];
  const int D = a.dim, LD = D + 1, C = a.chunk, H = a.heads, TR = ra_tile_rows<F::T>(C);
  float* qs = ra_smem;           // [TR][LD]
  float* dos = qs + TR * LD;
  float* ks = dos + TR * LD;
  float* vs = ks + TR * LD;
  float* dss = vs + TR * LD;     // [TR][PLD]
  float* rows = dss + TR * F::PLD;
  const int e = blockIdx.z;
  const RbLocal<float> x = rb_local<float>(a, e);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * F::T;
  const int tid = threadIdx.x, row = tid / 4, lane4 = tid % 4, i = q0 + row;
  const long sbk = (long)C * H * D, sr = a.sb / D;

  ra_load_tile<float, F::T>(qs, x.q, a.sb, b, h, q0, D, C, H);
  ra_load_tile<float, F::T>(dos, x.dout, a.sb, b, h, q0, D, C, H);
  rb_load_rows<F::T>(rows, rows + F::T, rows + 2 * F::T, x, sr, b, h, H, C, q0);
  float dq[F::DC];
#pragma unroll
  for (int c = 0; c < F::DC; ++c) dq[c] = 0.f;

  for (int blk = 0; blk < x.nblk; ++blk) {
    const RbBlock<float> kb = rb_block<float>(a, e, blk);
    for (int k0 = 0; k0 < C; k0 += F::T) {
      __syncthreads();
      ra_load_tile<float, F::T>(ks, kb.k, sbk, b, h, k0, D, C, H);
      ra_load_tile<float, F::T>(vs, kb.v, sbk, b, h, k0, D, C, H);
      __syncthreads();
      rb_scores_fma<DMAX>(a, x, kb, rows, qs, dos, ks, vs, nullptr, dss, b, q0, k0);
      __syncwarp();  // the row's ds was written by the 4 lanes that read it
      const int jn = min(F::T, C - k0);   // ds = 0 past the chunk's edge
#pragma unroll
      for (int c = 0; c < F::DC; ++c) {
        const int d = lane4 + 4 * c;
        if (d < D && i < C) {
          float s = 0.f;
          for (int j = 0; j < jn; ++j) s = fmaf(dss[row * F::PLD + j], ks[j * LD + d], s);
          dq[c] += s;
        }
      }
    }
  }

  if (i < C) {
    float* dqp = x.dq + ra_at(a.sb, b, i, h, H, D);
#pragma unroll
    for (int c = 0; c < F::DC; ++c) {
      const int d = lane4 + 4 * c;
      if (d < D) dqp[d] = x.first ? dq[c] : dqp[d] + dq[c];
    }
  }
}

// ---- bf16: tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32), 4 warps.
// The five products are S = q k^T and dP = dO v^T (recomputed by both
// kernels), dV += p^T dO, dK += ds^T q and dQ += ds k.  q, k, v and dO are
// bf16 inputs, exact as operands; p and ds are f32 values, and the contract
// runs their products in f32: each is fed as a pair hi = bf16(x), lo =
// bf16(x - hi), two products with about 16 bits of mantissa (one bf16
// operand would move dV and dK by up to 2^-9 relative per term).  Every
// 16-deep slice is summed by the tensor core from zero and added in f32
// (the tensor core truncates its own sums).
constexpr int RB_WARPS = 4;
constexpr int RB_THREADS = 32 * RB_WARPS;
constexpr int RB_BLOCKS_PER_SM = 2;

// Head dims up to 128 take the DMAX 128 kernels below; 136-256 take the
// DMAX 256 ones after them, which give each 16 owned rows a pair of warps,
// one for each half of the accumulators' columns.  Each kernel is an
// explicit specialization of a bare declaration, with launch bounds or a
// register cap of its own (__launch_bounds__ and __maxnreg__ do not mix).
// The DMAX 128 kernels' block: its tile of owned rows (grid y) and all dp
// columns.
struct RbCols {
  int yb;  // the block's tile of owned rows
  int c0;  // its first column
  int dp;  // its columns, zero-padded
};

template <int DMAX>
__device__ __forceinline__ RbCols rb_cols(int dp) {
  return RbCols{(int)blockIdx.y, 0, dp};
}

// the tiling of a chunk of C rows at head dim D
struct RbGeom {
  int wq;      // warps per (b, h): each owns 16 rows (dK/dV: keys; dQ: queries)
  int groups;  // (b, h) per block, RB_WARPS / wq
  int own;     // rows a group owns, 16 * wq
  int kt;      // rows of a walked tile: C rounded up to 16, at most 64
  int dp;      // D rounded up to 16 (zero-padded)
  int lds;     // shared row stride in elements, dp + 8 (conflict-free ldmatrix)
  int fixed;   // bytes a group holds for the whole launch (dK/dV: its K and V)
  int stage;   // bytes of one stage of the walked operand, per group
  int nst;     // stages
};

__host__ __device__ __forceinline__ RbGeom rb_geom(int C, int D, bool dkdv) {
  RbGeom g;
  g.wq = C <= 16 ? 1 : C <= 32 ? 2 : RB_WARPS;
  g.groups = RB_WARPS / g.wq;
  g.own = 16 * g.wq;
  const int c16 = (C + 15) / 16 * 16;
  g.kt = c16 < 64 ? c16 : 64;
  g.dp = (D + 15) / 16 * 16;
  g.lds = g.dp + 8;
  const int tile = g.kt * g.lds * 2;  // bytes of one bf16 tile
  if (dkdv) {  // owns K, V; walks q, dO and the rows m, l, delta
    g.fixed = 2 * g.own * g.lds * 2;
    g.stage = (2 * tile + 3 * g.kt * 4 + 15) / 16 * 16;
    g.nst = C > g.kt ? 2 : 1;
  } else {     // walks K, V and the keys' pad bytes
    g.fixed = 0;
    g.stage = (2 * tile + g.kt + 15) / 16 * 16;
    g.nst = 2;
  }
  return g;
}

// dK/dV: block ((b, h) group, key tile of 16 * wq keys, pair).  Warp w owns
// keys kb0 + 16 (w % wq) .. + 15 of its group's (b, h): K and V stay in
// shared memory, dk and dv in registers (accumulators of 16 keys x D), and
// the block walks the query tiles (q, dO, m, l, delta) through two
// cp.async stages.  It computes S^T = k q^T and dP^T = v dO^T, so p^T and
// ds^T come out of the accumulators as the A operands of dV and dK.
// Query tiles wholly before the owned keys add nothing to dk (ds = 0 at
// masked logits), and to dv only through dead rows (m = NEG_INF: p = 1 / l
// at every masked key of a live block): they are skipped up to the first
// tile that holds a dead row of any of the block's (b, h).
template <int DMAX>
__global__ void ring_bwd_dkdv_mma_kernel(const __grid_constant__ RingBwdArgs a);

template <>
__global__ void __launch_bounds__(RB_THREADS, RB_BLOCKS_PER_SM)
    ring_bwd_dkdv_mma_kernel<128>(const __grid_constant__ RingBwdArgs a) {
  constexpr int DMAX = 128;
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rb_smem[];
  __shared__ int first_dead;
  const int C = a.chunk, D = a.dim, H = a.heads;
  const RbGeom g = rb_geom(C, D, true);
  const RbCols cols = rb_cols<DMAX>(g.dp);
  const int pr = a.step.pair[blockIdx.z];
  const RbLocal<T> x = rb_local<T>(a, pr >> 1);
  const RbBlock<T> kb = rb_block<T>(a, pr >> 1, pr & 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int grp = warp / g.wq;
  const int gtid = threadIdx.x - grp * 32 * g.wq, gthreads = 32 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;  // the last block's groups may be idle
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int kb0 = cols.yb * g.own;              // the block's first key
  const int kw = 16 * (warp % g.wq);            // the warp's keys in the owned tile
  const int nd = g.dp / 8, ntq = (C + g.kt - 1) / g.kt;
  const long sbk = (long)C * H * D, sr = a.sb / D;
  unsigned char* gsm = rb_smem + (size_t)grp * (g.fixed + g.nst * g.stage);
  T* ks = reinterpret_cast<T*>(gsm);
  T* vs = ks + g.own * g.lds;
  unsigned char* stg = gsm + g.fixed;
  const int mi = lane / 8, lr8 = lane % 8;
  const T zero = __float2bfloat16_rn(0.f);

  // the owned K and V, zeros past the chunk and the dim
  if (active) {
    for (int c = gtid; c < g.own * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = kb0 + r;
      const int valid = kj < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = kj < C ? ra_at(sbk, b, kj, h, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, kb.k + off, valid, zero);
      rf_load16(vs + r * g.lds + d0, kb.v + off, valid, zero);
    }
  }
  rf_commit();
  // the warp's keys kb0 + kw + gr + 8y: in the chunk, and padded
  bool kin[2], kpad[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int kj = kb0 + kw + gr + 8 * y;
    kin[y] = active && kj < C;
    kpad[y] = kin[y] && kb.pad[(size_t)b * C + kj];
  }

  // causal: query rows i < lim see none of the block's keys
  int qstart = 0;
  if (a.causal) {
    const int lim = kb.k_off + kb0 - x.q_off;
    const int blind = lim >= C ? ntq : max(0, lim / g.kt);  // tiles wholly before
    if (blind > 0) {
      if (threadIdx.x == 0) first_dead = blind * g.kt;
      __syncthreads();
      const int rows = min(C, blind * g.kt);
      int fd = rows;
      if (active) {
        for (int i = gtid; i < rows; i += gthreads)
          if (x.m[(size_t)b * sr + (size_t)i * H + h] <= 0.5f * RA_NEG_INF) {
            fd = i;
            break;
          }
      }
      if (fd < rows) atomicMin(&first_dead, fd);
      __syncthreads();
      qstart = first_dead / g.kt;
    }
  }

  // query tile t into stage st: q and dO rows, and the rows' m, l, delta
  // (l = 1 and the rest 0 past the chunk)
  auto load = [&](int t, int st) {
    if (!active) return;
    const int q0 = t * g.kt;
    T* qs = reinterpret_cast<T*>(stg + (size_t)st * g.stage);
    T* os = qs + g.kt * g.lds;
    float* rm = reinterpret_cast<float*>(os + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, i = q0 + r;
      const int valid = i < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = i < C ? ra_at(a.sb, b, i, h, H, D) + d0 : 0;
      rf_load16(qs + r * g.lds + d0, x.q + off, valid, zero);
      rf_load16(os + r * g.lds + d0, x.dout + off, valid, zero);
    }
    for (int r = gtid; r < g.kt; r += gthreads) {
      const int i = q0 + r;
      if (i < C) {
        const size_t ri = (size_t)b * sr + (size_t)i * H + h;
        rb_load4(rm + r, x.m + ri);
        rb_load4(rm + g.kt + r, x.l + ri);
        rb_load4(rm + 2 * g.kt + r, x.delta + ri);
      } else {
        rm[r] = 0.f;
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

    if (active) {
      const int q0 = t * g.kt;
      const T* qs = reinterpret_cast<const T*>(stg + (size_t)st * g.stage);
      const T* os = qs + g.kt * g.lds;
      const float* rm = reinterpret_cast<const float*>(os + g.kt * g.lds);
      const float* rl = rm + g.kt;
      const float* rd = rl + g.kt;
#pragma unroll 1
      for (int qc = 0; qc < g.kt / 16 && q0 + 16 * qc < C; ++qc) {
        // S^T and dP^T: the warp's 16 keys x 16 queries
        float s[2][4] = {}, dpv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) {
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
            const int ii = 16 * qc + 8 * jn + 2 * tq + (c & 1), i = q0 + ii;
            float p = 0.f, ds = 0.f;
            if (kin[y] && i < C) {
              const bool masked = kpad[y] || (a.causal && kb.k_off + kj > x.q_off + i);
              p = expf((masked ? RA_NEG_INF : s[jn][c]) - rm[ii]) * (1.f / rl[ii]);
              if (!masked) ds = p * (dpv[jn][c] - rd[ii]);
            }
            s[jn][c] = p;
            dpv[jn][c] = ds;
          }
        }
        uint32_t hi[4], lo[4];
        rb_split(s, hi, lo);
        rb_mma_pair(dv, hi, lo, os + 16 * qc * g.lds + cols.c0, g.lds, cols.dp, lane);
        rb_split(dpv, hi, lo);
        rb_mma_pair(dk, hi, lo, qs + 16 * qc * g.lds + cols.c0, g.lds, cols.dp, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // add to the rider (one block owns these keys in this launch)
  float* rk = kb.rider;
  float* rv = rk + (size_t)a.batch * sbk;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    if (!kin[y]) continue;
    const size_t off = ra_at(sbk, b, kb0 + kw + gr + 8 * y, h, H, D);
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = cols.c0 + 8 * n + 2 * tq;
      if (d + 1 < D && D % 2 == 0) {
        float2* pk = reinterpret_cast<float2*>(rk + off + d);
        float2* pv = reinterpret_cast<float2*>(rv + off + d);
        const float2 ok = *pk, ov = *pv;
        *pk = make_float2(ok.x + dk[n][2 * y], ok.y + dk[n][2 * y + 1]);
        *pv = make_float2(ov.x + dv[n][2 * y], ov.y + dv[n][2 * y + 1]);
      } else {
        if (d < D) {
          rk[off + d] += dk[n][2 * y];
          rv[off + d] += dv[n][2 * y];
        }
        if (d + 1 < D) {
          rk[off + d + 1] += dk[n][2 * y + 1];
          rv[off + d + 1] += dv[n][2 * y + 1];
        }
      }
    }
  }
}

// dQ: block ((b, h) group, 16 * wq query rows, entry).  Warp w owns query
// rows r0 .. r0 + 15 of its group's (b, h): q and dO as A fragments and dq
// (16 rows x D) in registers; the block walks the key tiles of the entry's
// visiting blocks in order (K, V and the keys' pads) through two cp.async
// stages.  Key tiles wholly after the block's last row add nothing (ds = 0
// at masked logits) and are not walked.
template <int DMAX>
__global__ void ring_bwd_dq_mma_kernel(const __grid_constant__ RingBwdArgs a);

template <>
__global__ void __launch_bounds__(RB_THREADS, RB_BLOCKS_PER_SM)
    ring_bwd_dq_mma_kernel<128>(const __grid_constant__ RingBwdArgs a) {
  constexpr int DMAX = 128;
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rb_smem[];
  const int C = a.chunk, D = a.dim, H = a.heads, e = blockIdx.z;
  const RbGeom g = rb_geom(C, D, false);
  const RbCols cols = rb_cols<DMAX>(g.dp);
  const RbLocal<T> x = rb_local<T>(a, e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int grp = warp / g.wq;
  const int gtid = threadIdx.x - grp * 32 * g.wq, gthreads = 32 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int qb = cols.yb * g.own;                  // the block's first query row
  const int r0 = qb + 16 * (warp % g.wq);          // the warp's
  const int qlast = min(C, qb + g.own) - 1;        // the block's last row in the chunk
  const int nd = g.dp / 8, ntk = (C + g.kt - 1) / g.kt;
  const long sbk = (long)C * H * D, sr = a.sb / D;
  unsigned char* gsm = rb_smem + (size_t)grp * g.nst * g.stage;
  const int mi = lane / 8, lr8 = lane % 8;
  const T zero = __float2bfloat16_rn(0.f);

  // q and dO rows r0 + gr and + 8 as A fragments, zero past the chunk and the dim
  uint32_t qf[DMAX / 16][4], of[DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < g.dp / 16) {
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = r0 + gr + 8 * (y & 1), d = 16 * kk + 8 * (y >> 1) + 2 * tq;
        float q0 = 0.f, q1 = 0.f, o0 = 0.f, o1 = 0.f;
        if (active && i < C) {
          const size_t off = ra_at(a.sb, b, i, h, H, D);
          if (d < D) {
            q0 = __bfloat162float(x.q[off + d]);
            o0 = __bfloat162float(x.dout[off + d]);
          }
          if (d + 1 < D) {
            q1 = __bfloat162float(x.q[off + d + 1]);
            o1 = __bfloat162float(x.dout[off + d + 1]);
          }
        }
        qf[kk][y] = rf_pack(q0, q1);
        of[kk][y] = rf_pack(o0, o1);
      }
    }
  }
  // the rows' m, 1 / l and delta
  float mrow[2], lrow[2], drow[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    mrow[y] = lrow[y] = drow[y] = 0.f;
    if (active && i < C) {
      const size_t ri = (size_t)b * sr + (size_t)i * H + h;
      mrow[y] = x.m[ri];
      lrow[y] = 1.f / x.l[ri];
      drow[y] = x.delta[ri];
    }
  }

  // the key tiles of block j that are not wholly after the block's rows
  auto live = [&](int j) {
    if (!a.causal) return ntk;
    const int lim = x.q_off + qlast - a.step.src[2 * e + j] * C;
    return lim < 0 ? 0 : min(ntk, lim / g.kt + 1);
  };
  const int n0 = live(0), nt = n0 + (x.nblk > 1 ? live(1) : 0);

  // tile t (block t < n0 ? 0 : 1) into stage st: K, V and the keys' pad
  // bytes (1 past the chunk's edge)
  auto load = [&](int t, int st) {
    if (!active) return;
    const int j = t < n0 ? 0 : 1, k0 = (t < n0 ? t : t - n0) * g.kt;
    const RbBlock<T> kb = rb_block<T>(a, e, j);
    T* ks = reinterpret_cast<T*>(gsm + (size_t)st * g.stage);
    T* vs = ks + g.kt * g.lds;
    unsigned char* ps = reinterpret_cast<unsigned char*>(vs + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = k0 + r;
      const int valid = kj < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = kj < C ? ra_at(sbk, b, kj, h, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, kb.k + off, valid, zero);
      rf_load16(vs + r * g.lds + d0, kb.v + off, valid, zero);
    }
    for (int c = gtid; c < g.kt / 16; c += gthreads) {
      const int kj = k0 + 16 * c;
      rf_load16(ps + 16 * c, kb.pad + (size_t)b * C + kj, max(0, min(16, C - kj)),
                (unsigned char)1);
    }
  };

  float dq[MMA_DT][4];
#pragma unroll
  for (int n = 0; n < MMA_DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  if (nt > 0) load(0, 0);
  rf_commit();
  for (int t = 0, st = 0; t < nt; ++t, st ^= 1) {
    if (t + 1 < nt) load(t + 1, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t has landed
    __syncthreads();

    if (active) {
      const int k0 = (t < n0 ? t : t - n0) * g.kt;
      const int k_off = a.step.src[2 * e + (t < n0 ? 0 : 1)] * C;
      const T* ks = reinterpret_cast<const T*>(gsm + (size_t)st * g.stage);
      const T* vs = ks + g.kt * g.lds;
      const unsigned char* ps = reinterpret_cast<const unsigned char*>(vs + g.kt * g.lds);
#pragma unroll 1
      for (int kc = 0; kc < g.kt / 16 && k0 + 16 * kc < C; ++kc) {
        // S and dP: the warp's 16 rows x 16 keys
        float s[2][4] = {}, dpv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk) {
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
            const int jj = 16 * kc + 8 * jn + 2 * tq + (c & 1), kj = k0 + jj;
            float ds = 0.f;
            if (kj < C && i < C && !ps[jj] && !(a.causal && k_off + kj > x.q_off + i))
              ds = expf(s[jn][c] - mrow[y]) * lrow[y] * (dpv[jn][c] - drow[y]);
            s[jn][c] = ds;
          }
        }
        uint32_t hi[4], lo[4];
        rb_split(s, hi, lo);
        rb_mma_pair(dq, hi, lo, ks + 16 * kc * g.lds + cols.c0, g.lds, cols.dp, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (!active) return;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    if (i >= C) continue;  // rows past the chunk belong to the next rank
    float* p = x.dq + ra_at(a.sb, b, i, h, H, D);
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = cols.c0 + 8 * n + 2 * tq;
      if (d < D) p[d] = x.first ? dq[n][2 * y] : p[d] + dq[n][2 * y];
      if (d + 1 < D) p[d + 1] = x.first ? dq[n][2 * y + 1] : p[d + 1] + dq[n][2 * y + 1];
    }
  }
}

// ---- head dims 136-256: ring_bwd_dkdv_mma_kernel<256>, ring_bwd_dq_mma_kernel<256>
// The kernels above, at DMAX 256, would hold 16 rows x 256 columns of
// accumulators a warp.  Here each 16 owned rows (dK/dV: keys; dQ: query
// rows) are served by a PAIR of warps of one block (warp 2 rt + half), one
// for each half of the accumulators' columns (pair_cols: 128 each at Dh
// 256), as the forward does.  A block of 4 warps holds two row tiles: two
// (b, h) of 16 rows (C <= 16) or one (b, h) and 32 rows (C <= 32); longer
// chunks take blocks of 8 warps, one (b, h) and 64 rows.
//  - The owned rows (dK/dV: K and V; dQ: q and dO) and each walked stage
//    are loaded once per group, for both halves; q and dO are read by
//    ldmatrix, not held as fragments.
//  - S^T and dP^T (dQ: S and dP) are computed once per pair: warp `half`
//    takes the 8-wide column slices half + 2 i of the walked tile, each
//    element summed over every 16-deep slice of the head dim, each slice
//    from zero on the tensor cores, added in f32 in order, as above.
//  - Each warp turns its slice into p^T and ds^T (ds), rounds it to the hi
//    and lo bf16 words of the A operand (rb_split8), and the pair swaps
//    them through shared memory at its named barrier (pair_put, two
//    buffers used in turn); each warp then runs the products of the whole
//    16 x 16 tile over its own columns, as above (rb_mma_pair).  So dk, dv
//    and dq are the arithmetic of the kernels above, bit for bit.
//  - A group holds its owned rows, its pairs' exchange buffers and its
//    first stage; the second stages follow all groups and are allocated
//    only when a launch may walk more than one tile (ring_bwd_kernels).
//    At C 5 a group takes 38,080 bytes (dK/dV) or 35,856 (dQ, one stage),
//    room for 3 blocks an SM, and 2 for a dQ launch with two stages (52,768
//    bytes); from C 33 on, one 8-warp block an SM.
//  - dQ's registers are capped at 168 a thread, so that 3 blocks of 4
//    warps share an SM (__maxnreg__: the 8-warp blocks need 256 threads);
//    it uses 151.  dK/dV holds 128 f32 accumulators a thread (dk and dv):
//    capped at 168 it spilled 112 bytes, uncapped it takes 213 registers
//    and spills none, so it runs uncapped, 2 blocks of 4 warps an SM (ptxas
//    on the card, NVIDIA H100 80GB HBM3).
constexpr int RBS_DQ_MAX_REGS = 168;

struct RbsGeom {
  int wq;      // row tiles of 16 per (b, h) in a block, each a pair of warps: 1, 2 or 4
  int tiles;   // row tiles of a block: 2, or 4 (wq 4: blocks of 8 warps)
  int groups;  // (b, h) per block, tiles / wq
  int own;     // rows a group owns, 16 * wq
  int kt, dp, lds, stage;  // as RbGeom
  int fixed;   // bytes of the owned rows: two bf16 tiles (dK/dV: K, V; dQ: q, dO)
  int xch;     // bytes of the group's exchange buffers: 2 per pair, [2][N][32] uint4
  int gbytes;  // bytes of a group: fixed, xch, one stage
};

__host__ __device__ __forceinline__ RbsGeom rbs_geom(int C, int D, bool dkdv) {
  const RbGeom f = rb_geom(C, D, dkdv);
  RbsGeom g;
  g.wq = C <= 16 ? 1 : C <= 32 ? 2 : 4;
  g.tiles = g.wq == 4 ? 4 : 2;
  g.groups = g.tiles / g.wq;
  g.own = 16 * g.wq;
  g.kt = f.kt;
  g.dp = f.dp;
  g.lds = f.lds;
  g.stage = f.stage;
  g.fixed = 2 * g.own * g.lds * 2;
  g.xch = g.wq * 2 * 2 * (dkdv ? 2 : 1) * 32 * 16;  // dK/dV swaps p^T and ds^T, dQ ds
  g.gbytes = g.fixed + g.xch + g.stage;
  return g;
}

template <>
__global__ void ring_bwd_dkdv_mma_kernel<256>(const __grid_constant__ RingBwdArgs a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rb_smem[];
  __shared__ int first_dead;
  const int C = a.chunk, D = a.dim, H = a.heads;
  const RbsGeom g = rbs_geom(C, D, true);
  const int pr = a.step.pair[blockIdx.z];
  const RbLocal<T> x = rb_local<T>(a, pr >> 1);
  const RbBlock<T> kb = rb_block<T>(a, pr >> 1, pr & 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int rt = warp / 2, half = warp % 2;     // the warp's tile of 16 keys and column half
  const int grp = rt / g.wq;
  const int gtid = threadIdx.x - grp * 64 * g.wq, gthreads = 64 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;  // the last block's groups may be idle
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int kb0 = blockIdx.y * g.own;           // the block's first key
  const int kw = 16 * (rt % g.wq);              // the tile's keys in the owned rows
  const int nd = g.dp / 8, ntq = (C + g.kt - 1) / g.kt;
  const long sbk = (long)C * H * D, sr = a.sb / D;
  const PairCols cols = pair_cols(g.dp, half);
  unsigned char* gsm = rb_smem + (size_t)grp * g.gbytes;
  T* ks = reinterpret_cast<T*>(gsm);
  T* vs = ks + g.own * g.lds;
  uint4* xb = reinterpret_cast<uint4*>(gsm + g.fixed) + (rt % g.wq) * 2 * 2 * 2 * 32;
  unsigned char* stg0 = gsm + g.fixed + g.xch;
  unsigned char* stg1 = rb_smem + (size_t)g.groups * g.gbytes + (size_t)grp * g.stage;
  const int mi = lane / 8, lr8 = lane % 8;
  const T zero = __float2bfloat16_rn(0.f);

  // the owned K and V, zeros past the chunk and the dim
  if (active) {
    for (int c = gtid; c < g.own * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = kb0 + r;
      const int valid = kj < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = kj < C ? ra_at(sbk, b, kj, h, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, kb.k + off, valid, zero);
      rf_load16(vs + r * g.lds + d0, kb.v + off, valid, zero);
    }
  }
  rf_commit();
  // the tile's keys kb0 + kw + gr + 8y: in the chunk, and padded
  bool kin[2], kpad[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int kj = kb0 + kw + gr + 8 * y;
    kin[y] = active && kj < C;
    kpad[y] = kin[y] && kb.pad[(size_t)b * C + kj];
  }

  // causal: query rows i < lim see none of the block's keys (as above)
  int qstart = 0;
  if (a.causal) {
    const int lim = kb.k_off + kb0 - x.q_off;
    const int blind = lim >= C ? ntq : max(0, lim / g.kt);  // tiles wholly before
    if (blind > 0) {
      if (threadIdx.x == 0) first_dead = blind * g.kt;
      __syncthreads();
      const int rows = min(C, blind * g.kt);
      int fd = rows;
      if (active) {
        for (int i = gtid; i < rows; i += gthreads)
          if (x.m[(size_t)b * sr + (size_t)i * H + h] <= 0.5f * RA_NEG_INF) {
            fd = i;
            break;
          }
      }
      if (fd < rows) atomicMin(&first_dead, fd);
      __syncthreads();
      qstart = first_dead / g.kt;
    }
  }

  // query tile t into stage st: q and dO rows, and the rows' m, l, delta
  // (l = 1 and the rest 0 past the chunk)
  auto load = [&](int t, int st) {
    if (!active) return;
    const int q0 = t * g.kt;
    T* qs = reinterpret_cast<T*>(st ? stg1 : stg0);
    T* os = qs + g.kt * g.lds;
    float* rm = reinterpret_cast<float*>(os + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, i = q0 + r;
      const int valid = i < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = i < C ? ra_at(a.sb, b, i, h, H, D) + d0 : 0;
      rf_load16(qs + r * g.lds + d0, x.q + off, valid, zero);
      rf_load16(os + r * g.lds + d0, x.dout + off, valid, zero);
    }
    for (int r = gtid; r < g.kt; r += gthreads) {
      const int i = q0 + r;
      if (i < C) {
        const size_t ri = (size_t)b * sr + (size_t)i * H + h;
        rb_load4(rm + r, x.m + ri);
        rb_load4(rm + g.kt + r, x.l + ri);
        rb_load4(rm + 2 * g.kt + r, x.delta + ri);
      } else {
        rm[r] = 0.f;
        rm[g.kt + r] = 1.f;
        rm[2 * g.kt + r] = 0.f;
      }
    }
  };

  // dk and dv of keys kb0 + kw + gr + 8y over the warp's columns:
  // dk[n][2y + c] is column cols.c0 + 8n + 2tq + c
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

    if (active) {
      const int q0 = t * g.kt;
      const T* qs = reinterpret_cast<const T*>(st ? stg1 : stg0);
      const T* os = qs + g.kt * g.lds;
      const float* rm = reinterpret_cast<const float*>(os + g.kt * g.lds);
      const float* rl = rm + g.kt;
      const float* rd = rl + g.kt;
#pragma unroll 1
      for (int qc = 0; qc < g.kt / 16 && q0 + 16 * qc < C; ++qc) {
        // S^T and dP^T: the tile's 16 keys x the warp's 8 queries qw ..
        const int qw = 16 * qc + 8 * half;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < RA_DMAX / 16; ++kk) {
          if (kk < g.dp / 16) {
            uint32_t af[4];
            rf_ldsm(af, ks + (kw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
            rb_scores8(s, af, qs + qw * g.lds + 16 * kk, g.lds, lane);
            rf_ldsm(af, vs + (kw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
            rb_scores8(dpv, af, os + qw * g.lds + 16 * kk, g.lds, lane);
          }
        }
        // p^T and ds^T: key kb0 + kw + gr + 8 (c >> 1), query column ii
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = c >> 1, kj = kb0 + kw + gr + 8 * y;
          const int ii = qw + 2 * tq + (c & 1), i = q0 + ii;
          float p = 0.f, ds = 0.f;
          if (kin[y] && i < C) {
            const bool masked = kpad[y] || (a.causal && kb.k_off + kj > x.q_off + i);
            p = expf((masked ? RA_NEG_INF : s[c]) - rm[ii]) * (1.f / rl[ii]);
            if (!masked) ds = p * (dpv[c] - rd[ii]);
          }
          s[c] = p;
          dpv[c] = ds;
        }
        // the pair swaps its slices; dV += p^T dO and dK += ds^T q over the
        // warp's columns, the whole 16 x 16 tile as A
        const uint4 mine[2] = {rb_split8(s), rb_split8(dpv)};
        uint4* xp = xb + (qc & 1) * 2 * 2 * 32;
        pair_put<2>(xp, mine, half, lane, rt);
        uint32_t hi[4], lo[4];
        pair_tile_a(hi, lo, mine[0], pair_theirs<2>(xp, 0, half, lane), half);
        rb_mma_pair(dv, hi, lo, os + 16 * qc * g.lds + cols.c0, g.lds, cols.cw, lane);
        pair_tile_a(hi, lo, mine[1], pair_theirs<2>(xp, 1, half, lane), half);
        rb_mma_pair(dk, hi, lo, qs + 16 * qc * g.lds + cols.c0, g.lds, cols.cw, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st and the exchange before refills
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // add to the rider over the warp's columns (one block owns these keys)
  float* rk = kb.rider;
  float* rv = rk + (size_t)a.batch * sbk;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    if (!kin[y]) continue;
    const size_t off = ra_at(sbk, b, kb0 + kw + gr + 8 * y, h, H, D);
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = cols.c0 + 8 * n + 2 * tq;
      if (8 * n >= cols.cw) continue;
      if (d + 1 < D && D % 2 == 0) {
        float2* pk = reinterpret_cast<float2*>(rk + off + d);
        float2* pv = reinterpret_cast<float2*>(rv + off + d);
        const float2 ok = *pk, ov = *pv;
        *pk = make_float2(ok.x + dk[n][2 * y], ok.y + dk[n][2 * y + 1]);
        *pv = make_float2(ov.x + dv[n][2 * y], ov.y + dv[n][2 * y + 1]);
      } else {
        if (d < D) {
          rk[off + d] += dk[n][2 * y];
          rv[off + d] += dv[n][2 * y];
        }
        if (d + 1 < D) {
          rk[off + d + 1] += dk[n][2 * y + 1];
          rv[off + d + 1] += dv[n][2 * y + 1];
        }
      }
    }
  }
}

template <>
__global__ void __maxnreg__(RBS_DQ_MAX_REGS)
    ring_bwd_dq_mma_kernel<256>(const __grid_constant__ RingBwdArgs a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char rb_smem[];
  const int C = a.chunk, D = a.dim, H = a.heads, e = blockIdx.z;
  const RbsGeom g = rbs_geom(C, D, false);
  const RbLocal<T> x = rb_local<T>(a, e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
  const int rt = warp / 2, half = warp % 2;     // the warp's row tile and column half
  const int grp = rt / g.wq;
  const int gtid = threadIdx.x - grp * 64 * g.wq, gthreads = 64 * g.wq;
  const int bh = blockIdx.x * g.groups + grp;
  const bool active = bh < a.batch * H;
  const int b = active ? bh / H : 0, h = active ? bh % H : 0;
  const int qb = blockIdx.y * g.own;               // the group's first query row
  const int rw = 16 * (rt % g.wq);                 // the tile's first row in the group
  const int r0 = qb + rw;
  const int qlast = min(C, qb + g.own) - 1;        // the block's last row in the chunk
  const int nd = g.dp / 8, ntk = (C + g.kt - 1) / g.kt;
  const long sbk = (long)C * H * D, sr = a.sb / D;
  const PairCols cols = pair_cols(g.dp, half);
  unsigned char* gsm = rb_smem + (size_t)grp * g.gbytes;
  T* qs = reinterpret_cast<T*>(gsm);                          // [own][lds] q
  T* os = qs + g.own * g.lds;                                 // [own][lds] dO
  uint4* xb = reinterpret_cast<uint4*>(gsm + g.fixed) + (rt % g.wq) * 2 * 2 * 32;
  unsigned char* stg0 = gsm + g.fixed + g.xch;
  unsigned char* stg1 = rb_smem + (size_t)g.groups * g.gbytes + (size_t)grp * g.stage;
  const int mi = lane / 8, lr8 = lane % 8;
  const T zero = __float2bfloat16_rn(0.f);

  // the group's q and dO rows, zeros past the chunk and the dim (in the
  // first tile's cp.async group)
  if (active) {
    for (int c = gtid; c < g.own * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, i = qb + r;
      const int valid = i < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = i < C ? ra_at(a.sb, b, i, h, H, D) + d0 : 0;
      rf_load16(qs + r * g.lds + d0, x.q + off, valid, zero);
      rf_load16(os + r * g.lds + d0, x.dout + off, valid, zero);
    }
  }
  // the rows' m, 1 / l and delta
  float mrow[2], lrow[2], drow[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    mrow[y] = lrow[y] = drow[y] = 0.f;
    if (active && i < C) {
      const size_t ri = (size_t)b * sr + (size_t)i * H + h;
      mrow[y] = x.m[ri];
      lrow[y] = 1.f / x.l[ri];
      drow[y] = x.delta[ri];
    }
  }

  // the key tiles of block j that are not wholly after the block's rows
  auto live = [&](int j) {
    if (!a.causal) return ntk;
    const int lim = x.q_off + qlast - a.step.src[2 * e + j] * C;
    return lim < 0 ? 0 : min(ntk, lim / g.kt + 1);
  };
  const int n0 = live(0), nt = n0 + (x.nblk > 1 ? live(1) : 0);

  // tile t (block t < n0 ? 0 : 1) into stage st: K, V and the keys' pad
  // bytes (1 past the chunk's edge)
  auto load = [&](int t, int st) {
    if (!active) return;
    const int j = t < n0 ? 0 : 1, k0 = (t < n0 ? t : t - n0) * g.kt;
    const RbBlock<T> kb = rb_block<T>(a, e, j);
    T* ks = reinterpret_cast<T*>(st ? stg1 : stg0);
    T* vs = ks + g.kt * g.lds;
    unsigned char* ps = reinterpret_cast<unsigned char*>(vs + g.kt * g.lds);
    for (int c = gtid; c < g.kt * nd; c += gthreads) {
      const int r = c / nd, d0 = (c % nd) * 8, kj = k0 + r;
      const int valid = kj < C ? max(0, min(8, D - d0)) : 0;
      const size_t off = kj < C ? ra_at(sbk, b, kj, h, H, D) + d0 : 0;
      rf_load16(ks + r * g.lds + d0, kb.k + off, valid, zero);
      rf_load16(vs + r * g.lds + d0, kb.v + off, valid, zero);
    }
    for (int c = gtid; c < g.kt / 16; c += gthreads) {
      const int kj = k0 + 16 * c;
      rf_load16(ps + 16 * c, kb.pad + (size_t)b * C + kj, max(0, min(16, C - kj)),
                (unsigned char)1);
    }
  };

  // dq of rows r0 + gr + 8y over the warp's columns: dq[n][2y + c] is
  // column cols.c0 + 8n + 2tq + c
  float dq[MMA_DT][4];
#pragma unroll
  for (int n = 0; n < MMA_DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  if (nt > 0) load(0, 0);
  rf_commit();
  for (int t = 0, st = 0; t < nt; ++t, st ^= 1) {
    if (t + 1 < nt) load(t + 1, st ^ 1);
    rf_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tile t (and q, dO) landed
    __syncthreads();

    if (active) {
      const int k0 = (t < n0 ? t : t - n0) * g.kt;
      const int k_off = a.step.src[2 * e + (t < n0 ? 0 : 1)] * C;
      const T* ks = reinterpret_cast<const T*>(st ? stg1 : stg0);
      const T* vs = ks + g.kt * g.lds;
      const unsigned char* ps = reinterpret_cast<const unsigned char*>(vs + g.kt * g.lds);
#pragma unroll 1
      for (int kc = 0; kc < g.kt / 16 && k0 + 16 * kc < C; ++kc) {
        // S and dP: the tile's 16 rows x the warp's 8 keys kw ..
        const int kw = 16 * kc + 8 * half;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < RA_DMAX / 16; ++kk) {
          if (kk < g.dp / 16) {
            uint32_t af[4];
            rf_ldsm(af, qs + (rw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
            rb_scores8(s, af, ks + kw * g.lds + 16 * kk, g.lds, lane);
            rf_ldsm(af, os + (rw + 8 * (mi & 1) + lr8) * g.lds + 16 * kk + 8 * (mi >> 1));
            rb_scores8(dpv, af, vs + kw * g.lds + 16 * kk, g.lds, lane);
          }
        }
        // ds: row r0 + gr + 8 (c >> 1), key column jj
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = c >> 1, i = r0 + gr + 8 * y;
          const int jj = kw + 2 * tq + (c & 1), kj = k0 + jj;
          float ds = 0.f;
          if (kj < C && i < C && !ps[jj] && !(a.causal && k_off + kj > x.q_off + i))
            ds = expf(s[c] - mrow[y]) * lrow[y] * (dpv[c] - drow[y]);
          s[c] = ds;
        }
        // the pair swaps its slices; dQ += ds k over the warp's columns
        const uint4 mine[1] = {rb_split8(s)};
        uint4* xp = xb + (kc & 1) * 2 * 32;
        pair_put<1>(xp, mine, half, lane, rt);
        uint32_t hi[4], lo[4];
        pair_tile_a(hi, lo, mine[0], pair_theirs<1>(xp, 0, half, lane), half);
        rb_mma_pair(dq, hi, lo, ks + 16 * kc * g.lds + cols.c0, g.lds, cols.cw, lane);
      }
    }
    __syncthreads();  // every warp is done with stage st and the exchange before refills
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (!active) return;
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int i = r0 + gr + 8 * y;
    if (i >= C) continue;  // rows past the chunk belong to the next rank
    float* p = x.dq + ra_at(a.sb, b, i, h, H, D);
#pragma unroll
    for (int n = 0; n < MMA_DT; ++n) {
      const int d = cols.c0 + 8 * n + 2 * tq;
      if (8 * n >= cols.cw) continue;
      if (d < D) p[d] = x.first ? dq[n][2 * y] : p[d] + dq[n][2 * y];
      if (d + 1 < D) p[d + 1] = x.first ? dq[n][2 * y + 1] : p[d + 1] + dq[n][2 * y + 1];
    }
  }
}

// dq, dk and dv of every rank in T from the f32 dq carry and the landed
// riders (the two-way ring sums clockwise + counter-clockwise, in that
// order), one thread per element
template <typename T>
__global__ void ring_land_kernel(const __grid_constant__ RingBwdArgs a) {
  const long per_b = (long)a.chunk * a.heads * a.dim, per_r = a.batch * per_b;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.ranks * per_r) return;
  const long r = e / per_r, rem = e % per_r;
  const size_t li = (size_t)r * a.rs + (size_t)(rem / per_b) * a.sb + rem % per_b;
  const size_t hi = (size_t)r * 2 * per_r + rem;
  static_cast<T*>(a.dq_out)[li] = from_f<T>(a.dq[li]);
  const float* r0 = a.ret[0];
  const float* r1 = a.ret[1];
  const float dk = r1 ? r0[hi] + r1[hi] : r0[hi];
  const float dv = r1 ? r0[hi + per_r] + r1[hi + per_r] : r0[hi + per_r];
  static_cast<T*>(a.dk)[li] = from_f<T>(dk);
  static_cast<T*>(a.dv)[li] = from_f<T>(dv);
}

// ---------------------------------------------------------------------------
// The largest dynamic shared memory each kernel was allowed so far, per
// device: cudaFuncSetAttribute (a host call of its own) runs once per kernel
// and size, not once per launch.  A kernel's DMAX 256 instantiation has a
// slot of its own (`rs_slot`).
constexpr int RF_DEVICES = 16;
enum RingSmemSlot { RS_FWD_MMA, RS_FWD_FMA, RS_DKDV_MMA, RS_DQ_MMA, RS_DKDV_FMA, RS_DQ_FMA,
                    RS_SLOTS };

template <int DMAX>
constexpr int rs_slot(RingSmemSlot which) {
  return DMAX > 128 ? RS_SLOTS + which : which;
}

template <typename Kernel>
static cudaError_t rf_allow_smem(Kernel kernel, int slot, size_t bytes) {
  static int allowed[RF_DEVICES][2 * RS_SLOTS] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  BVQ_TRY(cudaGetDevice(&dev));
  if (dev < RF_DEVICES && (int)bytes <= allowed[dev][slot]) return cudaSuccess;
  BVQ_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes));
  if (dev < RF_DEVICES) allowed[dev][slot] = (int)bytes;
  return cudaSuccess;
}

template <int DMAX>
static cudaError_t ring_fwd_kernels(const RingFwdArgs& a, cudaStream_t s) {
  const int C = a.chunk, D = a.dim, n = a.step.nent, bh = a.batch * a.heads;
  if (a.act_bf16) {
    size_t smem;
    dim3 grid;
    int threads = RF_THREADS;
    if constexpr (DMAX > 128) {
      // the groups, then their second stages where an entry walks two tiles
      const RsGeom g = rs_geom(C, D);
      int walk = 0;
      for (int e = 0; e < n; ++e) walk = max(walk, (a.step.info[e] & 3) * cdiv(C, g.kt));
      smem = (size_t)g.groups * (g.gbytes + (walk > 1 ? g.stage : 0));
      grid = dim3(cdiv(bh, g.groups), cdiv(C, g.own), n);
      threads = 64 * g.tiles;
    } else {
      const RfGeom g = rf_geom(C, D);
      smem = (size_t)g.groups * 2 * g.stage;
      grid = dim3(cdiv(bh, g.groups), cdiv(C, 16 * g.wq), n);
    }
    BVQ_TRY(rf_allow_smem(ring_fwd_mma_kernel<DMAX>, rs_slot<DMAX>(RS_FWD_MMA), smem));
    ring_fwd_mma_kernel<DMAX><<<grid, threads, smem, s>>>(a);
  } else {
    using F = RaTile<DMAX>;
    const size_t tr = ra_tile_rows<F::T>(C);
    const size_t smem = (3 * tr * (D + 1) + tr * F::PLD) * sizeof(float);
    BVQ_TRY(rf_allow_smem(ring_fwd_fma_kernel<DMAX>, rs_slot<DMAX>(RS_FWD_FMA), smem));
    const dim3 grid(bh, cdiv(C, F::T), n);
    ring_fwd_fma_kernel<DMAX><<<grid, F::THREADS, smem, s>>>(a);
  }
  return cudaGetLastError();
}

// head dims up to 128 on the DMAX 128 kernels, 136-256 on the DMAX 256 ones
static cudaError_t ring_fwd_launch(const RingFwdArgs& a, cudaStream_t s) {
  const int C = a.chunk, D = a.dim, n = a.step.nent;
  const long rows = (long)C * a.heads * D;
  if (D <= 0 || D > RA_DMAX || C <= 0 || a.batch <= 0 || a.heads <= 0 || n <= 0 ||
      n > RING_RMAX || a.rs < rows || a.sb < rows || a.slot_rs < a.batch * rows)
    return cudaErrorInvalidValue;
  for (int e = 0; e < n; ++e) {
    const int nblk = a.step.info[e] & 3;
    if (nblk < 1 || nblk > 2) return cudaErrorInvalidValue;
  }
  return D > 128 ? ring_fwd_kernels<256>(a, s) : ring_fwd_kernels<128>(a, s);
}

enum RingBwdKernel { RB_DKDV, RB_DQ, RB_LAND };

template <int DMAX>
static cudaError_t ring_bwd_kernels(const RingBwdArgs& a, RingBwdKernel which, cudaStream_t s) {
  const int C = a.chunk, D = a.dim;
  const int bh = a.batch * a.heads, z = which == RB_DKDV ? a.step.npair : a.step.nent;
  if (a.act_bf16) {
    size_t smem;
    dim3 grid;
    int threads = RB_THREADS;
    if constexpr (DMAX > 128) {
      // the groups, then their second stages where a block may walk two
      // tiles: dK/dV the rank's query tiles, dQ the key tiles of an entry's
      // visiting blocks
      const RbsGeom g = rbs_geom(C, D, which == RB_DKDV);
      const int tiles = cdiv(C, g.kt);
      int walk = tiles;
      if (which == RB_DQ)
        for (int e = 0; e < a.step.nent; ++e) walk = max(walk, (a.step.info[e] & 3) * tiles);
      smem = (size_t)g.groups * (g.gbytes + (walk > 1 ? g.stage : 0));
      grid = dim3(cdiv(bh, g.groups), cdiv(C, g.own), z);
      threads = 64 * g.tiles;
    } else {
      const RbGeom g = rb_geom(C, D, which == RB_DKDV);
      smem = (size_t)g.groups * (g.fixed + g.nst * g.stage);
      grid = dim3(cdiv(bh, g.groups), cdiv(C, g.own), z);
    }
    if (which == RB_DKDV) {
      BVQ_TRY(rf_allow_smem(ring_bwd_dkdv_mma_kernel<DMAX>, rs_slot<DMAX>(RS_DKDV_MMA), smem));
      ring_bwd_dkdv_mma_kernel<DMAX><<<grid, threads, smem, s>>>(a);
    } else {
      BVQ_TRY(rf_allow_smem(ring_bwd_dq_mma_kernel<DMAX>, rs_slot<DMAX>(RS_DQ_MMA), smem));
      ring_bwd_dq_mma_kernel<DMAX><<<grid, threads, smem, s>>>(a);
    }
  } else {
    using F = RaTile<DMAX>;
    const size_t tr = ra_tile_rows<F::T>(C);
    const size_t tile = tr * (D + 1), scores = tr * F::PLD;
    const dim3 grid(bh, cdiv(C, F::T), z);
    if (which == RB_DKDV) {
      const size_t smem = (4 * tile + 2 * scores + 3 * F::T) * sizeof(float);
      BVQ_TRY(rf_allow_smem(ring_bwd_dkdv_fma_kernel<DMAX>, rs_slot<DMAX>(RS_DKDV_FMA), smem));
      ring_bwd_dkdv_fma_kernel<DMAX><<<grid, F::THREADS, smem, s>>>(a);
    } else {
      const size_t smem = (4 * tile + scores + 3 * F::T) * sizeof(float);
      BVQ_TRY(rf_allow_smem(ring_bwd_dq_fma_kernel<DMAX>, rs_slot<DMAX>(RS_DQ_FMA), smem));
      ring_bwd_dq_fma_kernel<DMAX><<<grid, F::THREADS, smem, s>>>(a);
    }
  }
  return cudaGetLastError();
}

static cudaError_t ring_bwd_launch(const RingBwdArgs& a, RingBwdKernel which, cudaStream_t s) {
  const int C = a.chunk, D = a.dim, n = a.step.nent, np = a.step.npair;
  const long rows = (long)C * a.heads * D;
  if (D <= 0 || D > RA_DMAX || C <= 0 || a.batch <= 0 || a.heads <= 0 || a.ranks <= 0 ||
      a.rs < rows || a.sb < rows || a.slot_rs < a.batch * rows)
    return cudaErrorInvalidValue;
  if (which == RB_LAND) {
    const long total = (long)a.ranks * a.batch * rows;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    if (a.act_bf16)
      ring_land_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(a);
    else
      ring_land_kernel<float><<<blocks, 256, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (n <= 0 || n > RING_RMAX || np <= 0 || np > 2 * RING_RMAX) return cudaErrorInvalidValue;
  for (int e = 0; e < n; ++e) {
    const int nblk = a.step.info[e] & 3;
    if (nblk < 1 || nblk > 2) return cudaErrorInvalidValue;
  }
  for (int p = 0; p < np; ++p) {
    const int e = a.step.pair[p] >> 1, j = a.step.pair[p] & 1;
    if (a.step.pair[p] < 0 || e >= n || j >= (a.step.info[e] & 3)) return cudaErrorInvalidValue;
  }
  return D > 128 ? ring_bwd_kernels<256>(a, which, s) : ring_bwd_kernels<128>(a, which, s);
}

}  // namespace bvq

extern "C" int bvq_ring_fwd_step(const bvq::RingFwdArgs* a, void* stream) {
  return static_cast<int>(bvq::ring_fwd_launch(*a, static_cast<cudaStream_t>(stream)));
}

extern "C" int bvq_ring_bwd_dkdv(const bvq::RingBwdArgs* a, void* stream) {
  return static_cast<int>(
      bvq::ring_bwd_launch(*a, bvq::RB_DKDV, static_cast<cudaStream_t>(stream)));
}

extern "C" int bvq_ring_bwd_dq(const bvq::RingBwdArgs* a, void* stream) {
  return static_cast<int>(
      bvq::ring_bwd_launch(*a, bvq::RB_DQ, static_cast<cudaStream_t>(stream)));
}

extern "C" int bvq_ring_land(const bvq::RingBwdArgs* a, void* stream) {
  return static_cast<int>(
      bvq::ring_bwd_launch(*a, bvq::RB_LAND, static_cast<cudaStream_t>(stream)));
}
