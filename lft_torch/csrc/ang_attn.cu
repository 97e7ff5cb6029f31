// K7: per-op angular attention on projected q/k/v, forward and backward.
//
// Replaces lft_tpu/kernels/ang_attn_mxu.py:_fwd_kernel / _bwd_kernel (the
// Pallas TPU kernels behind ang_attention_blockdiag). For every pixel n of N
// and head hh of 8, over the pixel's A2 view tokens (q, k, v [N, A2, C],
// dh = C / 8):
//   s_ij = (q_i * scale) . k_j        out_i = sum_j softmax_j(s_ij) v_j
// with m_i = max_j s_ij and l_i = sum_j exp(s_ij - m_i) per (token, head)
// as the residuals of the backward, which returns dq, dk, dv from
// (q, k, v, m, l, dout):
//   p_ij = exp(s_ij - m_i) / l_i      dp_ij = dout_i . v_j
//   D_i = sum_j p_ij dp_ij            ds_ij = p_ij (dp_ij - D_i)
//   dq_i = scale sum_j ds_ij k_j      dk_j = sum_i ds_ij (q_i * scale)
//   dv_j = sum_i p_ij dout_i
// The q/k/v/out projections stay outside (torch.matmul), as the JAX package
// leaves them to XLA.
//
// What the TPU kernel does to fill its matrix unit (keys replicated per
// head behind channel masks, a block-diagonal mask over a 128-row group of
// pixels, pixel pairs packed side by side, one row-wide softmax shift
// shared by the heads) has no purpose here: m stays per (token, head).
//
// Both kernels are persistent: a block walks tiles of P whole pixels
// (blockIdx.x, blockIdx.x + gridDim.x, ...; as many blocks as fit the SMs),
// and while it computes one tile, cp.async brings the next tile's rows into
// the other of two stages (the backward past A2 = 85 at C = 64: one stage).
// Rows are staged at stride C + 4 floats. Outputs (and m, l) go through
// shared memory and leave as whole coalesced lines. A thread's items are
// whole (pixel, head) units with the queries (or keys) fastest, so a warp's
// key (or query) reads are shared-memory broadcasts. Loops over keys (or
// queries) go by whole chunks of 8 without per-key predicates, and a last
// partial chunk with them, which let the compiler schedule a chunk's loads
// together (the forward 9% faster at A2 = 25, 21% at 81). Every score is the
// forward's arithmetic: q scaled first (one f32 product), then one fmaf
// chain over d; so m is the exact maximum and the backward rebuilds the
// scores bit for bit. Every output element is written by exactly one
// thread in a fixed order, without atomics: a call repeats bit for bit.
// N is ragged (a last tile's missing pixels are skipped) where the TPU
// wrapper pads it.
//
// Forward (`ang_attn`, with STATS `ang_attn_res`): a thread takes two
// queries of one (pixel, head), which share every key and value read. The
// softmax goes in chunks of KB = 8 keys, as K1's (ang_block.cu): the chunk's
// scores and their maximum with the running m; then the chunk's sums from 0
// (l_c of exp(s - m_c), o_c by fmaf chains) and one rescale a chunk, l =
// fmaf(l, r, l_c) and o = fmaf(o, r, o_c). Summed in two levels, l and out
// stay within the f32 plain version's float64 error up to 128 keys, where
// one running sum (K1's) put l at 2.5x it from 33 keys on. The output
// overwrites the thread's own q rows in shared memory. P is the largest
// number of pixels (up to 512 threads) whose two stages and m, l fit two
// blocks on an SM (2 at A2 = 25, C = 64; one pixel from A2 = 35): all of a
// tile's items are one round.
// Bound on this card: the bytes. At [16384, 25, 64] q, k, v, out are 4 x 105
// MB, 0.125 ms at 3.35 TB/s, against 2.6 GFLOP (0.039 ms on the FP32 pipes).
// What holds it back is its instruction stream, not the staging: with the
// loads taken out it runs 0.172 of its 0.195 ms, the staging alone 0.142
// (lft_torch/probe_k7.py; two blocks of 7 warps an SM, by registers).
//
// Backward (`ang_attn_bwd`): two phases a tile, each score rebuilt twice.
// * Query phase, a thread (pixel, head, query i): q_i scaled (and written
//   back, so the key phase reads the forward's product), then over the
//   keys s_ij, p_ij = exp(s_ij - m_i) * (1 / l_i), dp_ij and D_i = sum_j
//   p_ij dp_ij; then ds_ij and dq_i = scale sum_j ds_ij k_j. At A2 <= 32
//   the p_ij and dp_ij of the first loop stay in registers (64 of them);
//   beyond, the second loop rebuilds them (an extra pass: three rebuilds in
//   all, no register arrays). m_i, 1 / l_i and D_i go to shared memory as
//   one float4 a (token, head), dq_i to a staging tile.
// * Key phase, a thread (pixel, head, key j): over the pixel's queries, the
//   same p_ij and ds_ij from (q_i scaled, dout_i, m_i, 1 / l_i, D_i), dk_j =
//   sum_i ds_ij q_i scale, dv_j = sum_i p_ij dout_i, written over the
//   thread's own k_j and v_j rows.
// Every sum over keys or queries goes in two levels as the forward's:
// fmaf chains over chunks of 8 from 0, the chunks added in order.
// Registers: the held query phase takes 128 at dh = 8 with 120 B of
// spills; let it take the 169 it would use and only one block fits an SM,
// which is slower (0.209 against 0.168 ms at [4096, 25, 64], probe_k7).
// P: the pixels (up to 64 rows) whose two stages fit two blocks on an SM
// (one pixel at A2 = 25, C = 64: 67.6 KB); past 64 views a tile is one pixel
// in two rounds of threads. All on the FP32 pipes (3xTF32 would not pay at
// dh = 2-8). Bound: q, k, v, dout read and dq, dk, dv written once, m and l
// read once: 0.0567 ms at [4096, 25, 64] against 1.6 GFLOP (0.025 ms); at
// [1024, 81, 64] 4.3 GFLOP (0.064 ms) against 0.024 ms of bytes. Here too
// the instructions hold it back: without loads 0.161 of 0.168 ms, the
// staging alone 0.067 (probe_k7).
//
// bf16-IO forwards (`--dtype bfloat16` serving through the per-op branch;
// bf16 q, k, v and out, f32 arithmetic inside):
// * `ang_attn_bf16io` (`lft_ang_attn_bf16io`): lft_tpu's K7 on bf16 tensors
//   (ang_attn_mxu.py:_fwd_kernel :106-142) defers its normalisation behind
//   one row-wide max: s = (q . k) scale, m each token's max over EVERY head,
//   e = exp(s - m) rounded to bf16 for the product with v, l the head's sum
//   of the unrounded e, out = bf16(o (1 / l)). A head's max needs the other
//   heads' scores first, so `ang_attn_bf16io_kernel` takes K1's bf16-IO
//   attention pass (ang_block.cu) on its own: a block stages P whole pixels'
//   q, k, v widened to f32 (one stage), a first pass over the (pixel, head,
//   query) items writes each item's max to shared memory, a second forms m
//   over the heads, the sums and the output, rounded as it is stored; one
//   query a thread, each score built twice.
// * `ang_attn_sweep_bf16io` at A2 <= 128 (`lft_ang_attn_f32in_bf16io`):
//   lft_tpu's K8 widens q, k, v to f32 and rounds only its output
//   (ang_attn_vjp.py:_fwd_kernel :22-50), the f32 kernel's function: its
//   IO = bf16 instance, rows widened as the threads stage them, the output
//   rounded as it leaves.
// Bound at [16384, 25, 64]: q, k, v read and out written once in bf16,
// 0.0626 ms at 3.35 TB/s (2.6 GFLOP on the FP32 pipes: 0.039 ms; the
// deferred kernel builds each score twice).
//
// bf16-IO training forms (`--dtype bfloat16` training through the per-op
// branch):
// * `ang_attn_res_bf16io` (`lft_ang_attn_res_bf16io`): the deferred kernel
//   with STATS, m the token's max over its heads in every head's slot, l
//   each head's sum under it (lft_tpu's _fwd_kernel with_stats on bf16);
// * `ang_attn_sweep_res_bf16io` at A2 <= 128 (`lft_ang_attn_f32in_res_bf16io`):
//   the f32 kernel's bf16-IO instance with STATS (each head's own m, l);
// * `ang_attn_bwd_bf16io` (`lft_ang_attn_bwd_bf16io`): the backward kernel
//   with IO = bf16, rows widened as the threads stage them, and lft_tpu's
//   rounded operands (ang_attn_mxu.py:_bwd_kernel :148-192 on bf16): s = (q
//   . k) scale from the unscaled q, p = exp(s - m) (1 / l) and D = sum_j p
//   dp in f32, ds = bf16(p (dp - D) scale) and bf16(p) before their
//   products, dq, dk, dv summed in f32 and rounded once as they leave.
// Bound of the backward at [4096, 25, 64]: q, k, v, dout in and dq, dk, dv
// out in bf16, m, l f32: 0.0294 ms of bytes against 1.6 GFLOP, 0.025 ms on
// the FP32 pipes.

#include "ang_attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;
constexpr int HOLD_MAX = 32;       // the backward's query phase holds p, dp up to 32 keys

// floats a token row takes: the forward's two stages of q, k, v and m, l;
// the backward's `nbuf` stages of q, k, v, dout, m, l, then D (a float4 a
// head) and the dq staging row
inline int fwd_row_floats(int C, bool stats) { return 6 * (C + 4) + (stats ? 2 * H : 0); }
inline int bwd_row_floats(int C, int nbuf) { return nbuf * (4 * (C + 4) + 2 * H) + 4 * H + C + 4; }

struct Geo {
  int P, nt, nbuf;   // pixels a tile, threads a block, stages
  size_t bytes;      // shared memory a block
};

inline Geo fwd_geo(int A2, int C, bool stats) {
  const int QP = (A2 + 1) / 2;   // query pairs a (pixel, head)
  const int P = std::max(1, std::min(SMEM_TWO / (fwd_row_floats(C, true) * 4) / A2,
                                     NT_MAX / (H * QP)));
  return {P, round32(P * H * QP), 2, static_cast<size_t>(P) * A2 * fwd_row_floats(C, stats) * 4};
}

inline Geo bwd_geo(int A2, int C) {
  const int P = std::max(1, std::min(SMEM_TWO / (bwd_row_floats(C, 2) * 4) / A2,
                                     NT_MAX / (H * A2)));
  const int nbuf = static_cast<size_t>(P) * A2 * bwd_row_floats(C, 2) * 4 <= SMEM_MAX ? 2 : 1;
  const int items = P * H * A2, rounds = (items + NT_MAX - 1) / NT_MAX;
  return {P, round32((items + rounds - 1) / rounds), nbuf,
          static_cast<size_t>(P) * A2 * bwd_row_floats(C, nbuf) * 4};
}

// ---- forward: a thread takes two queries of one (pixel, head) -------------
template <int DH, bool STATS, class IO = float>
__global__ void __launch_bounds__(NT_MAX)
    ang_attn_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                    const IO* __restrict__ v, IO* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int N, int A2,
                    int P, float scale) {
  constexpr int C = H * DH, LD = C + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RT = P * A2;                     // rows of a whole tile
  const int SF = 3 * RT * LD;                // floats of a stage: q, k, v
  float* MS = smem + 2 * SF;                 // [RT][H] each (STATS)
  float* LS = MS + RT * H;
  const int QP = (A2 + 1) / 2, tiles = (N + P - 1) / P, tid = threadIdx.x;
  auto issue = [&](int tile, float* dst) {
    const int rows = min(P, N - tile * P) * A2;
    const size_t row0 = static_cast<size_t>(tile) * P * A2;
    stage_async<C, LD>(dst, q, row0, rows);
    stage_async<C, LD>(dst + RT * LD, k, row0, rows);
    stage_async<C, LD>(dst + 2 * RT * LD, v, row0, rows);
    cp_async_commit();
  };

  if (blockIdx.x < tiles) issue(blockIdx.x, smem);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    float* stg = smem + (it & 1) * SF;
    cp_async_wait<0>();
    __syncthreads();   // the tile has landed; the other stage's last reader is done
    if (tile + gridDim.x < tiles) issue(tile + gridDim.x, smem + ((it + 1) & 1) * SF);
    const int np = min(P, N - tile * P), rows = np * A2;
    const size_t row0 = static_cast<size_t>(tile) * P * A2;

    const int pr = tid % QP, hh = tid / QP % H, p = tid / (QP * H);
    if (p < np) {
      const int i0 = 2 * pr, i1 = min(i0 + 1, A2 - 1);   // a lone last query runs twice
      float* qp = stg + p * A2 * LD + hh * DH;
      const float* kp = qp + RT * LD;
      const float* vp = kp + RT * LD;
      float qa[DH], qb[DH], oa[DH], ob[DH];
      ld<DH>(qp + i0 * LD, qa);
      ld<DH>(qp + i1 * LD, qb);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        qa[d] *= scale;
        qb[d] *= scale;
        oa[d] = ob[d] = 0.f;
      }
      float ma = -CUDART_INF_F, mb = -CUDART_INF_F, la = 0.f, lb = 0.f;
      auto chunk = [&](int j0, auto full) {
        float sa[KB], sb[KB];
        float ca = ma, cb = mb;
#pragma unroll
        for (int jj = 0; jj < KB; ++jj) {
          sa[jj] = sb[jj] = -CUDART_INF_F;
          if (decltype(full)::value || j0 + jj < A2) {
            float kr[DH];
            ld<DH>(kp + (j0 + jj) * LD, kr);
            sa[jj] = dot<DH>(qa, kr);
            sb[jj] = dot<DH>(qb, kr);
          }
          ca = fmaxf(ca, sa[jj]);
          cb = fmaxf(cb, sb[jj]);
        }
        // the chunk's sums from 0, then one rescale of the running ones
        float lca = 0.f, lcb = 0.f, pa[DH], pb[DH];
#pragma unroll
        for (int d = 0; d < DH; ++d) pa[d] = pb[d] = 0.f;
#pragma unroll
        for (int jj = 0; jj < KB; ++jj) {
          if (decltype(full)::value || j0 + jj < A2) {
            const float ea = expf(sa[jj] - ca), eb = expf(sb[jj] - cb);
            float vr[DH];
            ld<DH>(vp + (j0 + jj) * LD, vr);
            lca += ea;
            lcb += eb;
#pragma unroll
            for (int d = 0; d < DH; ++d) {
              pa[d] = fmaf(ea, vr[d], pa[d]);
              pb[d] = fmaf(eb, vr[d], pb[d]);
            }
          }
        }
        const float ra = expf(ma - ca), rb = expf(mb - cb);
        la = fmaf(la, ra, lca);
        lb = fmaf(lb, rb, lcb);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          oa[d] = fmaf(oa[d], ra, pa[d]);
          ob[d] = fmaf(ob[d], rb, pb[d]);
        }
        ma = ca;
        mb = cb;
      };
      chunks(A2, chunk);
      const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        oa[d] *= ia;
        ob[d] *= ib;
      }
      // the output over the thread's own q rows, which no other thread reads
      st<DH>(qp + i0 * LD, oa);
      if (i0 + 1 < A2) st<DH>(qp + i1 * LD, ob);
      if constexpr (STATS) {
        MS[(p * A2 + i0) * H + hh] = ma;
        LS[(p * A2 + i0) * H + hh] = la;
        if (i0 + 1 < A2) {
          MS[(p * A2 + i1) * H + hh] = mb;
          LS[(p * A2 + i1) * H + hh] = lb;
        }
      }
    }
    __syncthreads();
    store_rows<C, LD>(out, stg, row0, rows);
    if constexpr (STATS) {
      store_rows<H, H>(m_out, MS, row0, rows);
      store_rows<H, H>(l_out, LS, row0, rows);
    }
  }
}

// ---- bf16-IO forward with the deferred softmax: a thread a (pixel, head,
// query), P whole pixels a block ---------------------------------------------
template <int DH, bool STATS = false>
__global__ void __launch_bounds__(NT_MAX)
    ang_attn_bf16io_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int N, int A2,
                           int P, float scale, float* __restrict__ m_out,
                           float* __restrict__ l_out) {
  constexpr int C = H * DH, LD = C + 4;
  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);
  const int RT = P * A2;
  float* KT = QT + RT * LD;
  float* VT = KT + RT * LD;
  float* MH = VT + RT * LD;                  // [RT][H]: each item's max
  const int np = min(P, N - static_cast<int>(blockIdx.x) * P), rows = np * A2;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * P * A2;
  stage_async<C, LD>(QT, q, row0, rows);
  stage_async<C, LD>(KT, k, row0, rows);
  stage_async<C, LD>(VT, v, row0, rows);
  __syncthreads();
  const int items = np * H * A2;
  // pass 1: each (pixel, head, query)'s max score; queries fastest, so a
  // warp's key reads are broadcasts
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int i = t % A2, hh = t / A2 % H, p = t / (A2 * H);
    float qv[DH];
    ld<DH>(QT + (p * A2 + i) * LD + hh * DH, qv);
    const float* kp = KT + p * A2 * LD + hh * DH;
    float mx = -CUDART_INF_F;
    for (int j = 0; j < A2; ++j) {
      float kr[DH];
      ld<DH>(kp + j * LD, kr);
      mx = fmaxf(mx, dot<DH>(qv, kr) * scale);
    }
    MH[(p * A2 + i) * H + hh] = mx;
  }
  __syncthreads();
  // pass 2: m the token's max over its heads; l over e, o over bf16(e)
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int i = t % A2, hh = t / A2 % H, p = t / (A2 * H);
    float m = MH[(p * A2 + i) * H];
#pragma unroll
    for (int g = 1; g < H; ++g) m = fmaxf(m, MH[(p * A2 + i) * H + g]);
    float qv[DH], o[DH];
    ld<DH>(QT + (p * A2 + i) * LD + hh * DH, qv);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = 0.f;
    const float* kp = KT + p * A2 * LD + hh * DH;
    const float* vp = VT + p * A2 * LD + hh * DH;
    float l = 0.f;
    for (int j = 0; j < A2; ++j) {
      float kr[DH], vr[DH];
      ld<DH>(kp + j * LD, kr);
      ld<DH>(vp + j * LD, vr);
      const float e = expf(dot<DH>(qv, kr) * scale - m);
      const float eb = bf16_round(e);
      l += e;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(eb, vr[d], o[d]);
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] *= inv;
    st<DH>(out + (row0 + p * A2 + i) * C + hh * DH, o);
    if constexpr (STATS) {   // m the token's max over its heads, in every head's slot
      m_out[(row0 + p * A2 + i) * H + hh] = m;
      l_out[(row0 + p * A2 + i) * H + hh] = l;
    }
  }
}

// ---- backward: a query phase (D, dq), then a key phase (dk, dv) ------------
// IO = bf16 (`ang_attn_bwd_bf16io`): lft_tpu's rounded operands, the header.
template <int DH, bool HOLD, class IO = float>
__global__ void __launch_bounds__(NT_MAX)
    ang_attn_bwd_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                        const IO* __restrict__ v, const IO* __restrict__ dout,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        IO* __restrict__ dq_out, IO* __restrict__ dk_out,
                        IO* __restrict__ dv_out, int N, int A2, int P, int nbuf,
                        float scale) {
  constexpr bool RND = is_bf16<IO>;   // s = (q . k) scale; ds, p rounded before their products
  constexpr int C = H * DH, LD = C + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int RT = P * A2;
  const int SF = RT * (4 * LD + 2 * H);      // a stage: q, k, v, dout [RT][LD]; m, l [RT][H]
  float* SD = smem + nbuf * SF;              // [RT][H] float4 {m, 1 / l, D, 0}
  float* DQ = SD + RT * 4 * H;               // [RT][LD]
  const int tiles = (N + P - 1) / P, tid = threadIdx.x, nt = blockDim.x;
  auto issue = [&](int tile, float* dst) {
    const int rows = min(P, N - tile * P) * A2;
    const size_t row0 = static_cast<size_t>(tile) * P * A2;
    stage_async<C, LD>(dst, q, row0, rows);
    stage_async<C, LD>(dst + RT * LD, k, row0, rows);
    stage_async<C, LD>(dst + 2 * RT * LD, v, row0, rows);
    stage_async<C, LD>(dst + 3 * RT * LD, dout, row0, rows);
    stage_async<H, H>(dst + 4 * RT * LD, m_in, row0, rows);
    stage_async<H, H>(dst + 4 * RT * LD + RT * H, l_in, row0, rows);
    cp_async_commit();
  };

  if (blockIdx.x < tiles) issue(blockIdx.x, smem);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    float* QT = smem + (it & (nbuf - 1)) * SF;
    float* KT = QT + RT * LD;
    float* VT = KT + RT * LD;
    const float* GT = VT + RT * LD;
    const float* MT = GT + RT * LD;
    const float* LT = MT + RT * H;
    cp_async_wait<0>();
    __syncthreads();
    const int nxt = tile + gridDim.x;
    if (nbuf == 2 && nxt < tiles) issue(nxt, smem + ((it + 1) & 1) * SF);
    const int np = min(P, N - tile * P), rows = np * A2, items = np * H * A2;
    const size_t row0 = static_cast<size_t>(tile) * P * A2;

    // query phase: thread (pixel, head, query i), queries fastest
    for (int t = tid; t < items; t += nt) {
      const int i = t % A2, hh = t / A2 % H, p = t / (A2 * H);
      const int me = p * A2 + i;
      const float* kp = KT + p * A2 * LD + hh * DH;
      const float* vp = VT + p * A2 * LD + hh * DH;
      float qs[DH], g[DH], dq[DH];
      ld<DH>(QT + me * LD + hh * DH, qs);
      ld<DH>(GT + me * LD + hh * DH, g);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        if constexpr (!RND) qs[d] *= scale;
        dq[d] = 0.f;
      }
      // the forward's q * scale, for the key phase (RND: q itself)
      if constexpr (!RND) st<DH>(QT + me * LD + hh * DH, qs);
      const float mi = MT[me * H + hh], inv = 1.f / LT[me * H + hh];
      float dsum = 0.f;
      if constexpr (HOLD) {   // p and dp of every key in registers
        float pj[HOLD_MAX], dpj[HOLD_MAX];
#pragma unroll
        for (int j0 = 0; j0 < HOLD_MAX; j0 += KB) {
          auto chunk = [&](auto full) {
            float dc = 0.f;
#pragma unroll
            for (int j = j0; j < j0 + KB; ++j) {
              if (decltype(full)::value || j < A2) {
                float kr[DH], vr[DH];
                ld<DH>(kp + j * LD, kr);
                ld<DH>(vp + j * LD, vr);
                pj[j] = expf((RND ? dot<DH>(qs, kr) * scale : dot<DH>(qs, kr)) - mi) * inv;
                dpj[j] = dot<DH>(g, vr);
                dc = fmaf(pj[j], dpj[j], dc);
              }
            }
            dsum += dc;
          };
          if (j0 + KB <= A2) chunk(std::true_type{});
          else if (j0 < A2) chunk(std::false_type{});
        }
#pragma unroll
        for (int j0 = 0; j0 < HOLD_MAX; j0 += KB) {
          auto chunk = [&](auto full) {
            float dc[DH] = {};
#pragma unroll
            for (int j = j0; j < j0 + KB; ++j) {
              if (decltype(full)::value || j < A2) {
                float kr[DH];
                ld<DH>(kp + j * LD, kr);
                const float ds = RND ? bf16_round(pj[j] * (dpj[j] - dsum) * scale)
                                     : pj[j] * (dpj[j] - dsum);
#pragma unroll
                for (int d = 0; d < DH; ++d) dc[d] = fmaf(ds, kr[d], dc[d]);
              }
            }
#pragma unroll
            for (int d = 0; d < DH; ++d) dq[d] += dc[d];
          };
          if (j0 + KB <= A2) chunk(std::true_type{});
          else if (j0 < A2) chunk(std::false_type{});
        }
      } else {   // the second loop rebuilds them
        auto dchunk = [&](int j0, auto full) {
          float dc = 0.f;
#pragma unroll
          for (int j = j0; j < j0 + KB; ++j) {
            if (decltype(full)::value || j < A2) {
              float kr[DH], vr[DH];
              ld<DH>(kp + j * LD, kr);
              ld<DH>(vp + j * LD, vr);
              dc = fmaf(expf((RND ? dot<DH>(qs, kr) * scale : dot<DH>(qs, kr)) - mi) * inv,
                        dot<DH>(g, vr), dc);
            }
          }
          dsum += dc;
        };
        auto qchunk = [&](int j0, auto full) {
          float dc[DH] = {};
#pragma unroll
          for (int j = j0; j < j0 + KB; ++j) {
            if (decltype(full)::value || j < A2) {
              float kr[DH], vr[DH];
              ld<DH>(kp + j * LD, kr);
              ld<DH>(vp + j * LD, vr);
              const float pr = expf((RND ? dot<DH>(qs, kr) * scale : dot<DH>(qs, kr)) - mi) * inv;
              const float ds = RND ? bf16_round(pr * (dot<DH>(g, vr) - dsum) * scale)
                                   : pr * (dot<DH>(g, vr) - dsum);
#pragma unroll
              for (int d = 0; d < DH; ++d) dc[d] = fmaf(ds, kr[d], dc[d]);
            }
          }
#pragma unroll
          for (int d = 0; d < DH; ++d) dq[d] += dc[d];
        };
        chunks(A2, dchunk);
        chunks(A2, qchunk);
      }
      store4(SD + (me * H + hh) * 4, make_float4(mi, inv, dsum, 0.f));
#pragma unroll
      for (int d = 0; d < DH; ++d) dq[d] *= RND ? 1.f : scale;
      st<DH>(DQ + me * LD + hh * DH, dq);
    }
    __syncthreads();

    // key phase: thread (pixel, head, key j), keys fastest
    for (int t = tid; t < items; t += nt) {
      const int j = t % A2, hh = t / A2 % H, p = t / (A2 * H);
      const int me = p * A2 + j;
      float kme[DH], vme[DH], dk[DH], dv[DH];
      ld<DH>(KT + me * LD + hh * DH, kme);
      ld<DH>(VT + me * LD + hh * DH, vme);
#pragma unroll
      for (int d = 0; d < DH; ++d) dk[d] = dv[d] = 0.f;
      auto kchunk = [&](int i0, auto full) {
        float ck[DH] = {}, cv[DH] = {};
#pragma unroll
        for (int i = i0; i < i0 + KB; ++i) {
          if (decltype(full)::value || i < A2) {
            const int o = p * A2 + i;
            float qo[DH], go[DH];
            ld<DH>(QT + o * LD + hh * DH, qo);
            ld<DH>(GT + o * LD + hh * DH, go);
            const float4 sd = load4(SD + (o * H + hh) * 4);
            const float pr =
                expf((RND ? dot<DH>(qo, kme) * scale : dot<DH>(qo, kme)) - sd.x) * sd.y;
            const float ds = RND ? bf16_round(pr * (dot<DH>(go, vme) - sd.z) * scale)
                                 : pr * (dot<DH>(go, vme) - sd.z);
            const float pv = RND ? bf16_round(pr) : pr;
#pragma unroll
            for (int d = 0; d < DH; ++d) {
              ck[d] = fmaf(ds, qo[d], ck[d]);
              cv[d] = fmaf(pv, go[d], cv[d]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dk[d] += ck[d];
          dv[d] += cv[d];
        }
      };
      chunks(A2, kchunk);
      // over the thread's own k and v rows, which no other thread reads now
      st<DH>(KT + me * LD + hh * DH, dk);
      st<DH>(VT + me * LD + hh * DH, dv);
    }
    __syncthreads();
    store_rows<C, LD>(dq_out, DQ, row0, rows);
    store_rows<C, LD>(dk_out, KT, row0, rows);
    store_rows<C, LD>(dv_out, VT, row0, rows);
    if (nbuf == 1 && nxt < tiles) {
      __syncthreads();   // the stage's last reader is done
      issue(nxt, smem);
    }
  }
}

template <bool STATS, class IO = float>
int ang_attn(const named_t<IO>* q, const named_t<IO>* k, const named_t<IO>* v,
             named_t<IO>* out, float* m, float* l, int N, int A2, int C, int heads, float scale,
             cudaStream_t s) {
  if (heads != H || A2 < 1 || A2 > 128 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = fwd_geo(A2, C, STATS);
  const int tiles = (N + g.P - 1) / g.P;
  int grid = 0;
  switch (C / H) {
#define LFT_ANG_CASE(DHV)                                                          \
    case DHV: {                                                                    \
      auto kernel = ang_attn_kernel<DHV, STATS, IO>;                               \
      if (const int e = persistent_grid(kernel, g.nt, g.bytes, tiles, &grid)) return e;        \
      kernel<<<grid, g.nt, g.bytes, s>>>(q, k, v, out, m, l, N, A2, g.P, scale);   \
      break;                                                                       \
    }
    LFT_ANG_CASE(2)
    LFT_ANG_CASE(4)
    LFT_ANG_CASE(8)
#undef LFT_ANG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The deferred bf16-IO forward (the header): P whole pixels a block, their
// q, k, v and maxima within two blocks' share of an SM, up to 1024 items;
// STATS also writes m, l.
template <bool STATS = false>
int ang_attn_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* m, float* l,
                    int N, int A2, int C, int heads, float scale, cudaStream_t s) {
  if (heads != H || A2 < 1 || A2 > 128 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row = 3 * (C + 4) + H;           // floats a token takes
  const int P = std::max(1, std::min(SMEM_TWO / (row * 4) / A2, 2 * NT_MAX / (H * A2)));
  const int nt = round32(std::min(NT_MAX, P * H * A2));
  const size_t bytes = static_cast<size_t>(P) * A2 * row * 4;
  const int grid = (N + P - 1) / P;
  switch (C / H) {
#define LFT_ANG_CASE(DHV)                                                          \
    case DHV: {                                                                    \
      auto kernel = ang_attn_bf16io_kernel<DHV, STATS>;                            \
      LFT_SET_SMEM(kernel, bytes);                                                 \
      kernel<<<grid, nt, bytes, s>>>(q, k, v, out, N, A2, P, scale, m, l);         \
      break;                                                                       \
    }
    LFT_ANG_CASE(2)
    LFT_ANG_CASE(4)
    LFT_ANG_CASE(8)
#undef LFT_ANG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [N, A2, C], C = 8 heads x {2, 4, 8}, A2 <= 128. Each returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int lft_ang_attn(const float* q, const float* k, const float* v, float* out, int N,
                            int A2, int C, int heads, float scale, void* stream) {
  return ang_attn<false>(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                         static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [N, A2, 8] (the residuals of the backward).
extern "C" int lft_ang_attn_res(const float* q, const float* k, const float* v, float* out,
                                float* m, float* l, int N, int A2, int C, int heads,
                                float scale, void* stream) {
  return ang_attn<true>(q, k, v, out, m, l, N, A2, C, heads, scale,
                        static_cast<cudaStream_t>(stream));
}

// The bf16-IO forwards (the header): q, k, v, out bf16 [N, A2, C].
extern "C" int lft_ang_attn_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out, int N,
                                   int A2, int C, int heads, float scale, void* stream) {
  return ang_attn_bf16io(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int lft_ang_attn_f32in_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                         int N, int A2, int C, int heads, float scale,
                                         void* stream) {
  return ang_attn<false, bf16>(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                               static_cast<cudaStream_t>(stream));
}

namespace {

template <class IO = float>
int ang_attn_bwd(const named_t<IO>* q, const named_t<IO>* k, const named_t<IO>* v,
                 const named_t<IO>* dout, const float* m, const float* l, named_t<IO>* dq,
                 named_t<IO>* dk, named_t<IO>* dv, int N, int A2, int C, int heads, float scale,
                 cudaStream_t s) {
  if (heads != H || A2 < 1 || A2 > 128 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = bwd_geo(A2, C);
  const int tiles = (N + g.P - 1) / g.P;
  int grid = 0;
  switch (C / H) {
#define LFT_ANG_CASE(DHV)                                                                  \
    case DHV: {                                                                            \
      auto kernel = ang_attn_bwd_kernel<DHV, false, IO>;                                  \
      if (A2 <= HOLD_MAX) kernel = ang_attn_bwd_kernel<DHV, true, IO>;                     \
      if (const int e = persistent_grid(kernel, g.nt, g.bytes, tiles, &grid)) return e;                \
      kernel<<<grid, g.nt, g.bytes, s>>>(q, k, v, dout, m, l, dq, dk, dv, N, A2, g.P,      \
                                         g.nbuf, scale);                                   \
      break;                                                                               \
    }
    LFT_ANG_CASE(2)
    LFT_ANG_CASE(4)
    LFT_ANG_CASE(8)
#undef LFT_ANG_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lft_ang_attn_bwd(const float* q, const float* k, const float* v,
                                const float* dout, const float* m, const float* l, float* dq,
                                float* dk, float* dv, int N, int A2, int C, int heads,
                                float scale, void* stream) {
  return ang_attn_bwd(q, k, v, dout, m, l, dq, dk, dv, N, A2, C, heads, scale,
                      static_cast<cudaStream_t>(stream));
}

// The `_res` forms in bf16 IO (the header): q, k, v, out bf16 [N, A2, C],
// m, l f32 [N, A2, 8]. `ang_attn_res_bf16io`: the deferred kernel with its
// statistics (m the token's max over its heads in every head's slot, l the
// head's sum under it); `ang_attn_sweep_res_bf16io` at A2 <= 128: the f32
// kernel's bf16-IO instance with its statistics (each head's own).
extern "C" int lft_ang_attn_res_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                       float* m, float* l, int N, int A2, int C, int heads,
                                       float scale, void* stream) {
  return ang_attn_bf16io<true>(q, k, v, out, m, l, N, A2, C, heads, scale,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int lft_ang_attn_f32in_res_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                             bf16* out, float* m, float* l, int N, int A2, int C,
                                             int heads, float scale, void* stream) {
  return ang_attn<true, bf16>(q, k, v, out, m, l, N, A2, C, heads, scale,
                              static_cast<cudaStream_t>(stream));
}

// K7's backward in bf16 IO (`ang_attn_bwd_bf16io`, the header): q, k, v,
// dout and dq, dk, dv bf16 [N, A2, C]; m, l f32 of K7 res bf16io.
extern "C" int lft_ang_attn_bwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                       const bf16* dout, const float* m, const float* l,
                                       bf16* dq, bf16* dk, bf16* dv, int N, int A2, int C,
                                       int heads, float scale, void* stream) {
  return ang_attn_bwd<bf16>(q, k, v, dout, m, l, dq, dk, dv, N, A2, C, heads, scale,
                            static_cast<cudaStream_t>(stream));
}
