// K8: per-op angular attention at any view count, forward (run past 128
// views) and backward (run from 33).
//
// Replaces lft_tpu/kernels/ang_attn_vjp.py:_fwd / _vjp_bwd (the Pallas TPU
// kernels behind ang_attention). For every pixel n of N and head hh of 8,
// over the pixel's A2 view tokens (q, k, v [N, A2, C], dh = C / 8):
//   s_ij = (q_i * scale) . k_j        out_i = sum_j softmax_j(s_ij) v_j
// with m_i = max_j s_ij and l_i = sum_j exp(s_ij - m_i) per (token, head).
// (out, m, l) are the residuals of the backward, which returns dq, dk, dv
// from (q, k, v, out, m, l, dout):
//   D_i = dout_i . out_i (per head)   p_ij = exp(s_ij - m_i) / l_i
//   ds_ij = p_ij (dout_i . v_j - D_i)
//   dq_i = scale sum_j ds_ij k_j      dk_j = sum_i ds_ij (q_i * scale)
//   dv_j = sum_i p_ij dout_i
// The q/k/v/out projections stay outside (torch.matmul), as the JAX package
// leaves them to XLA. The wrappers launch K7's kernels (ang_attn.cu) under
// K8's names for the forward at A2 <= 128 (the same function) and for the
// backward up to 32 views (where K7 holds p and dp in registers and runs
// faster). The forward here takes the view counts past K7's, where a
// pixel's q, k, v no longer fit K7's two stages (244 KB at A2 = 144, C = 64)
// and its 8 heads x 72 query pairs no longer fit 512 threads; the backward
// takes any A2 and runs from 33 views on.
//
// The TPU kernel holds a chunk of 32 pixels with all their views in VMEM and
// walks fori_loop(0, A2) over whole key views. Here a tile is one pixel's
// head group: HG of the 8 heads (the most whose items fit 256 threads; at
// least 16 bytes of a row), so every column of k and v is staged by exactly
// one tile, and the tiles of one pixel run in neighbouring blocks. Both
// kernels are persistent (tiles blockIdx.x, blockIdx.x + gridDim.x, ...), and
// the tile's key (or query) views pass through a ring of NS = 3 cp.async
// stages of KS = 32 rows of the group's columns; the ring runs on across the
// block's tiles, so the next tile's first rows land while this one computes.
// Every score is the forward's arithmetic: q scaled first (one f32 product),
// then one fmaf chain over d; m is the exact maximum, and the backward
// rebuilds the scores bit for bit. Every output element is written by one
// thread in a fixed order, without atomics: a call repeats bit for bit.
//
// Forward (`ang_attn_sweep`, with STATS `ang_attn_sweep_res`): K7's
// arithmetic. A thread takes two queries of one head, which share every key
// and value read; the softmax goes in chunks of KB = 8 keys (the chunk's
// scores and their maximum with the running m, the chunk's sums from 0, one
// rescale a chunk: l = fmaf(l, r, l_c), o = fmaf(o, r, o_c)), so l and out
// are summed in two levels and no key costs a correction exp. A tile takes
// up to 2 x 512 / HG queries (all of them up to 1024 views, 512 at dh = 2;
// past that the queries split into blocks whose tiles each stream the keys,
// from L2). The tile's q rows come with its first key stage into one of two
// q buffers, and the output overwrites the thread's own q rows there and
// leaves as 16-byte pieces of the group's columns, row after row; m and l
// likewise.
// Bound on this card: at [9216, 144, 64] 48.9 GFLOP, 0.730 ms on the FP32
// pipes, against 0.406 ms of bytes. It runs 2.62-2.85 ms there (NVIDIA H100
// 80GB HBM3, 700 W; compare_k8), held back, as K7 is, by its instruction
// stream: a (query, key, head) triple takes 16 FMA of ~31 instructions, 8 of
// them the accurate expf.
//
// Backward (`ang_attn_sweep_bwd`): two phases a tile, each score built twice.
// * Query phase, a thread (head, query i): D_i = dout_i . out_i once, m_i,
//   1 / l_i, then one pass over the streamed k, v stages: s_ij, p_ij =
//   exp(s_ij - m_i) * (1 / l_i), dp_ij, ds_ij = p_ij (dp_ij - D_i), dq_i.
//   {m_i, 1 / l_i, D_i} go to shared memory as one float4 a (query, head).
// * Key phase, a thread (head, key j): over the streamed (q, dout) stages
//   (q scaled in place once a stage, by the forward's product), the same
//   p_ij and ds_ij from the float4 of query i; dk_j = sum_i ds_ij q_i scale,
//   dv_j = sum_i p_ij dout_i.
// Every sum over keys or queries goes in two levels: fmaf chains over chunks
// of 8 from 0, the chunks added in order. Outputs go straight from the
// registers, 8 to 32 bytes a thread. Where a tile's items pass 512 threads
// (one head past 512 views, two at dh = 2 past 256) a phase runs in rounds,
// each streaming the stages again. Bound: 10 dh FLOP a pair and head, 0.406 ms at
// [2048, 144, 64] against 0.186 ms of bytes; it runs 1.91 ms there, and from
// 33 views on it beats K7's backward, which holds p and dp in registers only
// up to 32 keys (compare_k8).
//
// IO = bf16 (`lft_ang_attn_sweep_bf16io`, counted `ang_attn_sweep_bf16io`:
// `--dtype bfloat16` serving past 128 views): lft_tpu's K8 widens bf16 q,
// k, v to f32, runs its softmax in f32 and rounds only the output
// (ang_attn_vjp.py:_fwd_kernel :22-50); so does the forward's IO instance:
// the stages widened to f32 as the threads load them (8-byte loads; cp.async
// copies bytes), the f32 arithmetic above, the output rounded to bf16 as it
// leaves. At 128 views or fewer the wrapper launches K7's f32 kernel's bf16-IO
// instance (ang_attn.cu). Bound at [9216, 144, 64]: 48.9 GFLOP on the FP32
// pipes, 0.7302 ms (its bytes in bf16: 0.203 ms).
// Training in bf16 (`ang_attn_sweep_res_bf16io` past 128 views,
// `ang_attn_sweep_bwd_bf16io` at every view count): the forward's IO
// instance with STATS, and the backward's: f32 inside on the widened rows
// (ang_attn_vjp.py:_bwd_kernel :54-87 on bf16), D = dout . out from the
// saved bf16 output, dq, dk, dv rounded to bf16 once as they leave. The
// wrapper launches it at 32 views or fewer too, where the f32 backward takes
// K7's (which forms D from its scores: not lft_tpu's D once out is rounded).

#include <climits>

#include "ang_attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;
constexpr int KS = 32;        // key (or query) rows a stage
constexpr int NS = 3;         // stages of the ring
constexpr int NT_TILE = 256;  // items (query pairs or tokens x heads) a tile, where heads allow

// The most heads of a group (8, 4, 2, 1) whose `per_head` items fit NT_TILE,
// and at least 16 bytes of a row (2 heads at dh = 2).
inline int head_group(int per_head, int DH) {
  int hg = H;
  while (hg > 1 && hg * per_head > NT_TILE) hg /= 2;
  return std::max(hg, 4 / DH);
}

struct FwdGeo {
  int HG, QBP, NQB, nt;   // heads a tile, query pairs a tile, query blocks, threads
  size_t bytes;           // shared memory a block
};

struct BwdGeo {
  int HG, rounds, nt;     // heads a tile, rounds a phase, threads
  size_t bytes;
};

inline FwdGeo fwd_geo(int A2, int C, bool stats) {
  const int DH = C / H, QP = (A2 + 1) / 2, HG = head_group(QP, DH);
  const int QBP = std::min(QP, NT_MAX / HG), NQB = (QP + QBP - 1) / QBP;
  const int LDW = HG * DH + 4, QR = 2 * QBP;
  const size_t floats = NS * 2 * KS * LDW + 2 * QR * LDW + (stats ? 2 * QR * HG : 0);
  return {HG, QBP, NQB, round32(HG * QBP), floats * 4};
}

inline BwdGeo bwd_geo(int A2, int C) {
  const int DH = C / H, HG = head_group(A2, DH);
  const int items = HG * A2, rounds = (items + NT_MAX - 1) / NT_MAX;
  const size_t floats = NS * 2 * KS * (HG * DH + 4) + static_cast<size_t>(4) * HG * A2;
  return {HG, rounds, round32((items + rounds - 1) / rounds), floats * 4};
}

// ---- forward: a thread takes two queries of one head of the group ---------
template <int DH, int HG, bool STATS, class IO = float>
__global__ void __launch_bounds__(NT_MAX)
    sweep_fwd_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                     const IO* __restrict__ v, IO* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int N, int A2,
                     int QBP, int NQB, float scale) {
  constexpr int C = H * DH, W = HG * DH, LDW = W + 4, NG = H / HG;
  constexpr int SF = 2 * KS * LDW;           // floats of a stage: k, v [KS][LDW]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int QR = 2 * QBP;                    // query rows a tile at most
  float* QB = smem + NS * SF;                // two q buffers [QR][LDW]
  float* MS = QB + 2 * QR * LDW;             // [QR][HG] each (STATS)
  float* LS = MS + QR * HG;
  const int tiles = N * NG * NQB, nc = (A2 + KS - 1) / KS, tid = threadIdx.x;
  // tile t: query block t % NQB of head group t / NQB % NG of pixel t / (NQB NG)
  auto rows_of = [&](int t, size_t& row0, int& col0, int& i0, int& nq) {
    row0 = static_cast<size_t>(t / (NQB * NG)) * A2;
    col0 = t / NQB % NG * W;
    i0 = t % NQB * QR;
    nq = min(QR, A2 - i0);
  };
  // chunk f of the block's stream: key rows [c KS, c KS + KS) of its tile
  // f / nc (c = f % nc) into stage f % NS; the first brings the tile's q
  auto issue = [&](int f) {
    const int t = blockIdx.x + f / nc * gridDim.x, c = f % nc;
    if (t < tiles) {
      size_t row0;
      int col0, i0, nq;
      rows_of(t, row0, col0, i0, nq);
      float* dst = smem + f % NS * SF;
      const int n = min(KS, A2 - c * KS);
      stage_cols<C, W, LDW>(dst, k, row0 + c * KS, n, col0);
      stage_cols<C, W, LDW>(dst + KS * LDW, v, row0 + c * KS, n, col0);
      if (c == 0) stage_cols<C, W, LDW>(QB + (f / nc & 1) * QR * LDW, q, row0 + i0, nq, col0);
    }
    cp_async_commit();
  };

  for (int f = 0; f < NS - 1; ++f) issue(f);
  const int pr = tid % QBP, hh = tid / QBP;
  int f = 0;
  for (int t = blockIdx.x, it = 0; t < tiles; t += gridDim.x, ++it) {
    size_t row0;
    int col0, i0, nq;
    rows_of(t, row0, col0, i0, nq);
    float* qt = QB + (it & 1) * QR * LDW;
    const bool active = hh < HG && 2 * pr < nq;
    const int ia = 2 * pr, ib = min(ia + 1, nq - 1);   // a lone last query runs twice
    float qa[DH], qb[DH], oa[DH], ob[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qa[d] = qb[d] = oa[d] = ob[d] = 0.f;
    float ma = -CUDART_INF_F, mb = -CUDART_INF_F, la = 0.f, lb = 0.f;
    for (int c = 0; c < nc; ++c, ++f) {
      cp_async_wait<NS - 2>();
      __syncthreads();   // chunk f has landed; stage (f - 1) % NS's last reader is done
      issue(f + NS - 1);
      if (!active) continue;
      if (c == 0) {
        ld<DH>(qt + ia * LDW + hh * DH, qa);
        ld<DH>(qt + ib * LDW + hh * DH, qb);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          qa[d] *= scale;
          qb[d] *= scale;
        }
      }
      const float* kp = smem + f % NS * SF + hh * DH;
      const float* vp = kp + KS * LDW;
      const int nk = min(KS, A2 - c * KS);
      auto chunk = [&](int j0, auto full) {
        float sa[KB], sb[KB];
        float ca = ma, cb = mb;
#pragma unroll
        for (int jj = 0; jj < KB; ++jj) {
          sa[jj] = sb[jj] = -CUDART_INF_F;
          if (decltype(full)::value || j0 + jj < nk) {
            float kr[DH];
            ld<DH>(kp + (j0 + jj) * LDW, kr);
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
          if (decltype(full)::value || j0 + jj < nk) {
            const float ea = expf(sa[jj] - ca), eb = expf(sb[jj] - cb);
            float vr[DH];
            ld<DH>(vp + (j0 + jj) * LDW, vr);
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
      chunks(nk, chunk);
    }
    if (active) {
      const float ia_ = 1.f / la, ib_ = 1.f / lb;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        oa[d] *= ia_;
        ob[d] *= ib_;
      }
      // the output over the thread's own q rows, which no other thread reads
      st<DH>(qt + ia * LDW + hh * DH, oa);
      if (ia + 1 < nq) st<DH>(qt + ib * LDW + hh * DH, ob);
      if constexpr (STATS) {
        MS[ia * HG + hh] = ma;
        LS[ia * HG + hh] = la;
        if (ia + 1 < nq) {
          MS[ib * HG + hh] = mb;
          LS[ib * HG + hh] = lb;
        }
      }
    }
    __syncthreads();
    store_cols<C, W, LDW>(out, qt, row0 + i0, nq, col0);
    if constexpr (STATS) {
      for (int i = tid; i < nq * HG; i += blockDim.x) {
        const size_t o = (row0 + i0 + i / HG) * H + col0 / DH + i % HG;
        m_out[o] = MS[i];
        l_out[o] = LS[i];
      }
    }
  }
}

// ---- backward: a query phase (D, dq), then a key phase (dk, dv) ------------
template <int DH, int HG, class IO = float>
__global__ void __launch_bounds__(NT_MAX)
    sweep_bwd_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                     const IO* __restrict__ v, const IO* __restrict__ dout,
                     const IO* __restrict__ out, const float* __restrict__ m_in,
                     const float* __restrict__ l_in, IO* __restrict__ dq_out,
                     IO* __restrict__ dk_out, IO* __restrict__ dv_out, int N, int A2,
                     int rounds, float scale) {
  constexpr int C = H * DH, W = HG * DH, LDW = W + 4, NG = H / HG;
  constexpr int SF = 2 * KS * LDW;           // a stage: k, v or q (scaled), dout [KS][LDW]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* SD = smem + NS * SF;                // [A2][HG] float4 {m, 1 / l, D, 0}
  const int tiles = N * NG, nc = (A2 + KS - 1) / KS, RC = rounds * nc;
  const int tid = threadIdx.x, nt = blockDim.x;
  // chunk f of the block's stream, tile f / (2 RC) (head group t % NG of
  // pixel t / NG): first RC chunks of (k, v) rows (the query phase's
  // rounds), then RC of (q, dout) rows (the key phase's); rows [c KS, c KS +
  // KS), c = f % nc, into stage f % NS
  auto issue = [&](int f) {
    const int t = blockIdx.x + f / (2 * RC) * gridDim.x, e = f % (2 * RC), c = e % nc;
    if (t < tiles) {
      const bool keys = e < RC;
      const size_t row0 = static_cast<size_t>(t / NG) * A2 + c * KS;
      const int col0 = t % NG * W, n = min(KS, A2 - c * KS);
      float* dst = smem + f % NS * SF;
      stage_cols<C, W, LDW>(dst, keys ? k : q, row0, n, col0);
      stage_cols<C, W, LDW>(dst + KS * LDW, keys ? v : dout, row0, n, col0);
    }
    cp_async_commit();
  };

  for (int f = 0; f < NS - 1; ++f) issue(f);
  int f = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const size_t row0 = static_cast<size_t>(t / NG) * A2;
    const int col0 = t % NG * W;

    // query phase: thread (head hh of the group, query i), queries fastest
    for (int r = 0; r < rounds; ++r) {
      const int item = r * nt + tid, i = item % A2, hh = item / A2;
      const bool active = hh < HG;
      const size_t o = (row0 + i) * C + col0 + hh * DH;
      float qs[DH], g[DH], ov[DH], dq[DH];
      float mi = 0.f, li = 1.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) qs[d] = g[d] = ov[d] = dq[d] = 0.f;
      if (active) {   // before the first stage's wait, so that the loads overlap it
        ldg<DH>(q + o, qs);
        ldg<DH>(dout + o, g);
        ldg<DH>(out + o, ov);
        mi = __ldg(m_in + (row0 + i) * H + col0 / DH + hh);
        li = __ldg(l_in + (row0 + i) * H + col0 / DH + hh);
      }
      float inv = 0.f, dsum = 0.f;
      for (int c = 0; c < nc; ++c, ++f) {
        cp_async_wait<NS - 2>();
        __syncthreads();   // also: the last tile's key phase is done with SD
        issue(f + NS - 1);
        if (!active) continue;
        if (c == 0) {
#pragma unroll
          for (int d = 0; d < DH; ++d) qs[d] *= scale;
          inv = 1.f / li;
          dsum = dot<DH>(g, ov);
          store4(SD + (i * HG + hh) * 4, make_float4(mi, inv, dsum, 0.f));
        }
        const float* kp = smem + f % NS * SF + hh * DH;
        const float* vp = kp + KS * LDW;
        const int nk = min(KS, A2 - c * KS);
        auto qchunk = [&](int j0, auto full) {
          float dc[DH] = {};
#pragma unroll
          for (int j = j0; j < j0 + KB; ++j) {
            if (decltype(full)::value || j < nk) {
              float kr[DH], vr[DH];
              ld<DH>(kp + j * LDW, kr);
              ld<DH>(vp + j * LDW, vr);
              const float ds = expf(dot<DH>(qs, kr) - mi) * inv * (dot<DH>(g, vr) - dsum);
#pragma unroll
              for (int d = 0; d < DH; ++d) dc[d] = fmaf(ds, kr[d], dc[d]);
            }
          }
#pragma unroll
          for (int d = 0; d < DH; ++d) dq[d] += dc[d];
        };
        chunks(nk, qchunk);
      }
      if (active) {
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] *= scale;
        st<DH>(dq_out + o, dq);
      }
    }

    // key phase: thread (head hh of the group, key j), keys fastest
    for (int r = 0; r < rounds; ++r) {
      const int item = r * nt + tid, j = item % A2, hh = item / A2;
      const bool active = hh < HG;
      const size_t o = (row0 + j) * C + col0 + hh * DH;
      float kme[DH], vme[DH], dk[DH], dv[DH];
#pragma unroll
      for (int d = 0; d < DH; ++d) kme[d] = vme[d] = dk[d] = dv[d] = 0.f;
      if (active) {
        ldg<DH>(k + o, kme);
        ldg<DH>(v + o, vme);
      }
      for (int c = 0; c < nc; ++c, ++f) {
        cp_async_wait<NS - 2>();
        __syncthreads();   // also: SD is complete
        issue(f + NS - 1);
        float* qp = smem + f % NS * SF;
        const int ni = min(KS, A2 - c * KS);
        for (int x = tid; x < ni * W; x += nt) qp[x / W * LDW + x % W] *= scale;
        __syncthreads();
        if (!active) continue;
        qp += hh * DH;
        const float* gp = qp + KS * LDW;
        const float* sd = SD + (c * KS * HG + hh) * 4;
        auto kchunk = [&](int i0, auto full) {
          float ck[DH] = {}, cv[DH] = {};
#pragma unroll
          for (int i = i0; i < i0 + KB; ++i) {
            if (decltype(full)::value || i < ni) {
              float qo[DH], go[DH];
              ld<DH>(qp + i * LDW, qo);
              ld<DH>(gp + i * LDW, go);
              const float4 s = load4(sd + i * HG * 4);
              const float pr = expf(dot<DH>(qo, kme) - s.x) * s.y;
              const float ds = pr * (dot<DH>(go, vme) - s.z);
#pragma unroll
              for (int d = 0; d < DH; ++d) {
                ck[d] = fmaf(ds, qo[d], ck[d]);
                cv[d] = fmaf(pr, go[d], cv[d]);
              }
            }
          }
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dk[d] += ck[d];
            dv[d] += cv[d];
          }
        };
        chunks(ni, kchunk);
      }
      if (active) {
        st<DH>(dk_out + o, dk);
        st<DH>(dv_out + o, dv);
      }
    }
  }
}

template <class IO = float>
using FwdKernelIO = void (*)(const IO*, const IO*, const IO*, IO*, float*, float*, int, int, int,
                             int, float);
template <class IO = float>
using BwdKernelIO = void (*)(const IO*, const IO*, const IO*, const IO*, const IO*,
                             const float*, const float*, IO*, IO*, IO*, int, int, int, float);

// The instances: past 128 views the forward's groups are 1 or 2 heads (2 at
// dh = 2); the backward takes every A2, so every group.
template <bool STATS, class IO = float>
FwdKernelIO<IO> fwd_kernel(int DH, int HG) {
  switch (DH * 16 + HG) {
    case 2 * 16 + 2: return sweep_fwd_kernel<2, 2, STATS, IO>;
    case 4 * 16 + 1: return sweep_fwd_kernel<4, 1, STATS, IO>;
    case 4 * 16 + 2: return sweep_fwd_kernel<4, 2, STATS, IO>;
    case 8 * 16 + 1: return sweep_fwd_kernel<8, 1, STATS, IO>;
    case 8 * 16 + 2: return sweep_fwd_kernel<8, 2, STATS, IO>;
    default: return nullptr;
  }
}

inline bool bad_shape(int N, int A2, int C, int heads) {
  return heads != H || N < 1 || A2 < 1 || C % H || C / H > 8;
}

template <class IO = float>
BwdKernelIO<IO> bwd_kernel(int DH, int HG) {
  switch (DH * 16 + HG) {
    case 2 * 16 + 2: return sweep_bwd_kernel<2, 2, IO>;
    case 2 * 16 + 4: return sweep_bwd_kernel<2, 4, IO>;
    case 2 * 16 + 8: return sweep_bwd_kernel<2, 8, IO>;
    case 4 * 16 + 1: return sweep_bwd_kernel<4, 1, IO>;
    case 4 * 16 + 2: return sweep_bwd_kernel<4, 2, IO>;
    case 4 * 16 + 4: return sweep_bwd_kernel<4, 4, IO>;
    case 4 * 16 + 8: return sweep_bwd_kernel<4, 8, IO>;
    case 8 * 16 + 1: return sweep_bwd_kernel<8, 1, IO>;
    case 8 * 16 + 2: return sweep_bwd_kernel<8, 2, IO>;
    case 8 * 16 + 4: return sweep_bwd_kernel<8, 4, IO>;
    case 8 * 16 + 8: return sweep_bwd_kernel<8, 8, IO>;
    default: return nullptr;
  }
}

template <class IO = float>
int sweep_bwd(const named_t<IO>* q, const named_t<IO>* k, const named_t<IO>* v,
              const named_t<IO>* dout, const named_t<IO>* out, const float* m, const float* l,
              named_t<IO>* dq, named_t<IO>* dk, named_t<IO>* dv, int N, int A2, int C,
              int heads, float scale, cudaStream_t s) {
  if (bad_shape(N, A2, C, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdGeo g = bwd_geo(A2, C);
  const BwdKernelIO<IO> kernel = bwd_kernel<IO>(C / H, g.HG);
  const long long tiles = static_cast<long long>(N) * (H / g.HG);
  if (!kernel || g.bytes > SMEM_MAX || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  if (const int e = persistent_grid(kernel, g.nt, g.bytes, static_cast<int>(tiles), &grid))
    return e;
  kernel<<<grid, g.nt, g.bytes, s>>>(q, k, v, dout, out, m, l, dq, dk, dv, N, A2, g.rounds,
                                     scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS, class IO = float>
int sweep_fwd(const named_t<IO>* q, const named_t<IO>* k, const named_t<IO>* v,
              named_t<IO>* out, float* m, float* l, int N, int A2, int C, int heads, float scale,
              cudaStream_t s) {
  // A2 <= 128 is K7's (and a q buffer's next use needs NS - 1 stages a tile)
  if (bad_shape(N, A2, C, heads) || A2 <= 128) return static_cast<int>(cudaErrorInvalidValue);
  const FwdGeo g = fwd_geo(A2, C, STATS);
  const FwdKernelIO<IO> kernel = fwd_kernel<STATS, IO>(C / H, g.HG);
  const long long tiles = static_cast<long long>(N) * (H / g.HG) * g.NQB;
  if (!kernel || g.bytes > SMEM_MAX || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  if (const int e = persistent_grid(kernel, g.nt, g.bytes, static_cast<int>(tiles), &grid))
    return e;
  kernel<<<grid, g.nt, g.bytes, s>>>(q, k, v, out, m, l, N, A2, g.QBP, g.NQB, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [N, A2, C], C = 8 heads x {2, 4, 8}, A2 > 128 (K7's kernels
// take the rest). Each returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int lft_ang_attn_sweep(const float* q, const float* k, const float* v, float* out,
                                  int N, int A2, int C, int heads, float scale, void* stream) {
  return sweep_fwd<false>(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                          static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [N, A2, 8] (with out, the residuals of the backward).
extern "C" int lft_ang_attn_sweep_res(const float* q, const float* k, const float* v,
                                      float* out, float* m, float* l, int N, int A2, int C,
                                      int heads, float scale, void* stream) {
  return sweep_fwd<true>(q, k, v, out, m, l, N, A2, C, heads, scale,
                         static_cast<cudaStream_t>(stream));
}

// The forward's bf16-IO instance (the header): q, k, v, out bf16 [N, A2, C].
extern "C" int lft_ang_attn_sweep_bf16io(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                         int N, int A2, int C, int heads, float scale,
                                         void* stream) {
  return sweep_fwd<false, bf16>(q, k, v, out, nullptr, nullptr, N, A2, C, heads, scale,
                                static_cast<cudaStream_t>(stream));
}

// Any A2 whose {m, 1 / l, D} of a head group fit a block's shared memory.
extern "C" int lft_ang_attn_sweep_bwd(const float* q, const float* k, const float* v,
                                      const float* dout, const float* out, const float* m,
                                      const float* l, float* dq, float* dk, float* dv, int N,
                                      int A2, int C, int heads, float scale, void* stream) {
  return sweep_bwd(q, k, v, dout, out, m, l, dq, dk, dv, N, A2, C, heads, scale,
                   static_cast<cudaStream_t>(stream));
}

// The `_res` form in bf16 IO past 128 views (`ang_attn_sweep_res_bf16io`,
// the header): q, k, v, out bf16, m, l f32 [N, A2, 8].
extern "C" int lft_ang_attn_sweep_res_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                             bf16* out, float* m, float* l, int N, int A2,
                                             int C, int heads, float scale, void* stream) {
  return sweep_fwd<true, bf16>(q, k, v, out, m, l, N, A2, C, heads, scale,
                               static_cast<cudaStream_t>(stream));
}

// The backward in bf16 IO at every A2 (`ang_attn_sweep_bwd_bf16io`, the
// header): q, k, v, dout, out and dq, dk, dv bf16; D from the saved bf16
// out.
extern "C" int lft_ang_attn_sweep_bwd_bf16io(const bf16* q, const bf16* k, const bf16* v,
                                             const bf16* dout, const bf16* out, const float* m,
                                             const float* l, bf16* dq, bf16* dk, bf16* dv, int N,
                                             int A2, int C, int heads, float scale,
                                             void* stream) {
  return sweep_bwd<bf16>(q, k, v, dout, out, m, l, dq, dk, dv, N, A2, C, heads, scale,
                         static_cast<cudaStream_t>(stream));
}
