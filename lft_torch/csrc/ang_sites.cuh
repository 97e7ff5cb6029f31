// K1's site-subset forms, `ang_block_sites` and `ang_block_res_sites`
// (`--dtype mixed` under an LFT_MM_HP_SITES subset that rounds some of K1's
// five sites and not others, f32 IO). Replaces lft_tpu/kernels/
// ang_block.py:_core_fwd / _kernel (:110-152) under mm_half with that plan,
// as ang_bf16.cuh replaces it where every site rounds.
//
// The function, per pixel over its A2 <= 128 view tokens of width C, 8
// heads of dh = C / 8 (kernels/ang_block.py: _ang_block_planned; R_s(t):
// t rounded to bf16 where site s rounds, else t): xn = LN1(x + pe); q =
// R(xn) R(Wq), k = R(xn) R(Wk), v = R(x) R(Wv) at `aqkv`; scores (R(q) .
// R(k)) scale at `ascore`; m each token's max over every head and key; e =
// exp(s - m), l the sum of the unrounded e; a = (R(e) R(v)) / l at `aav`; x2
// = R(a) R(Wo) + x at `awo`; hid = relu(R(LN2(x2)) R(W1)), out = R(hid) R(W2)
// + x2 at `affn`. RES also writes m (the token's max, in every head's slot),
// l [N, A2, 8] and attn = R_awo(a) [N, A2, C]; its out is the forward's bit
// for bit (the same code, more stores).
//
// The mask is a launch argument (tf32.cuh: S_AQKV .. S_AFFN): one kernel
// for every mask, each product and each attention path chosen by a uniform
// branch. The host sizes and places shared memory from it (`AngSitesPlan`).
// The design is ang_bf16.cuh's (persistent blocks of RG_M = 128 token rows,
// P = 128 / A2 whole pixels a tile; the warp's rows of x, xn, x2, LN2(x2)
// and y in the accumulator layout; the attention a warp an item (pixel, 16
// queries, head group) on `mma.sync`, a max pass, then e, l and e v):
// * A product whose site rounds: bf16 `wgmma` with A from registers
//   (`acc_to_a`, or ldmatrix of the rounded attention output) on its weight
//   rounded to bf16 once a launch and resident in shared memory.
// * A product whose site stays f32: 3xTF32 `wgmma` on its weight split into
//   TF32 hi/lo once a launch (all six split are 256 KB at C = 64: no room
//   beside the rows): the groups Wv-Wk, Wo and the FFN resident in that
//   order while they fit, the rest streamed through a run-time `MbarRing`
//   (`AngSitesPlan`; S1 holds Wv-Wk resident and streams nothing, S2 holds
//   Wo and streams the FFN). A from the accumulators (x, xn, LN2(x2): the
//   weight's rows in `ffn_sites_k` order) or from rows in shared memory (the
//   attention output; LN2(x2) and relu(hid), a hidden chunk at a time, over
//   the warp's own rows of q and of k where both are f32 at C = 64, else
//   LN2(x2) from registers and the chunk over k and v behind a barrier a
//   tile). A product runs two chains, the even and the odd k8 steps, their
//   `wgmma`s alternating (`tf3_product`): one chain of three dependent
//   passes a k8 step left the tensor cores waiting (this design's first
//   version: S1 0.60 ms, S2 0.78). Resident Wv, Wq, Wk run as one product of
//   three chains (`tf3_qkv`); bf16 ones too, their k16 steps alternating.
// * The scores: bf16 `mma.sync.m16n8k8` where `ascore` rounds (q and k held
//   bf16), else 3xTF32 `mma.sync.m16n8k8` tf32 on hi/lo splits (q and k
//   held f32); e v: bf16 m16n8k16 over bf16(e) where `aav` rounds (v bf16,
//   B by ldmatrix.trans), else 3xTF32 m16n8k8 over 8 keys, e's C fragments
//   the A fragments with the keys in the order the lanes hold them (k = q4
//   <-> key 2 q4, k = q4 + 4 <-> key 2 q4 + 1: v's B fragments read to
//   match). e = 2^(s scale log2(e) - m log2(e)) by the SFU (ang_bf16.cuh:
//   ex2). The attention output (and the residual attn) is rounded where
//   `awo` rounds; held bf16 or f32 to match, over q where q's format is the
//   same (an item reads its own q rows, and only its own, before it writes
//   them; a pixel's last 16 queries may read the next pixel's rows as
//   padding, whose results are not stored).
// * x is read straight into registers (its next tile prefetched into L2),
//   and again from L2 for x2's residual before the Wo product.
// Sums: a bf16 product's over its whole K in the tensor cores' f32
// accumulators; a 3xTF32 one's in two chains, its even and its odd k8
// steps (32 of K each at C = 64), added in f32; a score
// over the head's channels in one MMA (three under 3xTF32); l and o as
// ang_bf16.cuh's. These differ from the plain version's order (the limits do
// not). Bound at [16384, 25, 64]: the products at the bf16 rate where their
// site rounds and 3xTF32 at the TF32 rate where it does not; x in and out
// f32, 0.0626 ms of bytes. The design before this one (ang_block_kernel with
// SITES: every weight split and streamed through WeightRing for every
// 128-row tile, each product one TF32 pass over rounded operands or
// 3xTF32, the attention a thread an item on the FP32 pipes with a max pass
// through shared memory) took 0.7681 ms under S1 and 0.8480 under S2 on an
// H100 at 700 W. Shared memory at C = 64:
//   S1 222,208 bytes (Wv-Wk resident, no ring), S2 224,320 (Wo resident, 4
//   ring slots for the FFN),
// every mask with three slots or more where it streams. One block of 256
// threads an SM.
// Every output is written by one thread of one block, no atomics: a call
// repeats bitwise.
#pragma once

#include "ang_bf16.cuh"
#include "bf16mma.cuh"
#include "ffn_sites.cuh"
#include "rowgemm.cuh"

namespace lft {

constexpr int ANG_SITES = S_AQKV | S_ASCORE | S_AAV | S_AWO | S_AFFN;

template <int C>
struct AngSites {
  static constexpr int H = 8, DH = C / H;
  static constexpr int HPC = 8 / DH;                  // heads a chunk of 8 channels
  static constexpr int NG = C / 16;                   // head groups (two chunks) of the attention
  static constexpr int HG = H / NG;                   // heads a group
  static constexpr int HC = 2 * C < 64 ? 2 * C : 64;  // hidden columns a chunk
  static constexpr int NH = 2 * C / HC;               // chunks
  static constexpr int SQ = C * C;
  static constexpr int LDB = C + 8, LDF = C + 4, LDH = HC + 4;   // row strides: bf16, f32, hid
  static constexpr int ROWS = RG_M + 16;              // rows of q, k, v
  // the stream: a C x C weight split, a hidden chunk's W1[:, c] and W2[c, :]
  static constexpr int PS = 2 * SQ, PW1 = 2 * C * HC, PW2 = 2 * HC * C;
  static constexpr int ALIGN = 32 * (C > HC ? C : HC);   // a piece starts on a chain of 16 of K
  // the scratch: the rounded weights (at most 8 C^2 bf16 values), then the stream
  static constexpr int BF_FLOATS = 4 * SQ;
  static constexpr int FLOATS = BF_FLOATS + 16 * SQ + 6 * ALIGN;
};

// A launch's layout, from its mask (the host's `ang_sites_plan`;
// kernels/rowgemm.py: ang_sites_plan): the rounded weights' bf16 offsets
// (compacted in the order Wv, Wq, Wk, Wo, W1, W2; -1 where f32); the split
// ones' stream offsets (Wv, Wq, Wk, Wo, then the FFN's chunks W1[:, c],
// W2[c, :]; -1 where rounded), of which the groups Wv-Wk, Wo and the FFN
// are held resident in that order while they fit (`res` floats of the
// stream, with three ring slots left if a group still streams) and the rest
// stream through the ring from `rb`; shared memory's byte offsets.
struct AngSitesPlan {
  int mask;
  int bw[6];       // bf16 offsets of Wv, Wq, Wk, Wo, W1, W2
  int sw[5];       // stream offsets of Wv, Wq, Wk, Wo and the FFN's first chunk
  int res, rb;     // floats of the stream held resident; where the ring's part starts
  int stream;      // floats of the stream
  int rbase;       // the resident split weights in shared memory, past the bf16 ones
  int wbytes;      // all resident weights
  int q, k, v, ao, mh, hid, ring, ns, bytes;   // shared memory
  int hid_kv;      // a hidden chunk lies over k and v (a barrier at each tile's start)
  int rows;        // LN2(x2) over q's rows and a hidden chunk over k's, each warp its own
};

template <int C>
AngSitesPlan ang_sites_plan(int mask) {
  using L = AngSites<C>;
  AngSitesPlan p{};
  p.mask = mask;
  const int site[6] = {S_AQKV, S_AQKV, S_AQKV, S_AWO, S_AFFN, S_AFFN};
  const int elems[6] = {L::SQ, L::SQ, L::SQ, L::SQ, 2 * L::SQ, 2 * L::SQ};
  auto up = [](int v, int a) { return (v + a - 1) / a * a; };
  int b = 0, s = 0;
  for (int i = 0; i < 6; ++i) {
    p.bw[i] = mask & site[i] ? b : -1;
    if (mask & site[i]) b += elems[i];
  }
  int end[5];   // each piece's end on the stream
  for (int i = 0; i < 5; ++i) {
    p.sw[i] = mask & site[i] ? -1 : up(s, L::ALIGN);
    if (!(mask & site[i])) s = p.sw[i] + (i < 4 ? L::PS : L::NH * (L::PW1 + L::PW2));
    end[i] = s;
  }
  p.stream = s;
  const bool qb = mask & S_ASCORE, vb = mask & S_AAV, ob = mask & S_AWO;
  const int row16 = L::LDB * 2, row32 = L::LDF * 4;
  const int qbytes = L::ROWS * (qb ? row16 : row32), vbytes = L::ROWS * (vb ? row16 : row32);
  // where `affn` is f32 and q, k are f32 rows at a hidden chunk's row
  // stride (C = 64), LN2(x2) over q's rows and a hidden chunk over k's, a
  // warp's own rows, dead after the attention; else LN2(x2) in registers
  // and a hidden chunk over k and v, a barrier a tile
  p.rows = !(mask & S_AFFN) && !qb && L::LDF == L::LDH;
  p.hid_kv = !(mask & S_AFFN) && !p.rows;
  const int hbytes = p.hid_kv ? RG_M * L::LDH * 4 : 0;
  const int kv = qbytes + vbytes > hbytes ? qbytes + vbytes : hbytes;
  const int tiles = up(qbytes + kv + (qb != ob ? RG_M * (ob ? row16 : row32) : 0) +
                       L::ROWS * L::NG * 4, 16);
  p.rbase = up(2 * b, 16);
  const int slot = RG_SF * 4 + 16;
  const int group_end[3] = {end[2], end[3], end[4]};   // Wv-Wk, Wo, the FFN
  for (int g = 0; g < 3; ++g) {
    if (group_end[g] == (g ? group_end[g - 1] : 0)) continue;   // rounded
    const int streams_after = group_end[g] < s ? 3 * slot : 0;
    if (p.rbase + 4 * group_end[g] + tiles + streams_after > RG_SMEM_MAX) break;
    p.res = group_end[g];
  }
  p.rb = up(p.res, L::ALIGN);
  p.wbytes = p.rbase + 4 * p.res;
  p.q = p.wbytes;
  p.k = p.q + qbytes;
  p.v = p.k + qbytes;
  p.hid = p.k;
  int o = p.k + kv;
  p.ao = qb == ob ? p.q : o;                     // the attention output over q
  if (qb != ob) o += RG_M * (ob ? row16 : row32);
  p.mh = o;
  p.ring = up(o + L::ROWS * L::NG * 4, 16);
  const int left = (RG_SMEM_MAX - p.ring) / slot;
  p.ns = s == p.res ? 0 : left < 8 ? left : 8;
  p.bytes = p.ring + p.ns * slot;
  return p;
}

// The launch's weights into wf, each element once: those of a rounding
// site to bf16 at their plan offsets (ang_bf16_weights_kernel's layout),
// the others split into TF32 hi/lo on the stream at wf + BF_FLOATS
// (rowgemm.cuh's layout), per hidden chunk for W1 and W2; Wv, Wq, Wk and,
// but where p.rows, W1 with their rows in `ffn_sites_k` order (their
// products take A from accumulators), Wo and W2 as they are (A from rows in
// shared memory) (kernels/rowgemm.py: ang_sites_stream).
template <int C>
__global__ void __launch_bounds__(256)
    ang_sites_weights_kernel(const float* __restrict__ wv, const float* __restrict__ wq,
                             const float* __restrict__ wk, const float* __restrict__ wo,
                             const float* __restrict__ w1, const float* __restrict__ w2,
                             float* __restrict__ wf, AngSitesPlan p) {
  using L = AngSites<C>;
  constexpr int SQ = L::SQ, HC = L::HC;
  bf16* wb = reinterpret_cast<bf16*>(wf);
  float* ws = wf + L::BF_FLOATS;
  auto lrow = [](int r) { return 8 * (r / 8) + r % 8 % 2 * 4 + r % 8 / 2; };   // ffn_sites_k⁻¹
  const int site[6] = {S_AQKV, S_AQKV, S_AQKV, S_AWO, S_AFFN, S_AFFN};
  for (int i = blockIdx.x * 256 + threadIdx.x; i < 8 * SQ; i += gridDim.x * 256) {
    const int which = i < 4 * SQ ? i / SQ : i < 6 * SQ ? 4 : 5;
    const int e = i - (which < 4 ? which * SQ : which == 4 ? 4 * SQ : 6 * SQ);
    const int N = which == 4 ? 2 * C : C, k = e / N, n = e % N;
    const float* src = which == 0 ? wv : which == 1 ? wq : which == 2 ? wk
                     : which == 3 ? wo : which == 4 ? w1 : w2;
    const float v = __ldg(src + e);
    if (p.mask & site[which]) {
      wb[p.bw[which] + ((k / 16 * 2 + k % 16 / 8) * (N / 8) + n / 8) * 64 + n % 8 * 8 + k % 8] =
          __float2bfloat16_rn(v);
      continue;
    }
    // the piece's offset, width and (logical) row of the element
    int off, pn, kr, nc;
    if (which < 4) {
      off = p.sw[which], pn = C, kr = which == 3 ? k : lrow(k), nc = n;
    } else if (which == 4) {   // W1: A from LN2(x2)'s rows where p.rows
      off = p.sw[4] + n / HC * (L::PW1 + L::PW2), pn = HC, kr = p.rows ? k : lrow(k), nc = n % HC;
    } else {
      off = p.sw[4] + k / HC * (L::PW1 + L::PW2) + L::PW1, pn = C, kr = k % HC, nc = n;
    }
    uint32_t hi, lo;
    split_tf32_rn(v, hi, lo);
    const int at = off + (((kr / 8) * 4 + kr % 8 / 4) * (pn / 8) + nc / 8) * 32 + nc % 8 * 4 +
                   kr % 4;
    ws[at] = __uint_as_float(hi);
    ws[at + 8 * pn] = __uint_as_float(lo);
  }
}

// The attention of a tile (pass 1, a barrier, pass 2), ang_bf16.cuh's items
// and lanes: q, k as bf16 (SB, `ascore` rounds) or f32 rows, v as bf16 (VB,
// `aav` rounds) or f32 rows; the output (rounded where `ob`) into AO, bf16
// or f32 as ob says, and with RES the residuals.
template <int C, bool SB, bool VB, bool RES>
__device__ __forceinline__ void ang_sites_attention(
    unsigned char* sm, const AngSitesPlan& p, bool ob, int np, int A2, float scale, size_t row0,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ attn_out) {
  using L = AngSites<C>;
  constexpr int H = L::H, DH = L::DH, HPC = L::HPC, NG = L::NG, HG = L::HG;
  constexpr int LDB = L::LDB, LDF = L::LDF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const bf16* Qb = reinterpret_cast<const bf16*>(sm + p.q);
  const bf16* Kb = reinterpret_cast<const bf16*>(sm + p.k);
  const bf16* Vb = reinterpret_cast<const bf16*>(sm + p.v);
  const float* Qf = reinterpret_cast<const float*>(sm + p.q);
  const float* Kf = reinterpret_cast<const float*>(sm + p.k);
  const float* Vf = reinterpret_cast<const float*>(sm + p.v);
  float* MH = reinterpret_cast<float*>(sm + p.mh);   // [ROWS][NG]: pass 1's maxima
  const int MT = (A2 + 15) / 16;                      // items (and key steps) a pixel and group
  const int items = np * MT * NG;
  // channel c of a chunk of 8 belongs to head c / DH of the chunk
  auto mine = [&](int e) { return (2 * q4) / DH == e % HPC; };
  auto mine_tf = [&](int e, int c) { return c / DH == e % HPC; };
  // the item's q: SB m16n8k8 bf16 A fragments of each head (other heads'
  // channels 0); else the group's two chunks split, rows g, g + 8 and
  // channels q4, q4 + 4 (m16n8k8 tf32 A fragments), masked per head at use
  struct Q {
    uint32_t f[SB ? HG : 1][2];
    uint32_t hi[SB ? 1 : 2][4], lo[SB ? 1 : 2][4];
  };
  auto item_of = [&](int item, int& base, int& i0, int& grp, Q& qv) {
    grp = item % NG;
    base = item / NG / MT * A2;
    i0 = 16 * (item / NG % MT);
    const int r0 = base + i0 + g;
    if constexpr (SB) {
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const int e = grp * HG + hh;
        const int at = r0 * LDB + 8 * (e / HPC) + 2 * q4;
        qv.f[hh][0] = mine(e) ? *reinterpret_cast<const uint32_t*>(Qb + at) : 0u;
        qv.f[hh][1] = mine(e) ? *reinterpret_cast<const uint32_t*>(Qb + at + 8 * LDB) : 0u;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* a = Qf + r0 * LDF + 8 * (2 * grp + u) + q4;
        split_tf32_rn(a[0], qv.hi[u][0], qv.lo[u][0]);
        split_tf32_rn(a[8 * LDF], qv.hi[u][1], qv.lo[u][1]);
        split_tf32_rn(a[4], qv.hi[u][2], qv.lo[u][2]);
        split_tf32_rn(a[8 * LDF + 4], qv.hi[u][3], qv.lo[u][3]);
      }
    }
  };
  // k of keys k0 .. k0 + 15, the group's two chunks: SB ldmatrix (kb[2 u]
  // keys k0 .. k0 + 7 of chunk u, kb[2 u + 1] the next 8); else the m16n8k8
  // tf32 B fragments (key k0 + 8 half + g, channels q4, q4 + 4) split
  struct Kf_ {
    uint32_t b[SB ? 4 : 1];
    uint32_t hi[SB ? 1 : 2][2][2], lo[SB ? 1 : 2][2][2];
  };
  auto keys = [&](int base, int k0, int grp, Kf_& kv) {
    if constexpr (SB) {
      ldmatrix_x4(kv.b, Kb + (base + k0 + (lane & 15)) * LDB + 8 * (2 * grp + (lane >> 4)));
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* a = Kf + (base + k0 + 8 * hf + g) * LDF + 8 * (2 * grp + u) + q4;
          split_tf32_rn(a[0], kv.hi[u][hf][0], kv.lo[u][hf][0]);
          split_tf32_rn(a[4], kv.hi[u][hf][1], kv.lo[u][hf][1]);
        }
    }
  };
  // c += a b over one m16n8k8 tile, 3xTF32: al bh + ah bl + ah bh
  auto tf3 = [](float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
    mma_tf32(c, al, bh[0], bh[1]);
    mma_tf32(c, ah, bl[0], bl[1]);
    mma_tf32(c, ah, bh[0], bh[1]);
  };
  // head hh's scores against keys k0 .. k0 + 15: s0[i] is query g + 8 (i /
  // 2) and key k0 + 2 q4 + i % 2, s1 the same 8 keys on
  auto scores = [&](const Q& qv, int hh, const Kf_& kv, float (&s0)[4], float (&s1)[4]) {
    const int u = hh / HPC;
#pragma unroll
    for (int i = 0; i < 4; ++i) s0[i] = s1[i] = 0.f;
    if constexpr (SB) {
      mma_bf16_k8(s0, qv.f[hh], kv.b[2 * u]);
      mma_bf16_k8(s1, qv.f[hh], kv.b[2 * u + 1]);
    } else {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // a0, a1 channel q4; a2, a3 channel q4 + 4
        const bool on = mine_tf(hh, q4 + 4 * (i >> 1));
        ah[i] = on ? qv.hi[u][i] : 0u;
        al[i] = on ? qv.lo[u][i] : 0u;
      }
      tf3(s0, ah, al, kv.hi[u][0], kv.lo[u][0]);
      tf3(s1, ah, al, kv.hi[u][1], kv.lo[u][1]);
    }
  };

  for (int item = warp; item < items; item += RG_NT / 32) {   // pass 1
    int base, i0, grp;
    Q qv;
    item_of(item, base, i0, grp, qv);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int k0 = 0; k0 < A2; k0 += 16) {
      Kf_ kv;
      keys(base, k0, grp, kv);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        float s0[4], s1[4];
        scores(qv, hh, kv, s0, s1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 2 * q4 + (i & 1);
          if (key < A2) mx[i >> 1] = fmaxf(mx[i >> 1], s0[i]);
          if (key + 8 < A2) mx[i >> 1] = fmaxf(mx[i >> 1], s1[i]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (q4 == 0 && i0 + g + 8 * h < A2) MH[(base + i0 + g + 8 * h) * NG + grp] = mx[h];
    }
  }
  __syncthreads();
  bf16* AOb = reinterpret_cast<bf16*>(sm + p.ao);
  float* AOf = reinterpret_cast<float*>(sm + p.ao);
  for (int item = warp; item < items; item += RG_NT / 32) {   // pass 2
    int base, i0, grp;
    Q qv;
    item_of(item, base, i0, grp, qv);
    float m[2], ml[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* mh = MH + (base + i0 + g + 8 * h) * NG;
      float mx = mh[0];
#pragma unroll
      for (int j = 1; j < NG; ++j) mx = fmaxf(mx, mh[j]);
      m[h] = mx * scale;
      ml[h] = m[h] * kLog2e;
    }
    const float sl = scale * kLog2e;
    float o[HG][4], l[HG][2];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      o[hh][0] = o[hh][1] = o[hh][2] = o[hh][3] = 0.f;
      l[hh][0] = l[hh][1] = 0.f;
    }
    for (int k0 = 0; k0 < A2; k0 += 16) {
      Kf_ kv;
      keys(base, k0, grp, kv);
      // v of keys k0 .. k0 + 15: VB ldmatrix.trans (vb[2 u], vb[2 u + 1] chunk
      // u's B fragments of m16n8k16); else m16n8k8 tf32 B fragments, n =
      // channel g of chunk u, k = q4 / q4 + 4 <-> keys 2 q4 / 2 q4 + 1 of
      // each 8
      uint32_t vb[VB ? 4 : 1];
      uint32_t vh[VB ? 1 : 2][2][2], vl[VB ? 1 : 2][2][2];
      if constexpr (VB) {
        ldmatrix_x4_trans(vb, Vb + (base + k0 + (lane & 15)) * LDB + 8 * (2 * grp + (lane >> 4)));
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float* a = Vf + (base + k0 + 8 * hf + 2 * q4) * LDF + 8 * (2 * grp + u) + g;
            split_tf32_rn(a[0], vh[u][hf][0], vl[u][hf][0]);
            split_tf32_rn(a[LDF], vh[u][hf][1], vl[u][hf][1]);
          }
      }
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        const int u = hh / HPC;
        float s0[4], s1[4];
        scores(qv, hh, kv, s0, s1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 2 * q4 + (i & 1);
          s0[i] = key < A2 ? ex2(fmaf(s0[i], sl, -ml[i >> 1])) : 0.f;
          s1[i] = key + 8 < A2 ? ex2(fmaf(s1[i], sl, -ml[i >> 1])) : 0.f;
          l[hh][i >> 1] += s0[i];
          l[hh][i >> 1] += s1[i];
        }
        if constexpr (VB) {
          const uint32_t pa[4] = {narrow2(s0[0], s0[1]), narrow2(s0[2], s0[3]),
                                  narrow2(s1[0], s1[1]), narrow2(s1[2], s1[3])};
          mma_bf16(o[hh], pa, vb[2 * u], vb[2 * u + 1]);
        } else {
          // A (g, k q4) is key 2 q4, (g, k q4 + 4) key 2 q4 + 1
          auto ev = [&](const float (&e)[4], int hf) {
            uint32_t eh[4], el[4];
            split_tf32_rn(e[0], eh[0], el[0]);
            split_tf32_rn(e[2], eh[1], el[1]);
            split_tf32_rn(e[1], eh[2], el[2]);
            split_tf32_rn(e[3], eh[3], el[3]);
            tf3(o[hh], eh, el, vh[u][hf], vl[u][hf]);
          };
          ev(s0, 0);
          ev(s1, 1);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const int e = grp * HG + hh;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[hh][h] += __shfl_xor_sync(0xffffffffu, l[hh][h], 1);
        l[hh][h] += __shfl_xor_sync(0xffffffffu, l[hh][h], 2);
      }
      const int col = 8 * (e / HPC) + 2 * q4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + g + 8 * h;
        if (i >= A2) continue;
        const float inv = 1.f / l[hh][h];
        float a0 = o[hh][2 * h] * inv, a1 = o[hh][2 * h + 1] * inv;
        if (ob) {
          a0 = bf16_round(a0);
          a1 = bf16_round(a1);
        }
        if (mine(e)) {
          if (ob)
            *reinterpret_cast<uint32_t*>(AOb + (base + i) * LDB + col) = narrow2(a0, a1);
          else
            *reinterpret_cast<float2*>(AOf + (base + i) * LDF + col) = make_float2(a0, a1);
          if constexpr (RES) st2(attn_out + (row0 + base + i) * C + col, a0, a1);
        }
        if constexpr (RES) {   // from the lane of the head's first channels
          if (2 * q4 == e % HPC * DH) {
            m_out[(row0 + base + i) * H + e] = m[h];
            l_out[(row0 + base + i) * H + e] = l[hh][h];
          }
        }
      }
    }
  }
}

// Keeps the compiler from reusing a fragment's registers while the
// asynchronous products that read them may still run.
template <int R>
__device__ __forceinline__ void reg_fence_u(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// A product of the warpgroup's 64 rows, K x N (N <= 64), 3xTF32 (as
// ffn_sites.cuh's rg_product_a): B from `res` (the piece resident in shared
// memory) or, where res is null, from the ring at stream offset `off`, its
// stages entered before the first `wgmma` (the ring's waits and its thread
// 0's copies between products in flight made ptxas serialize every `wgmma`
// of the kernel); the TF32 hi and lo A fragments of k8 step kk from af(kk,
// hi, lo). Two chains, the even and the odd k8 steps of the K, in the
// tensor cores' accumulators, their passes alternating so that no `wgmma`
// waits on the one before it; epi(s0, s1) takes them (an element's product
// s0[i] + s1[i]).
template <int K, int N, class AF, class EPI>
__device__ __forceinline__ void tf3_product(AF af, const float* res, MbarRing<0>& ring,
                                            const float*& st, int off, EPI epi) {
  constexpr int NC = K / 16, CHAIN = 32 * N, LBO = N / 8 * 128, SBO = 128;
  static_assert(K % 16 == 0 && N % 16 == 0 && N <= 64, "unsupported product shape");
  uint32_t ah[2][2][4], al[2][2][4];   // [buffer][k8 step][fragment]
  float s0[N / 2], s1[N / 2];
  const float* bs[NC];                 // each 16 of K's B
  auto load_a = [&](int c, int b) {
#pragma unroll
    for (int u = 0; u < 2; ++u) af(2 * c + u, ah[b][u], al[b][u]);
  };
  auto issue = [&](int c) {
    const uint64_t h0 = smem_desc(bs[c], LBO, SBO), h1 = h0 + 4 * N;   // k8 steps' hi; lo 2 N on
    const int b = c & 1;
    reg_fence(s0);
    reg_fence(s1);
    wgmma_fence();
    Wgmma<N>::mma(s0, al[b][0], h0, c > 0);
    Wgmma<N>::mma(s1, al[b][1], h1, c > 0);
    Wgmma<N>::mma(s0, ah[b][0], h0 + 2 * N, 1);
    Wgmma<N>::mma(s1, ah[b][1], h1 + 2 * N, 1);
    Wgmma<N>::mma(s0, ah[b][0], h0, 1);
    Wgmma<N>::mma(s1, ah[b][1], h1, 1);
    wgmma_commit();
  };
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!res && (off + c * CHAIN) % RG_SF == 0) st = ring.enter();
    bs[c] = res ? res + c * CHAIN : st + (off + c * CHAIN) % RG_SF;
  }
  load_a(0, 0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    issue(c);
    if (c > 0) {
      wgmma_wait<1>();
      reg_fence_u(ah[(c - 1) & 1][0]);   // read by the group just retired
      reg_fence_u(ah[(c - 1) & 1][1]);
      reg_fence_u(al[(c - 1) & 1][0]);
      reg_fence_u(al[(c - 1) & 1][1]);
    }
    if (c + 1 < NC) load_a(c + 1, (c + 1) & 1);
  }
  wgmma_wait<0>();
  reg_fence(s0);
  reg_fence(s1);
  epi(s0, s1);
}

// v, q, k = x Wv, xn Wq, xn Wk, 3xTF32 on resident split weights (rows in
// `ffn_sites_k` order), A from the accumulator layout of x and xn: a commit
// group a k8 step, the three products' passes alternating (no `wgmma` waits
// on the one before it), one group in flight while the next step's
// fragments split. A product's sums over its K = C in one chain.
template <int C>
__device__ __forceinline__ void tf3_qkv(const float (&xr)[C / 2], const float (&xn)[C / 2],
                                        const float* wv, const float* wq, const float* wk,
                                        float (&va)[C / 2], float (&qa)[C / 2],
                                        float (&ka)[C / 2]) {
  constexpr int N = C, LBO = N / 8 * 128, SBO = 128;
  auto id = [](float v) { return v; };
  uint32_t xh[2][4], xl[2][4], nh[2][4], nl[2][4];   // [buffer][fragment]
#pragma unroll
  for (int kk = 0; kk < C / 8; ++kk) {
    const int b = kk & 1, at = kk / 2 * 32 * N;
    acc_to_tf32(xr, kk, xh[b], xl[b], id);
    acc_to_tf32(xn, kk, nh[b], nl[b], id);
    const uint64_t dv = smem_desc(wv + at, LBO, SBO) + kk % 2 * 4 * N;
    const uint64_t dq = smem_desc(wq + at, LBO, SBO) + kk % 2 * 4 * N;
    const uint64_t dk = smem_desc(wk + at, LBO, SBO) + kk % 2 * 4 * N;
    reg_fence(va);
    reg_fence(qa);
    reg_fence(ka);
    wgmma_fence();
    Wgmma<N>::mma(va, xl[b], dv, kk > 0);
    Wgmma<N>::mma(qa, nl[b], dq, kk > 0);
    Wgmma<N>::mma(ka, nl[b], dk, kk > 0);
    Wgmma<N>::mma(va, xh[b], dv + 2 * N, 1);
    Wgmma<N>::mma(qa, nh[b], dq + 2 * N, 1);
    Wgmma<N>::mma(ka, nh[b], dk + 2 * N, 1);
    Wgmma<N>::mma(va, xh[b], dv, 1);
    Wgmma<N>::mma(qa, nh[b], dq, 1);
    Wgmma<N>::mma(ka, nh[b], dk, 1);
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait<1>();
      reg_fence_u(xh[b ^ 1]);
      reg_fence_u(xl[b ^ 1]);
      reg_fence_u(nh[b ^ 1]);
      reg_fence_u(nl[b ^ 1]);
    }
  }
  wgmma_wait<0>();
  reg_fence(va);
  reg_fence(qa);
  reg_fence(ka);
}

// wf: ang_sites_weights_kernel's scratch; x, out [N, A2, C], pe [A2, C],
// ln [4, C]; RES: m, l [N, A2, 8], attn [N, A2, C].
template <int C, bool RES>
__global__ void __launch_bounds__(RG_NT, 1)
    ang_sites_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                     const float* __restrict__ ln, const float* __restrict__ wf,
                     float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ attn_out, int N, int A2, float scale, AngSitesPlan p) {
  using L = AngSites<C>;
  constexpr int HC = L::HC, NH = L::NH, LDB = L::LDB, LDF = L::LDF, LDH = L::LDH;
  constexpr int KC = C / 16, KH = HC / 16;
  extern __shared__ __align__(16) float smem[];   // the type the other kernels of lft declare
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const bf16* ws = reinterpret_cast<const bf16*>(sm);
  const float* wres = reinterpret_cast<const float*>(sm + p.rbase);   // the resident split weights
  const bool r_qkv = p.mask & S_AQKV, sb = p.mask & S_ASCORE, vb = p.mask & S_AAV,
             ob = p.mask & S_AWO, r_ffn = p.mask & S_AFFN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int wr = 16 * warp;   // the warp's rows
  const int P = RG_M / A2;
  const int tiles = (N + P - 1) / P;
  auto id = [](float v) { return v; };
  // split piece i's B: resident (its first float) or null (on the ring at `ring_off(i)`)
  auto res_of = [&](int i) { return p.sw[i] >= 0 && p.sw[i] < p.res ? wres + p.sw[i] : nullptr; };
  auto ring_off = [&](int i) { return p.sw[i] - p.rb; };

  for (int i = 16 * tid; i < p.rbase; i += 16 * RG_NT)
    cp_async16v(sm + i, reinterpret_cast<const unsigned char*>(wf) + i, true);
  for (int i = 16 * tid; i < 4 * p.res; i += 16 * RG_NT)
    cp_async16v(sm + p.rbase + i, reinterpret_cast<const unsigned char*>(wf + L::BF_FLOATS) + i,
                true);
  cp_async_commit();
  // q, k, v's rows past the tile (read as a pixel's padding), a separate
  // attention output and MH to zero; again each tile where a hidden chunk
  // lies over k and v
  auto zero = [&](int off, int bytes) {
    for (int i = tid; i < bytes / 16; i += RG_NT)
      reinterpret_cast<uint4*>(sm + off)[i] = make_uint4(0u, 0u, 0u, 0u);
  };
  const int qrow = sb ? LDB * 2 : LDF * 4, vrow = vb ? LDB * 2 : LDF * 4;
  auto zero_pad = [&]() {
    zero(p.k + RG_M * qrow, 16 * qrow);
    zero(p.v + RG_M * vrow, 16 * vrow);
  };
  zero(p.q + RG_M * qrow, 16 * qrow);
  zero_pad();
  if (p.ao != p.q) zero(p.ao, RG_M * (ob ? LDB * 2 : LDF * 4));
  zero(p.mh, L::ROWS * L::NG * 4);
  MbarRing<0> ring;
  if (p.stream > p.res)
    ring.start(reinterpret_cast<float*>(sm + p.ring),
               reinterpret_cast<uint64_t*>(sm + p.ring + p.ns * RG_SF * 4),
               wf + L::BF_FLOATS + p.rb, p.stream - p.rb,
               (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x, p.ns);
  const float* st = nullptr;
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int pix0 = tile * P, np = min(P, N - pix0), nrows = np * A2;
    const size_t row0 = static_cast<size_t>(pix0) * A2;
    if (p.hid_kv && it > 0) {   // the last tile's hidden chunks are read
      __syncthreads();
      zero_pad();
    }
    {  // the next tile's x into L2, the warp's rows
      const int nt = tile + static_cast<int>(gridDim.x);
      const int nr = nt < tiles ? min(P, N - nt * P) * A2 - wr : 0;
      if (lane == 0 && nr > 0)
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                         x + (static_cast<size_t>(nt) * P * A2 + wr) * C),
                     "r"((nr < 16 ? nr : 16) * C * 4)
                     : "memory");
    }
    // x of the warp's rows (zero past the tile's pixels) in the accumulator layout
    auto x_pair = [&](int r, int c) {
      return wr + r < nrows ? ldg2(x + (row0 + wr + r) * C + c) : make_float2(0.f, 0.f);
    };
    // the pairs of an m64nN accumulator d, f(row, column, d[e], d[e + 1])
    auto pairs = [&](auto&& d, auto f) {
      constexpr int R = sizeof(d) / sizeof(float);
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) f(g + 8 * h, 8 * j + 2 * q4, 4 * j + 2 * h);
    };

    {  // xn = LN1(x + pe); v, q, k; v rounded into V where `aav` rounds, q
       // and k into Q, K where `ascore` does
      float xr[C / 2];
      RgAcc<C> xn;
      pairs(xr, [&](int r, int c, int e) {
        const float2 v = x_pair(r, c);
        const float2 pp = ldg2(pe + ((wr + r) % A2) * C + c);
        xr[e] = v.x;
        xr[e + 1] = v.y;
        xn[0][e] = v.x + pp.x;
        xn[0][e + 1] = v.y + pp.y;
      });
      quad_ln<C>(xn, ln, ln + C);
      // values of an m64nC accumulator into rows of Q, K or V (bf16 or f32)
      auto put = [&](int off, bool b16, const float (&d)[C / 2], const float (&d2)[C / 2],
                     bool two) {
        pairs(d, [&](int r, int c, int e) {
          const float v0 = two ? d[e] + d2[e] : d[e], v1 = two ? d[e + 1] + d2[e + 1] : d[e + 1];
          if (b16)
            *reinterpret_cast<uint32_t*>(sm + off + ((wr + r) * LDB + c) * 2) = narrow2(v0, v1);
          else
            *reinterpret_cast<float2*>(sm + off + ((wr + r) * LDF + c) * 4) = make_float2(v0, v1);
        });
      };
      float va[C / 2], qa[C / 2], ka[C / 2];
      if (r_qkv) {   // bf16 on resident bf16 weights, the three products' steps alternating
        uint32_t xa[KC][4], na[KC][4];
#pragma unroll
        for (int s = 0; s < KC; ++s) {
          acc_to_a(xa[s], xr, s, id);
          acc_to_a(na[s], xn[0], s, id);
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KC; ++s) {
          WgmmaBf<C>::mma(va, xa[s], bf16_piece_desc<C>(ws, p.bw[0], s, 0), s);
          WgmmaBf<C>::mma(qa, na[s], bf16_piece_desc<C>(ws, p.bw[1], s, 0), s);
          WgmmaBf<C>::mma(ka, na[s], bf16_piece_desc<C>(ws, p.bw[2], s, 0), s);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(va);
        reg_fence(qa);
        reg_fence(ka);
      } else if (res_of(0)) {   // 3xTF32 on resident split weights, issued together
        tf3_qkv<C>(xr, xn[0], res_of(0), res_of(1), res_of(2), va, qa, ka);
      }
      if (r_qkv || res_of(0)) {
        put(p.v, vb, va, va, false);
        put(p.q, sb, qa, qa, false);
        put(p.k, sb, ka, ka, false);
      } else {   // 3xTF32 from the ring, one product at a time
        auto from_x = [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          acc_to_tf32(xr, kk, hi, lo, id);
        };
        auto from_xn = [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) {
          acc_to_tf32(xn[0], kk, hi, lo, id);
        };
        tf3_product<C, C>(from_x, nullptr, ring, st, ring_off(0),
                          [&](const float(&s0)[C / 2], const float(&s1)[C / 2]) {
                            put(p.v, vb, s0, s1, true);
                          });
        tf3_product<C, C>(from_xn, nullptr, ring, st, ring_off(1),
                          [&](const float(&s0)[C / 2], const float(&s1)[C / 2]) {
                            put(p.q, sb, s0, s1, true);
                          });
        tf3_product<C, C>(from_xn, nullptr, ring, st, ring_off(2),
                          [&](const float(&s0)[C / 2], const float(&s1)[C / 2]) {
                            put(p.k, sb, s0, s1, true);
                          });
      }
    }
    __syncthreads();

    switch ((sb ? 2 : 0) | (vb ? 1 : 0)) {
      case 0: ang_sites_attention<C, false, false, RES>(sm, p, ob, np, A2, scale, row0, m_out,
                                                        l_out, attn_out); break;
      case 1: ang_sites_attention<C, false, true, RES>(sm, p, ob, np, A2, scale, row0, m_out,
                                                       l_out, attn_out); break;
      case 2: ang_sites_attention<C, true, false, RES>(sm, p, ob, np, A2, scale, row0, m_out,
                                                       l_out, attn_out); break;
      default: ang_sites_attention<C, true, true, RES>(sm, p, ob, np, A2, scale, row0, m_out,
                                                       l_out, attn_out);
    }
    __syncthreads();

    // x2 = R(a) R(Wo) + x, then LN2(x2); x for the residual loaded first, its
    // latency under the Wo product
    float x2[C / 2], xr[C / 2];
    pairs(xr, [&](int r, int c, int e) {
      const float2 v = x_pair(r, c);
      xr[e] = v.x;
      xr[e + 1] = v.y;
    });
    RgAcc<C> t;
    if (ob) {
      uint32_t aa[KC][4];
      const bf16* AOb = reinterpret_cast<const bf16*>(sm + p.ao);
#pragma unroll
      for (int s = 0; s < KC; ++s)
        ldmatrix_x4(aa[s], AOb + (wr + (lane & 15)) * LDB + 16 * s + 8 * (lane >> 4));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KC; ++s)
        WgmmaBf<C>::mma(x2, aa[s], bf16_piece_desc<C>(ws, p.bw[3], s, 0), s);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(x2);
    } else {
      tf3_product<C, C>(rows_a(reinterpret_cast<const float*>(sm + p.ao) + wr * LDF, LDF),
                        res_of(3), ring, st, ring_off(3),
                        [&](const float(&s0)[C / 2], const float(&s1)[C / 2]) {
#pragma unroll
                          for (int i = 0; i < C / 2; ++i) x2[i] = s0[i] + s1[i];
                        });
    }
#pragma unroll
    for (int e = 0; e < C / 2; ++e) t[0][e] = x2[e] += xr[e];
    quad_ln<C>(t, ln + 2 * C, ln + 3 * C);
    float* trows = reinterpret_cast<float*>(sm + p.q) + wr * LDF;   // LN2(x2), p.rows
    if (p.rows) {   // the Wo product has read the attention output's rows (over q)
      pairs(x2, [&](int r, int c, int e) {
        *reinterpret_cast<float2*>(trows + r * LDF + c) = make_float2(t[0][e], t[0][e + 1]);
      });
      __syncwarp();
    }

    // y = sum over the hidden chunks c of R(relu(R(LN2(x2)) R(W1[:, c]))) R(W2[c, :])
    float y[C / 2];
    auto relu = [](float v) { return fmaxf(v, 0.f); };
    if (r_ffn) {   // ang_bf16.cuh's: W2 of chunk c and W1 of chunk c + 1 together
      uint32_t la[KC][4], ha[KH][4];
      float hid[HC / 2];
#pragma unroll
      for (int s = 0; s < KC; ++s) acc_to_a(la[s], t[0], s, id);
      auto hidden = [&](int c) {
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KC; ++s)
          WgmmaBf<HC>::mma(hid, la[s], bf16_piece_desc<2 * C>(ws, p.bw[4], s, c * HC), s);
        wgmma_commit();
      };
      hidden(0);
      wgmma_wait<0>();
      reg_fence(hid);
#pragma unroll
      for (int s = 0; s < KH; ++s) acc_to_a(ha[s], hid, s, relu);
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        reg_fence(y);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < KH; ++s)
          WgmmaBf<C>::mma(y, ha[s], bf16_piece_desc<C>(ws, p.bw[5], c * KH + s, 0), c + s);
        wgmma_commit();
        if (c + 1 < NH) hidden(c + 1);
        wgmma_wait<0>();
        reg_fence(hid);
        reg_fence(y);
        if (c + 1 < NH) {
#pragma unroll
          for (int s = 0; s < KH; ++s) acc_to_a(ha[s], hid, s, relu);
        }
      }
    } else {   // 3xTF32, relu(hid) through the warp's rows of a hidden chunk
      float* hw = reinterpret_cast<float*>(sm + p.hid) + wr * LDH;
      const bool ffn_res = res_of(4) != nullptr;
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        const int off = c * (L::PW1 + L::PW2);
        const float* r1 = ffn_res ? res_of(4) + off : nullptr;
        const float* r2 = ffn_res ? res_of(4) + off + L::PW1 : nullptr;
        auto epi = [&](const float(&s0)[HC / 2], const float(&s1)[HC / 2]) {
          __syncwarp();   // the previous chunk's rows are read
          pairs(s0, [&](int r, int c_, int e) {
            *reinterpret_cast<float2*>(hw + r * LDH + c_) =
                make_float2(relu(s0[e] + s1[e]), relu(s0[e + 1] + s1[e + 1]));
          });
          __syncwarp();
        };
        if (p.rows)
          tf3_product<C, HC>(rows_a(trows, LDF), r1, ring, st, ring_off(4) + off, epi);
        else
          tf3_product<C, HC>(
              [&](int kk, uint32_t(&hi)[4], uint32_t(&lo)[4]) { acc_to_tf32(t[0], kk, hi, lo, id); },
              r1, ring, st, ring_off(4) + off, epi);
        tf3_product<HC, C>(rows_a(hw, LDH), r2, ring, st, ring_off(4) + off + L::PW1,
                           [&](const float(&s0)[C / 2], const float(&s1)[C / 2]) {
#pragma unroll
                             for (int i = 0; i < C / 2; ++i)
                               y[i] = c ? y[i] + (s0[i] + s1[i]) : s0[i] + s1[i];
                           });
      }
    }

    // out = y + x2, 16 bytes a lane
    RgAcc<C> o;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) o[0][i] = y[i] + x2[i];
    const long long orow[2] = {wr + g < nrows ? static_cast<long long>(row0) + wr + g : -1,
                               wr + g + 8 < nrows ? static_cast<long long>(row0) + wr + g + 8 : -1};
    rg_store_rows16<C>(out, o, orow);
  }
}

// The launch: the weights' preparation into wf (AngSites<C>::FLOATS
// floats), then the persistent kernel, one block an SM. `sites` must round
// some of K1's five sites and not others (the f32 and all-bf16 instances
// take the rest).
template <int C, bool RES>
int launch_ang_sites(const float* x, const float* pe, const float* ln, const float* wq,
                     const float* wk, const float* wv, const float* wo, const float* w1,
                     const float* w2, float* wf, float* out, float* m, float* l, float* attn,
                     int N, int A2, float scale, int sites, cudaStream_t s) {
  const int mask = sites & ANG_SITES;
  if (mask == 0 || mask == ANG_SITES) return static_cast<int>(cudaErrorInvalidValue);
  const AngSitesPlan p = ang_sites_plan<C>(mask);
  if (p.bytes > RG_SMEM_MAX || (p.stream > p.res && p.ns < 3))
    return static_cast<int>(cudaErrorInvalidValue);
  ang_sites_weights_kernel<C><<<(8 * C * C + 255) / 256, 256, 0, s>>>(wv, wq, wk, wo, w1, w2, wf,
                                                                      p);
  auto kernel = ang_sites_kernel<C, RES>;
  LFT_SET_SMEM(kernel, p.bytes);
  const int P = RG_M / A2;
  kernel<<<rg_grid((N + P - 1) / P), RG_NT, p.bytes, s>>>(x, pe, ln, wf, out, m, l, attn, N, A2,
                                                          scale, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
