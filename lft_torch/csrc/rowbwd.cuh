// The backward kernels' row-tile pieces on top of rowgemm.cuh, shared by
// spa_block_bwd.cu (K3.a spa_ffn_out_bwd, K3.d spa_qkv_ln_bwd) and
// ang_block.cu (K4's steps a and c): a warp's rows in and out of shared and
// device memory, the LayerNorm's backward on the accumulators, and the
// kernel of K3.d and of K4's step c, `qkv_ln_bwd_kernel`. Rows in device
// memory are f32 or, in the `_bf16io` instances (`--dtype bfloat16`
// training), bf16: widened to f32 as they are loaded into shared memory and
// rounded to nearest even as they are stored; the rows in shared memory and
// the products over them are the f32 instances' (with BF).
#pragma once

#include "rowgemm.cuh"
#include "spa.cuh"

namespace lft {

// The warp's 16 rows [t0, t0 + 16) of src [T, W] into dst (row stride ld),
// all loads in flight at once, zero past T; read once, so marked to leave
// L2 first (ld.global.cs).
template <int W>
__device__ __forceinline__ void warp_rows(float* dst, int ld, const float* __restrict__ src,
                                          int t0, int T) {
  constexpr int L = W / 8;   // float4 a lane
  const int lane = threadIdx.x & 31;
  float4 v[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = lane + 32 * k, r = i / (W / 4), c = 4 * (i % (W / 4));
    v[k] = t0 + r < T ? __ldcs(reinterpret_cast<const float4*>(src + static_cast<size_t>(t0 + r) * W + c))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();   // the rows' last readers are done
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = lane + 32 * k;
    store4(dst + i / (W / 4) * ld + 4 * (i % (W / 4)), v[k]);
  }
  __syncwarp();
}

// The same from bf16 rows, widened to f32 by 8-byte loads.
template <int W>
__device__ __forceinline__ void warp_rows(float* dst, int ld, const bf16* __restrict__ src,
                                          int t0, int T) {
  constexpr int L = W / 8;
  const int lane = threadIdx.x & 31;
  float4 v[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = lane + 32 * k, r = i / (W / 4), c = 4 * (i % (W / 4));
    v[k] = t0 + r < T ? ldcs4(src + static_cast<size_t>(t0 + r) * W + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int i = lane + 32 * k;
    store4(dst + i / (W / 4) * ld + 4 * (i % (W / 4)), v[k]);
  }
  __syncwarp();
}

// The warp's 16 rows of a shared tile (row stride ld), W floats each, into
// rows t0 .. t0 + 15 (< T) of dst [T, dld] from column c0 on: a lane's
// float4 a time, one row of whole 128-byte lines an instruction. KEEP: the
// rows are read again in this kernel (x2); else they are marked to leave
// L2 first (st.global.cs).
template <int W, bool KEEP = false>
__device__ __forceinline__ void store_rows(const float* tile, int ld, float* __restrict__ dst,
                                           int dld, int c0, int t0, int T) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < W / 8; ++k) {
    const int i = lane + 32 * k, r = i / (W / 4), c = 4 * (i % (W / 4));
    if (t0 + r >= T) continue;
    float* at = dst + static_cast<size_t>(t0 + r) * dld + c0 + c;
    const float4 v = load4(tile + r * ld + c);
    if constexpr (KEEP)
      store4(at, v);
    else
      __stcs(reinterpret_cast<float4*>(at), v);
  }
}

// The same into bf16 rows, each value rounded to nearest even.
template <int W, bool KEEP = false>
__device__ __forceinline__ void store_rows(const float* tile, int ld, bf16* __restrict__ dst,
                                           int dld, int c0, int t0, int T) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < W / 8; ++k) {
    const int i = lane + 32 * k, r = i / (W / 4), c = 4 * (i % (W / 4));
    if (t0 + r >= T) continue;
    bf16* at = dst + static_cast<size_t>(t0 + r) * dld + c0 + c;
    const float4 v = load4(tile + r * ld + c);
    if constexpr (KEEP)
      st4(at, v);
    else
      stcs4(at, v);
  }
}

// acc into the warp's rows of a shared tile (row stride ld), after every
// lane is done reading them.
template <int N>
__device__ __forceinline__ void put_tile(RgAcc<N>& acc, float* tile, int ld) {
  __syncwarp();
  rg_pairs<N>(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(tile + r * ld + c) = make_float2(v0, v1);
  });
  __syncwarp();
}

// The warp's 16 rows [t0, t0 + 16) of src [T, W] into aw (row stride W + 4)
// by cp.async, zero past T; one group.
template <int W>
__device__ __forceinline__ void rows_async(float* aw, const float* __restrict__ src, int t0,
                                           int T) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int i = lane; i < 16 * (W / 4); i += 32) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    const bool ok = t0 + r < T;
    cp_async16(aw + r * (W + 4) + c, src + static_cast<size_t>(ok ? t0 + r : 0) * W + c, ok);
  }
  cp_async_commit();
}

// The same from bf16 rows, widened by the warp's own loads (cp.async copies
// bytes); an empty group keeps the callers' group counts.
template <int W>
__device__ __forceinline__ void rows_async(float* aw, const bf16* __restrict__ src, int t0,
                                           int T) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int i = lane; i < 16 * (W / 4); i += 32) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4));
    store4(aw + r * (W + 4) + c, t0 + r < T ? ldcs4(src + static_cast<size_t>(t0 + r) * W + c)
                                            : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  cp_async_commit();
}

// f(p, i, row, col) for each of a thread's pairs of an N-wide accumulator:
// the elements acc[p][i], acc[p][i + 1] at (row, col), (row, col + 1) of the
// warp's 16 rows, in rg_pairs' order.
template <int N, class F>
__device__ __forceinline__ void rg_each(F f) {
  using P = RgParts<N>;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) f(p, 4 * j + 2 * h, g + 8 * h, p * P::NW + 8 * j + 2 * q);
}

// The rows t0 + row < T of acc into dst [T, ld] from column c0 on, a float2
// a pair; CS: marked to leave L2 first (st.global.cs).
template <int N, bool CS = true>
__device__ __forceinline__ void store_acc(const RgAcc<N>& acc, float* __restrict__ dst, int ld,
                                          int c0, int t0, int T) {
  rg_each<N>([&](int p, int i, int r, int c) {
    if (t0 + r >= T) return;
    float2* at = reinterpret_cast<float2*>(dst + static_cast<size_t>(t0 + r) * ld + c0 + c);
    const float2 v = make_float2(acc[p][i], acc[p][i + 1]);
    if constexpr (CS)
      __stcs(at, v);
    else
      *at = v;
  });
}

// xhat = (v - mu) rstd of the warp's 16 rows held in the accumulator layout,
// in place, with quad_ln's statistics (biased variance, eps 1e-5); rstd[h]
// of rows g + 8 h.
template <int N>
__device__ __forceinline__ void quad_xhat(RgAcc<N>& v, float (&rstd)[2]) {
  using P = RgParts<N>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j) s += v[p][4 * j + 2 * h] + v[p][4 * j + 2 * h + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / N;
    float qq = 0.f;
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = v[p][4 * j + 2 * h + e] - mu;
          qq = fmaf(d, d, qq);
        }
    qq += __shfl_xor_sync(0xffffffffu, qq, 1);
    qq += __shfl_xor_sync(0xffffffffu, qq, 2);
    rstd[h] = rsqrtf(qq / N + 1e-5f);
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = v[p][4 * j + 2 * h + e];
          x = (x - mu) * rstd[h];
        }
  }
}

// A LayerNorm's backward on the accumulators of the warp's 16 rows: dxn,
// the cotangent of its output, becomes that of its input, rstd (dxh -
// mean(dxh) - xh mean(dxh xh)) with dxh = dxn g (g: the LayerNorm's
// weight), given xh = xhat and rstd[h] of rows g + 8 h. First the affine
// grads' column sums over the 16 rows, sum dxn xh into part[c] and sum dxn
// into part[N + c]: rows g and g + 8 in a thread, then the 8 lanes of a
// column. Rows with a zero dxn add nothing. (K3.a keeps its own inline
// copy of this and of tile_ln_sums: through these functions it ran 8%
// slower on an H100 at the same registers, a scratch A/B.)
template <int N>
__device__ __forceinline__ void quad_ln_bwd(RgAcc<N>& dxn, const RgAcc<N>& xh,
                                            const float (&rstd)[2], const float* __restrict__ g,
                                            float* part) {
  using P = RgParts<N>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int jj = 0; jj < P::NW / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i0 = 4 * jj + e, i1 = 4 * jj + 2 + e;
        float sw = fmaf(dxn[p][i1], xh[p][i1], dxn[p][i0] * xh[p][i0]);
        float sb = dxn[p][i0] + dxn[p][i1];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          sw += __shfl_xor_sync(0xffffffffu, sw, o);
          sb += __shfl_xor_sync(0xffffffffu, sb, o);
        }
        if (lane < 4) {
          const int c = p * P::NW + 8 * jj + 2 * lane + e;
          part[c] = sw;
          part[N + c] = sb;
        }
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sa = 0.f, sx = 0.f;
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int jj = 0; jj < P::NW / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const float dxh = dxn[p][i] * __ldg(g + p * P::NW + 8 * jj + 2 * (lane & 3) + e);
          dxn[p][i] = dxh;
          sa += dxh;
          sx = fmaf(dxh, xh[p][i], sx);
        }
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sx += __shfl_xor_sync(0xffffffffu, sx, 1);
    sx += __shfl_xor_sync(0xffffffffu, sx, 2);
    sa /= N;
    sx /= N;
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int jj = 0; jj < P::NW / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          dxn[p][i] = rstd[h] * (dxn[p][i] - sa - xh[p][i] * sx);
        }
  }
}

// The tile's LayerNorm sums: the 8 warps' [2][N] rows of part added in warp
// order into out[0 .. 2 N) (one row of partial sums a 128-row tile, so their
// number and the order of the colsum after depend on T alone). One block
// barrier on each side: no warp still writes part, none writes it again
// before all have read it.
template <int N>
__device__ __forceinline__ void tile_ln_sums(const float* part, float* __restrict__ out) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * N; i += RG_NT) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < 8; ++wp) s += part[wp * 2 * N + i];
    out[i] = s;
  }
  __syncthreads();
}

// ---- K3.d and K4 c: the projections' and LN1's backward -------------------
//
// Replaces the dq/dk/dv and LN1 part of lft_tpu/kernels/spa_block.py:
// _bwd_kernel (:541-556) and of ang_block.py:_bwd_kernel. Over [T, W] token
// rows (W = D = 2C for K3.d, C for K4):
//   p   = dq Wqᵀ                              phase Q
//   dxn = p + dk Wkᵀ;  d = LN1ᵀ(dxn), with      phase K
//         xhat from x + pe[t % period]
//   dx  = (dx2 + dv Wvᵀ) + d                   phase V
// and dxpe = d (K3.d's dtokpe; K4 has none) and LN1's affine grads as one
// row of partial sums a 128-row tile, [2, W] at ln_part + tile * part_ld.
// JAX's order of the f32 additions is kept: finished products are added,
// no accumulator starts from a residual.
//
// Bound: 6 W^2 FLOP a token, 3 TF32 products each on the tensor cores, and
// 7 W-wide tensors of traffic (x, dq, dk, dv, dx2 in; dx, dxpe out): at
// [100, 32, 32, 64] (T = 102,400, W = 128) 10.1 GFLOP, 0.061 ms, and 367 MB,
// 0.1095 ms at 3.35 TB/s: bytes. The design, K2.2's (spa_block.cu:
// row_pass): the products run 3xTF32 (rowgemm.cuh, tails first) from
// weights resident in shared memory, persistent 128-row tiles, each warp's
// next rows brought by cp.async as soon as its product has read them, and
// no block barrier but the two around a tile's LN1 sums.
// * W <= 64: the three weights split (96 KB at W = 64) and three row tiles
//   fit (QkvLnBwd::ONE): one pass, p and d in registers.
// * W = 128: the three take 384 KB. As K2.2, one weight resident a pass,
//   three passes over the block's tiles: Q writes p into dxpe, K reads it
//   and writes d there, V reads d. A block reads back only what it wrote,
//   in the same thread: no grid-wide barrier. 157 MB more traffic (a bound
//   of ~0.16 ms for the design).
// LN1's backward runs on the accumulators (quad_xhat, quad_ln_bwd). Every
// output is written by one thread, no atomics: a call repeats bitwise.
// BF (`--dtype mixed`'s backward): the three products over bf16-rounded
// operands, one TF32 pass each (rowgemm.cuh). IO = bf16 (with BF, `--dtype
// bfloat16` training, lft_tpu's io = bf16): x, dq, dk, dv and dx bf16 (dx =
// bf16((dx2 + dv Wvᵀ) + d), its one rounding), pe, dx2, dxpe and the LN
// sums f32, as lft_tpu keeps them. Bound of K3.d's bf16-IO instance at
// [100, 32, 32, 64]: x, dq, dk, dv in bf16, dx2 in and dxpe out f32, dx out
// bf16, 262 MB, 0.078 ms; 10.1 GFLOP at the bf16 rate 0.010 ms: bytes.
// SITES (`qkv_ln_bwd_sites_kernel`, K3.d's `_sites` instance under an
// LFT_MM_HP_BWD_SITES subset): f32 rows, each product BF or 3xTF32 as its
// bit of the runtime mask `rb` says (1: dq Wqᵀ, 2: dk Wkᵀ, 4: dv Wvᵀ; a
// uniform branch, rowgemm.cuh:rg_product_site), the weights split piece by
// piece to match. At W <= 64 (ONE) one pass carries products of both
// settings; at W = 128 each pass is one product. K4's step c computes one
// site (`aqkv`) and takes the f32 or BF instance whole.
template <int W>
struct QkvLnBwd {
  static constexpr int LDX = W + 4;          // row stride of a tile
  static constexpr int SQ = 2 * W * W;       // floats of one W x W weight split
  static constexpr int FLOATS = 3 * SQ;      // the stream: Wqᵀ, Wkᵀ, Wvᵀ
  // all three weights, three row tiles and the 8 warps' LN1 sums [8][2][W]
  static constexpr bool ONE = (3 * SQ + 3 * RG_M * LDX + 16 * W) * 4 <= RG_SMEM_MAX;
  static constexpr int NW = ONE ? 3 : 1;     // weights (and row tiles) held at once
  static constexpr size_t BYTES = (NW * static_cast<size_t>(SQ) + NW * RG_M * LDX + 16 * W) * 4;
  static_assert(BYTES <= RG_SMEM_MAX, "the weights and the rows must fit in shared memory");
};

template <class IO = float>
struct QkvLnBwdArgs {
  const IO* x;
  const float* pe;
  const IO *dq, *dk, *dv;
  const float *dx2, *ln, *wf;
  IO* dx;
  float *dxpe, *ln_part;
  int period, part_ld, T;
};

// One pass over the block's tiles running the phases of PH (1: Q, 2: K,
// 4: V), each from its own weight and row tile (slots in phase order).
// Ends with every warp past its last read of the weights. SITES: phase i's
// product BF where bit i of rb is set.
template <int W, int PH, bool BF, class IO, bool SITES = false>
__device__ __forceinline__ void qkv_ln_bwd_pass(const QkvLnBwdArgs<IO>& a, float* smem,
                                                int rb = 0) {
  using Q = QkvLnBwd<W>;
  constexpr int LDX = Q::LDX, SQ = Q::SQ;
  constexpr int S1 = PH & 1, S2 = S1 + ((PH >> 1) & 1);   // the slots of K and V
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, T = a.T;
  const int tiles = (T + RG_M - 1) / RG_M;
  float* rows = smem + Q::NW * SQ;                 // [NW][RG_M][LDX]
  float* part = rows + Q::NW * RG_M * LDX;         // [8 warps][2][W]
  const IO* src[3] = {a.dq, a.dk, a.dv};
  const int slot[3] = {0, S1, S2};
  auto rw = [&](int s) { return rows + s * RG_M * LDX + 16 * warp * LDX; };
#pragma unroll
  for (int ph = 0; ph < 3; ++ph)
    if ((PH >> ph) & 1)
      for (int i = 4 * static_cast<int>(threadIdx.x); i < SQ; i += 4 * RG_NT)
        cp_async16(smem + slot[ph] * SQ + i, a.wf + ph * SQ + i, true);
#pragma unroll
  for (int ph = 0; ph < 3; ++ph)
    if ((PH >> ph) & 1) rows_async<W>(rw(slot[ph]), src[ph], blockIdx.x * RG_M + 16 * warp, T);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  const float* st = nullptr;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * RG_M + 16 * warp;
    const int n0 = (tile + static_cast<int>(gridDim.x)) * RG_M + 16 * warp;   // next tile's rows
    const bool more = tile + static_cast<int>(gridDim.x) < tiles;
    RgAcc<W> p, acc;   // p: dq Wqᵀ, then d
    if constexpr ((PH & 1) != 0) {
      ResidentWeights wr{smem};
      rg_zero<W>(p);
      if constexpr (SITES)
        rg_product_site<W, W, 0, false, true, true>((rb & 1) != 0, p, rw(0), LDX, wr, st);
      else
        rg_product<W, W, 0, true, BF>(p, rw(0), LDX, wr, st);
      __syncwarp();   // the warp's rows are read
      if (more) rows_async<W>(rw(0), a.dq, n0, T);
      if constexpr ((PH & 2) == 0) store_acc<W, false>(p, a.dxpe, W, 0, t0, T);
    }
    if constexpr ((PH & 2) != 0) {
      ResidentWeights wr{smem + S1 * SQ};
      rg_zero<W>(acc);
      if constexpr (SITES)
        rg_product_site<W, W, 0, false, true, true>((rb & 2) != 0, acc, rw(S1), LDX, wr, st);
      else
        rg_product<W, W, 0, true, BF>(acc, rw(S1), LDX, wr, st);
      __syncwarp();
      if (more) rows_async<W>(rw(S1), a.dk, n0, T);
      // dxn = dq Wqᵀ + dk Wkᵀ, the finished products added (zero past T)
      rg_each<W>([&](int pp, int i, int r, int c) {
        float2 u;
        if constexpr ((PH & 1) != 0)
          u = make_float2(p[pp][i], p[pp][i + 1]);
        else
          u = t0 + r < T ? *reinterpret_cast<const float2*>(a.dxpe + static_cast<size_t>(t0 + r) * W + c)
                         : make_float2(0.f, 0.f);
        acc[pp][i] = u.x + acc[pp][i];
        acc[pp][i + 1] = u.y + acc[pp][i + 1];
      });
      // LN1's backward: xhat of x + pe[t % period] (pe alone on rows past T)
      RgAcc<W> xh;
      const float* pe0 = a.pe + (t0 + g) % a.period * W;       // rows g, g + 8
      const float* pe1 = a.pe + (t0 + g + 8) % a.period * W;
      rg_each<W>([&](int pp, int i, int r, int c) {
        const int t = t0 + r;
        const float2 xv = t < T ? ldcs2(a.x + static_cast<size_t>(t) * W + c)
                                : make_float2(0.f, 0.f);
        const float2 pv = __ldg(reinterpret_cast<const float2*>((i & 2 ? pe1 : pe0) + c));
        xh[pp][i] = xv.x + pv.x;
        xh[pp][i + 1] = xv.y + pv.y;
      });
      float rstd[2];
      quad_xhat<W>(xh, rstd);
      quad_ln_bwd<W>(acc, xh, rstd, a.ln, part + warp * 2 * W);
      if (a.dxpe != nullptr) store_acc<W, ((PH & 4) != 0)>(acc, a.dxpe, W, 0, t0, T);
#pragma unroll
      for (int pp = 0; pp < RgParts<W>::NP; ++pp)
#pragma unroll
        for (int i = 0; i < RgParts<W>::R; ++i) p[pp][i] = acc[pp][i];
    }
    if constexpr ((PH & 4) != 0) {
      ResidentWeights wr{smem + S2 * SQ};
      rg_zero<W>(acc);
      if constexpr (SITES)
        rg_product_site<W, W, 0, false, true, true>((rb & 4) != 0, acc, rw(S2), LDX, wr, st);
      else
        rg_product<W, W, 0, true, BF>(acc, rw(S2), LDX, wr, st);
      __syncwarp();
      if (more) rows_async<W>(rw(S2), a.dv, n0, T);
      // dx = (dx2 + dv Wvᵀ) + d
      rg_each<W>([&](int pp, int i, int r, int c) {
        const size_t at = static_cast<size_t>(t0 + r) * W + c;
        if (t0 + r >= T) return;
        const float2 u = __ldcs(reinterpret_cast<const float2*>(a.dx2 + at));
        const float2 d = (PH & 2) != 0 ? make_float2(p[pp][i], p[pp][i + 1])
                                       : __ldcs(reinterpret_cast<const float2*>(a.dxpe + at));
        stcs2(a.dx + at, (u.x + acc[pp][i]) + d.x, (u.y + acc[pp][i + 1]) + d.y);
      });
    }
    if constexpr ((PH & 2) != 0)
      tile_ln_sums<W>(part, a.ln_part + static_cast<size_t>(tile) * a.part_ld);
    cp_async_wait<0>();   // the warp's rows of its next tile
    __syncwarp();
  }
  __syncthreads();
}

template <int W, bool BF = false, class IO = float>
__global__ void __launch_bounds__(RG_NT, 1) qkv_ln_bwd_kernel(const QkvLnBwdArgs<IO> a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (QkvLnBwd<W>::ONE) {
    qkv_ln_bwd_pass<W, 7, BF>(a, smem);
  } else {
    qkv_ln_bwd_pass<W, 1, BF>(a, smem);
    qkv_ln_bwd_pass<W, 2, BF>(a, smem);
    qkv_ln_bwd_pass<W, 4, BF>(a, smem);
  }
}

// The `_sites` instance (the header's SITES): f32 rows, rb the mask of the
// phases whose products round.
template <int W>
__global__ void __launch_bounds__(RG_NT, 1) qkv_ln_bwd_sites_kernel(const QkvLnBwdArgs<float> a,
                                                                    int rb) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (QkvLnBwd<W>::ONE) {
    qkv_ln_bwd_pass<W, 7, false, float, true>(a, smem, rb);
  } else {
    qkv_ln_bwd_pass<W, 1, false, float, true>(a, smem, rb);
    qkv_ln_bwd_pass<W, 2, false, float, true>(a, smem, rb);
    qkv_ln_bwd_pass<W, 4, false, float, true>(a, smem, rb);
  }
}

// Splits Wqᵀ, Wkᵀ, Wvᵀ straight from the forward's "x @ W" weights (wq, wk
// rows ldqk floats apart, wv rows W apart) into the scratch wf
// (QkvLnBwd<W>::FLOATS floats, kernels/rowgemm.py:qkv_ln_bwd_stream), then
// runs the kernel; BF: the bf16 parts, then the BF instance; IO: the rows'
// type (bf16 with BF). SITES: each piece split as its phase's bit of rb
// says, then the `_sites` instance.
template <int W, bool BF = false, class IO = float, bool SITES = false>
int launch_qkv_ln_bwd(QkvLnBwdArgs<IO> a, const float* wq, const float* wk, int ldqk,
                      const float* wv, float* wf, cudaStream_t s, int rb = 0) {
  using Q = QkvLnBwd<W>;
  RgPieces ps{};
  ps.p[0] = RgPiece{wq, ldqk, W, W, 0, 1};
  ps.p[1] = RgPiece{wk, ldqk, W, W, Q::SQ, 1};
  ps.p[2] = RgPiece{wv, W, W, W, 2 * Q::SQ, 1};
  if constexpr (SITES)
    for (int i = 0; i < 3; ++i) ps.p[i].bf = (rb >> i) & 1;
  launch_rg_weights(ps, 3, wf, s, BF, SITES);
  a.wf = wf;
  if constexpr (SITES) {
    static_assert(!BF && !is_bf16<IO>, "a `_sites` instance is f32 IO with its own mask");
    auto kernel = qkv_ln_bwd_sites_kernel<W>;
    LFT_SET_SMEM(kernel, Q::BYTES);
    kernel<<<rg_grid((a.T + RG_M - 1) / RG_M), RG_NT, Q::BYTES, s>>>(a, rb);
  } else {
    auto kernel = qkv_ln_bwd_kernel<W, BF, IO>;
    LFT_SET_SMEM(kernel, Q::BYTES);
    kernel<<<rg_grid((a.T + RG_M - 1) / RG_M), RG_NT, Q::BYTES, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
