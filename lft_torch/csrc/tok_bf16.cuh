// K2.1's bf16 forms on bf16 tensor-core products: `spa_tokenize_ln_bf16io`
// (IO = bf16, `--dtype bfloat16`) and `spa_tokenize_ln_bf16` (IO = float,
// `--dtype mixed` where `tok` rounds: LFT_MM_HP_SITES=none, S1), and K11.1's,
// `spa_tokenize_ln_pm_bf16io` and `spa_tokenize_ln_pm_bf16` (PM: the input
// pixel-major, spa.cuh: pm_row). Replaces lft_tpu/kernels/spa_block.py:
// _kernel :128-142 (call :352 view-major, :309 pixel-major) with x and Wu
// rounded to bf16 (io = bf16, or mm_half with `tok` rounded):
//
//   tok_f[t] = sum_tap bf16(x)[t + s_tap] bf16(Wu[tap]),  s_tap = (tap / 3 - 1, tap % 3 - 1),
//   x zero outside t's h x w image; tok = tok_f, xn = LN1(tok_f + pe_tok),
//
// both in the IO type (bf16: rounded once; LN1 from the unrounded sums, as
// kernels/spa_block.py: tokenize_ln_plain). tokenize.cuh's tap_conv_kernel
// keeps the f32 form and K3.e.
//
// Bound at [400, 32, 32, 64]: 57.9 GFLOP over the taps inside the image,
// 0.059 ms at the bf16 rate; x, pe_tok, tok and xn 263 MB in bf16, 0.0784 ms
// (f32 IO 525 MB, 0.157 ms): bytes. The design before this one
// (tap_conv_kernel<C, 2C, PM, true, true, IO>: one TF32 `wgmma` a k8 step
// over bf16-rounded values, the taps split into hi and lo (590 KB, half of it
// the unread lo parts) through a 3-stage cp.async ring for every 128-token
// block with a block barrier a stage, each chain of two k8 steps waited on,
// A four scalar loads and conversions a k8 step, the band widened to f32,
// the LN1 epilogue through a [128, D + 8] f32 tile) took 0.7984 ms (bf16
// IO) and 0.7444 (f32 IO) on an H100 at 700 W. This one:
// * The taps stay resident as bf16: the launch's first kernel rounds Wu
//   (9 C D values, 147 KB at C = 64) once into the K-major core matrices
//   bf16 `wgmma` reads (kernels/spa_block.py: tap_weights_bf16), and each
//   persistent block copies them into shared memory once.
// * A tile is r x cw pixels of one view (r cw <= 128 tokens;
//   kernels/spa_block.py: tok_bf16_tile, a function of the shapes), its band
//   of (r + 2) x (cw + 2) pixels bf16 in shared memory at a row stride of C
//   + 8 values, zero outside the image (written by the block itself). Two
//   bands: the next tile's is staged while this tile's products run, bf16 by
//   16-byte cp.async as it lies (zero-filled outside the image), f32 (its
//   rows prefetched into L2 at the tile's start, view-major) a 16-byte unit
//   a thread and tap through registers, rounded as it is stored at the next
//   tap (loads kept in that order, `ldg4_in_order`: hoisted, the nine taps'
//   loads held 72 registers; stored at their own tap, they waited out their
//   latency: 0.09 of 0.45 ms).
// * The products: bf16 `wgmma` m64nNk16 (N = min(D, 64), two parts at D =
//   128) with A from registers: each tap's A fragments come from the band by
//   `ldmatrix_x4`, a row address a lane, so a tap's rows start at any band
//   pixel; no scalar loads or conversions in the loop. A tap's products are
//   one commit group, the two parts' k16 steps alternating so that no
//   `wgmma` waits on the one before it; the next tap's fragments load while
//   they run (`wgmma_wait<1>`).
// * Sums: one chain over the whole K = 9 C, in the tensor cores' f32
//   accumulators, in tap order. They round their sums toward zero once a
//   k16 step: 36 times at C = 64, about 36 x 2^-24 of a sum, some 1e-3 of
//   the distance that bf16 operands put between these forms and f32 (the
//   limit is 1/10 of it). A chain a tap, flushed into f32 registers, held
//   two sets of chain sums beside the sums: 255 registers with spills, and
//   every tap waited on (0.35 ms in bf16 IO, `probe_variants`).
// * The epilogue on the accumulators: tok straight from them; xn = LN1(tok +
//   pe_tok), pe_tok read in their layout (all of a thread's loads issued
//   before its first store), across the quad (rowgemm.cuh: quad_ln); no f32
//   tile in shared memory. Each lane stores 16 bytes, the quad's pairs moved
//   across its lanes (rowgemm.cuh: rg_store_rows16; a pair a lane, half a
//   sector, the stores took 0.13 of 0.29 ms in bf16 IO).
// Shared memory (`TokBf16::bytes`): the taps 9 C D x 2 bytes and two bands;
// C = 64 with 8 x 16 tiles: 147,456 + 2 x 25,920 = 199,296 bytes. One block
// of 256 threads an SM, persistent over the tiles. Every output is written
// by one thread of one block, no atomics: a call repeats bitwise.
#pragma once

#include "bf16mma.cuh"
#include "rowgemm.cuh"
#include "spa.cuh"

namespace lft {

constexpr int TOK_N = 64;   // columns a `wgmma` (a part of D)

template <int C>
struct TokBf16 {
  static constexpr int D = 2 * C;
  static constexpr int LDB = C + 8;          // band row stride (bf16 values)
  static constexpr int KS = C / 16;          // k16 steps of a tap
  static constexpr int ELEMS = 9 * C * D;    // the taps in bf16
  static constexpr int WBYTES = 2 * ELEMS;
  __host__ __device__ static constexpr int band_bytes(int r, int cw) {
    return (r + 2) * (cw + 2) * LDB * 2;
  }
  __host__ __device__ static constexpr int bytes(int r, int cw) {
    return WBYTES + 2 * band_bytes(r, cw);
  }
};

// Wu [9, C, D] rounded to bf16, each tap's C x D laid out [C / 16][2][D /
// 8][8][8] (kernels/rowgemm.py: bf16_piece) at tap C D.
template <int C>
__global__ void __launch_bounds__(256)
    tok_bf16_weights_kernel(const float* __restrict__ wu, bf16* __restrict__ wb) {
  constexpr int D = 2 * C;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < 9 * C * D; i += gridDim.x * 256) {
    const int tap = i / (C * D), e = i % (C * D), k = e / D, n = e % D;
    wb[tap * C * D + ((k / 16 * 2 + k % 16 / 8) * (D / 8) + n / 8) * 64 + n % 8 * 8 + k % 8] =
        __float2bfloat16_rn(__ldg(wu + i));
  }
}

// 8 floats at p, loaded where the program puts the load: the asm keeps the
// compiler from moving it above the products issued before it.
__device__ __forceinline__ void ldg4_in_order(const float* p, float4& a, float4& b) {
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(a.x), "=f"(a.y), "=f"(a.z), "=f"(a.w) : "l"(p));
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(b.x), "=f"(b.y), "=f"(b.z), "=f"(b.w) : "l"(p + 4));
}

// x [V, h, w, C] (PM: [V / A2, h, w, A2, C]), pe_tok [h, w, D], tok and xn
// [V, h, w, D] in IO; wb the rounded taps (tok_bf16_weights_kernel); ln
// (LN1 w, b) f32; tiles of r x cw pixels.
template <int C, bool PM, class IO>
__global__ void __launch_bounds__(RG_NT, 1)
    tok_bf16_kernel(const IO* __restrict__ x, const bf16* __restrict__ wb,
                    const IO* __restrict__ pe_tok, const float* __restrict__ ln,
                    IO* __restrict__ tok, IO* __restrict__ xn, int V, int h, int w, int A2, int r,
                    int cw) {
  using G = TokBf16<C>;
  constexpr int D = G::D, LDB = G::LDB, KS = G::KS;
  constexpr int NW = D < TOK_N ? D : TOK_N, NP = D / NW;   // a part's columns, the parts
  extern __shared__ __align__(16) float smem[];   // the type the other kernels of lft declare
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const bf16* ws = reinterpret_cast<const bf16*>(sm);
  bf16* bands = reinterpret_cast<bf16*>(sm + G::WBYTES);
  const int bw = cw + 2, P = (r + 2) * bw, units = P * (C / 8);
  const int txs = (w + cw - 1) / cw, per_view = ((h + r - 1) / r) * txs, tiles = V * per_view;
  const int hw = h * w, ntok = r * cw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int wm = 16 * warp;   // the warp's 16 token rows

  // tile -> (view, y0, x0)
  auto where = [&](int tile, int& view, int& y0, int& x0) {
    view = tile / per_view;
    const int t = tile % per_view;
    y0 = (t / txs) * r;
    x0 = (t % txs) * cw;
  };
  // unit u of a tile's band (pixel u / (C / 8), 8 channels): its source row
  // of x (pixel-major with PM: spa.cuh's pm_row of the view-major token), or
  // -1 outside the image or past the band
  auto source = [&](int view, int y0, int x0, int u) {
    const int p = u / (C / 8), y = y0 - 1 + p / bw, xx = x0 - 1 + p % bw;
    if (u >= units || y < 0 || y >= h || xx < 0 || xx >= w) return -1;
    return PM ? ((view / A2) * hw + y * w + xx) * A2 + view % A2 : view * hw + y * w + xx;
  };
  auto src_of = [&](int row, int u) { return x + static_cast<size_t>(row) * C + 8 * (u % (C / 8)); };
  auto dst_of = [&](bf16* band, int u) { return band + (u / (C / 8)) * LDB + 8 * (u % (C / 8)); };
  // a tile's band: bf16 by cp.async (one group); f32 through registers
  auto stage_all = [&](bf16* band, int view, int y0, int x0, int j0) {
    for (int u = tid + RG_NT * j0; u < units; u += RG_NT) {
      const int row = source(view, y0, x0, u);
      if constexpr (is_bf16<IO>) {
        cp_async16v(dst_of(band, u), row < 0 ? x : src_of(row, u), row >= 0);
      } else {
        const float* s = src_of(row < 0 ? 0 : row, u);
        const float4 a = row < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ldg4(s);
        const float4 b = row < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : ldg4(s + 4);
        *reinterpret_cast<uint4*>(dst_of(band, u)) =
            make_uint4(narrow2(a.x, a.y), narrow2(a.z, a.w), narrow2(b.x, b.y), narrow2(b.z, b.w));
      }
    }
    if constexpr (is_bf16<IO>) cp_async_commit();
  };

  for (int i = 16 * tid; i < G::WBYTES; i += 16 * RG_NT)
    cp_async16v(sm + i, reinterpret_cast<const unsigned char*>(wb) + i, true);
  cp_async_commit();
  {  // the first tile's band
    int view, y0, x0;
    where(blockIdx.x, view, y0, x0);
    stage_all(bands, view, y0, x0, 0);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const bf16* cur = bands + (it & 1) * P * LDB;
    bf16* nxt = bands + ((it + 1) & 1) * P * LDB;
    const int next = tile + static_cast<int>(gridDim.x);
    int view, y0, x0, nview = 0, ny0 = 0, nx0 = 0;
    where(tile, view, y0, x0);
    if (next < tiles) where(next, nview, ny0, nx0);
    // the lane's A row address (ldmatrix: row lane % 16 of the warp's 16,
    // k half lane / 16): its token's band pixel, a pad row past the tile
    // reading pixel (1, 1)
    const int m = wm + (lane & 15);
    const bf16* arow = cur + (m < ntok ? (m / cw + 1) * bw + m % cw + 1 : bw + 1) * LDB +
                       8 * (lane >> 4);
    float acc[NP][NW / 2];   // the sums, part p's in acc[p] (WgmmaBf's layout)
    uint32_t af[2][KS][4];   // [tap parity][k16 step]
    auto load_a = [&](int tap, int b) {
      const int toff = (tap / 3 - 1) * bw + (tap % 3 - 1);
#pragma unroll
      for (int s = 0; s < KS; ++s) ldmatrix_x4(af[b][s], arow + toff * LDB + 16 * s);
    };
    // the tap's products, one commit group
    auto issue = [&](int tap) {
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s)   // the parts' chains alternate: no two in a row depend
#pragma unroll
        for (int p = 0; p < NP; ++p)
          WgmmaBf<NW>::mma(acc[p], af[tap & 1][s], bf16_piece_desc<D>(ws, tap * C * D, s, p * NW),
                           tap + s);
      wgmma_commit();
    };
    if constexpr (is_bf16<IO>) {   // the next band, as it lies
      if (next < tiles) stage_all(nxt, nview, ny0, nx0, 0);
    } else if (next < tiles && !PM && tid < r + 2) {   // f32: its rows into L2 first
      const int y = ny0 - 1 + tid, xl = max(nx0 - 1, 0), xr = min(nx0 + cw, w - 1);
      if (y >= 0 && y < h)
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                         x + (static_cast<size_t>(nview) * hw + y * w + xl) * C),
                     "r"((xr - xl + 1) * C * 4)
                     : "memory");
    }
    // f32: the next band's unit `tap` of this thread, loaded at the tap's
    // start and stored rounded at the next tap's, its products issued
    float4 ua[2], ub[2];
    int urow[2];
    auto put_unit = [&](int tap) {
      const int u = tid + RG_NT * tap, b = tap & 1;
      if (next < tiles && u < units)
        *reinterpret_cast<uint4*>(dst_of(nxt, u)) =
            urow[b] < 0 ? make_uint4(0u, 0u, 0u, 0u)
                        : make_uint4(narrow2(ua[b].x, ua[b].y), narrow2(ua[b].z, ua[b].w),
                                     narrow2(ub[b].x, ub[b].y), narrow2(ub[b].z, ub[b].w));
    };
    load_a(0, 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if constexpr (!is_bf16<IO>) {
        const int u = tid + RG_NT * tap;
        urow[tap & 1] = next < tiles ? source(nview, ny0, nx0, u) : -1;
        if (urow[tap & 1] >= 0) ldg4_in_order(src_of(urow[tap & 1], u), ua[tap & 1], ub[tap & 1]);
      }
      issue(tap);
      if (tap > 0) wgmma_wait<1>();   // the last tap's products, which read the other fragments
      if (tap < 8) load_a(tap + 1, (tap + 1) & 1);
      if constexpr (!is_bf16<IO>)
        if (tap > 0) put_unit(tap - 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    if constexpr (!is_bf16<IO>) put_unit(8);
    if constexpr (!is_bf16<IO>)   // units past the taps' nine (bands over 2,304 units)
      if (next < tiles) stage_all(nxt, nview, ny0, nx0, 9);

    // tok, then xn = LN1(tok + pe_tok), rows g and g + 8 of the warp
    int t[2];
    long long rows[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int mm = wm + g + 8 * e, y = y0 + mm / cw, xx = x0 + mm % cw;
      t[e] = mm < ntok && y < h && xx < w ? view * hw + y * w + xx : -1;
      rows[e] = t[e];
    }
    RgAcc<D> v;   // the sums in rowgemm.cuh's layout (parts of 64 columns): the same order
#pragma unroll
    for (int i = 0; i < D / 2; ++i) v[i / 32][i % 32] = acc[i / (NW / 2)][i % (NW / 2)];
    // pe_tok of every pair first, all loads in flight together (loaded
    // between the stores, each waited behind the one before: 0.19 of 0.34
    // ms went to them in bf16 IO, `probe_variants`' no_io), as they lie
    constexpr int NJ = D / 8, JP = RgParts<D>::NW / 8;   // 8-column groups: of a row, a part
    using PeT = std::conditional_t<is_bf16<IO>, uint32_t, float2>;
    PeT pe[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const IO* at = pe_tok + static_cast<size_t>(t[e] % hw) * D + 8 * j + 2 * q;
        if constexpr (is_bf16<IO>)
          pe[j][e] = t[e] < 0 ? 0u : __ldg(reinterpret_cast<const unsigned int*>(at));
        else
          pe[j][e] = t[e] < 0 ? make_float2(0.f, 0.f) : ldg2(at);
      }
    rg_store_rows16<D>(tok, v, rows);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v0 = v[j / JP][4 * (j % JP) + 2 * e];
        float& v1 = v[j / JP][4 * (j % JP) + 2 * e + 1];
        float2 p2;
        if constexpr (is_bf16<IO>)
          p2 = widen2(pe[j][e]);
        else
          p2 = pe[j][e];
        v0 += p2.x;
        v1 += p2.y;
      }
    quad_ln<D>(v, ln, ln + D);
    rg_store_rows16<D>(xn, v, rows);
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with this band, and the next one is in
  }
}

// The launch: the taps' rounding into wf (TokBf16<C>::ELEMS bf16 values),
// then the persistent kernel over V views of h x w in tiles of r x cw
// pixels, one block an SM.
template <int C, bool PM, class IO>
int launch_tok_bf16(const IO* x, const float* wu, float* wf, const IO* pe_tok, const float* ln,
                    IO* tok, IO* xn, int V, int h, int w, int A2, int r, int cw, cudaStream_t s) {
  using G = TokBf16<C>;
  if (V < 1 || h < 1 || w < 1 || A2 < 1 || r < 1 || cw < 1 || r * cw > RG_M ||
      G::bytes(r, cw) > RG_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(V) * ((h + r - 1) / r) * ((w + cw - 1) / cw);
  if (static_cast<long long>(V) * h * w > 0x7fffffffLL || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* wb = reinterpret_cast<bf16*>(wf);
  tok_bf16_weights_kernel<C><<<(G::ELEMS + 255) / 256, 256, 0, s>>>(wu, wb);
  auto kernel = tok_bf16_kernel<C, PM, IO>;
  LFT_SET_SMEM(kernel, G::bytes(r, cw));
  kernel<<<rg_grid(static_cast<int>(tiles)), RG_NT, G::bytes(r, cw), s>>>(x, wb, pe_tok, ln, tok,
                                                                          xn, V, h, w, A2, r, cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lft
