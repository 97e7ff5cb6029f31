// The weight gradients of the block backwards: Xᵀ·dY over a long token
// axis, and column sums, both deterministic.
//
// Replaces the weight-gradient accumulators of lft_tpu/kernels/
// ang_block.py:_bwd_kernel (zeroing :280-288, flush :396-402) and
// spa_block.py:_bwd_kernel (:402-415, :570-578), which added every grid
// step's contribution into constant-index output blocks: exact there only
// because the TPU grid is sequential. Here the token axis is cut into S
// fixed slices; block (tile, slice) writes the slice's partial product of
// one output tile, and the column-sum kernel adds the S partials of each
// output in slice order. No atomics, so a train step is bitwise
// repeatable. With taps = 9 the X rows are the 3x3-shifted neighbours of
// each token inside its h x w image (zero outside): the tokenization's
// weight gradient dwu without materialising unfold(x).
//
// Bound on this card: at T = 102,400 tokens each product reads X and dY
// once (26-105 MB a launch, 8-31 us at 3.35 TB/s) and does 2 T K N FLOP.
// On the FP32 pipes (67 TFLOP/s) the products are bound by operations;
// on the tensor cores they are bound by bytes, so the products run there:
//
// * 3xTF32 (tf32.cuh: `split_tf32`, `mma_tf32`). `wgmma` takes tf32
//   operands from shared memory K-major only, and the reduction axis here
//   (tokens) is the slow axis of both X [T, K] and dY [T, N]; `mma.sync`
//   fragments are loaded from a token-major tile as they lie. Rows are
//   padded by 8 floats, so the 32 lanes of a fragment load (token q, column
//   g) hit 32 banks.
// * A ring of 3 stages of 32-token slabs filled by `cp.async` (zero-filled
//   past the slice or the matrix edge), so loads overlap the products.
// * 128 x 128 output tiles over 8 warps (64 x 32 a warp: 4 x 4 MMA tiles),
//   one block an SM; for N <= 64, 64 x 64 over 2 warps, two blocks an SM.
//   The token split S gives about that many blocks (wgrad.py:splits).
// * dwu (taps = 9) from one staging of X: a block stages, for its 32
//   tokens, the three image rows above, at and below them (one token of
//   halo each side) and serves all nine taps from shared memory, one warp
//   a tap; a tap is a row offset, a 9-bit mask per token zeroes the taps
//   that leave the image. dtok is read once, and X once a 32-column tile
//   of dtok (its bands come again from L2), not once a tap.
// * BF (`lft_wgrad_bf16`, the weight grads of `--dtype mixed`'s backward:
//   lft_tpu accumulates Xᵀ dY over bf16 operands): X and dY rounded to bf16
//   as their fragments load, one `mma.sync` a step instead of three, the
//   same slabs and f32 accumulation (tf32.cuh).
// * bf16 IO (`lft_wgrad_bf16io`, the weight grads of `--dtype bfloat16`
//   training: lft_tpu's Xᵀ dY over its bf16 operands, f32 sums) has kernels
//   of its own, `wgrad_bf16io_kernel` and `wgrad_bf16io_taps_kernel`
//   (below): X and dY bf16 in device memory, staged as they lie by 16-byte
//   `cp.async` into a ring of 4 stages of 64 tokens (bf16 rows padded by 8
//   values: conflict-free `ldmatrix`), with 3 stages in flight while the
//   products run; the products bf16 `mma.sync.m16n8k16` (bf16mma.cuh) on
//   fragments read transposed from the token-major rows (`ldmatrix.trans`),
//   f32 accumulation. A chain is one stage: each 16 x 8 tile's 4 k16 MMAs
//   (64 tokens) add into their own accumulators from zero, which the FP32
//   pipes then add to the tile's sums (the tensor cores' truncation over a
//   slice's hundreds of steps, as above). `_f32dy` (K3's and K4's dx2,
//   which lft_tpu keeps f32 and casts at the site): dY staged f32 by
//   cp.async and rounded to bf16 (to nearest) as its fragments load. The
//   S slices are cut into clusters of Z blocks along the token axis
//   (wgrad.py:bf16io_cut, Z = 2): the cluster adds its Z partials of a tile
//   in rank order through distributed shared memory, each block writing its
//   share of the tile's rows, so only S / Z partials reach device memory
//   (4.33 MB at the step's largest product, against the 8.65 MB of S = 66
//   partials before), and the column sum adds those. Clusters of 4 or 8
//   would halve that again, but at one block an SM an H100 runs only 120 of
//   its 132 SMs in them, and the cluster that waits for a second wave
//   doubled the time (a sweep on an H100). Bound at the step's largest
//   product ([102400, 128] x [102400, 256]): 78.6 MB, 0.023 ms.
//
// colsum (a [R, N] -> a.sum(0)) and the partials' sum are one kernel: a
// cluster of up to 8 blocks (about two blocks an SM in all, at least two
// rows a thread) cuts the rows into contiguous chunks, each thread adds its
// rows in series (float4 across columns where N % 4 == 0, four loads in
// flight), a fixed tree in shared memory joins a block's row groups, and
// rank 0 adds the cluster's chunks in rank order through distributed
// shared memory. One launch, no atomics, no counter; the cut is a function
// of (R, N) alone. Bound by bytes; at N = 256 (12 of 16 launches a step)
// 2 column blocks x a cluster of 8 spread 1,600-2,048 rows over 16 SMs.

#include <cooperative_groups.h>

#include <cstdint>

#include "bf16mma.cuh"
#include "common.cuh"
#include "tf32.cuh"

namespace cg = cooperative_groups;
using namespace lft;

namespace {

constexpr int BT = 32;          // token rows of a stage
constexpr int STAGES = 3;       // depth of the cp.async ring
constexpr int WM = 64;          // output rows of a warp (4 MMA tiles of 16)
constexpr int WN = 32;          // output columns of a warp (4 MMA tiles of 8)
constexpr int PAD = 8;          // row padding in floats: conflict-free fragments

// taps = 1: a block is WARPS_M x WARPS_N warps over a (64 WARPS_M) x
// (32 WARPS_N) tile: 128 x 128 (2 x 4 warps), or 64 x 64 (1 x 2) for N <= 64
template <int WARPS_M, int WARPS_N>
struct Tile {
  static constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  static constexpr int NTH = 32 * WARPS_M * WARPS_N;
  static constexpr int LDX = BM + PAD, LDY = BN + PAD;
  static constexpr int SMEM = STAGES * BT * (LDX + LDY) * 4;
};

// taps = 9: a block is 9 warps (one a tap) over a 64 x 32 tile
constexpr int TAP_NTH = 9 * 32;
constexpr int HR = BT + 2;      // rows of one staged image row band: the slab and its halo
constexpr int TLDX = WM + PAD, TLDY = WN + PAD;
constexpr int TAP_X = 3 * HR * TLDX;          // floats of a stage's X bands
constexpr int TAP_SMEM = (STAGES * (TAP_X + BT * TLDY) + WM) * 4 + STAGES * BT * 4;

// acc (a warp's 64 x 32 tile) += Aᵀ B over one staged slab of BT tokens.
// row_a(t) points at token t's 64 A values of the warp (a zero row for a
// token that adds nothing); ys at the slab's B values of the warp's first
// column, row stride ldy. Fragments (m16n8k8, lane = 4 g + q): A (row m =
// output row, column = token) a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3
// (g+8, q+4); B (token, column) b0 (q, g), b1 (q+4, g). The MMAs add into
// a slab's own accumulators, which are then added to acc by the FP32
// pipes: the tensor cores round their f32 sums toward zero, and over a
// slice's hundreds of steps that bias would grow linearly (1e-5 of the
// largest output at T = 102,400); a slab's chain is 12 MMAs long (4 with
// BF: one product over the bf16-rounded operands).
template <bool BF, class RowA>
__device__ __forceinline__ void warp_slab(float (&acc)[4][4][4], RowA row_a, const float* ys,
                                          int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float sum[4][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < BT; kk += 8) {
    uint32_t bh[4][2], bl[4][2];
    const float* y0 = ys + (kk + q) * ldy + g;
    const float* y1 = y0 + 4 * ldy;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (BF) {
        bh[j][0] = bf16_bits(y0[8 * j]);
        bh[j][1] = bf16_bits(y1[8 * j]);
        continue;
      }
      split_tf32(y0[8 * j], bh[j][0], bl[j][0]);
      split_tf32(y1[8 * j], bh[j][1], bl[j][1]);
    }
    const float* a0 = row_a(kk + q) + g;
    const float* a1 = row_a(kk + q + 4) + g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t ah[4], al[4];
      if constexpr (BF) {
        ah[0] = bf16_bits(a0[16 * i]);
        ah[1] = bf16_bits(a0[16 * i + 8]);
        ah[2] = bf16_bits(a1[16 * i]);
        ah[3] = bf16_bits(a1[16 * i + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(sum[i][j], ah, bh[j][0], bh[j][1]);
        continue;
      }
      split_tf32(a0[16 * i], ah[0], al[0]);
      split_tf32(a0[16 * i + 8], ah[1], al[1]);
      split_tf32(a1[16 * i], ah[2], al[2]);
      split_tf32(a1[16 * i + 8], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(sum[i][j], al, bh[j][0], bh[j][1]);
        mma_tf32(sum[i][j], ah, bl[j][0], bl[j][1]);
        mma_tf32(sum[i][j], ah, bh[j][0], bh[j][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += sum[i][j][e];
}

// dst[row][col] of the warp's tile (row < K, col < N), row stride N.
__device__ __forceinline__ void store_tile(const float (&acc)[4][4][4], float* dst, int r0, int c0,
                                           int K, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 16 * i + g, c = c0 + 8 * j + 2 * q;
      if (c >= N) continue;
      if (r < K)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * N + c) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < K)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(r + 8) * N + c) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

__device__ __forceinline__ void slice(int T, int S, int& t0, int& t1) {
  t0 = static_cast<int>(static_cast<long long>(T) * blockIdx.z / S);
  t1 = static_cast<int>(static_cast<long long>(T) * (blockIdx.z + 1) / S);
}

// taps = 1: block (n tile, k tile, slice) -> dst[slice] = x[slice]ᵀ dy[slice]
// over its tile.
template <int WARPS_M, int WARPS_N, bool BF = false>
__global__ void __launch_bounds__(Tile<WARPS_M, WARPS_N>::NTH)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ dst, int T, int K, int N, int S) {
  using TL = Tile<WARPS_M, WARPS_N>;
  constexpr int BM = TL::BM, BN = TL::BN, NTH = TL::NTH, LDX = TL::LDX, LDY = TL::LDY;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                         // [STAGES][BT][LDX]
  float* Ys = smem + STAGES * BT * LDX;     // [STAGES][BT][LDY]
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  int t0, t1;
  slice(T, S, t0, t1);
  const int nslab = (t1 - t0 + BT - 1) / BT;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const bool active = k0 + wm < K && n0 + wn < N;

  auto load = [&](int slab, int stage) {
    const int tb = t0 + slab * BT;
    float* xs = Xs + stage * BT * LDX;
    float* ys = Ys + stage * BT * LDY;
    for (int i = threadIdx.x; i < BT * (BM / 4); i += NTH) {
      const int r = i / (BM / 4), c = 4 * (i % (BM / 4)), t = tb + r;
      const bool ok = t < t1 && k0 + c < K;
      copy4(xs + r * LDX + c, ok ? x + static_cast<size_t>(t) * K + k0 + c : x, ok);
    }
    for (int i = threadIdx.x; i < BT * (BN / 4); i += NTH) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4)), t = tb + r;
      const bool ok = t < t1 && n0 + c < N;
      copy4(ys + r * LDY + c, ok ? dy + static_cast<size_t>(t) * N + n0 + c : dy, ok);
    }
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nslab; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < nslab) load(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const int stage = j % STAGES;
    if (active) {
      const float* xs = Xs + stage * BT * LDX + wm;
      warp_slab<BF>(acc, [&](int t) { return xs + t * LDX; }, Ys + stage * BT * LDY + wn, LDY);
    }
  }
  cp_async_wait<0>();
  if (active)
    store_tile(acc, dst + static_cast<size_t>(blockIdx.z) * K * N, k0 + wm, n0 + wn, K, N);
}

// taps = 9: block (n tile of 32, k tile of 64, slice); warp = tap = 3 ky + kx
// -> dst[slice][tap] = x_shifted[slice]ᵀ dy[slice] over the tile.
template <bool BF = false>
__global__ void __launch_bounds__(TAP_NTH)
    wgrad_taps_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      float* __restrict__ dst, int T, int K, int N, int S, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                             // [STAGES][3][HR][TLDX]
  float* Ys = Xs + STAGES * TAP_X;              // [STAGES][BT][TLDY]
  float* zero = Ys + STAGES * BT * TLDY;        // [WM] zeros
  int* Fs = reinterpret_cast<int*>(zero + WM);  // [STAGES][BT] tap masks
  const int n0 = blockIdx.x * WN, k0 = blockIdx.y * WM;
  int t0, t1;
  slice(T, S, t0, t1);
  const int nslab = (t1 - t0 + BT - 1) / BT;
  const int hw = h * w;
  const int tap = threadIdx.x >> 5, ky = tap / 3, kx = tap % 3;
  if (threadIdx.x < WM) zero[threadIdx.x] = 0.f;

  auto load = [&](int slab, int stage) {
    const int tb = t0 + slab * BT;
    float* xs = Xs + stage * TAP_X;
    float* ys = Ys + stage * BT * TLDY;
    // band b holds tokens tb + (b - 1) w - 1 + r, r < HR
    for (int i = threadIdx.x; i < 3 * HR * (WM / 4); i += TAP_NTH) {
      const int b = i / (HR * (WM / 4)), rem = i % (HR * (WM / 4));
      const int r = rem / (WM / 4), c = 4 * (rem % (WM / 4));
      const int t = tb + (b - 1) * w - 1 + r;
      const bool ok = t >= 0 && t < T && k0 + c < K;
      copy4(xs + (b * HR + r) * TLDX + c, ok ? x + static_cast<size_t>(t) * K + k0 + c : x, ok);
    }
    for (int i = threadIdx.x; i < BT * (WN / 4); i += TAP_NTH) {
      const int r = i / (WN / 4), c = 4 * (i % (WN / 4)), t = tb + r;
      const bool ok = t < t1 && n0 + c < N;
      copy4(ys + r * TLDY + c, ok ? dy + static_cast<size_t>(t) * N + n0 + c : dy, ok);
    }
    if (threadIdx.x < BT) {
      const int t = tb + threadIdx.x;
      int mask = 0;
      if (t < t1) {
        const int p = t % hw, y = p / w, xx = p - y * w;
        const int rows = (y > 0 ? 1 : 0) | 2 | (y < h - 1 ? 4 : 0);
        const int cols = (xx > 0 ? 1 : 0) | 2 | (xx < w - 1 ? 4 : 0);
        for (int r = 0; r < 3; ++r)
          if (rows >> r & 1) mask |= cols << (3 * r);
      }
      Fs[stage * BT + threadIdx.x] = mask;
    }
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nslab; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < nslab) load(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const int stage = j % STAGES;
    const float* band = Xs + stage * TAP_X + ky * HR * TLDX + kx * TLDX;
    const int* fs = Fs + stage * BT;
    warp_slab<BF>(acc,
                  [&](int t) { return (fs[t] >> tap & 1) ? band + t * TLDX : zero; },
                  Ys + stage * BT * TLDY, TLDY);
  }
  cp_async_wait<0>();
  store_tile(acc, dst + (static_cast<size_t>(blockIdx.z) * 9 + tap) * K * N, k0, n0, K, N);
}

// ------------------------------------------------------------ bf16 IO ---

constexpr int BIO_BT = 64;       // tokens of a stage: one chain of 4 k16 MMAs
constexpr int BIO_STAGES = 4;    // depth of the cp.async ring
constexpr int BIO_CL = 8;        // most blocks of a cluster (the portable maximum)

// taps = 1: WARPS_M x WARPS_N warps over a (64 WARPS_M) x (32 WARPS_N) tile,
// as Tile; dY of type YT (bf16, or f32 for `_f32dy`). Bytes of a stage: X
// [BIO_BT][LDX] bf16, dY [BIO_BT][LDY]; after the ring, the block's partial
// [BM][LDR] f32 in the same shared memory.
template <int WARPS_M, int WARPS_N, class YT>
struct BioTile {
  static constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  static constexpr int NTH = 32 * WARPS_M * WARPS_N;
  static constexpr int LDX = BM + 8;                          // bf16 values
  static constexpr int LDY = is_bf16<YT> ? BN + 8 : BN + 4;   // YT values
  static constexpr int XS = BIO_BT * LDX * 2;
  static constexpr int STAGE = XS + BIO_BT * LDY * static_cast<int>(sizeof(YT));
  static constexpr int LDR = BN + 8;                          // f32 values
  static constexpr int RED = BM * LDR * 4;
  static constexpr int SMEM = BIO_STAGES * STAGE > RED ? BIO_STAGES * STAGE : RED;
};

// taps = 9: one warp a tap over a 64 x 32 tile, as wgrad_taps_kernel. A
// stage: X bands [3][BIO_BT + 2][TLDX] bf16, dY [BIO_BT][LDY], tap masks
// [BIO_BT]; after the ring a zero row [64] bf16; then the partials [9][64][40]
// f32 over the ring.
template <class YT>
struct BioTaps {
  static constexpr int HR = BIO_BT + 2;
  static constexpr int TLDX = WM + 8;
  static constexpr int LDY = is_bf16<YT> ? WN + 8 : WN + 4;
  static constexpr int XS = 3 * HR * TLDX * 2;
  static constexpr int YS = BIO_BT * LDY * static_cast<int>(sizeof(YT));
  static constexpr int STAGE = XS + YS + BIO_BT * 4;
  static constexpr int RING = BIO_STAGES * STAGE;
  static constexpr int LDR = WN + 8;
  static constexpr int RED = 9 * WM * LDR * 4;
  static constexpr int SMEM = (RING > RED ? RING : RED) + WM * 2;
};

// acc (a warp's 64 x 32 tile) += Aᵀ B over one staged slab of BIO_BT
// tokens. a_row(t, c): the shared address of token t's A values from
// column c (a multiple of 8) of the warp's 64 (a zero row for a token that
// adds nothing); ys: the slab's dY from the warp's first column, row stride
// ldy. The slab's MMAs add into its own accumulators, then acc += them on
// the FP32 pipes (the header: a chain of 4 k16 MMAs).
template <class YT, class RowA>
__device__ __forceinline__ void bio_slab(float (&acc)[4][4][4], RowA a_row,
                                         const YT* __restrict__ ys, int ldy) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mat = lane >> 3, r = lane & 7;
  float sum[4][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < BIO_BT; kk += 16) {
    uint32_t b[4][2];
    if constexpr (is_bf16<YT>) {
      // matrices (n tile j, k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15)
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t t4[4];
        ldmatrix_x4_trans(t4, ys + (kk + r + 8 * (mat & 1)) * ldy + 8 * (j + (mat >> 1)));
        b[j][0] = t4[0];
        b[j][1] = t4[1];
        b[j + 1][0] = t4[2];
        b[j + 1][1] = t4[3];
      }
    } else {
      const float* y0 = ys + (kk + 2 * q) * ldy + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = narrow2(y0[8 * j], y0[ldy + 8 * j]);
        b[j][1] = narrow2(y0[8 * ldy + 8 * j], y0[9 * ldy + 8 * j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
      uint32_t a[4];
      ldmatrix_x4_trans(a, a_row(kk + r + 8 * (mat >> 1), 16 * i + 8 * (mat & 1)));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(sum[i][j], a, b[j][0], b[j][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += sum[i][j][e];
}

// The warp's 64 x 32 tile into red (row stride ldr) from row r0, column c0.
__device__ __forceinline__ void bio_stash(const float (&acc)[4][4][4], float* red, int ldr,
                                          int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* p = red + (r0 + 16 * i + g) * ldr + c0 + 8 * j + 2 * q;
      st2(p, acc[i][j][0], acc[i][j][1]);
      st2(p + 8 * ldr, acc[i][j][2], acc[i][j][3]);
    }
}

// The cluster's partials of one tile, `rows` rows of COLS floats at a
// stride of LDR in each block's red, added in rank order through
// distributed shared memory: rank k takes rows [rows k / Z, rows (k + 1) /
// Z) and hands each 4-column sum to put(row, col, float4). With one block a
// cluster, the block's own rows.
template <int COLS, int LDR, int NTH, class Put>
__device__ __forceinline__ void bio_cluster_sum(float* red, int rows, Put put) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  cluster.sync();
  const int r0 = rows * rank / size, r1 = rows * (rank + 1) / size;
  constexpr int C4 = COLS / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * C4; i += NTH) {
    const int row = r0 + i / C4, c = 4 * (i % C4);
    float4 v = load4(cluster.map_shared_rank(red, 0) + row * LDR + c);
    for (int k = 1; k < size; ++k)
      v = add4(v, load4(cluster.map_shared_rank(red, k) + row * LDR + c));
    put(row, c, v);
  }
  cluster.sync();   // every block's shared memory lives until the others have read it
}

// taps = 1: block (n tile, k tile, slice); the cluster (Z slices in a row of
// blockIdx.z) writes dst[blockIdx.z / Z] = the sum of its slices' x[slice]ᵀ
// dy[slice] over its tile.
template <int WARPS_M, int WARPS_N, class YT>
__global__ void __launch_bounds__(BioTile<WARPS_M, WARPS_N, YT>::NTH)
    wgrad_bf16io_kernel(const bf16* __restrict__ x, const YT* __restrict__ dy,
                        float* __restrict__ dst, int T, int K, int N, int S) {
  using TL = BioTile<WARPS_M, WARPS_N, YT>;
  constexpr int BM = TL::BM, BN = TL::BN, NTH = TL::NTH, LDX = TL::LDX, LDY = TL::LDY;
  constexpr int YE = 16 / static_cast<int>(sizeof(YT));   // dY values of a 16-byte copy
  extern __shared__ __align__(16) unsigned char bsm[];
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  int t0, t1;
  slice(T, S, t0, t1);
  const int nslab = (t1 - t0 + BIO_BT - 1) / BIO_BT;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const bool active = k0 + wm < K && n0 + wn < N;
  auto xs_of = [&](int st) { return reinterpret_cast<bf16*>(bsm + st * TL::STAGE); };
  auto ys_of = [&](int st) { return reinterpret_cast<YT*>(bsm + st * TL::STAGE + TL::XS); };

  auto load = [&](int slab, int stage) {
    const int tb = t0 + slab * BIO_BT;
    bf16* xs = xs_of(stage);
    YT* ys = ys_of(stage);
    for (int i = threadIdx.x; i < BIO_BT * (BM / 8); i += NTH) {
      const int r = i / (BM / 8), c = 8 * (i % (BM / 8)), t = tb + r;
      const bool ok = t < t1 && k0 + c < K;
      cp_async16v(xs + r * LDX + c, ok ? x + static_cast<size_t>(t) * K + k0 + c : x, ok);
    }
    for (int i = threadIdx.x; i < BIO_BT * (BN / YE); i += NTH) {
      const int r = i / (BN / YE), c = YE * (i % (BN / YE)), t = tb + r;
      const bool ok = t < t1 && n0 + c < N;
      cp_async16v(ys + r * LDY + c, ok ? dy + static_cast<size_t>(t) * N + n0 + c : dy, ok);
    }
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < BIO_STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nslab; ++j) {
    cp_async_wait<BIO_STAGES - 2>();
    __syncthreads();
    if (j + BIO_STAGES - 1 < nslab) load(j + BIO_STAGES - 1, (j + BIO_STAGES - 1) % BIO_STAGES);
    cp_async_commit();
    const int stage = j % BIO_STAGES;
    if (active) {
      const bf16* xs = xs_of(stage) + wm;
      bio_slab<YT>(acc, [&](int t, int c) { return xs + t * LDX + c; }, ys_of(stage) + wn, LDY);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is read: the partial takes its place
  float* red = reinterpret_cast<float*>(bsm);
  bio_stash(acc, red, TL::LDR, wm, wn);
  const int size = static_cast<int>(cg::this_cluster().num_blocks());
  float* d = dst + static_cast<size_t>(blockIdx.z / size) * K * N;
  bio_cluster_sum<BN, TL::LDR, NTH>(red, BM, [&](int row, int c, float4 v) {
    const int k = k0 + row, n = n0 + c;
    if (k < K && n < N) store4(d + static_cast<size_t>(k) * N + n, v);
  });
}

// taps = 9: block (n tile of 32, k tile of 64, slice); warp = tap = 3 ky +
// kx; the cluster writes dst[blockIdx.z / Z][tap] = the sum of its slices'
// x_shifted[slice]ᵀ dy[slice] over the tile. The staging of
// wgrad_taps_kernel (three image row bands with a token of halo, a 9-bit
// mask a token), each lane of an `ldmatrix` pointing at its token's row of
// the tap's band or at the zero row.
template <class YT>
__global__ void __launch_bounds__(TAP_NTH)
    wgrad_bf16io_taps_kernel(const bf16* __restrict__ x, const YT* __restrict__ dy,
                             float* __restrict__ dst, int T, int K, int N, int S, int h, int w) {
  using TP = BioTaps<YT>;
  constexpr int HR = TP::HR, TLDX = TP::TLDX, LDY = TP::LDY;
  constexpr int YE = 16 / static_cast<int>(sizeof(YT));
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* zero = reinterpret_cast<bf16*>(bsm + (TP::RING > TP::RED ? TP::RING : TP::RED));
  const int n0 = blockIdx.x * WN, k0 = blockIdx.y * WM;
  int t0, t1;
  slice(T, S, t0, t1);
  const int nslab = (t1 - t0 + BIO_BT - 1) / BIO_BT;
  const int hw = h * w;
  const int tap = threadIdx.x >> 5, ky = tap / 3, kx = tap % 3;
  if (threadIdx.x < WM) zero[threadIdx.x] = __float2bfloat16_rn(0.f);
  auto xs_of = [&](int st) { return reinterpret_cast<bf16*>(bsm + st * TP::STAGE); };
  auto ys_of = [&](int st) { return reinterpret_cast<YT*>(bsm + st * TP::STAGE + TP::XS); };
  auto fs_of = [&](int st) {
    return reinterpret_cast<int*>(bsm + st * TP::STAGE + TP::XS + TP::YS);
  };

  auto load = [&](int slab, int stage) {
    const int tb = t0 + slab * BIO_BT;
    bf16* xs = xs_of(stage);
    YT* ys = ys_of(stage);
    // band b holds tokens tb + (b - 1) w - 1 + r, r < HR
    for (int i = threadIdx.x; i < 3 * HR * (WM / 8); i += TAP_NTH) {
      const int b = i / (HR * (WM / 8)), rem = i % (HR * (WM / 8));
      const int r = rem / (WM / 8), c = 8 * (rem % (WM / 8));
      const int t = tb + (b - 1) * w - 1 + r;
      const bool ok = t >= 0 && t < T && k0 + c < K;
      cp_async16v(xs + (b * HR + r) * TLDX + c, ok ? x + static_cast<size_t>(t) * K + k0 + c : x,
                  ok);
    }
    for (int i = threadIdx.x; i < BIO_BT * (WN / YE); i += TAP_NTH) {
      const int r = i / (WN / YE), c = YE * (i % (WN / YE)), t = tb + r;
      const bool ok = t < t1 && n0 + c < N;
      cp_async16v(ys + r * LDY + c, ok ? dy + static_cast<size_t>(t) * N + n0 + c : dy, ok);
    }
    if (threadIdx.x < BIO_BT) {
      const int t = tb + threadIdx.x;
      int mask = 0;
      if (t < t1) {
        const int p = t % hw, y = p / w, xx = p - y * w;
        const int rows = (y > 0 ? 1 : 0) | 2 | (y < h - 1 ? 4 : 0);
        const int cols = (xx > 0 ? 1 : 0) | 2 | (xx < w - 1 ? 4 : 0);
        for (int r = 0; r < 3; ++r)
          if (rows >> r & 1) mask |= cols << (3 * r);
      }
      fs_of(stage)[threadIdx.x] = mask;
    }
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < BIO_STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < nslab; ++j) {
    cp_async_wait<BIO_STAGES - 2>();
    __syncthreads();
    if (j + BIO_STAGES - 1 < nslab) load(j + BIO_STAGES - 1, (j + BIO_STAGES - 1) % BIO_STAGES);
    cp_async_commit();
    const int stage = j % BIO_STAGES;
    const bf16* band = xs_of(stage) + (ky * HR + kx) * TLDX;
    const int* fs = fs_of(stage);
    bio_slab<YT>(
        acc, [&](int t, int c) { return (fs[t] >> tap & 1) ? band + t * TLDX + c : zero + c; },
        ys_of(stage), LDY);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(bsm);   // [9][64][LDR]
  bio_stash(acc, red, TP::LDR, tap * WM, 0);
  const int size = static_cast<int>(cg::this_cluster().num_blocks());
  float* d = dst + static_cast<size_t>(blockIdx.z / size) * 9 * K * N;
  bio_cluster_sum<WN, TP::LDR, TAP_NTH>(red, 9 * WM, [&](int row, int c, float4 v) {
    const int k = k0 + row % WM, n = n0 + c;
    if (k < K && n < N) store4(d + (static_cast<size_t>(row / WM) * K + k) * N + n, v);
  });
}

// ---------------------------------------------------------------- colsum ---

constexpr int CS_THREADS = 512;  // a block: `lanes` columns x 512 / lanes row groups
constexpr int CS_MAX = 8;        // blocks of a cluster (the portable maximum)
constexpr int CS_UNROLL = 4;     // loads in flight a thread

// out[n] = sum_r a[r][n]. The cluster (blockIdx.y) cuts the rows into
// contiguous chunks; in a chunk, row group g of the block adds rows g,
// g + G, g + 2G, ... in series (G = 512 / lanes), the groups are joined by a
// halving tree, and rank 0 adds the chunks in rank order. W = 4: a lane
// takes a float4 of columns.
template <int W>
__global__ void __launch_bounds__(CS_THREADS)
    colsum_kernel(const float* __restrict__ a, float* __restrict__ out, int R, int N,
                  int lanes) {
  __shared__ float4 red[CS_THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const int groups = CS_THREADS / lanes;
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const int col = (blockIdx.x * lanes + lane) * W;
  const int r0 = static_cast<int>(static_cast<long long>(R) * rank / size);
  const int r1 = static_cast<int>(static_cast<long long>(R) * (rank + 1) / size);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < N) {
    const size_t step = static_cast<size_t>(groups) * N;
    int r = r0 + grp;
    for (; r + (CS_UNROLL - 1) * groups < r1; r += CS_UNROLL * groups) {
      const float* p = a + static_cast<size_t>(r) * N + col;
      float4 v[CS_UNROLL];
#pragma unroll
      for (int u = 0; u < CS_UNROLL; ++u)
        v[u] = W == 4 ? ldg4(p + u * step) : make_float4(__ldg(p + u * step), 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < CS_UNROLL; ++u) s = add4(s, v[u]);
    }
    for (; r < r1; r += groups) {
      const float* p = a + static_cast<size_t>(r) * N + col;
      s = add4(s, W == 4 ? ldg4(p) : make_float4(__ldg(p), 0.f, 0.f, 0.f));
    }
  }
  red[threadIdx.x] = s;
  for (int half = groups / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (grp < half) red[threadIdx.x] = add4(red[threadIdx.x], red[threadIdx.x + half * lanes]);
  }
  cluster.sync();
  if (rank == 0 && grp == 0 && col < N) {
    float4 v = red[lane];
    for (int c = 1; c < size; ++c) v = add4(v, cluster.map_shared_rank(red, c)[lane]);
    if constexpr (W == 4)
      store4(out + col, v);
    else
      out[col] = v.x;
  }
  cluster.sync();   // every block's shared memory lives until rank 0 has read it
}

template <int WARPS_M, int WARPS_N, bool BF>
cudaError_t launch_product(const float* x, const float* dy, float* dst, int T, int K, int N,
                           int S, cudaStream_t s) {
  using TL = Tile<WARPS_M, WARPS_N>;
  auto kernel = wgrad_kernel<WARPS_M, WARPS_N, BF>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TL::BN - 1) / TL::BN, (K + TL::BM - 1) / TL::BM, S);
  kernel<<<grid, TL::NTH, TL::SMEM, s>>>(x, dy, dst, T, K, N, S);
  return cudaGetLastError();
}

// `lanes` column lanes a block (32 or 64) and `size` blocks a cluster
// (wgrad.py:colsum_cut, functions of R and N).
cudaError_t launch_colsum(const float* a, float* out, int R, int N, int lanes, int size,
                          cudaStream_t s) {
  if (size < 1 || size > CS_MAX || (lanes != 32 && lanes != 64))
    return cudaErrorInvalidValue;
  const int W = N % 4 == 0 ? 4 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + lanes * W - 1) / (lanes * W), size, 1);
  cfg.blockDim = dim3(CS_THREADS, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = size;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // one block a cluster: a plain grid, each block its own cluster (4% less
  // time than a cluster launch at [100, 131072] on an H100)
  cfg.numAttrs = size > 1 ? 1 : 0;
  return W == 4 ? cudaLaunchKernelEx(&cfg, colsum_kernel<4>, a, out, R, N, lanes)
                : cudaLaunchKernelEx(&cfg, colsum_kernel<1>, a, out, R, N, lanes);
}

template <bool BF>
int wgrad(const float* x, const float* dy, float* part, float* out, int T, int K, int N, int S,
          int lanes, int size, int h, int w, cudaStream_t s) {
  const int taps = h > 0 ? 9 : 1;
  if (T < 1 || K < 4 || N < 4 || K % 4 || N % 4 || S < 1 || S > T ||
      (taps == 9 && (w < 1 || T % (h * w))))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = S > 1 ? part : out;
  cudaError_t err;
  if (taps == 1 && N > 64) {
    err = launch_product<2, 4, BF>(x, dy, dst, T, K, N, S, s);
  } else if (taps == 1) {
    err = launch_product<1, 2, BF>(x, dy, dst, T, K, N, S, s);
  } else {
    auto kernel = wgrad_taps_kernel<BF>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TAP_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + WN - 1) / WN, (K + WM - 1) / WM, S);
    kernel<<<grid, TAP_NTH, TAP_SMEM, s>>>(x, dy, dst, T, K, N, S, h, w);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  return static_cast<int>(launch_colsum(part, out, S, taps * K * N, lanes, size, s));
}


// One launch of a bf16-IO kernel: Z blocks a cluster along the slices.
template <class... KArgs, class... Args>
cudaError_t launch_bio(void (*kernel)(KArgs...), dim3 grid, int nth, int smem, int Z,
                       cudaStream_t s, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nth, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = Z;
  cfg.attrs = attr;
  cfg.numAttrs = Z > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int WARPS_M, int WARPS_N, class YT>
cudaError_t launch_bio_product(const bf16* x, const YT* dy, float* dst, int T, int K, int N,
                               int S, int Z, cudaStream_t s) {
  using TL = BioTile<WARPS_M, WARPS_N, YT>;
  const dim3 grid((N + TL::BN - 1) / TL::BN, (K + TL::BM - 1) / TL::BM, S);
  return launch_bio(wgrad_bf16io_kernel<WARPS_M, WARPS_N, YT>, grid, TL::NTH, TL::SMEM, Z, s,
                    x, dy, dst, T, K, N, S);
}

template <class YT>
int wgrad_bf16io(const bf16* x, const YT* dy, float* part, float* out, int T, int K, int N,
                 int S, int Z, int lanes, int size, int h, int w, cudaStream_t s) {
  const int taps = h > 0 ? 9 : 1;
  if (T < 1 || K < 8 || N < 8 || K % 8 || N % 8 || Z < 1 || Z > BIO_CL || S < Z || S % Z ||
      S > T || (taps == 9 && (w < 1 || T % (h * w))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = S / Z;
  float* dst = groups > 1 ? part : out;
  cudaError_t err;
  if (taps == 1 && N > 64) {
    err = launch_bio_product<2, 4, YT>(x, dy, dst, T, K, N, S, Z, s);
  } else if (taps == 1) {
    err = launch_bio_product<1, 2, YT>(x, dy, dst, T, K, N, S, Z, s);
  } else {
    const dim3 grid((N + WN - 1) / WN, (K + WM - 1) / WM, S);
    err = launch_bio(wgrad_bf16io_taps_kernel<YT>, grid, TAP_NTH, BioTaps<YT>::SMEM, Z, s, x,
                     dy, dst, T, K, N, S, h, w);
  }
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  return static_cast<int>(launch_colsum(part, out, groups, taps * K * N, lanes, size, s));
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// x [T, K], dy [T, N] (K, N multiples of 4); part [S, taps, K, N] scratch
// (unused when S = 1), its S partials added by the column sum (`lanes`,
// `size`);
// out [taps, K, N]. taps = 1 (h = 0): out = xᵀ dy.
// taps = 9 (h, w > 0, T a multiple of h w): out[ky * 3 + kx] = x_shiftedᵀ dy
// with x_shifted[t] the token at (y + ky - 1, x + kx - 1) of t's image,
// zero outside it.
extern "C" int lft_wgrad(const float* x, const float* dy, float* part, float* out, int T,
                         int K, int N, int S, int lanes, int size, int h, int w,
                         void* stream) {
  return wgrad<false>(x, dy, part, out, T, K, N, S, lanes, size, h, w,
                      static_cast<cudaStream_t>(stream));
}

// The same over bf16-rounded x and dy (the header's BF).
extern "C" int lft_wgrad_bf16(const float* x, const float* dy, float* part, float* out, int T,
                              int K, int N, int S, int lanes, int size, int h, int w,
                              void* stream) {
  return wgrad<true>(x, dy, part, out, T, K, N, S, lanes, size, h, w,
                     static_cast<cudaStream_t>(stream));
}

// The same over bf16 x and dy in device memory (`--dtype bfloat16`
// training, the header's bf16 IO): f32 sums, an f32 out. S slices in
// clusters of Z (S a multiple of Z, Z <= 8, wgrad.py:bf16io_cut); part
// [S / Z, taps, K, N] scratch, unused when S = Z; K and N multiples of 8.
extern "C" int lft_wgrad_bf16io(const bf16* x, const bf16* dy, float* part, float* out, int T,
                                int K, int N, int S, int Z, int lanes, int size, int h, int w,
                                void* stream) {
  return wgrad_bf16io(x, dy, part, out, T, K, N, S, Z, lanes, size, h, w,
                      static_cast<cudaStream_t>(stream));
}

// The same with dy f32 in device memory, rounded to bf16 as its fragments
// load.
extern "C" int lft_wgrad_bf16io_f32dy(const bf16* x, const float* dy, float* part, float* out,
                                      int T, int K, int N, int S, int Z, int lanes, int size,
                                      int h, int w, void* stream) {
  return wgrad_bf16io(x, dy, part, out, T, K, N, S, Z, lanes, size, h, w,
                      static_cast<cudaStream_t>(stream));
}

// out[n] = sum_r a[r][n] of a [R, N] (launch_colsum).
extern "C" int lft_colsum(const float* a, float* out, int R, int N, int lanes, int size,
                          void* stream) {
  if (R < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_colsum(a, out, R, N, lanes, size, static_cast<cudaStream_t>(stream)));
}
