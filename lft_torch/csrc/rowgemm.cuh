// A block's token-row products on the tensor cores, 3xTF32 (`wgmma`): the
// shared building block of K2.2 (spa_qkv), K2.4 (spa_outproj_ln), K2.5 /
// K11.5 (spa_ffn_out[_pm]), all in spa_block.cu, K3.a and K3.d
// (spa_ffn_out_bwd, spa_qkv_ln_bwd: spa_block_bwd.cu, rowbwd.cuh), K1
// (ang_block[_res]) and K4 (ang_block_bwd's steps a and c; ang_block.cu).
//
//   acc[64 x N] (+)= A[64 x K] B[K x N]
//
// * A is a warpgroup's 64 token rows in shared memory, row-major at a
//   padded stride (K contiguous: the K-major operand tf32 `wgmma` takes).
//   Each warp reads its own 16 rows into registers in the m16n8k8 fragment
//   layout and splits them into TF32 hi/lo as it loads (tf32.cuh), so the
//   rows a warp writes from its accumulators (the same 16 rows) are the
//   rows it reads next: between the products of a tile no warp waits for
//   another.
// * B is a weight matrix, split into TF32 hi/lo and laid out in K-major
//   core matrices by `rg_weights_kernel`, the first kernel of each launch
//   (in plain PyTorch `kernels/rowgemm.py:piece`). A kernel's weights are
//   one stream of such pieces in the order its products read them, and the
//   stream goes through a ring of RG_SF-float stages (`WeightRing`,
//   `cp.async`, NS - 2 stages ahead): split, the weights (576 KB for K2.5,
//   1.38 MB for K3.a, 256 KB for K1 at C = 64) do not fit in shared memory
//   beside the rows.
//   A weight that does fit (one D x D weight, 128 KB split at C = 64: K2.2
//   and K2.4) stays resident for a whole pass over the tiles instead
//   (`ResidentWeights`): the same product reads it without a ring and
//   without a block barrier, which on an H100 ran K2.2's products 1.7x
//   faster than the ring did. K3.a's stream (1.38 MB) goes through
//   `MbarRing`: the same slots filled by bulk copies on mbarriers, with no
//   block barrier a stage (1.33x WeightRing's speed for K3.a on an H100).
// * 3xTF32 with both tails rounded to nearest (`split_tf32_rn`; B's by the
//   weight kernel): the truncated tails of tf32.cuh's `split_tf32` err
//   toward zero alike, and over these short products (K = 16-128) that
//   bias brought C = 16's K1 up to twice the f32 block's error against
//   float64 (a scratch run on an H100).
// * The tensor cores round their f32 sums toward zero, so the products of
//   every 16 of K (two k8 steps: 6 MMAs, al bh + ah bl + ah bh each, the
//   first from zero) are a chain with its own accumulators, added into acc
//   in f32 on the FP32 pipes in K order.
// * The drains overlap: the chains (16 of K times a part of N <= 64
//   columns: one `wgmma` of width 64 where N allows) alternate between two
//   sets of chain accumulators, along K where N <= 64 and between the two
//   64-column halves at N = 128, so `wgmma.wait_group 1` retires one chain
//   (which is then added into its part of acc) while the next runs on the
//   tensor cores. The A fragments are double-buffered: the next 16 of K
//   load and split while this 16's chains run. On an H100 (a scratch A/B
//   of the variants, no number kept) 64-column parts beat 32-column ones,
//   whose chains cost more in issue, wait and flush than the tensor cores'
//   work; so did descriptors advanced by constants over rebuilt ones; an L2
//   prefetch of a block's next rows slowed K2.5 and is not made.
// * N <= 128 per product; K and N are multiples of 16; a chain's 32 N
//   floats of B never straddle two stages.
// * BF (`--dtype mixed`'s backward): both operands rounded to bf16 (A as
//   it is loaded, B by `rg_weights_kernel<true>` into the hi part of the
//   same layout, lo left 0), one TF32 `wgmma` a k8 step instead of three,
//   the same chains and f32 accumulation (tf32.cuh). A `_sites` instance
//   (a `--dtype mixed` site subset) takes BF or 3xTF32 product by product
//   at run time (`rg_product_site`), its weights split piece by piece to
//   match (`RgPiece::bf`).
// Every output is written by one warp of one block, no atomics: a call
// repeats bitwise.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace lft {

constexpr int RG_M = 128;               // token rows of a block: 2 warpgroups of 64
constexpr int RG_NT = 256;              // threads of a block
constexpr int RG_SF = 4096;             // floats of a ring stage (16 KB)
constexpr int RG_SMEM_MAX = 232448;     // shared memory a block can use

// Ring slots that fit beside `tile_bytes` of rows, at most 8.
constexpr int rg_slots(int tile_bytes) {
  return (RG_SMEM_MAX - tile_bytes) / (RG_SF * 4) < 8 ? (RG_SMEM_MAX - tile_bytes) / (RG_SF * 4)
                                                       : 8;
}

// One piece of a weight stream: B[k][n] = src[k ld + n], K x N, written at
// stream offset `off` (floats); with `tr` B is read transposed, B[k][n] =
// src[n ld + k] (a backward's Wᵀ from the forward's W, with no copy). bf:
// the piece is split as a BF product reads it (bf16 in hi, lo 0), read by
// the `_sites` instances' weight kernel only (`rg_weights_kernel<.., true>`).
struct RgPiece {
  const float* src;
  int ld, K, N, off;
  int tr;
  int bf;
};
constexpr int RG_MAX_PIECES = 12;
struct RgPieces {
  RgPiece p[RG_MAX_PIECES];
};

// B split into TF32 hi and lo (both rounded to nearest), per piece
// [K / 8][2 (hi, lo)][2 (k half)][N / 8][8 (n)][4 (k)]: a k8 step's hi (or
// lo) is core matrices of 8 columns x 4 k, 128 bytes each, N / 8 of them
// 128 bytes apart, then the second k half (kernels/rowgemm.py:piece). BF:
// hi is B rounded to bf16 and lo 0, in the same layout, so a BF product
// never reads a 3xTF32 split. PER (the `_sites` instances): each piece as
// its own `bf` says, the same layout either way.
template <bool BF = false, bool PER = false>
__global__ void __launch_bounds__(256) rg_weights_kernel(RgPieces ps, float* __restrict__ wf) {
  const RgPiece pc = ps.p[blockIdx.y];
  for (int i = blockIdx.x * 256 + threadIdx.x; i < pc.K * pc.N; i += gridDim.x * 256) {
    const int k = i / pc.N, n = i % pc.N;
    uint32_t hi, lo;
    const float v = __ldg(pc.src + (pc.tr ? static_cast<size_t>(n) * pc.ld + k
                                          : static_cast<size_t>(k) * pc.ld + n));
    if constexpr (PER) {
      if (pc.bf) {
        hi = bf16_bits(v);
        lo = 0u;
      } else {
        split_tf32_rn(v, hi, lo);
      }
    } else if constexpr (BF) {
      hi = bf16_bits(v);
      lo = 0u;
    } else {
      split_tf32_rn(v, hi, lo);
    }
    const size_t at = pc.off +
                      (static_cast<size_t>((k / 8) * 4 + k % 8 / 4) * (pc.N / 8) + n / 8) * 32 +
                      n % 8 * 4 + k % 4;
    wf[at] = __uint_as_float(hi);
    wf[at + 8 * pc.N] = __uint_as_float(lo);
  }
}

// per: each piece split as its `bf` says (a `_sites` instance's weights).
inline void launch_rg_weights(const RgPieces& ps, int n, float* wf, cudaStream_t s,
                              bool bf = false, bool per = false) {
  int most = 0;
  for (int i = 0; i < n; ++i) most = ps.p[i].K * ps.p[i].N > most ? ps.p[i].K * ps.p[i].N : most;
  const dim3 grid((most + 255) / 256, n);
  if (per)
    rg_weights_kernel<false, true><<<grid, 256, 0, s>>>(ps, wf);
  else if (bf)
    rg_weights_kernel<true><<<grid, 256, 0, s>>>(ps, wf);
  else
    rg_weights_kernel<false><<<grid, 256, 0, s>>>(ps, wf);
}

// The same for any number of pieces, RG_MAX_PIECES a launch.
inline void launch_rg_pieces(const RgPiece* all, int n, float* wf, cudaStream_t s,
                             bool bf = false, bool per = false) {
  for (int i = 0; i < n; i += RG_MAX_PIECES) {
    RgPieces ps{};
    const int k = n - i < RG_MAX_PIECES ? n - i : RG_MAX_PIECES;
    for (int j = 0; j < k; ++j) ps.p[j] = all[i + j];
    launch_rg_weights(ps, k, wf, s, bf, per);
  }
}

// Blocks of a persistent launch over `tiles` row tiles: one a multiprocessor
// (a block takes most of its shared memory), each walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., so that the weight ring runs on from one
// tile into the next.
inline int rg_grid(int tiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return tiles < sms ? tiles : sms;
}

// f(std::integral_constant<int, I>) for I = 0 .. N - 1: a loop whose index
// is a compile-time constant (a product's stream offset).
template <int N, int I = 0, class F>
__device__ __forceinline__ void rg_static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    rg_static_for<N, I + 1>(f);
  }
}

// The weight stream through NS shared-memory slots, PD = NS - 2 stages
// ahead. Stage st of the block is stage st % spt of the stream (one tile's
// stream a pass). A slot is refilled two stages after it was read: by then
// every chain that read it has retired (a warpgroup has at most one chain
// in flight, which reads the stage before the current one or the current
// one), and the barrier of `enter` has seen every warpgroup past it.
template <int NS>
struct WeightRing {
  static constexpr int SF = RG_SF;   // floats of a stage
  static constexpr int PD = NS - 2;
  static_assert(PD >= 1, "the ring needs three slots");
  float* slot;        // [NS][RG_SF]
  const float* wf;    // one tile's stream
  int total, spt;     // floats and stages of the stream
  int last;           // stages this block enters
  int s;              // the next stage to enter

  __device__ __forceinline__ void load(int st) const {
    if (st < last) {
      const int off = (st % spt) * RG_SF;
      const int n = total - off < RG_SF ? total - off : RG_SF;
      const float* src = wf + off;
      float* dst = slot + (st % NS) * RG_SF;
      for (int i = 4 * static_cast<int>(threadIdx.x); i < n; i += 4 * RG_NT)
        cp_async16(dst + i, src + i, true);
    }
    cp_async_commit();   // one group a stage, empty past the last
  }
  __device__ __forceinline__ void start(float* slots, const float* stream, int floats,
                                        int tiles) {
    slot = slots;
    wf = stream;
    total = floats;
    spt = (floats + RG_SF - 1) / RG_SF;
    last = tiles * spt;
    s = 0;
    for (int i = 0; i < PD; ++i) load(i);
  }
  // Waits for the next stage, refills the slot read two stages ago, and
  // returns the stage's slot.
  __device__ __forceinline__ const float* enter() {
    cp_async_wait<PD - 1>();
    fence_proxy_async();
    __syncthreads();
    load(s + PD);
    return slot + (s++ % NS) * RG_SF;
  }
};

// ---- mbarriers and bulk copies (sm_90) for MbarRing.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// Whether the phase of parity `parity` of b has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits for the phase of parity `parity` of b to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from device to shared memory by the copy engine,
// completing on b's transaction count.
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src, uint32_t bytes,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// The weight stream through NS slots as WeightRing sets it out, without its
// block barrier a stage: thread 0 fills a slot by one bulk copy on the
// slot's `full` mbarrier, and each warpgroup's first thread releases a slot
// on its `empty` mbarrier (two arrivals) once the warpgroup's chains that
// read it have retired (two stages on, as in WeightRing). A warpgroup waits
// only for its next stage to arrive, so the two run up to PD stages apart.
// Thread 0 issues the stages up to PD ahead whose slots are free, and
// waits for a slot only when its own warpgroup needs that stage next. bars:
// 2 NS mbarriers in shared memory.
template <int NS>
struct MbarRing {
  static constexpr int SF = RG_SF;   // floats of a stage
  static constexpr int PD = NS - 2;
  static_assert(PD >= 1, "the ring needs three slots");
  float* slot;              // [NS][RG_SF]
  uint64_t *full, *empty;   // [NS] each
  const float* wf;          // one tile's stream
  int total, spt, last;     // floats and stages of the stream, stages of the block
  int s;                    // the next stage to enter
  int issued;               // stages issued (thread 0)

  __device__ __forceinline__ void issue(int t) {
    const int i = t % NS, off = (t % spt) * RG_SF;
    const int n = total - off < RG_SF ? total - off : RG_SF;
    mbar_expect_tx(full + i, 4u * n);
    bulk_g2s(slot + i * RG_SF, wf + off, 4u * n, full + i);
  }
  // Issues the stages up to s + PD - 1 whose slots both warpgroups have
  // released; waits for the slot of a stage <= need.
  __device__ __forceinline__ void fill(int need) {
    while (issued < last && issued < s + PD) {
      if (issued >= NS) {
        const uint32_t parity = ((issued / NS) - 1) & 1;
        if (issued <= need)
          mbar_wait(empty + issued % NS, parity);
        else if (!mbar_test(empty + issued % NS, parity))
          break;
      }
      issue(issued++);
    }
  }
  __device__ __forceinline__ void start(float* slots, uint64_t* bars, const float* stream,
                                        int floats, int tiles) {
    slot = slots;
    full = bars;
    empty = bars + NS;
    wf = stream;
    total = floats;
    spt = (floats + RG_SF - 1) / RG_SF;
    last = tiles * spt;
    s = 0;
    issued = 0;
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) fill(-1);
  }
  // Releases the stage read two stages ago, fills, waits for the next stage
  // and returns its slot.
  __device__ __forceinline__ const float* enter() {
    if (s >= 2 && (threadIdx.x & 127) == 0) mbar_arrive(empty + (s - 2) % NS);
    if (threadIdx.x == 0) fill(s);
    mbar_wait(full + s % NS, (s / NS) & 1);
    return slot + (s++ % NS) * RG_SF;
  }
};

// MbarRing with its slot count set at run time (`start`'s ns, at least 3):
// K1 `_sites` (ang_sites.cuh), whose shared memory depends on its mask. The
// same protocol, the slot arithmetic on a run-time count, and thread 0
// issues every stage whose slot both warpgroups have released rather than
// PD ahead of the one entered: that kernel enters a product's stages
// together before its first `wgmma`, so with PD ahead a product's last
// stage was issued only as the product began.
template <>
struct MbarRing<0> {
  static constexpr int SF = RG_SF;
  float* slot;
  uint64_t *full, *empty;
  const float* wf;
  int total, spt, last, s, issued;
  int ns;   // slots

  __device__ __forceinline__ void issue(int t) {
    const int i = t % ns, off = (t % spt) * RG_SF;
    const int n = total - off < RG_SF ? total - off : RG_SF;
    mbar_expect_tx(full + i, 4u * n);
    bulk_g2s(slot + i * RG_SF, wf + off, 4u * n, full + i);
  }
  __device__ __forceinline__ void fill(int need) {
    while (issued < last) {
      if (issued >= ns) {
        const uint32_t parity = ((issued / ns) - 1) & 1;
        if (issued <= need)
          mbar_wait(empty + issued % ns, parity);
        else if (!mbar_test(empty + issued % ns, parity))
          break;
      }
      issue(issued++);
    }
  }
  __device__ __forceinline__ void start(float* slots, uint64_t* bars, const float* stream,
                                        int floats, int tiles, int slots_n) {
    ns = slots_n;
    slot = slots;
    full = bars;
    empty = bars + ns;
    wf = stream;
    total = floats;
    spt = (floats + RG_SF - 1) / RG_SF;
    last = tiles * spt;
    s = 0;
    issued = 0;
    if (threadIdx.x == 0) {
      for (int i = 0; i < ns; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) fill(-1);
  }
  __device__ __forceinline__ const float* enter() {
    if (s >= 2 && (threadIdx.x & 127) == 0) mbar_arrive(empty + (s - 2) % ns);
    if (threadIdx.x == 0) fill(s);
    mbar_wait(full + s % ns, (s / ns) & 1);
    return slot + (s++ % ns) * RG_SF;
  }
};

// A weight held whole in shared memory for a pass over the tiles: one
// stage as large as any stream, entered once, where the stream starts.
struct ResidentWeights {
  static constexpr int SF = 1 << 30;
  const float* w;
  __device__ __forceinline__ const float* enter() const { return w; }
};

template <int N>
struct RgParts {
  static constexpr int NW = N < 64 ? N : 64;   // columns of a part (a wgmma's N)
  static constexpr int NP = N / NW;            // parts of acc
  static constexpr int R = NW / 2;             // accumulators a thread, a part
};

template <int N>
using RgAcc = float[RgParts<N>::NP][RgParts<N>::R];

template <int N>
__device__ __forceinline__ void rg_zero(RgAcc<N>& acc) {
#pragma unroll
  for (int p = 0; p < RgParts<N>::NP; ++p)
#pragma unroll
    for (int i = 0; i < RgParts<N>::R; ++i) acc[p][i] = 0.f;
}

// Calls f(row, col, v0, v1) for each of a thread's pairs of acc (as
// lvalues): the warp's row `row` (0..15: g or g + 8), columns col, col + 1.
template <int N, class F>
__device__ __forceinline__ void rg_pairs(RgAcc<N>& acc, F f) {
  using P = RgParts<N>;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(g + 8 * h, p * P::NW + 8 * j + 2 * q, acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]);
}

// The warp's rows g and g + 8 of acc into rows r[0] and r[1] of dst (N
// values a row, IO type; a row < 0 is not stored), 16 bytes a lane: the
// quad's pairs moved across its lanes first (bf16: a lane stores the eight
// columns of one 8-column group, f32: four of them), so that a warp's store
// fills whole 32-byte sectors where a pair a lane filled half of one.
template <int N, class IO>
__device__ __forceinline__ void rg_store_rows16(IO* __restrict__ dst, const RgAcc<N>& acc,
                                                const long long (&r)[2]) {
  using P = RgParts<N>;
  constexpr int NJ = N / 8, JP = P::NW / 8;
  static_assert(NJ % (is_bf16<IO> ? 4 : 2) == 0, "whole groups of 8-column groups");
  const int q = threadIdx.x & 3;
  auto val = [&](int j, int e, int i) { return acc[j / JP][4 * (j % JP) + 2 * e + i]; };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    IO* row = dst + r[e] * N;
    if constexpr (is_bf16<IO>) {
      auto pick = [](const uint32_t (&m)[4], int i) {
        return i == 0 ? m[0] : i == 1 ? m[1] : i == 2 ? m[2] : m[3];
      };
#pragma unroll
      for (int jb = 0; jb < NJ / 4; ++jb) {
        uint32_t m[4], x[4];   // m[k]: this lane's pair of group 4 jb + k
#pragma unroll
        for (int k = 0; k < 4; ++k) m[k] = narrow2(val(4 * jb + k, e, 0), val(4 * jb + k, e, 1));
#pragma unroll
        for (int d = 0; d < 4; ++d)   // x[d]: lane q ^ d's pair of group 4 jb + q
          x[d] = d ? __shfl_xor_sync(0xffffffffu, pick(m, q ^ d), d) : pick(m, q);
        if (r[e] >= 0)
          *reinterpret_cast<uint4*>(row + 8 * (4 * jb + q)) =
              make_uint4(pick(x, q), pick(x, q ^ 1), pick(x, q ^ 2), pick(x, q ^ 3));
      }
    } else {
      const bool odd = q & 1;
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {   // even lanes group j, odd ones group j + 1
        const float2 a = make_float2(val(j, e, 0), val(j, e, 1));
        const float2 b = make_float2(val(j + 1, e, 0), val(j + 1, e, 1));
        const float2 send = odd ? a : b;
        const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                       __shfl_xor_sync(0xffffffffu, send.y, 1));
        if (r[e] >= 0)
          *reinterpret_cast<float4*>(row + (odd ? 8 * (j + 1) + 2 * (q - 1) : 8 * j + 2 * q)) =
              odd ? make_float4(got.x, got.y, b.x, b.y) : make_float4(a.x, a.y, got.x, got.y);
      }
    }
  }
}

// LayerNorm (torch's: biased variance, eps 1e-5, affine w, b), in place,
// of the warp's 16 rows held in the accumulator layout of an N-wide
// product: row g + 8 h's N values lie in the four lanes of a quad, so a
// row's sums take two shuffles and all 16 rows are normalised at once.
// KEEP: also hands out each row's mean and 1/std (mu[h], rstd[h]), so a
// backward can rebuild xhat = (x - mu) rstd bit for bit (K3.a).
template <int N, bool KEEP = false>
__device__ __forceinline__ void quad_ln(RgAcc<N>& v, const float* __restrict__ w,
                                        const float* __restrict__ b, float* mu_out = nullptr,
                                        float* rstd_out = nullptr) {
  using P = RgParts<N>;
  const int q = threadIdx.x & 3;
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
    const float rstd = rsqrtf(qq / N + 1e-5f);
    if constexpr (KEEP) {
      mu_out[h] = mu;
      rstd_out[h] = rstd;
    }
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int j = 0; j < P::NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = p * P::NW + 8 * j + 2 * q + e;
          float& x = v[p][4 * j + 2 * h + e];
          x = (x - mu) * rstd * __ldg(w + c) + __ldg(b + c);
        }
  }
}

// acc (+)= A B for the warpgroup's 64 rows. `a`: the warp's first row in
// shared memory, row stride lda floats. B: stream floats [OFF, OFF + 2 K N)
// (K x N, `rg_weights_kernel`'s layout) from `ring` (a WeightRing or
// ResidentWeights); `st` is the slot of the current stage, entered here
// where a chain starts a new one. TAILS_FIRST: a chain issues the four
// tail products (al bh, ah bl of both k8 steps) before the two ah bh, so
// that only two of its truncated sums are at the chain's full magnitude
// (four in the default order); at K = 16 a product is one chain, and this
// order keeps it within the f32 product's error (K3.a's dout Wlinᵀ at C =
// 16, an H100). BF: A rounded to bf16 as it loads, one product a k8 step
// over B's bf16 part (the header).
template <int K, int N, int OFF, bool TAILS_FIRST = false, bool BF = false, class W>
__device__ __forceinline__ void rg_product(RgAcc<N>& acc, const float* a, int lda, W& ring,
                                           const float*& st) {
  using P = RgParts<N>;
  constexpr int NP = P::NP, NW = P::NW, R = P::R, NC = K / 16, SF = W::SF;
  constexpr int CHAIN = 32 * N;   // floats of B a chunk of 16 of K reads (hi and lo)
  static_assert(K % 16 == 0 && N % 16 == 0 && N <= 128, "unsupported product shape");
  static_assert(OFF % CHAIN == 0 && SF % CHAIN == 0, "a chunk must not straddle two stages");
  constexpr int LBO = N / 8 * 128, SBO = 128;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* a0 = a + g * lda + q;
  const float* a1 = a0 + 8 * lda;

  uint32_t ah[2][2][4], al[2][2][4];   // [buffer][k8 step][fragment]
  float sum[2][R];                     // the two sets of chain accumulators
  auto load_a = [&](int c, int b) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k0 = 16 * c + 8 * u;
      if constexpr (BF) {
        ah[b][u][0] = bf16_bits(a0[k0]);
        ah[b][u][1] = bf16_bits(a1[k0]);
        ah[b][u][2] = bf16_bits(a0[k0 + 4]);
        ah[b][u][3] = bf16_bits(a1[k0 + 4]);
        continue;
      }
      split_tf32_rn(a0[k0], ah[b][u][0], al[b][u][0]);
      split_tf32_rn(a1[k0], ah[b][u][1], al[b][u][1]);
      split_tf32_rn(a0[k0 + 4], ah[b][u][2], al[b][u][2]);
      split_tf32_rn(a1[k0 + 4], ah[b][u][3], al[b][u][3]);
    }
  };
  // chain i: 16 of K (chunk i / NP) times part i % NP, into set i % 2
  auto issue = [&](int i) {
    const int c = i / NP, p = i % NP, z = i & 1;
    // the k8 steps' hi, then lo, 16 N and 8 N floats on (4 N and 2 N in the
    // descriptor's 16-byte units)
    const uint64_t d0 =
        smem_desc(st + (OFF + c * CHAIN) % SF + p * (NW / 8) * 32, LBO, SBO);
    reg_fence(sum[z]);
    wgmma_fence();
    if constexpr (BF) {
#pragma unroll
      for (int u = 0; u < 2; ++u) Wgmma<NW>::mma(sum[z], ah[c & 1][u], d0 + u * 4 * N, u);
    } else if constexpr (TAILS_FIRST) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint64_t dh = d0 + u * 4 * N, dl = dh + 2 * N;
        Wgmma<NW>::mma(sum[z], al[c & 1][u], dh, u);
        Wgmma<NW>::mma(sum[z], ah[c & 1][u], dl, 1);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) Wgmma<NW>::mma(sum[z], ah[c & 1][u], d0 + u * 4 * N, 1);
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint64_t dh = d0 + u * 4 * N, dl = dh + 2 * N;
        Wgmma<NW>::mma(sum[z], al[c & 1][u], dh, u);
        Wgmma<NW>::mma(sum[z], ah[c & 1][u], dl, 1);
        Wgmma<NW>::mma(sum[z], ah[c & 1][u], dh, 1);
      }
    }
    wgmma_commit();
  };
  auto flush = [&](int i) {
    const int p = i % NP, z = i & 1;
    reg_fence(sum[z]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[p][r] += sum[z][r];
  };

  load_a(0, 0);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if ((OFF + c * CHAIN) % SF == 0) st = ring.enter();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int i = c * NP + p;
      issue(i);
      if (i > 0) {   // retire the chain before this one and add it
        wgmma_wait<1>();
        flush(i - 1);
      }
      if (p == 0 && c + 1 < NC) load_a(c + 1, (c + 1) & 1);
    }
  }
  wgmma_wait<0>();
  flush(NC * NP - 1);
}

// rg_product<K, N, OFF, TAILS, BF>; with SITES (a `_sites` instance) BF is
// `bf`, the bit of the product's site in the instance's mask, taken at run
// time (the same in every thread of the block, so the branch is uniform and
// both paths keep the ring's stages in step).
template <int K, int N, int OFF, bool BF, bool SITES, bool TAILS = false, class W>
__device__ __forceinline__ void rg_product_site(bool bf, RgAcc<N>& acc, const float* a, int lda,
                                                W& ring, const float*& st) {
  if constexpr (SITES) {
    if (bf)
      rg_product<K, N, OFF, TAILS, true>(acc, a, lda, ring, st);
    else
      rg_product<K, N, OFF, TAILS, false>(acc, a, lda, ring, st);
  } else {
    rg_product<K, N, OFF, TAILS, BF>(acc, a, lda, ring, st);
  }
}

}  // namespace lft
