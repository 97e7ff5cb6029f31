// The weight gradients of the block backwards: Xᵀ·dY over a long token
// axis, and column sums, both deterministic.
//
// Replaces the weight-gradient accumulators of lft_tpu/kernels/
// ang_block.py:_bwd_kernel (zeroing :280-288, flush :396-402) and
// spa_block.py:_bwd_kernel (:402-415, :570-578), which added every grid
// step's contribution into constant-index output blocks: exact there only
// because the TPU grid is sequential. Here the token axis is cut into S
// fixed slices; block (tile, slice) writes the slice's partial product of
// one 64 x 64 output tile, and a second kernel adds the S partials of each
// output in slice order. No atomics, so a train step is bitwise
// repeatable. With taps = 9 the X rows are the 3x3-shifted neighbours of
// each token inside its h x w image (zero outside): the tokenization's
// weight gradient dwu without materialising unfold(x).
//
// Bound on this card: 2 T K N FLOP on the FP32 pipes (at T = 102,400 the
// K3 weight grads total ~44 GFLOP, 0.66 ms at 67 TFLOP/s) against reading
// X and dY once: operations for K, N >= 64. Each thread keeps a 4 x 4
// micro-tile of the output and reads one float4 of X and one of dY from
// shared memory per token, 16 FMAs per two loads.

#include "common.cuh"

using namespace lft;

namespace {

constexpr int TB = 64;   // output tile edge
constexpr int TK = 32;   // token rows staged per step

__global__ void __launch_bounds__(NT)
    wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         float* __restrict__ part, int T, int K, int N, int S, int taps,
                         int h, int w) {
  __shared__ __align__(16) float XS[TK][TB + 4];
  __shared__ __align__(16) float YS[TK][TB + 4];
  const int k0 = blockIdx.y * TB, n0 = blockIdx.x * TB;
  const int split = blockIdx.z % S, tap = blockIdx.z / S;
  const int t0 = static_cast<int>(static_cast<long long>(T) * split / S);
  const int t1 = static_cast<int>(static_cast<long long>(T) * (split + 1) / S);
  const int hw = h * w;
  const int sy = tap / 3 - 1, sx = tap % 3 - 1;   // taps == 9 only
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};

  for (int tb = t0; tb < t1; tb += TK) {
    for (int i = threadIdx.x; i < TK * (TB / 4); i += NT) {
      const int r = i / (TB / 4), c = 4 * (i % (TB / 4));
      const int t = tb + r;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
      if (t < t1) {
        if (n0 + c < N) yv = ldg4(dy + static_cast<size_t>(t) * N + n0 + c);
        int src = t;
        if (taps == 9) {
          const int rem = t % hw;
          const int y = rem / w + sy, xx = rem % w + sx;
          src = (y >= 0 && y < h && xx >= 0 && xx < w) ? t + sy * w + sx : -1;
        }
        if (src >= 0 && k0 + c < K) xv = ldg4(x + static_cast<size_t>(src) * K + k0 + c);
      }
      store4(&XS[r][c], xv);
      store4(&YS[r][c], yv);
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < TK; ++r) {
      const float4 a = load4(&XS[r][ty * 4]);
      const float4 b = load4(&YS[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = part + (static_cast<size_t>(split) * taps + tap) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i, n = n0 + tx * 4;
    if (k < K && n < N)
      store4(dst + static_cast<size_t>(k) * N + n,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// out[i] = sum_s part[s][i] for i < M, slices in order.
__global__ void __launch_bounds__(NT)
    sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int S,
                        int M) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int j = 0; j < S; ++j) s += __ldg(part + static_cast<size_t>(j) * M + i);
  out[i] = s;
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// x [T, K], dy [T, N] (K, N multiples of 4); part [S, taps, K, N] scratch;
// out [taps, K, N]. taps = 1: out = xᵀ dy. taps = 9 (h, w > 0, T a multiple
// of h w): out[ky * 3 + kx] = x_shiftedᵀ dy with x_shifted[t] the token at
// (y + ky - 1, x + kx - 1) of t's image, zero outside it.
extern "C" int lft_wgrad(const float* x, const float* dy, float* part, float* out, int T,
                         int K, int N, int S, int h, int w, void* stream) {
  const int taps = h > 0 ? 9 : 1;
  if (T < 1 || K < 4 || N < 4 || K % 4 || N % 4 || S < 1 || (taps == 9 && T % (h * w)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + TB - 1) / TB, (K + TB - 1) / TB, S * taps);
  wgrad_partial_kernel<<<grid, NT, 0, s>>>(x, dy, part, T, K, N, S, taps, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = taps * K * N;
  sum_partials_kernel<<<(M + NT - 1) / NT, NT, 0, s>>>(part, out, S, M);
  return static_cast<int>(cudaGetLastError());
}

// out[n] = sum_r a[r][n] of a [R, N], rows in order.
extern "C" int lft_colsum(const float* a, float* out, int R, int N, void* stream) {
  if (R < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  sum_partials_kernel<<<(N + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, R, N);
  return static_cast<int>(cudaGetLastError());
}
