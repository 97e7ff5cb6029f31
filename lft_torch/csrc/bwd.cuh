// Building blocks of the backward kernels (ang_block.cu's K4,
// spa_block_bwd.cu's K3): the LayerNorm's saved statistics and backward,
// one warp per row as in RowLN, and the deterministic per-block column sums
// of the LayerNorm affine gradients.
#pragma once

#include "common.cuh"

namespace lft {

// mean and 1/std of a D-wide row held as v[e] = row[lane + 32 e], with
// exactly RowLN::apply's arithmetic, so xhat = (v - mu) * rstd is the
// forward's normalised row bit for bit.
template <int D>
__device__ __forceinline__ void ln_stats(const float (&v)[RowLN<D>::E], float& mu,
                                         float& rstd) {
  using LN = RowLN<D>;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < LN::E; ++e)
    if (LN::valid(e)) s += v[e];
  mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < LN::E; ++e)
    if (LN::valid(e)) {
      const float d = v[e] - mu;
      q = fmaf(d, d, q);
    }
  rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
}

// dx = rstd (dxh - mean(dxh) - xhat mean(dxh xhat)), dxh = dxn * g: the
// cotangent of the LayerNorm input, in place over dxn.
template <int D>
__device__ __forceinline__ void ln_bwd(float (&dxn)[RowLN<D>::E],
                                       const float (&xhat)[RowLN<D>::E], float rstd,
                                       const float* __restrict__ g) {
  using LN = RowLN<D>;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int e = 0; e < LN::E; ++e)
    if (LN::valid(e)) {
      dxn[e] *= __ldg(g + LN::col(e));
      a += dxn[e];
      b = fmaf(dxn[e], xhat[e], b);
    }
  a = warp_sum(a) / D;
  b = warp_sum(b) / D;
#pragma unroll
  for (int e = 0; e < LN::E; ++e)
    if (LN::valid(e)) dxn[e] = rstd * (dxn[e] - a - xhat[e] * b);
}

// Per-warp column sums of a LayerNorm's affine grads, then one fixed-order
// sum over the block's warps. A warp owns the rows warp, warp + 8, ...; its
// lanes add sum(dxn * xhat) and sum(dxn) of those rows into acc, flush them
// to scratch[warp][slot .. slot + 1][D], and after a __syncthreads()
// `block_colsum` writes out[j][c] = sum over warps of scratch[warp][j][c].
template <int D>
struct LnGradAcc {
  float w[RowLN<D>::E], b[RowLN<D>::E];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < RowLN<D>::E; ++e) w[e] = b[e] = 0.f;
  }
  __device__ __forceinline__ void add(const float (&dxn)[RowLN<D>::E],
                                      const float (&xhat)[RowLN<D>::E]) {
#pragma unroll
    for (int e = 0; e < RowLN<D>::E; ++e) {
      w[e] = fmaf(dxn[e], xhat[e], w[e]);
      b[e] += dxn[e];
    }
  }
  // scratch is [NT/32][slots][D]
  __device__ __forceinline__ void flush(float* scratch, int slots, int slot) const {
    float* s = scratch + ((threadIdx.x >> 5) * slots + slot) * D;
#pragma unroll
    for (int e = 0; e < RowLN<D>::E; ++e)
      if (RowLN<D>::valid(e)) {
        s[RowLN<D>::col(e)] = w[e];
        s[D + RowLN<D>::col(e)] = b[e];
      }
  }
};

// out[i] = sum over warps of scratch[warp][i], i < n, warps in order.
__device__ __forceinline__ void block_colsum(const float* scratch, int n,
                                             float* __restrict__ out) {
  for (int i = threadIdx.x; i < n; i += NT) {
    float s = 0.f;
    for (int wp = 0; wp < NT / 32; ++wp) s += scratch[wp * n + i];
    out[i] = s;
  }
}

}  // namespace lft
