// K6: per-op 5x5-window attention, tile-dense: every query tile against its
// whole key halo, forward and backward.
//
// Replaces lft_tpu/kernels/spa_attn.py:_fwd / _vjp_bwd (the Pallas TPU
// kernels behind windowed_attention_mxu). q, k, v [B, h, w, E], 8 heads of
// dh = E / 8; the view is cut into th x tw query tiles (the caller's
// `pick_tile`, th*tw = nq in {8, .., 128}, dividing h and w exactly). For one
// tile and head, with the (th+4) x (tw+4) key halo (nk keys):
//   S = (Q * scale) K^T  [nq, nk], S_ij = -1e30 where key j is outside the
//   image or outside query i's 5x5 window; m_i = max_j S_ij;
//   l_i = sum_j exp(S_ij - m_i); out = (exp(S - m) V) / l
// a plain two-pass softmax over the dense masked row, not an online one:
// every key of a query lies in its tile's halo. With stats it writes m, l
// [B, h, w, 8]. The backward takes (q, k, v, m, l, dout), no output:
//   A = exp(S - m) / l      W = dO V^T  [nq, nk]      D_i = sum_j A_ij W_ij
//   dS = A (W - D)          dQ = scale dS K
//   dK_j = sum_i dS_ij (q_i * scale)     dV_j = sum_i A_ij dO_i
// The q/k/v/out projections stay outside (torch.matmul).
//
// The TPU kernel takes a whole view per grid step, loops over its tiles and
// heads, multiplies on the matrix unit with a precomputed additive mask, and
// adds each tile's halo-shaped dK, dV into padded accumulators, which is
// exact only because its grid runs in order. Here a block is one (view,
// tile, head), as the per-head window step of the fused block is: it stages
// the head's halo and tile rows once, and its warps each take four rows of
// the dense [nq, nk] matrix at a time. Lanes stride over the nk columns for
// the products that make a row of S (or A and W), which go to a per-warp
// buffer in shared memory; after the row reductions (max and sum, or D)
// eight lanes a row stride over the columns again for the second product
// (exp(S - m) V, or dS K) and fold their partial rows with shuffles. The
// mask is computed from the tile geometry, -1e30 as in the TPU kernel, so a
// masked column contributes exp(-1e30 - m) = 0 exactly. Products run on the
// FP32 pipes: TF32 on the tensor cores would miss the f32 bound.
//
// The backward has no atomics and is two kernels launched back to back. The
// first is the forward's shape with query rows: A and W, D (also written out,
// [B, h, w, 8]), dQ. The second is the transposed problem: the tile's own
// pixels are the KEYS, the halo holds the queries whose window can reach
// them (q, dO, m, l, D staged), dS^T and A^T rows go through the per-warp
// buffer, and dK, dV come out as sums over the halo, each element written by
// one thread. What the TPU adds over the tiles that share a key is here one
// gather inside the key's own tile. Scores are rebuilt with the forward's
// arithmetic (q scaled first, one fmaf chain).
//
// Bound on this card: the bytes of the function (4 tensors forward, 0.25 ms
// at [400, 32, 32, 128]); the dense products do nk / 25 ~ 10 times the
// window's work (50 GFLOP forward at that shape, 0.75 ms at 67 TFLOP/s), so
// the kernel itself is bound by the FP32 pipes and shared-memory reads.

#include "attn.cuh"

using namespace lft;

namespace {

constexpr int H = 8;
constexpr int RQ = 4;    // rows of the dense matrix a warp takes at a time
constexpr int MAX_SMEM = 232448;

struct Geo {
  int h, w, th, tw;      // view and query tile
  int hlw, nq, nk, nkp;  // halo width, rows, columns, padded row of the warp buffer
};

// row stride of the per-warp buffer: = 8 (mod 32), so the four rows that the
// second product reads at once fall in distinct banks
inline int padded(int nk) { return (nk + 31) / 32 * 32 + 8; }

// a[r] without a dynamically indexed register array
template <class T>
__device__ __forceinline__ T pick(const T (&a)[RQ], int r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

// Folds the eight lanes of a row (lane & 7) together.
template <int DH>
__device__ __forceinline__ void fold8(float (&a)[DH]) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int d = 0; d < DH; ++d) a[d] += __shfl_xor_sync(0xffffffffu, a[d], o);
}

// One head's rows of the halo (top-left corner (y0 - R, x0 - R), zero outside
// the image) -> a [nk][DH + 4] tile, times `mul`.
template <int DH>
__device__ __forceinline__ void stage_halo(float* dst, const float* __restrict__ img, int E,
                                           int y0, int x0, const Geo& g, float mul) {
  for (int i = threadIdx.x; i < g.nk * (DH / 4); i += blockDim.x) {
    const int pos = i / (DH / 4), d = 4 * (i % (DH / 4));
    const int y = y0 - R + pos / g.hlw, x = x0 - R + pos % g.hlw;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
      val = ldg4(img + (static_cast<size_t>(y) * g.w + x) * E + d);
      val = make_float4(val.x * mul, val.y * mul, val.z * mul, val.w * mul);
    }
    store4(dst + pos * (DH + 4) + d, val);
  }
}

// One head's rows of the tile itself -> a [nq][DH + 4] tile, times `mul`.
template <int DH>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ img, int E,
                                           int y0, int x0, const Geo& g, float mul) {
  for (int i = threadIdx.x; i < g.nq * (DH / 4); i += blockDim.x) {
    const int row = i / (DH / 4), d = 4 * (i % (DH / 4));
    const int y = y0 + row / g.tw, x = x0 + row % g.tw;
    float4 val = ldg4(img + (static_cast<size_t>(y) * g.w + x) * E + d);
    store4(dst + row * (DH + 4) + d,
           make_float4(val.x * mul, val.y * mul, val.z * mul, val.w * mul));
  }
}

// Block -> (tile origin, head, first pixel of the view).
struct Where {
  int y0, x0, head;
  size_t view;
  __device__ __forceinline__ explicit Where(const Geo& g) {
    const int ntw = g.w / g.tw;
    y0 = (blockIdx.x / ntw) * g.th;
    x0 = (blockIdx.x % ntw) * g.tw;
    head = blockIdx.y;
    view = static_cast<size_t>(blockIdx.z) * g.h * g.w;
  }
};

// ---- forward ---------------------------------------------------------------
template <int DH, bool STATS>
__global__ void __launch_bounds__(NT)
    spa_attn_mxu_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out, Geo g,
                        float scale) {
  constexpr int E = H * DH, LD = DH + 4;
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);   // [nk][LD]
  float* VT = KT + g.nk * LD;
  float* QT = VT + g.nk * LD;                    // [nq][LD], scaled
  float* SB = QT + g.nq * LD;                    // [warps][RQ][nkp]
  const Where at(g);
  const size_t base = at.view * E + at.head * DH;
  stage_halo<DH>(KT, k + base, E, at.y0, at.x0, g, 1.f);
  stage_halo<DH>(VT, v + base, E, at.y0, at.x0, g, 1.f);
  stage_tile<DH>(QT, q + base, E, at.y0, at.x0, g, scale);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float* S = SB + warp * RQ * g.nkp;
  for (int r0 = warp * RQ; r0 < g.nq; r0 += nw * RQ) {
    float qr[RQ][DH], mx[RQ], sum[RQ];
    int ly[RQ], lx[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      ld<DH>(QT + (r0 + r) * LD, qr[r]);
      ly[r] = (r0 + r) / g.tw;
      lx[r] = (r0 + r) % g.tw;
      mx[r] = -1e30f;
      sum[r] = 0.f;
    }
    // S = Q K^T with the mask, and the row maxima
    for (int j = lane; j < g.nk; j += 32) {
      const int ky = j / g.hlw - R, kx = j % g.hlw - R;      // relative to the tile
      const bool in_img = at.y0 + ky >= 0 && at.y0 + ky < g.h && at.x0 + kx >= 0
                          && at.x0 + kx < g.w;
      float kr[DH];
      ld<DH>(KT + j * LD, kr);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const bool ok = in_img && abs(ky - ly[r]) <= R && abs(kx - lx[r]) <= R;
        const float s = ok ? dot<DH>(qr[r], kr) : -1e30f;
        S[r * g.nkp + j] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) mx[r] = warp_max(mx[r]);
    // exp(S - m) in place, and the row sums
    for (int j = lane; j < g.nk; j += 32) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float e = expf(S[r * g.nkp + j] - mx[r]);
        S[r * g.nkp + j] = e;
        sum[r] += e;
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) sum[r] = warp_sum(sum[r]);
    __syncwarp();
    // out = (exp(S - m) V) / l: eight lanes a row
    const int r = lane >> 3, sub = lane & 7;
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = sub; j < g.nk; j += 8) {
      const float e = S[r * g.nkp + j];
      float vr[DH];
      ld<DH>(VT + j * LD, vr);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(e, vr[d], acc[d]);
    }
    fold8<DH>(acc);
    const size_t pixel = at.view + static_cast<size_t>(at.y0 + pick(ly, r)) * g.w + at.x0
                         + pick(lx, r);
    if (sub == 0) {
      const float inv = 1.f / pick(sum, r);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= inv;
      st<DH>(out + pixel * E + at.head * DH, acc);
      if constexpr (STATS) {
        m_out[pixel * H + at.head] = pick(mx, r);
        l_out[pixel * H + at.head] = pick(sum, r);
      }
    }
    __syncwarp();                                // S is rewritten by the next rows
  }
}

// ---- backward, first kernel: the tile's queries, D and dQ ------------------
template <int DH>
__global__ void __launch_bounds__(NT)
    spa_attn_mxu_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ m_in, const float* __restrict__ l_in,
                              float* __restrict__ d_out, float* __restrict__ dq_out, Geo g,
                              float scale) {
  constexpr int E = H * DH, LD = DH + 4;
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);   // [nk][LD]
  float* VT = KT + g.nk * LD;
  float* QT = VT + g.nk * LD;                    // [nq][LD], scaled
  float* GT = QT + g.nq * LD;                    // dout
  float* SB = GT + g.nq * LD;                    // [warps][2][RQ][nkp]: A, W
  const Where at(g);
  const size_t base = at.view * E + at.head * DH;
  stage_halo<DH>(KT, k + base, E, at.y0, at.x0, g, 1.f);
  stage_halo<DH>(VT, v + base, E, at.y0, at.x0, g, 1.f);
  stage_tile<DH>(QT, q + base, E, at.y0, at.x0, g, scale);
  stage_tile<DH>(GT, dout + base, E, at.y0, at.x0, g, 1.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float* A = SB + warp * 2 * RQ * g.nkp;
  float* W = A + RQ * g.nkp;
  for (int r0 = warp * RQ; r0 < g.nq; r0 += nw * RQ) {
    float mr[RQ], inv[RQ], dsum[RQ];
    int ly[RQ], lx[RQ];
    size_t pixel[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      ly[r] = (r0 + r) / g.tw;
      lx[r] = (r0 + r) % g.tw;
      pixel[r] = at.view + static_cast<size_t>(at.y0 + ly[r]) * g.w + at.x0 + lx[r];
      mr[r] = __ldg(m_in + pixel[r] * H + at.head);
      inv[r] = 1.f / __ldg(l_in + pixel[r] * H + at.head);
      dsum[r] = 0.f;
    }
    // A = exp(S - m) / l, W = dO V^T, D = rowsum(A W)
    for (int j = lane; j < g.nk; j += 32) {
      const int ky = j / g.hlw - R, kx = j % g.hlw - R;
      const bool in_img = at.y0 + ky >= 0 && at.y0 + ky < g.h && at.x0 + kx >= 0
                          && at.x0 + kx < g.w;
      float kr[DH], vr[DH];
      ld<DH>(KT + j * LD, kr);
      ld<DH>(VT + j * LD, vr);
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        float qr[DH], gr[DH];
        ld<DH>(QT + (r0 + r) * LD, qr);
        ld<DH>(GT + (r0 + r) * LD, gr);
        const bool ok = in_img && abs(ky - ly[r]) <= R && abs(kx - lx[r]) <= R;
        const float a = ok ? expf(dot<DH>(qr, kr) - mr[r]) * inv[r] : 0.f;
        const float wv = dot<DH>(gr, vr);
        A[r * g.nkp + j] = a;
        W[r * g.nkp + j] = wv;
        dsum[r] = fmaf(a, wv, dsum[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) dsum[r] = warp_sum(dsum[r]);
    __syncwarp();
    // dQ = scale (A (W - D)) K: eight lanes a row
    const int r = lane >> 3, sub = lane & 7;
    const float d_r = pick(dsum, r);
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = sub; j < g.nk; j += 8) {
      const float ds = A[r * g.nkp + j] * (W[r * g.nkp + j] - d_r);
      float kr[DH];
      ld<DH>(KT + j * LD, kr);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
    fold8<DH>(acc);
    if (sub == 0) {
      const size_t px = pick(pixel, r);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= scale;
      st<DH>(dq_out + px * E + at.head * DH, acc);
      d_out[px * H + at.head] = d_r;
    }
    __syncwarp();
  }
}

// ---- backward, second kernel: the tile's pixels as keys, dK and dV ---------
template <int DH>
__global__ void __launch_bounds__(NT)
    spa_attn_mxu_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ m_in, const float* __restrict__ l_in,
                               const float* __restrict__ d_in, float* __restrict__ dk_out,
                               float* __restrict__ dv_out, Geo g, float scale) {
  constexpr int E = H * DH, LD = DH + 4;
  extern __shared__ float4 smem4[];
  float* QH = reinterpret_cast<float*>(smem4);   // [nk][LD]: the halo's queries, scaled
  float* GH = QH + g.nk * LD;                    // their dout
  float* KT = GH + g.nk * LD;                    // [nq][LD]: the tile's keys
  float* VT = KT + g.nq * LD;
  float* MH = VT + g.nq * LD;                    // [nk] each: m, 1 / l, D of the halo's queries
  float* LH = MH + g.nkp;
  float* DS = LH + g.nkp;
  float* SB = DS + g.nkp;                        // [warps][2][RQ][nkp]: A^T, dS^T
  const Where at(g);
  const size_t base = at.view * E + at.head * DH;
  stage_halo<DH>(QH, q + base, E, at.y0, at.x0, g, scale);
  stage_halo<DH>(GH, dout + base, E, at.y0, at.x0, g, 1.f);
  stage_tile<DH>(KT, k + base, E, at.y0, at.x0, g, 1.f);
  stage_tile<DH>(VT, v + base, E, at.y0, at.x0, g, 1.f);
  for (int i = threadIdx.x; i < g.nk; i += blockDim.x) {
    const int y = at.y0 - R + i / g.hlw, x = at.x0 - R + i % g.hlw;
    float mv = 0.f, li = 0.f, dv = 0.f;
    if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
      const size_t s = (at.view + static_cast<size_t>(y) * g.w + x) * H + at.head;
      mv = __ldg(m_in + s);
      li = 1.f / __ldg(l_in + s);
      dv = __ldg(d_in + s);
    }
    MH[i] = mv;
    LH[i] = li;
    DS[i] = dv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float* A = SB + warp * 2 * RQ * g.nkp;
  float* DSB = A + RQ * g.nkp;
  for (int r0 = warp * RQ; r0 < g.nq; r0 += nw * RQ) {
    int ly[RQ], lx[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      ly[r] = (r0 + r) / g.tw;
      lx[r] = (r0 + r) % g.tw;
    }
    // A^T and dS^T: the halo's queries i against the tile's keys r
    for (int i = lane; i < g.nk; i += 32) {
      const int qy = i / g.hlw - R, qx = i % g.hlw - R;
      const bool in_img = at.y0 + qy >= 0 && at.y0 + qy < g.h && at.x0 + qx >= 0
                          && at.x0 + qx < g.w;
      float qo[DH], go[DH];
      ld<DH>(QH + i * LD, qo);
      ld<DH>(GH + i * LD, go);
      const float mi = MH[i], li = LH[i], di = DS[i];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        float kr[DH], vr[DH];
        ld<DH>(KT + (r0 + r) * LD, kr);
        ld<DH>(VT + (r0 + r) * LD, vr);
        const bool ok = in_img && abs(qy - ly[r]) <= R && abs(qx - lx[r]) <= R;
        const float a = ok ? expf(dot<DH>(qo, kr) - mi) * li : 0.f;
        A[r * g.nkp + i] = a;
        DSB[r * g.nkp + i] = a * (dot<DH>(go, vr) - di);
      }
    }
    __syncwarp();
    // dK = dS^T (Q * scale), dV = A^T dO: eight lanes a key
    const int r = lane >> 3, sub = lane & 7;
    float dk[DH], dv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dk[d] = dv[d] = 0.f;
    for (int i = sub; i < g.nk; i += 8) {
      const float ds = DSB[r * g.nkp + i], a = A[r * g.nkp + i];
      float qo[DH], go[DH];
      ld<DH>(QH + i * LD, qo);
      ld<DH>(GH + i * LD, go);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dk[d] = fmaf(ds, qo[d], dk[d]);
        dv[d] = fmaf(a, go[d], dv[d]);
      }
    }
    fold8<DH>(dk);
    fold8<DH>(dv);
    if (sub == 0) {
      const size_t off = (at.view + static_cast<size_t>(at.y0 + pick(ly, r)) * g.w + at.x0
                          + pick(lx, r)) * E + at.head * DH;
      st<DH>(dk_out + off, dk);
      st<DH>(dv_out + off, dv);
    }
    __syncwarp();
  }
}

// The view's geometry, or false for a shape the kernels do not take.
inline bool geometry(int B, int h, int w, int th, int tw, int heads, Geo& g) {
  if (heads != H || B < 1 || B > 65535 || th < 1 || tw < 1 || h < 1 || w < 1 || h % th || w % tw
      || (th * tw) % RQ || th * tw > 128)
    return false;
  g = Geo{h, w, th, tw, tw + 2 * R, th * tw, (th + 2 * R) * (tw + 2 * R),
          padded((th + 2 * R) * (tw + 2 * R))};
  return true;
}

// Warps of a block: one per four rows, at most 8, fewer while the block's
// shared memory (`fixed` floats and `per_warp` floats a warp) does not fit.
// Returns 0 if one warp does not fit.
inline int pick_warps(const Geo& g, size_t fixed, size_t per_warp, size_t& bytes) {
  int nw = 8;
  while (nw > 1 && nw * RQ > g.nq) nw /= 2;
  for (; nw >= 1; nw /= 2) {
    bytes = (fixed + nw * per_warp) * sizeof(float);
    if (bytes <= MAX_SMEM) return nw;
  }
  return 0;
}

template <bool STATS>
int spa_attn_mxu(const float* q, const float* k, const float* v, float* out, float* m, float* l,
                 int B, int h, int w, int E, int heads, int th, int tw, float scale,
                 cudaStream_t s) {
  Geo g;
  if (!geometry(B, h, w, th, tw, heads, g)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((h / th) * (w / tw), H, B);
  switch (E / H) {
#define LFT_MXU_CASE(DHV)                                                               \
    case DHV: {                                                                         \
      size_t bytes;                                                                     \
      const int nw = pick_warps(g, (2 * g.nk + g.nq) * (DHV + 4), RQ * g.nkp, bytes);   \
      if (!nw) return static_cast<int>(cudaErrorInvalidValue);                          \
      auto kernel = spa_attn_mxu_kernel<DHV, STATS>;                                    \
      LFT_SET_SMEM(kernel, bytes);                                                      \
      kernel<<<grid, 32 * nw, bytes, s>>>(q, k, v, out, m, l, g, scale);                \
      break;                                                                            \
    }
    LFT_MXU_CASE(4)
    LFT_MXU_CASE(8)
    LFT_MXU_CASE(16)
#undef LFT_MXU_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFT_EXPORT_ERROR_STRING

// q, k, v, out [B, h, w, E], E = 8 heads x {4, 8, 16}; (th, tw) a query tile
// dividing (h, w) with th * tw a multiple of 4, at most 128. Each returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int lft_spa_attn_mxu(const float* q, const float* k, const float* v, float* out,
                                int B, int h, int w, int E, int heads, int th, int tw,
                                float scale, void* stream) {
  return spa_attn_mxu<false>(q, k, v, out, nullptr, nullptr, B, h, w, E, heads, th, tw, scale,
                             static_cast<cudaStream_t>(stream));
}

// The same, also writing m, l [B, h, w, 8] (the residuals of the backward).
extern "C" int lft_spa_attn_mxu_res(const float* q, const float* k, const float* v, float* out,
                                    float* m, float* l, int B, int h, int w, int E, int heads,
                                    int th, int tw, float scale, void* stream) {
  return spa_attn_mxu<true>(q, k, v, out, m, l, B, h, w, E, heads, th, tw, scale,
                            static_cast<cudaStream_t>(stream));
}

// dsum [B, h, w, 8] is scratch the caller allocates: the first kernel writes
// D there and the second reads it.
extern "C" int lft_spa_attn_mxu_bwd(const float* q, const float* k, const float* v,
                                    const float* dout, const float* m, const float* l,
                                    float* dsum, float* dq, float* dk, float* dv, int B, int h,
                                    int w, int E, int heads, int th, int tw, float scale,
                                    void* stream) {
  Geo g;
  if (!geometry(B, h, w, th, tw, heads, g)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((h / th) * (w / tw), H, B);
  switch (E / H) {
#define LFT_MXU_CASE(DHV)                                                               \
    case DHV: {                                                                         \
      size_t bytes_q, bytes_kv;                                                         \
      const size_t tiles = 2 * static_cast<size_t>(g.nk + g.nq) * (DHV + 4);            \
      const int nw_q = pick_warps(g, tiles, 2 * RQ * g.nkp, bytes_q);                   \
      const int nw_kv = pick_warps(g, tiles + 3 * g.nkp, 2 * RQ * g.nkp, bytes_kv);     \
      if (!nw_q || !nw_kv) return static_cast<int>(cudaErrorInvalidValue);              \
      auto kq = spa_attn_mxu_bwd_q_kernel<DHV>;                                         \
      auto kkv = spa_attn_mxu_bwd_kv_kernel<DHV>;                                       \
      LFT_SET_SMEM(kq, bytes_q);                                                        \
      LFT_SET_SMEM(kkv, bytes_kv);                                                      \
      kq<<<grid, 32 * nw_q, bytes_q, s>>>(q, k, v, dout, m, l, dsum, dq, g, scale);     \
      kkv<<<grid, 32 * nw_kv, bytes_kv, s>>>(q, k, v, dout, m, l, dsum, dk, dv, g, scale); \
      break;                                                                            \
    }
    LFT_MXU_CASE(4)
    LFT_MXU_CASE(8)
    LFT_MXU_CASE(16)
#undef LFT_MXU_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
