"""What bounds `wgrad_bf16io` on the card: this checkout's `csrc/wgrad.cu`
timed beside variants of it, each one edit away, in turns in one process;
and the cluster sizes its slices could take.

    python3 -m lft_torch.probe_wgrad

The variants of the taps = 1 kernel `wgrad_bf16io_kernel` (built with the
port's nvcc flags into a temporary directory; an edit whose anchor is gone
from the source raises):

* `no_loads`: no copy of X or dY (the products run on whatever the ring
  holds: the compute, the ring's barriers, the partials and the column
  sum alone);
* `no_compute`: the staging alone (and the partials, the column sum);
* `x_only` / `dy_only`: the staging of one operand alone;
* `one_chain`: the MMAs add straight into the tile's sums, no chain
  accumulators flushed on the FP32 pipes (the cost of the flushes).

At the fused bf16 step's products dw1 [102400, 128]ᵀ[102400, 256], dwq
[102400, 128]ᵀ[102400, 128], K4's [102400, 64]ᵀ[102400, 64] (bf16 dY) and
K3's dwo (f32 dY), each variant at `wgrad.bf16io_cut`'s slices is timed in
device time (`profile_scene.device_ms`) in the order as is, variants,
variants reversed, as is, and with L2 flushed before each call
(`profile_scene.cold_ms`). Then, for each kernel (the 128 x 128 and 64 x 64
tiles and the taps kernel, bf16 and f32 dY), the clusters of Z = 1, 2, 4, 8
blocks the card holds at once (`cudaOccupancyMaxActiveClusters`), and dw1
and K4's product timed at the slice counts that Z allows. Beside them, the
card's read and copy rates on a 78.6 MB bf16 tensor (`sum`, `clone`).
Prints the card's name and power limit first. Exits non-zero without a
card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

_NO_COMPUTE = ("    if (active) {\n      const bf16* xs = xs_of(stage) + wm;",
               "    if (active && nslab < 0) {\n      const bf16* xs = xs_of(stage) + wm;")
_X_COPY = ("      cp_async16v(xs + r * LDX + c, ok ? x + static_cast<size_t>(t) * K + k0 + c : x, "
           "ok);\n", "\n")
_Y_COPY = ("      cp_async16v(ys + r * LDY + c, ok ? dy + static_cast<size_t>(t) * N + n0 + c : dy, "
           "ok);\n    }\n  };\n\n  float acc[4][4][4] = {};",
           "    }\n  };\n\n  float acc[4][4][4] = {};")

# name -> [(anchor, replacement), ...] on wgrad.cu
VARIANTS = {
    "no_loads": [_X_COPY, _Y_COPY],
    "no_compute": [_NO_COMPUTE],
    "x_only": [_NO_COMPUTE, _Y_COPY],
    "dy_only": [_NO_COMPUTE, _X_COPY],
    "one_chain": [("      for (int j = 0; j < 4; ++j) mma_bf16(sum[i][j], a, b[j][0], b[j][1]);",
                   "      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);")],
}

# appended to the source as it is: the clusters the card holds at once
_CLUSTERS = r"""
namespace {
template <class Kern>
int probe_clusters(Kern kernel, int nth, int smem, int Z) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, 8 * Z);
  cfg.blockDim = dim3(nth, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = Z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -2;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg)) return -3;
  return n;
}
}  // namespace

// kind 0: the 128 x 128 tile, 1: 64 x 64, 2: the taps kernel; f32dy: dY f32
extern "C" int probe_bio_clusters(int kind, int f32dy, int Z) {
  if (kind == 0)
    return f32dy ? probe_clusters(wgrad_bf16io_kernel<2, 4, float>, 256,
                                  BioTile<2, 4, float>::SMEM, Z)
                 : probe_clusters(wgrad_bf16io_kernel<2, 4, bf16>, 256,
                                  BioTile<2, 4, bf16>::SMEM, Z);
  if (kind == 1)
    return f32dy ? probe_clusters(wgrad_bf16io_kernel<1, 2, float>, 64,
                                  BioTile<1, 2, float>::SMEM, Z)
                 : probe_clusters(wgrad_bf16io_kernel<1, 2, bf16>, 64,
                                  BioTile<1, 2, bf16>::SMEM, Z);
  return f32dy ? probe_clusters(wgrad_bf16io_taps_kernel<float>, TAP_NTH,
                                BioTaps<float>::SMEM, Z)
               : probe_clusters(wgrad_bf16io_taps_kernel<bf16>, TAP_NTH, BioTaps<bf16>::SMEM, Z);
}
"""


def _build(name: str, src: str, tmp: str) -> ctypes.CDLL:
    from lft_torch.kernels import _build as b
    path = os.path.join(tmp, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-I", b.SRC_DIR, "-o", so, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    for f in (lib.lft_wgrad_bf16io, lib.lft_wgrad_bf16io_f32dy):
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_wgrad: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build as b
    from lft_torch.kernels import wgrad as wg
    from lft_torch.profile_scene import cold_ms, device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    with open(os.path.join(b.SRC_DIR, "wgrad.cu")) as f:
        src = f.read()
    sources = {"as_is": src + _CLUSTERS}
    for name, edits in VARIANTS.items():
        s = src
        for anchor, new in edits:
            if anchor not in s:
                raise AssertionError(f"probe_wgrad: the anchor of {name} is gone from wgrad.cu")
            s = s.replace(anchor, new)
        sources[name] = s
    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    T = 102400
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as ex:
            libs = dict(zip(sources, ex.map(lambda kv: _build(kv[0], kv[1], tmp),
                                             sources.items())))
        big = torch.randn(T * 384, device=dev, generator=g).bfloat16()
        print(f"card: sum of a {big.numel() * 2 / 1e6:.1f} MB bf16 tensor "
              f"{device_ms(lambda: big.sum()):.4f} ms, its clone "
              f"{device_ms(lambda: big.clone()):.4f} ms", flush=True)
        del big

        def call(lib, x, dy, out, S, Z):
            K, N = x.shape[1], dy.shape[1]
            groups = S // Z
            part = torch.empty(groups, K, N, device=dev)
            f = lib.lft_wgrad_bf16io if dy.dtype == torch.bfloat16 else lib.lft_wgrad_bf16io_f32dy
            args = (x.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), T, K, N, S, Z,
                    *wg.colsum_cut(groups, K * N), 0, 0)
            # `part` rides along so that its memory lives as long as the call
            return lambda part=part: f(*args, torch.cuda.current_stream().cuda_stream)

        shapes = (("dw1", 128, 256, torch.bfloat16), ("dwq", 128, 128, torch.bfloat16),
                  ("K4 64x64", 64, 64, torch.bfloat16), ("dwo, f32 dY", 128, 128, torch.float32))
        for what, K, N, dt in shapes:
            x = torch.randn(T, K, device=dev, generator=g).bfloat16()
            dy = torch.randn(T, N, device=dev, generator=g).to(dt)
            S, Z = wg.bf16io_cut(T, K, N)
            ref = wg.wgrad_plain(x, dy)
            fns, errs = {}, {}
            for name, lib in libs.items():
                out = torch.empty(K, N, device=dev)
                fns[name] = call(lib, x, dy, out, S, Z)
                if fns[name]():
                    raise RuntimeError(f"probe_wgrad: {name} failed to launch at {what}")
                torch.cuda.synchronize()
                errs[name] = float((out - ref).abs().max()) / float(ref.abs().max())
            order = list(fns) + list(fns)[::-1]
            warm = {n: [] for n in fns}
            for n in order:
                warm[n].append(device_ms(fns[n]))
            rows = "; ".join(f"{n} {w[0]:.4f} / {w[1]:.4f} ms, L2 flushed {cold_ms(fns[n]):.4f} ms"
                             f" (rel. err {errs[n]:.1e})" for n, w in warm.items())
            print(f"{what} [{T}, {K}]ᵀ[{T}, {N}] {str(dt)[6:]} dY, S = {S}, Z = {Z}: {rows}",
                  flush=True)
        lib = libs["as_is"]
        lib.probe_bio_clusters.argtypes = [ctypes.c_int] * 3
        for kind, tile in enumerate(("128 x 128 tile", "64 x 64 tile", "taps")):
            for f32 in (0, 1):
                print(f"clusters the card holds at once, {tile}, {'f32' if f32 else 'bf16'} dY: "
                      + ", ".join(f"Z = {z}: {lib.probe_bio_clusters(kind, f32, z)}"
                                  for z in (1, 2, 4, 8)), flush=True)
        for what, K, N in (("dw1", 128, 256), ("K4 64x64", 64, 64)):
            x = torch.randn(T, K, device=dev, generator=g).bfloat16()
            dy = torch.randn(T, N, device=dev, generator=g).bfloat16()
            S0 = wg.splits(T, K, N)
            out = torch.empty(K, N, device=dev)
            res = []
            for Z in (1, 2, 4, 8):
                for S in sorted({S0 // Z * Z, int(0.9 * S0) // Z * Z}):
                    fn = call(lib, x, dy, out, S, Z)
                    if fn():
                        raise RuntimeError(f"probe_wgrad: S = {S}, Z = {Z} failed to launch")
                    res.append(f"S = {S}, Z = {Z}: {device_ms(fn):.4f} ms, L2 flushed "
                               f"{cold_ms(fn):.4f} ms")
            print(f"{what} by slices and cluster size: " + "; ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
