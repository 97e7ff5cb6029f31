"""Time this checkout's `wgrad` and `colsum` against another revision's
`csrc/wgrad.cu`, in turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_wgrad OTHER_WGRAD_CU

OTHER_WGRAD_CU is a `wgrad.cu` with the C interface the port had before its
3xTF32 kernels (`lft_wgrad(x, dy, part, out, T, K, N, S, h, w, stream)` with
S partials of 64 x 64 tiles, about two blocks an SM; `lft_colsum(a, out, R,
N, stream)`), e.g. `git show <commit>:lft_torch/csrc/wgrad.cu`. It is built
with the port's nvcc flags into a temporary directory. At every product of
the fused 5x5 train step (batch 4, C = 64, T = 102,400; `STEP_PRODUCTS`) and
every column sum (`STEP_SUMS`), the two are checked against each other and
timed in device time (`profile_scene.device_ms`) in the order other, this,
this, other, beside one PyTorch call for the same function; then the sums
over a step's launches. Prints the card's name and power limit first. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile

import torch

# the products of a fused 5x5 train step: (what, K, N, image, launches a step)
STEP_PRODUCTS = (("K3 dw1 = xn2ᵀ dpre", 128, 256, None, 4),
                 ("K3 dwu (9 taps)", 64, 128, (32, 32), 4),
                 ("K3 dwq, dwk, dwv, dwo", 128, 128, None, 16),
                 ("K3 dw2", 256, 128, None, 4),
                 ("K3 dwlin", 128, 64, None, 4),
                 ("K4 dwq, dwk, dwv, dwo", 64, 64, None, 16),
                 ("K4 dw1", 64, 128, None, 4),
                 ("K4 dw2", 128, 64, None, 4))
# its column sums: (what, R, N, launches a step)
STEP_SUMS = (("K3 dpe_tok", 100, 32 * 32 * 128, 4),
             ("K3 LayerNorm partial sums", 1600, 256, 8),
             ("K4 LayerNorm partial sums", 2048, 256, 4))
STEP_TOKENS = 100 * 32 * 32


def _load_other(src: str, build_dir: str):
    from lft_torch.kernels import _build
    lib = _build.build_library(src, build_dir, "other_wgrad")
    lib.lft_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.lft_colsum.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def wgrad(x, dy, image=None):
        (T, K), N = x.shape, dy.shape[1]
        taps, (h, w) = (1, (0, 0)) if image is None else (9, image)
        S = max(1, min(-(-T // 256), -(-264 // (taps * -(-K // 64) * -(-N // 64)))))
        part = torch.empty(S, taps, K, N, device=x.device)
        out = torch.empty(taps, K, N, device=x.device)
        if lib.lft_wgrad(x.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), T, K, N,
                         S, h, w, stream()):
            raise RuntimeError("the other wgrad failed to launch")
        return out[0] if image is None else out

    def colsum(a):
        out = torch.empty(a.shape[1], device=a.device)
        if lib.lft_colsum(a.data_ptr(), out.data_ptr(), *a.shape, stream()):
            raise RuntimeError("the other colsum failed to launch")
        return out

    return wgrad, colsum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="path of the other revision's wgrad.cu")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_wgrad: no CUDA device is available", file=sys.stderr)
        return 1
    from lft_torch.device import resolve_device
    from lft_torch.kernels import wgrad as wg
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g)
    with tempfile.TemporaryDirectory() as tmp:
        o_wgrad, o_colsum = _load_other(a.other, tmp)
        cases = [(f"wgrad {what} [{STEP_TOKENS}, {K}]ᵀ[{STEP_TOKENS}, {N}]"
                  f"{'' if im is None else f' taps of {im}'}", per, (rand(STEP_TOKENS, K),
                  rand(STEP_TOKENS, N), im)) for what, K, N, im, per in STEP_PRODUCTS]
        cases += [(f"colsum {what} [{R}, {N}]", per, (rand(R, N),))
                  for what, R, N, per in STEP_SUMS]
        total = {}
        for what, per, args in cases:
            if what.startswith("wgrad"):
                other, this = (lambda f=f: f(*args) for f in (o_wgrad, wg.wgrad))
                x, dy, im = args
                lib = (lambda: x.t() @ dy) if im is None else (lambda: wg.wgrad_plain(x, dy, im))
            else:
                other, this = (lambda f=f: f(*args) for f in (o_colsum, wg.colsum))
                lib = lambda: args[0].sum(0)
            ref = lib()
            for f in (other, this):
                if not float((f() - ref).abs().max()) <= 1e-4 * float(ref.abs().max()):
                    raise AssertionError(f"{what}: the two builds disagree with the library")
            t = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            t_lib = device_ms(lib)
            key = what.split()[0]
            o, c, l_ = total.get(key, (0.0, 0.0, 0.0))
            total[key] = (o + per * (t[0] + t[3]) / 2, c + per * (t[1] + t[2]) / 2,
                          l_ + per * t_lib)
            print(f"{what}: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms, "
                  f"one PyTorch call {t_lib:.4f} ms; {per} a step", flush=True)
    for key, (o, c, l_) in total.items():
        print(f"{key} over a fused step's launches: other {o:.4f} ms, this {c:.4f} ms, "
              f"one PyTorch call each {l_:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
