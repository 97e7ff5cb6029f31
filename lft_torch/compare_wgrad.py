"""Time this checkout's `wgrad`, `wgrad_bf16io` and `colsum` against another
revision's `csrc/wgrad.cu`, in turns in one process, on one CUDA card.

    python3 -m lft_torch.compare_wgrad OTHER_WGRAD_CU [--only-bf16io]

OTHER_WGRAD_CU is a `wgrad.cu` with the C interface the port had from its
3xTF32 kernels until the bf16-IO kernels took their own slices (commit
4761636): `lft_wgrad(x, dy, part, out, T, K, N, S, lanes, size, h, w,
stream)`, `lft_wgrad_bf16io` / `lft_wgrad_bf16io_f32dy` with the same
arguments (S slices of `wgrad.splits`, their partials added by the column
sum, `colsum_cut`) and `lft_colsum(a, out, R, N, lanes, size, stream)`, e.g.
`git show <commit>:lft_torch/csrc/wgrad.cu` written into a git-ignored
directory beside that revision's headers (`git archive <commit>
lft_torch/csrc`). It is built with the port's nvcc flags into a temporary
directory. At every product of the fused 5x5 train step (batch 4, C = 64,
T = 102,400; `STEP_PRODUCTS`) and every column sum (`STEP_SUMS`) in f32,
and at every product in bf16 (bf16 x and dy; K3's dwo also on an f32 dy),
the two builds are checked against one PyTorch call for the same function
(1e-4 of its largest output) and timed in device time
(`profile_scene.device_ms`) in the order other, this, this, other, beside
that call and the bound (each input read once and the output written once
at 3.35 TB/s, or the products at 989 TFLOP/s in bf16); each bf16 product
also with L2 flushed before every call (`profile_scene.cold_ms`). Then the
sums over a step's launches. `--only-bf16io`: the bf16 products alone.
Prints the card's name and power limit first. Exits non-zero without a
card.
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
BW, BF16_RATE = 3.35e12, 989e12     # an H100 SXM's device memory and bf16 tensor-core peaks


def _load_other(src: str, build_dir: str):
    """(wgrad, colsum) of the other revision, with this checkout's wrappers'
    arguments: wgrad(x, dy, image) takes f32 x and dy, or a bf16 x and a
    bf16 or f32 dy (its bf16-IO entries)."""
    from lft_torch.kernels import _build
    from lft_torch.kernels import wgrad as wg
    lib = _build.build_library(src, build_dir, "other_wgrad")
    for f in (lib.lft_wgrad, lib.lft_wgrad_bf16io, lib.lft_wgrad_bf16io_f32dy):
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.lft_colsum.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def wgrad(x, dy, image=None):
        (T, K), N = x.shape, dy.shape[1]
        taps, (h, w) = (1, (0, 0)) if image is None else (9, image)
        S = wg.splits(T, K, N, taps)
        part = torch.empty(S, taps, K, N, device=x.device)
        out = torch.empty(taps, K, N, device=x.device)
        fn = lib.lft_wgrad if x.dtype == torch.float32 else \
            lib.lft_wgrad_bf16io if dy.dtype == torch.bfloat16 else lib.lft_wgrad_bf16io_f32dy
        if fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), T, K, N, S,
              *wg.colsum_cut(S, taps * K * N), h, w, stream()):
            raise RuntimeError("the other wgrad failed to launch")
        return out[0] if image is None else out

    def colsum(a):
        out = torch.empty(a.shape[1], device=a.device)
        if lib.lft_colsum(a.data_ptr(), out.data_ptr(), *a.shape,
                          *wg.colsum_cut(*a.shape), stream()):
            raise RuntimeError("the other colsum failed to launch")
        return out

    return wgrad, colsum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="path of the other revision's wgrad.cu")
    ap.add_argument("--only-bf16io", action="store_true", help="the bf16 products alone")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_wgrad: no CUDA device is available", file=sys.stderr)
        return 1
    from lft_torch.device import resolve_device
    from lft_torch.kernels import wgrad as wg
    from lft_torch.profile_scene import cold_ms, device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, device=dev, generator=g)
    T = STEP_TOKENS
    with tempfile.TemporaryDirectory() as tmp:
        o_wgrad, o_colsum = _load_other(a.other, tmp)
        cases = []
        if not a.only_bf16io:
            cases += [(f"wgrad {what} [{T}, {K}]ᵀ[{T}, {N}]"
                       f"{'' if im is None else f' taps of {im}'}", per, "wgrad",
                       (rand(T, K), rand(T, N), im)) for what, K, N, im, per in STEP_PRODUCTS]
            cases += [(f"colsum {what} [{R}, {N}]", per, "colsum", (rand(R, N),))
                      for what, R, N, per in STEP_SUMS]
        bf = [(what, K, N, im, per, torch.bfloat16) for what, K, N, im, per in STEP_PRODUCTS]
        bf.append(("K3 dwo, dy = dx2 in f32", 128, 128, None, 4, torch.float32))
        cases += [(f"wgrad_bf16io {what} [{T}, {K}]ᵀ[{T}, {N}]"
                   f"{'' if im is None else f' taps of {im}'}", per,
                   "wgrad_bf16io" if dt == torch.bfloat16 else "wgrad_bf16io_f32dy",
                   (rand(T, K).bfloat16(), rand(T, N).to(dt), im))
                  for what, K, N, im, per, dt in bf]
        total = {}
        for what, per, key, args in cases:
            if key == "colsum":
                other, this = (lambda f=f: f(*args) for f in (o_colsum, wg.colsum))
                lib = lambda: args[0].sum(0)
                nbytes, flops = args[0].numel() * 4 + args[0].shape[1] * 4, 0
            else:
                other, this = (lambda f=f: f(*args) for f in (o_wgrad, wg.wgrad))
                x, dy, im = args
                if key == "wgrad":
                    lib = (lambda: x.t() @ dy) if im is None else \
                        (lambda: wg.wgrad_plain(x, dy, im))
                elif im is None:    # the bf16 product (an f32 dy cast first), f32 out
                    lib = lambda: torch.mm(x.t(), dy.bfloat16(), out_dtype=torch.float32)
                else:
                    lib = None
                taps = 1 if im is None else 9
                nbytes = (x.numel() * x.element_size() + dy.numel() * dy.element_size()
                          + taps * x.shape[1] * dy.shape[1] * 4)
                flops = 2 * T * x.shape[1] * dy.shape[1] * taps
            ref = lib() if lib is not None else wg.wgrad_plain(*args)
            for f in (other, this):
                if not float((f() - ref).abs().max()) <= 1e-4 * float(ref.abs().max()):
                    raise AssertionError(f"{what}: the two builds disagree with the library")
            t = [device_ms(other), device_ms(this), device_ms(this), device_ms(other)]
            t_lib = device_ms(lib) if lib is not None else None
            bio = key.startswith("wgrad_bf16io")
            bound = max(nbytes / BW, flops / BF16_RATE if bio else 0) * 1e3
            cold = ""
            if bio:
                c = [cold_ms(other), cold_ms(this), cold_ms(this), cold_ms(other)]
                c_lib = cold_ms(lib) if lib is not None else None
                cold = (f"; L2 flushed: other {c[0]:.4f} / {c[3]:.4f} ms, this {c[1]:.4f} / "
                        f"{c[2]:.4f} ms, cuBLAS "
                        f"{'-' if c_lib is None else f'{c_lib:.4f} ms'}")
            o, c_, l_ = total.get(key, (0.0, 0.0, 0.0))
            total[key] = (o + per * (t[0] + t[3]) / 2, c_ + per * (t[1] + t[2]) / 2,
                          l_ + per * (t_lib or 0.0))
            print(f"{what}: other {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms, "
                  f"one PyTorch call {'-' if t_lib is None else f'{t_lib:.4f} ms'}, bound "
                  f"{bound:.4f} ms{cold}; {per} a step", flush=True)
    for key, (o, c, l_) in total.items():   # K3's dwo on an f32 dy: 4 of the 16 bf16 ones
        print(f"{key} over a fused step's launches: other {o:.4f} ms, this {c:.4f} ms, "
              f"one PyTorch call each {l_:.4f} ms (where there is one)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
