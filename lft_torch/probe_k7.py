"""What bounds K7 on the card: this checkout's `csrc/ang_attn.cu` timed
beside variants of it, each one edit away, in turns in one process.

    python3 -m lft_torch.probe_k7

The variants (built with the port's nvcc flags into a temporary
directory; an edit whose anchor is gone from the source raises):

* `fwd_no_compute` / `bwd_no_compute`: the staging and the stores alone
  (the outputs are then the inputs or garbage);
* `fwd_no_loads` / `bwd_no_loads`: the compute alone, on the first tile's
  rows (no cp.async past each block's first tile);
* `bwd_own_registers`: the held query phase (A2 <= 32) at the registers it
  would take (launch bounds of 256 threads, tiles of at most 256), against
  128 with spills;
* `bwd_lds2`: two more `LDS.128` a (key, query) pair in the key phase,
  and `bwd_fma8`: eight more FMAs there instead, which tell what a
  shared-memory read costs beside an FMA.

Times `ang_attn` at [16384, 25, 64], `ang_attn_res` at [4096, 25, 64] and
[1024, 81, 64] (the forward's variants) and `ang_attn_bwd` at [4096, 25,
64] and [1024, 81, 64] (the backward's, each from its own forward's (m,
l)) in device time (`profile_scene.device_ms`), in the order as is,
variants, variants reversed, as is, with each variant's ptxas registers
and spills at dh = 8 and its max |diff| to the plain version. Prints the
card's name and power limit first. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from lft_torch.compare_bwd import _tuple, ptxas_report
from lft_torch.compare_k7 import _wrap_other

_FWD_STAGE = """    stage_async<C, LD>(dst, q, row0, rows);
    stage_async<C, LD>(dst + RT * LD, k, row0, rows);
    stage_async<C, LD>(dst + 2 * RT * LD, v, row0, rows);
    cp_async_commit();"""
_BWD_STAGE = """    stage_async<C, LD>(dst, q, row0, rows);
    stage_async<C, LD>(dst + RT * LD, k, row0, rows);
    stage_async<C, LD>(dst + 2 * RT * LD, v, row0, rows);
    stage_async<C, LD>(dst + 3 * RT * LD, dout, row0, rows);"""
_FIRST_ONLY = "    if (tile >= static_cast<int>(gridDim.x)) { cp_async_commit(); return; }\n"
_KEY_READ = """            ld<DH>(GT + o * LD + hh * DH, go);
            const float4 sd = load4(SD + (o * H + hh) * 4);"""

# name -> (the kernel it probes, [(anchor, replacement), ...])
VARIANTS = {
    "fwd_no_compute": ("fwd", [("    if (p < np) {\n      const int i0 = 2 * pr",
                                "    if (false && p < np) {\n      const int i0 = 2 * pr")]),
    "fwd_no_loads": ("fwd", [(_FWD_STAGE, _FIRST_ONLY + _FWD_STAGE)]),
    "bwd_no_compute": ("bwd", [("    for (int t = tid; t < items; t += nt) {\n      const int i =",
                                "    for (int t = tid; t < 0; t += nt) {\n      const int i ="),
                               ("    for (int t = tid; t < items; t += nt) {\n      const int j =",
                                "    for (int t = tid; t < 0; t += nt) {\n      const int j =")]),
    "bwd_no_loads": ("bwd", [(_BWD_STAGE, _FIRST_ONLY + _BWD_STAGE)]),
    "bwd_own_registers": ("bwd", [
        ("__launch_bounds__(NT_MAX)\n    ang_attn_bwd_kernel(",
         "__launch_bounds__(HOLD ? 256 : NT_MAX)\n    ang_attn_bwd_kernel("),
        ("NT_MAX / (H * A2)));\n  const int nbuf",
         "(A2 <= HOLD_MAX ? 256 : NT_MAX) / (H * A2)));\n  const int nbuf")]),
    "bwd_lds2": ("bwd", [(_KEY_READ, _KEY_READ.replace("\n", """
            float xt[DH];
            ld<DH>(GT + o * LD + (hh ^ 1) * DH, xt);
#pragma unroll
            for (int d = 0; d < DH; ++d) go[d] = fmaf(0.f, xt[d], go[d]);
""", 1))]),
    "bwd_fma8": ("bwd", [(_KEY_READ, _KEY_READ.replace("\n", """
#pragma unroll
            for (int d = 0; d < DH; ++d) go[d] = fmaf(0.f, kme[(d + 1) % DH], go[d]);
""", 1))]),
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"probe_k7: the anchor is not once in ang_attn.cu:\n{old}")
        src = src.replace(old, new)
    return src


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_k7: no CUDA device is available", file=sys.stderr)
        return 1
    from lft_torch.device import resolve_device
    from lft_torch.kernels import _build
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.profile_scene import device_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    src = open(os.path.join(_build.SRC_DIR, "ang_attn.cu")).read()
    builds = {"as_is": ("both", src)}
    builds.update({n: (kind, variant_source(src, e)) for n, (kind, e) in VARIANTS.items()})
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for n, (_, text) in builds.items():
            cu = os.path.join(tmp, f"{n}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[n] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.SRC_DIR,
                                         "-o", os.path.join(tmp, f"lib{n}.so"), cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, p in procs.items():
            out, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for the variant {n}:\n{out}")
            regs = {k.replace("void ", ""): v for k, v in ptxas_report(out).items() if "<8" in k}
            print(f"ptxas {n}: " + "; ".join(f"{k} {r} registers, spills {s}/{ld} B"
                                             for k, (r, s, ld) in sorted(regs.items())),
                  flush=True)
            libs[n] = _wrap_other(ctypes.CDLL(os.path.join(tmp, f"lib{n}.so")))

        g = torch.Generator(device=dev).manual_seed(0)
        for N, A2, form in ((16384, 25, "fwd"), (4096, 25, "res"), (1024, 81, "res"),
                            (4096, 25, "bwd"), (1024, 81, "bwd")):
            shape = [N, A2, 64]
            q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) for _ in range(4))
            ref = am.ang_attention_blockdiag_plain(q, k, v, 8)
            want = {"fwd": ref[:1], "res": ref,
                    "bwd": am.ang_attention_blockdiag_bwd_plain(q, k, v, *ref[1:], dout, 8)}[form]
            runs = {}
            for n, (fwd, bwd) in libs.items():
                if builds[n][0] not in ("both", "bwd" if form == "bwd" else "fwd"):
                    continue
                if form == "bwd":
                    ml = fwd(q, k, v, True)[1:]
                    runs[n] = lambda bwd=bwd, ml=ml: bwd(q, k, v, *ml, dout)
                else:
                    runs[n] = lambda fwd=fwd: fwd(q, k, v, form == "res")
            errs = {n: max(float((a - b).abs().max()) for a, b in zip(_tuple(fn()), want))
                    for n, fn in runs.items()}
            order = list(runs)[1:]
            tm = {n: [] for n in runs}
            for n in ["as_is"] + order + order[::-1] + ["as_is"]:
                tm[n].append(device_ms(runs[n]))
            name = {"fwd": "ang_attn", "res": "ang_attn_res", "bwd": "ang_attn_bwd"}[form]
            print(f"{name} {shape} (device time, ms): " + "; ".join(
                f"{n} {' / '.join(f'{t:.4f}' for t in ts)} (max |diff| {errs[n]:.1e})"
                for n, ts in tm.items()), flush=True)
            del q, k, v, dout, ref, want, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
