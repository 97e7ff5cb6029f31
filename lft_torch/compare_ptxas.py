"""Hold this checkout's f32 kernel instances to another revision's machine
code: the ptxas registers and spills of every kernel, both builds.

    python3 -m lft_torch.compare_ptxas OTHER_CSRC_DIR [--replaced REGEX]

OTHER_CSRC_DIR holds another revision's whole `lft_torch/csrc` (e.g. `git
archive <commit> lft_torch/csrc` unpacked into a git-ignored directory such
as `ab/`), or is another checkout's `lft_torch/build` after its
`build_all` (its ptxas reports `lib<source>_<hash>.so.log` are read, and
nothing is compiled). Each source of this checkout is built as
`chip_smoke.py` builds it (`kernels._build.build_all`, whose ptxas report is
kept beside each library) and each source of the other revision with the
same flags. Kernels
are named by their demangled names (`compare_bwd.ptxas_report`); a kernel that gained trailing
`float` template arguments here (the IO types of `--dtype bfloat16`'s
`_bf16io` instances: K1-K4's, `wgrad`'s two operands, K7's and K8's
backwards) or trailing `false`s (the `BF` switch of `--dtype mixed`'s
bf16-operand instances, rowgemm.cuh / tokenize.cuh / wgrad.cu; the STATS
switch of K2.3's and K7's bf16-IO kernels; the DIV and DOUT switches of
K5's backward passes), in any order, or a trailing `true` after a
`__nv_bfloat16` IO type (the `BF` switch that K1's, K2.4's and K2.5's
bf16-IO instances always set, made its own template argument for the
bf16-operand forward instances of `--dtype mixed`), is matched to the other
build's kernel without them; so is a kernel that lost its trailing `float`
IO types here (`wgrad`'s f32 kernels once `wgrad_bf16io` had kernels of
its own), or its trailing `false` (K2.5's SITES switch once its `_sites`
instances had kernels of their own, ffn_sites.cuh), or an IO type with
its BF switch (`, float, false`) from the middle of its arguments (K1's
and K2.5's f32 and `_sites` kernels once their all-bf16 forms had kernels
of their own, ang_bf16.cuh and ffn_bf16.cuh). Prints every matched pair's
registers, spill stores and loads, and each side's unmatched kernels (here:
the newer bf16 instances). Exits 1 if a matched pair differs or an old
kernel is missing; `--replaced REGEX`: an old kernel missing here whose
name matches REGEX (an instance this revision replaced by a kernel of
another design) is printed as replaced and not counted. Needs nvcc, not a
card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from lft_torch.compare_bwd import ptxas_report
from lft_torch.kernels import _build


def bare(name: str) -> str:
    """The name without the return type that a template's demangled name
    carries and a plain function's does not."""
    return name[5:] if name.startswith("void ") else name


def without_bf(name: str) -> str:
    """`k<64, false>` -> `k<64>`, `k<false>` -> `k`: the name before the BF switch."""
    if name.endswith(", false>"):
        return name[: -len(", false>")] + ">"
    if name.endswith("<false>"):
        return name[: -len("<false>")]
    return name


def without_io(name: str) -> str:
    """`k<64, false, float>` -> `k<64, false>`, `k<2, 4, false, float, float>`
    -> `k<2, 4, false>`: the name before the IO types."""
    while name.endswith(", float>"):
        name = name[: -len(", float>")] + ">"
    return name


def without_bf16_bf(name: str) -> str:
    """`k<64, __nv_bfloat16, true>` -> `k<64, __nv_bfloat16>`: a bf16-IO
    instance's name before its BF switch."""
    if name.endswith("__nv_bfloat16, true>"):
        return name[: -len(", true>")] + ">"
    return name


def match(name: str, old_by: dict):
    """The other build's kernel that `name` is, or None: `name`, then `name`
    with its trailing `false`s and `float`s (or a bf16-IO instance's `true`)
    taken off one at a time."""
    cand = name
    while True:
        if cand in old_by:
            return cand
        shorter = (without_io(cand) if cand.endswith(", float>") else
                   without_bf16_bf(cand) if cand.endswith("__nv_bfloat16, true>") else
                   without_bf(cand))
        if shorter == cand:
            return None
        cand = shorter


def reports(csrc_other: str) -> tuple:
    """({source: {kernel: report}} of this build, of the other build)."""
    paths = _build.build_all()
    ours = {}
    for src, lib in paths.items():
        with open(lib + ".log") as f:
            ours[src] = ptxas_report(f.read())
    theirs = {}
    logs = {f[3:].rsplit("_", 1)[0]: f for f in os.listdir(csrc_other) if f.endswith(".so.log")}
    if logs:
        for src in _build.SOURCES:
            if src in logs:
                with open(os.path.join(csrc_other, logs[src])) as f:
                    theirs[src] = ptxas_report(f.read())
        return ours, theirs
    with tempfile.TemporaryDirectory() as tmp:
        for src in _build.SOURCES:
            path = os.path.join(csrc_other, f"{src}.cu")
            if not os.path.exists(path):
                continue
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc_other, "-o",
                                   os.path.join(tmp, f"lib{src}.so"), path],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
            theirs[src] = ptxas_report(proc.stdout + proc.stderr)
    return ours, theirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc")
    ap.add_argument("--replaced", default=None,
                    help="old kernels matching this regex may be missing here")
    a = ap.parse_args(argv)
    replaced = re.compile(a.replaced) if a.replaced else None
    ours, theirs = reports(a.other_csrc)
    bad = 0
    for src in sorted(theirs):
        new = ours.get(src, {})
        old_by = {bare(k): r for k, r in theirs[src].items()}
        old_io = {without_io(k): k for k in old_by if k.endswith(", float>")}
        old_bf = {without_bf(k): k for k in old_by if k.endswith(", false>")}
        old_mid = {k.replace(", float, false", "", 1): k for k in old_by if ", float, false" in k}
        matched = set()
        for name, r in sorted(new.items()):
            key = (match(bare(name), old_by) or old_io.get(bare(name)) or old_bf.get(bare(name))
                   or old_mid.get(bare(name)))
            if key is None:
                print(f"{src}: new only  {name}: {r[0]} registers, spills {r[1]}/{r[2]} B")
                continue
            matched.add(key)
            same = old_by[key] == r
            bad += not same
            print(f"{src}: {'same' if same else 'DIFFERS'}  {name}: {r[0]} registers, spills "
                  f"{r[1]}/{r[2]} B; other build {key}: {old_by[key][0]} registers, spills "
                  f"{old_by[key][1]}/{old_by[key][2]} B")
        for key in sorted(set(old_by) - matched):
            if replaced is not None and replaced.search(key):
                print(f"{src}: replaced  {key}")
                continue
            bad += 1
            print(f"{src}: MISSING here  {key}")
    print(f"ptxas: {'every kernel of the other build matched' if not bad else f'{bad} differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
