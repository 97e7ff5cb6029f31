"""What the port's hand-written kernels take, read by their wrappers and by
the model's dispatch.

The CUDA sources are built for C in `KERNEL_C` model channels: head widths
2, 4, 8 in the angular attention (C over 8 heads) and 4, 8, 16 in the
spatial one (2C over 8 heads). lft_tpu's Pallas kernels take any C with
8 | 2C. So where a choice is automatic (`attention_impl='auto'`, the fused
branch of a forward or train step on CUDA, the tiled scene pipeline), a
model of another width takes the plain torch ops: the unfused branch with
the tiled or dense torch attention, and no kernel is launched. An explicit
request for a kernel (`attention_impl='pallas'`, a block or kernel wrapper
called directly) still raises `NotImplementedError` at such a width.

It also holds `--dtype mixed`'s per-site product plans (below), which the
plain versions of K1-K4 follow at every site, and the card's kernels at
every plan too: the forward's (`KERNEL_SITES`, `card_fwd`, `fwd_kernel`)
and the backward's (`KERNEL_BWD_SITES`, `card_bwd`), each launch naming its
f32, `_bf16` or `_sites` instance (K4 also `_dp`); and `--dtype
bfloat16`'s routing of bf16 tensors (`io_kernel`).
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from lft_torch.kernels._build import (BF16TRAIN, FORWARD, PEROP_BF16IO, PEROP_BF16TRAIN,
                                      TAIL_BF16IO)

KERNEL_C = (16, 32, 64)


def kernels_take(C: int) -> bool:
    """Whether the port's kernels take a model of C channels."""
    return C in KERNEL_C


def attention_route(impl: str, device_type: str, C: int) -> str:
    """The unfused branch's attention implementation for a model of C
    channels on `device_type`: 'auto' becomes 'pallas' (the per-op kernels)
    on CUDA where `kernels_take(C)` and stays 'auto' (the tiled or dense
    torch op) otherwise; an explicit choice is kept."""
    if impl == "auto" and device_type == "cuda" and kernels_take(C):
        return "pallas"
    return impl


# ------------------------------------------------- the `mixed` site plans ---
#
# Copied from lft_tpu/kernels/common.py:18-50 (not imported: the port
# imports nothing of the JAX package). Under `--dtype mixed` each product
# SITE of the fused blocks either keeps f32 operands or rounds both operands
# to bf16 and accumulates in f32 (spa_block sites: tok the 9-tap
# tokenization, qk / v the projections, score q kᵀ, av p v, wo the
# out-projection, ffn both MLP products, lin Token2SAI; the ang_block sites
# carry an "a"). The forward's plan is LFT_MM_HP_SITES (default: every site
# f32), the backward's LFT_MM_HP_BWD_SITES (default: none).
MM_HP_ALL = frozenset({"tok", "qk", "v", "score", "av", "wo", "ffn", "lin",
                       "aqkv", "ascore", "aav", "awo", "affn"})
MM_HP_DEFAULT = "all"


def mm_hp_sites(env: str = "LFT_MM_HP_SITES", default: str = MM_HP_DEFAULT) -> frozenset:
    """The sites that keep f32 operands under `mixed`, from the environment
    variable `env`: "all", "none" or "", or a comma list drawn from
    MM_HP_ALL (an unknown name raises: a typo must not silently run at low
    precision). Read per call: a model call reads it once."""
    spec = os.environ.get(env, default).strip()
    if spec == "all":
        return MM_HP_ALL
    if spec in ("", "none"):
        return frozenset()
    sites = frozenset(s.strip() for s in spec.split(",") if s.strip())
    bad = sites - MM_HP_ALL
    if bad:
        raise ValueError(f"unknown {env} entries {sorted(bad)}; "
                         f"valid: {sorted(MM_HP_ALL)}")
    return sites


def mm_site_plan(mm_half: bool, sites: frozenset) -> dict:
    """site -> whether both operands of its products are rounded to bf16:
    under `mm_half` every site outside `sites`; without it none."""
    return {s: bool(mm_half) and s not in sites for s in MM_HP_ALL}


def active(plan):
    """The plan where it rounds at least one site, else None (the f32
    arithmetic, whose code paths are the float32 mode's own)."""
    return plan if plan and any(plan.values()) else None


def rounds(plan, site: str) -> bool:
    return bool(plan) and plan[site]


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bf16 (ties to even), kept in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def rd(t: torch.Tensor, plan, site: str) -> torch.Tensor:
    """A product's operand under `plan`: rounded to bf16 where its site is."""
    return bf16_round(t) if rounds(plan, site) else t


def _plan_name(sites: frozenset) -> str:
    if sites == MM_HP_ALL:
        return "all"
    return ",".join(sorted(sites)) or "none"


def _site_name(plan) -> str:
    return _plan_name(frozenset(s for s, r in plan.items() if not r))


# The sites whose products each forward launch computes on the card, as
# lft_tpu's K1 and K2 use them (ang_block.py:113-149, spa_block.py:131-203):
# K2.3 rounds q, k (`score`) and v, e (`av`), and its `_res` form stores the
# attn residual at the `wo` site's dtype (:190, :346-348); K1's `_res` form
# stores attn at `awo`'s, a site K1 computes anyway.
_K1_SITES = ("aqkv", "ascore", "aav", "awo", "affn")
KERNEL_SITES = {
    "ang_block": _K1_SITES, "ang_block_res": _K1_SITES,
    "spa_tokenize_ln": ("tok",), "spa_tokenize_ln_pm": ("tok",),
    "spa_qkv": ("qk", "v"),
    "spa_window_attn": ("score", "av"), "spa_window_attn_res": ("score", "av", "wo"),
    "spa_outproj_ln": ("wo",),
    "spa_ffn_out": ("ffn", "lin"), "spa_ffn_out_pm": ("ffn", "lin"),
}
# A `_sites` instance's mask: bit i rounds site i (csrc/tf32.cuh: S_TOK ..).
SITE_BITS = {s: 1 << i for i, s in enumerate(
    ("tok", "qk", "v", "score", "av", "wo", "ffn", "lin", "aqkv", "ascore", "aav", "awo",
     "affn"))}


def card_fwd(plan, kernel: str) -> str:
    """The instance that forward launch `kernel` (a key of KERNEL_SITES)
    takes on the card under the forward plan `plan`, as the suffix of its
    name: "" (the f32 instance) where none of its sites round, "_bf16" where
    all do, "_sites" (with `site_mask`) where some do and some do not (an
    LFT_MM_HP_SITES subset that splits the kernel's products). Under `all`
    and `none` every launch takes the f32 or `_bf16` instance."""
    plan = active(plan)
    if plan is None:
        return ""
    r = [plan[s] for s in KERNEL_SITES[kernel]]
    return "_bf16" if all(r) else "_sites" if any(r) else ""


# The sites whose products each backward launch computes on the card, as
# lft_tpu's _bwd_kernel / _spa_vjp_bwd use them (spa_block.py:430-567,
# ang_block.py:307-385): K3.a x2 = attn Wo and dattn = dx2 Woᵀ at `wo`, the
# FFN at `ffn`, dy = dout Wlinᵀ at `lin`; K3.b and K3.d the projections at
# `qk` and `v`; K3.c q, k, ds and D's sum at `score`, v, dattn and p at
# `av`; K3.e the transposed tokenization at `tok` alone (f32 or `_bf16`,
# never `_sites`); K4's three kernels the five angular sites. The weight
# gradients (`wgrad`) take each site's own setting.
_K4_SITES = ("aqkv", "ascore", "aav", "awo", "affn")
KERNEL_BWD_SITES = {
    "spa_ffn_out_bwd": ("wo", "ffn", "lin"), "spa_ln_qkv": ("qk", "v"),
    "spa_window_attn_bwd": ("score", "av"), "spa_qkv_ln_bwd": ("qk", "v"),
    "spa_tokenize_bwd": ("tok",),
    "ang_block_bwd": _K4_SITES, "ang_block_bwd128": _K4_SITES,
}


def site_mask(plan, kernel: str) -> int:
    """The mask a `_sites` launch of `kernel` (a key of KERNEL_SITES or
    KERNEL_BWD_SITES) takes: the SITE_BITS of its sites that round under
    `plan`."""
    sites = KERNEL_SITES[kernel] if kernel in KERNEL_SITES else KERNEL_BWD_SITES[kernel]
    return sum(SITE_BITS[s] for s in sites if rounds(plan, s))


def card_bwd(rounded: bool, bwd_plan, kernel: str) -> str:
    """The instance that backward launch `kernel` (a key of
    KERNEL_BWD_SITES) takes on the card under the backward plan `bwd_plan`
    after a forward that rounded (`rounded`: its plan was active) or not,
    as the suffix of its name: "" (the f32 instance) where none of its sites
    round, "_bf16" where all do, "_sites" (with `site_mask(bwd_plan,
    kernel)`) where some do and some do not. K4's f32 instance forms its
    attention's D = dattn . attn, which is lft_tpu's D = sum_j p_j dp_j only
    where the saved attn is an f32 forward's: with its sites all f32 after a
    forward that rounded, K4 takes `_dp` (D from its own p). The `_bf16` and
    `_sites` instances always form D so."""
    bwd_plan = active(bwd_plan)
    r = [bool(bwd_plan) and bwd_plan[s] for s in KERNEL_BWD_SITES[kernel]]
    if all(r):
        return "_bf16"
    if any(r):
        return "_sites"
    return "_dp" if rounded and kernel in ("ang_block_bwd", "ang_block_bwd128") else ""


def card_plan(plan, bwd_plan) -> dict:
    """Every launch of a fused model call on the card under the forward plan
    `plan` and the backward plan `bwd_plan`, named as the wrappers name it:
    {kernel: instance} for the keys of KERNEL_SITES (`card_fwd`) and of
    KERNEL_BWD_SITES (`card_bwd`). The card runs every pair of plans."""
    rounded = active(plan) is not None
    names = {k: k + card_fwd(plan, k) for k in KERNEL_SITES}
    names.update({k: k + card_bwd(rounded, bwd_plan, k) for k in KERNEL_BWD_SITES})
    return names


def no_plan(plan, kernel: str) -> None:
    """A bf16 tensor takes no `mixed` plan (the two dtypes exclude each
    other): an active plan raises NotImplementedError."""
    if active(plan) is not None:
        raise NotImplementedError(
            f"{kernel}: a bf16 tensor runs no --dtype mixed plan, got {_site_name(plan)!r}")


def fwd_kernel(kernel: str, t: torch.Tensor, plan) -> str:
    """The launch name of forward kernel `kernel` on the card for the IO
    dtype of `t` under the forward plan `plan`: its `_bf16io` instance for a
    bf16 t (`io_kernel`, no plan), else its f32, `_bf16` or `_sites`
    instance (`card_fwd`)."""
    name = io_kernel(kernel, t)
    if t.dtype == torch.bfloat16:
        no_plan(plan, name)
        return name
    return name + card_fwd(plan, kernel)


# ----------------------------------------------- `--dtype bfloat16` (IO) ---
#
# lft_tpu's `--dtype bfloat16` runs its fused kernels on bf16 tensors (`io =
# x_ref.dtype`, lft_tpu/kernels/ang_block.py:105, spa_block.py:116): its plan
# is `mm_site_plan(False, bf16, ...)`, every product site over bf16 operands
# (the IO dtype), and every intermediate the kernel hands on rounded to bf16
# where it is stored or added (the rounding points the plain versions list).
# Its unfused branch runs the per-op kernels on bf16 tensors too. On the card
# the SR forward's kernels (`_build.FORWARD`), those of the fused train step
# (`_build.BF16TRAIN`: K1 res, K2.3 res, K4, K3's five steps, `wgrad`), the
# per-op branch's forwards (`_build.PEROP_BF16IO`: K5-K10), its `_res`
# forms and backwards (`_build.PEROP_BF16TRAIN`: K5-K9) and K11's
# pixel-major steps (`_build.TAIL_BF16IO`) have `_bf16io` instances; a bf16
# tensor at any other launch raises. Nothing falls back to f32.


def io_kernel(kernel: str, t: torch.Tensor) -> str:
    """The launch name of `kernel` for the IO dtype of `t`: itself for an
    f32 tensor, its `_bf16io` instance for a bf16 one; a bf16 tensor at a
    kernel without one (`colsum`, whose inputs are f32 sums) raises
    NotImplementedError."""
    if t.dtype != torch.bfloat16:
        return kernel
    if kernel in FORWARD or kernel + "_bf16io" in (BF16TRAIN + PEROP_BF16IO + PEROP_BF16TRAIN
                                                   + TAIL_BF16IO):
        return kernel + "_bf16io"
    raise NotImplementedError(f"{kernel}: has no bf16-IO form; pass float32 tensors")


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two, as jnp's `@` promotes a bf16
    weight against an f32 activation (exactly: bf16 values widen to f32)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


# The per-op kernels' plain versions on the card, where the caller asks for
# them: `models.lft.forward(..., plain_blocks=True)` under `--dtype bfloat16`
# on the unfused branch, the reference that the card's per-op `_bf16io`
# kernels are held against (their forwards, `_res` forms and backwards; an
# autograd Function's backward runs where its forward ran). Everywhere else a
# wrapper takes its plain version for a CPU tensor only.
_plain = threading.local()


@contextlib.contextmanager
def plain_versions():
    """Within it, the per-op attention kernels (forwards, `_res` forms and
    backwards) run their plain versions on every device."""
    old = getattr(_plain, "on", False)
    _plain.on = True
    try:
        yield
    finally:
        _plain.on = old


def on_card(t: torch.Tensor) -> bool:
    """Whether a per-op kernel's wrapper launches its kernel for `t`: a CUDA
    tensor, outside `plain_versions()`."""
    return t.device.type == "cuda" and not getattr(_plain, "on", False)


def plain_if(plain: bool):
    """`plain_versions()` where `plain`, else nothing: an autograd Function's
    backward entered where its forward ran."""
    return plain_versions() if plain else contextlib.nullcontext()
