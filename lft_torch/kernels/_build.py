"""Build and load the port's CUDA kernels, and count their launches.

Each `lft_torch/csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface (`lft_torch/build/`, git-
ignored), at first use, and loaded with `ctypes`. All missing libraries
are built by parallel `nvcc` processes. A library's file name carries a
hash of its sources and flags, so an edited source is rebuilt.

Every wrapper that launches a kernel adds one to `LAUNCHES[name]` right
where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("ang_block", "spa_block", "spa_block_bwd", "wgrad", "ang_attn", "spa_attn_hp",
           "ang_attn_sweep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The kernels of the SR forward (K1, K2's five steps) ...
FORWARD = ("ang_block", "spa_tokenize_ln", "spa_qkv", "spa_window_attn",
           "spa_outproj_ln", "spa_ffn_out")
# ... and those only a train step launches: K1 and K2's window step with the
# residuals of the backward, K4, K3's five steps, the weight-grad reductions.
TRAINING = ("ang_block_res", "spa_window_attn_res", "ang_block_bwd", "spa_ffn_out_bwd",
            "spa_ln_qkv", "spa_window_attn_bwd", "spa_qkv_ln_bwd", "spa_tokenize_bwd",
            "wgrad", "colsum")
# The kernels of the unfused per-op branch's default pair: K7 (angular
# attention) and K5 (window attention), each as the primal, with the residuals
# (m, l) of the backward, and the backward.
PEROP = ("ang_attn", "ang_attn_res", "ang_attn_bwd", "spa_attn_hp", "spa_attn_hp_res",
         "spa_attn_hp_bwd")
# The branch's other trainable families, in the same three forms: K8 (the
# key-view sweep: any view count), K9 (the 25-offset sweep: any view size) and
# K6 (views of more than 2048 pixels); K9 and K6 launch K5's kernels, counted
# under their own names.
SWEEPS = ("ang_attn_sweep", "ang_attn_sweep_res", "ang_attn_sweep_bwd", "spa_attn_offset",
          "spa_attn_offset_res", "spa_attn_offset_bwd", "spa_attn_mxu", "spa_attn_mxu_res",
          "spa_attn_mxu_bwd")

# The last of the TPU kernels' counterparts: K10 (tile-halo window attention,
# forward only; K5's forward kernel under K10's name), K4 at pixels of 65 to
# 128 views (its three kernels, counted apart from A2 <= 64 so that a run
# shows which geometry trained) and K11 (K2's first and last step on a
# pixel-major buffer).
K11 = ("spa_tokenize_ln_pm", "spa_ffn_out_pm")
TAIL = ("spa_attn_tile", "ang_block_bwd128") + K11

# The bf16-operand instances that a fused train step under `--dtype mixed`
# launches in place of K3's five steps, K4 (either form) and `wgrad` (the
# backward's default plan, LFT_MM_HP_BWD_SITES=none): the same kernels with
# each product one TF32 pass over operands rounded to bf16.
MIXED = ("spa_ffn_out_bwd_bf16", "spa_ln_qkv_bf16", "spa_window_attn_bwd_bf16",
         "spa_qkv_ln_bwd_bf16", "spa_tokenize_bwd_bf16", "ang_block_bwd_bf16",
         "ang_block_bwd128_bf16", "wgrad_bf16")

# The bf16-IO instances of the SR forward's kernels that `--dtype bfloat16`
# launches in place of K1 and K2's five steps: bf16 activations in and out,
# each product one TF32 pass over bf16 values, lft_tpu's rounding points.
BF16IO = tuple(k + "_bf16io" for k in FORWARD)

# ... and of those a fused train step launches under `--dtype bfloat16` in
# place of K1 res, K2.3 res, K4 (either form), K3's five steps and `wgrad`:
# bf16 activations, residuals and operands in memory, each product one TF32
# pass over bf16 values with f32 sums, lft_tpu's rounding points (what stays
# f32: m, l, dx2, dtokpe, the LayerNorm partial sums and the weight grads).
BF16TRAIN = tuple(k + "_bf16io" for k in (
    "ang_block_res", "spa_window_attn_res", "ang_block_bwd", "ang_block_bwd128",
    "spa_ffn_out_bwd", "spa_ln_qkv", "spa_window_attn_bwd", "spa_qkv_ln_bwd",
    "spa_tokenize_bwd", "wgrad"))

# The bf16-IO instances of the per-op branch's forwards that `--dtype
# bfloat16` serving launches on bf16 tensors: K7, K8, K5, K6, K9, K10, each
# with lft_tpu's rounding points for its family (deferred: K7, K5; normalized:
# K6; f32 inside: K8, K9, K10).
PEROP_BF16IO = tuple(k + "_bf16io" for k in (
    "ang_attn", "ang_attn_sweep", "spa_attn_hp", "spa_attn_mxu", "spa_attn_offset",
    "spa_attn_tile"))

# ... and those that only a train step of the per-op branch launches under
# `--dtype bfloat16`: the `_res` form and the backward of K7, K8, K5, K6 and
# K9, each with its family's rounding points (rounded operands: K7, K5, K6;
# f32 inside, D from the saved bf16 output: K8, K9).
PEROP_BF16TRAIN = tuple(k + "_bf16io" for k in (
    "ang_attn_res", "ang_attn_bwd", "ang_attn_sweep_res", "ang_attn_sweep_bwd",
    "spa_attn_hp_res", "spa_attn_hp_bwd", "spa_attn_mxu_res", "spa_attn_mxu_bwd",
    "spa_attn_offset_res", "spa_attn_offset_bwd"))

# The bf16-operand instances of the SR forward's kernels that `--dtype mixed`
# serving launches under LFT_MM_HP_SITES=none (every site rounded) where no
# gradient is needed: K1, K2's five steps and K11's two, f32 activations,
# each product one TF32 pass over operands rounded to bf16, lft_tpu's
# softmax (each token's max over its heads, e rounded) in K1 and K2.3.
MIXED_FWD = tuple(k + "_bf16" for k in FORWARD + K11)

# ... and those that only a fused train step launches under `--dtype mixed`
# with LFT_MM_HP_SITES=none: K1 res and K2.3 res on `MIXED_FWD`'s
# arithmetic, their attn residual f32 holding bf16 values (K2's other four
# steps launch their `MIXED_FWD` instances; the backward `MIXED`'s), and
# under LFT_MM_HP_BWD_SITES=all K4 in both forms with its attention step
# forming D from its own p (`_dp`; K3's f32 kernels do so already).
MIXED_TRAIN = ("ang_block_res_bf16", "spa_window_attn_res_bf16", "ang_block_bwd_dp",
               "ang_block_bwd128_dp")

# The site-subset instances of `--dtype mixed` under an LFT_MM_HP_SITES
# subset: K1 (both forms), K2.2, K2.3 (both forms), K2.5 and K11.5, the
# kernels whose products span sites that such a plan can split
# (`common.KERNEL_SITES`); each takes a runtime mask of the sites that round
# and picks each product's path by it. A launch whose sites all round takes
# its `_bf16` instance, one whose sites all stay f32 its f32 one.
MIXED_SITES = ("ang_block_sites", "ang_block_res_sites", "spa_qkv_sites",
               "spa_window_attn_sites", "spa_window_attn_res_sites", "spa_ffn_out_sites",
               "spa_ffn_out_pm_sites")

# ... and those of a fused train step's backward under an LFT_MM_HP_BWD_SITES
# subset: K3.a, K3.b, K3.c, K3.d and K4 in both forms, each launch whose
# products span sites that such a plan can split (`common.KERNEL_BWD_SITES`,
# `common.card_bwd`); K3.e computes one site and takes its f32 or `_bf16`
# instance, `wgrad` each site's own.
MIXED_BWD_SITES = ("spa_ffn_out_bwd_sites", "spa_ln_qkv_sites", "spa_window_attn_bwd_sites",
                   "spa_qkv_ln_bwd_sites", "ang_block_bwd_sites", "ang_block_bwd128_sites")

# K11's bf16-IO instances (`--dtype bfloat16` on a pixel-major buffer): K2.1
# and K2.5 bf16io's arithmetic, the buffer read and written in place.
TAIL_BF16IO = tuple(k + "_bf16io" for k in K11)

# kernel name -> launches since the last reset
LAUNCHES = {name: 0 for name in FORWARD + TRAINING + PEROP + SWEEPS + TAIL + MIXED + BF16IO
            + BF16TRAIN + PEROP_BF16IO + PEROP_BF16TRAIN + MIXED_FWD + MIXED_TRAIN
            + MIXED_SITES + MIXED_BWD_SITES + TAIL_BF16IO}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build lft_torch's CUDA kernels)")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(SRC_DIR)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(SRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every library that is missing, one `nvcc` per source, all
    started together. Returns {name: path}; raises with the compiler's
    output if a build fails. The ptxas report of each build is kept
    beside its library as `<lib>.log`."""
    paths = {n: _lib_path(n) for n in SOURCES}
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    # ranks started together (lft_torch/parallel/) build once: the first to
    # take the lock builds, the others then find the libraries
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_missing(paths)
    return paths


def _build_missing(paths: dict) -> None:
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        with open(paths[n] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            lib = ctypes.CDLL(paths[name])
            lib.lft_error_string.argtypes = [ctypes.c_int]
            lib.lft_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def bind(name: str, fn: str, n_ptr: int, tail: tuple):
    """`lib.fn` with `n_ptr` pointer arguments, then `tail` ctypes types,
    then the stream pointer; returns an int (cudaError_t)."""
    f = getattr(library(name), fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def build_library(src: str, out_dir: str, name: str) -> ctypes.CDLL:
    """Compile one CUDA source with the port's nvcc flags into
    `out_dir/lib<name>.so` and load it: another revision's source, for the
    A/B tools (`compare_wgrad`, `compare_tokenize`). Its headers are looked
    up beside it first, then in this checkout's `csrc/`. Raises with the
    compiler's output if the build fails."""
    so = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", SRC_DIR, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(so)


def check_cuda_args(kernel: str, *tensors: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> None:
    """Every tensor of the dtype the launcher takes (`dtype`: float32, or
    bfloat16 for a `_bf16io` instance's activations), on the same CUDA
    device, contiguous, and 16-byte aligned (the kernels use 16-byte
    accesses)."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {dtype} tensors only, got {t.dtype}")
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{kernel}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: tensors must be 16-byte aligned")


def launch(name: str, kernel: str, fn, device: torch.device, *args) -> None:
    """Call a C launcher on `device`'s current stream, raise on a non-zero
    cudaGetLastError(), and count the launch."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = library(name).lft_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({err})")
    LAUNCHES[kernel] += 1
