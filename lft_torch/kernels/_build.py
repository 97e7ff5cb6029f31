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
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("ang_block", "spa_block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset
LAUNCHES = {
    "ang_block": 0,
    "spa_tokenize_ln": 0,
    "spa_qkv": 0,
    "spa_window_attn": 0,
    "spa_outproj_ln": 0,
    "spa_ffn_out": 0,
}

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
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
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
    return paths


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


def check_cuda_args(kernel: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the same CUDA device, float32, contiguous, and
    16-byte aligned (the kernels use float4 accesses)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{kernel}: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: float32 tensors only, got {t.dtype}")
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
