"""Build and load the port's hand-written CUDA kernels.

Each source under ``sign_language_nlp_torch/csrc/`` has a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library at first use and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds. Libraries go to
``sign_language_nlp_torch/kernels/build/`` (git-ignored), named by a
hash of the source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header is never served from a stale
build. The compiler's output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """`$CUDA_HOME/bin/nvcc` (default /usr/local/cuda), else `nvcc` on
    PATH. Raises if there is none: kernels are built on the card's
    machine only."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on a machine with the CUDA "
                           "toolkit")
    return found


class Built(NamedTuple):
    library: str    # the shared library
    log: str        # nvcc's and ptxas's output from the build
    seconds: float  # time spent compiling; 0.0 when already built


def build(source: str) -> Built:
    """Compile `csrc/<source>` unless a library of the same source,
    headers and flags exists."""
    src = os.path.join(CSRC_DIR, source)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = f"{os.path.splitext(source)[0]}_{digest.hexdigest()[:12]}"
    lib = os.path.join(BUILD_DIR, f"lib{stem}.so")
    log = os.path.join(BUILD_DIR, f"{stem}.log")
    if os.path.exists(lib):
        return Built(lib, log, 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic publish for concurrent first uses
    return Built(lib, log, seconds)


SOURCES = ("fused_attention_fwd.cu", "fused_attention_bwd.cu",
           "fused_attention_bh.cu")


def _load(source: str, fn_name: str, argtypes: list) -> ctypes.CDLL:
    lib = ctypes.CDLL(build(source).library)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.slt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.slt_cuda_error_string.restype = ctypes.c_char_p
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def fused_attention_library() -> ctypes.CDLL:
    """K1, the fused attention forward (csrc/fused_attention_fwd.cu),
    built on first call and loaded once per process. Arguments: q, k, v,
    bias, o, stats, seeds (pointers), rate, B, Sq, Sk, E, H, scale,
    stream."""
    return _load("fused_attention_fwd.cu", "slt_fused_attention_fwd_f32",
                 [_P] * 7 + [_F] + [_I] * 5 + [_F, _P])


@functools.lru_cache(maxsize=None)
def fused_attention_bwd_library() -> ctypes.CDLL:
    """K2, the fused attention backward (csrc/fused_attention_bwd.cu),
    built on first call and loaded once per process. Arguments: q, k, v,
    bias, dout, stats, seeds (pointers), rate, dq, dk, dv, delta
    (pointers), B, Sq, Sk, E, H, scale, stream."""
    return _load("fused_attention_bwd.cu", "slt_fused_attention_bwd_f32",
                 [_P] * 7 + [_F] + [_P] * 4 + [_I] * 5 + [_F, _P])


@functools.lru_cache(maxsize=None)
def fused_attention_bh_library() -> ctypes.CDLL:
    """K3, the single-head fused attention forward
    (csrc/fused_attention_bh.cu), built on first call and loaded once per
    process. Arguments: q, k, v, bias, o (pointers), BH, Sq, Sk, D,
    scale, stream."""
    return _load("fused_attention_bh.cu", "slt_fused_attention_bh_f32",
                 [_P] * 5 + [_I] * 4 + [_F, _P])
