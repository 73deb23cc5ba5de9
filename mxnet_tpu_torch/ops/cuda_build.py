"""Build and load the port's CUDA kernels.

The sources under ``mxnet_tpu_torch/csrc/`` have a plain C interface. At
first use they are compiled for Hopper (``sm_90a``) with ``nvcc``, one
process per source and all started together, linked into one shared
library under ``build/torch_kernels/`` and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so a changed
source builds a new library and an unchanged one is reused.

Nothing happens at import: this module, like every module of the port,
imports on a host without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..base import MXNetError

__all__ = ["library", "check", "check_operands", "build_library", "CSRC_DIR",
           "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every entry returns a cudaError_t as int
_SIGNATURES = {
    # q, k, v, o, lse, BH, T, S, D, scale, causal, stream
    "mxt_flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, do, lse, delta, dq, BH, T, S, D, scale, causal, stream
    "mxt_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # q, k, v, do, lse, delta, dk, dv, BH, T, S, D, scale, causal, stream
    "mxt_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                    _P),
    # x, gamma, beta, y, mean, rstd, R, D, eps, stream
    "mxt_layer_norm_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # x, gamma, mean, rstd, dy, dx, dgamma_part, dbeta_part, R, D, rows_per_block, stream
    "mxt_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # a, w, bias (or NULL), c, M, N, K, act, stream
    "mxt_matmul_bias_act_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise MXNetError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                     "to build (put nvcc on PATH)")


def build_library() -> Path:
    """Compile the kernels (if the hashed library is missing) and return its path."""
    target = BUILD_DIR / ("libmxnet_tpu_torch_kernels_%s.so" % _digest())
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT)))
        failures = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append("%s:\n%s" % (src.name, out.decode(errors="replace")))
        if failures:
            raise MXNetError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True)
        if link.returncode != 0:
            raise MXNetError("nvcc link failed:\n"
                             + (link.stdout + link.stderr).decode(errors="replace"))
        os.replace(tmp_lib, target)  # atomic: a concurrent builder sees all or nothing
    return target


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.mxt_error_string.argtypes = [ctypes.c_int]
            lib.mxt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_operands(what, *tensors):
    """Raise unless every operand is a contiguous float32 tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise MXNetError("%s: operands must share one CUDA device, got %s and %s"
                             % (what, dev, t.device))
        if t.dtype != torch.float32:
            raise MXNetError("%s: the kernel takes float32, got %s" % (what, t.dtype))
        if not t.is_contiguous():
            raise MXNetError("%s: the kernel takes contiguous tensors" % what)


def check(code, what):
    """Raise if a kernel's launch returned a CUDA error."""
    if code != 0:
        msg = library().mxt_error_string(code).decode(errors="replace")
        raise MXNetError("%s: CUDA launch failed with error %d (%s)" % (what, code, msg))
