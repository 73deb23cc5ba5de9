"""Build and load the port's CUDA kernels.

The sources under ``mxnet_tpu_torch/csrc/`` have a plain C interface. At
first use they are compiled for Hopper (``sm_90a``) with ``nvcc``, one
process per source and all started together, linked into one shared
library under ``build/torch_kernels/`` and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so a changed
source builds a new library and an unchanged one is reused.

For ``mx.rtc`` the module also compiles a user's CUDA source at run time
(``compile_cubin``: ``nvcc -cubin`` for ``sm_90a``, cached under
``build/torch_kernels/rtc/`` by a hash of source and flags) and binds the
four ``libcuda`` calls that load and launch such an image
(``load_function``, ``launch_function``: ``cuModuleLoadData``,
``cuModuleGetFunction``, ``cuLaunchKernel`` from ``libcuda`` through
``ctypes``).

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
           "BUILD_DIR", "RTC_DIR", "compile_cubin", "load_function", "launch_function"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

RTC_DIR = BUILD_DIR / "rtc"

_ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = _ARCH_FLAGS + ("-Xcompiler", "-fPIC")
#: a device image for the card itself: a cubin loads under any ``libcuda`` that
#: runs the card, PTX would need one as new as the toolkit
RTC_FLAGS = _ARCH_FLAGS + ("-cubin",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every entry returns a cudaError_t as int
_SIGNATURES = {
    # q, k, v, o, lse, blocks, nblocks, BH, T, S, D, scale, causal, stream
    "mxt_flash_attention_fwd": (_P,) * 6 + (_I,) * 5 + (_F, _I, _P),
    # q, k, v, do, lse, delta, dq, blocks, nblocks, BH, T, S, D, scale, causal, stream
    "mxt_flash_attention_bwd_dq": (_P,) * 8 + (_I,) * 5 + (_F, _I, _P),
    # q, k, v, do, lse, delta, dk, dv, blocks, nblocks, BH, T, S, D, scale, causal, stream
    "mxt_flash_attention_bwd_dkv": (_P,) * 9 + (_I,) * 5 + (_F, _I, _P),
    # x, gamma, beta, y, mean, rstd, R, D, rows_per_warp, eps, stream
    "mxt_layer_norm_fwd": (_P,) * 6 + (_I, _I, _I, _F, _P),
    # x, gamma, mean, rstd, dy, dx, part, sums (dgamma; dbeta), R, D, rows_per_block, stream
    "mxt_layer_norm_bwd": (_P,) * 8 + (_I,) * 3 + (_P,),
    # a, w, bias (or NULL), c, M, N, K, act, schedule, stream
    "mxt_matmul_bias_act_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, scale, shift, res, c, part, sums (the last five or NULL), B, K, H, W, N, taps,
    # stride, relu, parts, stream
    "mxt_conv_bn_fwd": (_P,) * 8 + (_I,) * 9 + (_P,),
    # x, w, scale, shift, c, dc, ds, dq, dx, dw, dw_part, dss, dss_part, dce, wt, B, K, H, W,
    # N, taps, stride, relu, parts, splits, stream
    "mxt_conv_bn_bwd": (_P,) * 15 + (_I,) * 10 + (_P,),
    # a, b, c, part, sums, M, K, N, layout, groups, stream
    "mxt_matmul_stats_fwd": (_P,) * 5 + (_I,) * 5 + (_P,),
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


# ------------------------------------------------- run-time compilation (mx.rtc)
def compile_cubin(source: str, name: str):
    """Compile a CUDA translation unit to an ``sm_90a`` cubin. Returns
    ``(image bytes, compiled)``: ``compiled`` is False when the image was
    found under ``RTC_DIR`` (same source, same flags) and nvcc did not run.
    A compile error raises ``MXNetError`` with the compiler's output."""
    digest = hashlib.sha256((" ".join(RTC_FLAGS) + "\0" + source).encode()).hexdigest()[:16]
    safe = "".join(ch if ch.isalnum() else "_" for ch in name)[:40]
    target = RTC_DIR / ("%s_%s.cubin" % (safe, digest))
    if target.exists():
        return target.read_bytes(), False
    nvcc = _nvcc()
    RTC_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=RTC_DIR) as tmp:
        src, out = Path(tmp) / (safe + ".cu"), Path(tmp) / target.name
        src.write_text(source)
        res = subprocess.run([nvcc, *RTC_FLAGS, "-o", str(out), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise MXNetError("rtc: nvcc failed to compile %r:\n%s"
                             % (name, res.stdout.decode(errors="replace")))
        os.replace(out, target)
    return target.read_bytes(), True


_cu = None


def _libcuda():
    """``libcuda`` with the argument types of the calls the port makes."""
    global _cu
    with _lock:
        if _cu is None:
            try:
                drv = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise MXNetError("rtc: libcuda.so.1 is not there (%s)" % e) from e
            pp = ctypes.POINTER(ctypes.c_void_p)
            u = ctypes.c_uint
            for fn, argtypes in (
                    ("cuCtxGetCurrent", [pp]),
                    ("cuDevicePrimaryCtxRetain", [pp, _I]),
                    ("cuCtxSetCurrent", [_P]),
                    ("cuModuleLoadData", [pp, ctypes.c_char_p]),
                    ("cuModuleGetFunction", [pp, _P, ctypes.c_char_p]),
                    ("cuLaunchKernel", [_P, u, u, u, u, u, u, u, _P, pp, pp]),
                    ("cuGetErrorName", [_I, ctypes.POINTER(ctypes.c_char_p)])):
                f = getattr(drv, fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
            _cu = drv
        return _cu


def _cu_check(code, what):
    if code != 0:
        name = ctypes.c_char_p()
        _libcuda().cuGetErrorName(code, ctypes.byref(name))
        raise MXNetError("rtc: %s failed with CUDA error %d (%s)"
                         % (what, code, (name.value or b"?").decode()))


def load_function(image: bytes, kernel_name: str, device: torch.device):
    """Load a cubin into ``device``'s primary context (torch's own) and
    return ``(module, function)`` handles. The module stays loaded for the
    life of the process."""
    drv = _libcuda()
    with torch.cuda.device(device):
        torch.cuda.current_stream(device)  # torch creates the context and makes it current
        ctx = ctypes.c_void_p()
        _cu_check(drv.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
        if not ctx.value:  # no context current on this thread: take the primary one
            _cu_check(drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), device.index or 0),
                          "cuDevicePrimaryCtxRetain")
            _cu_check(drv.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
        module, function = ctypes.c_void_p(), ctypes.c_void_p()
        _cu_check(drv.cuModuleLoadData(ctypes.byref(module), image), "cuModuleLoadData")
        _cu_check(drv.cuModuleGetFunction(ctypes.byref(function), module,
                                              kernel_name.encode()),
                      "cuModuleGetFunction(%r)" % kernel_name)
    return module, function


def launch_function(function, grid, block, pointers, device: torch.device):
    """Enqueue ``function<<<grid, block>>>(*pointers)`` on torch's current
    stream of ``device``; raises unless ``cuLaunchKernel`` accepts the launch."""
    # kernelParams: an array of pointers, each to one argument's value
    values = [ctypes.c_void_p(p) for p in pointers]
    params = (ctypes.c_void_p * len(values))(*[ctypes.addressof(v) for v in values])
    with torch.cuda.device(device):
        code = _libcuda().cuLaunchKernel(
            function, *grid, *block, 0, torch.cuda.current_stream(device).cuda_stream,
            params, None)
    _cu_check(code, "cuLaunchKernel")
