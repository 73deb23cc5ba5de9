# copied from mxnet_tpu/io_native.py (backend-free); the library comes from _native_build
"""ctypes bindings for the native IO runtime (src/io_native.cc).

Counterpart of ``mxnet_tpu/io_native.py``. The library is compiled on first
use with the system ``g++`` into ``build/torch_native/`` (``_native_build``);
``read_idx`` falls back to a pure-Python parser when no compiler is there,
the readers raise. It is the throughput path (threaded read-ahead off the
GIL), the reference's PrefetcherIter (src/io/iter_prefetcher.h:28).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["available", "NativeRecordIOReader", "NativePrefetchReader", "read_idx"]

_lib = None
_lock = threading.Lock()
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        from ._native_build import build

        path = build("io")
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.mxio_recordio_open.restype = ctypes.c_void_p
        lib.mxio_recordio_open.argtypes = [ctypes.c_char_p]
        lib.mxio_recordio_next.restype = ctypes.c_int
        lib.mxio_recordio_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.mxio_recordio_close.argtypes = [ctypes.c_void_p]
        lib.mxio_prefetch_open.restype = ctypes.c_void_p
        lib.mxio_prefetch_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.mxio_prefetch_next.restype = ctypes.c_int
        lib.mxio_prefetch_next.argtypes = lib.mxio_recordio_next.argtypes
        lib.mxio_prefetch_close.argtypes = [ctypes.c_void_p]
        lib.mxio_free.argtypes = [ctypes.c_void_p]
        lib.mxio_idx_read.restype = ctypes.c_int
        lib.mxio_idx_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class _Reader:
    _OPEN = None
    _NEXT = None
    _CLOSE = None

    def __init__(self, path, *open_args):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        self._handle = getattr(lib, self._OPEN)(path.encode(), *open_args)
        if not self._handle:
            raise IOError("cannot open %s" % path)

    def read(self):
        """Next record as bytes, or None at EOF."""
        data = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_uint64()
        ok = getattr(self._lib, self._NEXT)(self._handle, ctypes.byref(data),
                                            ctypes.byref(size))
        if not ok:
            return None
        try:
            return ctypes.string_at(data, size.value)
        finally:
            self._lib.mxio_free(data)

    def __iter__(self):
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec

    def close(self):
        if self._handle:
            getattr(self._lib, self._CLOSE)(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeRecordIOReader(_Reader):
    """Sequential native reader."""

    _OPEN = "mxio_recordio_open"
    _NEXT = "mxio_recordio_next"
    _CLOSE = "mxio_recordio_close"


class NativePrefetchReader(_Reader):
    """Reader with a background producer thread + bounded queue."""

    _OPEN = "mxio_prefetch_open"
    _NEXT = "mxio_prefetch_next"
    _CLOSE = "mxio_prefetch_close"

    def __init__(self, path, capacity=16):
        super().__init__(path, capacity)


def read_idx(path):
    """Parse an MNIST idx file into a numpy uint8 array (native fast path;
    reference: src/io/iter_mnist.cc LoadImg/LoadLabel)."""
    lib = _load()
    if lib is None:
        return _read_idx_py(path)
    out = ctypes.POINTER(ctypes.c_ubyte)()
    size = ctypes.c_uint64()
    ndim = ctypes.c_int()
    dims = (ctypes.c_int64 * 4)()
    ok = lib.mxio_idx_read(path.encode(), ctypes.byref(out), ctypes.byref(size),
                           ctypes.byref(ndim), dims)
    if not ok:
        raise IOError("cannot parse idx file %s" % path)
    try:
        shape = tuple(dims[i] for i in range(ndim.value))
        arr = np.ctypeslib.as_array(out, shape=(size.value,)).copy()
    finally:
        lib.mxio_free(out)
    return arr.reshape(shape)


def _read_idx_py(path):
    with open(path, "rb") as f:
        magic = f.read(4)
        n = magic[3]
        shape = tuple(int.from_bytes(f.read(4), "big") for _ in range(n))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)
