# copied from mxnet_tpu/image_native.py (backend-free); the library comes from _native_build
"""ctypes bindings for the native image pipeline (src/image_native.cc).

Counterpart of ``mxnet_tpu/image_native.py``. The C++ pipeline (threaded
libjpeg/libpng decode, augment and batch, off the GIL; reference:
src/io/iter_image_recordio_2.cc:559) is compiled on first use into
``build/torch_native/`` (``_native_build``; it needs libjpeg's and
libpng's headers and libraries). ``ImageRecordIter`` uses it when the
requested augmentation set is expressible natively, and the Python path
(cv2 or PIL) otherwise, or when ``MXNET_NATIVE_IMAGE_PIPELINE=0``.

The pipeline writes each batch into host buffers the caller may hand it
(``next_batch_into``): ``ImageRecordIter`` gives it page-locked tensors
and copies them to the card without blocking (``image._HostStaging``).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

__all__ = ["available", "NativeImagePipeline"]

_lib = None
_lock = threading.Lock()
_build_failed = False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        from ._native_build import build

        path = build("image")
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.mximg_open.restype = ctypes.c_void_p
        lib.mximg_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_ulonglong]
        lib.mximg_file_error.restype = ctypes.c_int
        lib.mximg_file_error.argtypes = [ctypes.c_void_p]
        lib.mximg_next_batch.restype = ctypes.c_int
        lib.mximg_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.mximg_next_batch_aug.restype = ctypes.c_int
        lib.mximg_next_batch_aug.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        lib.mximg_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.mximg_decode_errors.restype = ctypes.c_long
        lib.mximg_decode_errors.argtypes = [ctypes.c_void_p]
        lib.mximg_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    return (os.environ.get("MXNET_NATIVE_IMAGE_PIPELINE", "1") != "0"
            and _load() is not None)


class NativeImagePipeline:
    """Batches of decoded+augmented CHW float32 images from a .rec file,
    produced entirely in C++ worker threads."""

    def __init__(self, path, batch_size, data_shape, num_workers=4,
                 resize=0, rand_crop=False, rand_mirror=False,
                 mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), label_width=1,
                 shuffle_buf=0, seed=0, idx_path=None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native image pipeline unavailable")
        c, h, w = data_shape
        if c != 3:
            raise ValueError("native pipeline is RGB-only (C=3)")
        self._lib = lib
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._epoch = 0
        self._handle = lib.mximg_open(
            path.encode(), (idx_path or "").encode(), num_workers,
            batch_size, h, w, resize,
            int(bool(rand_crop)), int(bool(rand_mirror)),
            mean[0], mean[1], mean[2], std[0], std[1], std[2],
            label_width, shuffle_buf, seed)
        if not self._handle:
            raise IOError("cannot open %r" % path)
        self._data = np.empty((batch_size, c, h, w), np.float32)
        self._labels = np.empty((batch_size, label_width), np.float32)
        self._aug = np.empty((batch_size, 6), np.float32)

    def next_batch(self, with_aug=False):
        """(data, labels, n) — n < batch_size marks the epoch's tail; n == 0
        means exhausted. With ``with_aug``: (data, labels, aug, n) where aug
        is (batch, 6) float {pre-crop W, pre-crop H, crop x0, crop y0,
        mirror, true label length} per sample — the geometry a bbox-aware
        consumer (ImageDetIter) needs to transform detection labels. The
        returned arrays are reused between calls. Raises on mid-file
        corruption (the Python reader's invalid-magic contract)."""
        dp = self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        lp = self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if with_aug:
            n = self._lib.mximg_next_batch_aug(
                self._handle, dp, lp,
                self._aug.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            n = self._lib.mximg_next_batch(self._handle, dp, lp)
        if self._lib.mximg_file_error(self._handle):
            raise IOError("invalid RecordIO framing mid-file (corrupt .rec)")
        if with_aug:
            return self._data, self._labels, self._aug, int(n)
        return self._data, self._labels, int(n)

    def next_batch_into(self, data, labels):
        """As ``next_batch``, but the pipeline writes the batch into the
        caller's numpy arrays ``data`` (batch, C, H, W) and ``labels``
        (batch, label_width), float32 and C-contiguous (``image.py`` hands
        it views of page-locked buffers), and returns ``n``."""
        for buf, want in ((data, (self.batch_size,) + self.data_shape),
                          (labels, (self.batch_size, self.label_width))):
            if buf.shape != want or buf.dtype != np.float32 or not buf.flags.c_contiguous:
                raise ValueError("next_batch_into: want a C-contiguous float32 array of "
                                 "shape %s, got %s %s" % (want, buf.shape, buf.dtype))
        n = self._lib.mximg_next_batch(
            self._handle, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if self._lib.mximg_file_error(self._handle):
            raise IOError("invalid RecordIO framing mid-file (corrupt .rec)")
        return int(n)

    def reset(self):
        self._epoch += 1
        self._lib.mximg_reset(self._handle, self._epoch)

    @property
    def decode_errors(self):
        return int(self._lib.mximg_decode_errors(self._handle))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.mximg_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
