# copied from mxnet_tpu/libinfo.py (backend-free); the port's libraries are under build/torch_native
"""Locate the native libraries and report the version (reference:
python/mxnet/libinfo.py find_lib_path/__version__: there it found
libmxnet.so; here the native artifacts are the engine, IO, image, C
training and predict libraries ``_native_build`` compiles into
``build/torch_native/``)."""
from __future__ import annotations

import os

from . import __version__  # noqa: F401  (single source of truth: __init__)
from ._native_build import LIBS, _BUILD_DIR

__all__ = ["find_lib_path", "__version__"]

_NATIVE_LIBS = tuple(spec[1] for spec in LIBS.values())


def find_lib_path():
    """Paths of every built native library (possibly empty: the Python
    stack runs without them; they are accelerators, not prerequisites)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [_BUILD_DIR,
                  os.path.join(root, "lib"),
                  os.environ.get("MXNET_LIBRARY_PATH", "")]
    found = []
    for d in candidates:
        if not d or not os.path.isdir(d):
            continue
        for name in _NATIVE_LIBS:
            p = os.path.join(d, name)
            if os.path.exists(p) and p not in found:
                found.append(p)
    return found
