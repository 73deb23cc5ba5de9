"""Compile-if-stale for the port's host libraries.

Counterpart of ``mxnet_tpu/_native_build.py``. The native runtime's C++
pieces are compiled with the system ``g++`` on first use: the engine, the
RecordIO reader and the image pipeline from ``src/`` (backend-free C++ the
two packages share), and the C training and predict ABIs from
``mxnet_tpu_torch/csrc/host/`` (the port's copies, which embed CPython and
call into this package). Every library lands in ``build/torch_native/``, so
the port's builds never race the JAX package's ``build/libmxtpu_*.so``.

A library is rebuilt when it is missing, when its source or a header it
names is newer than it, or when its compile command changed (another
Python, other flags): the command is kept beside the library in
``<lib>.cmd``. The publish is atomic (a temporary file, then
``os.replace``), so a concurrent process never loads a half-written
library. Without a compiler, or when the compile fails, ``build_lib``
returns None (the callers then take their pure-Python paths), or raises
with the compiler's message when asked to.

``LIBS`` names the five libraries; ``build(name)`` is what every module
(and ``chip_smoke.py``) calls, so all of them compile with one command.
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
import threading

from .base import MXNetError

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
_HOST_DIR = os.path.join(_ROOT, "mxnet_tpu_torch", "csrc", "host")


def source_path(name):
    """A backend-free source of ``src/`` (engine, io, image)."""
    return os.path.join(_ROOT, "src", name)


def host_source_path(name):
    """One of the port's own host sources (``csrc/host/``)."""
    return os.path.join(_HOST_DIR, name)


def lib_file(libname):
    return os.path.join(_BUILD_DIR, libname)


def missing_headers(headers):
    """The names in ``headers`` the system compiler cannot include (all of
    them when there is no ``g++``)."""
    missing = []
    for h in headers:
        try:
            r = subprocess.run(["g++", "-x", "c++", "-E", "-o", os.devnull, "-"],
                               input="#include <%s>\n" % h, capture_output=True, text=True,
                               timeout=120)
            ok = r.returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            ok = False
        if not ok:
            missing.append(h)
    return missing


def _stale(out, cmd, deps):
    if not os.path.isfile(out) or not os.path.isfile(out + ".cmd"):
        return True
    with open(out + ".cmd") as f:
        if f.read() != cmd:
            return True
    built = os.path.getmtime(out)
    return any(os.path.isfile(d) and os.path.getmtime(d) > built for d in deps)


def build_lib(src, libname, extra_flags=(), opt="-O2", force=False, deps=(), raise_errors=False):
    """Compile ``src`` (absolute path) into ``build/torch_native/<libname>``
    if stale and return its path; None when the toolchain or the compile
    fails, unless ``raise_errors``, which raises ``MXNetError`` with the
    compiler's message. ``deps`` are headers whose edits rebuild too;
    ``force`` rebuilds whatever the checks say."""
    out = lib_file(libname)
    compiler = ["g++", "-std=c++17", opt, "-shared", "-fPIC", "-pthread"]
    cmd = " ".join(compiler + [src] + list(extra_flags))
    if not force and not _stale(out, cmd, [src] + list(deps)):
        return out
    tmp = "%s.%d.tmp" % (out, os.getpid())
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        r = subprocess.run(compiler + [src, "-o", tmp] + list(extra_flags),
                           capture_output=True, text=True)
    except OSError as e:
        if raise_errors:
            raise MXNetError("cannot build %s: %s" % (libname, e)) from e
        return None
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        if raise_errors:
            raise MXNetError("g++ failed to build %s from %s:\n%s"
                             % (libname, src, r.stderr[-2000:]))
        return None
    os.replace(tmp, out)
    tmp_cmd = "%s.cmd.%d.tmp" % (out, os.getpid())
    with open(tmp_cmd, "w") as f:
        f.write(cmd)
    os.replace(tmp_cmd, out + ".cmd")
    return out


def _python_flags():
    """Flags that link an embedded CPython (the C ABIs): the headers, the
    shared libpython and its directory on the run path."""
    libdir = sysconfig.get_config_var("LIBDIR")
    return ["-I", sysconfig.get_paths()["include"], "-L", libdir,
            "-l", "python%d.%d" % sys.version_info[:2], "-Wl,-rpath," + libdir]


#: name -> (source, library, extra flags, optimisation, headers its edits rebuild,
#: system headers it needs)
LIBS = {
    "engine": (source_path("engine_native.cc"), "libmxtpu_engine.so", (), "-O2", (), ()),
    "io": (source_path("io_native.cc"), "libmxtpu_io.so", (), "-O2", (), ()),
    "image": (source_path("image_native.cc"), "libmxtpu_image.so", ("-ljpeg", "-lpng"), "-O3",
              (), ("jpeglib.h", "png.h")),
    "c_api": (host_source_path("c_api.cc"), "libmxtpu_c.so", None, "-O2",
              (host_source_path("embed_runtime.h"),), ()),
    "predict": (host_source_path("predict_api.cc"), "libmxtpu_predict.so", None, "-O2",
                (host_source_path("embed_runtime.h"),), ()),
}
_locks = {name: threading.Lock() for name in LIBS}


def build(name, force=False, raise_errors=False):
    """Build (if stale) the library ``name`` of ``LIBS`` and return its path,
    or None (see ``build_lib``)."""
    src, libname, flags, opt, deps, _ = LIBS[name]
    with _locks[name]:
        return build_lib(src, libname, _python_flags() if flags is None else flags, opt=opt,
                         force=force, deps=deps, raise_errors=raise_errors)


def missing_prerequisites(name):
    """The system headers library ``name`` needs that the compiler lacks."""
    return missing_headers(LIBS[name][5])
