# copied from mxnet_tpu/engine.py (backend-free); the library comes from _native_build
"""Execution engine: variable-dependency scheduling of host-side work.

Counterpart of ``mxnet_tpu/engine.py`` (reference: include/mxnet/engine.h
``NewVariable``/``Push``/``WaitForVar``/``WaitForAll``, with the
ThreadedEnginePerDevice / ThreadedEngine / NaiveEngine policies selected by
``MXNET_ENGINE_TYPE``, src/engine/engine.cc:13-39). On the card, CUDA
streams already do the reference engine's device job (ordering, overlap),
so this engine schedules host-side stages: checkpoint writes
(``model.save_checkpoint``), IO and callbacks. ``nd.waitall`` synchronises
the card and then drains it.

Backends:
  * ``ThreadedEngine`` / ``ThreadedEnginePerDevice``: the native C++
    scheduler (``src/engine_native.cc``, built by ``_native_build``) through
    ctypes; a pure-Python thread pool with the same semantics when no
    compiler exists.
  * ``NaiveEngine``: run-on-push, single-threaded, deterministic.

Each push ticks the ``engine.push`` counter; waits are ``engine.wait_for_var``
and ``engine.wait_for_all`` spans (``telemetry``), and under tracing each op
runs inside an ``engine.op`` span.

Example::

    eng = mx.engine.get()
    v = eng.new_variable()
    eng.push(load_shard, const_vars=[], mutable_vars=[v])
    eng.push(lambda: consume(), const_vars=[v], mutable_vars=[])
    eng.wait_for_var(v)
"""
from __future__ import annotations

import ctypes
import os
import threading

from .base import MXNetError
from . import telemetry as _tm

__all__ = ["Engine", "NaiveEngine", "ThreadedEngine", "get", "set_engine_type"]


def _traced_op(fn, backend):
    """Wrap a pushed op so its execution shows up as an ``engine.op`` span
    (the reference profiler's per-op start/end stamps, profiler.cc). Only
    called when telemetry tracing is on — the off path pushes ``fn``
    untouched."""
    name = getattr(fn, "__name__", "op")

    def run():
        with _tm.span("engine.op", op=name, backend=backend):
            fn()

    return run


_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        from ._native_build import build

        path = build("engine")
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        lib.mxeng_create.restype = ctypes.c_void_p
        lib.mxeng_create.argtypes = [ctypes.c_int]
        lib.mxeng_new_var.restype = ctypes.c_int64
        lib.mxeng_new_var.argtypes = [ctypes.c_void_p]
        lib.mxeng_push.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.mxeng_wait_for_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mxeng_wait_for_all.argtypes = [ctypes.c_void_p]
        lib.mxeng_pending.restype = ctypes.c_int64
        lib.mxeng_pending.argtypes = [ctypes.c_void_p]
        lib.mxeng_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


_OPFN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _unknown_var_error(var):
    """``wait_for_var`` on a var this engine never issued nor saw in a push
    is an error (the native scheduler would make up an idle var for any
    id and return at once)."""
    return MXNetError(
        "wait_for_var: unknown engine variable %r — never created by "
        "new_variable() nor used by any push on this engine, so waiting on "
        "it is undefined. Note: vars do not survive set_engine_type(); this "
        "check is best-effort and a stale id can still alias a var the new "
        "engine issued, so callers holding vars across a swap must compare "
        "engine identity themselves (as model.py's checkpoint vars do)."
        % (var,))


class Engine:
    """Engine interface (reference: include/mxnet/engine.h Engine)."""

    def new_variable(self):
        raise NotImplementedError

    def push(self, fn, const_vars=(), mutable_vars=()):
        """Schedule ``fn()`` to run once all pending writes of ``const_vars``
        and all pending ops of ``mutable_vars`` drain."""
        raise NotImplementedError

    def wait_for_var(self, var):
        """Block until every pending op touching ``var`` drains. Raises
        ``MXNetError`` if ``var`` was never created by (or pushed through)
        this engine."""
        raise NotImplementedError

    def wait_for_all(self):
        raise NotImplementedError


class NaiveEngine(Engine):
    """Synchronous run-on-push engine (reference: src/engine/naive_engine.cc;
    the §5.2 debug mode — deterministic, single-threaded, gdb-able)."""

    def __init__(self):
        self._next = 1
        # FOREIGN var ids only (not issued by new_variable) — issued ids are
        # covered by the 1.._next watermark, so this set stays empty in
        # normal use and never grows per batch
        self._pushed = set()

    def new_variable(self):
        v = self._next
        self._next += 1
        return v

    def push(self, fn, const_vars=(), mutable_vars=()):
        if _tm.enabled():
            _tm.counter("engine.push").inc()
            if _tm.tracing():
                fn = _traced_op(fn, "naive")
        for v in (*const_vars, *mutable_vars):
            if not (isinstance(v, int) and 1 <= v < self._next):
                self._pushed.add(v)
        fn()

    def wait_for_var(self, var):
        if not (isinstance(var, int) and 1 <= var < self._next) \
                and var not in self._pushed:
            raise _unknown_var_error(var)
        _tm.event("engine.wait_for_var", backend="naive")

    def wait_for_all(self):
        _tm.event("engine.wait_for_all", backend="naive")


class ThreadedEngine(Engine):
    """Native C++ threaded var-dependency scheduler (src/engine_native.cc),
    with a Python-threads fallback (reference: threaded_engine_perdevice.cc;
    ``MXNET_CPU_WORKER_NTHREADS`` sets the pool size)."""

    def __init__(self, num_workers=None):
        if num_workers is None:
            num_workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "4"))
        self._num_workers = num_workers
        self._lib = _load_lib()
        self._keep = {}  # op id -> ctypes thunk keepalive
        self._keep_lock = threading.Lock()
        self._next_op = 1
        self._errors = []
        self._done = []  # completed op ids whose thunks can be purged
        # native ids are sequential from 1 (src/engine_native.cc next_var_),
        # so issued vars are covered by a watermark; only FOREIGN ids seen in
        # pushes need a set — empty in normal use, never grows per batch
        self._max_issued = 0
        self._foreign_vars = set()
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.mxeng_create(num_workers))
        else:
            self._py = _PythonThreadedEngine(num_workers)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def new_variable(self):
        if self._lib is None:
            return self._py.new_variable()
        v = self._lib.mxeng_new_var(self._handle)
        if v > self._max_issued:
            self._max_issued = v
        return v

    def push(self, fn, const_vars=(), mutable_vars=()):
        if _tm.enabled():
            _tm.counter("engine.push").inc()
            if _tm.tracing():
                fn = _traced_op(fn, "native" if self._lib is not None
                                else "python")
        if self._lib is None:
            return self._py.push(fn, const_vars, mutable_vars)
        for v in (*const_vars, *mutable_vars):
            if not (isinstance(v, int) and 1 <= v <= self._max_issued):
                self._foreign_vars.add(v)
        with self._keep_lock:
            op_id = self._next_op
            self._next_op += 1

        def trampoline(_):
            try:
                fn()
            except BaseException as e:  # surfaced on wait_for_all
                self._errors.append(e)
            finally:
                self._done.append(op_id)  # purged later, NOT freed mid-call

        cb = _OPFN(trampoline)
        with self._keep_lock:
            self._keep[op_id] = cb  # keep the ctypes thunk alive until done
            # NOTE: thunks are purged only in wait_for_all — an id lands in
            # _done before its native closure frame fully unwinds, so purging
            # here could free a closure a preempted worker thread is still
            # returning through
        carr = (ctypes.c_int64 * len(const_vars))(*const_vars)
        marr = (ctypes.c_int64 * len(mutable_vars))(*mutable_vars)
        self._lib.mxeng_push(self._handle, ctypes.cast(cb, ctypes.c_void_p),
                             None, carr, len(const_vars), marr, len(mutable_vars))

    def wait_for_var(self, var):
        if self._lib is None:
            return self._py.wait_for_var(var)
        if not (isinstance(var, int) and 1 <= var <= self._max_issued) \
                and var not in self._foreign_vars:
            # the native GetVar would silently conjure a fresh idle Var for
            # any int64 — return-immediately on a typo'd id. Fail loudly.
            raise _unknown_var_error(var)
        with _tm.span("engine.wait_for_var", backend="native"):
            self._lib.mxeng_wait_for_var(self._handle, var)
        self._raise_pending()

    def wait_for_all(self):
        if self._lib is None:
            return self._py.wait_for_all()
        with _tm.span("engine.wait_for_all", backend="native"):
            self._lib.mxeng_wait_for_all(self._handle)
        with self._keep_lock:
            # every op drained and its callback fully returned — purge all
            while self._done:
                self._keep.pop(self._done.pop(0), None)
        self._raise_pending()

    def _raise_pending(self):
        if self._errors:
            err = self._errors[:]
            del self._errors[:]
            raise MXNetError("engine op failed: %r" % (err[0],)) from err[0]

    def __del__(self):
        try:
            if self._lib is not None and self._handle:
                self._lib.mxeng_wait_for_all(self._handle)
                self._lib.mxeng_destroy(self._handle)
                self._handle = None
        except Exception:
            pass


class _PythonThreadedEngine(Engine):
    """GIL-bound fallback with identical semantics (used when g++ is absent)."""

    def __init__(self, num_workers):
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(num_workers)
        self._cond = threading.Condition()
        self._var_queues = {}  # var -> list of (op_id, is_write)
        self._running = {}     # var -> [readers, writer_flag]
        self._pending = 0
        self._next = 1
        self._ops = {}         # op_id -> (fn, const, mut)
        self._errors = []

    def new_variable(self):
        with self._cond:
            v = self._next
            self._next += 1
            self._var_queues[v] = []
            self._running[v] = [0, False]
            return v

    def push(self, fn, const_vars=(), mutable_vars=()):
        mutable_vars = list(dict.fromkeys(mutable_vars))
        const_vars = [v for v in dict.fromkeys(const_vars) if v not in mutable_vars]
        with self._cond:
            op_id = self._next
            self._next += 1
            self._ops[op_id] = (fn, const_vars, mutable_vars)
            self._pending += 1
            for v in const_vars:
                self._var_queues.setdefault(v, []).append((op_id, False))
            for v in mutable_vars:
                self._var_queues.setdefault(v, []).append((op_id, True))
            self._try_claim(op_id)

    def _eligible(self, vid, op_id, is_write):
        readers, writer = self._running.setdefault(vid, [0, False])
        if writer:
            return False
        if is_write and readers > 0:
            return False
        for qid, qwrite in self._var_queues.setdefault(vid, []):
            if qid == op_id:
                return True
            if is_write or qwrite:
                return False
        return False

    def _try_claim(self, op_id):
        fn, const_vars, mutable_vars = self._ops[op_id]
        for v in const_vars:
            if not self._eligible(v, op_id, False):
                return
        for v in mutable_vars:
            if not self._eligible(v, op_id, True):
                return
        for v in const_vars:
            self._running[v][0] += 1
            self._var_queues[v].remove((op_id, False))
        for v in mutable_vars:
            self._running[v][1] = True
            self._var_queues[v].remove((op_id, True))
        self._pool.submit(self._run, op_id)

    def _run(self, op_id):
        fn, const_vars, mutable_vars = self._ops[op_id]
        try:
            fn()
        except BaseException as e:
            with self._cond:
                self._errors.append(e)
        with self._cond:
            for v in const_vars:
                self._running[v][0] -= 1
            for v in mutable_vars:
                self._running[v][1] = False
            del self._ops[op_id]
            self._pending -= 1
            for v in const_vars + mutable_vars:
                for qid, qwrite in list(self._var_queues.get(v, [])):
                    self._try_claim(qid)
                    if qwrite:
                        break
            self._cond.notify_all()

    def wait_for_var(self, var):
        with _tm.span("engine.wait_for_var", backend="python"), self._cond:
            if var not in self._var_queues:
                # neither new_variable() nor any push registered this id —
                # the old behavior (return immediately) silently "succeeded"
                # on typo'd/stale vars
                raise _unknown_var_error(var)
            self._cond.wait_for(
                lambda: not self._var_queues.get(var)
                and self._running.get(var, [0, False]) == [0, False])
            self._raise_pending()

    def wait_for_all(self):
        with _tm.span("engine.wait_for_all", backend="python"), self._cond:
            self._cond.wait_for(lambda: self._pending == 0)
            self._raise_pending()

    def _raise_pending(self):
        if self._errors:
            err = self._errors[:]
            del self._errors[:]
            raise MXNetError("engine op failed: %r" % (err[0],)) from err[0]


_engine = None
_engine_lock = threading.Lock()


def get() -> Engine:
    """The process engine, selected by ``MXNET_ENGINE_TYPE`` (reference:
    src/engine/engine.cc CreateEngine; default ThreadedEnginePerDevice)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = _create(os.environ.get("MXNET_ENGINE_TYPE",
                                             "ThreadedEnginePerDevice"))
        return _engine


def set_engine_type(name: str) -> Engine:
    """Swap the process engine (waits for the old one to drain)."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.wait_for_all()
        _engine = _create(name)
        return _engine


def _create(name: str) -> Engine:
    if name == "NaiveEngine":
        return NaiveEngine()
    if name in ("ThreadedEngine", "ThreadedEnginePerDevice"):
        return ThreadedEngine()
    raise MXNetError("unknown MXNET_ENGINE_TYPE %r" % name)
