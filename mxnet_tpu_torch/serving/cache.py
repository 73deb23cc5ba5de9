"""Per-bucket executable cache.

Counterpart of ``mxnet_tpu/serving/cache.py`` ``PersistentExecutableCache``
(:109): one bound, inference-only executor per input-shape bucket, sharing
one set of parameter and aux-state arrays. After ``seal()`` a lookup for a
shape no warmed bucket covers raises, so a server never binds on the
request path; an unsealed cache (the predict API's open-ended ``reshape``)
binds new shapes at any time and, with ``max_executables``, keeps only the
most recently used. The JAX package compiles at warmup; here warmup runs
one forward, which builds the CUDA kernels at their first launch.

Persistence: the warmed bucket set is written as a JSON manifest under
``{cache_dir}/{device_kind}/{model_key}.json`` (the reference's fields), so
a restarted server warms the same buckets without being told
(``warmup(None)``). There is no counterpart of the reference's
``_enable_xla_persistence``: the port's compiled artefacts are the kernel
library under ``build/torch_kernels/``, which ``ops/cuda_build.py`` already
caches across processes at its first build.

Hot swap: ``swap_params`` writes new weights INTO the shared tensors. The
JAX package's swap is double-buffered because its arrays are immutable;
here the tensors are mutable and a captured megastep graph reads them by
address (``kv_decode._DecodeMegastep``), so the swap validates every value
first, then ``copy_``s all of them under the cache lock, which ``run``
holds until its outputs are read back: no batch sees half a swap, and no
tensor is ever replaced.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError, np_dtype
from ..context import current_context
from .. import telemetry as _tm

__all__ = ["PersistentExecutableCache", "serve_cache_dir"]

log = logging.getLogger("mxnet_tpu_torch.serving")


def serve_cache_dir():
    """The configured on-disk cache root (``MXNET_SERVE_CACHE_DIR``), or
    None when persistence is off (the default)."""
    d = os.environ.get("MXNET_SERVE_CACHE_DIR", "").strip()
    return d or None


def _sanitize(name):
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", str(name))


def _device_kind():
    """The card's name, sanitised as the reference sanitises its device
    kind; ``cpu`` where there is no card."""
    if not torch.cuda.is_available():
        return "cpu"
    return _sanitize(torch.cuda.get_device_name())


def _shape_key(input_shapes):
    return tuple(sorted((str(n), tuple(int(d) for d in s))
                        for n, s in input_shapes.items()))


def _plan_pattern_sites(exe):
    """Static summary of one bound executor's fusion plan (JAX :91): the
    generic-pattern site counts, the conv+BN directive count, and whether
    the conv+BN inference plan is active. The port has no inference gate:
    every planned conv site takes the stats-free kernel in an inference
    forward, so the plan is active wherever it has a conv+BN directive."""
    prog = exe._prog
    return {"pattern_sites": dict(prog.pattern_sites),
            "conv_bn_directives": prog.conv_bn_directives,
            "conv_bn_infer_active": prog.conv_bn_directives > 0}


class PersistentExecutableCache:
    """One grad-less executor per input-shape bucket.

    ``arg_params``/``aux_params`` are {name: numpy array, tensor or NDArray};
    every symbol argument that is not a param is an INPUT whose shape the
    bucket key carries, allocated as float32 like the serving graphs' inputs.
    An aux state (BatchNorm's moving stats) the checkpoint lacks stays zero.
    ``ctx`` defaults to ``gpu(0)`` and is resolved here, so a missing GPU
    raises at construction. ``dtype`` is the compute dtype; the port computes
    in float32 only (the TF32/bf16 decision is a later PR of ROADMAP §2b),
    and any other raises. ``model_key`` names the on-disk manifest (default:
    a digest of the symbol JSON and the dtype, the reference's digest);
    ``cache_dir`` is its root (default ``MXNET_SERVE_CACHE_DIR``; unset: no
    persistence). ``max_executables`` bounds an UNSEALED cache: past it the
    least recently used executor is dropped, so distinct shapes cannot grow
    device memory without limit (None or 0: unbounded; a sealed cache has a
    fixed size and never evicts)."""

    def __init__(self, symbol, arg_params=None, aux_params=None, ctx=None,
                 dtype="float32", model_key=None, cache_dir=None,
                 max_executables=None):
        if str(dtype) != "float32":
            raise MXNetError(
                "serving: dtype %r is not supported yet; the port computes in float32 "
                "until the TF32/bf16 PR (ROADMAP section 2b)" % (dtype,))
        self._sym = symbol
        self._ctx = ctx or current_context()
        self._ctx.torch_device  # raises now if the device is not there
        self._dtype = str(dtype)
        self._arg_params = dict(arg_params or {})
        self._aux_params = dict(aux_params or {})
        # ONE set of parameter and aux arrays shared by every bucket executor
        self._shared_args: Dict[str, object] = {}
        self._shared_aux: Optional[Dict[str, object]] = None
        self._max_exes = int(max_executables or 0) or None
        self._exes: "OrderedDict[tuple, object]" = OrderedDict()
        # per-bucket fusion summaries under their OWN lock: health() reads
        # them, and the main lock is held through a warmup forward
        self._fusion_sites: Dict[tuple, dict] = {}
        self._sites_lock = _tm.named_lock("serving.cache.sites")
        # held by executable(), run() (until its outputs are on the host)
        # and swap_params(): a swap never lands in the middle of a batch
        self._lock = _tm.named_rlock("serving.cache")
        self._sealed = False
        digest = hashlib.sha1((symbol.tojson() + "|" + self._dtype).encode()).hexdigest()[:16]
        self._model_key = _sanitize(model_key or digest)
        self._digest = digest
        self._cache_dir = cache_dir if cache_dir is not None else serve_cache_dir()
        #: executors bound so far (a hit binds nothing)
        self.binds = 0

    @property
    def input_names(self) -> List[str]:
        return [n for n in self._sym.list_arguments() if n not in self._arg_params]

    @property
    def sealed(self):
        return self._sealed

    def keys(self):
        """The bucket keys held now, least recently used first."""
        with self._lock:
            return list(self._exes)

    def _infer_full(self, input_shapes):
        """Shapes and dtypes of everything at these input shapes (the
        params' come from the checkpoint): no bind, no forward."""
        arg_names = set(self._sym.list_arguments())
        shapes = {n: tuple(s) for n, s in input_shapes.items()}
        types = {}
        for n, v in self._arg_params.items():
            if n in arg_names:  # extra checkpoint entries are ignored
                shapes.setdefault(n, tuple(v.shape))
                types[n] = np_dtype(v.dtype)
        for n in shapes:
            types.setdefault(n, np_dtype(self._dtype))
        return self._sym._infer_impl(shapes, types)

    def output_shapes(self, input_shapes) -> List[tuple]:
        """Statically inferred output shapes at these input shapes; safe to
        probe batch sizes that are not buckets."""
        return [tuple(s) for s in self._infer_full(input_shapes)[1]]

    def _bind(self, input_shapes):
        from ..ndarray import zeros

        arg_shapes, _, aux_shapes, arg_types, _, aux_types = self._infer_full(input_shapes)
        inputs = set(self.input_names)
        args = {}
        for n, s, t in zip(self._sym.list_arguments(), arg_shapes, arg_types):
            if n in inputs:  # input slots are per bucket: their shape IS the key
                args[n] = zeros(s, ctx=self._ctx, dtype=t)
                continue
            arr = self._shared_args.get(n)
            if arr is None:
                arr = zeros(s, ctx=self._ctx, dtype=t)
                arr[:] = self._arg_params[n]
                self._shared_args[n] = arr
            args[n] = arr
        if self._shared_aux is None:
            self._shared_aux = {}
            for n, s, t in zip(self._sym.list_auxiliary_states(), aux_shapes, aux_types):
                arr = zeros(s, ctx=self._ctx, dtype=t)
                if n in self._aux_params:
                    arr[:] = self._aux_params[n]
                self._shared_aux[n] = arr
        self.binds += 1
        return self._sym.bind(self._ctx, args, args_grad=None, grad_req="null",
                              aux_states=dict(self._shared_aux))

    def executable(self, input_shapes):
        """The executor for this exact input-shape bucket; before ``seal()`` a
        new bucket is bound and run once, after it a miss raises."""
        key = _shape_key(input_shapes)
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                self._exes.move_to_end(key)
                if _tm.enabled():
                    _tm.counter("serving.executable_hit").inc()
                return exe
            if self._sealed:
                raise MXNetError(
                    "serving: post-warmup executable-cache miss for input shapes %s "
                    "(warmed buckets: %s); a sealed cache never binds on the "
                    "request path" % (dict(input_shapes), [dict(k) for k in self._exes]))
            with _tm.span("serving.compile", model=self._model_key,
                          shapes=str(dict(input_shapes))):
                exe = self._bind(input_shapes)
                exe.forward(is_train=False)
                exe.outputs[0].asnumpy()  # wait for the warmup forward to finish
            with self._sites_lock:
                self._fusion_sites[key] = _plan_pattern_sites(exe)
            if _tm.enabled():
                _tm.counter("serving.executable_compile").inc()
            self._exes[key] = exe
            if self._max_exes and len(self._exes) > self._max_exes:
                old_key, _ = self._exes.popitem(last=False)
                with self._sites_lock:
                    self._fusion_sites.pop(old_key, None)
                log.info("serving: evicted LRU executable %s from %r (cap %d)",
                         dict(old_key), self._model_key, self._max_exes)
                if _tm.enabled():
                    _tm.counter("serving.executable_evict").inc()
            if _tm.enabled():
                _tm.gauge("serving.executables").set(len(self._exes))
            return exe

    def warmup(self, bucket_shapes: Optional[Sequence[dict]] = None, seal=True):
        """Bind and run one executor per bucket ({input_name: shape} dicts);
        None replays the persisted manifest (the restart path). Seals the
        cache (unless ``seal=False``), writes the manifest and returns the
        number of buckets.

        Warming ZERO buckets (no or stale manifest, or an empty list)
        neither seals nor persists: an empty sealed cache would reject every
        request with no way back."""
        if bucket_shapes is None:
            bucket_shapes = self._load_manifest()
        if not bucket_shapes:
            log.warning("serving: warmup(%s) found no buckets for %r; cache left UNSEALED "
                        "(an empty sealed cache would reject every request)",
                        "manifest" if bucket_shapes == [] else bucket_shapes, self._model_key)
            return 0
        with _tm.span("serving.warmup", model=self._model_key, buckets=len(bucket_shapes)):
            for shapes in bucket_shapes:
                self.executable(shapes)
        if seal:
            self.seal()
        self._save_manifest()
        return len(bucket_shapes)

    def seal(self):
        """Freeze the bucket set: from now on any lookup miss raises."""
        self._sealed = True

    def fusion_sites(self):
        """Per-bucket fusion summaries (see ``_plan_pattern_sites``), keyed by
        the bucket's shapes rendered as a dict. Takes only its own lock, so a
        health probe never waits on a warmup."""
        with self._sites_lock:
            return {str(dict(k)): v for k, v in self._fusion_sites.items()}

    # --------------------------------------------------------- persistence
    def _manifest_path(self):
        if not self._cache_dir:
            return None
        return os.path.join(self._cache_dir, _device_kind(), self._model_key + ".json")

    def _save_manifest(self):
        path = self._manifest_path()
        if path is None:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            buckets = [{n: list(s) for n, s in key} for key in self._exes]
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"model_key": self._model_key, "digest": self._digest,
                           "dtype": self._dtype, "device_kind": _device_kind(),
                           "buckets": buckets}, f, indent=1)
            os.replace(tmp, path)
        except OSError as exc:
            log.warning("serving: could not persist manifest %s (%s)", path, exc)

    def _load_manifest(self):
        path = self._manifest_path()
        if path is None or not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError) as exc:
            log.warning("serving: unreadable manifest %s (%s)", path, exc)
            return []
        if rec.get("digest") != self._digest:
            # a different model (or dtype) under the same key: stale
            log.warning("serving: manifest %s digest mismatch (model changed); ignoring",
                        path)
            return []
        return [{n: tuple(s) for n, s in b.items()} for b in rec.get("buckets", [])]

    # ------------------------------------------------------------ hot swap
    @staticmethod
    def _host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.array(v.asnumpy() if hasattr(v, "asnumpy") else v)

    def snapshot_params(self, arg_names=None, aux_names=None):
        """Host copies of the named (default: all) loaded arg and aux
        params, consistent under the swap lock: the snapshot a rollback
        restores. Unknown names are skipped (``swap_params`` would refuse
        them before writing anything). Returns ``(arg_params, aux_params)``."""
        with self._lock:
            args = {n: self._host(self._arg_params[n])
                    for n in (self._arg_params if arg_names is None else arg_names)
                    if n in self._arg_params}
            aux = {n: self._host(self._aux_params[n])
                   for n in (self._aux_params if aux_names is None else aux_names)
                   if n in self._aux_params}
        return args, aux

    @classmethod
    def _swap_value(cls, name, value, target, what):
        """Validate ONE incoming value against its target: the shape must
        match exactly and the value must cast to the target's dtype. Both
        happen here, before anything is written, so the write loop cannot
        fail halfway and leave a mix of old and new weights."""
        host = cls._host(value)
        want = tuple(target.shape)
        if tuple(host.shape) != want:
            raise MXNetError(
                "serving: swap_params shape mismatch for %r: got %s, %s has %s; a "
                "reshape would rebind, reload refused" % (name, tuple(host.shape), what, want))
        dtype = np_dtype(target.dtype)
        try:
            return np.ascontiguousarray(host, dtype=dtype)
        except (TypeError, ValueError) as exc:
            raise MXNetError(
                "serving: swap_params value for %r is not castable to the bound dtype %s "
                "(%s); reload refused" % (name, dtype.name, exc)) from exc

    def swap_params(self, arg_params, aux_params=None):
        """Hitless weight swap: write new values into the SHARED parameter
        and aux tensors every bucket executor reads, in place. Every key,
        shape and cast is checked first; a mismatch raises before anything
        is written. Then each tensor takes its value by ``copy_`` under the
        cache lock, so the swap lands between two batches, and no tensor is
        replaced: a megastep's CUDA graph, which reads the weights by
        address, sees the new values at its next replay without a new
        capture. Keys absent from ``arg_params`` keep their values (partial
        swaps are legal). Returns the number of values written."""
        with self._lock:
            input_names = set(self.input_names)
            updates = []
            for store, incoming, src, what in (
                    (self._shared_args, arg_params or {}, self._arg_params, "argument"),
                    (self._shared_aux, aux_params or {}, self._aux_params, "aux state")):
                for n, v in incoming.items():
                    if n in input_names:
                        raise MXNetError(
                            "serving: swap_params(%r) names a model INPUT, not a parameter"
                            % n)
                    cur = (store or {}).get(n)
                    if cur is None:
                        # not bound yet (a swap before warmup): stage it in
                        # the source dict, which the first bind reads
                        if n not in src:
                            raise MXNetError(
                                "serving: swap_params got unknown %s %r (loaded params: "
                                "%s...)" % (what, n, sorted(src)[:8]))
                        updates.append((None, self._swap_value(
                            n, v, self._host(src[n]), "the loaded checkpoint"), n, src))
                        continue
                    updates.append((cur, self._swap_value(n, v, cur, "the loaded model"),
                                    n, src))
            # every key validated: now write, all of them
            for cur, host, n, src in updates:
                if cur is not None:
                    cur._tensor().copy_(torch.from_numpy(host))
                src[n] = host  # the source dict stays what a later bind reads
        return len(updates)

    # ------------------------------------------------------------- running
    def run(self, inputs: Dict[str, np.ndarray]):
        """One batch through the bucket executable matching the inputs'
        exact shapes. Returns the outputs as numpy arrays. Holds the cache
        lock until they are on the host, so a swap waits for the batch."""
        with self._lock:
            exe = self.executable({n: tuple(np.shape(v)) for n, v in inputs.items()})
            for n, v in inputs.items():
                exe.arg_dict[n][:] = v
            exe.forward(is_train=False)
            return [o.asnumpy() for o in exe.outputs]
