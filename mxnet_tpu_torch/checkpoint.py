"""Sharded asynchronous checkpointing.

Counterpart of ``mxnet_tpu/checkpoint.py``. The file format is the JAX
package's, so a set written by either package is read by the other. Under a
checkpoint root (``MXNET_CHECKPOINT_DIR``)::

    step-00000042/
        shard-00003-of-00008.npz    # this worker's 1/W flat slices
        shard-00003-of-00008.json   # sha256 digest guard for the .npz
        ...one pair per worker...
        extra.npz                   # rank 0: aux/arg params etc. (optional)
        manifest.json               # rank 0, written LAST = commit marker

A step is **complete** iff ``manifest.json`` exists and every shard pair it
implies exists with a matching size; completeness is judged by readers, so
no cross-worker commit barrier is needed and a crash mid-write leaves an
incomplete (ignored) step. A replicated set holds ``weights.npz`` (and
``states.bin``, the optimizer state pickle) instead of shards.

Writes run **off the step path** on one writer thread. What differs from
the JAX package is the snapshot. JAX arrays are immutable, so the JAX
package hands the writer references. The port's state is updated in place
by the next step (the bucket engine's flat shards, the fused step's state
cell, which a CUDA graph replay writes), so a save takes a copy before it
returns (``freeze``): a device ``clone`` on the current stream, ordered
after the step that wrote the state, with an event recorded after it. The
writer waits for that event on a stream of its own and copies to the host
there, while the next steps run. Telemetry: ``checkpoint.save`` /
``checkpoint.write`` / ``checkpoint.wait`` spans, the ``checkpoint.inflight``
gauge (>0 while a write overlaps the step) and ``checkpoint.drop`` events
when a newer save supersedes a queued one.

Every write is atomic: temp file + ``os.replace``. A torn or tampered file
fails its digest or deserialization check with a structured ``MXNetError``
naming the offending path.
"""
from __future__ import annotations

import errno
import glob
import hashlib
import io as _io
import json
import logging
import os
import random
import re
import shutil
import threading
import time

import numpy as np
import torch

from . import faultinject as _fi
from . import telemetry as _tm
from .base import MXNetError

__all__ = [
    "Checkpointer", "atomic_write_bytes", "atomic_replace", "checkpoint_dir",
    "checkpoint_keep", "latest_complete", "load_manifest", "read_flat_buckets",
    "read_local_shard", "read_extra", "per_key_states", "step_dir",
    "list_steps", "read_shard_set", "read_sparse_tables",
    "sparse_shard_arrays", "sparse_manifest_section",
    "apply_retention", "prefix_retention", "load_ndarrays_checked",
    "read_sharded_pointer", "freeze",
]

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1
_STEP_RE = re.compile(r"step-(\d{8,})$")


# copied from mxnet_tpu/checkpoint.py (the environment readers, the atomic
# writes, the layout, retention, the npz and shard readers, the sparse
# section and per_key_states; backend-free)
def checkpoint_dir():
    """MXNET_CHECKPOINT_DIR — the sharded-checkpoint root; None when unset
    (sharded saves then need an explicit directory)."""
    return os.environ.get("MXNET_CHECKPOINT_DIR") or None


def checkpoint_keep():
    """MXNET_CHECKPOINT_KEEP — keep-last-K retention for checkpoint sets;
    None (default) = unlimited."""
    raw = os.environ.get("MXNET_CHECKPOINT_KEEP", "")
    if not raw:
        return None
    try:
        k = int(raw)
        if k <= 0:
            raise ValueError(k)
        return k
    except ValueError:
        log.warning("MXNET_CHECKPOINT_KEEP=%r is not a positive int; "
                    "retention disabled", raw)
        return None


def checkpoint_async():
    """MXNET_CHECKPOINT_ASYNC — `0` forces every save to block until the
    write lands; default async."""
    return os.environ.get("MXNET_CHECKPOINT_ASYNC", "1").lower() not in (
        "0", "off", "false")


def checkpoint_retries():
    """MXNET_CHECKPOINT_RETRIES — how many times the writer retries a
    TRANSIENT I/O failure (EIO/ENOSPC/EAGAIN, or an injected fault at the
    ``checkpoint.write`` site) before latching it. Default 3; 0 disables."""
    raw = os.environ.get("MXNET_CHECKPOINT_RETRIES", "3")
    try:
        return max(0, int(raw))
    except ValueError:
        log.warning("MXNET_CHECKPOINT_RETRIES=%r is not an int; using 3", raw)
        return 3


_TRANSIENT_ERRNOS = (errno.EIO, errno.ENOSPC, errno.EAGAIN)


def _transient_write_error(exc):
    """Retry-worthy? Disk-level transients (EIO torn write, ENOSPC until
    retention frees space, EAGAIN) and injected faults; permission errors,
    serialization bugs etc. latch immediately."""
    if isinstance(exc, _fi.FaultInjected):
        return True
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def atomic_write_bytes(path, data: bytes):
    """Write ``data`` to ``path`` atomically (temp + os.replace): readers see
    the old file or the new file, never a torn one.

    Fault-injection site ``checkpoint.write``: ``raise``/``delay_ms``/``hang``
    fire at entry; a ``torn_write`` plan persists only a prefix of the
    payload INTO THE TEMP FILE and raises ``OSError(EIO)``, the
    crash-mid-write shape. The final path is never torn."""
    _fi.fire("checkpoint.write")
    keep = _fi.torn_fraction("checkpoint.write")
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        f.write(data if keep is None else data[:int(len(data) * keep)])
        f.flush()
        os.fsync(f.fileno())
    if keep is not None:
        raise OSError(
            errno.EIO, "faultinject: torn write of %r (persisted %d of %d "
            "bytes into the temp file, then failed)"
            % (path, int(len(data) * keep), len(data)))
    os.replace(tmp, path)


def atomic_replace(path):
    """Context manager handing out a temp path that is os.replace'd onto
    ``path`` on clean exit and unlinked on error."""
    class _Ctx:
        def __enter__(self_):
            self_.tmp = "%s.tmp.%d" % (path, os.getpid())
            return self_.tmp

        def __exit__(self_, et, ev, tb):
            if et is None:
                os.replace(self_.tmp, path)
            else:
                try:
                    os.unlink(self_.tmp)
                except OSError:
                    pass
            return False

    return _Ctx()


def load_ndarrays_checked(path):
    """``nd.load`` with torn-file armour: any deserialization failure raises
    a structured MXNetError naming the offending path. The arrays load onto
    ``current_context()``."""
    from . import ndarray as nd

    try:
        return nd.load(path)
    except MXNetError as e:
        raise MXNetError(
            "checkpoint file %r is corrupt or not an NDArray file (%s) — "
            "likely a torn write from a crash mid-save; delete it and resume "
            "from the previous checkpoint" % (path, e)) from e
    except Exception as e:
        raise MXNetError(
            "checkpoint file %r is truncated or corrupt (%s: %s) — likely a "
            "torn write from a crash mid-save; delete it and resume from the "
            "previous checkpoint" % (path, type(e).__name__, e)) from e


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ------------------------------------------------------------------- layout
def step_dir(root, step) -> str:
    return os.path.join(root, "step-%08d" % int(step))


def _shard_base(rank, world) -> str:
    return "shard-%05d-of-%05d" % (rank, world)


def list_steps(root):
    """All step numbers present under ``root`` (complete or not), ascending."""
    steps = []
    for path in glob.glob(os.path.join(glob.escape(root), "step-*")):
        m = _STEP_RE.search(path)
        if m and os.path.isdir(path):
            steps.append(int(m.group(1)))
    return sorted(steps)


def load_manifest(root, step):
    """The manifest of one step, or None when absent/corrupt."""
    path = os.path.join(step_dir(root, step), MANIFEST_NAME)
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if m.get("format") != FORMAT_VERSION:
        log.warning("checkpoint %s has unknown format %r; ignoring",
                    path, m.get("format"))
        return None
    return m


def _step_complete(root, step, manifest) -> bool:
    d = step_dir(root, step)
    if manifest.get("kind") == "sharded":
        world = int(manifest["world"])
        for r in range(world):
            base = os.path.join(d, _shard_base(r, world))
            try:
                with open(base + ".json") as f:
                    meta = json.load(f)
                if meta.get("plan_hash") != manifest.get("plan_hash"):
                    return False
                # size check: catches a torn shard at scan time without
                # paying the full digest read (the digest still guards loads)
                if os.path.getsize(base + ".npz") != meta.get("nbytes"):
                    return False
            except (OSError, ValueError):
                return False
    for name in manifest.get("files", ()):
        if not os.path.exists(os.path.join(d, name)):
            return False
    return True


def latest_complete(root):
    """``(step, manifest)`` of the newest COMPLETE checkpoint under ``root``,
    or None. A checkpoint interrupted mid-write is skipped."""
    if not root or not os.path.isdir(root):
        return None
    for step in reversed(list_steps(root)):
        manifest = load_manifest(root, step)
        if manifest is not None and _step_complete(root, step, manifest):
            return step, manifest
    return None


# An INCOMPLETE old step may be garbage from a crash — or a lagging peer's
# writer thread still flushing into it on a shared filesystem; it becomes a
# victim only once its directory has been quiet this long.
_INCOMPLETE_GRACE_S = 900.0


def apply_retention(root, keep, protect_step=None):
    """Delete the oldest step dirs past ``keep``, never deleting
    ``protect_step``, the newest complete step, or an incomplete step
    modified within the last ``_INCOMPLETE_GRACE_S`` seconds (a lagging
    worker may still be writing its shard into it)."""
    if keep is None:
        return []
    steps = list_steps(root)
    if len(steps) <= keep:
        return []
    newest = latest_complete(root)
    protected = {protect_step, newest[0] if newest else None}
    victims = []
    for s in steps[:-keep]:
        if s in protected:
            continue
        manifest = load_manifest(root, s)
        if manifest is None or not _step_complete(root, s, manifest):
            try:
                quiet = time.time() - os.path.getmtime(step_dir(root, s))
            except OSError:
                quiet = _INCOMPLETE_GRACE_S
            if quiet < _INCOMPLETE_GRACE_S:
                continue  # a peer's writer may still be flushing into it
        victims.append(s)
    for s in victims:
        shutil.rmtree(step_dir(root, s), ignore_errors=True)
        log.info("checkpoint retention: dropped step %d (keep=%d)", s, keep)
    return victims


def prefix_retention(prefix, keep):
    """Keep-last-K for classic ``<prefix>-NNNN.params``/``.states`` epoch
    checkpoints (``callback.module_checkpoint``). The newest COMPLETE epoch —
    params readable, and if its .states is a sharded pointer, the pointed-to
    shard set complete — is never deleted, even when older than the window;
    a sharded .states' backing directory is removed with its epoch."""
    if keep is None:
        return []
    epochs = []
    for path in glob.glob(glob.escape(prefix) + "-*.params"):
        m = re.search(r"-(\d{4,})\.params$", path)
        if m:
            epochs.append(int(m.group(1)))
    epochs.sort()
    if len(epochs) <= keep:
        return []

    def _complete(ep):
        params = "%s-%04d.params" % (prefix, ep)
        states = "%s-%04d.states" % (prefix, ep)
        if not os.path.exists(params):
            return False
        ptr = _read_sharded_pointer(states)
        if ptr is not None:
            got = latest_complete(ptr["dir"])
            return got is not None and got[0] == ptr["step"]
        return True

    newest_complete = next((ep for ep in reversed(epochs) if _complete(ep)), None)
    victims = [ep for ep in epochs[:-keep] if ep != newest_complete]
    for ep in victims:
        for suffix in (".params", ".states"):
            path = "%s-%04d%s" % (prefix, ep, suffix)
            ptr = _read_sharded_pointer(path) if suffix == ".states" else None
            try:
                os.unlink(path)
            except OSError:
                continue
            if ptr is not None:
                shutil.rmtree(ptr["dir"], ignore_errors=True)
        log.info("checkpoint retention: dropped epoch %d of %r (keep=%d)", ep, prefix, keep)
    return victims


# ------------------------------------------------------- sharded npz helpers
def _npz_bytes(arrays: dict) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_npz_checked(path, want_digest=None):
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise MXNetError("checkpoint shard %r unreadable: %s" % (path, e)) from e
    if want_digest is not None and _sha256(data) != want_digest:
        raise MXNetError(
            "checkpoint shard %r failed its digest check — the file is torn "
            "or was modified after commit; this checkpoint step is unusable"
            % path)
    try:
        with np.load(_io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:
        raise MXNetError(
            "checkpoint shard %r is corrupt (%s: %s)"
            % (path, type(e).__name__, e)) from e


def read_local_shard(root, step, manifest, rank):
    """One worker's raw shard arrays ``{array_name: np}`` with the digest
    sidecar verified (the same-W shard-direct resume path)."""
    world = int(manifest["world"])
    base = os.path.join(step_dir(root, step), _shard_base(rank, world))
    try:
        with open(base + ".json") as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise MXNetError("checkpoint shard sidecar %r unreadable: %s"
                         % (base + ".json", e)) from e
    return _load_npz_checked(base + ".npz", meta.get("digest"))


def read_shard_set(root, step, manifest):
    """Every worker's digest-verified shard arrays, in rank order — read
    ONCE and passed to both ``read_flat_buckets`` and
    ``read_sparse_tables``."""
    world = int(manifest["world"])
    return [read_local_shard(root, step, manifest, r) for r in range(world)]


def read_flat_buckets(root, step, manifest, shards=None):
    """Assemble the FULL flat per-bucket arrays from every worker's shard
    file: ``{bucket_index: {"w": np, "states": [np, ...]}}``. Works for any
    saved world size — the re-flatten half of different-W resume."""
    n_states = int(manifest["optimizer"]["n_states"])
    if shards is None:
        shards = read_shard_set(root, step, manifest)
    out = {}
    for b in manifest["plan"]["buckets"]:
        idx = int(b["index"])
        names = ["b%d.w" % idx] + ["b%d.s%d" % (idx, i) for i in range(n_states)]
        for name in names:
            for r, sh in enumerate(shards):
                if name not in sh:
                    raise MXNetError(
                        "checkpoint step %d shard %d is missing array %r — "
                        "manifest/shard mismatch" % (step, r, name))
        w = np.concatenate([sh["b%d.w" % idx] for sh in shards])
        states = [np.concatenate([sh["b%d.s%d" % (idx, i)] for sh in shards])
                  for i in range(n_states)]
        out[idx] = {"w": w, "states": states}
    return out


# Row-sparse tables live OUTSIDE the bucket plan, so they checkpoint as
# their own shard arrays: worker r writes the r-th contiguous piece of the
# dense table plus the r-th piece of the touched-index set with its state
# rows. The pieces are np.array_split slices of SORTED arrays, so any
# reader world re-assembles them by plain concatenation.
def sparse_shard_arrays(sparse_tables, rank, world):
    """This worker's shard arrays for the manifest's sparse section.

    ``sparse_tables``: ``{key: {"shape", "dtype", "w" (np dense table),
    "indices" (np sorted int64), "states" ([np (nnz, ...) rows])}}``, in a
    deterministic key order (the manifest section's order names the
    ``sp<j>.*`` arrays)."""
    out = {}
    for j, key in enumerate(sorted(sparse_tables, key=str)):
        t = sparse_tables[key]
        flat = np.asarray(t["w"]).reshape(-1)
        out["sp%d.w" % j] = np.array_split(flat, world)[rank]
        out["sp%d.idx" % j] = np.array_split(np.asarray(t["indices"], np.int64), world)[rank]
        for i, s in enumerate(t["states"]):
            out["sp%d.s%d" % (j, i)] = np.array_split(np.asarray(s), world)[rank]
    return out


def sparse_manifest_section(sparse_tables):
    """The manifest rows describing the sparse shard set (order matches
    ``sparse_shard_arrays``)."""
    rows = []
    for key in sorted(sparse_tables, key=str):
        t = sparse_tables[key]
        rows.append({"key": _manifest_key(key),
                     "shape": list(t["shape"]),
                     "dtype": str(np.dtype(t["dtype"])),
                     "nnz": int(np.asarray(t["indices"]).size),
                     "n_states": len(t["states"])})
    return rows


def read_sparse_tables(root, step, manifest, shards=None):
    """Re-assemble every sparse table from the shard set:
    ``{key: {"w": np dense table, "indices": np, "states": [np rows]}}``,
    for ANY saved world size."""
    section = manifest.get("sparse") or []
    if not section:
        return {}
    if shards is None:
        shards = read_shard_set(root, step, manifest)
    out = {}
    for j, row in enumerate(section):
        key = _manifest_key(row["key"])
        shape = tuple(row["shape"])
        names = (["sp%d.w" % j, "sp%d.idx" % j]
                 + ["sp%d.s%d" % (j, i) for i in range(row["n_states"])])
        for name in names:
            for r, sh in enumerate(shards):
                if name not in sh:
                    raise MXNetError(
                        "checkpoint step %s shard %d is missing sparse "
                        "array %r — manifest/shard mismatch" % (step, r, name))
        w = np.concatenate([sh["sp%d.w" % j] for sh in shards]).reshape(shape)
        idx = np.concatenate([sh["sp%d.idx" % j] for sh in shards])
        states = [np.concatenate([sh["sp%d.s%d" % (j, i)] for sh in shards])
                  for i in range(row["n_states"])]
        if idx.size != row["nnz"]:
            raise MXNetError(
                "checkpoint step %s sparse key %r: %d touched rows in the "
                "shards, manifest says %d" % (step, key, idx.size, row["nnz"]))
        out[key] = {"w": w, "indices": idx.astype(np.int64), "states": states}
    return out


def read_extra(root, step, manifest):
    """``{name: np}`` of the manifest's rank-0 extra files (aux params
    etc.; see ``Checkpointer.save_sharded(extra=)``)."""
    d = step_dir(root, step)
    out = {}
    for name in manifest.get("files", ()):
        out[name] = _load_npz_checked(os.path.join(d, name))["value"]
    return out


def _manifest_key(key):
    """JSON round-trippable key encoding (int kvstore indices stay ints)."""
    return key


def per_key_states(manifest, flats, weights=False):
    """Re-flatten: per-key full arrays from the assembled flat buckets using
    the manifest's slot map. Returns ``{key: np}`` when ``weights`` else
    ``{key: (np, ...)}`` state tuples (empty tuple for stateless
    optimizers) — the seed of a different-W resume."""
    n_states = int(manifest["optimizer"]["n_states"])
    pending = {}
    shapes = {}
    for b in manifest["plan"]["buckets"]:
        idx = int(b["index"])
        flat = flats[idx]
        arrays = [flat["w"]] if weights else flat["states"]
        for slot in b["slots"]:
            key, offset, size, shape, dtype, src_off, part, n_parts = slot
            key = _manifest_key(key)
            shapes[key] = (tuple(shape), dtype)
            segs = [a[offset:offset + size] for a in arrays]
            pending.setdefault(key, {})[part] = segs
    out = {}
    for key, parts in pending.items():
        shape, dtype = shapes[key]
        n_arrays = 1 if weights else n_states
        full = []
        for i in range(n_arrays):
            pieces = [parts[p][i] for p in sorted(parts)]
            arr = (np.concatenate(pieces) if len(pieces) > 1
                   else pieces[0]).astype(dtype, copy=False).reshape(shape)
            full.append(arr)
        out[key] = full[0] if weights else tuple(full)
    return out


# ------------------------------------------------------------------ snapshot
class Frozen:
    """One tensor as it stood when ``freeze`` was called. On a card the copy
    is a ``clone`` on the current stream, so it runs after the step that
    wrote the tensor and before any later one, and an event marks its end;
    ``numpy()`` (on the writer thread) waits for that event on a stream of
    its own and copies to the host there. A CPU tensor is cloned at once.
    The host array is made once; the device copy is freed with it."""

    __slots__ = ("_dev", "_event", "_host")

    def __init__(self, tensor):
        with torch.no_grad():
            self._dev = tensor.detach().clone()
        self._event = None
        self._host = None
        if self._dev.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._dev.device))

    def numpy(self) -> np.ndarray:
        if self._host is None:
            t, self._dev = self._dev, None
            if self._event is not None:
                side = torch.cuda.Stream(device=t.device)
                with torch.cuda.stream(side):
                    side.wait_event(self._event)
                    t = t.to("cpu")  # pageable: returns once the copy landed
            self._host = t.numpy()
        return self._host


class FrozenView:
    """A slice of a ``Frozen`` flat buffer, reshaped: many parameters kept
    in one flat buffer freeze with one ``clone``."""

    __slots__ = ("_flat", "_off", "_size", "_shape")

    def __init__(self, flat: Frozen, off: int, size: int, shape):
        self._flat, self._off, self._size, self._shape = flat, off, size, tuple(shape)

    def numpy(self) -> np.ndarray:
        return self._flat.numpy()[self._off:self._off + self._size].reshape(self._shape)


def freeze(value):
    """A value as a save keeps it until its write: tensors and NDArrays as a
    ``Frozen`` copy taken now, numpy arrays and frozen values as they are."""
    if isinstance(value, (Frozen, FrozenView, np.ndarray)):
        return value
    if hasattr(value, "_tensor"):
        value = value._tensor()
    if isinstance(value, torch.Tensor):
        return Frozen(value)
    return np.asarray(value)


def _host(value) -> np.ndarray:
    return value.numpy() if isinstance(value, (Frozen, FrozenView)) else np.asarray(value)


# --------------------------------------------------------------- async writer
class _WriteJob:
    __slots__ = ("fn", "step", "done", "error")

    def __init__(self, fn, step):
        self.fn = fn
        self.step = step
        self.done = threading.Event()
        self.error = None


class Checkpointer:
    """Asynchronous checkpoint writer bound to one checkpoint root.

    One daemon writer thread; at most one job queued behind the one in
    flight — a newer save supersedes a queued (not-yet-started) one, which
    is *dropped* (``checkpoint.drop``): under failure recovery only the
    newest complete checkpoint matters."""

    def __init__(self, directory, keep=None, async_=None):
        if not directory:
            raise MXNetError(
                "Checkpointer needs a directory (argument or "
                "MXNET_CHECKPOINT_DIR)")
        self.directory = directory
        self.keep = checkpoint_keep() if keep is None else keep
        self.async_ = checkpoint_async() if async_ is None else bool(async_)
        self._lock = _tm.named_lock("checkpoint.writer")
        self._queued = None      # superseded-able pending job
        self._active = None
        self._thread = None
        self._shutdown = False   # close() in progress; writer loop exits
        self._error = None       # first writer failure; re-raised at next op
        self._cv = _tm.named_condition("checkpoint.writer", self._lock)
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- lifecycle
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True, name="mxtpu-checkpoint-writer")
            self._thread.start()

    def _writer_loop(self):
        while True:
            with self._cv:
                while self._queued is None:
                    if self._shutdown:
                        return
                    self._cv.wait()
                job, self._queued = self._queued, None
                self._active = job
                self._set_inflight_locked()
            try:
                # transient I/O is retried with capped jittered backoff
                # before latching; the write bodies are idempotent (temp +
                # os.replace), so a re-run never compounds a partial attempt
                retries = checkpoint_retries()
                attempt = 0
                while True:
                    try:
                        with _tm.span("checkpoint.write", step=job.step, attempt=attempt):
                            job.fn()
                        break
                    except BaseException as exc:
                        if attempt >= retries or not _transient_write_error(exc):
                            raise
                        attempt += 1
                        if _tm.enabled():
                            _tm.counter("checkpoint.retries").inc()
                        delay = min(1.0, 0.05 * (2 ** attempt)) * (0.5 + random.random())
                        log.warning(
                            "checkpoint write for step %s hit a transient "
                            "I/O error (%s); retry %d/%d in %.0fms",
                            job.step, exc, attempt, retries, delay * 1000)
                        time.sleep(delay)
            except BaseException as exc:  # latched; next save/wait raises
                log.error("checkpoint write for step %s FAILED: %s", job.step, exc)
                job.error = exc
                with self._cv:
                    if self._error is None:
                        self._error = exc
            finally:
                job.fn = None  # the frozen copies go with it
                with self._cv:
                    self._active = None
                    self._set_inflight_locked()
                    job.done.set()
                    self._cv.notify_all()

    def _set_inflight_locked(self):
        if _tm.enabled():
            _tm.gauge("checkpoint.inflight").set(
                (1 if self._active is not None else 0)
                + (1 if self._queued is not None else 0))

    def _raise_pending_error(self):
        exc, self._error = self._error, None
        if exc is not None:
            raise MXNetError("earlier async checkpoint write failed: %s" % exc) from exc

    # ----------------------------------------------------------------- save
    def _submit(self, fn, step, block):
        job = _WriteJob(fn, step)
        if not self.async_:
            block = True
        with self._cv:
            self._raise_pending_error()
            if self._queued is not None:
                dropped = self._queued
                dropped.fn = None
                dropped.done.set()  # waiters on the stale job unblock
                if _tm.enabled():
                    _tm.counter("checkpoint.drops").inc()
                    _tm.event("checkpoint.drop", step=dropped.step, superseded_by=step)
                log.info("checkpoint step %s dropped (superseded by %s "
                         "before its write started)", dropped.step, step)
            self._queued = job
            self._set_inflight_locked()
            self._cv.notify_all()
        if _tm.enabled():
            _tm.counter("checkpoint.saves").inc()
        self._ensure_thread()
        if block:
            # bounded wait: a writer thread that died without completing the
            # job must surface as an error, not hang the training loop
            while not job.done.wait(5.0):
                t = self._thread
                if t is None or not t.is_alive():
                    with self._cv:
                        self._raise_pending_error()
                    raise MXNetError(
                        "checkpoint writer thread died before step %s "
                        "completed" % (job.step,))
            with self._cv:
                self._raise_pending_error()
        return job

    def wait(self):
        """Block until every outstanding write landed; re-raise a latched
        writer failure."""
        with _tm.span("checkpoint.wait"):
            with self._cv:
                while self._queued is not None or self._active is not None:
                    if not self._cv.wait(5.0):
                        t = self._thread
                        if t is None or not t.is_alive():
                            self._raise_pending_error()
                            raise MXNetError(
                                "checkpoint writer thread died with "
                                "write(s) still queued")
                self._raise_pending_error()

    def close(self):
        """Drain outstanding writes and stop the writer thread. The
        Checkpointer stays usable — a later save starts a fresh thread. The
        thread stops even when the drain re-raises a latched failure."""
        try:
            self.wait()
        finally:
            with self._cv:
                self._shutdown = True
                self._cv.notify_all()
            t, self._thread = self._thread, None
            if t is not None:
                t.join(timeout=10)
            with self._cv:
                self._shutdown = False

    def save_sharded(self, kv, step, extra=None, meta=None, block=False):
        """Checkpoint a sharded-update dist KVStore: this worker's 1/W flat
        shard of each bucket's weights + optimizer state, asynchronously.

        The flat shards are copied NOW (``freeze``: a clone ordered on the
        stream after the round that wrote them), so the next round's
        in-place update cannot reach the saved bytes; the writer thread
        does device→host + disk. Rank 0 additionally writes ``extra`` host
        arrays and the manifest (the commit marker). All workers must call
        this at the same step."""
        engine = getattr(kv, "_bucket_engine", None)
        sparse_tables = self._collect_sparse(kv)
        dense_ok = (engine is not None and engine.plan is not None
                    and engine.mode == "sharded" and engine._sharded_state)
        if not dense_ok and not sparse_tables:
            if engine is None or engine.plan is None:
                raise MXNetError(
                    "save_sharded needs a committed bucket plan (run at "
                    "least one push round first)")
            raise MXNetError(
                "save_sharded called while the engine is not in sharded "
                "update mode — use save_replicated (states live per key)")
        if dense_ok:
            missing = [b.index for b in engine.plan.buckets
                       if b.index not in engine._sharded_state]
            if missing:
                raise MXNetError(
                    "sharded checkpoint needs every bucket's flat state "
                    "materialized; buckets %s have not dispatched yet "
                    "(finish the push round / call finalize_all first)" % missing)
            coll = engine._coll()
            rank, world = coll.rank, coll.n_workers
        else:
            rank, world = kv.rank, kv.num_workers
        opt = kv._optimizer
        kind, hyper, n_states = opt.flat_update_spec()
        with _tm.span("checkpoint.save", step=step, kind="sharded"):
            local = {}
            if dense_ok:
                for b in engine.plan.buckets:
                    sstate = engine._sharded_state[b.index]
                    shard = b.total // world
                    local["b%d.w" % b.index] = Frozen(
                        sstate["w_full"][rank * shard:(rank + 1) * shard])
                    for i, s in enumerate(sstate["states"]):
                        local["b%d.s%d" % (b.index, i)] = Frozen(s)
            # row-sparse tables ride the same shard files (host snapshots:
            # the (indices, rows) state is host-resident already)
            local.update(sparse_shard_arrays(sparse_tables, rank, world))
            manifest = None
            if rank == 0:
                plan_view = (engine.plan.describe_portable() if dense_ok
                             else {"buckets": []})
                manifest = {
                    "format": FORMAT_VERSION, "kind": "sharded",
                    "step": int(step), "world": world,
                    "plan_hash": engine.plan.hash if dense_ok else None,
                    "plan": plan_view,
                    "sparse": sparse_manifest_section(sparse_tables),
                    "optimizer": {
                        "kind": kind, "n_states": n_states,
                        "hyper": {k: v for k, v in hyper.items()},
                        "class": type(opt).__name__,
                    },
                    "update_counts": [[_manifest_key(k), int(v)] for k, v
                                      in opt._index_update_count.items()],
                    "num_update": int(opt.num_update),
                    "files": sorted(extra) if extra else [],
                    "meta": dict(meta or {}),
                    "written_at": time.time(),
                }
            plan_hash = engine.plan.hash if dense_ok else None
            extra = {k: freeze(v) for k, v in extra.items()} if extra else None
            return self._submit(
                lambda: self._write_shard(step, rank, world, plan_hash, local, extra, manifest),
                step, block)

    @staticmethod
    def _collect_sparse(kv):
        """Host snapshot of every row-sparse table + its lazy state: the
        checkpoint view ``sparse_shard_arrays`` slices. ``{}`` when the
        store has no sparse keys."""
        sp = getattr(kv, "_sparse_engine", None)
        if sp is None:
            return {}
        out = {}
        for key, (shape, dtype, st) in sp.sparse_states().items():
            out[key] = {"shape": tuple(shape), "dtype": dtype,
                        "w": kv._store[key].asnumpy(),
                        "indices": st.indices.copy(),
                        "states": [r.copy() for r in st.rows]}
        return out

    def save_replicated(self, step, weights, states_bytes=None, extra=None,
                        meta=None, world=1, rank=0, block=False):
        """Checkpoint the replicated-update (or single-process) layout: rank
        0 writes full weights (+ the optimizer state pickle) — every other
        rank's call is a cheap no-op so training scripts stay SPMD.

        ``weights`` values may be numpy arrays, tensors or NDArrays (copied
        now, ``freeze``) or frozen values. ``states_bytes`` is the pickle, or
        a callable the writer thread calls for it (so a state frozen now is
        serialized off the step path)."""
        with _tm.span("checkpoint.save", step=step, kind="replicated"):
            if rank != 0:
                return None
            manifest = {
                "format": FORMAT_VERSION, "kind": "replicated",
                "step": int(step), "world": int(world),
                "files": (["weights.npz"]
                          + (["states.bin"] if states_bytes else [])
                          + (sorted(extra) if extra else [])),
                "meta": dict(meta or {}),
                "written_at": time.time(),
            }
            host_weights = {k: freeze(v) for k, v in weights.items()}
            extra = {k: freeze(v) for k, v in extra.items()} if extra else None
            return self._submit(
                lambda: self._write_replicated(step, host_weights, states_bytes, extra,
                                               manifest),
                step, block)

    # ---------------------------------------------------------- write bodies
    def _step_dir(self, step):
        d = step_dir(self.directory, step)
        os.makedirs(d, exist_ok=True)
        return d

    def _write_extra(self, d, extra):
        if extra:
            for name, v in extra.items():
                atomic_write_bytes(os.path.join(d, name), _npz_bytes({"value": _host(v)}))

    def _finish_manifest(self, d, manifest):
        if manifest is not None:
            atomic_write_bytes(os.path.join(d, MANIFEST_NAME),
                               json.dumps(manifest, indent=1).encode())
            apply_retention(self.directory, self.keep, protect_step=manifest["step"])

    def _write_shard(self, step, rank, world, plan_hash, local, extra, manifest):
        d = self._step_dir(step)
        data = _npz_bytes({k: _host(v) for k, v in local.items()})  # device→host
        base = os.path.join(d, _shard_base(rank, world))
        atomic_write_bytes(base + ".npz", data)
        atomic_write_bytes(base + ".json", json.dumps({
            "digest": _sha256(data), "rank": rank, "world": world,
            "step": int(step), "plan_hash": plan_hash,
            "nbytes": len(data)}).encode())
        if rank == 0:
            self._write_extra(d, extra)
        self._finish_manifest(d, manifest)

    def _write_replicated(self, step, weights, states_bytes, extra, manifest):
        d = self._step_dir(step)
        atomic_write_bytes(os.path.join(d, "weights.npz"),
                           _npz_bytes({k: _host(v) for k, v in weights.items()}))
        if states_bytes:
            atomic_write_bytes(os.path.join(d, "states.bin"),
                               states_bytes() if callable(states_bytes) else states_bytes)
        self._write_extra(d, extra)
        self._finish_manifest(d, manifest)


def _read_sharded_pointer(path):
    """Parse a sharded-optimizer-states pointer file (see
    ``kvstore.save_optimizer_states``); None when ``path`` is absent or a
    classic pickle blob."""
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
        obj = json.loads(head.decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    if isinstance(obj, dict) and obj.get("format") == "mxtpu-sharded-states":
        return obj
    return None


def read_sharded_pointer(path):
    """Public wrapper: the pointer dict ({'dir', 'step'}) or None."""
    return _read_sharded_pointer(path)
