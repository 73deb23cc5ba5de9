"""KVStore: key-value parameter synchronization.

Counterpart of ``mxnet_tpu/kvstore.py`` (reference:
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h, python/mxnet/kvstore.py).
``push`` sums the per-device values of a key, in context order as
``nd.add_n`` does, then applies the updater (the optimizer) to the stored
weight or replaces it; ``pull`` copies the stored weight into every output.

Types:
  * ``local`` / ``device``: one process, several contexts. The sum runs on
    the first value's device; values elsewhere are copied there.
  * ``dist_sync`` / ``dist_device_sync`` / ``dist_tpu_sync``: data
    parallelism over processes on ``torch.distributed`` (``dist.py``; NCCL
    on the card, gloo on the CPU). A push's reduce becomes an all-reduce
    across workers; every worker then runs the same update (there is no
    parameter server). With more than one worker, pushes go through the
    bucketed engine (``kvstore_bucket.py``), as in the JAX package.
    ``dist_async`` runs as ``dist_sync``, with a warning.

Row-sparse values (``sparse.RowSparseNDArray``) take the sparse round
(``sparse/kvstore_sparse.py``). Optimizer states save and load as one
replicated pickle; the sharded checkpoint set and elastic re-forming come
with the next item of ``ROADMAP.md`` section 1.4 and raise.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from . import optimizer as opt
from . import telemetry as _tm
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_NEXT = ("comes with the sharded Checkpointer and module/elastic.py (ROADMAP.md "
         "section 1.4b)")


def _nbytes(arrs) -> int:
    """Byte count of one value list (telemetry only)."""
    return sum(int(a.size) * np.dtype(a.dtype).itemsize for a in arrs)


class KVStore:
    """(reference: python/mxnet/kvstore.py)"""

    def __init__(self, type_name: str):
        self._type = type_name
        self._store: Dict = {}
        self._updater: Optional[opt.Updater] = None
        self._optimizer = None
        self._bucket_engine = None  # dist comm engine (kvstore_bucket)
        self._sparse_engine = None  # row-sparse rounds (sparse/kvstore_sparse)
        self._verify_rounds_done = 0
        self._verify_check_rounds = None  # lazy MXNET_KVSTORE_CHECK_STEPS

    # ------------------------------------------------------------------ meta
    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        if "dist" in self._type:
            from . import dist

            return dist.rank()
        return 0

    @property
    def num_workers(self) -> int:
        if "dist" in self._type:
            from . import dist

            return dist.num_workers()
        return 1

    def num_dead_nodes(self, timeout=60.0, startup_grace=None) -> int:
        """Workers whose heartbeat went stale (``dist.num_dead_nodes``); 0
        for single-process stores."""
        if "dist" not in self._type:
            return 0
        from . import dist

        return dist.num_dead_nodes(timeout=timeout, startup_grace=startup_grace)

    def get_num_dead_node(self, node_id=0, timeout=None):
        """Dead-worker count. A job without elastic membership is gang
        scheduled: a dead peer ends the job, so while this process runs the
        count is 0 (JAX :368)."""
        return 0

    # ------------------------------------------------------------------- api
    def init(self, key, value):
        """Store a copy of each value. In dist mode every worker adopts rank
        0's value, so all start from the same weights."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % k)
            self._store[k] = self._broadcast_rank0(v.copy())

    def push(self, key, value, priority=0):
        """Reduce values per key; apply the updater or replace. On the
        bucketed dist path a push lands in its bucket's slot and a full
        bucket's collective starts at once (asynchronously), higher
        priorities first when several are ready."""
        keys, grouped = _group_kv(key, value)
        for k in keys:
            if k not in self._store:
                raise MXNetError("key %s has not been inited" % k)
        sp = _tm.NULL_SPAN
        if _tm.enabled():
            pushed = _nbytes(m for vals in grouped for m in vals)
            _tm.counter("kvstore.push_calls").inc()
            _tm.counter("kvstore.push_bytes").inc(pushed)
            sp = _tm.span("kvstore.push", nkeys=len(keys), bytes=pushed,
                          dist="dist" in self._type, priority=priority)
        with sp:
            keys, grouped = self._route_sparse(keys, grouped, priority)
            if not keys:
                return
            eng = self._engine()
            if eng is not None:
                merged_list = [self._reduce_local(vals, copy=False) for vals in grouped]
                eng.push(keys, merged_list, priority)
                return
            merged_list = [self._reduce_local(vals) for vals in grouped]
            if "dist" in self._type:
                self._verify_push_round(keys)
                merged_list = self._allreduce_batch(merged_list)
            for k, merged in zip(keys, merged_list):
                if self._updater is not None:
                    self._updater(k, merged, self._store[k])
                else:
                    self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        """Copy the stored weight into each output. On the bucketed dist
        path this waits only for the requested keys' own buckets."""
        assert out is not None
        keys, grouped = _group_kv(key, out)
        for k in keys:
            if k not in self._store:
                raise MXNetError("key %s has not been inited" % k)
        sp = _tm.NULL_SPAN
        if _tm.enabled():
            pulled = _nbytes(o for outs in grouped for o in outs)
            _tm.counter("kvstore.pull_calls").inc()
            _tm.counter("kvstore.pull_bytes").inc(pulled)
            sp = _tm.span("kvstore.pull", nkeys=len(keys), bytes=pulled)
        with sp:
            if self._bucket_engine is not None:
                self._bucket_engine.before_read(keys)
            for k, outs in zip(keys, grouped):
                local = self._store[k]
                for o in outs:
                    o[:] = local

    def _route_sparse(self, keys, grouped, priority):
        """Run the row-sparse values of a push round through the sparse
        engine; return the dense rest."""
        from .sparse import RowSparseNDArray

        if not any(isinstance(v, RowSparseNDArray) for vals in grouped for v in vals):
            return keys, grouped
        eng = self._sparse()
        dense_k, dense_g = [], []
        for k, vals in zip(keys, grouped):
            if isinstance(vals[0], RowSparseNDArray):
                merged = vals[0]
                for v in vals[1:]:  # local multi-device reduce: index merge
                    merged = merged + v
                eng.push(k, merged, priority=priority)
            else:
                dense_k.append(k)
                dense_g.append(vals)
        return dense_k, dense_g

    def _sparse(self):
        if self._sparse_engine is None:
            from .sparse.kvstore_sparse import SparseEngine

            self._sparse_engine = SparseEngine(self)
        return self._sparse_engine

    def row_sparse_pull(self, key, row_ids, priority=0):
        """Pull only the requested rows of a key as a RowSparseNDArray."""
        if key not in self._store:
            raise MXNetError("key %s has not been inited" % key)
        from .sparse import RowSparseNDArray, normalize_row_ids

        rows = normalize_row_ids(row_ids)
        stored = self._store[key]
        if _tm.enabled():
            _tm.counter("kvstore.pull_calls").inc()
            _tm.counter("kvstore.pull_bytes").inc(
                int(rows.size * int(np.prod(stored.shape[1:]) or 1) * stored.dtype.itemsize))
        t = stored._tensor()
        vals = t[torch.from_numpy(rows).to(t.device)]
        return RowSparseNDArray(rows, NDArray(vals, ctx=stored.context), stored.shape,
                                ctx=stored.context)

    def _engine(self):
        """The bucket engine of a dist store with more than one worker
        (``MXNET_KVSTORE_BUCKET=0`` keeps the unbucketed collective)."""
        if self._bucket_engine is not None:
            return self._bucket_engine
        if "dist" not in self._type:
            return None
        if os.environ.get("MXNET_KVSTORE_BUCKET", "1").lower() in ("0", "off", "false"):
            return None
        if self.num_workers == 1:
            return None
        from .kvstore_bucket import BucketEngine

        self._bucket_engine = BucketEngine(self)
        return self._bucket_engine

    def _reduce_local(self, vals: List[NDArray], copy=True) -> NDArray:
        """Sum this process's device copies of one key, in context order on
        the first copy's device (``add_n``'s chain). ``copy=False`` lets a
        single value through uncopied for read-only consumers."""
        if len(vals) == 1:
            return vals[0].copy() if copy else vals[0]
        out = vals[0]._tensor()
        for v in vals[1:]:
            out = out + v._tensor().to(out.device)
        return NDArray(out, ctx=vals[0].context)

    def _broadcast_rank0(self, arr: NDArray) -> NDArray:
        """Every worker adopts rank 0's value (dist init parity)."""
        if "dist" not in self._type or self.num_workers == 1:
            return arr
        coll = _Collective.get()
        t = arr._tensor()
        buf = t.to(coll.device).contiguous()
        coll.broadcast(buf)
        return NDArray(buf.to(t.device), ctx=arr.context)

    def _allreduce_batch(self, arrs: List[NDArray]) -> List[NDArray]:
        """Cross-process all-reduce of one push round: one collective per
        dtype over the concatenation of the keys, split back."""
        if self.num_workers == 1:
            return arrs
        coll = _Collective.get()
        by_dtype: Dict = {}
        for i, a in enumerate(arrs):
            by_dtype.setdefault(str(a.dtype), []).append(i)
        out: List = [None] * len(arrs)
        for idxs in by_dtype.values():
            flat = torch.cat([arrs[i]._tensor().reshape(-1).to(coll.device) for i in idxs])
            summed = coll.allreduce(flat).wait()
            off = 0
            for i in idxs:
                n = arrs[i].size
                dev = arrs[i]._tensor().device
                out[i] = NDArray(summed[off:off + n].reshape(arrs[i].shape).to(dev),
                                 ctx=arrs[i].context)
                off += n
        return out

    # ------------------------------------------------------------ validation
    def _verify_push_round(self, keys):
        """Before the unbucketed all-reduce, allgather a 4-byte digest of
        this round's key order, for the first MXNET_KVSTORE_CHECK_STEPS
        rounds, so rank-dependent pushes fail loudly."""
        if self.num_workers == 1:
            return
        from .kvstore_bucket import BucketEngine, verify_digest_across_workers

        if self._verify_check_rounds is None:
            self._verify_check_rounds = BucketEngine._env_check_rounds()
        self._verify_rounds_done += 1
        if self._verify_rounds_done > self._verify_check_rounds:
            return
        verify_digest_across_workers(repr(list(keys)), self._verify_check_rounds,
                                     BucketEngine._allgather_digest)

    def rearm_verify(self):
        """Re-open the key-sequence digest window (both push paths)."""
        self._verify_rounds_done = 0
        if self._bucket_engine is not None:
            self._bucket_engine.rearm_verify()

    # -------------------------------------------------------------- optimizer
    def set_optimizer(self, optimizer):
        """The updater runs in-process on every worker over the reduced
        gradients."""
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    def _barrier(self):
        """Collective barrier across workers (in-flight buckets drain
        first)."""
        if "dist" in self._type:
            if self._bucket_engine is not None:
                self._bucket_engine.finalize_all()
            if self.num_workers > 1:
                _Collective.get().barrier()

    def save_optimizer_states(self, fname):
        """The per-key Updater states as one pickle, written atomically;
        ``RowSparseState`` pickles as plain numpy. A sharded engine's flat
        shards checkpoint with the sharded Checkpointer, which the port has
        not yet."""
        assert self._updater is not None, "Cannot save states for distributed training"
        from . import checkpoint as ckpt

        eng = self._bucket_engine
        if eng is not None and eng._sharded_state:
            raise MXNetError("save_optimizer_states under MXNET_KVSTORE_UPDATE=sharded: "
                             "the sharded state set " + _NEXT)
        ckpt.atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Inverse of ``save_optimizer_states``; also reads a state file the
        JAX package's store wrote (``convert.load_states``). Each state goes
        onto its key's stored value's context. A torn or corrupt file
        raises a structured MXNetError naming the path."""
        assert self._updater is not None, "Cannot load states for distributed training"
        from .convert import load_states

        with open(fname, "rb") as fin:
            blob = fin.read()
        if blob[:1] == b"{":
            raise MXNetError("%r is a pointer to a sharded optimizer-state set, which %s"
                             % (fname, _NEXT))
        try:
            states = load_states(blob)
        except Exception as e:
            raise MXNetError(
                "optimizer-state file %r is torn or not a state pickle "
                "(%s: %s) — likely a crash mid-save; delete it and resume "
                "from the previous checkpoint" % (fname, type(e).__name__, e)) from e
        from .convert import states_on_context

        self._updater.states = {
            k: states_on_context(v, self._store[k].context if k in self._store else None)
            for k, v in states.items()}
        if self._bucket_engine is not None:
            self._bucket_engine.reseed_updater_states()

    # ------------------------------------------------------------- later items
    @property
    def elastic_state(self) -> str:
        raise MXNetError("KVStore.elastic_state: the elastic state machine " + _NEXT)

    def reform(self):
        raise MXNetError("KVStore.reform: re-forming over survivors " + _NEXT)

    def load_sharded_checkpoint(self, root, step=None):
        raise MXNetError("KVStore.load_sharded_checkpoint: the sharded checkpoint " + _NEXT)

    def _load_sharded_states(self, fname, pointer):
        raise MXNetError("KVStore._load_sharded_states: " + _NEXT)

    def _seed_states_from_manifest(self, root, step, manifest, flats=None,
                                   sparse_tables=None):
        raise MXNetError("KVStore._seed_states_from_manifest: " + _NEXT)

    def _seed_sparse_states(self, root, step, manifest, tables=None):
        raise MXNetError("KVStore._seed_sparse_states: " + _NEXT)


class _Pending:
    """An in-flight collective: ``wait()`` orders the caller's stream after
    it (NCCL) or blocks until it is done (gloo) and returns the result."""

    __slots__ = ("_work", "_finish", "_result")

    def __init__(self, work, finish):
        self._work, self._finish, self._result = work, finish, None

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            self._result = self._finish()
        return self._result


class _Collective:
    """The dist KVStore's collectives on the default process group. Every
    buffer lives on ``device``: the card for NCCL, the CPU for gloo. A sum
    whose wire dtype is narrower than its accumulate dtype (a bf16 bucket
    of float32 gradients) all-gathers the wire buffers and sums them in
    the accumulate dtype, in rank order: the sum never runs in bf16."""

    _cache = None  # (key, instance)

    @classmethod
    def get(cls):
        import torch.distributed as tdist

        key = (id(tdist.group.WORLD), tdist.get_world_size(), tdist.get_rank())
        if cls._cache is None or cls._cache[0] != key:
            cls._cache = (key, cls())
        return cls._cache[1]

    def __init__(self):
        import torch.distributed as tdist

        self.n_workers = tdist.get_world_size()
        self.rank = tdist.get_rank()
        self.backend = tdist.get_backend()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))

    def _fire(self):
        from . import faultinject as _fi

        _fi.fire("dist.collective")

    def broadcast(self, buf):
        import torch.distributed as tdist

        self._fire()
        tdist.broadcast(buf, src=0)

    def barrier(self):
        import torch.distributed as tdist

        tdist.barrier()

    def allreduce(self, flat, acc_dtype=None, async_op=False) -> _Pending:
        """The sum over workers of ``flat`` (1-D, on ``device``), in
        ``acc_dtype`` (default: its own)."""
        import torch.distributed as tdist

        self._fire()
        acc = acc_dtype or flat.dtype
        if acc == flat.dtype:
            work = tdist.all_reduce(flat, async_op=True)
            pend = _Pending(work, lambda: flat)
        else:
            gathered = torch.empty((self.n_workers * flat.numel(),), dtype=flat.dtype,
                                   device=flat.device)
            work = tdist.all_gather_into_tensor(gathered, flat, async_op=True)
            pend = _Pending(work, lambda: gathered.view(self.n_workers, -1).to(acc).sum(0))
        if not async_op:
            pend.wait()
        return pend

    def reduce_scatter(self, flat, acc_dtype=None, async_op=False) -> _Pending:
        """This worker's 1/W shard of the sum over workers of ``flat``
        (length a multiple of W)."""
        import torch.distributed as tdist

        self._fire()
        acc = acc_dtype or flat.dtype
        shard = flat.numel() // self.n_workers
        lo = self.rank * shard
        if acc != flat.dtype:
            full = self.allreduce(flat, acc_dtype=acc, async_op=True)
            pend = _Pending(full, lambda: full.wait()[lo:lo + shard])
        else:
            out = torch.empty((shard,), dtype=flat.dtype, device=flat.device)
            pend = _Pending(tdist.reduce_scatter_tensor(out, flat, async_op=True), lambda: out)
        if not async_op:
            pend.wait()
        return pend

    def all_gather(self, shard) -> torch.Tensor:
        """The concatenation of every worker's ``shard``, in rank order."""
        import torch.distributed as tdist

        self._fire()
        out = torch.empty((self.n_workers * shard.numel(),), dtype=shard.dtype,
                          device=shard.device)
        tdist.all_gather_into_tensor(out, shard.contiguous())
        return out

    def allgather_host(self, arr: np.ndarray) -> np.ndarray:
        """Every worker's int64 vector (same length on all), concatenated in
        rank order, back on the host."""
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(self.device)
        return self.all_gather(t).cpu().numpy()


# copied from mxnet_tpu/kvstore.py (_key_value, _group_kv; backend-free)
def _key_value(key, value):
    if isinstance(key, (list, tuple)):
        assert isinstance(value, (list, tuple)) and len(key) == len(value)
        return list(key), list(value)
    return [key], [value]


def _group_kv(key, value):
    """Group possibly-duplicate keys with per-device value lists
    (reference: kvstore_local.h:95 GroupKVPairs)."""
    if isinstance(key, (list, tuple)):
        if len(key) and isinstance(value, (list, tuple)) and len(value) == len(key) \
                and not isinstance(value[0], (list, tuple)):
            return list(key), [[v] for v in value]
        assert len(key) == len(value)
        return list(key), [list(v) if isinstance(v, (list, tuple)) else [v] for v in value]
    if isinstance(value, (list, tuple)):
        return [key], [list(value)]
    return [key], [[value]]


def create(name="local") -> KVStore:
    """Create a KVStore (reference: kvstore.py create). A ``dist*`` type
    joins the job ``tools/launch.py`` started (``dist.init``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    known = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
             "dist_tpu_sync", "dist_sync", "dist_device_sync", "dist_async")
    if name not in known:
        raise MXNetError("unknown KVStore type %r (known: %s)" % (name, known))
    if name == "dist_async":
        logging.warning(
            "KVStore 'dist_async' runs as SYNCHRONOUS all-reduce here: the "
            "collective design has no parameter server to absorb stale "
            "updates. Convergence semantics are those of dist_sync.")
    if "dist" in name:
        from . import dist

        dist.init()
    return KVStore(name)
