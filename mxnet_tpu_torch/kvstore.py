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
(``sparse/kvstore_sparse.py``). Optimizer states save as one replicated
pickle, or, under ``MXNET_KVSTORE_UPDATE=sharded``, as a pointer file to a
``checkpoint.Checkpointer`` shard set. ``reform`` and ``elastic_state``
carry the elastic re-form (``module/elastic.py``).
"""
from __future__ import annotations

import json
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
        count is 0. Under ``MXNET_ELASTIC=1`` membership is tracked by the
        heartbeat files and the scan is authoritative; ``timeout`` defaults
        to ``MXNET_ELASTIC_DEAD_TIMEOUT`` (JAX :368)."""
        from . import dist

        if "dist" in self._type and dist.elastic_enabled():
            if timeout is None:
                return dist.num_dead_nodes(timeout=dist.dead_timeout_seconds())
            return dist.num_dead_nodes(timeout=timeout)
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
        (``MXNET_KVSTORE_BUCKET=0`` keeps the unbucketed collective). One
        worker runs it too when ``MXNET_KVSTORE_UPDATE=sharded`` asks for
        the flat sharded update, whose state the sharded checkpoint saves;
        the JAX package's store builds no engine for one process
        (``mxnet_tpu/kvstore.py:254``), so there the knob does nothing."""
        if self._bucket_engine is not None:
            return self._bucket_engine
        if "dist" not in self._type:
            return None
        if os.environ.get("MXNET_KVSTORE_BUCKET", "1").lower() in ("0", "off", "false"):
            return None
        from .kvstore_bucket import update_mode

        if self.num_workers == 1 and update_mode() != "sharded":
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
        """Persist optimizer state. Replicated/local: the per-key Updater
        states as one pickle, written atomically (``RowSparseState`` pickles
        as plain numpy). Sharded (MXNET_KVSTORE_UPDATE=sharded): each worker
        writes its 1/W flat shard to ``<fname>.sharded/step-<N>/`` plus a
        digest-guarded manifest, and ``fname`` itself becomes a small
        pointer file that ``load_optimizer_states`` resolves (JAX :393)."""
        assert self._updater is not None, "Cannot save states for distributed training"
        from . import checkpoint as ckpt

        eng = self._bucket_engine
        # only the flat-sharded engine takes the pointer-file path; a
        # replicated/local store, sparse keys or not, keeps the pickle
        if eng is not None and eng._sharded_state:
            eng.finalize_all()
            opt = self._optimizer
            step = int(opt.num_update) if opt is not None else 0
            # a writer for this save only: fname is epoch-numbered under
            # module_checkpoint, so a cached one would never be reused
            writer = ckpt.Checkpointer(fname + ".sharded")
            try:
                writer.save_sharded(self, step, block=True)
            finally:
                writer.close()
            ckpt.atomic_write_bytes(fname, json.dumps(
                {"format": "mxtpu-sharded-states", "dir": fname + ".sharded",
                 "step": step}).encode())
            return
        ckpt.atomic_write_bytes(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Inverse of ``save_optimizer_states``; also reads a state file or a
        sharded set the JAX package's store wrote. A pickle's states go onto
        each key's stored value's context. A sharded pointer loads through
        ``checkpoint``: shard-direct when the live plan and world match the
        manifest (bit parity), else re-flattened into per-key states. A torn
        or corrupt file raises a structured MXNetError naming the path."""
        assert self._updater is not None, "Cannot load states for distributed training"
        from . import checkpoint as ckpt
        from .convert import load_states, states_on_context

        pointer = ckpt.read_sharded_pointer(fname)
        if pointer is not None:
            self._load_sharded_states(fname, pointer)
            return
        with open(fname, "rb") as fin:
            blob = fin.read()
        try:
            states = load_states(blob)
        except Exception as e:
            raise MXNetError(
                "optimizer-state file %r is torn or not a state pickle "
                "(%s: %s) — likely a crash mid-save; delete it and resume "
                "from the previous checkpoint" % (fname, type(e).__name__, e)) from e
        self._updater.states = {
            k: states_on_context(v, self._store[k].context if k in self._store else None)
            for k, v in states.items()}
        if self._bucket_engine is not None:
            self._bucket_engine.reseed_updater_states()

    def _load_sharded_states(self, fname, pointer):
        from . import checkpoint as ckpt

        root, step = pointer["dir"], pointer["step"]
        manifest = ckpt.load_manifest(root, step)
        if manifest is None:
            raise MXNetError(
                "sharded optimizer-state pointer %r names step %s in %r but "
                "no readable manifest exists there — the checkpoint set is "
                "torn or was deleted" % (fname, step, root))
        self._check_flat_spec(manifest, fname)
        self._seed_states_from_manifest(root, step, manifest)

    def _check_flat_spec(self, manifest, path):
        """The live optimizer must lower to the same flat kernel family as
        the one that wrote the checkpoint."""
        opt = self._optimizer
        if opt is None:
            return
        kind, _, n_states = opt.flat_update_spec() or (None, None, None)
        want = manifest["optimizer"]
        if kind is not None and (want["kind"] != kind or want["n_states"] != n_states):
            raise MXNetError(
                "sharded optimizer states at %r were saved by a %r "
                "optimizer (%d state slots); the live optimizer %s "
                "lowers to %r (%d slots) — states are not portable "
                "across optimizer kinds"
                % (path, want["kind"], want["n_states"], type(opt).__name__, kind, n_states))

    def _on_context(self, key, arr):
        """A host array as an NDArray on ``key``'s stored value's context."""
        ctx = self._store[key].context if key in self._store else None
        if ctx is None:
            from .context import current_context

            ctx = current_context()
        return NDArray(torch.from_numpy(np.array(arr, copy=True)).to(ctx.torch_device), ctx=ctx)

    def _seed_states_from_manifest(self, root, step, manifest, flats=None,
                                   sparse_tables=None):
        """Seed optimizer state from a sharded checkpoint step: shard-direct
        when the live plan and world match (momentum bit parity), else
        re-flatten every worker's shard into per-key Updater states. Update
        counts restore from the manifest either way (JAX :496)."""
        from . import checkpoint as ckpt

        eng = self._bucket_engine
        same_world = manifest["world"] == self.num_workers
        if (eng is not None and eng.plan is not None and same_world
                and eng.mode == "sharded" and eng.plan.hash == manifest.get("plan_hash")):
            # shard-direct: this worker's own shard seeds its flat slices
            n_states = manifest["optimizer"]["n_states"]
            if flats is not None:
                # every shard was read and verified already: slice ours out
                world = int(manifest["world"])
                shards = {}
                for b in manifest["plan"]["buckets"]:
                    idx = int(b["index"])
                    sliced = []
                    for s in flats[idx]["states"]:
                        n = s.shape[0] // world
                        sliced.append(s[self.rank * n:(self.rank + 1) * n])
                    shards[idx] = sliced
            else:
                local = ckpt.read_local_shard(root, step, manifest, self.rank)
                shards = {int(b["index"]): [local["b%d.s%d" % (int(b["index"]), i)]
                                            for i in range(n_states)]
                          for b in manifest["plan"]["buckets"]}
            eng.preload_flat_shards(shards)
        else:
            if flats is None:
                flats = ckpt.read_flat_buckets(root, step, manifest)
            for key, tup in ckpt.per_key_states(manifest, flats).items():
                nds = tuple(self._on_context(key, a) for a in tup)
                self._updater.states[key] = nds[0] if len(nds) == 1 else nds if nds else None
            if eng is not None:
                eng.reseed_updater_states()
        self._seed_sparse_states(root, step, manifest, tables=sparse_tables)
        opt = self._optimizer
        if opt is not None:
            for key, count in manifest.get("update_counts", ()):
                opt._index_update_count[key] = int(count)
            opt.num_update = max(opt.num_update, int(manifest.get("num_update", 0)))

    def _seed_sparse_states(self, root, step, manifest, tables=None):
        """Seed row-sparse optimizer states from the manifest's sparse
        section, re-assembled by concatenation: any reader world resumes
        bit-identically from any writer world."""
        from . import checkpoint as ckpt

        if not manifest.get("sparse"):
            return
        from .sparse import RowSparseState

        if tables is None:
            tables = ckpt.read_sparse_tables(root, step, manifest)
        for row in manifest["sparse"]:
            key = row["key"]
            t = tables[key]
            st = RowSparseState(tuple(row["shape"]), row["dtype"], int(row["n_states"]))
            st.indices = t["indices"]
            st.rows = [np.asarray(s, st.dtype) for s in t["states"]]
            self._updater.states[key] = st

    # ---------------------------------------------------------------- elastic
    #
    # The pause/re-form/resume state machine:
    #
    #     running --(pause decision agreed)--> paused
    #     paused  --(dist.reform succeeded)--> reforming
    #     reforming --(weights/state reseeded)--> resuming
    #     resuming --(first post-re-form round)--> running
    #
    # Driven by module.elastic.ElasticFit (JAX :591-643).

    _ELASTIC_STATES = ("running", "paused", "reforming", "resuming")

    @property
    def elastic_state(self) -> str:
        """Where this store is in the elastic state machine; ``running``
        outside a recovery window (and always, for non-elastic jobs)."""
        return getattr(self, "_elastic_state", "running")

    def _set_elastic_state(self, state):
        assert state in self._ELASTIC_STATES, state
        self._elastic_state = state
        if _tm.enabled():
            _tm.event("kvstore.elastic_state", state=state)
            _tm.gauge("kvstore.elastic_paused").set(0 if state == "running" else 1)

    def _reseed(self, key, value):
        """Overwrite one stored weight (the recovery path: ``init`` refuses
        duplicates, but a re-formed worker reseeding from a checkpoint must
        replace)."""
        if key not in self._store:
            raise MXNetError("cannot reseed key %s before init" % key)
        self._store[key] = value.copy()

    def reform(self):
        """Re-form this store over the CURRENT (post-recovery) process set:
        drop the collective of the old process group and re-plan the bucket
        engine for the new worker count. The caller (``dist.reform`` via the
        elastic controller) has already re-formed the process group; store
        values and optimizer state are reseeded afterwards."""
        if "dist" not in self._type:
            return
        self._set_elastic_state("reforming")
        _Collective._cache = None  # the old group's collective must not survive
        if self._bucket_engine is not None:
            self._bucket_engine.reform()
        # survivors must re-prove push-stream agreement over the new world
        self.rearm_verify()

    def load_sharded_checkpoint(self, root, step=None):
        """Seed stored WEIGHTS and optimizer state from a sharded checkpoint
        set under ``root``: the recovery path after an elastic re-form, and
        the cold start of a job relaunched at another world size.
        ``step=None`` takes the newest COMPLETE step. Weight keys must be
        inited already. Returns ``(step, weights)``, ``weights`` mapping key
        -> host numpy array for the caller to adopt into its executors.

        Raises a structured ``MXNetError`` when no complete checkpoint
        exists, the manifest is for another optimizer family, or the shard
        set fails its digest check."""
        from . import checkpoint as ckpt

        if step is None:
            got = ckpt.latest_complete(root)
            if got is None:
                raise MXNetError(
                    "no COMPLETE sharded checkpoint under %r — nothing to "
                    "recover from (a torn/in-flight step does not count)" % (root,))
            step, manifest = got
        else:
            manifest = ckpt.load_manifest(root, step)
            if manifest is None:
                raise MXNetError("checkpoint step %s under %r has no readable manifest"
                                 % (step, root))
        if manifest.get("kind") != "sharded":
            raise MXNetError("checkpoint step %s under %r is %r, not a sharded set"
                             % (step, root, manifest.get("kind")))
        self._check_flat_spec(manifest, root)
        with _tm.span("checkpoint.load", step=step, world=manifest.get("world")):
            # ONE disk + sha256 pass over the shard set; the flats, sparse
            # tables and the state seeding below all slice from it
            shards = ckpt.read_shard_set(root, step, manifest)
            flats = ckpt.read_flat_buckets(root, step, manifest, shards=shards)
            weights = ckpt.per_key_states(manifest, flats, weights=True)
            sparse_tables = ckpt.read_sparse_tables(root, step, manifest, shards=shards)
            for key, t in sparse_tables.items():
                weights[key] = t["w"]
            for key, w in weights.items():
                if key in self._store:
                    self._store[key] = self._on_context(key, w)
            self._seed_states_from_manifest(root, step, manifest, flats=flats,
                                            sparse_tables=sparse_tables)
        return step, weights


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
