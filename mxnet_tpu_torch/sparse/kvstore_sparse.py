"""Sparse push rounds for the KVStore (docs/SPARSE.md).

Counterpart of ``mxnet_tpu/sparse/kvstore_sparse.py``. The bucketed engine
owns DENSE gradients at fixed offsets; which rows a row-sparse gradient
moves changes every round, so sparse keys bypass the bucket plan and run
through this engine:

1. **Index union**: the round's working set is the union of every
   worker's touched rows, gathered in two steps: the counts, then the id
   vectors padded to the largest count with -1.
2. **Padded-row collective**: the union's rows scatter into a
   ``(U_pad, row)`` buffer, ``U_pad`` the next power of two >= U, and one
   all-reduce sums it. torch does not retrace on a new shape, but the
   padding is kept so that ``kvstore.bytes.sparse`` (the padded wire
   formula, ``2·(W-1)/W·N``) counts what the JAX package's counts.
3. **Lazy update**: the reduced rows go through
   ``optimizer.update_row_sparse``: only union rows pass through the flat
   kernel; untouched rows keep their weight AND optimizer state.
4. **Dense fallback**: when the union covers at least
   ``MXNET_SPARSE_DENSE_FALLBACK_PCT`` of the table (or
   ``MXNET_KVSTORE_SPARSE=0``), the round ships the dense buffer through
   the ordinary all-reduce and re-sparsifies it against the union before
   the optimizer sees it, so the update stays row-lazy.

Telemetry: ``kvstore.sparse_rows_pushed``, ``kvstore.bytes.sparse``,
``kvstore.sparse_dense_fallbacks`` counters and ``kvstore.sparse_push``
spans.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..base import MXNetError
from .. import telemetry as _tm
from ..ndarray import NDArray
from . import RowSparseNDArray, dense_fallback_pct, from_dense, sparse_enabled

__all__ = ["SparseEngine"]


# copied from mxnet_tpu/sparse/kvstore_sparse.py (_next_pow2, and sparse_states
# below; backend-free)
def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class SparseEngine:
    """Per-KVStore engine for row-sparse keys; optimizer state lives in the
    Updater's per-key ``RowSparseState``."""

    def __init__(self, kv):
        self._kv = kv
        self._keys: Dict = {}  # key -> (shape, dtype str)

    def _dist(self) -> bool:
        return "dist" in self._kv._type and self._kv.num_workers > 1

    def _coll(self):
        from ..kvstore import _Collective

        return _Collective.get()

    def _register(self, key, rsp: RowSparseNDArray):
        stored = self._kv._store[key]
        if tuple(stored.shape) != tuple(rsp.shape):
            raise MXNetError(
                "sparse push of key %s: gradient dense shape %s does not "
                "match the stored value %s" % (key, tuple(rsp.shape), tuple(stored.shape)))
        self._keys[key] = (tuple(rsp.shape), str(stored.dtype))

    # ----------------------------------------------------------------- rounds
    def push(self, key, rsp: RowSparseNDArray, priority=0):
        """One key's locally reduced row-sparse gradient: union the touched
        rows across workers, reduce the rows, lazily update the store."""
        if key not in self._keys:
            self._register(key, rsp)
        shape, dtype = self._keys[key]
        vocab = shape[0]
        local_idx = rsp.host_indices()
        union = self._allgather_union(local_idx, vocab) if self._dist() else local_idx
        pct = 100.0 * union.size / max(1, vocab)
        go_dense = (not sparse_enabled()) or pct >= dense_fallback_pct()
        sp = _tm.NULL_SPAN
        if _tm.enabled():
            sp = _tm.span("kvstore.sparse_push", key=key, rows=int(union.size), vocab=vocab,
                          density_pct=round(pct, 3), dense_wire=go_dense, priority=priority)
        with sp:
            if go_dense:
                reduced = self._dense_wire_round(key, rsp, union, dtype)
            else:
                reduced = self._sparse_wire_round(key, rsp, union, local_idx, shape, dtype)
            self._apply(key, reduced)

    def _allgather_union(self, local_idx, vocab):
        """Sorted unique union of every worker's touched rows: the counts,
        then the id vectors padded with -1 to the largest count."""
        coll = self._coll()
        counts = coll.allgather_host(np.asarray([local_idx.size], np.int64))
        cap = int(counts.max())
        if cap == 0:
            return np.zeros((0,), np.int64)
        padded = np.full((cap,), -1, np.int64)
        padded[:local_idx.size] = local_idx
        allv = coll.allgather_host(padded)
        union = np.unique(allv[allv >= 0])
        if union.size and (union[0] < 0 or union[-1] >= vocab):
            raise MXNetError("sparse push: row id out of [0, %d)" % vocab)
        return union

    def _sparse_wire_round(self, key, rsp, union, local_idx, shape, dtype):
        """Reduce only the union rows: scatter the local rows into the padded
        (U_pad, row) buffer, one all-reduce, slice back."""
        row_shape = tuple(shape[1:])
        U = int(union.size)
        U_pad = _next_pow2(U)
        stored = self._kv._store[key]
        vals = rsp.values._tensor()
        dev = self._coll().device if self._dist() else vals.device
        buf = torch.zeros((U_pad,) + row_shape, dtype=stored._tensor().dtype, device=dev)
        if local_idx.size:
            pos = torch.from_numpy(np.searchsorted(union, local_idx)).to(dev)
            buf[pos] = vals.to(device=dev, dtype=buf.dtype)
        if self._dist():
            coll = self._coll()
            W = coll.n_workers
            itemsize = np.dtype(dtype).itemsize
            row_elems = int(np.prod(row_shape)) if row_shape else 1
            wire = int(2 * (W - 1) / W * U_pad * row_elems * itemsize)
            out = coll.allreduce(buf.reshape(-1)).wait()
            rows = out.reshape((U_pad,) + row_shape)[:U]
            if _tm.enabled():
                _tm.counter("kvstore.bytes.sparse").inc(wire)
        else:
            rows = buf[:U]
        if _tm.enabled():
            _tm.counter("kvstore.sparse_rows_pushed").inc(U)
        rows = rows.to(stored._tensor().device)
        return RowSparseNDArray(union, NDArray(rows, ctx=stored.context), shape,
                                ctx=stored.context)

    def _dense_wire_round(self, key, rsp, union, dtype):
        """Near-dense round: ship the dense buffer through the all-reduce,
        then re-sparsify against the union so the UPDATE stays row-lazy."""
        if _tm.enabled():
            _tm.counter("kvstore.sparse_dense_fallbacks").inc()
            _tm.counter("kvstore.sparse_rows_pushed").inc(int(union.size))
        dense = rsp.to_dense()
        if self._dist():
            coll = self._coll()
            W = coll.n_workers
            wire = int(2 * (W - 1) / W * dense.size * np.dtype(dtype).itemsize)
            t = dense._tensor()
            out = coll.allreduce(t.reshape(-1).to(coll.device)).wait()
            dense = NDArray(out.reshape(dense.shape).to(t.device), ctx=dense.context)
            if _tm.enabled():
                _tm.counter("kvstore.bytes.allreduce").inc(wire)
        return from_dense(dense, rows=union)

    def _apply(self, key, reduced: RowSparseNDArray):
        kv = self._kv
        stored = kv._store[key]
        if kv._updater is not None:
            kv._updater(key, reduced, stored)
            return
        # no updater: a sparse push REPLACES the touched rows
        rows = reduced.host_indices()
        if rows.size:
            t = stored._tensor()
            t[torch.from_numpy(rows).to(t.device)] = \
                reduced.values._tensor().to(device=t.device, dtype=t.dtype)

    # ------------------------------------------------------------- checkpoint
    def sparse_states(self):
        """``{key: (shape, dtype, RowSparseState)}`` for every registered
        sparse key whose Updater state is row-sparse: the checkpoint
        writer's view (``checkpoint.sparse_shard_arrays``)."""
        from . import RowSparseState

        upd = self._kv._updater
        out = {}
        if upd is None:
            return out
        for key, (shape, dtype) in self._keys.items():
            st = upd.states.get(key)
            if isinstance(st, RowSparseState):
                out[key] = (shape, dtype, st)
        return out
