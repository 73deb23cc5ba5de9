"""Row-sparse storage kind: the recommender subsystem's foundation.

Counterpart of ``mxnet_tpu/sparse/__init__.py`` (docs/SPARSE.md). An
Embedding gradient only touches the rows a batch looked up, so shipping, or
running the optimizer over, the rest of a (vocab, dim) table is waste:

* ``RowSparseNDArray``: the ``row_sparse`` storage kind, a sorted unique
  ``indices`` vector plus the value ROWS of a logically dense
  ``(vocab, ...)`` array. ``to_dense``/``retain``/``from_dense`` convert;
  ``__add__`` merges two row-sparse values (the KVStore local reduce).
* ``embedding_backward``: the segment-sum backward of the Embedding lookup,
  rows summed per UNIQUE id over the ids sorted once on the host, so the
  sums run in one fixed order on any device (no atomics, the same bits
  every run).
* ``RowSparseState``: lazily grown row-sparse optimizer state, host numpy
  as in the JAX package: a row never touched has no state row at all.

Tensors live on the NDArrays' devices; indices are normalised on the host,
as in the JAX package. ``from_dense`` without ``rows`` scans the dense
gradient for non-zero rows, which reads one (vocab,) mask back to the host
(one sync a call, counted in ``embedding.host_syncs``).

Telemetry: ``embedding.rows_touched`` counts unique rows entering
``embedding_backward``/``from_dense``. Env knobs: ``MXNET_KVSTORE_SPARSE``
gates the sparse wire path, ``MXNET_SPARSE_DENSE_FALLBACK_PCT`` the density
past which a round ships dense (the update stays row-lazy either way).
"""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .. import telemetry as _tm
from ..ndarray import NDArray

__all__ = ["RowSparseNDArray", "row_sparse_array", "from_dense",
           "embedding_backward", "RowSparseState", "sparse_enabled",
           "dense_fallback_pct", "sparse_param_names", "normalize_row_ids"]

log = logging.getLogger("mxnet_tpu_torch.sparse")

DEFAULT_DENSE_FALLBACK_PCT = 50.0


# copied from mxnet_tpu/sparse/__init__.py (backend-free)
def sparse_enabled() -> bool:
    """MXNET_KVSTORE_SPARSE: `0` disables the sparse WIRE path (row-sparse
    pushes then ship dense buffers); the row-lazy update is not affected."""
    return os.environ.get("MXNET_KVSTORE_SPARSE", "1").lower() not in (
        "0", "off", "false")


def dense_fallback_pct() -> float:
    """MXNET_SPARSE_DENSE_FALLBACK_PCT: when a round's unique-row union
    touches at least this percentage of the table, the round ships the
    DENSE buffer instead. The optimizer update remains row-lazy."""
    raw = os.environ.get("MXNET_SPARSE_DENSE_FALLBACK_PCT", "")
    try:
        pct = float(raw) if raw else DEFAULT_DENSE_FALLBACK_PCT
        if not (0.0 < pct <= 100.0):
            raise ValueError(pct)
    except ValueError:
        log.warning("MXNET_SPARSE_DENSE_FALLBACK_PCT=%r is not in (0, 100]; "
                    "using %g", raw, DEFAULT_DENSE_FALLBACK_PCT)
        pct = DEFAULT_DENSE_FALLBACK_PCT
    return pct


def normalize_row_ids(rows) -> np.ndarray:
    """Sorted unique int64 row ids from an NDArray, tensor or array-like:
    the one boundary normalization every row-id consumer shares."""
    if isinstance(rows, NDArray):
        rows = rows.asnumpy()
    elif isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    return np.unique(np.asarray(rows).astype(np.int64).reshape(-1))


def _long_on(idx: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(device)


class RowSparseNDArray:
    """The ``row_sparse`` storage kind: ``indices``, sorted UNIQUE int32 row
    ids, shape (nnz,); ``values``, the corresponding rows, shape
    ``(nnz,) + shape[1:]``; ``shape``, the logical dense shape. A zero-nnz
    array is valid (the all-zero gradient)."""

    stype = "row_sparse"

    def __init__(self, indices, values, shape, ctx: Context = None):
        ctx = ctx or (values.context if isinstance(values, NDArray)
                      else current_context())
        if isinstance(indices, NDArray):
            indices = indices.asnumpy()
        elif isinstance(indices, torch.Tensor):
            indices = indices.detach().cpu().numpy()
        idx = np.asarray(indices).astype(np.int64).reshape(-1)
        if idx.size and (np.any(idx[1:] <= idx[:-1])
                         or idx[0] < 0 or idx[-1] >= shape[0]):
            raise MXNetError(
                "row_sparse indices must be sorted, unique and in "
                "[0, %d); got %r..." % (shape[0], idx[:8].tolist()))
        self.shape = tuple(int(s) for s in shape)
        vals = values if isinstance(values, NDArray) else NDArray(values, ctx=ctx)
        if tuple(vals.shape) != (idx.size,) + self.shape[1:]:
            raise MXNetError(
                "row_sparse values shape %s does not match %d indices of "
                "dense shape %s" % (tuple(vals.shape), idx.size, self.shape))
        self.indices = NDArray(torch.from_numpy(idx.astype(np.int32)), ctx=ctx)
        self.values = vals
        self._ctx = ctx
        self._host_idx = idx

    # ------------------------------------------------------------ properties
    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def size(self) -> int:
        """Stored element count (nnz rows x row size): what actually moves."""
        row = 1
        for s in self.shape[1:]:
            row *= int(s)
        return self.nnz * row

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def density(self) -> float:
        return self.nnz / max(1, self.shape[0])

    def host_indices(self) -> np.ndarray:
        """The indices as sorted int64 numpy (kept from construction: no
        read back from the device)."""
        return self._host_idx

    def __repr__(self):
        return "<RowSparseNDArray %s nnz=%d @%s>" % (
            "x".join(str(s) for s in self.shape), self.nnz, self.context)

    # ----------------------------------------------------------- conversions
    def to_dense(self) -> NDArray:
        """Scatter the rows into a dense NDArray of ``self.shape``."""
        vals = self.values._tensor()
        dense = torch.zeros(self.shape, dtype=vals.dtype, device=vals.device)
        if self.nnz:
            dense[_long_on(self._host_idx, vals.device)] = vals
        return NDArray(dense, ctx=self.context)

    def asnumpy(self) -> np.ndarray:
        return self.to_dense().asnumpy()

    def retain(self, row_ids) -> "RowSparseNDArray":
        """Keep only the rows named in ``row_ids``; rows absent from self
        come back as nothing, not zeros."""
        want = normalize_row_ids(row_ids)
        mine = self._host_idx
        keep = np.isin(mine, want)
        if keep.all():
            return self
        pos = np.flatnonzero(keep)
        vals = self.values._tensor()
        kept = vals[_long_on(pos, vals.device)]
        return RowSparseNDArray(mine[keep], NDArray(kept, ctx=self.context),
                                self.shape, ctx=self.context)

    def copy(self) -> "RowSparseNDArray":
        return RowSparseNDArray(self._host_idx, self.values.copy(), self.shape,
                                ctx=self.context)

    # ------------------------------------------------------------ arithmetic
    def __add__(self, other) -> "RowSparseNDArray":
        """Merge two row-sparse arrays on the index union: the KVStore local
        multi-device reduce for sparse gradients. Each side's rows are
        unique, so each scatter-add writes every position once."""
        if not isinstance(other, RowSparseNDArray):
            raise TypeError("row_sparse + %s is not defined" % type(other))
        if other.shape != self.shape:
            raise MXNetError("shape mismatch %s vs %s" % (self.shape, other.shape))
        a_idx, b_idx = self._host_idx, other._host_idx
        union = np.union1d(a_idx, b_idx)
        av, bv = self.values._tensor(), other.values._tensor()
        dt = torch.promote_types(av.dtype, bv.dtype)
        vals = torch.zeros((union.size,) + self.shape[1:], dtype=dt, device=av.device)
        if a_idx.size:
            vals.index_add_(0, _long_on(np.searchsorted(union, a_idx), av.device),
                            av.to(dt))
        if b_idx.size:
            vals.index_add_(0, _long_on(np.searchsorted(union, b_idx), av.device),
                            bv.to(device=av.device, dtype=dt))
        return RowSparseNDArray(union, NDArray(vals, ctx=self.context), self.shape,
                                ctx=self.context)

    def __mul__(self, scalar) -> "RowSparseNDArray":
        return RowSparseNDArray(self._host_idx, self.values * float(scalar), self.shape,
                                ctx=self.context)

    __rmul__ = __mul__


def row_sparse_array(data, shape, ctx=None) -> RowSparseNDArray:
    """Construct from ``(values, indices)`` (reference:
    mx.nd.sparse.row_sparse_array)."""
    values, indices = data
    ctx = ctx or (values.context if isinstance(values, NDArray) else current_context())
    if not isinstance(values, NDArray):
        values = NDArray(np.asarray(values), ctx=ctx)
    return RowSparseNDArray(indices, values, shape, ctx=ctx)


def from_dense(dense: NDArray, rows=None, shape=None) -> RowSparseNDArray:
    """Dense to row_sparse. With ``rows`` (the batch's looked-up ids) only
    those rows are gathered; without it, rows with any non-zero entry are
    found by a scan on the device whose (vocab,) mask is read back to the
    host: one sync a call."""
    shape = tuple(shape or dense.shape)
    d = dense._tensor().reshape(shape)
    if rows is not None:
        idx = normalize_row_ids(rows)
    else:
        mask = (d.reshape(shape[0], -1) != 0).any(dim=1)
        idx = torch.nonzero(mask).reshape(-1).cpu().numpy().astype(np.int64)
        if _tm.enabled():
            _tm.counter("embedding.host_syncs").inc()
    if _tm.enabled():
        _tm.counter("embedding.rows_touched").inc(int(idx.size))
    vals = d[_long_on(idx, d.device)]
    return RowSparseNDArray(idx, NDArray(vals, ctx=dense.context), shape,
                            ctx=dense.context)


def embedding_backward(data, ograd, input_dim) -> RowSparseNDArray:
    """Row-sparse gradient of an Embedding lookup by segment sum over the
    compacted unique ids (reference: the Embedding op's ``sparse_grad=True``
    backward). ``data``: the looked-up ids, any shape; ``ograd``: the output
    cotangent, shape ``data.shape + (dim,)``. The gradient rows are sorted
    by id on the host once, and each unique id's rows are summed in that
    order, so the result is the same bits on every run and device; the
    (vocab, dim) dense gradient is never materialized."""
    if isinstance(data, NDArray):
        ids = data.asnumpy()
    elif isinstance(data, torch.Tensor):
        ids = data.detach().cpu().numpy()
    else:
        ids = np.asarray(data)
    ids = ids.astype(np.int64).reshape(-1)
    if isinstance(ograd, NDArray):
        g, ctx = ograd._tensor(), ograd.context
    else:
        g = ograd if isinstance(ograd, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(ograd, dtype=np.float32))
        ctx = current_context() if g.is_cuda else Context("cpu", 0)
        g = g.to(ctx.torch_device)
    dim = int(g.shape[-1])
    g = g.reshape(-1, dim)
    if g.shape[0] != ids.size:
        raise MXNetError("embedding_backward: %d ids but %d gradient rows"
                         % (ids.size, g.shape[0]))
    uniq, counts = np.unique(ids, return_counts=True)
    if uniq.size and (uniq[0] < 0 or uniq[-1] >= input_dim):
        raise MXNetError("embedding_backward: id out of [0, %d)" % input_dim)
    if uniq.size:
        order = np.argsort(ids, kind="stable")
        rows = torch.segment_reduce(g[_long_on(order, g.device)], "sum",
                                    lengths=_long_on(counts, g.device))
    else:
        rows = g[:0]
    if _tm.enabled():
        _tm.counter("embedding.rows_touched").inc(int(uniq.size))
    return RowSparseNDArray(uniq, NDArray(rows, ctx=ctx), (int(input_dim), dim), ctx=ctx)


# copied from mxnet_tpu/sparse/__init__.py (backend-free)
class RowSparseState:
    """Lazily grown row-sparse optimizer state for one parameter:
    ``indices``, sorted unique rows that have EVER been updated; ``rows``,
    one ``(nnz, ...)`` host numpy array per optimizer state slot (SGD
    momentum: 1, Adam: 2). A row outside ``indices`` has no storage, so its
    state is a fresh Updater's zeros by construction. Pickles as plain
    numpy, the same state dict as the JAX package's."""

    def __init__(self, shape, dtype, n_states):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.n_states = int(n_states)
        self.indices = np.zeros((0,), np.int64)
        self.rows = [np.zeros((0,) + self.shape[1:], self.dtype)
                     for _ in range(self.n_states)]

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def gather(self, rows):
        """Per-slot state rows for ``rows`` (sorted unique int64): zeros for
        rows never updated."""
        out = [np.zeros((rows.size,) + self.shape[1:], self.dtype)
               for _ in range(self.n_states)]
        if self.indices.size:
            pos = np.searchsorted(self.indices, rows)
            pos = np.clip(pos, 0, self.indices.size - 1)
            hit = self.indices[pos] == rows
            for i in range(self.n_states):
                out[i][hit] = self.rows[i][pos[hit]]
        return out

    def scatter(self, rows, new_rows):
        """Write back updated state rows, growing the touched set."""
        if not rows.size:
            return
        union = np.union1d(self.indices, rows)
        if union.size != self.indices.size:
            grown = [np.zeros((union.size,) + self.shape[1:], self.dtype)
                     for _ in range(self.n_states)]
            if self.indices.size:
                old_pos = np.searchsorted(union, self.indices)
                for i in range(self.n_states):
                    grown[i][old_pos] = self.rows[i]
            self.indices, self.rows = union, grown
        pos = np.searchsorted(self.indices, rows)
        for i in range(self.n_states):
            self.rows[i][pos] = np.asarray(new_rows[i], self.dtype)

    def state_bytes(self) -> int:
        return sum(r.nbytes for r in self.rows) + self.indices.nbytes

    def __getstate__(self):
        return {"shape": self.shape, "dtype": self.dtype.name,
                "n_states": self.n_states, "indices": self.indices,
                "rows": self.rows}

    def __setstate__(self, d):
        self.shape = tuple(d["shape"])
        self.dtype = np.dtype(d["dtype"])
        self.n_states = int(d["n_states"])
        self.indices = np.asarray(d["indices"], np.int64)
        self.rows = [np.asarray(r, self.dtype) for r in d["rows"]]

    def __repr__(self):
        return "<RowSparseState %s nnz=%d x%d slots>" % (
            "x".join(str(s) for s in self.shape), self.nnz, self.n_states)


def sparse_param_names(symbol):
    """Names of parameters consumed as a sparse-grad embedding table: the
    weight input of every ``SparseEmbedding`` node and of every
    ``Embedding`` node carrying ``sparse_grad=True``."""
    names = []
    for node in symbol._topo():
        if node.is_variable:
            continue
        sparse = node.op == "SparseEmbedding"
        if node.op == "Embedding":
            flag = str(node.attrs.get("sparse_grad", "")).lower()
            sparse = flag in ("1", "true")
        if sparse and len(node.inputs) > 1:
            w = node.inputs[1][0]
            if w.is_variable:
                names.append(w.name)
    return names
