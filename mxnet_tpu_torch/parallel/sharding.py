"""Sharding rules: map symbol arguments to partition specs.

Counterpart of ``mxnet_tpu/parallel/sharding.py``, with each spec a plain
tuple (``()`` replicated, ``("data", None)`` rows over the data axis,
``("model", None)`` a weight's out-dim over the model axis), as
``jax.sharding.PartitionSpec`` lists them. The rules are computed and
checked (divisibility) as in the JAX package, and the sharding-plan lint
will read them. Within one process they place nothing: the port's trainer
runs the global batch as one program on the mesh's one physical device
(``parallel/mesh.py``), so a spec changes no value. Across processes the
batch spec says which rows each rank feeds.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["ShardingRules", "param_pspec", "shardable_dims", "MIN_SHARD_ELEMS"]

# the shard-or-replicate boundary (inclusive: prod(shape) >= this shards),
# shared with the sharding-plan lint's GL401 threshold in the JAX package
MIN_SHARD_ELEMS = 2 ** 16


# copied from mxnet_tpu/parallel/sharding.py (backend-free)
def shardable_dims(shape, model_size):
    """Dims of a rank-2 parameter that divide evenly over ``model_size``,
    largest first — the candidate order ``param_pspec`` tries. Conv filters
    and other rank>2 params return () (replicated by policy: their FLOPs are
    already parallel over the sharded batch)."""
    if model_size <= 1 or len(shape) != 2:
        return ()
    # out-dim first (the classic Megatron column split); the remaining dims,
    # largest first, are the divisibility fallback
    order = [0] + sorted(range(1, len(shape)), key=lambda d: -shape[d])
    return tuple(d for d in order if shape[d] % model_size == 0)


def param_pspec(name, shape, model_axis="model", model_size=1,
                min_shard_elems=MIN_SHARD_ELEMS):
    """Default tensor-parallel rule for a parameter (JAX :42-70), as a tuple.

    Shards large rank-2 weights — FC ``(out, in)``, embedding ``(vocab,
    dim)`` — over the ``model`` axis: the out/vocab dim when it divides
    evenly, else the other dim; only when neither divides does it give up to
    full replication. Everything else (conv filters, biases, BN stats) is
    replicated. Arrays with ``prod(shape) >= min_shard_elems`` are
    shardable; strictly smaller arrays replicate."""
    if model_size <= 1 or len(shape) != 2:
        return ()
    if int(np.prod(shape)) < min_shard_elems:
        return ()
    dims = shardable_dims(shape, model_size)
    if not dims:
        return ()
    spec = [None] * len(shape)
    spec[dims[0]] = model_axis  # best candidate wins; the rest are fallback
    return tuple(spec)


class ShardingRules:
    """Bundle of sharding decisions for one training program (JAX :73-144).

    ``data_axis``/``model_axis`` name mesh axes. ``param_rule(name, shape) ->
    spec`` decides parameter layout (default: ``param_pspec``). Data/label
    batches are sharded on dim 0 over the data axis.

    ``mesh`` may be a ``parallel.mesh.Mesh`` or an abstract ``MeshSpec``:
    only ``axis_names``/``shape`` are read."""

    def __init__(self, mesh, data_axis="data", model_axis="model",
                 param_rule: Optional[Callable] = None, seq_axis=None):
        self.mesh = mesh
        self.data_axis = data_axis if data_axis in mesh.axis_names else None
        self.model_axis = model_axis if model_axis in mesh.axis_names else None
        self.seq_axis = seq_axis if seq_axis in (mesh.axis_names or ()) else None
        self._param_rule = param_rule

    # copied from mxnet_tpu/parallel/sharding.py (infer_axes; backend-free)
    @classmethod
    def infer_axes(cls, mesh, param_rule=None):
        """Rules for a mesh whose axes are not named data/model: the first
        axis NOT literally named 'model' is the data (batch) axis, and the
        model axis is the one named 'model' if present, else the second
        remaining axis."""
        names = tuple(mesh.axis_names)
        if "data" in names:
            data_axis = "data"
        else:
            data_axis = next((n for n in names if n != "model"), None)
        if "model" in names and "model" != data_axis:
            model_axis = "model"
        else:
            rest = [n for n in names if n != data_axis]
            model_axis = rest[0] if rest else "__none__"
        return cls(mesh, data_axis=data_axis or "__none__",
                   model_axis=model_axis, param_rule=param_rule)

    @property
    def data_parallel_size(self):
        return self.mesh.shape[self.data_axis] if self.data_axis else 1

    @property
    def model_parallel_size(self):
        return self.mesh.shape[self.model_axis] if self.model_axis else 1

    def batch_spec(self, shape):
        if not self.data_axis or not shape:
            return ()
        if self.seq_axis and len(shape) >= 2:
            return (self.data_axis, self.seq_axis) + (None,) * (len(shape) - 2)
        return (self.data_axis,) + (None,) * (len(shape) - 1)

    def param_spec(self, name, shape):
        if self._param_rule is not None:
            return tuple(self._param_rule(name, shape))
        if not self.model_axis:
            return ()
        return param_pspec(name, shape, self.model_axis, self.model_parallel_size)

    def check(self, shape, spec):
        """Raise unless every sharded dim of ``shape`` divides evenly over
        its mesh axes (the check ``jax.device_put`` makes in the JAX
        package)."""
        from ..base import MXNetError

        for dim, axis in zip(shape, spec):
            if axis is None:
                continue
            size = int(np.prod([self.mesh.shape[a] for a in
                                (axis if isinstance(axis, tuple) else (axis,))]))
            if dim % size:
                raise MXNetError("dimension %d of shape %s does not split evenly over mesh "
                                 "axis %r of size %d" % (dim, tuple(shape), axis, size))
