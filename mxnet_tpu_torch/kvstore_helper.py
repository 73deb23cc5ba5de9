# copied from mxnet_tpu/kvstore_helper.py (backend-free)
"""KVStore/updater plumbing for the Module layer.

Counterpart of ``mxnet_tpu/kvstore_helper.py`` (reference:
python/mxnet/model.py:40-116 _create_kvstore, _initialize_kvstore,
_update_params_on_kvstore, _update_params): the glue that decides where the
optimizer runs and moves gradients through the store.
"""
from __future__ import annotations

from . import kvstore as kvs

__all__ = ["create_kvstore", "initialize_kvstore", "update_params_on_kvstore",
           "update_params"]


def create_kvstore(kvstore, num_device, arg_params):
    """Decide kvstore + update_on_kvstore (reference: model.py:40)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            # one device: the updater runs directly on the bound arrays
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                # the reference's heuristic: big arrays → update on the store
                max_size = max(np_prod(param.shape) for param in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def np_prod(shape):
    p = 1
    for s in shape:
        p *= int(s)
    return p


def initialize_kvstore(kvstore, param_arrays, arg_params, param_names, update_on_kvstore):
    """(reference: model.py _initialize_kvstore)"""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def update_params_on_kvstore(param_arrays, grad_arrays, kvstore, priorities=None,
                             sparse_indices=()):
    """(reference: model.py:88) Push the gradients (the store reduces them
    and runs the optimizer), pull the new weights back to every device.

    On bucketed dist stores the pushes go per key in reverse-topo order
    with ``priority=-index`` and the pulls in forward order, so the first
    layer's weights finalize while deeper buckets are still in flight;
    other stores take one batched round. ``sparse_indices`` names the
    parameters whose producer declared a row-sparse gradient: their dense
    gradient buffers convert here (``from_dense``, a scan for non-zero
    rows) and take the sparse round and the lazy update."""
    keys, grads, args = [], [], []
    sparse_set = set(sparse_indices or ())
    if sparse_set:
        from .sparse import from_dense
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
        if grad_list[0] is None:
            continue
        keys.append(index)
        if index in sparse_set:
            grad_list = [from_dense(g) for g in grad_list]
        grads.append(grad_list)
        args.append(arg_list)
    if not keys:
        return
    if _bucketed(kvstore):
        prio = dict(priorities or {})
        for k, g in zip(reversed(keys), reversed(grads)):
            kvstore.push(k, g, priority=prio.get(k, -k))
        for k, a in zip(keys, args):
            kvstore.pull(k, a, priority=prio.get(k, -k))
        return
    kvstore.push(keys, grads)
    kvstore.pull(keys, args)


def _bucketed(kvstore) -> bool:
    """True when the store's bucket engine takes per-key pushes
    (multi-process dist, MXNET_KVSTORE_BUCKET not disabled)."""
    try:
        return "dist" in kvstore.type and kvstore._engine() is not None
    except Exception:
        return False


def update_params(param_arrays, grad_arrays, updater, num_device, kvstore=None,
                  priorities=None):
    """(reference: model.py:99) Optionally reduce through the store, then
    run the updater on each device copy, key ``index * num_device + k``."""
    live = [(i, a, g) for i, (a, g) in enumerate(zip(param_arrays, grad_arrays))
            if g[0] is not None]
    if kvstore and live:
        keys = [i for i, _, _ in live]
        if _bucketed(kvstore):
            prio = dict(priorities or {})
            for i, _, g in reversed(live):
                kvstore.push(i, g, priority=prio.get(i, -i))
            for i, _, g in live:
                kvstore.pull(i, g, priority=prio.get(i, -i))
        else:
            kvstore.push(keys, [g for _, _, g in live])
            kvstore.pull(keys, [g for _, _, g in live])
    for index, arg_list, grad_list in live:
        for k, p, g in zip(range(len(arg_list)), arg_list, grad_list):
            updater(index * num_device + k, g, p)
