"""Where the optimizer runs, for the Module layer: the store-free part.

Counterpart of ``mxnet_tpu/kvstore_helper.py`` (:19-144; reference:
python/mxnet/model.py:40-116). On one device with a ``str`` store type that
is not ``dist*``, ``create_kvstore`` gives ``(None, False)`` exactly as the
JAX package does, and ``update_params`` runs the updater on each bound
parameter in place. A store (a ``KVStore`` object, a ``dist*`` type, or
more than one device) needs ``kvstore.py``, which comes with data
parallelism (``ROADMAP.md`` section 1.4): asking for one raises.
``initialize_kvstore`` and ``update_params_on_kvstore``, which only a
store calls, come with it.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["create_kvstore", "update_params"]

_NO_STORE = ("the port has no kvstore.py yet: a store, a dist* type and more than one "
             "device come with data parallelism (ROADMAP.md section 1.4)")


def create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` for ``None`` or a
    one-device, non-dist store type (JAX :19); anything else raises."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            # one device: the updater runs directly on the bound arrays
            return None, False
        raise MXNetError("kvstore %r over %d device(s): %s" % (kvstore, num_device, _NO_STORE))
    raise MXNetError("a %s store object: %s" % (type(kvstore).__name__, _NO_STORE))


def update_params(param_arrays, grad_arrays, updater, num_device, kvstore=None,
                  priorities=None):
    """Run the updater per device copy of each parameter that has a
    gradient, key ``index * num_device + k`` (JAX :121); the reduction
    through a store raises."""
    if kvstore:
        raise MXNetError("update_params through a store: %s" % _NO_STORE)
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays, grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (p, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, p)
