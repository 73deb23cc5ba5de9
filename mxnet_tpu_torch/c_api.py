"""Training-side C ABI: the build helper and the Python glue the embedded
interpreter calls (``csrc/host/c_api.cc``; reference: include/mxnet/c_api.h's
imperative slice, src/c_api/c_api_ndarray.cc:322 MXImperativeInvoke).

Counterpart of ``mxnet_tpu/c_api.py``. ``build()`` compiles
``libmxtpu_c.so`` into ``build/torch_native/`` (``_native_build``); C and
C++ programs link it beside ``include/mxtpu/c_api.h``, the JAX package's
header (the same ABI). The C library addresses everything through this
module, so the C side stays a thin GIL/refcount shim: op invocation by
registry name (string attrs parsed as in symbol JSON), ``simple_bind``
over a symbol JSON, KVStore verbs and host copies.

Devices: ``MXNDArrayCreate``'s ``dev_type`` is honoured as in the
reference, 1 the CPU and 2 the card (``device_context``); 2 on a host
without CUDA fails with an error that names CUDA, it never falls back to
the CPU. ``MXTrainExecutorCreate`` takes no device: it binds on the default
context, the card unless ``MXNET_DEFAULT_CONTEXT=cpu``.
"""
from __future__ import annotations

import numpy as np

from ._native_build import build as _build, lib_file, LIBS

__all__ = ["build", "lib_path"]


def lib_path():
    return lib_file(LIBS["c_api"][1])


def build(force=False):
    """Compile (if stale) and return the .so path; None if no toolchain."""
    return _build("c_api", force=force)


# ---------------------------------------------------------------- C-side glue
def device_context(dev_type, dev_id):
    """The Context a C caller's ``dev_type``/``dev_id`` name (reference:
    1 kCPU, 2 kGPU). A card that is not there raises."""
    from .base import MXNetError
    from .context import cpu, gpu

    if dev_type == 1:
        return cpu(dev_id)
    if dev_type == 2:
        ctx = gpu(dev_id)
        ctx.torch_device  # raises MXNetError naming CUDA when there is none
        return ctx
    raise MXNetError("dev_type %r: 1 is the CPU, 2 the CUDA card" % (dev_type,))


def zeros(shape, dev_type=1, dev_id=0):
    from . import ndarray as nd

    return nd.zeros(tuple(int(d) for d in shape), ctx=device_context(dev_type, dev_id))


def copy_from_host(arr, mem):
    # .copy(): the C caller frees its buffer right after this returns
    data = np.frombuffer(mem, dtype=np.float32).reshape(arr.shape).copy()
    arr[:] = data
    return True


def waitall():
    from . import ndarray as nd

    nd.waitall()
    return True


def invoke(op_name, inputs, keys, vals, outs):
    """MXImperativeInvokeByName glue: string attr values, optional in-place
    ``out=`` targets. Returns the output list (possibly the out targets)."""
    from . import ndarray as nd
    from .ops.registry import get_op, parse_attrs

    attrs = dict(zip(keys, vals))
    if outs is not None:
        # an undersized out list would silently drop outputs (e.g.
        # sgd_mom_update's momentum): refuse
        opdef = get_op(op_name)
        n_out = opdef.num_outputs(parse_attrs(opdef, dict(attrs)))
        if len(outs) != n_out:
            raise ValueError(
                "%s produces %d outputs but %d out targets were supplied"
                % (op_name, n_out, len(outs)))
    res = nd.imperative_invoke(op_name, list(inputs), attrs,
                               out=list(outs) if outs is not None else None)
    return list(res)


def bind_from_json(symbol_json, shapes):
    from . import symbol as sym
    from .context import current_context

    net = sym.load_json(symbol_json)
    # the named inputs (data/labels: the keys the C caller gave shapes for)
    # get grad_req null, so MXExecutorGetGrad returns NULL for them, the
    # header's parameter-vs-input idiom; every other argument is trainable
    grad_req = {n: ("null" if n in shapes else "write")
                for n in net.list_arguments()}
    return net.simple_bind(current_context(), grad_req=grad_req,
                           **{k: tuple(v) for k, v in shapes.items()})


def arg_names(ex):
    return list(ex.arg_dict.keys())


def get_arg(ex, name):
    if name not in ex.arg_dict:
        raise KeyError("unknown argument %r" % name)
    return ex.arg_dict[name]


def get_grad(ex, name):
    if name not in ex.grad_dict:
        raise KeyError("unknown argument %r" % name)
    return ex.grad_dict[name]


def kv_create(type_str):
    from . import kvstore

    return kvstore.create(type_str)


def kv_init(kv, keys, vals):
    kv.init(list(keys), list(vals))
    return True


def kv_push(kv, keys, vals):
    kv.push(list(keys), list(vals))
    return True


def kv_pull(kv, keys, outs):
    kv.pull(list(keys), out=list(outs))
    return True
