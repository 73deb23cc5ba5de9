"""Parameters from the JAX package (or any numpy source) into the port.

The names are identical in both packages, and so are the layouts: the
FullyConnected weight (N, K), the Convolution weight OIHW, BatchNorm's gamma
and beta and its aux states moving_mean and moving_var (C,). So conversion
is a copy onto the target device, the same call for a JAX executor's
arguments and for its aux states:

    args = params_from_numpy(jax_exe.arg_dict, ctx)
    aux = params_from_numpy(jax_exe.aux_dict, ctx)
    port_exe.copy_params_from(args, aux)

A checkpoint the JAX package saved (``mx.model.save_checkpoint``, or
``Module.save_checkpoint``) is in the reference's ``.params`` layout, which
the port reads as it is:

    args, aux = params_from_checkpoint("ckpt/resnet", 10, ctx)

A JAX ``Module``'s optimizer-state file pickles JAX arrays, which the port
cannot unpickle; with the states taken out as numpy on the JAX side (one
array, None, or a tuple of them per key), ``updater_states_from_numpy``
makes the port's ``Updater.states``, so training resumes in the port:

    mod.init_optimizer(...)
    mod._updater.states = updater_states_from_numpy(jax_states_as_numpy, ctx)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .context import Context, current_context

__all__ = ["params_from_numpy", "params_from_checkpoint", "updater_states_from_numpy"]


def params_from_numpy(arg_params, ctx: Context = None) -> Dict[str, torch.Tensor]:
    """{name: array} (numpy, or anything with ``asnumpy()``) → {name: tensor}
    on ``ctx`` (default ``gpu(0)``), with each array's dtype kept."""
    device = (ctx or current_context()).torch_device
    out = {}
    for name, value in arg_params.items():
        host = np.ascontiguousarray(value.asnumpy() if hasattr(value, "asnumpy") else value)
        out[name] = torch.from_numpy(host).to(device)
    return out


def params_from_checkpoint(prefix, epoch, ctx: Context = None):
    """``(arg_params, aux_params)`` of the checkpoint ``<prefix>-<epoch:04d>.params``
    (written by either package) as {name: tensor} dicts on ``ctx`` (default
    ``gpu(0)``), as ``params_from_numpy`` returns them."""
    from .model import load_checkpoint

    _, arg_params, aux_params = load_checkpoint(prefix, epoch, ctx=ctx)
    return ({n: a._tensor() for n, a in arg_params.items()},
            {n: a._tensor() for n, a in aux_params.items()})


def updater_states_from_numpy(states, ctx: Context = None):
    """{key: state} with each state a numpy array (or anything with
    ``asnumpy()``), None, or a tuple of them → the same structure of
    NDArrays on ``ctx`` (default ``gpu(0)``), each array's dtype kept."""
    from .ndarray import NDArray

    ctx = ctx or current_context()

    def one(v):
        if v is None:
            return None
        if isinstance(v, (tuple, list)):
            return tuple(one(x) for x in v)
        # a copy the port owns (the caller's array may be read-only)
        host = np.array(v.asnumpy() if hasattr(v, "asnumpy") else v, copy=True)
        return NDArray(torch.from_numpy(host), ctx=ctx)

    return {k: one(v) for k, v in states.items()}
