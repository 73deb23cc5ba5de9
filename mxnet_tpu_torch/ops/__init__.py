"""Operator library of the port: the registry, the ops of the transformer's
serving and training paths, the optimizer updates, and the hand-written CUDA
kernels behind their dispatchers.

Importing it registers the ops; it needs neither ``nvcc`` nor a GPU (the
kernels build at their first launch).
"""
from . import registry  # noqa: F401
from . import elemwise, broadcast_reduce, matrix, nn, attention, optimizer_ops  # noqa: F401
from . import flash_attention, norm_residual, matmul_bias_act  # noqa: F401
from .registry import get_op, list_ops  # noqa: F401

#: kernel name -> (its module, the module's plain-integer launch counter)
KERNELS = {
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_dq": (flash_attention, "dq_launches"),
    "flash_attention_dkv": (flash_attention, "dkv_launches"),
    "norm_residual": (norm_residual, "launches"),
    "norm_residual_bwd": (norm_residual, "bwd_launches"),
    "matmul_bias_act": (matmul_bias_act, "launches"),
}


def reset_launch_counts():
    for mod, counter in KERNELS.values():
        setattr(mod, counter, 0)


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, counter) for name, (mod, counter) in KERNELS.items()}
