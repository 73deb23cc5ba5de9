"""Operator library of the port: the registry, the ops of the serving slice,
and the three hand-written CUDA kernels behind their dispatchers.

Importing it registers the ops; it needs neither ``nvcc`` nor a GPU (the
kernels build at their first launch).
"""
from . import registry  # noqa: F401
from . import elemwise, broadcast_reduce, matrix, nn, attention  # noqa: F401
from . import flash_attention, norm_residual, matmul_bias_act  # noqa: F401
from .registry import get_op, list_ops  # noqa: F401

#: the kernel modules, each with a plain-integer ``launches`` count
KERNEL_MODULES = (flash_attention, norm_residual, matmul_bias_act)


def reset_launch_counts():
    for mod in KERNEL_MODULES:
        mod.launches = 0


def launch_counts():
    """{kernel module name: launches since the last reset}."""
    return {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in KERNEL_MODULES}
