"""Operator library of the port: the registry, every op of the JAX package's
library but ``SparseEmbedding`` and ``_graph_const`` (the layers, the
shape, indexing and ordering ops, the optimizer updates, the samplers, the
fused RNN op, the vision and detection ops, the sequence ops, CTC and
``Custom``), and the hand-written CUDA kernels behind their dispatchers.

Importing it registers the ops; it needs neither ``nvcc`` nor a GPU (the
kernels build at their first launch).
"""
import importlib

from . import registry  # noqa: F401
from . import elemwise, broadcast_reduce, matrix, nn, attention, optimizer_ops, sample, rnn  # noqa: F401
from . import vision, sequence, ctc, custom  # noqa: F401
from . import flash_attention, norm_residual, matmul_bias_act, conv_bn, matmul_stats  # noqa: F401
from .registry import AttrSpec, OpDef, get_op, has_op, list_ops, parse_attrs, register  # noqa: F401

__all__ = ["AttrSpec", "OpDef", "get_op", "has_op", "list_ops", "parse_attrs", "register"]

#: kernel name -> (its module, the module's plain-integer launch counter). rtc
#: lives above this package (it returns NDArrays, which import the ops), so it
#: is named here and imported when the counts are read.
KERNELS = {
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_bf16": (flash_attention, "bf16_launches"),
    "flash_attention_dq": (flash_attention, "dq_launches"),
    "flash_attention_dkv": (flash_attention, "dkv_launches"),
    "flash_attention_dq_bf16": (flash_attention, "bf16_dq_launches"),
    "flash_attention_dkv_bf16": (flash_attention, "bf16_dkv_launches"),
    "norm_residual": (norm_residual, "launches"),
    "norm_residual_bf16": (norm_residual, "bf16_launches"),
    "norm_residual_bwd": (norm_residual, "bwd_launches"),
    "norm_residual_bwd_bf16": (norm_residual, "bf16_bwd_launches"),
    "matmul_bias_act": (matmul_bias_act, "launches"),
    "matmul_bias_act_bf16": (matmul_bias_act, "bf16_launches"),
    "conv_bn": (conv_bn, "launches"),
    "conv_bn_infer": (conv_bn, "infer_launches"),
    "conv_bn_infer_bf16": (conv_bn, "infer_bf16_launches"),
    "conv_bn_bf16": (conv_bn, "fwd_bf16_launches"),
    "conv_bn_bwd": (conv_bn, "bwd_launches"),
    "conv_bn_bwd_bf16": (conv_bn, "bwd_bf16_launches"),
    "conv_bn_stash": (conv_bn, "stash_launches"),
    "conv_bn_stash_bf16": (conv_bn, "stash_bf16_launches"),
    "conv_bn_bwd_stash": (conv_bn, "bwd_stash_launches"),
    "conv_bn_bwd_stash_bf16": (conv_bn, "bwd_stash_bf16_launches"),
    "matmul_stats": (matmul_stats, "launches"),
    "matmul_stats_bf16": (matmul_stats, "bf16_launches"),
    "rtc": ("mxnet_tpu_torch.rtc", "launches"),
}

#: per-schedule counters of a kernel with more than one schedule: name ->
#: (module, counter). They count the same launches as ``KERNELS`` does, split
#: by the schedule each took; ``schedule_counts`` reads them.
SCHEDULE_COUNTERS = {
    "matmul_bias_act.small_m": (matmul_bias_act, "small_m_launches"),
    "matmul_bias_act.tiles": (matmul_bias_act, "tile_launches"),
}


def _counters():
    for name, (mod, counter) in KERNELS.items():
        yield name, importlib.import_module(mod) if isinstance(mod, str) else mod, counter


def reset_launch_counts():
    for _, mod, counter in _counters():
        setattr(mod, counter, 0)
    for mod, counter in SCHEDULE_COUNTERS.values():
        setattr(mod, counter, 0)


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, counter) for name, mod, counter in _counters()}


def schedule_counts():
    """{kernel.schedule: launches since the last reset}."""
    return {name: getattr(mod, counter) for name, (mod, counter) in SCHEDULE_COUNTERS.items()}


def add_launch_counts(counts, schedules=None):
    """Add {kernel name: n} (and {kernel.schedule: n}) to the counters: the
    launches of a CUDA-graph replay, which the wrappers counted once, when
    the graph was captured (a negative n takes counts back)."""
    for name, mod, counter in _counters():
        if counts.get(name):
            setattr(mod, counter, getattr(mod, counter) + counts[name])
    for name, (mod, counter) in SCHEDULE_COUNTERS.items():
        if (schedules or {}).get(name):
            setattr(mod, counter, getattr(mod, counter) + schedules[name])
