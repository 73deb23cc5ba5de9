"""Sequence ops for padded batches.

Counterpart of ``mxnet_tpu/ops/sequence.py``: ``SequenceLast``,
``SequenceMask`` and ``SequenceReverse`` over data laid out (max_seq_len,
batch, ...), each with an optional per-sample ``sequence_length`` input.
"""
from __future__ import annotations

import torch

from .registry import AttrSpec, register


def _seq_names(attrs):
    return ["data", "sequence_length"] if attrs.get("use_sequence_length") else ["data"]


def _seq_attrs():
    return {"use_sequence_length": AttrSpec("bool", default=False)}


def _lengths(sequence_length):
    return sequence_length.to(torch.int32).long()


@register("SequenceLast", attrs=_seq_attrs(), input_names=_seq_names)
def _sequence_last(attrs, data, sequence_length=None):
    """Each sample's last valid step (JAX :21)."""
    if not attrs["use_sequence_length"] or sequence_length is None:
        return data[-1]
    idx = (_lengths(sequence_length) - 1).clamp(0, data.shape[0] - 1)
    idx = idx.reshape((1, -1) + (1,) * (data.ndim - 2)).expand((1,) + tuple(data.shape[1:]))
    return data.gather(0, idx)[0]


@register("SequenceMask", attrs={"use_sequence_length": AttrSpec("bool", default=False),
                                 "value": AttrSpec("float", default=0.0)},
          input_names=_seq_names)
def _sequence_mask(attrs, data, sequence_length=None):
    """Steps past each sample's length set to ``value`` (JAX :39)."""
    if not attrs["use_sequence_length"] or sequence_length is None:
        return data
    steps = torch.arange(data.shape[0], device=data.device)
    mask = steps[:, None] < _lengths(sequence_length)[None, :]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), attrs["value"], dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse", attrs=_seq_attrs(), input_names=_seq_names)
def _sequence_reverse(attrs, data, sequence_length=None):
    """Each sample's first ``length`` steps reversed, the rest in place
    (JAX :48)."""
    if not attrs["use_sequence_length"] or sequence_length is None:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    lengths = _lengths(sequence_length)
    steps = torch.arange(T, device=data.device)[:, None]
    src = torch.where(steps < lengths[None, :], lengths[None, :] - 1 - steps, steps)
    src = src.reshape((T,) + tuple(lengths.shape) + (1,) * (data.ndim - 2))
    return data.gather(0, src.expand(data.shape))
