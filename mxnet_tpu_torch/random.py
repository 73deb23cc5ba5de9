"""Random number API.

Counterpart of ``mxnet_tpu/random.py`` (:17-42), whose state is one JAX PRNG
key split per draw: here it is one module-level ``torch.Generator`` on the
CPU, created from numpy's global stream at first use unless ``seed`` came
first. Its draws are not JAX's bits. ``uniform`` and ``normal`` come with
the random ops.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed"]

_GEN = None


def _generator() -> torch.Generator:
    global _GEN
    if _GEN is None:
        _GEN = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))
    return _GEN


def _next_seed() -> int:
    """A fresh host-side integer seed drawn from the global generator (JAX:
    ``_next_seed``, from its key): the decoders' sampling seed where none
    was given."""
    return int(torch.randint(0, 2**31 - 1, (), generator=_generator()))


def seed(seed_state: int):
    """Seed the global generator, and numpy's as the JAX package does
    (reference: mx.random.seed → MXRandomSeed)."""
    global _GEN
    _GEN = torch.Generator().manual_seed(int(seed_state))
    np.random.seed(int(seed_state) & 0x7FFFFFFF)
