"""Random number API.

Counterpart of ``mxnet_tpu/random.py`` (:17-79), whose state is one JAX PRNG
key split per draw. Here the state is one ``torch.Generator`` per device,
as the reference keeps one random resource per device: one on the CPU and
one on each CUDA card, made at first use. A draw on an array of
``gpu(i)`` runs on that card from its own generator; nothing is drawn on the
CPU and copied over. ``seed`` seeds every generator, those made later too;
until then each is seeded from numpy's global stream. The draws are not
JAX's bits: the same seed gives the same numbers in the port on the same
device, and the same distributions as the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "uniform", "normal"]

#: torch.device -> its generator; emptied by ``seed``
_GENS = {}
#: the last ``seed`` value, or None (then a new generator takes a numpy draw)
_SEED = None


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device`` or a device string),
    made and seeded at its first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = _GENS.get(device)
    if gen is None:
        s = _SEED if _SEED is not None else int(np.random.randint(0, 2**31 - 1))
        gen = _GENS[device] = torch.Generator(device=device).manual_seed(s)
    return gen


def _next_seed() -> int:
    """A fresh host-side integer seed drawn from the CPU generator (JAX:
    ``_next_seed``, from its key): the decoders' sampling seed where none
    was given, and ``Orthogonal``'s numpy seed."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator("cpu")))


def seed(seed_state: int):
    """Seed every device's generator, and numpy's as the JAX package does
    (reference: mx.random.seed → MXRandomSeed)."""
    global _SEED
    _SEED = int(seed_state)
    _GENS.clear()
    np.random.seed(int(seed_state) & 0x7FFFFFFF)


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype=np.float32, out=None):
    """Samples of U(low, high) on ``ctx`` (default ``current_context()``)."""
    from .ndarray import imperative_invoke
    from .context import current_context

    attrs = {"low": low, "high": high, "shape": shape, "dtype": dtype}
    return imperative_invoke("random_uniform", [], attrs, ctx=ctx or current_context(), out=out)[0]


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype=np.float32, out=None):
    """Samples of N(loc, scale²) on ``ctx`` (default ``current_context()``)."""
    from .ndarray import imperative_invoke
    from .context import current_context

    attrs = {"loc": loc, "scale": scale, "shape": shape, "dtype": dtype}
    return imperative_invoke("random_normal", [], attrs, ctx=ctx or current_context(), out=out)[0]
