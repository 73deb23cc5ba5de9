"""KV-cache incremental decode for the transformer LM.

Counterpart of ``mxnet_tpu/serving/kv_decode.py`` ``KVCacheDecoder``
(:434): one prefill executable (prompt bucket, exports every layer's K/V)
and one single-token decode executable over a preallocated ring KV buffer
of ``max_len`` slots per layer, both from a sealed executable cache.
Position ``p`` writes ring slot ``p % max_len`` inside the decode graph, and
the updated buffers, program outputs, are swapped back in as the next
step's inputs: a tensor swap, no copy and no host round-trip.

Seeding the ring after a prefill differs from the JAX package, whose arrays
are immutable (``ring.at[:, :, 0:P, :].set(out)``, :564-566): here it is an
in-place copy into the ring's first P slots, on the device.

Megasteps, the paged decoder, the prefix cache and speculative decoding
come with later slices; ``greedy`` takes one token per dispatch (k = 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..base import MXNetError
from .cache import PersistentExecutableCache

__all__ = ["KVCacheDecoder"]

_NEG = np.float32(-1e9)


class KVCacheDecoder:
    """Batched greedy decode over the serving transformer.

    ``arg_params`` is the {name: array} dict of ``models/transformer.
    get_symbol`` (numpy arrays, tensors, or anything ``arr[:] =`` takes);
    the serving graphs share those names. ``ctx`` defaults to ``gpu(0)``.
    The decoder computes in float32, the JAX serving default."""

    def __init__(self, arg_params: Dict[str, object], vocab_size,
                 num_layers=2, num_heads=2, model_dim=32, ffn_dim=64,
                 max_len=64, prefill_len: Optional[int] = None,
                 pos_len: Optional[int] = None, batch=1, ctx=None):
        from ..models import transformer as _tf

        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.model_dim = int(model_dim)
        self.max_len = int(max_len)
        self.prefill_len = int(prefill_len or max_len)
        self.pos_len = int(pos_len or max_len)
        self.batch = int(batch)
        self.dh = self.model_dim // self.num_heads
        if self.prefill_len > self.max_len:
            raise MXNetError("kv_decode: prefill_len %d > max_len %d"
                             % (self.prefill_len, self.max_len))
        cfg = dict(vocab_size=self.vocab_size, num_layers=self.num_layers,
                   num_heads=self.num_heads, model_dim=self.model_dim,
                   ffn_dim=int(ffn_dim), pos_len=self.pos_len)
        self._pf_cache = PersistentExecutableCache(
            _tf.get_prefill_symbol(prefill_len=self.prefill_len, **cfg),
            arg_params, ctx=ctx)
        self._dec_cache = PersistentExecutableCache(
            _tf.get_decode_symbol(max_len=self.max_len, **cfg),
            arg_params, ctx=ctx)
        self._dec_exe = None
        self._pos = 0
        self._warm = False

    # ------------------------------------------------------------ lifecycle
    def _decode_shapes(self):
        B, S, H, dh = self.batch, self.max_len, self.num_heads, self.dh
        shapes = {"data": (B, 1), "pos_idx": (B, 1), "slot_onehot": (S,),
                  "kv_mask": (S,)}
        for i in range(self.num_layers):
            shapes["kv_k_%d" % i] = (B, H, S, dh)
            shapes["kv_v_%d" % i] = (B, H, S, dh)
        return shapes

    def warmup(self):
        """Bind and run the prefill and decode executables once; seal both
        caches, so any later shape drift raises instead of binding."""
        if self._warm:
            return self
        self._pf_cache.warmup([{"data": (self.batch, self.prefill_len)}])
        self._dec_cache.warmup([self._decode_shapes()])
        self._dec_exe = self._dec_cache.executable(self._decode_shapes())
        self._warm = True
        return self

    def reset(self):
        """Forget all context (the KV slots are masked out, not zeroed)."""
        self._pos = 0

    # -------------------------------------------------------------- prefill
    def prefill(self, tokens):
        """Consume a (B, L<=prefill_len) prompt in one executable call: seeds
        the ring with positions 0..L-1 and returns the (B, vocab) logits at
        position L-1."""
        self.warmup()
        tokens = np.asarray(tokens, dtype=np.float32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        B, L = tokens.shape
        if B != self.batch:
            raise MXNetError("kv_decode: prefill batch %d != engine batch %d"
                             % (B, self.batch))
        if not 0 < L <= self.prefill_len:
            raise MXNetError("kv_decode: prompt length %d not in (0, %d]"
                             % (L, self.prefill_len))
        P = self.prefill_len
        padded = np.zeros((B, P), np.float32)
        padded[:, :L] = tokens
        pf = self._pf_cache.executable({"data": (B, P)})
        pf.arg_dict["data"][:] = padded
        pf.forward(is_train=False)
        # only the last real position's logits cross to the host
        logits = pf.outputs[0]._tensor().reshape(B, P, self.vocab_size)[:, L - 1, :]
        logits = logits.cpu().numpy()
        # seed ring slots 0..P-1 with the prefill's K/V on the device: a
        # tensor swap when the ring is exactly the prefill window, else an
        # in-place copy (slots >= L hold garbage, masked until written)
        exe = self._dec_exe
        for i in range(self.num_layers):
            for tag, out in (("kv_k_%d" % i, pf.outputs[1 + 2 * i]),
                             ("kv_v_%d" % i, pf.outputs[2 + 2 * i])):
                if P == self.max_len:
                    exe.arg_dict[tag]._set_tensor(out._tensor())
                else:
                    exe.arg_dict[tag]._tensor()[:, :, 0:P, :].copy_(out._tensor())
        self._pos = L
        return logits

    # --------------------------------------------------------------- decode
    def _stage_step(self, tokens):
        """Validate the position and write one step's inputs."""
        self.warmup()
        p, S = self._pos, self.max_len
        if p >= self.pos_len:
            raise MXNetError("kv_decode: position %d exceeds the trained position "
                             "table (%d rows)" % (p, self.pos_len))
        oh = np.zeros((S,), np.float32)
        oh[p % S] = 1.0
        mask = np.zeros((S,), np.float32)
        if p + 1 < S:
            mask[p + 1:] = _NEG  # slots beyond the history are empty
        exe = self._dec_exe
        exe.arg_dict["data"][:] = np.asarray(tokens, np.float32).reshape(self.batch, 1)
        exe.arg_dict["pos_idx"][:] = np.full((self.batch, 1), p, np.float32)
        exe.arg_dict["slot_onehot"][:] = oh
        exe.arg_dict["kv_mask"][:] = mask
        return exe

    def _finish_step(self, exe):
        """Swap the updated ring buffers in as the next step's inputs."""
        for i in range(self.num_layers):
            exe.arg_dict["kv_k_%d" % i]._set_tensor(exe.outputs[1 + 2 * i]._tensor())
            exe.arg_dict["kv_v_%d" % i]._set_tensor(exe.outputs[2 + 2 * i]._tensor())
        self._pos += 1

    def decode_step(self, tokens):
        """One token per stream; returns (B, vocab) logits for the next position."""
        exe = self._stage_step(tokens)
        exe.forward(is_train=False)
        logits = exe.outputs[0].asnumpy()
        self._finish_step(exe)
        return logits

    def greedy_step(self, tokens):
        """One greedy token per stream: only the on-device ``greedy_token``
        head, (B,) ids, crosses to the host."""
        exe = self._stage_step(tokens)
        exe.forward(is_train=False)
        nxt = exe.outputs[-1].asnumpy()
        self._finish_step(exe)
        return nxt.astype(np.int64)

    def greedy(self, prompt, n_tokens):
        """Greedy-decode ``n_tokens`` continuations of a (B, L) prompt, one
        token per dispatch. Returns (B, n_tokens) int64 token ids."""
        logits = self.prefill(prompt)
        nxt = np.argmax(logits, axis=-1)  # once per sequence: logits are host-side
        out = np.zeros((self.batch, n_tokens), np.int64)
        if n_tokens:
            out[:, 0] = nxt
        for t in range(1, n_tokens):
            nxt = self.greedy_step(nxt)
            out[:, t] = nxt
        return out
