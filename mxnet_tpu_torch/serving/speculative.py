"""Speculative decoding over the paged pool.

Counterpart of ``mxnet_tpu/serving/speculative.py`` (``SpeculativeDecoder``
:66, the ``MXNET_SPEC_*`` helpers :46-63), with its ``spec.*`` counters.

A small draft model (the target's first k blocks,
``models/transformer.draft_config``; weight names are positional, so the
target's checkpoint feeds it unchanged) proposes γ tokens in one decode
megastep, then the target scores all γ+1 candidate positions in ONE chunk
dispatch (``PagedKVDecoder.verify_chunk``). Greedy acceptance keeps the
longest prefix where the draft's token equals the target's argmax, emits the
target's own token at the first disagreement, and ``rollback`` releases the
rejected tail's pages. Every emitted token is the target's argmax over the
same visible KV, so the stream is token-identical to plain greedy decode;
speculation changes only how many dispatches it takes.

A round (target and draft both at position p, next token ``cur``):

1. draft megastep(k=γ) from ``cur`` → proposals props[0..γ-1] (the draft
   writes positions p..p+γ-1, i.e. cur and props[:-1]);
2. target ``verify_chunk([cur] + props)`` → γ+1 logits rows in one dispatch;
3. accept props[j] while it equals argmax(row j); at the first miss emit
   the target's argmax instead;
4. rollback BOTH decoders to p + n_acc + 1;
5. a fully accepted round steps the draft once more on props[γ-1], which it
   never wrote, to re-synchronise it.
"""
from __future__ import annotations

import os

import numpy as np

from .. import telemetry as _tm
from ..base import MXNetError
from .kv_decode import PagedKVDecoder

__all__ = ["SpeculativeDecoder", "spec_decode_enabled", "spec_gamma"]


def spec_decode_enabled():
    """``MXNET_SPEC_DECODE`` truthy: serving loops that support it decode
    speculatively."""
    return os.environ.get("MXNET_SPEC_DECODE", "").strip().lower() in ("1", "on", "true", "yes")


def spec_gamma(default=4):
    """Draft tokens proposed a round (``MXNET_SPEC_GAMMA``). Junk or
    non-positive values fall back to ``default``."""
    raw = os.environ.get("MXNET_SPEC_GAMMA", "").strip()
    if not raw:
        return int(default)
    try:
        g = int(raw)
    except ValueError:
        return int(default)
    return g if g >= 1 else int(default)


class SpeculativeDecoder:
    """Draft-verify speculative greedy decode over two paged decoders.

    ``target`` and ``draft`` are ``PagedKVDecoder``s over one vocabulary
    (normally the draft is the same checkpoint at fewer layers: ``build``).
    Admission runs on both; a round costs one draft megastep and one target
    verify chunk instead of γ+1 target steps."""

    def __init__(self, target: PagedKVDecoder, draft: PagedKVDecoder, gamma=None):
        if target.vocab_size != draft.vocab_size:
            raise MXNetError("speculative: target vocab %d != draft vocab %d"
                             % (target.vocab_size, draft.vocab_size))
        self.target = target
        self.draft = draft
        self.gamma = int(gamma) if gamma is not None else spec_gamma()
        if self.gamma < 1:
            raise MXNetError("speculative: gamma must be >= 1, got %d" % self.gamma)
        self._pairs = {}  # target seq_id -> draft seq_id

    @classmethod
    def build(cls, arg_params, vocab_size, num_layers=2, draft_layers=1, gamma=None,
              model_key=None, **kw):
        """Target and draft from ONE checkpoint: the draft is the same config
        cut to its first ``draft_layers`` blocks (the cache ignores the
        checkpoint's extra entries at bind). The draft's caches take the
        target's ``model_key`` with ``-draft<k>`` added, as in JAX."""
        from ..models.transformer import draft_config

        cfg = dict(vocab_size=vocab_size, num_layers=num_layers, **kw)
        target = PagedKVDecoder(arg_params, model_key=model_key, **cfg)
        draft = PagedKVDecoder(
            arg_params, model_key=(model_key or "transformer_paged_global_decode")
            + "-draft%d" % draft_layers, **draft_config(cfg, draft_layers))
        return cls(target, draft, gamma=gamma)

    # ------------------------------------------------------------ lifecycle
    def warmup(self):
        """Build every program a round runs: the target's decode executable
        and (γ+1)-token verify chunk, the draft's decode executable and
        γ-step megastep (captured as a CUDA graph on the card)."""
        from .kv_decode import _megastep_for, _sampler_from

        self.target.warmup()
        self.draft.warmup()
        self.target._chunk_for(self.gamma + 1)
        _megastep_for(self.draft, self.gamma, _sampler_from(None, None, None))
        return self

    def admit(self, prompt):
        """Admit into BOTH decoders. Returns ``(seq_id, logits)`` in the
        target's namespace; the paired draft sequence is internal."""
        seq_id, logits = self.target.admit(prompt)
        try:
            d_id, _ = self.draft.admit(prompt)
        except BaseException:
            self.target.retire(seq_id)
            raise
        self._pairs[seq_id] = d_id
        return seq_id, logits

    def retire(self, seq_id):
        d_id = self._pairs.pop(seq_id, None)
        self.target.retire(seq_id)
        if d_id is not None:
            self.draft.retire(d_id)

    def stats(self):
        return {"gamma": self.gamma, "target": self.target.stats(),
                "draft": self.draft.stats()}

    # --------------------------------------------------------------- decode
    def _room(self, seq_id):
        """The largest γ a round can use at the current position: the target
        writes γ+1 positions, the draft at most γ+1, both bounded by their
        position tables and per-lane slot quotas."""
        p = self.target.position(seq_id)
        lim = min(self.target.pos_len, self.target.max_len,
                  self.draft.pos_len, self.draft.max_len)
        return min(self.gamma, lim - p - 1)

    def greedy(self, prompt, n_tokens):
        """Greedy-decode ``n_tokens`` continuation tokens of one prompt,
        speculatively. Returns a (n_tokens,) int64 array token-identical to
        ``PagedKVDecoder.greedy`` on the target alone."""
        seq_id, logits = self.admit(prompt)
        d_id = self._pairs[seq_id]
        try:
            out = np.zeros((n_tokens,), np.int64)
            if n_tokens == 0:
                return out
            cur = int(np.argmax(logits))
            out[0] = cur
            t = 1
            g = self.gamma
            while t < n_tokens:
                if self._room(seq_id) < g:
                    # no room for a FULL round (a shorter one would need a
                    # program of its own): plain steps, the draft kept aligned
                    fed = cur
                    # graphlint: waive GL702 -- position-table tail; single-step program is already warm
                    lg = self.target.step({seq_id: fed})
                    # graphlint: waive GL703 -- one id from already-pulled logits
                    cur = int(np.argmax(lg[seq_id]))
                    # graphlint: waive GL702 -- draft shadow step, same warm program
                    self.draft.step({d_id: fed})
                    out[t] = cur
                    t += 1
                    continue
                p = self.target.position(seq_id)
                # graphlint: waive GL702 -- the γ-token round IS the amortization: one CUDA-graph replay proposes γ tokens
                props = self.draft.step_megastep({d_id: cur}, k=g)[d_id]
                rows = self.target.verify_chunk(seq_id, np.concatenate(([cur], props)))
                # graphlint: waive GL703 -- γ+1 argmaxes on one already-pulled verify block, not per-token pulls
                ids = np.argmax(rows, axis=1).astype(np.int64)
                n_acc = 0
                while n_acc < g and props[n_acc] == ids[n_acc]:
                    n_acc += 1
                if n_acc < g:
                    emitted = list(props[:n_acc]) + [int(ids[n_acc])]
                    self.target.rollback(seq_id, p + n_acc + 1)
                    self.draft.rollback(d_id, p + n_acc + 1)
                else:
                    emitted = list(props) + [int(ids[g])]
                    # the draft never wrote props[-1]: one catch-up step
                    # graphlint: waive GL702 -- ≤1 catch-up step per γ-token round
                    self.draft.step({d_id: int(props[-1])})
                if _tm.enabled():
                    _tm.counter("spec.proposed_tokens").inc(int(g))
                    _tm.counter("spec.accepted_tokens").inc(n_acc)
                    _tm.counter("spec.rounds").inc()
                for tok in emitted:
                    if t >= n_tokens:
                        break
                    out[t] = tok
                    t += 1
                cur = int(emitted[-1])
            return out
        finally:
            self.retire(seq_id)
