"""KV-cache incremental decode for the transformer LM.

Counterpart of ``mxnet_tpu/serving/kv_decode.py``: ``KVCacheDecoder``
(:434), its megasteps (``_DecodeMegastep`` :154, ``_ChunkProgram`` :337)
and the paged, multiplexed ``PagedKVDecoder`` (:838) with its refcounted
page pool, copy-on-write prefix sharing, fork, rollback and chunk
verification.

One prefill executable (prompt bucket, exports every layer's K/V) and one
single-token decode executable over a preallocated KV buffer, both from a
sealed executable cache. The decode graph writes the step's K/V in-graph
(``slot_onehot`` blend, ``models/transformer.get_decode_symbol``).

**Fixed KV buffers.** The JAX package swaps each step's KV outputs in as
the next step's inputs (its arrays are immutable). Here the decode
executor's KV arguments are the decoder's buffers for its whole life, at
fixed addresses: a step and a chunk copy their KV outputs back (the ring
only the slot it wrote), and a prefill seed, the paged admit's scatter
(``ring.at[:, phys, :].set`` in JAX, ``index_copy_`` here) and the
copy-on-write page copy write into them in place. That is what lets a
megastep be one CUDA graph.

**Megasteps.** ``decode_megastep``/``step_megastep`` take K decode steps in
one dispatch with on-device sampling; only the (K, B) token ids and the
activity mask come back to the host. JAX runs the K steps as a
``lax.scan``. Here, on the CPU, they are a Python loop over
``_GraphProgram.interpret``; on the card, ``_DecodeMegastep.warm`` captures
that loop once into a ``torch.cuda.CUDAGraph`` (after warm-up runs on a side
stream, which build the CUDA kernels and grow the allocator), and every
dispatch copies its inputs into the graph's static tensors and replays it.
The graph reads the weights and KV buffers by address; its last step copies
the final KV into the buffers. Lanes that are idle or done carry an
all-zero onehot row and write nothing. The kernel wrappers count their
launches when the graph is captured, not when it replays: the capture's
counts are taken back and added again at every replay
(``ops.add_launch_counts``).

**Sampling.** JAX draws ``categorical(fold_in(fold_in(key, pos), lane))``
(:217-223). Its bits cannot be matched; what is kept is that a draw depends
only on (seed, absolute position, lane), so a seeded decode gives the same
tokens however its steps are cut into megasteps. The draw is Gumbel-max on
a counter-based hash of (seed, position, lane, vocab id) in plain tensor
ops, which a CUDA graph captures.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import ops as _ops
from .. import random as _random
from .. import telemetry as _tm
from ..base import MXNetError
from .cache import PersistentExecutableCache

__all__ = ["KVCacheDecoder", "PagedKVDecoder", "PagedKVExhausted", "decode_megastep_k"]

_NEG = np.float32(-1e9)
_M32 = 0xFFFFFFFF


def decode_megastep_k(default=1):
    """Decode tokens per dispatch (``MXNET_DECODE_MEGASTEP_K``). K=1 is the
    single-step path; K>1 routes the greedy loops through the megastep. Junk
    values fall back to ``default``."""
    raw = os.environ.get("MXNET_DECODE_MEGASTEP_K", "").strip()
    if not raw:
        return int(default)
    try:
        k = int(raw)
    except ValueError:
        return int(default)
    return k if k >= 1 else int(default)


def _gap_mark(dec, site):
    """``dispatch.host_gap``: host time from the previous dispatch's return
    (its read-back) to this dispatch, per call site and in aggregate (JAX
    :71). Off, it costs one predicate: no clock read."""
    if not _tm.enabled():
        return
    last = dec._last_return_t
    if last is not None:
        dt = time.perf_counter() - last
        _tm.timer("dispatch.host_gap").add(dt)
        _tm.timer("dispatch.host_gap." + site).add(dt)


def _gap_return(dec):
    """Stamp the return side of the ``dispatch.host_gap`` interval, right
    after a dispatch's read-back."""
    if _tm.enabled():
        dec._last_return_t = time.perf_counter()


# ------------------------------------------------------------------ megastep
class _Sampler:
    """On-device sampling config for megasteps: ``greedy`` takes the graph's
    argmax head; ``topk`` divides the logits by ``temperature``, masks
    everything below the ``top_k``-th logit (0 = no truncation) and draws."""

    __slots__ = ("mode", "temperature", "top_k")

    def __init__(self, mode="greedy", temperature=1.0, top_k=0):
        if mode not in ("greedy", "topk"):
            raise MXNetError("decode sampler: mode must be 'greedy' or 'topk', got %r"
                             % (mode,))
        self.mode = mode
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        if self.temperature <= 0:
            raise MXNetError("decode sampler: temperature must be > 0")
        if self.top_k < 0:
            raise MXNetError("decode sampler: top_k must be >= 0")

    def key(self):
        return (self.mode, self.temperature, self.top_k)


def _sampler_from(sample=None, temperature=None, top_k=None):
    """Resolve sampler knobs: explicit arguments win over the
    MXNET_DECODE_SAMPLE / _TEMP / _TOPK environment defaults."""
    mode = sample or os.environ.get("MXNET_DECODE_SAMPLE", "greedy")
    if temperature is None:
        temperature = float(os.environ.get("MXNET_DECODE_SAMPLE_TEMP", "1.0"))
    if top_k is None:
        top_k = int(os.environ.get("MXNET_DECODE_SAMPLE_TOPK", "0"))
    return _Sampler(mode, temperature, top_k)


def _sampling_key(dec):
    """The decoder's sampling seed, fixed for its life: its ``sample_seed``,
    else MXNET_DECODE_SAMPLE_SEED, else a draw from the port's global
    generator (``random.py``)."""
    if dec._sample_key is None:
        seed = dec._sample_seed
        if seed is None:
            raw = os.environ.get("MXNET_DECODE_SAMPLE_SEED", "").strip()
            seed = int(raw) if raw else None
        dec._sample_key = int(seed) if seed is not None else _random._next_seed()
    return dec._sample_key


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply rounds) of int64 tensors
    holding values in [0, 2**32); the multipliers are below 2**31, so no
    product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x346CA68B) & _M32
    return x ^ (x >> 16)


def _gumbel(seed, pos, lanes, vocab_ids):
    """Gumbel(0, 1) noise (B, V), a function of (seed, position, lane, vocab
    id) alone: 24 hashed bits a draw give u in (0, 1), then -log(-log u)."""
    row = _mix32(_mix32(_mix32(seed & _M32) ^ (pos & _M32)) ^ lanes)
    h = _mix32(row[:, None] ^ _mix32(vocab_ids)[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _sample(logits, pos, lanes, seed, temperature, top_k):
    """One token a lane from (B, V) logits: temperature, top-k truncation
    below the k-th logit (JAX :213-215), Gumbel-max."""
    lg = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    vocab_ids = torch.arange(lg.shape[1], device=lg.device)
    return torch.argmax(lg + _gumbel(seed, pos, lanes, vocab_ids), dim=-1)


def _sig_of(*arrays):
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)


def _program(symbol):
    """The interpretable program of a serving graph, after the bind-time
    rewrite (so the fused kernels' sites match, as in a bound executor)."""
    from ..analysis.rewrite import rewrite_for_bind
    from ..executor import _GraphProgram

    prog = _GraphProgram(rewrite_for_bind(symbol))
    if prog.aux_names:
        raise MXNetError("serving program: the graph must carry no aux state, got %r"
                         % (prog.aux_names,))
    return prog


class _DecodeMegastep:
    """K decode steps in one dispatch: on the card one CUDA-graph replay.

    The per-stream decode graph (``get_decode_symbol(per_stream_slots=True)``
    and, for the paged pool, ``global_slots``) is interpreted K times; each
    step blends its KV write in-graph through the host-staged slot plan,
    samples the next token on the device and latches EOS, as JAX's scan body
    (:227-256) does. Shapes are fixed when the program is built; after
    ``warm`` a different input signature raises instead of capturing again.
    """

    def __init__(self, dec, k, sampler):
        from ..models import transformer as _tf

        self.k = int(k)
        self.sampler = sampler
        self.rows = dec.batch if hasattr(dec, "batch") else dec.lanes
        # the paged decoder's pool is ONE slot axis shared by all lanes (kv
        # (H, S_tot, dh)); the ring decoder carries a ring per lane (kv (B,
        # H, S, dh)): the same steps over another slot space
        self.global_slots = bool(getattr(dec, "_global_slots", False))
        L = dec.num_layers
        self._S = dec.total_slots if self.global_slots else dec.max_len
        self._pos_len = dec.pos_len
        self._prog = _program(_tf.get_decode_symbol(
            vocab_size=dec.vocab_size, num_layers=L, num_heads=dec.num_heads,
            model_dim=dec.model_dim, ffn_dim=dec.ffn_dim, max_len=self._S,
            pos_len=dec.pos_len, per_stream_slots=True, global_slots=self.global_slots))
        self.kv_names = [n for i in range(L) for n in ("kv_k_%d" % i, "kv_v_%d" % i)]
        step_inputs = {"data", "pos_idx", "slot_onehot", "kv_mask", *self.kv_names}
        self.weight_names = [n for n in self._prog.arg_names if n not in step_inputs]
        self._sig = None
        self._graph = None     # the CUDA graph (a decoder on the card)
        self._static = None    # its input tensors, in _tensors' order
        self._out = None       # its (2, K, B) int64 output: ids, then activity
        self._bound = None     # the tensors it reads by address
        #: {kernel: launches} and {kernel.schedule: launches} of one replay
        self.replay_launches = ({}, {})

    def _zero_inputs(self):
        B, S = self.rows, self._S
        return (np.zeros((B,), np.int32), np.zeros((B,), np.int32),
                np.zeros((B, self.k), np.int32), np.full((B, S), _NEG, np.float32),
                np.ones((B,), bool))  # every lane idle: runs, writes nothing

    def _steps(self, args, kvs, tok0, pos, slots, base_mask, done0, seed, eos):
        """The K steps on tensors. ``args`` holds the weights; ``kvs`` are
        the decoder's KV buffers, read by the first step and given the last
        step's KV. Returns (2, K, B) int64: the ids, then the activity."""
        dev = base_mask.device
        slot_ids = torch.arange(self._S, device=dev)
        lanes = torch.arange(self.rows, device=dev)
        L2 = len(self.kv_names)
        tok, done, mask, kv = tok0, done0, base_mask, list(kvs)
        toks, acts = [], []
        for t in range(self.k):
            act = ~done
            oh = (slots[:, t:t + 1] == slot_ids).to(torch.float32) \
                * act.to(torch.float32)[:, None]
            # the slot written now is attendable from now to the last step
            mask = mask.masked_fill(oh > 0, 0.0)
            # idle lanes clamp into the position table; their onehot row is
            # all-zero, so what they compute is written nowhere
            pos_t = torch.clamp(pos + t, 0, self._pos_len - 1)
            args.update(data=tok.to(torch.float32)[:, None],
                        pos_idx=pos_t.to(torch.float32)[:, None], slot_onehot=oh, kv_mask=mask)
            args.update(zip(self.kv_names, kv))
            outs, _ = self._prog.interpret(tuple(args[n] for n in self._prog.arg_names), (),
                                           False)
            kv = outs[1:1 + L2]
            if self.sampler.mode == "greedy":
                nxt = outs[-1].to(torch.int64)  # the on-device argmax head
            else:
                nxt = _sample(outs[0], pos + t, lanes, seed, self.sampler.temperature,
                              self.sampler.top_k)
            nxt = torch.where(act, nxt, torch.clamp(eos, min=0))
            done = done | (act & (eos >= 0) & (nxt == eos))
            toks.append(nxt)
            acts.append(act.to(torch.int64))
            tok = nxt
        for buf, new in zip(kvs, kv):
            buf.copy_(new)
        return torch.stack([torch.stack(toks), torch.stack(acts)])

    @staticmethod
    def _tensors(arrays, dev):
        tok0, pos, slots, base_mask, done0, seed, eos = arrays
        to = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev)  # noqa: E731
        return (to(tok0, torch.int64), to(pos, torch.int64), to(slots, torch.int64),
                to(base_mask, torch.float32), to(done0, torch.bool), to(seed, torch.int64),
                to(eos, torch.int64))

    def _bound_tensors(self, dec):
        ex = dec._dec_exe.arg_dict
        return ({n: ex[n]._tensor() for n in self.weight_names},
                [ex[n]._tensor() for n in self.kv_names])

    def warm(self, dec):
        """Fix the input signature. On the card: run the K steps twice with
        every lane idle on a side stream (builds the kernels, grows the
        allocator, writes nothing), then capture them into one CUDA graph."""
        z = self._zero_inputs()
        weights, kvs = self._bound_tensors(dec)
        dev = kvs[0].device
        with _tm.span("serving.megastep_compile", k=self.k, rows=self.rows,
                      sampler=self.sampler.mode):
            if dev.type == "cuda":
                self._capture(dec, weights, kvs, z, dev)
        self._sig = _sig_of(*z)
        if _tm.enabled():
            _tm.counter("executor.compile").inc()

    def _capture(self, dec, weights, kvs, z, dev):
        static = self._tensors(z + (_sampling_key(dec), -1), dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):
                self._steps(dict(weights), kvs, *static)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _ops.launch_counts(), _ops.schedule_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph):
            out = self._steps(dict(weights), kvs, *static)
        after = _ops.launch_counts(), _ops.schedule_counts()
        # the capture launched nothing: take its counts back, and add them
        # at every replay instead
        self.replay_launches = tuple({k: a[k] - b[k] for k in a}
                                     for a, b in zip(after, before))
        _ops.add_launch_counts(*({k: -v for k, v in c.items()} for c in self.replay_launches))
        self._graph, self._static, self._out = graph, static, out
        self._bound = (weights, kvs)

    def run(self, dec, tok0, pos, slots, base_mask, done0, eos):
        """One megastep dispatch; the KV buffers take the K steps' writes.
        Returns host ``(ids (K, B) int64, acts (K, B) bool)``."""
        sig = _sig_of(tok0, pos, slots, base_mask, done0)
        if self._sig is not None and sig != self._sig:
            if _tm.enabled():
                _tm.counter("executor.retrace").inc()
            raise MXNetError(
                "decode megastep (K=%d): input signature drifted from the warmed shapes "
                "(%r != %r); megastep programs are sealed like the executable cache"
                % (self.k, sig, self._sig))
        if _tm.enabled():
            _tm.counter("executor.cache_hit").inc()
        inputs = (tok0, pos, slots, base_mask, done0, _sampling_key(dec), eos)
        weights, kvs = self._bound_tensors(dec)
        if self._graph is None:
            with torch.no_grad():
                out = self._steps(weights, kvs, *self._tensors(inputs, kvs[0].device))
        else:
            if any(weights[n] is not self._bound[0][n] for n in weights) \
                    or any(a is not b for a, b in zip(kvs, self._bound[1])):
                raise MXNetError(
                    "decode megastep (K=%d): the decoder's weights or KV buffers are not "
                    "the tensors its CUDA graph was captured on; write into them in place"
                    % self.k)
            for dst, src in zip(self._static, self._tensors(inputs, "cpu")):
                dst.copy_(src)
            self._graph.replay()
            _ops.add_launch_counts(*self.replay_launches)
            out = self._out
        host = out.cpu().numpy()
        return host[0], host[1].astype(bool)


def _megastep_for(dec, k, sampler):
    """The decoder's megastep program for ``(K, sampler)``, built and warmed
    once."""
    cache_key = (int(k), sampler.key())
    ms = dec._megasteps.get(cache_key)
    if ms is None:
        ms = _DecodeMegastep(dec, k, sampler)
        ms.warm(dec)
        dec._megasteps[cache_key] = ms
    return ms


class _ChunkProgram:
    """T tokens of ONE lane scored, and written where asked, in one
    rectangular dispatch over the paged pool
    (``models/transformer.get_chunk_symbol``): the chunked prefill of the
    prefix-cache admit and the speculative verify pass are this program at
    two T. It runs eagerly through ``_GraphProgram.interpret``. Sealed like
    the megastep: ``warm`` runs one all-pad chunk, which writes nothing, and
    a later input signature that differs raises."""

    def __init__(self, dec, t):
        from ..models import transformer as _tf

        self.t = int(t)
        self._S = dec.total_slots
        L = dec.num_layers
        self._prog = _program(_tf.get_chunk_symbol(
            vocab_size=dec.vocab_size, num_layers=L, num_heads=dec.num_heads,
            model_dim=dec.model_dim, ffn_dim=dec.ffn_dim, chunk_len=self.t,
            total_slots=self._S, pos_len=dec.pos_len))
        self.kv_names = [n for i in range(L) for n in ("kv_k_%d" % i, "kv_v_%d" % i)]
        self._sig = None

    def _zero_inputs(self):
        T, S = self.t, self._S
        return (np.zeros((1, T), np.float32), np.zeros((1, T), np.float32),
                np.zeros((T, S), np.float32), np.full((T, S), _NEG, np.float32))

    def _forward(self, dec, data, pos_idx, w_oh, mask):
        ex = dec._dec_exe.arg_dict
        dev = ex[self.kv_names[0]]._tensor().device
        feed = {"data": data, "pos_idx": pos_idx, "write_onehot": w_oh, "att_mask": mask}
        args = tuple(torch.from_numpy(feed[n]).to(dev) if n in feed else ex[n]._tensor()
                     for n in self._prog.arg_names)
        with torch.no_grad():
            outs, _ = self._prog.interpret(args, (), False)
        return outs[0], outs[1:1 + len(self.kv_names)]

    def warm(self, dec):
        z = self._zero_inputs()
        with _tm.span("serving.chunk_compile", t=self.t):
            self._forward(dec, *z)
        self._sig = _sig_of(*z)
        if _tm.enabled():
            _tm.counter("executor.compile").inc()

    def run(self, dec, data, pos_idx, w_oh, mask):
        """One chunk dispatch. Returns device ``(logits (T, vocab), new_kvs)``;
        the caller copies the KV into the buffers when the chunk writes."""
        sig = _sig_of(data, pos_idx, w_oh, mask)
        if self._sig is not None and sig != self._sig:
            if _tm.enabled():
                _tm.counter("executor.retrace").inc()
            raise MXNetError(
                "chunk program (T=%d): input signature drifted from the warmed shapes "
                "(%r != %r); chunk programs are sealed like the executable cache"
                % (self.t, sig, self._sig))
        if _tm.enabled():
            _tm.counter("executor.cache_hit").inc()
        return self._forward(dec, data, pos_idx, w_oh, mask)


def _token_head(exe):
    """Whether a decode executable has the trailing ``greedy_token`` head,
    found by its output name (a count could coincide, JAX :502-510)."""
    return any(name.startswith("greedy_token") for name in exe.output_dict)


class KVCacheDecoder:
    """Batched greedy decode over the serving transformer, all B streams at
    one position.

    ``arg_params`` is the {name: array} dict of ``models/transformer.
    get_symbol`` (numpy arrays, tensors, or anything ``arr[:] =`` takes);
    the serving graphs share those names. ``ctx`` defaults to ``gpu(0)``.
    The decoder computes in float32, the JAX serving default: a ``dtype``
    other than ``"float32"`` raises. ``cache_dir`` and ``model_key`` name
    the two caches' manifests (``model_key`` + ``-prefill`` / ``-decode``).
    ``sample_seed`` fixes the megastep sampler's draws."""

    def __init__(self, arg_params: Dict[str, object], vocab_size,
                 num_layers=2, num_heads=2, model_dim=32, ffn_dim=64,
                 max_len=64, prefill_len: Optional[int] = None,
                 pos_len: Optional[int] = None, batch=1, ctx=None,
                 dtype="float32", cache_dir=None, model_key=None, sample_seed=None):
        from ..models import transformer as _tf

        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.model_dim = int(model_dim)
        self.ffn_dim = int(ffn_dim)
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
                   ffn_dim=self.ffn_dim, pos_len=self.pos_len)
        key = model_key or "transformer_decode"
        self._pf_cache = PersistentExecutableCache(
            _tf.get_prefill_symbol(prefill_len=self.prefill_len, **cfg),
            arg_params, {}, ctx=ctx, dtype=dtype, cache_dir=cache_dir,
            model_key=key + "-prefill")
        self._dec_cache = PersistentExecutableCache(
            _tf.get_decode_symbol(max_len=self.max_len, **cfg),
            arg_params, {}, ctx=ctx, dtype=dtype, cache_dir=cache_dir,
            model_key=key + "-decode")
        self._dec_exe = None
        self._pos = 0
        self._warm = False
        self._token_out = False
        self._last_return_t = None  # dispatch.host_gap interval start
        self._megasteps = {}  # (K, sampler) -> _DecodeMegastep
        self._sample_seed = sample_seed
        self._sample_key = None

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
        self._token_out = _token_head(self._dec_exe)
        self._warm = True
        return self

    def reset(self):
        """Forget all context (the KV slots are masked out, not zeroed)."""
        self._pos = 0

    @property
    def position(self):
        return self._pos

    def _kv(self, name):
        return self._dec_exe.arg_dict[name]._tensor()

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
        with _tm.span("serving.prefill", rows=B, prompt_len=L):
            pf = self._pf_cache.executable({"data": (B, P)})
            pf.arg_dict["data"][:] = padded
            pf.forward(is_train=False)
            # only the last real position's logits cross to the host
            logits = pf.outputs[0]._tensor().reshape(B, P, self.vocab_size)[:, L - 1, :]
            logits = logits.cpu().numpy()
        # seed ring slots 0..P-1 with the prefill's K/V, in place on the
        # device (slots >= L hold garbage, masked until written)
        for i in range(self.num_layers):
            self._kv("kv_k_%d" % i)[:, :, 0:P, :].copy_(pf.outputs[1 + 2 * i]._tensor())
            self._kv("kv_v_%d" % i)[:, :, 0:P, :].copy_(pf.outputs[2 + 2 * i]._tensor())
        self._pos = L
        self._last_return_t = None  # a new sequence: no decode return before it
        if _tm.enabled():
            _tm.counter("serving.prefill_tokens").inc(B * L)
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
        _gap_mark(self, "serving.decode_step")
        return exe

    def _finish_step(self, exe):
        """The one ring slot the step wrote into the decoder's KV buffers, in
        place (every other slot of the graph's KV output is its input's)."""
        s = self._pos % self.max_len
        for i in range(self.num_layers):
            for j, name in ((1 + 2 * i, "kv_k_%d" % i), (2 + 2 * i, "kv_v_%d" % i)):
                self._kv(name)[:, :, s:s + 1, :].copy_(exe.outputs[j]._tensor()[:, :, s:s + 1, :])
        self._pos += 1
        if _tm.enabled():
            _tm.counter("serving.decode_tokens").inc(self.batch)
            _tm.gauge("decode.tokens_per_dispatch").set(self.batch)

    def decode_step(self, tokens):
        """One token per stream; returns (B, vocab) logits for the next position."""
        exe = self._stage_step(tokens)
        t0 = time.perf_counter()
        with _tm.span("serving.decode_step", rows=self.batch, pos=self._pos):
            exe.forward(is_train=False)
            logits = exe.outputs[0].asnumpy()
        if _tm.enabled():
            _tm.timer("serving.decode_step").add(time.perf_counter() - t0)
        _gap_return(self)
        self._finish_step(exe)
        return logits

    def greedy_step(self, tokens):
        """One greedy token per stream: only the on-device ``greedy_token``
        head, (B,) ids, crosses to the host (a host argmax of the logits for
        a decode program without the head)."""
        self.warmup()
        if not self._token_out:
            return np.argmax(self.decode_step(tokens), axis=-1)
        exe = self._stage_step(tokens)
        t0 = time.perf_counter()
        with _tm.span("serving.decode_step", rows=self.batch, pos=self._pos, greedy=True):
            exe.forward(is_train=False)
            nxt = exe.outputs[-1].asnumpy()
        if _tm.enabled():
            _tm.timer("serving.decode_step").add(time.perf_counter() - t0)
        _gap_return(self)
        self._finish_step(exe)
        return nxt.astype(np.int64)

    def decode_megastep(self, tokens, k=None, eos_id=None, sample=None,
                        temperature=None, top_k=None):
        """K tokens per stream in ONE dispatch (one CUDA-graph replay on the
        card): in-graph ring writes, on-device sampling (greedy argmax by
        default; ``sample='topk'`` with ``temperature``/``top_k``), and only
        the (B, K) ids cross to the host. ``eos_id`` arms per-lane early
        exit: after a lane emits it, its later steps write nothing and emit
        eos filler; the position still advances by K for every lane.
        ``tokens`` is the (B,) step input, as for ``greedy_step``. Returns
        (B, K) int64 ids."""
        self.warmup()
        k = int(k) if k is not None else decode_megastep_k()
        if k < 1:
            raise MXNetError("decode_megastep: K must be >= 1, got %d" % k)
        p, S, B = self._pos, self.max_len, self.batch
        if p + k > self.pos_len:
            raise MXNetError(
                "decode_megastep: positions %d..%d exceed the trained position table "
                "(%d rows)" % (p, p + k - 1, self.pos_len))
        ms = _megastep_for(self, k, _sampler_from(sample, temperature, top_k))
        tok0 = np.asarray(tokens, np.int32).reshape(B)
        posv = np.full((B,), p, np.int32)
        # K consecutive ring slots, staged on the host as _stage_step stages one
        slots = np.tile((np.arange(p, p + k) % S).astype(np.int32), (B, 1))
        valid = np.arange(S) < min(p, S)
        base_mask = np.broadcast_to(np.where(valid, np.float32(0), _NEG), (B, S)) \
            .astype(np.float32).copy()
        done0 = np.zeros((B,), bool)
        eos = -1 if eos_id is None else int(eos_id)
        _gap_mark(self, "serving.decode_megastep")
        t0 = time.perf_counter()
        with _tm.span("serving.decode_megastep", rows=B, pos=p, k=k):
            ids, acts = ms.run(self, tok0, posv, slots, base_mask, done0, eos)
        if _tm.enabled():
            _tm.timer("serving.decode_megastep").add(time.perf_counter() - t0)
        _gap_return(self)
        self._pos = p + k
        if _tm.enabled():
            _tm.counter("serving.decode_tokens").inc(int(acts.sum()))
            _tm.counter("serving.megasteps").inc()
            _tm.gauge("decode.tokens_per_dispatch").set(ids.size)
        return ids.T.astype(np.int64)

    def greedy(self, prompt, n_tokens, k=None, eos_id=None):
        """Greedy-decode ``n_tokens`` continuations of a (B, L) prompt. With
        ``k`` > 1 (default ``MXNET_DECODE_MEGASTEP_K``) K tokens a dispatch
        through ``decode_megastep``, the sub-K tail through ``greedy_step``;
        K=1 is one token a dispatch. Returns (B, n_tokens) int64 ids."""
        k = int(k) if k is not None else decode_megastep_k()
        logits = self.prefill(prompt)
        nxt = np.argmax(logits, axis=-1)  # once per sequence: logits are host-side
        out = np.zeros((self.batch, n_tokens), np.int64)
        if n_tokens:
            out[:, 0] = nxt
        t = 1
        while t < n_tokens:
            if k > 1 and n_tokens - t >= k:
                chunk = self.decode_megastep(nxt, k=k, eos_id=eos_id)
                out[:, t:t + k] = chunk
                nxt = chunk[:, -1]
                t += k
            else:
                nxt = self.greedy_step(nxt)
                out[:, t] = nxt
                t += 1
        return out


# --------------------------------------------------------------- paged decode
class PagedKVExhausted(MXNetError):
    """The paged KV pool cannot satisfy an allocation: no free lane for a new
    sequence, or no free page for a growing one. Retire a sequence (or size
    the pool larger) and retry: admission backpressure, not corruption."""


# copied from mxnet_tpu/serving/kv_decode.py _PagePool (:747), backend-free
class _PagePool:
    """Refcounted block allocator over ONE global slot axis.

    The pool's ``lanes * slots`` KV slots form one physical space carved into
    fixed-size page frames; any lane (and the prefix index) may reference any
    frame. Every holder owns a reference: ``acquire`` hands out a frame at
    refcount 1, ``incref`` adds a holder, ``release`` drops one and returns
    the frame to the free list only when the LAST holder lets go.

    Frames come off a LIFO free list, and ``release`` pushes them back
    REVERSED so a retire-then-readmit (or rollback-then-regrow) replays the
    original placement order: deterministic placement, which the bitwise
    cached-admit parity leans on. A ``budget`` below the physical frame count
    models admission control against a smaller reservation; a shared frame
    counts once."""

    def __init__(self, lanes, slots, page_size, budget=None):
        if slots % page_size:
            raise MXNetError("paged_kv: page_size %d must divide the %d slots per lane"
                             % (page_size, slots))
        self.lanes = int(lanes)
        self.page_size = int(page_size)
        self.frames_per_lane = slots // page_size
        self.total_frames = self.lanes * self.frames_per_lane
        self.budget = int(budget) if budget else self.total_frames
        self._free = list(range(self.total_frames))
        self._ref: Dict[int, int] = {}  # frame -> holder count

    @property
    def in_use(self):
        """Frames with at least one holder (each counts once)."""
        return len(self._ref)

    def can_acquire(self, n=1):
        return len(self._free) >= n and self.in_use + n <= self.budget

    def acquire(self):
        """One free frame at refcount 1, or raise ``PagedKVExhausted``."""
        if self.in_use >= self.budget:
            raise PagedKVExhausted(
                "paged_kv: page budget exhausted (%d/%d frames in use); retire a "
                "sequence and retry" % (self.in_use, self.budget))
        if not self._free:
            raise PagedKVExhausted(
                "paged_kv: no free page frame (%d frames all referenced) — retire a "
                "sequence or evict cached prefixes and retry" % self.total_frames)
        f = self._free.pop()
        self._ref[f] = 1
        return f

    def incref(self, frame):
        """Add a holder to an allocated frame (page sharing)."""
        self._ref[frame] += 1

    def refcount(self, frame):
        return self._ref.get(frame, 0)

    def release(self, frames):
        """Drop ONE reference per listed frame; frames whose last holder left
        go back on the free list (reversed: see the class docstring)."""
        freed = []
        for f in frames:
            n = self._ref[f] - 1
            if n:
                self._ref[f] = n
            else:
                del self._ref[f]
                freed.append(f)
        self._free.extend(reversed(freed))


class _Lane:
    __slots__ = ("seq_id", "pos", "frames")

    def __init__(self, seq_id):
        self.seq_id = seq_id
        self.pos = 0            # next position to be written
        self.frames = []        # logical page -> physical frame index


class PagedKVDecoder:
    """Multiplexed KV-cache decode: ONE decode batch serves many concurrent,
    independently positioned sequences.

    The decode executable's batch rows are ``lanes``: sequences are admitted
    one at a time, advance at their own positions and retire independently.
    KV storage is ONE global slot pool (``get_decode_symbol(global_slots=
    True)``): per layer (H, lanes·max_len, dh), carved into ``page_size``
    frames that a ``_PagePool`` hands out on demand, so a frame is a slot
    range any lane can read. Per-lane math is that of a batch-1
    ``KVCacheDecoder`` at the same position.

    With ``prefix_cache=True`` (or ``MXNET_SERVE_PREFIX_CACHE=1``) admit
    hashes the prompt in ``prefix_chunk``-token chunks, adopts the cached
    pages of the longest matched chunk chain at a refcount, and
    chunk-prefills only the rest through the chunk program. A lane's first
    write into a page another holder still references copies it first
    (copy-on-write; ``fork`` shares every page this way). ``rollback``
    truncates a sequence by releasing whole pages, the speculative reject
    primitive (``serving/speculative.py``)."""

    def __init__(self, arg_params: Dict[str, object], vocab_size,
                 num_layers=2, num_heads=2, model_dim=32, ffn_dim=64,
                 max_len=64, page_size=8, lanes=4, page_budget=None,
                 prefill_len: Optional[int] = None,
                 pos_len: Optional[int] = None, prefix_cache=None,
                 prefix_chunk=None, ctx=None, dtype="float32", cache_dir=None,
                 model_key=None, sample_seed=None):
        from ..models import transformer as _tf

        self.vocab_size = int(vocab_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.model_dim = int(model_dim)
        self.ffn_dim = int(ffn_dim)
        self.max_len = int(max_len)
        self.lanes = int(lanes)
        self.prefill_len = int(prefill_len or max_len)
        self.pos_len = int(pos_len or max_len)
        self.dh = self.model_dim // self.num_heads
        if self.prefill_len > self.max_len:
            raise MXNetError("paged_kv: prefill_len %d > max_len %d"
                             % (self.prefill_len, self.max_len))
        self.pool = _PagePool(self.lanes, self.max_len, page_size, budget=page_budget)
        self.page_size = self.pool.page_size
        self.total_slots = self.lanes * self.max_len
        self._global_slots = True
        if prefix_cache is None:
            prefix_cache = os.environ.get("MXNET_SERVE_PREFIX_CACHE", "").strip().lower() \
                in ("1", "on", "true", "yes")
        if prefix_cache:
            from .prefix_cache import PrefixCache

            if prefix_chunk is None:
                raw = os.environ.get("MXNET_SERVE_PREFIX_CHUNK", "").strip()
                prefix_chunk = int(raw) if raw else self.page_size
            self.prefix_chunk = int(prefix_chunk)
            self._prefix = PrefixCache(self.pool, self.prefix_chunk)
        else:
            self.prefix_chunk = None
            self._prefix = None
        self._prefix_hits = 0
        self._prefix_misses = 0
        cfg = dict(vocab_size=self.vocab_size, num_layers=self.num_layers,
                   num_heads=self.num_heads, model_dim=self.model_dim,
                   ffn_dim=self.ffn_dim, pos_len=self.pos_len)
        key = model_key or "transformer_paged_global_decode"
        self._pf_cache = PersistentExecutableCache(
            _tf.get_prefill_symbol(prefill_len=self.prefill_len, **cfg),
            arg_params, {}, ctx=ctx, dtype=dtype, cache_dir=cache_dir,
            model_key=key + "-prefill")
        self._dec_cache = PersistentExecutableCache(
            _tf.get_decode_symbol(max_len=self.total_slots, per_stream_slots=True,
                                  global_slots=True, **cfg),
            arg_params, {}, ctx=ctx, dtype=dtype, cache_dir=cache_dir,
            model_key=key + "-decode")
        self._dec_exe = None
        self._lanes: Dict[int, _Lane] = {}   # lane index -> _Lane
        self._seq_lane: Dict[int, int] = {}  # seq_id -> lane index
        self._next_seq = 0
        self._warm = False
        self._megasteps = {}        # (K, sampler) -> _DecodeMegastep
        self._chunks = {}           # T -> _ChunkProgram
        self._last_return_t = None  # dispatch.host_gap interval start
        self._sample_seed = sample_seed
        self._sample_key = None

    # ------------------------------------------------------------ lifecycle
    def _decode_shapes(self):
        B, S, H, dh = self.lanes, self.total_slots, self.num_heads, self.dh
        shapes = {"data": (B, 1), "pos_idx": (B, 1),
                  "slot_onehot": (B, S), "kv_mask": (B, S)}
        for i in range(self.num_layers):
            shapes["kv_k_%d" % i] = (H, S, dh)
            shapes["kv_v_%d" % i] = (H, S, dh)
        return shapes

    def warmup(self):
        """Bind the multiplexed decode executable and the admit-side
        program: the batch-1 prefill bucket, or the C-token chunk program
        when the prefix cache is on (chunked admits never use the prefill
        bucket: cold and cached admits must run the SAME program for their
        logits to be bitwise equal)."""
        if self._warm:
            return self
        self._dec_cache.warmup([self._decode_shapes()])
        self._dec_exe = self._dec_cache.executable(self._decode_shapes())
        self._warm = True
        if self._prefix is None:
            self._pf_cache.warmup([{"data": (1, self.prefill_len)}])
        else:
            self._chunk_for(self.prefix_chunk)
        return self

    def stats(self):
        out = {"lanes": self.lanes,
               "active": len(self._lanes),
               "pages_in_use": self.pool.in_use,
               "page_budget": self.pool.budget,
               "page_size": self.page_size}
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
            tot = self._prefix_hits + self._prefix_misses
            out["prefix_hit_rate"] = (self._prefix_hits / tot) if tot else 0.0
        return out

    def _kv(self, name):
        return self._dec_exe.arg_dict[name]._tensor()

    def _kv_names(self):
        return [n for i in range(self.num_layers) for n in ("kv_k_%d" % i, "kv_v_%d" % i)]

    # ------------------------------------------------------------ admission
    def _acquire_frame(self):
        """One page frame from the pool, evicting cached prefixes (LRU,
        leaf-first) to make room before giving up."""
        try:
            return self.pool.acquire()
        except PagedKVExhausted:
            if self._prefix is not None and self._prefix.evict_for(1):
                return self.pool.acquire()
            raise

    def _cow_page(self, lane: _Lane, page):
        """Copy-on-write: give ``lane`` a private copy of logical page
        ``page`` when another holder (a lane or the prefix index) still
        references its frame: a slot-range copy in every layer's K/V buffer,
        in place; the shared frame loses one ref."""
        frame = lane.frames[page]
        if self.pool.refcount(frame) <= 1:
            return frame
        fresh = self._acquire_frame()
        P = self.page_size
        for name in self._kv_names():
            ring = self._kv(name)
            ring[:, fresh * P:(fresh + 1) * P, :].copy_(ring[:, frame * P:(frame + 1) * P, :])
        self.pool.release([frame])
        lane.frames[page] = fresh
        if _tm.enabled():
            _tm.counter("serving.cow_copies").inc()
        return fresh

    def _phys_slot(self, lane: _Lane, pos):
        """Physical slot of logical position ``pos`` FOR WRITING: acquires a
        new frame when the position crosses into an unallocated page, and
        resolves copy-on-write when its page is still shared."""
        if pos >= self.max_len:
            raise MXNetError("paged_kv: position %d exceeds the per-sequence slot quota "
                             "(max_len %d)" % (pos, self.max_len))
        page, off = divmod(pos, self.page_size)
        while len(lane.frames) <= page:
            lane.frames.append(self._acquire_frame())
        frame = self._cow_page(lane, page)
        return frame * self.page_size + off

    def _lane_slots(self, lane: _Lane, upto=None):
        """Physical slots of positions 0..n-1 (n = ``lane.pos`` unless
        ``upto`` given), derived from the frame table: positions are always
        contiguous, so the slot list IS the page map."""
        n = lane.pos if upto is None else int(upto)
        if n <= 0:
            return np.zeros((0,), np.int64)
        P = self.page_size
        pages = np.asarray(lane.frames[:(n + P - 1) // P], np.int64)
        slots = pages[:, None] * P + np.arange(P, dtype=np.int64)[None, :]
        return slots.reshape(-1)[:n]

    def _free_lane(self):
        free_lanes = [i for i in range(self.lanes) if i not in self._lanes]
        if not free_lanes:
            raise PagedKVExhausted("paged_kv: all %d lanes occupied; retire a sequence first"
                                   % self.lanes)
        return free_lanes[0]

    def _lane_of(self, seq_id):
        idx = self._seq_lane.get(seq_id)
        if idx is None:
            raise MXNetError("paged_kv: unknown seq_id %r" % (seq_id,))
        return idx, self._lanes[idx]

    def admit(self, prompt):
        """Admit one sequence. ``prompt`` is a (L,) or (1, L) token array,
        0 < L <= prefill_len. Returns ``(seq_id, logits)``, the (vocab,)
        logits of its next token. Raises ``PagedKVExhausted`` when no lane
        or not enough frames are free.

        Without the prefix cache a batch-1 prefill seeds the lane's pages.
        With it, matched chunks are adopted at a refcount and only the
        unmatched tail runs through the chunk program; cold and cached
        admits run the same program over the same physical slots, so their
        logits are bitwise equal."""
        self.warmup()
        prompt = np.asarray(prompt, dtype=np.float32).reshape(1, -1)
        L = prompt.shape[1]
        if not 0 < L <= self.prefill_len:
            raise MXNetError("paged_kv: prompt length %d not in (0, %d]"
                             % (L, self.prefill_len))
        idx = self._free_lane()
        seq_id = self._next_seq
        self._next_seq += 1
        lane = _Lane(seq_id)
        self._lanes[idx] = lane
        self._seq_lane[seq_id] = idx
        try:
            if self._prefix is not None:
                logits = self._admit_chunked(prompt, lane)
            else:
                logits = self._admit_prefill(prompt, lane, idx)
        except BaseException:
            # the caller has no seq_id to retire: release the lane and its
            # frames, or each failed admit would leak them
            self._evict(idx)
            raise
        lane.pos = L
        self._last_return_t = None  # an admit breaks the steady decode chain
        if _tm.enabled():
            _tm.counter("serving.paged_admits").inc()
            _tm.counter("serving.prefill_tokens").inc(L)
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)
        return seq_id, logits

    def _admit_prefill(self, prompt, lane, idx):
        """One batch-1 prefill dispatch, then the prompt's K/V scattered into
        the lane's physical slots on the device."""
        L = prompt.shape[1]
        phys = [self._phys_slot(lane, p) for p in range(L)]
        padded = np.zeros((1, self.prefill_len), np.float32)
        padded[:, :L] = prompt
        with _tm.span("serving.paged_admit", seq=lane.seq_id, prompt_len=L, lane=idx):
            pf = self._pf_cache.executable({"data": (1, self.prefill_len)})
            pf.arg_dict["data"][:] = padded
            pf.forward(is_train=False)
            logits = pf.outputs[0]._tensor().reshape(
                1, self.prefill_len, self.vocab_size)[0, L - 1, :].cpu().numpy()
            phys_idx = None
            for i in range(self.num_layers):
                for tag, out in (("kv_k_%d" % i, pf.outputs[1 + 2 * i]),
                                 ("kv_v_%d" % i, pf.outputs[2 + 2 * i])):
                    ring = self._kv(tag)
                    if phys_idx is None:
                        phys_idx = torch.as_tensor(phys, dtype=torch.int64).to(ring.device)
                    ring.index_copy_(1, phys_idx, out._tensor()[0, :, :L, :])
        return logits

    def _chunk_for(self, t):
        """The sealed T-token chunk program, warmed on first use."""
        prog = self._chunks.get(t)
        if prog is None:
            prog = _ChunkProgram(self, t)
            prog.warm(self)
            self._chunks[t] = prog
        return prog

    def _run_chunk(self, lane: _Lane, tokens, base, write, prog=None):
        """Dispatch ``tokens`` (length <= T) of ``lane`` at positions
        ``base..base+len-1`` through the chunk program, writing their K/V
        when ``write`` (rows past ``len`` are pad: zero write-onehot, fully
        masked). Returns host logits rows (len, vocab)."""
        prog = prog or self._chunk_for(self.prefix_chunk)
        T, S = prog.t, self.total_slots
        n = len(tokens)
        data = np.zeros((1, T), np.float32)
        pos_idx = np.zeros((1, T), np.float32)
        w_oh = np.zeros((T, S), np.float32)
        mask = np.full((T, S), _NEG, np.float32)
        data[0, :n] = tokens
        pos_idx[0, :n] = np.arange(base, base + n)
        if write:
            phys = [self._phys_slot(lane, base + j) for j in range(n)]
        else:
            phys = self._lane_slots(lane, base + n)[base:]
        seen = self._lane_slots(lane, base)
        for j in range(n):
            if write:
                w_oh[j, phys[j]] = 1.0
            mask[j, seen] = 0.0
            mask[j, phys[: j + 1]] = 0.0
        _gap_mark(self, "serving.chunk_prefill")
        with _tm.span("serving.chunk_prefill", t=T, rows=n, write=bool(write)):
            logits, new_kvs = prog.run(self, data, pos_idx, w_oh, mask)
            out = logits[:n].cpu().numpy()
        _gap_return(self)
        if write:
            self._write_back(new_kvs)
        return out

    def _write_back(self, new_kvs):
        """A dispatch's KV outputs into the decoder's KV buffers, in place:
        whole buffers, one copy each. Only the dispatch's slots changed, but
        on the card a gather and a scatter of a few scattered slots take
        longer than a whole buffer's copy (``tools/torch_slot_copy_times.py``)."""
        for name, new in zip(self._kv_names(), new_kvs):
            self._kv(name).copy_(new)

    def _admit_chunked(self, prompt, lane):
        """Prefix-cache admit: match the prompt's chunk-hash chain, adopt the
        matched pages at a refcount, chunk-prefill only the rest. A fully
        matched prompt replays its last chunk with a ZERO write-onehot, which
        leaves every buffer bitwise untouched and gives the cold admit's
        logits."""
        C = self.prefix_chunk
        toks = np.asarray(prompt, np.int64).reshape(-1)
        L = toks.shape[0]
        n_full = L // C
        hashes = self._prefix.chain_hashes(toks[:n_full * C])
        matched, frames = self._prefix.match(hashes)
        for f in frames:
            self.pool.incref(f)
        lane.frames = list(frames)
        if _tm.enabled() and frames:
            _tm.counter("serving.pages_shared").inc(len(frames))
        if matched:
            self._prefix_hits += 1
            if _tm.enabled():
                _tm.counter("serving.prefix_hits").inc(matched)
                _tm.counter("serving.prefill_tokens_saved").inc(matched * C)
        else:
            self._prefix_misses += 1
        if _tm.enabled():
            _tm.counter("serving.prefix_misses").inc(n_full - matched)
        logits = None
        with _tm.span("serving.paged_admit", seq=lane.seq_id, prompt_len=L,
                      cached_tokens=matched * C):
            for c in range(matched, n_full):
                base = c * C
                rows = self._run_chunk(lane, toks[base:base + C], base, write=True)
                logits = rows[-1]
                # whole chunks become cache entries as soon as they are
                # computed; the index increfs the frames itself
                self._prefix.insert(
                    hashes[c], lane.frames[base // self.page_size:(base + C) // self.page_size],
                    parent=hashes[c - 1] if c else None)
            tail = L - n_full * C
            if tail:
                logits = self._run_chunk(lane, toks[L - tail:], L - tail, write=True)[-1]
            elif logits is None:
                # full match: zero-write replay of the last chunk
                base = (n_full - 1) * C
                logits = self._run_chunk(lane, toks[base:base + C], base, write=False)[-1]
        if _tm.enabled():
            tot = self._prefix_hits + self._prefix_misses
            _tm.gauge("serving.prefix_hit_rate").set(self._prefix_hits / tot if tot else 0.0)
        return logits

    def _evict(self, idx):
        lane = self._lanes.pop(idx)
        self._seq_lane.pop(lane.seq_id, None)
        self.pool.release(lane.frames)

    def retire(self, seq_id):
        """Free a finished sequence's lane and page frames (its slots are
        masked out for every other lane already; nothing is zeroed)."""
        idx, _ = self._lane_of(seq_id)
        self._evict(idx)
        if _tm.enabled():
            _tm.counter("serving.paged_retires").inc()
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)

    @property
    def active(self):
        return sorted(self._seq_lane)

    def position(self, seq_id):
        return self._lane_of(seq_id)[1].pos

    # ----------------------------------------------------- fork / rollback
    def fork(self, seq_id):
        """Clone a sequence into a free lane by SHARING every page frame at
        a refcount: no copy, no recompute. Either side's next write into a
        shared page copies it first. Returns the clone's seq_id."""
        _, src = self._lane_of(seq_id)
        new_idx = self._free_lane()
        new_id = self._next_seq
        self._next_seq += 1
        lane = _Lane(new_id)
        lane.pos = src.pos
        lane.frames = list(src.frames)
        for f in lane.frames:
            self.pool.incref(f)
        self._lanes[new_idx] = lane
        self._seq_lane[new_id] = new_idx
        if _tm.enabled():
            _tm.counter("serving.pages_shared").inc(len(lane.frames))
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)
        return new_id

    def rollback(self, seq_id, pos):
        """Truncate a sequence back to ``pos`` written positions: whole pages
        past the boundary are RELEASED (a frame another holder shares just
        loses this lane's ref); the partial boundary page is kept, its stale
        tail left out of the derived valid-slot set. No device work: the
        speculative reject primitive."""
        _, lane = self._lane_of(seq_id)
        pos = int(pos)
        if not 0 <= pos <= lane.pos:
            raise MXNetError("paged_kv: rollback target %d outside [0, %d]" % (pos, lane.pos))
        keep = (pos + self.page_size - 1) // self.page_size
        dropped = lane.frames[keep:]
        del lane.frames[keep:]
        self.pool.release(dropped)
        lane.pos = pos
        if _tm.enabled():
            _tm.counter("spec.rollbacks").inc()
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)

    def verify_chunk(self, seq_id, tokens):
        """Score ``tokens`` (length T) at the sequence's next T positions in
        ONE rectangular dispatch, writing their K/V (row j attends to
        everything before it and rows 0..j: T successive ``step`` calls
        fused). Advances the position by T; the caller accepts a prefix and
        ``rollback``s the rest. Returns (T, vocab) logits: the speculative
        verify pass."""
        self.warmup()
        _, lane = self._lane_of(seq_id)
        toks = np.asarray(tokens, np.int64).reshape(-1)
        t = toks.shape[0]
        if t < 1:
            raise MXNetError("verify_chunk: need at least one token")
        if lane.pos + t > self.pos_len:
            raise MXNetError(
                "paged_kv: seq %d verify positions %d..%d exceed the trained position "
                "table (%d rows)" % (seq_id, lane.pos, lane.pos + t - 1, self.pos_len))
        rows = self._run_chunk(lane, toks, lane.pos, write=True, prog=self._chunk_for(t))
        lane.pos += t
        if _tm.enabled():
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)
        return rows

    # --------------------------------------------------------------- decode
    def step(self, tokens: Dict[int, object]):
        """One multiplexed decode dispatch: ``tokens`` maps seq_id -> next
        token id for any subset of the active sequences; each advances at
        its own position. Returns {seq_id: (vocab,) logits}. Lanes not
        stepped ride along with an all-zero write-onehot: their KV is
        untouched and their logits discarded."""
        self.warmup()
        if not tokens:
            return {}
        B, S = self.lanes, self.total_slots
        data = np.zeros((B, 1), np.float32)
        pos_idx = np.zeros((B, 1), np.float32)
        oh = np.zeros((B, S), np.float32)
        mask = np.full((B, S), _NEG, np.float32)
        stepped = []
        for seq_id, tok in tokens.items():
            idx, lane = self._lane_of(seq_id)
            if lane.pos >= self.pos_len:
                raise MXNetError(
                    "paged_kv: seq %d at position %d exceeds the trained position table "
                    "(%d rows)" % (seq_id, lane.pos, self.pos_len))
            phys = self._phys_slot(lane, lane.pos)
            data[idx, 0] = float(np.asarray(tok).reshape(()))
            pos_idx[idx, 0] = lane.pos
            oh[idx, phys] = 1.0
            mask[idx, self._lane_slots(lane)] = 0.0
            mask[idx, phys] = 0.0
            stepped.append((seq_id, idx, lane))
        exe = self._dec_exe
        exe.arg_dict["data"][:] = data
        exe.arg_dict["pos_idx"][:] = pos_idx
        exe.arg_dict["slot_onehot"][:] = oh
        exe.arg_dict["kv_mask"][:] = mask
        _gap_mark(self, "serving.paged_step")
        with _tm.span("serving.decode_step", rows=len(stepped), paged=True):
            exe.forward(is_train=False)
            logits = exe.outputs[0].asnumpy()
        _gap_return(self)
        self._write_back([exe.outputs[1 + j]._tensor() for j in range(2 * self.num_layers)])
        out = {}
        for seq_id, idx, lane in stepped:
            lane.pos += 1
            out[seq_id] = logits[idx]
        if _tm.enabled():
            _tm.counter("serving.decode_tokens").inc(len(stepped))
            _tm.counter("serving.paged_steps").inc()
            _tm.gauge("decode.tokens_per_dispatch").set(len(stepped))
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)
        return out

    def step_megastep(self, tokens: Dict[int, object], k=None, eos_id=None,
                      sample=None, temperature=None, top_k=None):
        """K multiplexed decode steps in ONE dispatch (one CUDA-graph replay
        on the card): every stepped sequence advances K positions at its own
        offsets, sampling on the device (greedy argmax by default,
        temperature/top-k with ``sample='topk'``). Frames for all K
        positions are acquired UP FRONT, so ``PagedKVExhausted`` comes before
        any device work (frames already acquired stay with their lanes).
        Lanes not stepped ride along idle; with ``eos_id`` a lane that emits
        eos writes nothing after it and only its pre-eos positions advance.
        Returns {seq_id: (K,) int64 ids}."""
        self.warmup()
        k = int(k) if k is not None else decode_megastep_k()
        if k < 1:
            raise MXNetError("step_megastep: K must be >= 1, got %d" % k)
        if not tokens:
            return {}
        B, S = self.lanes, self.total_slots
        stepped = []
        for seq_id, tok in tokens.items():
            idx, lane = self._lane_of(seq_id)
            if lane.pos + k > self.pos_len:
                raise MXNetError(
                    "paged_kv: seq %d megastep positions %d..%d exceed the trained "
                    "position table (%d rows)"
                    % (seq_id, lane.pos, lane.pos + k - 1, self.pos_len))
            stepped.append((seq_id, idx, lane, tok))
        phys = {seq_id: [self._phys_slot(lane, lane.pos + i) for i in range(k)]
                for seq_id, _, lane, _ in stepped}
        ms = _megastep_for(self, k, _sampler_from(sample, temperature, top_k))
        tok0 = np.zeros((B,), np.int32)
        posv = np.zeros((B,), np.int32)
        slots = np.zeros((B, k), np.int32)
        base_mask = np.full((B, S), _NEG, np.float32)
        done0 = np.ones((B,), bool)  # idle unless stepped
        for seq_id, idx, lane, tok in stepped:
            tok0[idx] = int(np.asarray(tok).reshape(()))
            posv[idx] = lane.pos
            slots[idx] = phys[seq_id]
            base_mask[idx, self._lane_slots(lane)] = 0.0
            done0[idx] = False
        eos = -1 if eos_id is None else int(eos_id)
        _gap_mark(self, "serving.paged_megastep")
        with _tm.span("serving.decode_megastep", rows=len(stepped), paged=True, k=k):
            ids, acts = ms.run(self, tok0, posv, slots, base_mask, done0, eos)
        _gap_return(self)
        out = {}
        written = 0
        for seq_id, idx, lane, _ in stepped:
            # active steps form a prefix (done latches): exactly the steps
            # whose KV write landed, and only those positions advance
            n_w = int(acts[:, idx].sum())
            lane.pos += n_w
            written += n_w
            out[seq_id] = ids[:, idx].astype(np.int64)
        if _tm.enabled():
            _tm.counter("serving.decode_tokens").inc(written)
            _tm.counter("serving.megasteps").inc()
            _tm.gauge("decode.tokens_per_dispatch").set(k * len(stepped))
            _tm.gauge("serving.paged_pages_in_use").set(self.pool.in_use)
        return out

    def greedy(self, prompts, n_tokens, k=None):
        """Greedy-decode ``n_tokens`` continuations of several prompts at
        once through the multiplexed batch (admitted together, stepped
        together). With ``k`` > 1 (default ``MXNET_DECODE_MEGASTEP_K``) K
        tokens a dispatch through ``step_megastep``, the sub-K tail through
        ``step``; K=1 is one dispatch a token. ``prompts`` is a list of
        (L_i,) token arrays. Returns a list of (n_tokens,) int64 arrays; the
        sequences are retired on every exit."""
        k = int(k) if k is not None else decode_megastep_k()
        seqs = []
        logits = {}
        try:
            for p in prompts:
                sid, lg = self.admit(p)
                seqs.append(sid)
                logits[sid] = lg
            out = {sid: np.zeros((n_tokens,), np.int64) for sid in seqs}
            nxt = {sid: int(np.argmax(logits[sid])) for sid in seqs}
            for sid in seqs:
                if n_tokens:
                    out[sid][0] = nxt[sid]
            t = 1
            while t < n_tokens:
                if k > 1 and n_tokens - t >= k:
                    chunk = self.step_megastep(nxt, k=k)
                    for sid in seqs:
                        out[sid][t:t + k] = chunk[sid]
                        nxt[sid] = int(chunk[sid][-1])
                    t += k
                else:
                    lg = self.step(nxt)
                    nxt = {sid: int(np.argmax(lg[sid])) for sid in seqs}
                    for sid in seqs:
                        out[sid][t] = nxt[sid]
                    t += 1
            return [out[sid] for sid in seqs]
        finally:
            for sid in seqs:
                if sid in self._seq_lane:
                    self.retire(sid)
