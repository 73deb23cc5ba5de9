"""Speculative decoding, the port against the JAX package on the CPU: the
draft-verify stream is token-identical to the port's plain greedy and to
JAX's, for a truncated draft, a draft equal to the target (every proposal
accepted) and a draft of unrelated weights (rounds rejected); both decoders
give back every page; the knobs and ``draft_config`` resolve as in the
reference."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import PagedKVDecoder as JaxPaged
from mxnet_tpu.serving import speculative as jspec
from mxnet_tpu_torch.models import transformer as ptf
from mxnet_tpu_torch.serving import PagedKVDecoder, SpeculativeDecoder
from mxnet_tpu_torch.serving import speculative as pspec

torch.set_num_threads(1)

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64)
SERVE = dict(max_len=32, page_size=4, lanes=1, prefill_len=8, pos_len=32, prefix_cache=False)


def _params(seed=0, S=32):
    """Random weights that keep greedy decode varied: matrices N(0, 1/fan_in),
    embeddings N(0, 1), LayerNorm gains 1 + N(0, 0.25)."""
    net = jtf.get_symbol(seq_len=S, **CFG)
    shapes = net.infer_shape(data=(1, S), softmax_label=(1, S))[0]
    rs = np.random.RandomState(seed)
    out = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        w = rs.randn(*s)
        if "embed" in n:
            pass
        elif n.endswith("_gamma"):
            w = 1 + 0.5 * w
        elif len(s) == 2:
            w = w / np.sqrt(s[1])
        else:
            w = 0.1 * w
        out[n] = w.astype(np.float32)
    return out


PARAMS = _params()
PROMPT = np.random.RandomState(7).randint(1, CFG["vocab_size"], (5,))
N_TOKENS = 20


def _port_params(params=PARAMS):
    return pt.params_from_numpy(params, ctx=pt.cpu())


@pytest.fixture(scope="module")
def jax_greedy():
    return JaxPaged(PARAMS, ctx=mx.cpu(), **CFG, **SERVE).greedy([PROMPT], N_TOKENS, k=1)[0]


def _draft(kind):
    if kind == "hostile":
        return PagedKVDecoder(_port_params(_params(seed=99)), ctx=pt.cpu(), **CFG, **SERVE)
    layers = 1 if kind == "truncated" else CFG["num_layers"]
    return PagedKVDecoder(_port_params(), ctx=pt.cpu(),
                          **ptf.draft_config(dict(CFG, **SERVE), layers))


@pytest.mark.parametrize("kind", ["truncated", "self", "hostile"])
def test_speculative_greedy_equals_plain_greedy_and_jax(jax_greedy, kind):
    target = PagedKVDecoder(_port_params(), ctx=pt.cpu(), **CFG, **SERVE)
    plain = target.greedy([PROMPT], N_TOKENS, k=1)[0]
    np.testing.assert_array_equal(plain, jax_greedy)
    assert len(np.unique(plain)) > 5
    spec = SpeculativeDecoder(target, _draft(kind), gamma=3).warmup()
    rounds = []
    verify = target.verify_chunk

    def counted(seq_id, tokens):
        rounds.append(len(tokens))
        return verify(seq_id, tokens)

    target.verify_chunk = counted
    got = spec.greedy(PROMPT, N_TOKENS)
    np.testing.assert_array_equal(got, jax_greedy)
    if kind == "self":  # every proposal accepted: 4 tokens a round
        assert len(rounds) == (N_TOKENS - 1 + 3) // 4
    if kind == "hostile":  # rejections: fewer than 4 tokens a round on average
        assert len(rounds) > (N_TOKENS - 1 + 3) // 4
    assert target.stats()["pages_in_use"] == 0 and spec.draft.stats()["pages_in_use"] == 0
    assert spec.stats()["gamma"] == 3


def test_build_cuts_the_draft_from_the_targets_checkpoint():
    spec = SpeculativeDecoder.build(_port_params(), draft_layers=1, gamma=4, ctx=pt.cpu(),
                                    **CFG, **SERVE)
    assert spec.target.num_layers == 2 and spec.draft.num_layers == 1
    np.testing.assert_array_equal(spec.greedy(PROMPT, 9),
                                  spec.target.greedy([PROMPT], 9, k=1)[0])
    with pytest.raises(pt.MXNetError, match="vocab"):
        SpeculativeDecoder(spec.target, PagedKVDecoder(
            _port_params(), ctx=pt.cpu(), **dict(CFG, vocab_size=32), **SERVE))
    with pytest.raises(pt.MXNetError, match="gamma"):
        SpeculativeDecoder(spec.target, spec.draft, gamma=0)


@pytest.mark.parametrize("layers", [1, 2, 0, 3])
def test_draft_config_is_the_references(layers):
    cfg = dict(CFG, max_len=32)
    try:
        want = jtf.draft_config(cfg, layers)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            ptf.draft_config(cfg, layers)
        return
    assert ptf.draft_config(cfg, layers) == want


@pytest.mark.parametrize("decode,gamma", [("", ""), ("on", "7"), ("yes", "junk"), ("0", "-2")])
def test_knobs_resolve_as_the_reference(monkeypatch, decode, gamma):
    monkeypatch.setenv("MXNET_SPEC_DECODE", decode)
    monkeypatch.setenv("MXNET_SPEC_GAMMA", gamma)
    assert pspec.spec_decode_enabled() == jspec.spec_decode_enabled()
    assert pspec.spec_gamma() == jspec.spec_gamma()
    assert pspec.spec_gamma(3) == jspec.spec_gamma(3)
