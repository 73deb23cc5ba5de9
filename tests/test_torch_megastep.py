"""Megastep decode, the port against the JAX package: the same parameters
through both packages' ``KVCacheDecoder`` on the CPU (the JAX package in its
default setting, its decode graphs composed of plain ops; the port running
its K steps as a loop over the same graph). Greedy tokens at K = 1, 4 and 8
and a direct ``decode_megastep`` match JAX's; an EOS'd lane writes nothing;
seeded top-k draws do not depend on how the steps are cut into megasteps;
the sampler's knobs, the megastep-K knob and the seed sources resolve as in
the reference."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import random as jrandom
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import KVCacheDecoder as JaxDecoder
from mxnet_tpu.serving import kv_decode as jkv
from mxnet_tpu_torch.serving import KVCacheDecoder
from mxnet_tpu_torch.serving import kv_decode as pkv

torch.set_num_threads(1)

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64)
SERVE = dict(max_len=32, prefill_len=8, pos_len=32, batch=4)
N_TOKENS = 17


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
PROMPT = np.random.RandomState(3).randint(1, CFG["vocab_size"], (4, 6))


def _jax(**kw):
    return JaxDecoder(PARAMS, ctx=mx.cpu(), **CFG, **SERVE, **kw)


def _port(**kw):
    return KVCacheDecoder(pt.params_from_numpy(PARAMS, ctx=pt.cpu()), ctx=pt.cpu(), **CFG,
                          **SERVE, **kw)


@pytest.fixture(scope="module")
def jax_greedy():
    with pytest.MonkeyPatch.context() as mp:
        for var in ("MXNET_DECODE_MEGASTEP_K", "MXNET_FUSED_PATTERNS", "MXNET_FUSED_PATTERNS_INFER",
                    "MXNET_FUSION_TUNE_DIR"):
            mp.delenv(var, raising=False)
        return _jax().greedy(PROMPT, N_TOKENS, k=1)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_tokens_identical_to_jax(jax_greedy, k):
    got = _port().greedy(PROMPT, N_TOKENS, k=k)
    assert got.shape == (4, N_TOKENS) and got.dtype == np.int64
    assert len(np.unique(got)) > 8  # a varied decode, not one repeated id
    np.testing.assert_array_equal(got, jax_greedy)


def test_decode_megastep_matches_jax_and_advances_the_position():
    jdec, pdec = _jax(), _port()
    tok = np.argmax(jdec.prefill(PROMPT), axis=-1)
    np.testing.assert_array_equal(np.argmax(pdec.prefill(PROMPT), axis=-1), tok)
    want = jdec.decode_megastep(tok, k=4)
    got = pdec.decode_megastep(tok, k=4)
    np.testing.assert_array_equal(got, want)
    assert pdec.position == jdec.position == PROMPT.shape[1] + 4
    again_j = jdec.decode_megastep(want[:, -1], k=4)
    np.testing.assert_array_equal(pdec.decode_megastep(got[:, -1], k=4), again_j)
    with pytest.raises(pt.MXNetError, match="position table"):
        pdec.decode_megastep(got[:, -1], k=32)


def test_token_head_is_found_by_name_and_the_decoder_reports_its_config():
    dec = _port().warmup()
    assert dec._token_out is True
    assert pkv._token_head(dec._dec_exe)
    assert dec.ffn_dim == CFG["ffn_dim"] and dec.position == 0

    class Exe:  # a token-less program whose output count is the same
        output_dict = {"out%d" % i: None for i in range(len(dec._dec_exe.output_dict))}

    assert not pkv._token_head(Exe())


def _probe_eos(dec, kw, K):
    """A token lane 0 emits mid-megastep, not earlier and never in lane 1."""
    tok0 = np.argmax(dec.prefill(PROMPT[:2]), axis=-1)
    probe = dec.decode_megastep(tok0, k=K, **kw)
    for j in range(1, K - 1):
        cand = int(probe[0, j])
        if cand not in probe[0, :j] and cand not in probe[1]:
            return probe, j, cand
    raise AssertionError("no usable eos candidate in %r" % probe)


def test_eos_lanes_write_nothing_after_their_eos():
    """Once a lane emits eos, its later steps write NOTHING: those ring slots
    stay bitwise what they were, its outputs are eos filler, and the other
    lane decodes as without eos."""
    K = 6
    kw = dict(sample="topk", temperature=1.5, top_k=10)
    serve = dict(SERVE, batch=2)

    def mk():
        return KVCacheDecoder(pt.params_from_numpy(PARAMS, ctx=pt.cpu()), ctx=pt.cpu(),
                              sample_seed=23, **CFG, **serve)

    probe, j, eos = _probe_eos(mk(), kw, K)
    dec = mk()
    tok0 = np.argmax(dec.prefill(PROMPT[:2]), axis=-1)
    p, S = dec.position, dec.max_len
    names = [n for n in dec._dec_exe.arg_dict if n.startswith(("kv_k_", "kv_v_"))]
    before = {n: dec._kv(n).clone() for n in names}
    out = dec.decode_megastep(tok0, k=K, eos_id=eos, **kw)
    np.testing.assert_array_equal(out[0, :j + 1], probe[0, :j + 1])
    assert (out[0, j + 1:] == eos).all()
    np.testing.assert_array_equal(out[1], probe[1])
    dead = [(p + t) % S for t in range(j + 1, K)]
    live = [(p + t) % S for t in range(j + 1)]
    for n in names:
        after = dec._kv(n)
        assert torch.equal(after[0][:, dead, :], before[n][0][:, dead, :])
        assert not torch.equal(after[0][:, live, :], before[n][0][:, live, :])
        assert not torch.equal(after[1][:, dead, :], before[n][1][:, dead, :])


def test_greedy_eos_filler_matches_jax():
    """With greedy decode and an eos id that a lane emits mid-megastep, the
    port's ids, eos filler included, are JAX's."""
    jdec, pdec = _jax(), _port()
    tok = np.argmax(jdec.prefill(PROMPT), axis=-1)
    pdec.prefill(PROMPT)
    probe = _jax()
    probe.prefill(PROMPT)
    free = probe.decode_megastep(tok, k=8)
    eos = int(free[0, 3])
    want = jdec.decode_megastep(tok, k=8, eos_id=eos)
    got = pdec.decode_megastep(tok, k=8, eos_id=eos)
    assert (want == eos).sum() > (free == eos).sum()  # some lane was filled with eos
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plan", [[2, 2], [1, 1, 1, 1], [3, 1], [1, 3]])
def test_topk_draws_are_the_same_for_any_partition_into_k(plan):
    """A draw depends on (seed, absolute position, lane) alone: one K=4
    megastep gives the tokens of any partition of the same four steps."""
    kw = dict(sample="topk", temperature=0.8, top_k=5)

    def run(parts, seed=11):
        dec = _port(sample_seed=seed)
        tok = np.argmax(dec.prefill(PROMPT), axis=-1)
        out = []
        for k in parts:
            out.append(dec.decode_megastep(tok, k=k, **kw))
            tok = out[-1][:, -1]
        return np.concatenate(out, axis=1)

    full = run([4])
    np.testing.assert_array_equal(run(plan), full)
    assert not np.array_equal(run([4], seed=12), full)


def test_topk_keeps_only_the_top_k_logits():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0]] * 2)
    pos, lanes = torch.tensor([7, 7]), torch.arange(2)
    seen = set()
    for seed in range(64):
        seen.update(pkv._sample(logits, pos, lanes, torch.tensor(seed), 1.0, 2).tolist())
    assert seen == {1, 2}
    # the draws follow softmax(logits / T): at T = 0.25 the top logit dominates
    draws = [int(pkv._sample(logits, pos + t, lanes, torch.tensor(3), 0.25, 0)[0])
             for t in range(200)]
    assert draws.count(1) > 150


@pytest.mark.parametrize("raw", ["", "8", "junk", "0", " 3 "])
def test_megastep_k_knob_resolves_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("MXNET_DECODE_MEGASTEP_K", raw)
    assert pkv.decode_megastep_k() == jkv.decode_megastep_k()
    assert pkv.decode_megastep_k(5) == jkv.decode_megastep_k(5)


@pytest.mark.parametrize("args,env", [
    ((None, None, None), {}),
    ((None, None, None), {"MXNET_DECODE_SAMPLE": "topk", "MXNET_DECODE_SAMPLE_TEMP": "0.5",
                          "MXNET_DECODE_SAMPLE_TOPK": "7"}),
    (("greedy", 2.0, 3), {"MXNET_DECODE_SAMPLE": "topk"}),
    (("bogus", None, None), {}),
    (("topk", 0.0, None), {}),
    (("topk", 1.0, -1), {}),
])
def test_sampler_knobs_resolve_and_refuse_as_the_reference(monkeypatch, args, env):
    for var in ("MXNET_DECODE_SAMPLE", "MXNET_DECODE_SAMPLE_TEMP", "MXNET_DECODE_SAMPLE_TOPK"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    try:
        want = jkv._sampler_from(*args).key()
    except JaxError as e:
        with pytest.raises(pt.MXNetError, match=str(e).split(":")[1].strip()[:20]):
            pkv._sampler_from(*args)
        return
    assert pkv._sampler_from(*args).key() == want


def test_sampling_seed_comes_from_the_decoder_then_the_environment_then_random(monkeypatch):
    monkeypatch.delenv("MXNET_DECODE_SAMPLE_SEED", raising=False)
    assert pkv._sampling_key(_port(sample_seed=5)) == 5
    monkeypatch.setenv("MXNET_DECODE_SAMPLE_SEED", "9")
    assert pkv._sampling_key(_port()) == 9
    assert pkv._sampling_key(_port(sample_seed=5)) == 5
    monkeypatch.delenv("MXNET_DECODE_SAMPLE_SEED")
    pt.random.seed(42)
    a, b = pkv._sampling_key(_port()), pkv._sampling_key(_port())
    pt.random.seed(42)
    assert (pkv._sampling_key(_port()), pkv._sampling_key(_port())) == (a, b)
    assert a != b


def test_random_seed_seeds_numpy_as_the_reference():
    jrandom.seed(7)
    want = np.random.rand(3)
    pt.random.seed(7)
    np.testing.assert_array_equal(np.random.rand(3), want)


def test_swap_params_lands_in_the_next_megastep_as_in_jax():
    """A hitless reload of the decoder's weights (``swap_params`` on its two
    caches): the next greedy tokens, megasteps included, equal JAX's decoder
    after the same swap and a fresh decoder built with the new weights; the
    megastep programs are reused, and the weight tensors are the same
    objects (a captured graph reads them by address)."""
    new = _params(seed=1)
    jdec, pdec = _jax(), _port()
    jdec.greedy(PROMPT, 9, k=4)
    pdec.greedy(PROMPT, 9, k=4)
    programs = dict(pdec._megasteps)
    before = {n: a._tensor() for n, a in pdec._dec_exe.arg_dict.items()}
    for dec in (jdec, pdec):
        assert dec._pf_cache.swap_params(new) == len(new)
        assert dec._dec_cache.swap_params(new) == len(new)
    want = jdec.greedy(PROMPT, 9, k=4)
    got = pdec.greedy(PROMPT, 9, k=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, KVCacheDecoder(pt.params_from_numpy(new, ctx=pt.cpu()), ctx=pt.cpu(), **CFG,
                            **SERVE).greedy(PROMPT, 9, k=4))
    assert pdec._megasteps == programs
    assert all(pdec._dec_exe.arg_dict[n]._tensor() is t for n, t in before.items())
    assert pdec._pf_cache.binds == pdec._dec_cache.binds == 1
