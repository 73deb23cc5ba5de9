"""The prefix cache, the port against the JAX package on the CPU: the same
chained chunk hashes; the index adopts, evicts (leaf first, never a frame
another holder shares) and accounts as the reference's does under the same
calls; a cached admit gives the cold admit's logits bitwise within the port
(and JAX's within 1e-5), and a prompt that shares a prefix decodes the
tokens of a decoder without the cache."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import PagedKVDecoder as JaxPaged
from mxnet_tpu.serving import PrefixCache as JaxPrefixCache
from mxnet_tpu.serving.kv_decode import _PagePool as JaxPool
from mxnet_tpu_torch.serving import PagedKVDecoder, PagedKVExhausted, PrefixCache
from mxnet_tpu_torch.serving.kv_decode import _PagePool

torch.set_num_threads(1)

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64)
SERVE = dict(max_len=32, page_size=4, lanes=4, prefill_len=16, pos_len=32)


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
STEM = np.random.RandomState(5).randint(1, CFG["vocab_size"], (8,))
P0 = np.concatenate([STEM, [7, 9, 11, 13, 15]])
P1 = np.concatenate([STEM, [8, 10, 12, 14]])


def _jax(**kw):
    kw.setdefault("prefix_cache", True)
    kw.setdefault("prefix_chunk", 4)
    return JaxPaged(PARAMS, ctx=mx.cpu(), **CFG, **dict(SERVE, **kw))


def _port(**kw):
    kw.setdefault("prefix_cache", True)
    kw.setdefault("prefix_chunk", 4)
    return PagedKVDecoder(pt.params_from_numpy(PARAMS, ctx=pt.cpu()), ctx=pt.cpu(), **CFG,
                          **dict(SERVE, **kw))


@pytest.mark.parametrize("chunk,tokens", [
    (4, np.arange(12)), (4, np.arange(13)), (8, STEM), (2, P0), (3, np.array([5, 5, 5, 5, 5, 5])),
    (4, np.array([], np.int64))])
def test_chain_hashes_equal_the_references(chunk, tokens):
    port = PrefixCache(_PagePool(lanes=1, slots=24, page_size=1), chunk)
    ref = JaxPrefixCache(JaxPool(lanes=1, slots=24, page_size=1), chunk)
    assert port.chain_hashes(tokens) == ref.chain_hashes(tokens)
    assert port.chain_hashes(tokens.astype(np.float32)) == ref.chain_hashes(tokens)


def _index_script(pool_cls, cache_cls):
    """Insert a chain and a branch, match, evict for room, report state."""
    pool = pool_cls(lanes=1, slots=16, page_size=4)
    pc = cache_cls(pool, chunk=4)
    h = pc.chain_hashes(np.arange(12))
    b = pc.chain_hashes(np.concatenate([np.arange(4), np.arange(50, 58)]))
    frames = [pool.acquire() for _ in range(3)]
    for i in range(3):
        pc.insert(h[i], [frames[i]], parent=h[i - 1] if i else None)
    branch = pool.acquire()
    pc.insert(b[1], [branch], parent=b[0])
    pc.insert(h[0], [frames[0]])  # already present: keeps its entry
    out = [pc.match(h), pc.match(b), pc.match(h[1:])]
    pool.release(frames + [branch])  # the lanes let go; the index holds them
    out.append((pool.in_use, [pool.refcount(f) for f in frames + [branch]]))
    out.append([pc.evict_for(n) for n in (1, 2, 4)])  # 4 is more than all
    out.append((pc.stats(), pool.in_use, pc.match(h)))
    return out


def test_index_adopts_and_evicts_as_the_reference():
    assert _index_script(_PagePool, PrefixCache) == _index_script(JaxPool, JaxPrefixCache)


def test_eviction_never_frees_a_page_a_lane_holds():
    pool = _PagePool(lanes=1, slots=16, page_size=4)
    pc = PrefixCache(pool, chunk=4)
    h = pc.chain_hashes(np.arange(8))
    f0, f1 = pool.acquire(), pool.acquire()
    pc.insert(h[0], [f0])
    pc.insert(h[1], [f1], parent=h[0])
    pool.release([f1])  # a lane still holds f0
    held = [pool.acquire(), pool.acquire()]  # the pool is full
    assert pc.evict_for(1)  # the leaf goes first, and frees f1
    assert pool.refcount(f0) == 2 and pool.refcount(f1) == 0
    assert pc.stats() == {"entries": 1, "frames_held": 1, "evictions": 1}
    # two frames: the last entry goes, but f0 stays with its lane
    assert not pc.evict_for(2)
    assert pool.refcount(f0) == 1 and pool.in_use == 3
    assert pc.stats() == {"entries": 0, "frames_held": 0, "evictions": 2}
    assert pool.acquire() == f1
    pool.release(held)
    with pytest.raises(ValueError, match="multiple of the page size"):
        PrefixCache(pool, chunk=6)


def test_cached_admit_logits_are_the_cold_admits_bitwise():
    """A full match replays the last chunk without writing; a retired and
    re-admitted prompt lands on the same frames: both give the cold admit's
    logits bitwise, which are JAX's within 1e-5."""
    dec = _port()
    s0, cold = dec.admit(P1)  # 12 tokens: three chunks, no tail
    s1, hit = dec.admit(P1)
    assert np.array_equal(cold, hit)
    lanes = [dec._lanes[dec._seq_lane[s]] for s in (s0, s1)]
    assert lanes[0].frames == lanes[1].frames
    assert all(dec.pool.refcount(f) == 3 for f in lanes[0].frames)
    dec.retire(s1)
    s2, again = dec.admit(P1)
    assert np.array_equal(cold, again)
    s3, tail = dec.admit(P0)  # two chunks shared, then its own chunk and tail
    assert dec.stats()["prefix_hit_rate"] == 0.75
    jdec = _jax()
    np.testing.assert_allclose(cold, jdec.admit(P1)[1], atol=1e-5, rtol=0)
    jdec.admit(P1)
    jdec.admit(P1)
    np.testing.assert_allclose(tail, jdec.admit(P0)[1], atol=1e-5, rtol=0)
    assert dec.stats()["prefix_cache"] == jdec.stats()["prefix_cache"]
    for s in (s0, s2, s3):
        dec.retire(s)
    assert dec.pool.in_use == dec.stats()["prefix_cache"]["frames_held"]


def test_shared_prefix_decodes_the_tokens_of_a_decoder_without_the_cache():
    want = JaxPaged(PARAMS, ctx=mx.cpu(), prefix_cache=False, **CFG, **SERVE).greedy(
        [P0, P1], 9, k=1)
    dec = _port()
    dec.admit(P0)
    for sid in list(dec.active):
        dec.retire(sid)
    for k in (1, 4):
        got = dec.greedy([P0, P1], 9, k=k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert dec.stats()["prefix_hit_rate"] > 0.5


def test_retired_writer_leaves_the_sharers_pages_and_exhaustion_raises():
    dec = _port(lanes=3, page_budget=4)
    s0, lg0 = dec.admit(P1)  # three frames, the index shares them
    s1, lg1 = dec.admit(P1)
    assert dec.pool.in_use == 3 and np.array_equal(lg0, lg1)
    dec.retire(s0)
    lane1 = dec._lanes[dec._seq_lane[s1]]
    assert all(dec.pool.refcount(f) == 2 for f in lane1.frames)
    ref = _port(prefix_cache=False, lanes=1)
    rsid, rlg = ref.admit(P1)
    t = int(np.argmax(rlg))
    np.testing.assert_array_equal(dec.step_megastep({s1: t}, k=2)[s1],
                                  ref.step_megastep({rsid: t}, k=2)[rsid])
    with pytest.raises(PagedKVExhausted, match="budget exhausted"):
        dec.admit(np.arange(30, 42))
    assert all(dec.pool.refcount(f) >= 1 for f in lane1.frames)
