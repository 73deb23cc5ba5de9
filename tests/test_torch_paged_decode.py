"""The paged, multiplexed decoder, the port against the JAX package on the
CPU: the page pool hands out the same frames and refcounts under the same
calls; multiplexed ``step`` and ``step_megastep`` give JAX's tokens across
page crossings, for lanes admitted at different times; teacher-forced step
and ``verify_chunk`` logits are JAX's within 1e-5; pool exhaustion raises
before any dispatch and leaves the KV untouched; fork and copy-on-write
isolate writers; ``rollback`` frees only whole pages."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import PagedKVDecoder as JaxPaged
from mxnet_tpu.serving.kv_decode import _PagePool as JaxPool
from mxnet_tpu_torch.serving import KVCacheDecoder, PagedKVDecoder, PagedKVExhausted
from mxnet_tpu_torch.serving.kv_decode import _PagePool

torch.set_num_threads(1)

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64)
SERVE = dict(max_len=32, page_size=4, lanes=4, prefill_len=8, pos_len=32)


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
PROMPTS = [np.random.RandomState(9 + i).randint(1, CFG["vocab_size"], (2 + i,))
           for i in range(3)]


def _jax(**kw):
    return JaxPaged(PARAMS, ctx=mx.cpu(), **CFG, **dict(SERVE, **kw))


def _port(**kw):
    return PagedKVDecoder(pt.params_from_numpy(PARAMS, ctx=pt.cpu()), ctx=pt.cpu(), **CFG,
                          **dict(SERVE, **kw))


# ------------------------------------------------------------------ the pool
def _drive(pool, script):
    """Run a script of pool calls; record each call's result or error text."""
    log = []
    held = []
    for op, arg in script:
        try:
            if op == "acquire":
                held.append(pool.acquire())
                log.append(held[-1])
            elif op == "incref":
                pool.incref(held[arg])
                log.append(pool.refcount(held[arg]))
            elif op == "release":
                pool.release([held[i] for i in arg])
                log.append(pool.in_use)
        except Exception as e:  # noqa: BLE001 -- the error's text is the result
            log.append(str(e))
        log.append((pool.in_use, pool.can_acquire(2), sorted(pool._ref.items())))
    return log


SCRIPTS = {
    "share_and_free": (dict(lanes=2, slots=16, page_size=4),
                       [("acquire", 0)] * 5 + [("incref", 0), ("incref", 2), ("release", [0, 1]),
                                               ("release", [0, 2, 3]), ("acquire", 0),
                                               ("acquire", 0), ("acquire", 0)]),
    "exhaust_budget": (dict(lanes=2, slots=16, page_size=4, budget=3),
                       [("acquire", 0)] * 4 + [("release", [1]), ("acquire", 0), ("acquire", 0)]),
    "exhaust_frames": (dict(lanes=1, slots=8, page_size=4, budget=5),
                       [("acquire", 0)] * 3 + [("release", [0, 1]), ("acquire", 0)]),
    "replay_order": (dict(lanes=3, slots=8, page_size=2),
                     [("acquire", 0)] * 6 + [("release", [2, 3, 4]), ("acquire", 0),
                                             ("acquire", 0), ("acquire", 0)]),
}


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_page_pool_gives_the_references_frames_and_refcounts(which):
    kw, script = SCRIPTS[which]
    assert _drive(_PagePool(**kw), script) == _drive(JaxPool(**kw), script)


def test_page_pool_refuses_a_page_size_that_does_not_divide_the_slots():
    with pytest.raises(JaxError, match="divide"):
        JaxPool(lanes=1, slots=10, page_size=4)
    with pytest.raises(pt.MXNetError, match="divide"):
        _PagePool(lanes=1, slots=10, page_size=4)


# ------------------------------------------------------------ token parity
@pytest.fixture(scope="module")
def jax_greedy():
    return _jax().greedy(PROMPTS, 13, k=4)


@pytest.mark.parametrize("k", [1, 4])
def test_multiplexed_greedy_tokens_identical_to_jax(jax_greedy, k):
    """Three lanes at three positions, 13 tokens each: every lane crosses
    pages of 4 slots mid-decode, inside a megastep at K = 4."""
    got = _port().greedy(PROMPTS, 13, k=k)
    assert len(np.unique(np.concatenate(got))) > 8
    for g, w in zip(got, jax_greedy):
        np.testing.assert_array_equal(g, w)


def _staggered(dec, k):
    """Two lanes admitted and stepped, a third admitted later; then one
    megastep (or step) of all three at different positions."""
    sids, cur = [], {}
    for p in PROMPTS[:2]:
        sid, lg = dec.admit(p)
        sids.append(sid)
        cur[sid] = int(np.argmax(lg))
    rows = {s: [] for s in sids}
    for _ in range(2):
        lg = dec.step(cur)
        for s in sids:
            rows[s].append(lg[s])
        cur = {s: int(np.argmax(lg[s])) for s in sids}
    sid, lg = dec.admit(PROMPTS[2])
    cur[sid] = int(np.argmax(lg))
    rows[sid] = [lg]
    ids = dec.step_megastep(cur, k=k)
    return rows, ids, {s: dec.position(s) for s in cur}


def test_staggered_lanes_match_jax_logits_and_megastep_tokens():
    jrows, jids, jpos = _staggered(_jax(), 5)
    prows, pids, ppos = _staggered(_port(), 5)
    assert ppos == jpos
    for s in jrows:
        np.testing.assert_allclose(np.asarray(prows[s]), np.asarray(jrows[s]), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(pids[s], jids[s])


def test_verify_chunk_logits_match_jax_within_1e5():
    def run(dec):
        sid, lg = dec.admit(PROMPTS[1])
        rows = dec.verify_chunk(sid, [int(np.argmax(lg)), 5, 9, 33, 2])
        return lg, rows, dec.position(sid), list(dec._lanes[dec._seq_lane[sid]].frames)

    want, got = run(_jax()), run(_port())
    assert got[1].shape == (5, CFG["vocab_size"])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-5, rtol=0)
    assert got[2:] == want[2:]


def _written_back(how):
    """The KV buffers before and after one dispatch, the graph's KV outputs
    (None for a chunk, whose outputs are not kept) and the slots it wrote."""
    if how == "ring_step":
        dec = KVCacheDecoder(pt.params_from_numpy(PARAMS, ctx=pt.cpu()), ctx=pt.cpu(), batch=2,
                             max_len=SERVE["max_len"], prefill_len=8, pos_len=32, **CFG)
        nxt = np.argmax(dec.prefill(np.stack([PROMPTS[1][:3], PROMPTS[2][:3]])), axis=-1)
        names = [n for i in range(CFG["num_layers"]) for n in ("kv_k_%d" % i, "kv_v_%d" % i)]
        before = [dec._kv(n).clone() for n in names]
        slot = dec.position % dec.max_len
        dec.greedy_step(nxt)
        outs = [dec._dec_exe.outputs[1 + j]._tensor() for j in range(len(names))]
        def flat(t):  # (B, H, S, dh) -> (B·S, H, dh): lane b's slot s at b·S + s
            B, H, S, dh = t.shape
            return t.transpose(1, 2).reshape(B * S, H, dh)

        return ([flat(b) for b in before], [flat(dec._kv(n)) for n in names],
                [flat(o) for o in outs], [slot + b * dec.max_len for b in range(2)])
    dec = _port()
    cur = {}
    for p in PROMPTS[:2]:
        sid, lg = dec.admit(p)
        cur[sid] = int(np.argmax(lg))
    before = [dec._kv(n).clone() for n in dec._kv_names()]
    pos = {s: dec.position(s) for s in cur}
    outs = None
    if how == "paged_step":
        dec.step(cur)
        outs = [dec._dec_exe.outputs[1 + j]._tensor() for j in range(len(before))]
    else:
        sid = next(iter(cur))
        dec.verify_chunk(sid, [cur[sid], 5, 9])
        cur = {sid: None}
    lanes = {s: dec._lanes[dec._seq_lane[s]] for s in cur}
    wrote = [int(x) for s, lane in lanes.items() for x in dec._lane_slots(lane)[pos[s]:]]
    return ([b.transpose(0, 1) for b in before],
            [dec._kv(n).transpose(0, 1) for n in dec._kv_names()],
            outs and [o.transpose(0, 1) for o in outs], wrote)


@pytest.mark.parametrize("how", ["ring_step", "paged_step", "verify_chunk"])
def test_a_dispatch_changes_only_the_slots_it_wrote(how):
    """The decoders keep their KV buffers and take a dispatch's writes into
    them (the ring decoder copies back only the slot it wrote): every other
    slot is bitwise what it was, and the buffers equal the graph's whole KV
    outputs."""
    before, after, outs, wrote = _written_back(how)
    rest = [i for i in range(before[0].shape[0]) if i not in wrote]
    assert len(wrote) in (2, 3) and rest
    for b, a in zip(before, after):
        assert torch.equal(a[rest], b[rest])
        assert all(not torch.equal(a[i], b[i]) for i in wrote)
    for a, o in zip(after, outs or []):
        assert torch.equal(a, o)


# ---------------------------------------------------------------- admission
def test_exhaustion_raises_before_any_dispatch_and_leaves_the_kv_untouched():
    dec = _port(max_len=16, page_size=2, lanes=2, page_budget=5)
    sa, la = dec.admit(PROMPTS[1][:3])
    sb, lb = dec.admit(PROMPTS[2][:3])
    toks = {sa: int(np.argmax(la)), sb: int(np.argmax(lb))}
    pos = (dec.position(sa), dec.position(sb))
    kv = [dec._kv(n).clone() for n in dec._kv_names()]
    with pytest.raises(PagedKVExhausted, match="budget exhausted"):
        dec.step_megastep(toks, k=4)  # two new frames a lane, one in the pool
    assert (dec.position(sa), dec.position(sb)) == pos
    for a, n in zip(kv, dec._kv_names()):
        assert torch.equal(a, dec._kv(n))
    dec.retire(sb)
    assert dec.step_megastep({sa: toks[sa]}, k=4)[sa].shape == (4,)
    assert dec.position(sa) == pos[0] + 4
    dec.admit(PROMPTS[0])
    with pytest.raises(PagedKVExhausted, match="lanes occupied"):
        dec.admit(PROMPTS[0])
    with pytest.raises(pt.MXNetError, match="prompt length"):
        _port().admit(np.ones(9))


def test_failed_admit_releases_its_lane_and_frames():
    dec = _port(lanes=2, page_budget=2)
    dec.admit(PROMPTS[0])  # one frame
    with pytest.raises(PagedKVExhausted):
        dec.admit(np.arange(1, 9))  # needs two
    assert dec.stats()["active"] == 1 and dec.pool.in_use == 1


# ------------------------------------------------------------ fork, rollback
FORK_PROMPT = np.arange(1, 7) * 7 % 64


def _fork_run(dec):
    """Fork a 6-token sequence; megastep both down different paths (their
    first writes land in the shared boundary page)."""
    s0, lg = dec.admit(FORK_PROMPT)
    fk = dec.fork(s0)
    shared = list(dec._lanes[dec._seq_lane[s0]].frames)
    t0 = int(np.argmax(lg))
    got = dec.step_megastep({s0: t0, fk: (t0 + 1) % 64}, k=4)
    frames = [dec._lanes[dec._seq_lane[s]].frames for s in (s0, fk)]
    return t0, shared, got[s0], got[fk], frames


def test_fork_shares_pages_and_copy_on_write_isolates_the_writers():
    _, j_shared, j0, j1, _ = _fork_run(_jax())
    dec = _port()
    t0, shared, p0, p1, frames = _fork_run(dec)
    np.testing.assert_array_equal(p0, j0)
    np.testing.assert_array_equal(p1, j1)
    assert shared == j_shared
    assert frames[0][0] == frames[1][0] == shared[0]  # the full page stays shared
    assert frames[0][1] != frames[1][1]                # the boundary page was copied
    assert dec.pool.refcount(shared[0]) == 2
    # each continuation is what a lone sequence decodes
    solo = _port(lanes=1)
    for tok, want in ((t0, p0), ((t0 + 1) % 64, p1)):
        sid, _ = solo.admit(FORK_PROMPT)
        np.testing.assert_array_equal(solo.step_megastep({sid: tok}, k=4)[sid], want)
        solo.retire(sid)


def test_rollback_frees_whole_pages_only_and_redecodes_identically():
    dec = _port(lanes=2)
    sid, lg = dec.admit(PROMPTS[2])  # 4 tokens: one page
    want = dec.step_megastep({sid: int(np.argmax(lg))}, k=6)[sid]  # positions 4..9
    lane = dec._lanes[dec._seq_lane[sid]]
    assert len(lane.frames) == 3 and dec.pool.in_use == 3
    dec.rollback(sid, 6)  # keeps pages 0..1, drops page 2
    assert lane.pos == 6 and len(lane.frames) == 2 and dec.pool.in_use == 2
    redo = dec.step_megastep({sid: int(want[1])}, k=4)[sid]
    np.testing.assert_array_equal(redo, want[2:6])
    with pytest.raises(pt.MXNetError, match="rollback target"):
        dec.rollback(sid, 99)
    dec.retire(sid)
    assert dec.stats() == {"lanes": 2, "active": 0, "pages_in_use": 0, "page_budget": 16,
                           "page_size": 4}
    with pytest.raises(pt.MXNetError, match="unknown seq_id"):
        dec.retire(sid)
