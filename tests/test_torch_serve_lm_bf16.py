"""The transformer LM served in bfloat16, held against the JAX package.

- The plain versions of the flash-attention forward (row 1 of the kernel
  table) and the LayerNorm forward (row 4) on bfloat16 operands against the
  TPU kernels themselves (``pallas_attention._fwd_call`` and
  ``pallas_norm_residual._fwd_call`` in interpret mode): O and y within one
  bfloat16 ulp (``bf16_ulps``), lse, mean and rstd within rtol 1e-5, atol
  1e-6. A parity test on float32 rows pins the one rounding point the
  LayerNorm's bf16 form copies: XLA compiles the TPU kernel's ``xhat * g +
  b`` as one FMA.
- ``KVCacheDecoder`` and ``PagedKVDecoder`` at ``dtype="bfloat16"``, with
  bfloat16 parameters and with float32 ones, against the JAX package's
  decoders in the forced serving setting its Pallas kernels engage in (the
  port's sites run the kernels' plain versions): the prefill logits and 8
  decode steps teacher-forced with JAX's greedy tokens, within atol = rtol
  = 4e-2 (the JAX package's bfloat16 tolerance,
  ``tests/test_pallas_norm_residual.py:33``), and the port's argmax equal to
  JAX's token wherever JAX's top-2 gap exceeds that. Found at these sizes:
  the prefill logits bitwise equal; the decode steps equal JAX's step
  evaluated op by op (``jax.disable_jit``) bitwise but for a few logits of
  one step, and part from its compiled step by one bfloat16 ulp on about
  half the logits, as that step parts from its own op-by-op evaluation
  (``tools/torch_lm_bf16_decode_spread.py``). The op that differed until
  matched: the bf16 ``softmax`` of the decode step's scores, which JAX
  rounds op by op (``ops/nn.py`` ``_softmax_bf16``).
- The two deliberate departures (ROADMAP.md section 3): (a) the token ids
  and positions are bound in float32, so ids 1000 and 1001 give JAX the
  same logits (bfloat16 rounds both to 1000) and the port different ones;
  (b) the bfloat16 megastep runs, and K = 4 gives the tokens and the KV
  bits of 4 single steps, where JAX's raises on its carry's dtype.
- ``params_from_numpy`` on ``ml_dtypes`` bfloat16 arrays is bitwise, and its
  ``dtype="bfloat16"`` rounds as ``ml_dtypes`` does.
- The binding (ids float32, the rest bf16), a site of mixed dtypes (the
  promoted dtype), and the prefix cache and speculative decode in bf16.

Sizes are small: 2 layers, model width 128 (JAX's LayerNorm kernel takes
widths that are multiples of 128), vocabulary 200 (ids exact in bfloat16).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.ops import pallas_attention as jpa
from mxnet_tpu.ops import pallas_norm_residual as jpn
from mxnet_tpu.serving import KVCacheDecoder as JaxDecoder
from mxnet_tpu.serving import PagedKVDecoder as JaxPaged
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import norm_residual as nr
from mxnet_tpu_torch.ops.conv_bn import bf16_ulps
from mxnet_tpu_torch.serving import KVCacheDecoder, PagedKVDecoder

torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16
CFG = dict(vocab_size=200, num_layers=2, num_heads=2, model_dim=128, ffn_dim=256)
LOCKSTEP = dict(batch=8, prefill_len=16, max_len=32, pos_len=32)
PAGED = dict(lanes=4, page_size=8, max_len=32, prefill_len=16, pos_len=32)
FORCED_INFER = "attention=pallas_flash,matmul_bias_act=pallas,norm_residual=pallas"
TOL = 4e-2
STEPS = 8


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHREWRITE", "on")
    monkeypatch.setenv("MXNET_FUSED_PATTERNS_INFER", FORCED_INFER)
    for k in ("MXNET_FUSED_PATTERNS", "MXNET_FUSION_TUNE_DIR", "MXNET_DECODE_MEGASTEP_K",
              "MXNET_SERVE_PREFIX_CACHE"):
        monkeypatch.delenv(k, raising=False)


def _ulps(got, want):
    """bfloat16 ulps between two arrays of bfloat16 values."""
    return bf16_ulps(torch.from_numpy(np.asarray(got, np.float32)),
                     torch.from_numpy(np.asarray(want, np.float32)))


def _within_one_ulp(got, want, floor=1e-6):
    """Every element one bfloat16 ulp at most from JAX's, or, where the
    float32 sums before the rounding cancel, within ``floor`` of the
    largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    near = np.abs(got - want) <= floor * np.abs(want).max()
    far = (_ulps(got, want).numpy() > 1) & ~near
    assert int(far.sum()) == 0, (int(far.sum()), float(np.abs(got - want).max()))
    return float((got == want).mean())


# ----------------------------------------------------------- the two kernels
# (BH, T, S, D, causal, block_q, block_k): causal square at D 16 and 64, the
# prefill's width over several key blocks, rectangular T < S causal (bottom
# right aligned) and not
FLASH_CASES = [(4, 64, 64, 16, True, 32, 32), (4, 64, 64, 64, True, 32, 32),
               (2, 128, 128, 64, True, 64, 32), (2, 32, 64, 64, True, 32, 32),
               (2, 32, 96, 16, False, 32, 32), (3, 16, 48, 64, False, 16, 16)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "bh%d_t%d_s%d_d%d_%s" % (c[:4] + (
                             "causal" if c[4] else "full",)))
def test_flash_forward_plain_matches_the_pallas_kernel_on_bf16(case):
    BH, T, S, D, causal, bq, bk = case
    rs = np.random.RandomState(sum(case[:4]))
    q, k, v = (rs.randn(BH, n, D).astype(np.float32).astype(BF16) for n in (T, S, S))
    scale = 1.0 / np.sqrt(D)
    jo, jlse = jpa._fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                             float(scale), bq, bk, True)
    po, plse = fa.flash_attention_plain(*(torch.from_numpy(a.astype(np.float32)).bfloat16()
                                          for a in (q, k, v)), causal=causal)
    assert po.dtype == torch.bfloat16 and plse.dtype == torch.float32
    assert np.asarray(jo).dtype == BF16
    _within_one_ulp(po.float().numpy(), np.asarray(jo).astype(np.float32))
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse)[..., 0], rtol=1e-5, atol=1e-6)


# tests/test_pallas_norm_residual.py's (4, 16, 128) rows, a decode step's 8
# rows at the transformer's width, and wider rows
LN_SHAPES = [(64, 128), (8, 512), (256, 256), (32, 512), (16, 1024)]


@pytest.mark.parametrize("R,D", LN_SHAPES)
def test_layer_norm_forward_plain_matches_the_pallas_kernel_on_bf16(R, D):
    rs = np.random.RandomState(R + D)
    x = rs.randn(R, D).astype(np.float32).astype(BF16)
    g = rs.uniform(0.5, 1.5, D).astype(np.float32).astype(BF16)
    b = rs.uniform(-0.2, 0.2, D).astype(np.float32).astype(BF16)
    jy, jmean, jrstd = jpn._fwd_call(jnp.asarray(x), jnp.asarray(g).reshape(1, D),
                                     jnp.asarray(b).reshape(1, D), 1e-5,
                                     jpn.choose_block_rows((R, D), 2), True)
    py, pmean, prstd = nr.layer_norm_affine_plain(
        *(torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (x, g, b)))
    assert py.dtype == torch.bfloat16 and np.asarray(jy).dtype == BF16
    _within_one_ulp(py.float().numpy(), np.asarray(jy).astype(np.float32))
    np.testing.assert_allclose(pmean.numpy(), np.asarray(jmean)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(prstd.numpy(), np.asarray(jrstd)[:, 0], rtol=1e-5, atol=1e-6)


def test_the_pallas_layer_norm_affine_is_one_fma():
    """The rounding point the bf16 form copies: on float32 rows, every y of
    the interpreted TPU kernel is fma(x̂, γ, β) of its own x̂ = (x −
    mean)·rstd, one rounding, and many differ from x̂·γ rounded, then + β
    rounded."""
    R, D = 256, 256
    rs = np.random.RandomState(7)
    x = rs.randn(R, D).astype(np.float32)
    g = (1 + 0.1 * rs.randn(D)).astype(np.float32)
    b = (0.1 * rs.randn(D)).astype(np.float32)
    y, mean, rstd = (np.asarray(a) for a in jpn._fwd_call(
        jnp.asarray(x), jnp.asarray(g).reshape(1, D), jnp.asarray(b).reshape(1, D), 1e-5,
        jpn.choose_block_rows((R, D), 4), True))
    xhat = ((x - mean) * rstd).astype(np.float32)
    fused = (xhat.astype(np.float64) * g + b.astype(np.float64)).astype(np.float32)
    two = (xhat * g).astype(np.float32) + b
    assert np.array_equal(y, fused)
    assert (y != two).mean() > 0.05


# ------------------------------------------------------------------ decoders
def _params(vocab=CFG["vocab_size"], seed=0):
    cfg = dict(CFG, vocab_size=vocab)
    net = jtf.get_symbol(seq_len=32, **cfg)
    shapes = net.infer_shape(data=(1, 32), softmax_label=(1, 32))[0]
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes) if n not in ("data", "softmax_label")}


def _prompts():
    rs = np.random.RandomState(3)
    return rs.randint(1, CFG["vocab_size"], (8, 10))


def _lockstep(dec, prompt, tokens=None):
    """Prefill logits, then STEPS decode steps' logits: fed the decoder's own
    greedy tokens, or ``tokens`` (STEPS, B) where given. Returns (logits
    (1 + STEPS, B, vocab) float32, the tokens fed)."""
    out = [np.asarray(dec.prefill(prompt), np.float32)]
    fed = []
    for i in range(STEPS):
        tok = np.argmax(out[-1], axis=-1) if tokens is None else tokens[i]
        fed.append(tok)
        out.append(np.asarray(dec.decode_step(tok), np.float32))
    return np.stack(out), np.stack(fed)


def _paged(dec, prompts, tokens=None):
    """The same over PAGED's lanes: each prompt admitted (its own length),
    then STEPS multiplexed steps."""
    sids, first = [], []
    for p in prompts:
        sid, lg = dec.admit(p)
        sids.append(sid)
        first.append(np.asarray(lg, np.float32))
    out, fed = [np.stack(first)], []
    for i in range(STEPS):
        tok = np.argmax(out[-1], axis=-1) if tokens is None else tokens[i]
        fed.append(tok)
        lg = dec.step({s: int(t) for s, t in zip(sids, tok)})
        out.append(np.stack([np.asarray(lg[s], np.float32) for s in sids]))
    return np.stack(out), np.stack(fed)


@pytest.fixture(scope="module", params=["bf16_params", "f32_params"])
def served(request):
    """Both packages' decoders at dtype="bfloat16" over the same weights:
    {"lockstep"|"paged": (JAX's logits, the port's logits)}."""
    host = _params()
    bf16 = request.param == "bf16_params"
    jparams = {n: v.astype(BF16) for n, v in host.items()} if bf16 else host
    pparams = pt.params_from_numpy(jparams, ctx=pt.cpu())
    prompt = _prompts()
    ragged = [prompt[i, :6 + i] for i in range(PAGED["lanes"])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_GRAPHREWRITE", "on")
        mp.setenv("MXNET_FUSED_PATTERNS_INFER", FORCED_INFER)
        mp.delenv("MXNET_FUSED_PATTERNS", raising=False)
        mp.delenv("MXNET_FUSION_TUNE_DIR", raising=False)
        jl, jtok = _lockstep(JaxDecoder(jparams, ctx=mx.cpu(), dtype="bfloat16", **CFG,
                                        **LOCKSTEP), prompt)
        pdec = KVCacheDecoder(pparams, ctx=pt.cpu(), dtype="bfloat16", **CFG, **LOCKSTEP)
        pl, _ = _lockstep(pdec, prompt, jtok)
        jp, jptok = _paged(JaxPaged(jparams, ctx=mx.cpu(), dtype="bfloat16", **CFG, **PAGED),
                           ragged)
        pp, _ = _paged(PagedKVDecoder(pparams, ctx=pt.cpu(), dtype="bfloat16", **CFG, **PAGED),
                       ragged, jptok)
    want_kv = torch.bfloat16
    assert pdec._kv("kv_k_0").dtype == want_kv
    return {"lockstep": (jl, pl), "paged": (jp, pp), "bf16": bf16}


@pytest.mark.parametrize("which", ["lockstep", "paged"])
def test_bf16_logits_match_the_references(served, which):
    jl, pl = served[which]
    assert pl.shape == jl.shape and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("which", ["lockstep", "paged"])
def test_bf16_greedy_tokens_match_where_the_top2_gap_is_clear(served, which):
    """The port's greedy token at every position (prefill and the 8 steps,
    each fed JAX's tokens) is JAX's wherever JAX's top-2 logit gap exceeds
    the tolerance."""
    jl, pl = served[which]
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > TOL
    assert clear.any()
    np.testing.assert_array_equal(np.argmax(pl, -1)[clear], np.argmax(jl, -1)[clear])


def test_bf16_prefill_logits_are_the_references_bitwise_with_bf16_params(served):
    """What these sizes show: with bfloat16 parameters both prefills run the
    same kernels' arithmetic (JAX's Pallas kernels interpreted, the port's
    plain versions) and the ops between them round alike, so the logits,
    rounded to bfloat16 last, agree bit for bit; with float32 parameters the
    model runs in float32 and the logits agree within 1e-5."""
    jl, pl = served["lockstep"]
    if served["bf16"]:
        np.testing.assert_array_equal(pl[0], jl[0])
    else:
        np.testing.assert_allclose(pl[0], jl[0], atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------- departures
def test_departure_a_ids_above_256_stay_exact():
    """Departure (a): ids 1001 and 1000 (and 999 beside them) round to 1000
    in bfloat16, so JAX's bf16 prefill, which binds the ids in bfloat16,
    gives both prompts the same logits; the port binds ids and positions in
    float32 and tells them apart."""
    host = {n: v.astype(BF16) for n, v in _params(vocab=1024).items()}
    serve = dict(batch=1, prefill_len=16, max_len=32, pos_len=32)
    cfg = dict(CFG, vocab_size=1024)
    prompts = [np.array([[1001, 3, 999]]), np.array([[1000, 3, 999]])]
    jdec = JaxDecoder(host, ctx=mx.cpu(), dtype="bfloat16", **cfg, **serve)
    j = [np.asarray(jdec.prefill(p), np.float32) for p in prompts]
    pdec = KVCacheDecoder(pt.params_from_numpy(host, ctx=pt.cpu()), ctx=pt.cpu(),
                          dtype="bfloat16", **cfg, **serve)
    p = [pdec.prefill(pr) for pr in prompts]
    np.testing.assert_array_equal(j[0], j[1])
    assert np.abs(p[0] - p[1]).max() > 1e-2
    # the port's row for the rounded prompt is JAX's
    np.testing.assert_allclose(pdec.prefill(np.array([[1000, 3, 1000]])), j[0], atol=TOL,
                               rtol=TOL)


def _kvs(dec):
    return [dec._kv(n).clone() for i in range(CFG["num_layers"])
            for n in ("kv_k_%d" % i, "kv_v_%d" % i)]


@pytest.mark.parametrize("params", ["bf16_params", "f32_params"])
def test_departure_b_the_bf16_megastep_is_four_single_steps(params):
    """Departure (b): the port's bf16 megastep at K = 4 gives the tokens of
    4 single steps and leaves the KV buffers bit for bit as they leave them
    (bf16 weights, and float32 weights over bf16 buffers), lockstep and
    paged."""
    host = _params()
    if params == "bf16_params":
        host = {n: v.astype(BF16) for n, v in host.items()}
    w = pt.params_from_numpy(host, ctx=pt.cpu())
    prompt = _prompts()
    dec = KVCacheDecoder(w, ctx=pt.cpu(), dtype="bfloat16", **CFG, **LOCKSTEP)
    nxt = np.argmax(dec.prefill(prompt), -1)
    single = []
    for _ in range(4):
        nxt = dec.greedy_step(nxt)
        single.append(nxt)
    kv_single = _kvs(dec)
    dec.reset()
    mega = dec.decode_megastep(np.argmax(dec.prefill(prompt), -1), k=4)
    np.testing.assert_array_equal(mega, np.stack(single, 1))
    assert all(torch.equal(a, b) for a, b in zip(_kvs(dec), kv_single))
    assert kv_single[0].dtype == torch.bfloat16

    # paged: each sequence's K/V gathered through its own page table (the
    # megastep takes its pages up front, single steps one at a time, so the
    # pool places them apart)
    prompts = [prompt[i, :6 + i] for i in range(PAGED["lanes"])]
    runs = []
    for k in (1, 4):
        pdec = PagedKVDecoder(w, ctx=pt.cpu(), dtype="bfloat16", **CFG, **PAGED)
        nxt = {}
        for p in prompts:
            sid, lg = pdec.admit(p)
            nxt[sid] = int(np.argmax(lg))
        if k == 1:
            toks = []
            for _ in range(4):
                lg = pdec.step(nxt)
                nxt = {s: int(np.argmax(lg[s])) for s in nxt}
                toks.append([nxt[s] for s in sorted(nxt)])
            toks = np.array(toks).T
        else:
            got = pdec.step_megastep(nxt, k=4)
            toks = np.stack([got[s] for s in sorted(got)])
        slots = {s: torch.from_numpy(pdec._lane_slots(pdec._lane_of(s)[1])) for s in nxt}
        runs.append((toks, [b.index_select(1, slots[s]) for s in sorted(slots)
                            for b in _kvs(pdec)]))
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[1][1], runs[0][1]))


@pytest.mark.parametrize("cls", ["KVCacheDecoder", "PagedKVDecoder"])
def test_departure_b_the_references_bf16_megastep_raises(cls):
    """JAX's bf16 megastep: its scan carries the KV buffers, and the f32
    onehot (``mxnet_tpu/serving/kv_decode.py:231``) promotes them to
    float32, which the scan refuses."""
    host = {n: v.astype(BF16) for n, v in _params().items()}
    prompt = _prompts()
    if cls == "KVCacheDecoder":
        dec = JaxDecoder(host, ctx=mx.cpu(), dtype="bfloat16", **CFG, **LOCKSTEP)
        run = lambda: dec.greedy(prompt, 5, k=4)  # noqa: E731
    else:
        dec = JaxPaged(host, ctx=mx.cpu(), dtype="bfloat16", **CFG, **PAGED)
        run = lambda: dec.greedy([prompt[0], prompt[1]], 5, k=4)  # noqa: E731
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        run()


# ---------------------------------------------------------- params_from_numpy
def test_params_from_numpy_takes_ml_dtypes_bf16_bitwise():
    rs = np.random.RandomState(1)
    f32 = {"w": rs.randn(7, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    b16 = {n: v.astype(BF16) for n, v in f32.items()}
    got = pt.params_from_numpy(b16, ctx=pt.cpu())
    rounded = pt.params_from_numpy(f32, ctx=pt.cpu(), dtype="bfloat16")
    for n, v in b16.items():
        assert got[n].dtype == rounded[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[n].view(torch.int16).numpy(), v.view(np.int16))
        np.testing.assert_array_equal(rounded[n].view(torch.int16).numpy(), v.view(np.int16))
    assert pt.params_from_numpy(f32, ctx=pt.cpu())["w"].dtype == torch.float32
    with pytest.raises(pt.MXNetError, match="float32 or bfloat16"):
        pt.params_from_numpy(f32, ctx=pt.cpu(), dtype="float16")


# ------------------------------------------------------------- binding, sites
def test_bf16_decoders_bind_ids_in_float32_and_the_rest_in_bf16():
    """The inputs of both serving graphs: ``data`` and ``pos_idx`` float32
    (departure (a)), ``slot_onehot``, ``kv_mask`` and the KV buffers bf16;
    bf16 params stay bf16, float32 params float32; the caches' digests carry
    the float32 inputs."""
    host = _params()
    for params, want in ((pt.params_from_numpy(host, ctx=pt.cpu(), dtype="bfloat16"),
                          torch.bfloat16), (host, torch.float32)):
        dec = KVCacheDecoder(params, ctx=pt.cpu(), dtype="bfloat16", **CFG, **LOCKSTEP).warmup()
        pf = dec._pf_cache.executable({"data": (LOCKSTEP["batch"], LOCKSTEP["prefill_len"])})
        args = dict(dec._dec_exe.arg_dict, **{"pf_data": pf.arg_dict["data"]})
        dtypes = {n: a._tensor().dtype for n, a in args.items()}
        assert dtypes["pf_data"] == dtypes["data"] == dtypes["pos_idx"] == torch.float32
        assert dtypes["slot_onehot"] == dtypes["kv_mask"] == dtypes["kv_v_1"] == torch.bfloat16
        assert dtypes["layer0_qkv_weight"] == dtypes["lm_head_weight"] == want
    f32 = KVCacheDecoder(host, ctx=pt.cpu(), dtype="float32", **CFG, **LOCKSTEP)
    assert dec._dec_cache._digest != f32._dec_cache._digest


def test_a_site_of_mixed_dtypes_computes_in_the_promoted_dtype():
    """bf16 activations over float32 weights at a pattern site: the kernel
    candidate runs the float32 kernel on the operands widened, so its output
    has the unfused ops' (promoted) dtype, within the bf16 tolerance of the
    unfused ops (which round the statistics in bf16 before meeting the
    float32 gamma); the tune key's signature names each operand's dtype."""
    from mxnet_tpu_torch.ops import fusion_patterns as fp

    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(4, 6, 128).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rs.uniform(0.5, 1.5, 128).astype(np.float32))
    b = torch.from_numpy(rs.uniform(-0.2, 0.2, 128).astype(np.float32))
    pat = [p for p in fp.get_patterns() if p.name == "norm_residual"][0]
    baseline, cands = pat.build({"eps": 1e-5}, (x, g, b))
    (name, fused), = cands
    y = fused(x, g, b)
    assert name == "cuda" and y.dtype == torch.float32
    want = nr.layer_norm_affine_plain(x.float().reshape(-1, 128), g, b)[0].reshape(y.shape)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    unfused = baseline(x, g, b)
    assert unfused.dtype == torch.float32
    torch.testing.assert_close(y, unfused, rtol=TOL, atol=TOL)
    assert fp.sig_of((x, g)) == "bfloat16(4, 6, 128);float32(128,)"


def test_bf16_prefix_cache_and_speculative_decode_follow_the_decoders_dtype():
    """The chunk program in bf16: a cached admit's logits are the cold
    admit's bitwise (the same program over the same slots); speculative
    greedy (a bf16 draft megastep, a bf16 verify chunk) gives the target's
    plain greedy tokens."""
    from mxnet_tpu_torch.serving import SpeculativeDecoder

    w = pt.params_from_numpy(_params(), ctx=pt.cpu(), dtype="bfloat16")
    prompt = _prompts()[0]
    dec = PagedKVDecoder(w, ctx=pt.cpu(), dtype="bfloat16", prefix_cache=True, prefix_chunk=8,
                         **CFG, **PAGED)
    s0, cold = dec.admit(prompt[:9])  # one chunk of 8, then a tail of 1
    s1, hit = dec.admit(prompt[:9])
    np.testing.assert_array_equal(hit, cold)
    assert dec._kv("kv_k_0").dtype == torch.bfloat16 and dec.stats()["prefix_hit_rate"] > 0
    spec = SpeculativeDecoder.build(w, draft_layers=1, gamma=3, ctx=pt.cpu(), dtype="bfloat16",
                                    **CFG, **PAGED)
    assert spec.draft.dtype == spec.target.dtype == "bfloat16"
    np.testing.assert_array_equal(spec.greedy(prompt, 9),
                                  spec.target.greedy([prompt], 9, k=1)[0])
