"""The transformer LM trained in bfloat16 (``SPMDTrainer(compute_dtype=
'bfloat16')``), held against the JAX package.

- The plain versions of the flash-attention backward (rows 2 and 3 of the
  kernel table: ``flash_attention_bwd_dq_plain``, ``_dkv_plain``) and of the
  LayerNorm backward (row 5: ``layer_norm_affine_bwd_plain``) on bfloat16
  operands against the TPU kernels themselves (``pallas_attention._bwd_call``
  in interpret mode; ``_ln_bwd`` through ``jax.vjp`` of
  ``layer_norm_affine(..., interpret=True)``): dq, dk, dv, dx, dγ and dβ
  within one bfloat16 ulp, or within 1e-5 of the largest magnitude where a
  float32 sum cancels (``_bf16_close``). JAX's own tests allow 2e-2 and 4e-2
  (``tests/test_attention.py:201-228``, ``tests/test_pallas_norm_residual.py:33``).
- A small LM (2 layers, width 128, 2 heads of 64, vocabulary 256, 64
  tokens, batch 2) trained by both packages' bf16 step from the same numpy
  weights, the patterns forced on in both (``MXNET_FUSED_PATTERNS`` and
  ``MXNET_GRAPHREWRITE=on``; JAX's trainer binds the symbol as its fused
  module path does, after JAX's own bind-time rewrite, without which its
  naive LayerNorm composition matches no pattern). Against JAX's op-by-op
  step (``jax.disable_jit``), one step: the outputs within 4 bfloat16 ulps
  (72 of the 32768 probabilities move at all), and every parameter's
  update within ``OPBYOP_ULPS`` bfloat16 ulps of its largest (2, and 4 for the
  biases ``ROW_SUMMED_BIASES``). The ops round where JAX's do; what is left
  is order: float32 sums (the dots of XLA and torch, the kernels' row means)
  in other orders flip a few bfloat16 roundings, and JAX sums a bias's
  gradient over the rows in bfloat16, each add rounded, in windows of 32
  rows (XLA:CPU's tree reduction), where the port sums in float32 and
  rounds once (``test_the_references_bf16_row_sum_rounds_each_add``).
  Against JAX's compiled step, 3 steps: each array's distance from JAX's
  within twice the reference's own spread, the largest distance between
  its compiled and its op-by-op steps over the size of the update, which
  the module measures (``reference``: 0.0185 of an array's update, layer
  0's ffn1 weight, at these sizes; the port's largest is 0.0192, the same
  array); each step's loss within 1e-3 of itself.
- Departure (c) (ROADMAP.md section 3): the port's bf16 step binds token
  ids and class labels in float32. At vocabulary 1024 JAX's step cannot tell
  ids and labels 1000 and 1001 apart (bfloat16 rounds both to 1000) and the
  port's can; the LM's ``data`` and ``softmax_label`` stay float32, a
  ResNet's ``data`` is cast; ``Embedding`` over a bf16 weight with float32
  ids and ``SoftmaxOutput`` with a float32 label compute in the weight's and
  the data's dtype.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu
from mxnet_tpu.analysis.rewrite import rewrite_for_bind as jrewrite_for_bind
from mxnet_tpu.ops import pallas_attention as jpa
from mxnet_tpu.ops import pallas_norm_residual as jpn
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import norm_residual as nr
from mxnet_tpu_torch.ops.conv_bn import bf16_ulps

torch.set_num_threads(1)
BF16 = torch.bfloat16
FORCED = {"MXNET_GRAPHREWRITE": "on",
          "MXNET_FUSED_PATTERNS": "attention=pallas_flash,matmul_bias_act=pallas,"
                                  "norm_residual=pallas"}
CFG = dict(vocab_size=256, num_layers=2, num_heads=2, model_dim=128, ffn_dim=256)
SEQ, BATCH, STEPS = 64, 2, 3
OPT = {"learning_rate": 0.01, "momentum": 0.9}
#: the FullyConnected biases whose gradient JAX sums over the rows in
#: bfloat16 (ffn1's bias is a matmul_bias_act site's, summed in float32)
ROW_SUMMED_BIASES = ("qkv_bias", "proj_bias", "ffn2_bias", "lm_head_bias")
#: the op-by-op step's bound: bfloat16 ulps of each array's largest update
OPBYOP_ULPS = {"weights": 2, "row_summed_biases": 4}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXNET_FUSION_TUNE_DIR", "MXNET_FUSED_PATTERNS_INFER", "MXNET_GRAPHREWRITE_BF16",
              "MXNET_SERVE_QUANT", "MXNET_FUSED_CONV_BN", "MXNET_FUSED_CONV_BN_BWD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in FORCED.items():
        monkeypatch.setenv(k, v)


def _t(a):
    """A JAX array as a float32 torch tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _bf16_close(got, want, atol_rel=1e-5):
    """bf16 values of one function: neighbouring bfloat16 values, or within
    ``atol_rel`` of the largest |want| (a float32 sum that cancels)."""
    g, w = got.float(), want.float()
    near = (g - w).abs() <= atol_rel * float(w.abs().max())
    far = (bf16_ulps(g, w) > 1) & ~near
    assert int(far.sum()) == 0, (int(far.sum()), float((g - w).abs().max()))


# ------------------------------------------------------ the three kernels
# (BH, T, S, D, causal, block_q, block_k): T = S and S > T, causal and not,
# D = 32 and 64, over several blocks
FLASH_CASES = [(bh, t, s, d, causal, 32, 32) for bh, t, s in ((3, 64, 64), (2, 32, 96))
               for d in (32, 64) for causal in (True, False)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "bh%d_t%d_s%d_d%d_%s" % (
    c[:4] + ("causal" if c[4] else "full",)))
def test_flash_backward_plain_matches_the_pallas_kernels_on_bf16(case):
    BH, T, S, D, causal, bq, bk = case
    rs = np.random.RandomState(sum(case[:4]) + causal)
    q, k, v, do = (jnp.asarray(rs.randn(BH, n, D).astype(np.float32)).astype(jnp.bfloat16)
                   for n in (T, S, S, T))
    scale = float(1.0 / np.sqrt(D))
    o, lse = jpa._fwd_call(q, k, v, causal, scale, bq, bk, True)
    jdq, jdk, jdv = jpa._bwd_call(q, k, v, o, lse, do, causal, scale, bq, bk, True)
    assert jdq.dtype == jdk.dtype == jdv.dtype == jnp.bfloat16
    tq, tk, tv, to, tdo = (_t(a).to(BF16) for a in (q, k, v, o, do))
    tlse = _t(lse)[..., 0]
    got = fa.flash_attention_bwd(tq, tk, tv, to, tlse, tdo, causal=causal, scale=scale)
    assert all(g.dtype == BF16 for g in got)
    for g, w in zip(got, (jdq, jdk, jdv)):
        _bf16_close(g, _t(w))
    delta = (tdo.float() * to.float()).sum(dim=-1)
    args = (tq, tk, tv, tlse, tdo, delta, causal, scale)
    assert torch.equal(got[0], fa.flash_attention_bwd_dq_plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], fa.flash_attention_bwd_dkv_plain(*args)))


@pytest.mark.parametrize("R,D", [(128, 128), (256, 512)])
def test_layer_norm_backward_plain_matches_the_pallas_kernel_on_bf16(R, D):
    rs = np.random.RandomState(R + D)
    x, dy = (jnp.asarray(rs.randn(R, D).astype(np.float32)).astype(jnp.bfloat16)
             for _ in range(2))
    g = jnp.asarray(rs.uniform(0.5, 1.5, D).astype(np.float32)).astype(jnp.bfloat16)
    b = jnp.asarray(rs.uniform(-0.2, 0.2, D).astype(np.float32)).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_, g_, b_: jpn.layer_norm_affine(x_, g_, b_, interpret=True),
                     x, g, b)
    jdx, jdg, jdb = vjp(dy)
    assert jdx.dtype == jdg.dtype == jdb.dtype == jnp.bfloat16
    tx, tg, tb, tdy = (_t(a).to(BF16) for a in (x, g, b, dy))
    y = nr.LayerNormAffine.apply(tx.requires_grad_(True), tg.requires_grad_(True),
                                 tb.requires_grad_(True), 1e-5)
    got = torch.autograd.grad(y, (tx, tg, tb), tdy)
    assert all(t.dtype == BF16 for t in got)
    for a, w in zip(got, (jdx, jdg, jdb)):
        _bf16_close(a, _t(w))
    _, mean, rstd = nr.layer_norm_affine_plain(tx.detach(), tg.detach(), tb.detach())
    plain = nr.layer_norm_affine_bwd_plain(tx.detach(), tg.detach(), mean, rstd, tdy)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_the_references_bf16_row_sum_rounds_each_add():
    """What parts the biases' gradients: JAX's vjp of a bias added over 128
    bfloat16 rows is XLA:CPU's bfloat16 reduce, windows of 32 rows summed
    one add at a time, each add rounded to bfloat16, then the windows'
    sums likewise; the port's (torch's) sums in float32 and rounds once,
    and lies nearer float64's sum."""
    rs = np.random.RandomState(5)
    g = rs.rand(128, 256).astype(np.float32) / 256
    g[np.arange(128), rs.randint(0, 256, 128)] -= 1  # a softmax head's (p − onehot)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda b: jnp.zeros((128, 256), jnp.bfloat16) + b,
                         jnp.zeros(256, jnp.bfloat16))
        want = _t(vjp(gb)[0])
    t = _t(gb).to(BF16)

    def seq(rows):
        acc = torch.zeros(rows.shape[1:], dtype=BF16)
        for r in rows:
            acc = acc + r
        return acc

    windows = torch.stack([seq(t[i:i + 32]) for i in range(0, 128, 32)])
    assert torch.equal(seq(windows).float(), want)
    port = t.sum(dim=0)  # the port's bias gradient: float32 sum, one rounding
    exact = t.double().sum(dim=0)
    assert not torch.equal(port.float(), want)
    assert float((port.double() - exact).abs().sum()) < float((want.double() - exact).abs().sum())


# ------------------------------------------------------------ the whole step
def _lm(m):
    with m.name.NameManager():
        return m.models.transformer.get_symbol(seq_len=SEQ, **CFG)


def _batch(vocab=CFG["vocab_size"], seed=0):
    tok = np.random.RandomState(seed).randint(0, vocab, (BATCH, SEQ + 1)).astype(np.float32)
    return tok[:, :-1], tok[:, 1:]


def _jax_trainer(x, y):
    """JAX's bf16 trainer over its bind-time rewrite of the LM (as its fused
    module path binds it), with its initial weights."""
    sym = jrewrite_for_bind(_lm(mxnet_tpu), {"data": x.shape, "softmax_label": y.shape}, None,
                            grad_req="write", target="spmd")[0]
    tr = mxnet_tpu.parallel.SPMDTrainer(
        sym, mxnet_tpu.parallel.make_mesh({"data": 1}, devices=jax.devices()[:1]),
        optimizer="sgd", optimizer_params=OPT, compute_dtype="bfloat16")
    tr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
    return tr


def _params(tr):
    return {k: np.asarray(v, np.float32) for k, v in tr.get_params()[0].items()}


def _probs(out):
    return np.asarray(jnp.asarray(out).astype(jnp.float32)) if not isinstance(
        out, torch.Tensor) else out.float().numpy()


@pytest.fixture(scope="module")
def reference():
    """Both packages' bf16 steps from the JAX trainer's initial weights:
    {"start", "x", "y", "opbyop", "compiled", "port"}, each of the last
    three a list of (outputs, params) after each of STEPS steps, and
    "spread": the reference's own, the largest distance between its
    compiled and op-by-op params over the size of the update."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in FORCED.items():
            mp.setenv(k, v)
        x, y = _batch()
        runs = {}
        for kind in ("opbyop", "compiled"):
            tr = _jax_trainer(x, y)
            start = _params(tr)
            runs[kind] = []
            for _ in range(STEPS):
                if kind == "opbyop":
                    with jax.disable_jit():
                        out = tr.step({"data": x}, {"softmax_label": y})[0]
                else:
                    out = tr.step({"data": x}, {"softmax_label": y})[0]
                runs[kind].append((_probs(out), _params(tr)))
        ptr = pt.parallel.SPMDTrainer(_lm(pt), pt.parallel.make_mesh((1,), ("data",),
                                                                     [pt.cpu()]),
                                      optimizer="sgd", optimizer_params=OPT,
                                      compute_dtype="bfloat16")
        ptr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
        ptr.set_params(start)
        pt.ops.reset_launch_counts()
        runs["port"] = [(_probs(ptr.step({"data": x}, {"softmax_label": y})[0]), _params(ptr))
                        for _ in range(STEPS)]
        sites = list(ptr._sites.values())[0]
    comp, op = runs["compiled"][-1][1], runs["opbyop"][-1][1]
    spread = max(np.abs(comp[k] - op[k]).max() / np.abs(op[k] - start[k]).max() for k in op)
    loss_spread = max(abs(_xent(a, y) - _xent(b, y))
                      for (a, _), (b, _) in zip(runs["compiled"], runs["opbyop"]))
    return dict(runs, start=start, x=x, y=y, spread=float(spread), loss_spread=loss_spread,
                sites=sites, launches=pt.ops.launch_counts())


def _xent(prob, y):
    p = np.asarray(prob, np.float64)
    return float(-np.mean(np.log(np.maximum(p[np.arange(len(p)), y.reshape(-1).astype(int)],
                                            1e-30))))


def test_bf16_lm_step_engages_every_pattern_site_at_bfloat16(reference):
    """The 2 attention, 2 matmul_bias_act and 5 norm_residual sites engage
    their kernels (the plain versions on the CPU, no launch) at bfloat16."""
    pats = [d for d in reference["sites"].values() if d["kind"] == "pattern"]
    names = sorted(d["pat"].name for d in pats)
    assert names == ["attention"] * 2 + ["matmul_bias_act"] * 2 + ["norm_residual"] * 5
    assert all(d["train"] and "bfloat16" in d["key"] for d in pats)
    assert not any(reference["launches"].values())


def test_bf16_lm_step_matches_the_references_op_by_op_step(reference):
    """One step against JAX's op-by-op step: the probabilities within 4
    bfloat16 ulps and the loss within 1e-4; each parameter's update within
    OPBYOP_ULPS bfloat16 ulps of its largest; master weights float32."""
    (jo, jp), (po, pp) = reference["opbyop"][0], reference["port"][0]
    u = bf16_ulps(torch.tensor(po), torch.tensor(jo))
    assert int(u.max()) <= 4 and float((u > 0).float().mean()) < 5e-3, (int(u.max()),)
    y = reference["y"]
    assert abs(_xent(po, y) - _xent(jo, y)) <= 1e-4
    start = reference["start"]
    for k in jp:
        assert pp[k].dtype == np.float32
        ulps = OPBYOP_ULPS["row_summed_biases" if k.endswith(ROW_SUMMED_BIASES) else "weights"]
        step = np.abs(jp[k] - start[k]).max()
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=ulps * 2.0 ** -7 * step,
                                   err_msg=k)


def test_bf16_lm_steps_match_the_references_compiled_steps(reference):
    """3 steps against JAX's compiled step: each array within twice the
    reference's own spread (``reference``) of its update; each step's loss
    within 1e-3 of itself (at these sizes the port's third loss lies 4.6e-4
    of it below JAX's compiled one and 3.6e-4 below its op-by-op one, whose
    own distance is 1.0e-4: the port's float32 bias sums)."""
    spread, start, y = reference["spread"], reference["start"], reference["y"]
    assert 0 < spread < 0.1, spread
    for (jo, jp), (po, pp) in zip(reference["compiled"], reference["port"]):
        assert abs(_xent(po, y) - _xent(jo, y)) <= 1e-3 * _xent(jo, y)
    jp, pp = reference["compiled"][-1][1], reference["port"][-1][1]
    for k in jp:
        step = np.abs(jp[k] - start[k]).max()
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=2 * spread * step, err_msg=k)


def test_bf16_lm_loss_falls(reference):
    y = reference["y"]
    losses = [_xent(o, y) for o, _ in reference["port"]]
    assert losses[-1] < losses[0], losses


def test_a_bf16_tune_measures_each_lm_site_at_bfloat16(tmp_path, monkeypatch):
    """Under ``MXNET_FUSION_TUNE_DIR`` (patterns on ``auto``) the bf16 step's
    attention, matmul_bias_act and norm_residual sites are measured at
    bfloat16 (their keys name it; synthetic inputs made without numpy's
    bfloat16) and every candidate passes parity: at bfloat16 a candidate is
    held to the bf16 baseline or to the baseline's float32 value at the same
    inputs, and the matmul_bias_act kernel, which the bf16 baseline's
    gradients miss by 7 % at ReLU kinks, lies within 0.3 % of the latter."""
    from mxnet_tpu_torch import fusion_tune

    monkeypatch.delenv("MXNET_FUSED_PATTERNS")
    monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_FUSION_TUNE_ITERS", "1")
    fusion_tune.reset()
    try:
        x, y = _batch()
        tr = pt.parallel.SPMDTrainer(_lm(pt), pt.parallel.make_mesh((1,), ("data",),
                                                                   [pt.cpu()]),
                                     compute_dtype="bfloat16")
        tr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
        tr.step({"data": x}, {"softmax_label": y})
        with open(fusion_tune.cache_path("cpu")) as f:
            entries = json.load(f)["entries"]
    finally:
        fusion_tune.reset()
    kinds = sorted(k.split("|")[0] for k in entries)
    assert kinds == ["attention", "matmul_bias_act", "norm_residual"], sorted(entries)
    for key, rec in entries.items():
        assert "bfloat16" in key and rec["measured"], key
        for name, row in rec["measured"].items():
            assert "error" not in row and "rejected" not in row, (key, name, row)
            assert row["rel_err"] <= 2e-2, (key, name, row)


# ------------------------------------------------------------ departure (c)
def _ids_net(m):
    """``Embedding(1024, 8)`` → ``FullyConnected(1024)`` → ``SoftmaxOutput``."""
    s = m.sym
    with m.name.NameManager():
        e = s.Embedding(data=s.Variable("data"), input_dim=1024, output_dim=8, name="embed")
        fc = s.FullyConnected(data=e, num_hidden=1024, name="fc")
        return s.SoftmaxOutput(data=fc, label=s.Variable("softmax_label"), name="softmax")


def _ids_step(m, mesh, ids):
    tr = m.parallel.SPMDTrainer(_ids_net(m), mesh, optimizer="sgd",
                                optimizer_params={"learning_rate": 0.1},
                                compute_dtype="bfloat16")
    x = np.array(ids, np.float32).reshape(-1, 1)
    y = np.array(ids, np.float32)
    tr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=1)
    out = tr.step({"data": x}, {"softmax_label": y})[0]
    return _probs(out), {k: np.asarray(v) for k, v in tr.get_params()[0].items()}


def test_departure_c_ids_and_labels_above_256_stay_exact():
    """Ids and labels [1000, 3] and [1001, 3]: JAX's bf16 step rounds both
    1000 and 1001 to 1000 and gives the same outputs and weights; the
    port's binds them in float32 and tells them apart (the looked-up row,
    the trained rows)."""
    jmesh = mxnet_tpu.parallel.make_mesh({"data": 1}, devices=jax.devices()[:1])
    pmesh = pt.parallel.make_mesh((1,), ("data",), [pt.cpu()])
    ja, jwa = _ids_step(mxnet_tpu, jmesh, [1000, 3])
    jb, jwb = _ids_step(mxnet_tpu, jmesh, [1001, 3])
    assert np.array_equal(ja, jb) and all(np.array_equal(jwa[k], jwb[k]) for k in jwa)
    pa, pwa = _ids_step(pt, pmesh, [1000, 3])
    pb, pwb = _ids_step(pt, pmesh, [1001, 3])
    assert not np.array_equal(pa, pb)
    assert not np.array_equal(pwa["embed_weight"][1000], pwb["embed_weight"][1000])
    assert not np.array_equal(pwa["embed_weight"][1001], pwb["embed_weight"][1001])
    assert not np.array_equal(pwa["fc_bias"], pwb["fc_bias"])


def test_departure_c_the_lm_keeps_ids_and_labels_float32_resnet_casts_data():
    mesh = pt.parallel.make_mesh((1,), ("data",), [pt.cpu()])
    lm = pt.parallel.SPMDTrainer(_lm(pt), mesh, compute_dtype="bfloat16")
    assert lm._index_inputs == {"data", "softmax_label"}
    with pt.name.NameManager():
        res = pt.models.get_symbol("resnet", num_classes=10, num_layers=18,
                                   image_shape="3,32,32")
    rn = pt.parallel.SPMDTrainer(res, mesh, compute_dtype="bfloat16")
    assert rn._index_inputs == {"softmax_label"}
    # float32 steps cast nothing, whatever the inputs hold
    assert pt.parallel.SPMDTrainer(_lm(pt), mesh)._index_inputs == frozenset()


def test_departure_c_the_step_binds_ids_float32_and_the_rest_bfloat16(monkeypatch):
    """The values the bf16 LM step hands its program: ids and labels
    float32, every parameter bfloat16."""
    x, y = _batch()
    tr = pt.parallel.SPMDTrainer(_lm(pt), pt.parallel.make_mesh((1,), ("data",), [pt.cpu()]),
                                 compute_dtype="bfloat16")
    tr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
    seen = {}
    real = tr._prog.interpret

    def spy(args, *a, **kw):
        seen.update(zip(tr._prog.arg_names, (v.dtype for v in args)))
        return real(args, *a, **kw)

    monkeypatch.setattr(tr._prog, "interpret", spy)
    tr.step({"data": x}, {"softmax_label": y})
    assert seen.pop("data") == seen.pop("softmax_label") == torch.float32
    assert set(seen.values()) == {BF16}


def test_mixed_dtype_sites_of_the_ids_compute_in_the_bf16_dtype():
    """``Embedding`` with float32 ids over a bfloat16 weight gives bfloat16
    rows; ``SoftmaxOutput`` with bfloat16 data and a float32 label gives a
    gradient in data's dtype, equal to the one of a bfloat16 label (ids up
    to 256)."""
    from mxnet_tpu_torch.ops.registry import get_op, parse_attrs

    emb = get_op("Embedding")
    w = torch.randn(1024, 8).to(BF16)
    ids = torch.tensor([[1000.0, 1001.0, 3.0]])
    (rows,), _ = emb.apply(parse_attrs(emb, {"input_dim": 1024, "output_dim": 8}), [ids, w])
    assert rows.dtype == BF16 and torch.equal(rows[0], w[[1000, 1001, 3]])
    so = get_op("SoftmaxOutput")
    attrs = parse_attrs(so, {})
    data = torch.randn(4, 300).to(BF16).requires_grad_(True)
    grads = []
    for label in (torch.tensor([299.0, 3.0, 0.0, 255.0]),
                  torch.tensor([299.0, 3.0, 0.0, 255.0]).to(BF16)):
        (prob,), _ = so.apply(attrs, [data, label])
        grads.append(torch.autograd.grad(prob, data, torch.ones_like(prob))[0])
    assert prob.dtype == grads[0].dtype == BF16
    # 299 is not a bfloat16 integer (it rounds to 300, out of range): the
    # float32 label keeps row 0's target, the bfloat16 one drops it
    assert torch.equal(grads[0][1:], grads[1][1:]) and not torch.equal(grads[0][0], grads[1][0])
    assert float(grads[0][0, 299]) < 0 and float(grads[1][0, 299]) > 0


def test_ml_dtypes_bf16_holds_integers_exactly_only_to_256():
    """Why departure (c): 256 and 257 round apart only up to 256."""
    v = np.array([255, 256, 257, 1000, 1001], np.float32).astype(ml_dtypes.bfloat16)
    assert v.astype(np.float32).tolist() == [255, 256, 256, 1000, 1000]
