"""The port's pattern fusion engine (``fusion.plan``/``execute``,
``ops/fusion_patterns.py`` and the gate family of ``fusion.py``) held
against the JAX package's.

Every case of the reference's ``tests/test_fusion_patterns.py`` runs on
both packages (``_run(m, ...)``, the port inside ``with cpu():``, inputs
made by numpy from a seed): a pattern forced on (``MXNET_FUSED_PATTERNS=
<name>=1`` or a lowering name) gives the unfused graph's outputs and
gradients at the reference's tolerance, and the port's forced run gives
the JAX package's forced run's. The port's lowerings on the CPU are its
kernels' plain versions. A lowering name of the JAX package's ``pallas*``
family forces the port's kernel (``pallas_flash`` → ``cuda_flash``); a
name the port has no candidate for (``chunked_kv``, ``block_causal``)
leaves the site unfused, as the JAX gate leaves a site whose forced
lowering does not exist. The bfloat16 parameters run on the JAX package
only: the pattern kernels take float32 until ROADMAP.md section 2b's bf16
queue reaches them, ``PORT_F32_ONLY``.

``test_auto_mode_without_cache_is_bit_identical`` is the port's departure
(ROADMAP.md section 3): with no tune directory ``auto`` engages every site
the kernel takes, bitwise the forced run, where the JAX package declines
every site. Beside the reference's cases: the ``MXNET_FUSED_PATTERNS``
grammar, ``ElemwiseChain``'s matches and keys, the inference override,
the gate reasons, word for word where the predicate is shared, and
``MXNET_SERVE_QUANT=int8`` (the weight grid bitwise, a conv+BN net's
inference forward at the reference's tolerance). The GL303 case runs the
port's fusion explainer (``analysis/fusion_explain.py``) beside JAX's, and
their findings are equal; ``WAITS`` is empty.
"""
import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu.fusion
import mxnet_tpu.ops.fusion_patterns
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.fusion
import mxnet_tpu_torch.ops.fusion_patterns  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

#: reference cases not mirrored here (none)
WAITS = {}


@pytest.fixture(autouse=True)
def _no_tune(monkeypatch):
    monkeypatch.delenv("MXNET_FUSION_TUNE_DIR", raising=False)
    monkeypatch.delenv("MXNET_FUSED_PATTERNS_INFER", raising=False)


def _pkgs(dtype="float32"):
    return [mxnet_tpu, pt] if dtype == "float32" else [mxnet_tpu]


def _tol(dtype):
    return 4e-2 if dtype == "bfloat16" else 2e-5


def _run(m, net_fn, shapes, dtype, env, monkeypatch, is_train=True, seed=3):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", env)
    with pt.cpu() if m is pt else contextlib.nullcontext():
        net = net_fn(m)
        rs = np.random.RandomState(seed)
        type_dict = {n: dtype for n in net.list_arguments() if "label" not in n}
        ex = net.simple_bind(m.cpu(), grad_req="write", type_dict=type_dict, **shapes)
        for name, arr in zip(net.list_arguments(), ex.arg_arrays):
            if "label" in name:
                arr[:] = rs.randint(0, 4, arr.shape).astype("f")
            else:
                arr[:] = rs.uniform(-0.5, 0.5, arr.shape).astype("f")
        outs = ex.forward(is_train=is_train)
        host = [o.asnumpy().astype("f") for o in outs]
        grads = {}
        if is_train:
            ex.backward()
            grads = {n: (g.asnumpy().astype("f") if g is not None else None)
                     for n, g in ex.grad_dict.items()}
        return host, grads


def _assert_parity(ref, got, dtype, what, tol=None):
    r_outs, r_grads = ref
    g_outs, g_grads = got
    tol = tol if tol is not None else _tol(dtype)
    for a, b in zip(r_outs, g_outs):
        denom = np.max(np.abs(a)) + 1e-9
        assert np.max(np.abs(a - b)) / denom <= tol, (what, "outputs")
    for k in r_grads:
        if r_grads[k] is None:
            continue
        denom = np.max(np.abs(r_grads[k])) + 1e-9
        err = np.max(np.abs(r_grads[k] - g_grads[k])) / denom
        assert err <= tol, (what, "grad", k, err)


def _forced_both(net_fn, shapes, dtype, ref_env, env, monkeypatch, what, tol=None,
                 is_train=True):
    """The reference's contract in each package, then the port's forced run
    against the JAX package's."""
    got = {}
    for m in _pkgs(dtype):
        ref = _run(m, net_fn, shapes, dtype, ref_env, monkeypatch, is_train)
        got[m] = _run(m, net_fn, shapes, dtype, env, monkeypatch, is_train)
        _assert_parity(ref, got[m], dtype, "%s/%s" % (m.__name__, what), tol)
    if pt in got:
        _assert_parity(got[mxnet_tpu], got[pt], dtype, "port vs jax " + what, tol)


# ---------------------------------------------------------- matmul_bias_act
def _mba_net(act="relu"):
    def build(m):
        sym = m.sym
        x = sym.Variable("data")
        h = sym.FullyConnected(x, num_hidden=128, name="fc1")
        h = sym.Activation(h, act_type=act, name="act1")
        h = sym.FullyConnected(h, num_hidden=4, name="fc2")
        return sym.SoftmaxOutput(h, name="softmax")
    return build


_MBA = {"data": (8, 32), "softmax_label": (8,)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_matmul_bias_act_parity(monkeypatch, dtype, act):
    tol = 1e-1 if dtype == "bfloat16" and act == "relu" else None
    _forced_both(_mba_net(act), _MBA, dtype, "0", "matmul_bias_act=1", monkeypatch,
                 "matmul_bias_act/" + act, tol)


def test_matmul_bias_act_inference_parity(monkeypatch):
    _forced_both(_mba_net(), _MBA, "float32", "0", "matmul_bias_act=1", monkeypatch,
                 "matmul_bias_act/infer", is_train=False)


# ------------------------------------------------------------ norm_residual
def _ln_net(dim=32):
    def build(m):
        sym = m.sym
        x = sym.Variable("data")
        mean = sym.mean(x, axis=-1, keepdims=True)
        cent = sym.broadcast_sub(x, mean, name="cent")
        var = sym.mean(sym.square(cent), axis=-1, keepdims=True)
        inv = sym.rsqrt(var + 1e-5)
        normed = sym.broadcast_mul(cent, inv)
        gamma = sym.Variable("ln_gamma", shape=(dim,))
        beta = sym.Variable("ln_beta", shape=(dim,))
        out = sym.broadcast_add(sym.broadcast_mul(normed, gamma), beta, name="ln")
        fc = sym.FullyConnected(out, num_hidden=4, flatten=True, name="head")
        return sym.SoftmaxOutput(fc, name="softmax")
    return build


_LN = {"data": (4, 8, 32), "softmax_label": (4,)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_residual_parity(monkeypatch, dtype):
    _forced_both(_ln_net(), _LN, dtype, "0", "norm_residual=1", monkeypatch, "norm_residual")


def test_norm_residual_inference_parity(monkeypatch):
    _forced_both(_ln_net(), _LN, "float32", "0", "norm_residual=1", monkeypatch,
                 "norm_residual/infer", is_train=False)


# ---------------------------------------------------------------- attention
def _att_net(m):
    sym = m.sym
    x = sym.Variable("data")
    att = sym.MultiHeadAttention(query=x, key=x, value=x, causal=True, name="att")
    fc = sym.FullyConnected(sym.Flatten(att), num_hidden=4, name="head")
    return sym.SoftmaxOutput(fc, name="softmax")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_causal_parity(monkeypatch, dtype):
    """``attention=1`` forces each package's first candidate: the JAX
    package's block-causal XLA, the port's flash kernel."""
    _forced_both(_att_net, {"data": (2, 2, 64, 16), "softmax_label": (2,)}, dtype, "0",
                 "attention=1", monkeypatch, "attention/first candidate")


def _cross_att_net(causal=False):
    def build(m):
        sym = m.sym
        q, kv = sym.Variable("q"), sym.Variable("kv")
        att = sym.MultiHeadAttention(query=q, key=kv, value=kv, causal=causal, name="xatt")
        fc = sym.FullyConnected(sym.Flatten(att), num_hidden=4, name="head")
        return sym.SoftmaxOutput(fc, name="softmax")
    return build


_CROSS_SHAPES = {"q": (2, 2, 8, 16), "kv": (2, 2, 64, 16), "softmax_label": (2,)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lowering", ["chunked_kv", "pallas_flash"])
def test_attention_rectangular_fwd_parity(monkeypatch, causal, lowering):
    _forced_both(_cross_att_net(causal), _CROSS_SHAPES, "float32", "0",
                 "attention=%s" % lowering, monkeypatch,
                 "attention/%s causal=%s" % (lowering, causal), tol=1e-5, is_train=False)


def test_attention_rectangular_train_parity(monkeypatch):
    _forced_both(_cross_att_net(True), _CROSS_SHAPES, "float32", "0", "attention=chunked_kv",
                 monkeypatch, "attention/chunked_kv train", tol=1e-5)


def _run_tf(m, shapes, env, monkeypatch, seed=5):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", env)
    with pt.cpu() if m is pt else contextlib.nullcontext():
        net = m.models.get_symbol("transformer", vocab_size=50, model_dim=32, num_heads=2,
                                  num_layers=1, seq_len=8)
        rs = np.random.RandomState(seed)
        ex = net.simple_bind(m.cpu(), grad_req="write", **shapes)
        for name, arr in zip(net.list_arguments(), ex.arg_arrays):
            if name in ("data", "softmax_label"):
                arr[:] = rs.randint(1, 50, arr.shape).astype("f")
            else:
                arr[:] = rs.uniform(-0.5, 0.5, arr.shape).astype("f")
        host = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward()
        return host, {n: (g.asnumpy() if g is not None else None)
                      for n, g in ex.grad_dict.items()}


def test_attention_flash_training_parity_transformer(monkeypatch):
    shapes = {"data": (2, 8), "softmax_label": (2, 8)}
    got = {}
    for m in (mxnet_tpu, pt):
        ref = _run_tf(m, shapes, "0", monkeypatch)
        got[m] = _run_tf(m, shapes, "attention=pallas_flash", monkeypatch)
        _assert_parity(ref, got[m], "float32", "attention/flash-train", tol=1e-5)
    _assert_parity(got[mxnet_tpu], got[pt], "float32", "port vs jax flash-train", tol=1e-5)


def test_memory_plan_elides_flash_attention_scores(monkeypatch):
    """Forced flash drops the (B, H, T, S) score stash in both packages. The
    dense plan is each package's own: JAX in auto with no verdict, the port
    with its patterns off (in auto the port trains every site flash)."""
    for m, dense_env in ((mxnet_tpu, "auto"), (pt, "0")):
        net = m.models.get_symbol("transformer", vocab_size=50, model_dim=64, num_heads=2,
                                  num_layers=2, seq_len=64)
        shapes = {"data": (2, 64), "softmax_label": (2, 64)}
        monkeypatch.setenv("MXNET_FUSED_PATTERNS", dense_env)
        dense = m.analysis.lint(net, shapes=shapes, train=True,
                                passes=["shape_lint", "memory_plan"]).memory_plan
        assert dense["attention"]["sites"] == 2
        assert dense["attention"]["score_bytes"] == 2 * (2 * 2 * 64 * 64 * 4)
        assert dense["attention"]["flash_elided_sites"] == 0
        monkeypatch.setenv("MXNET_FUSED_PATTERNS", "attention=pallas_flash")
        flash = m.analysis.lint(net, shapes=shapes, train=True,
                                passes=["shape_lint", "memory_plan"]).memory_plan
        assert flash["attention"]["flash_elided_sites"] == 2
        assert flash["attention"]["score_bytes"] == 0
        assert flash["per_device"]["peak"] < dense["per_device"]["peak"]
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "auto")
    assert pt.fusion.attention_trains_flash((2, 2, 64, 32), (2, 2, 64, 32), "float32", True)


# ----------------------------------------------------------- elemwise_chain
def _chain_net(m):
    sym = m.sym
    x = sym.Variable("data")
    h = sym.exp(x * 0.1)
    h = sym.tanh(h)
    h = sym.Activation(h, act_type="sigmoid", name="sig")
    fc = sym.FullyConnected(h, num_hidden=4, name="head")
    return sym.SoftmaxOutput(fc, name="softmax")


def test_elemwise_chain_parity(monkeypatch):
    _forced_both(_chain_net, {"data": (4, 16), "softmax_label": (4,)}, "float32", "0",
                 "elemwise_chain=1", monkeypatch, "elemwise_chain")


def test_elemwise_chain_matches_and_keys_as_the_reference(monkeypatch):
    """The chain roots at its end with the same interior, meta key and
    untunable verdict in both packages."""
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "elemwise_chain")
    got = {}
    for m in (mxnet_tpu, pt):
        net = _chain_net(m)
        plan = m.fusion.plan(net._topo(), output_ids={id(n) for n, _ in net._outputs})
        roots = [(d["pat"].name, d["pat"].key_variant(d["meta"]),
                  [n.op for n in d["meta"]["nodes"]])
                 for d in plan.values() if d["kind"] == "pattern"]
        got[m] = (roots, sum(d["kind"] == "lazy" for d in plan.values()))
    assert got[mxnet_tpu] == got[pt]
    assert got[pt][0] == [("elemwise_chain", "_mul_scalar(0.1)-exp-tanh-sigmoid",
                           ["_mul_scalar", "exp", "tanh", "Activation"])]
    assert pt.ops.fusion_patterns.ElemwiseChain.tunable is False


# ------------------------------------------------------- auto-mode fallback
def test_auto_mode_without_cache_is_bit_identical(monkeypatch):
    """The reference: with no tune cache every JAX gate declines, bitwise
    the engine off. The port's departure: every site its kernel takes
    engages, bitwise the forced run (``matmul_bias_act=1``)."""
    ref = _run(mxnet_tpu, _mba_net(), _MBA, "float32", "0", monkeypatch)
    got = _run(mxnet_tpu, _mba_net(), _MBA, "float32", "auto", monkeypatch)
    forced = _run(pt, _mba_net(), _MBA, "float32", "matmul_bias_act=1", monkeypatch)
    auto = _run(pt, _mba_net(), _MBA, "float32", "auto", monkeypatch)
    for a, b in list(zip(ref[0], got[0])) + list(zip(forced[0], auto[0])):
        assert np.array_equal(a, b)
    for r, g in ((ref[1], got[1]), (forced[1], auto[1])):
        for k in r:
            if r[k] is not None:
                assert np.array_equal(r[k], g[k]), k
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "auto")
    with pt.cpu():
        ex = _mba_net()(pt).simple_bind(pt.cpu(), **_MBA)
    [site] = [d for d in ex._sites.values() if d["kind"] == "pattern"]
    assert site["train"] == site["infer"] == "cuda"
    assert "the port's default" in site["train_reason"]


# ------------------------------------------------------------ plan coverage
def test_plan_roots_transformer_patterns(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "auto")
    for m in (mxnet_tpu, pt):
        net = m.models.get_symbol("transformer", vocab_size=50, model_dim=32, num_heads=2,
                                  num_layers=1, seq_len=8)
        sites = m.analysis.pattern_site_counts(net)
        assert sites.get("attention") == 1
        assert sites.get("matmul_bias_act", 0) >= 1
        assert sites.get("norm_residual", 0) == 0
        assert m.analysis.pattern_site_counts(m.analysis.rewrite(net).symbol) \
            .get("norm_residual") == 3


def test_patterns_off_plan_has_no_pattern_directives(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "0")
    for m in (mxnet_tpu, pt):
        net = _mba_net()(m)
        plan = m.fusion.plan(net._topo(), output_ids={id(n) for n, _ in net._outputs})
        assert not any(d["kind"] in ("pattern", "lazy") for d in plan.values())


def test_infer_env_override_plans_pattern(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "0")
    monkeypatch.setenv("MXNET_FUSED_PATTERNS_INFER", "matmul_bias_act")
    for m in (mxnet_tpu, pt):
        net = _mba_net()(m)
        plan = m.fusion.plan(net._topo(), output_ids={id(n) for n, _ in net._outputs})
        assert any(d["kind"] == "pattern" for d in plan.values())
        assert m.fusion.enabled_patterns()["matmul_bias_act"] == "0"
        assert m.fusion.enabled_patterns(infer=True)["matmul_bias_act"] == "auto"


def test_infer_override_engages_on_inference_only(monkeypatch):
    """The port's bind resolves the training and the inference verdict
    apart: a pattern the inference map alone enables runs its kernel on an
    inference forward and the unfused ops on a training one."""
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "0")
    monkeypatch.setenv("MXNET_FUSED_PATTERNS_INFER", "matmul_bias_act")
    with pt.cpu():
        ex = _mba_net()(pt).simple_bind(pt.cpu(), **_MBA)
    [site] = [d for d in ex._sites.values() if d["kind"] == "pattern"]
    assert site["train"] is None and site["infer"] == "cuda"
    assert site["train_reason"] == "pattern disabled (MXNET_FUSED_PATTERNS)"


def test_memory_plan_reports_fusion_interiors(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "auto")
    for m in (mxnet_tpu, pt):
        rep = m.analysis.lint(_mba_net()(m), shapes={"data": (8, 32)},
                              passes=["shape_lint", "memory_plan"])
        plan = rep.memory_plan
        assert plan is not None and "fusion" in plan
        assert plan["fusion"]["pattern_sites"].get("matmul_bias_act") == 1
        assert plan["fusion"]["interior_bytes"] > 0


# ------------------------------------------------- grammar, reasons, keys
@pytest.mark.parametrize("env", ["", "auto", "all", "1", "0", "off", "none",
                                 "attention,matmul_bias_act=1",
                                 "attention=pallas_flash,norm_residual=0",
                                 "matmul_bias_act=auto,auto", "elemwise_chain=fused",
                                 "bogus,attention", "attention=nosuchlowering"])
def test_patterns_env_grammar_matches_the_reference(env):
    names = mxnet_tpu.ops.fusion_patterns.pattern_names()
    assert pt.ops.fusion_patterns.pattern_names() == names
    assert pt.fusion._parse_patterns_env(env, names) == \
        mxnet_tpu.fusion._parse_patterns_env(env, names)


def _mba_args(m, rows=8):
    rs = np.random.RandomState(0)
    host = (rs.randn(rows, 32).astype("f"), rs.randn(128, 32).astype("f"),
            rs.randn(128).astype("f"))
    if m is pt:
        import torch

        return tuple(torch.from_numpy(a) for a in host)
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in host)


@pytest.mark.parametrize("env,train", [("0", True), ("0", False), ("matmul_bias_act=1", True),
                                       ("matmul_bias_act=nosuch", True),
                                       ("matmul_bias_act=0", False)])
def test_gate_pattern_reasons_match_the_reference_word_for_word(env, train, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", env)
    meta = {"act": "relu", "flatten": True, "no_bias": False}
    got = []
    for m in (mxnet_tpu, pt):
        pat = next(p for p in m.ops.fusion_patterns.get_patterns() if p.name == "matmul_bias_act")
        args = _mba_args(m)
        engaged, _, reason = m.fusion.gate_pattern_explain(pat, meta, args, train=train)
        got.append((engaged, reason))
        assert m.fusion._tune_key(pat, meta, args) == \
            "matmul_bias_act|relu|float32(8, 32);float32(128, 32);float32(128,)"
    assert got[0] == got[1]


def test_untunable_chain_reason_matches_the_reference(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "elemwise_chain")
    got = []
    for m in (mxnet_tpu, pt):
        net = _chain_net(m)
        plan = m.fusion.plan(net._topo(), output_ids={id(n) for n, _ in net._outputs})
        [d] = [d for d in plan.values() if d["kind"] == "pattern"]
        x = (np.zeros((4, 16), "f"),)
        if m is pt:
            import torch

            x = (torch.from_numpy(x[0]),)
        got.append(m.fusion.gate_pattern_explain(d["pat"], d["meta"], x)[2])
    assert got[0] == got[1]


@pytest.mark.parametrize("env", ["0", "1"])
def test_conv_gate_reasons_match_the_reference_word_for_word(env, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", env)
    args = ((1, 1), (1, 1), (2, 8, 8, 8), (16, 8, 1, 1), np.float32, True)
    assert pt.fusion.gate_explain(*args) == mxnet_tpu.fusion.gate_explain(*args)


def test_port_gate_family_defaults(monkeypatch):
    """The port's own predicates: the shape gate's reason, a bare conv and
    an untuned site engage, the backward policies, quantization modes."""
    for k in ("MXNET_FUSED_CONV_BN", "MXNET_FUSED_CONV_BN_BWD", "MXNET_SERVE_QUANT"):
        monkeypatch.delenv(k, raising=False)
    f = pt.fusion
    ok = ((1, 1), (1, 1), (2, 8, 8, 8), (16, 8, 1, 1), np.float32)
    assert f.gate_explain(*ok, True)[0] and f.gate_explain(*ok, False)[0]
    assert "no tune verdict" in f.gate_explain(*ok, True)[1]
    odd = ((1, 1), (1, 1), (2, 6, 8, 8), (16, 6, 1, 1), np.float32, True)
    assert f.gate_explain(*odd) == (False, "shape (2, 6, 8, 8)x(16, 6, 1, 1) is not taken "
                                           "by the kernels' shape gate (supported() declined)")
    assert f.bwd_mode(*ok, True) == "recompute"
    for env, want in (("0", "xla"), ("xla", "xla"), ("1", "recompute"), ("stash", "stash"),
                      ("recompute", "recompute"), ("junk", "xla")):
        monkeypatch.setenv("MXNET_FUSED_CONV_BN_BWD", env)
        assert f.bwd_mode(*ok, True) == want, env
    assert f.conv_schedule((1, 1), (1, 1), (2, 8, 8, 8), (16, 8, 1, 1), np.float32, False) \
        is None
    assert f.infer_default()
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", "0")
    assert not f.infer_default()
    for env, want in (("", "off"), ("int8", "int8"), ("bf16", "bf16"), ("fp32", "off"),
                      ("junk", "off")):
        monkeypatch.setenv("MXNET_SERVE_QUANT", env)
        assert f.quant_mode() == want == mxnet_tpu.fusion.quant_mode()


def test_int8_weight_grid_matches_the_reference():
    """``MXNET_SERVE_QUANT=int8``'s weight transform against the JAX
    package's ``_quant_conv_inputs``: the same per-output-channel scale,
    rounding and clamp, bitwise (an all-zero channel keeps scale 1)."""
    import jax.numpy as jnp

    rs = np.random.RandomState(11)
    w = (rs.randn(16, 8, 3, 3) * 0.2).astype(np.float32)
    w[3] = 0.0
    w[5, 0, 0, 0] = 4.0  # one outlier sets its channel's scale
    x = rs.randn(2, 8, 6, 6).astype(np.float32)
    _, want = mxnet_tpu.fusion._quant_conv_inputs(jnp.asarray(x), jnp.asarray(w), "int8")
    got = pt.fusion._quant_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), w)


def _conv_bn_net(m):
    """Two pre-activation bottlenecks of the package's own ResNet (a
    projection and a stride-2 unit), then the zoo's head."""
    res = (mxnet_tpu if m is mxnet_tpu else pt).models.resnet
    sym = m.sym
    body = sym.Variable("data")
    body = res.residual_unit(body, 32, (1, 1), False, "u1")
    body = res.residual_unit(body, 32, (2, 2), False, "u2")
    bn = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
    relu = sym.Activation(data=bn, act_type="relu", name="relu")
    pool = sym.Pooling(data=relu, global_pool=True, kernel=(4, 4), pool_type="avg", name="pool")
    fc = sym.FullyConnected(data=sym.Flatten(data=pool), num_hidden=10, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _conv_bn_infer(m, quant, monkeypatch):
    """An inference forward of ``_conv_bn_net`` on seeded values, the JAX
    package forced onto its Pallas conv+BN kernels (interpret mode)."""
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", "1")
    monkeypatch.setenv("MXNET_SERVE_QUANT", quant)
    with pt.cpu() if m is pt else contextlib.nullcontext():
        ex = _conv_bn_net(m).simple_bind(m.cpu(), grad_req="null", data=(2, 16, 8, 8),
                                         softmax_label=(2,))
        rs = np.random.RandomState(7)
        for n, arr in sorted(ex.arg_dict.items()):
            if n == "softmax_label":
                v = rs.randint(0, 10, arr.shape)
            elif n.endswith("_gamma"):
                v = rs.uniform(0.5, 1.5, arr.shape)
            elif n.endswith("_beta") or n.endswith("_bias") or n == "data":
                v = rs.uniform(-0.5, 0.5, arr.shape)
            else:
                v = rs.randn(*arr.shape) * np.sqrt(2.0 / np.prod(arr.shape[1:]))
            arr[:] = v.astype(np.float32)
        for n, arr in sorted(ex.aux_dict.items()):
            arr[:] = (rs.uniform(0.5, 1.5, arr.shape) if n.endswith("_var")
                      else rs.uniform(-0.1, 0.1, arr.shape)).astype(np.float32)
        return ex.forward(is_train=False)[0].asnumpy(), ex


def test_int8_inference_matches_the_reference(monkeypatch):
    """A conv+BN net's inference forward under ``MXNET_SERVE_QUANT=int8``:
    the port (the stats-free kernel's plain version on the quantized
    weights) against the JAX package (its Pallas inference kernel on its
    own quantized weights), at the reference's fused-vs-unfused output
    tolerance; and int8 moves the output off the float32 forward's."""
    tol = dict(rtol=1e-4, atol=1e-5)
    saved = pt.telemetry.current_override()
    pt.telemetry.set_mode("counters")
    pt.telemetry.reset()
    try:
        got, ex = _conv_bn_infer(pt, "int8", monkeypatch)
        engaged = pt.telemetry.counter("fusion.infer_engaged").value
    finally:
        pt.telemetry.set_mode(saved)
    want, _ = _conv_bn_infer(mxnet_tpu, "int8", monkeypatch)
    np.testing.assert_allclose(got, want, **tol)
    # every planned conv site takes the stats-free kernel
    sites = [d for d in ex._sites.values() if d["kind"] == "conv"]
    assert len(sites) >= 6 and engaged == len(sites)
    assert all(d["infer"] and d["quant"] == "int8" for d in sites)
    off, _ = _conv_bn_infer(pt, "off", monkeypatch)
    assert not np.allclose(got, off, **tol)


def test_gl303_reports_pattern_sites_and_near_misses(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "auto")
    rows = []
    for m in (mxnet_tpu, pt):
        sym = m.sym
        x = sym.Variable("data")
        # near-miss: FullyConnected consumed twice -> not rooted
        fc = sym.FullyConnected(x, num_hidden=8, name="fc_shared")
        out = sym.Activation(fc, act_type="relu", name="relu_a") + fc
        net = sym.SoftmaxOutput(sym.FullyConnected(sym.Flatten(out), num_hidden=4, name="head"),
                                name="softmax")
        rep = m.analysis.lint(net, shapes={"data": (4, 16)}, passes=["fusion_explain"])
        gl303 = [d for d in rep if d.code == "GL303"]
        assert any("consumers" in d.message for d in gl303), [d.message for d in gl303]
        # a graph where the pattern cleanly roots reports NO GL303 noise
        rep2 = m.analysis.lint(_mba_net()(m), shapes={"data": (8, 32)},
                               passes=["fusion_explain"])
        assert not [d for d in rep2 if d.code == "GL303"]
        rows.append([(d.code, d.node, d.message) for d in list(rep) + list(rep2)])
    assert rows[1] == rows[0]


def test_every_reference_case_is_mirrored_or_named():
    ref = {n.name for n in ast.parse((ROOT / "tests" / "test_fusion_patterns.py").read_text()).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    here = {n for n in globals() if n.startswith("test_")}
    assert ref - here == set(WAITS)
