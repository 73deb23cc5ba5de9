"""Ring attention and the sequence-parallel step of the port
(``mxnet_tpu_torch/parallel/ring_attention.py``, ``ops/attention.py``'s
dispatch, the fusion gate) held against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. JAX
runs on the 8 virtual CPUs of ``tests/conftest.py``; the port runs a mesh
of logical ``cpu(i)`` as one program. The tolerance is JAX's own
(``tests/test_attention.py``: rtol 1e-4, atol 1e-5) unless a test states
another. The ring across processes runs as two gloo ranks under
``tools/launch.py -n 2 --launcher local``, with its own timeout.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu.parallel.ring_attention import ring_attention as jax_ring
from mxnet_tpu.parallel.ring_attention import local_blockwise_attention as jax_local
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel.ring_attention import local_blockwise_attention, ring_attention

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


def _ref_attention(q, k, v, causal):
    """The numpy oracle of tests/test_attention.py over (B, H, T, D)."""
    d = q.shape[-1]
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    if causal:
        T, S = s.shape[-2], s.shape[-1]
        s = np.where(np.tril(np.ones((T, S), bool), k=S - T), s, -np.inf)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype("float32") for _ in range(3)]


def _meshes(shape):
    n = int(np.prod(list(shape.values())))
    return (mxnet_tpu.parallel.make_mesh(shape, devices=jax.devices()[:n]),
            parallel.make_mesh(shape, devices=[pt.cpu(i) for i in range(n)]))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_exact_against_jax_and_numpy(causal):
    q, k, v = _qkv(1, (2, 16, 2, 4))
    jmesh, pmesh = _meshes({"seq": 4})
    want = np.asarray(jax_ring(q, k, v, jmesh, seq_axis="seq", causal=causal))
    got = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), pmesh, seq_axis="seq",
                         causal=causal).numpy()
    ref = _ref_attention(*(x.transpose(0, 2, 1, 3) for x in (q, k, v)),
                         causal).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # batch_axis leaves the one-program ring's result unchanged
    jmesh2, pmesh2 = _meshes({"data": 2, "seq": 4})
    both = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), pmesh2, causal=causal,
                          batch_axis="data").numpy()
    np.testing.assert_allclose(both, got, rtol=0, atol=0)
    np.testing.assert_allclose(
        both, np.asarray(jax_ring(q, k, v, jmesh2, causal=causal, batch_axis="data")),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grads_match_jax_grad(causal):
    """q, k and v gradients of <ring(q, k, v), w> for a random cotangent w
    against ``jax.grad`` through JAX's ppermute ring."""
    q, k, v = _qkv(2, (1, 8, 2, 4))
    w = np.random.RandomState(3).randn(1, 8, 2, 4).astype("float32")
    jmesh, pmesh = _meshes({"seq": 4})

    def loss(q_, k_, v_):
        return (jax_ring(q_, k_, v_, jmesh, causal=causal) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (ring_attention(*ts, pmesh, causal=causal) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", ts, want):
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL,
                                   err_msg="d" + name)


@pytest.mark.parametrize("causal,q_block,kv_block", [(False, 1, 0), (True, 1, 0), (True, 1, 1),
                                                     (True, 0, 2)])
def test_local_blockwise_attention_matches_jax(causal, q_block, kv_block):
    """One block's unnormalized output, running max and denominator; (0, 2)
    is an all-masked block (max 0, denominator 0)."""
    q, k, v = _qkv(4, (2, 4, 2, 3))
    want = jax_local(*(jnp.asarray(x) for x in (q, k, v)), 0.5, causal, q_block, kv_block, 4)
    got = local_blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0.5, causal,
                                    q_block, kv_block, 4)
    for name, a, b in zip(("o", "m", "l"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


def _op_apply(pkg, attrs, q, k, v):
    opdef = pkg.ops.registry.get_op("_contrib_MultiHeadAttention")
    ins = [torch.from_numpy(x) for x in (q, k, v)] if pkg is pt else [q, k, v]
    (out,), _ = opdef.apply(attrs, ins)
    return np.asarray(out)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_dispatch_in_op_matches_dense_in_both_packages(causal):
    """Under a trace mesh with a 'seq' axis the op dispatches to the ring
    (dp x sp), counts it in ``DISPATCH_COUNTS["ring"]`` and gives the
    dense path's values, in both packages (JAX :303)."""
    from mxnet_tpu.ops import attention as jattn
    from mxnet_tpu_torch.ops import attention as pattn

    q, k, v = _qkv(3, (4, 2, 16, 4))
    attrs = {"causal": causal, "scale": -1.0}
    meshes = _meshes({"data": 2, "seq": 4})
    for pkg, mod, mesh in ((mxnet_tpu, jattn, meshes[0]), (pt, pattn, meshes[1])):
        dense = _op_apply(pkg, attrs, q, k, v)
        before = mod.DISPATCH_COUNTS["ring"]
        with pkg.parallel.mesh.trace_mesh(mesh):
            ring = _op_apply(pkg, attrs, q, k, v)
        assert mod.DISPATCH_COUNTS["ring"] == before + 1, pkg.__name__
        np.testing.assert_allclose(ring, dense, rtol=RTOL, atol=ATOL, err_msg=pkg.__name__)
        np.testing.assert_allclose(ring, _ref_attention(q, k, v, causal), rtol=RTOL, atol=ATOL)
    assert set(pattn.DISPATCH_COUNTS) == set(jattn.DISPATCH_COUNTS)


@pytest.mark.parametrize("case", ["kill_switch", "cross_attention", "ragged_T", "ragged_batch",
                                  "data_mesh"])
def test_ring_dispatch_declines_where_jax_declines(monkeypatch, case):
    """The kill switch (JAX :328), cross-attention (S != T), T not divisible
    by the seq axis, a batch not divisible by the data axis and a mesh
    without a seq axis keep the dense path in both packages."""
    from mxnet_tpu.ops import attention as jattn
    from mxnet_tpu_torch.ops import attention as pattn

    if case == "kill_switch":
        monkeypatch.setenv("MXNET_RING_ATTENTION", "0")
    B, T = (3 if case == "ragged_batch" else 2), (18 if case == "ragged_T" else 16)
    rs = np.random.RandomState(4)
    q = rs.randn(B, 2, T, 4).astype("float32")
    k, v = (rs.randn(B, 2, 24 if case == "cross_attention" else T, 4).astype("float32")
            for _ in range(2))
    shape = {"data": 8} if case == "data_mesh" else {"data": 2, "seq": 4}
    attrs = {"causal": True, "scale": -1.0}
    outs = []
    for pkg, mod, mesh in zip((mxnet_tpu, pt), (jattn, pattn), _meshes(shape)):
        before = mod.DISPATCH_COUNTS["ring"]
        with pkg.parallel.mesh.trace_mesh(mesh):
            outs.append(_op_apply(pkg, attrs, q, k, v))
        assert mod.DISPATCH_COUNTS["ring"] == before, (case, pkg.__name__)
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def _attention_gate_args(pkg):
    """The gate's inputs at a flash-admitted causal self-attention site."""
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 2, 64, 64).astype("float32") for _ in range(3))
    patterns = importlib.import_module(pkg.__name__ + ".ops.fusion_patterns")
    pat = next(p for p in patterns.get_patterns() if p.name == "attention")
    args = (tuple(torch.from_numpy(x) for x in (q, k, v)) if pkg is pt
            else tuple(jnp.asarray(x) for x in (q, k, v)))
    return pat, {"causal": True, "scale": -1.0}, args


def test_gate_declines_attention_on_a_seq_mesh_with_the_references_reason(monkeypatch):
    """On a seq mesh the port's gate declines the attention pattern with
    JAX's words (JAX's gate declines on any multi-device mesh); on a
    data-only mesh the port keeps its departure and engages it, and every
    other pattern engages on the seq mesh too."""
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "attention=1,matmul_bias_act=1")
    reasons = {}
    for pkg, mesh in zip((mxnet_tpu, pt), _meshes({"data": 2, "seq": 4})):
        pat, meta, args = _attention_gate_args(pkg)
        with pkg.parallel.mesh.trace_mesh(mesh):
            engaged, chosen, reasons[pkg] = importlib.import_module(
                pkg.__name__ + ".fusion").gate_pattern_explain(pat, meta, args)
        assert not engaged and chosen is None
    assert reasons[pt] == reasons[mxnet_tpu]
    pat, meta, args = _attention_gate_args(pt)
    _, data_mesh = _meshes({"data": 8})
    with pt.parallel.mesh.trace_mesh(data_mesh):
        engaged, chosen, reason = pt.fusion.gate_pattern_explain(pat, meta, args)
    assert engaged and chosen[0].startswith("cuda_flash"), reason
    monkeypatch.setenv("MXNET_RING_ATTENTION", "0")
    with pt.parallel.mesh.trace_mesh(_meshes({"data": 2, "seq": 4})[1]):
        assert pt.fusion.gate_pattern_explain(pat, meta, args)[0]
    monkeypatch.delenv("MXNET_RING_ATTENTION")
    mba = next(p for p in pt.ops.fusion_patterns.get_patterns() if p.name == "matmul_bias_act")
    rs = np.random.RandomState(6)
    x, w, b = (torch.from_numpy(rs.randn(*s).astype("float32")) for s in
               ((8, 16), (32, 16), (32,)))
    with pt.parallel.mesh.trace_mesh(_meshes({"data": 2, "seq": 4})[1]):
        assert pt.fusion.gate_pattern_explain(
            mba, {"act": "relu", "flatten": True, "no_bias": False}, (x, w, b))[0]


@pytest.mark.parametrize("case", ["cross_attention", "ragged_T", "ragged_batch"])
def test_gate_keeps_flash_at_a_site_the_ring_does_not_take(monkeypatch, case):
    """On a seq mesh the gate declines only the sites the op's ring takes
    (``ring_takes``): cross-attention, a T that does not divide over the
    seq axis and a batch that does not divide over the data axis keep
    ``cuda_flash``, and ``attention_trains_flash`` says the same."""
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "attention=1")
    from mxnet_tpu_torch.ops import attention as pattn

    B, T = (3 if case == "ragged_batch" else 2), (66 if case == "ragged_T" else 64)
    S = 96 if case == "cross_attention" else T
    rs = np.random.RandomState(7)
    q = torch.from_numpy(rs.randn(B, 2, T, 64).astype("float32"))
    k, v = (torch.from_numpy(rs.randn(B, 2, S, 64).astype("float32")) for _ in range(2))
    pat = next(p for p in pt.ops.fusion_patterns.get_patterns() if p.name == "attention")
    mesh = _meshes({"data": 2, "seq": 4})[1]
    with parallel.mesh.trace_mesh(mesh):
        assert pattn.ring_takes(None, q.shape, k.shape) is None
        engaged, chosen, reason = pt.fusion.gate_pattern_explain(
            pat, {"causal": True, "scale": -1.0}, (q, k, v))
        assert engaged and chosen[0] == "cuda_flash", reason
        assert pt.fusion.attention_trains_flash(q.shape, k.shape, "float32", True)
        assert pattn.ring_takes(None, (2, 2, 64, 64), (2, 2, 64, 64)) is mesh


def test_flash_predicate_memory_plan_and_explainer_agree_with_the_gate(monkeypatch):
    """``attention_trains_flash``, the memory plan's score-stash rule and
    GL303 say what the gate decides: no flash on a seq mesh (the ring keeps
    its blocks' probabilities for the backward), flash elsewhere."""
    from mxnet_tpu_torch import analysis, fusion
    from mxnet_tpu_torch.models import transformer

    monkeypatch.setenv("MXNET_FUSED_PATTERNS", "attention=1")
    seq_mesh = parallel.MeshSpec({"data": 2, "seq": 4})
    shapes = ((2, 2, 64, 64), (2, 2, 64, 64))
    assert fusion.attention_trains_flash(*shapes, "float32", True)
    with parallel.mesh.trace_mesh(seq_mesh):
        assert not fusion.attention_trains_flash(*shapes, "float32", True)
    net = transformer.get_symbol(vocab_size=32, num_layers=2, num_heads=2, model_dim=128,
                                 ffn_dim=128, seq_len=64)
    kw = dict(shapes={"data": (8, 64), "softmax_label": (8, 64)}, train=True)
    plain = analysis.lint(net, **kw)
    ringed = analysis.lint(net, mesh=seq_mesh, **kw)
    assert plain.memory_plan["attention"]["flash_elided_sites"] == 2
    assert ringed.memory_plan["attention"]["flash_elided_sites"] == 0
    assert ringed.memory_plan["attention"]["score_bytes"] > 0
    declined = [d for d in ringed.by_code("GL303") if "declined on this mesh" in d.message]
    assert len(declined) == 2 and all(fusion.MESH_REASON in d.message for d in declined)
    assert not [d for d in plain.by_code("GL303") if "declined" in d.message]
    # a T the seq axis does not divide: the ring takes no site, flash keeps them all
    ragged = transformer.get_symbol(vocab_size=32, num_layers=2, num_heads=2, model_dim=128,
                                    ffn_dim=128, seq_len=66)
    rep = analysis.lint(ragged, mesh=seq_mesh, shapes={"data": (8, 66), "softmax_label": (8, 66)},
                        train=True)
    assert rep.memory_plan["attention"]["flash_elided_sites"] == 2
    assert not [d for d in rep.by_code("GL303") if "declined" in d.message]


# --------------------------------------------------- the sequence-parallel step
EXAMPLE = dict(vocab_size=32, num_layers=2, num_heads=4, model_dim=64, ffn_dim=128)


def _assert_params_close(got, want, rtol, atol, key_bias=True):
    """Every parameter within tolerance; with ``key_bias=False`` but the
    key third of each fused qkv bias. Softmax is invariant to a key bias
    (q·b_k is the same for every key), so its gradient is zero but for
    float32 rounding, and Adam's step, which divides each gradient by its
    own root mean square, turns that noise into steps of up to ±lr."""
    assert sorted(got) == sorted(want)
    M = EXAMPLE["model_dim"]
    for n in want:
        a, b = got[n], want[n]
        if not key_bias and n.endswith("_qkv_bias"):
            a = np.concatenate([a[:M], a[2 * M:]])
            b = np.concatenate([b[:M], b[2 * M:]])
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=n)


def _copy_batches(n, batch=8, seq_len=64, vocab=32, seed=0):
    """example/long-context/ring_attention_lm.py's induction-head batches."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        half = rs.randint(2, vocab, (batch, seq_len // 2))
        seq = np.concatenate([half, half], axis=1).astype("float32")
        y = np.roll(seq, -1, axis=1)
        y[:, -1] = 1
        out.append((seq, y))
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_spmd_transformer_steps_over_data_and_seq_match_the_jax_trainer(optimizer):
    """Three ``SPMDTrainer`` steps of the example's transformer (2 layers,
    4 heads, dim 64, seq 64, batch 8) over {data: 2, seq: 4} with
    ``ShardingRules(seq_axis="seq")``: the ring dispatches at every
    attention site of every step in both packages, and the outputs match
    (rtol 2e-4, atol 2e-5, the fused step's tolerance in
    ``tests/test_torch_parallel.py``). SGD with momentum: every final
    parameter at that tolerance. Adam 3e-3 (the example's): every
    parameter within atol 1e-4 (lr/30), the key third of the qkv biases
    aside (``_assert_params_close``). Adam's step divides each gradient by
    its own root mean square, so an element whose gradient is near float32
    rounding moves by a share of lr on that rounding (measured: 7.0e-5 on
    one element of 12288 of ``layer0_qkv_weight``)."""
    from mxnet_tpu.ops import attention as jattn
    from mxnet_tpu_torch.ops import attention as pattn

    batches = _copy_batches(3)
    opt_params = ({"learning_rate": 3e-3} if optimizer == "adam"
                  else {"learning_rate": 0.01, "momentum": 0.9})
    results = []
    start = None
    for pkg, attn, mesh in zip((mxnet_tpu, pt), (jattn, pattn), _meshes({"data": 2, "seq": 4})):
        net = pkg.models.transformer.get_symbol(seq_len=64, **EXAMPLE)
        tr = pkg.parallel.SPMDTrainer(net, mesh, optimizer=optimizer,
                                      optimizer_params=opt_params,
                                      rules=pkg.parallel.ShardingRules(mesh, seq_axis="seq"))
        tr.init_params({"data": (8, 64)}, {"softmax_label": (8, 64)}, seed=0)
        if start is None:
            start = {n: np.asarray(a) for n, a in tr.get_params()[0].items()}
        else:
            tr.set_params(start, {})
        before = attn.DISPATCH_COUNTS["ring"]
        outs = [np.asarray(tr.step({"data": x}, {"softmax_label": y})[0]) for x, y in batches]
        assert attn.DISPATCH_COUNTS["ring"] - before >= EXAMPLE["num_layers"], pkg.__name__
        if pkg is pt:  # the port runs the op once a site a step
            assert attn.DISPATCH_COUNTS["ring"] - before == EXAMPLE["num_layers"] * 3
        results.append((outs, {n: np.asarray(a) for n, a in tr.get_params()[0].items()}))
    (j_outs, j_par), (p_outs, p_par) = results
    for a, b in zip(p_outs, j_outs):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    if optimizer == "sgd":
        _assert_params_close(p_par, j_par, 2e-4, 2e-5)
    else:
        _assert_params_close(p_par, j_par, 0.0, 1e-4, key_bias=False)


def test_spmd_ring_step_equals_the_dense_step_of_the_port(monkeypatch):
    """The port's ring step against its own dense step
    (``MXNET_RING_ATTENTION=0``) on the same mesh, SGD with momentum:
    outputs and every parameter after two steps (rtol 1e-4, atol 1e-5)."""
    batches = _copy_batches(2, seed=1)
    mesh = _meshes({"data": 2, "seq": 4})[1]
    runs = []
    for ring in ("1", "0"):
        monkeypatch.setenv("MXNET_RING_ATTENTION", ring)
        net = pt.models.transformer.get_symbol(seq_len=64, **EXAMPLE)
        tr = parallel.SPMDTrainer(net, mesh, optimizer="sgd",
                                  optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
                                  rules=parallel.ShardingRules(mesh, seq_axis="seq"))
        tr.init_params({"data": (8, 64)}, {"softmax_label": (8, 64)}, seed=0)
        outs = [np.asarray(tr.step({"data": x}, {"softmax_label": y})[0]) for x, y in batches]
        runs.append((outs, {n: np.asarray(a) for n, a in tr.get_params()[0].items()}))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    _assert_params_close(runs[0][1], runs[1][1], RTOL, ATOL)


def _no_dense_op(monkeypatch):
    """Make the attention op raise if it runs: a site the fused step hands
    to flash never reaches it. Returns the op's own function."""
    opdef = pt.ops.registry.get_op("_contrib_MultiHeadAttention")
    fn = opdef.fn

    def refuse(*a, **kw):
        raise AssertionError("the attention op ran (ring or dense path) at a flash site")

    monkeypatch.setattr(opdef, "fn", refuse)
    return fn


def _flash_sites(tr):
    return [d["train"] for sites in tr._sites.values() for d in sites.values()
            if d.get("kind") == "pattern" and d["pat"].name == "attention"]


def test_spmd_step_keeps_flash_at_sites_the_ring_does_not_take(monkeypatch):
    """A seq-mesh step whose T (66) does not divide over the seq axis (its
    batch rows shard over data; ``seq_axis`` rules would refuse T): the
    ring takes no site, every attention site resolves to ``cuda_flash``
    (its plain version on the CPU), the op never runs and the outputs
    equal the same step with the ring switched off (rtol 1e-5, atol
    1e-6)."""
    from mxnet_tpu_torch.ops import attention as pattn

    (x, y), = _copy_batches(1, seq_len=66, seed=2)
    mesh = _meshes({"data": 2, "seq": 4})[1]
    outs = []
    for ring in ("1", "0"):
        monkeypatch.setenv("MXNET_RING_ATTENTION", ring)
        net = pt.models.transformer.get_symbol(seq_len=66, **EXAMPLE)
        tr = parallel.SPMDTrainer(net, mesh, optimizer="sgd",
                                  optimizer_params={"learning_rate": 0.01},
                                  rules=parallel.ShardingRules(mesh))
        tr.init_params({"data": (8, 66)}, {"softmax_label": (8, 66)}, seed=0)
        with monkeypatch.context() as m:
            _no_dense_op(m)
            before = pattn.DISPATCH_COUNTS["ring"]
            outs.append(np.asarray(tr.step({"data": x}, {"softmax_label": y})[0]))
            assert pattn.DISPATCH_COUNTS["ring"] == before
        assert _flash_sites(tr) == ["cuda_flash"] * EXAMPLE["num_layers"]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_spmd_sites_follow_the_ring_switch_between_steps(monkeypatch):
    """The trainer keeps its resolved sites by the ring's state: a step
    with the ring on runs the op's ring at every site, and a later step
    with ``MXNET_RING_ATTENTION=0`` resolves its sites anew, to flash,
    and never runs the op."""
    from mxnet_tpu_torch.ops import attention as pattn

    batches = _copy_batches(2, seed=3)
    mesh = _meshes({"data": 2, "seq": 4})[1]
    net = pt.models.transformer.get_symbol(seq_len=64, **EXAMPLE)
    tr = parallel.SPMDTrainer(net, mesh, optimizer="sgd", optimizer_params={"learning_rate": 0.01},
                              rules=parallel.ShardingRules(mesh, seq_axis="seq"))
    tr.init_params({"data": (8, 64)}, {"softmax_label": (8, 64)}, seed=0)
    before = pattn.DISPATCH_COUNTS["ring"]
    tr.step({"data": batches[0][0]}, {"softmax_label": batches[0][1]})
    assert pattn.DISPATCH_COUNTS["ring"] - before == EXAMPLE["num_layers"]
    assert _flash_sites(tr) == [None] * EXAMPLE["num_layers"]
    monkeypatch.setenv("MXNET_RING_ATTENTION", "0")
    with monkeypatch.context() as m:
        _no_dense_op(m)
        out = tr.step({"data": batches[1][0]}, {"softmax_label": batches[1][1]})[0]
    assert np.isfinite(np.asarray(out)).all()
    assert pattn.DISPATCH_COUNTS["ring"] - before == EXAMPLE["num_layers"]
    assert sorted(_flash_sites(tr), key=str) == \
        [None] * EXAMPLE["num_layers"] + ["cuda_flash"] * EXAMPLE["num_layers"]


def test_a_seq_mesh_across_processes_is_allowed_and_the_trainer_still_refuses(monkeypatch):
    """``make_mesh({"seq": 2})`` under a two-rank job is one seq axis over
    the ranks; the fused step across processes keeps refusing any axis but
    data (section 1.4c); a model axis across processes still raises."""
    from mxnet_tpu_torch import dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "num_workers", lambda: 2)
    with pt.cpu():
        mesh = parallel.make_mesh({"seq": 2})
        assert mesh.process_count == 2 and mesh.shape == {"seq": 2}
        with pytest.raises(pt.MXNetError, match="section 1.4c"):
            parallel.make_mesh({"data": 1, "model": 2})
        net = pt.models.transformer.get_symbol(seq_len=8, **EXAMPLE)
        with pytest.raises(pt.MXNetError, match="a seq axis across processes.*section 1.4c"):
            parallel.SPMDTrainer(net, mesh)


# ------------------------------------------------------- the ring across ranks
WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel.ring_attention import ring_attention

tmp = sys.argv[1]
pt.dist.init()
rank, world = pt.dist.rank(), pt.dist.num_workers()
case = np.load(os.path.join(tmp, "case.npz"))
mesh = parallel.make_mesh({"seq": world})
t = case["q"].shape[1] // world
rows = slice(rank * t, (rank + 1) * t)
out = {"process_count": mesh.process_count}
for causal in (False, True):
    ts = [torch.from_numpy(np.ascontiguousarray(case[n][:, rows])).requires_grad_(True)
          for n in "qkv"]
    o = ring_attention(*ts, mesh, causal=causal)
    (o * torch.from_numpy(np.ascontiguousarray(case["w"][:, rows]))).sum().backward()
    out["o%d" % causal] = o.detach().numpy()
    for n, x in zip("qkv", ts):
        out["d%s%d" % (n, causal)] = x.grad.numpy()
try:
    ring_attention(*ts, mesh, batch_axis="data")
    out["batch_axis_raised"] = ""
except pt.MXNetError as e:
    out["batch_axis_raised"] = str(e)
np.savez(os.path.join(tmp, "out%d.npz" % rank), **out)
pt.dist.shutdown()
'''


def test_two_rank_gloo_ring_matches_jax_ring_over_two_devices(tmp_path):
    """Two gloo ranks, each with its own (B, T/2, H, D) block: k and v move
    by ``batch_isend_irecv``, the cotangents back the other way. The
    gathered outputs and q, k, v gradients of <ring, w> equal JAX's ring
    over two virtual devices (causal and not); a batch axis across
    processes raises naming section 1.4c."""
    q, k, v = _qkv(7, (2, 16, 2, 4))
    w = np.random.RandomState(8).randn(2, 16, 2, 4).astype("float32")
    np.savez(tmp_path / "case.npz", q=q, k=k, v=v, w=w)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "launch.py"), "-n", "2", "--launcher", "local",
         "--cpu-devices", "1", sys.executable, str(script), str(tmp_path)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    outs = [dict(np.load(tmp_path / ("out%d.npz" % r))) for r in range(2)]
    jmesh = mxnet_tpu.parallel.make_mesh({"seq": 2}, devices=jax.devices()[:2])
    for causal in (False, True):
        def loss(q_, k_, v_):
            return (jax_ring(q_, k_, v_, jmesh, causal=causal) * w).sum()

        want_o = np.asarray(jax_ring(q, k, v, jmesh, causal=causal))
        want_g = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        got_o = np.concatenate([o["o%d" % causal] for o in outs], axis=1)
        np.testing.assert_allclose(got_o, want_o, rtol=RTOL, atol=ATOL)
        for n, g in zip("qkv", want_g):
            got = np.concatenate([o["d%s%d" % (n, causal)] for o in outs], axis=1)
            np.testing.assert_allclose(got, np.asarray(g), rtol=RTOL, atol=ATOL,
                                       err_msg="d%s causal=%s" % (n, causal))
    for o in outs:
        assert int(o["process_count"]) == 2
        assert "section 1.4c" in str(o["batch_axis_raised"])
