"""The port's graph layer against the JAX package: the transformer's serving
graphs give the same Symbol JSON and the same inferred shapes, and after the
bind-time rewrite the port's fusion plan roots the same pattern sites as the
JAX plan in the forced serving setting (MXNET_GRAPHREWRITE=on with the
attention/matmul_bias_act/norm_residual lowerings forced for inference)."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu import fusion as jfusion
from mxnet_tpu import name as jname
from mxnet_tpu.analysis.rewrite import rewrite_for_bind as jrewrite_for_bind
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch import fusion as pfusion
from mxnet_tpu_torch.analysis import rewrite_for_bind
from mxnet_tpu_torch.models import transformer as ptf

torch.set_num_threads(1)

CFG = dict(vocab_size=256, num_layers=2, num_heads=2, model_dim=128, ffn_dim=256)
L = CFG["num_layers"]
FORCED_INFER = "attention=pallas_flash,matmul_bias_act=pallas,norm_residual=pallas"


def _decode_shapes(B=8, S=32, per_stream=False, pool=False):
    """The decode graph's input shapes: the per-lane ring, per-stream slot
    rows over it, or per-stream rows over one shared pool of S slots."""
    row = (B, S) if per_stream or pool else (S,)
    shapes = {"data": (B, 1), "pos_idx": (B, 1), "slot_onehot": row, "kv_mask": row}
    for i in range(L):
        shapes["kv_k_%d" % i] = shapes["kv_v_%d" % i] = (2, S, 64) if pool else (B, 2, S, 64)
    return shapes


def _chunk_shapes(T=4, S=64):
    shapes = {"data": (1, T), "pos_idx": (1, T), "write_onehot": (T, S), "att_mask": (T, S)}
    for i in range(L):
        shapes["kv_k_%d" % i] = shapes["kv_v_%d" % i] = (2, S, 64)
    return shapes


GRAPHS = {
    "prefill": ("get_prefill_symbol", dict(prefill_len=16, pos_len=32), {"data": (8, 16)}),
    "decode": ("get_decode_symbol", dict(max_len=32, pos_len=32), _decode_shapes()),
    "decode_per_stream": ("get_decode_symbol", dict(max_len=32, pos_len=32, per_stream_slots=True),
                          _decode_shapes(per_stream=True)),
    "decode_global": ("get_decode_symbol", dict(max_len=64, pos_len=32, per_stream_slots=True,
                                                global_slots=True),
                      _decode_shapes(S=64, pool=True)),
    "chunk": ("get_chunk_symbol", dict(chunk_len=4, total_slots=64, pos_len=32), _chunk_shapes()),
    "train": ("get_symbol", dict(seq_len=16), {"data": (8, 16), "softmax_label": (8, 16)}),
}


def _both(which):
    fn, kw, shapes = GRAPHS[which]
    with jname.NameManager():
        js = getattr(jtf, fn)(**CFG, **kw)
    with pt.NameManager():
        ps = getattr(ptf, fn)(**CFG, **kw)
    return js, ps, shapes


@pytest.mark.parametrize("which", sorted(GRAPHS))
def test_symbol_json_identical(which):
    js, ps, _ = _both(which)
    assert ps.tojson() == js.tojson()
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_outputs() == js.list_outputs()


@pytest.mark.parametrize("which", sorted(GRAPHS))
def test_infer_shape_agrees(which):
    js, ps, shapes = _both(which)
    j_args, j_outs, _ = js.infer_shape(**shapes)
    p_args, p_outs, _ = ps.infer_shape(**shapes)
    assert [tuple(s) for s in p_args] == [tuple(s) for s in j_args]
    assert [tuple(s) for s in p_outs] == [tuple(s) for s in j_outs]


def test_load_json_round_trips_the_reference_graph():
    js, _, _ = _both("prefill")
    text = js.tojson()
    assert pt.symbol.load_json(text).tojson() == text


@pytest.mark.parametrize("which,expected", [
    ("prefill", {"attention": L, "matmul_bias_act": L, "norm_residual": 2 * L + 1}),
    ("decode", {"matmul_bias_act": L, "norm_residual": 2 * L + 1}),
    ("decode_global", {"matmul_bias_act": L, "norm_residual": 2 * L + 1}),
    ("chunk", {"matmul_bias_act": L, "norm_residual": 2 * L + 1}),
])
def test_fusion_plan_sites_match_the_reference(which, expected, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHREWRITE", "on")
    monkeypatch.setenv("MXNET_FUSED_PATTERNS_INFER", FORCED_INFER)
    monkeypatch.delenv("MXNET_FUSED_PATTERNS", raising=False)
    js, ps, shapes = _both(which)
    types = {n: np.dtype("float32") for n in shapes}
    jr = jrewrite_for_bind(js, shapes, types)[0]
    jsites = jfusion.plan_sites(jfusion.plan(jr._topo(), output_ids={id(n) for n, _ in jr._outputs}))[0]
    pr = rewrite_for_bind(ps, shapes, types)[0]
    psites = pfusion.plan_sites(pfusion.plan(pr._topo(), output_ids={id(n) for n, _ in pr._outputs}))[0]
    names = ("attention", "matmul_bias_act", "norm_residual")
    assert {k: v for k, v in jsites.items() if k in names} == expected
    assert psites == jsites


def test_layer_norm_needs_the_rewrite_to_match():
    """The zoo's LayerNorm is naive on purpose: before cse+canonicalize no
    norm_residual site roots; after, every one does."""
    _, ps, shapes = _both("prefill")
    raw = pfusion.plan_sites(pfusion.plan(ps._topo(), output_ids={id(n) for n, _ in ps._outputs}))[0]
    assert raw.get("norm_residual", 0) == 0
    pr = rewrite_for_bind(ps, shapes, {n: np.dtype("float32") for n in shapes})[0]
    assert len(pr._topo()) < len(ps._topo())
    assert pr.list_arguments() == ps.list_arguments()


def test_executor_forward_matches_unfused_ops():
    """The fused plan (kernels' plain versions on the CPU) gives the
    prefill graph's values, within f32 rounding of the unfused ops."""
    _, ps, shapes = _both("prefill")
    exe = ps.simple_bind(pt.cpu(), **shapes)
    rs = np.random.RandomState(4)
    for name, arr in exe.arg_dict.items():
        if name == "data":
            arr[:] = rs.randint(0, CFG["vocab_size"], arr.shape).astype(np.float32)
        else:
            arr[:] = (rs.randn(*arr.shape) * 0.1).astype(np.float32)
    fused = [o.asnumpy() for o in exe.forward()]
    prog = pt.executor._GraphProgram(ps)  # the original graph, nothing matches
    assert not prog.pattern_sites.get("norm_residual")
    vals = tuple(exe.arg_dict[n]._tensor() for n in prog.arg_names)
    with torch.no_grad():
        plain, _ = prog.interpret(vals, (), False, None, prog.sites_of(vals, ()))
    for f, p in zip(fused, plain):
        np.testing.assert_allclose(f, p.numpy(), atol=1e-5, rtol=1e-5)


def _wide_site(which):
    """A graph whose one fusion site has shapes its kernel does not take:
    head width 160 (flash takes D <= 128) or rows of 1100 (LayerNorm takes
    D <= 1024)."""
    if which == "attention":
        q, k, v = (pt.sym.Variable(n) for n in "qkv")
        return (pt.sym.MultiHeadAttention(query=q, key=k, value=v, causal=True),
                {n: (1, 2, 8, 160) for n in "qkv"})
    return ptf._layer_norm(pt.sym.Variable("x"), "ln", 1100), {"x": (4, 1100)}


@pytest.mark.parametrize("which", ["attention", "norm_residual"])
def test_cpu_site_the_kernel_does_not_take_runs_unfused(which):
    """On the CPU such a site runs the op's own semantics; on CUDA it raises
    (tests/test_torch_cuda.py)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import norm_residual as nr

    net, shapes = _wide_site(which)
    exe = net.simple_bind(pt.cpu(), **shapes)
    assert exe._prog.pattern_sites == {which: 1}
    rs = np.random.RandomState(5)
    for arr in exe.arg_dict.values():
        arr[:] = rs.randn(*arr.shape).astype(np.float32)
    got = exe.forward()[0].asnumpy()
    a = {n: torch.from_numpy(v.asnumpy()) for n, v in exe.arg_dict.items()}
    if which == "attention":
        want, _ = fa.flash_attention_plain(*(a[n].reshape(2, 8, 160) for n in "qkv"), causal=True)
        want = want.reshape(1, 2, 8, 160)
    else:
        want, _, _ = nr.layer_norm_affine_plain(a["x"], a["ln_gamma"], a["ln_beta"])
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)
