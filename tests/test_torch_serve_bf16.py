"""bf16 serving (``MXNET_SERVE_QUANT=bf16``) held against the JAX package.

- ``conv_block_infer_plain`` on bfloat16 operands against JAX's
  ``conv_block_infer`` (its Pallas kernel in interpret mode) at narrow
  widths: 1x1 and 3x3, stride 1 and 2, with and without a prologue and a
  ReLU. Every element outside the ReLU decisions the prologue's rounding
  decides (counted, ``bf16_compare``) is within one bfloat16 ulp:
  neighbouring bfloat16 values (``bf16_ulps`` <= 1; 2^-8·|ref| is one ulp at
  the top of a binade and half of one at its bottom) or within 1e-6 of the
  largest |ref|; each case prints the share that is bitwise equal (all but
  a few elements: the JAX kernel adds its 3x3 taps' products tap by tap,
  the plain version in one convolution).
- The small conv+BN net of the reference's ``tests/test_serving.py``
  (``_infer_forward``) and two residual units of the package's ResNet (one
  site the gate declines: 12 input channels), served under
  ``MXNET_SERVE_QUANT=bf16`` by both packages with the conv+BN plan forced
  (``MXNET_FUSED_CONV_BN=1``: JAX runs its Pallas kernel, the port its
  kernel's plain version): within 1e-2 of each other, both within the
  reference's 0.05 of the float32 output and away from it, and the gate's
  ``fusion.infer_engaged``/``infer_fallback`` counts equal.
- The other bf16 routes: ``MXNET_GRAPHREWRITE_BF16=1``'s cast sandwich (the
  conv site gets bfloat16 operands and no prologue, in both packages, and
  the port hands them to the bf16 form of ``conv_block_infer``; a cast that
  reaches a float32-only kernel, a backward of the transformer's or
  ``matmul_stats``, is refused naming ROADMAP.md section 2b),
  ``PersistentExecutableCache(dtype="bfloat16")`` and ``Predictor`` under
  ``MXNET_SERVE_QUANT=bf16``.
- What stays refused: a float16 ``compute_dtype`` and bfloat16 operands of
  the kernels without a bf16 form (bf16 training itself is
  ``tests/test_torch_train_bf16.py``'s).
"""
import contextlib
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu
import mxnet_tpu.fusion
from mxnet_tpu.ops import pallas_conv_bn as jcb
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.fusion
from mxnet_tpu_torch.ops import conv_bn as cb
from mxnet_tpu_torch.ops import cuda_build


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXNET_FUSION_TUNE_DIR", "MXNET_FUSED_PATTERNS", "MXNET_FUSED_PATTERNS_INFER",
              "MXNET_GRAPHREWRITE", "MXNET_GRAPHREWRITE_BF16", "MXNET_SERVE_QUANT",
              "MXNET_FUSED_CONV_BN"):
        monkeypatch.delenv(k, raising=False)


# (B, K, H, W, N, k, stride, prologue, relu)
CASES = [
    (2, 16, 8, 8, 24, 3, 1, True, True),
    (2, 8, 7, 7, 16, 3, 1, True, False),
    (2, 64, 14, 14, 32, 3, 1, False, False),
    (2, 32, 9, 9, 8, 3, 1, True, True),
    (2, 16, 8, 8, 32, 1, 1, True, True),
    (2, 64, 7, 7, 64, 1, 1, True, False),
    (2, 24, 14, 14, 16, 1, 1, False, False),
    (2, 32, 14, 14, 64, 1, 2, True, True),
    (2, 16, 13, 11, 24, 1, 2, False, False),
    (2, 8, 12, 12, 8, 1, 2, True, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "k%d_s%d_%dx%dx%d_K%d_N%d%s%s" % (
    c[5], c[6], c[0], c[2], c[3], c[1], c[4], "_pro" if c[7] else "", "_relu" if c[8] else ""))
def test_plain_bf16_forward_matches_the_pallas_kernel(case):
    B, K, H, W, N, k, s, pro, relu = case
    rs = np.random.RandomState(sum(case[:7]))
    x = rs.randn(B, K, H, W).astype(np.float32)
    w = (rs.randn(N, K, k, k) * np.sqrt(2.0 / (K * k * k))).astype(np.float32)
    sc = rs.uniform(0.5, 1.5, K).astype(np.float32) if pro else None
    sh = rs.uniform(-0.5, 0.5, K).astype(np.float32) if pro else None
    want = jcb.conv_block_infer(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
        None if sc is None else jnp.asarray(sc), None if sh is None else jnp.asarray(sh),
        (k, k), (s, s), relu)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tsc = None if sc is None else torch.from_numpy(sc)
    tsh = None if sh is None else torch.from_numpy(sh)
    got = cb.conv_block_infer_plain(tx.bfloat16(), tw.bfloat16(), tsc, tsh, (s, s), relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    cmp = cb.bf16_compare(got, want, tx, tw.shape, tsc, tsh, (s, s), relu)
    print(case, cmp)
    assert cmp["beyond"] == 0, (case, cmp)
    # the dispatcher on the CPU: bfloat16 operands, and compute="bfloat16"
    # on float32 ones (the casts the serving path fuses into the kernel)
    assert torch.equal(cb.conv_block_infer(tx.bfloat16(), tw.bfloat16(), tsc, tsh, (s, s), relu),
                       got)
    fused = cb.conv_block_infer(tx, tw, tsc, tsh, (s, s), relu, compute="bfloat16")
    assert fused.dtype == torch.float32 and torch.equal(fused, got.float())


def test_one_rounding_after_the_add_is_not_the_references_prologue():
    """The plain version's two roundings are a choice the reference's
    output makes: one rounding after the add moves elements by more than a
    bfloat16 ulp at the same seeded 3x3 site."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 8, 8).astype(np.float32)
    w = (rs.randn(16, 16, 3, 3) * 0.2).astype(np.float32)
    sc, sh = rs.uniform(0.5, 1.5, 16).astype(np.float32), rs.uniform(-.5, .5, 16).astype(np.float32)
    want = jcb.conv_block_infer(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(sc),
                                jnp.asarray(sh), (3, 3), (1, 1), True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    b = (1, -1, 1, 1)
    xb = torch.from_numpy(x).bfloat16().float()
    one = torch.relu((xb * torch.from_numpy(sc).bfloat16().float().reshape(b)
                      + torch.from_numpy(sh).bfloat16().float().reshape(b)).bfloat16())
    c = torch.nn.functional.conv2d(one.float(), torch.from_numpy(w).bfloat16().float(),
                                   padding=1).bfloat16()
    assert int((cb.bf16_ulps(c, want) > 1).sum()) > 0
    two = cb.conv_block_infer_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                                    torch.from_numpy(sc), torch.from_numpy(sh), (1, 1), True)
    assert torch.equal(two.float(), want)


def test_bf16_ulps_counts_steps_across_binades_and_zero():
    v = torch.tensor([1.0, 1.0, -1.0, 0.0, 1e-40], dtype=torch.float32)
    nxt = torch.tensor([1.0078125, 0.99609375, -1.0078125, -0.0, -1e-40], dtype=torch.float32)
    assert cb.bf16_ulps(v, nxt).tolist()[:4] == [1, 1, 1, 0]
    assert int(cb.bf16_ulps(torch.tensor([2.0]), torch.tensor([1.0]))) == 128


# ---------------------------------------------------------------- the nets
def _small_net(m):
    """The reference's ``tests/test_serving.py`` ``_conv_bn_net``."""
    s = m.sym.Variable("data")
    s = m.sym.BatchNorm(s, name="bn0", fix_gamma=False)
    s = m.sym.Activation(s, act_type="relu")
    s = m.sym.Convolution(s, kernel=(3, 3), pad=(1, 1), num_filter=8, no_bias=True, name="conv1")
    s = m.sym.BatchNorm(s, name="bn1", fix_gamma=False)
    s = m.sym.Activation(s, act_type="relu")
    s = m.sym.Flatten(s)
    s = m.sym.FullyConnected(s, num_hidden=4, name="fc")
    return m.sym.SoftmaxOutput(s, name="softmax")


def _resnet_units(m):
    """A projection unit and a stride-2 unit of the package's ResNet, then
    the zoo's head; on 12 input channels, which the shape gate declines at
    the first unit's 3x3 conv (K % 8 != 0)."""
    res, sym = m.models.resnet, m.sym
    body = res.residual_unit(sym.Variable("data"), 32, (1, 1), False, "u1")
    body = res.residual_unit(body, 32, (2, 2), False, "u2")
    bn = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
    relu = sym.Activation(data=bn, act_type="relu", name="relu")
    pool = sym.Pooling(data=relu, global_pool=True, kernel=(4, 4), pool_type="avg", name="pool")
    fc = sym.FullyConnected(data=sym.Flatten(data=pool), num_hidden=10, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")


NETS = {"small": (_small_net, (2, 8, 8, 8)), "resnet_units": (_resnet_units, (2, 12, 8, 8))}


def _fill(exe, seed):
    """The reference's ``_infer_forward`` values: per-param seeds, moving
    stats near (0, 1), the images from ``seed``."""
    for i, k in enumerate(sorted(exe.arg_dict)):
        arr = exe.arg_dict[k]
        if k == "data":
            continue
        rs = np.random.RandomState(100 + i)
        v = rs.randn(*arr.shape) * 0.3 + (1.0 if "gamma" in k else 0.0)
        arr[:] = (np.zeros(arr.shape) if k == "softmax_label" else v).astype("float32")
    for k in sorted(exe.aux_dict):
        arr = exe.aux_dict[k]
        arr[:] = (np.full(arr.shape, 0.1, "float32") if "mean" in k
                  else np.ones(arr.shape, "float32"))
    shape = exe.arg_dict["data"].shape
    exe.arg_dict["data"][:] = np.random.RandomState(seed).rand(*shape).astype("float32")


def _serve(m, net, env, monkeypatch, seed=7):
    """One inference forward of NETS[net] under ``env``: (probabilities,
    the telemetry counters the bind and forward added, the executor)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    build, shape = NETS[net]
    tm = m.telemetry
    saved = tm.current_override()
    tm.set_mode("counters")
    tm.reset()
    try:
        with pt.cpu() if m is pt else contextlib.nullcontext():
            exe = build(m).simple_bind(m.cpu(), grad_req="null", data=shape)
            _fill(exe, seed)
            exe.forward(is_train=False)
            out = exe.outputs[0].asnumpy()
        counts = {k: v for k, v in tm.counters().items() if k.startswith("fusion.infer_")}
    finally:
        tm.set_mode(saved)
        tm.reset()
    for k in env:
        monkeypatch.delenv(k)
    return out, counts, exe


@pytest.mark.parametrize("net", sorted(NETS))
def test_serve_quant_bf16_matches_the_reference(net, monkeypatch):
    base, _, _ = _serve(mxnet_tpu, net, {"MXNET_FUSED_CONV_BN": "0"}, monkeypatch)
    env = {"MXNET_FUSED_CONV_BN": "1", "MXNET_SERVE_QUANT": "bf16"}
    want, jcounts, _ = _serve(mxnet_tpu, net, env, monkeypatch)
    got, pcounts, exe = _serve(pt, net, env, monkeypatch)
    assert np.abs(got - want).max() < 1e-2
    for q in (got, want):
        assert 0 < np.abs(q - base).max() < 0.05
    assert pcounts == jcounts and pcounts.get("fusion.infer_engaged", 0) > 0
    sites = [d for d in exe._sites.values() if d["kind"] == "conv"]
    assert all(d["quant"] == "bf16" for d in sites)
    assert sum(bool(d["infer"]) for d in sites) == pcounts["fusion.infer_engaged"]
    assert sum(not d["infer"] for d in sites) == pcounts.get("fusion.infer_fallback", 0)
    if net == "resnet_units":
        assert pcounts.get("fusion.infer_fallback", 0) > 0
        assert all(d["infer_key"].startswith("conv_bn|") and "bfloat16" in d["infer_key"]
                   for d in sites if d["infer_key"])


def test_serve_quant_bf16_sites_call_the_bf16_form(monkeypatch):
    """Every engaged site hands float32 x and w to ``conv_block_infer`` with
    ``compute="bfloat16"`` (the kernel's fused casts), every declined site
    runs the library's bfloat16 conv, and the result is the reference's
    with the engaged sites' kernel in its place."""
    seen = []
    real = cb.conv_block_infer

    def spy(x, w, *a, **kw):
        seen.append((x.dtype, w.dtype, kw.get("compute")))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(cb, "conv_block_infer", spy)
    _, counts, exe = _serve(pt, "resnet_units", {"MXNET_SERVE_QUANT": "bf16"}, monkeypatch)
    assert seen and set(seen) == {(torch.float32, torch.float32, "bfloat16")}
    assert len(seen) == counts["fusion.infer_engaged"]


def _graphrewrite_env(extra=None):
    env = {"MXNET_GRAPHREWRITE": "on", "MXNET_GRAPHREWRITE_BF16": "1",
           "MXNET_FUSED_CONV_BN": "1"}
    env.update(extra or {})
    return env


def test_graphrewrite_bf16_casts_reach_the_bf16_form(monkeypatch):
    """``MXNET_GRAPHREWRITE_BF16=1``: the cast sandwich hands the conv site
    bfloat16 x and w with no BN prologue to fold (a Cast stands between),
    and both packages engage it at inference; the port runs the bf16 form
    of ``conv_block_infer`` on those operands (on the card, the bf16
    kernel)."""
    seen = []
    real = cb.conv_block_infer

    def spy(x, w, scale, shift, *a, **kw):
        seen.append((x.dtype, w.dtype, scale is None, kw.get("compute")))
        return real(x, w, scale, shift, *a, **kw)

    want, jcounts, _ = _serve(mxnet_tpu, "small", _graphrewrite_env(), monkeypatch)
    monkeypatch.setattr(cb, "conv_block_infer", spy)
    got, pcounts, _ = _serve(pt, "small", _graphrewrite_env(), monkeypatch)
    assert pcounts == jcounts == {"fusion.infer_engaged": 1}
    assert seen == [(torch.bfloat16, torch.bfloat16, True, None)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_graphrewrite_bf16_cast_into_a_float32_kernel_is_refused_naming_section_2b():
    """No kernel is float32-only any more: a cast that reaches any of them
    (``matmul_stats`` since its bf16 form, the conv+BN kernels,
    ``matmul_bias_act`` and the flash-attention and LayerNorm kernels,
    forward and backward) passes the dtype check and goes on to the device
    check; only a dtype no form takes (float16) is refused, before any
    launch. The dispatchers run on ``meta`` tensors, which take the CUDA
    path's checks and launch nothing."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.ops import norm_residual as nr

    meta = dict(dtype=torch.bfloat16, device="meta")
    q, x, g = torch.empty(2, 8, 16, **meta), torch.empty(4, 16, **meta), torch.empty(16, **meta)
    lse, stat = torch.empty(2, 8, device="meta"), torch.empty(4, device="meta")
    for call in (lambda: fa.flash_attention(q, q, q, causal=True),
                 lambda: nr.layer_norm_affine(x, g, g),
                 lambda: fa.flash_attention_bwd(q, q, q, q, lse, q, causal=True),
                 lambda: nr.layer_norm_affine_bwd(x, g, stat, stat, x),
                 lambda: ms.matmul_with_stats(x, torch.empty(16, 8, **meta))):
        with pytest.raises(pt.MXNetError, match="one CUDA device"):
            call()
    half = torch.empty(4, 16, dtype=torch.float16, device="meta")
    with pytest.raises(pt.MXNetError, match="takes float32 or bfloat16, got torch.float16"):
        ms.matmul_with_stats(half, torch.empty(16, 8, dtype=torch.float16, device="meta"))
    t = torch.zeros(8, 8, dtype=torch.bfloat16)
    for what in ("matmul_bias_act", "conv_block", "conv_block_bwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "layer_norm_affine_bwd"):
        with pytest.raises(pt.MXNetError, match="one CUDA device"):
            cuda_build.check_operands(what, t, dtypes=(torch.bfloat16,))
    with pytest.raises(pt.MXNetError, match="one CUDA device"):
        cuda_build.check_operands("matmul_with_stats", t, dtypes=ms.DTYPES)
    with pytest.raises(pt.MXNetError, match="one CUDA device"):
        cuda_build.check_operands("conv_block_infer", t, dtypes=(torch.float32, torch.bfloat16))


def test_persistent_cache_serves_bfloat16_inputs_like_the_reference():
    """``PersistentExecutableCache(dtype="bfloat16")``: the reference serves
    the small net with bfloat16 input slots (the images round to bfloat16,
    the params stay float32, each op computes in the promoted dtype), and
    so does the port, its planned conv included."""
    from mxnet_tpu.serving import PersistentExecutableCache as JaxCache
    from mxnet_tpu_torch.serving import PersistentExecutableCache as PortCache

    net = _small_net(pt)
    shapes = net.infer_shape(data=(2, 8, 8, 8))
    rs = np.random.RandomState(0)
    args = {k: (rs.randn(*s) * 0.3).astype("float32")
            for k, s in zip(net.list_arguments(), shapes[0]) if k not in ("data", "softmax_label")}
    aux = {k: (np.ones(s, "float32") if "var" in k else np.full(s, 0.1, "float32"))
           for k, s in zip(net.list_auxiliary_states(), shapes[2])}
    x = rs.rand(2, 8, 8, 8).astype("float32")
    outs = []
    for cls, m in ((JaxCache, mxnet_tpu), (PortCache, pt)):
        per_dtype = []
        for dtype in ("float32", "bfloat16"):
            c = cls(_small_net(m), args, aux, m.cpu(), dtype)
            assert c.warmup([{"data": (2, 8, 8, 8), "softmax_label": (2,)}]) == 1
            per_dtype.append(c.run({"data": x, "softmax_label": np.zeros(2, "float32")})[0])
        outs.append(per_dtype)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-6)
    assert np.abs(outs[1][1] - outs[1][0]).max() > 0  # the inputs were rounded


def test_predictor_carries_serve_quant_bf16(monkeypatch):
    """``Predictor`` binds through the serving cache, so it reads
    ``MXNET_SERVE_QUANT`` at its bind as a direct bind does, in both
    packages."""
    outs = {}
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", "1")
    monkeypatch.setenv("MXNET_SERVE_QUANT", "bf16")
    for m in (mxnet_tpu, pt):
        with pt.cpu() if m is pt else contextlib.nullcontext():
            net = _small_net(m)
            exe = net.simple_bind(m.cpu(), grad_req="null", data=(2, 8, 8, 8))
            _fill(exe, 7)
            exe.forward(is_train=False)
            direct = exe.outputs[0].asnumpy()
            params = {"arg:" + k: v for k, v in exe.arg_dict.items()
                      if k not in ("data", "softmax_label")}
            params.update({"aux:" + k: v for k, v in exe.aux_dict.items()})
            blob = _params_bytes(m, params)
            pred = m.predictor.Predictor(net.tojson(), blob, {"data": (2, 8, 8, 8)},
                                         **({"ctx": pt.cpu()} if m is pt else {}))
            pred.forward(data=exe.arg_dict["data"].asnumpy())
            outs[m.__name__] = pred.get_output(0)
            np.testing.assert_allclose(outs[m.__name__], direct, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(outs["mxnet_tpu_torch"], outs["mxnet_tpu"], rtol=0, atol=1e-2)


def _params_bytes(m, params):
    """A ``.params`` blob of {"arg:"/"aux:" name: NDArray}, as ``nd.save`` writes it."""
    fd, path = tempfile.mkstemp(suffix=".params")
    os.close(fd)
    try:
        m.nd.save(path, params)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.remove(path)


# ------------------------------------------------------ what stays float32
def test_bf16_training_stays_refused_naming_the_bf16_training_step():
    """What stays refused now that the bf16 training step trains
    (``tests/test_torch_train_bf16.py``): a float16 ``compute_dtype``,
    naming the bf16 training step; a bfloat16 operand where a kernel takes
    float32 (the float32 form's check); a bfloat16 x beside a float32 w in
    the inference forward."""
    mesh = pt.parallel.make_mesh((1,), ("data",), [pt.cpu()])
    with pytest.raises(pt.MXNetError, match="bf16 training step of ROADMAP.md section 2b"):
        pt.parallel.SPMDTrainer(_small_net(pt), mesh, compute_dtype="float16")
    x = torch.zeros(2, 8, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(pt.MXNetError, match="takes float32, got torch.bfloat16"):
        cuda_build.check_operands("conv_block", x)
    with pytest.raises(pt.MXNetError, match="computes in one dtype"):
        cb.conv_block_infer(x, torch.zeros(8, 8, 1, 1), None, None)


def test_bf16_inference_verdict_is_keyed_by_bfloat16(tmp_path, monkeypatch):
    """Under ``MXNET_FUSION_TUNE_DIR`` the bf16 inference gate reads a
    verdict keyed by the bfloat16 dtype: its forward-only contest between
    the library's bfloat16 conv and the stats-free kernel's bf16 form
    (``cuda:bf16``), beside the bf16 training contest of the same site
    (``cuda:xla``, ``cuda:recompute``, ``cuda:stash``, fwd+bwd) in the one bfloat16 entry;
    the float32 verdict of the same site is its own entry, and a later
    float32 bind reads it and measures nothing."""
    import json

    from mxnet_tpu_torch import fusion_tune

    monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_FUSION_TUNE_ITERS", "1")
    fusion_tune.reset()
    try:
        _, _, exe = _serve(pt, "small", {"MXNET_SERVE_QUANT": "bf16"}, monkeypatch)
        [site] = [d for d in exe._sites.values() if d["kind"] == "conv"]
        assert "bfloat16" in site["infer_key"] and "float32" in site["key"]
        with pt.cpu():
            path = fusion_tune.cache_path()
        entries = json.load(open(path))["entries"]
        bf16 = entries[site["infer_key"]]
        assert set(bf16["measured"]) == {"cuda:bf16", "cuda:xla", "cuda:recompute",
                                         "cuda:stash"}
        assert bf16["train"] and "engage" in bf16 and "engage_fwd" in bf16
        assert "cuda:xla" in entries[site["key"]]["measured"]
        fusion_tune.reset()

        def measured(*a, **kw):
            raise AssertionError("a float32 rebind measured %s" % (a,))

        monkeypatch.setattr(pt.fusion, "_conv_bn_measure", measured)
        _serve(pt, "small", {}, monkeypatch)
        assert json.load(open(path))["entries"] == entries
    finally:
        fusion_tune.reset()


@pytest.mark.parametrize("net", sorted(NETS))
def test_traced_conv_notes_match_the_reference(net, monkeypatch):
    """Under tracing each planned conv leaves one ``fusion.conv`` event with
    the inference decision and its predicate: ``engaged (inference,
    quant=bf16)`` word for word in both packages, or the shape gate's
    reason (the port's words name its kernels' gate where the reference
    names its VMEM budget; both end ``(supported() declined)``)."""
    notes = []
    env = {"MXNET_FUSED_CONV_BN": "1", "MXNET_SERVE_QUANT": "bf16"}
    for m in (mxnet_tpu, pt):
        tm = m.telemetry
        saved = tm.current_override()
        tm.set_mode("trace")
        tm.clear_events()
        try:
            with pt.cpu() if m is pt else contextlib.nullcontext():
                for k, v in env.items():
                    monkeypatch.setenv(k, v)
                build, shape = NETS[net]
                exe = build(m).simple_bind(m.cpu(), grad_req="null", data=shape)
                _fill(exe, 7)
                exe.forward(is_train=False)
            notes.append(sorted(
                (a["op"], tuple(a["shape"]), bool(a["engaged"]),
                 a["reason"] if a["engaged"] else a["reason"].rpartition(" (")[2])
                for name, _, _, _, a in tm.drain_events() if name == "fusion.conv"))
        finally:
            tm.set_mode(saved)
            tm.clear_events()
    assert notes[0] and notes[1] == notes[0]
    assert {r for *_, r in notes[1]} <= {"engaged (inference, quant=bf16)",
                                        "supported() declined)"}
