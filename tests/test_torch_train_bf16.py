"""bf16 training (``SPMDTrainer(compute_dtype='bfloat16')``) held against the
JAX package.

- The conv+BN training forward's plain version (``conv_block_plain``) on
  bfloat16 operands against JAX's ``_conv_block_fwd_impl(...,
  interpret=True)`` (its Pallas kernel in interpret mode) at the 1x1 and
  3x3 cases of ``tests/test_torch_serve_bf16.py``, stride 1 and 2, with
  and without the prologue, its ReLU and the residual: c within one
  bfloat16 ulp (``bf16_ulps`` <= 1) outside the
  ReLU decisions the prologue's rounding decides (``bf16_compare``), Σc and
  Σc² within 1e-5 of the largest magnitude (float32 sums over B·H'W' in
  another order).
- The backward's plain version (``conv_block_bwd_plain``) against
  ``_conv_block_bwd_impl(..., interpret=True)`` on the same cases: dx, dw
  and dres within one bfloat16 ulp or 1e-5 of the largest magnitude (a sum
  that cancels: float32 sums in another order, then one rounding), dscale
  and dshift within 1e-5 of the largest.
- The shape gate, one predicate for both dtypes (``conv_bn.supported``),
  against JAX's ``plan_blocks(..., itemsize=2)``: equal at the gate's small
  edges and at the five ResNet-50 shapes the bf16 step's kernels are timed
  at; ``GATE_BF16_DIFFERS`` lists where they part (the TPU's VMEM budget).
- ``matmul_bias_act``'s plain version and its backward on bfloat16 operands
  against JAX's ``matmul_bias_act`` under ``jax.vjp``: y, da, dw and db
  within one bfloat16 ulp or 1e-5 of the largest magnitude.
- Two residual units of the package's ResNet trained by both packages'
  ``SPMDTrainer(compute_dtype='bfloat16')`` from the same numpy weights,
  the conv+BN fusion forced onto the kernels (``MXNET_FUSED_CONV_BN=1``,
  ``MXNET_FUSED_CONV_BN_BWD=recompute``). Against JAX's compiled step, 3
  steps: each step's loss within 1e-2; the params after 3 steps within 1e-1
  of each array's largest magnitude, 3e-1 for the arrays that start at zero
  (the BatchNorm betas and the fc bias). Those bounds are twice the
  reference's own spread: its compiled step and its op-by-op evaluation of
  the same step (``jax.disable_jit``) part by up to 4.7 % (the weight of
  the stride-2 3x3 conv, which the shape gate declines: XLA keeps its
  bf16 input's chain in excess precision when compiled) and 14.4 % (a beta)
  after 3 steps (``tools/torch_bf16_step_spread.py``). Against JAX's op-by-op
  step, one step: the outputs and every parameter bitwise equal but the fc
  bias (its bf16 gradient sum, within one ulp), the aux within 1e-6 of
  each array's largest. Master weights and aux stay float32.
- The port's copies of the JAX package's own bf16 tests
  (``tests/test_parallel.py``): ``test_bf16_compute_runs`` and
  ``test_bf16_training_converges`` (accuracy > 0.9).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu
from mxnet_tpu.ops import pallas_conv_bn as jcb
from mxnet_tpu.ops import pallas_matmul_bias_act as jmba
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.ops import conv_bn as cb
from mxnet_tpu_torch.ops import matmul_bias_act as mba

torch.set_num_threads(1)
BF16 = torch.bfloat16
FORCED = {"MXNET_FUSED_CONV_BN": "1", "MXNET_FUSED_CONV_BN_BWD": "recompute"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXNET_FUSION_TUNE_DIR", "MXNET_FUSED_PATTERNS", "MXNET_FUSED_PATTERNS_INFER",
              "MXNET_GRAPHREWRITE", "MXNET_GRAPHREWRITE_BF16", "MXNET_SERVE_QUANT",
              "MXNET_FUSED_CONV_BN", "MXNET_FUSED_CONV_BN_BWD"):
        monkeypatch.delenv(k, raising=False)


def _t(a):
    """A JAX array as a float32 torch tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _bf16_close(got, want, atol_rel=1e-5):
    """bf16 values of one function: neighbouring bfloat16 values, or within
    ``atol_rel`` of the largest |want| (a sum that cancels)."""
    g, w = got.float(), want.float()
    near = (g - w).abs() <= atol_rel * float(w.abs().max())
    far = (cb.bf16_ulps(g, w) > 1) & ~near
    assert int(far.sum()) == 0, (int(far.sum()), float((g - w).abs().max()))


def _sums_close(got, want):
    """float32 sums over B·H'W' in another order: within 1e-5 of the largest."""
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-5 * float(want.abs().max()) + 1e-30)


# (B, K, H, W, N, k, stride, prologue, relu, residual): the cases of
# tests/test_torch_serve_bf16.py, the residual added where the prologue is
CASES = [
    (2, 16, 8, 8, 24, 3, 1, True, True, True),
    (2, 8, 7, 7, 16, 3, 1, True, False, False),
    (2, 64, 14, 14, 32, 3, 1, False, False, True),
    (2, 32, 9, 9, 8, 3, 1, True, True, False),
    (2, 16, 8, 8, 32, 1, 1, True, True, True),
    (2, 64, 7, 7, 64, 1, 1, True, False, False),
    (2, 24, 14, 14, 16, 1, 1, False, False, False),
    (2, 32, 14, 14, 64, 1, 2, True, True, True),
    (2, 16, 13, 11, 24, 1, 2, False, False, False),
    (2, 8, 12, 12, 8, 1, 2, True, False, True),
]


def _case(case):
    B, K, H, W, N, k, s, pro, relu, res = case
    rs = np.random.RandomState(sum(case[:7]))
    x = rs.randn(B, K, H, W).astype(np.float32)
    w = (rs.randn(N, K, k, k) * np.sqrt(2.0 / (K * k * k))).astype(np.float32)
    sc = rs.uniform(0.5, 1.5, K).astype(np.float32) if pro else None
    sh = rs.uniform(-0.5, 0.5, K).astype(np.float32) if pro else None
    Ho, Wo = cb.strided_dims(H, W, (s, s)) if k == 1 else (H, W)
    r = rs.randn(B, N, Ho, Wo).astype(np.float32) if res else None
    dc = rs.randn(B, N, Ho, Wo).astype(np.float32)
    ds, dq = rs.randn(N).astype(np.float32), (rs.randn(N) * 0.1).astype(np.float32)
    return x, w, sc, sh, r, dc, ds, dq


def _ids(c):
    return "k%d_s%d_%dx%dx%d_K%d_N%d%s%s%s" % (
        c[5], c[6], c[0], c[2], c[3], c[1], c[4], "_pro" if c[7] else "",
        "_relu" if c[8] else "", "_res" if c[9] else "")


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _jbf16(a):
    return None if a is None else jnp.asarray(a).astype(jnp.bfloat16)


def _tb(a):
    return None if a is None else torch.from_numpy(a).to(BF16)


def _tf(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_bf16_training_forward_matches_the_pallas_kernel(case):
    k, s, relu = case[5], case[6], case[8]
    x, w, sc, sh, r, _, _, _ = _case(case)
    jc, js, jq = jcb._conv_block_fwd_impl(
        _jbf16(x), _jbf16(w), _jax(sc), _jax(sh), _jbf16(r), kernel_hw=(k, k), stride=(s, s),
        relu=relu, interpret=True)
    assert jc.dtype == jnp.bfloat16 and js.dtype == jnp.float32
    c, ssum, ssq = cb.conv_block_plain(_tb(x), _tb(w), _tf(sc), _tf(sh), _tb(r), (s, s), relu)
    assert c.dtype == BF16 and ssum.dtype == ssq.dtype == torch.float32
    cmp = cb.bf16_compare(c, _t(jc), torch.from_numpy(x), w.shape, _tf(sc), _tf(sh), (s, s),
                          relu)
    print(case, cmp)
    assert cmp["beyond"] == 0, (case, cmp)
    _sums_close(ssum, _t(js))
    _sums_close(ssq, _t(jq))
    # the dispatcher on the CPU takes the plain version
    got = cb.conv_block(_tb(x), _tb(w), _tf(sc), _tf(sh), _tb(r), (s, s), relu)
    assert all(torch.equal(a, b) for a, b in zip(got, (c, ssum, ssq)))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_bf16_backward_matches_the_pallas_kernel(case):
    k, s, relu, has_res = case[5], case[6], case[8], case[9]
    x, w, sc, sh, r, dc, ds, dq = _case(case)
    # one c for both: the JAX kernel's forward
    jc = jcb._conv_block_fwd_impl(_jbf16(x), _jbf16(w), _jax(sc), _jax(sh), _jbf16(r),
                                  kernel_hw=(k, k), stride=(s, s), relu=relu,
                                  interpret=True)[0]
    want = jcb._conv_block_bwd_impl(
        _jbf16(x), _jbf16(w), _jax(sc), _jax(sh), jc, _jbf16(dc), _jax(ds), _jax(dq), None,
        kernel_hw=(k, k), stride=(s, s), relu=relu, has_res=has_res, interpret=True)
    c = _t(jc).to(BF16)
    got = cb.conv_block_bwd(_tb(x), _tb(w), _tf(sc), _tf(sh), c, _tb(dc), _tf(ds), _tf(dq),
                            (s, s), relu, has_res)
    names = ("dx", "dw", "dscale", "dshift", "dres")
    for name, g, jw in zip(names, got, want):
        assert (g is None) == (jw is None), name
        if g is None:
            continue
        if name in ("dscale", "dshift"):
            assert g.dtype == torch.float32 and jw.dtype == jnp.float32
            _sums_close(g, _t(jw))
        else:
            assert g.dtype == BF16 and jw.dtype == jnp.bfloat16, name
            _bf16_close(g, _t(jw))


@pytest.mark.parametrize("act", mba.ACTIVATIONS)
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_plain_bf16_matmul_bias_act_and_its_backward_match_the_reference(act, bias):
    """y, da, dw and db of JAX's kernel (interpret mode) under ``jax.vjp`` on
    bfloat16 operands, against the port's ``MatmulBiasAct`` on the CPU.
    JAX's kernel takes whole tiles: M 64, N 128 (its 128-lane stripe)."""
    rs = np.random.RandomState(ord(act[0]) + bias)
    a = rs.randn(64, 96).astype(np.float32)
    w = (rs.randn(128, 96) / np.sqrt(96)).astype(np.float32)
    b = rs.randn(128).astype(np.float32) if bias else np.zeros(128, np.float32)
    dy = rs.randn(64, 128).astype(np.float32)
    y, vjp = jax.vjp(lambda a_, w_, b_: jmba.matmul_bias_act(a_, w_, b_, act),
                     _jbf16(a), _jbf16(w), _jbf16(b))
    jda, jdw, jdb = vjp(_jbf16(dy))
    assert y.dtype == jda.dtype == jdw.dtype == jdb.dtype == jnp.bfloat16
    tb = _tb(b) if bias else None
    got = mba.MatmulBiasAct.apply(_tb(a), _tb(w), tb, act, None)
    assert got.dtype == BF16
    _bf16_close(got, _t(y))
    assert torch.equal(got, mba.matmul_bias_act_plain(_tb(a), _tb(w), tb, act))
    # the backward from the reference's y: act' of a y one ulp away (tanh
    # near ±1, where 1 − y² cancels) is another number
    ctx = types.SimpleNamespace(saved_tensors=(_tb(a), _tb(w), _t(y).to(BF16)), act=act,
                                has_bias=bias, b_dtype=BF16)
    da, dw, db, _, _ = mba.MatmulBiasAct.backward(ctx, _tb(dy))
    _bf16_close(da, _t(jda))
    _bf16_close(dw, _t(jdw))
    if bias:
        assert db.dtype == BF16
        _bf16_close(db, _t(jdb))


# (x, w, stride): the gate's small edges (``tests/test_torch_conv_bn.py``'s),
# and the five ResNet-50 shapes at batch 32 of the bf16 kernels' timings
GATE_BF16 = [((2, 8, 8, 8), (16, 8, 1, 1), (1, 1)), ((2, 8, 9, 9), (16, 8, 1, 1), (2, 2)),
             ((2, 16, 8, 8), (8, 16, 3, 3), (1, 1)), ((1, 8, 3, 3), (8, 8, 1, 1), (1, 1)),
             ((2, 12, 8, 8), (16, 12, 1, 1), (1, 1)), ((2, 8, 8, 8), (16, 8, 3, 3), (2, 2)),
             ((2, 8, 2, 2), (16, 8, 3, 3), (1, 1)), ((32, 64, 56, 56), (64, 64, 3, 3), (1, 1)),
             ((32, 64, 56, 56), (256, 64, 1, 1), (1, 1)),
             ((32, 256, 56, 56), (512, 256, 1, 1), (2, 2)),
             ((32, 256, 14, 14), (256, 256, 3, 3), (1, 1)),
             ((32, 512, 7, 7), (2048, 512, 1, 1), (1, 1))]
# where they part: JAX's budget of 12 MiB of VMEM a grid instance, which
# holds whole-HW tiles of x, declines these at any channel stripe; a GPU
# block stages a chunk of K at a time, and the port's gate admits them
GATE_BF16_DIFFERS = [((32, 2048, 56, 56), (512, 2048, 1, 1), (1, 1)),
                     ((2, 512, 112, 112), (512, 512, 3, 3), (1, 1))]


@pytest.mark.parametrize("x_shape,w_shape,stride", GATE_BF16 + GATE_BF16_DIFFERS)
def test_shape_gate_against_jax_plan_blocks_at_bf16(x_shape, w_shape, stride):
    jax_takes = [jcb.plan_blocks(x_shape, w_shape, stride, itemsize=2, prologue=p, res=r)
                 is not None for p in (False, True) for r in (False, True)]
    port = cb.supported(x_shape, w_shape, stride)
    if (x_shape, w_shape, stride) in GATE_BF16_DIFFERS:
        assert port and not any(jax_takes)
    else:
        assert jax_takes == [port] * 4


# ------------------------------------------------------------ the whole step
def _units(m):
    """Two residual units of the package's ResNet (a projection unit and a
    stride-2 unit) on 16 channels, then the zoo's head: every 1x1 and 3x3
    conv a planned site the shape gate admits."""
    res, sym = m.models.resnet, m.sym
    body = res.residual_unit(sym.Variable("data"), 32, (1, 1), False, "u1")
    body = res.residual_unit(body, 32, (2, 2), False, "u2")
    bn = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
    relu = sym.Activation(data=bn, act_type="relu", name="relu")
    pool = sym.Pooling(data=relu, global_pool=True, kernel=(4, 4), pool_type="avg", name="pool")
    fc = sym.FullyConnected(data=sym.Flatten(data=pool), num_hidden=10, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _xent(prob, y):
    p = np.asarray(prob, np.float32)
    return float(-np.mean(np.log(np.maximum(p[np.arange(len(y)), y.astype(int)], 1e-12))))


def _trainer(m, mesh):
    return m.parallel.SPMDTrainer(
        _units(m), mesh, optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9}, compute_dtype="bfloat16")


def _two_trainers(monkeypatch):
    """Both packages' bf16 trainers of ``_units`` from the JAX trainer's
    initial weights, and the batch: (jax trainer, port trainer, x, y, the
    initial params)."""
    for k, v in FORCED.items():
        monkeypatch.setenv(k, v)
    rs = np.random.RandomState(0)
    x = rs.rand(4, 16, 8, 8).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.float32)
    jtr = _trainer(mxnet_tpu, mxnet_tpu.parallel.make_mesh(
        {"data": 1}, devices=jax.devices()[:1]))
    jtr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
    arg, aux = jtr.get_params()
    arg = {k: np.asarray(v) for k, v in arg.items()}
    aux = {k: np.asarray(v) for k, v in aux.items()}
    ptr = _trainer(pt, pt.parallel.make_mesh((1,), ("data",), [pt.cpu()]))
    ptr.init_params({"data": x.shape}, {"softmax_label": y.shape}, seed=3)
    ptr.set_params(arg, aux)
    return jtr, ptr, x, y, arg


def test_bf16_step_of_two_residual_units_matches_the_reference(monkeypatch):
    jtr, ptr, x, y, arg = _two_trainers(monkeypatch)
    pt.ops.reset_launch_counts()
    for step in range(3):
        jo = jtr.step({"data": x}, {"softmax_label": y})[0]
        po = ptr.step({"data": x}, {"softmax_label": y})[0]
        assert po.dtype == BF16 and jo.dtype == jnp.bfloat16
        jl, pl = _xent(_t(jo), y), _xent(po.float(), y)
        assert abs(jl - pl) <= 1e-2, (step, jl, pl)
    # the CPU runs the plain versions: no kernel launched
    assert not any(pt.ops.launch_counts().values())
    (jp, ja), (pp, pa) = jtr.get_params(), ptr.get_params()
    for k in jp:
        want = np.asarray(jp[k])
        assert pp[k].dtype == np.float32 and want.dtype == np.float32, k
        tol = 3e-1 if not np.abs(arg[k]).max() else 1e-1
        np.testing.assert_allclose(pp[k], want, rtol=0,
                                   atol=tol * float(np.abs(want).max()) + 1e-12, err_msg=k)
    for k in ja:
        want = np.asarray(ja[k])
        assert pa[k].dtype == np.float32, k
        np.testing.assert_allclose(pa[k], want, rtol=0,
                                   atol=1e-1 * float(np.abs(want).max()) + 1e-12, err_msg=k)
    # the sites: every conv+BN site planned and engaged at bfloat16
    sites = list(ptr._sites.values())[0]
    convs = [d for d in sites.values() if d["kind"] == "conv"]
    assert convs and all(d["train"][0] and d["train"][1] == "recompute" for d in convs)
    assert all("bfloat16" in d["key"] for d in convs)


def test_bf16_step_matches_the_references_op_by_op_step_bit_for_bit(monkeypatch):
    """One step of the JAX trainer with its step evaluated op by op
    (``jax.disable_jit``: every bf16 op rounds where its definition says)
    against the port's: the outputs and every parameter after the step
    bitwise equal, but the fc bias, whose gradient JAX reduces over the
    batch in bf16 in its own order (its update within one bf16 ulp of the
    gradient); the aux within 1e-6 of each array's largest (float32 sums
    in other orders)."""
    jtr, ptr, x, y, arg = _two_trainers(monkeypatch)
    with jax.disable_jit():
        jo = jtr.step({"data": x}, {"softmax_label": y})[0]
    po = ptr.step({"data": x}, {"softmax_label": y})[0]
    assert torch.equal(po.float(), _t(jo))
    (jp, ja), (pp, pa) = jtr.get_params(), ptr.get_params()
    for k in jp:
        want = np.asarray(jp[k])
        if k == "fc_bias":
            step = np.abs(want - arg[k]).max()
            np.testing.assert_allclose(pp[k], want, rtol=0, atol=2 ** -7 * step)
        else:
            np.testing.assert_array_equal(pp[k], want, err_msg=k)
    for k in ja:
        want = np.asarray(ja[k])
        np.testing.assert_allclose(pa[k], want, rtol=0, atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=k)


# ------------------------------------------- copies of the JAX package's tests
def _train_mlp(mesh_shape, steps=3, compute_dtype=None, opt="sgd"):
    """``tests/test_parallel.py``'s ``_train`` on the port: the mlp over a
    mesh of logical CPU contexts."""
    n = int(np.prod(list(mesh_shape.values())))
    mesh = pt.parallel.make_mesh(mesh_shape, devices=[pt.cpu(i) for i in range(n)])
    tr = pt.parallel.SPMDTrainer(
        pt.models.get_symbol("mlp", num_classes=10), mesh, optimizer=opt,
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, compute_dtype=compute_dtype)
    tr.init_params({"data": (8, 784)}, {"softmax_label": (8,)}, seed=7)
    rs = np.random.RandomState(0)
    x = rs.rand(8, 784).astype("float32")
    y = rs.randint(0, 10, (8,)).astype("float32")
    for _ in range(steps):
        tr.step({"data": x}, {"softmax_label": y})
    p, _ = tr.get_params()
    return p


def test_bf16_compute_runs():
    p = _train_mlp({"data": 4}, compute_dtype="bfloat16")
    for v in p.values():
        assert v.dtype == np.float32  # master weights stay fp32
        assert np.isfinite(v).all()


def test_bf16_training_converges():
    """End-to-end bf16-compute training reaches high accuracy on a
    separable toy set (``tests/test_parallel.py``'s, on the port)."""
    mesh = pt.parallel.make_mesh({"data": 1}, devices=[pt.cpu()])
    net = pt.models.get_symbol("mlp", num_classes=2)
    tr = pt.parallel.SPMDTrainer(
        net, mesh, optimizer="adam", optimizer_params={"learning_rate": 1e-3},
        compute_dtype="bfloat16")
    tr.init_params({"data": (64, 784)}, {"softmax_label": (64,)}, seed=1)
    rs = np.random.RandomState(0)
    w = rs.randn(784).astype("float32")
    x = rs.randn(512, 784).astype("float32")
    y = (x @ w > 0).astype("float32")
    for _ in range(30):
        k = rs.randint(0, 8) * 64
        tr.step({"data": x[k:k + 64]}, {"softmax_label": y[k:k + 64]})
    outs = tr.step({"data": x[:64]}, {"softmax_label": y[:64]})
    assert outs[0].dtype == BF16
    pred = outs[0].float().numpy().argmax(axis=1)
    acc = (pred == y[:64]).mean()
    assert acc > 0.9, "bf16 training under-converged: acc=%.3f" % acc


def test_bf16_mlp_step_matches_the_reference():
    """The mlp (FullyConnected → relu twice, ``matmul_bias_act``'s two sites)
    trained 3 steps in bf16 by both packages from the same weights: params
    within 2e-2 of each array's largest magnitude."""
    jtr = mxnet_tpu.parallel.SPMDTrainer(
        mxnet_tpu.models.get_symbol("mlp", num_classes=10),
        mxnet_tpu.parallel.make_mesh({"data": 1}, devices=jax.devices()[:1]), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, compute_dtype="bfloat16")
    jtr.init_params({"data": (8, 784)}, {"softmax_label": (8,)}, seed=7)
    start = {k: np.asarray(v) for k, v in jtr.get_params()[0].items()}
    rs = np.random.RandomState(0)
    x = rs.rand(8, 784).astype("float32")
    y = rs.randint(0, 10, (8,)).astype("float32")
    for _ in range(3):
        jtr.step({"data": x}, {"softmax_label": y})
    mesh = pt.parallel.make_mesh({"data": 1}, devices=[pt.cpu()])
    tr = pt.parallel.SPMDTrainer(
        pt.models.get_symbol("mlp", num_classes=10), mesh, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, compute_dtype="bfloat16")
    tr.init_params({"data": (8, 784)}, {"softmax_label": (8,)}, seed=7)
    tr.set_params(start)
    for _ in range(3):
        tr.step({"data": x}, {"softmax_label": y})
    got, want = tr.get_params()[0], jtr.get_params()[0]
    for k in want:
        w_ = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w_, rtol=0, atol=2e-2 * float(np.abs(w_).max()),
                                   err_msg=k)
