"""The rest of the zoo in the port against the JAX package: ``models.get_symbol``
over every ``_ZOO`` name, the conv+BN plans of the Inception nets, and bound
networks' outputs, gradients and BatchNorm aux updates; Dropout in the
executor.

Symbol JSON, argument and aux names and inferred shapes are compared at the
published sizes (Inception-v3 at 299 x 299 and 1000 classes has 23 834 568
parameters). The planners' conv+BN sites are compared with the JAX package
under ``MXNET_FUSED_CONV_BN=1``, as ``test_torch_resnet.py`` compares
ResNet's. Numerical parity runs at reduced sizes, each named in ``NETS``,
``BLOCKS`` or ``WHOLE``: Inception-v3 at 75 x 75 (the smallest image its stem
and grid reductions take to a 1 x 1 grid before the global pool),
Inception-BN at 96 x 96, AlexNet at 67 x 67 (its three max pools leave 1 x 1), VGG-16 at 32 x 32, all
at their published channel widths and batch 2; the MT Transformer at
``tests/test_models.py``'s size and with ``tgt_len`` != ``src_len``; the
fused-RNN LSTM LM narrowed. A whole Inception net's training step at batch
2 is chaotic: BatchNorm's batch statistics over a few positions amplify
float32 rounding, so a change of 1e-6 in the images moves the JAX package's
own gradients of Inception-v3 at 107 x 107 by percents, and the port's
float32 run and JAX's each land that far from the port's float64 run. So a
whole net is held to JAX's inference forward, and the training step
(outputs, every gradient, the moving stats) runs on each Inception module
type once (``BLOCKS``), built by the package's own function at its published
channel widths. The JAX side runs its default lowering (XLA),
which is the reference's math; the kernels' plain versions the port runs on
the CPU are held against the Pallas kernels in ``test_torch_conv_bn.py``,
``test_torch_kernels.py`` and ``test_torch_train_kernels.py``. Dropout's
masks come from different generators in the two packages, so AlexNet and
VGG run with every Dropout's ``p`` set to 0 in the JSON, and Dropout itself
is held to its definition. Tolerances are ``test_torch_resnet.py``'s:
outputs rtol 1e-4, atol 1e-5; gradients rtol 2e-3, atol 2e-4; aux states
rtol 1e-4, atol 1e-5."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import fusion as jfusion
from mxnet_tpu import models as jmodels
from mxnet_tpu import name as jname
from mxnet_tpu_torch import fusion as pfusion
from mxnet_tpu_torch import models as pmodels

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL, AUX_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=2e-4), \
    dict(rtol=1e-4, atol=1e-5)
PORTED = sorted(jmodels._ZOO)

# the full-size input shapes of each name (its default constructor)
FULL = {"lenet": dict(data=(2, 1, 28, 28)), "mlp": dict(data=(2, 784)),
        "alexnet": dict(data=(2, 3, 224, 224)), "vgg": dict(data=(2, 3, 224, 224)),
        "vgg16": dict(data=(2, 3, 224, 224)), "vgg19": dict(data=(2, 3, 224, 224)),
        "inception-bn": dict(data=(2, 3, 224, 224)), "inception_bn": dict(data=(2, 3, 224, 224)),
        "inception-v3": dict(data=(2, 3, 299, 299)), "inception_v3": dict(data=(2, 3, 299, 299)),
        "resnet": dict(data=(2, 3, 224, 224)), "resnet-18": dict(data=(2, 3, 224, 224)),
        "resnet-34": dict(data=(2, 3, 224, 224)), "resnet-50": dict(data=(2, 3, 224, 224)),
        "resnet-101": dict(data=(2, 3, 224, 224)), "resnet-152": dict(data=(2, 3, 224, 224)),
        "lstm": dict(data=(32, 32), softmax_label=(32, 32)),
        "transformer": dict(data=(2, 64), softmax_label=(2, 64)),
        "transformer_mt": dict(data=(2, 64), dec_data=(2, 64), softmax_label=(2, 64)),
        "vgg16-ssd-300": dict(data=(2, 3, 300, 300)),
        "vgg16-ssd-300-train": dict(data=(2, 3, 300, 300), label=(2, 4, 5)),
        "recommender": dict(user=(2,), item=(2,), dense=(2, 16), label=(2,)),
        "dlrm": dict(user=(2,), item=(2,), dense=(2, 16), label=(2,))}


def _both(name, **kw):
    with jname.NameManager():
        js = jmodels.get_symbol(name, **kw)
    with pt.NameManager():
        ps = pmodels.get_symbol(name, **kw)
    return js, ps


# ------------------------------------------------------------------ symbols
def test_the_zoo_has_the_references_names():
    assert sorted(pmodels._ZOO) == sorted(jmodels._ZOO)
    assert sorted(FULL) == PORTED


@pytest.mark.parametrize("name", PORTED)
def test_get_symbol_json_names_and_shapes_match_jax(name):
    js, ps = _both(name)
    assert ps.tojson() == js.tojson()
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_auxiliary_states() == js.list_auxiliary_states()
    assert ps.list_outputs() == js.list_outputs()
    want = js.infer_shape(**FULL[name])
    got = ps.infer_shape(**FULL[name])
    assert [list(map(tuple, s)) for s in got] == [list(map(tuple, s)) for s in want]


@pytest.mark.parametrize("name", ["recommender", "dlrm"])
def test_the_models_the_port_lacks_raise_naming_their_roadmap_item(name):
    """The recommender's names raised, naming ROADMAP.md section 1.4, until
    its first half landed; the port lacks no zoo model now, and these two
    build the JAX builder's JSON, arguments and shapes at full width."""
    js, ps = _both(name)
    assert ps.tojson() == js.tojson()
    args, _, _ = ps.infer_shape(**FULL[name])
    shapes = dict(zip(ps.list_arguments(), map(tuple, args)))
    assert shapes["user_embed_weight"] == (65536, 64)
    assert shapes["item_embed_weight"] == (32768, 64)
    assert shapes["top_fc0_weight"] == (512, 193)


def test_inception_v3_has_its_published_parameter_count():
    _, ps = _both("inception-v3", num_classes=1000)
    args, outs, _ = ps.infer_shape(data=(2, 3, 299, 299))
    assert [tuple(o) for o in outs] == [(2, 1000)]
    n = sum(int(np.prod(s)) for nm, s in zip(ps.list_arguments(), args)
            if nm not in ("data", "softmax_label"))
    assert n == 23834568


def _plan_by_name(fusion, sym):
    topo = sym._topo()
    plan = fusion.plan(topo, output_ids={id(n) for n, _ in sym._outputs})
    return {n.name: dict(plan[id(n)]) for n in topo
            if id(n) in plan and plan[id(n)]["kind"] in pfusion.CONV_BN_KINDS}


@pytest.mark.parametrize("name,convs,fused", [("inception-v3", 94, 50), ("inception-bn", 69, 0)])
def test_inception_conv_bn_plans_match_jax(name, convs, fused, monkeypatch):
    """The same sites in both planners. Inception-v3's convolutions have no
    bias: its 1x1 and 3x3 pad-1 stride-1 sites are planned; Inception-BN's
    all carry a bias, so none is."""
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", "1")
    js, ps = _both(name)
    plan = _plan_by_name(pfusion, ps)
    assert plan == _plan_by_name(jfusion, js)
    assert pt.executor._GraphProgram(ps).conv_bn_directives == jfusion.plan_sites(
        jfusion.plan(js._topo(), output_ids={id(n) for n, _ in js._outputs}))[1]
    assert sum(n.op == "Convolution" for n in ps._topo()) == convs
    assert sum(d["kind"] == "conv" for d in plan.values()) == fused


# ---------------------------------------------------------------- executors
def _p_zero(sym_json):
    """The JSON with every Dropout's p set to 0."""
    graph = json.loads(sym_json)
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node.get("attrs", node.get("attr", node.get("param")))["p"] = "0"
    return json.dumps(graph)


def _image_net(name, image, **kw):
    def build():
        js, ps = _both(name, num_classes=10, **kw)
        if name in ("alexnet", "vgg16"):
            js = mx.sym.load_json(_p_zero(js.tojson()))
            ps = pt.sym.load_json(_p_zero(ps.tojson()))
        return js, ps, dict(data=(2,) + image, softmax_label=(2,))
    return build


def _mt(src, tgt):
    def build():
        js, ps = _both("transformer_mt", vocab_size=16, num_layers=2, num_heads=2,
                       model_dim=16, ffn_dim=32, src_len=src, tgt_len=tgt)
        return js, ps, dict(data=(2, src), dec_data=(2, tgt), softmax_label=(2, tgt))
    return build


def _lstm():
    js, ps = _both("lstm", num_classes=40, num_embed=8, num_hidden=12, num_layers=2,
                   seq_len=6, batch_size=3)
    return js, ps, dict(data=(3, 6), softmax_label=(3, 6))


def _head(sym, body):
    pool = sym.Pooling(data=body, kernel=(2, 2), global_pool=True, pool_type="avg", name="gp")
    fc = sym.FullyConnected(data=sym.Flatten(data=pool), num_hidden=10, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def _v3_stem(m, sym):
    net = m._unit(sym.Variable("data"), 32, (3, 3), stride=(2, 2), name="stem1")
    net = m._unit(net, 32, (3, 3), name="stem2")
    net = m._unit(net, 64, (3, 3), pad=(1, 1), name="stem3")
    return _head(sym, m._pool(net, "max", stride=(2, 2), name="stem_pool1"))


# Each Inception module type once, built by the package's own function at its
# published channel widths, with a pooled softmax head: (constructor, data shape)
BLOCKS = {
    "v3-stem": (_v3_stem, (2, 3, 35, 35)),
    "v3-block_a": (lambda m, sym: _head(sym, m._block_a(sym.Variable("data"), 32, "mixed")),
                   (2, 192, 17, 17)),
    "v3-grid_reduce_a": (lambda m, sym: _head(sym, m._grid_reduce_a(sym.Variable("data"),
                                                                    "mixed_3")),
                         (2, 288, 17, 17)),
    "v3-block_b": (lambda m, sym: _head(sym, m._block_b(sym.Variable("data"), 128, "mixed_4")),
                   (2, 768, 9, 9)),
    "v3-grid_reduce_b": (lambda m, sym: _head(sym, m._grid_reduce_b(sym.Variable("data"),
                                                                    "mixed_8")),
                         (2, 768, 9, 9)),
    "v3-block_c": (lambda m, sym: _head(sym, m._block_c(sym.Variable("data"), "max",
                                                        "mixed_10")),
                   (2, 1280, 8, 8)),
    "bn-inception_a": (lambda m, sym: _head(sym, m._inception_a(
        sym.Variable("data"), 64, 64, 64, 64, 96, "avg", 32, "3a")), (2, 192, 14, 14)),
    "bn-inception_b": (lambda m, sym: _head(sym, m._inception_b(
        sym.Variable("data"), 128, 160, 64, 96, "3c")), (2, 320, 14, 14)),
}


def _block(name):
    from mxnet_tpu.models import inception_bn as jbn, inception_v3 as jv3
    from mxnet_tpu_torch.models import inception_bn as pbn, inception_v3 as pv3

    def build():
        fn, shape = BLOCKS[name]
        jm, pm = (jv3, pv3) if name.startswith("v3") else (jbn, pbn)
        with jname.NameManager():
            js = fn(jm, mx.sym)
        with pt.NameManager():
            ps = fn(pm, pt.sym)
        assert ps.tojson() == js.tojson()
        return js, ps, dict(data=shape, softmax_label=(2,))
    return build


NETS = {"alexnet-67-p0": _image_net("alexnet", (3, 67, 67)),
        "vgg16-32-p0": _image_net("vgg16", (3, 32, 32)),
        "mt-5-5": _mt(5, 5), "mt-7-5": _mt(7, 5), "lstm": _lstm}
NETS.update({name: _block(name) for name in BLOCKS})
# whole Inception nets: the inference forward only (see the module docstring)
WHOLE = {"inception-v3-75": _image_net("inception-v3", (3, 75, 75)),
         "inception-bn-96": _image_net("inception-bn", (3, 96, 96))}
TOKENS = {"mt-5-5": 16, "mt-7-5": 16, "lstm": 40}


def _values(net, args, aux, seed=11):
    """He-scaled weights, γ in U(0.5, 1.5), β and biases small, moving
    variances in U(0.5, 1.5); images in U(-1, 1); token ids and labels in
    [0, vocab); the LSTM's packed weights and states in U(-0.1, 0.1)."""
    rs = np.random.RandomState(seed)
    vocab = TOKENS.get(net, 10)
    out = {}
    for n, s in args:
        if n in ("softmax_label", "dec_data") or (n == "data" and net in TOKENS):
            v = rs.randint(0, vocab, s)
        elif n == "data":
            v = rs.uniform(-1, 1, s)
        elif n.endswith("_gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif n.endswith("_beta") or n.endswith("_bias"):
            v = rs.uniform(-0.2, 0.2, s)
        elif n.startswith("lstm_"):
            v = rs.uniform(-0.1, 0.1, s)
        elif len(s) == 1:
            v = rs.uniform(-0.2, 0.2, s)
        else:
            v = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        out[n] = v.astype(np.float32)
    auxv = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("_var") else rs.uniform(-0.1, 0.1, s)
                ).astype(np.float32) for n, s in aux}
    return out, auxv


INPUTS = ("data", "dec_data", "softmax_label")


@pytest.fixture(scope="module", params=sorted(NETS))
def reference(request):
    """The JAX executor's values, forward_backward's outputs, gradients and
    new aux states, and an inference forward's outputs."""
    js, ps, shapes = NETS[request.param]()
    exe = js.simple_bind(mx.cpu(), type_dict={"data": "int32"} if request.param == "lstm"
                         else None, **shapes)
    args, aux = _values(request.param, [(n, a.shape) for n, a in exe.arg_dict.items()],
                        [(n, a.shape) for n, a in exe.aux_dict.items()])
    exe.copy_params_from(args, aux)
    out = [o.asnumpy() for o in exe.forward_backward()]
    grads = {n: g.asnumpy() for n, g in exe.grad_dict.items() if n not in INPUTS}
    new_aux = {n: a.asnumpy() for n, a in exe.aux_dict.items()}
    exe.copy_params_from({}, aux)
    infer = [o.asnumpy() for o in exe.forward(is_train=False)]
    return dict(name=request.param, sym=ps, shapes=shapes, args=args, aux=aux, out=out,
                grads=grads, new_aux=new_aux, infer=infer)


def _port_exe(ref):
    exe = ref["sym"].simple_bind(pt.cpu(), type_dict={"data": "int32"} if ref["name"] == "lstm"
                                 else None, **ref["shapes"])
    exe.copy_params_from(ref["args"], ref["aux"])
    return exe


def test_forward_backward_outputs_gradients_and_aux_match_jax(reference):
    exe = _port_exe(reference)
    out = [o.asnumpy() for o in exe.forward_backward()]
    for g, w in zip(out, reference["out"]):
        np.testing.assert_allclose(g, w, **OUT_TOL)
    assert sorted(reference["grads"]) == sorted(n for n in exe.grad_dict if n not in INPUTS)
    for n, want in reference["grads"].items():
        got = exe.grad_dict[n].asnumpy()
        np.testing.assert_allclose(got, want, err_msg=n, **GRAD_TOL)
    for n, want in reference["new_aux"].items():
        np.testing.assert_allclose(exe.aux_dict[n].asnumpy(), want, err_msg=n, **AUX_TOL)
    if reference["name"].startswith("mt"):
        # the encoder learns through the cross-attention (tests/test_models.py:124)
        for n in ("enc0_self_qkv_weight", "enc_embed_weight"):
            assert np.abs(exe.grad_dict[n].asnumpy()).sum() > 0, n


def test_inference_forward_matches_jax(reference):
    exe = _port_exe(reference)
    for g, w in zip(exe.forward(is_train=False), reference["infer"]):
        np.testing.assert_allclose(g.asnumpy(), w, **OUT_TOL)


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_whole_inception_inference_forward_matches_jax(name):
    js, ps, shapes = WHOLE[name]()
    exe = js.simple_bind(mx.cpu(), grad_req="null", **shapes)
    args, aux = _values(name, [(n, a.shape) for n, a in exe.arg_dict.items()],
                        [(n, a.shape) for n, a in exe.aux_dict.items()])
    exe.copy_params_from(args, aux)
    want = exe.forward(is_train=False)[0].asnumpy()
    pexe = ps.simple_bind(pt.cpu(), grad_req="null", **shapes)
    pexe.copy_params_from(args, aux)
    np.testing.assert_allclose(pexe.forward(is_train=False)[0].asnumpy(), want, **OUT_TOL)


# ------------------------------------------------------------------ Dropout
def _dropout_net(p=0.5):
    data = pt.sym.Variable("data")
    fc = pt.sym.FullyConnected(data=data, num_hidden=64, name="fc")
    d1 = pt.sym.Dropout(data=fc, p=p, name="d1")
    d2 = pt.sym.Dropout(data=d1 * 1.0, p=p, name="d2")
    return pt.sym.Group([d1, d2])


def _dropout_exe(p=0.5, B=64):
    rs = np.random.RandomState(0)
    exe = _dropout_net(p).simple_bind(pt.cpu(), data=(B, 32))
    exe.copy_params_from({"data": rs.uniform(0.5, 1.5, (B, 32)).astype(np.float32),
                          "fc_weight": rs.uniform(0.1, 0.2, (64, 32)).astype(np.float32),
                          "fc_bias": np.zeros(64, np.float32)})
    return exe


def test_dropout_is_the_identity_at_inference_and_at_p_zero():
    exe = _dropout_exe()
    fc = exe.arg_dict["data"].asnumpy() @ exe.arg_dict["fc_weight"].asnumpy().T
    d1, d2 = [o.asnumpy() for o in exe.forward(is_train=False)]
    np.testing.assert_allclose(d1, fc, rtol=1e-6)
    np.testing.assert_array_equal(d1, d2)
    exe0 = _dropout_exe(p=0.0)
    d1, d2 = [o.asnumpy() for o in exe0.forward(is_train=True)]
    np.testing.assert_allclose(d1, fc, rtol=1e-6)
    np.testing.assert_array_equal(d1, d2)
    # at p = 0 a training step equals JAX's op
    jop = mx.ops.registry.get_op("Dropout")
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    want = jop.apply(mx.ops.registry.parse_attrs(jop, {"p": "0"}), [x], is_train=True,
                     rng=__import__("jax").random.PRNGKey(0))[0][0]
    got = pt.ops.registry.get_op("Dropout").apply(
        pt.ops.registry.parse_attrs(pt.ops.registry.get_op("Dropout"), {"p": "0"}),
        [torch.from_numpy(x)], is_train=True, rng=pt.random.generator("cpu"))[0][0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_an_inference_forward_draws_nothing():
    """Dropout is the identity at inference and draws no mask, so a serving
    path (an inference forward, a captured CUDA graph of one) never moves
    the generator."""
    exe = _dropout_exe()
    gen = pt.random.generator("cpu")
    before = gen.get_state()
    exe.forward(is_train=False)
    assert torch.equal(gen.get_state(), before)
    exe.forward(is_train=True)
    assert not torch.equal(gen.get_state(), before)


def test_dropout_scales_the_kept_values_and_their_gradients():
    """y = x·m/(1 − p) and dx = dy·m/(1 − p) for the drawn mask m, the same
    mask through forward_backward, forward(is_train=True) + backward; the
    kept fraction within 4σ of 1 − p; two nodes draw different masks."""
    p, keep = 0.5, 0.5
    exe = _dropout_exe(p)
    fc = exe.arg_dict["data"].asnumpy() @ exe.arg_dict["fc_weight"].asnumpy().T
    pt.random.seed(5)
    d1, d2 = [o.asnumpy() for o in exe.forward(is_train=True)]
    m1 = d1 != 0
    np.testing.assert_allclose(d1[m1], fc[m1] / keep, rtol=1e-6)
    n = m1.size
    assert abs(m1.mean() - keep) < 4 * np.sqrt(keep * (1 - keep) / n)
    m2 = (d2 != 0) & m1
    assert not np.array_equal(d2 != 0, m1)  # its own mask
    np.testing.assert_allclose(d2[m2], fc[m2] / keep / keep, rtol=1e-6)
    exe.backward([pt.nd.ones(d1.shape, ctx=pt.cpu()), pt.nd.zeros(d2.shape, ctx=pt.cpu())])
    dfc = m1 / keep  # dy = 1 through d1 only
    np.testing.assert_allclose(exe.grad_dict["fc_bias"].asnumpy(), dfc.sum(0), rtol=1e-5)
    # the same seed: the same masks, through either path
    pt.random.seed(5)
    exe.forward_backward([pt.nd.ones(d1.shape, ctx=pt.cpu()), pt.nd.zeros(d2.shape,
                                                                         ctx=pt.cpu())])
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(), d1)
    np.testing.assert_array_equal(exe.outputs[1].asnumpy(), d2)
    np.testing.assert_allclose(exe.grad_dict["fc_bias"].asnumpy(), dfc.sum(0), rtol=1e-5)
    # a later forward draws anew
    exe.forward(is_train=True)
    assert not np.array_equal(exe.outputs[0].asnumpy() != 0, m1)


def test_dropout_training_steps_of_alexnet_repeat_from_the_seed():
    """Two training steps of a narrow AlexNet head at p = 0.5 from the same
    ``random.seed`` give the same bits; a third, unseeded, does not."""
    _, ps = _both("alexnet", num_classes=10)
    exe = ps.simple_bind(pt.cpu(), data=(2, 3, 67, 67), softmax_label=(2,))
    args, _ = _values("alexnet", [(n, a.shape) for n, a in exe.arg_dict.items()], [])
    exe.copy_params_from(args)

    def step():
        exe.forward_backward()
        return exe.outputs[0].asnumpy(), exe.grad_dict["fc1_weight"].asnumpy()

    pt.random.seed(3)
    a = step()
    pt.random.seed(3)
    b = step()
    c = step()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])
