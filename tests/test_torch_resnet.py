"""The port's ResNet slice against the JAX package: the zoo's pre-activation
ResNet symbol (JSON, arguments, aux states, inferred shapes), the conv+BN
fusion plan, and a bound network's outputs, gradients and BatchNorm aux
updates through every executor path; the new ops one by one.

The JAX reference runs with its conv+BN fusion forced onto the Pallas
kernels (``MXNET_FUSED_CONV_BN=1``, ``MXNET_FUSED_CONV_BN_BWD=recompute``),
in interpret mode on the CPU. The port runs on the CPU, through its kernels'
plain versions. Parameters, aux states and inputs are made with numpy from
one seed and handed to both. Tolerances are JAX's own fused-vs-unfused ones
(``tests/test_conv_bn_fusion.py``): outputs rtol 1e-4, atol 1e-5; gradients
rtol 2e-3, atol 2e-4; aux states rtol 1e-4, atol 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import fusion as jfusion
from mxnet_tpu import name as jname
from mxnet_tpu.models import resnet as jres
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.ops.registry import parse_attrs as jparse_attrs
from mxnet_tpu_torch import fusion as pfusion
from mxnet_tpu_torch import symbol as psymbol
from mxnet_tpu_torch.models import resnet as pres
from mxnet_tpu_torch.ops import conv_bn as cb
from mxnet_tpu_torch.ops.registry import get_op as pget_op
from mxnet_tpu_torch.ops.registry import parse_attrs as pparse_attrs

torch.set_num_threads(1)

FORCED = {"MXNET_FUSED_CONV_BN": "1", "MXNET_FUSED_CONV_BN_BWD": "recompute"}
INPUTS = ("data", "softmax_label")
OUT_TOL, GRAD_TOL, AUX_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=2e-4), \
    dict(rtol=1e-4, atol=1e-5)


def _resnet(pkg, name, layers, image):
    with name():
        return pkg.get_symbol(num_classes=10 if image == "3,32,32" else 1000,
                              num_layers=layers, image_shape=image)


def _both_resnets(layers, image):
    return (_resnet(jres, jname.NameManager, layers, image),
            _resnet(pres, pt.NameManager, layers, image))


def _narrow(pkg, name):
    """Three pre-activation bottlenecks from the package's own
    ``residual_unit`` (a projection, a stride-2 and an identity unit, as the
    zoo's stages begin), then the zoo's head."""
    with name():
        sym = pkg.sym
        body = sym.Variable("data")
        body = pkg.residual_unit(body, 32, (1, 1), False, "u1")
        body = pkg.residual_unit(body, 32, (2, 2), False, "u2")
        body = pkg.residual_unit(body, 32, (1, 1), True, "u3")
        bn = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
        relu = sym.Activation(data=bn, act_type="relu", name="relu")
        pool = sym.Pooling(data=relu, global_pool=True, kernel=(4, 4), pool_type="avg",
                           name="pool")
        fc = sym.FullyConnected(data=sym.Flatten(data=pool), num_hidden=10, name="fc")
        return sym.SoftmaxOutput(data=fc, name="softmax")


class _J:  # the JAX package's names for _narrow
    sym, residual_unit = mx.sym, staticmethod(jres.residual_unit)


class _P:
    sym, residual_unit = pt.sym, staticmethod(pres.residual_unit)


NETS = {"narrow": (lambda: _narrow(_J, jname.NameManager), lambda: _narrow(_P, pt.NameManager),
                   (2, 16, 8, 8)),
        "resnet18": (lambda: _both_resnets(18, "3,32,32")[0],
                     lambda: _both_resnets(18, "3,32,32")[1], (2, 3, 32, 32))}


def _values(names_shapes, aux_names_shapes, seed=7):
    """He-scaled weights, γ in U(0.5, 1.5), β and moving means small,
    moving variances in U(0.5, 1.5); images in U(-1, 1), labels in [0, 10)."""
    rs = np.random.RandomState(seed)
    args = {}
    for n, s in names_shapes:
        if n == "data":
            v = rs.uniform(-1, 1, s)
        elif n == "softmax_label":
            v = rs.randint(0, 10, s)
        elif n.endswith("_gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif n.endswith("_beta") or n.endswith("_bias"):
            v = rs.uniform(-0.2, 0.2, s)
        else:
            v = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    aux = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("_var") else rs.uniform(-0.1, 0.1, s)
               ).astype(np.float32) for n, s in aux_names_shapes}
    return args, aux


@pytest.fixture(scope="module", params=sorted(NETS))
def reference(request):
    """The JAX executor, forced onto its fused kernels: the values, then
    forward_backward's outputs, gradients and new aux states, and an
    inference forward's outputs from the initial aux states."""
    jnet, pnet, shape = NETS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in FORCED.items():
            mp.setenv(k, v)
        net = jnet()
        exe = net.simple_bind(mx.cpu(), data=shape, softmax_label=(shape[0],))
        args, aux = _values([(n, a.shape) for n, a in exe.arg_dict.items()],
                            [(n, a.shape) for n, a in exe.aux_dict.items()])
        exe.copy_params_from(args, aux)
        out = exe.forward_backward()[0].asnumpy()
        grads = {n: g.asnumpy() for n, g in exe.grad_dict.items() if n not in INPUTS}
        new_aux = {n: a.asnumpy() for n, a in exe.aux_dict.items()}
        exe.copy_params_from({}, aux)
        infer = exe.forward(is_train=False)[0].asnumpy()
    return dict(net=pnet, shape=shape, args=args, aux=aux, out=out, grads=grads,
                new_aux=new_aux, infer=infer)


def _port_exe(ref):
    shape = ref["shape"]
    exe = ref["net"]().simple_bind(pt.cpu(), data=shape, softmax_label=(shape[0],))
    exe.copy_params_from(ref["args"], ref["aux"])
    return exe


def _check(exe, ref, out):
    np.testing.assert_allclose(out, ref["out"], **OUT_TOL)
    for n, want in ref["grads"].items():
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(), want, err_msg=n, **GRAD_TOL)
    for n, want in ref["new_aux"].items():
        np.testing.assert_allclose(exe.aux_dict[n].asnumpy(), want, err_msg=n, **AUX_TOL)


def test_forward_backward_matches_the_jax_executor(reference):
    exe = _port_exe(reference)
    before = (cb.launches, cb.bwd_launches)
    _check(exe, reference, exe.forward_backward()[0].asnumpy())
    assert (cb.launches, cb.bwd_launches) == before  # CPU tensors never launch


def test_forward_then_backward_matches_the_jax_executor(reference):
    exe = _port_exe(reference)
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    _check(exe, reference, out)


def test_inference_forward_matches_the_jax_executor(reference):
    exe = _port_exe(reference)
    out = exe.forward(is_train=False)[0]
    assert exe._graph is None and not out._tensor().requires_grad
    np.testing.assert_allclose(out.asnumpy(), reference["infer"], **OUT_TOL)
    for n, want in reference["aux"].items():  # an inference forward writes no aux
        np.testing.assert_array_equal(exe.aux_dict[n].asnumpy(), want)


def test_cold_backward_leaves_the_aux_states_unchanged(reference):
    """backward() with no forward before reruns the training forward for its
    graph and discards that forward's aux values, as JAX does (:431)."""
    exe = _port_exe(reference)
    exe.backward()
    for n, want in reference["aux"].items():
        np.testing.assert_array_equal(exe.aux_dict[n].asnumpy(), want)
    for n, want in reference["grads"].items():
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(), want, err_msg=n, **GRAD_TOL)


def test_training_forward_without_gradients_still_writes_aux(reference):
    exe = reference["net"]().simple_bind(pt.cpu(), grad_req="null", data=reference["shape"],
                                         softmax_label=(reference["shape"][0],))
    exe.copy_params_from(reference["args"], reference["aux"])
    exe.forward(is_train=True)
    for n, want in reference["new_aux"].items():
        np.testing.assert_allclose(exe.aux_dict[n].asnumpy(), want, err_msg=n, **AUX_TOL)


def test_params_from_numpy_carries_the_jax_executors_args_and_aux(reference):
    """A JAX executor's arg_dict and aux_dict go across with
    ``params_from_numpy`` and ``copy_params_from``: same names, same
    layouts (OIHW conv weights)."""
    jnet = NETS["narrow" if reference["shape"][1] == 16 else "resnet18"][0]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in FORCED.items():
            mp.setenv(k, v)
        jexe = jnet().simple_bind(mx.cpu(), data=reference["shape"],
                                  softmax_label=(reference["shape"][0],))
    jexe.copy_params_from(reference["args"], reference["aux"])
    args = pt.params_from_numpy(jexe.arg_dict, ctx=pt.cpu())
    aux = pt.params_from_numpy(jexe.aux_dict, ctx=pt.cpu())
    exe = reference["net"]().simple_bind(pt.cpu(), data=reference["shape"],
                                         softmax_label=(reference["shape"][0],))
    exe.copy_params_from(args, aux)
    for table, want in ((exe.arg_dict, reference["args"]), (exe.aux_dict, reference["aux"])):
        assert set(table) == set(want)
        for n, a in table.items():
            np.testing.assert_array_equal(a.asnumpy(), want[n])
    np.testing.assert_allclose(exe.forward()[0].asnumpy(), reference["infer"], **OUT_TOL)


# ------------------------------------------------------------------ symbols
@pytest.mark.parametrize("layers,image", [(18, "3,32,32"), (50, "3,224,224")])
def test_symbol_json_arguments_aux_and_shapes_match(layers, image):
    js, ps = _both_resnets(layers, image)
    assert ps.tojson() == js.tojson()
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_auxiliary_states() == js.list_auxiliary_states()
    assert len(ps.list_auxiliary_states()) == 2 * sum(n.op == "BatchNorm" for n in ps._topo())
    shape = (2,) + tuple(int(v) for v in image.split(","))
    want = js.infer_shape(data=shape, softmax_label=(2,))
    got = ps.infer_shape(data=shape, softmax_label=(2,))
    assert [list(map(tuple, s)) for s in got] == [list(map(tuple, s)) for s in want]


def _plan_by_name(fusion, sym):
    topo = sym._topo()
    plan = fusion.plan(topo, output_ids={id(n) for n, _ in sym._outputs})
    out = {}
    for n in topo:
        d = plan.get(id(n))
        if d is not None and d["kind"] in pfusion.CONV_BN_KINDS:
            out[n.name] = {k: v for k, v in d.items()}
    return out


def _node_shapes(sym, **shapes):
    """Every node output's shape, from the port's meta-device inference."""
    arg_s, _, aux_s = sym.infer_shape(**shapes)
    known = dict(zip(sym.list_arguments(), arg_s))
    known.update(zip(sym.list_auxiliary_states(), aux_s))
    out = {}
    for node in sym._topo():
        if node.is_variable:
            out[(id(node), 0)] = known[node.name]
            continue
        ins = tuple(out[(id(i), oi)] for i, oi in node.inputs)
        res = psymbol._eval_node_shape(node.op, psymbol._freeze(node.parsed_attrs()), ins,
                                       ("float32",) * len(ins), psymbol._aux_positions(node))
        for k, (sh, _) in enumerate(res):
            out[(id(node), k)] = sh
    return out


@pytest.mark.parametrize("layers,image", [(18, "3,32,32"), (50, "3,224,224")])
def test_conv_bn_plan_matches_jax(layers, image, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CONV_BN", "1")
    js, ps = _both_resnets(layers, image)
    assert _plan_by_name(pfusion, ps) == _plan_by_name(jfusion, js)
    assert pt.executor._GraphProgram(ps).conv_bn_directives == jfusion.plan_sites(
        jfusion.plan(js._topo(), output_ids={id(n) for n, _ in js._outputs}))[1]
    if layers != 50:
        return
    plan = _plan_by_name(pfusion, ps)
    convs = {n: d for n, d in plan.items() if d["kind"] == "conv"}
    bns = {n: d for n, d in plan.items() if d["kind"] == "bn"}
    topo = ps._topo()
    assert sum(n.op == "Convolution" for n in topo) == 53
    assert (len(convs), sum(d["defer"] for d in convs.values())) == (49, 16)
    assert (len(bns), sum(d["fold"] for d in bns.values())) == (50, 45)
    # the convs left to F.conv2d: the 7x7 stem and the three 3x3 stride-2 ones
    assert sorted(n.name for n in topo if n.op == "Convolution" and n.name not in convs) == \
        ["conv0", "stage2_unit1_conv2", "stage3_unit1_conv2", "stage4_unit1_conv2"]
    # and at 224 every planned site passes the shape gate: 49 kernel launches
    shapes = _node_shapes(ps, data=(32, 3, 224, 224), softmax_label=(32,))
    gated = [n.name for n in topo if n.name in convs and cb.supported(
        shapes[(id(n.inputs[0][0]), n.inputs[0][1])], shapes[(id(n.inputs[1][0]), 0)],
        convs[n.name]["stride"])]
    assert len(gated) == 49


# ---------------------------------------------------------------------- ops
def _op_pair(name, attrs, inputs, aux=(), is_train=False):
    jop, pop = jget_op(name), pget_op(name)
    jouts, jaux = jop.apply(jparse_attrs(jop, attrs), [jnp.asarray(a) for a in inputs],
                            aux=[jnp.asarray(a) for a in aux], is_train=is_train)
    pouts, paux = pop.apply(pparse_attrs(pop, attrs), [torch.from_numpy(a) for a in inputs],
                            aux=[torch.from_numpy(a) for a in aux], is_train=is_train)
    return ([np.asarray(o) for o in jouts], [np.asarray(a) for a in jaux],
            [o.detach().numpy() for o in pouts], [a.detach().numpy() for a in paux])


@pytest.mark.parametrize("attrs,shape", [
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"), (2, 3, 9, 11)),
    (dict(kernel=(3, 3), stride=(2, 2), pool_type="max", pooling_convention="full"),
     (2, 3, 10, 7)),
    (dict(kernel=(3, 2), stride=(2, 3), pad=(1, 0), pool_type="avg",
          pooling_convention="full"), (1, 2, 9, 10)),
    (dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"), (2, 3, 7, 9)),
    (dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="sum"), (2, 3, 5, 6)),
    (dict(kernel=(3, 3), stride=(2, 2), pool_type="sum", pooling_convention="full"),
     (1, 2, 8, 8)),
    (dict(kernel=(7, 7), global_pool=True, pool_type="avg"), (2, 4, 5, 3)),
    (dict(kernel=(1, 1), global_pool=True, pool_type="max"), (2, 4, 5, 3)),
    (dict(kernel=(3,), stride=(2,), pool_type="max", pooling_convention="full"), (2, 3, 10)),
], ids=["max-valid-pad", "max-full", "avg-full-pad", "avg-valid", "sum-valid-pad",
        "sum-full", "global-avg", "global-max", "max-full-1d"])
def test_pooling_matches_the_jax_op(attrs, shape):
    rs = np.random.RandomState(11)
    x = rs.randn(*shape).astype(np.float32)
    (jo,), _, (po,), _ = _op_pair("Pooling", attrs, [x])
    assert po.shape == jo.shape
    np.testing.assert_allclose(po, jo, rtol=1e-6, atol=1e-6)
    # and the gradient (max: the arg-max's; avg/sum: spread over the window)
    head = rs.randn(*jo.shape).astype(np.float32)
    jop, pop = jget_op("Pooling"), pget_op("Pooling")
    _, vjp = jax.vjp(lambda a: jop.fn(jparse_attrs(jop, attrs), a), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(head))
    t = torch.from_numpy(x).requires_grad_(True)
    pop.fn(pparse_attrs(pop, attrs), t).backward(torch.from_numpy(head))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_flatten_and_convolution_match_the_jax_ops():
    rs = np.random.RandomState(12)
    x = rs.randn(2, 3, 4, 5).astype(np.float32)
    (jo,), _, (po,), _ = _op_pair("Flatten", {}, [x])
    np.testing.assert_array_equal(po, jo)
    for attrs, w_shape in ((dict(kernel=(3, 3), num_filter=6, stride=(2, 1), pad=(1, 0),
                                 dilate=(1, 2), no_bias=True), (6, 3, 3, 3)),
                           (dict(kernel=(1, 1), num_filter=4), (4, 3, 1, 1)),
                           (dict(kernel=(3, 3), num_filter=6, num_group=3, pad=(1, 1),
                                 no_bias=True), (6, 1, 3, 3))):
        w = rs.randn(*w_shape).astype(np.float32)
        bias = [] if attrs.get("no_bias") else [rs.randn(w_shape[0]).astype(np.float32)]
        (jo,), _, (po,), _ = _op_pair("Convolution", attrs, [x, w] + bias)
        np.testing.assert_allclose(po, jo, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attrs,is_train", [
    (dict(fix_gamma=False, use_global_stats=True), True),
    (dict(fix_gamma=False, output_mean_var=True), True),
    (dict(fix_gamma=True, output_mean_var=True), False),
    (dict(fix_gamma=False, eps=2e-5, momentum=0.8), True),
], ids=["global_stats", "mean_var_train", "mean_var_infer_fix_gamma", "train"])
def test_batch_norm_matches_the_jax_op(attrs, is_train):
    """Outputs, new aux states and, in training, the gradients through all
    outputs (the mean and var heads of output_mean_var too)."""
    rs = np.random.RandomState(13)
    x = rs.randn(4, 3, 5, 2).astype(np.float32)
    g, b = rs.uniform(0.5, 1.5, 3).astype(np.float32), rs.randn(3).astype(np.float32)
    mm, mv = rs.randn(3).astype(np.float32) * 0.1, rs.uniform(0.5, 1.5, 3).astype(np.float32)
    jo, ja, po, pa = _op_pair("BatchNorm", attrs, [x, g, b], [mm, mv], is_train)
    for p, j in zip(po + pa, jo + ja):
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-6)
    jop, pop = jget_op("BatchNorm"), pget_op("BatchNorm")
    heads = [rs.randn(*o.shape).astype(np.float32) for o in jo]

    def jf(x, g, b):
        outs, _ = jop.apply(jparse_attrs(jop, attrs), [x, g, b],
                            aux=[jnp.asarray(mm), jnp.asarray(mv)], is_train=is_train)
        return tuple(outs)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (x, g, b)))
    jgrads = vjp(tuple(jnp.asarray(h) for h in heads))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    outs, _ = pop.apply(pparse_attrs(pop, attrs), ts,
                        aux=[torch.from_numpy(mm), torch.from_numpy(mv)], is_train=is_train)
    live = [(o, torch.from_numpy(h)) for o, h in zip(outs, heads) if o.requires_grad]
    pgrads = torch.autograd.grad([o for o, _ in live], ts, [h for _, h in live],
                                 allow_unused=True)
    for name, p, j in zip(("x", "gamma", "beta"), pgrads, jgrads):
        p = np.zeros_like(np.asarray(j)) if p is None else p.numpy()
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-4, atol=1e-5, err_msg=name)


def test_bind_aux_states_and_their_errors():
    net = pt.sym.BatchNorm(pt.sym.Variable("x"), name="bn")
    x = pt.ndarray.zeros((2, 3), ctx=pt.cpu())
    args = {"x": x, "bn_gamma": pt.ndarray.zeros((3,), ctx=pt.cpu()),
            "bn_beta": pt.ndarray.zeros((3,), ctx=pt.cpu())}
    assert net.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    with pytest.raises(pt.MXNetError, match="missing aux state"):
        net.bind(pt.cpu(), args)
    with pytest.raises(pt.MXNetError, match="missing aux states"):
        net.bind(pt.cpu(), args, aux_states={"bn_moving_mean": x})
    with pytest.raises(pt.MXNetError, match="expected 2 aux states"):
        net.bind(pt.cpu(), args, aux_states=[x])
    aux = [pt.ndarray.zeros((3,), ctx=pt.cpu()) for _ in range(2)]
    exe = net.bind(pt.cpu(), args, aux_states=aux)
    assert exe.aux_dict["bn_moving_var"] is aux[1]
    with pytest.raises(pt.MXNetError, match="not in executor aux states"):
        exe.copy_params_from({}, {"nope": np.zeros(3, np.float32)})
