"""VGG16-SSD-300 (``models/vgg16_ssd.py``) in the port against the JAX
package.

- Both symbols (``vgg16-ssd-300`` and ``vgg16-ssd-300-train``) build the
  JAX builders' JSON at the published defaults (20 classes, nms_thresh 0.5,
  nms_topk 400), with the same arguments, aux states, outputs and inferred
  shapes: 8732 anchors, cls_preds (B, 21, 8732), loc_preds (B, 34928).
- The deploy graph at 300 x 300, batch 1, from the same random weights:
  the detections' class ids equal JAX's and the scores and boxes within
  rtol 1e-4, atol 1e-5 (float32 convolutions summing in other orders),
  and the graph's cls_prob and loc_preds within the same.
- One training step of the SSD loss tail: ``example/ssd``'s mini backbone
  at 64 x 64, batch 2, with each package's own ``multibox_layer`` and
  ``ssd_losses``, from the same weights. The reference is JAX's own step at
  float64 (x64 on), with the package's float32 accumulators (the BatchNorm
  statistics of ``mxnet_tpu/ops/nn.py`` and ``mxnet_tpu/fusion.py`` cast to
  float32 whatever the input type) promoted to float64 for that run. The
  port's float64 step equals it within rtol 1e-6 in the outputs, the moving
  statistics and every gradient. The port's float32 step: the class
  targets equal JAX's; the other outputs and the moving statistics within
  rtol 1e-4, atol 1e-5 of JAX's float32 step, every gradient within
  rtol 2e-3, atol 2e-4 of the largest magnitude (the training tolerance of
  ``test_torch_zoo.py``), or no farther from JAX's float64 step than JAX's
  float32 step is.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu.fusion as jfusion
import mxnet_tpu.ops.nn as jnn
import mxnet_tpu_torch as pt
from mxnet_tpu import models as jmodels
from mxnet_tpu import name as jname
from mxnet_tpu_torch import models as pmodels

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-3, atol=2e-4)


def _both(name, **kw):
    with jname.NameManager():
        js = jmodels.get_symbol(name, **kw)
    with pt.NameManager():
        ps = pmodels.get_symbol(name, **kw)
    return js, ps


def _weights(net, shapes, seed, skip=("data", "label")):
    """He-scaled weights, biases in U(-0.1, 0.1), γ in U(0.5, 1.5), β in
    U(-0.1, 0.1), the L2 scale at its initial 20."""
    rs = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), shapes):
        if n in skip:
            continue
        if n.endswith(("_bias", "_beta")):
            v = rs.uniform(-0.1, 0.1, s)
        elif n.endswith("_gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif n.startswith("scale_"):
            v = np.full(s, 20.0)
        else:
            v = rs.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    return args


@pytest.mark.parametrize("name,shapes", [
    ("vgg16-ssd-300", dict(data=(2, 3, 300, 300))),
    ("vgg16-ssd-300-train", dict(data=(2, 3, 300, 300), label=(2, 4, 5)))])
def test_symbols_are_the_references_at_the_published_defaults(name, shapes):
    js, ps = _both(name)
    assert ps.tojson() == js.tojson()
    assert ps.list_arguments() == js.list_arguments()
    assert ps.list_auxiliary_states() == js.list_auxiliary_states() == []
    assert ps.list_outputs() == js.list_outputs()
    want, got = js.infer_shape(**shapes), ps.infer_shape(**shapes)
    assert [list(map(tuple, s)) for s in got] == [list(map(tuple, s)) for s in want]
    internals = ps.get_internals()
    _, outs, _ = internals.infer_shape(**shapes)
    by_name = dict(zip(internals.list_outputs(), outs))
    assert tuple(by_name["anchors_output"]) == (1, 8732, 4)
    assert tuple(by_name["cls_preds_output"]) == (2, 21, 8732)
    assert tuple(by_name["loc_preds_output"]) == (2, 34928)
    if name == "vgg16-ssd-300":
        assert [tuple(s) for s in got[1]] == [(2, 8732, 6)]
        attrs = ps.attr_dict()["detection"]
        assert (attrs["nms_threshold"], attrs["nms_topk"]) == ("0.5", "400")
    else:
        assert [tuple(s) for s in got[1]] == [(2, 21, 8732), (2, 34928), (2, 8732)]
    # the L2 norm's learnable scale: its __shape__ and __init__ attributes
    assert ps.attr_dict()["scale_0"] == js.attr_dict()["scale_0"]


def test_deploy_forward_matches_jax_at_300():
    js, ps = _both("vgg16-ssd-300")
    shapes, _, _ = ps.infer_shape(data=(1, 3, 300, 300))
    args = _weights(ps, shapes, 0)
    args["data"] = np.random.RandomState(1).uniform(-1, 1, (1, 3, 300, 300)).astype(np.float32)
    taps = ["cls_prob_output", "loc_preds_output", "detection_output"]
    jint, pint = js.get_internals(), ps.get_internals()
    jsym = mxnet_tpu.sym.Group([jint[t] for t in taps])
    psym = pt.sym.Group([pint[t] for t in taps])
    jexe = mxnet_tpu.executor.bind(jsym, mxnet_tpu.cpu(),
                                   {k: mxnet_tpu.nd.array(v) for k, v in args.items()},
                                   grad_req="null")
    want = [o.asnumpy() for o in jexe.forward(is_train=False)]
    with pt.cpu():
        pexe = pt.executor.bind(psym, pt.cpu(), {k: pt.nd.array(v) for k, v in args.items()},
                                grad_req="null")
        got = [o.asnumpy() for o in pexe.forward(is_train=False)]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, **OUT_TOL)
    np.testing.assert_array_equal(got[2][..., 0], want[2][..., 0])  # the kept ids
    np.testing.assert_allclose(got[2][..., 1:], want[2][..., 1:], **OUT_TOL)
    assert (got[2][..., 0] >= 0).sum() > 0


def _conv_act(sym, data, name, num_filter):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=(3, 3), pad=(1, 1),
                        name="conv" + name)
    bn = sym.BatchNorm(data=c, name="bn" + name)
    return sym.Activation(data=bn, act_type="relu", name="relu" + name)


def _mini_ssd(pkg, num_classes=3):
    """``example/ssd/train_ssd.py``'s mini SSD: a three-scale conv backbone
    and the package's own ``multibox_layer`` and ``ssd_losses``."""
    sym = pkg.sym
    data = sym.Variable("data")
    label = sym.Variable("label")
    b1 = _conv_act(sym, _conv_act(sym, data, "1_1", 32), "1_2", 32)
    p1 = sym.Pooling(data=b1, kernel=(2, 2), stride=(2, 2), pool_type="max")
    b2 = _conv_act(sym, _conv_act(sym, p1, "2_1", 64), "2_2", 64)
    p2 = sym.Pooling(data=b2, kernel=(2, 2), stride=(2, 2), pool_type="max")
    b3 = _conv_act(sym, _conv_act(sym, p2, "3_1", 128), "3_2", 128)
    p3 = sym.Pooling(data=b3, kernel=(2, 2), stride=(2, 2), pool_type="max")
    b4 = _conv_act(sym, p3, "4_1", 128)
    sizes = [(0.2, 0.3), (0.4, 0.5), (0.7, 0.9)]
    ratios = [(1.0, 2.0, 0.5)] * 3
    ssd = pkg.models.vgg16_ssd
    cls_preds, loc_preds, anchors = ssd.multibox_layer([b2, b3, b4], num_classes, sizes, ratios)
    return ssd.ssd_losses(cls_preds, loc_preds, anchors, label)


def _array(pkg, v, dtype):
    # the JAX package's nd.array narrows float64 to float32; a float64
    # zeros array takes the values as they are
    a = pkg.nd.zeros(np.shape(v), dtype=dtype)
    a[:] = np.asarray(v, dtype)
    return a


def _train_step(pkg, net, args, aux, imgs, labels, dtype="float32"):
    ctx = pkg.cpu()
    reqs = {n: ("write" if n in args else "null") for n in net.list_arguments()}
    arrays = {k: _array(pkg, v, dtype) for k, v in dict(args, data=imgs, label=labels).items()}
    grads = {n: pkg.nd.zeros(arrays[n].shape, dtype=dtype) for n in args}
    exe = pkg.executor.bind(net, ctx, arrays, args_grad=grads, grad_req=reqs,
                            aux_states={k: _array(pkg, v, dtype) for k, v in aux.items()})
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward()
    return (outs, {n: exe.grad_dict[n].asnumpy() for n in args},
            {n: exe.aux_dict[n].asnumpy() for n in aux})


def _fro(a, b):
    return float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b)) or 1.0)


class _Float64Accumulators:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX package's
    float32 accumulators become float64 ones in its float64 reference step."""
    float32 = jax.numpy.float64

    def __getattr__(self, name):
        return getattr(jax.numpy, name)


def test_mini_ssd_training_step_matches_jax(monkeypatch):
    """The port's float64 step is JAX's float64 step (outputs, moving stats
    and every gradient within rtol 1e-6). Its float32 step: the class
    targets (mined negatives included) equal JAX's; the other outputs, the
    moving stats and every gradient lie within the tolerances above of JAX's
    float32 step, or no farther from JAX's float64 step than JAX's float32
    step is (training BatchNorm at batch 2 amplifies float32 rounding: JAX's
    CPU step lies 1.0e-5 and 1.6e-5 from float64 in the two outputs, the
    port's 3.6e-7 and 6.8e-7). A conv bias under a BatchNorm has a gradient
    of 0 in exact arithmetic: it must stay at rounding's size."""
    with jname.NameManager():
        jnet = _mini_ssd(mxnet_tpu)
    with pt.NameManager():
        pnet = _mini_ssd(pt)
    assert pnet.tojson() == jnet.tojson()
    with pt.cpu():
        imgs, labels = pmodels.vgg16_ssd.SyntheticDetIter(2, (3, 64, 64), 3, 1).batches[0]
    arg_shapes, _, aux_shapes = pnet.infer_shape(data=imgs.shape, label=labels.shape)
    args = _weights(pnet, arg_shapes, 7)
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s)).astype(np.float32)
           for n, s in zip(pnet.list_auxiliary_states(), aux_shapes)}
    want = _train_step(mxnet_tpu, jnet, args, aux, imgs, labels)
    with monkeypatch.context() as m, jax.enable_x64(True):
        for mod in (jnn, jfusion):
            m.setattr(mod, "jnp", _Float64Accumulators())
        exact = _train_step(mxnet_tpu, jnet, args, aux, imgs, labels, dtype="float64")
    assert all(o.dtype == np.float64 for o in exact[0])
    with pt.cpu():
        got = _train_step(pt, pnet, args, aux, imgs, labels)
        got64 = _train_step(pt, pnet, args, aux, imgs, labels, dtype="float64")

    def close(g, w, e, tol):
        return np.allclose(g, w, **tol) or _fro(g, e) <= _fro(w, e)

    np.testing.assert_array_equal(got[0][2], want[0][2])
    np.testing.assert_array_equal(got64[0][2], exact[0][2])
    assert (got[0][2] > 0).any() and (got[0][2] == 0).any()  # positives, mined negatives
    for i in (0, 1):
        np.testing.assert_allclose(got64[0][i], exact[0][i], rtol=1e-6, atol=0)
        assert close(got[0][i], want[0][i], exact[0][i], OUT_TOL), i
    gscale = max(float(np.abs(exact[1][n]).max()) for n in args)
    for n in args:
        if float(np.abs(exact[1][n]).max()) <= 1e-6 * gscale:
            assert float(np.abs(got64[1][n]).max()) <= 1e-9 * gscale, n
            assert float(np.abs(got[1][n]).max()) <= 1e-4 * gscale, n
            continue
        np.testing.assert_allclose(got64[1][n], exact[1][n], rtol=1e-6,
                                   atol=1e-9 * gscale, err_msg=n)
        tol = dict(rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"] * float(np.abs(want[1][n]).max()))
        assert close(got[1][n], want[1][n], exact[1][n], tol), n
    for n in aux:
        np.testing.assert_allclose(got64[2][n], exact[2][n], rtol=1e-6, atol=0, err_msg=n)
        assert close(got[2][n], want[2][n], exact[2][n], OUT_TOL), n
