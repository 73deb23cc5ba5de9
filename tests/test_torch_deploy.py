"""The deploy surface of the port against the JAX package's: checkpoints the
JAX package saved are served by both ``Predictor``s from the same bytes
(``mlp``, ``lenet`` and resnet-18 at (2, 3, 32, 32) with non-trivial moving
statistics), and ``model.save_checkpoint``/``load_checkpoint``/
``resume_or_init`` are held against the JAX functions. Weights and inputs
come from numpy seeds. The outputs are softmax probabilities in float32 on
the CPU in both packages: rtol 1e-5, atol 1e-6 (sums in other orders)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import models as jmodels
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu_torch.predictor import Predictor, load_ndarray_file

torch.set_num_threads(1)

CPU = pt.cpu()
MODELS = {
    "mlp": (dict(num_classes=4), (2, 16)),
    "lenet": (dict(num_classes=3), (2, 1, 28, 28)),
    "resnet": (dict(num_classes=10, num_layers=18, image_shape="3,32,32"), (2, 3, 32, 32)),
}


def _values(net, data_shape, seed=0):
    """Random parameters and non-trivial moving statistics from a seed."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape,
                                                softmax_label=(data_shape[0],))
    rs = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif n.endswith(("_beta", "_bias")):
            v = rs.uniform(-0.1, 0.1, s)
        else:
            v = rs.standard_normal(s) * np.sqrt(2.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    aux = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rs.uniform(-0.2, 0.2, s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _jax_checkpoint(tmp_path, name, epoch=7):
    """A checkpoint the JAX package saved; returns (json, bytes, args, aux, shape)."""
    kwargs, shape = MODELS[name]
    net = jmodels.get_symbol(name, **kwargs)
    args, aux = _values(net, shape)
    prefix = str(tmp_path / name)
    mx.model.save_checkpoint(prefix, epoch, net, {k: mx.nd.array(v) for k, v in args.items()},
                             {k: mx.nd.array(v) for k, v in aux.items()})
    mx.nd.waitall()  # the JAX package queues the write
    with open(prefix + "-symbol.json") as f:
        json_str = f.read()
    with open("%s-%04d.params" % (prefix, epoch), "rb") as f:
        blob = f.read()
    return prefix, json_str, blob, args, aux, shape


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predictors_agree_from_the_same_bytes(name, tmp_path):
    _, json_str, blob, args, aux, shape = _jax_checkpoint(tmp_path, name)
    assert bool(aux) == (name == "resnet")
    x = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    want_pred = JaxPredictor(json_str, blob, {"data": shape}, ctx=mx.cpu())
    want_pred.forward(data=x)
    want = want_pred.get_output(0)
    pred = Predictor(json_str, blob, {"data": shape}, ctx=CPU)
    pred.forward(data=x)
    got = pred.get_output(0)
    assert pred.num_outputs == want_pred.num_outputs == 1
    assert pred.input_shapes == want_pred.input_shapes == {"data": shape}
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # an NDArray input and set_input + forward() give the same
    pred.set_input("data", pt.nd.array(x, ctx=CPU))
    pred.forward()
    np.testing.assert_array_equal(pred.get_output(0), got)
    # the moving statistics were used, not batch statistics: another batch
    # mate does not change a row's probabilities
    y = x.copy()
    y[1] = 0.0
    pred.forward(data=y)
    np.testing.assert_allclose(pred.get_output(0)[0], got[0], rtol=1e-6, atol=1e-7)


def test_load_ndarray_file_reads_the_checkpoint_bytes(tmp_path):
    _, _, blob, args, aux, _ = _jax_checkpoint(tmp_path, "resnet")
    loaded = load_ndarray_file(blob, ctx=CPU)
    assert set(loaded) == {"arg:" + k for k in args} | {"aux:" + k for k in aux}
    for k, v in args.items():
        np.testing.assert_array_equal(loaded["arg:" + k].asnumpy(), v)
    for k, v in aux.items():
        np.testing.assert_array_equal(loaded["aux:" + k].asnumpy(), v)
    with pytest.raises(pt.MXNetError, match="invalid NDArray file"):
        load_ndarray_file(b"\0" * 64, ctx=CPU)


def test_partial_outputs(tmp_path):
    """MXPredCreatePartialOut: serve chosen outputs of a grouped symbol."""
    d = pt.sym.Variable("data")
    fc = pt.sym.FullyConnected(d, num_hidden=5, name="fc")
    net = pt.sym.Group([pt.sym.Activation(fc, act_type="relu", name="act"),
                        pt.sym.softmax(fc, name="prob"), fc])
    rs = np.random.RandomState(0)
    w, b = rs.randn(5, 8).astype(np.float32), rs.randn(5).astype(np.float32)
    path = str(tmp_path / "p.params")
    pt.nd.save(path, {"arg:fc_weight": pt.nd.array(w, ctx=CPU), "fc_bias": pt.nd.array(b, ctx=CPU),
                      "arg:unused": pt.nd.ones((2,), ctx=CPU)})
    blob = open(path, "rb").read()
    assert net.list_outputs() == ["act_output", "prob_output", "fc_output"]
    x = rs.randn(3, 8).astype(np.float32)
    logits = x @ w.T + b
    full = Predictor(net.tojson(), blob, {"data": (3, 8)}, ctx=CPU)
    full.forward(data=x)
    assert full.num_outputs == 3
    part = Predictor(net.tojson(), blob, {"data": (3, 8)}, ctx=CPU,
                     output_names=["fc_output", "act_output"])
    part.forward(data=x)
    assert part.num_outputs == 2
    np.testing.assert_allclose(part.get_output(0), logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(part.get_output(1), np.maximum(logits, 0), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(part.get_output(0), full.get_output(2))
    with pytest.raises(pt.MXNetError, match="not in"):
        Predictor(net.tojson(), blob, {"data": (3, 8)}, ctx=CPU, output_names=["nope_output"])
    # the same JSON through the JAX package's partial-output path
    jpart = JaxPredictor(net.tojson(), blob, {"data": (3, 8)}, ctx=mx.cpu(),
                         output_names=["fc_output", "act_output"])
    jpart.forward(data=x)
    np.testing.assert_allclose(part.get_output(1), jpart.get_output(1), rtol=1e-5, atol=1e-6)


def test_reshape_round_trip_binds_once_per_shape(tmp_path):
    _, json_str, blob, _, _, shape = _jax_checkpoint(tmp_path, "resnet")
    rs = np.random.RandomState(2)
    x = rs.standard_normal(shape).astype(np.float32)
    pred = Predictor(json_str, blob, {"data": shape}, ctx=CPU)
    assert pred.executables_bound == 1
    pred.forward(data=x)
    first = pred.get_output(0)
    pred.reshape({"data": (1,) + shape[1:]})
    assert pred.executables_bound == 2 and pred.input_shapes == {"data": (1,) + shape[1:]}
    pred.forward(data=x[:1])
    np.testing.assert_allclose(pred.get_output(0), first[:1], rtol=1e-5, atol=1e-6)
    exe1 = pred._exe
    pred.reshape({"data": shape})
    assert pred.executables_bound == 2  # back to a seen shape: nothing is bound
    pred.forward(data=x)
    np.testing.assert_array_equal(pred.get_output(0), first)
    # every executor reads the same parameter and aux arrays
    for n, a in pred._exe.arg_dict.items():
        assert n in ("data", "softmax_label") or a is exe1.arg_dict[n]
    for n, a in pred._exe.aux_dict.items():
        assert a is exe1.aux_dict[n]
    with pytest.raises(pt.MXNetError, match="unknown input"):
        pred.set_input("label", x)
    with pytest.raises(pt.MXNetError, match="unknown input"):
        pred.reshape({"label": (2,)})
    with pytest.raises(pt.MXNetError, match="bound as"):
        pred.forward(data=x[:1])


def test_lru_cap_under_max_executables(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_MAX_EXECUTABLES", "2")
    _, json_str, blob, _, _, _ = _jax_checkpoint(tmp_path, "mlp")
    pred = Predictor(json_str, blob, {"data": (2, 16)}, ctx=CPU)
    key = lambda b: (("data", (b, 16)),)  # noqa: E731
    pred.reshape({"data": (3, 16)})
    assert pred._cache.keys() == [key(2), key(3)]
    pred.reshape({"data": (2, 16)})      # a hit makes batch 2 the most recent
    assert pred._cache.keys() == [key(3), key(2)] and pred.executables_bound == 2
    pred.reshape({"data": (4, 16)})      # over the cap: batch 3 goes
    assert pred._cache.keys() == [key(2), key(4)] and pred.executables_bound == 3
    pred.reshape({"data": (3, 16)})      # and is bound anew when it comes back
    assert pred._cache.keys() == [key(4), key(3)] and pred.executables_bound == 4
    pred.forward(data=np.zeros((3, 16), np.float32))
    assert pred.get_output(0).shape == (3, 4)
    monkeypatch.setenv("MXNET_SERVE_MAX_EXECUTABLES", "not a number")  # falls back to 8
    pred = Predictor(json_str, blob, {"data": (2, 16)}, ctx=CPU)
    for b in range(3, 12):
        pred.reshape({"data": (b, 16)})
    assert len(pred._cache.keys()) == 8


def test_cache_output_shapes_run_and_seal(tmp_path):
    _, json_str, blob, args, aux, shape = _jax_checkpoint(tmp_path, "resnet")
    from mxnet_tpu_torch.serving import PersistentExecutableCache

    cache = PersistentExecutableCache(pt.sym.load_json(json_str), args, aux, ctx=CPU)
    assert cache.output_shapes({"data": (5,) + shape[1:]}) == [(5, 10)]
    assert cache.keys() == [] and cache.binds == 0  # probing binds nothing
    x = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    (out,) = cache.run({"data": x})
    pred = Predictor(json_str, blob, {"data": shape}, ctx=CPU)
    pred.forward(data=x)
    np.testing.assert_array_equal(out, pred.get_output(0))
    cache.seal()
    with pytest.raises(pt.MXNetError, match="cache miss"):
        cache.run({"data": x[:1]})
    # a BatchNorm model without its aux_params binds, on zero moving stats
    bare = PersistentExecutableCache(pt.sym.load_json(json_str), args, ctx=CPU)
    assert float(bare.executable({"data": shape}).aux_dict["bn1_moving_var"].asnumpy().max()) == 0


@pytest.mark.parametrize("name", sorted(MODELS))
def test_load_checkpoint_matches_the_reference(name, tmp_path):
    prefix, json_str, _, args, aux, _ = _jax_checkpoint(tmp_path, name, epoch=7)
    jsym, jargs, jaux = mx.model.load_checkpoint(prefix, 7)
    psym, pargs, paux = pt.model.load_checkpoint(prefix, 7, ctx=CPU)
    assert psym.tojson() == jsym.tojson() == json_str
    assert sorted(pargs) == sorted(jargs) == sorted(args)
    assert sorted(paux) == sorted(jaux) == sorted(aux)
    for k in args:
        np.testing.assert_array_equal(pargs[k].asnumpy(), jargs[k].asnumpy())
    for k in aux:
        np.testing.assert_array_equal(paux[k].asnumpy(), jaux[k].asnumpy())
    targs, taux = pt.params_from_checkpoint(prefix, 7, ctx=CPU)
    assert all(isinstance(t, torch.Tensor) for t in list(targs.values()) + list(taux.values()))
    np.testing.assert_array_equal(targs[sorted(args)[0]].numpy(), args[sorted(args)[0]])


def test_save_checkpoint_writes_what_the_reference_writes(tmp_path):
    prefix, json_str, blob, args, aux, _ = _jax_checkpoint(tmp_path, "resnet", epoch=7)
    out = str(tmp_path / "port")
    net = pt.sym.load_json(json_str)
    # numpy values and NDArrays on cpu(): the same bytes as the JAX package's file
    pt.model.save_checkpoint(out, 7, net, args, {k: pt.nd.array(v, ctx=CPU) for k, v in aux.items()})
    pt.nd.waitall()  # the write is queued on the engine, as the JAX package's
    assert open(out + "-0007.params", "rb").read() == blob
    assert open(out + "-symbol.json").read() == json_str
    assert not list(tmp_path.glob("port*.tmp.*"))  # the temporary file was renamed
    # and the JAX package loads the port's checkpoint
    _, jargs, jaux = mx.model.load_checkpoint(out, 7)
    np.testing.assert_array_equal(jaux["bn1_moving_var"].asnumpy(), aux["bn1_moving_var"])
    pt.model.save_checkpoint(out, 8, None, args, aux)  # symbol=None writes the params only
    assert pt.model.find_last_checkpoint(out) == 8
    with pytest.raises(pt.MXNetError, match="0-d"):
        pt.model.save_checkpoint(out, 9, None, {"s": np.float32(1.0)}, {})
    assert pt.model.find_last_checkpoint(out) == 8 and not list(tmp_path.glob("port*.tmp.*"))


def test_resume_or_init_matches_the_reference(tmp_path):
    prefix = str(tmp_path / "ck")
    assert pt.model.resume_or_init(prefix, ctx=CPU) == mx.model.resume_or_init(prefix) \
        == (0, None, None)
    assert pt.model.find_last_checkpoint(prefix) is None
    net = jmodels.get_symbol("mlp", num_classes=4)
    for epoch in (3, 12):
        args, aux = _values(net, (2, 16), seed=epoch)
        mx.model.save_checkpoint(prefix, epoch, net, {k: mx.nd.array(v) for k, v in args.items()},
                                 {})
    mx.nd.waitall()
    (tmp_path / "ck-junk.params").write_bytes(b"")  # not an epoch file
    jbegin, jargs, jaux = mx.model.resume_or_init(prefix)
    begin, pargs, paux = pt.model.resume_or_init(prefix, ctx=CPU)
    assert begin == jbegin == 12 == pt.model.find_last_checkpoint(prefix)
    assert sorted(pargs) == sorted(jargs) and paux == {} and jaux == {}
    for k in jargs:
        np.testing.assert_array_equal(pargs[k].asnumpy(), jargs[k].asnumpy())
    (tmp_path / "ck-0013.params").write_bytes(b"torn")
    with pytest.raises(pt.MXNetError, match="ck-0013.params"):
        pt.model.resume_or_init(prefix, ctx=CPU)


def test_deploy_entry_points_default_to_the_gpu(tmp_path, monkeypatch):
    prefix, json_str, blob, _, _, shape = _jax_checkpoint(tmp_path, "mlp")
    # the default no variable names (tests/conftest.py sets one for JAX)
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Predictor(json_str, blob, {"data": shape}),
                 lambda: load_ndarray_file(blob),
                 lambda: pt.model.load_checkpoint(prefix, 7),
                 lambda: pt.model.resume_or_init(prefix),
                 lambda: pt.params_from_checkpoint(prefix, 7),
                 lambda: pt.nd.load(prefix + "-0007.params")):
        with pytest.raises(pt.MXNetError, match="CUDA is not available"):
            call()
