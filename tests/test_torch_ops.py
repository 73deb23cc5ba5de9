"""Every op the port registers, against the JAX package's op of the same name:
attrs given as the strings a Symbol JSON carries, inputs made with numpy
from a seed, outputs compared in float32 (atol = rtol = 2e-6: elementwise
float32 arithmetic and short sums on the CPU in both packages). The ops of
the imperative NDArray also go through the generated ``nd.<op>`` functions
of both packages. The samplers, whose bits are the port's own, are held to
the reference's distributions instead."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg

torch.set_num_threads(1)


def _r(*shape, seed=0, lo=None):
    x = np.random.RandomState(seed + sum(shape)).randn(*shape).astype(np.float32)
    return np.abs(x) + lo if lo is not None else x


def _ids(n, *shape):
    return np.random.RandomState(7).randint(0, n, shape).astype(np.float32)


def _q(*shape, seed=0):
    """Values on a grid of quarters, so that equal pairs and halves occur."""
    return np.round(_r(*shape, seed=seed) * 4) / 4


# (op, attrs as JSON strings, inputs)
CASES = [
    ("elemwise_add", {}, [_r(3, 4), _r(3, 4, seed=1)]),
    ("elemwise_sub", {}, [_r(3, 4), _r(3, 4, seed=1)]),
    ("elemwise_mul", {}, [_r(3, 4), _r(3, 4, seed=1)]),
    ("_plus_scalar", {"scalar": "1e-05"}, [_r(3, 4)]),
    ("_minus_scalar", {"scalar": "2.5"}, [_r(3, 4)]),
    ("_rminus_scalar", {"scalar": "1.0"}, [_r(3, 4)]),
    ("_mul_scalar", {"scalar": "0.125"}, [_r(3, 4)]),
    ("rsqrt", {}, [_r(3, 4, lo=0.1)]),
    ("square", {}, [_r(3, 4)]),
    ("broadcast_add", {}, [_r(2, 3, 4), _r(1, 3, 1, seed=1)]),
    ("broadcast_sub", {}, [_r(2, 3, 4), _r(2, 3, 1, seed=1)]),
    ("broadcast_mul", {}, [_r(2, 1, 4), _r(1, 3, 4, seed=1)]),
    ("sum", {"axis": "3"}, [_r(2, 3, 4, 5)]),
    ("sum", {"axis": "(0, 2)", "keepdims": "True"}, [_r(2, 3, 4)]),
    ("sum", {"axis": "1", "exclude": "True"}, [_r(2, 3, 4)]),
    ("mean", {"axis": "-1", "keepdims": "True"}, [_r(2, 3, 4)]),
    ("mean", {}, [_r(2, 3, 4)]),
    ("argmax", {"axis": "-1"}, [_r(3, 7)]),
    ("argmax", {"axis": "0", "keepdims": "True"}, [_r(3, 7)]),
    ("Reshape", {"shape": "(-1, 4, 0)"}, [_r(2, 12, 5)]),
    ("Reshape", {"shape": "(0, -3, -2)"}, [_r(2, 3, 4, 5)]),
    ("Reshape", {"shape": "(-4, 2, -1, -2)"}, [_r(6, 4)]),
    ("Reshape", {"shape": "(-1, 3)", "reverse": "True"}, [_r(2, 3, 4)]),
    ("expand_dims", {"axis": "3"}, [_r(2, 3, 4)]),
    ("slice_axis", {"axis": "2", "begin": "1", "end": "2"}, [_r(2, 3, 4)]),
    ("slice_axis", {"axis": "0", "begin": "1", "end": "None"}, [_r(4, 3)]),
    ("SwapAxis", {"dim1": "1", "dim2": "2"}, [_r(2, 3, 4)]),
    ("Embedding", {"input_dim": "10", "output_dim": "4"}, [_ids(10, 2, 3), _r(10, 4)]),
    ("FullyConnected", {"num_hidden": "6"}, [_r(2, 3, 4), _r(6, 12, seed=1), _r(6, seed=2)]),
    ("FullyConnected", {"num_hidden": "6", "flatten": "False"},
     [_r(2, 3, 4), _r(6, 4, seed=1), _r(6, seed=2)]),
    ("FullyConnected", {"num_hidden": "6", "no_bias": "True"}, [_r(5, 4), _r(6, 4, seed=1)]),
    ("Activation", {"act_type": "relu"}, [_r(3, 4)]),
    ("Activation", {"act_type": "sigmoid"}, [_r(3, 4)]),
    ("Activation", {"act_type": "tanh"}, [_r(3, 4)]),
    ("Activation", {"act_type": "softrelu"}, [_r(3, 4) * 30]),
    ("softmax", {"axis": "-1"}, [_r(2, 3, 5)]),
    ("softmax", {"axis": "1", "temperature": "2.0"}, [_r(2, 3, 5)]),
    ("SoftmaxOutput", {}, [_r(6, 5), _ids(5, 6)]),
    ("_contrib_MultiHeadAttention", {"causal": "True"}, [_r(2, 2, 6, 8, seed=s) for s in range(3)]),
    ("MultiHeadAttention", {"causal": "True"},
     [_r(2, 2, 3, 8), _r(2, 2, 7, 8, seed=1), _r(2, 2, 7, 8, seed=2)]),
    ("_contrib_MultiHeadAttention", {"causal": "False", "scale": "0.3"},
     [_r(2, 2, 5, 8), _r(2, 2, 4, 8, seed=1), _r(2, 2, 4, 8, seed=2)]),
    ("Convolution", {"kernel": "(3, 3)", "num_filter": "4", "pad": "(1, 1)", "no_bias": "True"},
     [_r(2, 3, 5, 5), _r(4, 3, 3, 3, seed=1)]),
    ("Convolution", {"kernel": "(1, 1)", "num_filter": "4", "stride": "(2, 2)"},
     [_r(2, 3, 5, 5), _r(4, 3, 1, 1, seed=1), _r(4, seed=2)]),
    ("Pooling", {"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)", "pool_type": "max"},
     [_r(2, 3, 7, 6)]),
    ("Pooling", {"kernel": "(7, 7)", "global_pool": "True", "pool_type": "avg"},
     [_r(2, 3, 4, 5)]),
    ("Flatten", {}, [_r(2, 3, 4)]),
    # data, gamma, beta, then the aux states moving_mean, moving_var
    ("BatchNorm", {"fix_gamma": "False", "eps": "2e-05", "momentum": "0.9"},
     [_r(2, 3, 4, 4), _r(3, seed=1), _r(3, seed=2), _r(3, seed=3), _r(3, seed=4, lo=0.5)]),
    ("sgd_update", {"lr": "0.1", "wd": "0.01", "rescale_grad": "0.5"},
     [_r(3, 4), _r(3, 4, seed=1)]),
    ("sgd_mom_update", {"lr": "0.1", "momentum": "0.9", "wd": "0.01", "clip_gradient": "0.5"},
     [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2)]),
    ("adam_update", {"lr": "0.01", "wd": "0.01", "rescale_grad": "0.5", "clip_gradient": "1.0"},
     [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2), _r(3, 4, seed=3, lo=0.1)]),
    ("rmsprop_update", {"lr": "0.01", "wd": "0.01", "gamma1": "0.9", "rescale_grad": "0.5",
                        "clip_weights": "0.5"},
     [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2, lo=0.1)]),
    ("rmsprop_update", {"lr": "0.01", "clip_gradient": "0.25"},
     [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2, lo=0.1)]),
    ("rmspropalex_update", {"lr": "0.01", "wd": "0.01", "gamma1": "0.9", "gamma2": "0.8",
                            "clip_gradient": "1.0"},
     [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2, lo=2.0), _r(3, 4, seed=3) * 0.1,
      _r(3, 4, seed=4)]),
    ("rmspropalex_update", {"lr": "0.01", "clip_weights": "0.3"},
     [_r(3, 4), _r(3, 4, seed=1), _r(3, 4, seed=2, lo=2.0), _r(3, 4, seed=3) * 0.1,
      _r(3, 4, seed=4)]),
    # an inference forward: Dropout is the identity (its training draws are
    # held in tests/test_torch_zoo.py)
    ("Dropout", {"p": "0.5"}, [_r(3, 4)]),
    ("LRN", {"nsize": "3", "alpha": "0.001", "beta": "0.75", "knorm": "2"}, [_r(2, 5, 3, 4)]),
    ("LRN", {"nsize": "5"}, [_r(2, 7, 3, 3) * 4]),
    ("SliceChannel", {"num_outputs": "3"}, [_r(2, 6, 4)]),
    ("SliceChannel", {"num_outputs": "4", "axis": "1", "squeeze_axis": "1"}, [_r(2, 4, 5)]),
    ("where", {}, [_q(3, 4), _r(3, 4), _r(3, 4, seed=1)]),
    ("where", {}, [_q(3), _r(3, 4), _r(3, 4, seed=1)]),
    ("zeros_like", {}, [_r(3, 4)]),
    ("ones_like", {}, [_r(3, 4)]),
    # data (T, N, I), the packed parameters, state (and state_cell for lstm)
    ("RNN", {"state_size": "4", "num_layers": "2", "mode": "lstm", "state_outputs": "True"},
     [_r(3, 2, 5) * 0.5, _r(2 * 4 * 4 * (5 + 4) + 2 * 4 * 4 * 2 + 2 * 4 * 4 * 4, seed=1) * 0.3,
      _r(2, 2, 4, seed=2) * 0.5, _r(2, 2, 4, seed=3) * 0.5]),
    ("RNN", {"state_size": "4", "num_layers": "1", "mode": "gru", "bidirectional": "True"},
     [_r(3, 2, 5) * 0.5, _r(2 * 3 * 4 * (5 + 4) + 2 * 2 * 3 * 4, seed=1) * 0.3,
      _r(2, 2, 4, seed=2) * 0.5]),
    ("RNN", {"state_size": "3", "num_layers": "1", "mode": "rnn_tanh", "state_outputs": "1"},
     [_r(4, 2, 5) * 0.5, _r(3 * (5 + 3) + 2 * 3, seed=1) * 0.3, _r(1, 2, 3, seed=2) * 0.5]),
    ("RNN", {"state_size": "3", "num_layers": "2", "mode": "rnn_relu"},
     [_r(4, 2, 5) * 0.5, _r(3 * (5 + 3) + 3 * (3 + 3) + 2 * 2 * 3, seed=1) * 0.3,
      _r(2, 2, 3, seed=2) * 0.5]),
]

# the imperative NDArray's ops: ops/elemwise.py and ops/broadcast_reduce.py in
# full, and the matrix and init ops ndarray.py names
_N_GRAPH_CASES = len(CASES)


def _unit(*shape, seed=0):
    return np.tanh(_r(*shape, seed=seed)) * 0.9  # inside (-1, 1)


_SAME_SHAPE = ["elemwise_div", "_grad_add", "_maximum", "_minimum", "_hypot", "_equal",
               "_not_equal", "_greater", "_greater_equal", "_lesser", "_lesser_equal", "_mod"]
CASES += [(op, {}, [_q(3, 4), _q(3, 4, seed=1) + (0.125 if op in ("elemwise_div", "_mod") else 0)])
          for op in _SAME_SHAPE]
CASES += [("_power", {}, [_r(3, 4, lo=0.1), _r(3, 4, seed=1)])]
_BROADCAST = ["broadcast_div", "broadcast_mod", "broadcast_maximum", "broadcast_minimum",
              "broadcast_hypot", "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
              "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal"]
CASES += [(op, {}, [_q(2, 3, 4), _q(1, 3, 1, seed=1) + (0.125 if "d" == op[-1] or "div" in op
                                                        else 0)]) for op in _BROADCAST]
CASES += [("broadcast_power", {}, [_r(2, 3, 4, lo=0.1), _r(2, 1, 4, seed=1)])]
# unary op -> its input
_UNARY = {
    "abs": _r(3, 4), "sign": _q(3, 4), "round": _q(3, 4) * 2, "rint": _q(3, 4) * 2,
    "ceil": _r(3, 4) * 3, "floor": _r(3, 4) * 3, "fix": _r(3, 4) * 3, "trunc": _r(3, 4) * 3,
    "sqrt": _r(3, 4, lo=0.1), "cbrt": _r(3, 4), "rcbrt": _r(3, 4, lo=0.1), "exp": _r(3, 4),
    "log": _r(3, 4, lo=0.1), "log10": _r(3, 4, lo=0.1), "log2": _r(3, 4, lo=0.1),
    "log1p": _r(3, 4, lo=0.0), "expm1": _r(3, 4), "sin": _r(3, 4), "cos": _r(3, 4),
    "tan": _unit(3, 4), "arcsin": _unit(3, 4), "arccos": _unit(3, 4), "arctan": _r(3, 4),
    "sinh": _r(3, 4), "cosh": _r(3, 4), "tanh": _r(3, 4), "arcsinh": _r(3, 4),
    "arccosh": _r(3, 4, lo=1.1), "arctanh": _unit(3, 4), "degrees": _r(3, 4),
    "radians": _r(3, 4) * 90, "negative": _r(3, 4), "reciprocal": _r(3, 4, lo=0.1),
    "relu": _r(3, 4), "sigmoid": _r(3, 4), "softsign": _r(3, 4), "gamma": _r(3, 4, lo=0.5),
    "gammaln": _r(3, 4, lo=0.5), "erf": _r(3, 4), "logical_not": _q(3, 4),
    "_copy": _r(3, 4), "BlockGrad": _r(3, 4), "_CrossDeviceCopy": _r(3, 4),
    "norm": _r(3, 4), "argmax_channel": _r(3, 5, 2),
}
CASES += [(op, {}, [x.astype(np.float32)]) for op, x in _UNARY.items()]
# scalar op -> (scalar, input)
_SCALARS = {
    "_div_scalar": ("0.3", _r(3, 4)), "_rdiv_scalar": ("2.0", _r(3, 4, lo=0.1)),
    "_power_scalar": ("2.5", _r(3, 4, lo=0.1)), "_rpower_scalar": ("1.5", _r(3, 4)),
    "_maximum_scalar": ("0.25", _q(3, 4)), "_minimum_scalar": ("0.25", _q(3, 4)),
    "_hypot_scalar": ("1.5", _r(3, 4)), "_mod_scalar": ("0.75", _q(3, 4) + 0.125),
    "_rmod_scalar": ("2.5", _q(3, 4) + 0.125), "_equal_scalar": ("0.25", _q(3, 4)),
    "_not_equal_scalar": ("0.25", _q(3, 4)), "_greater_scalar": ("0.25", _q(3, 4)),
    "_greater_equal_scalar": ("0.25", _q(3, 4)), "_lesser_scalar": ("0.25", _q(3, 4)),
    "_lesser_equal_scalar": ("0.25", _q(3, 4)),
}
CASES += [(op, {"scalar": s}, [x.astype(np.float32)]) for op, (s, x) in _SCALARS.items()]
_NAN = _r(2, 3, 4)
_NAN[0, 1, 2] = _NAN[1, 0, 0] = np.nan
CASES += [
    ("Cast", {"dtype": "int32"}, [_r(3, 4) * 5]),
    ("Cast", {"dtype": "float16"}, [_r(3, 4)]),
    ("clip", {"a_min": "-0.5", "a_max": "0.25"}, [_r(3, 4)]),
    ("smooth_l1", {"scalar": "2.0"}, [_r(3, 4)]),
    ("add_n", {"num_args": "3"}, [_r(3, 4, seed=s) for s in range(3)]),
    ("broadcast_to", {"shape": "(2, 0, 4)"}, [_r(1, 3, 1)]),
    ("broadcast_axis", {"axis": "(0, 2)", "size": "(2, 4)"}, [_r(1, 3, 1)]),
    ("prod", {"axis": "(0, 2)"}, [_r(2, 3, 4)]),
    ("prod", {}, [_r(2, 3)]),
    ("nansum", {"axis": "(1, 2)", "keepdims": "True"}, [_NAN]),
    ("nanprod", {"axis": "2"}, [_NAN]),
    ("max", {"axis": "(0, 2)"}, [_r(2, 3, 4)]),
    ("max", {}, [_r(2, 3, 4)]),
    ("min", {"axis": "1", "keepdims": "True"}, [_r(2, 3, 4)]),
    ("min", {"axis": "0", "exclude": "True"}, [_r(2, 3, 4)]),
    ("argmin", {"axis": "1"}, [_r(3, 7)]),
    ("argmin", {}, [_r(3, 7)]),
    ("argmax", {}, [_r(3, 7)]),
    ("dot", {}, [_r(3, 4), _r(4, 5, seed=1)]),
    ("dot", {"transpose_a": "True", "transpose_b": "True"}, [_r(4, 3), _r(5, 4, seed=1)]),
    ("dot", {}, [_r(4), _r(4, seed=1)]),
    ("dot", {}, [_r(2, 3, 4), _r(4, 5, seed=1)]),
    ("transpose", {}, [_r(2, 3, 4)]),
    ("transpose", {"axes": "(1, 2, 0)"}, [_r(2, 3, 4)]),
    ("Concat", {"num_args": "2", "dim": "1"}, [_r(2, 3), _r(2, 2, seed=1)]),
    ("one_hot", {"depth": "5"}, [np.array([[0, 4], [7, 2]], np.float32)]),
    ("one_hot", {"depth": "3", "on_value": "2.0", "off_value": "-1.0", "dtype": "int32"},
     [np.array([1, 0, 2], np.float32)]),
    ("_zeros", {"shape": "(2, 3)"}, []),
    ("_ones", {"shape": "(2, 3)", "dtype": "int32"}, []),
    ("_full", {"shape": "(4,)", "value": "2.5"}, []),
    ("_arange", {"start": "1.0", "stop": "7.0", "step": "1.5", "repeat": "2"}, []),
    ("_arange", {"start": "5.0"}, []),
]


def _case_id(case):
    return "%s-%s" % (case[0], "-".join("%s=%s" % kv for kv in case[1].items()) or "plain")


@pytest.mark.parametrize("op,attrs,inputs", CASES, ids=[_case_id(c) for c in CASES])
def test_op_matches_the_reference(op, attrs, inputs):
    jop, pop = jreg.get_op(op), preg.get_op(op)
    assert pop.name == jop.name  # same canonical name, so the same Symbol JSON
    n_in = len(pop.input_names(preg.parse_attrs(pop, attrs)))  # the rest are aux states
    jout, _ = jop.apply(jreg.parse_attrs(jop, attrs), [jnp.asarray(x) for x in inputs[:n_in]],
                        aux=[jnp.asarray(x) for x in inputs[n_in:]])
    pout, _ = pop.apply(preg.parse_attrs(pop, attrs), [torch.from_numpy(x) for x in inputs[:n_in]],
                        aux=[torch.from_numpy(x) for x in inputs[n_in:]])
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape
        assert p.numpy().dtype == j.dtype
        np.testing.assert_allclose(p.numpy(), j, atol=2e-6, rtol=2e-6)


ND_CASES = CASES[_N_GRAPH_CASES:]


@pytest.mark.parametrize("op,attrs,inputs", ND_CASES, ids=[_case_id(c) for c in ND_CASES])
def test_nd_function_matches_the_reference(op, attrs, inputs):
    """The generated ``nd.<op>`` function over NDArrays, against ``mx.nd.<op>``."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as pt

    want = getattr(mx.nd, op)(*[mx.nd.array(x) for x in inputs], **attrs)
    got = getattr(pt.nd, op)(*[pt.nd.array(x, ctx=pt.cpu()) for x in inputs], ctx=pt.cpu(),
                             **attrs)
    assert isinstance(got, pt.nd.NDArray) and got.context == pt.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), atol=2e-6, rtol=2e-6)


# the samplers draw from the port's generators, not JAX's keys: each is held
# to the reference's distribution by the mean and standard deviation of
# 20 000 draws (within 5 standard errors of the exact moments) and by its
# support, through the op and through ``nd.<op>`` under each alias
RANDOM_CASES = [
    ("random_uniform", {"low": "-2.0", "high": "3.0", "shape": "(100, 200)"},
     (0.5, 5.0 / math.sqrt(12.0)), (-2.0, 3.0)),
    ("_sample_uniform", {"shape": "(20000,)"}, (0.5, 1.0 / math.sqrt(12.0)), (0.0, 1.0)),
    ("uniform", {"low": "1.0", "high": "1.5", "shape": "(4, 5000)"},
     (1.25, 0.5 / math.sqrt(12.0)), (1.0, 1.5)),
    ("random_normal", {"loc": "1.5", "scale": "0.25", "shape": "(100, 200)"}, (1.5, 0.25), None),
    ("_sample_normal", {"shape": "(20000,)"}, (0.0, 1.0), None),
    ("normal", {"loc": "-3.0", "scale": "2.0", "shape": "(20000,)"}, (-3.0, 2.0), None),
]


def _check_draws(x, moments, support):
    mean, std = moments
    n = x.size
    assert abs(x.mean() - mean) < 5 * std / math.sqrt(n)
    assert abs(x.std() - std) < 5 * std / math.sqrt(2 * n)
    if support is not None:
        assert x.min() >= support[0] and x.max() <= support[1]


@pytest.mark.parametrize("op,attrs,moments,support", RANDOM_CASES,
                         ids=[_case_id(c) for c in RANDOM_CASES])
def test_random_op_draws_the_references_distribution(op, attrs, moments, support):
    import mxnet_tpu as mx
    import mxnet_tpu_torch as pt

    jop, pop = jreg.get_op(op), preg.get_op(op)
    assert pop.name == jop.name and pop.needs_rng and jop.needs_rng
    jx = np.asarray(getattr(mx.nd, op)(**attrs).asnumpy())
    pt.random.seed(11)
    px = getattr(pt.nd, op)(ctx=pt.cpu(), **attrs)
    assert px.context == pt.cpu() and px.shape == jx.shape and px.dtype == jx.dtype
    for x in (jx, px.asnumpy()):
        _check_draws(x.astype(np.float64), moments, support)
    pt.random.seed(11)  # the same seed, the same draws
    np.testing.assert_array_equal(getattr(pt.nd, op)(ctx=pt.cpu(), **attrs).asnumpy(),
                                  px.asnumpy())


def test_every_port_op_is_swept_and_named_as_in_the_reference():
    swept = {preg.get_op(c[0]).name for c in CASES + RANDOM_CASES}
    assert swept == set(preg.list_ops())
    for name, op in preg._REGISTRY.items():
        assert jreg.get_op(name).name == op.name, name
