"""Every op the port registers, against the JAX package's op of the same name:
attrs given as the strings a Symbol JSON carries, inputs made with numpy
from a seed, outputs compared in float32."""
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


def test_every_port_op_is_swept_and_named_as_in_the_reference():
    swept = {preg.get_op(c[0]).name for c in CASES}
    assert swept == set(preg.list_ops())
    for name, op in preg._REGISTRY.items():
        assert jreg.get_op(name).name == op.name, name
