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

import jax
import jax.numpy as jnp

import mxnet_tpu
import mxnet_tpu.operator  # noqa: F401
import mxnet_tpu_torch as pt

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
    ("SparseEmbedding", {"input_dim": "10", "output_dim": "4"}, [_ids(10, 2, 3), _r(10, 4)]),
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



# ------------------------------------------------- the rest of the library
# a Custom op registered in both packages under the same op_type
def _custom_prop(pkg):
    """tanh(x)·factor with its hand-written backward, on ``pkg``'s classes."""

    class Prop(pkg.operator.CustomOpProp):
        def __init__(self, factor="1.5"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            factor = self.factor

            class Op(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], np.tanh(in_data[0].asnumpy()) * factor)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    y = out_data[0].asnumpy() / factor
                    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * factor * (1 - y * y))

            return Op()

    return Prop


for _pkg in (mxnet_tpu, pt):
    _pkg.operator.register("sweep_scaled_tanh")(_custom_prop(_pkg))


def _boxes(n, seed, lo=0.0, hi=1.0):
    """n corner boxes inside [lo, hi]², each at least a tenth of the span wide."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(lo, hi, (n, 2, 2))
    a, b = p.min(axis=1), p.max(axis=1) + 0.1 * (hi - lo)
    return np.concatenate([a, b], axis=1).astype(np.float32)


def _prior(H, W, sizes, ratios):
    """MultiBoxPrior's anchors, made with numpy as the JAX op makes them."""
    cy, cx = (np.arange(H, dtype=np.float32) + 0.5) / H, (np.arange(W, dtype=np.float32) + 0.5) / W
    cyg, cxg = np.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r)) for r in ratios[1:]]
    a = np.stack([np.stack([cxg - w / 2, cyg - h / 2, cxg + w / 2, cyg + h / 2], -1)
                  for w, h in whs], 2)
    return a.reshape(1, -1, 4).astype(np.float32)


_ANCH = _prior(4, 4, (0.3, 0.45), (1.0, 2.0, 0.5))  # (1, 64, 4)
_NA = _ANCH.shape[1]
# two images: 3 boxes and a padded row, 1 box and two padded rows
_LAB = -np.ones((2, 3, 5), np.float32)
_LAB[0, :2, 0], _LAB[0, :2, 1:] = [1, 2], _boxes(2, 3)
_LAB[1, :1, 0], _LAB[1, :1, 1:] = [0], _boxes(1, 4)
_PROBS = np.exp(_r(2, 4, _NA))
_PROBS = (_PROBS / _PROBS.sum(axis=1, keepdims=True)).astype(np.float32)
_ROIS = np.array([[0, 1, 2, 9, 13], [1, 0, 0, 15, 15], [0, 6, 3, 7, 4]], np.float32)
_A = 12  # Proposal's 4 scales x 3 ratios

CASES += [
    ("Deconvolution", {"kernel": "(3, 3)", "num_filter": "4", "stride": "(2, 2)",
                       "pad": "(1, 1)", "adj": "(1, 1)"},
     [_r(2, 3, 5, 5), _r(3, 4, 3, 3, seed=1), _r(4, seed=2)]),
    ("Deconvolution", {"kernel": "(2, 2)", "num_filter": "6", "num_group": "2", "no_bias": "True"},
     [_r(2, 4, 3, 4), _r(4, 3, 2, 2, seed=1)]),
    ("LeakyReLU", {"act_type": "leaky", "slope": "0.1"}, [_r(3, 4)]),
    ("LeakyReLU", {"act_type": "elu", "slope": "0.3"}, [_r(3, 4)]),
    ("LeakyReLU", {"act_type": "prelu"}, [_r(2, 3, 4), _r(3, seed=1)]),
    ("LeakyReLU", {"act_type": "rrelu"}, [_r(3, 4)]),
    ("log_softmax", {"axis": "1"}, [_r(2, 5, 3)]),
    ("SoftmaxActivation", {}, [_r(2, 3, 4)]),
    ("SoftmaxActivation", {"mode": "channel"}, [_r(2, 3, 4)]),
    ("LinearRegressionOutput", {"grad_scale": "0.5"}, [_r(4, 3), _r(4, 3, seed=1)]),
    ("LogisticRegressionOutput", {}, [_r(4, 3), _q(4, 3, seed=1)]),
    ("MAERegressionOutput", {}, [_r(4, 3), _r(4, 3, seed=1)]),
    ("MakeLoss", {"grad_scale": "0.25", "normalization": "batch"}, [_r(4, 3)]),
    ("MakeLoss", {"normalization": "valid"}, [_r(4, 3)]),
    ("SVMOutput", {"margin": "0.5"}, [_r(4, 5), _ids(5, 4)]),
    ("SVMOutput", {"use_linear": "True", "regularization_coefficient": "2.0"},
     [_r(4, 5), _ids(5, 4)]),
    ("IdentityAttachKLSparseReg", {"penalty": "0.01"}, [_r(3, 4), _r(1, seed=1, lo=0.1)]),
    ("InstanceNorm", {"eps": "1e-05"}, [_r(2, 3, 4, 5), _r(3, seed=1), _r(3, seed=2)]),
    ("L2Normalization", {}, [_r(2, 3, 4)]),
    ("L2Normalization", {"mode": "channel"}, [_r(2, 3, 4, 2)]),
    ("L2Normalization", {"mode": "spatial", "eps": "1e-05"}, [_r(2, 3, 4, 2)]),
    ("UpSampling", {"scale": "2"}, [_r(2, 3, 3, 4)]),
    ("UpSampling", {"scale": "3", "num_args": "2"}, [_r(1, 2, 2, 3), _r(1, 3, 2, 3, seed=1)]),
    ("UpSampling", {"scale": "2", "num_args": "2", "multi_input_mode": "sum"},
     [_r(1, 2, 2, 3), _r(1, 2, 2, 3, seed=1)]),
    ("UpSampling", {"scale": "2", "sample_type": "bilinear"}, [_r(2, 3, 3, 4)]),
    ("ROIPooling", {"pooled_size": "(2, 3)", "spatial_scale": "0.5"}, [_r(2, 3, 8, 8), _ROIS]),
    ("BilinearSampler", {}, [_r(2, 3, 5, 6), np.tanh(_r(2, 2, 4, 5, seed=1)) * 1.2]),
    ("GridGenerator", {"transform_type": "affine", "target_shape": "(3, 4)"}, [_r(2, 6)]),
    ("GridGenerator", {"transform_type": "warp"}, [_r(2, 2, 3, 4)]),
    # no sample lands within rounding of a pixel's edge, where the sampler's
    # gradient jumps (torch.linspace and jnp.linspace round the grid apart)
    ("SpatialTransformer", {"target_shape": "(5, 4)"},
     [_r(2, 3, 6, 6), np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0],
                                [1.1, 0.03, -0.13, 0.07, 0.83, 0.11]], np.float32)]),
    ("Crop", {"offset": "(1, 2)", "h_w": "(3, 3)"}, [_r(2, 3, 6, 6)]),
    ("Crop", {"h_w": "(2, 4)", "center_crop": "True"}, [_r(2, 3, 6, 7)]),
    ("Crop", {"num_args": "2", "center_crop": "True"}, [_r(2, 3, 6, 7), _r(1, 1, 3, 5)]),
    ("_contrib_MultiBoxPrior", {"sizes": "(0.3, 0.45)", "ratios": "(1.0, 2.0, 0.5)"},
     [_r(1, 3, 4, 4)]),
    ("MultiBoxPrior", {"sizes": "[0.5, 0.8]", "ratios": "[1, 3]", "clip": "True",
                       "steps": "(0.2, 0.25)", "offsets": "(0.4, 0.6)"}, [_r(1, 3, 5, 4)]),
    ("_contrib_MultiBoxTarget", {}, [_ANCH, _LAB, _r(2, 4, _NA)]),
    ("MultiBoxTarget", {"overlap_threshold": "0.4", "negative_mining_ratio": "3",
                        "negative_mining_thresh": "0.5", "minimum_negative_samples": "2",
                        "variances": "(0.1, 0.1, 0.2, 0.2)"}, [_ANCH, _LAB, _r(2, 4, _NA)]),
    ("_contrib_MultiBoxDetection", {}, [_PROBS, _r(2, 4 * _NA) * 0.5, _ANCH]),
    ("MultiBoxDetection", {"nms_threshold": "0.3", "threshold": "0.2", "nms_topk": "10",
                           "clip": "False"}, [_PROBS, _r(2, 4 * _NA) * 0.5, _ANCH]),
    ("_contrib_Proposal", {"feature_stride": "16", "rpn_post_nms_top_n": "8",
                           "rpn_pre_nms_top_n": "40", "rpn_min_size": "4"},
     [np.abs(_r(2, 2 * _A, 4, 4)), _r(2, 4 * _A, 4, 4, seed=1) * 0.1,
      np.array([[64, 64, 1.0], [60, 50, 0.5]], np.float32)]),
    ("Proposal", {"rpn_post_nms_top_n": "6", "threshold": "0.5", "output_score": "True"},
     [np.abs(_r(1, 2 * _A, 3, 4)), _r(1, 4 * _A, 3, 4, seed=1) * 0.1,
      np.array([[48, 64, 1.0]], np.float32)]),
    ("_contrib_fft", {}, [_r(2, 8)]),
    ("ifft", {}, [_r(2, 3, 16)]),
    ("_contrib_count_sketch", {"out_dim": "4"},
     [_r(3, 6), np.array([0, 3, 1, 0, 3, 2], np.float32),
      np.array([1, -1, 1, 1, -1, -1], np.float32)]),
    ("Correlation", {"max_displacement": "1", "pad_size": "1"}, [_r(2, 3, 4, 5), _r(2, 3, 4, 5, seed=1)]),
    ("Correlation", {"max_displacement": "2", "stride2": "2", "is_multiply": "False"},
     [_r(1, 2, 5, 5), _r(1, 2, 5, 5, seed=1)]),
    ("batch_dot", {}, [_r(2, 3, 4), _r(2, 4, 5, seed=1)]),
    ("batch_dot", {"transpose_a": "True", "transpose_b": "True"},
     [_r(2, 4, 3), _r(2, 5, 4, seed=1)]),
    ("slice", {"begin": "(1, 0, 2)", "end": "(2, 3, 4)"}, [_r(3, 4, 5)]),
    ("crop", {"begin": "(0, 1)", "end": "(2, 3)"}, [_r(3, 4)]),
    ("repeat", {"repeats": "2", "axis": "1"}, [_r(2, 3)]),
    ("repeat", {"repeats": "3"}, [_r(2, 3)]),
    ("tile", {"reps": "(2, 1, 3)"}, [_r(2, 3)]),
    ("reverse", {"axis": "(0, 2)"}, [_r(2, 3, 4)]),
    ("flip", {"axis": "1"}, [_r(2, 3, 4)]),
    ("take", {}, [_r(5, 3), np.array([[0, 4.7], [-2, 9]], np.float32)]),
    ("take", {"axis": "1", "mode": "wrap"}, [_r(2, 5, 3), np.array([1, -1, 7], np.float32)]),
    ("batch_take", {}, [_r(4, 5), np.array([0, 4, 2, 2], np.float32)]),
    ("pick", {}, [_r(3, 5), np.array([0, 4, 2], np.float32)]),
    ("pick", {"axis": "0", "keepdims": "True"}, [_r(3, 5, 2), _ids(3, 5, 2)]),
    ("topk", {"k": "3"}, [_q(4, 6)]),
    ("topk", {"k": "2", "axis": "0", "ret_typ": "value"}, [_q(5, 3)]),
    ("topk", {"k": "3", "ret_typ": "both", "is_ascend": "True"}, [_q(4, 6)]),
    ("topk", {"k": "2", "ret_typ": "mask", "axis": "1"}, [_q(3, 5, 2)]),
    ("sort", {}, [_q(4, 6)]),
    ("sort", {"axis": "0", "is_ascend": "False"}, [_q(4, 6)]),
    ("sort", {"axis": "None"}, [_q(3, 4)]),
    ("argsort", {}, [_q(4, 6)]),
    ("argsort", {"axis": "0", "is_ascend": "False"}, [_q(5, 3)]),
    ("Pad", {"mode": "constant", "pad_width": "(0, 0, 0, 0, 1, 2, 2, 1)",
             "constant_value": "1.5"}, [_r(2, 3, 4, 5)]),
    ("pad", {"mode": "edge", "pad_width": "(0, 0, 0, 0, 2, 1, 0, 3)"}, [_r(2, 3, 4, 5)]),
    ("Pad", {"mode": "reflect", "pad_width": "(0, 0, 0, 0, 1, 2, 2, 1)"}, [_r(2, 3, 4, 5)]),
    ("SequenceLast", {}, [_r(4, 3, 2)]),
    ("SequenceLast", {"use_sequence_length": "True"},
     [_r(4, 3, 2), np.array([1, 4, 2], np.float32)]),
    ("SequenceMask", {"use_sequence_length": "True", "value": "-1.0"},
     [_r(4, 3, 2), np.array([1, 4, 0], np.float32)]),
    ("SequenceReverse", {}, [_r(4, 3)]),
    ("SequenceReverse", {"use_sequence_length": "True"},
     [_r(4, 3, 2), np.array([1, 4, 2], np.float32)]),
    ("WarpCTC", {"input_length": "4", "label_length": "2"},
     [_r(8, 5), np.array([[1, 2], [3, 0]], np.float32)]),
    ("Custom", {"op_type": "sweep_scaled_tanh", "factor": "2.0"}, [_r(3, 4)]),
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
    ("_graph_const", {"data": np.arange(6, dtype=np.float32).tobytes(), "shape": "(2, 3)",
                      "dtype": "float32"}, []),
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


# every op of the rest of the library whose JAX function has a gradient:
# the vjp of the JAX op against torch autograd of the port's, at a cotangent
# drawn from a seed a case, over every input (an index, label or shape-only
# input gets zeros from both), atol = rtol = 1e-5
GRAD_OPS = {"Deconvolution", "LeakyReLU", "log_softmax", "SoftmaxActivation",
            "LinearRegressionOutput", "LogisticRegressionOutput", "MAERegressionOutput",
            "MakeLoss", "SVMOutput", "IdentityAttachKLSparseReg", "InstanceNorm",
            "L2Normalization", "UpSampling", "ROIPooling", "BilinearSampler", "GridGenerator",
            "SpatialTransformer", "Crop", "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
            "_contrib_MultiBoxDetection", "_contrib_Proposal", "_contrib_fft", "_contrib_ifft",
            "_contrib_count_sketch", "Correlation", "batch_dot", "slice", "repeat", "tile",
            "reverse", "take", "batch_take", "pick", "topk", "sort", "argsort", "Pad",
            "SequenceLast", "SequenceMask", "SequenceReverse", "WarpCTC", "Custom",
            "SparseEmbedding"}
GRAD_CASES = [c for c in CASES if preg.get_op(c[0]).name in GRAD_OPS]


@pytest.mark.parametrize("op,attrs,inputs", GRAD_CASES, ids=[_case_id(c) for c in GRAD_CASES])
def test_op_gradient_matches_the_reference(op, attrs, inputs):
    jop, pop = jreg.get_op(op), preg.get_op(op)
    jattrs, pattrs = jreg.parse_attrs(jop, attrs), preg.parse_attrs(pop, attrs)
    n_in = len(pop.input_names(pattrs))
    jaux = [jnp.asarray(x) for x in inputs[n_in:]]
    jouts, vjp = jax.vjp(lambda *xs: tuple(jop.apply(jattrs, list(xs), aux=jaux)[0]),
                         *[jnp.asarray(x) for x in inputs[:n_in]])
    rs = np.random.RandomState(len(GRAD_CASES))
    cots = [rs.randn(*np.shape(o)).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    xs = [torch.from_numpy(x.copy()).requires_grad_(True) for x in inputs[:n_in]]
    pouts, _ = pop.apply(pattrs, xs, aux=[torch.from_numpy(x) for x in inputs[n_in:]])
    heads = [(o, torch.from_numpy(c)) for o, c in zip(pouts, cots) if o.requires_grad]
    pgrads = torch.autograd.grad([o for o, _ in heads], xs, [c for _, c in heads],
                                 allow_unused=True) if heads else [None] * n_in
    for x, p, j in zip(inputs, pgrads, jgrads):
        j = np.zeros(x.shape, np.float32) if j.dtype == jax.dtypes.float0 else np.asarray(j)
        p = np.zeros(x.shape, np.float32) if p is None else p.numpy()
        np.testing.assert_allclose(p, j, atol=1e-5, rtol=1e-5)


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
    # (mean, std, kurtosis): the standard error of a std is std·sqrt((κ - 1)/4n)
    ("random_gamma", {"alpha": "2.0", "beta": "1.5", "shape": "(20000,)"},
     (3.0, 1.5 * math.sqrt(2.0), 6.0), (0.0, math.inf)),
    ("_sample_gamma", {"shape": "(100, 200)"}, (1.0, 1.0, 9.0), (0.0, math.inf)),
    ("random_exponential", {"lam": "2.0", "shape": "(20000,)"}, (0.5, 0.5, 9.0),
     (0.0, math.inf)),
    ("exponential", {"shape": "(20000,)"}, (1.0, 1.0, 9.0), (0.0, math.inf)),
    ("_sample_exponential", {"lam": "0.5", "shape": "(20000,)"}, (2.0, 2.0, 9.0),
     (0.0, math.inf)),
    ("random_poisson", {"lam": "3.0", "shape": "(20000,)"},
     (3.0, math.sqrt(3.0), 3.0 + 1.0 / 3.0), (0.0, math.inf)),
    ("poisson", {"lam": "0.5", "shape": "(20000,)"}, (0.5, math.sqrt(0.5), 5.0),
     (0.0, math.inf)),
    ("_sample_poisson", {"shape": "(20000,)"}, (1.0, 1.0, 4.0), (0.0, math.inf)),
    # k(1 - p)/p and k(1 - p)/p², excess kurtosis 6/k + p²/(k(1 - p))
    ("random_negative_binomial", {"k": "3", "p": "0.4", "shape": "(20000,)"},
     (4.5, math.sqrt(11.25), 3.0 + 2.0 + 0.16 / 1.8), (0.0, math.inf)),
    ("negative_binomial", {"k": "2", "p": "0.5", "shape": "(20000,)"},
     (2.0, 2.0, 3.0 + 3.0 + 0.25 / 1.0), (0.0, math.inf)),
    ("_sample_negbinomial", {"k": "5", "p": "0.7", "shape": "(20000,)"},
     (5 * 0.3 / 0.7, math.sqrt(5 * 0.3) / 0.7, 3.0 + 6.0 / 5 + 0.49 / 1.5), (0.0, math.inf)),
    # mean μ, variance μ + αμ² (r = 1/α, p = r/(r + μ))
    ("random_generalized_negative_binomial", {"mu": "2.0", "alpha": "0.5", "shape": "(20000,)"},
     (2.0, 2.0, 3.0 + 3.0 + 0.25), (0.0, math.inf)),
    ("generalized_negative_binomial", {"mu": "3.0", "alpha": "0.0", "shape": "(20000,)"},
     (3.0, math.sqrt(3.0), 3.0 + 1.0 / 3.0), (0.0, math.inf)),
    ("_sample_gennegbinomial", {"mu": "1.0", "alpha": "0.25", "shape": "(20000,)"},
     (1.0, math.sqrt(1.25), 3.0 + 6.0 / 4 + 0.8 ** 2 / (4 * 0.2)), (0.0, math.inf)),
]


def _check_draws(x, moments, support):
    """Within 5 standard errors of the mean and std (the std's from the
    distribution's kurtosis κ, 3 where ``moments`` names none)."""
    mean, std, kurt = (tuple(moments) + (3.0,))[:3]
    n = x.size
    assert abs(x.mean() - mean) < 5 * std / math.sqrt(n)
    assert abs(x.std() - std) < 5 * std * math.sqrt((kurt - 1.0) / (4 * n))
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


# the multisample ops: parameter rows (2,) each, 20 000 draws a row, every
# row held to its distribution as above
MULTISAMPLE_CASES = [
    ("sample_uniform", [np.array([0.0, -2.0], np.float32), np.array([1.0, 3.0], np.float32)],
     lambda lo, hi: ((lo + hi) / 2, (hi - lo) / math.sqrt(12.0), 1.8)),
    ("sample_normal", [np.array([0.0, 1.5], np.float32), np.array([1.0, 0.25], np.float32)],
     lambda mu, sigma: (mu, sigma, 3.0)),
    ("sample_gamma", [np.array([2.0, 0.5], np.float32), np.array([1.5, 2.0], np.float32)],
     lambda a, b: (a * b, math.sqrt(a) * b, 3.0 + 6.0 / a)),
    ("sample_exponential", [np.array([2.0, 0.5], np.float32)],
     lambda lam: (1.0 / lam, 1.0 / lam, 9.0)),
    ("sample_poisson", [np.array([3.0, 0.5], np.float32)],
     lambda lam: (lam, math.sqrt(lam), 3.0 + 1.0 / lam)),
    ("sample_negative_binomial", [np.array([3.0, 5.0], np.float32),
                                  np.array([0.4, 0.7], np.float32)],
     lambda k, p: (k * (1 - p) / p, math.sqrt(k * (1 - p)) / p,
                   3.0 + 6.0 / k + p * p / (k * (1 - p)))),
    ("sample_generalized_negative_binomial", [np.array([2.0, 1.0], np.float32),
                                              np.array([0.5, 0.25], np.float32)],
     lambda mu, a: (mu, math.sqrt(mu + a * mu * mu),
                    3.0 + 6.0 * a + (1 / (1 + a * mu)) ** 2 / ((1 / a) * (a * mu / (1 + a * mu))))),
]


@pytest.mark.parametrize("op,params,moments", MULTISAMPLE_CASES,
                         ids=[c[0] for c in MULTISAMPLE_CASES])
def test_multisample_op_draws_the_references_distribution(op, params, moments):
    import mxnet_tpu as mx
    import mxnet_tpu_torch as pt

    jop, pop = jreg.get_op(op), preg.get_op(op)
    assert pop.name == jop.name and pop.needs_rng and jop.needs_rng
    assert pop.input_names({}) == jop.input_names({})
    jx = getattr(mx.nd, op)(*[mx.nd.array(p) for p in params], shape=(20000,)).asnumpy()
    pt.random.seed(13)
    px = getattr(pt.nd, op)(*[pt.nd.array(p, ctx=pt.cpu()) for p in params], shape=(20000,))
    assert px.context == pt.cpu() and px.shape == jx.shape == (2, 20000)
    assert px.dtype == jx.dtype
    for x in (jx, px.asnumpy()):
        for row in range(2):
            _check_draws(x[row].astype(np.float64), moments(*[float(p[row]) for p in params]),
                         None)
    pt.random.seed(13)
    again = getattr(pt.nd, op)(*[pt.nd.array(p, ctx=pt.cpu()) for p in params], shape=(20000,))
    np.testing.assert_array_equal(again.asnumpy(), px.asnumpy())


def test_every_port_op_is_swept_and_named_as_in_the_reference():
    swept = {preg.get_op(c[0]).name for c in CASES + RANDOM_CASES + MULTISAMPLE_CASES}
    assert swept == set(preg.list_ops())
    for name, op in preg._REGISTRY.items():
        assert jreg.get_op(name).name == op.name, name

    for name in preg.list_ops():
        jop, pop = jreg.get_op(name), preg.get_op(name)
        assert pop.aliases == jop.aliases, name
        assert sorted(pop.attr_specs) == sorted(jop.attr_specs), name


# the ops of the JAX library the port leaves to a later item, with the
# ROADMAP item each waits for: none
LATER = {}


def test_the_port_lacks_only_the_ops_of_later_roadmap_items():
    assert set(jreg.list_ops()) - set(preg.list_ops()) == set(LATER)
    assert set(preg.list_ops()) <= set(jreg.list_ops())
