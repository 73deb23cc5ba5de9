"""Parameter-shape inference rules.

Copied from ``mxnet_tpu/ops/shape_rules.py`` (backend-free), for the ops
of every op the port registers that has parameters or labels to infer
(the JAX package's whole table): forward shapes come from
running each op on the ``meta`` device, but weight, bias, label and aux-state
shapes flow backward from the data shape, and these rules fill them in. Each
rule gets the inputs' shapes ordered ``input_names + aux_names``.
"""
from __future__ import annotations

RULES = {}


def rule(name):
    def _r(fn):
        RULES[name] = fn
        return fn

    return _r


def _prod(xs):
    p = 1
    for x in xs:
        p *= int(x)
    return p


@rule("FullyConnected")
def _fc(attrs, shapes):
    data = shapes[0]
    if data is not None:
        nh = attrs["num_hidden"]
        d = _prod(data[1:]) if attrs.get("flatten", True) else data[-1]
        if shapes[1] is None:
            shapes[1] = (nh, d)
        if len(shapes) > 2 and shapes[2] is None:
            shapes[2] = (nh,)
    return shapes


# copied from mxnet_tpu/ops/shape_rules.py (_conv, backend-free)
@rule("Convolution")
def _conv(attrs, shapes):
    data = shapes[0]
    if data is not None:
        nf, g = attrs["num_filter"], attrs.get("num_group", 1)
        if shapes[1] is None:
            shapes[1] = (nf, data[1] // g) + tuple(attrs["kernel"])
        if len(shapes) > 2 and shapes[2] is None:
            shapes[2] = (nf,)
    return shapes


# copied from mxnet_tpu/ops/shape_rules.py (_bn, backend-free)
@rule("BatchNorm")
def _bn(attrs, shapes):
    data = shapes[0]
    if data is not None:
        c = (data[1],)
        for i in range(1, 5):  # gamma, beta, moving_mean, moving_var
            if shapes[i] is None:
                shapes[i] = c
    return shapes


# copied from mxnet_tpu/ops/shape_rules.py (_deconv, backend-free)
@rule("Deconvolution")
def _deconv(attrs, shapes):
    data = shapes[0]
    if data is not None:
        nf, g = attrs["num_filter"], attrs.get("num_group", 1)
        if shapes[1] is None:
            shapes[1] = (data[1], nf // g) + tuple(attrs["kernel"])
        if len(shapes) > 2 and shapes[2] is None:
            shapes[2] = (nf,)
    return shapes


@rule("InstanceNorm")
def _in(attrs, shapes):
    data = shapes[0]
    if data is not None:
        for i in (1, 2):
            if shapes[i] is None:
                shapes[i] = (data[1],)
    return shapes


@rule("LeakyReLU")
def _lrelu(attrs, shapes):
    data = shapes[0]
    if data is not None and len(shapes) > 1 and shapes[1] is None:
        shapes[1] = (data[1],)
    return shapes


@rule("Embedding")
@rule("SparseEmbedding")
def _embedding(attrs, shapes):
    if shapes[1] is None:
        shapes[1] = (attrs["input_dim"], attrs["output_dim"])
    return shapes


@rule("SoftmaxOutput")
def _softmax_out(attrs, shapes):
    data = shapes[0]
    if data is not None and shapes[1] is None:
        if attrs.get("multi_output") and len(data) > 2:
            shapes[1] = (data[0],) + tuple(data[2:])
        elif attrs.get("preserve_shape"):
            shapes[1] = tuple(data[:-1])
        else:
            shapes[1] = (data[0],)
    return shapes


# copied from mxnet_tpu/ops/shape_rules.py (_rnn_shapes, backend-free)
@rule("RNN")
def _rnn_shapes(attrs, shapes):
    from .rnn import rnn_param_size

    data = shapes[0]
    if data is not None:
        T, N, I = data
        H, L = attrs["state_size"], attrs["num_layers"]
        d = 2 if attrs.get("bidirectional") else 1
        if shapes[1] is None:
            shapes[1] = (rnn_param_size(L, I, H, attrs.get("bidirectional", False),
                                        attrs["mode"]),)
        if shapes[2] is None:
            shapes[2] = (L * d, N, H)
        if len(shapes) > 3 and shapes[3] is None:
            shapes[3] = (L * d, N, H)
    return shapes


def _label_like_data(attrs, shapes):
    if shapes[0] is not None and shapes[1] is None:
        shapes[1] = tuple(shapes[0])
    return shapes


for _n in ("LinearRegressionOutput", "LogisticRegressionOutput", "MAERegressionOutput"):
    RULES[_n] = _label_like_data


@rule("SVMOutput")
def _svm_out(attrs, shapes):
    data = shapes[0]
    if data is not None and shapes[1] is None:
        shapes[1] = (data[0],)
    return shapes


@rule("IdentityAttachKLSparseReg")
def _klreg(attrs, shapes):
    return shapes
