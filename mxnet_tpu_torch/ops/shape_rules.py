"""Parameter-shape inference rules.

Copied from ``mxnet_tpu/ops/shape_rules.py`` (backend-free), for the ops
of the transformer's graphs: forward shapes come from running each op on the
``meta`` device, but weight, bias and label shapes flow backward from the
data shape, and these rules fill them in.
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


@rule("Embedding")
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
