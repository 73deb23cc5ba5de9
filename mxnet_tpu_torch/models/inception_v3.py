# copied from mxnet_tpu/models/inception_v3.py (backend-free; the docstring adapted)
"""Inception-v3 (reference: example/image-classification/symbols/
inception-v3.py — Szegedy et al., "Rethinking the Inception Architecture",
299x299 input; BASELINE.json config 2).

The convolutions have no bias, so the conv+BN planner (``fusion.py``) takes
each 1x1 and each 3x3 pad-1 stride-1 site onto the fused kernels
(``ops/conv_bn.py``); the factorized 1x7/7x1 and 1x3/3x1, the 5x5 and the
unpadded or stride-2 3x3 convolutions stay ``F.conv2d``.
"""
from .. import symbol as sym


def _unit(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    bn = sym.BatchNorm(data=c, fix_gamma=False, eps=2e-5, name="%s_bn" % name)
    return sym.Activation(data=bn, act_type="relu", name="%s_relu" % name)


def _pool(data, kind, kernel=(3, 3), stride=(1, 1), pad=(0, 0), name=None):
    return sym.Pooling(data=data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=kind, name=name)


def _block_a(data, proj, name):
    """35x35 module: 1x1 / 5x5 / double-3x3 / pooled-projection branches."""
    b0 = _unit(data, 64, (1, 1), name="%s_b0" % name)
    b1 = _unit(data, 48, (1, 1), name="%s_b1a" % name)
    b1 = _unit(b1, 64, (5, 5), pad=(2, 2), name="%s_b1b" % name)
    b2 = _unit(data, 64, (1, 1), name="%s_b2a" % name)
    b2 = _unit(b2, 96, (3, 3), pad=(1, 1), name="%s_b2b" % name)
    b2 = _unit(b2, 96, (3, 3), pad=(1, 1), name="%s_b2c" % name)
    b3 = _pool(data, "avg", pad=(1, 1), name="%s_pool" % name)
    b3 = _unit(b3, proj, (1, 1), name="%s_b3" % name)
    return sym.Concat(b0, b1, b2, b3, name="%s_concat" % name)


def _grid_reduce_a(data, name):
    """35x35 → 17x17."""
    b0 = _unit(data, 384, (3, 3), stride=(2, 2), name="%s_b0" % name)
    b1 = _unit(data, 64, (1, 1), name="%s_b1a" % name)
    b1 = _unit(b1, 96, (3, 3), pad=(1, 1), name="%s_b1b" % name)
    b1 = _unit(b1, 96, (3, 3), stride=(2, 2), name="%s_b1c" % name)
    b2 = _pool(data, "max", stride=(2, 2), name="%s_pool" % name)
    return sym.Concat(b0, b1, b2, name="%s_concat" % name)


def _block_b(data, c7, name):
    """17x17 module with factorized 7x7 (1x7 then 7x1) branches."""
    b0 = _unit(data, 192, (1, 1), name="%s_b0" % name)
    b1 = _unit(data, c7, (1, 1), name="%s_b1a" % name)
    b1 = _unit(b1, c7, (1, 7), pad=(0, 3), name="%s_b1b" % name)
    b1 = _unit(b1, 192, (7, 1), pad=(3, 0), name="%s_b1c" % name)
    b2 = _unit(data, c7, (1, 1), name="%s_b2a" % name)
    b2 = _unit(b2, c7, (7, 1), pad=(3, 0), name="%s_b2b" % name)
    b2 = _unit(b2, c7, (1, 7), pad=(0, 3), name="%s_b2c" % name)
    b2 = _unit(b2, c7, (7, 1), pad=(3, 0), name="%s_b2d" % name)
    b2 = _unit(b2, 192, (1, 7), pad=(0, 3), name="%s_b2e" % name)
    b3 = _pool(data, "avg", pad=(1, 1), name="%s_pool" % name)
    b3 = _unit(b3, 192, (1, 1), name="%s_b3" % name)
    return sym.Concat(b0, b1, b2, b3, name="%s_concat" % name)


def _grid_reduce_b(data, name):
    """17x17 → 8x8."""
    b0 = _unit(data, 192, (1, 1), name="%s_b0a" % name)
    b0 = _unit(b0, 320, (3, 3), stride=(2, 2), name="%s_b0b" % name)
    b1 = _unit(data, 192, (1, 1), name="%s_b1a" % name)
    b1 = _unit(b1, 192, (1, 7), pad=(0, 3), name="%s_b1b" % name)
    b1 = _unit(b1, 192, (7, 1), pad=(3, 0), name="%s_b1c" % name)
    b1 = _unit(b1, 192, (3, 3), stride=(2, 2), name="%s_b1d" % name)
    b2 = _pool(data, "max", stride=(2, 2), name="%s_pool" % name)
    return sym.Concat(b0, b1, b2, name="%s_concat" % name)


def _block_c(data, pool_kind, name):
    """8x8 module with expanded 1x3/3x1 fan-outs."""
    b0 = _unit(data, 320, (1, 1), name="%s_b0" % name)
    b1 = _unit(data, 384, (1, 1), name="%s_b1a" % name)
    b1l = _unit(b1, 384, (1, 3), pad=(0, 1), name="%s_b1b" % name)
    b1r = _unit(b1, 384, (3, 1), pad=(1, 0), name="%s_b1c" % name)
    b2 = _unit(data, 448, (1, 1), name="%s_b2a" % name)
    b2 = _unit(b2, 384, (3, 3), pad=(1, 1), name="%s_b2b" % name)
    b2l = _unit(b2, 384, (1, 3), pad=(0, 1), name="%s_b2c" % name)
    b2r = _unit(b2, 384, (3, 1), pad=(1, 0), name="%s_b2d" % name)
    b3 = _pool(data, pool_kind, pad=(1, 1), name="%s_pool" % name)
    b3 = _unit(b3, 192, (1, 1), name="%s_b3" % name)
    return sym.Concat(b0, b1l, b1r, b2l, b2r, b3, name="%s_concat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    # stem: 299x299x3 → 35x35x192
    net = _unit(data, 32, (3, 3), stride=(2, 2), name="stem1")
    net = _unit(net, 32, (3, 3), name="stem2")
    net = _unit(net, 64, (3, 3), pad=(1, 1), name="stem3")
    net = _pool(net, "max", stride=(2, 2), name="stem_pool1")
    net = _unit(net, 80, (1, 1), name="stem4")
    net = _unit(net, 192, (3, 3), name="stem5")
    net = _pool(net, "max", stride=(2, 2), name="stem_pool2")
    # 3 x A (35x35)
    net = _block_a(net, 32, "mixed")
    net = _block_a(net, 64, "mixed_1")
    net = _block_a(net, 64, "mixed_2")
    net = _grid_reduce_a(net, "mixed_3")
    # 4 x B (17x17)
    net = _block_b(net, 128, "mixed_4")
    net = _block_b(net, 160, "mixed_5")
    net = _block_b(net, 160, "mixed_6")
    net = _block_b(net, 192, "mixed_7")
    net = _grid_reduce_b(net, "mixed_8")
    # 2 x C (8x8)
    net = _block_c(net, "avg", "mixed_9")
    net = _block_c(net, "max", "mixed_10")
    net = sym.Pooling(data=net, kernel=(8, 8), global_pool=True,
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(data=net, name="flatten")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
