"""ResNet v2 (pre-activation): the symbol builder of the JAX package's zoo.

Copied from ``mxnet_tpu/models/resnet.py`` (backend-free, the same node
names and JSON), the counterpart of the reference's
example/image-classification/symbols/resnet.py (He et al., "Identity
Mappings in Deep Residual Networks"). Depths 18/34 use the basic 2-conv
block, 50/101/152 the 1-3-1 bottleneck, with stage filter counts
(64,128,256,512)×{1,4}. Bound and run through the port's executor, its
BN -> relu -> conv chains take the fused conv+BN kernels (``fusion.py``).
"""
from .. import symbol as sym

_BN_MOM = 0.9
_BN_EPS = 2e-5


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True):
    """One pre-activation residual unit (reference resnet.py residual_unit)."""
    if bottle_neck:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=num_filter // 4, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter // 4, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(data=act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter, kernel=(1, 1),
                                       stride=stride, no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name=name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(data=act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True, name=name + "_conv1")
    bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name=name + "_bn2")
    act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(data=act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True, name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=act1, num_filter=num_filter, kernel=(1, 1),
                                   stride=stride, no_bias=True, name=name + "_sc")
    return conv2 + shortcut


_DEPTHS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224", **kwargs):
    """Build a ResNet Symbol (reference resnet.py get_symbol)."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    if num_layers not in _DEPTHS:
        raise ValueError("resnet num_layers must be one of %s" % sorted(_DEPTHS))
    units, bottle_neck = _DEPTHS[num_layers]
    filter_list = [64, 256, 512, 1024, 2048] if bottle_neck else [64, 64, 128, 256, 512]

    data = sym.Variable("data")
    (_, height, _) = image_shape
    if height <= 32:  # cifar-style stem (reference resnet.py small-image path)
        body = sym.Convolution(data=data, num_filter=filter_list[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True, name="conv0")
    else:
        body = sym.Convolution(data=data, num_filter=filter_list[0], kernel=(7, 7),
                               stride=(2, 2), pad=(3, 3), no_bias=True, name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", name="pool0")

    for stage, n_unit in enumerate(units):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = residual_unit(body, filter_list[stage + 1], stride, False,
                             name="stage%d_unit1" % (stage + 1), bottle_neck=bottle_neck)
        for j in range(n_unit - 1):
            body = residual_unit(body, filter_list[stage + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (stage + 1, j + 2),
                                 bottle_neck=bottle_neck)

    bn1 = sym.BatchNorm(data=body, fix_gamma=False, eps=_BN_EPS, momentum=_BN_MOM, name="bn1")
    relu1 = sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7), pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
