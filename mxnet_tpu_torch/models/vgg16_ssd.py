# copied from mxnet_tpu/models/vgg16_ssd.py (backend-free), with example/ssd's
# synthetic data (SyntheticDetIter) and SSD loss (ssd_objective) added
"""VGG16-reduced SSD-300 training symbol (reference: example/ssd/symbol/
symbol_vgg16_ssd_300.py + common.py multibox_layer; BASELINE.json config 4).

The canonical anchor specification — six feature scales (conv4_3 with a
learnable L2-norm scale, fc7, conv8_2 ... conv11_2), SSD paper sizes/ratios —
with the fc6 hole-algorithm conv (3x3, dilation 6). Training losses follow
the reference exactly: hard-negative-mined SoftmaxOutput over anchor classes
plus smooth-L1 MakeLoss on masked location offsets; the port runs the
multi-loss graph op by op through its executor.
"""
import json

import numpy as np
import torch

from .. import symbol as sym

# SSD-300 anchor spec (reference symbol_vgg16_ssd_300.py:118-122)
SIZES = [[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79],
         [.88, .961]]
RATIOS = [[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
          [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]
NORMALIZATIONS = [20, -1, -1, -1, -1, -1]


def _conv_relu(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
               stride=(1, 1), dilate=None):
    kw = {"dilate": dilate} if dilate else {}
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        pad=pad, stride=stride, name="conv%s" % name, **kw)
    return sym.Activation(data=c, act_type="relu", name="relu%s" % name)


def _vgg_stage(data, name, num_filter, convs, pool_kernel=(2, 2),
               pool_stride=(2, 2), pool_pad=(0, 0), pool_convention="valid"):
    net = data
    for i in range(convs):
        net = _conv_relu(net, "%s_%d" % (name, i + 1), num_filter)
    feat = net
    net = sym.Pooling(data=net, pool_type="max", kernel=pool_kernel,
                      stride=pool_stride, pad=pool_pad,
                      pooling_convention=pool_convention,
                      name="pool%s" % name)
    return net, feat


def _backbone(data):
    """VGG16 body with SSD modifications: pool5 3x3/1, dilated conv6 (the
    surgery replacing fc6/fc7), plus the extra pyramid layers."""
    net, _ = _vgg_stage(data, "1", 64, 2)
    net, _ = _vgg_stage(net, "2", 128, 2)
    # pool3 uses ceil-mode ('full') so 75 → 38, matching the reference
    net, _ = _vgg_stage(net, "3", 256, 3, pool_convention="full")
    net, conv4_3 = _vgg_stage(net, "4", 512, 3)
    net, _ = _vgg_stage(net, "5", 512, 3, pool_kernel=(3, 3),
                        pool_stride=(1, 1), pool_pad=(1, 1))
    net = _conv_relu(net, "6", 1024, pad=(6, 6), dilate=(6, 6))
    relu7 = _conv_relu(net, "7", 1024, kernel=(1, 1), pad=(0, 0))
    # extra layers: 1x1 squeeze then 3x3 (stride 2 for 8/9, valid for 10/11)
    net = _conv_relu(relu7, "8_1", 256, kernel=(1, 1), pad=(0, 0))
    conv8_2 = _conv_relu(net, "8_2", 512, stride=(2, 2))
    net = _conv_relu(conv8_2, "9_1", 128, kernel=(1, 1), pad=(0, 0))
    conv9_2 = _conv_relu(net, "9_2", 256, stride=(2, 2))
    net = _conv_relu(conv9_2, "10_1", 128, kernel=(1, 1), pad=(0, 0))
    conv10_2 = _conv_relu(net, "10_2", 256, pad=(0, 0))
    net = _conv_relu(conv10_2, "11_1", 128, kernel=(1, 1), pad=(0, 0))
    conv11_2 = _conv_relu(net, "11_2", 256, pad=(0, 0))
    return [conv4_3, relu7, conv8_2, conv9_2, conv10_2, conv11_2]


def multibox_layer(layers, num_classes, sizes, ratios, normalizations=None,
                   num_channels=()):
    """Per-scale class/location heads + anchors (reference: common.py
    multibox_layer). ``num_channels`` supplies the channel count for each
    normalized layer (consumed in order), sizing its learnable scale.
    Returns (cls_preds (B,C+1,N), loc_preds (B,4N), anchors (1,N,4))."""
    cls_layers, loc_layers, anchor_layers = [], [], []
    if normalizations is None:
        normalizations = [-1] * len(layers)
    channels = list(num_channels)
    for i, (feat, size, ratio, norm) in enumerate(
            zip(layers, sizes, ratios, normalizations)):
        if norm > 0:
            if not channels:
                raise ValueError(
                    "multibox_layer: normalizations[%d] > 0 needs a "
                    "num_channels entry to size the scale variable" % i)
            feat = sym.L2Normalization(data=feat, mode="channel",
                                       name="norm_%d" % i)
            scale = sym.Variable(
                "scale_%d" % i,
                attr={"__shape__": json.dumps([1, channels.pop(0), 1, 1]),
                      "__init__": json.dumps(["Constant", {"value": norm}])})
            feat = sym.broadcast_mul(scale, feat, name="scaled_%d" % i)
        na = len(size) + len(ratio) - 1
        cls = sym.Convolution(data=feat, num_filter=na * (num_classes + 1),
                              kernel=(3, 3), pad=(1, 1),
                              name="cls_pred_%d" % i)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Reshape(cls, shape=(0, -1, num_classes + 1)))
        loc = sym.Convolution(data=feat, num_filter=na * 4, kernel=(3, 3),
                              pad=(1, 1), name="loc_pred_%d" % i)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Reshape(loc, shape=(0, -1)))
        anchor_layers.append(sym.MultiBoxPrior(
            feat, sizes=size, ratios=ratio, name="anchors_%d" % i))
    cls_preds = sym.Concat(*cls_layers, dim=1, name="cls_preds_pre")
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1), name="cls_preds")
    loc_preds = sym.Concat(*loc_layers, dim=1, name="loc_preds")
    anchors = sym.Concat(*anchor_layers, dim=1, name="anchors")
    return cls_preds, loc_preds, anchors


def ssd_losses(cls_preds, loc_preds, anchors, label):
    """The reference's SSD training tail: MultiBoxTarget with 3:1 hard
    negative mining → ignore-aware SoftmaxOutput + masked smooth-L1 MakeLoss
    (symbol_vgg16_ssd_300.py:129-147)."""
    loc_target, loc_target_mask, cls_target = sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5, ignore_label=-1,
        negative_mining_ratio=3, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss_ = sym.smooth_l1(data=loc_diff, scalar=1.0, name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0, name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def get_symbol_train(num_classes=20, **kwargs):
    """Training graph: backbone → heads → MultiBoxTarget → losses
    (reference: symbol_vgg16_ssd_300.py get_symbol_train)."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    layers = _backbone(data)
    cls_preds, loc_preds, anchors = multibox_layer(
        layers, num_classes, SIZES, RATIOS, NORMALIZATIONS,
        num_channels=[512])
    return ssd_losses(cls_preds, loc_preds, anchors, label)


def get_symbol(num_classes=20, nms_thresh=0.5, nms_topk=400, **kwargs):
    """Deploy graph: heads → MultiBoxDetection (reference: get_symbol)."""
    data = sym.Variable("data")
    layers = _backbone(data)
    cls_preds, loc_preds, anchors = multibox_layer(
        layers, num_classes, SIZES, RATIOS, NORMALIZATIONS,
        num_channels=[512])
    cls_prob = sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                     name="cls_prob")
    return sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                 name="detection", nms_threshold=nms_thresh,
                                 variances=(0.1, 0.1, 0.2, 0.2),
                                 nms_topk=nms_topk)


# --- example/ssd/train_ssd.py's synthetic data and the SSD loss --------------
class SyntheticDetIter:
    """example/ssd/train_ssd.py's ``SyntheticDetIter`` on the port: random
    rectangles of ``num_classes`` colours with labels in the SSD layout,
    (B, max_objects, 5) rows of [cls, xmin, ymin, xmax, ymax] padded with
    -1; ``num_batches`` fixed batches, each drawn once from the seed (numpy
    in ``batches``, NDArrays on the current context in the iteration)."""

    def __init__(self, batch_size, data_shape, num_classes, num_batches, max_objects=4,
                 seed=0):
        from .. import io, ndarray

        self._io, self.batch_size, self.num_batches, self.cur = io, batch_size, num_batches, 0
        rs = np.random.RandomState(seed)
        self.batches = []
        for _ in range(num_batches):
            b, c, h, w = (batch_size,) + tuple(data_shape)
            imgs = np.zeros((b, c, h, w), np.float32)
            labels = -np.ones((b, max_objects, 5), np.float32)
            for i in range(b):
                for j in range(rs.randint(1, max_objects + 1)):
                    cls = rs.randint(0, num_classes)
                    x0, y0 = rs.uniform(0, 0.6, 2)
                    x1, y1 = x0 + rs.uniform(0.2, 0.4), y0 + rs.uniform(0.2, 0.4)
                    x1, y1 = min(x1, 1.0), min(y1, 1.0)
                    imgs[i, cls % c, int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)] = 1.0
                    labels[i, j] = [cls, x0, y0, x1, y1]
            self.batches.append((imgs, labels))
        self.provide_data = [io.DataDesc("data", (batch_size,) + tuple(data_shape))]
        self.provide_label = [io.DataDesc("label", (batch_size, max_objects, 5))]
        self._nd = [(ndarray.array(x), ndarray.array(y)) for x, y in self.batches]

    def __iter__(self):
        return self

    def reset(self):
        self.cur = 0

    def __next__(self):
        if self.cur >= self.num_batches:
            raise StopIteration
        data, label = self._nd[self.cur]
        self.cur += 1
        return self._io.DataBatch(data=[data], label=[label], pad=0)

    next = __next__


def ssd_objective(outs):
    """The SSD loss of a training forward's outputs (cls_prob, loc_loss,
    cls_label): the cross-entropy over the anchors with a target (the
    SoftmaxOutput's valid ones), averaged, plus the smooth-L1 location loss
    a batch row."""
    prob, loc, target = (o._tensor() if hasattr(o, "_tensor") else o for o in outs)
    valid = target >= 0
    picked = prob.gather(1, target.clamp(min=0).long()[:, None])[:, 0]
    ce = -(torch.log(picked.clamp_min(1e-30)) * valid).sum() / valid.sum().clamp(min=1)
    return float(ce + loc.sum() / prob.shape[0])
