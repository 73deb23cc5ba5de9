"""Neural-network layer ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the transformer's and the
ResNet's paths: ``FullyConnected`` (flatten and ``flatten=False``, weight in
the (N, K) layout), ``Convolution`` (NCHW data, OIHW weight; stride, pad,
dilate, num_group, bias), ``Pooling`` (max, avg and sum; ``global_pool``;
the ``valid`` and ``full`` conventions; avg counts the padding, as the
reference's pool does), ``BatchNorm`` (moving-stat aux state; a training
forward through the hand-derived backward of JAX ``_bn_train_core``, an
autograd Function), ``Activation``, ``softmax`` and ``SoftmaxOutput``, the
training symbol's head, whose backward is its own loss gradient (an autograd
Function, the JAX package's ``custom_vjp``), Dropout, LRN, and the rest of
the JAX module's layers: ``Deconvolution``, ``LeakyReLU``, ``log_softmax``,
``SoftmaxActivation``, the regression outputs, ``MakeLoss``, ``SVMOutput``,
``IdentityAttachKLSparseReg``, ``InstanceNorm``, ``L2Normalization`` and
``UpSampling``. A product or convolution
outside any fused site stays ``torch.matmul`` or ``F.conv2d``, as the JAX
package leaves them to XLA; the other ops differentiate through torch.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import AttrSpec, register


def _fc_names(attrs):
    return ["data", "weight"] if attrs.get("no_bias") else ["data", "weight", "bias"]


@register("FullyConnected", attrs={"num_hidden": AttrSpec("int", required=True),
                                   "no_bias": AttrSpec("bool", default=False),
                                   "flatten": AttrSpec("bool", default=True)},
          input_names=_fc_names)
def _fully_connected(attrs, data, weight, bias=None):
    """y = x · Wᵀ + b; ``flatten=False`` applies over the last axis."""
    if attrs.get("flatten", True) and data.ndim != 2:
        data = data.reshape(data.shape[0], -1)
    y = torch.matmul(data, weight.t())
    if bias is not None:
        y = y + bias
    return y


# --- Convolution (JAX mxnet_tpu/ops/nn.py:84) ---------------------------------
def _conv_attrs():
    return {
        "kernel": AttrSpec("shape", required=True),
        "stride": AttrSpec("shape", default=()),
        "dilate": AttrSpec("shape", default=()),
        "pad": AttrSpec("shape", default=()),
        "num_filter": AttrSpec("int", required=True),
        "num_group": AttrSpec("int", default=1),
        "workspace": AttrSpec("int", default=1024),
        "no_bias": AttrSpec("bool", default=False),
        "cudnn_tune": AttrSpec("str", default=None),
        "cudnn_off": AttrSpec("bool", default=False),
        "layout": AttrSpec("str", default=None),
        "target_shape": AttrSpec("shape", default=()),
        "adj": AttrSpec("shape", default=()),
    }


def _spatial(attrs, key, nd, fill):
    v = attrs.get(key) or ()
    return tuple(v) if len(v) == nd else (fill,) * nd


_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", attrs=_conv_attrs(), input_names=_fc_names,
          aliases=("Convolution_v1",))
def _convolution(attrs, data, weight, bias=None):
    """NC+spatial data, OI+spatial weight (the reference's layouts); the
    bias is added after the product, as the JAX op adds it."""
    nd = len(attrs["kernel"])
    out = _CONV_FNS[nd](data, weight, None, _spatial(attrs, "stride", nd, 1),
                        _spatial(attrs, "pad", nd, 0), _spatial(attrs, "dilate", nd, 1),
                        attrs["num_group"])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# --- Pooling (JAX mxnet_tpu/ops/nn.py:140) -------------------------------------
@register("Pooling", attrs={"kernel": AttrSpec("shape", required=True),
                            "pool_type": AttrSpec("str", default="max"),
                            "global_pool": AttrSpec("bool", default=False),
                            "stride": AttrSpec("shape", default=()),
                            "pad": AttrSpec("shape", default=()),
                            "pooling_convention": AttrSpec("str", default="valid"),
                            "cudnn_off": AttrSpec("bool", default=False)},
          aliases=("Pooling_v1",))
def _pooling(attrs, data):
    """Max, avg or sum over windows. The padding is explicit, as the JAX
    op's ``reduce_window`` pads: -inf for max, 0 for avg and sum, and for the
    ``full`` convention the high edge is padded by JAX's own formula
    (:165-172) rather than ``ceil_mode``'s. Avg divides by the window size
    (count-include-pad)."""
    nd = data.ndim - 2
    if attrs["global_pool"]:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    else:
        kernel = tuple(attrs["kernel"])
        stride, pad = _spatial(attrs, "stride", nd, 1), _spatial(attrs, "pad", nd, 0)
    if attrs["pooling_convention"] == "full":
        pads = []
        for i in range(nd):
            in_sz = data.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(in_sz - kernel[i]) // stride[i]) + 1
            needed = (out_sz - 1) * stride[i] + kernel[i] - in_sz
            pads.append((pad[i], pad[i] + max(needed, 0)))
    else:
        pads = [(p, p) for p in pad]
    pt = attrs["pool_type"]
    if pt not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %r" % pt)
    if nd == 1:  # as a 2-D pool over a unit row
        out = _pooling_nd(data.unsqueeze(2), (1,) + kernel, (1,) + stride,
                          [(0, 0)] + pads, pt)
        return out.squeeze(2)
    return _pooling_nd(data, kernel, stride, pads, pt)


def _pooling_nd(data, kernel, stride, pads, pool_type):
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]  # F.pad: last axis first
    if any(flat):
        data = F.pad(data, flat, value=-math.inf if pool_type == "max" else 0.0)
    nd = data.ndim - 2
    if pool_type == "max":
        return (F.max_pool2d if nd == 2 else F.max_pool3d)(data, kernel, stride)
    avg = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return avg(data, kernel, stride, divisor_override=1 if pool_type == "sum" else None)


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # logaddexp(x, 0), as jnp.logaddexp computes it
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)),
}


@register("Activation", attrs={"act_type": AttrSpec("str", required=True)})
def _activation(attrs, data):
    t = attrs["act_type"]
    if t not in _ACTS:
        raise MXNetError("unknown act_type %r" % t)
    return _ACTS[t](data)


@register("softmax", attrs={"axis": AttrSpec("int", default=-1),
                            "temperature": AttrSpec("any", default=None)})
def _softmax(attrs, data):
    t = attrs.get("temperature")
    if t not in (None, "None"):
        data = data / float(t)
    return F.softmax(data, dim=attrs["axis"])


@register("SoftmaxOutput", attrs={"grad_scale": AttrSpec("float", default=1.0),
                                  "ignore_label": AttrSpec("float", default=-1.0),
                                  "multi_output": AttrSpec("bool", default=False),
                                  "use_ignore": AttrSpec("bool", default=False),
                                  "preserve_shape": AttrSpec("bool", default=False),
                                  "normalization": AttrSpec("str", default="null"),
                                  "out_grad": AttrSpec("bool", default=False)},
          input_names=("data", "label"), aliases=("Softmax",))
def _softmax_output(attrs, data, label):
    """Softmax forward with the cross-entropy gradient on backward, ignoring
    the head gradient exactly like the reference (softmax_output-inl.h)."""
    return _SoftmaxOutput.apply(data, label, attrs)


def _softmax_output_grad(prob, label, attrs):
    """(p − onehot(y))·grad_scale with 'null'|'batch'|'valid' normalization
    (JAX ``_softmax_output_grad``, mxnet_tpu/ops/nn.py:420). A label outside
    [0, C) has an all-zero one-hot row, as ``jax.nn.one_hot`` gives it."""
    multi = attrs["multi_output"] and prob.ndim > 2
    axis = 1 if multi else prob.ndim - 1
    classes = torch.arange(prob.shape[axis], device=prob.device)
    classes = classes.reshape([-1 if i == axis else 1 for i in range(prob.ndim)])
    onehot = (label.long().unsqueeze(axis) == classes).to(prob.dtype)
    grad = prob - onehot
    valid = torch.ones(label.shape, dtype=prob.dtype, device=prob.device)
    if attrs["use_ignore"]:
        keep = (label != attrs["ignore_label"]).to(prob.dtype)
        grad = grad * keep.unsqueeze(axis)
        valid = keep
    norm = attrs["normalization"]
    if norm == "batch":
        grad = grad / label.shape[0]
    elif norm == "valid":
        grad = grad / torch.clamp(valid.sum(), min=1.0)
    return grad * attrs["grad_scale"]


class _SoftmaxOutput(torch.autograd.Function):
    """Class probabilities forward; backward returns the loss gradient and
    ignores the incoming head gradient. The label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        axis = 1 if (attrs["multi_output"] and data.ndim > 2) else -1
        prob = F.softmax(data, dim=axis)
        ctx.save_for_backward(prob, label)
        ctx.attrs = attrs
        return prob

    @staticmethod
    def backward(ctx, grad):
        prob, label = ctx.saved_tensors
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return _softmax_output_grad(prob, label, ctx.attrs), dlabel, None


# --- BatchNorm (JAX mxnet_tpu/ops/nn.py:367) -----------------------------------
def _bn_outputs(attrs):
    return 3 if attrs.get("output_mean_var") else 1


def _bn_axes(x):
    return (0,) + tuple(range(2, x.ndim))


class _BatchNormTrain(torch.autograd.Function):
    """``(out, mean, var)`` of a training BatchNorm with the hand-derived
    backward of JAX ``_bn_train_core`` (:291, backward :338-361): the biased
    batch variance, every reduction in a float32 accumulator, dgamma 0 under
    fix_gamma, and the cotangents of the mean and var outputs folded into dx
    (``output_mean_var=True`` graphs differentiate through them)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, fix_gamma):
        axes, b = _bn_axes(x), (1, -1) + (1,) * (x.ndim - 2)
        acc = torch.promote_types(x.dtype, torch.float32)
        cnt = x.numel() // x.shape[1]
        x32 = x.to(acc)
        mean = x32.sum(dim=axes) / cnt
        var = (x32 * x32).sum(dim=axes) / cnt - mean * mean
        m, istd = mean.to(x.dtype), torch.rsqrt(var + eps).to(x.dtype)
        xhat = (x - m.reshape(b)) * istd.reshape(b)
        out = xhat + beta.reshape(b) if fix_gamma else xhat * gamma.reshape(b) + beta.reshape(b)
        ctx.save_for_backward(x, gamma, m, istd)
        ctx.fix_gamma = fix_gamma
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, ct_mean, ct_var):
        x, gamma, m, istd = ctx.saved_tensors
        axes, b = _bn_axes(x), (1, -1) + (1,) * (x.ndim - 2)
        acc = torch.promote_types(x.dtype, torch.float32)
        cnt = x.numel() // x.shape[1]
        dy = torch.zeros_like(x) if dy is None else dy
        xhat = (x - m.reshape(b)) * istd.reshape(b)
        dbeta32 = dy.to(acc).sum(dim=axes)
        dgamma32 = (dy * xhat).to(acc).sum(dim=axes)
        g_istd = (istd if ctx.fix_gamma else gamma * istd).to(x.dtype)
        c1, c2 = (dbeta32 / cnt).to(x.dtype), (dgamma32 / cnt).to(x.dtype)
        dx = g_istd.reshape(b) * (dy - c1.reshape(b) - xhat * c2.reshape(b))
        if ct_mean is not None:
            dx = dx + (ct_mean / cnt).to(x.dtype).reshape(b)
        if ct_var is not None:
            dx = dx + (2.0 * ct_var / cnt).to(x.dtype).reshape(b) * (x - m.reshape(b))
        dgamma = torch.zeros_like(dgamma32) if ctx.fix_gamma else dgamma32
        return dx, dgamma.to(gamma.dtype), dbeta32.to(gamma.dtype), None, None


def _batch_norm_across(mesh, x, gamma, beta, eps, fix_gamma):
    """A training BatchNorm in a fused step whose mesh spans processes:
    the moments are the global batch's (``fusion._global_moments``: the
    per-rank sums of x and x² summed over the mesh, the backward summing
    their cotangents), as the JAX package's reductions over a sharded
    batch give. Autograd derives the backward through the float32 sums."""
    from ..fusion import _global_moments

    b = (1, -1) + (1,) * (x.ndim - 2)
    mean, var = _global_moments(x, mesh)
    xhat = (x - mean.to(x.dtype).reshape(b)) * torch.rsqrt(var + eps).to(x.dtype).reshape(b)
    out = xhat + beta.reshape(b) if fix_gamma else xhat * gamma.reshape(b) + beta.reshape(b)
    return out, mean, var


@register("BatchNorm", attrs={"eps": AttrSpec("float", default=1e-3),
                              "momentum": AttrSpec("float", default=0.9),
                              "fix_gamma": AttrSpec("bool", default=True),
                              "use_global_stats": AttrSpec("bool", default=False),
                              "output_mean_var": AttrSpec("bool", default=False)},
          input_names=("data", "gamma", "beta"), aux_names=("moving_mean", "moving_var"),
          num_outputs=_bn_outputs,
          output_names=lambda a: ["output", "mean", "var"][: _bn_outputs(a)],
          needs_train_flag=True)
def _batch_norm(attrs, inputs, aux, is_train=False):
    """Channel-axis-1 batch norm. A training forward (without
    use_global_stats) normalises with the batch statistics and returns the
    new moving stats, ``moving·momentum + batch·(1 − momentum)``, as the
    op's new aux values; the executor writes them into the aux arrays. An
    inference forward normalises with the moving stats."""
    data, gamma, beta = inputs
    moving_mean, moving_var = aux
    eps, momentum = attrs["eps"], attrs["momentum"]
    b = (1, -1) + (1,) * (data.ndim - 2)
    if is_train and not attrs["use_global_stats"]:
        from ..fusion import _cross_process_mesh

        mesh = _cross_process_mesh()
        if mesh is not None:
            out, mean, var = _batch_norm_across(mesh, data, gamma, beta, float(eps),
                                                bool(attrs["fix_gamma"]))
        else:
            out, mean, var = _BatchNormTrain.apply(data, gamma, beta, float(eps),
                                                   bool(attrs["fix_gamma"]))
        new_mean = moving_mean * momentum + mean.detach() * (1 - momentum)
        new_var = moving_var * momentum + var.detach() * (1 - momentum)
        outs = (out, mean.to(data.dtype), var.to(data.dtype)) if attrs["output_mean_var"] \
            else (out,)
        return outs, (new_mean, new_var)
    if attrs["fix_gamma"]:
        gamma = torch.ones_like(gamma)  # a constant: no gradient reaches gamma
    out = (data - moving_mean.reshape(b)) * torch.rsqrt(moving_var.reshape(b) + eps)
    out = out * gamma.reshape(b) + beta.reshape(b)
    outs = (out, moving_mean, moving_var) if attrs["output_mean_var"] else (out,)
    return outs, (moving_mean, moving_var)


# --- Dropout and LRN (JAX mxnet_tpu/ops/nn.py:241-255, :624-646) ---------------
@register("Dropout", attrs={"p": AttrSpec("float", default=0.5)}, needs_rng=True,
          needs_train_flag=True)
def _dropout(attrs, data, is_train=False, rng=None):
    """Inverted dropout (reference: dropout-inl.h); identity at inference.
    A training forward draws its keep mask once from ``rng``, the generator
    of the bind's device (``random.generator``), on that device; autograd
    keeps the mask, so the backward reuses it: dx = dy·m/(1 − p)."""
    p = attrs["p"]
    if not is_train or p <= 0.0 or rng is None:
        return data
    return inverted_dropout(data, p, rng)


def inverted_dropout(x, p, rng):
    """``x·m/(1 − p)`` for a keep mask m drawn from ``rng`` on x's device
    (the RNN op's dropout between layers too)."""
    keep = 1.0 - p
    mask = torch.empty(x.shape, dtype=torch.float32, device=x.device).bernoulli_(
        keep, generator=rng).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@register("LRN", attrs={"alpha": AttrSpec("float", default=1e-4),
                        "beta": AttrSpec("float", default=0.75),
                        "knorm": AttrSpec("float", default=2.0),
                        "nsize": AttrSpec("int", required=True)})
def _lrn(attrs, data):
    """Local response norm across channels (reference: lrn.cc): the sum of
    squares over a window of ``nsize`` channels, zero-padded at the ends."""
    n = attrs["nsize"]
    half = n // 2
    sq = F.pad(data * data, (0, 0) * (data.ndim - 2) + (half, half))
    C = data.shape[1]
    ssum = sq[:, 0:C]
    for i in range(1, n):
        ssum = ssum + sq[:, i:i + C]
    norm = attrs["knorm"] + (attrs["alpha"] / n) * ssum
    return data * torch.pow(norm, -attrs["beta"])


# --- The rest of the layer library (JAX mxnet_tpu/ops/nn.py) ---------------------
_DECONV_FNS = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@register("Deconvolution", attrs=_conv_attrs(), input_names=_fc_names)
def _deconvolution(attrs, data, weight, bias=None):
    """Transposed convolution (JAX :104). MXNet's weight layout (C_in,
    num_filter/g, *kernel) is ``conv_transpose``'s; ``adj`` adds to the high
    edge. ``target_shape`` is parsed and not read, as the JAX op reads it
    not."""
    nd = len(attrs["kernel"])
    out = _DECONV_FNS[nd](data, weight, None, _spatial(attrs, "stride", nd, 1),
                          _spatial(attrs, "pad", nd, 0), _spatial(attrs, "adj", nd, 0),
                          attrs["num_group"])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _lrelu_names(attrs):
    return ["data", "gamma"] if attrs.get("act_type") == "prelu" else ["data"]


@register("LeakyReLU", attrs={"act_type": AttrSpec("str", default="leaky"),
                              "slope": AttrSpec("float", default=0.25),
                              "lower_bound": AttrSpec("float", default=0.125),
                              "upper_bound": AttrSpec("float", default=0.334)},
          input_names=_lrelu_names, needs_rng=True, needs_train_flag=True)
def _leaky_relu(attrs, data, gamma=None, is_train=False, rng=None):
    """leaky|elu|prelu|rrelu (JAX :208). rrelu's slopes are drawn in a
    training forward only, from ``rng`` (the bind device's generator) on
    data's device, U(lower_bound, upper_bound) an element; at inference the
    slope is their mean."""
    t = attrs["act_type"]
    if t == "leaky":
        return torch.where(data >= 0, data, attrs["slope"] * data)
    if t == "elu":
        return torch.where(data >= 0, data, attrs["slope"] * torch.expm1(data))
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) if data.ndim > 2 else gamma
        return torch.where(data >= 0, data, g * data)
    if t == "rrelu":
        if is_train and rng is not None:
            slope = torch.empty(data.shape, dtype=data.dtype, device=data.device).uniform_(
                attrs["lower_bound"], attrs["upper_bound"], generator=rng)
        else:
            slope = (attrs["lower_bound"] + attrs["upper_bound"]) / 2.0
        return torch.where(data >= 0, data, slope * data)
    raise MXNetError("unknown act_type %r" % t)


@register("log_softmax", attrs={"axis": AttrSpec("int", default=-1)})
def _log_softmax(attrs, data):
    return F.log_softmax(data, dim=attrs["axis"])


@register("SoftmaxActivation", attrs={"mode": AttrSpec("str", default="instance")})
def _softmax_activation(attrs, data):
    """instance: over each sample's trailing axes; channel: over axis 1
    (JAX :273)."""
    if attrs["mode"] == "channel":
        return F.softmax(data, dim=1)
    return F.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(data.shape)


class _LossHead(torch.autograd.Function):
    """A loss layer's head: ``forward`` gives ``fwd(data)``; ``backward``
    ignores the incoming gradient and returns ``grad(out, label)`` for data
    and zeros for the label (the JAX ops' ``custom_vjp``s)."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad):
        out = fwd(data)
        ctx.save_for_backward(out, data, label)
        ctx.grad = grad
        return out

    @staticmethod
    def backward(ctx, _head):
        out, data, label = ctx.saved_tensors
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return ctx.grad(out, data, label).to(data.dtype), dlabel, None, None


def _make_output_op(name, fwd, grad):
    """The regression-output family (JAX :489): ``grad(out, label)`` times
    grad_scale over the output's size per sample."""

    def g(out, data, label, scale):
        num_output = max(int(np.prod(out.shape[1:])), 1)
        return grad(out, label.reshape(out.shape)) * (scale / num_output)

    @register(name, attrs={"grad_scale": AttrSpec("float", default=1.0)},
              input_names=("data", "label"))
    def op(attrs, data, label):
        scale = float(attrs["grad_scale"])
        return _LossHead.apply(data, label, fwd, lambda o, d, y: g(o, d, y, scale))

    op.__doc__ = "%s (reference: regression_output-inl.h)." % name
    return op


_make_output_op("LinearRegressionOutput", lambda x: x.view_as(x), lambda o, y: o - y)
_make_output_op("LogisticRegressionOutput", torch.sigmoid, lambda o, y: o - y)
_make_output_op("MAERegressionOutput", lambda x: x.view_as(x), lambda o, y: torch.sign(o - y))


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward emits grad_scale / norm_div everywhere."""

    @staticmethod
    def forward(ctx, data, value):
        ctx.value = value
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.value), None


@register("MakeLoss", attrs={"grad_scale": AttrSpec("float", default=1.0),
                             "valid_thresh": AttrSpec("float", default=0.0),
                             "normalization": AttrSpec("str", default="null")})
def _make_loss(attrs, data):
    """Treat data as a loss: the backward emits grad_scale (JAX :546),
    divided by the batch size under ``normalization="batch"``. As in the
    JAX op, "valid" divides by nothing (ROADMAP.md §3)."""
    norm_div = float(data.shape[0]) if attrs["normalization"] == "batch" else 1.0
    return _MakeLoss.apply(data, float(attrs["grad_scale"]) / norm_div)


def _svm_grad(margin, coef, use_linear):
    def grad(out, data, label):
        onehot = (label.long().unsqueeze(-1)
                  == torch.arange(data.shape[-1], device=data.device)).to(data.dtype)
        ty = 2.0 * onehot - 1.0  # +1 for the target class, -1 otherwise
        viol = (margin - ty * data) > 0
        if use_linear:
            d = -ty * coef
        else:
            d = -2.0 * coef * (margin - ty * data) * ty
        return torch.where(viol, d, torch.zeros((), dtype=data.dtype, device=data.device))

    return grad


@register("SVMOutput", attrs={"margin": AttrSpec("float", default=1.0),
                              "regularization_coefficient": AttrSpec("float", default=1.0),
                              "use_linear": AttrSpec("bool", default=False)},
          input_names=("data", "label"))
def _svm_output(attrs, data, label):
    """Hinge-loss output layer (JAX :584): identity forward, the squared (or
    linear) hinge gradient on backward."""
    return _LossHead.apply(data, label, lambda x: x.view_as(x),
                           _svm_grad(attrs["margin"], attrs["regularization_coefficient"],
                                     bool(attrs["use_linear"])))


@register("IdentityAttachKLSparseReg", attrs={"sparseness_target": AttrSpec("float", default=0.1),
                                              "penalty": AttrSpec("float", default=0.001),
                                              "momentum": AttrSpec("float", default=0.9)},
          aux_names=("moving_avg",))
def _identity_kl(attrs, inputs, aux):
    """Identity forward whose gradient gains the KL sparseness penalty of
    the mean activation (JAX :600); the aux moving average follows that
    mean in every forward."""
    (data,), (moving,) = inputs, aux
    rho_hat = torch.sigmoid(data).mean()
    new_moving = moving * attrs["momentum"] + rho_hat.detach() * (1 - attrs["momentum"])
    rho = attrs["sparseness_target"]
    penalty = attrs["penalty"] * (-rho / (rho_hat + 1e-8) + (1 - rho) / (1 - rho_hat + 1e-8))
    out = data + penalty.detach() * (data - data.detach())
    return (out,), (new_moving,)


@register("InstanceNorm", attrs={"eps": AttrSpec("float", default=1e-3)},
          input_names=("data", "gamma", "beta"))
def _instance_norm(attrs, data, gamma, beta):
    """Per-sample, per-channel normalisation over the spatial axes with the
    biased variance (JAX :646)."""
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, keepdim=True, correction=0)
    b = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * torch.rsqrt(var + attrs["eps"])
    return out * gamma.reshape(b) + beta.reshape(b)


@register("L2Normalization", attrs={"eps": AttrSpec("float", default=1e-10),
                                    "mode": AttrSpec("str", default="instance")})
def _l2_normalization(attrs, data):
    """x / sqrt(Σx² + eps) over each instance, channel column or spatial
    plane (JAX :661)."""
    mode = attrs["mode"]
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, data.ndim))
    return data / torch.sqrt((data * data).sum(dim=axes, keepdim=True) + attrs["eps"])


@register("UpSampling", attrs={"scale": AttrSpec("int", required=True),
                               "num_filter": AttrSpec("int", default=0),
                               "sample_type": AttrSpec("str", default="nearest"),
                               "multi_input_mode": AttrSpec("str", default="concat"),
                               "num_args": AttrSpec("int", default=1),
                               "workspace": AttrSpec("int", default=512)},
          input_names=lambda a: ["arg%d" % i for i in range(int(a.get("num_args", 1)))])
def _upsampling(attrs, *args):
    """Nearest or bilinear upsampling of every input by ``scale``, then
    concatenated (or summed) over the channels (JAX :678). Bilinear resizes
    each input with half-pixel centres, as ``jax.image.resize`` does; like
    the JAX op it does not read a weight input as the reference's
    deconvolution would (ROADMAP.md §3)."""
    s = attrs["scale"]
    outs = []
    for data in args:
        if attrs["sample_type"] == "nearest":
            outs.append(data.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3))
        else:
            outs.append(F.interpolate(data, scale_factor=s, mode="bilinear",
                                      align_corners=False))
    if len(outs) == 1:
        return outs[0]
    if attrs["multi_input_mode"] == "sum":
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    return torch.cat(outs, dim=1)
