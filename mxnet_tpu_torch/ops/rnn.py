"""Fused multi-layer RNN op.

Counterpart of ``mxnet_tpu/ops/rnn.py`` (:25-185), the reference's
cuDNN-backed ``RNN`` operator (src/operator/rnn.cc:34). The same packed
parameter layout as ``FusedRNNCell`` (``rnn/rnn_cell.py``): per layer (and
per direction) i2h_weight then h2h_weight, then all biases (i2h_bias,
h2h_bias per layer and direction). Gate order: LSTM [i, f, c, o]; GRU
[r, z, n]. Modes ``rnn_relu``, ``rnn_tanh``, ``lstm``, ``gru``; bidirectional;
``state_outputs``; dropout ``p`` between layers, drawn from the node's
generator in a training forward.

The JAX op is a ``lax.scan`` per layer, not a Pallas kernel. Here each
layer's input projection for all time steps is one ``torch.matmul``
(``(T·B, I) x (I, G·H)``), and the recurrence, whose step t needs step
t − 1's state, is a loop over time in torch; autograd differentiates
through it. Data layout (seq_len, batch, input), the reference's TNC.
"""
from __future__ import annotations

import torch

from .nn import inverted_dropout
from .registry import AttrSpec, register

__all__ = ["rnn_param_size"]


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


# copied from mxnet_tpu/ops/rnn.py (rnn_param_size, backend-free)
def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total number of elements in the packed parameter vector."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size)  # weights
    size += num_layers * d * 2 * g * state_size  # biases
    return size


# copied from mxnet_tpu/ops/rnn.py (_unpack_params, backend-free)
def _unpack_params(params, num_layers, input_size, state_size, bidirectional, mode):
    """Slice the flat parameter vector into per-layer/direction (Wx, Wh, bx, bh)."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    out = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        layer_ws = []
        for _ in range(d):
            wx = params[off: off + g * state_size * in_sz].reshape(g * state_size, in_sz)
            off += g * state_size * in_sz
            wh = params[off: off + g * state_size * state_size].reshape(g * state_size,
                                                                        state_size)
            off += g * state_size * state_size
            layer_ws.append([wx, wh])
        out.append(layer_ws)
    for layer in range(num_layers):
        for di in range(d):
            bx = params[off: off + g * state_size]
            off += g * state_size
            bh = params[off: off + g * state_size]
            off += g * state_size
            out[layer][di].extend([bx, bh])
    return out


def _step(mode, H, zx_t, h, c, wh_t, bh):
    """One time step from the precomputed input-side gates ``zx_t`` (JAX
    ``_cell_step``); returns (h, c)."""
    if mode == "lstm":
        z = zx_t + torch.matmul(h, wh_t) + bh
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:3 * H])
        o = torch.sigmoid(z[:, 3 * H:])
        c = f * c + i * g
        return o * torch.tanh(c), c
    if mode == "gru":
        zh = torch.matmul(h, wh_t) + bh
        r = torch.sigmoid(zx_t[:, :H] + zh[:, :H])
        z = torch.sigmoid(zx_t[:, H:2 * H] + zh[:, H:2 * H])
        n = torch.tanh(zx_t[:, 2 * H:] + r * zh[:, 2 * H:])
        return (1 - z) * n + z * h, None
    z = zx_t + torch.matmul(h, wh_t) + bh
    return (torch.relu(z) if mode == "rnn_relu" else torch.tanh(z)), None


def _run_layer(mode, H, x, h, c, wx, wh, bx, bh, reverse=False):
    """One recurrent layer (JAX ``_run_layer``): the input-side GEMM over
    all time steps at once, then the loop over time; ``reverse`` walks the
    sequence backward and keeps each output at its own step. Returns
    ((h, c), ys) with ys (T, B, H)."""
    T = x.shape[0]
    zx = torch.matmul(x, wx.t()) + bx  # (T, B, G·H)
    wh_t = wh.t()
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = _step(mode, H, zx[t], h, c, wh_t, bh)
        ys[t] = h
    return (h, c), torch.stack(ys, dim=0)


def _rnn_names(attrs):
    names = ["data", "parameters", "state"]
    if attrs.get("mode") == "lstm":
        names.append("state_cell")
    return names


def _rnn_nout(attrs):
    if not attrs.get("state_outputs"):
        return 1
    return 3 if attrs.get("mode") == "lstm" else 2


@register("RNN", attrs={"state_size": AttrSpec("int", required=True),
                        "num_layers": AttrSpec("int", required=True),
                        "bidirectional": AttrSpec("bool", default=False),
                        "mode": AttrSpec("str", required=True),
                        "p": AttrSpec("float", default=0.0),
                        "state_outputs": AttrSpec("bool", default=False)},
          input_names=_rnn_names, num_outputs=_rnn_nout,
          output_names=lambda a: ["output", "state_output", "statecell_output"][: _rnn_nout(a)],
          needs_rng=True, needs_train_flag=True)
def _rnn(attrs, data, parameters, state, state_cell=None, is_train=False, rng=None):
    mode = attrs["mode"]
    H = attrs["state_size"]
    L = attrs["num_layers"]
    bidir = bool(attrs["bidirectional"])
    d = 2 if bidir else 1
    T, N, I = data.shape
    layers = _unpack_params(parameters, L, I, H, bidir, mode)

    x = data
    h_out, c_out = [], []
    for layer in range(L):
        if is_train and attrs["p"] > 0 and layer > 0 and rng is not None:
            x = inverted_dropout(x, attrs["p"], rng)
        dir_outs = []
        for di in range(d):
            wx, wh, bx, bh = layers[layer][di]
            h0 = state[layer * d + di]
            c0 = state_cell[layer * d + di] if mode == "lstm" else None
            (h, c), ys = _run_layer(mode, H, x, h0, c0, wx, wh, bx, bh, reverse=(di == 1))
            dir_outs.append(ys)
            h_out.append(h)
            if mode == "lstm":
                c_out.append(c)
        x = dir_outs[0] if d == 1 else torch.cat(dir_outs, dim=-1)

    outs = [x]
    if attrs["state_outputs"]:
        outs.append(torch.stack(h_out, dim=0))
        if mode == "lstm":
            outs.append(torch.stack(c_out, dim=0))
    return tuple(outs) if len(outs) > 1 else outs[0]
