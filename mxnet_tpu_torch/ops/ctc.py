"""CTC loss: the ``WarpCTC`` op.

Counterpart of ``mxnet_tpu/ops/ctc.py`` (the reference's
plugin/warpctc). ``data`` is ``(input_length * batch, alphabet)``
time-major activations (row ``t*B + b``); ``label`` is ``(batch,
label_length)``, padded with the blank 0. The forward returns
``softmax(data)``; the backward ignores the head gradient and returns the
gradient of the summed CTC loss. The loss is the log-space alpha recursion
of the JAX package (``ctc_nll``), one step a frame over all rows at once,
and its gradient comes from torch autograd through that recursion, as the
JAX op takes ``jax.grad`` of it. A sample whose label needs more frames
than ``input_length`` (repeats need a blank between them) has zero loss
and zero gradient.
"""
from __future__ import annotations

import torch

from .registry import AttrSpec, register

_NEG = -1e30  # the -inf stand-in that keeps logsumexp's gradient finite


def _compact_labels(label, blank):
    """Left-align each row's non-blank entries, in order: [3, 0, 2, 0] ->
    [3, 2, 0, 0], and the rows' lengths (JAX :32-41, a stable argsort of
    the pad mask)."""
    is_pad = label == blank
    order = torch.argsort(is_pad.to(torch.int32), dim=1, stable=True)
    return label.gather(1, order), (~is_pad).sum(dim=1)


def ctc_nll(log_probs, label, label_lengths, blank=0):
    """Per-sample negative log-likelihood (JAX ``ctc_nll``): log_probs (T, B,
    C) log-softmax scores, label (B, L) compacted, label_lengths (B,)."""
    T, B, _ = log_probs.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev, dt = log_probs.device, log_probs.dtype
    label = label.long()
    label_lengths = label_lengths.long()
    s_idx = torch.arange(S, device=dev)
    # the extended sequence: blank at even s, label[(s - 1) // 2] at odd s
    lab_at = torch.where(s_idx % 2 == 1, label[:, torch.clamp((s_idx - 1) // 2, max=L - 1)],
                         blank)  # (B, S)
    prev2 = torch.cat([torch.full((B, 2), -1, dtype=lab_at.dtype, device=dev),
                       lab_at[:, :-2]], dim=1)
    can_skip = (lab_at != blank) & (lab_at != prev2)
    valid = s_idx[None, :] < (2 * label_lengths[:, None] + 1)
    neg = torch.full((), _NEG, dtype=dt, device=dev)

    alpha = torch.full((B, S), _NEG, dtype=dt, device=dev)
    alpha[:, 0] = log_probs[0, :, blank]
    first = log_probs[0].gather(1, label[:, :1])[:, 0]
    alpha[:, 1] = torch.where(label_lengths > 0, first, neg)
    pad1 = torch.full((B, 1), _NEG, dtype=dt, device=dev)
    pad2 = torch.full((B, 2), _NEG, dtype=dt, device=dev)
    for t in range(1, T):
        em = log_probs[t].gather(1, lab_at)
        diag = torch.cat([pad1, alpha[:, :-1]], dim=1)
        skip = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1), neg)
        merged = torch.logsumexp(torch.stack([alpha, diag, skip], dim=0), dim=0)
        alpha = torch.where(valid, merged + em, neg)
    # the accept states: 2·len (the final blank) and 2·len - 1 (the last symbol)
    endb = alpha.gather(1, (2 * label_lengths)[:, None])[:, 0]
    ends = alpha.gather(1, torch.clamp(2 * label_lengths - 1, min=0)[:, None])[:, 0]
    ends = torch.where(label_lengths > 0, ends, neg)
    return -torch.logaddexp(endb, ends)


def _total_nll(data2d, label, input_length, blank):
    """The summed loss of the feasible samples (JAX ``total_nll``)."""
    B = data2d.shape[0] // input_length
    logits = data2d.reshape(input_length, B, data2d.shape[1])
    lp = torch.log_softmax(logits.float(), dim=-1)
    compact, lengths = _compact_labels(label.to(torch.int32).reshape(B, -1), blank)
    nll = ctc_nll(lp, compact, lengths, blank)
    pos = torch.arange(1, compact.shape[1], device=compact.device)
    repeats = ((compact[:, 1:] == compact[:, :-1]) & (pos[None, :] < lengths[:, None])).sum(1)
    feasible = (lengths + repeats) <= input_length
    return torch.where(feasible, nll, torch.zeros((), dtype=nll.dtype, device=nll.device)).sum()


class _WarpCTC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data2d, label, input_length, blank):
        ctx.save_for_backward(data2d, label)
        ctx.input_length, ctx.blank = input_length, blank
        return torch.softmax(data2d, dim=-1)

    @staticmethod
    def backward(ctx, _head):
        data2d, label = ctx.saved_tensors
        with torch.enable_grad():
            x = data2d.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(_total_nll(x, label, ctx.input_length, ctx.blank), [x])
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return g.to(data2d.dtype), dlabel, None, None


@register("WarpCTC", attrs={"label_length": AttrSpec("int", default=0),
                            "input_length": AttrSpec("int", default=0)},
          input_names=("data", "label"))
def _warpctc(attrs, data, label):
    T = int(attrs["input_length"])
    if T <= 0:
        raise ValueError("WarpCTC requires input_length > 0")
    if data.ndim != 2:
        data = data.reshape(-1, data.shape[-1])
    return _WarpCTC.apply(data, label, T, 0)
