"""Functional optimizers for the fused training step.

Counterpart of ``mxnet_tpu/parallel/optim.py``. The JAX package returns
pure ``(init, apply)`` pairs over parameter dicts that XLA fuses into the
step. The port's pair runs ``optimizer.FLAT_KERNELS`` (the same arithmetic
as the KVStore's sharded update): ``apply`` flattens a parameter dict into
one buffer for each dtype and runs the kernel once over it, and the
trainer (``parallel/trainer.py``) calls ``FunctionalOptimizer.flat`` on the
flat buffers it keeps its parameters, gradients and states in. SGD, NAG and
Adam have the JAX package's formulas (JAX :49-108); ``rescale_grad``,
``clip_gradient`` and ``lr_mult``/``wd_mult`` by name as there.

``lr`` and the step counter ``t`` are device tensors, never Python floats:
inside a CUDA graph a Python number would be captured as a constant, and a
learning-rate schedule would stop moving on the card.
"""
from __future__ import annotations

import torch

from ..optimizer import FLAT_KERNELS

__all__ = ["make_functional_optimizer", "functional_from_optimizer", "FunctionalOptimizer"]

#: state names of each kind, in the flat kernel's order (JAX's state keys)
_STATES = {"sgd": ("mom",), "nag": ("mom",), "adam": ("m", "v")}


class FunctionalOptimizer:
    """One functional optimizer: ``init`` and ``apply`` over dicts, as in
    the JAX package, and ``flat`` over flat buffers, which both run."""

    def __init__(self, kind, learning_rate, wd, rescale_grad, clip_gradient, momentum, beta1,
                 beta2, epsilon, lr_mult, wd_mult):
        self.kind = kind
        self.learning_rate = float(learning_rate)
        self.wd = float(wd)
        self.lr_mult = {str(k): float(v) for k, v in dict(lr_mult or {}).items()}
        self.wd_mult = {str(k): float(v) for k, v in dict(wd_mult or {}).items()}
        self.beta1, self.beta2 = float(beta1), float(beta2)
        hyper = {"rescale_grad": rescale_grad, "clip_gradient": clip_gradient or 0.0}
        if kind == "adam":
            hyper.update(beta1=beta1, beta2=beta2, epsilon=epsilon)
            self.state_names = _STATES["adam"]
        else:
            hyper.update(momentum=momentum)
            self.state_names = _STATES[kind] if momentum > 0 else ()
        self._kernel = FLAT_KERNELS[kind](hyper)

    # ------------------------------------------------------------------ dicts
    def init(self, params):
        """``{"t": int32 0, <state name>: {name: zeros}}`` on the params'
        device (JAX ``init``)."""
        first = next(iter(params.values()), None)
        device = first.device if first is not None else "cpu"
        state = {"t": torch.zeros((), dtype=torch.int32, device=device)}
        for s in self.state_names:
            state[s] = {k: torch.zeros_like(v) for k, v in params.items()}
        return state

    def apply(self, params, grads, state, lr=None):
        """``(new_params, new_state)``, functional (JAX ``apply``): the
        dicts are flattened, one buffer a dtype, and ``flat`` runs once on
        each. ``lr`` overrides the static learning rate."""
        names = list(params)
        device = params[names[0]].device
        lr_t = self.lr_tensor(lr, device)
        new_t = state["t"] + 1
        new_params, new_state = {}, {"t": new_t}
        for s in self.state_names:
            new_state[s] = {}
        for group in _dtype_groups(params, names):
            flat = lambda d: torch.cat([d[k].reshape(-1) for k in group])  # noqa: E731
            lr_vec, wd_vec = self.mult_vectors(params, group)
            w, states = self.flat(flat(params), flat(grads),
                                  tuple(flat(state[s]) for s in self.state_names),
                                  new_t, lr_t, lr_vec, wd_vec)
            for out, vec in [(new_params, w)] + [(new_state[s], v)
                                                 for s, v in zip(self.state_names, states)]:
                off = 0
                for k in group:
                    n = params[k].numel()
                    out[k] = vec[off:off + n].view(params[k].shape)
                    off += n
        return new_params, new_state

    # ------------------------------------------------------------------- flat
    def lr_tensor(self, lr, device):
        value = self.learning_rate if lr is None else lr
        if isinstance(value, torch.Tensor):
            return value.to(device=device, dtype=torch.float32)
        return torch.full((), float(value), dtype=torch.float32, device=device)

    def mult_vectors(self, params, names):
        """The per-element ``lr_mult`` vector (None where every multiplier
        is 1) and ``wd·wd_mult`` vector (a 0-d tensor where uniform) over
        the flat layout of ``names``; built once by the trainer."""
        device = params[names[0]].device
        dtype = params[names[0]].dtype

        def vec(table, base):
            vals = [base * table.get(k, 1.0) for k in names]
            if len(set(vals)) == 1:
                return torch.full((), vals[0], dtype=dtype, device=device)
            return torch.cat([torch.full((params[k].numel(),), v, dtype=dtype, device=device)
                              for k, v in zip(names, vals)])

        lr_vec = None if all(self.lr_mult.get(k, 1.0) == 1.0 for k in names) \
            else vec(self.lr_mult, 1.0)
        return lr_vec, vec(self.wd_mult, self.wd)

    def flat(self, w, g, states, t, lr, lr_vec, wd):
        """One update of flat buffers: returns ``(w, states)``. ``t`` is the
        new step count (Adam's bias correction, JAX :97-100) and ``lr`` the
        device learning rate; both are read on the device."""
        lr = lr if lr_vec is None else lr * lr_vec
        if self.kind == "adam":
            tf = t.to(torch.float32)
            lr = lr * (torch.sqrt(1.0 - torch.pow(self.beta2, tf))
                       / (1.0 - torch.pow(self.beta1, tf)))
        return self._kernel(w, g, states, lr, wd)


def _dtype_groups(params, names):
    groups = {}
    for k in names:
        groups.setdefault(params[k].dtype, []).append(k)
    return list(groups.values())


def make_functional_optimizer(name="sgd", learning_rate=0.01, wd=0.0,
                              rescale_grad=1.0, clip_gradient=None,
                              momentum=0.9, beta1=0.9, beta2=0.999,
                              epsilon=1e-8, lr_mult=None, wd_mult=None,
                              **_ignored):
    """Return ``(init_fn, apply_fn)`` (JAX :20-111).

    ``init_fn(params) -> state``; ``apply_fn(params, grads, state, lr=None)
    -> (new_params, new_state)``. ``lr_mult``/``wd_mult`` are optional
    name→float dicts. Both are bound methods of one ``FunctionalOptimizer``,
    which the trainer reaches through ``apply_fn.__self__``."""
    if name not in _STATES:
        raise ValueError("unknown functional optimizer %r (have sgd/nag/adam)" % name)
    fo = FunctionalOptimizer(name, learning_rate, wd, rescale_grad, clip_gradient, momentum,
                             beta1, beta2, epsilon, lr_mult, wd_mult)
    return fo.init, fo.apply


_SUPPORTED_CLASSES = {"SGD": "sgd", "NAG": "nag", "Adam": "adam"}


# copied from mxnet_tpu/parallel/optim.py (functional_from_optimizer; backend-free)
def functional_from_optimizer(optimizer, param_names):
    """Lower an ``mxnet_tpu_torch.optimizer.Optimizer`` instance to a
    functional ``(init, apply, lr_of_step)`` triple, or return ``None`` when
    its class has no in-step equivalent.

    ``lr_of_step(t)`` evaluates the schedule on the host; the trainer writes
    its value into the step's device learning rate each step."""
    kind = _SUPPORTED_CLASSES.get(type(optimizer).__name__)
    if kind is None:
        return None

    def mult_by_name(mult):
        out = {}
        for key, val in (mult or {}).items():
            name = optimizer.idx2name.get(key, key) if isinstance(key, int) else key
            if name in param_names:
                out[str(name)] = float(val)
        return out

    kwargs = dict(
        learning_rate=optimizer.lr,
        wd=getattr(optimizer, "wd", 0.0),
        rescale_grad=getattr(optimizer, "rescale_grad", 1.0),
        clip_gradient=getattr(optimizer, "clip_gradient", None),
        lr_mult=mult_by_name(optimizer.lr_mult),
        wd_mult=mult_by_name(optimizer.wd_mult),
    )
    if kind in ("sgd", "nag"):
        kwargs["momentum"] = getattr(optimizer, "momentum", 0.0)
    if kind == "adam":
        kwargs.update(
            beta1=getattr(optimizer, "beta1", 0.9),
            beta2=getattr(optimizer, "beta2", 0.999),
            epsilon=getattr(optimizer, "epsilon", 1e-8),
        )
    init, apply = make_functional_optimizer(kind, **kwargs)

    def lr_of_step(t):
        if optimizer.lr_scheduler is not None:
            return float(optimizer.lr_scheduler(int(t)))
        return float(optimizer.lr)

    return init, apply, lr_of_step
