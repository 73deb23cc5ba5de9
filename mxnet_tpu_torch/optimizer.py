"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` for the dense update path
(:126-625): ``Optimizer`` with the reference's registry, learning-rate
schedules (``lr_scheduler=``), per-parameter lr/wd multipliers (by name,
by index, and from the symbol's ``__lr_mult__``/``__wd_mult__`` attributes,
``sym=``) and per-key update counts; ``SGD`` (with momentum), ``NAG``,
``ccSGD``, ``SGLD``, ``DCASGD``, ``Adam`` (host-side bias-corrected lr),
``AdaGrad``, ``RMSProp`` (plain and centred), ``AdaDelta`` and ``Test``;
``create``, ``register``, ``Updater`` (with ``get_states``/``set_states``,
pickles of the port's NDArrays) and ``get_updater``.

SGD, Adam and RMSProp run one op of ``ops/optimizer_ops.py`` through
``ndarray.imperative_invoke``, which writes the new weight and state into
their arrays in place; the others are NDArray arithmetic, as in the JAX
package. SGLD's noise is drawn on the weight's device from that device's
generator (``random.py``), so it is not JAX's bits.

The FLAT kernels (``FLAT_KERNELS``, ``flat_kernel``; JAX :64-110) are the
same expressions as the fused ops, on flat tensors with ``lr``/``wd`` as
scalars or per-element vectors. Two consumers share them: the KVStore
bucket engine's sharded update (``kvstore_bucket.py``) and the row-sparse
LAZY update (``update_row_sparse``): only the rows a row-sparse gradient
names pass through the kernel; every other row keeps its weight and its
optimizer state bit for bit (a ``sparse.RowSparseState`` holds no row it
never updated), and the per-key update count still ticks once a round.
"""
from __future__ import annotations

import logging
import math
import pickle

import torch

from . import ndarray as nd
from .ndarray import imperative_invoke, zeros

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Test", "create", "register", "get_updater", "Updater", "flat_kernel",
           "FLAT_KERNELS"]


# ------------------------------------------------------------------ flat
# Each mirrors the fused op of ops/optimizer_ops.py expression for
# expression. ``lr``/``wd`` arrive as Python floats or per-element tensors;
# ``hyper`` holds constants.

def _flat_sgd(hyper):
    rg, clip = hyper["rescale_grad"], hyper["clip_gradient"]
    mu = hyper["momentum"]

    def fn(w, g, states, lr, wd):
        g = g * rg
        if clip and clip > 0:
            g = torch.clamp(g, -clip, clip)
        if mu:
            (mom,) = states
            new_mom = mu * mom - lr * (g + wd * w)
            return w + new_mom, (new_mom,)
        return w - lr * (g + wd * w), ()

    return fn


def _flat_adam(hyper):
    rg, clip = hyper["rescale_grad"], hyper["clip_gradient"]
    b1, b2, eps = hyper["beta1"], hyper["beta2"], hyper["epsilon"]

    def fn(w, g, states, lr, wd):
        g = g * rg
        if clip and clip > 0:
            g = torch.clamp(g, -clip, clip)
        g = g + wd * w
        mean, var = states
        new_mean = b1 * mean + (1 - b1) * g
        new_var = b2 * var + (1 - b2) * torch.square(g)
        w = w - lr * new_mean / (torch.sqrt(new_var) + eps)
        return w, (new_mean, new_var)

    return fn


def _flat_nag(hyper):
    """Nesterov momentum as the fused SPMD step writes it (JAX
    ``parallel/optim.py:69-79``): m = mu·m − lr·g', w + mu·m − lr·g' with
    g' the prepped gradient plus wd·w. The ``NAG`` class's per-key update
    has the reference's other form, so its ``flat_update_spec`` stays None
    and only ``parallel/optim.py`` reads this kernel."""
    rg, clip = hyper["rescale_grad"], hyper["clip_gradient"]
    mu = hyper["momentum"]

    def fn(w, g, states, lr, wd):
        g = g * rg
        if clip and clip > 0:
            g = torch.clamp(g, -clip, clip)
        g = g + wd * w
        if mu:
            (mom,) = states
            new_mom = mu * mom - lr * g
            return w + mu * new_mom - lr * g, (new_mom,)
        return w - lr * g, ()

    return fn


FLAT_KERNELS = {"sgd": _flat_sgd, "nag": _flat_nag, "adam": _flat_adam}


def flat_kernel(kind, hyper):
    """The flat kernel of a ``flat_update_spec`` family."""
    return FLAT_KERNELS[kind](hyper)


class Optimizer:
    """Base optimizer with the reference's registry / lr&wd-mult machinery."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise ValueError("Cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError("param_idx2name should be a dict of param indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def flat_update_spec(self):
        """``(kind, hyper, n_states)`` of the flat kernel whose math equals
        this optimizer's fused op, or ``None`` where there is none (JAX
        :182). The bucket engine's sharded update and the row-sparse lazy
        update both run it."""
        return None

    def create_state_row_sparse(self, index, weight):
        """State for a row-sparse-gradient parameter: a lazily grown
        ``sparse.RowSparseState`` with one row slot per flat-kernel state.
        Optimizers without a flat lowering take the dense state (their
        row-sparse updates densify, with a one-time warning)."""
        spec = self.flat_update_spec()
        if spec is None:
            if not getattr(self, "_warned_no_lazy", False):
                self._warned_no_lazy = True
                logging.getLogger("mxnet_tpu_torch.sparse").warning(
                    "optimizer %s has no flat_update_spec(): row-sparse "
                    "gradients densify and the update is NOT lazy (untouched "
                    "rows see a zero-gradient step)", type(self).__name__)
            return self.create_state(index, weight)
        from .sparse import RowSparseState

        return RowSparseState(weight.shape, weight.dtype, spec[2])

    def update_row_sparse(self, index, weight, grad, state):
        """Lazy row update (JAX :216): the flat kernel runs on exactly
        ``grad``'s rows of ``weight`` and ``state``; every other row, weight
        AND optimizer state, is untouched. The per-key update count ticks
        once a call, so lr schedules equal the dense path's."""
        from .sparse import RowSparseNDArray, RowSparseState

        assert isinstance(grad, RowSparseNDArray), type(grad)
        spec = self.flat_update_spec()
        if spec is None or not isinstance(state, RowSparseState):
            # no flat lowering (or a dense state): densify
            self.update(index, weight, grad.to_dense(), state)
            return
        kind, hyper, _ = spec
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if kind == "adam":
            t = self._index_update_count[index]
            lr *= math.sqrt(1.0 - hyper["beta2"] ** t) / (1.0 - hyper["beta1"] ** t)
        rows = grad.host_indices()
        if not rows.size:
            return
        w = weight._tensor()
        pos = torch.from_numpy(rows).to(w.device)
        g_rows = grad.values._tensor().to(device=w.device, dtype=w.dtype)
        s_rows = tuple(torch.from_numpy(s).to(w.device) for s in state.gather(rows))
        w_new, s_new = FLAT_KERNELS[kind](hyper)(w[pos], g_rows, s_rows, lr, wd)
        w[pos] = w_new
        state.scatter(rows, [s.cpu().numpy() for s in s_new])

    # ----------------------------------------------------------------- mults
    def _sym_mults(self, key):
        """{argument name: float} of the symbol's ``key`` attribute."""
        if self.sym is None:
            return {}
        attr = self.sym.attr_dict()
        return {name: float(attr[name][key]) for name in self.sym.list_arguments()
                if name in attr and key in attr[name]}

    def set_lr_mult(self, args_lr_mult):
        """Per-parameter lr multipliers, by name or index; the symbol's
        ``__lr_mult__`` attributes feed in first (JAX :256)."""
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-parameter wd multipliers, by name or index; every parameter
        whose name does not end in ``_weight`` or ``_gamma`` (biases, betas:
        the 1-D ones) gets wd 0, as in the reference, then the symbol's
        ``__wd_mult__`` attributes, then ``args_wd_mult`` (JAX :266)."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    # ------------------------------------------------------------- schedules
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_attrs(self, lr, wd):
        attrs = {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            attrs["clip_gradient"] = self.clip_gradient
        return attrs

    def _prep(self, grad):
        """The rescaled, clipped gradient as a new array (the NDArray
        optimizers' first step)."""
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = nd.clip(grad, a_min=-self.clip_gradient, a_max=self.clip_gradient)
        return grad


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros_like(weight):
    return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)


@register
class SGD(Optimizer):
    """SGD with momentum, on the sgd_update / sgd_mom_update ops."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(self._get_lr(index), self._get_wd(index))
        if state is not None:
            attrs["momentum"] = self.momentum
            imperative_invoke("sgd_mom_update", [weight, grad, state], attrs, out=[weight, state])
        else:
            imperative_invoke("sgd_update", [weight, grad], attrs, out=[weight])

    def flat_update_spec(self):
        """Flat lowering of sgd_update / sgd_mom_update."""
        return ("sgd", {"momentum": self.momentum, "rescale_grad": self.rescale_grad,
                        "clip_gradient": self.clip_gradient or 0.0},
                1 if self.momentum != 0.0 else 0)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (JAX :380)."""

    def flat_update_spec(self):
        return None  # Nesterov math differs from the flat sgd kernel

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prep(grad)
        if state is not None:
            mom = state
            mom[:] = mom * self.momentum + grad + wd * weight
            grad[:] = grad + self.momentum * mom
            weight[:] = weight - lr * grad
        else:
            weight[:] = weight - lr * (grad + wd * weight)


@register
class ccSGD(SGD):
    """Deprecated alias of SGD (JAX :445)."""


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (JAX :416); the noise is drawn
    on the weight's device from its generator."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prep(grad)
        noise = nd.random_normal(loc=0.0, scale=math.sqrt(lr), shape=weight.shape,
                                 ctx=weight.context)
        weight[:] = weight - lr / 2 * (grad + wd * weight) + noise


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (JAX :325)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prep(grad)
        mom, previous_weight = state
        step = grad + wd * weight + self.lamda * grad * grad * (weight - previous_weight)
        if mom is not None:
            mom[:] = mom * self.momentum
            mom[:] = mom - lr * step
        else:
            mom = -lr * step
        previous_weight[:] = weight
        weight[:] = weight + mom


@register
class Adam(Optimizer):
    """Adam with the reference's bias-corrected effective lr, folded on the
    host, on the adam_update op."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))  # mean, var

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        attrs = self._common_attrs(lr, wd)
        attrs.update(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        imperative_invoke("adam_update", [weight, grad, mean, var], attrs,
                          out=[weight, mean, var])

    def flat_update_spec(self):
        """Flat lowering of adam_update; the bias-corrected lr is folded on
        the host, as ``update`` does."""
        return ("adam", {"beta1": self.beta1, "beta2": self.beta2, "epsilon": self.epsilon,
                         "rescale_grad": self.rescale_grad,
                         "clip_gradient": self.clip_gradient or 0.0}, 2)


@register
class AdaGrad(Optimizer):
    """AdaGrad (JAX :499)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = self._prep(grad)
        history = state
        history[:] = history + grad * grad
        weight[:] = weight - lr * (grad / nd.sqrt(history + self.float_stable_eps) + wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Alex Graves' variant (JAX :536), on the
    rmsprop_update / rmspropalex_update ops."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9, epsilon=1e-8,
                 centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight), _zeros_like(weight))  # n, g, delta
        return (_zeros_like(weight),)  # n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        attrs = self._common_attrs(self._get_lr(index), self._get_wd(index))
        attrs.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.clip_weights is not None:
            attrs["clip_weights"] = self.clip_weights
        if not self.centered:
            (n,) = state
            imperative_invoke("rmsprop_update", [weight, grad, n], attrs, out=[weight, n])
        else:
            n, g, delta = state
            attrs["gamma2"] = self.gamma2
            imperative_invoke("rmspropalex_update", [weight, grad, n, g, delta], attrs,
                              out=[weight, n, g, delta])


@register
class AdaDelta(Optimizer):
    """AdaDelta (JAX :605)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))  # accumulated g, accumulated delta

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = self._prep(grad)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1.0 - self.rho) * grad * grad
        current_delta = nd.sqrt(acc_delta + self.epsilon) / nd.sqrt(acc_g + self.epsilon) * grad
        acc_delta[:] = self.rho * acc_delta + (1.0 - self.rho) * current_delta * current_delta
        weight[:] = weight - current_delta - wd * weight


@register
class Test(Optimizer):
    """Trivial optimizer for tests (JAX :653)."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        weight[:] = weight + grad * self.rescale_grad
        state[:] = weight


class Updater:
    """Applies an optimizer per key with lazily created state."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        from .sparse import RowSparseNDArray, RowSparseState, from_dense

        if isinstance(grad, RowSparseNDArray):
            if index not in self.states:
                self.states[index] = self.optimizer.create_state_row_sparse(index, weight)
            self.optimizer.update_row_sparse(index, weight, grad, self.states[index])
            return
        if isinstance(self.states.get(index), RowSparseState):
            # a key that trained row-sparse now sees a DENSE gradient: its
            # non-zero rows are its touched set (JAX :596)
            self.optimizer.update_row_sparse(index, weight, from_dense(grad),
                                             self.states[index])
            return
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Take the states ``get_states`` pickled (or a states dict); the
        arrays come back on the contexts they were saved from."""
        self.states = pickle.loads(states) if isinstance(states, bytes) else states

    def get_states(self):
        """The states as a pickle of the port's NDArrays (their values and
        contexts)."""
        return pickle.dumps(self.states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
