"""SPMDTrainer: forward, backward and the update as one step.

Counterpart of ``mxnet_tpu/parallel/trainer.py``. The JAX package compiles
forward, backward, the gradient all-reduce and the optimizer update into
one ``jax.jit`` over a mesh. The port runs the same function as one step
over flat buffers:

* the parameters, their gradients and each optimizer state live in one
  flat buffer a dtype (``_TrainState``), the names being views of it; the
  update is ``FunctionalOptimizer.flat`` (``optimizer.FLAT_KERNELS``) once
  over each buffer, with ``lr`` and the step counter ``t`` on the device;
* within one process the global batch runs as one forward and one backward
  on the mesh's one physical device: the sum over the data shards is the
  full-batch gradient, BatchNorm's moments are over the global batch, and a
  ``model`` axis changes no value (``parallel/mesh.py``);
* across processes each rank runs its own rows, then ``all_reduce``s the
  flat gradients in buckets of ``MXNET_KVSTORE_BUCKET_MB`` inside the step,
  and every rank applies the same update; a BatchNorm's sums are summed
  over the ranks inside the forward (``fusion._conv_block_sharded``,
  ``fusion._global_moments``), and in ``remat``'s recompute, so its
  moments are the global batch's;
* on a CUDA device the step is one ``torch.cuda.CUDAGraph`` a batch shape:
  the first dispatch of a shape runs eagerly on a side stream (the warm-up:
  first-use library loads and ``cudaFuncSetAttribute`` happen there), then
  captures forward, backward, update, aux update and the anomaly guard's
  ``where``; later dispatches ``copy_`` the batch and the learning rates
  into the graph's static buffers and replay it. ``step_many`` captures N
  steps over N input slots in one graph (JAX's ``lax.scan``). A graph reads
  its tensors by address: everything that writes the state copies into the
  cell's tensors, and a replay whose tensors were replaced raises. The
  kernels' launch counters count at capture; the capture's counts are
  taken back and added at each replay. On the CPU there is no graph: the
  same step runs eagerly, with the kernels' plain versions. A graph with a
  ``Custom`` op (host Python) runs the step eagerly on the card, decided at
  bind from the node list and logged once; a capture that fails raises.

The anomaly guard (``MXNET_ANOMALY_GUARD``, JAX :283-306, :504-540) checks
one finite bit a gradient inside the step and where-selects the old
parameters, aux and optimizer state (its counter included) when any is
false; the per-key vector is the one value a step reads back.
"""
from __future__ import annotations

import copy
import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError
from .optim import make_functional_optimizer
from .sharding import ShardingRules

__all__ = ["SPMDTrainer"]

_BF16 = ("compute_dtype %r: the port's fused step computes in float32; bf16 and TF32 "
         "come with the TF32/bf16 PR (ROADMAP.md section 2b)")
#: ops whose apply runs host Python: a graph holding one is not captured
_HOST_OPS = ("Custom",)
#: aten products the 'dots' remat policy keeps (JAX's dots_with_no_batch_dims_saveable)
_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution", "linear")


class _TrainState:
    """The mutable training state (params / aux / optimizer state) in one
    cell, so several trainers can SHARE it: bucketing runs one step a
    bucket shape while every bucket trains the same tensors (JAX :27-44).

    ``flats`` holds the flat buffers behind the views: ``"params"``,
    ``"grads"`` and each optimizer state name, each {dtype: buffer}, and
    ``"groups"`` {dtype: [names]}; ``mults`` the optimizer's (lr_mult,
    wd) vectors a dtype; ``pool`` the CUDA-graph memory pool every bucket's
    graph shares. ``version`` counts the writes to params and aux (a step,
    a megastep, ``set_params``): a module's bound executors are current
    while they hold the version they were last loaded at."""

    __slots__ = ("params", "aux", "opt_state", "version", "flats", "mults", "pool")

    def __init__(self):
        self.params = {}
        self.aux = {}
        self.opt_state = None
        self.version = 0
        self.flats = None
        self.mults = None
        self.pool = None


class SPMDTrainer:
    """Train a Symbol over a mesh.

    Parameters
    ----------
    symbol : the network (loss heads as outputs, e.g. SoftmaxOutput).
    mesh : parallel.mesh.Mesh (see parallel.make_mesh).
    data_names / label_names : input argument names.
    optimizer / optimizer_params : functional optimizer spec (optim.py), a
        name or a pair from ``make_functional_optimizer`` /
        ``functional_from_optimizer``.
    rules : ShardingRules (defaults to batch-on-'data').
    remat : recompute the forward during backward
        (``torch.utils.checkpoint``): True or 'nothing' keeps nothing,
        'dots' keeps the products' and convolutions' outputs.
    compute_dtype : None or float32; any other raises (section 2b).
    """

    def __init__(self, symbol, mesh, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 optimizer_params=None, rules: Optional[ShardingRules] = None,
                 remat=False, compute_dtype=None):
        from ..analysis.rewrite import rewrite_for_bind
        from ..executor import _GraphProgram
        from ..ops.registry import get_op

        if compute_dtype is not None and np.dtype(compute_dtype) != np.float32:
            raise MXNetError(_BF16 % (compute_dtype,))
        self.symbol = symbol
        self.mesh = mesh
        self.rules = rules or ShardingRules(mesh)
        # the bind-time rewrite, as executor.bind runs it (weight names kept)
        self._prog = _GraphProgram(rewrite_for_bind(symbol))
        self._remat = remat
        physical = {ctx.torch_device for ctx in mesh.devices.flat}
        if len(physical) != 1:
            raise MXNetError("a mesh of one process runs on one physical device; %s name %d"
                             % (list(mesh.devices.flat), len(physical)))
        self._device = physical.pop()
        ops = [get_op(node.op) for node in self._prog.topo if not node.is_variable]
        if mesh.process_count > 1 and self.rules.model_parallel_size > 1:
            raise MXNetError("a model axis across processes is ROADMAP.md section 1.4c (the "
                             "JAX package's planner plans no multi-process job either)")
        self._needs_rng = any(op.needs_rng for op in ops)
        if remat and self._needs_rng:
            raise MXNetError("remat with a random op: the recompute would draw other bits "
                             "from the device's generator")
        self._host_op = next((node.op for node in self._prog.topo
                              if not node.is_variable and node.op in _HOST_OPS), None)

        arg_names = self._prog.arg_names
        self.input_names = [n for n in list(data_names) + list(label_names) if n in arg_names]
        self.param_names = [n for n in arg_names if n not in self.input_names]
        self.aux_names = self._prog.aux_names

        opt_kwargs = dict(optimizer_params or {})
        if isinstance(optimizer, str):
            _, apply = make_functional_optimizer(optimizer, **opt_kwargs)
        else:
            _, apply = optimizer  # a pre-built (init, apply) pair
        # the trainer keeps the state in its own flat buffers and runs the
        # pair's FunctionalOptimizer on them
        self._fo = getattr(apply, "__self__", None)
        if not hasattr(self._fo, "flat"):
            raise MXNetError("SPMDTrainer takes an optimizer name or a pair from "
                             "make_functional_optimizer / functional_from_optimizer")

        self._state = _TrainState()
        self._graphs = {}  # (steps, input signature) -> _CapturedSteps
        self._step_count = 0
        self._anomaly_mode = None
        self._built = False
        self.skipped_steps = 0

    # ----------------------------------------------------------- shared state
    @property
    def params(self) -> Dict:
        return self._state.params

    @property
    def aux(self) -> Dict:
        return self._state.aux

    @property
    def opt_state(self):
        return self._state.opt_state

    @opt_state.setter
    def opt_state(self, v):
        """Copy a state tree (tensors or numpy, the JAX package's layout)
        into the cell's tensors."""
        st = self._state.opt_state
        if st is None:
            raise MXNetError("set the parameters before the optimizer state")
        with torch.no_grad():
            st["t"].copy_(torch.as_tensor(np.asarray(_host(v["t"])), dtype=torch.int32))
            for s in self._fo.state_names:
                for k, dst in st[s].items():
                    dst.copy_(torch.as_tensor(np.asarray(_host(v[s][k]))))

    def adopt_state(self, other: "SPMDTrainer"):
        """Share another trainer's state cell — the bucketing contract: same
        tensors, a step of its own for each bucket shape."""
        if set(self.param_names) != set(other.param_names) or \
                set(self.aux_names) != set(other.aux_names):
            raise MXNetError(
                "cannot share training state: bucket symbols disagree on "
                "parameter names")
        self._state = other._state

    @property
    def _spans_processes(self):
        return self.mesh.process_count > 1

    # ------------------------------------------------------------------ init
    def init_params(self, data_shapes, label_shapes=None, initializer=None,
                    dtype="float32", seed=0):
        """Infer all shapes, initialize params on the host from ``seed``,
        and lay them out in the state cell's flat buffers."""
        from .. import random as _rnd
        from ..context import cpu
        from ..initializer import InitDesc, Xavier
        from ..ndarray import array as nd_array

        initializer = initializer or Xavier(factor_type="in", magnitude=2.0)
        hints = dict(data_shapes)
        hints.update(label_shapes or {})
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**hints)
        arg_map = dict(zip(self.symbol.list_arguments(), arg_shapes))
        aux_map = dict(zip(self.symbol.list_auxiliary_states(), aux_shapes))
        attrs = self.symbol.attr_dict()
        _rnd.seed(seed)  # deterministic init regardless of prior RNG use

        def host_init(name, shape):
            tmp = nd_array(np.zeros(shape, dtype=dtype), ctx=cpu())
            initializer(InitDesc(name, attrs.get(name, {})), tmp)
            return tmp.asnumpy()

        arg = {n: host_init(n, arg_map[n]) for n in self.param_names}
        aux = {n: host_init(n, aux_map[n]) for n in self.aux_names}
        for name in self.param_names:
            self.rules.check(arg[name].shape, self.rules.param_spec(name, arg[name].shape))
        self.set_params(arg, aux)
        with torch.no_grad():  # a fresh optimizer state, in place
            for t in [self.opt_state["t"]] + [v for s in self._fo.state_names
                                              for v in self.opt_state[s].values()]:
                t.zero_()
        return self

    def _allocate(self, arg):
        """The flat buffers: params (holding ``arg``), grads, each optimizer
        state, the counter ``t``, and the optimizer's multiplier vectors."""
        st = self._state
        missing = [n for n in self.param_names if n not in arg]
        if missing:
            raise MXNetError("set_params: no value for %s (call init_params first)" % missing)
        groups = {}
        for n in self.param_names:
            v = torch.as_tensor(_host(arg[n]))
            if not v.is_floating_point():
                raise MXNetError("the fused step trains floating-point parameters; %r is %s"
                                 % (n, v.dtype))
            groups.setdefault(v.dtype, []).append(n)
        shapes = {n: tuple(np.shape(_host(arg[n]))) for n in self.param_names}
        flats = {"params": {}, "grads": {}, "groups": groups}
        for s in self._fo.state_names:
            flats[s] = {}
        params, grads = {}, {}
        states = {s: {} for s in self._fo.state_names}
        for dt, names in groups.items():
            total = sum(int(np.prod(shapes[n])) for n in names)
            for key in ["params", "grads"] + list(self._fo.state_names):
                flats[key][dt] = torch.zeros(total, dtype=dt, device=self._device)
            off = 0
            for n in names:
                size = int(np.prod(shapes[n]))
                for key, table in [("params", params), ("grads", grads)] + [
                        (s, states[s]) for s in self._fo.state_names]:
                    table[n] = flats[key][dt][off:off + size].view(shapes[n])
                off += size
        st.flats, st.params = flats, params
        st.opt_state = {"t": torch.zeros((), dtype=torch.int32, device=self._device)}
        for s in self._fo.state_names:
            st.opt_state[s] = states[s]
        flats["grads_by_name"] = grads
        st.mults = {dt: self._fo.mult_vectors(params, names) for dt, names in groups.items()}

    # ------------------------------------------------------------------ step
    def _fwd(self, args, aux):
        """The training forward, under ``remat``'s checkpoint policy. The
        mesh is entered inside ``run``, so the recompute that backward
        makes (on autograd's thread, outside the caller's context) takes
        the same path as the forward: a BatchNorm across processes sums
        its statistics over the ranks in both."""
        from .mesh import trace_mesh

        prog, device, mesh = self._prog, self._device, self.mesh

        def run(*a):
            with trace_mesh(mesh):
                return prog.interpret(a, aux, True, device)

        if not self._remat:
            return run(*args)
        from torch.utils.checkpoint import checkpoint

        if self._remat == "dots":
            import functools

            from torch.utils.checkpoint import (CheckpointPolicy,
                                                create_selective_checkpoint_contexts)

            keep = {getattr(torch.ops.aten, n) for n in _DOT_OPS if hasattr(torch.ops.aten, n)}
            keep = {op for pkt in keep for op in [pkt.default]}

            def policy(ctx, op, *a, **kw):
                return (CheckpointPolicy.MUST_SAVE if op in keep
                        else CheckpointPolicy.PREFER_RECOMPUTE)

            return checkpoint(run, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts, policy))
        return checkpoint(run, *args, use_reentrant=False)

    def _one_step(self, inputs, lr):
        """One training step on the state cell, in place: returns the head
        outputs and (guard on) the per-key finite vector. ``inputs`` are
        tensors on the device, ``lr`` a 0-d device tensor. Nothing here
        reads the device back, so the step can be captured."""
        st = self._state
        flats = st.flats
        input_set = set(self.input_names)
        args, leaves = [], {}
        for n in self._prog.arg_names:
            if n in input_set:
                args.append(inputs[n])
                continue
            p = st.params[n].detach().requires_grad_(True)
            leaves[n] = p
            args.append(p)
        aux_old = tuple(st.aux[n] for n in self.aux_names)
        with torch.enable_grad():
            outs, new_aux = self._fwd(args, aux_old)
        # loss heads ignore the incoming cotangent, so ones is the identity
        # head gradient (JAX :248-250)
        heads = [(o, torch.ones_like(o)) for o in outs if o.requires_grad]
        names = list(leaves)
        got = [None] * len(names)
        if heads and names:
            got = torch.autograd.grad([o for o, _ in heads], [leaves[n] for n in names],
                                      grad_outputs=[g for _, g in heads], allow_unused=True)
        with torch.no_grad():
            grads = flats["grads_by_name"]
            for n, g in zip(names, got):
                if g is None:
                    grads[n].zero_()
                else:
                    grads[n].copy_(g)
            self._all_reduce_grads()
            t_old = st.opt_state["t"]
            t_new = t_old + 1
            finite = ok = None
            if self._anomaly_mode is not None:
                finite = torch.stack([torch.isfinite(grads[k]).all() for k in sorted(grads)])
                ok = finite.all()
            for dt, group in flats["groups"].items():
                w = flats["params"][dt]
                states = tuple(flats[s][dt] for s in self._fo.state_names)
                lr_vec, wd = st.mults[dt]
                w_new, s_new = self._fo.flat(w, flats["grads"][dt], states, t_new, lr,
                                             lr_vec, wd)
                for dst, new in zip((w,) + states, (w_new,) + tuple(s_new)):
                    dst.copy_(new if ok is None else torch.where(ok, new, dst))
            for n, old, new in zip(self.aux_names, aux_old, new_aux):
                if new is not old:
                    old.copy_(new if ok is None else torch.where(ok, new.to(old.dtype), old))
            t_old.copy_(t_new if ok is None else torch.where(ok, t_new, t_old))
        return tuple(o.detach() for o in outs), finite

    def _all_reduce_grads(self):
        """Sum the flat gradients over the mesh's processes, in buckets of
        ``MXNET_KVSTORE_BUCKET_MB`` (``kvstore_bucket.bucket_bytes``)."""
        if self.mesh.process_count <= 1:
            return
        import torch.distributed as tdist

        from ..kvstore_bucket import bucket_bytes

        cap = bucket_bytes()
        for flat in self._state.flats["grads"].values():
            step = max(1, cap // flat.element_size())
            for off in range(0, flat.numel(), step):
                tdist.all_reduce(flat[off:off + step], group=self.mesh.group)

    def _build(self):
        """Read the guard mode once, when the first step runs (the JAX
        package reads it when the step compiles)."""
        if self._built:
            return
        from ..base import anomaly_guard_mode

        self._anomaly_mode = anomaly_guard_mode() if self.param_names else None
        if self._device.type == "cuda" and self._host_op is not None:
            logging.getLogger("mxnet_tpu_torch").warning(
                "fused step: the graph holds a %s op (host Python), so the step runs "
                "eagerly on the card, without a CUDA graph", self._host_op)
        self._built = True

    def _dispatch(self, inputs_list, lrs):
        """Run ``len(inputs_list)`` steps: eagerly on the CPU (and for a
        graph with a host op), else through the captured graph of this
        signature, capturing it after an eager first dispatch. Returns
        (list of per-step outputs, stacked finite vectors or None)."""
        self._build()
        n = len(inputs_list)
        if self._device.type != "cuda" or self._host_op is not None:
            res = [self._one_step(inp, self._lr_tensor(lr)) for inp, lr in zip(inputs_list, lrs)]
            return self._collect(res)
        key = (n,) + tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(inputs_list[0].items()))
        prog = self._graphs.get(key)
        if prog is not None:
            return prog.run(self, inputs_list, lrs)
        dev = self._device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            res = [self._one_step(inp, self._lr_tensor(lr))
                   for inp, lr in zip(inputs_list, lrs)]
        torch.cuda.current_stream(dev).wait_stream(side)
        out = self._collect(res)
        self._graphs[key] = _CapturedSteps(self, inputs_list)
        return out

    @staticmethod
    def _collect(res):
        finite = [f for _, f in res]
        return [o for o, _ in res], (None if finite[0] is None else torch.stack(finite))

    def _lr_tensor(self, lr):
        return self._fo.lr_tensor(lr, self._device)

    def _resolve_lr(self, lr):
        return self._fo.learning_rate if lr is None else float(lr)

    def _bound_tensors(self):
        """Every state tensor a captured graph reads or writes."""
        st = self._state
        out = [st.opt_state["t"]] + list(st.aux.values())
        for key in ["params", "grads"] + list(self._fo.state_names):
            out += list(st.flats[key].values())
        return tuple(out)

    def step(self, data: Dict, label: Optional[Dict] = None, lr=None):
        """Run one training step; returns the head outputs (tensors).

        ``lr`` optionally overrides the optimizer's static learning rate for
        this step (drives lr schedules without a new graph)."""
        from .. import telemetry as _tm

        if not self.params and self.param_names:
            raise MXNetError("call init_params first")
        sp = _tm.NULL_SPAN
        if _tm.enabled():
            _tm.counter("trainer.step").inc()
            _tm.counter("trainer.dispatches").inc()
            _tm.gauge("train.steps_per_dispatch").set(1)
            sp = _tm.span("trainer.step", n=self._step_count)
        with sp:
            placed = self._place_batch(data, label)
            self._step_count += 1
            outs, finite = self._dispatch([placed], [self._resolve_lr(lr)])
            self._state.version += 1
            if finite is not None:
                self._check_anomaly(finite[0])
        return outs[0]

    def step_many(self, data_list, label_list=None, lrs=None):
        """Run N training steps in ONE dispatch (the training megastep): on
        the card one CUDA graph of N steps over N input slots, replayed;
        the weights are bitwise what N ``step`` calls give, NaN-guard
        skipped steps included. ``lrs`` is an optional per-step list (None
        entries take the static lr). Returns N per-step output tuples.
        Multi-process meshes are rejected, as in the JAX package."""
        from .. import telemetry as _tm

        n = len(data_list)
        if n == 0:
            return []
        if not self.params and self.param_names:
            raise MXNetError("call init_params first")
        if n == 1:
            lr = lrs[0] if lrs else None
            return [self.step(data_list[0], (label_list or [None])[0], lr=lr)]
        if self._spans_processes:
            raise MXNetError(
                "step_many: multi-process meshes are not supported (the "
                "stacked batch cannot be assembled from process-local "
                "shards) — set MXNET_TRAIN_MEGASTEP_N=1")
        vals = [self._resolve_lr(None if lrs is None else lrs[i]) for i in range(n)]
        sp = _tm.NULL_SPAN
        if _tm.enabled():
            _tm.counter("trainer.step").inc(n)
            _tm.counter("trainer.megastep").inc()
            _tm.counter("trainer.dispatches").inc()
            _tm.gauge("train.steps_per_dispatch").set(n)
            sp = _tm.span("trainer.megastep", n=self._step_count, steps=n)
        with sp:
            labels = label_list or [None] * n
            placed = [self._place_batch(data_list[i], labels[i]) for i in range(n)]
            self._step_count += n
            outs, finite = self._dispatch(placed, vals)
            self._state.version += 1
            if finite is not None:
                self._check_anomaly(finite)
        return outs

    def _check_anomaly(self, finite_vec):
        """Host half of the anomaly guard (JAX :504-540): the step already
        kept the old state where a gradient was non-finite; the per-key
        vector (one row a step of a megastep) is read back here to count
        the skip or raise naming the first offending key."""
        from .. import telemetry as _tm

        fv = finite_vec.cpu().numpy()
        if fv.all():
            return
        if fv.ndim == 2:
            for row in fv:
                self._check_anomaly(torch.from_numpy(row))
            return
        bad = sorted(self.params)[int(np.argmin(fv))]
        if self._anomaly_mode == "raise":
            raise MXNetError(
                "anomaly guard: non-finite (NaN/Inf) gradient for "
                "parameter %r at step %d — the fused step left params/"
                "optimizer state UN-updated (MXNET_ANOMALY_GUARD=raise)"
                % (bad, self._step_count))
        self.skipped_steps += 1
        if _tm.enabled():
            _tm.counter("trainer.skipped_steps").inc()
        logging.getLogger("mxnet_tpu").warning(
            "anomaly guard: dropped step %d — non-finite gradient, first "
            "offending key %r (%d step(s) skipped so far)",
            self._step_count, bad, self.skipped_steps)

    def _place_batch(self, data, label=None):
        """One batch's inputs as tensors on the device, rows checked against
        the data axis (JAX :547-565)."""
        inputs = dict(data)
        inputs.update(label or {})
        placed = {}
        pc = self.mesh.process_count
        for n in self.input_names:
            if n not in inputs:
                raise MXNetError("missing input %r" % n)
            v = inputs[n]
            v = v._tensor() if hasattr(v, "_tensor") else torch.as_tensor(_host(v))
            shape = tuple(v.shape)
            self.rules.check((shape[0] * pc,) + shape[1:] if shape else shape,
                             self.rules.batch_spec(shape))
            placed[n] = v.to(self._device)
        return placed

    def cost_analysis(self, data, label=None):
        """The training step's cost: ``flops`` (the products and
        convolutions of forward and backward, counted by
        ``torch.utils.flop_counter`` on the unfused graph over meta
        tensors, plus a few operations an element for the update) and
        ``bytes accessed`` (what the step must move: the inputs and outputs
        once, each parameter, gradient, optimizer state and aux array read
        and written once). Nothing runs on the device and the state is not
        touched."""
        from torch.utils.flop_counter import FlopCounterMode

        if not self.params and self.param_names:
            raise MXNetError("call init_params first")
        placed = self._place_batch(data, label)
        prog = copy.copy(self._prog)
        prog.fusion_plan = {}
        meta = torch.device("meta")
        args, leaves = [], []
        for n in prog.arg_names:
            src = placed[n] if n in placed else self.params[n]
            t = torch.empty_like(src, device=meta)
            if n not in placed:
                t.requires_grad_(True)
                leaves.append(t)
            args.append(t)
        aux = tuple(torch.empty_like(self.aux[n], device=meta) for n in self.aux_names)
        counter = FlopCounterMode(display=False)
        with counter, torch.enable_grad():
            outs, _ = prog.interpret(tuple(args), aux, True, meta)
            heads = [o for o in outs if o.requires_grad]
            if heads and leaves:
                torch.autograd.grad(heads, leaves, grad_outputs=[torch.ones_like(o) for o in heads],
                                    allow_unused=True)
        n_params = sum(p.numel() for p in self.params.values())
        n_states = len(self._fo.state_names)
        nbytes = sum(t.numel() * t.element_size() for t in placed.values())
        nbytes += sum(o.numel() * o.element_size() for o in outs)
        nbytes += sum(p.numel() * p.element_size() for p in self.params.values()) * (
            4 + 2 * n_states)  # w read+written, g written+read, states read+written
        nbytes += 2 * sum(a.numel() * a.element_size() for a in self.aux.values())
        return {"flops": float(counter.get_total_flops() + 5 * n_params * (1 + n_states)),
                "bytes accessed": float(nbytes)}

    # ------------------------------------------------------------------ misc
    def get_params(self):
        """Params/aux as host numpy (for checkpointing / Module interop)."""
        fetch = lambda d: {k: v.detach().cpu().numpy().copy() for k, v in d.items()}  # noqa: E731
        return fetch(self.params), fetch(self.aux)

    def set_params(self, arg_params, aux_params=None):
        """Copy values (numpy, tensors or NDArrays) into the state cell's
        tensors, allocating the cell at the first call; a captured graph
        keeps reading the same tensors."""
        arg = {k: v for k, v in (arg_params or {}).items() if k in self.param_names}
        aux = {k: v for k, v in (aux_params or {}).items() if k in self.aux_names}
        st = self._state
        st.version += 1
        with torch.no_grad():
            if st.flats is None and arg:
                self._allocate(arg)
            for name, v in arg.items():
                st.params[name].copy_(torch.as_tensor(_host(v)))
            for name, v in aux.items():
                src = torch.as_tensor(_host(v))
                if name in st.aux:
                    st.aux[name].copy_(src)
                else:
                    st.aux[name] = src.to(self._device).clone()


class _CapturedSteps:
    """N training steps captured as one CUDA graph over static input slots
    and a static learning-rate vector. It reads its tensors by address, as
    the decode megastep's graph does (``serving/kv_decode.py``), so a
    replay whose state tensors or generator were replaced raises."""

    def __init__(self, trainer, inputs_list):
        from .. import ops as _ops
        from .. import random as _random

        dev = trainer._device
        st = trainer._state
        n = len(inputs_list)
        self.static_inputs = [{k: torch.empty_like(v) for k, v in inp.items()}
                              for inp in inputs_list]
        self.static_lrs = torch.zeros(n, dtype=torch.float32, device=dev)
        self.bound = trainer._bound_tensors()
        self.gen = None
        graph = torch.cuda.CUDAGraph()
        if trainer._needs_rng:
            # Dropout's bernoulli_ draws from the device's generator: the
            # graph must advance its offset on each replay
            if not hasattr(graph, "register_generator_state"):
                raise MXNetError("a CUDA graph of a step with a random op needs "
                                 "CUDAGraph.register_generator_state (torch %s has none)"
                                 % torch.__version__)
            self.gen = _random.generator(dev)
            graph.register_generator_state(self.gen)
        if st.pool is None:
            st.pool = torch.cuda.graph_pool_handle()
        before = _ops.launch_counts(), _ops.schedule_counts()
        with torch.cuda.graph(graph, pool=st.pool):
            res = [trainer._one_step(self.static_inputs[i], self.static_lrs[i])
                   for i in range(n)]
            # the stacked finite vectors are written by the graph too
            self.outs, self.finite = trainer._collect(res)
        after = _ops.launch_counts(), _ops.schedule_counts()
        # the capture launched nothing: take its counts back, and add them
        # at every replay instead
        self.replay_launches = tuple({k: a[k] - b[k] for k in a} for a, b in zip(after, before))
        _ops.add_launch_counts(*({k: -v for k, v in c.items()} for c in self.replay_launches))
        self.graph = graph
        self.replays = 0

    def run(self, trainer, inputs_list, lrs):
        from .. import ops as _ops
        from .. import random as _random

        if any(a is not b for a, b in zip(trainer._bound_tensors(), self.bound)) or (
                self.gen is not None and _random.generator(trainer._device) is not self.gen):
            raise MXNetError(
                "fused step: the trainer's state tensors or the device's generator are not "
                "the ones its CUDA graph was captured on; write into them in place")
        for slots, inp in zip(self.static_inputs, inputs_list):
            for k, dst in slots.items():
                dst.copy_(inp[k], non_blocking=True)
        self.static_lrs.copy_(torch.tensor(lrs, dtype=torch.float32), non_blocking=True)
        self.graph.replay()
        self.replays += 1
        _ops.add_launch_counts(*self.replay_launches)
        outs = [tuple(o.clone() for o in step) for step in self.outs]
        return outs, (None if self.finite is None else self.finite.clone())


def _host(v):
    """A value as something ``torch.as_tensor`` takes: an NDArray's tensor,
    a tensor, or numpy."""
    if hasattr(v, "_tensor"):
        return v._tensor()
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    return v if v.flags.writeable else v.copy()
