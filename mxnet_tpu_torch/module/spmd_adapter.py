"""Lower Module's forward_backward+update onto one fused step.

Counterpart of ``mxnet_tpu/module/spmd_adapter.py``. When a ``Module``
spans several distinct contexts, or its store is a ``dist*`` sync store, or
``MXNET_MODULE_FUSED_STEP=1`` asks, this adapter replaces the exec-group +
kvstore loop with ``parallel.SPMDTrainer``: forward, backward, the gradient
sum and the optimizer update run as one step, on the card one CUDA graph.
The Module API (``fit``/``forward_backward``/``update``/``get_outputs``/
metrics/checkpointing) is unchanged; only the execution strategy moves.

The triggers, refusals and log lines are the JAX package's (``try_create``
JAX :305-396, ``derive`` :461-502). Duplicates are judged by ``Context``
equality, so ``[gpu(0), gpu(0)]`` and ``[cpu(0), cpu(0)]`` stay on the
per-device path, as JAX's duplicate-device check keeps them. Contexts that
name several physical devices in one process also stay there: the port's
fused step runs one device a process. ``MXNET_AUTOPLAN=1`` asks the
planner (``parallel/autoplan.py``) for the mesh and the per-parameter specs
of a one-process job (``_autoplan_mesh``, JAX :367-456); a failed or
infeasible plan, a plan with pipeline stages and a multi-process job log
and keep the all-data mesh, as the JAX package's rule that autoplan never
takes down a job says. ``MXNET_GRAPHLINT`` lints the bound graph against
the real mesh and rules (``_lint_plan``). Bucketing rides the fused step
through ``derive``: each bucket's trainer shares the donor's state cell.
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from ..base import MXNetError

__all__ = ["SPMDStepAdapter", "train_megastep_n"]


# copied from mxnet_tpu/module/spmd_adapter.py (backend-free)
def train_megastep_n(default=1):
    """``MXNET_TRAIN_MEGASTEP_N``: batches buffered per fused dispatch.

    N=1 (the default) is one dispatch a batch. N>1 buffers N batches and
    runs them through ONE N-step dispatch (``SPMDTrainer.step_many``, on the
    card one CUDA graph of N steps). Junk or <1 falls back to
    ``default``."""
    raw = os.environ.get("MXNET_TRAIN_MEGASTEP_N", "")
    try:
        n = int(raw)
    except (TypeError, ValueError):
        return default
    return n if n >= 1 else default


class SPMDStepAdapter:
    def __init__(self, module, mesh, fn_opt, lr_of_step, shared=None,
                 rules=None):
        from ..parallel.trainer import SPMDTrainer

        self._lr_of_step = lr_of_step
        self._fn_opt = fn_opt
        # a batch's arrays come in the order of the bound descriptors (the
        # iterator's provide_data), as the exec group loads them; the JAX
        # package zips module._data_names instead, which crosses inputs when
        # an iterator orders them otherwise (ROADMAP.md section 3)
        self._data_names = _names(module._data_shapes) or list(module._data_names)
        self._label_names = _names(module._label_shapes) or list(module._label_names)
        self._ctx = module._context[0]
        # the bind-time rewrite with the module's shapes (JAX :56-57); weight
        # names are kept, so params, checkpoints and store keys are unaffected
        self.trainer = SPMDTrainer(
            self._rewrite_symbol(module),
            mesh,
            data_names=tuple(self._data_names),
            label_names=tuple(self._label_names),
            optimizer=fn_opt,
            rules=rules,
        )
        self._optimizer = module._optimizer
        self._outputs = None
        self._pending_step = False  # a fused step ran, update() not yet seen
        self._megastep_n = train_megastep_n()
        self._buf = []           # buffered (data, label, lr, labels_nd) tuples
        self._metric_pairs = []  # flushed (labels_nd, outputs) awaiting metric
        if self._megastep_n > 1 and self.trainer._spans_processes:
            logging.warning(
                "MXNET_TRAIN_MEGASTEP_N=%d ignored: multi-process mesh — "
                "dispatching one batch per step", self._megastep_n)
            self._megastep_n = 1
        if self._megastep_n > 1 and shared is not None:
            # bucketing interleaves steps from several per-bucket adapters
            # over ONE shared state cell; buffering would flush them out of
            # order and corrupt the optimizer step sequence
            logging.warning(
                "MXNET_TRAIN_MEGASTEP_N=%d ignored for bucket adapter: "
                "shared-state buckets dispatch one batch per step",
                self._megastep_n)
            self._megastep_n = 1
        if shared is not None:
            # bucketing: same tensors, a step of this bucket's shapes
            self.trainer.adopt_state(shared.trainer)
        else:
            self.adopt_params(module._arg_params, module._aux_params)
        self._lint_plan(module)

    @staticmethod
    def _bind_hints(module):
        """The module's bound input shapes and dtypes (JAX :330-348)."""
        shapes, types = {}, {}
        for desc in list(module._data_shapes or []) + list(module._label_shapes or []):
            name, shape = desc[0], desc[1]
            shapes[name] = tuple(shape)
            dt = getattr(desc, "dtype", None)
            if dt is not None:
                types[name] = np.dtype(dt)
        return shapes, types

    def _rewrite_symbol(self, module):
        """The rewrite hook of the fused-step bind path (JAX :110-120): the
        trainer runs the REWRITTEN graph, with ``executor.bind``'s
        verify/fallback semantics (and, under ``MXNET_GRAPHREWRITE=0``, the
        port's always-on rules)."""
        from ..analysis.rewrite import rewrite_for_bind

        shapes, types = self._bind_hints(module)
        return rewrite_for_bind(module._symbol, shapes, types, grad_req="write",
                                target="spmd_bind")[0]

    def _lint_plan(self, module):
        """``MXNET_GRAPHLINT`` on the fused-step bind path (JAX :123-137).
        Unlike the one-device ``executor.bind`` lint, this one hands the
        passes the REAL mesh and sharding rules, so the GL4xx sharding-plan
        lint and the per-device GL5xx memory plan judge the plan the
        trainer runs. The graph linted is the one the trainer binds (the
        rewritten symbol)."""
        from ..analysis import graphlint_mode, lint_bind

        mode = graphlint_mode()
        if mode is None:
            return
        shapes, types = self._bind_hints(module)
        lint_bind(self.trainer._prog.symbol, shapes, types, mode, target="spmd_bind",
                  mesh=self.trainer.mesh, rules=self.trainer.rules, train=True)

    @property
    def params_version(self):
        """The count of writes to the trainer's params and aux. It lives on
        the SHARED state cell: a step through bucket A leaves bucket B's
        executors behind too."""
        return self.trainer._state.version

    def consume_pending_step(self):
        """True iff a fused step ran since the last update() — lets update()
        distinguish the fit() pairing from a manual fwd/bwd loop."""
        pending, self._pending_step = self._pending_step, False
        return pending

    # ------------------------------------------------------------------ params
    def adopt_params(self, arg_params, aux_params):
        """Take the module's params as the trainer's state (copied into its
        tensors). In a multi-process mesh every worker then takes rank 0's
        values (the reference's kvstore-init broadcast)."""
        self.trainer.set_params(arg_params or {}, aux_params or {})
        if self.trainer._spans_processes:
            import torch.distributed as tdist

            st = self.trainer._state
            for t in list(st.flats["params"].values()) + list(st.aux.values()):
                tdist.broadcast(t, src=0, group=self.trainer.mesh.group)

    def export_params(self, arg_params, aux_params):
        """Write the trainer's current params back into the module's
        NDArray dicts (checkpointing / get_params)."""
        self.flush()  # buffered megastep batches must land before export
        st = self.trainer._state
        for k, v in st.params.items():
            arg_params[k][:] = v.detach()
        for k, v in st.aux.items():
            aux_params[k][:] = v

    # ------------------------------------------------------------------ step
    def step(self, data_batch):
        """The fused train step: fwd + bwd + gradient sum + update.

        With ``MXNET_TRAIN_MEGASTEP_N`` > 1 the batch is only BUFFERED here;
        every N-th call (or an explicit ``flush``) dispatches all N as one
        N-step dispatch. The lr schedule is still read at buffer time, so
        schedules fire on the same optimizer step as the N=1 path."""

        def dev(v):
            return v._tensor() if hasattr(v, "_tensor") else v

        data = {n: dev(v) for n, v in zip(self._data_names, data_batch.data)}
        label = {}
        if self._label_names and data_batch.label is not None:
            label = {n: dev(v) for n, v in zip(self._label_names, data_batch.label)}
        opt = self._optimizer
        # legacy ordering (optimizer.py _update_count → _get_lr): the counter
        # increments BEFORE the schedule is read
        opt.num_update += 1
        lr = self._lr_of_step(opt.num_update)
        if self._megastep_n <= 1:
            self._outputs = self.trainer.step(data, label, lr=lr)
            self._pending_step = True
            return
        # the iterator may reuse its buffers across next() calls — copy now
        data = {n: _copy(v) for n, v in data.items()}
        label = {n: _copy(v) for n, v in label.items()}
        labels_nd = [lb.copy() for lb in data_batch.label] if data_batch.label is not None else []
        self._buf.append((data, label, lr, labels_nd))
        self._outputs = None
        self._pending_step = True
        if len(self._buf) >= self._megastep_n:
            self.flush()

    def flush(self):
        """Dispatch any buffered batches through one N-step dispatch."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        outs = self.trainer.step_many(
            [b[0] for b in buf], [b[1] for b in buf],
            lrs=[b[2] for b in buf])
        self._metric_pairs.extend(
            (b[3], o) for b, o in zip(buf, outs))
        self._outputs = outs[-1]

    def drain_metric(self, eval_metric):
        """Feed every flushed-but-unreported (labels, outputs) pair into
        ``eval_metric``. Returns True iff anything was drained."""
        pairs, self._metric_pairs = self._metric_pairs, []
        for labels_nd, outs in pairs:
            eval_metric.update(labels_nd, self._wrap(outs))
        return bool(pairs)

    def update_metric(self, eval_metric, labels):
        """Module.update_metric seam. Returns True when this adapter owns
        the metric update (fused step ran), False → exec-group path.

        Megastep mode drains the flushed backlog instead of pairing the
        caller's ``labels`` with ``get_outputs()``; a still-buffered batch
        also returns True (its metric row arrives at the next flush)."""
        if self._megastep_n > 1:
            if self.drain_metric(eval_metric):
                return True
            return bool(self._buf)
        if self._outputs is None:
            return False
        eval_metric.update(labels, self.get_outputs())
        return True

    def _wrap(self, outs):
        from ..ndarray import _wrap

        return [_wrap(o, self._ctx) for o in outs]

    def get_outputs(self):
        """Step outputs as NDArrays. Across processes each process sees its
        own rows (the ones it fed), so update_metric(labels) pairs
        correctly."""
        if self._outputs is None:
            return []
        return self._wrap(self._outputs)

    # ------------------------------------------------------------- opt states
    def get_states(self):
        """The optimizer state as the JAX package pickles it: numpy
        ``{"t", "mom"}`` or ``{"t", "m", "v"}``, so either package's fused
        step loads the other's file."""
        from ..convert import opt_state_to_numpy

        self.flush()  # buffered megastep batches must land before snapshot
        return pickle.dumps(opt_state_to_numpy(self.trainer.opt_state))

    def freeze(self):
        """The weights, aux values and optimizer state as the last dispatched
        step left them, copied now (``checkpoint.Frozen``: one clone a flat
        buffer, ordered on the stream after the step, so a later replay
        cannot reach them). Returns ``(weights, states)``: ``weights`` maps
        ``"arg:<name>"``/``"aux:<name>"`` to frozen values, and ``states()``
        makes the ``get_states`` pickle from the frozen state, on whichever
        thread writes it."""
        from ..checkpoint import Frozen, FrozenView

        self.flush()
        tr = self.trainer
        st = tr._state
        weights, frozen = {}, {"t": Frozen(st.opt_state["t"])}
        for key in ("params",) + tuple(tr._fo.state_names):
            views = weights if key == "params" else frozen.setdefault(key, {})
            for dt, names in st.flats["groups"].items():
                flat, off = Frozen(st.flats[key][dt]), 0
                for n in names:
                    p = st.params[n]
                    views[("arg:" + n) if key == "params" else n] = FrozenView(
                        flat, off, p.numel(), p.shape)
                    off += p.numel()
        for n, a in st.aux.items():
            weights["aux:" + n] = Frozen(a)

        def states():
            return pickle.dumps({k: v.numpy() if k == "t" else {n: x.numpy() for n, x in v.items()}
                                 for k, v in frozen.items()})

        return weights, states

    def set_states(self, blob):
        """Copy a ``get_states`` pickle (either package's) into the
        trainer's state tensors."""
        from ..convert import load_fused_states

        self.trainer.opt_state = load_fused_states(blob)


def _names(descs):
    return [d.name if hasattr(d, "name") else d[0] for d in descs or []]


def _copy(v):
    return v.clone() if hasattr(v, "clone") else v.copy()


def try_create(module, kvstore_obj):
    """Create an adapter when the Module's configuration supports the fused
    step; otherwise return None (→ legacy per-device + kvstore path).

    Triggers: several distinct contexts, a ``dist*`` sync kvstore, or
    ``MXNET_MODULE_FUSED_STEP=1``. ``MXNET_MODULE_FUSED_STEP=0`` disables."""
    def rejected(why):
        # one findable log line naming the trigger
        logging.warning("fused SPMD step disabled: %s — using the legacy "
                        "per-device + kvstore path", why)
        return None

    flag = os.environ.get("MXNET_MODULE_FUSED_STEP", "")
    if flag == "0":
        return None  # explicit opt-out, no warning needed
    dist = (kvstore_obj is not None and "dist" in kvstore_obj.type
            and "async" not in kvstore_obj.type)
    multi_dev = len(module._context) > 1
    if not (dist or multi_dev or flag == "1"):
        return None  # single device, nothing to fuse over — stay quiet
    if not module.for_training or module.inputs_need_grad:
        return None  # inference / grad-of-input binds are not a step at all
    if not getattr(module, "_fused_step_ok", True):
        return None  # explicit constructor opt-out (fused_step=False) — quiet
    if getattr(module, "_monitor_installed", False):
        return rejected("a Monitor is installed (per-op taps need the "
                        "exec-group path)")
    if module._fixed_param_names:
        return rejected("fixed_param_names is set")
    wl = module._work_load_list
    if wl and len(set(wl)) > 1:
        return rejected("uneven work_load_list %r" % (wl,))
    bad_req = [n for n in module._param_names
               if module._exec_group.grad_req.get(n) != "write"]
    if bad_req:
        return rejected("grad_req != 'write' for %s" % bad_req[:3])

    from ..parallel.optim import functional_from_optimizer

    fn = functional_from_optimizer(module._optimizer, set(module._param_names))
    if fn is None:
        logging.warning(
            "fused SPMD step unavailable for optimizer %s — falling back to "
            "the per-device kvstore path", type(module._optimizer).__name__)
        return None
    init, apply, lr_of_step = fn

    from .. import dist as _dist
    from ..parallel.autoplan import autoplan_enabled
    from ..parallel.mesh import _process_mesh, make_mesh

    devices = list(module._context)
    if len(set(devices)) != len(devices):
        return rejected("duplicate devices in context list")
    physical = {ctx.torch_device for ctx in devices}
    if len(physical) > 1:
        return rejected("the contexts name %d physical devices; the fused step runs "
                        "one device a process" % len(physical))
    mesh, rules = None, None
    if autoplan_enabled():
        # MXNET_AUTOPLAN=1: the planner picks the mesh shape and the
        # per-param specs. It runs BEFORE the batch-divisibility guard: a
        # model-parallel plan (dp < devices) serves batches the all-data
        # mesh cannot split (JAX :405-414)
        mesh, rules = _autoplan_mesh(module, devices)
    if mesh is None:
        if module._exec_group.batch_size % len(module._context):
            return rejected(
                "batch size %d does not split evenly over %d devices"
                % (module._exec_group.batch_size, len(module._context)))
        if dist and _dist.is_initialized() and _dist.num_workers() > 1:
            mesh = _process_mesh(devices[0])  # global mesh: one context a process
        else:
            mesh = make_mesh((len(devices),), ("data",), devices)
    else:
        # the planned mesh (one process only) splits the batch over its
        # data axis alone, so only dp must divide the batch
        dp = dict(mesh.shape).get("data", 1)
        if module._exec_group.batch_size % dp:
            return rejected(
                "batch size %d does not split evenly over the planned "
                "data axis (dp=%d)" % (module._exec_group.batch_size, dp))
    return SPMDStepAdapter(module, mesh, (init, apply), lr_of_step, rules=rules)


def _autoplan_mesh(module, devices):
    """Ask the planner for this module's mesh and sharding rules (JAX
    :421-456). Returns (None, None), with a logged reason, on ANY failure or
    infeasibility: autoplan never takes down a job that runs on the
    default all-data mesh."""
    from .. import dist as _dist
    from ..parallel import autoplan
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import ShardingRules

    if _dist.is_initialized() and _dist.num_workers() > 1:
        # as the JAX package: the module's bind shapes are per-process
        # LOCAL batches while the mesh covers every process, so the
        # planner would price peaks and reshards at 1/P of reality, and a
        # tp-heavy winner with dp < P would glue different local rows into
        # one "replicated" batch
        logging.warning(
            "MXNET_AUTOPLAN=1: multi-process (dist) jobs are not planned "
            "yet — using the default all-data mesh")
        return None, None
    shapes, types = SPMDStepAdapter._bind_hints(module)
    try:
        plan = autoplan.plan_parallel(module._symbol, shapes, types=types,
                                      devices=len(devices))
    except Exception as exc:
        # PlanError or anything the analysis passes throw on an exotic
        # graph: autoplan NEVER takes down a job that runs on the default mesh
        logging.warning("MXNET_AUTOPLAN=1: planner failed (%s: %s) — using "
                        "the default all-data mesh", type(exc).__name__, exc)
        return None, None
    if not plan.feasible:
        logging.warning("MXNET_AUTOPLAN=1: no feasible plan (%s) — using "
                        "the default all-data mesh", plan.reason)
        return None, None
    if plan.pipeline_stages > 1:
        logging.warning(
            "MXNET_AUTOPLAN=1: the winning plan needs %d pipeline stages "
            "and the fused SPMD step cannot pipeline — train through "
            "module.PipelineExecutorGroup instead. Falling back to the "
            "default mesh.", plan.pipeline_stages)
        return None, None
    logging.info("MXNET_AUTOPLAN=1: %s", plan.summary())
    mesh = make_mesh(dict(plan.mesh), devices=devices)
    rules = ShardingRules(mesh, data_axis="data", model_axis="model",
                          param_rule=plan.param_rule())
    return mesh, rules


def derive(module, shared_adapter):
    """Adapter for a bucket Module that shares a bound module's training
    state (same tensors, a step of this bucket's shapes). Returns None —
    with one warning naming the trigger — when this bucket can't ride the
    fused step; the caller (borrow_optimizer) then RAISES rather than
    training a legacy per-bucket path against stale weights."""
    if os.environ.get("MXNET_MODULE_FUSED_STEP", "") == "0":
        logging.warning("fused SPMD step disabled for bucket: "
                        "MXNET_MODULE_FUSED_STEP=0 set after the donor "
                        "module fused")
        return None
    if not module.for_training or module.inputs_need_grad:
        logging.warning("fused SPMD step disabled for bucket: module is "
                        "inference-only or needs input gradients")
        return None
    if module._exec_group.batch_size % len(module._context):
        logging.warning(
            "fused SPMD step disabled for bucket: batch size %d does not "
            "split evenly over %d devices", module._exec_group.batch_size,
            len(module._context))
        return None
    if shared_adapter._megastep_n > 1:
        logging.warning(
            "MXNET_TRAIN_MEGASTEP_N=%d disabled: bucketing shares one "
            "optimizer state cell across modules — dispatching one batch "
            "per step from here on", shared_adapter._megastep_n)
        shared_adapter.flush()
        shared_adapter._megastep_n = 1
    try:
        return SPMDStepAdapter(
            module, shared_adapter.trainer.mesh, shared_adapter._fn_opt,
            shared_adapter._lr_of_step, shared=shared_adapter,
            rules=shared_adapter.trainer.rules)
    except MXNetError as exc:
        logging.warning("fused SPMD step disabled for bucket: %s", exc)
        return None
