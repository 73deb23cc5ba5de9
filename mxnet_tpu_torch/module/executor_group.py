"""DataParallelExecutorGroup: the Module's executors, one per context.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (:25-286; reference:
python/mxnet/module/executor_group.py:77, decide_slices :207, bind_exec
:270, forward :355, backward :481, update_metric :511). The batch splits by
``workload`` into one slice per context; each context gets its own
executor, made by ``simple_bind`` (or, for a bucket, by ``bind`` over the
default bucket's arrays on that context), so each holds its own parameter,
gradient and aux tensors even where two contexts name one device (every
``cpu(i)`` is the one CPU, and ``[gpu(0), gpu(0)]`` is one card twice).
``param_arrays``, ``grad_arrays`` and ``aux_arrays`` are per-context lists
in the reference's layout; the gradients are summed across contexts by the
store (``kvstore_helper``). ``load_data_label`` copies each context's rows
of the batch into its bound input arrays in place, with no rebinding; the
executors' forward and backward run the fused sites' CUDA kernels.
``PipelineExecutorGroup`` (JAX :295-517) runs one Symbol as a GPipe
pipeline of stage executors (``parallel/autoplan.py`` cuts it).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context
from ..executor import bind, simple_bind
from .. import ndarray as nd
from ..ndarray import zeros

__all__ = ["DataParallelExecutorGroup", "PipelineExecutorGroup"]


# copied from mxnet_tpu/module/executor_group.py (backend-free)
def _split_input_slice(batch_size, work_load_list):
    """Batch index ranges per device (reference: executor_group.py:207
    decide_slices / mxnet.executor_manager._split_input_slice)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size must be >= number of devices")
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            stop = batch_size
        else:
            stop = start + int(round(batch_size * w / total))
        slices.append(slice(start, stop))
        start = stop
    return slices


class DataParallelExecutorGroup:
    """(reference: executor_group.py:77)"""

    def __init__(self, symbol, contexts: List[Context], workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None, logger=None,
                 fixed_param_names=None, grad_req="write"):
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else None
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])

        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_names = [d.name if hasattr(d, "name") else d[0] for d in self.data_shapes]
        self.label_names = ([lb.name if hasattr(lb, "name") else lb[0]
                             for lb in self.label_shapes] if self.label_shapes else [])

        first = self.data_shapes[0]
        self.batch_size = (first.shape if hasattr(first, "shape") else first[1])[0]
        self.slices = _split_input_slice(self.batch_size, self.workload)

        # per-arg grad_req (params fixed → null; data per inputs_need_grad)
        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = ("null" if (not for_training
                                                  or name in self.fixed_param_names)
                                       else grad_req)
            elif name in self.data_names:
                self.grad_req[name] = grad_req if inputs_need_grad else "null"
            else:  # labels
                self.grad_req[name] = "null"

        # per-param comm priority for the dist KVStore's bucketed push/pull,
        # from the symbol's topological order (JAX :103)
        self.param_priorities = self._topo_priorities(symbol)

        self.execs = []
        self._bind_execs(shared_group)

        # param_arrays[i] = list over devices of the NDArray for param i
        self.param_arrays = [[e.arg_dict[name] for e in self.execs] for name in self.param_names]
        self.grad_arrays = [[e.grad_dict[name] for e in self.execs] for name in self.param_names]
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs] for name in self.aux_names]
        self.data_arrays = [[e.arg_dict[name] for e in self.execs] for name in self.data_names]
        self.label_arrays = [[e.arg_dict[name] for e in self.execs] for name in self.label_names]
        self.input_grad_arrays = ([[e.grad_dict[name] for e in self.execs]
                                   for name in self.data_names] if inputs_need_grad else [])

    # copied from mxnet_tpu/module/executor_group.py (backend-free)
    def _topo_priorities(self, symbol):
        """{param index: priority} from the symbol DAG's topological order."""
        try:
            topo_vars = [n.name for n in symbol._topo() if n.is_variable]
        except Exception:  # foreign symbol object: argument order
            topo_vars = []
        pos = {n: i for i, n in enumerate(topo_vars)}
        ranked = sorted(range(len(self.param_names)),
                        key=lambda i: pos.get(self.param_names[i], i))
        return {idx: -rank for rank, idx in enumerate(ranked)}

    def _bind_execs(self, shared_group):
        name2shape = {}
        for d in list(self.data_shapes) + list(self.label_shapes or []):
            name2shape[d.name if hasattr(d, "name") else d[0]] = tuple(
                d.shape if hasattr(d, "shape") else d[1])
        for i, (ctx, slc) in enumerate(zip(self.contexts, self.slices)):
            dev_shapes = {name: (slc.stop - slc.start,) + shape[1:]
                          for name, shape in name2shape.items()}
            if shared_group is None:
                ex = simple_bind(self.symbol, ctx, grad_req=self.grad_req, **dev_shapes)
            else:
                # a bucket's executor binds the SAME parameter, gradient and
                # aux arrays as the default bucket's, so an update through
                # any bucket updates all (reference: graph_executor.cc:348)
                ex = self._bind_shared(shared_group, i, ctx, dev_shapes)
            self.execs.append(ex)

    def _bind_shared(self, shared_group, dev_i, ctx, dev_shapes):
        shared_ex = shared_group.execs[dev_i]
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**dev_shapes)
        if arg_shapes is None:
            raise MXNetError("bind (shared): insufficient shape info")
        args, grads, reqs = [], [], []
        for name, shape in zip(self.arg_names, arg_shapes):
            req = self.grad_req[name]
            if name in shared_ex.arg_dict and tuple(shared_ex.arg_dict[name].shape) == tuple(shape):
                args.append(shared_ex.arg_dict[name])
                grads.append(shared_ex.grad_dict.get(name) if req != "null" else None)
            else:
                args.append(zeros(shape, ctx=ctx))
                grads.append(zeros(shape, ctx=ctx) if req != "null" else None)
            reqs.append(req if grads[-1] is not None else "null")
        auxs = []
        for name, shape in zip(self.aux_names, aux_shapes):
            if name in shared_ex.aux_dict and tuple(shared_ex.aux_dict[name].shape) == tuple(shape):
                auxs.append(shared_ex.aux_dict[name])
            else:
                auxs.append(zeros(shape, ctx=ctx))
        return bind(self.symbol, ctx, args, args_grad=grads, grad_req=reqs, aux_states=auxs,
                    shared_exec=shared_ex)

    # -------------------------------------------------------------- dataflow
    def _load_slices(self, arrays_per_name, batch_arrays):
        """Copy each context's rows of each batch array into its bound array
        in place: ``copy_``, across devices where the batch lies elsewhere
        (reference: executor_group.py _load_data/_load_general)."""
        if batch_arrays is None or len(batch_arrays) == 0:
            # label-less predict batch: nothing to load
            return
        if len(batch_arrays) < len(arrays_per_name):
            raise MXNetError(
                "batch supplies %d arrays but %d are bound — an iterator is "
                "under-feeding the module's inputs" % (len(batch_arrays), len(arrays_per_name)))
        for src, dev_arrays in zip(batch_arrays, arrays_per_name):
            if len(dev_arrays) == 1:
                dev_arrays[0][:] = src
                continue
            for dst, slc in zip(dev_arrays, self.slices):
                dst[:] = src[slc.start:slc.stop]

    def load_data_label(self, data_batch):
        self._load_slices(self.data_arrays, data_batch.data)
        if self.label_arrays and data_batch.label:
            self._load_slices(self.label_arrays, data_batch.label)

    def forward(self, data_batch, is_train=None):
        """(reference: executor_group.py:355)"""
        self.load_data_label(data_batch)
        if is_train is None:
            is_train = self.for_training
        for ex in self.execs:
            ex.forward(is_train=is_train)

    def backward(self, out_grads=None):
        """(reference: executor_group.py:481)"""
        assert self.for_training, "re-bind with for_training=True to run backward"
        for i, ex in enumerate(self.execs):
            if out_grads is None or len(self.execs) == 1:
                ex.backward(out_grads)
            else:
                slc = self.slices[i]
                ex.backward([g[slc.start:slc.stop] for g in out_grads])

    def forward_backward(self, data_batch):
        """One training step's forward and backward on every executor."""
        self.load_data_label(data_batch)
        for ex in self.execs:
            ex.forward_backward()

    def get_outputs(self, merge_multi_context=True):
        outputs = [[ex.outputs[i] for ex in self.execs] for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [outs[0] if len(outs) == 1 else nd.concatenate(outs, axis=0)
                    for outs in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [list(dev) for dev in self.input_grad_arrays]
        if merge_multi_context:
            return [g[0] if len(g) == 1 else nd.concatenate(g, axis=0) for g in grads]
        return grads

    def update_metric(self, eval_metric, labels):
        """(reference: executor_group.py:511)"""
        eval_metric.update(labels, self.get_outputs(merge_multi_context=True))

    # ---------------------------------------------------------------- params
    def set_params(self, arg_params, aux_params):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params, allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copy device-0 values out (devices hold identical params)."""
        for i, name in enumerate(self.param_names):
            arg_params[name] = self.param_arrays[i][0].copy()
        for i, name in enumerate(self.aux_names):
            aux_params[name] = self.aux_arrays[i][0].copy()

    def install_monitor(self, mon):
        for ex in self.execs:
            mon.install(ex)


class PipelineExecutorGroup:
    """GPipe-style pipeline-parallel execution of one Symbol (JAX :295-517).

    The auto-parallel planner's third axis (``parallel/autoplan.py``): the
    graph is cut at single-tensor boundaries into stages, each stage binds
    its OWN executor (1/S of the parameters, gradients and optimizer
    state), and a batch runs as ``microbatches`` slices pushed through the
    stages — GPipe's schedule with recompute-based backward:

      forward phase   every microbatch m: stage 0..S-1 forward, keeping
                      the boundary activations per (m, stage) and the last
                      stage's outputs per m; each stage's autograd graph is
                      dropped as soon as its forward ends,
      backward phase  every microbatch m in REVERSE: stage S-1..0 reloads
                      m's inputs and runs the cold ``backward`` (forward
                      and backward again from the bound arguments: a
                      recompute, so no stage's activations survive across
                      microbatches), handing each stage's boundary-input
                      gradient to the stage below; parameter grads
                      accumulate under ``grad_req='add'``.

    With per-example losses (SoftmaxOutput's default ``normalization=
    'null'``) the accumulated gradient over the microbatches equals the
    full-batch gradient. BatchNorm's moving stats update once per
    microbatch forward (µ-fold faster momentum than one full-batch step);
    the recompute discards its aux values, so they never update twice.
    Dropout draws fresh bits in the recompute.

    Where the reference keeps the batch as host numpy and copies a slice
    to the device for every (stage, microbatch, phase), the port moves the
    batch to the device once and slices it there: the same values, with no
    host sync a batch.
    """

    def __init__(self, symbol, context, data_shapes, label_shapes=None,
                 num_stages=2, microbatches=None, cut_entries=None,
                 type_dict=None, for_training=True, logger=None):
        from ..parallel import autoplan

        self.symbol = symbol
        self.context = context
        self.for_training = for_training
        self.data_shapes = [(d.name, tuple(d.shape)) if hasattr(d, "name")
                            else (d[0], tuple(d[1])) for d in data_shapes]
        self.label_shapes = [(l.name, tuple(l.shape)) if hasattr(l, "name")
                             else (l[0], tuple(l[1]))
                             for l in (label_shapes or [])]
        self.batch_size = self.data_shapes[0][1][0]
        mu = microbatches if microbatches is not None else \
            autoplan.autoplan_microbatches()
        if self.batch_size % mu:
            raise MXNetError(
                "batch size %d does not divide into %d microbatches"
                % (self.batch_size, mu))
        self.microbatches = mu
        self._mb = self.batch_size // mu

        full_shapes = dict(self.data_shapes + self.label_shapes)
        if cut_entries is None:
            cut_entries = autoplan.choose_cuts(
                symbol, full_shapes, types=type_dict, n_stages=num_stages)
        self.cut_entries = list(cut_entries)
        self.stage_symbols, self.boundary_names = autoplan.split_symbol(
            symbol, self.cut_entries)
        self.num_stages = len(self.stage_symbols)

        # ---- bind each stage at MICROBATCH shapes, chaining boundaries ----
        input_names = set(full_shapes)
        self.execs: List = []
        self._stage_inputs: List[List[str]] = []   # data/label vars per stage
        self._stage_params: List[List[str]] = []
        boundary_shape = None
        for k, ssym in enumerate(self.stage_symbols):
            args = ssym.list_arguments()
            stage_inputs = [n for n in args if n in input_names]
            bname = self.boundary_names[k - 1] if k > 0 else None
            params = [n for n in args
                      if n not in input_names and n != bname]
            shapes = {}
            for n in stage_inputs:
                sh = full_shapes[n]
                shapes[n] = (self._mb,) + tuple(sh[1:])
            grad_req = {n: "null" for n in stage_inputs}
            grad_req.update({n: "add" if for_training else "null"
                             for n in params})
            if bname is not None:
                shapes[bname] = boundary_shape
                grad_req[bname] = "write" if for_training else "null"
            ex = simple_bind(ssym, context, grad_req=grad_req,
                             type_dict=type_dict, **shapes)
            if k < self.num_stages - 1:
                _, out_shapes, _ = ssym.infer_shape(**shapes)
                boundary_shape = tuple(out_shapes[0])
            self.execs.append(ex)
            self._stage_inputs.append(stage_inputs)
            self._stage_params.append(params)

        self.param_names = [n for ps in self._stage_params for n in ps]
        self.aux_names = [n for s in self.stage_symbols
                          for n in s.list_auxiliary_states()]
        self.param_arrays = [self._owner(n).arg_dict[n]
                             for n in self.param_names]
        self.grad_arrays = [self._owner(n).grad_dict[n]
                            for n in self.param_names]
        self._outputs_mb: List[List[nd.NDArray]] = []

    def _owner(self, param):
        for k, names in enumerate(self._stage_params):
            if param in names:
                return self.execs[k]
        raise MXNetError("parameter %r is bound by no stage" % param)

    # -------------------------------------------------------------- dataflow
    def _load_stage_inputs(self, ex, stage, data_map, m):
        lo, hi = m * self._mb, (m + 1) * self._mb
        with torch.no_grad():
            for name in self._stage_inputs[stage]:
                src = data_map.get(name)
                if src is None:
                    # a label-less predict batch: leave the bound array as-is
                    # (the data side was validated in _batch_map)
                    continue
                ex.arg_dict[name]._tensor().copy_(src[lo:hi])

    def _batch_map(self, data_batch):
        """Name -> the batch's tensor on the executors' device, moved ONCE
        per batch; the schedule slices it on the device for every (stage,
        microbatch, phase)."""
        device = self.execs[0]._ctx.torch_device

        def dev(v):
            t = v._tensor() if isinstance(v, nd.NDArray) else torch.as_tensor(np.asarray(v))
            return t.to(device)

        data_map = {n: dev(v) for (n, _), v in
                    zip(self.data_shapes, data_batch.data or [])}
        if self.label_shapes and data_batch.label:
            data_map.update(
                {n: dev(v) for (n, _), v in
                 zip(self.label_shapes, data_batch.label)})
        missing = [n for n, _ in self.data_shapes if n not in data_map]
        if missing:
            raise MXNetError("batch is missing input(s) %s" % missing)
        return data_map

    def _load_boundary(self, ex, k, m):
        with torch.no_grad():
            ex.arg_dict[self.boundary_names[k - 1]]._tensor().copy_(
                self._boundaries[m][k - 1])

    def forward(self, data_batch, is_train=None):
        """Chain every microbatch through the stages (forward phase only);
        boundary activations are kept for a following ``backward``."""
        if is_train is None:
            is_train = self.for_training
        data_map = self._batch_map(data_batch)
        self._boundaries = [[None] * (self.num_stages - 1)
                            for _ in range(self.microbatches)]
        self._outputs_mb = []
        for m in range(self.microbatches):
            for k, ex in enumerate(self.execs):
                self._load_stage_inputs(ex, k, data_map, m)
                if k > 0:
                    self._load_boundary(ex, k, m)
                ex.forward(is_train=is_train)
                # drop the autograd graph the training forward kept (JAX
                # :450 clears _cached_vjp): backward recomputes per
                # microbatch anyway, and keeping it would pin this stage's
                # saved activations across the whole phase — the memory
                # this schedule exists to avoid
                ex._graph = None
                if k < self.num_stages - 1:
                    self._boundaries[m][k] = ex.outputs[0]._tensor().clone()
            self._outputs_mb.append([o.copy() for o in self.execs[-1].outputs])
        self._data_map = data_map

    def backward(self):
        """Backward phase of the GPipe schedule (call after ``forward``):
        reverse microbatch order, a forward+backward recompute per stage,
        grads accumulate across microbatches."""
        assert self.for_training, "bind with for_training=True"
        missing = [n for n, _ in self.label_shapes
                   if n not in self._data_map]
        if missing:
            raise MXNetError(
                "backward needs label input(s) %s but the batch carried "
                "none" % missing)
        with torch.no_grad():
            for g in self.grad_arrays:
                if g is not None:
                    g._tensor().zero_()
        for m in reversed(range(self.microbatches)):
            out_grad = None
            for k in reversed(range(self.num_stages)):
                ex = self.execs[k]
                self._load_stage_inputs(ex, k, self._data_map, m)
                if k > 0:
                    self._load_boundary(ex, k, m)
                # no graph may survive from the forward phase: it would be
                # the LAST microbatch's, not m's (JAX :483); the cold
                # backward reruns the forward on m's inputs and discards
                # its aux values
                ex._graph = None
                if k == self.num_stages - 1:
                    ex.backward()
                else:
                    ex.backward([out_grad])
                if k > 0:
                    out_grad = ex.grad_dict[self.boundary_names[k - 1]].copy()

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def get_outputs(self, merge_multi_context=True):
        """Last-stage outputs over the whole batch (microbatches
        re-concatenated along dim 0)."""
        n_out = len(self.execs[-1].outputs)
        return [nd.concatenate([mb[i] for mb in self._outputs_mb], axis=0)
                if self.microbatches > 1 else self._outputs_mb[0][i]
                for i in range(n_out)]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ---------------------------------------------------------------- params
    def set_params(self, arg_params, aux_params=None):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params or {},
                                allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        for k, ex in enumerate(self.execs):
            for name in self._stage_params[k]:
                arg_params[name] = ex.arg_dict[name].copy()
            for name, arr in ex.aux_dict.items():
                aux_params[name] = arr.copy()
