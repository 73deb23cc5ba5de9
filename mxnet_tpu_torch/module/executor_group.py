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
``PipelineExecutorGroup`` (JAX :295) comes with ``parallel/autoplan.py``
(``ROADMAP.md`` section 1.4b) and raises.
"""
from __future__ import annotations

from typing import List

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
    """GPipe-style pipeline execution of one Symbol (JAX :295): comes with
    ``parallel/autoplan.py``, which the port has not yet."""

    def __init__(self, symbol, context, data_shapes, label_shapes=None, num_stages=2,
                 microbatches=None, cut_entries=None, type_dict=None, for_training=True,
                 logger=None):
        raise MXNetError("PipelineExecutorGroup: pipeline parallelism comes with "
                         "parallel/autoplan.py, which the port has not yet (ROADMAP.md "
                         "section 1.4b)")
