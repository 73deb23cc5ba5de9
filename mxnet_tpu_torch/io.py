"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (:38-763; reference: python/mxnet/io.py
DataBatch/DataDesc :19-103, NDArrayIter :453, ResizeIter :216,
PrefetchingIter :281, and the C++ MNISTIter iter_mnist.cc:241 and CSVIter
iter_csv.cc:132). ``NDArrayIter`` holds its sources as NDArrays on
``current_context()`` (the card unless the caller runs in ``with cpu():``):
each source goes to the device once, and every batch is a slice of it on
the device, with no host round trip; a padded last batch is one
concatenation on the device. ``PrefetchingIter`` runs a pump thread per
child iterator into a bounded queue. ``DevicePrefetchIter`` moves each
batch onto its device ahead of the training loop on a side CUDA stream,
through a pinned host staging buffer where the batch lies on the host, and
the consumer's stream waits on the copy's event.
"""
from __future__ import annotations

import queue
import struct
import threading
from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError
from . import telemetry as _tm
from .context import Context, current_context
from .ndarray import NDArray, array, concatenate, _wrap

__all__ = [
    "DataDesc",
    "DataBatch",
    "DataIter",
    "NDArrayIter",
    "ResizeIter",
    "PrefetchingIter",
    "DevicePrefetchIter",
    "device_prefetch_enabled",
    "CSVIter",
    "MNISTIter",
]


def device_prefetch_enabled():
    """Whether ``Module.fit`` auto-wraps the training iterator in a
    ``DevicePrefetchIter`` (``MXNET_IO_DEVICE_PREFETCH=1``,
    Off by default: the wrap changes nothing numerically (device copies are
    bit-preserving) but adds a pump thread."""
    import os

    return os.environ.get("MXNET_IO_DEVICE_PREFETCH", "0").strip().lower() \
        in ("1", "true", "on")


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape(+dtype/layout) of one input stream (reference: io.py:19)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch: data/label NDArray lists + pad/index bookkeeping."""

    def __init__(self, data, label=None, pad=None, index=None, bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (reference: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(
                data=self.getdata(), label=self.getlabel(), pad=self.getpad(), index=self.getindex()
            )
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalize data/label input to a list of (name, numpy) pairs
    (reference: io.py _init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out[k] = np.asarray(v)
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle/pad handling
    (reference: io.py:453)."""

    def __init__(
        self,
        data,
        label=None,
        batch_size=1,
        shuffle=False,
        last_batch_handle="pad",
        data_name="data",
        label_name="softmax_label",
    ):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)

        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]
        # each source onto the default context once; batches are slices of it
        ctx = current_context()
        self.data = [(k, array(v, ctx=ctx)) for k, v in self.data]
        self.label = [(k, array(v, ctx=ctx)) for k, v in self.label]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype) for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _next_batch(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def next(self):
        if not _tm.enabled():
            return self._next_batch()
        # batch-fetch latency: host slicing + NDArray materialization — the
        # time the accelerator would wait on input without a prefetcher.
        # The timer serves `counters` mode; the span serves `trace` mode.
        import time as _time

        t0 = _time.perf_counter()
        with _tm.span("io.next", iter=type(self).__name__):
            batch = self._next_batch()
        _tm.counter("io.batches").inc()
        _tm.timer("io.batch_fetch").add(_time.perf_counter() - t0)
        return batch

    def _getdata(self, data_source):
        """The batch's rows of each source: a view of the source on its
        device, or, for a padded batch, the tail and the head concatenated
        there."""
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [x[1].slice(self.cursor, self.cursor + self.batch_size) for x in data_source]
        # padding: wrap around (reference pads from the head)
        pad = self.batch_size - self.num_data + self.cursor
        return [concatenate([x[1].slice(self.cursor, self.num_data), x[1].slice(0, pad)])
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (reference: io.py:216)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur >= self.size:
            return False
        self.cur += 1
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            # wrap the child's epoch: this iterator's epoch is `size` batches
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _pump_loop(fetch, q, stop, end_sentinel):
    """The shared prefetch pump body (PrefetchingIter and
    DevicePrefetchIter): drive ``fetch()`` until epoch end (StopIteration)
    or a child error (surfaced to the consumer as the end token), with a
    bounded ``put`` that stays responsive to shutdown. ALWAYS terminates
    the queue with a sentinel/exception so the consumer can't hang."""
    end_token = end_sentinel
    try:
        while not stop.is_set():
            try:
                batch = fetch()
            except StopIteration:
                break
            except BaseException as exc:  # surface child errors
                end_token = exc
                break
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
    finally:
        q.put(end_token)


def _get_bounded(q, threads, what, poll_s=1.0):
    """``queue.get`` that cannot hang on a dead pump (GL804 audit,
    docs/static_analysis.md §GL8xx): poll with a timeout and raise once
    every pump thread is gone while the queue stayed empty — the sentinel
    guarantee of ``_pump_loop`` was violated (a hard-killed thread), so
    blocking forever is the only alternative. A slow-but-alive pump just
    keeps the poll going; steady state never times out."""
    while True:
        try:
            return q.get(timeout=poll_s)
        except queue.Empty:
            if not any(t.is_alive() for t in threads):
                raise MXNetError(
                    "%s: prefetch pump thread(s) died without terminating "
                    "their queue — batch stream lost; reset the iterator"
                    % what)


def _drain_and_join(queues, threads, stop, end_sentinel, timeout):
    """The shared bounded teardown: signal stop, drain each queue until
    its sentinel (unblocking a pump stuck on a full queue), then join
    every pump against ONE shared deadline. Returns the still-alive
    (wedged) threads."""
    import time as _time

    stop.set()
    for q in queues:
        while True:
            try:
                if q.get_nowait() is end_sentinel:
                    break
            except queue.Empty:
                break
    deadline = _time.monotonic() + timeout
    stuck = []
    for t in threads:
        t.join(timeout=max(0.0, deadline - _time.monotonic()))
        if t.is_alive():
            stuck.append(t)
    return stuck


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators (reference:
    io.py PrefetchingIter, C++ PrefetcherIter iter_prefetcher.h:28).

    Mechanism (original to this port): one pump thread per child iterator
    feeds a bounded queue (``prefetch_depth`` batches ahead, vs. the
    reference's fixed one-ahead event handshake); a sentinel marks epoch
    end. ``reset()`` tears the epoch's pumps down and starts fresh ones, so
    no cross-epoch thread state can leak.
    """

    _END = object()  # epoch-end sentinel

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, shutdown_timeout=5.0):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        assert self.iters
        self.n_iter = len(self.iters)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self.current_batch = None
        self._depth = max(1, int(prefetch_depth))
        self._shutdown_timeout = float(shutdown_timeout)
        self._queues = None
        self._threads = []
        self._stop = None
        self._ended = False  # epoch exhausted; queues carry no more batches
        self._wedged = None  # MXNetError once a pump failed to shut down
        self._start_epoch()

    # ------------------------------------------------------------ pump plumbing
    def _pump(self, child, q, stop):
        from . import faultinject as _fi

        def fetch():
            # injection site io.prefetch (docs/RESILIENCE.md): a `raise`
            # rides the error channel and surfaces to the consumer as the
            # epoch's failure; a delay/hang starves the training loop
            # (visible as io.prefetch_wait) and, past shutdown_timeout,
            # trips the wedge latch
            _fi.fire("io.prefetch")
            return child.next()

        _pump_loop(fetch, q, stop, PrefetchingIter._END)

    def _start_epoch(self):
        self._queues = [queue.Queue(maxsize=self._depth)
                        for _ in range(self.n_iter)]
        self._stop = threading.Event()
        self._ended = False
        self._threads = [
            threading.Thread(target=self._pump, args=(it, q, self._stop),
                             daemon=True)
            for it, q in zip(self.iters, self._queues)]
        for t in self._threads:
            t.start()

    def _shutdown(self, strict=True):
        """Stop the epoch's pumps with a BOUNDED join: one shared deadline
        (``shutdown_timeout`` seconds total, not per thread) covers every
        pump. A pump still alive past the deadline means its child iterator
        is wedged in user code — resetting the child underneath it would be
        a two-thread data race on the iterator's cursor, and silently
        carrying the thread into the next epoch leaks it forever. So the
        iterator latches a hard MXNetError: this reset raises it, and every
        later next()/reset() re-raises until the owner rebuilds the
        pipeline."""
        if self._stop is None:
            return
        stuck = _drain_and_join(self._queues, self._threads, self._stop,
                                PrefetchingIter._END,
                                self._shutdown_timeout)
        self._threads = []
        if stuck:
            self._wedged = MXNetError(
                "PrefetchingIter: %d pump thread(s) [%s] still running %gs "
                "after shutdown — a child iterator is blocked in user code; "
                "this prefetcher is wedged and cannot be reused (rebuild the "
                "data pipeline)" % (len(stuck),
                                    ", ".join(t.name for t in stuck),
                                    self._shutdown_timeout))
            if strict:
                raise self._wedged

    def _check_wedged(self):
        if self._wedged is not None:
            raise self._wedged

    def __del__(self):
        try:
            self._shutdown(strict=False)
        except Exception:
            pass

    # ------------------------------------------------------------------ DataIter
    @property
    def provide_data(self):
        return self._renamed(lambda it: it.provide_data, self.rename_data)

    @property
    def provide_label(self):
        return self._renamed(lambda it: it.provide_label, self.rename_label)

    def _renamed(self, get, renames):
        descs = []
        for k, it in enumerate(self.iters):
            for d in get(it):
                d = d if isinstance(d, DataDesc) else DataDesc(*d)
                if renames is not None:
                    d = DataDesc(renames[k][d.name], d.shape, d.dtype)
                descs.append(d)
        return descs

    def reset(self):
        self._check_wedged()
        self._shutdown()
        for it in self.iters:
            it.reset()
        self._start_epoch()

    def iter_next(self):
        self._check_wedged()
        if self._ended:
            return False  # pumps are gone; blocking on the queues would hang
        if _tm.enabled():
            # consumer-side stall: >0 here means the pumps can't keep up and
            # the accelerator is input-bound for this batch
            import time as _time

            t0 = _time.perf_counter()
            with _tm.span("io.prefetch_wait"):
                got = [_get_bounded(q, self._threads, "PrefetchingIter")
                       for q in self._queues]
            _tm.timer("io.prefetch_wait").add(_time.perf_counter() - t0)
        else:
            got = [_get_bounded(q, self._threads, "PrefetchingIter")
                   for q in self._queues]
        for g in got:
            if isinstance(g, BaseException):
                self._ended = True
                raise g  # a pump's child iterator failed mid-epoch
        ended = [g is PrefetchingIter._END for g in got]
        if any(ended):
            assert all(ended), "iterators disagree on epoch length"
            self._ended = True
            return False
        pad = got[0].pad
        assert all(g.pad == pad for g in got), "different pad between iterators"
        data, label = [], []
        for g in got:
            data.extend(g.data)
            label.extend(g.label)
        self.current_batch = DataBatch(data, label, pad, got[0].index)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class DevicePrefetchIter(DataIter):
    """Double-buffered device-side prefetch.

    One pump thread drives the child iterator ahead of the training loop:
    while step N runs, batch N+1 is fetched and copied onto ``device`` (a
    Context, default ``current_context()``) on a side CUDA stream, then
    parked in a bounded queue. A batch on the host goes through a pinned
    staging buffer and a ``non_blocking`` copy; one already on the card is
    copied there, into a buffer the prefetcher owns. The pump records an
    event on the side stream after the copies, ``next()`` makes the
    consumer's current stream wait on it, and every tensor that crosses the
    two streams is marked with ``record_stream``, so the caching allocator
    cannot hand out a buffer still in use by the other stream. With
    ``device=cpu()`` the copy runs on the CPU.

    ``augment`` receives the batch's DATA tensors (on the device)
    positionally and returns as many; it runs on the side stream. Labels pass
    through untouched. With ``augment=None`` the wrap is numerically a
    no-op: the copies preserve bits, so training results are bit-identical
    to the unwrapped iterator.

    The pump/teardown discipline (bounded-queue put, epoch-end sentinel,
    bounded shutdown join with the wedge latch) is ``PrefetchingIter``'s.
    """

    _END = object()

    def __init__(self, data_iter, prefetch_depth=2, device=None,
                 augment=None, shutdown_timeout=5.0):
        super().__init__()
        assert not isinstance(data_iter, list), \
            "DevicePrefetchIter wraps ONE iterator; compose PrefetchingIter for multi-stream"
        self.data_iter = data_iter
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        self.current_batch = None
        self._depth = max(1, int(prefetch_depth))
        self._shutdown_timeout = float(shutdown_timeout)
        self._ctx = Context(device) if device is not None else current_context()
        self._device = self._ctx.torch_device
        self._augment = augment
        # the side stream of the copies (None on the CPU)
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device.type == "cuda" else None)
        self.wait_s = 0.0  # consumer-side stall, accumulated per epoch
        self._queue = None
        self._thread = None
        self._stop = None
        self._ended = False
        self._wedged = None
        # the pump starts LAZILY on the first consume after construction /
        # reset(): the fit loop's unconditional end-of-epoch reset() (and
        # the final one after the last epoch) must not spin up a thread
        # that eagerly transfers batches nobody will read

    # ------------------------------------------------------------- device side
    def _put_array(self, a):
        """One array's tensor on the device, copied on the side stream."""
        src = a._tensor() if isinstance(a, NDArray) else torch.as_tensor(np.asarray(a))
        if self._stream is None:
            return src.to(self._device, copy=True)
        if src.device.type == "cpu":
            staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            staged.copy_(src)
            return staged.to(self._device, non_blocking=True)
        # a source on a card was written on its producer's stream
        src.record_stream(self._stream)
        return src.to(self._device, copy=True, non_blocking=True)

    def _to_device(self, batch):
        """Copy (and augment) one batch; returns (batch, the copies' event)."""
        if self._stream is None:
            data = [self._put_array(a) for a in (batch.data or [])]
            if self._augment is not None and data:
                data = self._augmented(data)
            label = [self._put_array(a) for a in (batch.label or [])]
            event = None
        else:
            # the producer's work (an iterator that slices on the card) first
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
            with torch.cuda.stream(self._stream):
                data = [self._put_array(a) for a in (batch.data or [])]
                if self._augment is not None and data:
                    data = self._augmented(data)
                label = [self._put_array(a) for a in (batch.label or [])]
                event = torch.cuda.Event()
                event.record(self._stream)
        return DataBatch([_wrap(d, self._ctx) for d in data],
                         [_wrap(lb, self._ctx) for lb in label],
                         batch.pad, batch.index), event

    def _augmented(self, data):
        out = tuple(self._augment(*data))
        assert len(out) == len(data), "augment must return one array per data input"
        return list(out)

    def _consume(self, batch, event):
        """The consumer's side: its stream waits for the copies, and each
        copied tensor is marked as used on it."""
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for a in list(batch.data) + list(batch.label):
                a._tensor().record_stream(consumer)
        return batch

    # ------------------------------------------------------------ pump plumbing
    def _pump(self, child, q, stop):
        from . import faultinject as _fi

        def fetch():
            _fi.fire("io.prefetch")
            return self._to_device(child.next())

        _pump_loop(fetch, q, stop, DevicePrefetchIter._END)

    def _ensure_started(self):
        if self._thread is not None:
            return
        self._queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._ended = False
        self.wait_s = 0.0
        self._thread = threading.Thread(
            target=self._pump, args=(self.data_iter, self._queue,
                                     self._stop),
            daemon=True, name="device-prefetch")
        self._thread.start()

    def _shutdown(self, strict=True):
        if self._stop is None or self._thread is None:
            return
        stuck = _drain_and_join([self._queue], [self._thread], self._stop,
                                DevicePrefetchIter._END,
                                self._shutdown_timeout)
        self._thread = None
        if stuck:
            self._wedged = MXNetError(
                "DevicePrefetchIter: pump thread still running %gs after "
                "shutdown — the child iterator is blocked in user code; "
                "rebuild the data pipeline" % self._shutdown_timeout)
            if strict:
                raise self._wedged

    def __del__(self):
        try:
            self._shutdown(strict=False)
        except Exception:
            pass

    # ------------------------------------------------------------------ DataIter
    def reset(self):
        if self._wedged is not None:
            raise self._wedged
        self._shutdown()
        self.data_iter.reset()
        self._ended = False  # next consume lazily starts a fresh pump

    def iter_next(self):
        if self._wedged is not None:
            raise self._wedged
        if self._ended:
            return False
        self._ensure_started()
        import time as _time

        t0 = _time.perf_counter()
        if _tm.enabled():
            with _tm.span("io.prefetch_wait"):
                got = _get_bounded(self._queue, (self._thread,),
                                   "DevicePrefetchIter")
            _tm.timer("io.prefetch_wait").add(_time.perf_counter() - t0)
        else:
            got = _get_bounded(self._queue, (self._thread,),
                               "DevicePrefetchIter")
        self.wait_s += _time.perf_counter() - t0
        if isinstance(got, BaseException):
            self._ended = True
            raise got
        if got is DevicePrefetchIter._END:
            self._ended = True
            return False
        self.current_batch = self._consume(*got)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class CSVIter(NDArrayIter):
    """CSV-file-backed iterator (reference: src/io/iter_csv.cc:132). Parses on
    the host with numpy, then batches like NDArrayIter on its device."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,), batch_size=1, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        super().__init__(data, label, batch_size=batch_size, **kwargs)


def _read_idx_file(path):
    """Read an MNIST idx-format file (reference: iter_mnist.cc ReadInt/LoadImage)."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32, 0x0D: np.float32}[
            dtype_code
        ]
        # np.dtype(...): numpy 2 has no newbyteorder on the scalar type,
        # where the JAX package calls it (mxnet_tpu/io.py:727)
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims).astype(dtype)


class MNISTIter(NDArrayIter):
    """MNIST idx-format iterator (reference: src/io/iter_mnist.cc:241)."""

    def __init__(
        self,
        image,
        label,
        batch_size=128,
        shuffle=True,
        flat=False,
        silent=False,
        seed=0,
        input_shape=None,
        **kwargs,
    ):
        images = _read_idx_file(image).astype(np.float32) / 255.0
        labels = _read_idx_file(label).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        elif input_shape is not None:
            images = images.reshape((-1,) + tuple(input_shape))
        else:
            images = images.reshape(images.shape[0], 1, images.shape[1], images.shape[2])
        super().__init__(
            images, labels, batch_size=batch_size, shuffle=shuffle, last_batch_handle="discard"
        )
