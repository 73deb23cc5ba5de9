"""Multi-process bootstrap and heartbeat.

Counterpart of the bootstrap and heartbeat half of ``mxnet_tpu/dist.py``
(:56-390). ``tools/launch.py`` starts N copies of a command with
``MXNET_TPU_COORDINATOR`` (host:port of worker 0), ``MXNET_TPU_NUM_WORKERS``
and ``MXNET_TPU_WORKER_ID``; ``init()`` reads them and joins the job with
``torch.distributed.init_process_group`` over a ``TCPStore`` that worker 0
hosts at the coordinator address: the backend follows the default
context's device type alone (``context.current_context()``): gloo for
``cpu`` (``MXNET_DEFAULT_CONTEXT=cpu``, as ``tools/launch.py
--cpu-devices`` sets), NCCL for ``gpu``, which raises on a host without
CUDA. ``rank``/``num_workers`` then back the dist KVStore's.

The file heartbeat is the JAX package's: each worker touches
``$MXNET_TPU_HEARTBEAT_DIR/worker-<rank>`` on a timer, and
``num_dead_nodes`` counts stale files. Elastic membership (``members``,
``generation``, ``reform``, the pause protocol, ``coordination_client``)
comes with ``module/elastic.py`` (``ROADMAP.md`` section 1.4b) and raises
until then.
"""
from __future__ import annotations

import datetime
import logging
import os

from .base import MXNetError

__all__ = ["init", "is_initialized", "rank", "num_workers", "shutdown", "backend",
           "num_dead_nodes", "elastic_enabled", "members", "generation", "orig_rank",
           "dead_members", "dead_timeout_seconds", "plan_reform", "plan_from_pause",
           "reform", "coordination_client", "propose_pause", "poll_pause",
           "stop_heartbeat", "is_heartbeating"]

# env contract with tools/launch.py
ENV_COORDINATOR = "MXNET_TPU_COORDINATOR"  # host:port of process 0
ENV_NUM_WORKERS = "MXNET_TPU_NUM_WORKERS"
ENV_WORKER_ID = "MXNET_TPU_WORKER_ID"
ENV_HEARTBEAT_DIR = "MXNET_TPU_HEARTBEAT_DIR"
ENV_HEARTBEAT_INTERVAL = "MXNET_TPU_HEARTBEAT_INTERVAL"
ENV_ELASTIC = "MXNET_ELASTIC"
ENV_DEAD_TIMEOUT = "MXNET_ELASTIC_DEAD_TIMEOUT"

_ELASTIC = ("elastic membership comes with module/elastic.py, which the port has not "
            "yet (ROADMAP.md section 1.4b)")

_initialized = False
_store = None
_heartbeat_thread = None
_heartbeat_stop = None  # threading.Event; set by stop_heartbeat()
_start_time = None  # job-start anchor for num_dead_nodes' startup grace


def _job_start_time():
    global _start_time
    if _start_time is None:
        import time

        _start_time = time.time()
    return _start_time


def is_initialized() -> bool:
    return _initialized


def elastic_enabled() -> bool:
    """MXNET_ELASTIC=1 asks for the survivable coordination layer, which
    the port has not yet: ``init`` raises under it."""
    return os.environ.get(ENV_ELASTIC, "").lower() in ("1", "on", "true", "yes")


def _default_backend() -> str:
    """gloo for a ``cpu`` default context, NCCL for a ``gpu`` one; a ``gpu``
    default on a host without CUDA raises (no CPU fallback)."""
    from .context import current_context

    ctx = current_context()
    if ctx.device_type == "cpu":
        return "gloo"
    ctx.torch_device  # raises without CUDA
    return "nccl"


def init(coordinator_address=None, num_processes=None, process_id=None):
    """Join the job. Arguments default to the ``MXNET_TPU_*`` variables;
    without a coordinator (a single-process job) or when already joined,
    nothing happens. The backend is NCCL on a card and gloo on the CPU (see
    the module docstring)."""
    global _initialized, _store
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if coordinator_address is None:
        return  # single-process
    if elastic_enabled():
        raise MXNetError("MXNET_ELASTIC=1: " + _ELASTIC)
    world = int(num_processes if num_processes is not None
                else os.environ.get(ENV_NUM_WORKERS, "1"))
    rank_ = int(process_id if process_id is not None
                else os.environ.get(ENV_WORKER_ID, "0"))
    backend_ = _default_backend()
    host, port = coordinator_address.rsplit(":", 1)
    if backend_ == "gloo" and host in ("localhost", "127.0.0.1"):
        # a one-host job: gloo's pairs meet on the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=300)
    import torch.distributed as tdist

    _store = tdist.TCPStore(host, int(port), world, is_master=(rank_ == 0), timeout=timeout)
    tdist.init_process_group(backend_, store=_store, rank=rank_, world_size=world,
                             timeout=timeout)
    _initialized = True
    _job_start_time()
    _start_heartbeat(rank_)
    logging.info("mxnet_tpu_torch.dist: worker %d/%d joined %s over %s",
                 rank_, world, coordinator_address, backend_)


def backend():
    """The process group's backend (``"nccl"`` or ``"gloo"``), or None."""
    if not _initialized:
        return None
    import torch.distributed as tdist

    return tdist.get_backend()


def rank() -> int:
    if not _initialized:
        return 0
    import torch.distributed as tdist

    return tdist.get_rank()


def num_workers() -> int:
    if not _initialized:
        return 1
    import torch.distributed as tdist

    return tdist.get_world_size()


def shutdown():
    """Leave the job: stop the heartbeat and destroy the process group."""
    global _initialized, _store, _heartbeat_thread, _heartbeat_stop
    if not _initialized:
        return
    import torch.distributed as tdist

    if _heartbeat_stop is not None:
        _heartbeat_stop.set()
    _heartbeat_thread = None  # a later init() must restart the beat
    _heartbeat_stop = None
    tdist.destroy_process_group()
    _store = None
    _initialized = False
    from . import kvstore

    kvstore._Collective._cache = None


# copied from mxnet_tpu/dist.py (_start_heartbeat, is_heartbeating,
# stop_heartbeat, num_dead_nodes, dead_timeout_seconds, dead_members,
# _scan_heartbeats, _note_liveness; backend-free, the elastic branches
# dropped)
def _start_heartbeat(process_id):
    """Touch the per-worker heartbeat file on a timer (daemon thread)."""
    global _heartbeat_thread, _heartbeat_stop
    hb_dir = os.environ.get(ENV_HEARTBEAT_DIR)
    if not hb_dir or _heartbeat_thread is not None:
        return
    import threading

    interval = float(os.environ.get(ENV_HEARTBEAT_INTERVAL, "5"))
    path = os.path.join(hb_dir, "worker-%d" % process_id)
    stop = threading.Event()

    def beat():
        from . import faultinject as _fi

        while _initialized and not stop.is_set():
            try:
                _fi.fire("dist.heartbeat")
                os.makedirs(hb_dir, exist_ok=True)
                with open(path, "a"):
                    os.utime(path, None)
            except (OSError, _fi.FaultInjected):
                pass
            stop.wait(interval)

    _heartbeat_stop = stop
    _heartbeat_thread = threading.Thread(target=beat, daemon=True, name="mxtpu-heartbeat")
    _heartbeat_thread.start()


def is_heartbeating() -> bool:
    return _heartbeat_thread is not None and _heartbeat_thread.is_alive()


def stop_heartbeat(remove=False):
    """Stop this worker's heartbeat; ``remove=True`` deletes its file, so
    the others' next scan classes it dead at once."""
    global _heartbeat_thread, _heartbeat_stop
    if _heartbeat_stop is not None:
        _heartbeat_stop.set()
    if _heartbeat_thread is not None:
        _heartbeat_thread.join(timeout=2.0)
        _heartbeat_thread = None
        _heartbeat_stop = None
    if remove:
        hb_dir = os.environ.get(ENV_HEARTBEAT_DIR)
        wid = os.environ.get(ENV_WORKER_ID)
        if hb_dir and wid is not None:
            try:
                os.unlink(os.path.join(hb_dir, "worker-%s" % wid))
            except OSError:
                pass


def num_dead_nodes(timeout=60.0, startup_grace=None):
    """Workers whose heartbeat file is older than ``timeout`` seconds; 0
    when heartbeating is not configured. A missing file counts as alive
    until ``startup_grace`` (default ``timeout``) seconds after job start."""
    dead, max_age = _scan_heartbeats(timeout, startup_grace)
    _note_liveness(len(dead), max_age)
    return len(dead)


def dead_timeout_seconds() -> float:
    """MXNET_ELASTIC_DEAD_TIMEOUT (default 60 s)."""
    try:
        return float(os.environ.get(ENV_DEAD_TIMEOUT, "60"))
    except ValueError:
        return 60.0


def dead_members(timeout=None, startup_grace=None):
    """Ranks whose heartbeat is stale."""
    if timeout is None:
        timeout = dead_timeout_seconds()
    dead, _ = _scan_heartbeats(timeout, startup_grace)
    return dead


def _scan_heartbeats(timeout, startup_grace):
    import time

    hb_dir = os.environ.get(ENV_HEARTBEAT_DIR)
    if not hb_dir or not os.path.isdir(hb_dir):
        return [], 0.0
    if startup_grace is None:
        startup_grace = timeout
    ranks = list(range(int(os.environ.get(ENV_NUM_WORKERS, "1"))))
    now = time.time()
    start = _job_start_time()
    try:
        start = min(start, os.path.getmtime(hb_dir))
    except OSError:
        pass
    in_grace = now - start <= startup_grace
    dead = []
    max_age = 0.0
    for r in ranks:
        path = os.path.join(hb_dir, "worker-%d" % r)
        try:
            age = now - os.path.getmtime(path)
            max_age = max(max_age, age)
            if age > timeout:
                dead.append(r)
        except OSError:
            if not in_grace:
                dead.append(r)  # never heartbeated, grace period over
                max_age = max(max_age, now - start)
    return dead, max_age


_last_dead = 0  # previous num_dead_nodes result, for transition counting


def _note_liveness(dead, max_age):
    global _last_dead
    from . import telemetry as _tm

    if not _tm.enabled():
        _last_dead = dead
        return
    _tm.gauge("dist.dead_nodes").set(dead)
    _tm.gauge("dist.heartbeat_age_s").set(round(max_age, 3))
    if dead != _last_dead:
        _tm.counter("dist.dead_node_transitions").inc()
        _tm.event("dist.dead_node_transition", dead=dead, previous=_last_dead)
        _last_dead = dead


# ----------------------------------------------------------------- elastic
def _elastic(name):
    return MXNetError("dist.%s: %s" % (name, _ELASTIC))


def members():
    """Elastic membership: raises until module/elastic.py is ported."""
    raise _elastic("members")


def generation() -> int:
    raise _elastic("generation")


def orig_rank():
    raise _elastic("orig_rank")


def coordination_client():
    raise _elastic("coordination_client")


def plan_reform(timeout=None, dead=None):
    raise _elastic("plan_reform")


def propose_pause(dead, round_no, margin=None):
    raise _elastic("propose_pause")


def poll_pause():
    raise _elastic("poll_pause")


def plan_from_pause(payload):
    raise _elastic("plan_from_pause")


def reform(plan=None):
    raise _elastic("reform")
