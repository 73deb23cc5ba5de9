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
``num_dead_nodes`` counts stale files.

Elastic membership (``MXNET_ELASTIC=1``, JAX :132-170, :391-756): worker
death pauses and re-forms the job instead of ending it. The coordination
service is worker 0's ``TCPStore``, which outlives every process group as
the JAX package's coordination client outlives its backend. Each
generation's process group meets on a fresh key space of it
(``PrefixStore("gen-<g>")``) at the survivors' dense ranks. The pause
decision is first-write-wins (``compare_set``); ``reform`` destroys the old
group and joins the new one. The group's timeout is half of
``MXNET_ELASTIC_REFORM_TIMEOUT``, so a survivor blocked in a collective
with a dead peer errors out of it inside the re-form window.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import time

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
ENV_REFORM_TIMEOUT = "MXNET_ELASTIC_REFORM_TIMEOUT"
ENV_MIN_WORKERS = "MXNET_ELASTIC_MIN_WORKERS"
ENV_DEAD_TIMEOUT = "MXNET_ELASTIC_DEAD_TIMEOUT"
ENV_PAUSE_MARGIN = "MXNET_ELASTIC_PAUSE_MARGIN"

_initialized = False
_store = None
_heartbeat_thread = None
_heartbeat_stop = None  # threading.Event; set by stop_heartbeat()
_start_time = None  # job-start anchor for num_dead_nodes' startup grace
# ---- elastic state (meaningful only under MXNET_ELASTIC=1) ----
_elastic = False      # this job runs the survivable coordination layer
_generation = 0       # bumped by every successful reform()
_members = None       # ORIGINAL ranks of the current generation, sorted
_orig_rank = None     # this process's launcher rank (stable across reforms)
_orig_world = None    # the launch-time worker count


def _job_start_time():
    global _start_time
    if _start_time is None:
        import time

        _start_time = time.time()
    return _start_time


def is_initialized() -> bool:
    return _initialized


def elastic_enabled() -> bool:
    """MXNET_ELASTIC=1: run the survivable coordination layer — worker death
    pauses and re-forms the job instead of ending it. Failure detection is
    the heartbeat files'."""
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
    the module docstring). Under ``MXNET_ELASTIC=1`` the process group
    meets on generation 0's key space of the store, with a timeout inside
    the re-form window."""
    global _initialized, _store
    global _elastic, _members, _orig_rank, _orig_world, _generation
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if coordinator_address is None:
        return  # single-process
    world = int(num_processes if num_processes is not None
                else os.environ.get(ENV_NUM_WORKERS, "1"))
    rank_ = int(process_id if process_id is not None
                else os.environ.get(ENV_WORKER_ID, "0"))
    backend_ = _default_backend()
    host, port = coordinator_address.rsplit(":", 1)
    if backend_ == "gloo" and host in ("localhost", "127.0.0.1"):
        # a one-host job: gloo's pairs meet on the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    elastic = elastic_enabled()
    timeout = _group_timeout(elastic)
    import torch.distributed as tdist

    _store = tdist.TCPStore(host, int(port), world, is_master=(rank_ == 0), timeout=timeout)
    group_store = _store
    if elastic:
        group_store = tdist.PrefixStore("gen-0", _store)
        _elastic, _generation = True, 0
        _members = list(range(world))
        _orig_rank, _orig_world = rank_, world
    tdist.init_process_group(backend_, store=group_store, rank=rank_, world_size=world,
                             timeout=timeout)
    _initialized = True
    _job_start_time()
    _start_heartbeat(rank_)
    logging.info("mxnet_tpu_torch.dist: worker %d/%d joined %s over %s%s",
                 rank_, world, coordinator_address, backend_, " [elastic]" if elastic else "")


def _group_timeout(elastic):
    """300 s; half the re-form window under ``MXNET_ELASTIC=1``."""
    if elastic:
        return datetime.timedelta(seconds=_reform_timeout_s() / 2)
    return datetime.timedelta(seconds=300)


def backend():
    """The process group's backend (``"nccl"`` or ``"gloo"``), or None."""
    if not _initialized:
        return None
    import torch.distributed as tdist

    return tdist.get_backend()


def rank() -> int:
    """This process's rank in the CURRENT generation (dense 0..W-1)."""
    if _elastic and _members is not None:
        return _members.index(_orig_rank)
    if not _initialized:
        return 0
    import torch.distributed as tdist

    return tdist.get_rank()


def num_workers() -> int:
    if _elastic and _members is not None:
        return len(_members)
    if not _initialized:
        return 1
    import torch.distributed as tdist

    return tdist.get_world_size()


def shutdown():
    """Leave the job: stop the heartbeat and destroy the process group."""
    global _initialized, _store, _heartbeat_thread, _heartbeat_stop
    global _elastic, _members, _orig_rank, _orig_world, _generation
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
    _elastic = False
    _members = None
    _orig_rank = None
    _orig_world = None
    _generation = 0
    from . import kvstore

    kvstore._Collective._cache = None


# copied from mxnet_tpu/dist.py (_start_heartbeat, is_heartbeating,
# stop_heartbeat, num_dead_nodes, dead_timeout_seconds, dead_members,
# _scan_heartbeats, _note_liveness, members, generation, orig_rank,
# plan_reform, _pause_margin, plan_from_pause; backend-free)
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
        wid = _orig_rank if _orig_rank is not None else os.environ.get(ENV_WORKER_ID)
        if hb_dir and wid is not None:
            try:
                os.unlink(os.path.join(hb_dir, "worker-%s" % wid))
            except OSError:
                pass


def num_dead_nodes(timeout=60.0, startup_grace=None):
    """Workers whose heartbeat file is older than ``timeout`` seconds; 0
    when heartbeating is not configured. A missing file counts as alive
    until ``startup_grace`` (default ``timeout``) seconds after job start.
    In an elastic job the scan covers the CURRENT membership only."""
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
    """ORIGINAL ranks of current members whose heartbeat is stale — the
    input to ``plan_reform``. Default timeout: MXNET_ELASTIC_DEAD_TIMEOUT."""
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
    if _elastic and _members is not None:
        ranks = list(_members)
    else:
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
def members():
    """ORIGINAL launcher ranks of the current generation, sorted; None when
    not an elastic job. Heartbeat files keep the original ranks across
    re-forms while the dense rank (``rank()``) is re-assigned each
    generation."""
    return list(_members) if _members is not None else None


def generation() -> int:
    """0 at launch; +1 per successful ``reform()``."""
    return _generation


def orig_rank():
    """This process's launch-time rank (stable across re-forms); None when
    not elastic."""
    return _orig_rank


def coordination_client():
    """The job's coordination store (elastic jobs only): worker 0's
    ``TCPStore``, the barrier/KV substrate the re-form protocol runs on. It
    outlives every process group."""
    if not _elastic:
        raise MXNetError(
            "coordination_client() needs an elastic job (MXNET_ELASTIC=1 "
            "before dist.init())")
    return _store


def _reform_timeout_s() -> float:
    try:
        return float(os.environ.get(ENV_REFORM_TIMEOUT, "120"))
    except ValueError:
        return 120.0


def plan_reform(timeout=None, dead=None):
    """Decide the next generation's membership from the heartbeat files.

    Returns ``{"generation", "members", "dead", "rank", "world"}`` — the
    survivor set and this process's dense rank in it. Raises a structured
    ``MXNetError`` for the unrecoverable cases: the coordinator (original
    rank 0, whose process hosts the store) among the dead; fewer than
    ``MXNET_ELASTIC_MIN_WORKERS`` (default 1) survivors; this process
    itself classed dead."""
    if not _elastic or _members is None:
        raise MXNetError("plan_reform() needs an elastic job (MXNET_ELASTIC=1 before dist.init())")
    if dead is None:
        dead = dead_members(timeout=timeout)
    dead = sorted(set(dead) & set(_members))
    if not dead:
        raise MXNetError("plan_reform(): no dead members — nothing to "
                         "re-form (membership: %s)" % (_members,))
    survivors = [m for m in _members if m not in dead]
    if 0 in dead:
        raise MXNetError(
            "elastic re-form impossible: the coordinator (original rank 0) "
            "is dead — its process hosts the coordination store every "
            "barrier and KV exchange rides. Unrecoverable; restart the job "
            "from the last checkpoint (dead: %s)" % dead)
    try:
        min_workers = int(os.environ.get(ENV_MIN_WORKERS, "1"))
    except ValueError:
        min_workers = 1
    if len(survivors) < max(1, min_workers):
        raise MXNetError(
            "elastic re-form impossible: %d survivor(s) %s is below "
            "MXNET_ELASTIC_MIN_WORKERS=%d (dead: %s). Unrecoverable; "
            "restart the job from the last checkpoint"
            % (len(survivors), survivors, min_workers, dead))
    if _orig_rank in dead:
        raise MXNetError(
            "elastic re-form: THIS worker (original rank %d) is classed "
            "dead by its own heartbeat scan — clock skew or a stalled "
            "host. The survivors are re-forming without us; exiting is the "
            "only safe move" % _orig_rank)
    return {"generation": _generation + 1, "members": survivors,
            "dead": dead, "rank": survivors.index(_orig_rank),
            "world": len(survivors)}


def _pause_key(gen):
    return "mxtpu-elastic/gen-%d/pause" % gen


def _pause_margin() -> int:
    try:
        return max(1, int(os.environ.get(ENV_PAUSE_MARGIN, "3")))
    except ValueError:
        return 3


def propose_pause(dead, round_no, margin=None):
    """Publish the pause decision for the NEXT generation in the store,
    first write wins (``compare_set`` against an absent key): a second
    proposal changes nothing and gets the FIRST payload back, so every
    worker acts on one decision even when two detect trouble in the same
    window. Proposers: the coordinator's per-round heartbeat scan, and a
    SIGTERM'd worker draining itself (``dead=[orig_rank()]``).

    ``pause_at = round_no + margin`` (MXNET_ELASTIC_PAUSE_MARGIN, default
    3): every worker keeps training through round ``pause_at``, so the
    collective count stays the same across workers. Returns the payload in
    force."""
    store = coordination_client()
    gen = _generation + 1
    payload = {"generation": gen, "dead": sorted(set(int(d) for d in dead)),
               "pause_at": int(round_no) + (_pause_margin() if margin is None
                                            else max(1, int(margin))),
               "proposer": _orig_rank}
    try:
        got = store.compare_set(_pause_key(gen), "", json.dumps(payload))
    except RuntimeError as e:
        raise MXNetError(
            "elastic pause: could not publish OR read the gen-%d pause "
            "payload (%s) — coordination store unreachable; the "
            "coordinator likely died. Unrecoverable; restart from the "
            "last checkpoint" % (gen, e)) from e
    in_force = json.loads(got)
    if in_force == payload:
        from . import telemetry as _tm

        if _tm.enabled():
            _tm.event("dist.pause_proposed", generation=gen, pause_at=payload["pause_at"],
                      dead=",".join(map(str, payload["dead"])))
    return in_force


def poll_pause():
    """Non-blocking check for a published pause decision for the NEXT
    generation: the payload dict, or None. ``check`` comes first, since a
    ``get`` of an absent key waits for it."""
    store = coordination_client()
    key = _pause_key(_generation + 1)
    try:
        if not store.check([key]):
            return None
        return json.loads(store.get(key))
    except (RuntimeError, ValueError):
        return None


def plan_from_pause(payload):
    """Membership plan from an AGREED pause payload — every worker re-forms
    from the same dead set even when local heartbeat scans disagree at the
    staleness boundary. Raises ``EvictedError`` when the payload names THIS
    worker dead (a drain after SIGTERM: expected, exit clean), and the
    structured ``MXNetError``s of ``plan_reform``."""
    from .base import EvictedError

    if not _elastic or _members is None:
        raise MXNetError("plan_from_pause() needs an elastic job "
                         "(MXNET_ELASTIC=1 before dist.init())")
    gen = int(payload.get("generation", -1))
    if gen != _generation + 1:
        raise MXNetError(
            "elastic pause payload is for generation %d but this worker is "
            "at generation %d — membership drifted (a re-form happened "
            "without us?); unrecoverable" % (gen, _generation))
    dead = sorted(set(payload["dead"]) & set(_members))
    if _orig_rank in dead:
        raise EvictedError(
            "this worker (original rank %d) is in generation %d's dead set "
            "%s — draining (expected after SIGTERM) or written off by the "
            "survivors; stopping training" % (_orig_rank, gen, dead))
    return plan_reform(dead=dead)


def _barrier(store, key, members_, timeout_s):
    """A counted barrier on the store: every member adds one, the last one
    to arrive marks it done, everyone waits for the mark."""
    if store.add(key + "/arrived", 1) == len(members_):
        store.set(key + "/done", "1")
    store.wait([key + "/done"], datetime.timedelta(seconds=timeout_s))


def reform(plan=None):
    """Re-form the job over the survivor set, keeping the store:

    1. the coordinator PUBLISHES the membership plan in the store (every
       worker scans heartbeats on its own; borderline staleness must not
       let two workers re-form different worlds);
    2. survivors meet at a generation-named barrier — a survivor wedged in
       a dead collective has ``MXNET_ELASTIC_REFORM_TIMEOUT`` to error out
       of it and arrive;
    3. every survivor destroys its process group and joins the new one on
       the generation's key space, at its new dense rank.

    Callers re-create what lived on the old group afterwards
    (``KVStore.reform``, then a reseed). Raises ``MXNetError`` when the plan
    cannot be agreed or the barrier times out."""
    global _members, _generation
    from . import telemetry as _tm

    if plan is None:
        plan = plan_reform()
    store = coordination_client()
    gen = plan["generation"]
    timeout_s = _reform_timeout_s()
    t0 = time.time()
    with _tm.span("dist.reform", generation=gen, world=plan["world"]):
        key = "mxtpu-elastic/gen-%d/members" % gen
        if _orig_rank == 0:
            store.set(key, json.dumps(plan["members"]))
            agreed = plan["members"]
        else:
            try:
                store.wait([key], datetime.timedelta(seconds=timeout_s))
                agreed = json.loads(store.get(key))
            except RuntimeError as e:
                raise MXNetError(
                    "elastic re-form gen %d: coordinator never published "
                    "the membership plan within %.0fs — it likely died "
                    "mid-re-form. Unrecoverable; restart from the last "
                    "checkpoint (%s)" % (gen, timeout_s, e)) from e
        if _orig_rank not in agreed:
            raise MXNetError(
                "elastic re-form gen %d: the coordinator's membership %s "
                "excludes this worker (original rank %d) — our heartbeat "
                "went stale from its point of view. Exiting is the only "
                "safe move" % (gen, agreed, _orig_rank))
        try:
            _barrier(store, "mxtpu-elastic/gen-%d/reform" % gen, agreed, timeout_s)
        except RuntimeError as e:
            raise MXNetError(
                "elastic re-form gen %d: survivor barrier over %s did not "
                "complete within %.0fs — a survivor is wedged or died "
                "during the re-form. Unrecoverable; restart from the last "
                "checkpoint (%s)" % (gen, agreed, timeout_s, e)) from e
        _teardown_backend(agreed, gen, store)
        _members = list(agreed)
        _generation = gen
        import torch.distributed as tdist

        if tdist.get_world_size() != len(agreed):
            raise MXNetError(
                "elastic re-form gen %d: the re-formed process group spans %d "
                "process(es), expected %d" % (gen, tdist.get_world_size(), len(agreed)))
    dead = sorted(set(plan["dead"]) | (set(plan["members"]) - set(agreed)))
    dead = [d for d in dead if d not in agreed]
    if _tm.enabled():
        _tm.counter("dist.reforms").inc()
        _tm.gauge("dist.generation").set(gen)
        _tm.gauge("dist.world").set(len(agreed))
        _tm.event("dist.reform", generation=gen, world=len(agreed),
                  dead=",".join(map(str, dead)), seconds=round(time.time() - t0, 3))
    logging.info(
        "mxnet_tpu_torch.dist: re-formed generation %d over %d worker(s) "
        "(original ranks %s, dead %s) in %.2fs", gen, len(agreed), agreed, dead,
        time.time() - t0)
    return {"generation": gen, "members": list(agreed),
            "rank": agreed.index(_orig_rank), "world": len(agreed), "dead": dead}


def _teardown_backend(agreed, gen, store):
    """Destroy the old process group and join the new one: the survivors at
    their dense ranks, on generation ``gen``'s key space of the store. The
    KVStore's cached collective belongs to the old group and goes with it;
    the device generators are checked (``random.refresh_backend``)."""
    import torch.distributed as tdist

    from . import kvstore, random as _random

    backend_ = tdist.get_backend()
    tdist.destroy_process_group()
    kvstore._Collective._cache = None
    tdist.init_process_group(backend_, store=tdist.PrefixStore("gen-%d" % gen, store),
                             rank=list(agreed).index(_orig_rank), world_size=len(agreed),
                             timeout=_group_timeout(True))
    _random.refresh_backend()
