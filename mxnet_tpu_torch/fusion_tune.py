"""Persistent measure-and-cache autotuning for the fusion gates.

Counterpart of ``mxnet_tpu/fusion_tune.py``, all of its ``__all__``. Every
(pattern, shape, dtype) site is MEASURED against its unfused baseline on
first encounter — fused and baseline on synthetic inputs, forward and
backward — and the verdict (engage or not, winning lowering, measured µs)
is persisted to a per-device-kind JSON cache, so every later bind, in this
process or another, reuses it with zero re-tunes.

Cache layout, as the JAX package writes it:
``$MXNET_FUSION_TUNE_DIR/<device_kind>.json`` holding

    {"version": 2, "device_kind": ..., "digest": sha256(entries-json),
     "entries": {"<pattern>|<variant>|<sig>": {record}, ...}}

Version-1 files load (their records are default-schedule verdicts); a file
of an unknown version is invalidated with one warning, never a crash.
Writes are atomic (temp + ``os.replace``) and merge-on-write under an
advisory ``flock``, so processes tuning disjoint sites compose. A corrupt
or digest-mismatched file is ignored with a one-time warning.

``device_kind()`` is ``torch.cuda.get_device_name()`` of the current
context's card, and ``"cpu"`` on the CPU: a cache tuned on one card never
gates another. The port's gates resolve once at bind (``fusion.py``), so a
lookup never runs per forward and a measurement never runs inside a
CUDA-graph capture.

Measurement (``measure_candidates``): each contestant's forward and its
forward + backward are timed, after a warm-up, as the median of
``_ROUNDS`` interleaved rounds of ``iters`` runs — on the card by CUDA
events around runs queued behind a sleep of the card (the card's time, as
a CUDA-graph step sees it, not the host's), on the CPU by
``perf_counter``. On the CPU a candidate whose outputs or gradients leave
``rel_tol`` of the baseline is rejected for parity (at bfloat16, of the
baseline and of its float32 evaluation on the same inputs: a departure,
JAX's tuner holds a bf16 candidate to its bf16 baseline alone), and a
candidate that raises is recorded, each verdict cached as the JAX package
caches it. One departure: on a CUDA tensor either is a fault and raises (``verdict``
re-raises it as ``MXNetError`` naming the site and caches nothing),
because a kernel that fails or returns wrong numbers must never be
declined quietly.

Gating env: ``MXNET_FUSION_TUNE_DIR`` (setting it enables tuning),
``MXNET_FUSION_TUNE=0`` (never measure), ``MXNET_FUSION_TUNE_ITERS``
(default 10), ``MXNET_FUSION_TUNE_SCHEDULES`` (default 4: the schedule
variants a candidate family may add), ``MXNET_FUSION_TUNE_MIN_SPEEDUP``
(default 1.05). Telemetry: ``fusion.tune`` counts measurements,
``fusion.tune_cache_hit`` verdicts served from the cache.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time

import numpy as np
import torch

from . import telemetry as _tm
from .base import MXNetError

__all__ = ["enabled", "cache_dir", "device_kind", "lookup", "peek",
           "verdict", "measure_candidates", "synth_like", "reset",
           "cache_path", "entries_digest", "schedule_budget",
           "parse_schedule", "sched_name"]

log = logging.getLogger("mxnet_tpu")

_VERSION = 2
#: prior schema whose entries remain readable (default-schedule verdicts)
_COMPAT_VERSIONS = (1,)

_lock = threading.Lock()
# device_kind -> {key: record}; absent means "not loaded yet"
_mem = {}
_warned_paths = set()


# ------------------------------------------------------------------- gating
def cache_dir():
    """The configured cache directory (``MXNET_FUSION_TUNE_DIR``), or None
    when persistence/tuning is off (the default)."""
    d = os.environ.get("MXNET_FUSION_TUNE_DIR", "").strip()
    return d or None


def enabled():
    """Whether the autotuner may MEASURE: a cache dir is configured and the
    kill-switch (``MXNET_FUSION_TUNE=0``) is not set."""
    if os.environ.get("MXNET_FUSION_TUNE", "auto").strip() == "0":
        return False
    return cache_dir() is not None


def tune_iters():
    try:
        return max(1, int(os.environ.get("MXNET_FUSION_TUNE_ITERS", "10")))
    except ValueError:
        return 10


# copied from mxnet_tpu/fusion_tune.py (schedule_budget; backend-free)
def schedule_budget():
    """How many schedule variants each pattern may enumerate per candidate
    family beyond the default candidate (``MXNET_FUSION_TUNE_SCHEDULES``,
    default 4). ``0`` = binary-verdict mode: only the default schedule is
    measured."""
    try:
        return max(0, int(os.environ.get("MXNET_FUSION_TUNE_SCHEDULES",
                                         "4")))
    except ValueError:
        return 4


# copied from mxnet_tpu/fusion_tune.py (sched_name; backend-free)
def sched_name(base, **kv):
    """The canonical schedule-variant candidate name: ``base@k=v,...``
    (sorted keys, so the name is deterministic and round-trips through
    ``parse_schedule``)."""
    return "%s@%s" % (base, ",".join(
        "%s=%d" % (k, v) for k, v in sorted(kv.items())))


# copied from mxnet_tpu/fusion_tune.py (parse_schedule; backend-free)
def parse_schedule(name):
    """The schedule dict a candidate name encodes (``base@k=v,...``), or
    ``"default"`` for a bare candidate name, or None for no lowering."""
    if not name:
        return None
    _, sep, tail = str(name).partition("@")
    if not sep:
        return "default"
    out = {}
    for item in tail.split(","):
        k, _, v = item.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            out[k] = v
    return out


def device_kind():
    """The cache scope: the current context's card name
    (``torch.cuda.get_device_name``), or ``"cpu"``."""
    from .context import current_context

    ctx = current_context()
    if ctx.device_type == "cpu":
        return "cpu"
    try:
        return torch.cuda.get_device_name(ctx.torch_device)
    except Exception:
        return "unknown"


def cache_path(kind=None):
    d = cache_dir()
    if d is None:
        return None
    kind = kind if kind is not None else device_kind()
    safe = re.sub(r"[^A-Za-z0-9._-]+", "_", str(kind)) or "unknown"
    return os.path.join(d, safe + ".json")


# copied from mxnet_tpu/fusion_tune.py (entries_digest; backend-free)
def entries_digest(entries):
    """The integrity digest over the canonical entries JSON. A hand-edited
    (or torn) cache file fails this check and is ignored."""
    blob = json.dumps(entries, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def reset():
    """Drop the in-process memo. The on-disk cache is untouched."""
    with _lock:
        _mem.clear()
        _warned_paths.clear()


# ------------------------------------------------------------------ storage
def _warn_once(path, msg):
    if path not in _warned_paths:
        _warned_paths.add(path)
        log.warning("fusion_tune: ignoring cache file %s: %s", path, msg)


# copied from mxnet_tpu/fusion_tune.py (_load_file; backend-free)
def _load_file(path, kind):
    """Entries from one cache file, or {} when absent/corrupt/mismatched."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as exc:
        _warn_once(path, "unreadable or not JSON (%s)" % exc)
        return {}
    version = payload.get("version") if isinstance(payload, dict) else None
    if version != _VERSION and version not in _COMPAT_VERSIONS:
        _warn_once(path, "unknown schema version %r (this build reads "
                   "v%d and the compatible v%s)"
                   % (version if isinstance(payload, dict)
                      else type(payload).__name__, _VERSION,
                      "/v".join(str(v) for v in _COMPAT_VERSIONS)))
        return {}
    if payload.get("device_kind") != kind:
        _warn_once(path, "stamped for device_kind %r, this process runs %r"
                   % (payload.get("device_kind"), kind))
        return {}
    entries = payload.get("entries")
    if not isinstance(entries, dict):
        _warn_once(path, "entries missing or not a dict")
        return {}
    if payload.get("digest") != entries_digest(entries):
        _warn_once(path, "digest mismatch (torn write or hand edit)")
        return {}
    if version in _COMPAT_VERSIONS:
        log.info("fusion_tune: cache file %s is schema v%s (binary "
                 "verdicts); records load as default-schedule entries",
                 path, version)
    return entries


def _entries(kind):
    """The in-memory entry map for this device kind, loading the file once
    per process."""
    ent = _mem.get(kind)
    if ent is None:
        path = cache_path(kind)
        ent = _load_file(path, kind) if path is not None else {}
        _mem[kind] = ent
    return ent


def _persist(kind, new_entries):
    """Merge ``new_entries`` into the on-disk file atomically, under an
    advisory flock on a sidecar lock file so concurrent processes tuning
    disjoint sites compose; our fresh measurements win ties."""
    path = cache_path(kind)
    if path is None:
        return
    from .checkpoint import atomic_write_bytes

    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        lock_fd = None
        try:
            import fcntl

            lock_fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # best effort: no flock on this platform/filesystem
        try:
            merged = _load_file(path, kind)
            merged.update(new_entries)
            payload = {"version": _VERSION, "device_kind": kind,
                       "digest": entries_digest(merged), "entries": merged}
            atomic_write_bytes(path, json.dumps(
                payload, sort_keys=True, indent=1).encode())
            _mem[kind] = merged
        finally:
            if lock_fd is not None:
                os.close(lock_fd)  # closing releases the flock
    except OSError as exc:  # a read-only dir must not sink the bind
        log.warning("fusion_tune: could not persist cache %s: %s", path, exc)


# ------------------------------------------------------------------ lookups
def peek(key):
    """The cached record for ``key`` (no telemetry, no measurement)."""
    if cache_dir() is None:
        return None
    kind = device_kind()
    with _lock:
        return _entries(kind).get(key)


def lookup(key):
    """The cached record for ``key``, counting ``fusion.tune_cache_hit``."""
    rec = peek(key)
    if rec is not None and _tm.enabled():
        _tm.counter("fusion.tune_cache_hit").inc()
    return rec


def verdict(key, measure):
    """The record for ``key``: cache hit, else (when tuning is enabled)
    measure NOW via ``measure()`` → record, persist, return. Returns None
    when no verdict exists and tuning is disabled.

    On the CPU a measurement that raises is itself cached (``engage:
    False`` with the error), as the JAX package does. On a card it raises
    ``MXNetError`` naming ``key`` and caches nothing: a failing kernel is a
    fault, never a decline."""
    rec = lookup(key)
    if rec is not None:
        return rec
    if not enabled():
        return None
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError("fusion_tune: %r has no verdict inside a CUDA-graph capture; "
                         "verdicts are resolved at bind" % key)
    kind = device_kind()
    if _tm.enabled():
        _tm.counter("fusion.tune").inc()
    t0 = time.perf_counter()
    try:
        rec = measure()
    except Exception as exc:  # noqa: BLE001
        if kind != "cpu":
            raise MXNetError("fusion_tune: measuring %r on %s failed: %s: %s"
                             % (key, kind, type(exc).__name__, exc)) from exc
        rec = {"engage": False, "lowering": None,
               "error": "%s: %s" % (type(exc).__name__, exc)}
    rec.setdefault("engage", False)
    rec["tune_s"] = round(time.perf_counter() - t0, 4)
    sched = parse_schedule(rec.get("lowering"))
    if sched is not None:
        rec["schedule"] = sched
    rec["schedules_searched"] = sum(
        1 for n in (rec.get("measured") or {}) if "@" in n)
    with _lock:
        _entries(kind)[key] = rec
        _persist(kind, {key: rec})
    return rec


# -------------------------------------------------------------- measurement
_ROUNDS = 3


def synth_like(args, seed=0):
    """Concrete standard-normal arrays (numpy) matching ``args``'
    shapes/dtypes: the measurement runs on synthetic data of the site's
    contract, never on a bind's live arrays. A bfloat16 arg gets float32
    values (numpy has no bfloat16 without ``ml_dtypes``, and torch reads no
    numpy bfloat16): the caller casts them to the arg's dtype."""
    from .base import np_dtype, torch_dtype

    rs = np.random.RandomState(seed)
    return tuple(rs.randn(*[int(d) for d in a.shape]).astype(
        np.float32 if torch_dtype(a.dtype) == torch.bfloat16 else np_dtype(a.dtype))
        for a in args)


def _flat(out):
    """The tensors of an output (a tensor or a tuple of them)."""
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(t, torch.Tensor)]


def _rel_err(a, b):
    """Max relative error over corresponding tensors."""
    worst = 0.0
    for la, lb in zip(a, b):
        if la is None or lb is None:
            continue
        a32, b32 = la.detach().double(), lb.detach().double()
        denom = float(b32.abs().max()) + 1e-9 if b32.numel() else 1.0
        diff = float((a32 - b32).abs().max()) if a32.numel() else 0.0
        worst = max(worst, diff / denom)
    return worst


def min_speedup():
    """The fused-vs-baseline margin a candidate must clear to engage
    (``MXNET_FUSION_TUNE_MIN_SPEEDUP``, default 1.05)."""
    try:
        return float(os.environ.get("MXNET_FUSION_TUNE_MIN_SPEEDUP", "1.05"))
    except ValueError:
        return 1.05


def _to_device(args):
    from .context import current_context

    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        else:
            out.append(torch.as_tensor(np.asarray(a)).to(current_context().torch_device))
    return tuple(out)


def _grads(fn, args):
    """(outputs, gradients of every floating input) of ``fn`` under a
    ones cotangent."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
        outs = _flat(fn(*leaves))
        heads = [(o, torch.ones_like(o)) for o in outs if o.requires_grad]
        wrt = [t for t in leaves if t.requires_grad]
        got = torch.autograd.grad([o for o, _ in heads], wrt,
                                  [g for _, g in heads], allow_unused=True) if heads else []
    return [o.detach() for o in outs], list(got)


def _runner(fn, args, train, iters):
    """A timed runner for ``iters`` executions of ``fn(*args)`` (its forward,
    or its forward + backward): warms up now; each call returns seconds a
    run. CUDA events on a card, ``perf_counter`` on the CPU."""
    cuda = args[0].is_cuda

    if train:
        leaves = [a.detach().requires_grad_(a.is_floating_point()) for a in args]

        def once():
            with torch.enable_grad():
                outs = [o for o in _flat(fn(*leaves)) if o.requires_grad]
                if outs:
                    torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
                for t in leaves:
                    t.grad = None
    else:
        def once():
            with torch.no_grad():
                fn(*args)

    once()  # warm-up (and the first launch's build)
    if cuda:
        torch.cuda.synchronize(args[0].device)

    def run():
        if cuda:
            # the runs are queued behind a sleep on the card that outlasts
            # their queueing (made longer until it does), so the events
            # hold the card's time and none of the host's: a fused step
            # replays as a CUDA graph, with no host between its kernels
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            cycles = 1 << 22
            for _ in range(6):
                torch.cuda._sleep(cycles)
                start.record()
                for _ in range(iters):
                    once()
                end.record()
                queued_first = not start.query()
                end.synchronize()
                if queued_first:
                    break
                cycles *= 4
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            once()
        return (time.perf_counter() - t0) / iters

    return run


def measure_candidates(baseline, candidates, args, train=True, iters=None,
                       rel_tol=2e-2, margin=None):
    """Measure ``candidates`` ([(name, fn)]) against ``baseline`` on the
    concrete ``args`` (tensors, or numpy arrays put on the current
    context), forward and (``train``) backward, and return the verdict
    record.

    Every timer runs in INTERLEAVED rounds (baseline, cand1, cand2,
    baseline, ...), each contestant's time the median of its ``_ROUNDS``
    rounds, so clock drift hits every contestant alike. A candidate is
    eligible when its outputs AND gradients stay within ``rel_tol`` of the
    baseline's; it wins when its fwd+bwd time beats the baseline's by the
    ``margin`` (default ``min_speedup()``). Record fields as the JAX
    package writes them: ``engage``, ``lowering``, ``base_fwd_us``/
    ``fused_fwd_us``, ``base_bwd_us``/``fused_bwd_us``, ``engage_fwd`` and
    ``lowering_fwd`` (the inference gate), per-candidate ``measured``
    rows. On a CUDA tensor a candidate that raises or leaves ``rel_tol``
    raises (the port's departure) instead of being recorded."""
    iters = iters if iters is not None else tune_iters()
    margin = margin if margin is not None else min_speedup()
    args = _to_device(args)
    on_card = args[0].is_cuda

    def contest(fn):
        return (_runner(fn, args, False, iters),
                _runner(fn, args, True, iters) if train else None)

    def values(fn, at):
        if train:
            return _grads(fn, at)
        with torch.no_grad():
            return _flat(fn(*at)), []

    refs = [values(baseline, args)]
    if any(a.dtype == torch.bfloat16 for a in args):
        # the function's value at these inputs, the baseline in float32: at
        # bfloat16 the unfused baseline rounds more often than a kernel
        # that accumulates in float32 (at ReLU kinks its gradients lie
        # 2-7 % off this), so a candidate within rel_tol of either is right
        refs.append(values(baseline, tuple(
            a.float() if a.dtype == torch.bfloat16 else a for a in args)))

    def err_of(out, g):
        return min(max([_rel_err(out, o_ref)] + [_rel_err([a], [b]) for a, b in zip(g, g_ref)])
                   for o_ref, g_ref in refs)

    rec = {"engage": False, "engage_fwd": False, "lowering": None,
           "iters": iters, "train": bool(train), "measured": {}}
    table = [("__baseline__", contest(baseline))]
    errs = {}
    for name, fn in candidates:
        try:
            runners = contest(fn)
            err = err_of(*values(fn, args))
        except Exception as exc:  # noqa: BLE001
            if on_card:
                raise  # a kernel that fails on the card is a fault, not a loser
            rec["measured"][name] = {"error": "%s: %s" % (type(exc).__name__, exc)}
            continue
        if on_card and not err <= rel_tol:
            # wrong numbers on the card are a fault too, never a decline
            raise MXNetError("fusion_tune: candidate %r leaves its baseline on %s by "
                             "rel_err %.3g > %.3g" % (name, args[0].device, err, rel_tol))
        errs[name] = err
        table.append((name, runners))
    samples = {name: ([], []) for name, _ in table}
    for _ in range(_ROUNDS):
        for name, runners in table:
            samples[name][0].append(runners[0]())
            if runners[1] is not None:
                samples[name][1].append(runners[1]())
    times = {name: [float(np.median(f)), float(np.median(t)) if t else float("inf")]
             for name, (f, t) in samples.items()}
    b_fwd, b_tot = times["__baseline__"]
    b_bwd = max(b_tot - b_fwd, 0.0) if train else 0.0
    rec["base_fwd_us"] = round(b_fwd * 1e6, 2)
    if train:
        rec["base_bwd_us"] = round(b_bwd * 1e6, 2)
    best = best_fwd = None
    for name, _ in table[1:]:
        f_fwd, f_tot = times[name]
        f_bwd = max(f_tot - f_fwd, 0.0) if train else 0.0
        err = errs[name]
        row = {"fwd_us": round(f_fwd * 1e6, 2), "rel_err": round(err, 6)}
        if train:
            row["bwd_us"] = round(f_bwd * 1e6, 2)
        if err <= rel_tol:
            total = f_tot if train else f_fwd
            base_total = b_tot if train else b_fwd
            if (base_total / total >= margin
                    and (best is None or total < best[0])):
                best = (total, name, f_fwd, f_bwd, err)
            if (b_fwd / f_fwd >= margin
                    and (best_fwd is None or f_fwd < best_fwd[0])):
                best_fwd = (f_fwd, name)
        else:
            row["rejected"] = "parity (rel_err %.2g > %.2g)" % (err, rel_tol)
        rec["measured"][name] = row
    if best is not None:
        _, name, f_fwd, f_bwd, err = best
        rec.update({"engage": True, "lowering": name,
                    "fused_fwd_us": round(f_fwd * 1e6, 2),
                    "rel_err": round(err, 6)})
        if train:
            rec["fused_bwd_us"] = round(f_bwd * 1e6, 2)
    if best_fwd is not None:
        rec["engage_fwd"] = True
        rec.setdefault("lowering_fwd", best_fwd[1])
    return rec
