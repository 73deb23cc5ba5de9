"""Profiler (reference: python/mxnet/profiler.py + src/engine/profiler.cc).

Counterpart of ``mxnet_tpu/profiler.py``, on ``torch.profiler`` where the
reference captures with ``jax.profiler``. A capture is TWO coordinated
recorders:

  * the torch trace — a ``torch.profiler.profile`` window with CPU
    activity, and CUDA activity when CUDA is available (kernel launches on
    the card, CPU ops on the host), exported at ``stop`` as a chrome trace
    into ``<filename dir>/torch_trace/<ns>.pt.trace.json``, and
  * the framework telemetry spans (mxnet_tpu_torch.telemetry) — engine/
    executor/fusion/kvstore/io seams, forced to ``trace`` mode for the
    window even when ``MXNET_TELEMETRY`` is off.

``dump_profile()`` finalizes both and honors the reference ``MXDumpProfile``
contract: it writes the framework spans as chrome-trace JSON to the
configured ``filename`` (with the torch trace directory recorded under the
reference's key, ``otherData.xla_trace_dir``, which ``mxtrace`` and the
schema read), and returns that path. State transitions are idempotent:
``profiler_set_state('run')`` while running, ``'stop'`` while stopped, and
``dump_profile()`` with no capture are all clean no-ops that never leave
``_state``/``_trace_dir`` torn.
"""
from __future__ import annotations

import logging
import os
import time

from .base import MXNetError
from . import telemetry as _tm

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "trace_files", "summarize", "State"]

_LOG = logging.getLogger("mxnet_tpu_torch")

_config = {"mode": "symbolic", "filename": "profile.json"}
_state = "stop"
_trace_dir = None     # torch capture dir of the current/last capture
_dump_path = None     # framework chrome-trace written by the last dump
_prof = None          # the running torch.profiler.profile, if it started
_captured = False     # at least one capture window ran (dump has content)
_saved_override = None  # telemetry mode override to restore at stop

#: chrome-trace categories of the work a card ran (torch.profiler's
#: kineto trace); on the CPU the device rows are the CPU operators
_CARD_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_CPU_CATS = ("cpu_op",)


class State:
    stop = "stop"
    run = "run"


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """(reference: profiler.py profiler_set_config; modes kOnlySymbolic/
    kAllOperator — the torch trace records every operator either way)."""
    if mode not in ("symbolic", "all"):
        raise MXNetError("profiler mode must be 'symbolic' or 'all'")
    _config["mode"] = mode
    _config["filename"] = filename


def profiler_set_state(state="stop"):
    """(reference: profiler.py profiler_set_state). Idempotent in both
    directions: re-entering the current state is a no-op."""
    global _state, _trace_dir, _prof, _captured, _saved_override
    if state not in ("stop", "run"):
        raise MXNetError("profiler state must be 'stop' or 'run'")
    if state == _state:
        return  # already there — never tear _trace_dir/telemetry mode

    if state == "run":
        # frame the capture window: force span recording on, remember what
        # to restore (an explicit set_mode override, or the env default)
        _saved_override = _tm.current_override()
        _tm.set_mode("trace")
        _tm.clear_events()
        _trace_dir = os.path.join(
            os.path.dirname(os.path.abspath(_config["filename"])) or ".",
            "torch_trace")
        _prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            _prof = prof
        except Exception as exc:
            # framework spans still record; the dump just has no torch half
            _LOG.warning("profiler: torch trace capture failed to start (%s); "
                         "capturing framework spans only", exc)
        _state = "run"
        _captured = True
        return

    # state == "stop"
    if _prof is not None:
        prof, _prof = _prof, None
        try:
            prof.stop()
            os.makedirs(_trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                _trace_dir, "%d.pt.trace.json" % time.time_ns()))
        except Exception as exc:
            _LOG.warning("profiler: torch trace capture failed to stop: %s",
                         exc)
    _tm.set_mode(_saved_override)
    _state = "stop"


def dump_profile():
    """Finalize the capture and write the framework chrome-trace JSON to the
    configured ``filename`` (reference: MXDumpProfile). Returns the written
    path — or ``None``, cleanly, when no capture ever ran."""
    global _dump_path
    if _state == "run":
        profiler_set_state("stop")
    if not _captured:
        return None  # nothing recorded; stay consistent instead of raising
    _dump_path = os.path.abspath(_config["filename"])
    _tm.export_chrome_trace(
        _dump_path, xla_trace_dir=_trace_dir,
        extra={"profiler_mode": _config["mode"]})
    return _dump_path


def _torch_traces(d):
    import glob

    return sorted(glob.glob(os.path.join(d, "*.pt.trace.json"))) if d else []


def trace_files(trace_dir=None):
    """Every artifact the capture produced, framework AND torch: the
    chrome-trace JSON ``dump_profile`` wrote (if any) plus the torch
    traces under the capture directory, one a window. Empty list = no
    capture (or the capture failed)."""
    d = trace_dir or _trace_dir
    out = []
    if (trace_dir is None or trace_dir == _trace_dir) \
            and _dump_path and os.path.exists(_dump_path):
        out.append(_dump_path)
    out.extend(_torch_traces(d))
    return out


def _framework_rows(trace_dir):
    """Aggregate framework spans for the CURRENT capture: from the dumped
    chrome-trace when one exists, else the live telemetry buffer. An
    explicit ``trace_dir`` naming a DIFFERENT capture gets no framework
    rows — this process's buffer/dump says nothing about an archived
    trace, and attributing it there would misreport where that capture's
    time went."""
    if trace_dir is not None and trace_dir != _trace_dir:
        return []
    trace = None
    if _dump_path and os.path.exists(_dump_path):
        import json

        try:
            with open(_dump_path) as f:
                trace = json.load(f)
        except (OSError, ValueError):
            trace = None
    rows = _tm.span_summary(trace=trace, top=None if trace else 10**6)
    return [{"process": "mxnet_tpu_torch framework", "name": r["name"],
             "ms": r["ms"], "count": r["count"]} for r in rows]


def summarize(trace_dir=None, top=25, device_only=True):
    """Aggregate per-kernel wall time from a captured trace — the per-op
    stat table of the reference's engine profiler (src/engine/profiler.cc
    chrome-trace events), recovered from the newest torch trace and MERGED
    with the framework telemetry spans.

    Returns a list of {"name", "ms", "count", "process"} dicts, heaviest
    first. The device rows are the card's kernels, copies and memsets, or
    the CPU operators when the capture saw no card. ``device_only=False``
    includes every host-side span of the trace and the framework spans
    (framework seams are host work by definition).
    """
    import collections
    import json

    files = _torch_traces(trace_dir or _trace_dir)
    out = []
    if files:
        with open(files[-1]) as f:
            events = json.load(f).get("traceEvents", [])
        pids = {e.get("pid"): (e.get("args") or {}).get("name", "")
                for e in events if e.get("ph") == "M"
                and e.get("name") == "process_name"}
        spans = [e for e in events if e.get("ph") == "X"]
        if device_only:
            cats = (_CARD_CATS if any(e.get("cat") in _CARD_CATS for e in spans)
                    else _CPU_CATS)
            spans = [e for e in spans if e.get("cat") in cats]
        acc = collections.Counter()
        cnt = collections.Counter()
        for e in spans:
            key = (pids.get(e.get("pid")) or str(e.get("pid")),
                   e.get("name", "?"))
            acc[key] += e.get("dur", 0)
            cnt[key] += 1
        out = [{"process": proc, "name": name,
                "ms": round(us / 1000.0, 3), "count": cnt[(proc, name)]}
               for (proc, name), us in acc.items()]
    if not device_only:
        out.extend(_framework_rows(trace_dir))
    out.sort(key=lambda r: -r["ms"])
    return out[:top]
