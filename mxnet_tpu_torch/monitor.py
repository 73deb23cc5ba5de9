# copied from mxnet_tpu/monitor.py (backend-free)
"""Monitor: per-batch output statistics (reference: python/mxnet/monitor.py:16).

Installs an executor monitor callback; each ``tic``/``toc`` window collects
(name, stat) pairs for outputs matching the pattern — the observability layer
Module.fit wires when ``monitor`` is passed (base_module.py fit)."""
from __future__ import annotations

import logging
import re

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """|x|/size(x), the reference's default stat"""
                arr = x.asnumpy()
                return abs(arr).sum() / arr.size

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(name):
            return
        try:
            stat = self.stat_func(arr)
        except Exception as exc:
            # a non-numeric/odd-dtype output (int tokens, bool masks, a
            # custom stat_func choking on bf16) must not abort fit mid-epoch
            # — record the failure as the stat instead of raising
            stat = "<stat failed: %s: %s>" % (type(exc).__name__, exc)
        self.queue.append((self.step, name, stat))

    def install(self, exe):
        """(reference: monitor.py install — executor.set_monitor_callback)"""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v in self.queue:
            res.append((n, k, str(v)))
        self.queue = []
        res.extend(self._telemetry_stats())
        return res

    def _telemetry_stats(self):
        """Per-batch framework stats from the telemetry registry (single
        source of truth with the trace/Speedometer): the latest step row's
        counter/timer deltas, rendered like output stats. Empty when
        telemetry is off or no step has been marked yet."""
        from . import telemetry

        if not telemetry.enabled():
            return []
        rows = telemetry.step_rows(last=1)
        if not rows:
            return []
        row = rows[-1]
        # label with THIS monitor's batch counter, not the registry's
        # process-global step id — a prior fit/bench in the process would
        # otherwise make the two row families disagree in the Batch column
        n = self.step - 1
        out = []
        if row["wall_ms"] is not None:
            out.append((n, "telemetry.step_wall_ms", str(row["wall_ms"])))
        for name, delta in sorted(row["counters"].items()):
            out.append((n, "telemetry." + name, str(delta)))
        for name, t in sorted(row["timers"].items()):
            out.append((n, "telemetry.%s_ms" % name, str(t["ms"])))
        return out

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
        return res
