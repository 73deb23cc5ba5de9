"""The port's observability tools held against the JAX package's:
``telemetry/cli.py`` (``mxtrace``), ``profiler.py`` and ``visualization.py``.

``mxtrace``: the same dump files give the same text, the same return code
and the same merged file from both packages' ``cli.main`` (the default
view, ``--top``, ``--json``, ``--check`` on a good, a bad and a truncated
dump and on a file cut short, ``--fleet``, ``--fleet-trace``, and dumps of
two processes merged by ``merge_traces``); the port's module also runs as
``python -m mxnet_tpu_torch.telemetry.cli``. ``profiler``: the reference's
case of ``tests/test_misc.py`` on the CPU over ``torch.profiler``.
``visualization``: ``print_summary``'s text and total and ``plot_network``'s
graph for the same symbol JSON.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import visualization as mx_vis
from mxnet_tpu.telemetry import cli as mx_cli
from mxnet_tpu_torch import telemetry as pt_tm
from mxnet_tpu_torch import visualization as pt_vis
from mxnet_tpu_torch.telemetry import cli as pt_cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: a child process that records spans (two trace ids shared with the
#: parent's dump), step rows and counters, and writes its dump
_CHILD = r"""
import sys, time
from mxnet_tpu_torch import telemetry as tm
tm.set_mode("trace")
for i, tid in enumerate(("00000000000000aa", "00000000000000bb")):
    with tm.trace_scope(tid):
        with tm.span("serving.dispatch", rows=2):
            time.sleep(0.002)
        with tm.span("serving.queue_wait"):
            pass
    tm.counter("serving.batches").inc()
    tm.mark_step()
tm.export_chrome_trace(sys.argv[1], extra={"label": "replica-0", "clock_offset_s": 0.0015})
"""


def _record_parent_dump(path, fleet):
    """A dump of this process through the port's telemetry: step rows,
    repeated spans on two threads (gap attribution), trace ids, counters,
    a lock-witness block and the fleet rollup."""
    saved = pt_tm.current_override()
    pt_tm.reset()
    pt_tm.clear_events()
    pt_tm.set_mode("trace")
    try:
        for step in range(3):
            with pt_tm.span("executor.forward", bucket=4):
                time.sleep(0.001)
            with pt_tm.trace_scope("00000000000000aa" if step else "00000000000000bb"):
                with pt_tm.span("fleet.dispatch", replica=0):
                    time.sleep(0.001)
            pt_tm.counter("executor.cache_hit").inc(2)
            pt_tm.counter("io.batches").inc()
            pt_tm.timer("fleet.request").add(0.003 * (step + 1))
            pt_tm.mark_step()
        pt_tm.export_chrome_trace(path, xla_trace_dir="/nonexistent/torch_trace", extra={
            "label": "router", "fleet": fleet, "lock_witness": {
                "locks": [{"name": "serving.cache", "acquisitions": 12, "contentions": 1,
                           "wait_ms": 0.25, "hold_ms": 3.5, "max_hold_ms": 1.25,
                           "long_holds": 0, "threads": {"batcher": 12}}],
                "events": [{"kind": "inversion", "first": "a", "then": "b",
                            "thread": "t1", "prior_count": 2},
                           {"kind": "long_hold", "lock": "serving.cache", "hold_ms": 55.0,
                            "thread": "batcher", "dispatch_seam": True}],
                "events_dropped": 1}})
    finally:
        pt_tm.set_mode(saved)
        pt_tm.reset()
        pt_tm.clear_events()


def _fleet_rollup():
    """A ``Router.metrics()`` rollup with an SLO block, as the router
    stamps it into a merged fleet dump."""
    return {"qps": 41.5, "requests": 83, "errors": 1, "shed": 2, "shed_rate": 0.0235,
            "redispatches": 3, "submitted": 85, "replicas_fresh": 2,
            "tokens_per_dispatch": None, "elapsed_s": 2.0,
            "latency_ms": {"fleet.request": {"count": 83, "p50": 3.9, "p95": 9.5, "p99": 15.25},
                           "serving.request": {"count": 80, "p50": 2.1, "p95": 4.0,
                                               "p99": 6.5}},
            "counters": {"serving.requests": 80},
            "replicas": {"0": {"state": "healthy", "requests": 40, "qps": 20.0,
                               "clock_offset_ms": 1.5, "dropped": 0},
                         "1": {"state": "degraded", "requests": 43, "qps": 21.5,
                               "clock_offset_ms": -0.25, "dropped": 1}},
            "dropped_events": 1,
            "slo": {"ok": False, "burn_rate": 2.5, "burn_threshold": 1.0,
                    "short_window_s": 5, "window_s": 60,
                    "objectives": {"err_pct": {"threshold": 1, "burn_rate": 2.5,
                                               "value": 2.5, "firing": True},
                                   "p99_ms": {"threshold": 50, "burn_rate": 0.3,
                                              "value": 15.25, "firing": False}}},
            "violations": [{"kind": "slo.violation", "objective": "err_pct",
                            "burn_rate": 2.5}]}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """The dump files every case reads: the parent's, a child process's,
    the two merged by the reference's ``mxtrace --out``, a bad one (wrong
    schema version, an X event without ts), a truncated one (dropped
    spans) and a file cut short mid-JSON."""
    d = tmp_path_factory.mktemp("dumps")
    paths = {"parent": d / "router.json", "child": d / "replica.json"}
    _record_parent_dump(str(paths["parent"]), _fleet_rollup())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", _CHILD, str(paths["child"])], env=env, check=True,
                   cwd=str(d), timeout=120)
    paths["merged"] = d / "merged.json"
    assert mx_cli.main([str(paths["parent"]), str(paths["child"]), "--out",
                        str(paths["merged"])]) == 0
    good = json.loads(paths["parent"].read_text())
    bad = json.loads(json.dumps(good))
    bad["otherData"]["mxnet_telemetry"] = 0
    next(e for e in bad["traceEvents"] if e["ph"] == "X").pop("ts")
    paths["bad"] = d / "bad.json"
    paths["bad"].write_text(json.dumps(bad))
    trunc = json.loads(json.dumps(good))
    trunc["otherData"]["dropped"] = 17
    paths["truncated"] = d / "truncated.json"
    paths["truncated"].write_text(json.dumps(trunc))
    paths["cut"] = d / "cut.json"
    paths["cut"].write_text(paths["parent"].read_text()[:200])
    no_steps = json.loads(json.dumps(good))
    no_steps["otherData"]["steps"] = []
    no_steps["otherData"].pop("lock_witness")
    no_steps["otherData"].pop("fleet")
    paths["bare"] = d / "bare.json"
    paths["bare"].write_text(json.dumps(no_steps))
    return paths


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


VIEWS = [("parent", []), ("parent", ["--top", "3"]), ("parent", ["--json"]),
         ("parent", ["--check"]), ("bad", ["--check"]), ("truncated", ["--check"]),
         ("truncated", []), ("cut", ["--check"]), ("cut", []), ("bare", []),
         ("bare", ["--fleet", "--fleet-trace"]), ("merged", []), ("merged", ["--check"]),
         ("merged", ["--fleet"]), ("merged", ["--fleet-trace"]),
         ("merged", ["--fleet", "--fleet-trace", "--top", "4"]), ("child", ["--fleet-trace"])]


@pytest.mark.parametrize("which, flags", VIEWS, ids=["%s%s" % (w, "".join(f)) for w, f in VIEWS])
def test_mxtrace_prints_the_references_text(which, flags, dumps, capsys):
    argv = [str(dumps[which])] + flags
    want = _run(mx_cli, argv, capsys)
    got = _run(pt_cli, argv, capsys)
    assert got == want
    assert want[1] or want[2]


def test_mxtrace_merges_two_processes_as_the_reference_does(dumps, tmp_path, capsys):
    outs = {}
    for name, cli in (("jax", mx_cli), ("torch", pt_cli)):
        path = tmp_path / ("%s.json" % name)
        rc, text, _ = _run(cli, [str(dumps["parent"]), str(dumps["child"]), "--out", str(path),
                                 "--fleet-trace"], capsys)
        assert rc == 0
        outs[name] = (text, json.loads(path.read_text()))
    assert outs["torch"] == outs["jax"]
    merged = outs["torch"][1]
    assert pt_cli.check(merged) == []
    chains = pt_cli.request_chains(merged)
    assert len({s["pid"] for s in chains["00000000000000aa"]}) == 2
    assert sorted(d["label"] for d in merged["otherData"]["processes"].values()) == \
        ["replica-0", "router"]


def test_mxtrace_check_and_chains_equal_the_references(dumps):
    for which in ("parent", "child", "merged", "bad", "truncated"):
        trace = json.loads(dumps[which].read_text())
        assert pt_cli.check(trace) == mx_cli.check(trace)
        assert pt_cli.request_chains(trace, top=0) == mx_cli.request_chains(trace, top=0)
        for fn in ("step_table", "fleet_table", "locks_table"):
            assert getattr(pt_cli, fn)(trace) == getattr(mx_cli, fn)(trace)
        for fn in ("spans_table", "gaps_table", "fleet_trace_table"):
            assert getattr(pt_cli, fn)(trace, 5) == getattr(mx_cli, fn)(trace, 5)
    assert pt_cli.check([]) == mx_cli.check([])
    assert pt_cli.check({"traceEvents": 3}) == mx_cli.check({"traceEvents": 3})


def test_mxtrace_runs_as_a_module(dumps):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.telemetry.cli",
                          str(dumps["merged"]), "--fleet"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("== fleet rollups ==\nfleet: qps=41.5")
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.telemetry.cli",
                          str(dumps["bad"]), "--check"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 1 and "mxtrace: SCHEMA: otherData.mxnet_telemetry" in res.stderr


# ------------------------------------------------------------- profiler
def test_profiler_api(tmp_path):
    """The reference's ``test_misc.py::test_profiler_api`` on the port: the
    config is validated, run/stop/dump are idempotent, the capture leaves
    artifacts and ``summarize`` parses them (CPU operators here)."""
    from mxnet_tpu_torch import profiler

    profiler.profiler_set_config(mode="all", filename=str(tmp_path / "p.json"))
    with pytest.raises(pt.MXNetError):
        profiler.profiler_set_config(mode="bogus")
    with pytest.raises(pt.MXNetError):
        profiler.profiler_set_state("paused")
    assert profiler.dump_profile() in (None, profiler._dump_path)
    before = pt_tm.mode()
    profiler.profiler_set_state("run")
    assert pt_tm.tracing()
    trace_dir = profiler._trace_dir
    profiler.profiler_set_state("run")  # idempotent: the window stays open
    assert profiler._trace_dir == trace_dir and profiler._state == "run"
    with pt.cpu():
        x = pt.nd.ones((64, 64))
        (pt.nd.dot(x, x) + 1).wait_to_read()
        with pt_tm.span("executor.forward"):
            pass
    profiler.profiler_set_state("stop")
    profiler.profiler_set_state("stop")
    assert pt_tm.mode() == before
    files = profiler.trace_files()
    assert files, "profiler capture produced no trace artifacts"
    assert any(f.endswith(".pt.trace.json") for f in files), files
    assert os.path.dirname(files[-1]) == str(tmp_path / "torch_trace")
    rows = profiler.summarize(device_only=False, top=10)
    assert rows and all({"name", "ms", "count", "process"} <= set(r) for r in rows)
    ops = profiler.summarize(top=50)
    assert any(r["name"] == "aten::mm" for r in ops), ops
    path = profiler.dump_profile()
    assert path == str(tmp_path / "p.json")
    assert profiler.dump_profile() == path  # a second dump rewrites the same file
    trace = json.loads(Path(path).read_text())
    assert pt_cli.check(trace) == []
    assert trace["otherData"]["xla_trace_dir"] == str(tmp_path / "torch_trace")
    assert trace["otherData"]["profiler_mode"] == "all"
    assert path in profiler.trace_files()
    assert profiler.trace_files(str(tmp_path / "elsewhere")) == []
    assert profiler.summarize(str(tmp_path / "elsewhere"), device_only=False) == []
    assert any(r["process"] == "mxnet_tpu_torch framework" and r["name"] == "executor.forward"
               for r in profiler.summarize(device_only=False, top=100))


def test_profiler_api_matches_the_references_signatures():
    from mxnet_tpu import profiler as mp
    from mxnet_tpu_torch import profiler as pp

    import inspect

    assert pp.__all__ == mp.__all__
    for name in mp.__all__:
        a, b = getattr(mp, name), getattr(pp, name)
        if callable(a) and not isinstance(a, type):
            assert inspect.signature(a) == inspect.signature(b), name
    assert (pp.State.run, pp.State.stop) == (mp.State.run, mp.State.stop)


# ------------------------------------------------------- visualization
SUMMARY_CASES = [("mlp", {"num_classes": 10}, (2, 784)),
                 ("resnet", {"num_layers": 18, "num_classes": 10, "image_shape": "3,32,32"},
                  (2, 3, 32, 32)),
                 ("lenet", {"num_classes": 10}, None)]


@pytest.mark.parametrize("model, kwargs, shape", SUMMARY_CASES, ids=[c[0] for c in SUMMARY_CASES])
def test_print_summary_prints_the_references_text(model, kwargs, shape, capsys):
    js = mx.models.get_symbol(model, **kwargs).tojson()
    shape = None if shape is None else {"data": shape}
    want = mx_vis.print_summary(mx.sym.fromjson(js), shape=shape, line_length=100)
    text = capsys.readouterr().out
    got = pt_vis.print_summary(pt.sym.fromjson(js), shape=shape, line_length=100)
    assert capsys.readouterr().out == text
    assert got == want and (got > 0) == (shape is not None)


def test_print_summary(capsys):
    """The reference's ``test_misc.py::test_print_summary`` on the port."""
    net = pt.sym.FullyConnected(data=pt.sym.Variable("data"), num_hidden=4, name="fc")
    total = pt_vis.print_summary(net, shape={"data": (2, 3)})
    assert "fc" in capsys.readouterr().out
    assert total == 4 * 3 + 4


def test_plot_network_is_the_references_graph_or_raises_as_it_does(monkeypatch):
    js = mx.models.get_symbol("mlp", num_classes=10).tojson()
    try:
        import graphviz  # noqa: F401
    except ImportError:
        pass
    else:
        want = mx_vis.plot_network(mx.sym.fromjson(js), title="net",
                                   node_attrs={"fillcolor": "#fff"}).source
        got = pt_vis.plot_network(pt.sym.fromjson(js), title="net",
                                  node_attrs={"fillcolor": "#fff"}).source
        assert got == want
    monkeypatch.setitem(sys.modules, "graphviz", None)  # an import of it now fails
    msgs = []
    for vis, sym, err in ((mx_vis, mx.sym, mx.MXNetError), (pt_vis, pt.sym, pt.MXNetError)):
        with pytest.raises(err) as ei:
            vis.plot_network(sym.fromjson(js))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "plot_network requires the graphviz package"
