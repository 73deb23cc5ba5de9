"""The port's static analysis (``mxnet_tpu_torch/analysis/``: the seven
graph passes, the engine-race analysis, the dispatch and concurrency lints
and the ``graphlint`` CLI) held against the JAX package's.

Every case of the reference's ``tests/test_graphlint.py`` runs on both
packages (fixture ``mx``): every GL0xx-GL8xx code fires on its broken
graph, schedule or source and stays silent on its clean one, the
sharding-plan and memory-plan acceptance cases, the telemetry gauge, the
budget variable, the fused step's bind feeding the real mesh, the
``infer_meta`` registry, the bind-time modes, the unknown-pass refusal, the
engines' unknown-variable refusal, the repo scans (each package scans its
own sources) and the CLI. Beside them, each report's ``(code, node,
severity)`` list and its ``memory_plan`` dict equal the JAX package's, for
every code's graphs and for the zoo's models over several meshes, budgets
and policies, with all seven passes in both packages, both pattern engines
set to three patterns and their attention forced onto the flash lowering
(``MXNET_FUSED_PATTERNS``, which both packages read): the port trains every
attention site it can through its flash kernels, and the memory plan's
fusion and attention entries report each package's own engine. The CLI's
``--format json`` payloads equal JAX's for the same argv. Messages are
compared after ``_as_reference`` maps the port's own words (its conv+BN
kernel, its bound programs and captured graphs) back to the reference's.
The rewrite verifier's GL6xx cases run the reference's deliberately broken
passes over each package's ``RewritePass`` (``REWRITE_CODE_CASES``). The
port's own vocabulary (torch's pulls and collectives, the CUDA graph's
``replay``, ``dist.orig_rank``) has a broken source per word
(``PORT_PULLS``, ``PORT_COLLECTIVES``).

``WAITS_FOR_1_5`` is empty: a completeness check holds that every
reference case is mirrored here.
"""
import ast
import contextlib
import importlib
import json
import logging
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu
import mxnet_tpu_torch as pt

ROOT = Path(__file__).resolve().parents[1]
#: the order of the reference's manager (``run_graph_passes``' imports), in
#: which the port registers its passes. The reference registers its own in
#: whichever order a process first imports their modules (its
#: ``analysis/__init__.py`` imports ``dispatch_lint``; a test file may import
#: ``concurrency_lint``), so reports are compared pass by pass (``_rows``).
PASSES = ["shape_lint", "retrace_guard", "fusion_explain", "shard_lint", "memory_plan",
          "dispatch_lint", "concurrency_lint"]
JAX_PATTERNS = "attention=pallas_flash,matmul_bias_act,norm_residual"

#: reference cases of tests/test_graphlint.py not mirrored here (none)
WAITS_FOR_1_5 = {}

#: the port's words in a message, each with the reference's in its place
PORT_WORDS = (
    ("the hand-written conv+BN kernel", "the Pallas conv+BN path"),
    ("has no fused variant", "has no Pallas variant"),
    ("this conv runs on cuDNN (torch's convolution); see fusion.conv_reject_reason for the "
     "supported shapes", "this conv runs on the ordinary XLA lowering; see docs/PERF.md §6 for "
     "the supported shapes"),
    ("a distinct bound program — a per-step-varying scalar (lr, loss scale) forces one bind "
     "(and graph capture) per step", "a distinct XLA compile — a per-step-varying scalar (lr, "
     "loss scale) forces one compile per step"),
    ("binds a fresh program (and captures a fresh CUDA graph), and bound buffers are not "
     "shared across shapes", "traces and compiles a fresh XLA executable, and bound buffers "
     "are not donated across shapes"),
    ("every shard is padded to", "XLA pads every shard to"),
)


def _as_reference(text):
    for port, ref in PORT_WORDS:
        text = text.replace(port, ref)
    return text


@pytest.fixture(params=["jax", "port"])
def mx(request):
    return mxnet_tpu if request.param == "jax" else pt


def _on(m):
    return pt.cpu() if m is pt else contextlib.nullcontext()


def _lint(m, sym, **kw):
    return m.analysis.lint(sym, **kw)


def _codes(m, sym, **kw):
    return set(_lint(m, sym, **kw).codes())


def _empty_spec(m):
    if m is mxnet_tpu:
        from jax.sharding import PartitionSpec as P

        return P()
    return ()


# ------------------------------------------------------------ code table
def _gl001_broken(m):
    a = m.sym.Variable("a", shape=(2, 3))
    b = m.sym.Variable("b", shape=(4, 5))
    return m.sym.dot(a, b, name="baddot"), {}


def _gl001_clean(m):
    a = m.sym.Variable("a", shape=(2, 3))
    b = m.sym.Variable("b", shape=(3, 5))
    return m.sym.dot(a, b, name="okdot"), {}


def _gl002_broken(m):
    d, e = m.sym.Variable("data"), m.sym.Variable("extra")
    s = m.sym.FullyConnected(data=d, num_hidden=4, name="fcA") \
        + m.sym.FullyConnected(data=e, num_hidden=4, name="fcB")
    return s, {"shapes": {"data": (2, 8)}}


def _gl002_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=4, name="fcC"),
            {"shapes": {"data": (2, 8)}})


def _gl003_broken(m):
    w = m.sym.Variable("fc_weight", shape=(7, 99))
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), weight=w, num_hidden=7, name="fc"),
            {"shapes": {"data": (2, 10)}})


def _gl003_clean(m):
    w = m.sym.Variable("fc_weight", shape=(7, 10))
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), weight=w, num_hidden=7, name="fc"),
            {"shapes": {"data": (2, 10)}})


def _gl004_broken(m):
    x = m.sym.Variable("x", dtype="float16")
    y = m.sym.Variable("y", dtype="float32")
    return x + y, {"shapes": {"x": (2,), "y": (2,)}}


def _gl004_clean(m):
    x = m.sym.Variable("x", dtype="float16")
    y = m.sym.Variable("y", dtype="float16")
    return x + y, {"shapes": {"x": (2,), "y": (2,)}}


def _gl005_broken(m):
    return m.sym.Variable("dup") + m.sym.Variable("dup"), {"shapes": {"dup": (2,)}}


def _gl005_clean(m):
    return m.sym.Variable("p") + m.sym.Variable("q"), {"shapes": {"p": (2,), "q": (2,)}}


def _gl006_broken(m):
    flat = m.sym.Flatten(data=m.sym.Variable("data"))
    return (m.sym.Convolution(data=flat, num_filter=8, kernel=(3, 3), name="badconv"),
            {"shapes": {"data": (2, 3, 8, 8)}})


def _gl006_clean(m):
    return (m.sym.Convolution(data=m.sym.Variable("data"), num_filter=8, kernel=(3, 3),
                              pad=(1, 1), name="okconv"),
            {"shapes": {"data": (2, 3, 8, 8)}})


def _gl201_broken(m):
    return m.sym.Variable("x") * 0.125, {}


def _gl201_clean(m):
    return m.sym.Variable("x") + m.sym.Variable("y"), {}


def _gl202_broken(m):
    h = m.sym.Variable("h", dtype="float16")
    return m.sym.Variable("x") + h, {}


def _gl202_clean(m):
    h = m.sym.Variable("h", dtype="float16")
    return m.sym.Variable("x", dtype="float16") + h, {}


def _gl203_broken(m):
    return m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=4, name="fcP"), {}


def _gl203_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=4, name="fcP"),
            {"shapes": {"data": (2, 8)}})


def _fusable_chain(m, kernel=(3, 3), pad=(1, 1), no_bias=True, name="c"):
    bn = m.sym.BatchNorm(data=m.sym.Variable("data"), fix_gamma=False, name=name + "_bn")
    act = m.sym.Activation(data=bn, act_type="relu", name=name + "_relu")
    return m.sym.Convolution(data=act, num_filter=8, kernel=kernel, pad=pad, no_bias=no_bias,
                             name=name + "_conv")


def _gl301_broken(m):
    return _fusable_chain(m, no_bias=False, name="biased"), {}


def _gl301_clean(m):
    return _fusable_chain(m, name="fusable"), {}


def _gl302_broken(m):
    bn = m.sym.BatchNorm(data=m.sym.Variable("data"), fix_gamma=False, name="pool_bn")
    return m.sym.Pooling(data=bn, kernel=(2, 2), pool_type="max", name="pool"), {}


def _gl302_clean(m):
    return _fusable_chain(m, name="folded"), {}


def _gl303_broken(m):
    fc = m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc_shared")
    relu = m.sym.Activation(data=fc, act_type="relu", name="relu")
    return relu + fc, {"shapes": {"data": (4, 16)}}


def _gl303_clean(m):
    fc = m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc")
    return (m.sym.Activation(data=fc, act_type="relu", name="relu"),
            {"shapes": {"data": (4, 16)}})


def _gl401_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=999, name="oddfc"),
            {"shapes": {"data": (4, 783)}, "mesh": "dp=2,model=2"})


def _gl401_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=1000, name="evenfc"),
            {"shapes": {"data": (4, 784)}, "mesh": "dp=2,model=2"})


def _gl402_broken(m):
    h = m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=256, name="fcbig")
    return (m.sym.FullyConnected(data=h, num_hidden=8, name="fcsmall"),
            {"shapes": {"data": (8, 512)}, "mesh": "dp=2,model=2"})


def _gl402_clean(m):
    h = m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=16, name="fc_a")
    return (m.sym.FullyConnected(data=h, num_hidden=8, name="fc_b"),
            {"shapes": {"data": (8, 64)}, "mesh": "dp=2,model=2"})


def _gl403_broken(m):
    s = m.sym.sum(m.sym.Variable("data"), name="collapse")
    return s * 2.0, {"shapes": {"data": (8, 16)}, "mesh": "dp=2"}


def _gl403_clean(m):
    return (m.sym.sum(m.sym.Variable("data"), name="lossval"),
            {"shapes": {"data": (8, 16)}, "mesh": "dp=2"})


def _gl404_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (3, 16)}, "mesh": "dp=2"})


def _gl404_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (4, 16)}, "mesh": "dp=2"})


def _gl405_rules(m, param_rule):
    mesh = m.parallel.parse_mesh_spec("dp=2,model=2")
    return mesh, m.parallel.ShardingRules.infer_axes(mesh, param_rule=param_rule)


def _gl405_broken(m):
    empty = _empty_spec(m)
    mesh, rules = _gl405_rules(m, lambda name, shape: empty)  # replicate all
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=256, name="fc"),
            {"shapes": {"data": (8, 512)}, "mesh": mesh, "rules": rules})


def _gl405_clean(m):
    mesh, rules = _gl405_rules(m, None)
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=256, name="fc"),
            {"shapes": {"data": (8, 512)}, "mesh": mesh, "rules": rules})


def _gl501_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (8, 16)}, "budget_gb": 1e-6})


def _gl501_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=8, name="fc"),
            {"shapes": {"data": (8, 16)}, "budget_gb": 1000.0})


def _gl502_broken(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=65536, name="bigfc"),
            {"shapes": {"data": (4096, 64)}})


def _gl502_clean(m):
    return (m.sym.FullyConnected(data=m.sym.Variable("data"), num_hidden=1024, name="smallfc"),
            {"shapes": {"data": (64, 64)}})


GRAPH_CODE_CASES = {
    "GL001": (_gl001_broken, _gl001_clean), "GL002": (_gl002_broken, _gl002_clean),
    "GL003": (_gl003_broken, _gl003_clean), "GL004": (_gl004_broken, _gl004_clean),
    "GL005": (_gl005_broken, _gl005_clean), "GL006": (_gl006_broken, _gl006_clean),
    "GL201": (_gl201_broken, _gl201_clean), "GL202": (_gl202_broken, _gl202_clean),
    "GL203": (_gl203_broken, _gl203_clean),
    "GL301": (_gl301_broken, _gl301_clean), "GL302": (_gl302_broken, _gl302_clean),
    "GL303": (_gl303_broken, _gl303_clean),
    "GL401": (_gl401_broken, _gl401_clean), "GL402": (_gl402_broken, _gl402_clean),
    "GL403": (_gl403_broken, _gl403_clean), "GL404": (_gl404_broken, _gl404_clean),
    "GL405": (_gl405_broken, _gl405_clean),
    "GL501": (_gl501_broken, _gl501_clean), "GL502": (_gl502_broken, _gl502_clean),
}


def _build(m, builder):
    with m.name.NameManager():
        return builder(m)


@pytest.mark.parametrize("code", sorted(GRAPH_CODE_CASES))
def test_graph_code_triggers_on_broken_graph(mx, code):
    sym, kw = _build(mx, GRAPH_CODE_CASES[code][0])
    assert code in _codes(mx, sym, **kw)


@pytest.mark.parametrize("code", sorted(GRAPH_CODE_CASES))
def test_graph_code_silent_on_clean_graph(mx, code):
    sym, kw = _build(mx, GRAPH_CODE_CASES[code][1])
    assert code not in _codes(mx, sym, **kw)


def _rows(report):
    """(code, node, severity) of each finding, in the manager's pass order
    and each pass's own order."""
    ds = sorted(enumerate(report), key=lambda p: (PASSES.index(p[1].pass_name), p[0]))
    return [(d.code, d.node, d.severity) for _, d in ds]


@pytest.fixture
def jax_patterns(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_PATTERNS", JAX_PATTERNS)


@pytest.mark.parametrize("code", sorted(GRAPH_CODE_CASES))
@pytest.mark.parametrize("side", [0, 1], ids=["broken", "clean"])
def test_each_codes_report_equals_the_references(code, side, jax_patterns):
    reports = []
    for m in (mxnet_tpu, pt):
        sym, kw = _build(m, GRAPH_CODE_CASES[code][side])
        reports.append(_lint(m, sym, **kw))
    ref, port = reports
    assert _rows(port) == _rows(ref)
    assert port.memory_plan == ref.memory_plan
    assert port.reshard_total_bytes == ref.reshard_total_bytes
    # a GL001 quotes the backend's own exception after its prefix
    assert [_message(d) for d in _by_pass(port)] == [_message(d) for d in _by_pass(ref)]


def _by_pass(report):
    return [d for _, d in sorted(enumerate(report),
                                 key=lambda p: (PASSES.index(p[1].pass_name), p[0]))]


def _message(d):
    return d.message.split(": ")[0] if d.code == "GL001" else _as_reference(d.message)


ZOO = {
    "mlp": (dict(num_classes=10), {"data": (8, 784)}),
    "lenet": (dict(num_classes=10), {"data": (8, 1, 28, 28)}),
    "resnet-18": (dict(num_classes=10, image_shape="3,32,32"), {"data": (8, 3, 32, 32)}),
    "resnet-50": (dict(num_classes=10, image_shape="3,32,32"), {"data": (8, 3, 32, 32)}),
    "transformer": (dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64,
                         seq_len=16), {"data": (8, 16), "softmax_label": (8, 16)}),
    "recommender": (dict(num_users=512, num_items=256, embed_dim=16, dense_dim=8),
                    {"user": (8,), "item": (8,), "dense": (8, 8)}),
}
LINT_KW = {"single": {}, "dp8": {"mesh": "dp=8"}, "dp4_tp2": {"mesh": "dp=4,model=2"},
           "budget": {"mesh": "dp=2", "budget_gb": 1e-4}, "recompute": {"bwd": "recompute"},
           "inference": {"train": False}}


@pytest.mark.parametrize("kw", sorted(LINT_KW))
@pytest.mark.parametrize("model", sorted(ZOO))
def test_zoo_reports_and_memory_plans_equal_the_references(model, kw, jax_patterns):
    build, shapes = ZOO[model]
    reports = []
    for m in (mxnet_tpu, pt):
        with m.name.NameManager():
            sym = m.models.get_symbol(model, **build)
        reports.append(_lint(m, sym, shapes=shapes, **LINT_KW[kw]))
    ref, port = reports
    assert _rows(port) == _rows(ref)
    assert port.memory_plan == ref.memory_plan
    assert port.memory_plan is not None and port.memory_plan["per_device"]["peak"] > 0


def test_every_diagnostic_code_is_tested():
    """Every code has its trigger/clean pair here: the graph codes, the
    engine schedules, the rewrite verifier, the dispatch and concurrency
    sources."""
    covered = (set(GRAPH_CODE_CASES) | set(ENGINE_CODE_CASES) | {"GL105"}
               | set(REWRITE_CODE_CASES) | set(DISPATCH_CODE_CASES)
               | set(CONCURRENCY_CODE_CASES))
    assert covered == set(pt.analysis.CODES)
    assert set(pt.analysis.CODES) == set(mxnet_tpu.analysis.CODES)


def test_every_reference_case_is_mirrored_or_waits_for_section_1_5():
    ref = {n.name for n in ast.parse((ROOT / "tests" / "test_graphlint.py").read_text()).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    here = {n for n in globals() if n.startswith("test_")}
    assert ref - here == set(WAITS_FOR_1_5)


def test_registered_passes_are_the_references_in_order():
    _lint(mxnet_tpu, _build(mxnet_tpu, _gl001_clean)[0])  # the manager's imports register
    assert pt.analysis.list_passes() == PASSES
    assert sorted(mxnet_tpu.analysis.list_passes()) == sorted(PASSES)


def test_port_messages_name_no_reference_backend():
    """The port's code table and the messages and hints of every code's
    broken graph name none of the reference's backend (its kernels, its
    compiler, its loops, its chip)."""
    words = ("Pallas", "XLA", "lax.scan", "TPU", "pjit", "jax")
    texts = [desc for _, desc in pt.analysis.CODES.values()]
    for code in sorted(GRAPH_CODE_CASES):
        sym, kw = _build(pt, GRAPH_CODE_CASES[code][0])
        texts += [t for d in _lint(pt, sym, **kw) for t in (d.message, d.fix_hint or "")]
    for src in DISPATCH_SOURCES.values():
        texts += [t for f in pt.analysis.dispatch_lint.lint_dispatch_source("<case>", text=src)
                  for t in (f.message, f.fix_hint or "")]
    texts += [t for d in pt.analysis.lint_dispatch_gaps(_gl705_rows(8.0), pct=0.25)
              for t in (d.message, d.fix_hint or "")]
    bad = [t for t in texts if any(w in t for w in words)]
    assert not bad, bad


# -------------------------------------------------- engine schedules (GL1xx)
def _engine(m):
    return importlib.import_module(m.__name__ + ".engine")


def _trace_gl101_broken(e):
    v = e.new_variable()
    e.push(lambda: None, const_vars=[v], mutable_vars=[v])


def _trace_gl102_broken(e):
    v = e.new_variable()
    e.push(lambda: None, const_vars=[v])
    e.wait_for_var(v)


def _trace_gl103_broken(e):
    v = e.new_variable()
    e.push(lambda: None, mutable_vars=[v, v])


def _trace_gl104_broken(e):
    v = e.new_variable()
    e.push(lambda: None, const_vars=[v])  # read before any write
    e.push(lambda: None, mutable_vars=[v])


def _trace_clean(e):
    v, w = e.new_variable(), e.new_variable()
    e.push(lambda: None, mutable_vars=[v])
    e.push(lambda: None, const_vars=[v], mutable_vars=[w])
    e.push(lambda: None, const_vars=[v, w])
    e.wait_for_var(w)


ENGINE_CODE_CASES = {"GL101": _trace_gl101_broken, "GL102": _trace_gl102_broken,
                     "GL103": _trace_gl103_broken, "GL104": _trace_gl104_broken}


@pytest.mark.parametrize("code", sorted(ENGINE_CODE_CASES))
def test_engine_code_triggers_on_broken_schedule(mx, code):
    e = mx.analysis.RecordingEngine(_engine(mx).NaiveEngine())
    ENGINE_CODE_CASES[code](e)
    assert code in mx.analysis.analyze_trace(e.trace).codes()


@pytest.mark.parametrize("code", sorted(ENGINE_CODE_CASES) + ["GL105"])
def test_engine_code_silent_on_clean_schedule(mx, code):
    e = mx.analysis.RecordingEngine(_engine(mx)._PythonThreadedEngine(2), assert_discipline=True)
    _trace_clean(e)
    e.wait_for_all()
    assert code not in mx.analysis.analyze_trace(e.trace).codes()


def _no_discipline_engine(m):
    """Deliberately broken: every op on its own thread, the declared var
    sets ignored — what the shim exists to catch."""

    class NoDiscipline(_engine(m).Engine):
        def __init__(self):
            self._n, self._threads = 0, []

        def new_variable(self):
            self._n += 1
            return self._n

        def push(self, fn, const_vars=(), mutable_vars=()):
            def quiet():
                try:
                    fn()
                except Exception:
                    pass  # the shim raises; the trace records it

            t = threading.Thread(target=quiet)
            t.start()
            self._threads.append(t)

        def wait_for_var(self, var):
            self.wait_for_all()

        def wait_for_all(self):
            for t in self._threads:
                t.join()

    return NoDiscipline()


def test_gl105_runtime_shim_catches_broken_engine(mx):
    e = mx.analysis.RecordingEngine(_no_discipline_engine(mx), assert_discipline=True)
    v = e.new_variable()
    gate, started = threading.Event(), threading.Event()

    def first():
        started.set()
        gate.wait(5)

    e.push(first, mutable_vars=[v])
    assert started.wait(5)
    e.push(lambda: None, mutable_vars=[v])  # overlapping writer
    time.sleep(0.05)
    gate.set()
    e.wait_for_all()
    report = mx.analysis.analyze_trace(e.trace)
    assert "GL105" in report.codes()
    assert any("write-write" in d.message for d in report.by_code("GL105"))


def test_shipped_python_engine_passes_discipline_shim(mx):
    e = mx.analysis.RecordingEngine(_engine(mx)._PythonThreadedEngine(4), assert_discipline=True)
    vars_ = [e.new_variable() for _ in range(4)]
    for i in range(80):
        e.push(lambda: time.sleep(0.0005), mutable_vars=[vars_[i % 4]])
        e.push(lambda: None, const_vars=[vars_[i % 4]], mutable_vars=[vars_[(i + 1) % 4]])
    e.wait_for_all()
    assert not e.trace.violations
    assert "GL105" not in mx.analysis.analyze_trace(e.trace).codes()


@pytest.mark.parametrize("maker", ["naive", "threaded", "python"])
def test_wait_for_unknown_var_raises(mx, maker):
    eng = _engine(mx)
    e = {"naive": eng.NaiveEngine, "threaded": lambda: eng.ThreadedEngine(num_workers=2),
         "python": lambda: eng._PythonThreadedEngine(2)}[maker]()
    with pytest.raises(mx.MXNetError, match="unknown engine variable"):
        e.wait_for_var(987654321)
    v = e.new_variable()
    done = []
    e.push(lambda: done.append(1), mutable_vars=[v])
    e.wait_for_var(v)
    assert done == [1]


# ------------------------------------------------ dispatch discipline (GL7xx)
DISPATCH_SOURCES = {
    "GL701_broken": """
def greedy(dec, tok, n):
    for _ in range(n):
        logits = dec.decode_step(tok)
        tok = logits.asnumpy()
    return tok
""",
    "GL701_clean": """
def drain(dec, toks):
    outs = []
    for t in toks:
        outs.append(dec.decode_step(t))
    return outs[-1].asnumpy()
""",
    "GL702_broken": """
def decode(dec, tok, n):
    for _ in range(n):
        tok = dec.decode_step(tok)
    return tok
""",
    # the reference's fix: the loop state rides as the scan carry, one dispatch
    "GL702_clean": """
def decode(dec, tok, n):
    def megastep(carry, _):
        return dec.scan_body(carry), None
    final, _ = lax.scan(megastep, tok, None, length=n)
    return final
""",
    "GL703_broken": """
def pick(dec, x):
    logits = dec.decode_step(x)
    return np.argmax(logits, axis=-1)
""",
    "GL703_clean": """
def pick(dec, x):
    ids = dec.greedy_step(x)
    return ids
""",
    "GL703_waived": """
def pick(dec, x):
    logits = dec.decode_step(x)
    return np.argmax(logits, axis=-1)  # graphlint: waive GL703 -- acknowledged
""",
    "GL704_broken": """
def run2(a, b, x):
    ya = a.forward(x)
    out = ya.asnumpy()
    yb = b.forward(x)
    return out, yb.asnumpy()
""",
    "GL704_clean": """
def run2(a, b, x):
    ya = a.forward(x)
    yb = b.forward(x)
    return ya.asnumpy(), yb.asnumpy()
""",
}


def _dispatch_lint(m):
    return importlib.import_module(m.__name__ + ".analysis.dispatch_lint")


def _dl_codes(m, src):
    return {f.code for f in _dispatch_lint(m).lint_dispatch_source("<case>", text=src)}


def _gl705_rows(gap_ms):
    return [{"name": "serving.decode_step", "count": 10, "intervals": 9, "busy_ms": 10.0,
             "gap_ms": gap_ms, "max_gap_ms": gap_ms / 2.0, "clamped": 0}]


def _gl705_codes(m, gap_ms):
    return {d.code for d in _dispatch_lint(m).lint_dispatch_gaps(_gl705_rows(gap_ms), pct=0.25)}


DISPATCH_CODE_CASES = {
    **{code: (lambda m, c=code: _dl_codes(m, DISPATCH_SOURCES[c + "_broken"]),
              lambda m, c=code: _dl_codes(m, DISPATCH_SOURCES[c + "_clean"]))
       for code in ("GL701", "GL702", "GL703", "GL704")},
    # 8 ms host gap against 10 ms busy = 80% >> the 25% threshold; 1 ms = 10% is under
    "GL705": (lambda m: _gl705_codes(m, 8.0), lambda m: _gl705_codes(m, 1.0)),
}


@pytest.mark.parametrize("code", sorted(DISPATCH_CODE_CASES))
def test_dispatch_code_triggers_on_broken_source(mx, code):
    assert code in DISPATCH_CODE_CASES[code][0](mx)


@pytest.mark.parametrize("code", sorted(DISPATCH_CODE_CASES))
def test_dispatch_code_silent_on_clean_source(mx, code):
    assert code not in DISPATCH_CODE_CASES[code][1](mx)


def test_dispatch_waived_site_reported_but_not_failing(mx):
    dl = _dispatch_lint(mx)
    f = next(f for f in dl.lint_dispatch_source("<case>", text=DISPATCH_SOURCES["GL703_waived"])
             if f.code == "GL703")
    assert f.waived
    d = f.to_diagnostic()
    assert d.severity == "info" and d.message.endswith("[waived]")
    g = next(f for f in dl.lint_dispatch_source("<case>", text=DISPATCH_SOURCES["GL703_broken"])
             if f.code == "GL703")
    assert not g.waived and g.to_diagnostic().severity == "warning"


def test_dispatch_family_waiver_covers_every_gl7xx_code(mx):
    src = DISPATCH_SOURCES["GL701_broken"].replace(
        "tok = logits.asnumpy()", "tok = logits.asnumpy()  # graphlint: waive GL7xx -- family")
    findings = _dispatch_lint(mx).lint_dispatch_source("<case>", text=src)
    assert {f.line for f in findings if f.waived}, [f.to_dict() for f in findings]


def test_gl705_needs_two_intervals(mx):
    rows = _gl705_rows(8.0)
    rows[0]["intervals"] = 1
    assert not _dispatch_lint(mx).lint_dispatch_gaps(rows, pct=0.25)


def test_repo_dispatch_scan_flags_kv_decode_host_sync_sites(mx):
    """Each package's default scan (its own serving layer) flags the
    kv_decode host-sync sites: GL701 in both decoders' greedy loops, with
    file:line provenance."""
    report, sites = _dispatch_lint(mx).lint_dispatch_paths()
    kv = [s for s in sites if s["file"] == mx.__name__ + "/serving/kv_decode.py"
          and s["code"] == "GL701"]
    assert len(kv) >= 2, sites
    assert {s["function"] for s in kv} >= {"KVCacheDecoder.greedy", "PagedKVDecoder.greedy"}
    assert all(s["line"] > 0 and s["provenance"] for s in kv)


def test_graph_gl703_fires_on_tokenless_decode_symbol_only(mx):
    cfg = dict(vocab_size=64, num_layers=2, num_heads=2, model_dim=32, ffn_dim=64)
    B, S, H, dh = 2, 8, 2, 16
    sh = {"data": (B, 1), "pos_idx": (B, 1), "slot_onehot": (S,), "kv_mask": (S,)}
    for i in range(cfg["num_layers"]):
        sh["kv_k_%d" % i] = (B, H, S, dh)
        sh["kv_v_%d" % i] = (B, H, S, dh)
    tf = mx.models.transformer
    bare = tf.get_decode_symbol(max_len=S, pos_len=S, token_out=False, **cfg)
    assert "GL703" in _codes(mx, bare, shapes=sh)
    headed = tf.get_decode_symbol(max_len=S, pos_len=S, **cfg)
    assert "GL703" not in _codes(mx, headed, shapes=sh)


#: the port's pulls: each a broken loop of forward calls that fires GL701
PORT_PULLS = {
    "item": "y.item()", "cpu": "y.cpu()", "numpy": "y.numpy()",
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    "Event.synchronize": "done.synchronize()", "tolist": "y.tolist()",
}


@pytest.mark.parametrize("word", sorted(PORT_PULLS))
def test_gl701_fires_on_each_port_pull_in_a_loop_of_forward_calls(word):
    src = """
import torch

def loop(exe, x, n, done):
    for _ in range(n):
        y = exe.forward(x)
        x = %s
    return x
""" % PORT_PULLS[word]
    findings = pt.analysis.lint_dispatch_source("<case>", text=src)
    assert [(f.code, f.line) for f in findings if f.code == "GL701"] == [("GL701", 7)], \
        [f.to_dict() for f in findings]


def test_gl701_fires_on_a_pull_inside_a_loop_of_graph_replays():
    src = """
def loop(graph, out, n):
    for _ in range(n):
        graph.replay()
        tok = out.cpu()
    return tok
"""
    assert "GL701" in _dl_codes(pt, src)


def test_a_context_factory_is_not_a_pull():
    """``pt.cpu()``/``cpu()`` make a context; only a value's ``.cpu()`` is a
    copy to the host."""
    src = """
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import cpu

def loop(exe, x, n):
    for _ in range(n):
        y = exe.forward(x, ctx=pt.cpu())
        x = y + cpu(0).device_id
    return x
"""
    assert "GL701" not in _dl_codes(pt, src)


def test_gl704_fires_on_a_premature_cpu_copy():
    broken = """
def run2(a, b, x):
    ya = a.forward(x)
    out = ya.cpu()
    yb = b.forward(x)
    return out, yb.cpu()
"""
    clean = """
def run2(a, b, x):
    ya = a.forward(x)
    yb = b.forward(x)
    return ya.cpu(), yb.cpu()
"""
    assert "GL704" in _dl_codes(pt, broken)
    assert "GL704" not in _dl_codes(pt, clean)


# ------------------------------------------------------ concurrency (GL8xx)
CONCURRENCY_SOURCES = {
    "GL801_broken": """
import jax

def step(kv):
    if jax.process_index() == 0:
        kv.allreduce([1])
""",
    # guarding on world SIZE is rank-uniform: the correct idiom, not divergence
    "GL801_clean": """
import jax

def step(kv):
    if jax.process_count() > 1:
        kv.allreduce([1])
""",
    "GL802_broken": """
import threading

class Srv:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._t = threading.Thread(target=self._loop)

    def _loop(self):
        self.count += 1

    def bump(self):
        with self._lock:
            self.count += 1
""",
    "GL802_clean": """
import threading

class Srv:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._t = threading.Thread(target=self._loop)

    def _loop(self):
        with self._lock:
            self.count += 1

    def bump(self):
        with self._lock:
            self.count += 1
""",
    "GL803_broken": """
import threading

class Srv:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._b:
            with self._a:
                pass
""",
    "GL803_clean": """
import threading

class Srv:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._a:
            with self._b:
                pass
""",
    "GL804_broken": """
import threading

class Srv:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = None

    def drain(self):
        with self._lock:
            return self._q.get()
""",
    # cond.wait() on a condition backed by the held lock RELEASES it: exempt
    "GL804_clean": """
import threading

class Srv:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q = None

    def drain(self):
        with self._lock:
            self._cv.wait()
        return self._q.get()
""",
    "GL804_waived": """
import threading

class Srv:
    def __init__(self):
        self._lock = threading.Lock()
        self._q = None

    def drain(self):
        with self._lock:
            return self._q.get()  # graphlint: waive GL804 -- bounded producer
""",
}


def _concurrency_lint(m):
    return importlib.import_module(m.__name__ + ".analysis.concurrency_lint")


def _cl_codes(m, src):
    return {f.code for f in _concurrency_lint(m).lint_concurrency_source("<case>", text=src)}


def _gl805_codes(m, seam):
    witness = {"enabled": True, "threshold_ms": 50.0,
               "events": [{"kind": "long_hold", "lock": "serving.engine", "hold_ms": 80.0,
                           "threshold_ms": 50.0, "thread": "T", "dispatch_seam": seam}]}
    return {d.code for d in _concurrency_lint(m).lint_lock_witness(witness)}


CONCURRENCY_CODE_CASES = {
    **{code: (lambda m, c=code: _cl_codes(m, CONCURRENCY_SOURCES[c + "_broken"]),
              lambda m, c=code: _cl_codes(m, CONCURRENCY_SOURCES[c + "_clean"]))
       for code in ("GL801", "GL802", "GL803", "GL804")},
    # a >threshold hold ACROSS a dispatch seam fires; with no seam it does not
    "GL805": (lambda m: _gl805_codes(m, True), lambda m: _gl805_codes(m, False)),
}


@pytest.mark.parametrize("code", sorted(CONCURRENCY_CODE_CASES))
def test_concurrency_code_triggers_on_broken_source(mx, code):
    assert code in CONCURRENCY_CODE_CASES[code][0](mx)


@pytest.mark.parametrize("code", sorted(CONCURRENCY_CODE_CASES))
def test_concurrency_code_silent_on_clean_source(mx, code):
    assert code not in CONCURRENCY_CODE_CASES[code][1](mx)


def test_concurrency_waived_site_reported_but_not_failing(mx):
    cl = _concurrency_lint(mx)
    f = next(f for f in cl.lint_concurrency_source("<case>",
                                                   text=CONCURRENCY_SOURCES["GL804_waived"])
             if f.code == "GL804")
    assert f.waived
    d = f.to_diagnostic()
    assert d.severity == "info" and d.message.endswith("[waived]")
    g = next(f for f in cl.lint_concurrency_source("<case>",
                                                   text=CONCURRENCY_SOURCES["GL804_broken"])
             if f.code == "GL804")
    assert not g.waived and g.to_diagnostic().severity == "warning"


def test_concurrency_family_waiver_covers_every_gl8xx_code(mx):
    src = CONCURRENCY_SOURCES["GL801_broken"].replace(
        "kv.allreduce([1])", "kv.allreduce([1])  # graphlint: waive GL8xx -- family waiver")
    findings = _concurrency_lint(mx).lint_concurrency_source("<case>", text=src)
    assert {f.line for f in findings if f.waived}, [f.to_dict() for f in findings]


def test_gl801_except_handler_is_rank_varying(mx):
    src = """
def step(kv):
    try:
        risky()
    except Exception:
        kv._barrier()
"""
    assert "GL801" in _cl_codes(mx, src)


def test_gl801_provenance_names_the_divergent_read(mx):
    f = next(f for f in _concurrency_lint(mx).lint_concurrency_source(
        "<case>", text=CONCURRENCY_SOURCES["GL801_broken"]) if f.code == "GL801")
    assert any("process_index" in p for p in f.provenance), f.provenance


def test_repo_concurrency_scan_is_clean_or_waived(mx):
    """Each package's default scan of its own threaded and distributed
    sources: every finding fixed or waived, and the elastic pause path's
    protocol-level GL801 visible as a waived site."""
    report, sites = _concurrency_lint(mx).lint_concurrency_paths()
    unwaived = [s for s in sites if not s["waived"]]
    assert not unwaived, unwaived
    assert any(s["code"] == "GL801" and s["file"] == mx.__name__ + "/module/elastic.py"
               for s in sites), sites


#: the port's collectives (torch.distributed's and its own wrappers')
PORT_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object", "all_gather_into_tensor",
                    "broadcast", "broadcast_object_list", "reduce_scatter_tensor", "barrier",
                    "monitored_barrier", "send", "recv", "allgather_host", "_all_reduce_grads")


@pytest.mark.parametrize("name", PORT_COLLECTIVES)
def test_gl801_fires_on_each_port_collective_under_a_rank_branch(name):
    src = """
import torch
from mxnet_tpu_torch import dist

def step(t):
    if dist.rank() == 0:
        torch.distributed.%s(t)
""" % name
    findings = pt.analysis.concurrency_lint.lint_concurrency_source("<case>", text=src)
    assert [(f.code, f.line) for f in findings] == [("GL801", 7)], \
        [f.to_dict() for f in findings]


@pytest.mark.parametrize("guard", ["dist.rank() == 0", "dist.orig_rank() == 0",
                                   "torch.distributed.get_rank() == 0"])
def test_gl801_fires_on_all_reduce_under_each_rank_read(guard):
    src = """
import torch
from mxnet_tpu_torch import dist

def step(t):
    if %s:
        torch.distributed.all_reduce(t)
""" % guard
    assert "GL801" in _cl_codes(pt, src)


def test_gl801_silent_on_all_reduce_under_the_world_size():
    src = """
import torch
from mxnet_tpu_torch import dist

def step(t):
    if dist.num_workers() > 1:
        torch.distributed.all_reduce(t)
"""
    assert "GL801" not in _cl_codes(pt, src)


# ------------------------------------------------------------------ CLI
def _cli(m):
    return importlib.import_module(m.__name__ + ".analysis.cli")


def test_cli_mesh_resnet50_reshard_and_peak_table(mx, capsys):
    rc = _cli(mx).main(["resnet-50", "--shape", "data=32,3,224,224", "--mesh", "dp=8,model=2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "implicit reshard" in out and "moved per device" in out
    assert "predicted peak HBM per device" in out
    assert "params" in out and "activations" in out


def test_cli_mesh_summary_table_and_json_plan(mx, capsys):
    main = _cli(mx).main
    assert main(["mlp", "lenet", "--mesh", "dp=2"]) == 0
    assert "peak-HBM summary" in capsys.readouterr().out
    rc = main(["mlp", "--mesh", "dp=2", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    plan = payload[0]["memory_plan"]
    assert plan["mesh"] == {"dp": 2} and plan["per_device"]["peak"] > 0


def test_cli_bad_mesh_is_usage_error(mx):
    assert _cli(mx).main(["mlp", "--mesh", "dp8"]) == 2


def test_cli_single_model_clean(mx):
    assert _cli(mx).main(["mlp"]) == 0


def test_cli_list_codes(mx, capsys):
    assert _cli(mx).main(["--list-codes"]) == 0
    out = capsys.readouterr().out
    for code in mx.analysis.CODES:
        assert code in out


def test_cli_json_format_and_broken_symbol_file(mx, tmp_path, capsys):
    sym, _ = _build(mx, _gl006_broken)
    path = str(tmp_path / "broken-symbol.json")
    sym.save(path)
    rc = _cli(mx).main([path, "--shape", "data=2,3,8,8", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert any(d["code"] == "GL006" for entry in payload for d in entry["diagnostics"])


def test_cli_unknown_target_is_usage_error(mx):
    assert _cli(mx).main(["no-such-model"]) == 2


def test_cli_default_shapes_are_case_insensitive(mx, capsys):
    assert _cli(mx).main(["MLP"]) == 0
    assert "0 total finding(s)" in capsys.readouterr().out


def test_cli_strict_fails_on_warnings(mx):
    sym, _ = _build(mx, _gl202_broken)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "warn-symbol.json")
        sym.save(path)
        assert _cli(mx).main([path]) == 0
        assert _cli(mx).main([path, "--strict"]) == 1


def test_cli_all_models_sweep_exits_zero(mx):
    assert _cli(mx).main(["--all-models"]) == 0


def _payload(m, argv, capsys):
    """The CLI's exit code and JSON payload; the zoo's auto-named nodes
    counted from 0 (each package keeps its own name counter)."""
    capsys.readouterr()
    with m.name.NameManager():
        rc = _cli(m).main(argv)
    return rc, json.loads(capsys.readouterr().out)


def _as_reference_json(obj):
    """A port payload in the reference's words and paths."""
    text = json.dumps(obj, sort_keys=True).replace("mxnet_tpu_torch/", "mxnet_tpu/")
    for port, ref in PORT_WORDS:
        text = text.replace(json.dumps(port)[1:-1], json.dumps(ref)[1:-1])
    return json.loads(text)


CLI_JSON_ARGV = {
    "mlp": ["mlp", "--format", "json"],
    "resnet18_mesh": ["resnet-18", "--shape", "data=8,3,32,32", "--mesh", "dp=4,model=2",
                      "--budget-gb", "0.01", "--format", "json"],
    "zoo_inference": ["lenet", "transformer", "recommender", "--inference", "--bwd",
                      "recompute", "--format", "json"],
    "passes": ["mlp", "lenet", "--passes", "shape_lint,fusion_explain", "--format", "json"],
    "rewrite": ["transformer", "mlp", "--rewrite", "--format", "json"],
    "autoplan": ["resnet-50", "--autoplan", "--mesh-devices", "8", "--format", "json"],
}


@pytest.mark.parametrize("case", sorted(CLI_JSON_ARGV))
def test_cli_json_payloads_equal_the_references(case, jax_patterns, capsys):
    argv = CLI_JSON_ARGV[case]
    rc_ref, ref = _payload(mxnet_tpu, argv, capsys)
    rc_port, port = _payload(pt, argv, capsys)
    assert rc_port == rc_ref
    assert _as_reference_json(port) == json.loads(json.dumps(ref, sort_keys=True))


@pytest.mark.parametrize("mode", ["--dispatch", "--concurrency"])
def test_cli_source_lint_payloads_match_the_references(mode, capsys):
    """The source lints scan each package's own tree: the same codes in the
    same functions, waived alike, under the reference's paths."""
    rows, rcs, paths = [], [], []
    for m in (mxnet_tpu, pt):
        rc, payload = _payload(m, [mode, "--format", "json"], capsys)
        rcs.append(rc)
        # the reference's dispatch scan also reads its benches; the port's
        # tools loop over no dispatch (dispatch_lint.DEFAULT_SCAN_PATHS)
        paths.append([p for p in payload["paths"] if p.startswith(m.__name__ + "/")])
        rows.append(sorted((s["code"], s["file"].split("/", 1)[1], s["function"], s["waived"])
                           for s in payload["sites"]
                           if s["file"].startswith(m.__name__ + "/")))
    assert rcs[1] == rcs[0] == 0
    assert paths[1] == [p.replace("mxnet_tpu/", "mxnet_tpu_torch/", 1) for p in paths[0]]
    assert rows[1] == rows[0]


def test_cli_gl705_from_a_trace_dump(tmp_path, capsys):
    """``--dispatch --trace`` prices a chrome-trace dump: the gaps equal
    ``lint_dispatch_gaps(gap_summary(trace=dump))``, and a GL705 fails the
    run (exit 1) where the static sites are all waived."""
    from mxnet_tpu_torch.telemetry.trace import gap_summary

    events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 1, "args": {"name": "x"}}]
    for t in (0, 15000, 30000):  # 10 ms spans 5 ms apart: 10 ms of gap over 30 ms busy
        events.append({"name": "serving.decode_step", "ph": "X", "pid": 1, "tid": 1, "ts": t,
                       "dur": 10000})
    dump = tmp_path / "trace.json"
    dump.write_text(json.dumps({"traceEvents": events}))
    rc, payload = _payload(pt, ["--dispatch", "--trace", str(dump), "--format", "json"], capsys)
    want = pt.analysis.lint_dispatch_gaps(gap_summary(trace=json.loads(dump.read_text()),
                                                      top=1000))
    assert [d["code"] for d in payload["gaps"]] == ["GL705"] == [d.code for d in want]
    assert payload["gaps"] == [d.to_dict() for d in want]
    assert rc == 1


# ------------------------------------------- GL4xx/GL5xx acceptance cases
def test_missharded_symbol_fires_three_distinct_gl4xx_codes(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data=d, num_hidden=256, name="fc1")
    h = mx.sym.Activation(data=h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(data=h, num_hidden=8, name="fc2")
    odd = mx.sym.FullyConnected(data=mx.sym.Variable("aux_data"), num_hidden=999, name="oddfc")
    sym = mx.sym.Group([h, odd])
    report = _lint(mx, sym, shapes={"data": (3, 512), "aux_data": (4, 783)},
                   mesh="dp=2,model=2", target="missharded")
    fired = {c for c in report.codes() if c.startswith("GL4")}
    assert len(fired) >= 3 and {"GL401", "GL402", "GL404"} <= fired, report.format()


def test_clean_model_lints_clean_under_mesh_and_budget(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    report = _lint(mx, net, shapes={"data": (8, 784)}, mesh="dp=8", budget_gb=16.0,
                   target="mlp")
    assert report.codes() == [], report.format()
    assert report.memory_plan is not None and report.memory_plan["per_device"]["peak"] > 0


def test_memory_plan_structure_and_policies(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    sh = {"data": (32, 784)}
    stash = _lint(mx, net, shapes=sh).memory_plan
    rec = _lint(mx, net, shapes=sh, bwd="recompute").memory_plan
    inf = _lint(mx, net, shapes=sh, train=False).memory_plan
    pd = stash["per_device"]
    assert pd["peak"] == (pd["params"] + pd["grads"] + pd["opt_state"] + pd["inputs"]
                          + pd["act_peak"])
    assert pd["grads"] == pd["opt_state"] > 0
    assert rec["per_device"]["act_peak"] <= pd["act_peak"]
    assert inf["per_device"]["grads"] == inf["per_device"]["opt_state"] == 0
    assert inf["per_device"]["peak"] < pd["peak"]
    assert stash["peak_node"] and stash["peak_live"]
    dp = _lint(mx, net, shapes=sh, mesh="dp=8").memory_plan
    assert dp["per_device"]["act_peak"] < pd["act_peak"]
    assert dp["per_device"]["params"] == pd["params"]


def test_predicted_peak_within_2x_of_measured_live_buffers(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    shapes = {"data": (32, 784), "softmax_label": (32,)}
    pred = _lint(mx, net, shapes=shapes, target="mlp").memory_plan["per_device"]["peak"]
    with _on(mx):
        exe = net.simple_bind(ctx=mx.cpu(), **shapes)
        exe.forward(is_train=True)
        exe.backward()

    def nbytes(a):
        return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize

    measured = sum(nbytes(a) for a in exe.arg_arrays)
    measured += sum(nbytes(g) for g in exe.grad_arrays if g is not None)
    measured += sum(nbytes(a) for a in exe.aux_arrays)
    measured += sum(nbytes(o) for o in exe.outputs)
    assert measured / 2 <= pred <= measured * 2, (pred, measured)


def test_batch_one_keeps_batch_sharding_no_false_gl403(mx):
    net = mx.models.get_symbol("mlp", num_classes=10)
    report = _lint(mx, net, shapes={"data": (1, 784)}, mesh="dp=8,model=2", target="mlp-b1")
    assert "GL403" not in report.codes(), report.format()


def test_null_grad_req_bind_plans_inference(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    net = mx.models.get_symbol("mlp", num_classes=10)
    arg_shapes, _, _ = net.infer_shape(data=(8, 784))
    with _on(mx):
        args = {n: mx.nd.zeros(s) for n, s in zip(net.list_arguments(), arg_shapes)}
        grads = {n: mx.nd.zeros(s) for n, s in zip(net.list_arguments(), arg_shapes)}
    mx.telemetry.reset()
    net.bind(ctx=mx.cpu(), args=args, args_grad=grads, grad_req="write")
    train_peak = mx.telemetry.gauge("memlint.predicted_peak_bytes").value
    mx.telemetry.reset()
    net.bind(ctx=mx.cpu(), args=args, args_grad=grads, grad_req="null")
    inf_peak = mx.telemetry.gauge("memlint.predicted_peak_bytes").value
    assert inf_peak < train_peak, (inf_peak, train_peak)


def test_memory_plan_exports_telemetry_gauge(mx, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    mx.telemetry.reset()
    net = mx.models.get_symbol("mlp", num_classes=10)
    report = _lint(mx, net, shapes={"data": (8, 784)})
    g = mx.telemetry.gauge("memlint.predicted_peak_bytes")
    assert g.value == report.memory_plan["per_device"]["peak"]


def test_memlint_budget_env_var(mx, monkeypatch):
    monkeypatch.setenv("MXNET_MEMLINT_BUDGET_GB", "0.000001")
    sym, kw = _build(mx, _gl501_clean)
    assert "GL501" in _lint(mx, sym, shapes=kw["shapes"]).codes()
    monkeypatch.setenv("MXNET_MEMLINT_BUDGET_GB", "1000")
    assert "GL501" not in _codes(mx, sym, shapes=kw["shapes"])


def test_spmd_adapter_feeds_mesh_to_lint(mx, monkeypatch):
    """The fused step's bind lints with the REAL mesh and rules: the
    predicted peak lands on the gauge and reflects the dp=8 sharding."""
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    mx.telemetry.reset()
    net = mx.models.get_symbol("mlp", num_classes=10)
    with _on(mx):
        it = mx.io.NDArrayIter(np.zeros((16, 784), "float32"), np.zeros((16,), "float32"),
                               batch_size=16)
        mod = mx.mod.Module(net, context=[mx.cpu(i) for i in range(8)])
        mod.fit(it, num_epoch=1)
    assert mod._spmd is not None, "fused SPMD step did not engage"
    spmd_peak = mx.telemetry.gauge("memlint.predicted_peak_bytes").value
    assert spmd_peak and spmd_peak > 0
    single = _lint(mx, net, shapes={"data": (16, 784), "softmax_label": (16,)}).memory_plan
    assert single["per_device"]["act_peak"] > 0
    assert spmd_peak < single["per_device"]["peak"]


def test_spmd_adapter_lints_the_same_plan_in_both_packages(monkeypatch, caplog):
    """Under ``MXNET_GRAPHLINT=warn`` the fused step of a batch of 12 over
    eight devices logs the same GL404 (12 rows do not split 8 ways) and
    sets the same gauge value in both packages."""
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    peaks, lines = [], []
    for m in (mxnet_tpu, pt):
        m.telemetry.reset()
        caplog.clear()
        net = m.models.get_symbol("mlp", num_classes=10)
        with _on(m), caplog.at_level(logging.WARNING, logger="mxnet_tpu.graphlint"):
            it = m.io.NDArrayIter(np.zeros((16, 784), "float32"), np.zeros((16,), "float32"),
                                  batch_size=16)
            mod = m.mod.Module(net, context=[m.cpu(i) for i in range(8)])
            mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
            mod.init_params()
            mod.init_optimizer()
        assert mod._spmd is not None
        peaks.append(m.telemetry.gauge("memlint.predicted_peak_bytes").value)
        lines.append(sorted(r.getMessage() for r in caplog.records
                            if r.name == "mxnet_tpu.graphlint"))
    assert peaks[0] == peaks[1] > 0
    assert lines[0] == [_as_reference(line) for line in lines[1]]


# ----------------------------------------------------------- infer_meta
def test_infer_meta_registry(mx):
    infer_meta = importlib.import_module(mx.__name__ + ".ops.infer_meta")
    shape_rules = importlib.import_module(mx.__name__ + ".ops.shape_rules")
    conv = infer_meta.get_meta("Convolution")
    assert conv.input_ranks["data"] == (4, 4)
    assert "weight" in conv.param_slots
    assert infer_meta.backward_shape_rule("FullyConnected") \
        is shape_rules.RULES["FullyConnected"]
    default = infer_meta.get_meta("no_such_op")
    assert default.input_ranks == {} and default.param_slots == ()


def test_infer_meta_tables_equal_the_references():
    from mxnet_tpu.ops import infer_meta as jm
    from mxnet_tpu_torch.ops import infer_meta as pm

    assert pm.SHARD_RULES == jm.SHARD_RULES and pm.EMBEDDING_RULES == jm.EMBEDDING_RULES
    assert sorted(pm._META) == sorted(jm._META)
    for name, meta in jm._META.items():
        got = pm._META[name]
        for field in meta.__slots__:
            assert getattr(got, field) == getattr(meta, field), (name, field)


# ------------------------------------------------ bind-time modes
def test_bind_lint_error_mode_raises(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "error")
    sym, kw = _build(mx, _gl006_broken)
    with _on(mx), pytest.raises(mx.MXNetError, match="GL006"):
        sym.simple_bind(ctx=mx.cpu(), **kw["shapes"])


def test_bind_lint_error_mode_passes_clean_graph(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "error")
    net = mx.models.get_symbol("mlp", num_classes=10)
    with _on(mx):
        exe = net.simple_bind(ctx=mx.cpu(), data=(4, 784), softmax_label=(4,))
        assert exe.forward(is_train=False)[0].shape == (4, 10)


def test_bind_lint_warn_mode_logs_but_binds(mx, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_GRAPHLINT", "warn")
    x = mx.sym.Variable("x", dtype="float16")
    y = mx.sym.Variable("y", dtype="float32")
    with _on(mx), caplog.at_level("WARNING", logger="mxnet_tpu.graphlint"):
        exe = (x + y).simple_bind(ctx=mx.cpu(), x=(2,), y=(2,),
                                  type_dict={"x": "float16", "y": "float32"})
    assert exe is not None
    assert any("GL004" in r.message for r in caplog.records)


def test_bind_lint_off_by_default(mx, monkeypatch):
    monkeypatch.delenv("MXNET_GRAPHLINT", raising=False)
    assert mx.analysis.graphlint_mode() is None


def test_graphlint_mode_aliases_and_unknown(mx, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_GRAPHLINT", "1")
    assert mx.analysis.graphlint_mode() == "warn"
    monkeypatch.setenv("MXNET_GRAPHLINT", "bogus-%s" % mx.__name__)
    with caplog.at_level("WARNING", logger="mxnet_tpu.graphlint"):
        assert mx.analysis.graphlint_mode() is None
    assert any("not a recognized mode" in r.message for r in caplog.records)


def test_resnet_lints_clean_under_error_mode(mx, monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHLINT", "error")
    net = mx.models.get_symbol("resnet-18", num_classes=10, image_shape="3,32,32")
    with _on(mx):
        exe = net.simple_bind(ctx=mx.cpu(), data=(2, 3, 32, 32), softmax_label=(2,))
    assert exe is not None
    report = _lint(mx, net, shapes={"data": (2, 3, 32, 32)}, target="resnet-18")
    assert report.errors == [] and report.warnings == []


def test_unknown_pass_subset_raises(mx):
    sym, _ = _build(mx, _gl001_clean)
    with pytest.raises(ValueError, match="unknown analysis pass"):
        mx.analysis.lint(sym, passes=["shapelint"])


# ------------------------------------------------- rewrite verifier (GL6xx)
def _rw_codes(m, sym, passes=None, grad_req=None, max_rounds=None, shapes=None, types=None):
    res = m.analysis.rewrite(sym, shapes=shapes, types=types, passes=passes,
                             max_rounds=max_rounds)
    return set(m.analysis.verify_rewrite(res, grad_req=grad_req).codes())


def _broken_passes(m):
    """The reference's deliberately broken passes over ``m``'s RewritePass."""

    class Once(m.analysis.RewritePass):
        def __init__(self):
            self._done = False

        def run(self, g):
            if self._done:
                return 0
            self._done = True
            return self._fire(g)

    class ShapeBreaking(Once):
        name = "badshape"

        def _fire(self, g):
            node, oi = g.outputs[0]
            new = g.new_node("sum", node.name + "_collapsed", {}, [(node, oi)])
            g.outputs[0] = (new, 0)
            g.note(self.name, "collapse", "replace", node=new.name, origins=[node.name])
            g.invalidate()
            return 1

    class NoProvenance(Once):
        name = "noprov"

        def _fire(self, g):
            node, oi = g.outputs[0]
            new = g.new_node("_copy", node.name + "_id", {}, [(node, oi)])
            g.outputs[0] = (new, 0)
            g.invalidate()
            return 1

    class NeverConverges(m.analysis.RewritePass):
        name = "pingpong"

        def run(self, g):
            return 1

    class ArgDropping(Once):
        name = "argdrop"

        def _fire(self, g):
            arr = np.zeros((2,), "float32")
            lit = g.new_node("_graph_const", "lit", {"data": arr.tobytes(), "shape": (2,),
                                                     "dtype": "float32"}, [])
            g.outputs[0] = (lit, 0)
            g.note(self.name, "drop", "replace", node=lit.name, origins=[g.topo()[0].name])
            g.invalidate()
            return 1

    return {"shape": ShapeBreaking, "noprov": NoProvenance, "pingpong": NeverConverges,
            "argdrop": ArgDropping}


def _scalar_chain(m):
    return m.sym.Variable("x") * 2.0, {"shapes": {"x": (2,)}}


def _rw_case(m, code, broken):
    bp = _broken_passes(m)
    sym, kw = _scalar_chain(m)
    if code == "GL601":
        return _rw_codes(m, sym, passes=[bp["shape"]()], **kw) if broken \
            else _rw_codes(m, sym, **kw)
    if code == "GL602":
        if broken:
            return _rw_codes(m, sym, passes=[bp["noprov"]()], **kw)
        d = m.sym.Variable("data")
        return _rw_codes(m, m.sym.Activation(d * d, act_type="relu"), shapes={"data": (2, 3)})
    if code == "GL603":
        if broken:
            return _rw_codes(m, sym, passes=[bp["pingpong"]()], max_rounds=2, **kw)
        return _rw_codes(m, m.models.get_symbol("transformer", vocab_size=20, model_dim=16,
                                                num_heads=2, num_layers=1, ffn_dim=16,
                                                seq_len=4))
    if code == "GL604":
        return _rw_codes(m, sym, passes=[bp["argdrop"]()],
                         grad_req="write" if broken else "null", **kw)
    if broken:  # GL605: the summary fires whenever the pipeline changed anything
        a, b = m.sym.Variable("a"), m.sym.Variable("b")
        return _rw_codes(m, (a + b) * (a + b), shapes={"a": (2,), "b": (2,)})
    return _rw_codes(m, m.models.get_symbol("mlp", num_classes=10), shapes={"data": (2, 784)})


REWRITE_CODE_CASES = ("GL601", "GL602", "GL603", "GL604", "GL605")


@pytest.mark.parametrize("code", REWRITE_CODE_CASES)
def test_rewrite_code_triggers_on_broken_rewrite(mx, code):
    assert code in _rw_case(mx, code, True)


@pytest.mark.parametrize("code", REWRITE_CODE_CASES)
def test_rewrite_code_silent_on_clean_rewrite(mx, code):
    assert code not in _rw_case(mx, code, False)


@pytest.mark.parametrize("code", REWRITE_CODE_CASES)
def test_rewrite_codes_match_the_reference(code):
    with pt.cpu():
        port = [_rw_case(pt, code, b) for b in (True, False)]
    assert port == [_rw_case(mxnet_tpu, code, b) for b in (True, False)]


# ------------------------------------------------------------ sources
def test_package_sources_compile():
    """Every port source parses and compiles."""
    bad = []
    for path in sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")):
        try:
            compile(path.read_text(), str(path), "exec")
        except SyntaxError as exc:
            bad.append("%s: %s" % (path, exc))
    assert not bad, "\n".join(bad)


def test_pyflakes_clean_when_available():
    pytest.importorskip("pyflakes")
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "pyflakes", str(ROOT / "mxnet_tpu_torch")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
