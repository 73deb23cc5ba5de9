"""The port's lock witness (``telemetry/lockwitness.py``) and its GL805 wiring
(``analysis/concurrency_lint.py``, the CLI's ``--witness``, the bind-time
``concurrency_lint`` pass) held against the JAX package's.

Every case of the reference's ``tests/test_concurrency_lint.py`` runs on both
packages (fixture ``P``: the package's ``lockwitness``,
``lint_lock_witness``, ``trace.build_trace``, ``telemetry.cli`` and
``analysis.cli``): the mode gate, the seeded two-thread races the witness
must catch, its statistics and primitives, and the witness -> trace ->
mxtrace/graphlint plumbing. A completeness check holds that every reference
case is mirrored here, and the GL805 findings of the same seeded runs are the
same in both packages.
"""
import ast
import importlib
import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import mxnet_tpu
import mxnet_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _pkg(m):
    name = m.__name__
    return SimpleNamespace(
        m=m, lw=importlib.import_module(name + ".telemetry.lockwitness"),
        lint_lock_witness=importlib.import_module(
            name + ".analysis.concurrency_lint").lint_lock_witness,
        build_trace=importlib.import_module(name + ".telemetry.trace").build_trace,
        locks_table=importlib.import_module(name + ".telemetry.cli").locks_table,
        main=importlib.import_module(name + ".analysis.cli").main)


@pytest.fixture(params=["jax", "port"])
def P(request):
    return _pkg(mxnet_tpu if request.param == "jax" else mxnet_tpu_torch)


@pytest.fixture
def witness(P):
    P.lw.set_mode("witness")
    P.lw.reset_witness()
    yield P.lw
    P.lw.set_mode(None)
    P.lw.reset_witness()


# ------------------------------------------------------------- mode gate
def test_off_mode_returns_plain_primitives(P, monkeypatch):
    lw = P.lw
    monkeypatch.delenv("MXNET_CONCLINT", raising=False)
    lw.set_mode(None)
    assert not lw.witnessing()
    assert isinstance(lw.named_lock("x"), type(threading.Lock()))
    assert isinstance(lw.named_rlock("x"), type(threading.RLock()))
    assert isinstance(lw.named_condition("x"), threading.Condition)


def test_env_arms_witness(P, monkeypatch):
    lw = P.lw
    lw.set_mode(None)
    monkeypatch.setenv("MXNET_CONCLINT", "witness")
    assert lw.witnessing()
    monkeypatch.setenv("MXNET_CONCLINT", "off")
    assert not lw.witnessing()


# ------------------------------------------- seeded races (the acceptance)
def _seeded_inversion(lw, first="repro.a", second="repro.b"):
    """T1 takes a->b, T2 takes b->a after T1 is done: sequenced, no actual
    deadlock, but the order inversion is there to witness."""
    a, b = lw.named_lock(first), lw.named_lock(second)
    t1_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        t1_done.set()

    def t2():
        t1_done.wait(5.0)
        with b:
            with a:
                pass

    th1, th2 = threading.Thread(target=t1, name="t1"), threading.Thread(target=t2, name="t2")
    th1.start()
    th2.start()
    th1.join(5.0)
    th2.join(5.0)


def test_witness_catches_seeded_two_thread_inversion(P, witness):
    _seeded_inversion(witness)
    rep = witness.witness_report()
    inv = [e for e in rep["events"] if e["kind"] == "inversion"]
    assert inv, rep["events"]
    assert {inv[0]["first"], inv[0]["then"]} == {"repro.a", "repro.b"}
    diags = P.lint_lock_witness(rep)
    assert [d.code for d in diags] == ["GL805"]
    assert "inversion" in diags[0].message


def test_witness_long_hold_across_dispatch_seam(P, witness, monkeypatch):
    monkeypatch.setenv("MXNET_CONCLINT_HOLD_MS", "5")
    lk = witness.named_lock("repro.hold")
    with lk:
        witness.note_dispatch()
        time.sleep(0.02)
    rep = witness.witness_report()
    holds = [e for e in rep["events"] if e["kind"] == "long_hold"]
    assert holds and holds[0]["dispatch_seam"]
    assert [d.code for d in P.lint_lock_witness(rep)] == ["GL805"]


def test_long_hold_without_seam_is_not_gl805(P, witness, monkeypatch):
    monkeypatch.setenv("MXNET_CONCLINT_HOLD_MS", "5")
    lk = witness.named_lock("repro.hostwork")
    with lk:
        time.sleep(0.02)
    rep = witness.witness_report()
    holds = [e for e in rep["events"] if e["kind"] == "long_hold"]
    assert holds and not holds[0]["dispatch_seam"]
    assert P.lint_lock_witness(rep) == []


def test_same_order_twice_is_not_an_inversion(P, witness):
    a, b = witness.named_lock("ok.a"), witness.named_lock("ok.b")
    for _ in range(2):
        with a:
            with b:
                pass
    rep = witness.witness_report()
    assert not [e for e in rep["events"] if e["kind"] == "inversion"]
    assert P.lint_lock_witness(rep) == []


# ----------------------------------------------------- stats / primitives
def test_contention_and_hold_stats(witness):
    lk = witness.named_lock("stats.l")
    started, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            started.set()
            release.wait(5.0)

    th = threading.Thread(target=holder)
    th.start()
    started.wait(5.0)
    if lk.acquire(timeout=0.05):  # contended probe
        lk.release()
    release.set()
    th.join(5.0)
    with lk:
        pass
    row = next(r for r in witness.witness_report()["locks"] if r["name"] == "stats.l")
    assert row["acquisitions"] >= 2
    assert row["contentions"] >= 1
    assert row["hold_ms"] >= 0.0
    assert len(row["threads"]) >= 2


def test_witness_rlock_reentrancy(witness):
    rl = witness.named_rlock("re.l")
    with rl:
        with rl:
            assert rl._is_owned()
    row = next(r for r in witness.witness_report()["locks"] if r["name"] == "re.l")
    assert row["acquisitions"] == 1  # the reentrant acquire is not a second one


def test_witness_condition_wait_notify(witness):
    lk = witness.named_lock("cv.l")
    cv = witness.named_condition("cv.l", lk)
    fired = []

    def waiter():
        with lk:
            while not fired:
                if not cv.wait(5.0):
                    return

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.01)
    with lk:
        fired.append(1)
        cv.notify_all()
    th.join(5.0)
    assert not th.is_alive()


def test_reset_witness_clears_everything(witness):
    with witness.named_lock("reset.l"):
        pass
    witness.reset_witness()
    rep = witness.witness_report()
    assert rep["locks"] == [] and rep["events"] == []


# ------------------------------------------------------------- plumbing
def test_trace_embeds_lock_witness_block(P, witness):
    with witness.named_lock("trace.l"):
        pass
    block = P.build_trace()["otherData"]["lock_witness"]
    assert block["enabled"]
    assert any(r["name"] == "trace.l" for r in block["locks"])


def test_mxtrace_locks_table_renders(P, witness):
    with witness.named_lock("tbl.l"):
        pass
    out = P.locks_table(P.build_trace())
    assert "tbl.l" in out and "hold_ms" in out
    assert "MXNET_CONCLINT" in P.locks_table({"otherData": {}})


def test_graphlint_witness_flag_judges_a_dump(P, witness, tmp_path, capsys):
    a, b = witness.named_lock("cli.a"), witness.named_lock("cli.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    dump = tmp_path / "trace.json"
    dump.write_text(json.dumps(P.build_trace()))
    empty = tmp_path / "empty"
    empty.mkdir()
    rc = P.main(["--concurrency", "--witness", str(dump), "--format", "json", str(empty)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1  # the target dir has no .py files; the witness GL805 alone fails it
    assert [d["code"] for d in out["witness"]] == ["GL805"]


def test_bindtime_pass_surfaces_gl805_when_witnessing(P, witness, monkeypatch):
    monkeypatch.setenv("MXNET_CONCLINT_HOLD_MS", "5")
    lk = witness.named_lock("pass.l")
    with lk:
        witness.note_dispatch()
        time.sleep(0.02)
    net = P.m.models.get_symbol("mlp", num_classes=10)
    report = P.m.analysis.lint(net, shapes={"data": (8, 784)}, passes=["concurrency_lint"],
                               target="witness")
    assert "GL805" in report.codes()
    witness.set_mode(None)  # off-witness the pass is silent whatever was recorded
    report = P.m.analysis.lint(net, shapes={"data": (8, 784)}, passes=["concurrency_lint"],
                               target="off")
    assert report.codes() == []


# --------------------------------------------------------- against JAX
def test_seeded_witness_findings_equal_the_references(monkeypatch):
    """The same seeded inversion and seam-crossing hold give the same GL805
    findings (code, node, message but the measured hold) in both packages,
    through ``lint_lock_witness`` and through the bind-time pass."""
    monkeypatch.setenv("MXNET_CONCLINT_HOLD_MS", "5")
    rows = []
    for m in (mxnet_tpu, mxnet_tpu_torch):
        P = _pkg(m)
        P.lw.set_mode("witness")
        P.lw.reset_witness()
        try:
            _seeded_inversion(P.lw, "eq.a", "eq.b")
            with P.lw.named_lock("eq.hold"):
                P.lw.note_dispatch()
                time.sleep(0.02)
            direct = P.lint_lock_witness(P.lw.witness_report())
            net = m.models.get_symbol("mlp", num_classes=10)
            bound = list(m.analysis.lint(net, shapes={"data": (8, 784)},
                                         passes=["concurrency_lint"]))
        finally:
            P.lw.set_mode(None)
            P.lw.reset_witness()
        rows.append([(d.code, d.node, d.message.split(" held ")[0]) for d in direct])
        assert [(d.code, d.node) for d in bound] == [r[:2] for r in rows[-1]]
    assert rows[0] == rows[1]
    assert sorted(r[0] for r in rows[1]) == ["GL805", "GL805"]


def test_every_reference_case_is_mirrored():
    ref = {n.name for n in ast.parse((ROOT / "tests" / "test_concurrency_lint.py").read_text()).body
           if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    here = {n for n in globals() if n.startswith("test_")}
    assert len(ref) == 14 and ref <= here, sorted(ref - here)
