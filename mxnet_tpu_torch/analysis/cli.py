"""The ``graphlint`` CLI of the port.

Copied from ``mxnet_tpu/analysis/cli.py`` (backend-free) but for its
surface names: it runs as ``python -m mxnet_tpu_torch.analysis.cli`` and
lints the port's zoo and sources. Like the reference's launcher
(``tools/graphlint``), it keeps lint off the accelerator: ``main`` runs
under ``cpu()``, and a lint, a rewrite dump or a plan allocates nothing on
the card.

Lints bundled model-zoo networks (by name) or serialized Symbol JSON files
(by path) with the full static-analysis pass suite and prints structured
diagnostics. Exit code: 0 clean, 1 findings at/above the failure severity
(error by default, warning with ``--strict``), 2 usage or load failure.

Examples::

    python -m mxnet_tpu_torch.analysis.cli resnet-18 --shape data=1,3,32,32
    python -m mxnet_tpu_torch.analysis.cli model-symbol.json --format json
    python -m mxnet_tpu_torch.analysis.cli --all-models
    python -m mxnet_tpu_torch.analysis.cli --list-codes
    python -m mxnet_tpu_torch.analysis.cli resnet-50 --shape data=32,3,224,224 \
        --mesh dp=8,model=2 --budget-gb 16   # sharding-plan + memory planner
    python -m mxnet_tpu_torch.analysis.cli transformer --rewrite   # GL6xx dump
    python -m mxnet_tpu_torch.analysis.cli resnet-50 --autoplan --mesh-devices 8
    python -m mxnet_tpu_torch.analysis.cli --dispatch          # GL7xx host-sync lint
    python -m mxnet_tpu_torch.analysis.cli --dispatch --trace profile.json  # + GL705
    python -m mxnet_tpu_torch.analysis.cli --concurrency       # GL8xx lock/collective lint
    python -m mxnet_tpu_torch.analysis.cli --concurrency --witness trace.json  # + GL805
"""
from __future__ import annotations

import argparse
import json
import sys

from .diagnostics import CODES, describe_code

# Default lint shapes/dtypes per zoo model: enough hints that the full
# shape/dtype propagation runs end to end (labels backward-derive via
# shape_rules where possible). Models without an entry lint structurally.
DEFAULT_SHAPES = {
    "lenet": {"data": (1, 1, 28, 28)},
    "mlp": {"data": (1, 784)},
    "alexnet": {"data": (1, 3, 224, 224)},
    "vgg": {"data": (1, 3, 224, 224)},
    "vgg16": {"data": (1, 3, 224, 224)},
    "vgg19": {"data": (1, 3, 224, 224)},
    "inception-bn": {"data": (1, 3, 224, 224)},
    "inception_bn": {"data": (1, 3, 224, 224)},
    "inception-v3": {"data": (1, 3, 299, 299)},
    "inception_v3": {"data": (1, 3, 299, 299)},
    "resnet": {"data": (1, 3, 224, 224)},
    "resnet-18": {"data": (1, 3, 224, 224)},
    "resnet-34": {"data": (1, 3, 224, 224)},
    "resnet-50": {"data": (1, 3, 224, 224)},
    "resnet-101": {"data": (1, 3, 224, 224)},
    "resnet-152": {"data": (1, 3, 224, 224)},
    "lstm": {"data": (32, 32), "softmax_label": (32, 32)},
    "transformer": {"data": (2, 64), "softmax_label": (2, 64)},
    "transformer_mt": {"data": (2, 64), "dec_data": (2, 64),
                       "softmax_label": (2, 64)},
    "vgg16-ssd-300": {"data": (1, 3, 300, 300)},
    "vgg16-ssd-300-train": {"data": (1, 3, 300, 300), "label": (1, 3, 5)},
    "recommender": {"user": (64,), "item": (64,), "dense": (64, 16),
                    "label": (64,)},
    "dlrm": {"user": (64,), "item": (64,), "dense": (64, 16),
             "label": (64,)},
}
DEFAULT_TYPES = {
    "lstm": {"data": "int32"},
    "transformer": {"data": "int32"},
    "transformer_mt": {"data": "int32", "dec_data": "int32"},
    "recommender": {"user": "int32", "item": "int32"},
    "dlrm": {"user": "int32", "item": "int32"},
}


def _parse_kv_shape(spec: str):
    if "=" not in spec:
        raise ValueError("--shape expects NAME=d0,d1,... got %r" % spec)
    name, dims = spec.split("=", 1)
    shape = tuple(int(x) for x in dims.strip("()[] ").split(",") if x.strip())
    return name.strip(), shape


def _parse_kv_type(spec: str):
    if "=" not in spec:
        raise ValueError("--type expects NAME=dtype, got %r" % spec)
    name, dt = spec.split("=", 1)
    return name.strip(), dt.strip()


def _zoo_sweep_names():
    """Deduped zoo keys for --all-models (aliases collapse to one entry)."""
    from ..models import _ZOO

    seen, names = set(), []
    for key in sorted(_ZOO):
        fn = _ZOO[key]
        marker = getattr(fn, "__wrapped__", None) or fn
        if id(marker) in seen:
            continue
        seen.add(id(marker))
        names.append(key)
    return names


def _load_target(name, shapes, types, use_defaults):
    """Resolve one CLI target to (label, symbol, shape_hints, type_hints)."""
    if name.endswith(".json"):
        from .. import symbol as sym_mod

        return name, sym_mod.load(name), dict(shapes), dict(types)
    from .. import models

    sym = models.get_symbol(name)
    key = name.lower()  # get_symbol lowercases; the shape table must too
    sh = dict(DEFAULT_SHAPES.get(key, {})) if use_defaults else {}
    ty = dict(DEFAULT_TYPES.get(key, {})) if use_defaults else {}
    sh.update(shapes)
    ty.update(types)
    return name, sym, sh, ty


def _format_plan(plan) -> str:
    """Human block for one target's memory plan: the per-device byte table
    plus the peak owner and its live set."""
    from .shard_lint import fmt_bytes

    pd = plan["per_device"]
    mesh = plan["mesh"]
    head = "-- predicted peak HBM per device: %s (%s, %s%s) --" % (
        fmt_bytes(pd["peak"]),
        "train/" + plan["policy"] if plan["train"] else "inference",
        "mesh " + ",".join("%s=%d" % kv for kv in mesh.items())
        if mesh else "single device",
        ", budget %s" % fmt_bytes(plan["budget_bytes"])
        if plan["budget_bytes"] else "")
    lines = [head]
    lines.append("   params %s | grads %s | opt %s | inputs %s | "
                 "activations %s"
                 % (fmt_bytes(pd["params"]), fmt_bytes(pd["grads"]),
                    fmt_bytes(pd["opt_state"]), fmt_bytes(pd["inputs"]),
                    fmt_bytes(pd["act_peak"])))
    lines.append("   peak at %s (%s); largest live: %s"
                 % (plan["peak_node"], plan["peak_phase"],
                    ", ".join("%s=%s" % (n, fmt_bytes(b))
                              for n, b in plan["peak_live"][:4]) or "-"))
    return "\n".join(lines)


def _format_peak_table(peaks) -> str:
    """The --all-models summary: one peak-HBM row per target."""
    from .shard_lint import fmt_bytes

    rows = [("model", "peak/device", "params", "activations", "peak node")]
    for label, plan in peaks:
        if plan is None:
            rows.append((label, "n/a (shapes underdetermined)", "-", "-", "-"))
            continue
        pd = plan["per_device"]
        rows.append((label, fmt_bytes(pd["peak"]), fmt_bytes(pd["params"]),
                     fmt_bytes(pd["act_peak"]), str(plan["peak_node"])))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = ["== peak-HBM summary =="]
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(out)


def _format_plan_table(rows) -> str:
    """The --autoplan --all-models summary: one plan row per target."""
    from .shard_lint import fmt_bytes

    table = [("model", "mesh", "pp", "comm/step", "peak/device", "verdict")]
    for label, plan, err in rows:
        if plan is None:
            table.append((label, "-", "-", "-", "-", "ERROR: %s" % err))
            continue
        mesh = ",".join("%s=%d" % kv for kv in plan.mesh.items())
        table.append((
            label, mesh,
            str(plan.pipeline_stages) if plan.pipeline_stages > 1 else "-",
            fmt_bytes(plan.predicted.get("comm_bytes", 0)),
            fmt_bytes(plan.predicted.get("peak_bytes", 0)),
            "ok" if plan.feasible else "INFEASIBLE"))
    widths = [max(len(r[i]) for r in table) for i in range(len(table[0]))]
    out = ["== autoplan summary =="]
    for r in table:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(out)


def _run_autoplan(args, targets, shapes, types, devices) -> int:
    """The --autoplan mode: plan every target, dump the ParallelPlans.

    Exit 0 when every target got a plan — feasible OR infeasible-with-a-
    structured-reason (the CI gate's contract); 1 when the planner itself
    failed on any target; 2 on load failures."""
    from ..parallel import autoplan

    rows = []
    load_failed = plan_failed = False
    for target in targets:
        try:
            label, sym, sh, ty = _load_target(
                target, shapes, types, not args.no_default_shapes)
        except Exception as exc:
            print("graphlint: cannot load %r: %s: %s"
                  % (target, type(exc).__name__, exc), file=sys.stderr)
            rows.append((target, None, "load: %s" % exc))
            load_failed = True
            continue
        try:
            plan = autoplan.plan_parallel(
                sym, sh, types=ty, devices=devices,
                budget_gb=args.budget_gb, bwd=args.bwd, label=label)
        except autoplan.PlanError as exc:
            rows.append((label, None, str(exc)))
            plan_failed = True
            continue
        rows.append((label, plan, None))

    if args.format == "json":
        payload = []
        for label, plan, err in rows:
            entry = {"target": label, "devices": devices}
            if plan is None:
                entry["plan_error"] = err
            else:
                entry["autoplan"] = plan.to_dict()
            payload.append(entry)
        print(json.dumps(payload, indent=2))
    else:
        for label, plan, err in rows:
            print("== autoplan: %s (%d devices) ==" % (label, devices))
            if plan is None:
                print("  planner failed: %s" % err)
                continue
            print("  " + plan.summary())
            if not plan.feasible:
                print("  reason: %s" % plan.reason)
            if plan.stage_cuts:
                print("  stage cuts: %s" % ", ".join(plan.stage_cuts))
            for rej in plan.rejected[:4]:
                mesh = ",".join("%s=%d" % kv for kv in rej["mesh"].items())
                print("  rejected mesh[%s]: %s" % (mesh, rej["why"]))
            print()
        if len(rows) > 1:
            print(_format_plan_table(rows))
    if load_failed:
        return 2
    return 1 if plan_failed else 0


def _format_rewrite(label, res, report, sites_before, sites_after) -> str:
    """Human block for one target's rewrite run: per-pass node-count table,
    fired-rule histogram, fusion-site delta, verifier outcome."""
    lines = ["== graphrewrite: %s ==" % label]
    lines.append("nodes %d -> %d (%d folded, %d merged, %d removed, "
                 "%d casts) rounds=%d fixpoint=%s"
                 % (res.nodes_before, res.nodes_after,
                    res.counts["folded"], res.counts["merged"],
                    res.counts["removed"], res.counts["casts"],
                    res.rounds, "yes" if res.fixpoint else "NO"))
    if res.pass_rows:
        rows = [("round", "pass", "fired", "nodes before", "nodes after")]
        for r in res.pass_rows:
            rows.append((str(r["round"]), r["pass"], str(r["fired"]),
                         str(r["nodes_before"]), str(r["nodes_after"])))
        widths = [max(len(x[i]) for x in rows) for i in range(5)]
        lines.extend("  " + "  ".join(c.ljust(w)
                                      for c, w in zip(r, widths)).rstrip()
                     for r in rows)
    rules = res.rule_table()
    if rules:
        lines.append("fired rules:")
        lines.extend("  %-32s %d" % (k, v) for k, v in sorted(rules.items()))
    if sites_before != sites_after:
        names = sorted(set(sites_before) | set(sites_after))
        lines.append("fusion sites: " + ", ".join(
            "%s %d -> %d" % (n, sites_before.get(n, 0), sites_after.get(n, 0))
            for n in names))
    if report is not None:
        bad = [d for d in report
               if d.code in ("GL601", "GL602", "GL603", "GL604")]
        if bad:
            lines.extend(d.format() for d in bad)
        else:
            lines.append("verify: clean (0 errors)")
        for d in report.by_code("GL605"):
            lines.append(d.format())
    return "\n".join(lines)


def _format_rewrite_table(rows) -> str:
    """The --rewrite --all-models summary: one rewrite row per target."""
    table = [("model", "nodes", "folded/merged/removed", "norm_residual",
              "verdict")]
    for label, res, report, sb, sa, err in rows:
        if res is None:
            table.append((label, "-", "-", "-", "ERROR: %s" % err))
            continue
        codes = sorted({d.code for d in report.errors}) if report else []
        table.append((
            label, "%d->%d" % (res.nodes_before, res.nodes_after),
            "%d/%d/%d" % (res.counts["folded"], res.counts["merged"],
                          res.counts["removed"]),
            "%d->%d" % (sb.get("norm_residual", 0),
                        sa.get("norm_residual", 0)),
            "ok" if not codes else ",".join(codes)))
    widths = [max(len(r[i]) for r in table) for i in range(len(table[0]))]
    out = ["== graphrewrite summary =="]
    for r in table:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(out)


def _run_rewrite(args, targets, shapes, types) -> int:
    """The --rewrite mode: rewrite every target (analysis/rewrite.py), run
    the GL6xx verifier, dump per-pass node counts + the fired-rule table +
    the fusion-site delta. ``--rewrite-json`` adds the full provenance
    record list to the JSON payload.

    Exit 0 when every target rewrites and verifies with zero
    GL601/GL602/GL604; 1 on any verifier error (or rewrite crash); 2 on
    load failure."""
    from . import verify_rewrite
    from .rewrite import pattern_site_counts, rewrite as run_rewrite

    rows, payload = [], []
    load_failed = verify_failed = False
    for target in targets:
        try:
            label, sym, sh, ty = _load_target(
                target, shapes, types, not args.no_default_shapes)
        except Exception as exc:
            print("graphlint: cannot load %r: %s: %s"
                  % (target, type(exc).__name__, exc), file=sys.stderr)
            rows.append((target, None, None, {}, {}, str(exc)))
            payload.append({"target": target, "load_error": str(exc)})
            load_failed = True
            continue
        try:
            res = run_rewrite(sym, shapes=sh, types=ty, label=label)
            report = verify_rewrite(res, target=label)
            sites_before = pattern_site_counts(sym)
            sites_after = pattern_site_counts(res.symbol)
        except Exception as exc:
            print("graphlint: rewrite of %r failed: %s: %s"
                  % (label, type(exc).__name__, exc), file=sys.stderr)
            rows.append((label, None, None, {}, {}, str(exc)))
            payload.append({"target": label, "rewrite_error": str(exc)})
            verify_failed = True
            continue
        if report.errors:
            verify_failed = True
        rows.append((label, res, report, sites_before, sites_after, None))
        entry = {"target": label, "rewrite": res.to_dict(),
                 "fusion_sites_before": sites_before,
                 "fusion_sites_after": sites_after,
                 "verify": json.loads(report.to_json())}
        if args.rewrite_json:
            entry["records"] = res.records
        payload.append(entry)
    if args.format == "json" or args.rewrite_json:
        print(json.dumps(payload, indent=2))
    else:
        for label, res, report, sb, sa, err in rows:
            if res is None:
                continue
            print(_format_rewrite(label, res, report, sb, sa))
            print()
        if len(rows) > 1:
            print(_format_rewrite_table(rows))
    if load_failed:
        return 2
    return 1 if verify_failed else 0


def _format_dispatch_table(sites) -> str:
    """The --dispatch per-site table: one row per finding, waiver column."""
    rows = [("code", "site", "function", "waived", "finding")]
    for s in sites:
        msg = s["message"]
        if len(msg) > 56:
            msg = msg[:53] + "..."
        rows.append((s["code"], "%s:%d" % (s["file"], s["line"]),
                     s["function"], "waived" if s["waived"] else "-", msg))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = ["== dispatch sites =="]
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(out)


def _run_dispatch(args, targets) -> int:
    """The --dispatch mode: the source-level dispatch-discipline lint
    (GL701-GL704, analysis/dispatch_lint.py) over Python files and
    directories instead of Symbol graphs. Targets are *paths*; with none
    given, the default scan surface is the serving hot paths plus the
    benches that drive them (``dispatch_lint.DEFAULT_SCAN_PATHS``).
    ``--trace DUMP.json`` additionally prices a telemetry capture: GL705
    for any span whose measured host gap exceeds
    ``MXNET_DISPATCHLINT_GAP_PCT`` of its device busy time.

    A finding acknowledged with ``# graphlint: waive GL70x -- reason``
    stays in the site table (column ``waived``) but does not fail the
    run. Exit 0 when every static finding is waived (or none) and no
    GL705 fired; 1 otherwise; 2 on an unreadable path or trace."""
    from .dispatch_lint import (DEFAULT_SCAN_PATHS, lint_dispatch_gaps,
                                lint_dispatch_paths)

    try:
        report, sites = lint_dispatch_paths(targets or None)
    except OSError as exc:
        print("graphlint: --dispatch: %s" % exc, file=sys.stderr)
        return 2
    gap_diags = []
    if args.trace:
        from ..telemetry.trace import gap_summary

        try:
            with open(args.trace) as f:
                trace = json.load(f)
        except (OSError, ValueError) as exc:
            print("graphlint: cannot load --trace %s: %s"
                  % (args.trace, exc), file=sys.stderr)
            return 2
        gap_diags = lint_dispatch_gaps(gap_summary(trace=trace, top=1000))
        report.extend(gap_diags)
    failed = any(not s["waived"] for s in sites) or bool(gap_diags)
    if args.format == "json":
        payload = {"target": "dispatch",
                   "paths": list(targets) or list(DEFAULT_SCAN_PATHS),
                   "sites": sites,
                   "gaps": [d.to_dict() for d in gap_diags],
                   "report": json.loads(report.to_json())}
        print(json.dumps(payload, indent=2))
    else:
        print(report.format(min_severity=args.min_severity))
        if sites:
            print()
            print(_format_dispatch_table(sites))
    return 1 if failed else 0


def _format_concurrency_table(sites) -> str:
    """The --concurrency per-site table: one row per finding."""
    rows = [("code", "site", "function", "waived", "finding")]
    for s in sites:
        msg = s["message"]
        if len(msg) > 56:
            msg = msg[:53] + "..."
        rows.append((s["code"], "%s:%d" % (s["file"], s["line"]),
                     s["function"], "waived" if s["waived"] else "-", msg))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = ["== concurrency sites =="]
    for r in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(out)


def _run_concurrency(args, targets) -> int:
    """The --concurrency mode: the source-level concurrency lint
    (GL801-GL804, analysis/concurrency_lint.py) over Python files and
    directories. Targets are *paths*; with none given, the default scan
    surface is the threaded/distributed layer
    (``concurrency_lint.DEFAULT_SCAN_PATHS``). ``--witness DUMP.json``
    additionally judges a ``MXNET_CONCLINT=witness`` run: GL805 for every
    witnessed lock-order inversion or >threshold hold across a dispatch
    seam (the dump is either a raw ``witness_report()`` JSON or a chrome
    trace whose ``otherData.lock_witness`` block carries one).

    Waivers (``# graphlint: waive GL80x -- reason``) stay in the site
    table but do not fail the run. Exit 0 when every static finding is
    waived (or none) and no GL805 fired; 1 otherwise; 2 on an unreadable
    path or witness dump."""
    from .concurrency_lint import (DEFAULT_SCAN_PATHS, lint_lock_witness,
                                   lint_concurrency_paths)

    try:
        report, sites = lint_concurrency_paths(targets or None)
    except OSError as exc:
        print("graphlint: --concurrency: %s" % exc, file=sys.stderr)
        return 2
    witness_diags = []
    if args.witness:
        try:
            with open(args.witness) as f:
                dump = json.load(f)
        except (OSError, ValueError) as exc:
            print("graphlint: cannot load --witness %s: %s"
                  % (args.witness, exc), file=sys.stderr)
            return 2
        if isinstance(dump.get("otherData"), dict):
            dump = dump["otherData"].get("lock_witness") or {}
        witness_diags = lint_lock_witness(dump)
        report.extend(witness_diags)
    failed = any(not s["waived"] for s in sites) or bool(witness_diags)
    if args.format == "json":
        payload = {"target": "concurrency",
                   "paths": list(targets) or list(DEFAULT_SCAN_PATHS),
                   "sites": sites,
                   "witness": [d.to_dict() for d in witness_diags],
                   "report": json.loads(report.to_json())}
        print(json.dumps(payload, indent=2))
    else:
        print(report.format(min_severity=args.min_severity))
        if sites:
            print()
            print(_format_concurrency_table(sites))
    return 1 if failed else 0


def main(argv=None) -> int:
    from ..context import cpu

    with cpu():  # a lint, a rewrite or a plan never allocates on the card
        return _main(argv)


def _main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="graphlint",
        description="Static graph lint for mxnet_tpu_torch Symbols "
                    "(shape/dtype propagation, retrace guard, fusion "
                    "explainer) and source lints of the port.")
    ap.add_argument("targets", nargs="*",
                    help="model-zoo names (e.g. resnet-18) or *-symbol.json paths")
    ap.add_argument("--all-models", action="store_true",
                    help="lint every bundled model in mxnet_tpu_torch/models/")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="NAME=d0,d1,...",
                    help="shape hint for an input (repeatable)")
    ap.add_argument("--type", action="append", default=[], dest="types",
                    metavar="NAME=dtype",
                    help="dtype hint for an input (repeatable)")
    ap.add_argument("--no-default-shapes", action="store_true",
                    help="lint structurally; skip the built-in per-model "
                         "default shape table")
    ap.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N...]",
                    help="abstract device mesh for the sharding-plan lint "
                         "(GL4xx) and per-device memory planning, e.g. "
                         "dp=8,model=2 — first axis is the batch axis, "
                         "'model' (or the second axis) the tensor axis")
    ap.add_argument("--rewrite", action="store_true",
                    help="run the Symbol->Symbol rewrite pipeline "
                         "(analysis/rewrite.py: const fold, CSE, "
                         "canonicalize, DCE) + the GL6xx provenance "
                         "verifier instead of the lint passes, and dump "
                         "per-pass node counts, the fired-rule table and "
                         "the fusion-site delta per target")
    ap.add_argument("--dispatch", action="store_true",
                    help="run the source-level dispatch-discipline lint "
                         "(GL7xx: host sync inside dispatch loops, "
                         "scan-able loops, host-side reductions, premature "
                         "pulls) over Python files/dirs instead of Symbol "
                         "graphs. Targets are paths; default: the serving "
                         "hot paths. Findings carry file:line provenance "
                         "and honor '# graphlint: waive GL70x -- reason' "
                         "comments")
    ap.add_argument("--trace", default=None, metavar="DUMP.json",
                    help="with --dispatch: also price a telemetry "
                         "chrome-trace dump — GL705 when a span's measured "
                         "host gap exceeds MXNET_DISPATCHLINT_GAP_PCT of "
                         "its device busy time")
    ap.add_argument("--concurrency", action="store_true",
                    help="run the source-level concurrency lint (GL8xx: "
                         "rank-divergent collectives, unguarded shared "
                         "state, lock-order inversions, blocking with a "
                         "lock held) over Python files/dirs instead of "
                         "Symbol graphs. Targets are paths; default: the "
                         "threaded/distributed surface. Findings honor "
                         "'# graphlint: waive GL80x -- reason' comments")
    ap.add_argument("--witness", default=None, metavar="DUMP.json",
                    help="with --concurrency: also judge a "
                         "MXNET_CONCLINT=witness run — GL805 for every "
                         "witnessed lock-order inversion or >threshold "
                         "hold across a dispatch seam (raw "
                         "witness_report() JSON or a chrome trace with an "
                         "otherData.lock_witness block)")
    ap.add_argument("--rewrite-json", action="store_true",
                    help="with --rewrite: emit the machine-readable plan "
                         "dump as JSON, including the full provenance "
                         "record list")
    ap.add_argument("--autoplan", action="store_true",
                    help="run the cost-model auto-parallel planner "
                         "(parallel.autoplan) instead of the lint passes: "
                         "search dp x tp x pp over --mesh-devices devices "
                         "and dump the winning ParallelPlan per target. "
                         "An infeasible plan "
                         "with a structured reason is a valid outcome "
                         "(exit 0); only a planner failure exits 1")
    ap.add_argument("--mesh-devices", type=int, default=None, metavar="N",
                    help="device count the --autoplan search factorizes "
                         "(defaults to the --mesh product when given)")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="peak-HBM budget per device in GiB, the unit the "
                         "peak tables print (GL501); default: the "
                         "MXNET_MEMLINT_BUDGET_GB env var")
    ap.add_argument("--bwd", choices=("stash", "recompute"), default="stash",
                    help="memory planner backward policy: stash every "
                         "activation (default, the no-remat executor) or "
                         "keep only matmul/conv outputs (remat='dots')")
    ap.add_argument("--inference", action="store_true",
                    help="plan memory without grads/optimizer state "
                         "(forward-only liveness)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--min-severity", choices=("info", "warning", "error"),
                    default="info", help="suppress findings below this level "
                                         "in text output")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail (exit 1)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset (default: all)")
    ap.add_argument("--list-codes", action="store_true",
                    help="print every diagnostic code and exit")
    args = ap.parse_args(argv)

    if args.list_codes:
        for code in sorted(CODES):
            print(describe_code(code))
        return 0

    if args.dispatch:
        return _run_dispatch(args, list(args.targets))

    if args.concurrency:
        return _run_concurrency(args, list(args.targets))

    targets = list(args.targets)
    if args.all_models:
        targets.extend(n for n in _zoo_sweep_names() if n not in targets)
    if not targets:
        ap.print_usage(sys.stderr)
        print("graphlint: no targets (give model names, JSON paths, or "
              "--all-models)", file=sys.stderr)
        return 2

    try:
        shapes = dict(_parse_kv_shape(s) for s in args.shape)
        types = dict(_parse_kv_type(s) for s in args.types)
    except ValueError as exc:
        print("graphlint: %s" % exc, file=sys.stderr)
        return 2
    mesh = None
    if args.mesh:
        from ..parallel.mesh import parse_mesh_spec

        try:
            mesh = parse_mesh_spec(args.mesh)
        except ValueError as exc:
            print("graphlint: %s" % exc, file=sys.stderr)
            return 2

    if args.rewrite or args.rewrite_json:
        return _run_rewrite(args, targets, shapes, types)

    if args.autoplan:
        devices = args.mesh_devices
        if devices is None and mesh is not None:
            devices = mesh.size
        if devices is None or devices < 1:
            print("graphlint: --autoplan needs --mesh-devices N (or --mesh)",
                  file=sys.stderr)
            return 2
        return _run_autoplan(args, targets, shapes, types, devices)

    from . import lint

    passes = args.passes.split(",") if args.passes else None
    failed = False
    load_failed = False
    json_out = []
    peaks = []  # (target, plan) rows for the --all-models summary table
    for target in targets:
        try:
            label, sym, sh, ty = _load_target(
                target, shapes, types, not args.no_default_shapes)
        except Exception as exc:
            # keep going: the other targets' reports (and, in json mode,
            # a machine-readable load_error entry) must still come out
            print("graphlint: cannot load %r: %s: %s"
                  % (target, type(exc).__name__, exc), file=sys.stderr)
            if args.format == "json":
                json_out.append({"target": target,
                                 "load_error": "%s: %s"
                                               % (type(exc).__name__, exc),
                                 "diagnostics": []})
            load_failed = True
            continue
        try:
            report = lint(sym, shapes=sh, types=ty, passes=passes,
                          target=label, mesh=mesh,
                          budget_gb=args.budget_gb, bwd=args.bwd,
                          train=not args.inference)
        except ValueError as exc:  # unknown --passes selection
            print("graphlint: %s" % exc, file=sys.stderr)
            return 2
        if not report.ok(strict=args.strict):
            failed = True
        peaks.append((label, report.memory_plan))
        if args.format == "json":
            json_out.append(json.loads(report.to_json()))
        else:
            print(report.format(min_severity=args.min_severity))
            if report.memory_plan is not None:
                print(_format_plan(report.memory_plan))
            print()
    if args.format == "json":
        print(json.dumps(json_out, indent=2))
    elif len(peaks) > 1:
        print(_format_peak_table(peaks))
    if load_failed:
        return 2
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
