"""Fusion-eligibility explainer (GL301/GL302/GL303).

Copied from ``mxnet_tpu/analysis/fusion_explain.py`` (backend-free), over
the port's ``fusion.plan``. The messages name what the port runs: the
hand-written conv+BN kernel (``csrc/conv_bn.cu``) on the fused path,
cuDNN (torch's convolution) on the library path.

``fusion.plan`` silently skips every subgraph it cannot rewrite — correct,
but invisible: a model author who expected the fused path has no way to
learn *which* predicate failed short of reading the planner. This pass
re-runs the plan and reports, for every rejected Convolution (GL301) and
every unfolded BatchNorm (GL302), the exact predicate, quoting
``fusion.conv_reject_reason`` / ``fusion.bn_reject_reason`` for op-level
predicates and re-deriving the consumer-structure predicates for fold
rejections.

GL303 covers the generic pattern engine (ops/fusion_patterns.py): for
every node a pattern ALMOST rooted (a FullyConnected whose consumer is not
a fusable Activation, a broadcast_add whose LayerNorm chain broke one link
deep, ...) it quotes the pattern's ``reject_reason``; for every planned
pattern root it reports the site inventory — the engage itself is a
per-shape bind-time decision (the fusion_tune measured verdict, whose
tuned-and-rejected reasons carry the measured fused-vs-baseline µs). On a
mesh with a ``seq`` axis > 1 every planned ``attention`` root that the
op's ring dispatch takes (``ops.attention.ring_takes``) is reported with
the gate's reason, which the reference's pass does not say.

All findings are INFO severity: an unfused graph is slower, not wrong.
"""
from __future__ import annotations

from .diagnostics import Diagnostic
from .manager import GraphContext, graph_pass

__all__ = ["fusion_explain"]


def _is_relu(node):
    return (node.op == "Activation"
            and node.parsed_attrs().get("act_type") == "relu")


def _explain_no_fold(ctx: GraphContext, node, directives):
    """Why an eligible BatchNorm's directive has fold=False — mirrors the
    consumer walk in fusion.plan, returning the failed predicate."""
    from .. import fusion

    output_ids = {id(n) for n, _ in ctx.symbol._outputs}
    if id(node) in output_ids:
        return ("its output is a program output and must materialize; the "
                "fold would save nothing")
    cons = ctx.consumers.get(id(node), [])
    if not cons:
        return "its output is a graph head; there is no consumer to fold into"
    bad_index = [c for c, oi in cons if oi != 0]
    if bad_index:
        return ("outputs other than the normalized activation are consumed "
                "(e.g. by %s)" % bad_index[0].name)
    targets = [c for c, _ in cons]
    src, src_desc = node, "the BN output"
    if len(targets) == 1 and _is_relu(targets[0]):
        relu = targets[0]
        relu_cons = ctx.consumers.get(id(relu), [])
        if any(oi != 0 for _, oi in relu_cons):
            return "the relu's secondary outputs are consumed"
        targets = [c for c, _ in relu_cons]
        src, src_desc = relu, "the relu(BN) output"
        if id(relu) in output_ids:
            return ("the relu output is a program output and must "
                    "materialize; the fold would save nothing")
        if not targets:
            return "the relu output is a graph head; nothing to fold into"
    for c in targets:
        d = directives.get(id(c))
        if d is None or d.get("kind") != "conv":
            reason = fusion.conv_reject_reason(c)
            return ("%s feeds %s(%s), which is not a fusable convolution: %s"
                    % (src_desc, c.name, c.op, reason))
        if not (c.inputs and c.inputs[0][0] is src):
            return ("%s feeds %s's weight input, not its data input"
                    % (src_desc, c.name))
    return "planner declined the fold (unmatched consumer pattern)"


@graph_pass("fusion_explain")
def fusion_explain(ctx: GraphContext):
    from .. import fusion

    diags = []
    # same output_ids the executor passes: the explained plan must be the
    # plan that actually runs (graph-output nodes are never folded/deferred)
    directives = fusion.plan(
        ctx.topo, output_ids={id(n) for n, _ in ctx.symbol._outputs})
    for node in ctx.topo:
        if node.is_variable:
            continue
        if node.op == "Convolution":
            reason = fusion.conv_reject_reason(node)
            if reason is not None:
                diags.append(Diagnostic(
                    "GL301",
                    "not eligible for the hand-written conv+BN kernel: %s"
                    % reason,
                    node=node.name, op=node.op,
                    fix_hint="this conv runs on cuDNN (torch's convolution); "
                             "see fusion.conv_reject_reason for the supported "
                             "shapes",
                ))
        elif node.op == "BatchNorm":
            reason = fusion.bn_reject_reason(node)
            if reason is not None:
                diags.append(Diagnostic(
                    "GL302",
                    "not eligible for fusion: %s" % reason,
                    node=node.name, op=node.op,
                ))
                continue
            d = directives.get(id(node))
            if d is not None and d.get("kind") == "bn" and not d.get("fold"):
                diags.append(Diagnostic(
                    "GL302",
                    "eligible but not folded: %s" % _explain_no_fold(ctx, node, directives),
                    node=node.name, op=node.op,
                    fix_hint="a fold needs every consumer of the BN(+relu) "
                             "output to be the data input of a fusable conv",
                ))
    diags.extend(_explain_patterns(ctx, directives))
    return diags


def _explain_patterns(ctx: GraphContext, directives):
    """GL303: NEAR-MISS rejections of the generic pattern engine — a node
    that almost rooted a pattern (e.g. a FullyConnected whose fusable
    Activation consumer is not its sole consumer) with the failed
    predicate. Deliberately quiet: a node that simply isn't a pattern's
    shape is not a finding (a clean model must lint clean), and the
    planned-site inventory lives on ``Report.memory_plan["fusion"]`` and
    the serving cache's ``fusion_sites()``, not here."""
    from .. import fusion
    from ..ops.fusion_patterns import get_patterns

    diags = []
    modes = fusion.enabled_patterns()
    pctx = fusion._PlanCtx(
        ctx.consumers, {id(n) for n, _ in ctx.symbol._outputs}, directives)
    from ..ops.attention import ring_takes

    def ring_site(node):
        # the gate's test at this site's shapes, where they infer
        q, k = (ctx.entry_shape.get((id(n), oi)) for n, oi in node.inputs[:2])
        return q is not None and k is not None and ring_takes(ctx.mesh, q, k) is not None

    for node in ctx.topo:
        d = directives.get(id(node))
        if ctx.mesh is not None and d is not None and d["kind"] == "pattern" \
                and d["pat"].name == "attention" and ring_site(node):
            # the gate's own reason: on this mesh the op's ring dispatch
            # runs the site, not the flash kernels
            diags.append(Diagnostic(
                "GL303",
                "planned 'attention' site declined on this mesh: %s" % fusion.MESH_REASON,
                node=node.name, op=node.op,
                fix_hint="MXNET_RING_ATTENTION=0 keeps the flash kernels on a seq mesh",
            ))
        if node.is_variable or d is not None:
            continue
        for pat in get_patterns():
            if modes.get(pat.name, "0") == "0":
                continue
            reason = pat.reject_reason(node, pctx)
            if reason is not None:
                diags.append(Diagnostic(
                    "GL303",
                    "not rooted by the %r pattern: %s" % (pat.name, reason),
                    node=node.name, op=node.op,
                    fix_hint="pattern matchers are structural; see "
                             "ops/fusion_patterns.py for the contract",
                ))
                break
    return diags
