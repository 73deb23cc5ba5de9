"""Symbol: declarative graph composition.

Counterpart of ``mxnet_tpu/symbol.py``: a Symbol is a Python DAG over the
op registry, with the reference's ``*-symbol.json`` format, so the same
constructor calls give the same JSON in both packages. Shape inference
runs each op's torch function on the ``meta`` device (the JAX package uses
``jax.eval_shape``); parameter shapes that flow backward from the data
come from ``ops/shape_rules.py``. A variable that feeds an op's aux slot
(BatchNorm's moving mean and variance) is an auxiliary state, listed by
``list_auxiliary_states`` and not by ``list_arguments``.
"""
from __future__ import annotations

import builtins
import functools
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .attribute import AttrScope
from .base import MXNetError, np_dtype, numpy_dtype, torch_dtype
from .context import current_context
from .name import NameManager
from .ops import registry as _registry
from .ops.registry import get_op, parse_attrs
from .ops.shape_rules import RULES as _SHAPE_RULES

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json", "pow", "maximum",
           "minimum"]


class _Node:
    """One graph node: an operator application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "_parsed")

    def __init__(self, op: Optional[str], name: str, attrs: dict, inputs):
        self.op = op  # canonical registry name, or None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)  # list[(node, out_index)]
        self._parsed = None

    @property
    def is_variable(self):
        return self.op is None

    def parsed_attrs(self) -> dict:
        if self._parsed is None:
            self._parsed = parse_attrs(get_op(self.op), self.attrs) if self.op else {}
        return self._parsed

    def opdef(self):
        return get_op(self.op)

    def num_outputs(self) -> int:
        if self.op is None:
            return 1
        return self.opdef().num_outputs(self.parsed_attrs())


def _aux_positions(node: _Node) -> int:
    """Number of trailing inputs of ``node`` that are aux states."""
    if node.op is None:
        return 0
    return len(node.opdef().aux_names(node.parsed_attrs()))


def _topo_order(head_nodes) -> List[_Node]:
    """Iterative post-order DFS preserving input order (nnvm DFSVisit)."""
    order: List[_Node] = []
    visited = set()
    stack = [(n, False) for n in reversed(head_nodes)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in visited:
            continue
        if expanded:
            visited.add(id(node))
            order.append(node)
        else:
            stack.append((node, True))
            for inp, _ in reversed(node.inputs):
                if id(inp) not in visited:
                    stack.append((inp, False))
    return order


def _freeze(attrs: dict):
    """A hashable form of parsed attrs (copied from mxnet_tpu/symbol.py)."""
    def fr(v):
        if isinstance(v, (list, tuple)):
            return tuple(fr(x) for x in v)
        if isinstance(v, np.dtype):
            return v.name
        return v

    return tuple(sorted((k, fr(v)) for k, v in attrs.items()))


class _IncompleteInference(MXNetError):
    pass


class Symbol:
    """A list of output entries over the graph (reference: nnvm Symbol)."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list[(node, out_index)]

    @property
    def name(self):
        if len(self._outputs) != 1:
            return None
        return self._outputs[0][0].name

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "Grouped")

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __getitem__(self, index):
        """One output (or a slice of them) by position or by its name in
        ``list_outputs()``."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("cannot find output %r in %s" % (index, names))
            index = names.index(index)
        # builtins: the module-level op functions shadow names like `slice`
        if isinstance(index, builtins.slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def get_internals(self) -> "Symbol":
        """All intermediate outputs as a grouped symbol (reference:
        symbol.py get_internals)."""
        return Symbol([(node, i) for node in self._topo() for i in range(node.num_outputs())])

    def _head_nodes(self):
        seen, heads = set(), []
        for node, _ in self._outputs:
            if id(node) not in seen:
                seen.add(id(node))
                heads.append(node)
        return heads

    def _topo(self) -> List[_Node]:
        return _topo_order(self._head_nodes())

    def _classified_variables(self):
        """Topo-ordered (args, auxs) variable node lists. A variable feeding an
        aux slot of any consumer is an auxiliary state (copied from
        mxnet_tpu/symbol.py :130)."""
        topo = self._topo()
        aux_vars = set()
        for node in topo:
            n_aux = _aux_positions(node)
            if n_aux:
                for inp, _ in node.inputs[len(node.inputs) - n_aux:]:
                    if inp.is_variable:
                        aux_vars.add(id(inp))
        args, auxs = [], []
        for node in topo:
            if node.is_variable:
                (auxs if id(node) in aux_vars else args).append(node)
        return args, auxs

    def list_arguments(self) -> List[str]:
        """Argument names in topological order, aux states left out."""
        return [n.name for n in self._classified_variables()[0]]

    def list_auxiliary_states(self) -> List[str]:
        """Aux state names (BatchNorm's moving stats) in topological order."""
        return [n.name for n in self._classified_variables()[1]]

    def list_inputs(self) -> List[str]:
        """Every variable, arguments and aux states, in topological order."""
        return [n.name for n in self._topo() if n.is_variable]

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of the head nodes as one grouped symbol, or None."""
        outs = []
        for node in self._head_nodes():
            outs.extend(node.inputs)
        return Symbol(outs) if outs else None

    # ------------------------------------------------------------------ attrs
    def attr(self, key):
        if len(self._outputs) != 1:
            raise MXNetError("attr() requires a single-output symbol")
        v = self._outputs[0][0].attrs.get(key)
        return None if v is None else str(v)

    def list_attr(self):
        if len(self._outputs) != 1:
            raise MXNetError("list_attr() requires a single-output symbol")
        return {k: str(v) for k, v in self._outputs[0][0].attrs.items()}

    def attr_dict(self):
        return {n.name: {k: str(v) for k, v in n.attrs.items()} for n in self._topo() if n.attrs}

    def list_outputs(self) -> List[str]:
        out = []
        for node, idx in self._outputs:
            if node.is_variable:
                out.append(node.name)
            else:
                out.append("%s_%s" % (node.name, node.opdef().output_names(node.parsed_attrs())[idx]))
        return out

    # -------------------------------------------------------------- arithmetic
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(op, [a, b], {})
        return _create(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_rdiv_scalar", reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        if isinstance(other, Symbol):
            return _create("_power", [self, other], {})
        return _create("_power_scalar", [self], {"scalar": float(other)})

    def __neg__(self):
        return _create("negative", [self], {})

    # comparisons build graph nodes, as in the reference; identity hashing
    # keeps symbols usable as dict keys
    def __eq__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binary(other, "_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binary(other, "_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, other):
        return self._binary(other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # -------------------------------------------------------------- inference
    def _resolve_kwargs_shapes(self, args, kwargs):
        """Shape hints by name from positional shapes (in argument order)
        and keywords."""
        known = {}
        for name, sh in zip(self.list_arguments(), args):
            if sh is not None:
                known[name] = tuple(sh)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)
        return known

    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from input shapes, given in
        argument order or by name; (None, None, None) when they leave some
        argument undetermined."""
        try:
            return self._infer_impl(self._resolve_kwargs_shapes(args, kwargs), {})[:3]
        except _IncompleteInference:
            return None, None, None

    def infer_shape_partial(self, *args, **kwargs):
        """As ``infer_shape``, with None for whatever stays undetermined."""
        return self._infer_impl(self._resolve_kwargs_shapes(args, kwargs), {},
                                partial=True)[:3]

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) from input dtypes, given in
        argument order or by name; needs no shapes (JAX :317)."""
        known = {}
        for name, t in zip(self.list_arguments(), args):
            if t is not None:
                known[name] = np_dtype(t)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = np_dtype(v)
        res = self._infer_impl({}, known, partial=True)
        return res[3], res[4], res[5]

    def _infer_impl(self, shape_hints: dict, type_hints: dict, partial: bool = False):
        """Shapes and dtypes of every argument, output and aux state:
        ``(arg_shapes, out_shapes, aux_shapes, arg_types, out_types,
        aux_types)``. With ``partial`` an undetermined shape is None and the
        dtypes still propagate (JAX :333)."""
        topo = self._topo()
        args, auxs = self._classified_variables()
        shape: Dict[Tuple[int, int], Optional[tuple]] = {}
        dtype: Dict[Tuple[int, int], np.dtype] = {}
        var_shape: Dict[str, Optional[tuple]] = {}
        var_dtype: Dict[str, Optional[np.dtype]] = {}
        for node in topo:
            if node.is_variable:
                sh = shape_hints.get(node.name)
                if sh is None and "__shape__" in node.attrs:
                    sh = _parse_shape_attr(node.attrs["__shape__"])
                dt = type_hints.get(node.name)
                if dt is None and "__dtype__" in node.attrs:
                    dt = np_dtype(node.attrs["__dtype__"])
                var_shape[node.name] = tuple(sh) if sh is not None else None
                var_dtype[node.name] = None if dt is None else np.dtype(dt)
        for node in topo:
            if node.is_variable:
                shape[(id(node), 0)] = var_shape[node.name]
                if var_dtype[node.name] is not None:
                    dtype[(id(node), 0)] = var_dtype[node.name]
                continue
            parsed = node.parsed_attrs()
            entries = [(id(n), i) for n, i in node.inputs]
            in_shapes = [shape.get(e) for e in entries]
            rule = _SHAPE_RULES.get(node.op)
            if rule is not None and any(s is None for s in in_shapes):
                filled = rule(parsed, list(in_shapes))
                for (inp, out_i), old, new in zip(node.inputs, in_shapes, filled):
                    if old is None and new is not None:
                        new = tuple(int(x) for x in new)
                        shape[(id(inp), out_i)] = new
                        if inp.is_variable:
                            var_shape[inp.name] = new
                in_shapes = [shape.get(e) for e in entries]
            if any(s is None for s in in_shapes):
                if partial:
                    # shapes unknown: still propagate dtypes by promotion
                    # (the inputs take the promotion of the KNOWN input
                    # dtypes, never a dtype-forcing op's output dtype)
                    known_in = [d for d in (dtype.get(e) for e in entries) if d is not None]
                    promo = np.dtype(np.result_type(*known_in)) if known_in else None
                    for inp, _ in node.inputs:
                        if inp.is_variable and var_dtype.get(inp.name) is None \
                                and promo is not None:
                            var_dtype[inp.name] = promo
                            dtype[(id(inp), 0)] = promo
                    dt = _fallback_dtype(parsed, known_in)
                    for i in range(node.num_outputs()):
                        shape[(id(node), i)] = None
                        dtype[(id(node), i)] = dt
                    continue
                missing = [node.inputs[i][0].name for i, s in enumerate(in_shapes)
                           if s is None and node.inputs[i][0].is_variable]
                raise _IncompleteInference("cannot infer shapes at node %r (op %s): "
                                           "unknown inputs %s" % (node.name, node.op, missing))
            in_dtypes = []
            for inp, out_i in node.inputs:
                d = dtype.get((id(inp), out_i))
                if d is None:  # unknown dtypes default to float32, as in the reference
                    d = var_dtype.get(inp.name) if inp.is_variable else None
                    d = np.dtype(np.float32) if d is None else d
                    if inp.is_variable:
                        var_dtype[inp.name] = d
                        dtype[(id(inp), 0)] = d
                in_dtypes.append(d)
            outs = _eval_node_shape(node.op, _freeze(parsed), tuple(in_shapes),
                                    tuple(d.name for d in in_dtypes), _aux_positions(node))
            for i, (sh, dt) in enumerate(outs[: node.num_outputs()]):
                shape[(id(node), i)] = sh
                dtype[(id(node), i)] = np.dtype(dt)
        arg_shapes = [var_shape.get(n.name) for n in args]
        aux_shapes = [var_shape.get(n.name) for n in auxs]
        if not partial and any(s is None for s in arg_shapes + aux_shapes):
            raise _IncompleteInference("underdetermined shapes for arguments %s"
                                       % [n.name for n in args + auxs
                                          if var_shape.get(n.name) is None])
        arg_types = [var_dtype.get(n.name) or np.dtype(np.float32) for n in args]
        aux_types = [var_dtype.get(n.name) or np.dtype(np.float32) for n in auxs]
        out_shapes = [shape.get((id(n), i)) for n, i in self._outputs]
        out_types = [dtype.get((id(n), i), var_dtype.get(n.name)) or np.dtype(np.float32)
                     for n, i in self._outputs]
        return arg_shapes, out_shapes, aux_shapes, arg_types, out_types, aux_types

    # --------------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None, group2ctx=None,
                    **kwargs):
        """Allocate every argument (and its gradient, where grad_req is not
        null) from the given input shapes and bind; ``ctx=None`` is
        ``current_context()``, the GPU."""
        from .executor import simple_bind as _sb

        return _sb(self, ctx or current_context(), grad_req=grad_req, type_dict=type_dict,
                   group2ctx=group2ctx, **kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write", aux_states=None,
             group2ctx=None, shared_exec=None):
        from .executor import bind as _bind

        return _bind(self, ctx, args, args_grad=args_grad, grad_req=grad_req,
                     aux_states=aux_states, shared_exec=shared_exec, group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        """One-shot inference forward on NDArray keyword inputs."""
        return self.bind(ctx or current_context(), kwargs).forward(is_train=False)

    # ------------------------------------------------------------------ JSON
    def tojson(self) -> str:
        topo = self._topo()
        ids = {id(n): i for i, n in enumerate(topo)}
        nodes, arg_nodes, row_ptr = [], [], [0]
        for n in topo:
            entry = {"op": n.op if n.op else "null", "name": n.name,
                     "inputs": [[ids[id(inp)], oi, 0] for inp, oi in n.inputs]}
            if n.attrs:
                entry["attr"] = {k: str(v) for k, v in n.attrs.items()}
            nodes.append(entry)
            if n.op is None:
                arg_nodes.append(ids[id(n)])
            row_ptr.append(row_ptr[-1] + n.num_outputs())
        graph = {"nodes": nodes, "arg_nodes": arg_nodes, "node_row_ptr": row_ptr,
                 "heads": [[ids[id(n)], i, 0] for n, i in self._outputs],
                 "attrs": {"mxnet_version": ["int", 905]}}
        return json.dumps(graph, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self) -> str:
        lines = []
        for n in self._topo():
            if n.is_variable:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (inp.name, oi) for inp, oi in n.inputs)
                lines.append("Op:%s, Name=%s\nInputs:\n\t%s" % (n.op, n.name, ins))
        return "\n".join(lines)


def _fallback_dtype(parsed, known):
    """The dtype of a node whose shapes are unknown (copied from
    mxnet_tpu/symbol.py ``_fallback_dtype``): its declared ``dtype`` attr
    (Cast, the creation ops) or the numpy promotion of its known inputs."""
    if isinstance(parsed.get("dtype"), (np.dtype, type, str)):
        try:
            return np.dtype(np_dtype(parsed["dtype"]))
        except TypeError:
            pass
    if not known:
        return np.dtype(np.float32)
    return np.dtype(np.result_type(*known))


def _parse_shape_attr(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    s = str(v).strip().lstrip("([").rstrip(")]")
    if not s:
        return ()
    return tuple(int(float(x)) for x in s.split(",") if x.strip())


@functools.lru_cache(maxsize=16384)
def _eval_node_shape(op_name, attrs_key, in_shapes, in_dtypes, n_aux):
    """Run one op on ``meta`` tensors: its output shapes and dtypes, no data.
    The last ``n_aux`` inputs are its aux states."""
    ins = [torch.empty(s, dtype=torch_dtype(d), device="meta")
           for s, d in zip(in_shapes, in_dtypes)]
    n_in = len(ins) - n_aux
    outs, _ = get_op(op_name).apply(dict(attrs_key), ins[:n_in], aux=ins[n_in:])
    return tuple((tuple(int(x) for x in o.shape), numpy_dtype(o.dtype).name) for o in outs)


# ----------------------------------------------------------------- creation
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None, init=None,
             **kwargs) -> Symbol:
    """Create a named variable placeholder (reference: symbol.py Variable).
    The optional settings go into its JSON attrs as the reference writes
    them: ``__shape__``, ``__lr_mult__``, ``__wd_mult__``, ``__dtype__``,
    ``__init__`` and any other ``__key__`` keyword."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = dict(AttrScope.current().get(attr) or {})
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        attr["__dtype__"] = np.dtype(np_dtype(dtype)).name
    if init is not None:
        attr["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            attr[k] = str(v)
        else:
            raise ValueError("Attribute name=%s is not supported." % k)
    return Symbol([(_Node(None, name, attr, []), 0)])


var = Variable


def Group(symbols) -> Symbol:
    """Group symbols into one multi-output symbol (reference: symbol.py Group)."""
    outputs = []
    for s in symbols:
        if not isinstance(s, Symbol):
            raise TypeError("Group: expected Symbol, got %r" % (s,))
        outputs.extend(s._outputs)
    return Symbol(outputs)


def _single_outputs(op_name, input_syms):
    inputs = []
    for s in input_syms:
        if len(s._outputs) != 1:
            raise MXNetError("op %s: input symbols must have a single output" % op_name)
        inputs.append(s._outputs[0])
    return inputs


def _create(op_name, input_syms, attrs, name=None, attr=None) -> Symbol:
    """Create an op node over single-output input symbols; the AttrScope's
    attrs (and ``attr``) go onto the node, as in the reference."""
    opdef = get_op(op_name)
    parsed = parse_attrs(opdef, attrs)
    name = NameManager.current().get(name, opdef.name.lower().lstrip("_") or opdef.name.lower())
    node_attrs = dict(attrs)
    node_attrs.update(AttrScope.current().get(attr))
    node = _Node(opdef.name, name, node_attrs, _single_outputs(op_name, input_syms))
    return Symbol([(node, i) for i in range(opdef.num_outputs(parsed))])


def _make_symbol_function(op_name):
    opdef = get_op(op_name)

    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_kwargs, attrs = {}, {}
        for a in args:
            if not isinstance(a, Symbol):
                raise TypeError("%s: positional args must be Symbols; use kwargs for attrs"
                                % op_name)
        for k, v in kwargs.items():
            (sym_kwargs if isinstance(v, Symbol) else attrs)[k] = v
        if "num_args" in opdef.attr_specs and "num_args" not in attrs:
            attrs["num_args"] = len(args) + len(sym_kwargs)  # as mxnet_tpu/symbol.py:624
        parsed = parse_attrs(opdef, attrs)
        slots = opdef.input_names(parsed) + opdef.aux_names(parsed)
        name = NameManager.current().get(name, opdef.name.lower().lstrip("_") or opdef.name.lower())
        if len(args) > len(slots):
            raise MXNetError("%s: too many positional inputs (%d given, expects %s)"
                             % (op_name, len(args), slots))
        filled: Dict[str, Symbol] = dict(zip(slots, args))
        for k, v in sym_kwargs.items():
            if k not in slots:
                raise MXNetError("%s: unknown tensor input %r (expects %s)" % (op_name, k, slots))
            if k in filled:
                raise MXNetError("%s: input %r given twice" % (op_name, k))
            filled[k] = v
        # omitted named inputs become new variables "<name>_<slot>" (reference behavior)
        input_syms = [filled[s] if s in filled else Variable("%s_%s" % (name, s)) for s in slots]
        node_attrs = dict(attrs)
        node_attrs.update(AttrScope.current().get(attr))
        node = _Node(opdef.name, name, node_attrs, _single_outputs(op_name, input_syms))
        return Symbol([(node, i) for i in range(opdef.num_outputs(parsed))])

    creator.__name__ = op_name
    creator.__doc__ = opdef.doc
    return creator


# -------------------------------------------------------------------- JSON load
def load_json(json_str: str) -> Symbol:
    """Rebuild a Symbol from nnvm graph JSON (reference format)."""
    graph = json.loads(json_str)
    built: List[_Node] = []
    for nj in graph["nodes"]:
        op = nj["op"]
        attrs = nj.get("attr") or nj.get("attrs") or nj.get("param") or {}
        inputs = [(built[e[0]], e[1]) for e in nj.get("inputs", [])]
        built.append(_Node(None if op == "null" else get_op(op).name, nj["name"], attrs, inputs))
    heads = graph.get("heads") or [[len(built) - 1, 0, 0]]
    return Symbol([(built[h[0]], h[1]) for h in heads])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def fromjson(json_str: str) -> Symbol:
    return load_json(json_str)


def pow(base, exp):
    if isinstance(base, Symbol) and isinstance(exp, Symbol):
        return _create("_power", [base, exp], {})
    if isinstance(base, Symbol):
        return base.__pow__(exp)
    if isinstance(exp, Symbol):
        return _create("_rpower_scalar", [exp], {"scalar": float(base)})
    raise TypeError("pow: need at least one Symbol")


def maximum(left, right):
    if isinstance(left, Symbol) and isinstance(right, Symbol):
        return _create("_maximum", [left, right], {})
    if isinstance(left, Symbol):
        return _create("_maximum_scalar", [left], {"scalar": float(right)})
    return _create("_maximum_scalar", [right], {"scalar": float(left)})


def minimum(left, right):
    if isinstance(left, Symbol) and isinstance(right, Symbol):
        return _create("_minimum", [left, right], {})
    if isinstance(left, Symbol):
        return _create("_minimum_scalar", [left], {"scalar": float(right)})
    return _create("_minimum_scalar", [right], {"scalar": float(left)})


def _init_symbol_module():
    mod = sys.modules[__name__]
    for name in list(_registry._REGISTRY.keys()):
        if not hasattr(mod, name):
            setattr(mod, name, _make_symbol_function(name))


_init_symbol_module()
