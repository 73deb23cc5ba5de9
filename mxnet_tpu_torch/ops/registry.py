"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py`` with the same ``OpDef``
contract: every operator is a plain function ``fn(attrs, *inputs)`` over
torch tensors, and ``OpDef.apply`` returns ``(outputs_list, new_aux_list)``.
The transformer's serving and training paths register no op with aux
state, randomness or a train flag; the slots stay so later slices keep the
contract. Gradients come from torch autograd over the ops' functions, with
an autograd Function where the JAX package has a ``custom_vjp``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..base import MXNetError, np_dtype

__all__ = ["OpDef", "register", "get_op", "list_ops", "parse_attrs", "AttrSpec"]


class AttrSpec:
    """Declarative parameter field (reference: dmlc::Parameter / DMLC_DECLARE_FIELD)."""

    def __init__(self, typ, default=None, required=False, doc=""):
        self.typ = typ  # 'int'|'float'|'bool'|'str'|'shape'|'dtype'|'any'
        self.default = default
        self.required = required
        self.doc = doc

    def parse(self, value):
        if value is None:
            return None
        t = self.typ
        if t == "int":
            return int(value)
        if t == "float":
            return float(value)
        if t == "bool":
            if isinstance(value, str):
                return value.strip().lower() in ("true", "1")
            return bool(value)
        if t == "str":
            return str(value)
        if t == "shape":
            if isinstance(value, str):
                s = value.strip().lstrip("([").rstrip(")]")
                if not s:
                    return ()
                return tuple(int(float(x)) for x in s.replace("L", "").split(",") if x.strip())
            if isinstance(value, (int, np.integer)):
                return (int(value),)
            return tuple(int(v) for v in value)
        if t == "dtype":
            return np_dtype(value)
        return value


class OpDef:
    def __init__(self, name: str, fn: Callable, attrs: Optional[Dict[str, AttrSpec]] = None,
                 input_names=("data",), aux_names=(), num_outputs=1, output_names=None,
                 needs_rng: bool = False, needs_train_flag: bool = False,
                 aliases: Sequence[str] = (), doc: str = ""):
        self.name = name
        self.fn = fn
        self.attr_specs = attrs or {}
        # input_names/aux_names/num_outputs may be callables of parsed attrs
        self._input_names = input_names
        self._aux_names = aux_names
        self._num_outputs = num_outputs
        self._output_names = output_names
        self.needs_rng = needs_rng
        self.needs_train_flag = needs_train_flag
        self.aliases = tuple(aliases)
        self.doc = doc or (fn.__doc__ or "")

    def input_names(self, attrs) -> List[str]:
        n = self._input_names
        return list(n(attrs) if callable(n) else n)

    def aux_names(self, attrs) -> List[str]:
        n = self._aux_names
        return list(n(attrs) if callable(n) else n)

    def num_outputs(self, attrs) -> int:
        n = self._num_outputs
        return int(n(attrs) if callable(n) else n)

    def output_names(self, attrs) -> List[str]:
        if self._output_names is None:
            k = self.num_outputs(attrs)
            return ["output"] if k == 1 else ["output%d" % i for i in range(k)]
        n = self._output_names
        return list(n(attrs) if callable(n) else n)

    @property
    def has_aux(self) -> bool:
        if callable(self._aux_names):
            return True
        return len(self._aux_names) > 0

    def apply(self, attrs, inputs, aux=None, is_train=False, rng=None):
        """Run the op on torch tensors. Returns (outputs_list, new_aux_list)."""
        kwargs = {}
        if self.needs_train_flag:
            kwargs["is_train"] = is_train
        if self.needs_rng:
            kwargs["rng"] = rng
        if self.has_aux:
            out, new_aux = self.fn(attrs, list(inputs), list(aux or []), **kwargs)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            return outs, list(new_aux)
        out = self.fn(attrs, *inputs, **kwargs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return outs, []


_REGISTRY: Dict[str, OpDef] = {}
_CANONICAL: Dict[str, OpDef] = {}


def register(name, attrs=None, input_names=("data",), aux_names=(), num_outputs=1,
             output_names=None, needs_rng=False, needs_train_flag=False, aliases=()):
    """Decorator registering a torch function as a framework operator."""

    def _reg(fn):
        op = OpDef(name, fn, attrs=attrs, input_names=input_names, aux_names=aux_names,
                   num_outputs=num_outputs, output_names=output_names,
                   needs_rng=needs_rng, needs_train_flag=needs_train_flag,
                   aliases=aliases)
        if name in _REGISTRY:
            raise MXNetError("duplicate operator registration %r" % name)
        for a in aliases:
            if a in _REGISTRY:
                raise MXNetError("operator alias %r collides with existing op" % a)
        _CANONICAL[name] = op
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return _reg


def get_op(name: str) -> OpDef:
    if name not in _REGISTRY:
        raise MXNetError("operator %r is not registered" % name)
    return _REGISTRY[name]


def list_ops() -> List[str]:
    return sorted(_CANONICAL.keys())


def parse_attrs(op: OpDef, raw: dict) -> dict:
    """Parse raw kwargs/JSON-string attrs into typed python values using the
    op's AttrSpec table (the reference's dmlc::Parameter::Init)."""
    out = {}
    specs = op.attr_specs
    for k, v in (raw or {}).items():
        if k in ("name", "__proto__"):
            continue
        if k in specs:
            out[k] = specs[k].parse(v)
        else:
            out[k] = v  # unknown attrs kept verbatim (reference keeps __xxx__ attrs)
    for k, spec in specs.items():
        if k not in out:
            if spec.required:
                raise MXNetError("operator %s: required attribute %r missing" % (op.name, k))
            out[k] = spec.default
    return out
