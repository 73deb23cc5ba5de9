# copied from mxnet_tpu/attribute.py (backend-free)
"""Attribute scoping for symbol construction.

Counterpart of the reference's AttrScope (python/mxnet/attribute.py): a
thread-local ``with`` scope that stamps attributes (``__ctx_group__``,
``__lr_mult__``, ...) onto every symbol created inside it — the mechanism the
reference uses for model-parallel device placement and per-layer optimizer
multipliers.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    """``with mx.AttrScope(ctx_group='dev1'):`` — attrs applied to new symbols."""

    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes need to be strings")
        self._attr = {"__%s__" % k if not k.startswith("__") else k: v for k, v in kwargs.items()}

    def get(self, attr):
        """Merge scope attrs under explicitly-given ``attr`` dict."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = AttrScope.current()._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current() -> "AttrScope":
        cur = getattr(AttrScope._current, "value", None)
        if cur is None:
            cur = AttrScope()
            AttrScope._current.value = cur
        return cur
