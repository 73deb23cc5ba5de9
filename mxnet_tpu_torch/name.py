"""Automatic symbol naming.

A copy of ``mxnet_tpu/name.py`` (backend-free): a thread-local stack of
managers hands out unique names per op type ("fullyconnected0", ...), so the
port's graphs get the same node names, and the same JSON, as the JAX
package's for the same constructor calls.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager"]


class NameManager:
    """Hands out unique auto-names per hint; usable as a ``with`` scope."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """Return ``name`` if given, else a fresh auto-name for ``hint``."""
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager

    @staticmethod
    def current() -> "NameManager":
        cur = getattr(NameManager._current, "value", None)
        if cur is None:
            cur = NameManager()
            NameManager._current.value = cur
        return cur

