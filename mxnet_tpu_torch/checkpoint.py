"""Atomic checkpoint writes, torn-file armour and keep-last-K retention.

Counterpart of the part of ``mxnet_tpu/checkpoint.py`` the ``Module.fit``
trunk calls: ``checkpoint_keep`` (:96), ``atomic_write_bytes`` (:145),
``atomic_replace`` (:170), ``load_ndarrays_checked`` (:191) and
``prefix_retention`` (:331). Every write is a temporary file and then
``os.replace``: a reader sees the old file or the new one, never a torn one.
The sharded asynchronous ``Checkpointer`` and its manifests come with data
parallelism (``ROADMAP.md`` §1.4); until then an optimizer-state file is
always one plain pickle, never a pointer to a shard set.
"""
from __future__ import annotations

import errno
import glob
import logging
import os
import re

from . import faultinject as _fi
from .base import MXNetError

__all__ = ["checkpoint_keep", "atomic_write_bytes", "atomic_replace", "load_ndarrays_checked",
           "prefix_retention"]

log = logging.getLogger(__name__)


# copied from mxnet_tpu/checkpoint.py (checkpoint_keep, atomic_write_bytes,
# atomic_replace, load_ndarrays_checked; backend-free)
def checkpoint_keep():
    """MXNET_CHECKPOINT_KEEP — keep-last-K retention for checkpoint sets;
    None (default) = unlimited."""
    raw = os.environ.get("MXNET_CHECKPOINT_KEEP", "")
    if not raw:
        return None
    try:
        k = int(raw)
        if k <= 0:
            raise ValueError(k)
        return k
    except ValueError:
        log.warning("MXNET_CHECKPOINT_KEEP=%r is not a positive int; "
                    "retention disabled", raw)
        return None


def atomic_write_bytes(path, data: bytes):
    """Write ``data`` to ``path`` atomically (temp + os.replace): readers see
    the old file or the new file, never a torn one.

    Fault-injection site ``checkpoint.write``: ``raise``/``delay_ms``/``hang``
    fire at entry; a ``torn_write`` plan persists only a prefix of the
    payload INTO THE TEMP FILE and raises ``OSError(EIO)``, the
    crash-mid-write shape. The final path is never torn."""
    _fi.fire("checkpoint.write")
    keep = _fi.torn_fraction("checkpoint.write")
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        f.write(data if keep is None else data[:int(len(data) * keep)])
        f.flush()
        os.fsync(f.fileno())
    if keep is not None:
        raise OSError(
            errno.EIO, "faultinject: torn write of %r (persisted %d of %d "
            "bytes into the temp file, then failed)"
            % (path, int(len(data) * keep), len(data)))
    os.replace(tmp, path)


def atomic_replace(path):
    """Context manager handing out a temp path that is os.replace'd onto
    ``path`` on clean exit and unlinked on error."""
    class _Ctx:
        def __enter__(self_):
            self_.tmp = "%s.tmp.%d" % (path, os.getpid())
            return self_.tmp

        def __exit__(self_, et, ev, tb):
            if et is None:
                os.replace(self_.tmp, path)
            else:
                try:
                    os.unlink(self_.tmp)
                except OSError:
                    pass
            return False

    return _Ctx()


def load_ndarrays_checked(path):
    """``nd.load`` with torn-file armour: any deserialization failure raises
    a structured MXNetError naming the offending path. The arrays load onto
    ``current_context()``."""
    from . import ndarray as nd

    try:
        return nd.load(path)
    except MXNetError as e:
        raise MXNetError(
            "checkpoint file %r is corrupt or not an NDArray file (%s) — "
            "likely a torn write from a crash mid-save; delete it and resume "
            "from the previous checkpoint" % (path, e)) from e
    except Exception as e:
        raise MXNetError(
            "checkpoint file %r is truncated or corrupt (%s: %s) — likely a "
            "torn write from a crash mid-save; delete it and resume from the "
            "previous checkpoint" % (path, type(e).__name__, e)) from e


def prefix_retention(prefix, keep):
    """Keep-last-K for ``<prefix>-NNNN.params``/``.states`` epoch
    checkpoints (``callback.module_checkpoint``). The newest epoch whose
    params file exists is never deleted, even when older than the window
    (JAX :331, whose sharded ``.states`` pointers the port does not write)."""
    if keep is None:
        return []
    epochs = []
    for path in glob.glob(glob.escape(prefix) + "-*.params"):
        m = re.search(r"-(\d{4,})\.params$", path)
        if m:
            epochs.append(int(m.group(1)))
    epochs.sort()
    if len(epochs) <= keep:
        return []
    newest_complete = next((ep for ep in reversed(epochs)
                            if os.path.exists("%s-%04d.params" % (prefix, ep))), None)
    victims = [ep for ep in epochs[:-keep] if ep != newest_complete]
    for ep in victims:
        for suffix in (".params", ".states"):
            try:
                os.unlink("%s-%04d%s" % (prefix, ep, suffix))
            except OSError:
                continue
        log.info("checkpoint retention: dropped epoch %d of %r (keep=%d)", ep, prefix, keep)
    return victims
