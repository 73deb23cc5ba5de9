# copied from mxnet_tpu/serving/fleet/rpc.py (backend-free)
"""Minimal framed RPC for the serving fleet (docs/SERVING.md §Fleet).

One replica process = one ``RpcServer`` wrapping its ``InferenceEngine``;
the router and supervisor talk to it through ``RpcClient``. The protocol
is deliberately tiny: a 4-byte big-endian length prefix followed by a
pickled ``{"method": str, "kw": dict}`` request and a pickled
``{"ok": bool, "result"| "error"}`` response over a loopback TCP socket.
Pickle is acceptable here — and ONLY here — because both ends are the
same codebase run by the same user on the same host (the server binds
127.0.0.1 exclusively); numpy arrays ride through with zero translation
layers, and structured serving errors (``ServeOverloadError`` with its
``retry_after_ms``, ``ServeDeadlineError``) arrive on the router side as
the same exception types the in-process engine raises.

Failure semantics are the part that matters for the fleet: any socket
error (peer died, connection refused, recv timeout) surfaces as
``RpcConnectionError`` — the router's signal to mark the replica suspect
and RE-DISPATCH the in-flight request elsewhere. A request is therefore
never lost to a replica death; at-most-once execution is NOT promised
(inference is idempotent, so replay is safe), which is exactly the
trade the re-dispatch path wants.

Observability plane (docs/OBSERVABILITY.md §Fleet): every ``call()``
carries the caller's trace context in a ``trace`` field on the request
frame; the server installs it thread-local around the handler so replica
spans inherit the router-minted ``trace_id`` with no per-handler
plumbing. Each connection also measures the peer's wall-clock offset on
connect (and again after every reconnect) with the midpoint method —
``offset = server_wall - (send + recv) / 2``, median over a few round
trips — which ``telemetry.merge_traces`` uses to align per-process
chrome dumps onto one timeline.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time

from ... import telemetry
from ...base import MXNetError

__all__ = ["RpcServer", "RpcClient", "RpcError", "RpcConnectionError",
           "RpcRemoteError"]

_LEN = struct.Struct(">I")
_MAX_MSG = 1 << 30  # 1 GiB frame cap: a corrupt length prefix must not
#                     drive a multi-GiB allocation


class RpcError(MXNetError):
    """Base class for fleet RPC failures."""


class RpcConnectionError(RpcError):
    """Transport failure (peer dead / refused / timed out). The router
    treats this as 'replica suspect': re-dispatch, let the supervisor's
    heartbeat scan decide whether it is actually dead."""


class RpcRemoteError(RpcError):
    """The remote handler raised something that could not be pickled back
    verbatim; carries the remote repr."""


def _send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise RpcConnectionError("fleet.rpc: peer closed mid-message")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock):
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > _MAX_MSG:
        raise RpcError("fleet.rpc: frame length %d exceeds cap" % n)
    return pickle.loads(_recv_exact(sock, n))


class RpcClient:
    """One persistent connection to a replica; thread-compatible but NOT
    thread-safe (the router gives each dispatch worker its own client so
    concurrent requests to one replica pipeline through separate
    connections). Reconnects lazily after any failure."""

    def __init__(self, addr, timeout_s=30.0, connect_timeout_s=2.0,
                 clock_samples=3):
        host, port = addr.rsplit(":", 1)
        self.addr = addr
        self._host, self._port = host, int(port)
        self.timeout_s = float(timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self._sock = None
        # midpoint clock-offset handshake: seconds to ADD to the peer's
        # wall clock to land on ours; None until a connection measured it
        # (re-measured on every reconnect, so drift across a replica
        # restart is picked up)
        self.clock_offset_s = None
        self.remote_pid = None
        self._clock_samples = int(clock_samples)

    def _measure_clock(self, s):
        """Median midpoint offset over a few __clock__ round trips.

        A server without the builtin answers with a clean unknown-method
        error frame (stream stays in sync) — the offset just stays
        unknown. A TRANSPORT failure mid-handshake leaves the stream
        desynchronized, so it escalates to ``RpcConnectionError`` like
        any other call-path failure."""
        offsets = []
        try:
            s.settimeout(self.connect_timeout_s)
            for _ in range(max(1, self._clock_samples)):
                t0 = time.time()
                _send_msg(s, {"method": "__clock__", "kw": {}})
                resp = _recv_msg(s)
                t1 = time.time()
                if not (isinstance(resp, dict) and resp.get("ok")):
                    return
                r = resp.get("result") or {}
                self.remote_pid = r.get("pid", self.remote_pid)
                offsets.append((t0 + t1) / 2.0 - r.get("wall", t0))
        except RpcError:
            try:
                s.close()
            except OSError:
                pass
            raise
        except (OSError, EOFError, pickle.UnpicklingError) as exc:
            try:
                s.close()
            except OSError:
                pass
            raise RpcConnectionError(
                "fleet.rpc: clock handshake with %s failed (%s: %s)"
                % (self.addr, type(exc).__name__, exc)) from exc
        offsets.sort()
        self.clock_offset_s = offsets[len(offsets) // 2]

    def _ensure(self):
        if self._sock is not None:
            return self._sock
        try:
            s = socket.create_connection(
                (self._host, self._port), timeout=self.connect_timeout_s)
        except OSError as exc:
            raise RpcConnectionError(
                "fleet.rpc: cannot connect to %s (%s)"
                % (self.addr, exc)) from exc
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._measure_clock(s)
        self._sock = s
        return s

    def call(self, method, rpc_timeout_s=None, **kw):
        """Invoke ``method`` on the replica; ``kw`` (including any
        ``timeout_s`` the remote HANDLER consumes) crosses the wire
        verbatim — ``rpc_timeout_s`` is this side's socket receive bound
        only, and callers that forward a handler timeout must size it
        strictly larger. Remote exceptions re-raise here as their
        original type (pickled through); transport failures — including a
        frame-cap violation, after which the stream is desynchronized —
        drop the connection and raise ``RpcConnectionError``/
        ``RpcError``."""
        sock = self._ensure()
        sock.settimeout(self.timeout_s if rpc_timeout_s is None
                        else float(rpc_timeout_s))
        req = {"method": method, "kw": kw}
        trace_id = telemetry.trace_context()
        if trace_id is not None:
            req["trace"] = {"id": trace_id}
        try:
            with telemetry.span("fleet.rpc", method=method,
                                addr=self.addr):
                _send_msg(sock, req)
                resp = _recv_msg(sock)
        except RpcError:
            self.close()  # incl. frame-cap: the stream is mid-payload
            raise
        except (OSError, EOFError, pickle.UnpicklingError) as exc:
            self.close()
            raise RpcConnectionError(
                "fleet.rpc: %s to %s failed in transport (%s: %s)"
                % (method, self.addr, type(exc).__name__, exc)) from exc
        if resp.get("ok"):
            return resp.get("result")
        err = resp.get("error")
        if isinstance(err, BaseException):
            raise err
        raise RpcRemoteError("fleet.rpc: %s on %s failed remotely: %s"
                             % (method, self.addr, err))

    def close(self):
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


class RpcServer:
    """Loopback-only threaded RPC server: one daemon thread accepts, one
    per connection serves request/response frames until the peer hangs
    up. ``handlers`` maps method name -> callable(**kw)."""

    def __init__(self, handlers, host="127.0.0.1", port=0):
        self._handlers = dict(handlers)
        # clock-offset handshake builtin (RpcClient._measure_clock): the
        # peer's view of this process's wall clock + identity
        self._handlers.setdefault(
            "__clock__", lambda: {"wall": time.time(), "pid": os.getpid()})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self._host = host
        self._stop = threading.Event()
        self._accept_thread = None

    @property
    def port(self):
        return self._sock.getsockname()[1]

    @property
    def addr(self):
        return "%s:%d" % (self._host, self.port)

    def start(self):
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-rpc-accept", daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        self._sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="fleet-rpc-conn", daemon=True).start()

    def _serve_conn(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                try:
                    req = _recv_msg(conn)
                except (RpcError, OSError, EOFError,
                        pickle.UnpicklingError):
                    return  # peer hung up / garbage: drop the connection
                method = req.get("method")
                fn = self._handlers.get(method)
                trace_id = (req.get("trace") or {}).get("id")
                if fn is None:
                    resp = {"ok": False,
                            "error": MXNetError(
                                "fleet.rpc: unknown method %r" % method)}
                else:
                    try:
                        # install the caller's trace context around the
                        # handler: spans recorded on this thread inherit
                        # the router-minted trace_id
                        with telemetry.trace_scope(trace_id):
                            resp = {"ok": True,
                                    "result": fn(**req.get("kw", {}))}
                    except BaseException as exc:  # noqa: BLE001 — every
                        # handler failure must cross back as a response,
                        # or the caller's recv would hang
                        try:
                            pickle.dumps(exc)
                            resp = {"ok": False, "error": exc}
                        except Exception:
                            resp = {"ok": False,
                                    "error": "%s: %s"
                                    % (type(exc).__name__, exc)}
                try:
                    _send_msg(conn, resp)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
