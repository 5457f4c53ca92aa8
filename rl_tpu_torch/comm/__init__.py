"""The control plane: backend atoms, mailboxes, command channels and the
line-delimited JSON TCP endpoint (counterpart of :mod:`rl_tpu.comm`).

The data plane on the card is the program's own tensors (and, across
cards, ``torch.distributed``, ROADMAP A7); what stays on the host is the
control plane: how commands and results move between threads and
processes. :class:`TCPCommandServer` and :class:`TCPCommandClient` speak
the reference's wire byte for byte (one JSON object a line, an optional
``nbin`` raw binary frame after the newline, an optional ``trace``
context), so a port client talks to a reference server and the reverse.
The rendezvous classes wait for ``parallel/`` and the service registry
for the rest of the reference's ``comm``: both ROADMAP A7.
"""

from __future__ import annotations

import contextlib
import contextvars
import enum
import json
import queue
import socket
import socketserver
import threading
from typing import Any, Callable, Mapping

from .._stubs import not_ported, not_ported_call
from .liveness import Interruptor, Watchdog

__all__ = [
    "Interruptor",
    "Watchdog",
    "ServiceRegistry",
    "TCPServiceRegistry",
    "connect_registry",
    "ServiceBackend",
    "TransportBackend",
    "service_backend",
    "transport_backend",
    "current_service_backend",
    "current_transport_backend",
    "Rendezvous",
    "MappingRendezvous",
    "EnvVarRendezvous",
    "JaxDistributedRendezvous",
    "Mailbox",
    "CommandChannel",
    "BinaryReply",
    "BLOB_KEY",
    "TCPCommandServer",
    "TCPCommandClient",
]


class ServiceBackend(enum.Enum):
    """WHERE code runs (reference backends.py:13)."""

    DIRECT = "direct"
    THREAD = "thread"
    PROCESS = "process"
    JAX_COLLECTIVE = "jax_collective"  # the reference's in-mesh backend
    RAY = "ray"  # import-gated


class TransportBackend(enum.Enum):
    """HOW bytes move (reference backends.py:21)."""

    AUTO = "auto"
    DIRECT = "direct"
    QUEUE = "queue"
    TCP = "tcp"
    DEVICE = "device"  # device copies / collectives
    RAY = "ray"


_SERVICE = contextvars.ContextVar("rl_tpu_service_backend", default=ServiceBackend.DIRECT)
_TRANSPORT = contextvars.ContextVar("rl_tpu_transport_backend", default=TransportBackend.AUTO)


@contextlib.contextmanager
def service_backend(backend: ServiceBackend | str):
    """Scope the default service backend (reference backends.py:191)."""
    token = _SERVICE.set(ServiceBackend(backend) if isinstance(backend, str) else backend)
    try:
        yield
    finally:
        _SERVICE.reset(token)


@contextlib.contextmanager
def transport_backend(backend: TransportBackend | str):
    token = _TRANSPORT.set(TransportBackend(backend) if isinstance(backend, str) else backend)
    try:
        yield
    finally:
        _TRANSPORT.reset(token)


def current_service_backend() -> ServiceBackend:
    return _SERVICE.get()


def current_transport_backend() -> TransportBackend:
    return _TRANSPORT.get()


# -- rendezvous and the service registry (ROADMAP A7) -------------------------

Rendezvous = not_ported("Rendezvous", __name__, "A7")
MappingRendezvous = not_ported("MappingRendezvous", __name__, "A7")
EnvVarRendezvous = not_ported("EnvVarRendezvous", __name__, "A7")
JaxDistributedRendezvous = not_ported("JaxDistributedRendezvous", __name__, "A7")
ServiceRegistry = not_ported("ServiceRegistry", __name__, "A7")
TCPServiceRegistry = not_ported("TCPServiceRegistry", __name__, "A7")
connect_registry = not_ported_call("connect_registry", __name__, "A7")


# -- mailbox / command channel ------------------------------------------------


class Mailbox:
    """Async message channel between threads (reference mailbox.py:185):
    named queues with blocking receive and futures-free semantics."""

    def __init__(self):
        self._queues: dict[str, queue.Queue] = {}
        self._lock = threading.Lock()

    def _q(self, name: str) -> queue.Queue:
        with self._lock:
            if name not in self._queues:
                self._queues[name] = queue.Queue()
            return self._queues[name]

    def send(self, to: str, message: Any) -> None:
        self._q(to).put(message)

    def receive(self, name: str, timeout: float | None = None) -> Any:
        return self._q(name).get(timeout=timeout)

    def try_receive(self, name: str) -> Any | None:
        try:
            return self._q(name).get_nowait()
        except queue.Empty:
            return None


class CommandChannel:
    """Control-plane RPC between a controller and named workers (reference
    command.py:42): register handlers, send commands, await replies."""

    def __init__(self, mailbox: Mailbox | None = None):
        self.mailbox = mailbox or Mailbox()
        self._handlers: dict[str, Callable[[Any], Any]] = {}
        self._seq = 0

    def register_handler(self, command: str, fn: Callable[[Any], Any]) -> None:
        self._handlers[command] = fn

    def serve_once(self, worker: str, timeout: float | None = None) -> bool:
        """Process one pending command addressed to ``worker``; False if none
        arrived within ``timeout``."""
        try:
            msg = self.mailbox.receive(f"cmd:{worker}", timeout=timeout)
        except queue.Empty:
            return False
        cmd, payload, reply_to = msg
        if cmd not in self._handlers:
            self.mailbox.send(reply_to, ("error", f"unknown command {cmd!r}"))
            return True
        try:
            out = self._handlers[cmd](payload)
            self.mailbox.send(reply_to, ("ok", out))
        except Exception as e:  # noqa: BLE001 - control plane reports, not crashes
            self.mailbox.send(reply_to, ("error", repr(e)))
        return True

    def call(self, worker: str, command: str, payload: Any = None, timeout: float | None = 10.0) -> Any:
        self._seq += 1
        reply_to = f"reply:{worker}:{self._seq}"
        self.mailbox.send(f"cmd:{worker}", (command, payload, reply_to))
        try:
            status, out = self.mailbox.receive(reply_to, timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no reply from worker {worker!r} to {command!r} within {timeout}s"
            ) from None
        if status != "ok":
            raise RuntimeError(f"command {command!r} on {worker!r} failed: {out}")
        return out


# reserved payload key a binary request's raw frame arrives under — old
# handlers never see it (old peers never send "nbin"), binary-aware
# handlers pop it
BLOB_KEY = "__blob__"


class BinaryReply:
    """A handler return value carrying a raw binary frame alongside the JSON
    ``out``. The server writes the header line with ``nbin=len(blob)`` and
    streams the bytes after the newline — no base64, no double copy."""

    __slots__ = ("out", "blob")

    def __init__(self, out: Any, blob: bytes):
        self.out = out
        self.blob = blob


class _JSONHandler(socketserver.StreamRequestHandler):
    def handle(self):
        line = self.rfile.readline()
        if not line:
            return
        blob_out = b""
        try:
            req = json.loads(line)
            # binary frame extension: a request announcing "nbin" is
            # followed by exactly that many raw bytes after the newline;
            # old peers never send the field, so this is wire-compatible
            nbin = int(req.get("nbin") or 0)
            payload = req.get("payload")
            if nbin:
                blob = self.rfile.read(nbin)
                if len(blob) != nbin:
                    raise ConnectionError("truncated binary frame")
                payload = dict(payload or {})
                payload[BLOB_KEY] = blob
            fn = self.server._handlers.get(req.get("command"))  # type: ignore[attr-defined]
            if fn is None:
                resp = {"status": "error", "out": f"unknown command {req.get('command')!r}"}
            else:
                from ..obs.trace import TraceContext, get_tracer, use_context

                # optional "trace" key on the frame: old peers never send
                # it, new peers tolerate its absence — the control plane
                # stays wire-compatible in both directions
                wire_ctx = TraceContext.from_wire(req.get("trace"))
                if wire_ctx is None:
                    out = fn(payload)
                else:
                    # adopt the caller's context on this handler thread:
                    # everything the handler does (spans, fleet submits,
                    # fault stamps) parents under the RPC that caused it
                    with use_context(wire_ctx), get_tracer().ctx_span(
                        f"comm/handle:{req.get('command')}"
                    ):
                        out = fn(payload)
                if isinstance(out, BinaryReply):
                    blob_out = out.blob
                    resp = {"status": "ok", "out": out.out, "nbin": len(blob_out)}
                else:
                    resp = {"status": "ok", "out": out}
        except Exception as e:  # noqa: BLE001
            resp = {"status": "error", "out": repr(e)}
            blob_out = b""
        # chaos site: the handler already ran — a drop here models a reply
        # lost on the wire, which only a client-side retry can survive
        from ..resilience.faults import should_drop

        if should_drop("comm.server.reply"):
            return
        self.wfile.write((json.dumps(resp) + "\n").encode() + blob_out)


class TCPCommandServer:
    """Cross-process command endpoint (line-delimited JSON over TCP): the
    control plane between host processes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socketserver.ThreadingTCPServer((host, port), _JSONHandler)
        self._server._handlers = {}  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def register_handler(self, command: str, fn: Callable[[Any], Any]) -> None:
        self._server._handlers[command] = fn  # type: ignore[attr-defined]

    def start(self) -> "TCPCommandServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class TCPCommandClient:
    """One-shot JSON-RPC client with optional transport retry.

    ``retry`` is a :class:`rl_tpu_torch.resilience.RetryPolicy`; when set,
    ``call(..., idempotent=True)`` survives refused connections, timeouts,
    and dropped replies. Server-side handler errors come back as
    ``RuntimeError`` and are never retried — the request reached the peer.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0, retry: Any = None):
        self.host, self.port, self.timeout = host, port, timeout
        self.retry = retry

    def _call_once(self, command: str, payload: Any, blob: bytes | None = None,
                   binary: bool = False) -> Any:
        from ..obs.trace import current_context, get_tracer

        req = {"command": command, "payload": payload}
        if blob is not None:
            req["nbin"] = len(blob)
        if current_context() is None:
            return self._send(req, blob=blob, binary=binary)
        # inside a traced request: the wire frame carries the RPC span's
        # context so the server-side handler links under THIS call (the
        # one TCP hop in the request tree); retried calls each get their
        # own span/frame, which is what a retry is
        with get_tracer().ctx_span(f"comm/call:{command}") as span_ctx:
            if span_ctx is not None:
                req["trace"] = span_ctx.to_wire()
            return self._send(req, blob=blob, binary=binary)

    def _send(self, req: Mapping[str, Any], blob: bytes | None = None,
              binary: bool = False) -> Any:
        command = req["command"]
        with socket.create_connection((self.host, self.port), timeout=self.timeout) as s:
            wire = (json.dumps(dict(req)) + "\n").encode()
            if blob is not None:
                wire += blob
            s.sendall(wire)
            data = b""
            while b"\n" not in data:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
            if not data:
                # server accepted the connection but never replied (dropped
                # reply / handler crash): transport-shaped, hence retryable
                raise ConnectionError(
                    f"empty reply from {self.host}:{self.port} for {command!r}"
                )
            if b"\n" not in data:
                raise ConnectionError(
                    f"truncated reply from {self.host}:{self.port} for {command!r}"
                )
            head, rest = data.split(b"\n", 1)
            resp = json.loads(head)
            nbin = int(resp.get("nbin") or 0)
            while len(rest) < nbin:
                chunk = s.recv(65536)
                if not chunk:
                    break
                rest += chunk
        if len(rest) < nbin:
            raise ConnectionError(
                f"truncated binary reply from {self.host}:{self.port} for {command!r}"
            )
        if resp["status"] != "ok":
            raise RuntimeError(f"remote command {command!r} failed: {resp['out']}")
        if binary:
            return resp["out"], rest[:nbin]
        return resp["out"]

    def call(self, command: str, payload: Any = None, idempotent: bool = True) -> Any:
        if self.retry is None:
            return self._call_once(command, payload)
        return self.retry.call(self._call_once, command, payload, idempotent=idempotent)

    def call_binary(
        self, command: str, payload: Any = None, blob: bytes | None = None,
        idempotent: bool = True,
    ) -> tuple[Any, bytes]:
        """Like :meth:`call` but sends ``blob`` as a raw binary frame after
        the header line and returns ``(out, reply_blob)`` (raw bytes, no
        base64)."""
        if self.retry is None:
            return self._call_once(command, payload, blob=blob, binary=True)
        return self.retry.call(
            self._call_once, command, payload, blob=blob, binary=True,
            idempotent=idempotent,
        )
