"""In-band request tracing: W3C-``traceparent`` ids, per-phase spans.

The port's own copy of ``gpustack_tpu/observability/tracing.py`` (the
standard library only, as there). Dapper-style propagation for the
multi-hop serving path (client → server proxy/failover → worker reverse
proxy → engine): the edge mints a 32-hex trace id (or adopts the
caller's ``X-Request-ID``), every downstream dial carries ``traceparent:
00-<trace>-<span>-01``, and each hop records its own per-phase spans into

- a bounded in-memory :class:`TraceStore` ring, and
- ONE structured log line per hop (``trace=… phases=[…]``) so a
  chaos-run log greps into a causal timeline.

The engine is the only component the port serves, and the engine has no
request-duration histogram family in the JAX module either
(``_COMPONENT_HISTOGRAMS`` names only the server and the worker), so this
copy records spans and log lines only.

:func:`trace_middleware` is the stdlib form of the JAX aiohttp
middleware: a class decorator for a ``BaseHTTPRequestHandler``.

Everything here is synchronous and allocation-light: tracing rides the
hot request path and must never add a lock hold across a request or an
unbounded buffer.
"""

from __future__ import annotations

import hashlib
import logging
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional
from urllib.parse import urlsplit

logger = logging.getLogger(__name__)

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "X-Request-ID"

# probe/scrape chatter no hop should trace: a health poll every few
# seconds would flood the hop log and evict real requests from the
# trace ring. Shared by the server's timing middleware, the generic
# hop middleware below, and anything else that adopts tracing.
UNTRACED_PATHS = frozenset(
    {
        "/healthz", "/readyz", "/health", "/metrics", "/metrics/raw",
        "/debug/flight",
    }
)

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
_HEX32_RE = re.compile(r"^[0-9a-f]{32}$")
# adoptable client request ids: printable token, bounded length
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{4,128}$")

def make_trace_id() -> str:
    return uuid.uuid4().hex


def make_span_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceContext:
    """trace id + this hop's span id (+ the upstream hop's span id)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "request_id")

    def __init__(
        self,
        trace_id: str,
        span_id: str = "",
        parent_id: str = "",
        request_id: str = "",
    ):
        self.trace_id = trace_id
        self.span_id = span_id or make_span_id()
        self.parent_id = parent_id
        self.request_id = request_id or trace_id

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def child(self) -> "TraceContext":
        """Same trace, fresh span, parented on this hop's span. Note:
        internal hops propagate ``propagation_headers()`` (this hop's
        OWN span id) instead — the receiver mints its span on adoption
        (``from_headers``), so every parent_id in the store points at a
        recorded span."""
        return TraceContext(
            self.trace_id,
            make_span_id(),
            parent_id=self.span_id,
            request_id=self.request_id,
        )

    def propagation_headers(self) -> Dict[str, str]:
        return {
            TRACEPARENT_HEADER: self.traceparent(),
            REQUEST_ID_HEADER: self.request_id,
        }


def parse_traceparent(value: str) -> Optional[TraceContext]:
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    trace_id, parent_span, _flags = m.groups()
    if trace_id == "0" * 32 or parent_span == "0" * 16:
        return None                     # spec: all-zero ids are invalid
    return TraceContext(trace_id, parent_id=parent_span)


def from_headers(headers) -> TraceContext:
    """Adopt the incoming hop's context, else mint a fresh one.

    Order: a valid ``traceparent`` wins (internal hops always send it);
    else a client-supplied ``X-Request-ID`` is adopted — used verbatim
    when it is already a 32-hex trace id, otherwise hashed into one
    (the original survives as ``request_id`` for log correlation)."""
    tp = headers.get(TRACEPARENT_HEADER, "")
    if tp:
        ctx = parse_traceparent(tp)
        if ctx is not None:
            rid = headers.get(REQUEST_ID_HEADER, "")
            if rid and _REQUEST_ID_RE.match(rid):
                ctx.request_id = rid
            return ctx
    rid = headers.get(REQUEST_ID_HEADER, "")
    if rid and _REQUEST_ID_RE.match(rid):
        low = rid.lower()
        if _HEX32_RE.match(low):
            return TraceContext(low, request_id=rid)
        digest = hashlib.sha256(rid.encode()).hexdigest()[:32]
        return TraceContext(digest, request_id=rid)
    return TraceContext(make_trace_id())


# concurrency contract (the JAX module's, kept by review here): the trace
# ring and the store registry are touched from handler threads and debug
# readers — always under their lock.
GUARDED_BY = {
    "_ring": "_mu",
    "_STORES": "_STORES_MU",
}


class TraceStore:
    """Bounded ring of finished hop traces, newest last. Reads and
    writes are tiny and lock-guarded."""

    def __init__(self, maxlen: int = 512):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, maxlen))

    def configure(self, maxlen: int) -> None:
        with self._mu:
            self._ring = deque(self._ring, maxlen=max(1, maxlen))

    def add(self, entry: Dict[str, Any]) -> None:
        with self._mu:
            self._ring.append(entry)

    def query(
        self,
        trace_id: str = "",
        model: str = "",
        min_duration_ms: float = 0.0,
        phase: str = "",
        outcome: str = "",
        limit: int = 50,
    ) -> List[Dict[str, Any]]:
        """Filter the ring: ``phase`` keeps entries that recorded a span
        with that name (e.g. ``kv_upload``, ``connect``); ``outcome``
        matches the sealed outcome (``ok``/``error``/``shed``/…)."""
        with self._mu:
            entries = list(self._ring)
        out = []
        for entry in reversed(entries):       # newest first
            if trace_id and entry.get("trace_id") != trace_id:
                continue
            if model and entry.get("model") != model:
                continue
            if entry.get("duration_ms", 0.0) < min_duration_ms:
                continue
            if outcome and entry.get("outcome") != outcome:
                continue
            if phase and not any(
                p.get("phase") == phase
                for p in entry.get("spans", ())
            ):
                continue
            out.append(entry)
            if len(out) >= max(1, limit):
                break
        return out


_STORES: Dict[str, TraceStore] = {}
_STORES_MU = threading.Lock()


def get_store(component: str) -> TraceStore:
    with _STORES_MU:
        store = _STORES.get(component)
        if store is None:
            store = TraceStore()
            _STORES[component] = store
        return store


def store_components() -> List[str]:
    with _STORES_MU:
        return sorted(_STORES)


class RequestTrace:
    """Per-phase span collection for one hop of one request.

    Phases are named wall-clock intervals (``begin``/``end`` or the
    ``phase`` context manager); ``event`` records point-in-time
    annotations (e.g. a failover attempt). ``finish`` seals the trace:
    spans land in the component's :class:`TraceStore` and one structured
    log line is emitted.
    """

    def __init__(
        self,
        ctx: TraceContext,
        component: str,
        name: str,
        model: str = "",
    ):
        self.ctx = ctx
        self.component = component
        self.name = name
        self.model = model
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self._open: Dict[str, float] = {}
        self.phases: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self._finished = False

    # ---- span recording -------------------------------------------------

    def begin(self, phase: str) -> None:
        self._open.setdefault(phase, time.monotonic())

    def end(self, phase: str, **attrs: Any) -> None:
        start = self._open.pop(phase, None)
        if start is None:
            return
        now = time.monotonic()
        self.add_phase(
            phase, now - start, _offset=start - self._t0, **attrs
        )

    @contextmanager
    def phase(self, name: str, **attrs: Any):
        self.begin(name)
        try:
            yield self
        finally:
            self.end(name, **attrs)

    def add_phase(
        self, phase: str, seconds: float, _offset: float = -1.0,
        **attrs: Any,
    ) -> None:
        """Record an externally measured phase duration."""
        entry: Dict[str, Any] = {
            "phase": phase,
            "offset_ms": round(
                (_offset if _offset >= 0.0
                 else time.monotonic() - self._t0 - seconds) * 1e3,
                3,
            ),
            "duration_ms": round(seconds * 1e3, 3),
        }
        if attrs:
            entry["attrs"] = attrs
        self.phases.append(entry)

    def event(self, name: str, **attrs: Any) -> None:
        entry: Dict[str, Any] = {
            "event": name,
            "offset_ms": round(
                (time.monotonic() - self._t0) * 1e3, 3
            ),
        }
        if attrs:
            entry["attrs"] = attrs
        self.events.append(entry)

    def phase_names(self) -> List[str]:
        return [p["phase"] for p in self.phases]

    # ---- sealing --------------------------------------------------------

    def finish(
        self,
        status: int = 0,
        outcome: str = "",
        log: bool = True,
        **attrs: Any,
    ) -> float:
        """Seal the trace; returns total duration in ms. Idempotent —
        the first call wins (middleware and handler may both try)."""
        if self._finished:
            return 0.0
        self._finished = True
        # close any dangling phase (an exception mid-stream must not
        # lose the span entirely)
        for phase in list(self._open):
            self.end(phase, truncated=True)
        duration_s = time.monotonic() - self._t0
        if not outcome:
            outcome = "ok" if 0 < status < 500 else "error"
        entry: Dict[str, Any] = {
            "trace_id": self.ctx.trace_id,
            "span_id": self.ctx.span_id,
            "parent_id": self.ctx.parent_id,
            "request_id": self.ctx.request_id,
            "component": self.component,
            "name": self.name,
            "model": self.model,
            "status": status,
            "outcome": outcome,
            "started_at": self.started_at,
            "duration_ms": round(duration_s * 1e3, 3),
            "spans": self.phases,
        }
        if self.events:
            entry["events"] = self.events
        if attrs:
            entry["attrs"] = {
                k: v for k, v in attrs.items() if v is not None
            }
        get_store(self.component).add(entry)
        if log:
            logger.info("%s", self.log_line(entry))
        return entry["duration_ms"]

    @staticmethod
    def log_line(entry: Dict[str, Any]) -> str:
        """One greppable line: ``trace=<id> … phases=[a:1.2 b:3.4]``."""
        phases = " ".join(
            f"{p['phase']}:{p['duration_ms']:.1f}"
            for p in entry.get("spans", [])
        )
        parts = [
            f"trace={entry['trace_id']}",
            f"span={entry['span_id']}",
            f"component={entry['component']}",
            f"name={entry['name']!r}",
            f"status={entry['status']}",
            f"outcome={entry['outcome']}",
            f"ms={entry['duration_ms']:.1f}",
        ]
        if entry.get("model"):
            parts.append(f"model={entry['model']}")
        if entry.get("request_id") != entry["trace_id"]:
            parts.append(f"req={entry['request_id']}")
        parts.append(f"phases=[{phases}]")
        return " ".join(parts)




def trace_middleware(component: str):
    """The stdlib form of the JAX ``trace_middleware``: a class decorator
    for a ``BaseHTTPRequestHandler`` subclass, for single-phase hops (the
    engine API server). Around each ``do_*`` method of a path outside
    :data:`UNTRACED_PATHS` it adopts or mints the context and opens the
    hop's :class:`RequestTrace` as ``self.trace`` (handlers add their
    phases and events to it); every response the handler starts gets
    ``X-Request-ID`` and ``traceparent`` beside its status line, a
    Server-Sent Events stream included, before its first byte; and the
    trace finishes with the status sent, or 500 when the handler raised,
    which logs the hop's ``trace=…`` line."""

    def wrap(handler_cls):
        class Traced(handler_cls):
            trace: Optional[RequestTrace] = None
            _trace_status = 500

            def send_response(self, code, message=None):
                super().send_response(code, message)
                trace = self.trace
                if trace is not None:
                    self._trace_status = code
                    self.send_header(REQUEST_ID_HEADER, trace.ctx.request_id)
                    self.send_header(
                        TRACEPARENT_HEADER, trace.ctx.traceparent()
                    )

        def traced(method):
            def run(self):
                path = urlsplit(self.path).path
                if path in UNTRACED_PATHS:
                    return method(self)
                self.trace = RequestTrace(
                    from_headers(self.headers), component,
                    f"{self.command} {path}",
                )
                self._trace_status = 500
                try:
                    method(self)
                except BaseException:
                    self._trace_status = 500
                    raise
                finally:
                    trace, self.trace = self.trace, None
                    trace.finish(status=self._trace_status)

            run.__name__ = method.__name__
            run.__doc__ = method.__doc__
            return run

        for name in dir(handler_cls):
            if name.startswith("do_"):
                setattr(Traced, name, traced(getattr(handler_cls, name)))
        Traced.__name__ = Traced.__qualname__ = handler_cls.__name__
        return Traced

    return wrap
