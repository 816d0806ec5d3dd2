"""Request-correlated spans and trace propagation.

Counterpart of ``paddle_tpu/observability/tracing.py`` (a copy, not an
import). A ``span`` is the host annotation an instrumented layer opens
around a hot section. While ``torch.profiler`` records, the span opens a
``torch.profiler.record_function`` range of its name, so it lands in the
profiler's host timeline around the kernels it launched; its structured
attributes (``request_id`` first among them) go to the trace buffer.

- :class:`TraceContext` — (trace_id, parent span id), minted per
  request; it rides the request (``Request.trace``) so spans parent
  correctly.
- :class:`TraceBuffer` — a bounded per-process ring of COMPLETED
  spans. When one is installed (``install_trace_buffer``), every
  ``Span.__exit__`` records ``{name, t0, t1, pid, trace, attrs}``
  into it on the buffer's clock. ``drain()`` hands the ring over; the
  cumulative ``drained_total`` / ``dropped_total`` counters make a lost
  drain (or a ring overflow) detectable.
- request bindings (``bind_request``) — rid -> TraceContext, so spans
  that only know a ``request_id`` resolve their trace.

Spans are cheap when nothing records: one check of the profiler's
state, and the trace buffer only when one is installed.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "span", "TraceContext", "TraceBuffer",
           "install_trace_buffer", "current_trace_buffer",
           "bind_request", "unbind_request", "clear_bindings",
           "context_for", "active_context"]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Distributed trace identity carried across the RPC boundary.

    Plain picklable value: ``trace_id`` names the whole request
    lifecycle (one per router submit), ``parent_span_id`` the span
    that minted/forwarded it. Deterministic ids (``req-<rid>``) keep
    chaos episodes replayable."""

    trace_id: str
    parent_span_id: int = 0

    @classmethod
    def for_request(cls, rid: int,
                    parent_span_id: int = 0) -> "TraceContext":
        return cls(trace_id=f"req-{int(rid)}",
                   parent_span_id=int(parent_span_id))


class TraceBuffer:
    """Bounded thread-safe ring of completed-span records.

    ``time_fn`` is the clock spans are stamped on — a worker passes
    its engine clock so virtual-clock episodes produce clock-aligned
    records across processes. The cumulative counters make scrape
    loss detectable: ``recorded_total == drained_total +
    dropped_total + len(ring)`` always holds, and a consumer that
    tracks the ``drained_total`` it has ingested can tell when a
    drain it never saw happened in between."""

    def __init__(self, capacity: int = 2048,
                 time_fn: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.now = time_fn
        self._ring: deque = deque()
        self._lock = threading.Lock()
        self.recorded_total = 0
        self.drained_total = 0
        self.dropped_total = 0

    def record(self, rec: dict) -> None:
        with self._lock:
            self.recorded_total += 1
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped_total += 1
            self._ring.append(rec)

    def drain(self) -> List[dict]:
        """Take everything recorded since the last drain (oldest
        first); bumps ``drained_total`` by the number returned."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            self.drained_total += len(out)
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# -- process-global wiring (buffer + rid bindings + active stack) -----

_buffer: Optional[TraceBuffer] = None
_bindings: Dict[int, TraceContext] = {}
_bind_lock = threading.Lock()
_tls = threading.local()


def install_trace_buffer(
        buf: Optional[TraceBuffer]) -> Optional[TraceBuffer]:
    """Install the process trace buffer (None uninstalls). Returns
    the previously installed buffer so callers can restore it."""
    global _buffer
    prev = _buffer
    _buffer = buf
    return prev


def current_trace_buffer() -> Optional[TraceBuffer]:
    return _buffer


def bind_request(rid: int, ctx: Optional[TraceContext]) -> None:
    """rid → TraceContext: workers call this when a request arrives
    over RPC so engine spans (which only carry ``request_id``)
    resolve their trace id."""
    if ctx is None:
        return
    with _bind_lock:
        _bindings[int(rid)] = ctx


def unbind_request(rid: int) -> None:
    with _bind_lock:
        _bindings.pop(int(rid), None)


def clear_bindings() -> None:
    with _bind_lock:
        _bindings.clear()


def context_for(rid) -> Optional[TraceContext]:
    if rid is None:
        return None
    with _bind_lock:
        return _bindings.get(int(rid))


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def active_context() -> Optional[TraceContext]:
    """The context of the innermost open span that has one — what
    the cluster RPC client stamps on every outgoing frame."""
    st = _stack()
    return st[-1] if st else None


def _profiler_range(name: str):
    """An open ``record_function`` range while the torch profiler
    records, else None (no dispatcher call on the serving hot path)."""
    import torch
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """Context manager: a profiler range (while ``torch.profiler``
    records) and a trace-buffer record, with attributes.

    ``set_attr`` may be called inside the span (attributes are read at
    exit, when the chrome event is emitted). ``ctx`` attaches an
    explicit :class:`TraceContext`; without one, the request binding
    for ``attrs['request_id']`` and then the enclosing span's context
    are consulted. When a :class:`TraceBuffer` is installed the
    completed span is recorded into it at exit (even when the body
    raised — a failed stage is still part of the timeline).
    """

    def __init__(self, name: str, request_id: Optional[int] = None,
                 ctx: Optional[TraceContext] = None, **attrs: Any):
        self.name = name
        self.ctx = ctx
        self.attrs: Dict[str, Any] = {}
        if request_id is not None:
            self.attrs["request_id"] = request_id
        self.attrs.update(attrs)
        self._ev = None
        self._buf: Optional[TraceBuffer] = None
        self._t0 = 0.0
        self._eff: Optional[TraceContext] = None
        self._pushed = False

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self._ev = _profiler_range(self.name)
        self._eff = (self.ctx
                     or context_for(self.attrs.get("request_id"))
                     or active_context())
        if self._eff is not None:
            _stack().append(self._eff)
            self._pushed = True
        buf = _buffer
        if buf is not None:
            self._buf = buf
            self._t0 = float(buf.now())
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            self._ev.__exit__(None, None, None)
            self._ev = None
        if self._pushed:
            st = _stack()
            if st:
                st.pop()
            self._pushed = False
        buf = self._buf
        if buf is not None:
            self._buf = None
            rec = {"name": self.name, "t0": self._t0,
                   "t1": float(buf.now()), "pid": os.getpid()}
            if self._eff is not None:
                rec["trace"] = self._eff.trace_id
                rec["parent"] = self._eff.parent_span_id
            if exc and exc[0] is not None:
                rec["error"] = getattr(exc[0], "__name__", str(exc[0]))
            if self.attrs:
                rec["attrs"] = dict(self.attrs)
            buf.record(rec)
        return False


def span(name: str, request_id: Optional[int] = None,
         ctx: Optional[TraceContext] = None, **attrs: Any) -> Span:
    """Open a host span; ``request_id``/attrs flow into the trace
    buffer's record::

        with span("serving.prefill", request_id=req.rid, bucket=32):
            ...
    """
    return Span(name, request_id=request_id, ctx=ctx, **attrs)
