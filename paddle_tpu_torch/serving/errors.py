"""Typed serving-engine errors (the engine's failure contract).

Counterpart of ``paddle_tpu/serving/errors.py`` for the errors the
single-process engine raises; callers branch on these instead of
parsing RuntimeError strings:

- :class:`QueueFull` — ``submit()`` with the bounded admission queue at
  ``max_queue``.
- :class:`DeadlineExceeded` — set as ``Request.error`` (with
  ``finish_reason == "deadline"``) when the engine cancels a queued or
  in-flight request at a step boundary; never raised by ``submit()``.
- :class:`EngineBroken` — ``step()``/``submit()`` after a step failed
  (its in-place KV writes may be half done), until ``recover()``.
- :class:`EngineIdle` — ``step()`` with no queued or in-flight work.
- :class:`EngineClosed` — ``submit()`` after ``drain()``.
- :class:`RequestCancelled` — set as ``Request.error`` by ``cancel()``,
  ``drain()`` cutoffs and client disconnects (raised inside a prefill
  that observes the disconnect, and handled there).

The front-door and router errors come with the fleet slice.
"""
from __future__ import annotations

__all__ = ["ServingError", "QueueFull", "DeadlineExceeded",
           "EngineBroken", "EngineIdle", "EngineClosed",
           "RequestCancelled"]


def _rebuild_error(cls, args, attrs):
    e = cls.__new__(cls)
    RuntimeError.__init__(e, *args)
    e.__dict__.update(attrs)
    return e


class ServingError(RuntimeError):
    """Base class for the serving engine's typed failures (pickle-safe:
    the structured subclass signatures are restored from ``__dict__``)."""

    def __reduce__(self):
        return _rebuild_error, (type(self), self.args, dict(self.__dict__))


class QueueFull(ServingError):
    def __init__(self, depth: int, max_queue: int):
        super().__init__(
            f"admission queue full ({depth} waiting >= max_queue="
            f"{max_queue}); retry later or raise max_queue")
        self.depth = depth
        self.max_queue = max_queue


class DeadlineExceeded(ServingError):
    def __init__(self, rid, detail: str = ""):
        super().__init__(
            f"request {rid} missed its deadline"
            + (f": {detail}" if detail else ""))
        self.rid = rid


class EngineBroken(ServingError):
    def __init__(self, reason: str):
        super().__init__(
            f"ServingEngine is broken (a step failed part-way through "
            f"its in-place KV-cache writes): {reason}. Call recover() "
            f"to rebuild the KV state from the requests and go on.")
        self.reason = reason


class EngineIdle(ServingError):
    def __init__(self):
        super().__init__(
            "step() called with no queued or in-flight work; guard the "
            "loop with has_work()")


class EngineClosed(ServingError):
    def __init__(self):
        super().__init__(
            "ServingEngine is draining/closed; submit() refused")


class RequestCancelled(ServingError):
    def __init__(self, rid, reason: str = "cancelled"):
        super().__init__(f"request {rid} cancelled: {reason}")
        self.rid = rid
