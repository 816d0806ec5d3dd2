"""Crash flight recorder: the last N step records, dumped on failure.

Counterpart of ``paddle_tpu/observability/flight_recorder.py`` (a copy,
not an import). A bounded, thread-safe ring that instrumented layers
append step records to (the serving engine's step latency, slot
occupancy, queue depth, admissions and evictions, its recoveries), and
that dumps itself to a JSON file when

- an instrumented step raises (``ServingEngine.step`` wraps itself), or
- the process hits an unhandled exception (``install_excepthook``).

A dump goes to the ``path`` given, else ``dump_dir``, else the directory
in ``PTPU_FLIGHT_DIR``, else the system's temporary directory. Records
are plain dicts, so the dump is greppable without tooling; the ring
bound keeps a long run's memory that of a short one.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["FlightRecorder", "default_recorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 256,
                 time_fn: Callable[[], float] = time.time,
                 dump_dir: Optional[str] = None, registry=None,
                 spill_path: Optional[str] = None,
                 spill_every: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.now = time_fn
        self.dump_dir = dump_dir
        # registry whose snapshot embeds in dumps (None = the process
        # default; callers with an injected registry pass it at dump
        # time so the post-mortem carries THEIR metrics)
        self.registry = registry
        # SIGKILL survivability: a kill -9 never runs dump(), so a
        # process can spill the ring to a well-known path every
        # spill_every records
        self.spill_path = spill_path
        self.spill_every = int(spill_every)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dumps = 0
        self._prev_hook = None

    # -- recording -----------------------------------------------------
    def record(self, kind: str, **fields) -> dict:
        """Append one record; oldest records fall off past capacity."""
        with self._lock:
            rec = {"seq": self._seq, "t": float(self.now()),
                   "kind": kind, **fields}
            self._seq += 1
            self._ring.append(rec)
            due = (self.spill_path is not None and self.spill_every > 0
                   and self._seq % self.spill_every == 0)
        if due:
            self.spill()
        return rec

    def spill(self) -> Optional[str]:
        """Atomically write the ring to ``spill_path`` (tmp + rename;
        a kill mid-write leaves the previous spill intact). Errors are
        swallowed — spilling is best-effort insurance, never a reason
        to fail the step that triggered it."""
        path = self.spill_path
        if not path:
            return None
        try:
            payload = {"pid": os.getpid(),
                       "spilled_at": float(self.now()),
                       "records": self.snapshot()}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=repr)
            os.replace(tmp, path)
            return path
        except Exception:
            return None

    def snapshot(self) -> List[dict]:
        """Oldest-to-newest copy of the ring."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- dumping -------------------------------------------------------
    def _default_path(self) -> str:
        d = self.dump_dir or os.environ.get("PTPU_FLIGHT_DIR") \
            or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        with self._lock:
            self._dumps += 1
            n = self._dumps
        return os.path.join(
            d, f"ptpu_flight_{os.getpid()}_{n:03d}.json")

    def dump(self, path: Optional[str] = None, reason: str = "",
             extra: Optional[Dict] = None, registry=None) -> str:
        """Write the ring (plus a metrics snapshot) to ``path`` and
        return it. The snapshot comes from ``registry``, else the
        recorder's own, else the process default. Callers on a crash
        path should wrap this in try/except so a full disk never masks
        the original error."""
        path = path or self._default_path()
        payload = {"reason": reason, "dumped_at": float(self.now()),
                   "pid": os.getpid(), "records": self.snapshot()}
        if extra:
            payload.update(extra)
        try:
            reg = registry if registry is not None else self.registry
            if reg is None:
                from .registry import default_registry
                reg = default_registry()
            payload["metrics"] = reg.to_json()
        except Exception:
            pass
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=repr)
        return path

    # -- crash hook ----------------------------------------------------
    def install_excepthook(self) -> "FlightRecorder":
        """Chain onto sys.excepthook: dump the ring before the default
        traceback printing on any unhandled exception."""
        if self._prev_hook is not None:
            return self
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            try:
                p = self.dump(
                    reason=f"unhandled {exc_type.__name__}: {exc}")
                print(f"[flight-recorder] dumped to {p}",
                      file=sys.stderr)
            except Exception:
                pass
            prev(exc_type, exc, tb)

        self._prev_hook = prev
        sys.excepthook = hook
        return self

    def uninstall_excepthook(self) -> None:
        if self._prev_hook is not None:
            sys.excepthook = self._prev_hook
            self._prev_hook = None


_default = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-global recorder the built-in layers append to."""
    return _default
