"""paddle_tpu_torch.observability — the serving engine's telemetry.

Counterpart of ``paddle_tpu/observability`` (copies, not imports: the
port never imports the reference package):

- **Metrics registry** (``registry.py``): thread-safe ``Counter`` /
  ``Gauge`` / ``Histogram`` families with label sets and an injectable
  clock; Prometheus text exposition and JSON exporters. The process
  default (``default_registry()``) is what the serving engine publishes
  its ``ptpu_serving_*`` families to unless it is given its own.
- **Spans** (``tracing.py``): host annotations that open a
  ``torch.profiler`` range while the profiler records and carry
  structured attributes (request ids) into an installed trace buffer.
- **Flight recorder** (``flight_recorder.py``): a bounded ring of the
  last N step records, dumped to a JSON file when a step raises
  (``dump_dir``, else ``PTPU_FLIGHT_DIR``, else the temporary
  directory).

- **Watchtower** (``watchtower.py``): multi-window SLO burn rates,
  EWMA and robust-z anomaly detectors, stall and orphaned-request
  detectors over an attached engine, deduped incidents, ``healthz()``
  and ``render_diagnosis``; the engine's step bumps its counter
  (``observe_step()``, one increment).

The reference's cluster timeline (``ClusterTelemetry``, which merges N
processes) comes with the serving fleet.
"""
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricError, MetricRegistry, default_registry)
from .tracing import (Span, span, TraceContext,  # noqa: F401
                      TraceBuffer, install_trace_buffer,
                      current_trace_buffer, bind_request,
                      unbind_request, clear_bindings, context_for,
                      active_context)
from .flight_recorder import FlightRecorder, default_recorder  # noqa: F401
from .watchtower import (DEFAULT_OBJECTIVES, EwmaDetector,  # noqa: F401
                         Incident, RobustZDetector, SLOObjective,
                         Watchtower, render_diagnosis)

__all__ = ["Counter", "Gauge", "Histogram", "MetricError",
           "MetricRegistry", "default_registry", "Span", "span",
           "TraceContext", "TraceBuffer", "install_trace_buffer",
           "current_trace_buffer", "bind_request", "unbind_request",
           "clear_bindings", "context_for", "active_context",
           "FlightRecorder", "default_recorder", "SLOObjective",
           "DEFAULT_OBJECTIVES", "EwmaDetector", "RobustZDetector",
           "Incident", "Watchtower", "render_diagnosis"]
