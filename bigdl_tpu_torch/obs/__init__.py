"""The observability plane (``bigdl_tpu/obs/``): tracing, the metrics
registry and its export, the flight recorder and the engine's step
timeline.

- :class:`Tracer` / :class:`RequestTrace`: per-request span trees for
  the serving lifecycle (submit, queue wait, page reservation, prefill
  chunks, counted decode and verify steps, retirement), carried on the
  stream; JSONL export and :func:`format_trace` waterfalls. Off, a trace
  costs one ``is None`` test.
- :class:`MetricsRegistry`: components register their gauges once, and
  one ``collect()`` gives a flat, stable-key snapshot.
- :func:`to_prometheus` / :func:`to_json`: exporters over a collect.
- :class:`MetricsEndpoint`: a stdlib HTTP thread serving ``/metrics``,
  ``/metrics.json`` and ``/healthz`` (:func:`engine_health` checks).
- :class:`FlightRecorder` / :func:`record_event`: a bounded ring of
  structured incidents (faults fired, watchdog stalls, retries).
- :class:`StepTimeline`: the engine's per-iteration breakdown (host
  against kernel-call time, the prefill / decode / verify split, queue
  depth and occupancy, the async overlap split), always on, bounded.
"""

from bigdl_tpu_torch.obs.endpoint import MetricsEndpoint, engine_health
from bigdl_tpu_torch.obs.exporters import prometheus_name, to_json, to_prometheus
from bigdl_tpu_torch.obs.recorder import (
    FlightRecorder,
    flight_recorder,
    record_event,
)
from bigdl_tpu_torch.obs.registry import MetricsRegistry
from bigdl_tpu_torch.obs.timeline import StepTimeline
from bigdl_tpu_torch.obs.trace import (
    RequestTrace,
    Span,
    Tracer,
    format_trace,
    submit_trace,
)

__all__ = [
    "FlightRecorder",
    "MetricsEndpoint",
    "MetricsRegistry",
    "RequestTrace",
    "Span",
    "StepTimeline",
    "Tracer",
    "engine_health",
    "flight_recorder",
    "format_trace",
    "prometheus_name",
    "record_event",
    "submit_trace",
    "to_json",
    "to_prometheus",
]
