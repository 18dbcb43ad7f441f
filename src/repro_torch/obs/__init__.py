"""Host-side telemetry of the port (twin of ``repro/obs``): metrics sinks,
histograms, phase timers, model FLOPs and the card's peaks, and the
communication flight recorder. Turning a sink on issues no collective."""

from repro_torch.obs.flight_recorder import CompileSnapshot, FlightRecorder
from repro_torch.obs.metrics import (Fence, Histogram, InMemorySink,
                                     JsonlSink, Metrics, MetricsSink,
                                     NullSink, PhaseTimer, as_sink,
                                     block_until_ready, read_jsonl,
                                     render_step, scoped_timer, to_host)

__all__ = [
    "CompileSnapshot", "FlightRecorder", "Fence", "Histogram",
    "InMemorySink", "JsonlSink", "Metrics", "MetricsSink", "NullSink",
    "PhaseTimer", "as_sink", "block_until_ready", "read_jsonl",
    "render_step", "scoped_timer", "to_host",
]
