"""Host-side telemetry of the port (sinks, histograms, counters)."""
