"""Telemetry for the port: sinks, histograms, counters and gauges.

Own copy of the parts of ``repro/obs/metrics.py`` the serving engine uses
(``MetricsSink``, ``NullSink``, ``InMemorySink``, ``as_sink``,
``Histogram``, ``Metrics``), without JAX's named scopes and fencing.
Everything here is host-side bookkeeping; a wall that covers work on the
card is fenced by its caller (``torch.cuda.synchronize``) before the
clock is read.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


# ---------------------------------------------------------------------------
# Sinks.
# ---------------------------------------------------------------------------

@runtime_checkable
class MetricsSink(Protocol):
    """Anything that accepts telemetry records (flat JSON-able dicts)."""

    def emit(self, record: Dict[str, Any]) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Drops every record: the ``sink=None`` resolution."""

    def emit(self, record: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class InMemorySink:
    """Keeps records in a list (tests, benchmarks)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def emit(self, record: Dict[str, Any]) -> None:
        self.records.append(dict(record))

    def close(self) -> None:
        pass

    def by_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("kind") == kind]


def as_sink(sink: Optional[MetricsSink]) -> MetricsSink:
    """``None`` → :class:`NullSink`, so instrumented code never branches
    on whether a sink is present."""
    return sink if sink is not None else NullSink()


# ---------------------------------------------------------------------------
# Histograms / counters / gauges.
# ---------------------------------------------------------------------------

class Histogram:
    """Streaming samples with nearest-rank quantiles.

    Exact while ``count <= cap`` (every sample kept); past that, samples
    degrade to a uniform reservoir (Algorithm R with a deterministic LCG,
    so runs are reproducible) while ``count``, ``total``, ``min`` and
    ``max`` stay exact.
    """

    def __init__(self, cap: int = 4096, _seed: int = 0x9E3779B9):
        self.cap = int(cap)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._xs: List[float] = []
        self._rng = _seed & 0xFFFFFFFF

    def _rand(self, n: int) -> int:
        # 32-bit LCG (Numerical Recipes constants): deterministic, cheap.
        self._rng = (1664525 * self._rng + 1013904223) & 0xFFFFFFFF
        return self._rng % n

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        if len(self._xs) < self.cap:
            self._xs.append(x)
        else:
            # Algorithm R: keep each of the `count` samples with prob cap/count.
            j = self._rand(self.count)
            if j < self.cap:
                self._xs[j] = x

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the retained samples."""
        if not self._xs:
            return None
        xs = sorted(self._xs)
        idx = min(len(xs) - 1,
                  max(0, int(round(p / 100 * (len(xs) - 1)))))
        return xs[idx]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def summary(self) -> Dict[str, Optional[float]]:
        return {"count": self.count, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class Metrics:
    """Named counters (monotonic), gauges (latest value, plus peak), and
    histograms: one registry per instrumented component."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._gauge_peaks: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        value = float(value)
        self.gauges[name] = value
        self._gauge_peaks[name] = max(self._gauge_peaks.get(name, value),
                                      value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).add(value)

    def histogram(self, name: str) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram()
        return self.histograms[name]

    def snapshot(self) -> Dict[str, Any]:
        """Flat dict view: counters, gauges (+ ``<name>_peak``), and
        per-histogram summaries."""
        out: Dict[str, Any] = dict(self.counters)
        out.update(self.gauges)
        out.update({f"{k}_peak": v for k, v in self._gauge_peaks.items()})
        for name, h in self.histograms.items():
            for stat, v in h.summary().items():
                out[f"{name}_{stat}"] = v
        return out
