"""Telemetry for the port: sinks, histograms, counters, gauges and phase
timers (twin of ``repro/obs/metrics.py``).

* **Sinks**: a :class:`MetricsSink` is anything with ``emit(record)``;
  records are flat JSON-able dicts tagged with a ``kind`` (``step`` |
  ``compile`` | ``event`` | ``request`` | ``summary``). :class:`JsonlSink`
  appends one JSON object a line (the format the reference's
  ``scripts/report.py`` renders); :class:`InMemorySink` keeps a list;
  :class:`NullSink` drops everything.
* **Histograms / counters / gauges**: :class:`Histogram` keeps exact
  nearest-rank quantiles up to ``cap`` samples, then a deterministic
  reservoir; histograms and :class:`Metrics` registries ``merge``.
* **Phase timers**: :func:`scoped_timer` runs a block inside
  ``torch.profiler.record_function`` (so a profile attributes its kernels
  to the phase) and reads the host clock after
  :func:`block_until_ready` has synchronized the card on the tensors the
  block registered (``fence.set(x)``): the card's queued work of one
  phase is not charged to the next. Everything here is host-side
  bookkeeping; it issues no collective.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Protocol, runtime_checkable

import torch

from repro_torch.analysis.decorators import host_sync_allowed
from repro_torch.core.tree import leaves_with_paths


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


class JsonlSink:
    """One JSON object a line, flushed per record (a crash leaves at most
    a torn last line, which :func:`read_jsonl` drops). Values that are not
    JSON-native (tensors, numpy scalars) are coerced by ``float()``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, sort_keys=True, default=_coerce))
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _coerce(x):
    """JSON fallback for tensors and numpy scalars (anything float-able)."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def as_sink(sink: Optional[MetricsSink]) -> MetricsSink:
    """``None`` → :class:`NullSink`, so instrumented code never branches
    on whether a sink is present."""
    return sink if sink is not None else NullSink()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """A :class:`JsonlSink` file's records. Blank lines are skipped; a
    line that does not parse (a write cut by a crash) is dropped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


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

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    @property
    def exact(self) -> bool:
        """True while every sample is kept (the quantiles are exact)."""
        return self.count == len(self._xs)

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

    def merge(self, other: "Histogram") -> "Histogram":
        """The two histograms combined into a new one: exact while the
        union of kept samples fits under ``cap``, else thinned evenly over
        the sorted union; count, total, min and max combine exactly."""
        out = Histogram(cap=max(self.cap, other.cap))
        pool = self._xs + other._xs
        if len(pool) > out.cap:
            pool = sorted(pool)
            stride = len(pool) / out.cap
            pool = [pool[int(i * stride)] for i in range(out.cap)]
        out._xs = list(pool)
        out.count = self.count + other.count
        out.total = self.total + other.total
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

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

    def merge(self, other: "Metrics") -> "Metrics":
        """The two registries combined: counters add, gauge peaks take the
        max (latest values keep ``self``'s), histograms merge."""
        out = Metrics()
        out.counters = dict(other.counters)
        for k, v in self.counters.items():
            out.counters[k] = out.counters.get(k, 0) + v
        out.gauges = {**other.gauges, **self.gauges}
        out._gauge_peaks = dict(other._gauge_peaks)
        for k, v in self._gauge_peaks.items():
            out._gauge_peaks[k] = max(out._gauge_peaks.get(k, v), v)
        for k in set(self.histograms) | set(other.histograms):
            a = self.histograms.get(k, Histogram())
            b = other.histograms.get(k, Histogram())
            out.histograms[k] = a.merge(b)
        return out

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


# ---------------------------------------------------------------------------
# Phase timing.
# ---------------------------------------------------------------------------

@host_sync_allowed
def block_until_ready(x):
    """Wait for the card's queued work on every CUDA device that holds a
    tensor of the tree ``x`` (a no-op for host values). Returns ``x``."""
    devices = {leaf.device for _, leaf in leaves_with_paths(x)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return x


class Fence:
    """Holder a timed block registers its output in; the surrounding
    :func:`scoped_timer` waits for it before it stops the clock."""

    def __init__(self):
        self.value = None

    def set(self, x):
        self.value = x
        return x

    @host_sync_allowed
    def block(self):
        if self.value is not None:
            block_until_ready(self.value)


@host_sync_allowed
def to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """A step's metrics (0-d tensors on the device, host numbers) as host
    floats: the read a caller makes after its fence, since the steps
    return device scalars and never wait for the card themselves."""
    return {k: float(v) for k, v in metrics.items()}


@contextmanager
def scoped_timer(name: str, out: Dict[str, float], *,
                 clock=time.perf_counter):
    """Time a named phase into ``out[name]`` (seconds, accumulating).

    The block runs inside ``torch.profiler.record_function(name)``; on
    exit the timer waits for whatever the block registered with
    ``fence.set(...)``, so the card's queued work of this phase is not
    charged to whichever later phase first synchronizes.
    """
    fence = Fence()
    with torch.profiler.record_function(name):
        t0 = clock()
        try:
            yield fence
        finally:
            fence.block()
            out[name] = out.get(name, 0.0) + clock() - t0


class PhaseTimer:
    """Per-step phase walls and cumulative per-phase histograms.

    Usage::

        timer = PhaseTimer()
        with timer.phase("step") as f:
            state, metrics = step_fn(state, batch)
            f.set(state["params"])          # fence on the card's work
        walls = timer.flush()               # {"step_s": 0.0123}
    """

    def __init__(self):
        self.current: Dict[str, float] = {}
        self.metrics = Metrics()

    def phase(self, name: str):
        return scoped_timer(name, self.current)

    def flush(self) -> Dict[str, float]:
        """Close out the current step: fold its phase walls into the
        histograms and return them as ``{"<name>_s": wall}``."""
        out = {f"{k}_s": v for k, v in self.current.items()}
        for k, v in self.current.items():
            self.metrics.observe(f"{k}_s", v)
        self.current = {}
        return out

    def summaries(self) -> Dict[str, Dict[str, Optional[float]]]:
        return {k: h.summary() for k, h in self.metrics.histograms.items()}


# ---------------------------------------------------------------------------
# Console rendering.
# ---------------------------------------------------------------------------

def render_step(rec: Dict[str, Any]) -> str:
    """One line for a ``kind="step"`` record: the console view of what the
    sink received."""
    parts = [f"step {int(rec.get('step', 0)):5d}"]
    if "loss" in rec:
        parts.append(f"loss {rec['loss']:.4f}")
    if "grad_norm" in rec:
        parts.append(f"gnorm {rec['grad_norm']:.2f}")
    if "lr" in rec:
        parts.append(f"lr {rec['lr']:.2e}")
    if "wall_s" in rec:
        parts.append(f"{rec['wall_s'] * 1e3:.0f}ms")
    if rec.get("tokens_per_s"):
        parts.append(f"{rec['tokens_per_s']:.0f} tok/s")
    if rec.get("mfu") is not None:
        parts.append(f"mfu {rec['mfu']:.2%}")
    return " ".join(parts)
