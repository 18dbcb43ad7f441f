"""Per-run communication flight recorder (twin of
``repro/obs/flight_recorder.py``).

The reference snapshots two static views of a compiled program: the
trace-time tape and the collectives of the compiled HLO. The port has no
compile. It holds the tape (``comm.primitives.tape``: what each primitive
promised) against the issued view (``comm.primitives.issued``: what was
handed to ``torch.distributed``) of the same step, once, on the run's
first step, whose wall also holds the kernel builds. Then it stamps every
step with the run's throughput:

* tokens/s and achieved FLOP/s → **MFU**: model FLOPs
  (``obs.flops.model_flops``) over ``n_devices × peak``, the peak the
  H100's (``obs.flops.PEAK_FLOPS``);
* the tape's collective bytes a step beside the issued bytes, and the
  tape's bytes a token;
* the step wall against a rolling median (the recorder's own straggler
  rule when the caller gives no verdict).

Drift (``compile`` record and ``drift_events``): an op the tape promised
more often than it was issued, an op issued that the tape never recorded
(or more often), and an op whose tape payload bytes differ from the bytes
issued.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs.flops import PEAK_FLOPS
from repro_torch.obs.metrics import Histogram, MetricsSink, as_sink


@dataclass
class CompileSnapshot:
    """The first step's collective structure, taken once."""

    # tape view (what the primitives promised)
    tape_counts: Dict[str, int] = field(default_factory=dict)
    tape_bytes_by_op: Dict[str, float] = field(default_factory=dict)
    expected_bytes_per_step: float = 0.0     # ring-model traffic
    expected_steps_per_step: int = 0
    # issued view (what went to torch.distributed)
    issued_counts: Dict[str, int] = field(default_factory=dict)
    issued_bytes_by_op: Dict[str, float] = field(default_factory=dict)
    issued_bytes_per_step: float = 0.0
    drift: List[str] = field(default_factory=list)

    def as_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"kind": "compile",
                               "expected_collective_bytes":
                                   self.expected_bytes_per_step,
                               "expected_comm_steps":
                                   self.expected_steps_per_step,
                               "issued_collective_bytes":
                                   self.issued_bytes_per_step,
                               "drift": list(self.drift)}
        for op, n in sorted(self.tape_counts.items()):
            rec[f"tape/{op}_count"] = n
        for op, b in sorted(self.tape_bytes_by_op.items()):
            rec[f"tape/{op}_bytes"] = b
        for op, n in sorted(self.issued_counts.items()):
            rec[f"issued/{op}_count"] = n
        for op, b in sorted(self.issued_bytes_by_op.items()):
            rec[f"issued/{op}_bytes"] = b
        return rec


class FlightRecorder:
    """Run telemetry of one train loop (or any stepped program).

    Parameters
    ----------
    sink: where records go (``None`` → dropped).
    model_flops_per_step: model FLOPs of one step
        (``obs.flops.model_flops``); enables ``achieved_flops`` and
        ``mfu`` on step records.
    n_devices: cards the program spans (the layout's world size; the MFU
        denominator).
    peak_flops: per-card peak; by default the H100's dense bf16 peak.
    wall_factor / wall_window / wall_warmup: rolling-median step-wall
        straggler rule; the first ``wall_warmup`` steps (kernel builds,
        resume) are never flagged and never enter the window.
    """

    def __init__(self, sink: Optional[MetricsSink] = None, *,
                 model_flops_per_step: Optional[float] = None,
                 n_devices: int = 1,
                 peak_flops: float = PEAK_FLOPS["bfloat16"],
                 wall_factor: float = 3.0, wall_window: int = 50,
                 wall_warmup: int = 1):
        self.sink = as_sink(sink)
        self.model_flops_per_step = model_flops_per_step
        self.n_devices = max(int(n_devices), 1)
        self.peak_flops = peak_flops
        self.wall_factor = wall_factor
        self.wall_window = wall_window
        self.wall_warmup = wall_warmup
        self.snapshot: Optional[CompileSnapshot] = None
        self.drift_events: List[str] = []
        self.wall_hist = Histogram()
        self._walls: List[float] = []
        self._seen = 0

    # -- the first step's snapshot ------------------------------------------

    def on_compile(self, *, records=None, issued=None,
                   note: str = "") -> CompileSnapshot:
        """Snapshot the first step's tape (``CommRecord`` list) and issued
        view (``IssuedRecord`` list); emit one ``compile`` record; return
        the snapshot (``snapshot.drift`` lists the mismatches)."""
        snap = CompileSnapshot()
        payload: Dict[str, float] = {}
        for r in records or ():
            snap.tape_counts[r.op] = snap.tape_counts.get(r.op, 0) + 1
            payload[r.op] = payload.get(r.op, 0.0) + r.payload_bytes
            snap.expected_bytes_per_step += r.traffic_bytes
            snap.expected_steps_per_step += r.steps
        snap.tape_bytes_by_op = payload
        for r in issued or ():
            snap.issued_counts[r.op] = snap.issued_counts.get(r.op, 0) + 1
            snap.issued_bytes_by_op[r.op] = \
                snap.issued_bytes_by_op.get(r.op, 0.0) + r.nbytes
        snap.issued_bytes_per_step = sum(snap.issued_bytes_by_op.values())

        for op in sorted(set(snap.tape_counts) | set(snap.issued_counts)):
            want, got = snap.tape_counts.get(op, 0), \
                snap.issued_counts.get(op, 0)
            if got < want:
                snap.drift.append(f"{op}: tape promises {want} "
                                  f"collective(s), {got} issued")
            elif got > want:
                snap.drift.append(f"{op}: {got} issued, the tape records "
                                  f"{want}")
            elif payload.get(op, 0.0) != snap.issued_bytes_by_op.get(op, 0.0):
                snap.drift.append(
                    f"{op}: tape promises {payload.get(op, 0.0):.0f}B, "
                    f"{snap.issued_bytes_by_op.get(op, 0.0):.0f}B issued")

        self.snapshot = snap
        self.drift_events.extend(snap.drift)
        rec = snap.as_record()
        if note:
            rec["note"] = note
        self.sink.emit(rec)
        return snap

    # -- per-step records ----------------------------------------------------

    def expected_wall_s(self) -> Optional[float]:
        """Rolling-median step wall over the post-warmup window."""
        if not self._walls:
            return None
        xs = sorted(self._walls)
        return xs[len(xs) // 2]

    def on_step(self, step: int, wall_s: float, *,
                tokens: Optional[int] = None,
                phases: Optional[Dict[str, float]] = None,
                metrics: Optional[Dict[str, float]] = None,
                straggler: Optional[bool] = None) -> Dict[str, Any]:
        """Build and emit one ``step`` record; return it.

        ``phases``: ``{"<name>_s": wall}`` from ``PhaseTimer.flush()``.
        ``straggler``: the caller's verdict (the loop's watchdog); if
        None, the recorder's rolling-median rule decides."""
        rec: Dict[str, Any] = {"kind": "step", "step": int(step),
                               "wall_s": float(wall_s)}
        if metrics:
            rec.update({k: float(v) for k, v in metrics.items()})
        if phases:
            rec.update({k: float(v) for k, v in phases.items()})

        expected = self.expected_wall_s()
        self._seen += 1
        warming = self._seen <= self.wall_warmup
        if not warming:
            self._walls.append(float(wall_s))
            self._walls = self._walls[-self.wall_window:]
            self.wall_hist.add(float(wall_s))
        if straggler is None:
            straggler = bool(expected is not None and not warming
                             and wall_s > self.wall_factor * expected)
        rec["straggler"] = bool(straggler)
        if expected is not None:
            rec["expected_wall_s"] = expected

        if tokens:
            rec["tokens"] = int(tokens)
            rec["tokens_per_s"] = tokens / wall_s if wall_s > 0 else 0.0
        if self.model_flops_per_step and wall_s > 0:
            achieved = self.model_flops_per_step / wall_s
            rec["achieved_flops"] = achieved
            rec["mfu"] = achieved / (self.peak_flops * self.n_devices)
        if self.snapshot is not None:
            rec["expected_collective_bytes"] = \
                self.snapshot.expected_bytes_per_step
            rec["issued_collective_bytes"] = \
                self.snapshot.issued_bytes_per_step
            if tokens and self.snapshot.expected_bytes_per_step:
                rec["comm_bytes_per_token"] = \
                    self.snapshot.expected_bytes_per_step / tokens
        self.sink.emit(rec)
        return rec

    def event(self, name: str, **fields) -> Dict[str, Any]:
        """Emit a structured ``event`` record (resume, fallback, skip,
        signal, ...)."""
        rec: Dict[str, Any] = {"kind": "event", "event": name}
        rec.update(fields)
        self.sink.emit(rec)
        return rec

    def summary(self, **extra) -> Dict[str, Any]:
        """Emit the run's ``summary`` record (wall histogram, drift count,
        the caller's extras) and return it."""
        rec: Dict[str, Any] = {"kind": "summary",
                               "steps_recorded": self._seen,
                               "drift_events": len(self.drift_events)}
        for stat, v in self.wall_hist.summary().items():
            rec[f"wall_s_{stat}"] = v
        if self.snapshot is not None:
            rec["expected_collective_bytes"] = \
                self.snapshot.expected_bytes_per_step
        rec.update(extra)
        self.sink.emit(rec)
        return rec
