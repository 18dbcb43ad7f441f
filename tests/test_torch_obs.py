"""Port vs reference: telemetry (``repro_torch.obs``), the flight
recorder's tape-against-issued check, ``train(sink=)``, the engine's
summary, and both CLIs' telemetry and checkpoint flags, on the CPU.

Host-side bookkeeping runs through both packages on the same inputs and
must agree exactly (histogram quantiles, ``render_step``'s strings,
model FLOPs); the reference's ``scripts/report.py``, run unchanged as a
subprocess, renders the port's JSONL.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.hlo_analysis import model_flops as j_model_flops
from repro_torch import obs
from repro_torch.comm.primitives import CommRecord, IssuedRecord
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.obs import flops
from repro_torch.train.loop import train

ROOT = Path(__file__).resolve().parent.parent
ARCH = "linear-llama3-1b"
QUIET = dict(log_every=10 ** 9, log_fn=lambda *_: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# Histograms and registries against the reference's
# ---------------------------------------------------------------------------

def _fill(mod, case):
    """One scenario through one package's Histogram / Metrics."""
    rng = np.random.default_rng(0)
    if case == "exact":
        h = mod.Histogram()
        h.extend(list(rng.normal(size=101)))
    elif case == "reservoir":
        h = mod.Histogram(cap=64)
        h.extend(float(i) for i in range(10_000))
    elif case == "merge_fits":
        a, b = mod.Histogram(), mod.Histogram()
        a.extend([1.0, 5.0, 9.0, 13.0])
        b.extend([2.0, 4.0, 8.0])
        h = a.merge(b)
    elif case == "merge_over_cap":
        a, b = mod.Histogram(cap=16), mod.Histogram(cap=16)
        a.extend(float(i) for i in range(16))
        b.extend(float(i) for i in range(100, 116))
        h = a.merge(b)
    else:
        m, other = mod.Metrics(), mod.Metrics()
        m.inc("requests", 3)
        m.gauge("queue", 3)
        m.gauge("queue", 1)
        m.observe("lat_s", 0.1)
        m.observe("lat_s", 0.3)
        other.inc("requests", 10)
        other.gauge("queue", 7)
        other.observe("lat_s", 0.2)
        return m.merge(other).snapshot()
    return {"summary": h.summary(), "exact": h.exact, "kept": list(h._xs),
            "p": [h.percentile(p) for p in (0, 25, 50, 90, 99, 100)]}


@pytest.mark.parametrize("case", ["exact", "reservoir", "merge_fits",
                                  "merge_over_cap", "metrics_merge"])
def test_histograms_and_metrics_match_reference(case):
    """Quantiles, kept samples, ``exact``, ``merge`` and the registry's
    merged snapshot equal the reference's."""
    assert _fill(obs, case) == _fill(jobs, case)


# ---------------------------------------------------------------------------
# Sinks and timers (twins of tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_jsonl_sink_roundtrip_and_truncated_tail(tmp_path):
    """Tensors and numpy scalars are coerced; lines are sorted-key JSON;
    a blank line and a torn last line are skipped on read."""
    path = str(tmp_path / "m.jsonl")
    with obs.JsonlSink(path) as sink:
        sink.emit({"kind": "step", "step": 0, "loss": torch.tensor(1.5)})
        sink.emit({"kind": "step", "step": 1, "loss": np.float32(1.25)})
    with open(path, "a") as f:
        f.write("\n" + '{"kind": "step", "step"')
    recs = obs.read_jsonl(path)
    assert [r["step"] for r in recs] == [0, 1]
    assert [r["loss"] for r in recs] == [1.5, 1.25]
    with open(path) as f:
        assert '"kind": "step"' in f.readline()
    assert recs == jobs.read_jsonl(path)


def test_timers():
    """``scoped_timer`` accumulates by its clock and fences on what the
    block registered; ``PhaseTimer`` flushes per step and keeps
    histograms; ``block_until_ready`` passes a tree through."""
    out = {}
    clock = iter([0.0, 1.0, 5.0, 7.5]).__next__
    for _ in range(2):
        with obs.scoped_timer("step", out, clock=clock):
            pass
    assert out["step"] == 1.0 + 2.5
    out = {}
    with obs.scoped_timer("step", out) as f:
        y = f.set(torch.arange(1024) * 2)
    assert out["step"] > 0 and int(y[1]) == 2
    tree = {"a": [torch.ones(2), 3.0]}
    assert obs.block_until_ready(tree) is tree
    t = obs.PhaseTimer()
    for _ in range(3):
        with t.phase("data"):
            pass
        with t.phase("step"):
            pass
        assert set(t.flush()) == {"data_s", "step_s"} and t.current == {}
    summ = t.summaries()
    assert summ["step_s"]["count"] == summ["data_s"]["count"] == 3


@pytest.mark.parametrize("rec", [
    {"kind": "step", "step": 7, "loss": 2.5, "wall_s": 0.25,
     "tokens_per_s": 4096.0, "mfu": 0.41},
    {"kind": "step", "step": 12345, "loss": 0.123456, "grad_norm": 3.14159,
     "lr": 3e-4, "wall_s": 1.5},
    {"kind": "step"}])
def test_render_step_matches_reference(rec):
    assert obs.render_step(rec) == jobs.render_step(rec)


# ---------------------------------------------------------------------------
# Model FLOPs and the card's peaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_match_reference(kind):
    """6·N·D, 2·N·D, 2·N·B on SMOKE and on full-width CONFIG, the same
    numbers as the reference's ``model_flops``; the peaks are the
    H100's, never the reference's TPU constant."""
    for port, ref in ((get_smoke(ARCH), j_get_smoke(ARCH)),
                      (get_config(ARCH), j_get_config(ARCH))):
        shape = ShapeConfig("s", 2048, 8, kind)
        jshape = JShapeConfig("s", 2048, 8, kind)
        assert flops.model_flops(port, shape) == j_model_flops(ref, jshape)
    assert dataclasses.asdict(ShapeConfig("s", 1, 2, "train")) == \
        dataclasses.asdict(JShapeConfig("s", 1, 2, "train"))
    assert flops.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert flops.HBM_BYTES_PER_S == 3.35e12
    assert flops.peak_flops("bfloat16") == 989e12
    with pytest.raises(ValueError):
        flops.peak_flops("float16")


# ---------------------------------------------------------------------------
# The flight recorder: tape against issued
# ---------------------------------------------------------------------------

def _tape():
    return [CommRecord("all-gather", 1000, 875, 1, 8, tag="lasp2.states"),
            CommRecord("all-gather", 1000, 875, 1, 8, tag="lasp2.states"),
            CommRecord("all-reduce", 4000, 7000, 1, 8, tag="train.grads")]


def _issued(tape):
    return [IssuedRecord(r.op, r.payload_bytes, r.tag)
            for r in tape]


@pytest.mark.parametrize("case", ["match", "fake_tape", "missing_issued",
                                  "unrecorded_issued", "bytes"])
def test_flight_recorder_drift(case):
    """No drift when every promised collective was issued with its bytes;
    a fake tape record, a missing issued op, an issued op the tape never
    recorded, and a byte mismatch each flag drift in the ``compile``
    record."""
    tape, issued = _tape(), _issued(_tape())
    if case == "fake_tape":
        tape.append(CommRecord("all-to-all", 10, 70, 1, 8, tag="fake"))
    elif case == "missing_issued":
        issued = issued[1:]
    elif case == "unrecorded_issued":
        issued.append(IssuedRecord("collective-permute", 64, "hop"))
    elif case == "bytes":
        issued[-1] = IssuedRecord("all-reduce", 4004, "train.grads")
    sink = obs.InMemorySink()
    fr = obs.FlightRecorder(sink)
    snap = fr.on_compile(records=tape, issued=issued, note="t")
    (rec,) = sink.by_kind("compile")
    assert rec["drift"] == snap.drift == fr.drift_events
    assert rec["note"] == "t"
    if case == "match":
        assert snap.drift == []
        assert rec["tape/all-gather_count"] == rec["issued/all-gather_count"] \
            == 2
        assert rec["tape/all-reduce_bytes"] == rec["issued/all-reduce_bytes"]
        assert rec["expected_collective_bytes"] == 875 + 875 + 7000
    else:
        want = {"fake_tape": "all-to-all", "missing_issued": "all-gather",
                "unrecorded_issued": "collective-permute",
                "bytes": "all-reduce"}[case]
        assert len(snap.drift) == 1 and snap.drift[0].startswith(want)


def test_flight_recorder_step_records_and_warmup():
    """Twin of the reference's: the warm-up step is never flagged nor in
    the window, a 10x wall trips the rule, MFU is model FLOPs over
    ``n_devices × peak``, the summary counts post-warm-up walls; an
    external verdict wins."""
    sink = obs.InMemorySink()
    fr = obs.FlightRecorder(sink, model_flops_per_step=1e9, n_devices=2,
                            peak_flops=1e12, wall_warmup=1)
    fr.on_compile(records=_tape(), issued=_issued(_tape()))
    assert fr.on_step(0, 30.0, tokens=1000)["straggler"] is False
    assert fr.expected_wall_s() is None
    for i in range(1, 13):
        fr.on_step(i, 0.1, tokens=1000)
    assert abs(fr.expected_wall_s() - 0.1) < 1e-9
    assert fr.on_step(13, 1.0, tokens=1000)["straggler"] is True
    r = sink.by_kind("step")[5]
    assert r["tokens_per_s"] == 1000 / 0.1
    assert abs(r["mfu"] - (1e9 / 0.1) / (2 * 1e12)) < 1e-12
    assert r["issued_collective_bytes"] == 1000 + 1000 + 4000
    assert r["comm_bytes_per_token"] == r["expected_collective_bytes"] / 1000
    summ = fr.summary(final_step=13)
    assert summ["steps_recorded"] == 14 and summ["wall_s_count"] == 13
    assert obs.FlightRecorder().peak_flops == 989e12
    fr2 = obs.FlightRecorder(obs.InMemorySink())
    for i in range(12):
        fr2.on_step(i, 0.1)
    assert fr2.on_step(12, 0.1, straggler=True)["straggler"] is True


# ---------------------------------------------------------------------------
# train(sink=) and the report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sink_run(tmp_path_factory):
    """5 guarded SMOKE steps through both packages' ``train(sink=)`` (the
    port's into a JsonlSink), and the port's sink-less run."""
    from repro.configs.base import RunConfig as JRunConfig
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.train.loop import train as j_train
    kw = dict(num_microbatches=1, total_steps=5, warmup_steps=2,
              learning_rate=1e-3, remat="none", guard=True)
    path = str(tmp_path_factory.mktemp("obs") / "train.jsonl")
    cfg = get_smoke(ARCH)
    with obs.JsonlSink(path) as sink:
        _, hist = train(cfg, RunConfig(**kw), SyntheticLM(
            cfg.vocab_size, 64, 4, seed=0), device="cpu", sink=sink, **QUIET)
    _, plain = train(cfg, RunConfig(**kw), SyntheticLM(
        cfg.vocab_size, 64, 4, seed=0), device="cpu", **QUIET)
    jsink = jobs.InMemorySink()
    jcfg = j_get_smoke(ARCH)
    j_train(jcfg, JRunConfig(**kw), JSyntheticLM(jcfg.vocab_size, 64, 4,
                                                 seed=0), sink=jsink, **QUIET)
    return path, hist, plain, jsink.records


def test_train_sink_records(sink_run):
    """Kinds ``compile``, ``step`` × 5, ``summary`` in that order; every
    step record holds the reference's step keys with ``hlo`` read as
    ``issued``; MFU is model FLOPs over the wall times the bf16 peak; the
    sink changes no loss (bitwise)."""
    path, hist, plain, jrecords = sink_run
    recs = obs.read_jsonl(path)
    assert [r["kind"] for r in recs] == ["compile"] + ["step"] * 5 + \
        ["summary"]
    assert recs[0]["drift"] == [] and recs[0]["expected_collective_bytes"] \
        == 0
    jstep = next(r for r in jrecords if r["kind"] == "step")
    want = {k.replace("hlo", "issued") for k in jstep}
    cfg = get_smoke(ARCH)
    n = flops.model_flops(cfg, ShapeConfig("r", 64, 4, "train"))
    for r in recs[1:-1]:
        assert want <= set(r), want - set(r)
        assert r["tokens"] == 4 * 64
        assert r["mfu"] == pytest.approx(n / (r["wall_s"] * 989e12),
                                         rel=1e-12)
    summ = recs[-1]
    assert summ["steps_recorded"] == 5 and summ["final_step"] == 5
    assert summ["phase_step_s_count"] == 5 and summ["skipped_steps"] == 0
    jsumm = next(r for r in jrecords if r["kind"] == "summary")
    assert set(jsumm) <= set(summ)
    assert [h["loss"] for h in hist] == [h["loss"] for h in plain]


def test_report_renders_the_ports_jsonl(sink_run, tmp_path):
    """The reference's ``scripts/report.py``, unchanged, renders the
    port's train JSONL and exits 0."""
    out = tmp_path / "report.md"
    proc = subprocess.run([sys.executable, str(ROOT / "scripts/report.py"),
                           sink_run[0], "-o", str(out)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    text = out.read_text()
    assert "## Steps" in text and "mfu" in text
    assert "### Numerical guard" in text and "## Summary (run)" in text


# ---------------------------------------------------------------------------
# Both CLIs: train with --guard --metrics-out --ckpt-dir, serve from it
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--smoke", "--steps", "2", "--seq", "64", "--batch", "4",
              "--guard", "--guard-max-skips", "3"]
SERVE_ARGS = ["--smoke", "--requests", "3", "--max-batch", "2",
              "--prompt-len", "16", "--new-tokens", "4"]


def _ref_cli(module, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_clis_train_then_serve_in_both_packages(tmp_path, capsys):
    """``launch.train --guard --metrics-out --ckpt-dir`` for 2 steps, then
    ``launch.serve --ckpt-dir --metrics-out`` on that directory, in both
    packages: each prints the restored step and writes request records
    and a serve summary; the port's greedy tokens equal those of an
    engine it builds on the restored params."""
    from repro_torch.checkpoint.manager import CheckpointError, \
        CheckpointManager
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    out = {}
    for pkg in ("repro", "repro_torch"):
        d = tmp_path / pkg
        d.mkdir()
        ckpt, tm, sm = str(d / "ckpt"), str(d / "t.jsonl"), str(d / "s.jsonl")
        targs = TRAIN_ARGS + ["--ckpt-dir", ckpt, "--metrics-out", tm]
        sargs = SERVE_ARGS + ["--ckpt-dir", ckpt, "--metrics-out", sm]
        if pkg == "repro":
            _ref_cli("repro.launch.train", targs)
            text = _ref_cli("repro.launch.serve", sargs)
        else:
            ttrain.main(targs + ["--device", "cpu"])
            results = tserve.main(sargs + ["--device", "cpu"])
            text = capsys.readouterr().out
        assert "[serve] restored params from step 2" in text, text
        treq = obs.read_jsonl(tm)
        assert [r["kind"] for r in treq][0] == "compile"
        assert sum(r["kind"] == "step" for r in treq) == 2
        srec = obs.read_jsonl(sm)
        assert [r["kind"] for r in srec] == ["request"] * 3 + ["summary"]
        out[pkg] = srec
    assert set(out["repro_torch"][-1]) == set(out["repro"][-1])
    assert set(out["repro_torch"][0]) == set(out["repro"][0])

    # the port's tokens against an engine on the restored params
    cfg = get_smoke(ARCH)
    ckpt = str(tmp_path / "repro_torch" / "ckpt")
    target = {"params": M.init_params(torch.Generator().manual_seed(9), cfg,
                                      device="cpu",
                                      param_dtype=cfg.param_dtype)}
    params = CheckpointManager(ckpt).restore(2, target)["params"]
    engine = ServeEngine(cfg, params, max_len=20, max_batch=2, device="cpu")
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 17, size=3)
    uids = [engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)), 4,
                          seed=0, stream=i) for i, n in enumerate(lens)]
    want = engine.run()
    assert sorted(results) == sorted(uids)
    for uid in uids:
        np.testing.assert_array_equal(results[uid], want[uid])
    with pytest.raises(CheckpointError, match="no checkpoint"):
        tserve.main(SERVE_ARGS + ["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "empty")])


def test_engine_reset_metrics_and_emit_summary():
    """``reset_metrics`` drops the counters and keeps the cache gauges;
    ``emit_summary`` emits ``stats()`` plus extras as a serve summary."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    cfg = get_smoke(ARCH)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    sink = obs.InMemorySink()
    engine = ServeEngine(cfg, params, max_len=24, max_batch=2, sink=sink,
                         device="cpu")
    engine.submit(np.arange(1, 9), 3)
    engine.run()
    assert engine.stats()["submitted"] == 1
    engine.reset_metrics()
    s = engine.stats()
    assert "submitted" not in s and engine.sched.metrics is engine.metrics
    assert s["cache_bytes_linear_state"] == engine.cache_stats()[
        "linear_state"]
    rec = engine.emit_summary(requests=1)
    assert sink.records[-1] == rec
    assert rec["kind"] == "summary" and rec["component"] == "serve"
    assert rec["requests"] == 1
    assert json.loads(json.dumps(rec)) == rec
