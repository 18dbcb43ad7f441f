"""Chaos drill: the port's real train loop under a deterministic fault
schedule (twin of ``repro/resilience/drill.py``).

  PYTHONPATH=src python -m repro_torch.resilience.drill \\
      --out drill_report.json --metrics-out drill_metrics.jsonl

Runs the DP×SP step (``--dp`` × ``--sp`` gloo ranks, (2, 4) by default,
each a process) on :func:`drill_config` through the reference's fault
catalog and checks recovery AND loss parity. It runs on the card, every
rank on card ``rank % device_count`` (several ranks share one card over
gloo) and the train step through the chunk kernels K1/K2a/K2b;
``--device cpu`` runs the plain PyTorch path on the CPU, as the
reference's drill runs on its CPU.

* ``nan_skip_parity``: NaN gradients at step k: the guard skips the step,
  the trajectory before the fault is the fault-free one, and from the
  fault on it equals a forced-skip run (a NaN step is a no-op step).
* ``corrupt_fallback_resume``: training stopped, the LATEST checkpoint
  corrupted on disk: the resume falls back to the newest valid
  checkpoint (its ZeRO-1 moments sliced back onto the data ranks) and
  recomputes to the end; the losses match the uninterrupted run at
  rtol 1e-6 and the fallback is recorded.
* ``save_ioerror_retry``: a transient IOError during a save is retried
  with backoff; the checkpoint verifies afterwards.
* ``kill_mid_save``: the writer dies mid-archive: the previous checkpoint
  is untouched, the async error surfaces on ``wait()``, the next save
  succeeds.
* ``straggler_step``: an injected input-pipeline straggler shows in the
  step record's data-phase wall (one device).
* ``consecutive_skip_abort``: a persistent NaN source trips the
  consecutive-skip threshold: the loop raises ``GuardAbort`` after saving
  a clean checkpoint (one device).

The three training findings share one spawn of ranks. The report holds
the chunk kernels' launches per route (rank 0's and this process's).
Exit code 0 iff every finding passed and, on the card, K1, K2a and K2b
each launched. The findings JSON (``kind: chaos_drill``) and the
recovery run's telemetry JSONL render with the reference's
``scripts/report.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

NAN_STEP = 5          # fault schedule: NaN grads at this step
TOTAL = 12            # drill run length
INTERRUPT_AT = 8      # resume scenario stops here, then corrupts latest
CKPT_EVERY = 4
RTOL = 1e-6           # acceptance: loss parity on recomputed steps

_LAYOUTS = {}


def drill_config():
    """SMOKE ``linear-llama3-1b`` widened to d 128 in 2 heads of 64, the
    heads the drill's recorded runs took (the chunk kernels take SMOKE's
    own heads of 16 as well)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke("linear-llama3-1b"),
                               name="linear-llama3-1b-drill", d_model=128,
                               n_heads=2, n_kv_heads=2, head_dim=64)


def _quiet(_msg):
    pass


def _mk(chaos_nan=(), chaos_skip=(), max_skips=8):
    from repro_torch.configs.base import RunConfig
    return RunConfig(num_microbatches=1, remat="none", total_steps=TOTAL,
                     warmup_steps=2, guard=True,
                     chaos_nan_steps=tuple(chaos_nan),
                     chaos_skip_steps=tuple(chaos_skip),
                     guard_max_consecutive_skips=max_skips)


def _layout(dp, sp):
    """This process's (dp, sp) groups (made once: ``new_group`` is
    collective), or None on one device."""
    if dp * sp == 1:
        return None
    if (dp, sp) not in _LAYOUTS:
        from repro_torch.launch.mesh import make_training_groups
        _LAYOUTS[dp, sp] = make_training_groups(dp, sp)
    return _LAYOUTS[dp, sp]


def _train(run, *, device, dp=2, sp=4, ckpt_dir=None, max_steps=None,
           sink=None, data=None, seq=64, batch=8):
    """The train loop on :func:`drill_config` on ``device``; at dp × sp > 1
    inside a process group of that many ranks (``launch.mesh.run_ranks``)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.loop import train

    cfg = drill_config()
    if data is None:
        data = SyntheticLM(cfg.vocab_size, seq, batch, seed=3)
    return train(cfg, run, data, device=device, layout=_layout(dp, sp),
                 ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY, log_every=1000,
                 log_fn=_quiet, max_steps=max_steps, sink=sink)


def _kernels():
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_fwd)
    return (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)


def _launches(into=None):
    """This process's K1/K2a/K2b launches per route, added to ``into``."""
    out = dict(into or {})
    for fn in _kernels():
        got = out.setdefault(fn.__name__, {})
        for route, n in fn.route_launches.items():
            got[route] = got.get(route, 0) + n
    return out


def _losses(history):
    return {h["step"]: h["loss"] for h in history}


def _close(a, b):
    import numpy as np
    return bool(np.allclose(a, b, rtol=RTOL, atol=0.0))


def _barrier(dp, sp):
    if dp * sp > 1:
        import torch.distributed as dist
        dist.barrier()


def _train_scenarios(rank, device, dp, sp, tmp, metrics_out):
    """The training findings on this rank; rank 0 returns ``(findings,
    records)``, the other ranks None."""
    from repro_torch.obs import InMemorySink, JsonlSink, read_jsonl
    from repro_torch.resilience import chaos

    kw = dict(device=device, dp=dp, sp=sp)
    # fault-free and forced-skip references (no checkpoints)
    _, hist_base = _train(_mk(), **kw)
    _, hist_skip = _train(_mk(chaos_skip=(NAN_STEP,)), **kw)
    base, skip = _losses(hist_base), _losses(hist_skip)

    # NaN-injected run, stopped at INTERRUPT_AT, with checkpoints
    ckpt = os.path.join(tmp, "drill_ckpt")
    _, hist1 = _train(_mk(chaos_nan=(NAN_STEP,)), ckpt_dir=ckpt,
                      max_steps=INTERRUPT_AT, **kw)
    # corrupt the LATEST checkpoint (once: the flip is an XOR), resume
    _barrier(dp, sp)
    corrupted = chaos.corrupt_checkpoint(ckpt) if rank == 0 else None
    _barrier(dp, sp)
    sink = None
    if rank == 0:
        sink = JsonlSink(metrics_out) if metrics_out else InMemorySink()
    state2, hist2 = _train(_mk(chaos_nan=(NAN_STEP,)), ckpt_dir=ckpt,
                           sink=sink, **kw)
    if rank:
        return None
    if metrics_out:
        sink.close()
        records = read_jsonl(metrics_out)
    else:
        records = sink.records

    findings = []
    l1 = _losses(hist1)
    skipped_at = [h["step"] for h in hist1 if h["skipped"]]
    pre_ok = _close([l1[s] for s in range(NAN_STEP)],
                    [base[s] for s in range(NAN_STEP)])
    post_ok = _close([l1[s] for s in range(NAN_STEP, INTERRUPT_AT)],
                     [skip[s] for s in range(NAN_STEP, INTERRUPT_AT)])
    findings.append({
        "name": "nan_skip_parity",
        "ok": skipped_at == [NAN_STEP] and pre_ok and post_ok,
        "detail": {
            "skipped_steps": skipped_at,
            "pre_fault_matches_fault_free": pre_ok,
            "post_fault_matches_forced_skip": post_ok,
            "skipped_total": hist1[-1]["skipped_steps"],
        },
    })

    l2 = _losses(hist2)
    fallback = [r for r in records if r.get("event") == "ckpt_fallback"]
    resumed_from = hist2[0]["step"] if hist2 else None
    steps2 = sorted(l2)
    recompute_ok = _close([l2[s] for s in steps2],
                          [skip[s] for s in steps2])
    reskipped = [h["step"] for h in hist2 if h["skipped"]]
    findings.append({
        "name": "corrupt_fallback_resume",
        "ok": (bool(fallback)
               and fallback[0].get("bad_step") == INTERRUPT_AT
               and fallback[0].get("restored_step") == CKPT_EVERY
               and resumed_from == CKPT_EVERY
               and steps2 == list(range(CKPT_EVERY, TOTAL))
               and recompute_ok
               and reskipped == [NAN_STEP]
               and int(state2["step"]) == TOTAL),
        "detail": {
            "corrupted": os.path.relpath(corrupted, tmp),
            "fallback_events": fallback,
            "resumed_from": resumed_from,
            "recomputed_steps": [steps2[0], steps2[-1]] if steps2 else [],
            "losses_match_reference_rtol": RTOL,
            "recompute_ok": recompute_ok,
            "reskipped": reskipped,
        },
    })
    return findings, records


def _train_rank(rank, world, device, dp, sp, tmp, metrics_out):
    try:
        out = _train_scenarios(rank, device, dp, sp, tmp, metrics_out)
    finally:
        # Drop the cached groups before the launcher destroys the process
        # group: a group still referenced then is shut down but freed only
        # at interpreter exit, where its C++ threads may be torn down
        # joinable ("terminate called without an active exception").
        _LAYOUTS.clear()
    return None if out is None else (*out, _launches())


def drill_train_scenarios(tmp, metrics_out=None, *, device="cuda", dp=2,
                          sp=4):
    """The three training findings: one spawn of dp × sp gloo ranks (or
    this process on one device)."""
    if dp * sp == 1:
        return (*_train_scenarios(0, device, 1, 1, tmp, metrics_out), {})
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(_train_rank, dp * sp, backend="gloo", device=device,
                      args=(dp, sp, tmp, metrics_out), timeout_s=900)
    return ranks[0]


def drill_save_ioerror(tmp):
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.resilience import chaos

    tree = {"w": torch.arange(16, dtype=torch.float32)}
    mgr = CheckpointManager(os.path.join(tmp, "flaky"), retries=3,
                            backoff_s=0.01)
    flaky = chaos.FlakySavez(fails=2)
    mgr._savez = flaky
    mgr.save_async(1, tree)
    mgr.wait()                         # retried write: must NOT raise
    out = mgr.restore(1, {"w": torch.zeros((16,), dtype=torch.float32)})
    ok = (flaky.calls == 3 and mgr.latest_step() == 1
          and float(out["w"][7]) == 7.0)
    return [{"name": "save_ioerror_retry", "ok": ok,
             "detail": {"write_attempts": flaky.calls}}]


def drill_kill_mid_save(tmp):
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.resilience import chaos

    tree = {"w": torch.arange(16, dtype=torch.float32)}
    mgr = CheckpointManager(os.path.join(tmp, "killed"), backoff_s=0.01)
    mgr.save(1, tree)
    mgr._savez = chaos.KillingSavez()
    mgr.save_async(2, {"w": tree["w"] * 2})
    surfaced = False
    try:
        mgr.wait()                     # the thread's crash must surface
    except chaos.KillSave:
        surfaced = True
    intact = mgr.latest_step() == 1
    mgr._savez = np.savez
    mgr.save(2, {"w": tree["w"] * 2})  # recovery write
    out = mgr.restore(2, {"w": torch.zeros((16,), dtype=torch.float32)})
    ok = (surfaced and intact and mgr.latest_step() == 2
          and float(out["w"][3]) == 6.0)
    return [{"name": "kill_mid_save", "ok": ok,
             "detail": {"error_surfaced": surfaced,
                        "previous_checkpoint_intact": intact}}]


def drill_straggler(device):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.obs import InMemorySink
    from repro_torch.resilience import chaos

    data = chaos.StragglerData(
        SyntheticLM(drill_config().vocab_size, 32, 4, seed=3),
        at_step=TOTAL - 2, sleep_s=0.5)
    sink = InMemorySink()
    _train(_mk(), device=device, dp=1, sp=1, data=data, sink=sink)
    steps = sink.by_kind("step")
    hit = [r for r in steps if r.get("step") == TOTAL - 2]
    ok = bool(hit) and hit[0].get("data_s", 0.0) >= 0.5 \
        and len(steps) == TOTAL
    return [{"name": "straggler_step", "ok": ok,
             "detail": {"data_phase_wall_s": hit[0].get("data_s")
                        if hit else None}}]


def drill_consecutive_abort(tmp, device):
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.resilience.guard import GuardAbort
    from repro_torch.train.step import init_state

    run = _mk(chaos_nan=tuple(range(2, TOTAL)), max_skips=3)
    ckpt = os.path.join(tmp, "abort_ckpt")
    aborted = False
    try:
        _train(run, device=device, dp=1, sp=1, ckpt_dir=ckpt, seq=32,
               batch=4)
    except GuardAbort:
        aborted = True
    mgr = CheckpointManager(ckpt)
    step = mgr.latest_step()
    ok = aborted and step is not None
    if ok:   # the abort's checkpoint must verify (params are clean)
        target = init_state(torch.Generator().manual_seed(0),
                            drill_config(), device="cpu", run=run)
        restored = mgr.restore(step, target)
        ok = all(bool(torch.isfinite(p).all()) for _, p in
                 leaves_with_paths(restored["params"]))
    return [{"name": "consecutive_skip_abort", "ok": ok,
             "detail": {"aborted": aborted, "checkpoint_step": step}}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.resilience.drill",
        description="fault-injection drill over the port's train loop")
    ap.add_argument("--out", default="drill_report.json",
                    help="findings JSON")
    ap.add_argument("--metrics-out", default=None,
                    help="telemetry JSONL of the recovery run")
    ap.add_argument("--tmp", default=None,
                    help="scratch dir for drill checkpoints (default: a "
                         "fresh TemporaryDirectory)")
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; ranks share the cards) or cpu "
                         "(the plain PyTorch path)")
    args = ap.parse_args(argv)

    import tempfile

    from repro_torch.core.device import resolve_device

    # JsonlSink appends: a re-run must not read the previous drill's
    # records
    if args.metrics_out and os.path.exists(args.metrics_out):
        os.remove(args.metrics_out)

    device = resolve_device(None if args.device == "cuda"
                            else args.device).type
    if device == "cuda":
        from repro_torch.kernels._build import build_kernels
        build_kernels()       # once, before the ranks load the libraries
    findings = []
    with tempfile.TemporaryDirectory() as td:
        tmp = args.tmp or td
        f, _records, launched = drill_train_scenarios(
            tmp, args.metrics_out, device=device, dp=args.dp, sp=args.sp)
        findings += f
        findings += drill_save_ioerror(tmp)
        findings += drill_kill_mid_save(tmp)
        findings += drill_straggler(device)
        findings += drill_consecutive_abort(tmp, device)

    launched = _launches(launched)
    idle = [k for k, r in launched.items() if not sum(r.values())] \
        if device == "cuda" else []
    n_bad = sum(not f["ok"] for f in findings)
    doc = {"kind": "chaos_drill", "mesh": f"{args.dp}x{args.sp}",
           "device": device, "arch": drill_config().name,
           "launches": launched, "rtol": RTOL,
           "passed": n_bad == 0 and not idle, "findings": findings}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2, default=str)
    for fd in findings:
        print(f"[{'ok' if fd['ok'] else 'FAIL'}] {fd['name']}")
        if not fd["ok"]:
            print(f"       {fd['detail']}")
    print(f"kernel launches (rank 0 and this process): {launched}")
    if n_bad or idle:
        print(f"CHAOS DRILL FAILED: {n_bad}/{len(findings)} findings"
              + (f"; never launched on the card: {idle}" if idle else ""),
              file=sys.stderr)
        return 1
    print(f"ALL {len(findings)} CHAOS DRILL FINDINGS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
