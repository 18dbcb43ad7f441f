"""Fault-tolerant training loop (twin of ``repro/train/loop.py``).

* auto-resume from the latest checkpoint (``batch(step)`` is a pure
  function, so a resumed run is bitwise identical), falling back to the
  newest valid checkpoint when the latest is corrupt;
* periodic async checkpointing (atomic, crash-safe) and a final one
  (not written again when the last periodic save holds the same step);
* a step watchdog: step walls are tracked and slow steps logged;
* non-finite steps are skipped inside the step; with ``run.guard`` the
  loop logs each skip and raises ``GuardAbort`` after
  ``run.guard_max_consecutive_skips`` consecutive ones, the final
  checkpoint saved;
* SIGTERM or KeyboardInterrupt → final checkpoint, clean exit;
* optional telemetry (``sink=``): per-step records with phase walls
  (data / step / ckpt), tokens/s and MFU against the card's peak, the
  flight recorder's ``compile`` record (the first step's tape against its
  issued collectives), ``event`` records and a ``summary``. With
  ``sink=None`` the loop takes no tape, fences nothing and emits nothing.

Runs on the CUDA card unless ``device`` names another one; without a card
it raises. With a ``layout`` (``launch.mesh.TrainingGroups``) this rank
runs the DP×SP(×TP) step on its rows and chunk of the same seeded
global batch every rank draws; checkpoints are layout-independent
(``checkpoint.manager``: under ZeRO-1 the moments are gathered over the
zero group on save steps, rank 0 writes, every rank restores its slice),
so a run written at (1, 2, 2) resumes at (2, 2) or on one device and the
other way round; only rank 0
emits telemetry. The final save is a collective, so every rank must
reach it at the same step: after each step the ranks agree, in one
all-reduce of two flags, on whether any of them was sent SIGTERM or
failed a checkpoint write, and all stop (or all raise) at that step. A
rank that leaves the loop on an exception the others need not share (a
KeyboardInterrupt, an error in its step) saves nothing; ``GuardAbort``
is shared by construction (every rank reaches the same verdict) and
saves.
"""

from __future__ import annotations

import signal
import time
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointError,
                                            CheckpointManager, gather_zero1,
                                            zero1_shards)
from repro_torch.comm import primitives
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.obs.metrics import to_host
from repro_torch.resilience.guard import GuardAbort
from repro_torch.train.step import init_state, make_train_step, \
    state_from_params, zero1_degree


class StepWatchdog:
    """Tracks step durations; flags stragglers (> factor × median).

    The first ``warmup`` durations (kernel builds, resume spikes) are
    never flagged and never enter the rolling window, so a one-off outlier
    cannot poison the median later steps are judged against.
    """

    def __init__(self, factor: float = 3.0, window: int = 50,
                 warmup: int = 1):
        self.times, self.factor, self.window = [], factor, window
        self.warmup = warmup
        self.seen = 0
        self.slow_steps = 0

    def record(self, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        self.times.append(dt)
        self.times = self.times[-self.window:]
        med = float(np.median(self.times))
        slow = len(self.times) >= 10 and dt > self.factor * med
        self.slow_steps += int(slow)
        return slow


def _is_rank0(layout) -> bool:
    if layout is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def train(cfg: ModelConfig, run: RunConfig, data: SyntheticLM, *,
          device=None, params=None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10,
          log_fn: Callable[[str], None] = print, max_steps=None,
          layout=None, sink=None):
    """Returns ``(final_state, history)``, one metrics dict per step (loss,
    grad_norm, lr, skipped, the ``GUARD_METRICS`` under the guard, step,
    dt in host seconds after the step's device work).

    ``params``: initial fp32 master params on ``device`` (e.g. carried
    across from the reference with ``params_from_jax``); by default they
    are drawn by ``init_params`` from a generator seeded with
    ``run.seed`` (the same params on every rank).

    ``sink``: an ``obs.MetricsSink`` (rank 0's is used under a layout; the
    caller owns its lifetime). The first step runs under the comm tape and
    the issued view, and the flight recorder's ``compile`` record compares
    them; every step emits a ``step`` record (phase walls, tokens/s,
    MFU); resume, checkpoint fallback, guard skip and abort, signal and
    interrupt emit ``event`` records; the run ends with a ``summary``.
    """
    if cfg.encoder is not None or cfg.n_image_tokens:
        raise ValueError(
            f"{cfg.name}: train() feeds SyntheticLM batches, which carry no "
            f"encoder frames or image embeddings, and this model needs them "
            f"(the reference's loop fails on it too); train the cross family "
            f"with train.step.make_train_step and 'frames' / 'img' in each "
            f"microbatch")
    device = resolve_device(device)
    zero1 = zero1_degree(run, layout)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        state = init_state(gen, cfg, device=device, zero1=zero1, run=run)
    else:
        where = {p.device for _, p in leaves_with_paths(params)}
        if where != {device}:
            raise ValueError(f"params on {sorted(map(str, where))}, the run "
                             f"on {device}")
        state = state_from_params(params, zero1, run)
    start_step = 0

    recorder = timer = None
    if sink is not None and _is_rank0(layout):
        from repro_torch.obs import FlightRecorder, PhaseTimer
        from repro_torch.obs.flops import model_flops, peak_flops
        shape = ShapeConfig("train-run", data.seq_len, data.global_batch,
                            "train")
        recorder = FlightRecorder(
            sink, model_flops_per_step=model_flops(cfg, shape),
            n_devices=layout.world if layout is not None else 1,
            peak_flops=peak_flops(cfg.dtype))
        timer = PhaseTimer()
    phase = timer.phase if timer is not None else (lambda _n: nullcontext())
    event = recorder.event if recorder is not None else (lambda *a, **k: None)
    tokens_per_step = data.global_batch * data.seq_len

    mgr = CheckpointManager(ckpt_dir, verify=run.ckpt_verify) \
        if ckpt_dir else None
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            shards = zero1_shards(state, layout)
            try:
                state = mgr.restore(latest, state, shards=shards)
                start_step = latest
            except (CheckpointError, ValueError) as e:
                log_fn(f"[resume] checkpoint step {latest} invalid "
                       f"({type(e).__name__}); falling back")
                start_step, state, rejected = mgr.restore_latest_valid(
                    state, shards=shards)
                log_fn(f"[resume] fell back to step {start_step} "
                       f"(rejected {[s for s, _ in rejected]})")
                event("ckpt_fallback", bad_step=latest,
                      restored_step=start_step,
                      rejected=[s for s, _ in rejected],
                      error=type(e).__name__)
            log_fn(f"[resume] restored step {start_step} from {ckpt_dir}")
            event("resume", step=start_step, ckpt_dir=ckpt_dir)

    saved = {"step": None}

    def save(step: int, asynchronous: bool) -> None:
        # every rank joins ZeRO-1's gather; rank 0 writes
        tree = gather_zero1(state, layout)
        if _is_rank0(layout):
            (mgr.save_async if asynchronous else mgr.save)(step, tree)
        saved["step"] = step

    def agree(*flags) -> list:
        """Each flag as any rank holds it: one all-reduce over the layout's
        world; on one device the flags as they are."""
        if layout is None:
            return [bool(f) for f in flags]
        t = torch.tensor([float(bool(f)) for f in flags], device=device)
        primitives.psum_packed(t, layout.world_group, tag="train.agree")
        return [bool(x > 0) for x in t.tolist()]

    def write_failed(err):
        """Under a layout, the error every rank raises when any rank's
        checkpoint write failed (rank 0 raises its own)."""
        return err if err is not None else RuntimeError(
            "a checkpoint write failed on rank 0")

    def final_save() -> None:
        err = None
        try:
            mgr.wait()
        except Exception as e:
            if layout is None:
                raise
            err = e
        (failed,) = agree(err is not None)
        if failed:
            raise write_failed(err)
        if saved["step"] != int(state["step"]):
            save(int(state["step"]), asynchronous=False)

    step_fn = make_train_step(cfg, run, layout)
    watchdog = StepWatchdog()
    history = []
    skipped_total = 0
    total = max_steps if max_steps is not None else run.total_steps
    stop = {"now": False}

    def _sig(_sig, _frm):
        stop["now"] = True

    old_handler = signal.signal(signal.SIGTERM, _sig)
    shared_exit = True     # every rank leaves the loop at the same step
    try:
        for step in range(start_step, total):
            with phase("data"):
                batch = data.microbatched(step, run.num_microbatches)
            first = recorder is not None and recorder.snapshot is None
            t0 = time.perf_counter()
            with phase("step") as fence, \
                    (primitives.tape() if first else nullcontext()) as taped, \
                    (primitives.issued() if first else nullcontext()) as sent:
                state, metrics = step_fn(state, batch)
                if fence is not None:
                    fence.set(state["params"])
            synchronize(device)
            dt = time.perf_counter() - t0
            metrics = to_host(metrics)
            if first:
                recorder.on_compile(records=taped, issued=sent,
                                    note=f"{cfg.name} train step")
            slow = watchdog.record(dt)
            write_err = None
            with phase("ckpt"):
                if mgr is not None and (step + 1) % ckpt_every == 0:
                    try:
                        save(step + 1, asynchronous=True)
                    except Exception as e:
                        if layout is None:
                            raise
                        write_err = e
            rec = None
            if recorder is not None:
                rec = recorder.on_step(step, dt, tokens=tokens_per_step,
                                       phases=timer.flush(),
                                       metrics=metrics, straggler=slow)
            metrics["step"], metrics["dt"] = step, dt
            history.append(metrics)
            skipped_total += int(metrics["skipped"])
            if metrics["skipped"]:
                consec = int(metrics.get("consecutive_skips", 0))
                log_fn(f"[guard] step {step} skipped (non-finite update; "
                       f"consecutive {max(consec, 1)})")
                event("guard_skip", step=step, consecutive=consec,
                      total=skipped_total)
                if run.guard and consec >= run.guard_max_consecutive_skips:
                    # skips never applied an update, so the final
                    # checkpoint (the finally block) is clean
                    event("guard_abort", step=step, consecutive=consec)
                    raise GuardAbort(
                        f"{consec} consecutive skipped steps at step {step} "
                        f"(threshold {run.guard_max_consecutive_skips}): "
                        f"the run cannot make progress; a final checkpoint "
                        f"was saved")
            if slow:
                log_fn(f"[watchdog] step {step} straggled: {dt:.2f}s")
            if step % log_every == 0:
                if rec is not None:
                    from repro_torch.obs import render_step
                    log_fn(render_step(rec))
                else:
                    log_fn(f"step {step:5d} loss {metrics['loss']:.4f} "
                           f"gnorm {metrics['grad_norm']:.2f} "
                           f"lr {metrics['lr']:.2e} {dt * 1e3:.0f}ms")
            if layout is not None:
                stop["now"], failed = agree(stop["now"], write_err is not None)
                if failed:
                    shared_exit = False   # no final save after a failed one
                    raise write_failed(write_err)
            if stop["now"]:
                log_fn(f"[signal] interrupted at step {step}; saving")
                event("signal", step=step, signal="SIGTERM")
                break
    except KeyboardInterrupt:
        event("interrupt")
        if layout is not None:
            # the other ranks may stand at another step: no collective save
            log_fn("[interrupt] under a layout: no final checkpoint")
            shared_exit = False
            raise
        log_fn("[interrupt] saving final checkpoint")
    except GuardAbort:
        raise
    except BaseException:
        shared_exit = layout is None
        raise
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if mgr is not None and shared_exit:
            final_save()
        if recorder is not None:
            recorder.summary(final_step=int(state["step"]),
                             slow_steps=watchdog.slow_steps,
                             skipped_steps=skipped_total,
                             **{f"phase_{k}_{s}": v
                                for k, h in timer.summaries().items()
                                for s, v in h.items()})
    return state, history
