"""Fault-tolerant training loop (twin of ``repro/train/loop.py``).

* auto-resume from the latest checkpoint (``batch(step)`` is a pure
  function, so a resumed run is bitwise identical), falling back to the
  newest valid checkpoint when the latest is corrupt;
* periodic async checkpointing (atomic, crash-safe) and a final one;
* a step watchdog: step walls are tracked and slow steps logged;
* non-finite steps are skipped inside the step;
* SIGTERM or KeyboardInterrupt → final checkpoint, clean exit.

Runs on the CUDA card unless ``device`` names another one; without a card
it raises. With a ``layout`` (``launch.mesh.TrainingGroups``) this rank
runs the DP×SP step on its rows and chunk of the same seeded global batch
every rank draws. The reference's ``sink=`` telemetry comes with a later
slice.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import SyntheticLM
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


def train(cfg: ModelConfig, run: RunConfig, data: SyntheticLM, *,
          device=None, params=None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10,
          log_fn: Callable[[str], None] = print, max_steps=None,
          layout=None):
    """Returns ``(final_state, history)``, one metrics dict per step (loss,
    grad_norm, lr, skipped, step, dt in host seconds after the step's
    device work).

    ``params``: initial fp32 master params on ``device`` (e.g. carried
    across from the reference with ``params_from_jax``); by default they
    are drawn by ``init_params`` from a generator seeded with
    ``run.seed`` (the same params on every rank).
    """
    if cfg.encoder is not None or cfg.n_image_tokens:
        raise ValueError(
            f"{cfg.name}: train() feeds SyntheticLM batches, which carry no "
            f"encoder frames or image embeddings, and this model needs them "
            f"(the reference's loop fails on it too); train the cross family "
            f"with train.step.make_train_step and 'frames' / 'img' in each "
            f"microbatch")
    device = resolve_device(device)
    if ckpt_dir and layout is not None and layout.world > 1:
        raise NotImplementedError(
            "checkpoints of a DP×SP run (restore onto another layout) are "
            "ported with M9")
    zero1 = zero1_degree(run, layout)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(run.seed)
        state = init_state(gen, cfg, device=device, zero1=zero1)
    else:
        where = {p.device for _, p in leaves_with_paths(params)}
        if where != {device}:
            raise ValueError(f"params on {sorted(map(str, where))}, the run "
                             f"on {device}")
        state = state_from_params(params, zero1)
    start_step = 0

    mgr = CheckpointManager(ckpt_dir, verify=run.ckpt_verify) \
        if ckpt_dir else None
    if mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            try:
                state = mgr.restore(latest, state)
                start_step = latest
            except (CheckpointError, ValueError) as e:
                log_fn(f"[resume] checkpoint step {latest} invalid "
                       f"({type(e).__name__}); falling back")
                start_step, state, rejected = mgr.restore_latest_valid(state)
                log_fn(f"[resume] fell back to step {start_step} "
                       f"(rejected {[s for s, _ in rejected]})")
            log_fn(f"[resume] restored step {start_step} from {ckpt_dir}")

    step_fn = make_train_step(cfg, run, layout)
    watchdog = StepWatchdog()
    history = []
    total = max_steps if max_steps is not None else run.total_steps
    stop = {"now": False}

    def _sig(_sig, _frm):
        stop["now"] = True

    old_handler = signal.signal(signal.SIGTERM, _sig)
    try:
        for step in range(start_step, total):
            batch = data.microbatched(step, run.num_microbatches)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            synchronize(device)
            dt = time.perf_counter() - t0
            slow = watchdog.record(dt)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, state)
            metrics["step"], metrics["dt"] = step, dt
            history.append(metrics)
            if metrics["skipped"]:
                log_fn(f"[skip] step {step} skipped (non-finite update)")
            if slow:
                log_fn(f"[watchdog] step {step} straggled: {dt:.2f}s")
            if step % log_every == 0:
                log_fn(f"step {step:5d} loss {metrics['loss']:.4f} "
                       f"gnorm {metrics['grad_norm']:.2f} "
                       f"lr {metrics['lr']:.2e} {dt * 1e3:.0f}ms")
            if stop["now"]:
                log_fn(f"[signal] interrupted at step {step}; saving")
                break
    except KeyboardInterrupt:
        log_fn("[interrupt] saving final checkpoint")
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if mgr is not None:
            mgr.wait()
            mgr.save(int(state["step"]), state)
    return state, history
