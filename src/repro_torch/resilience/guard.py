"""The numerical health guard of the train steps (twin of
``repro/resilience/guard.py``).

Everything here works on values the step already has: 0-d tensors on the
step's device, and the rolling window of recorded gradient norms. Under a
DP×SP layout each rank's loss-health indicator rides as one more fp32
scalar in the step's one gradient all-reduce (``train.grads``), so the
guard adds no collective: gradient non-finiteness needs no local sweep
(NaN and Inf survive the sum), and every rank reaches the same verdict
from the same reduced values.

Semantics per step, given the reduced global gradient norm:

* **skip**: a rank saw a non-finite loss, or the reduced norm or loss is
  non-finite. No update is applied: params, moments and Adam's count
  stay as they were, ``skipped_steps`` and ``consecutive_skips`` count
  up, and ``state["step"]`` still advances (the learning-rate schedule
  keys off it), so a skipped step is exactly a no-op update.
* **spike clip**: once ``GUARD_WARMUP`` finite norms are recorded, a
  finite norm above ``spike_factor ×`` the rolling median is clipped to
  ``min(grad_clip, spike_factor × median)``. The window records the
  post-clip norm, so one spike cannot drag the median.
* **abort**: the loop raises :class:`GuardAbort` when
  ``consecutive_skips`` reaches ``run.guard_max_consecutive_skips``;
  skips never applied an update, so the checkpoint it saves is clean.
"""

from __future__ import annotations

import torch

# Finite steps recorded before the spike detector arms; below this the
# guard only clips to ``grad_clip`` (the unguarded behaviour).
GUARD_WARMUP = 8

# Metric keys every guarded step reports (floats).
GUARD_METRICS = ("skipped_steps", "consecutive_skips", "guard_spike",
                 "guard_median")


class GuardAbort(RuntimeError):
    """Raised by the train loop when ``consecutive_skips`` reaches the
    configured threshold: the run cannot make progress."""


def guard_init(window: int, device=None):
    """The guard's state, carried in the train state (checkpointed like
    any other leaf; the same on every rank, a function of reduced
    values only)."""
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return {
        "norm_window": torch.zeros((window,), dtype=torch.float32,
                                   device=device),
        "window_count": i32(),
        "skipped_steps": i32(),
        "consecutive_skips": i32(),
        "spike_steps": i32(),
    }


def rolling_median(window, count):
    """Median of the ``min(count, len(window))`` recorded norms (the lower
    one of an even count); 0 when empty. Unfilled slots are masked to +inf
    before the sort."""
    w = window.shape[0]
    n = torch.clamp(count, max=w)
    idx = torch.arange(w, device=window.device)
    vals = torch.sort(torch.where(idx < n, window,
                                  torch.full_like(window, float("inf")))
                      ).values
    med = vals[torch.clamp((n - 1) // 2, min=0).long()]
    return torch.where(n > 0, med, torch.zeros_like(med))


def guard_verdict(guard, gnorm, nonfinite, *, grad_clip: float,
                  spike_factor: float, warmup: int = GUARD_WARMUP):
    """The step's guard decision.

    ``gnorm``: the global (reduced) gradient norm, a 0-d fp32 tensor;
    ``nonfinite``: a 0-d bool tensor, True if any rank contributed a
    non-finite loss or gradient.

    Returns ``(scale, ok, new_guard, info)``: multiply the gradients by
    ``scale`` (0 on a skip) and apply the update only if ``ok``; ``info``
    holds the ``GUARD_METRICS`` as 0-d fp32 tensors.
    """
    count = guard["window_count"]
    window = guard["norm_window"]
    med = rolling_median(window, count)
    armed = count >= warmup
    ok = torch.logical_not(nonfinite)
    spike = armed & ok & (gnorm > spike_factor * med)
    limit = torch.where(spike, torch.clamp(spike_factor * med,
                                           max=grad_clip),
                        torch.full_like(med, grad_clip))
    scale = torch.where(
        ok, torch.clamp(limit / torch.clamp(gnorm, min=1e-9), max=1.0),
        torch.zeros_like(limit))

    w = window.shape[0]
    recorded = torch.minimum(gnorm, limit)   # post-clip: spikes can't drag it
    slot = torch.arange(w, device=window.device) == count.long() % w
    new_window = torch.where(ok & slot, recorded, window)
    oki = ok.to(torch.int32)
    new_guard = {
        "norm_window": new_window,
        "window_count": count + oki,
        "skipped_steps": guard["skipped_steps"] + (1 - oki),
        "consecutive_skips": torch.where(
            ok, torch.zeros_like(count), guard["consecutive_skips"] + 1),
        "spike_steps": guard["spike_steps"] + spike.to(torch.int32),
    }
    info = {
        "skipped_steps": new_guard["skipped_steps"].float(),
        "consecutive_skips": new_guard["consecutive_skips"].float(),
        "guard_spike": spike.float(),
        "guard_median": torch.where(armed, med, torch.zeros_like(med)),
    }
    return scale, ok, new_guard, info


# -- deterministic fault injection (drill and tests) ------------------------

def chaos_hit(step: int, steps) -> bool:
    """True iff ``step`` is one of ``steps``."""
    return int(step) in tuple(steps)


@torch.no_grad()
def chaos_poison_nan(flat, step: int, nan_steps):
    """Fill the local gradient ``flat`` with NaN, in place, at the
    scheduled steps: the guard's detection path end to end (the NaN
    survives the gradient reduction and trips the reduced norm's check).
    Returns ``flat``."""
    if chaos_hit(step, nan_steps):
        flat.fill_(float("nan"))
    return flat
