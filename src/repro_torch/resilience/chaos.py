"""Deterministic fault injectors for the chaos drill and tests (twin of
``repro/resilience/chaos.py``).

Host-side counterparts to the step's injection knobs
(``RunConfig.chaos_nan_steps`` / ``chaos_skip_steps``): byte-level
checkpoint corruption, flaky/killed checkpoint writers (plugged into the
``CheckpointManager._savez`` seam), and data-pipeline wrappers that
deliver a SIGTERM or a straggler sleep at an exact step. Everything is
deterministic — a drill run is reproducible bit-for-bit.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Optional

import numpy as np


class KillSave(RuntimeError):
    """Injected hard failure mid-save (simulated crash — NOT retried,
    unlike OSError)."""


# -- checkpoint byte corruption --------------------------------------------

def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    if step is None:
        steps = sorted(int(n[5:]) for n in os.listdir(ckpt_dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def corrupt_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                       n_bytes: int = 64, offset_frac: float = 0.5) -> str:
    """Flip ``n_bytes`` in the middle of a checkpoint's ``arrays.npz``
    (default: the latest step). Returns the corrupted file's path."""
    path = os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")
    size = os.path.getsize(path)
    off = min(int(size * offset_frac), max(size - n_bytes, 0))
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n_bytes)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


def truncate_manifest(ckpt_dir: str, step: Optional[int] = None, *,
                      keep_frac: float = 0.5) -> str:
    """Truncate a checkpoint's ``manifest.json`` mid-document (a torn
    write). Returns the truncated file's path."""
    path = os.path.join(_step_dir(ckpt_dir, step), "manifest.json")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(size * keep_frac), 1))
    return path


# -- checkpoint writer faults (CheckpointManager._savez seam) --------------

class FlakySavez:
    """``np.savez`` stand-in that raises OSError for the first ``fails``
    calls, then writes normally — exercises save retry-with-backoff."""

    def __init__(self, fails: int):
        self.fails = fails
        self.calls = 0

    def __call__(self, file, **arrays):
        self.calls += 1
        if self.calls <= self.fails:
            raise OSError(f"injected save IOError (call {self.calls})")
        return np.savez(file, **arrays)


class KillingSavez:
    """Writes a torn archive prefix then raises :class:`KillSave` —
    simulates the process dying mid-save. The atomic tmp-dir protocol
    must leave the previous checkpoint untouched."""

    def __call__(self, file, **arrays):
        file.write(b"PK\x03\x04 torn write, not a real archive")
        file.flush()
        raise KillSave("injected kill mid-save")


# -- data-pipeline wrappers (delivered at an exact step) -------------------

class _DataWrapper:
    """Delegates the SyntheticLM interface, intercepting per-step
    fetches."""

    def __init__(self, data):
        self._data = data

    def _on_fetch(self, step: int) -> None:   # pragma: no cover - override
        pass

    def batch(self, step: int):
        self._on_fetch(step)
        return self._data.batch(step)

    def microbatched(self, step: int, a: int):
        self._on_fetch(step)
        return self._data.microbatched(step, a)

    def __getattr__(self, name):
        return getattr(self._data, name)


class InterruptData(_DataWrapper):
    """Raises ``signum`` in the main thread when step ``at_step``'s batch
    is fetched — the train loop's handler finishes the step, saves a
    final checkpoint, and exits cleanly (the preemption path)."""

    def __init__(self, data, at_step: int,
                 signum: int = signal.SIGTERM):
        super().__init__(data)
        self.at_step = at_step
        self.signum = signum

    def _on_fetch(self, step: int) -> None:
        if step == self.at_step:
            signal.raise_signal(self.signum)


class StragglerData(_DataWrapper):
    """Sleeps ``sleep_s`` when step ``at_step``'s batch is fetched — an
    injected input-pipeline straggler, visible in the step record's
    ``data`` phase wall."""

    def __init__(self, data, at_step: int, sleep_s: float = 1.0):
        super().__init__(data)
        self.at_step = at_step
        self.sleep_s = sleep_s

    def _on_fetch(self, step: int) -> None:
        if step == self.at_step:
            time.sleep(self.sleep_s)
