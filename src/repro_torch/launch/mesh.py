"""Rank layouts and process groups of the DP×SP step, and a rank launcher
(twin of ``repro/launch/mesh.py``).

A rank is a process. A (dp, sp) layout puts global rank ``r`` at data
index ``r // sp`` and sequence-chunk index ``r % sp``: the reference's
(data, sequence) mesh order, sequence minor. The SP group of a rank holds
the ``sp`` ranks of its data index (the ranks that share its rows), its
data group the ``dp`` ranks of its chunk index.
"""

from __future__ import annotations

import datetime
import multiprocessing
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TrainingGroups:
    """This rank's place in a (dp, sp) layout and its process groups."""

    dp: int
    sp: int
    data_index: int
    chunk_index: int
    sp_group: Any       # the sp ranks of this data index, chunk order
    dp_group: Any       # the dp ranks of this chunk index, data order
    world_group: Any    # every rank

    @property
    def world(self) -> int:
        return self.dp * self.sp


def make_training_groups(dp_degree: int, sp_degree: int) -> TrainingGroups:
    """The groups of a (dp, sp) layout over the initialised world. Every
    rank creates every group, in the same order (``new_group`` is
    collective)."""
    world = dist.get_world_size()
    if dp_degree < 1 or sp_degree < 1 or dp_degree * sp_degree != world:
        raise ValueError(f"dp_degree×sp_degree = {dp_degree}×{sp_degree} "
                         f"must equal the world size {world}")
    rank = dist.get_rank()
    d, t = divmod(rank, sp_degree)
    sp_groups = [dist.new_group([i * sp_degree + j
                                 for j in range(sp_degree)])
                 for i in range(dp_degree)]
    dp_groups = [dist.new_group([i * sp_degree + j
                                 for i in range(dp_degree)])
                 for j in range(sp_degree)]
    return TrainingGroups(dp=dp_degree, sp=sp_degree, data_index=d,
                          chunk_index=t, sp_group=sp_groups[d],
                          dp_group=dp_groups[t], world_group=dist.group.WORLD)


# ---------------------------------------------------------------------------
# Rank launcher: processes on this host, one process group.
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, backend, device, timeout_s, store,
               out, args):
    """One rank: join the group, run ``fn``, save its result or its
    traceback, leave the group."""
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
            # the ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world_size, dev, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"result{rank}.pt")
    except BaseException:
        (out / f"error{rank}.txt").write_text(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world_size: int, *, backend: str = "gloo",
              device: str = "cpu", args=(), timeout_s: float = 600.0
              ) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size``
    spawned processes joined in one process group (``backend``; its store
    a file under a new temporary directory, so concurrent launches never
    share a port or a store). ``device``: "cpu", or "cuda" (rank r on card
    ``r % device_count``). ``fn`` and ``args`` are pickled, so ``fn`` must
    be importable by name.

    Returns each rank's result (``torch.save``-able), in rank order. A
    rank that raises exits nonzero; the others are then stopped (they may
    wait on it in a collective) and this raises ``RuntimeError`` with the
    failed ranks' tracebacks. So does a launch that outlives
    ``timeout_s``.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        out = Path(tmp)
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world_size, backend, device, timeout_s,
            str(out / "store"), out, tuple(args))) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            errors = "".join(
                f"--- rank {r} ---\n{(out / f'error{r}.txt').read_text()}"
                for r in range(world_size)
                if (out / f"error{r}.txt").exists())
            raise RuntimeError(f"ranks exited with {codes}"
                               + (f":\n{errors}" if errors else
                                  " (stopped or timed out)"))
        return [torch.load(out / f"result{r}.pt", weights_only=False)
                for r in range(world_size)]

