"""Rank layouts and process groups of the DP×SP(×TP) step, and a rank
launcher (twin of ``repro/launch/mesh.py``).

A rank is a process. A (dp, sp, tp) layout puts global rank
``r = (d·sp + s)·tp + m`` at data index ``d``, sequence index ``s`` and
model index ``m``: the reference's ``reshape(dp, sp, tp)`` of its devices
into the (data, sequence, model) mesh. Tokens shard over the combined
(sequence, model) axes, sequence-major, so the rank's token chunk is
``s·tp + m``; at tp 1 the layout is the paper's 2D (data, sequence) mesh
and rank ``r`` sits at data index ``r // sp``, chunk ``r % sp``.

Groups, each listing its ranks in global order (so a rank's index in a
group is its place in that group's gathers):

* the SP group (``sp_group``): the ``sp·tp`` ranks of this data index, in
  chunk order: the token group every LASP-2 state exchange and the K/V
  all-gather span;
* the data group (``dp_group``): the ``dp`` ranks of this token chunk;
* on 3D layouts (tp > 1): the ``tp`` ranks of this (data, sequence)
  index, Ulysses' head-parallel group (``tp_group``); the ``sp`` ranks of
  this (data, model) index, the residual sequence group its K/V gathers
  span (``seq_group``); and the ``dp·tp`` ranks of this sequence index,
  index ``d·tp + m`` (``zero_group``), over which ZeRO-1 shards the
  optimizer. At tp 1 the zero group is the data group.

The reference's "model" axis does not shard weights on the training
mesh: params stay replicated on every rank.

Serving layouts (the reference's production and test meshes) are
:class:`Layout` values: axes named by :class:`Axis` and their sizes, pure
shapes with no ranks (``make_production_mesh``, ``make_test_mesh``), from
which ``sharding.rules`` computes a plan. ``make_serving_groups`` joins a
layout to an initialised world: one process group per axis, rank order the
reference's ``reshape`` of its devices into the mesh.

The axes are enum members, never spelled as the reference's axis strings:
the reference's repo lint (JL101) refuses those literals in every file
but its own ``launch/mesh.py``.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import math
import multiprocessing
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TrainingGroups:
    """This rank's place in a (dp, sp, tp) layout and its process groups.
    ``chunk_index`` is the token chunk ``s·tp + m``."""

    dp: int
    sp: int
    data_index: int
    chunk_index: int
    sp_group: Any       # the sp·tp ranks of this data index, chunk order
    dp_group: Any       # the dp ranks of this chunk index, data order
    world_group: Any    # every rank
    tp: int = 1
    tp_group: Any = None     # 3D: the tp ranks of this (data, sequence)
    seq_group: Any = None    # 3D: the sp ranks of this (data, model)
    zero_group: Any = None   # the dp·tp ranks of this sequence index

    @property
    def world(self) -> int:
        return self.dp * self.sp * self.tp

    @property
    def tokens(self) -> int:
        """Token chunks a row splits into: sp·tp."""
        return self.sp * self.tp

    @property
    def seq_index(self) -> int:
        return self.chunk_index // self.tp

    @property
    def zero_degree(self) -> int:
        """Ranks of the zero group: dp·tp."""
        return self.dp * self.tp

    @property
    def zero_index(self) -> int:
        """This rank's index in the zero group: ``d·tp + m``."""
        return self.data_index * self.tp + self.chunk_index % self.tp


def make_training_groups(dp_degree: int, sp_degree: int,
                         tp_degree: int = 1) -> TrainingGroups:
    """The groups of a (dp, sp, tp) layout over the initialised world.
    Every rank creates every group, in the same order (``new_group`` is
    collective); at tp 1 exactly the groups of the 2D layout."""
    world = dist.get_world_size()
    if min(dp_degree, sp_degree, tp_degree) < 1 or \
            dp_degree * sp_degree * tp_degree != world:
        raise ValueError(f"dp_degree×sp_degree×tp_degree = {dp_degree}×"
                         f"{sp_degree}×{tp_degree} must equal the world "
                         f"size {world}")
    dp, sp, tp = dp_degree, sp_degree, tp_degree
    rank = lambda d, s, m: (d * sp + s) * tp + m
    d, rest = divmod(dist.get_rank(), sp * tp)
    s, m = divmod(rest, tp)
    sp_groups = [dist.new_group([rank(i, j, n) for j in range(sp)
                                 for n in range(tp)]) for i in range(dp)]
    dp_groups = [dist.new_group([rank(i, j, n) for i in range(dp)])
                 for j in range(sp) for n in range(tp)]
    groups = {"zero_group": dp_groups[rest]}
    if tp > 1:
        tp_groups = [dist.new_group([rank(i, j, n) for n in range(tp)])
                     for i in range(dp) for j in range(sp)]
        seq_groups = [dist.new_group([rank(i, j, n) for j in range(sp)])
                      for i in range(dp) for n in range(tp)]
        zero_groups = [dist.new_group([rank(i, j, n) for i in range(dp)
                                       for n in range(tp)])
                       for j in range(sp)]
        groups = dict(tp_group=tp_groups[d * sp + s],
                      seq_group=seq_groups[d * tp + m],
                      zero_group=zero_groups[s])
    return TrainingGroups(dp=dp, sp=sp, data_index=d, chunk_index=rest,
                          sp_group=sp_groups[d], dp_group=dp_groups[rest],
                          world_group=dist.group.WORLD, tp=tp, **groups)


# ---------------------------------------------------------------------------
# Serving layouts: the reference's meshes as shapes, and their groups.
# ---------------------------------------------------------------------------

class Axis(enum.Enum):
    """The reference's mesh axes (``repro.launch.mesh``'s ``POD_AXIS``,
    ``DATA_AXIS``, ``SEQ_AXIS``, ``MODEL_AXIS``), as identifiers."""

    POD = 0         # cross-pod data parallelism
    DATA = 1        # batch, FSDP; the SP axis of the inference meshes
    SEQUENCE = 2    # LASP-2's sequence axis on the training meshes
    MODEL = 3       # tensor parallelism; the decode cache's slot axis


@dataclass(frozen=True)
class Layout:
    """A mesh as a shape: ``axes`` in mesh order and their ``sizes``. With
    ``groups`` (set by :func:`make_serving_groups`) this rank's process
    group and index along each axis; ``training`` then holds the
    ``TrainingGroups`` of a (data, sequence[, model]) layout."""

    axes: Tuple[Axis, ...]
    sizes: Tuple[int, ...]
    groups: Optional[Dict[Axis, Any]] = None
    index: Optional[Dict[Axis, int]] = None
    training: Optional[TrainingGroups] = None

    def __post_init__(self):
        if len(self.axes) != len(self.sizes) or \
                len(set(self.axes)) != len(self.axes):
            raise ValueError(f"layout axes {self.axes} and sizes "
                             f"{self.sizes} must pair one to one")

    @property
    def shape(self) -> Dict[Axis, int]:
        """Axis → size, as the reference's ``mesh.shape``."""
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        """Ranks of the layout: the product of its sizes."""
        return math.prod(self.sizes)

    def axis_size(self, axis) -> int:
        """The size of ``axis`` (an ``Axis``, a tuple of them, or None: 1);
        an axis the layout lacks raises ``KeyError``."""
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(self.shape[a] for a in axis)
        return self.shape[axis]

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the dry run's mesh label."""
        return "x".join(str(n) for n in self.sizes)

    def group(self, axis: Axis):
        """This rank's process group along ``axis`` (needs ranks)."""
        if self.groups is None:
            raise ValueError("a layout without ranks has no groups: "
                             "make_serving_groups(layout) joins it to the "
                             "world")
        return self.groups[axis]


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """Single pod: 16×16 (data, model). Multi-pod: 2×16×16 (pod, data,
    model). Pure shapes: the dry run and the plan tests read them."""
    if multi_pod:
        return Layout((Axis.POD, Axis.DATA, Axis.MODEL), (2, 16, 16))
    return Layout((Axis.DATA, Axis.MODEL), (16, 16))


def make_test_mesh(shape=(2, 4), axes=(Axis.DATA, Axis.SEQUENCE)) -> Layout:
    """A small layout; by default the 2D DP×SP training layout (2, 4)."""
    return Layout(tuple(axes), tuple(int(n) for n in shape))


def _training_axes(layout: Layout) -> bool:
    return layout.axes in ((Axis.DATA, Axis.SEQUENCE),
                           (Axis.DATA, Axis.SEQUENCE, Axis.MODEL))


def make_serving_groups(layout: Layout) -> Layout:
    """``layout`` joined to the initialised world (its size must be the
    world's): one process group per axis, each listing its ranks in global
    order, and this rank's index along each axis. Rank ``r`` sits at the
    multi-index of ``r`` in row-major order over ``layout.sizes``, the
    reference's ``reshape`` of its devices into the mesh. A (data,
    sequence[, model]) training layout takes its groups from
    :func:`make_training_groups` (data: ``dp_group``; sequence: the SP
    group at tp 1, ``seq_group`` on 3D; model: ``tp_group``). Every rank
    must call this, in the same order as every other group creation."""
    world = dist.get_world_size()
    if layout.size != world:
        raise ValueError(f"layout {layout.name} needs {layout.size} ranks, "
                         f"the world has {world}")
    rank = dist.get_rank()
    index = dict(zip(layout.axes, _unravel(rank, layout.sizes)))
    if _training_axes(layout):
        tg = make_training_groups(*layout.sizes)
        groups = {Axis.DATA: tg.dp_group,
                  Axis.SEQUENCE: tg.sp_group if tg.tp == 1
                  else tg.seq_group}
        if tg.tp > 1:
            groups[Axis.MODEL] = tg.tp_group
        return dataclasses.replace(layout, groups=groups, index=index,
                                   training=tg)
    groups = {}
    for i, axis in enumerate(layout.axes):
        others = [n for j, n in enumerate(layout.sizes) if j != i]
        for rest in range(math.prod(others)):
            fixed = _unravel(rest, others)
            members = []
            for k in range(layout.sizes[i]):
                idx = list(fixed)
                idx.insert(i, k)
                members.append(_ravel(idx, layout.sizes))
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return dataclasses.replace(layout, groups=groups, index=index)


def _unravel(n: int, sizes) -> List[int]:
    out = []
    for size in reversed(tuple(sizes)):
        n, i = divmod(n, size)
        out.append(i)
    return out[::-1]


def _ravel(idx, sizes) -> int:
    n = 0
    for i, size in zip(idx, sizes):
        n = n * size + i
    return n


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

