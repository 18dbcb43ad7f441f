"""Logical-axis sharding rules and plans per (shape kind × layout).

Twin of ``repro/sharding/rules.py``. The reference's story holds:

* ``Axis.POD`` — pure data parallelism across pods;
* ``Axis.DATA`` — FSDP weight sharding plus batch DP (training, decode)
  or the paper's sequence parallelism (prefill, long context);
* ``Axis.MODEL`` — tensor parallelism (heads, d_ff, vocab, experts); for
  decode with few KV heads it instead shards the ring cache's slot dim
  (the flash-decoding merge in ``core.lasp2h``).

Every rule degrades as the reference's does: an axis applies to a tensor
dim only if the axis's size divides the dim (:func:`fit_spec`).

The reference places tensors through GSPMD. The port runs explicit ranks
(``launch.mesh.make_serving_groups``), so a plan is applied in part:

* applied: ``plan.sp`` splits a prompt's tokens over the SP axis's group
  (LASP-2 for linear and SSD layers, LASP-2H for softmax layers), and
  every ``cache_seq`` placement slices the softmax rings' slot dim over
  that axis's group (the ring stays whole when its length does not
  divide), read back through ``ring_decode_attention(sp=)``;
* computed, not applied: weights over fsdp or tp, batch over data, heads,
  ff, vocab and experts over model. Every rank holds all weights and the
  whole slot grid; :func:`param_specs` and ``launch.cells.cache_specs``
  report what those placements would put on a rank.

A layout without ranks (``make_production_mesh``) gives a plan whose
rules, specs and SP axes are the reference's, with ``plan.sp`` None.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.comm.spec import CommSpec
from repro_torch.core.lasp2 import SPConfig
from repro_torch.launch.mesh import Axis, Layout

POD, DATA, SEQ, MODEL = Axis.POD, Axis.DATA, Axis.SEQUENCE, Axis.MODEL


class Spec:
    """A partition spec: one entry per tensor dim (an ``Axis``, a tuple of
    them, or None), as the reference's ``PartitionSpec``. A leaf of the
    spec trees (not a tuple, so the tree helpers do not descend into
    it)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, Spec) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"


def fit_spec(layout: Layout, shape, spec: Spec) -> Spec:
    """Drop spec entries whose axis size does not divide the dim; a
    compound entry keeps its longest prefix that divides."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fitted = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            fitted.append(None)
        elif dim % layout.axis_size(ax) == 0:
            fitted.append(ax)
        elif isinstance(ax, tuple):
            kept = None
            for cut in range(len(ax) - 1, 0, -1):
                sub = tuple(ax[:cut])
                if dim % layout.axis_size(sub) == 0:
                    kept = sub if len(sub) > 1 else sub[0]
                    break
            fitted.append(kept)
        else:
            fitted.append(None)
    return Spec(*fitted)


@dataclass
class Parallelism:
    """Everything the model needs to know about distribution.

    ``rules`` maps logical dims to axes. ``sp_axes`` are the axes the
    sequence splits over (empty: no SP), ``sp_manual`` the manual
    DP×SP(×TP) train plan, whose caller already holds per-rank chunks.
    ``sp`` is the ``core.lasp2.SPConfig`` over the SP group, set only
    when the layout has ranks. The reference's ``backend`` and
    ``banded_windows`` have no twin: the backend follows the tensors, and
    the flash kernels' band skips the blocks the banded form skips.
    """

    layout: Optional[Layout] = None
    rules: dict = field(default_factory=dict)
    sp: Optional[SPConfig] = None
    sp_axes: tuple = ()
    sp_manual: bool = False
    comm: CommSpec = field(default_factory=CommSpec)
    fsdp_axis: Optional[Axis] = DATA
    tp_axis: Optional[Axis] = MODEL
    dp_axes: tuple = (POD, DATA)
    decode_cache_axis: Optional[Axis] = None
    manual_axes: tuple = ()
    zero1_axis: Optional[object] = None     # Axis | tuple[Axis, ...] | None

    def act(self, x, *dims):
        """The identity. The reference constrains ``x``'s sharding by its
        logical dims for GSPMD; a rank here holds what its plan applies
        already (its sequence chunk, its ring slice) and replicates the
        rest, so there is nothing to constrain."""
        return x

    @property
    def sp_degree(self) -> int:
        """Ranks the sequence splits over (1 without SP)."""
        if not self.sp_axes:
            return 1
        return math.prod(self.layout.axis_size(a) for a in self.sp_axes)

    def sp_for(self, seq_len: int):
        """The SP config iff ``seq_len`` divides by the SP degree (e.g.
        whisper's 1500 encoder frames stay local); under the manual train
        plan ``seq_len`` is already a chunk, and the config returns
        whenever the degree exceeds 1."""
        if self.sp is None:
            return None
        if self.sp_manual:
            return self.sp if self.sp_degree > 1 else None
        if seq_len % self.sp_degree == 0:
            return self.sp
        return None

    def tp_size(self) -> int:
        if self.layout is None or self.tp_axis is None:
            return 1
        return self.layout.axis_size(self.tp_axis)

    def divisible(self, n: int) -> bool:
        return n % max(self.tp_size(), 1) == 0

    def cache_sp(self) -> Optional[SPConfig]:
        """The ``SPConfig`` over the group of the axis the softmax rings'
        slot dim is placed on (the ``cache_seq`` rule: the SP axis under
        the prefill plan, model under the decode plan when the KV heads do
        not divide it), or None: no such rule, no ranks, or an axis of
        size 1."""
        ax = self.rules.get("cache_seq")
        if ax is None or self.layout is None or self.layout.groups is None \
                or self.layout.axis_size(ax) == 1:
            return None
        if self.sp is not None and self.sp_axes == (ax,):
            return self.sp
        return SPConfig(self.layout.group(ax), comm=self.comm)


def local_plan() -> Parallelism:
    """One-device plan (tests, smoke configs)."""
    return Parallelism(layout=None)


# ---------------------------------------------------------------------------
# Parameter partition specs (by path name).
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "wx", "wz", "w1", "w3", "w_gate", "w_up"}
_ROW = {"wo", "w2", "wout", "w_down"}


def _spec_for(path: str, shape, plan: Parallelism) -> Spec:
    """Partition spec of one parameter; ``path`` is '/'-joined keys.
    Column-parallel weights (fsdp, tp); row-parallel (tp, fsdp);
    embeddings (tp on vocab, fsdp); MoE experts carry a leading expert
    dim on tp; biases and norms replicate. The port keeps one dict a
    layer, so no leaf has the reference's stacked group dim."""
    fsdp, tp = plan.fsdp_axis, plan.tp_axis
    parts = path.split("/")
    name = parts[-1]
    base = [None] * len(shape)
    if name in ("table", "lm_head"):
        dims = [tp, fsdp]
    elif "experts" in parts and name in _COL:
        dims = [tp, fsdp, None]
    elif "experts" in parts and name in _ROW:
        dims = [tp, None, fsdp]
    elif name in _COL:
        dims = [fsdp, tp]
    elif name in _ROW:
        dims = [tp, fsdp]
    elif name in ("wb", "wc", "router"):
        dims = [fsdp, None]
    elif name.startswith("conv_x"):
        dims = [None, tp]
    elif name in ("a_log", "d_skip", "dt_bias") and len(base) == 1:
        dims = [tp]
    elif name == "wdt":
        dims = [fsdp, tp]
    else:
        dims = base                     # norms, biases, scalars
    return fit_spec(plan.layout, shape, Spec(*dims))


def param_specs(params_tree, plan: Parallelism):
    """Tree of :class:`Spec` matching ``params_tree`` (tensors, meta
    tensors included, or anything with a ``shape``)."""
    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        return _spec_for("/".join(prefix), tuple(tree.shape), plan)

    return build(params_tree, ())


# ---------------------------------------------------------------------------
# Plan factory per (shape kind × layout).
# ---------------------------------------------------------------------------

def _sp_config(layout: Layout, axis: Axis, spec: CommSpec):
    """The SP config over ``axis``'s group, or None without ranks."""
    if layout.groups is None:
        return None
    return SPConfig(layout.group(axis), comm=spec)


def make_plan(layout: Optional[Layout], shape_kind: str, *,
              global_batch: int = 1, n_kv_heads: int = 8,
              n_heads: Optional[int] = None,
              params_bytes: Optional[int] = None,
              comm: Optional[CommSpec] = None,
              zero1: bool = True) -> Parallelism:
    """Resolve the rules for a cell, branch for branch the reference's.

    train   — on a (data, sequence[, model]) layout: the paper's DP×SP
              deployment (or 3D DP×SP×TP with Ulysses over model), a
              manual plan: tokens over (sequence, model), params
              replicated, ZeRO-1 over the remaining width; under ranks
              ``plan.sp`` is built on ``launch.mesh.make_training_groups``
              (``layout.training``). Otherwise batch over (pod, data),
              falling back to SP over data when the batch does not divide.
    prefill — sequence over data (LASP-2/2H SP), batch over pod; when the
              heads do not divide model but the batch does and the
              weights are small, batch over model instead (hymba,
              whisper).
    decode  — batch over (pod, data); the ring's slots over model when
              the KV heads do not divide it (flash decoding).

    ``comm`` is the ``comm.spec.CommSpec`` of every SP layer under the
    plan. The reference's deprecated loose comm keywords and its
    ``backend`` have no twin.
    """
    spec = comm if comm is not None else CommSpec()
    if layout is None:
        return local_plan()
    shape = layout.shape
    axes = layout.axes
    has_pod = POD in axes
    seq_ax = SEQ if SEQ in axes else None

    if shape_kind == "train" and seq_ax is not None:
        dp_ax = DATA if DATA in axes else None
        tp_ax = MODEL if (MODEL in axes and shape[MODEL] > 1) else None
        if tp_ax is not None:
            if spec.strategy not in ("allgather", "ulysses"):
                raise ValueError(
                    f"comm strategy {spec.strategy!r} does not support the "
                    f"3D DP×SP×TP mesh (the ring/pipelined exchanges are "
                    f"wired for a single sequence axis); use 'allgather' "
                    f"or 'ulysses'")
            if spec.strategy == "ulysses" and n_heads is not None:
                from repro_torch.core.lasp2h import check_ulysses_heads
                check_ulysses_heads(n_heads, n_kv_heads, shape[tp_ax], "tp")
        plan = Parallelism(
            layout=layout, comm=spec, fsdp_axis=None, tp_axis=None,
            dp_axes=(dp_ax,) if dp_ax else (),
            manual_axes=tuple(a for a in (dp_ax, seq_ax, tp_ax)
                              if a is not None),
            rules={"batch": dp_ax, "seq": seq_ax, "residual_seq": seq_ax,
                   "heads": None, "kv_heads": None, "ff": None,
                   "vocab": None, "experts": None, "cache_seq": None},
            sp_axes=tuple(a for a in (seq_ax, tp_ax) if a is not None),
            sp_manual=True)
        tg = layout.training
        if tg is not None:
            plan.sp = SPConfig(tg.sp_group, comm=spec,
                               tp_group=tg.tp_group if tg.tp > 1 else None,
                               seq_group=tg.seq_group if tg.tp > 1
                               else None)
        zero_axes = tuple(a for a in (dp_ax, tp_ax)
                          if a is not None and shape[a] > 1)
        if zero1 and zero_axes:
            plan.zero1_axis = (zero_axes if len(zero_axes) > 1
                               else zero_axes[0])
        return plan

    dp = (POD, DATA) if has_pod else (DATA,)
    tp = MODEL if MODEL in axes else None
    plan = Parallelism(layout=layout, comm=spec,
                       fsdp_axis=DATA if DATA in axes else None,
                       tp_axis=tp, dp_axes=dp)
    # The SP axis: sequence when the layout names it, else data (the
    # inference layouts, where data does double duty for prefill SP).
    sp_ax = seq_ax or DATA
    sp_size = shape.get(sp_ax, 1)
    tp_size = shape.get(MODEL, 1) if tp else 1

    def with_sp():
        plan.sp_axes = (sp_ax,)
        plan.sp = _sp_config(layout, sp_ax, spec)

    if (shape_kind == "prefill" and tp is not None and n_heads is not None
            and n_heads % tp_size != 0 and global_batch % tp_size == 0
            and params_bytes is not None
            and params_bytes <= 6 * 2 ** 30):
        plan.tp_axis = None          # weights replicated on the TP axis
        plan.fsdp_axis = DATA if DATA in axes else None
        plan.rules = {"batch": (POD, MODEL) if has_pod else MODEL,
                      "seq": sp_ax, "residual_seq": sp_ax,
                      "heads": None, "kv_heads": None,
                      "ff": None, "vocab": None, "experts": None,
                      "cache_seq": sp_ax}
        if sp_size > 1:
            with_sp()
        return plan

    if shape_kind == "train":
        plan.rules = {"batch": dp, "seq": None, "heads": tp, "kv_heads": tp,
                      "ff": tp, "vocab": tp, "experts": tp,
                      "cache_seq": None}
        # a batch that does not divide the full dp falls back to SP
        if global_batch % layout.axis_size(dp) != 0:
            plan.rules.update({"batch": POD if has_pod else None,
                               "seq": sp_ax})
            with_sp()
    elif shape_kind == "prefill":
        plan.rules = {"batch": POD if has_pod else None, "seq": sp_ax,
                      "residual_seq": sp_ax,
                      "heads": tp, "kv_heads": tp, "ff": tp, "vocab": tp,
                      "experts": tp, "cache_seq": sp_ax}
        if sp_size > 1:
            with_sp()
    elif shape_kind == "decode":
        cache_axis = tp if (tp and n_kv_heads % tp_size != 0) else None
        plan.rules = {"batch": dp, "seq": None, "heads": tp,
                      "kv_heads": tp, "ff": tp, "vocab": tp, "experts": tp,
                      "cache_seq": cache_axis}
        plan.decode_cache_axis = cache_axis
    else:
        raise ValueError(shape_kind)
    return plan
