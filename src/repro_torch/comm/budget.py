"""Collective budgets, checked against the tape.

Twin of ``repro/comm/budget.py``. The paper's claims are counts: LASP-2
does exactly one forward all-gather of sequence-length-independent state
a layer; LASP-1's ring does 2(W-1) sequential hops per forward and
backward. A :class:`CollectiveBudget` is such a claim written down. The
reference proves it against compiled HLO text; the port has no compiler,
so :func:`check_budget` reads what the ranks issued instead: a tape of
``comm.primitives.CommRecord`` (``primitives.tape()``), one record per
collective called, the backward's included (tags ``<tag>.bwd``). The
reference's ``compiled_hlo`` and ``gather_result_bytes`` read HLO and have
no twin here.

Per-axis budgets (:class:`AxisBudget`, :func:`train_step_axis_budget`)
name the layout axes a collective spans; a record carries its group's
size, not its axes, so each call site's axes come from its tag and :func:`check_axis_budget` holds the record's group size to
them.

Serving (``sharding.rules`` plans) has budgets of the port's own
(:func:`decode_merge_budget`, :func:`serve_prefill_budget`,
:func:`serve_decode_budget`): the reference's GSPMD moves the last
position's hidden state, the causal conv's halo and a sliced ring's
partials without a named primitive, so it has no budget for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional

from repro_torch.comm.primitives import wire_dtype
from repro_torch.configs.base import MambaConfig
from repro_torch.launch.mesh import Axis



@dataclass(frozen=True)
class CollectiveBudget:
    """Exact expected counts per collective op; ops not listed must be
    absent (``strict``) or are ignored. ``max_traffic``: per-op ceilings
    on the summed per-rank wire bytes."""

    counts: Mapping[str, int]
    strict: bool = True
    max_traffic: Mapping[str, float] = field(default_factory=dict)
    note: str = ""


def comm_itemsize(comm_dtype: Optional[str] = None) -> int:
    """Bytes per element on the wire for a ``comm_dtype`` knob value."""
    return wire_dtype(comm_dtype).itemsize


def packed_state_bytes(b: int, h: int, dk: int, dv: int,
                       comm_dtype: Optional[str] = None) -> int:
    """Per-rank payload of the packed ``(M_t ‖ A_t)`` state exchange:
    ``B·H·(dk·dv + 1)`` scalars in the wire dtype."""
    return b * h * (dk * dv + 1) * comm_itemsize(comm_dtype)


def allgather_state_budget(world: int, *, with_grad: bool = False,
                           backward: str = "faithful", n_slices: int = 1,
                           state_bytes: Optional[int] = None
                           ) -> CollectiveBudget:
    """The "allgather" (and "ulysses") state exchange: exactly 1 forward
    all-gather of the packed states; ``with_grad`` adds the faithful
    backward's dM gather or the autodiff reduce-scatter."""
    del n_slices

    def traffic(n_gathers, n_rs=0):
        if state_bytes is None:
            return {}
        out = {}
        if n_gathers:
            out["all-gather"] = n_gathers * (world - 1) * state_bytes
        if n_rs:
            out["reduce-scatter"] = n_rs * (world - 1) * state_bytes
        return out

    if not with_grad:
        return CollectiveBudget({"all-gather": 1}, max_traffic=traffic(1))
    if backward == "faithful":
        return CollectiveBudget({"all-gather": 2}, max_traffic=traffic(2),
                                note="paper Alg. 2+4: fwd + dM gathers")
    return CollectiveBudget({"all-gather": 1, "reduce-scatter": 1},
                            max_traffic=traffic(1, 1),
                            note="autodiff: RS is the gather transpose")


def ring_state_budget(world: int, *, with_grad: bool = False,
                      backward: str = "autodiff", n_slices: int = 1,
                      state_bytes: Optional[int] = None
                      ) -> CollectiveBudget:
    """The "ring" / "pipelined" exchanges: ``n_slices·(W-1)`` hops a pass,
    mirrored 1:1 by the backward; only the count is pinned."""
    del backward, state_bytes
    per_pass = n_slices * (world - 1)
    return CollectiveBudget(
        {"collective-permute": 2 * per_pass if with_grad else per_pass})


_STATE_BUDGETS = {"allgather": allgather_state_budget,
                  "ring": ring_state_budget,
                  "pipelined": ring_state_budget,
                  "ulysses": allgather_state_budget}


def lasp2_budget(strategy: str, world: int, *, with_grad: bool = False,
                 backward: str = "faithful", n_slices: int = 1,
                 state_bytes: Optional[int] = None) -> CollectiveBudget:
    """What one LASP-2 layer may put on the wire under ``strategy``:
    allgather/ulysses 1 all-gather (+1 all-gather faithful, +1
    reduce-scatter autodiff); ring W-1 hops; pipelined ``n_slices·(W-1)``
    hops (doubled with the backward). ``state_bytes``
    (:func:`packed_state_bytes`) pins the traffic ceilings too."""
    try:
        fn = _STATE_BUDGETS[strategy]
    except KeyError:
        raise ValueError(f"unknown comm strategy {strategy!r}; expected one "
                         f"of {tuple(_STATE_BUDGETS)}") from None
    return fn(world, with_grad=with_grad, backward=backward,
              n_slices=n_slices, state_bytes=state_bytes)


def allgather_context_budget(degree: int, *, sp: int = 1, b: int, hq: int,
                             hkv: int, c: int, dh: int,
                             with_grad: bool = False,
                             comm_dtype: Optional[str] = None,
                             compute_itemsize: int = 4
                             ) -> CollectiveBudget:
    """The K/V all-gather context path: exactly 2 all-gathers (K, V) over
    the ``degree``-wide sequence split; autodiff mirrors each in a
    reduce-scatter. Per-rank volume ``(degree-1)·|K/V chunk|``."""
    del sp, hq, compute_itemsize
    kv = b * hkv * c * dh * comm_itemsize(comm_dtype)
    counts: Dict[str, int] = {"all-gather": 2}
    ceil: Dict[str, float] = {"all-gather": 2 * (degree - 1) * kv}
    if with_grad:
        counts["reduce-scatter"] = 2
        ceil["reduce-scatter"] = 2 * (degree - 1) * kv
    return CollectiveBudget(counts, max_traffic=ceil,
                            note=f"K/V allgather, degree={degree}")


def ulysses_context_budget(degree: int, *, sp: int = 1, b: int, hq: int,
                           hkv: int, c: int, dh: int,
                           with_grad: bool = False,
                           comm_dtype: Optional[str] = None,
                           compute_itemsize: int = 4) -> CollectiveBudget:
    """The Ulysses head-parallel path: exactly 2 all-to-alls a forward
    (packed q‖k‖v in, the output back), mirrored by the backward; on a 3D
    layout (``sp > 1``) also the K/V gathers over the residual sequence
    axis, the bytes of a width-``sp`` 2D gather."""
    g = degree
    wi = comm_itemsize(comm_dtype)
    a2a_in = b * (hq + 2 * hkv) * c * dh * wi
    a2a_out = b * hq * c * dh * compute_itemsize
    per_fwd = (g - 1) * a2a_in // g + (g - 1) * a2a_out // g
    counts: Dict[str, int] = {"all-to-all": 4 if with_grad else 2}
    ceil: Dict[str, float] = {
        "all-to-all": per_fwd * (2 if with_grad else 1)}
    if sp > 1:
        kv = b * hkv * c * dh * wi
        counts["all-gather"] = 2
        ceil["all-gather"] = 2 * (sp - 1) * kv
        if with_grad:
            counts["reduce-scatter"] = 2
            ceil["reduce-scatter"] = 2 * (sp - 1) * kv
    return CollectiveBudget(counts, max_traffic=ceil,
                            note=f"ulysses a2a, degree={g} sp={sp}")


_CONTEXT_BUDGETS = {"allgather": allgather_context_budget,
                    "ring": allgather_context_budget,
                    "pipelined": allgather_context_budget,
                    "ulysses": ulysses_context_budget}


def hybrid_context_budget(strategy: str, degree: int, *, sp: int = 1,
                          b: int, hq: int, hkv: int, c: int, dh: int,
                          with_grad: bool = False,
                          comm_dtype: Optional[str] = None,
                          compute_itemsize: int = 4) -> CollectiveBudget:
    """What one LASP-2H softmax context-attention call may put on the
    wire under ``strategy`` (the ring strategies' softmax layers take the
    K/V gather). ``degree``: the K/V gather's width, or Ulysses' head
    group; ``sp``: Ulysses' residual sequence width; ``c``: the chunk
    length."""
    if strategy not in _CONTEXT_BUDGETS:
        raise ValueError(f"unknown comm strategy {strategy!r}; expected one "
                         f"of {tuple(_CONTEXT_BUDGETS)}")
    return _CONTEXT_BUDGETS[strategy](
        degree, sp=sp, b=b, hq=hq, hkv=hkv, c=c, dh=dh,
        with_grad=with_grad, comm_dtype=comm_dtype,
        compute_itemsize=compute_itemsize)


def ring_baseline_budget(world: int, *,
                         with_grad: bool = False) -> CollectiveBudget:
    """LASP-1 (paper Alg. 5/6): W-1 hops a pass, the 2(W-1) sequential
    steps an iteration that LASP-2 removes."""
    return CollectiveBudget(
        {"collective-permute": (world - 1) * (2 if with_grad else 1)})


def combine(budgets: Iterable[CollectiveBudget],
            note: str = "") -> CollectiveBudget:
    """The sum of several calls' budgets: counts and ceilings add; strict
    if every part is."""
    counts: Dict[str, int] = {}
    ceil: Dict[str, float] = {}
    strict = True
    for bud in budgets:
        strict = strict and bud.strict
        for op, n in bud.counts.items():
            counts[op] = counts.get(op, 0) + n
        for op, t in bud.max_traffic.items():
            ceil[op] = ceil.get(op, 0) + t
    return CollectiveBudget(counts, strict=strict, max_traffic=ceil,
                            note=note)


def check_budget(records, budget: CollectiveBudget) -> List[str]:
    """Human-readable violations of ``budget`` by a tape (empty list =
    within budget): each listed op's count exactly, no unlisted op under
    ``strict``, and each op's summed ``traffic_bytes`` within its
    ceiling. The tape holds every collective the primitives issued, the
    backward's included, so no count escapes it (the reference's HLO
    view sees collectives its trace-time tape does not)."""
    counts: Dict[str, int] = {}
    traffic: Dict[str, float] = {}
    for r in records:
        counts[r.op] = counts.get(r.op, 0) + 1
        traffic[r.op] = traffic.get(r.op, 0.0) + r.traffic_bytes
    violations = []
    for op, expected in budget.counts.items():
        if counts.get(op, 0) != expected:
            violations.append(f"{op}: expected exactly {expected}, the tape "
                              f"has {counts.get(op, 0)}")
    if budget.strict:
        for op, n in counts.items():
            if op not in budget.counts and n:
                violations.append(f"{op}: expected none, the tape has {n}")
    for op, ceiling in budget.max_traffic.items():
        if traffic.get(op, 0.0) > ceiling:
            violations.append(f"{op}: tape traffic {traffic[op]:.0f}B "
                              f"exceeds budget {ceiling:.0f}B")
    return violations


def assert_budget(records, budget: CollectiveBudget) -> None:
    violations = check_budget(records, budget)
    if violations:
        note = f" ({budget.note})" if budget.note else ""
        raise AssertionError("collective budget violated" + note + ":\n  "
                             + "\n  ".join(violations))


# ---------------------------------------------------------------------------
# Per-axis budgets (the DP×SP(×TP) train step).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AxisBudget:
    """Exact expected counts per ``(op, axes)``, ``axes`` the layout-ordered
    tuple of ``Axis`` a collective's group spans. ``strict``: any other
    key is a violation."""

    counts: Mapping[tuple, int]
    strict: bool = True
    note: str = ""


def _seq_axes(layout) -> tuple:
    """The axes tokens split over, major first: (sequence, model)."""
    shape = layout.shape
    return tuple(a for a in (Axis.SEQUENCE, Axis.MODEL)
                 if shape.get(a, 1) > 1)


def train_step_axis_budget(layout, *, n_sp_layers: int,
                           n_hybrid_layers: int = 0,
                           comm_strategy: str = "allgather",
                           microbatches: int = 1,
                           backward: str = "autodiff",
                           zero1: bool = True) -> AxisBudget:
    """What one DP×SP(×TP) train step may put on the wire, per
    ``(op, axes)`` of ``layout`` (a ``launch.mesh.Layout`` over data,
    sequence and model):

    * per LASP-2 layer and microbatch, over the token axes (sequence,
      model): 1 forward state all-gather, plus the backward's 1
      reduce-scatter (autodiff) or 1 dM all-gather (faithful);
    * per softmax layer and microbatch: under "ulysses" 4 all-to-alls over
      (model,) (or (sequence,) at tp 1), and at tp > 1 with sp > 1 2 K/V
      all-gathers and 2 reduce-scatters over (sequence,); otherwise 2 K/V
      all-gathers and 2 reduce-scatters over the token axes;
    * 1 gradient all-reduce over every axis of size > 1;
    * under ZeRO-1, 1 parameter all-gather over (data, model).
    """
    shape = layout.shape
    nontrivial = tuple(a for a in layout.axes if shape[a] > 1)
    dp = shape.get(Axis.DATA, 1)
    sp = shape.get(Axis.SEQUENCE, 1)
    tp = shape.get(Axis.MODEL, 1)
    seq_axes = _seq_axes(layout)
    counts: Dict[tuple, int] = {}

    def add(op, axes, n):
        if n and axes:
            counts[(op, axes)] = counts.get((op, axes), 0) + n

    if seq_axes and n_sp_layers:
        per_pass = n_sp_layers * microbatches
        if backward == "faithful":
            add("all-gather", seq_axes, 2 * per_pass)
        else:
            add("all-gather", seq_axes, per_pass)
            add("reduce-scatter", seq_axes, per_pass)
    if seq_axes and n_hybrid_layers:
        per_pass = n_hybrid_layers * microbatches
        if comm_strategy == "ulysses":
            a2a_axes = (Axis.MODEL,) if tp > 1 else (Axis.SEQUENCE,)
            add("all-to-all", a2a_axes, 4 * per_pass)
            if tp > 1 and sp > 1:
                add("all-gather", (Axis.SEQUENCE,), 2 * per_pass)
                add("reduce-scatter", (Axis.SEQUENCE,), 2 * per_pass)
        else:
            add("all-gather", seq_axes, 2 * per_pass)
            add("reduce-scatter", seq_axes, 2 * per_pass)
    counts[("all-reduce", nontrivial)] = 1
    zero_axes = tuple(a for a in (Axis.DATA, Axis.MODEL)
                      if shape.get(a, 1) > 1)
    if zero1 and zero_axes:
        add("all-gather", zero_axes, 1)
    return AxisBudget(counts, note=f"dp={dp} sp={sp} tp={tp} "
                                   f"layers={n_sp_layers}"
                                   f"+{n_hybrid_layers}h A={microbatches}")


def _record_axes(record, layout) -> Optional[tuple]:
    """The axes of ``layout`` a train-step record's group spans, by its
    call site's tag (the ``.bwd`` suffix dropped): the state and K/V
    gathers the token axes, Ulysses' all-to-alls the head group (model,
    or sequence at tp 1), its K/V gathers sequence, the gradient
    all-reduce every axis of size > 1, the ZeRO-1 gather (data, model).
    None for a tag of no train-step call site."""
    shape = layout.shape
    tag = record.tag[:-4] if record.tag.endswith(".bwd") else record.tag
    if tag in ("lasp2.states", "lasp2.dstates", "lasp2h.k", "lasp2h.v"):
        return _seq_axes(layout)
    if tag in ("ulysses.in", "ulysses.out"):
        return (Axis.MODEL,) if shape.get(Axis.MODEL, 1) > 1 \
            else (Axis.SEQUENCE,)
    if tag in ("ulysses.k", "ulysses.v"):
        return (Axis.SEQUENCE,)
    if tag == "train.grads":
        return tuple(a for a in layout.axes if shape[a] > 1)
    if tag == "zero1.param_gather":
        return tuple(a for a in (Axis.DATA, Axis.MODEL)
                     if shape.get(a, 1) > 1)
    return None


def check_axis_budget(records, layout, budget: AxisBudget) -> List[str]:
    """Violations of an :class:`AxisBudget` by a tape of one step: each
    record keyed ``(op, the axes of its tag)``, its group's size held to those
    axes' sizes; a record of an unknown call site is a violation."""
    got: Dict[tuple, int] = {}
    violations = []
    for r in records:
        axes = _record_axes(r, layout)
        if axes is None:
            violations.append(f"{r.op} {r.tag!r}: not a train-step "
                              f"collective")
            continue
        if r.group != layout.axis_size(axes):
            violations.append(f"{r.op} {r.tag!r}: group of {r.group} "
                              f"ranks, its axes {axes} hold "
                              f"{layout.axis_size(axes)}")
        got[(r.op, axes)] = got.get((r.op, axes), 0) + 1
    for key, expected in budget.counts.items():
        if got.get(key, 0) != expected:
            violations.append(f"{key[0]} over {key[1]}: expected exactly "
                              f"{expected}, the tape has {got.get(key, 0)}")
    if budget.strict:
        for key, n in got.items():
            if key not in budget.counts and n:
                violations.append(f"{key[0]} over {key[1]}: expected none, "
                                  f"the tape has {n}")
    return violations


def assert_axis_budget(records, layout, budget: AxisBudget) -> None:
    violations = check_axis_budget(records, layout, budget)
    if violations:
        note = f" ({budget.note})" if budget.note else ""
        raise AssertionError("per-axis collective budget violated" + note
                             + ":\n  " + "\n  ".join(violations))


# ---------------------------------------------------------------------------
# Serving under a plan (the port's own).
# ---------------------------------------------------------------------------

def decode_merge_budget(world: int, *, b: int, hq: int, dh: int
                        ) -> CollectiveBudget:
    """One flash-decoding merge of a sliced cache (``core.lasp2h``'s
    ``ring_decode_attention(sp=)``, ``sharded_decode_attention(sp=)``):
    3 all-gathers, of o (B·Hq·dh), m and l (B·Hq) in fp32, whatever the
    cache length."""
    nbytes = (b * hq * dh + 2 * b * hq) * 4
    return CollectiveBudget({"all-gather": 3},
                            max_traffic={"all-gather": (world - 1) * nbytes},
                            note=f"decode merge, world={world}")


def _split_degree(plan, s: int) -> int:
    """Ranks a serving plan splits ``s`` tokens over (1: whole), from
    its layout alone, as ``plan.sp_for`` decides under ranks."""
    if plan is None or not plan.sp_axes or plan.sp_manual:
        return 1
    w = plan.sp_degree
    return w if s % w == 0 else 1


def _ring_degree(plan, ring: int) -> int:
    """Ranks a ring of ``ring`` slots is sliced over under ``plan`` (1:
    whole): its ``cache_seq`` axis's size, when that divides the ring."""
    ax = plan.rules.get("cache_seq") if plan is not None else None
    if ax is None:
        return 1
    w = plan.layout.axis_size(ax)
    return w if ring % w == 0 else 1


def serve_prefill_budget(cfg, plan, *, b: int, s: int) -> CollectiveBudget:
    """One ``models.model.prefill`` of ``b`` rows of ``s`` tokens under
    ``plan`` (a ``sharding.rules.Parallelism``; read from its layout, so a
    plan without ranks has one too): nothing when the plan keeps the
    prompt whole; else per linear or SSD layer the state gather
    (:func:`lasp2_budget`), per softmax layer the K/V context exchange
    (:func:`hybrid_context_budget`; under "ulysses" also the ring's K/V
    gathers, tags ``ring.k``, ``ring.v``), per SSD layer (mamba2, hymba's
    ``ssm``) one conv-halo gather (``mamba2.conv``), and one gather of the
    last position's hidden state (``prefill.last``)."""
    w = _split_degree(plan, s)
    if w == 1:
        return CollectiveBudget({})
    c = s // w
    strategy, dt = plan.comm.strategy, plan.comm.dtype
    act = 2 if cfg.dtype == "bfloat16" else 4
    parts = []
    for spec in cfg.layer_specs():
        if spec.mixer in ("linear", "mamba2", "hymba"):
            if spec.mixer == "linear":
                h, dk, dv = cfg.n_heads, cfg.head_dim, cfg.head_dim
                if cfg.linear_attn.feature_map == "taylor":
                    dk = 1 + dk + dk * dk
            else:
                mb = cfg.mamba or MambaConfig()
                d_in = mb.expand * cfg.d_model if spec.mixer == "mamba2" \
                    else cfg.d_model
                h, dk, dv = d_in // mb.headdim, mb.d_state, mb.headdim
            parts.append(lasp2_budget(
                "allgather", w,
                state_bytes=packed_state_bytes(b, h, dk, dv, dt)))
        if spec.mixer in ("mamba2", "hymba"):
            mb = cfg.mamba or MambaConfig()
            d_in = mb.expand * cfg.d_model if spec.mixer == "mamba2" \
                else cfg.d_model
            halo = b * (mb.d_conv - 1) * (d_in + 2 * mb.ngroups
                                          * mb.d_state) * act
            parts.append(CollectiveBudget(
                {"all-gather": 1},
                max_traffic={"all-gather": (w - 1) * halo}))
        if spec.mixer in ("softmax", "hymba"):
            kw = dict(b=b, hq=cfg.n_heads, hkv=cfg.n_kv_heads, c=c,
                      dh=cfg.head_dim, comm_dtype=dt, compute_itemsize=act)
            if strategy == "ulysses":
                parts.append(hybrid_context_budget("ulysses", w, **kw))
                parts.append(allgather_context_budget(w, **kw))
            else:
                parts.append(hybrid_context_budget("allgather", w, **kw))
    parts.append(CollectiveBudget(
        {"all-gather": 1},
        max_traffic={"all-gather": (w - 1) * b * cfg.d_model * act}))
    return combine(parts, note=f"serve prefill W={w} B={b} S={s}")


def serve_decode_budget(cfg, plan, *, b: int, max_len: int
                        ) -> CollectiveBudget:
    """One ``models.model.decode_step`` of ``b`` rows under ``plan``: one
    merge (:func:`decode_merge_budget`) per softmax or hymba layer whose
    ring the plan slices (a ``cache_seq`` axis whose size divides the
    ring); linear and SSD layers decode with no exchange."""
    from repro_torch.models.blocks import softmax_ring_len
    parts = []
    for spec in cfg.layer_specs():
        if spec.mixer not in ("softmax", "hymba"):
            continue
        ring = max_len if spec.mixer == "hymba" \
            else softmax_ring_len(spec, max_len)
        w = _ring_degree(plan, ring)
        if w > 1:
            parts.append(decode_merge_budget(w, b=b, hq=cfg.n_heads,
                                             dh=cfg.head_dim))
    return combine(parts, note=f"serve decode B={b}")


# Exchanges that stay fp32 (or the compute dtype) whatever ``comm_dtype``:
# the packed gradient all-reduce and the loop's stop agreement, ZeRO-1's
# parameter gather and the checkpoint's moment gather (the reference's
# (data, model) collectives, fp32 by design), Ulysses' head
# repartition (the reference's model-axis all-to-alls, in the compute
# dtype), and serving's exchanges: the last hidden state, the conv halo,
# the ring's K/V gathers and the flash-decoding merge's o, m and l.
# Every other exchange, the LASP-2 state exchange and the K/V gathers of
# LASP-2H and Ulysses, carries the wire dtype (the sanitizer's SAN203).
WIRE_FP32_TAGS = ("train.grads", "train.agree", "zero1.param_gather",
                  "ckpt.zero1_gather", "ulysses.in", "ulysses.out",
                  "prefill.last", "mamba2.conv", "ring.k", "ring.v",
                  "ring_decode.", "decode.")


def wire_exempt(tag: str) -> bool:
    """True for a record's tag (``.bwd`` included) that
    ``WIRE_FP32_TAGS`` names: an exchange outside the ``comm_dtype``
    contract."""
    tag = tag[:-4] if tag.endswith(".bwd") else tag
    return any(tag == t or (t.endswith(".") and tag.startswith(t))
               for t in WIRE_FP32_TAGS)
