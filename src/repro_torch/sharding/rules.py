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
(``launch.mesh.make_serving_groups``) and applies a serving plan's
placements itself. A rank stores exactly what :func:`param_specs`
(:func:`shard_params`) and :func:`cache_specs` give it, computes on its
local slice where the math allows, and gathers a dim over its axis only
where the computation needs it whole, each exchange a recorded collective
(``comm.primitives``) with its own tag:

* ``plan.sp`` splits a prompt's tokens over the SP axis's group (LASP-2
  for linear and SSD layers, LASP-2H for softmax layers); a ``cache_seq``
  placement slices the softmax rings' slot dim over that axis's group
  (the ring stays whole when its length does not divide), read back
  through ``ring_decode_attention(sp=)``;
* weights over fsdp: each layer's leaves are gathered over data just
  before the layer runs and dropped after it (``fsdp.<leaf>``), the
  embedding's and ``lm_head``'s at their use;
* heads, kv heads and ff over model: linear and softmax mixers run on the
  rank's heads (:class:`LayerSplit`) and dense MLPs on its ff columns,
  each closed by one all-reduce after the row-parallel ``wo`` or ``w2``
  (``tp.mixer``, ``tp.mlp``); vocab over model: the masked lookup's
  all-reduce (``tp.embed``) and the gather of the logits' vocab slices
  (``tp.logits``);
* decode slots (batch) over data: the engine's slot grid and the decode
  cache hold this rank's rows, the sampled tokens gathered back
  (``serve.tokens``).

* SSD heads over model (mamba2, hymba's SSM half): the rank's ``wx``,
  ``wz``, ``wdt`` columns, ``conv_x`` channels and 1-D head leaves; ``B``
  and ``C`` stay whole; the group norm's statistic is one all-reduce
  (``tp.gnorm``), ``wo`` row-parallel; the split conv caches of ``B`` and
  ``C`` are gathered at each decode step (``tp.conv``);
* experts over model (MoE): each rank fills and runs only its experts'
  slots of a dispatch every rank of the model group routes alike, and one
  fp32 all-reduce sums the experts' and the shared experts' partial
  outputs (``tp.experts``). The capacity is the reference's: its global
  dispatch, from the whole call's tokens, wherever the plan sets
  ``fsdp_axis`` (one all-gather of the per-row expert counts over each
  token axis, ``moe.counts``), the per-shard one where it does not;
* cross layers on their heads: the memory's K/V cache holds the rank's kv
  heads, its slots sliced over the ``cache_seq`` axis and read through the
  flash-decoding merge; Whisper's encoder layers split as the decoder's;
* prefill rows over the prefill plan's batch axis (hymba's and whisper's
  batch-over-model branch): each rank prefills its rows, the last
  position's hidden state gathered back (``prefill.rows``).

Still gathered whole over model at use (``tp.cols.<leaf>``, caches
``tp.cache.<leaf>``): head counts the model axis does not divide (the
specs test divisibility on the flattened column dim: hymba's 25:5,
granite's single kv head), SSD heads it does not divide, experts it does
not divide. A per-head cut there would need uneven shards.
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
    when the layout has ranks. ``kind`` is ``make_plan``'s shape kind. The reference's ``backend`` and
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
    kind: Optional[str] = None              # make_plan's shape kind

    def act(self, x, *dims):
        """The identity. The reference constrains ``x``'s sharding by its
        logical dims for GSPMD; a rank here computes on what its plan
        gives it already (its chunk, its rows, its heads), so there is
        nothing to constrain."""
        return x

    def place(self, axis) -> Optional["Place"]:
        """This rank's :class:`Place` along ``axis``: None without ranks,
        for no axis, or for an axis of size 1 (nothing to exchange)."""
        if axis is None or self.layout is None or \
                self.layout.groups is None or axis not in self.layout.axes \
                or self.layout.axis_size(axis) == 1:
            return None
        return Place(self.layout.axis_size(axis), self.layout.index[axis],
                     self.layout.group(axis))

    def tp_place(self) -> Optional["Place"]:
        """The model axis's :class:`Place` where the plan places weights
        on it (``tp_axis``)."""
        return self.place(self.tp_axis)

    def fsdp_place(self) -> Optional["Place"]:
        """The data axis's :class:`Place` where the plan shards weights
        over it (``fsdp_axis``)."""
        return self.place(self.fsdp_axis)

    def rows_axis(self, rows: int):
        """The axis ``rows`` decode slots split over: the batch rule's one
        axis of size > 1, where its size divides ``rows``; else None (the
        rows stay whole). Read from the layout's sizes."""
        ax = self.rules.get("batch")
        axes = [a for a in (ax if isinstance(ax, tuple) else (ax,))
                if self.size_of(a) > 1]
        if len(axes) != 1 or rows % self.size_of(axes[0]):
            return None
        return axes[0]

    def rows_place(self, rows: int) -> Optional["Place"]:
        """This rank's :class:`Place` along :meth:`rows_axis`, or None."""
        return self.place(self.rows_axis(rows))

    def prefill_rows_axis(self, rows: int):
        """The axis a prefill plan's batch rule splits ``rows`` prompt rows
        over (:meth:`rows_axis`; the batch-over-model branch, or pod), or
        None: the rows stay whole on every rank (any other plan kind, no
        axis of size > 1, or a count the axis does not divide)."""
        return self.rows_axis(rows) if self.kind == "prefill" else None

    def prefill_rows_place(self, rows: int) -> Optional["Place"]:
        """This rank's :class:`Place` along :meth:`prefill_rows_axis`."""
        return self.place(self.prefill_rows_axis(rows))

    @property
    def moe_global(self) -> bool:
        """Whether an MoE layer dispatches over the whole call's tokens:
        the reference's ``_moe_dispatch`` on the global ``x`` wherever the
        plan sets ``fsdp_axis``; without it the reference's ``shard_map``
        branch counts each token shard's capacity apart."""
        return self.layout is not None and self.fsdp_axis is not None

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

    def size_of(self, axis) -> int:
        """``axis``'s size (1 for None or an axis the layout lacks)."""
        if axis is None or self.layout is None or \
                axis not in self.layout.axes:
            return 1
        return self.layout.axis_size(axis)

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


@dataclass(frozen=True)
class Place:
    """A rank's place along one axis: the axis's size, the rank's index
    on it and the axis's process group."""

    size: int
    index: int
    group: object


@dataclass(frozen=True)
class LayerSplit:
    """How one layer computes under a serving plan, decided once from the
    model axis's size, the config's head counts and the layer's param
    specs (:func:`layer_split`):

    * ``q``, ``kv``: the attention's q (kv) heads split over model (linear,
      softmax and cross mixers, hymba's ``attn``); otherwise the rank
      computes them all, its ``wq`` (``wk``, ``wv``) gathered at use where
      the specs split the flattened columns anyway;
    * ``wo``: the attention's ``wo`` holds the rank's rows (row-parallel,
      ``tp.mixer``);
    * ``ssd``: the SSD heads split over model (mamba2, hymba's ``ssm``):
      the rank's ``wx``, ``wz``, ``wdt`` columns, ``conv_x`` channels and
      1-D head leaves; otherwise every SSD leaf the specs split is
      gathered at use, and so is its cache;
    * ``ssd_wo``: the SSD's ``wo`` holds the rank's rows;
    * ``mlp``: the dense MLP holds the rank's ff columns (``tp.mlp``);
    * ``experts``: an MoE MLP's experts split over model (expert
      parallelism, ``tp.experts``); ``shared``: its shared experts' ff
      columns split;
    * ``mixer``: the layer's mixer; ``size``, ``tp``: the model axis's
      size and the rank's :class:`Place` on it (None without ranks or for
      size 1).
    """

    size: int = 1
    tp: Optional[Place] = None
    mixer: str = ""
    q: bool = False
    kv: bool = False
    wo: bool = False
    ssd: bool = False
    ssd_wo: bool = False
    mlp: bool = False
    experts: bool = False
    shared: bool = False

    def heads(self, n: int, split: bool):
        """``(heads, first head)`` of ``n`` heads that the rank computes:
        its block where ``split``, else all of them."""
        if not split or self.tp is None:
            return n, 0
        k = n // self.size
        return k, self.tp.index * k

    def gathered(self, path) -> bool:
        """Whether the layer's leaf at ``path`` (``("mixer", "wq")``) is
        gathered whole over model at use (tag ``tp.cols.<leaf>``; only
        the dims its spec places on model are gathered)."""
        if self.size == 1:
            return False
        leaf = path[-1]
        if path[0] == "mixer":
            if self.mixer == "mamba2" or path[1] == "ssm":
                return not (self.ssd_wo if leaf == "wo" else self.ssd)
            return {"wq": not self.q, "wdt": not self.q, "wk": not self.kv,
                    "wv": not self.kv, "wo": not self.wo}.get(leaf, False)
        if path[0] != "mlp":
            return False
        if "experts" in path:
            return not self.experts
        if "shared" in path:
            return not self.shared
        return not self.mlp


def _entry(spec, dim: int):
    return spec[dim] if dim < len(spec) else None


def _on(tree, path, dim, axis) -> bool:
    """Whether the spec at ``path`` of ``tree`` places ``dim`` on ``axis``
    (False where the leaf is missing)."""
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return False
        tree = tree[k]
    return _entry(tree, dim) == axis


def layer_split(cfg, spec, lspecs, plan: Optional[Parallelism]) -> LayerSplit:
    """The :class:`LayerSplit` of layer ``spec`` (a ``LayerSpec``) of
    ``cfg`` under ``plan``, ``lspecs`` its :func:`param_specs` (read only
    under tensor parallelism). A linear mixer splits its q heads where the
    model axis's size divides them; a softmax-like mixer (softmax, cross,
    hymba's attention) where the size also divides the kv heads or there
    is one kv head (MQA), as the GQA kernels take them; kv heads split
    where the size divides them. SSD heads split where the specs place
    every per-head leaf on model (the size divides the heads and the inner
    width alike); experts where they place the experts' dim on model.
    Read from the layout's sizes: the budgets use it without ranks."""
    if plan is None or plan.layout is None:
        return LayerSplit(mixer=spec.mixer)
    size = plan.tp_size()
    if size == 1:
        return LayerSplit(mixer=spec.mixer)
    tp = plan.tp_axis
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    m = spec.mixer
    attn = m in ("linear", "softmax", "cross", "hymba")
    kv = attn and hkv % size == 0
    q = attn and h % size == 0 and (m == "linear" or kv or hkv == 1)
    mixer = lspecs.get("mixer", {})
    attn_p = ("attn",) if m == "hymba" else ()
    ssm_p = ("ssm",) if m == "hymba" else ()
    ssm = m in ("mamba2", "hymba")
    ssd = ssm and all(_on(mixer, ssm_p + (leaf,), dim, tp) for leaf, dim in (
        ("wx", 1), ("wz", 1), ("wdt", 1), ("conv_x", 1), ("a_log", 0),
        ("d_skip", 0), ("dt_bias", 0)))
    mlp = lspecs.get("mlp", {})
    return LayerSplit(
        size, plan.tp_place(), m, q, kv,
        wo=attn and _on(mixer, attn_p + ("wo",), 0, tp),
        ssd=ssd, ssd_wo=ssm and _on(mixer, ssm_p + ("wo",), 0, tp),
        mlp=spec.mlp == "dense" and _on(mlp, ("w1",), 1, tp),
        experts=spec.mlp == "moe" and all(
            _on(mlp, ("experts", w), 0, tp) for w in ("w1", "w3", "w2")),
        shared=spec.mlp == "moe" and _on(mlp, ("shared", "w1"), 1, tp))


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


def cache_specs(cache_tree, plan: Parallelism):
    """Specs of a decode cache (``models.model.init_cache``'s tree; one
    dict a layer, so no leading group dim): K/V over (batch, kv_heads,
    cache_seq), states and their log decays over (batch, heads), conv
    inputs over (batch, tp) on their channel dim, ``pos`` replicated, the
    rest over batch. The reference keeps ``log_decay`` over batch only
    (replicated over model); here it follows its state's heads, which
    the rank's decode step advances alone."""
    layout = plan.layout
    b_ax = plan.rules.get("batch")

    def spec_for(name, leaf):
        if name == "pos":
            return Spec()
        if name in ("k", "v"):
            dims = (b_ax, plan.rules.get("kv_heads"),
                    plan.rules.get("cache_seq"), None)
        elif name in ("m", "log_decay"):
            dims = (b_ax, plan.rules.get("heads"), None, None)
        elif name.startswith("conv_"):
            dims = (b_ax, None, plan.tp_axis)
        else:
            dims = (b_ax,)
        return fit_spec(layout, leaf.shape, Spec(*dims[:len(leaf.shape)]))

    def build(tree, name):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, name) for v in tree]
        return spec_for(name, tree)

    return build(cache_tree, "")


def _entry_axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def shard_leaf(t, spec: Spec, layout: Layout, index=None, axes=None):
    """This rank's slice of ``t`` along each entry of ``spec``: an entry's
    axes (major first) index the slice by the rank's ``index`` (default
    ``layout.index``). ``axes``: slice only entries made of these axes.
    A view (narrowing keeps the storage)."""
    index = layout.index if index is None else index
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        ents = _entry_axes(entry)
        if axes is not None and not set(ents) <= set(axes):
            continue
        i = 0
        for a in ents:
            i = i * layout.axis_size(a) + index[a]
        n = t.shape[dim] // layout.axis_size(entry)
        t = t.narrow(dim, i * n, n)
    return t


def shard_tree(tree, specs, layout: Layout, index=None, axes=None):
    """:func:`shard_leaf` over a tree and its spec tree, each slice a
    tensor of its own (``clone``), so the whole leaf can be freed."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], layout, index, axes)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, layout, index, axes)
                          for v, s in zip(tree, specs))
    out = shard_leaf(tree, specs, layout, index, axes)
    return out if out is tree else out.clone()


def shard_params(params, plan: Parallelism, index=None):
    """This rank's slice of every leaf of ``params`` (the whole tree) along
    its :func:`param_specs` entry: the twin of the reference's
    ``param_shardings`` on a rank. ``index`` ({Axis: int}; default the
    layout's own) names a rank of a layout without ranks (the tests, on
    meta tensors)."""
    if plan.layout is None:
        return params
    return shard_tree(params, param_specs(params, plan), plan.layout, index)


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
              whisper): a rank then prefills its rows
              (``Parallelism.prefill_rows_place``).
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
            kind=shape_kind,
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
                       tp_axis=tp, dp_axes=dp, kind=shape_kind)
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
