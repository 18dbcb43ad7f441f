"""Cell builder: (architecture × input shape × layout) → the callable a
rank runs under the cell's plan, its abstract arguments and their specs.

Twin of ``repro/launch/cells.py``. A cell resolves to one of three
functions:

  train   → ``step(state, batch)``  (forward, backward, optimizer)
  prefill → ``prefill(params, tokens, aux)``
  decode  → ``decode_step(params, token, cache, aux)``

Abstract arguments are tensors on ``torch.device("meta")``: shapes and
dtypes with no storage, the whole arrays; ``specs`` place them. A rank
under the cell's plan holds what the specs give it and runs ``fn`` on
that: its shard of the params (``sharding.rules.shard_params``) and of
the decode cache (``models.model.init_cache(plan=)``); the plan's
placements are applied (``sharding.rules``). ``long_500k`` on an
architecture that is not sub-quadratic switches to the paper's
linearized 1/4 hybrid (windowed softmax layers), and the cell's note
says so. The reference's ``Cell.lower`` (jit and lower for XLA) has no
twin: the port compiles nothing; ``launch.dryrun`` reads the plan and
its specs instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.launch.mesh import Axis, Layout
from repro_torch.models import model as M
from repro_torch.sharding.rules import (Parallelism, Spec, cache_specs,
                                        fit_spec, make_plan, param_specs)

MICROBATCH_TOKEN_TARGET = 4096   # per-rank tokens a microbatch aims at
META = torch.device("meta")


def choose_microbatches(shape: ShapeConfig, dp_size: int,
                        target: int = MICROBATCH_TOKEN_TARGET) -> int:
    """Microbatches a train cell accumulates: about ``target`` tokens a
    rank each, at most one row a rank each, a divisor of the batch."""
    tokens_per_dev = shape.global_batch * shape.seq_len // max(dp_size, 1)
    a = max(1, tokens_per_dev // target)
    a = min(a, shape.global_batch // max(dp_size, 1) or 1)
    while shape.global_batch % a:
        a -= 1
    return max(a, 1)


def _meta(shape, dtype):
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=META)


def aux_input_specs(cfg: ModelConfig, batch_rows: int, lead=()):
    """Stub-frontend inputs (meta tensors): whisper frames, vision
    patches."""
    out = {}
    if cfg.encoder is not None:
        out["frames"] = _meta(lead + (batch_rows, cfg.encoder.n_frames,
                                      cfg.d_model), torch.bfloat16)
    if cfg.n_image_tokens:
        out["img"] = _meta(lead + (batch_rows, cfg.n_image_tokens,
                                   cfg.d_model), torch.bfloat16)
    return out


def _batch_specs(batch, plan: Parallelism):
    """A train batch's specs ((A, B, S, ...) leaves): rows over the batch
    rule, the tokens, labels and resets' sequence over the seq rule."""
    b_ax, s_ax = plan.rules.get("batch"), plan.rules.get("seq")

    def spec_for(name, leaf):
        dims = [None] * leaf.dim()
        dims[1] = b_ax
        if name in ("tokens", "labels", "resets") and leaf.dim() > 2:
            dims[2] = s_ax
        return fit_spec(plan.layout, leaf.shape, Spec(*dims))

    return {k: spec_for(k, v) for k, v in batch.items()}


@dataclass
class Cell:
    """One (arch × shape × layout): ``fn`` is the callable a rank runs
    under ``plan`` (on arguments like ``abstract_args``, which hold meta
    tensors), ``specs`` the placement the plan computes for each
    argument (None where a layout has none)."""

    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    plan: Parallelism
    run: RunConfig
    fn: Any
    abstract_args: tuple
    specs: Optional[tuple]
    note: str = ""


def resolve_config(arch: str, shape_name: str) -> tuple[ModelConfig, str]:
    """The cell's config and its note: ``long_500k`` on a config that is
    not sub-quadratic takes the linearized 1/4 hybrid."""
    cfg = get_config(arch)
    note = "native"
    if shape_name == "long_500k" and not cfg.subquadratic:
        cfg = cfg.linearize(hybrid_every=4)
        note = "linearized-1/4-hybrid (pure softmax infeasible at 500k)"
    return cfg, note


def _dp_size(layout: Optional[Layout], plan: Parallelism) -> int:
    if layout is None:
        return 1
    dp = 1
    for a in plan.dp_axes:
        if a in layout.axes:
            dp *= layout.shape[a]
    if plan.sp_axes and not plan.manual_axes:
        # 1-D SP training: batch over pod only
        dp = layout.shape.get(Axis.POD, 1)
    return dp


def _zero_size(layout: Optional[Layout], plan: Parallelism) -> int:
    if layout is None or plan.zero1_axis is None:
        return 1
    return layout.axis_size(plan.zero1_axis)


def _nbytes(tree) -> int:
    from repro_torch.core.tree import leaves_with_paths
    return sum(t.numel() * t.element_size()
               for _, t in leaves_with_paths(tree) if torch.is_tensor(t))


def build_cell(arch: str, shape_name: str, layout: Optional[Layout], *,
               run: Optional[RunConfig] = None,
               cfg_override: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None,
               plan: Optional[Parallelism] = None) -> Cell:
    """The cell of ``arch`` × ``SHAPES[shape_name]`` (or ``shape``, a
    resized one: the roofline's reduced-batch cells) on ``layout``.
    ``plan``: a serving plan to place the cell by instead of the one
    ``make_plan`` and the prefill FSDP rule give (a rank's own plan, whose
    held bytes the dry run's ``memory_report`` then gives)."""
    shape = shape or SHAPES[shape_name]
    if cfg_override is not None:
        cfg, note = cfg_override, "override"
    else:
        cfg, note = resolve_config(arch, shape_name)
    run = run or RunConfig()
    fixed = plan is not None
    if not fixed:
        plan = make_plan(layout, shape.kind, global_batch=shape.global_batch,
                         n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                         params_bytes=cfg.param_count() * 2,
                         comm=run.comm_spec())

    if shape.kind == "train":
        from repro_torch.train.step import init_state, make_train_step
        a = choose_microbatches(shape, _dp_size(layout, plan),
                                target=run.microbatch_tokens)
        run = dataclasses.replace(run, num_microbatches=a)
        bm = shape.global_batch // a
        state = init_state(None, cfg, device=META,
                           zero1=_zero_size(layout, plan), run=run)
        batch = {"tokens": _meta((a, bm, shape.seq_len), torch.int32),
                 "labels": _meta((a, bm, shape.seq_len), torch.int32),
                 "resets": _meta((a, bm, shape.seq_len), torch.bool)}
        batch.update(aux_input_specs(cfg, bm, lead=(a,)))

        def fn(state_, batch_):
            groups = layout.training if plan.sp_manual else None
            return make_train_step(cfg, run, groups)(state_, batch_)

        specs = None if layout is None else (
            {"params": param_specs(state["params"], plan)},
            _batch_specs(batch, plan))
        return Cell(arch, shape, cfg, plan, run, fn, (state, batch), specs,
                    note)

    params = M.init_params(None, cfg, device=META,
                           param_dtype="bfloat16" if run.infer_bf16
                           else cfg.param_dtype)
    if layout is not None and run.infer_bf16 and shape.kind == "prefill" \
            and not fixed:
        drop_prefill_fsdp(plan, _nbytes(params), run)
    pspec = None if layout is None else param_specs(params, plan)
    b = shape.global_batch

    if shape.kind == "prefill":
        tokens = _meta((b, shape.seq_len), torch.int32)
        aux = aux_input_specs(cfg, b)

        def fn(params_, tokens_, aux_in):
            return M.prefill(params_, tokens_, cfg, plan,
                             max_len=shape.seq_len,
                             img_emb=aux_in.get("img"),
                             enc_frames=aux_in.get("frames"))

        specs = None
        if layout is not None:
            specs = (pspec, fit_spec(layout, tokens.shape,
                                     Spec(plan.rules.get("batch"),
                                          plan.rules.get("seq"))),
                     {k: fit_spec(layout, v.shape,
                                  Spec(plan.rules.get("batch")))
                      for k, v in aux.items()})
        return Cell(arch, shape, cfg, plan, run, fn, (params, tokens, aux),
                    specs, note)

    token = _meta((b,), torch.int32)
    cache = M.init_cache(cfg, b, shape.seq_len, device=META)
    aux = {}
    if cfg.encoder is not None:
        aux["enc_out"] = _meta((b, cfg.encoder.n_frames, cfg.d_model),
                               torch.bfloat16)
    if cfg.n_image_tokens:
        aux["img"] = _meta((b, cfg.n_image_tokens, cfg.d_model),
                           torch.bfloat16)

    # a rank of a layout with ranks holds its block of the rows where the
    # plan places them (the token and cache specs' batch entry)
    place = plan.rows_place(b) if layout is not None else None
    rows = None if place is None else (place.index * (b // place.size),
                                       b // place.size)

    def fn(params_, token_, cache_, aux_in):
        return M.decode_step(params_, token_, cache_, cfg, plan, rows=rows,
                             img_emb=aux_in.get("img"),
                             enc_out=aux_in.get("enc_out"))

    specs = None
    if layout is not None:
        specs = (pspec, fit_spec(layout, token.shape,
                                 Spec(plan.rules.get("batch"))),
                 cache_specs(cache, plan),
                 {k: fit_spec(layout, v.shape, Spec(plan.rules.get("batch")))
                  for k, v in aux.items()})
    return Cell(arch, shape, cfg, plan, run, fn, (params, token, cache, aux),
                specs, note)


def drop_prefill_fsdp(plan: Parallelism, params_bytes: int,
                      run: RunConfig) -> None:
    """The prefill cells' rule: no FSDP when the weights over the model
    axis fit ``run.infer_fsdp_budget_gb`` (they are then whole over data,
    sharded over model only)."""
    tp_size = plan.layout.shape.get(Axis.MODEL, 1)
    if params_bytes / tp_size <= run.infer_fsdp_budget_gb * 2 ** 30:
        plan.fsdp_axis = None


def reduced_depth_config(cfg: ModelConfig, n_units: int) -> ModelConfig:
    """Same widths, ``n_units`` pattern repetitions."""
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern) * n_units)
