"""Plan-level dry run: every (architecture × shape × layout) cell's plan,
per-rank memory and collective budget, with no ranks and no card.

Twin of ``repro/launch/dryrun.py``, which lowers and compiles each cell
for the 256- and 512-chip production meshes. The port compiles nothing,
so what has no twin is XLA's: the compile itself, ``memory_analysis`` and
``cost_analysis``. Their counterparts on the card are
``torch.cuda.max_memory_allocated`` (a real run's peak) and the
collective tape (``comm.primitives.tape``) of a real run. What this run
computes instead, per cell, from ``launch.cells.build_cell``:

* ``memory``: the bytes one rank would hold of params, gradients and
  optimizer moments (train; the moments sharded over the ZeRO-1 axes
  where the plan has them), of the decode cache (prefill and decode) and
  of the inputs, each leaf divided over the axes of its spec
  (``sharding.rules.fit_spec``), against the card's 80 GB. Activations
  are not counted. A serving rank holds exactly these params and this
  cache (``sharding.rules.shard_params``, ``models.model.init_cache(
  plan=)``; the tests hold a rank's Σ ``nbytes`` to them): the port
  applies the placements (``sharding.rules``).
* ``collectives``: the cell's budget (``comm.budget``): a serving
  cell's prefill or decode step with its FSDP gathers and its TP
  all-reduces and gathers, or a train step's sequence-parallel
  exchanges where the plan splits the sequence.

Usage::

    python -m repro_torch.launch.dryrun --arch codeqwen1.5-7b --shape train_4k
    python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

One JSON a cell under ``--out`` (default ``results/dryrun_torch``), named
``<arch>__<shape>__<mesh>.json``, with the reference's record keys
(``arch``, ``shape``, ``mesh``, ``devices``, ``status``, ``note``,
``config_name``, ``params_b``, ``num_microbatches``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

CARD_BYTES = 80e9     # an H100's device memory


def _shards(layout, spec) -> int:
    return math.prod(layout.axis_size(e) for e in spec if e is not None)


def _sharded_bytes(tree, specs, layout) -> int:
    """Bytes one rank holds of ``tree`` under ``specs`` (a tree of the
    same structure; None: replicated)."""
    from repro_torch.core.tree import leaves_with_paths
    leaves = [t for _, t in leaves_with_paths(tree) if torch.is_tensor(t)]
    if specs is None:
        return sum(t.numel() * t.element_size() for t in leaves)
    from repro_torch.sharding.rules import Spec

    def spec_leaves(s):
        if isinstance(s, Spec):
            return [s]
        if isinstance(s, dict):
            return [x for v in s.values() for x in spec_leaves(v)]
        if isinstance(s, (list, tuple)):
            return [x for v in s for x in spec_leaves(v)]
        return []

    return sum(t.numel() * t.element_size() // _shards(layout, s)
               for t, s in zip(leaves, spec_leaves(specs)))


def memory_report(cell) -> dict:
    """Per-rank resident bytes by kind, from the cell's specs."""
    layout = cell.plan.layout
    out = {}
    if cell.shape.kind == "train":
        state, batch = cell.abstract_args
        pspec = cell.specs[0]["params"] if cell.specs else None
        out["params"] = _sharded_bytes(state["params"], pspec, layout)
        out["grads"] = out["params"]
        if cell.plan.zero1_axis is not None:
            # the flat moments were built as one rank's ZeRO-1 slice
            out["opt"] = _sharded_bytes((state["opt"].m, state["opt"].v),
                                        None, layout)
        else:
            out["opt"] = 2 * out["params"]
        out["inputs"] = _sharded_bytes(batch, cell.specs and cell.specs[1],
                                       layout)
        out["cache"] = 0
    elif cell.shape.kind == "prefill":
        from repro_torch.launch.cells import cache_specs
        from repro_torch.models import model as M
        params, tokens, aux = cell.abstract_args
        specs = cell.specs
        out["params"] = _sharded_bytes(params, specs and specs[0], layout)
        cache = M.init_cache(cell.cfg, cell.shape.global_batch,
                             cell.shape.seq_len, device="meta")
        out["cache"] = _sharded_bytes(
            cache, cache_specs(cache, cell.plan) if layout else None,
            layout)
        out["inputs"] = _sharded_bytes(
            [tokens, aux], specs and [specs[1], specs[2]], layout)
        out["grads"] = out["opt"] = 0
    else:
        params, token, cache, aux = cell.abstract_args
        specs = cell.specs
        out["params"] = _sharded_bytes(params, specs and specs[0], layout)
        out["cache"] = _sharded_bytes(cache, specs and specs[2], layout)
        out["inputs"] = _sharded_bytes(
            [token, aux], specs and [specs[1], specs[3]], layout)
        out["grads"] = out["opt"] = 0
    out["total"] = sum(out.values())
    out["activations"] = "not counted"
    out["card_bytes"] = CARD_BYTES
    out["fits_card"] = out["total"] <= CARD_BYTES
    return out


def collective_report(cell) -> dict:
    """The cell's step budget (``comm.budget``) as counts and ceilings."""
    from repro_torch.comm import budget as B
    cfg, plan, shape = cell.cfg, cell.plan, cell.shape
    if shape.kind == "prefill":
        bud = B.serve_prefill_budget(cfg, plan, b=shape.global_batch,
                                     s=shape.seq_len,
                                     params=cell.abstract_args[0])
    elif shape.kind == "decode":
        bud = B.serve_decode_budget(cfg, plan, b=shape.global_batch,
                                    max_len=shape.seq_len,
                                    params=cell.abstract_args[0])
    elif plan.sp_axes and plan.layout is not None:
        n_lin = sum(s.mixer in ("linear", "mamba2", "hymba")
                    for s in cfg.layer_specs())
        n_soft = sum(s.mixer in ("softmax", "hymba")
                     for s in cfg.layer_specs())
        w = plan.sp_degree
        mb = cell.run.num_microbatches
        bm = shape.global_batch // mb
        c = shape.seq_len // w
        parts = [B.lasp2_budget(plan.comm.strategy, w, with_grad=True,
                                backward="autodiff")] * (n_lin * mb)
        parts += [B.hybrid_context_budget(
            plan.comm.strategy, w, b=bm, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
            c=c, dh=cfg.head_dim, with_grad=True)] * (n_soft * mb)
        bud = B.combine(parts, note=f"train SP W={w}, A={mb}")
    else:
        bud = B.CollectiveBudget({}, note="no sequence split: the weight "
                                 "placements' collectives are GSPMD's")
    return {"counts": dict(bud.counts),
            "max_traffic_bytes": dict(bud.max_traffic), "note": bud.note}


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str
            ) -> dict:
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    layout = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": layout.name,
           "devices": layout.size, "status": "building"}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, layout)
        rec["note"] = cell.note
        rec["config_name"] = cell.cfg.name
        rec["params_b"] = cell.cfg.param_count() / 1e9
        rec["num_microbatches"] = cell.run.num_microbatches
        rec["plan"] = {"rules": {k: _axis_name(v)
                                 for k, v in cell.plan.rules.items()},
                       "sp_axes": _axis_name(cell.plan.sp_axes),
                       "sp_degree": cell.plan.sp_degree,
                       "decode_cache_axis":
                           _axis_name(cell.plan.decode_cache_axis),
                       "zero1_axis": _axis_name(cell.plan.zero1_axis)}
        rec["memory"] = memory_report(cell)
        rec["collectives"] = collective_report(cell)
        rec["status"] = "ok"
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: OK "
              f"({rec['memory']['total'] / 1e9:.2f} GB a rank w/o "
              f"activations)")
    except Exception as e:  # noqa: BLE001 — record, don't stop the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: FAIL {e}",
              file=sys.stderr)
    rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{rec['mesh']}".replace("/", "_")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _axis_name(v):
    """Axes as their enum names (``DATA``, ``MODEL`` …) for JSON."""
    if v is None:
        return None
    if isinstance(v, tuple):
        return [_axis_name(a) for a in v]
    return v.name


def run_all(multi_pod: bool, out_dir: str, archs=None, shapes=None):
    """Every cell of ``archs`` (default the reference's ``ARCH_IDS``) ×
    ``shapes`` (default every shape), in this process: no compile state
    to isolate. Returns ``{tag: status}``."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.base import SHAPES
    results = {}
    for arch in archs or ARCH_IDS:
        for shape in shapes or list(SHAPES):
            rec = run_one(arch, shape, multi_pod, out_dir)
            results[f"{arch}__{shape}__{rec['mesh']}"] = rec["status"]
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    if args.all:
        res = run_all(args.multi_pod, args.out)
        bad = [k for k, v in res.items() if v != "ok"]
        print(f"\n{len(res) - len(bad)}/{len(res)} cells OK")
        return 1 if bad else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    return 0 if run_one(args.arch, args.shape, args.multi_pod,
                        args.out)["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
