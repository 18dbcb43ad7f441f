"""Roofline per (arch × shape) for one card (twin of
``repro/launch/roofline.py``).

Nothing runs on any device: the cell's program (``launch.cells``, no
layout: the one-card program) is executed on the ``meta`` device under a
counting dispatch mode, which adds up

* FLOPs of ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the convolutions,
  as ``torch.utils.flop_counter`` counts them;
* HBM bytes as the sum of each op's input and output bytes (views and
  allocations move nothing and are skipped). Eager code reads and writes
  HBM at every op, so for it this is the traffic; for anything fused it
  is an upper bound;
* the kernels as themselves: every kernel entry that ``kernels/ops.py``
  reaches (K1, K2a, K2b, K3, K4, K5a, K5b) is replaced, for the count, by
  its kernel's own work from ``obs.flops`` (the formulas of the kernel
  table's bounds), not its plain version's;
* collective bytes from the cell's budget, as ``launch.dryrun`` reads it
  (none for a one-card cell).

Terms are seconds against the H100's peaks in ``obs.flops`` (989 TF/s
bf16, 3.35 TB/s HBM, 450 GB/s NVLink a direction). Eager code counts every
layer, so there is no scan to extrapolate; the reference's reduced-depth
solve is kept as a check: the costs at G ∈ {1, 2} groups and A ∈ {1, 2}
microbatches are solved for ``c0 + G·c3 + A·(c1 + G·c2)`` (``c3``: the
optimizer's per-group work, outside the microbatch loop) and the solve at
the cell's (A, G) must equal the full-depth count exactly. A config whose
layers differ by position (hymba's global layers) breaks the premise;
its record says so.

  python -m repro_torch.launch.roofline --arch linear-llama3-1b \\
      --shape train_4k                    # results/roofline_torch/*.json
  python -m repro_torch.launch.roofline --all
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs import flops as F

aten = torch.ops.aten
_COUNTED = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
            aten._convolution, aten.convolution_backward)
# ops that allocate or alias without moving data
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like,
               aten.new_empty, aten.new_empty_strided, aten.detach,
               aten.lift_fresh, aten.alias}


@dataclass
class CostVector:
    """Per-device cost of one program (additive, scalable): the
    reference's ``hlo_analysis.CostVector``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: Dict[str, float] = field(default_factory=dict)
    # kernel launches of the measured program (not part of the algebra)
    kernels: Dict[str, int] = field(default_factory=dict)

    def __add__(self, o):
        d = dict(self.coll_by_op)
        for k, v in o.coll_by_op.items():
            d[k] = d.get(k, 0.0) + v
        return CostVector(self.flops + o.flops,
                          self.hbm_bytes + o.hbm_bytes,
                          self.coll_bytes + o.coll_bytes, d)

    def __sub__(self, o):
        d = {k: v - o.coll_by_op.get(k, 0.0)
             for k, v in self.coll_by_op.items()}
        return CostVector(self.flops - o.flops,
                          self.hbm_bytes - o.hbm_bytes,
                          self.coll_bytes - o.coll_bytes, d)

    def scale(self, f):
        return CostVector(self.flops * f, self.hbm_bytes * f,
                          self.coll_bytes * f,
                          {k: v * f for k, v in self.coll_by_op.items()})


class Counter(TorchDispatchMode):
    """Adds up FLOPs and HBM bytes of the ops run while it is active;
    :meth:`add` takes a kernel's own work."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, int] = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _COUNTED:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            seen = set()
            for t in _leaves((args, kwargs, out)):
                key = id(t)
                if key not in seen:
                    seen.add(key)
                    self.bytes += t.numel() * t.element_size()
        return out

    def cost(self) -> CostVector:
        return CostVector(self.flops, self.bytes)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _leaves(y)


def _empty(shape, dtype, like):
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


@contextlib.contextmanager
def kernels_as_work(counter: Counter):
    """Replace the kernel entries that ``kernels/ops.py`` reaches by
    meta stand-ins that add their kernel's work (``obs.flops``) to
    ``counter`` and return empty outputs of the kernels' shapes (an
    allocation moves no bytes in the count)."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import lasp2_chunk as lc
    from repro_torch.kernels import lasp2_decode as dc

    def chunk_fwd(q, k, v, log_a, *, block_size=lc.DEFAULT_BLOCK):
        bh, s, dk = q.shape
        dv = v.shape[-1]
        counter.add("K1", *F.chunk_fwd_work(bh, s, dk, dv,
                                            q.element_size()))
        return (_empty((bh, s, dv), q.dtype, q),
                _empty((bh, dk, dv), torch.float32, q),
                _empty((bh,), torch.float32, q))

    def chunk_dq(k, v, log_a, do, *, block_size=lc.DEFAULT_BLOCK):
        bh, s, dk = k.shape
        work = F.chunk_bwd_work(bh, s, dk, v.shape[-1], k.element_size())
        counter.add("K2a", *work[0])
        return _empty(k.shape, k.dtype, k)

    def chunk_dkv(q, k, v, log_a, o, do, dstate, *,
                  block_size=lc.DEFAULT_BLOCK):
        bh, s, dk = q.shape
        work = F.chunk_bwd_work(bh, s, dk, v.shape[-1], q.element_size())
        counter.add("K2b", *work[1])
        return (_empty(k.shape, k.dtype, k), _empty(v.shape, v.dtype, v),
                _empty((bh, s), torch.float32, q))

    def flash_pairs(q, k, kw):
        _, q_off, kv_len = fl._resolve(q, k, kw.get("scale"),
                                       kw.get("q_offset"), kw.get("kv_len"))
        return q.shape[0] * q.shape[1] * F.flash_pairs(
            q.shape[2], k.shape[2], q_off, kv_len, kw.get("causal", True),
            kw.get("window"))

    def flash_work(q, k, kw, i):
        b, hq, sq, dh = q.shape
        return F.flash_work(b, hq, k.shape[1], sq, k.shape[2], dh,
                            q.element_size(), flash_pairs(q, k, kw))[i]

    def flash_fwd(q, k, v, **kw):
        counter.add("K4", *flash_work(q, k, kw, 0))
        return _empty(q.shape, q.dtype, q), \
            _empty(q.shape[:3], torch.float32, q)

    def flash_dq(q, k, v, do, lse, delta, **kw):
        counter.add("K5a", *flash_work(q, k, kw, 1))
        return _empty(q.shape, q.dtype, q)

    def flash_dkv(q, k, v, do, lse, delta, **kw):
        counter.add("K5b", *flash_work(q, k, kw, 2))
        return _empty(k.shape, k.dtype, k), _empty(v.shape, v.dtype, v)

    def decode(q, k, v, log_a, state, log_decay, *, route=None):
        bh, dk = q.shape
        dv = v.shape[1]
        counter.add("K3", *F.decode_work(bh, dk, dv, q.element_size()))
        return _empty((bh, dv), torch.float32, q), state, log_decay

    patches = ((lc, "lasp2_chunk_fwd", chunk_fwd),
               (lc, "lasp2_chunk_bwd_dq", chunk_dq),
               (lc, "lasp2_chunk_bwd_dkv", chunk_dkv),
               (fl, "flash_attention_fwd", flash_fwd),
               (fl, "flash_attention_bwd_dq", flash_dq),
               (fl, "flash_attention_bwd_dkv", flash_dkv),
               (dc, "lasp2_decode_step", decode))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def measure(cell) -> CostVector:
    """The cell's program once on the meta device: its FLOPs and HBM
    bytes (kernels as their own work) and its kernel launches."""
    counter = Counter()
    with kernels_as_work(counter), counter:
        cell.fn(*cell.abstract_args)
    cost = counter.cost()
    cost.kernels = dict(counter.kernels)
    return cost


def collective_bytes(cell) -> Dict[str, float]:
    """Per-op collective bytes a device puts on the wire in one step: the
    cell's budget ceilings (``launch.dryrun.collective_report``)."""
    from repro_torch.launch.dryrun import collective_report
    return {k: float(v) for k, v in
            collective_report(cell)["max_traffic_bytes"].items()}


def _cell(arch, shape, cfg, run, *, n_groups=None, microbatches=None):
    """The one-card cell of ``cfg`` on ``shape`` at ``n_groups`` pattern
    repetitions (full depth by default) and ``microbatches`` (the cell's
    own by default), its microbatch rows held at the full cell's."""
    from repro_torch.launch.cells import (build_cell, choose_microbatches,
                                          reduced_depth_config)
    if n_groups is not None:
        cfg = reduced_depth_config(cfg, n_groups)
    if shape.kind == "train" and microbatches is not None:
        rows = shape.global_batch // choose_microbatches(
            shape, 1, target=run.microbatch_tokens)
        shape = dataclasses.replace(shape, global_batch=rows * microbatches)
    return build_cell(arch, shape.name, None, cfg_override=cfg, run=run,
                      shape=shape)


def solve(f11, f12, f21, f22):
    """``(c0, c1, c2, c3)`` of ``cost(A, G) = c0 + G·c3 + A·(c1 + G·c2)``
    from the costs at (A, G) = (1, 1), (1, 2), (2, 1), (2, 2)."""
    c2 = (f22 - f21) - (f12 - f11)
    c3 = (f12 - f11) - c2
    c1 = (f21 - f11) - c2
    c0 = f11 - c1 - c2 - c3
    return c0, c1, c2, c3


def extrapolate(c, a, g) -> CostVector:
    c0, c1, c2, c3 = c
    return c0 + c3.scale(g) + (c1 + c2.scale(g)).scale(a)


def roofline_terms(cost: CostVector, dtype: str = "bfloat16"
                   ) -> Dict[str, float]:
    """The three per-step time lower bounds on the card, in seconds."""
    t_compute = cost.flops / F.peak_flops(dtype)
    t_memory = cost.hbm_bytes / F.HBM_BYTES_PER_S
    t_coll = cost.coll_bytes / F.NVLINK_BYTES_PER_S
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "dominant": dominant,
            "bound_s": max(t_compute, t_memory, t_coll)}


def _positional(cfg) -> bool:
    """True when layers of one pattern position differ by depth (hymba's
    global layers): the solve's premise fails."""
    from repro_torch.models.model import hymba_global_flags
    return hymba_global_flags(cfg) is not None


def record(arch: str, shape_name: str, *, cfg=None, shape=None,
           run=None) -> dict:
    """The roofline record of one cell (the reference's keys): ``arch`` ×
    ``SHAPES[shape_name]`` under ``RunConfig()``, or the ``cfg``,
    ``shape`` and ``run`` given (a measured program's own).

    Train cells: the costs at (A, G) ∈ {1, 2}² give the solve; the
    full-depth program at A = min(A_cell, 2) is counted and must equal
    the solve there; the record is the solve at the cell's (A, G), the
    microbatch loop repeating identical work. Prefill and decode cells:
    the full-depth program is the record, checked against the G ∈ {1, 2}
    solve."""
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.launch.cells import choose_microbatches, resolve_config
    shape = shape or SHAPES[shape_name]
    note = "override"
    if cfg is None:
        cfg, note = resolve_config(arch, shape_name)
    run = run or RunConfig()
    g = cfg.n_groups
    cell = lambda **kw: _cell(arch, shape, cfg, run, **kw)
    if shape.kind == "train":
        a = choose_microbatches(shape, 1, target=run.microbatch_tokens)
        c = solve(*(measure(cell(n_groups=gg, microbatches=aa))
                    for aa, gg in ((1, 1), (1, 2), (2, 1), (2, 2))))
        a_chk = min(a, 2)
        full = measure(cell(microbatches=a_chk))
        solved = extrapolate(c, a_chk, g)
        total = extrapolate(c, a, g)
        extra = {"A": a, "G": g, "checked_at_A": a_chk}
    else:
        f1, f2 = (measure(cell(n_groups=gg)) for gg in (1, 2))
        full = total = measure(cell())
        solved = (f1 - (f2 - f1)) + (f2 - f1).scale(g)
        extra = {"G": g}
    exact = (solved.flops == full.flops
             and solved.hbm_bytes == full.hbm_bytes)
    if not exact and not _positional(cfg):
        raise AssertionError(
            f"{arch} x {shape.name}: the (A, G) solve gives "
            f"{solved.flops} FLOPs / {solved.hbm_bytes} bytes, the "
            f"full-depth count {full.flops} / {full.hbm_bytes}")
    extra.update(full_depth_flops=full.flops,
                 full_depth_hbm_bytes=full.hbm_bytes,
                 solved_flops=solved.flops, solved_hbm_bytes=solved.hbm_bytes,
                 equals_full_depth=exact)
    if not exact:
        extra["note"] = ("layers differ by position (global layers): the "
                         "solve is not exact")
    coll = collective_bytes(cell())
    total.coll_bytes, total.coll_by_op = sum(coll.values()), coll
    terms = roofline_terms(total, cfg.dtype)
    mf = F.model_flops(cfg, shape)
    ideal_s = mf / F.peak_flops(cfg.dtype)
    return {
        "arch": arch, "shape": shape.name, "config": cfg.name, "note": note,
        "mesh": "1 card", "devices": 1, "dtype": cfg.dtype,
        "runs_on": "meta (nothing runs on a device)", "status": "ok",
        "extrapolation": extra,
        "per_device": {"flops": total.flops, "hbm_bytes": total.hbm_bytes,
                       "collective_bytes": total.coll_bytes,
                       "coll_by_op": total.coll_by_op},
        "kernel_launches_at_checked_A": full.kernels,
        "terms": terms,
        "model_flops": mf,
        "hlo_flops_global": total.flops,
        "useful_flops_ratio": mf / total.flops if total.flops else 0.0,
        "roofline_fraction": ideal_s / terms["bound_s"]
        if terms["bound_s"] else 0.0,
    }


def run_one(arch: str, shape_name: str, out_dir: str) -> bool:
    t0 = time.time()
    try:
        rec = record(arch, shape_name)
        t = rec["terms"]
        print(f"[roofline] {arch} x {shape_name}: "
              f"compute {t['compute_s'] * 1e3:.2f}ms "
              f"memory {t['memory_s'] * 1e3:.2f}ms "
              f"collective {t['collective_s'] * 1e3:.2f}ms "
              f"-> {t['dominant']}-bound; "
              f"useful-FLOPs {rec['useful_flops_ratio']:.2%}; "
              f"roofline-fraction {rec['roofline_fraction']:.2%}")
    except Exception as e:  # noqa: BLE001
        rec = {"arch": arch, "shape": shape_name, "status": "fail",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[roofline] {arch} x {shape_name}: FAIL {e}",
              file=sys.stderr)
    rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}".replace("/", "_") + ".json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec["status"] == "ok"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.roofline",
        description="per-cell roofline of the one-card program, counted "
                    "on the meta device (nothing runs on any device)")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/roofline_torch")
    args = ap.parse_args(argv)
    if args.all:
        from repro_torch.configs import ALL_IDS
        from repro_torch.configs.base import SHAPES
        res = {f"{a}__{s}": run_one(a, s, args.out)
               for a in ALL_IDS for s in SHAPES}
        bad = [k for k, ok in res.items() if not ok]
        print(f"\n{len(res) - len(bad)}/{len(res)} roofline cells OK")
        return 1 if bad else 0
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    return 0 if run_one(args.arch, args.shape, args.out) else 1


if __name__ == "__main__":
    sys.exit(main())
