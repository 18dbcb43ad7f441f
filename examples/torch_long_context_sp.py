"""Long-context sequence parallelism on the PyTorch port: shard a
64K-token sequence over 8 ranks with LASP-2, verify it against the
local computation, and show how its communication differs from LASP-1's
and Megatron-SP's (the paper's §3.4 comparison, reproduced
structurally). The twin of ``examples/long_context_sp.py``; it imports
only ``repro_torch``.

The ranks are 8 processes joined by gloo (``launch.mesh.run_ranks``), on
the CUDA card by default (all 8 share it; gloo stages each exchange
through host memory), or with ``--device cpu`` on the plain PyTorch
path, whose Megatron-SP softmax holds S x S scores a head: there give
``--seq`` a few thousand tokens. Where the reference reads the compiled
HLO, the port reads its collective tape (``comm.primitives.tape()``),
which records every collective as it is issued: LASP-2's and LASP-1's
tapes are held to their budgets (``comm.budget``), Megatron-SP's is
printed.

  PYTHONPATH=src python examples/torch_long_context_sp.py \
      [--device cpu --seq 2048]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch
import torch.distributed as dist

from repro_torch.comm import primitives
from repro_torch.comm.budget import (assert_budget, lasp2_budget,
                                     ring_baseline_budget)
from repro_torch.core.baselines import lasp1, megatron_sp_attention
from repro_torch.core.device import resolve_device
from repro_torch.core.lasp2 import SPConfig, lasp2
from repro_torch.launch.mesh import run_ranks

WORLD, B, H, S, D = 8, 1, 8, 65536, 64
CASES = ("LASP-2 (AllGather of M_t)", "LASP-1 (ring P2P)",
         "Megatron-SP (AllGather activations)")


def _inputs(b, h, s, d, dtype):
    """q, k, v: (b, h, s, d) from seed 0 (N(0, 1) times 0.3, 0.3, 0.5)."""
    gen = torch.Generator().manual_seed(0)
    return tuple((torch.randn((b, h, s, d), generator=gen) * scale).to(dtype)
                 for scale in (0.3, 0.3, 0.5))


def _tape_summary(records):
    """``{op: [count, payload bytes]}`` of one tape."""
    out = {}
    for r in records:
        n = out.setdefault(r.op, [0, 0])
        n[0] += 1
        n[1] += r.payload_bytes
    return out


def _rank(rank, world, device, b, h, s, d, dtype_name):
    """One rank: LASP-2 on its chunk against the local computation over
    the whole sequence (sliced to the chunk), then LASP-2, LASP-1 and
    Megatron-SP on its chunk under the tape, the first two held to their
    budgets. Returns the chunk's max |Δ| and max |o|, and each tape's
    summary."""
    dtype = getattr(torch, dtype_name)
    sp = SPConfig(dist.group.WORLD)
    q, k, v = (x.to(device) for x in _inputs(b, h, s, d, dtype))
    c = s // world
    mine = slice(rank * c, (rank + 1) * c)
    chunk = [x[:, :, mine].contiguous() for x in (q, k, v)]
    budgets = (lasp2_budget("allgather", world), ring_baseline_budget(world),
               None)
    fns = (lambda *x: lasp2(*x, sp=sp), lambda *x: lasp1(*x, sp=sp),
           lambda *x: megatron_sp_attention(*x, sp=sp))
    outs, tapes = [], []
    with torch.no_grad():
        o_loc = lasp2(q, k, v, sp=None)[:, :, mine].float()
        for fn, budget in zip(fns, budgets):
            with primitives.tape() as rec:
                outs.append(fn(*chunk))
            if budget is not None:
                assert_budget(rec, budget)
            tapes.append(_tape_summary(rec))
    return {"diff": float((outs[0].float() - o_loc).abs().max()),
            "scale": float(o_loc.abs().max()), "tapes": tapes}


def long_context_sp(device=None, *, world=WORLD, b=B, h=H, s=S, d=D,
                    dtype=torch.bfloat16, log_fn=print, rank_fn=_rank):
    """Run the demo on ``world`` gloo ranks at (b, h, s, d) in ``dtype``
    on ``device`` (the card when None). Raises if a budget is violated.
    ``rank_fn`` is what each rank runs: ``_rank``, or a picklable
    function that calls it with the same arguments and returns its
    result with more keys. Returns ``(max relative |Δ| of LASP-2 sharded
    against local, rank 0's tape summaries by case, every rank's
    result)``."""
    where = resolve_device(device).type
    log_fn(f"sequence: {s} tokens over {world} ranks ({s // world} per "
           f"rank)\n")
    ranks = run_ranks(rank_fn, world, device=where,
                      args=(b, h, s, d, str(dtype).replace("torch.", "")))
    rel = max(r["diff"] for r in ranks) / max(r["scale"] for r in ranks)
    log_fn(f"LASP-2 sharded == local: max rel Δ = {rel:.2e} "
           f"({str(dtype).replace('torch.', '')} I/O, fp32 state)\n")
    tapes = dict(zip(CASES, ranks[0]["tapes"]))
    for name, tape in tapes.items():
        checked = "verified" if name != CASES[2] else "n/a"
        ops = {op: n for op, (n, _) in tape.items()}
        payload = {op: nbytes for op, (_, nbytes) in tape.items()}
        log_fn(f"{name:40s} collectives={ops} payload_bytes={payload} "
               f"budget={checked}")
    log_fn(f"\nLASP-2's gather moves H·dk·dv state bytes, independent of "
           f"the\n{s}-token sequence; Megatron-SP's gather scales with S.")
    return rel, tapes, ranks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seq", type=int, default=S,
                    help=f"sequence length (default {S})")
    args = ap.parse_args(argv)
    return long_context_sp(args.device, s=args.seq)


if __name__ == "__main__":
    main()
