"""Training launcher of the port: the fault-tolerant loop on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch linear-llama3-1b \
      --steps 10 --batch 8 --seq 2048 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --variant HYBRID \
      --steps 10 --batch 8 --seq 2048 --microbatches 2   # LASP-2H hybrid
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
      --steps 10 --batch 8 --seq 2048 --microbatches 2 --remat full
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
      --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch moonshot-v1-16b-a3b --linearize 0 --smoke --device cpu \
      --steps 5                              # Linear-MoE (one device)
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --smoke --device cpu --sp-degree 2 \
      --steps 20 --seq 64 --batch 4          # DP×SP over gloo ranks
      # --comm-strategy ring | pipelined | ulysses: the other exchanges
  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
      -m repro_torch.launch.train --smoke --device cpu --steps 20 \
      --seq 256 --dp-degree 2 --sp-degree 2 --tp-degree 2 \
      --comm-strategy ulysses                # 3D DP×SP×TP (USP Ulysses)
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 5 --guard --metrics-out run.jsonl --ckpt-dir ckpt

Runs on the CUDA card unless ``--device`` names another device. Weights
are random, drawn from ``--seed``; data is ``SyntheticLM`` (packed
documents with state resets). Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the store address in the environment)
each rank runs the DP×SP(×TP) step of a ``--dp-degree`` ×
``--sp-degree`` × ``--tp-degree`` layout: NCCL with rank r on card
``LOCAL_RANK``, gloo with ``--device cpu``; only rank 0 logs; MoE configs
train on one device only. With ``--tp-degree`` above 1 the tokens split
over sp×tp ranks, and under ``--comm-strategy ulysses`` the softmax
layers' all-to-alls run over the tp ranks (the heads must divide by tp);
the ring and pipelined exchanges are refused there. ``--grad-compression``
is the reference's pod-mesh flag: inert on one device, refused under a
layout, as in the reference.
``--linearize K`` applies the paper's recipe to the chosen config
(``--smoke`` included). ``--guard`` turns on the numerical health guard
(skip a non-finite step, clip a spike, abort after ``--guard-max-skips``
consecutive skips); ``--metrics-out`` writes the run's telemetry as JSONL
(rank 0's under torchrun; the reference's ``scripts/report.py`` renders
it). A ``--ckpt-dir`` written under one layout resumes under another.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="linear-llama3-1b")
    ap.add_argument("--variant", default=None,
                    help="config-module variant (e.g. HYBRID, DENSE)")
    ap.add_argument("--linearize", type=int, default=None,
                    help="the paper's Linear-X recipe on the arch: 0 = "
                         "every softmax layer linear, k > 0 = a 1/k hybrid "
                         "(every k-th softmax layer kept, windowed 2048)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-verify", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="verify per-array SHA-256 checksums on restore; "
                         "a corrupt latest checkpoint falls back to the "
                         "newest valid one (--no-ckpt-verify to disable)")
    ap.add_argument("--guard", action="store_true",
                    help="the numerical health guard: skip a step with a "
                         "non-finite loss or gradient (the health scalar "
                         "rides the one gradient all-reduce), clip a "
                         "grad-norm spike to a rolling median, abort "
                         "after --guard-max-skips consecutive skips")
    ap.add_argument("--guard-max-skips", type=int, default=8,
                    help="consecutive skipped steps before the loop "
                         "aborts with GuardAbort")
    ap.add_argument("--metrics-out", default=None,
                    help="write run telemetry (per-step phase walls, "
                         "tokens/s, MFU against the card's peak, the "
                         "first step's tape against its issued "
                         "collectives) as JSONL here")
    ap.add_argument("--remat", default="none", choices=["none", "full"])
    ap.add_argument("--dp-degree", type=int, default=1)
    ap.add_argument("--sp-degree", type=int, default=1)
    ap.add_argument("--tp-degree", type=int, default=1,
                    help="head-parallel degree of the 3D DP×SP×TP layout: "
                         "tokens split over sp×tp ranks, Ulysses' "
                         "all-to-alls run over the tp ranks")
    ap.add_argument("--grad-compression", action="store_true",
                    help="the reference's cross-pod gradient compression: "
                         "inert on one device, refused under a layout")
    ap.add_argument("--zero1", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shard the Adam moments over the data ranks "
                         "(--no-zero1 to replicate them)")
    ap.add_argument("--comm-strategy", default="allgather",
                    choices=["allgather", "ring", "pipelined", "ulysses"],
                    help="the SP exchange: LASP-2's state all-gather, "
                         "LASP-1's ring, the ring in dv slices, or "
                         "Ulysses' all-to-alls for softmax layers")
    ap.add_argument("--comm-dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--comm-overlap", default="overlap",
                    choices=["overlap", "none"])
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke, get_variant
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.loop import train
    from repro_torch.train.step import check_layout_strategy

    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dp, sp, tp = args.dp_degree, args.sp_degree, args.tp_degree
    if dp * sp * tp != world:
        raise ValueError(f"--dp-degree × --sp-degree × --tp-degree = {dp} × "
                         f"{sp} × {tp} must equal the {world} ranks")
    mb = args.batch // args.microbatches
    if mb % dp or args.seq % (sp * tp):
        raise ValueError(f"--batch/microbatches ({mb}) must divide by dp "
                         f"({dp}) and --seq ({args.seq}) by sp×tp ({sp}×"
                         f"{tp})")
    check_layout_strategy(args.comm_strategy, tp)
    if args.smoke:
        cfg = get_smoke(args.arch)
    elif args.variant:
        cfg = get_variant(args.arch, args.variant)
    else:
        cfg = get_config(args.arch)
    if args.linearize is not None:
        cfg = cfg.linearize(hybrid_every=args.linearize)
    run = RunConfig(num_microbatches=args.microbatches,
                    learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 5),
                    remat=args.remat, seed=args.seed,
                    ckpt_verify=args.ckpt_verify, zero1=args.zero1,
                    comm_strategy=args.comm_strategy,
                    comm_dtype=args.comm_dtype,
                    comm_overlap=args.comm_overlap, guard=args.guard,
                    guard_max_consecutive_skips=args.guard_max_skips,
                    grad_compression=args.grad_compression,
                    dp_degree=dp, sp_degree=sp, tp_degree=tp)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    layout, log_fn = None, print
    if world > 1:
        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_training_groups

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        layout = make_training_groups(dp, sp, tp)
        if dist.get_rank():
            log_fn = lambda *_: None
    sink = None
    if args.metrics_out and (layout is None or dist.get_rank() == 0):
        from repro_torch.obs import JsonlSink
        sink = JsonlSink(args.metrics_out)
    try:
        _, history = train(cfg, run, data, device=device,
                           ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                           layout=layout, log_fn=log_fn, sink=sink)
    finally:
        if layout is not None:
            dist.destroy_process_group()
        if sink is not None:
            sink.close()
            log_fn(f"[train] telemetry -> {args.metrics_out}")
    first = sum(h["loss"] for h in history[:10]) / max(len(history[:10]), 1)
    last = sum(h["loss"] for h in history[-10:]) / max(len(history[-10:]), 1)
    log_fn(f"[train] {cfg.name} on {device}: loss {first:.4f} -> "
           f"{last:.4f} over {len(history)} steps "
           f"({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
