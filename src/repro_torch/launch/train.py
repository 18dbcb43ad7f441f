"""Training launcher of the port: the fault-tolerant loop on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch linear-llama3-1b \
      --steps 10 --batch 8 --seq 2048 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --variant HYBRID \
      --steps 10 --batch 8 --seq 2048 --microbatches 2   # LASP-2H hybrid

Runs on the CUDA card unless ``--device`` names another device. Weights
are random, drawn from ``--seed``; data is ``SyntheticLM`` (packed
documents with state resets). The mesh, communication and guard flags of
``repro.launch.train`` come with the slices that port them.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="linear-llama3-1b")
    ap.add_argument("--variant", default=None,
                    help="config-module variant (e.g. HYBRID, DENSE)")
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
    ap.add_argument("--remat", default="none", choices=["none", "full"])
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke, get_variant
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.loop import train

    device = resolve_device(args.device)
    if args.smoke:
        cfg = get_smoke(args.arch)
    elif args.variant:
        cfg = get_variant(args.arch, args.variant)
    else:
        cfg = get_config(args.arch)
    run = RunConfig(num_microbatches=args.microbatches,
                    learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 5),
                    remat=args.remat, seed=args.seed,
                    ckpt_verify=args.ckpt_verify)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    _, history = train(cfg, run, data, device=device,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    first = sum(h["loss"] for h in history[:10]) / max(len(history[:10]), 1)
    last = sum(h["loss"] for h in history[-10:]) / max(len(history[-10:]), 1)
    print(f"[train] {cfg.name} on {device}: loss {first:.4f} -> {last:.4f} "
          f"over {len(history)} steps "
          f"({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
