#!/usr/bin/env python3
"""A model at full width on the card at phase 7's learning rate, 3e-4,
which ``chip_smoke.py`` does not train it at (by default GLA), or at
another rate and depth.

    python3 scripts/variant_lr_probe.py
    python3 scripts/variant_lr_probe.py --arch mamba2-2.7b
    python3 scripts/variant_lr_probe.py --arch codeqwen1.5-7b --layers 2 \
        --steps 3 --lr 1e-4 1e-5

``--arch gla`` is ``linear-llama3-1b``'s ``CONFIG`` with
``LinearAttnConfig("silu", "data", "autodiff")``; ``mamba2-2.7b`` and
``hymba-1.5b`` and the zoo's ids (phase 14) are their ``CONFIG``s,
``--layers`` cutting the depth. Each trains ``--steps`` (5) steps at each
``--lr`` through
``train()`` on phase 7's run and data (``chip_smoke.train_setup``) in
bf16 (``sm90`` kernels, but for hymba's chunk kernels; no remat for GLA,
full remat for the SSM family, as phase 13) and in fp32 (``simt``
kernels, ``remat="full"`` to fit). Prints one line per
run: the loss, grad norm and learning rate of each step. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gla",
                    choices=["gla", "mamba2-2.7b", "hymba-1.5b",
                             "codeqwen1.5-7b", "granite-34b",
                             "starcoder2-15b", "moonshot-v1-16b-a3b",
                             "phi3.5-moe-42b-a6.6b"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-4])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variant_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.configs import LinearAttnConfig, get_config
    from repro_torch.train.loop import train
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.arch == "gla":
        linear = get_config("linear-llama3-1b")
        base = dataclasses.replace(
            linear, name=linear.name + "-gla",
            linear_attn=LinearAttnConfig("silu", "data", "autodiff"))
    else:
        base = get_config(args.arch)
    if args.layers:
        base = dataclasses.replace(base, n_layers=args.layers)
    for lr, dtype in ((lr, d) for lr in args.lr
                      for d in ("bfloat16", "float32")):
        remat = "none" if args.arch == "gla" and dtype == "bfloat16" \
            else "full"
        cfg = dataclasses.replace(base, dtype=dtype)
        run, data = C.train_setup(cfg, args.steps, lr, remat)
        state, hist = train(cfg, run, data, log_every=10 ** 9,
                            log_fn=lambda *_: None)
        print(f"[probe] {cfg.name} layers={cfg.n_layers} dtype={dtype} "
              f"lr={run.learning_rate} "
              f"remat={remat} losses={[round(h['loss'], 4) for h in hist]} "
              f"grad_norms={[round(h['grad_norm'], 3) for h in hist]} "
              f"lrs={[round(h['lr'], 8) for h in hist]}", flush=True)
        del state, hist
        C._free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
