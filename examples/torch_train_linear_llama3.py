"""End to end on the PyTorch port: train a ~100M-param
Linear-Llama3 for a few hundred steps with checkpointing and auto-resume,
the paper's §4 setup at small scale (pure linear attention; ``--hybrid``
for the 1/4 hybrid). The twin of ``examples/train_linear_llama3.py``; it
imports only ``repro_torch`` and runs on the CUDA card, or with
``--device cpu`` on the plain PyTorch path.

  PYTHONPATH=src python examples/torch_train_linear_llama3.py \\
      [--steps 300] [--hybrid] [--resume-demo] [--ckpt-dir DIR] \\
      [--device cpu]

``--resume-demo`` stops training halfway and restarts it, which resumes
from the latest checkpoint (the batches are a pure function of the
step, so the resumed run is the uninterrupted one bit for bit). Without
``--ckpt-dir`` the checkpoints go to a new temporary directory, removed
at the end.
"""

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs.base import (LayerSpec, LinearAttnConfig,
                                      ModelConfig, RunConfig)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train.loop import train


def model_100m(hybrid: bool) -> ModelConfig:
    """~100M params: 12 layers, d=512, 8 heads, the Linear-Llama3 recipe;
    built as the reference example builds it."""
    pattern = (LayerSpec(mixer="linear", mlp="dense"),)
    cfg = ModelConfig(
        name="linear-llama3-100m", family="dense",
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=1408, vocab_size=32000,
        pattern=pattern,
        linear_attn=LinearAttnConfig(feature_map="identity", decay="none",
                                     backward="faithful"))
    if hybrid:
        # linearize on an already-linear pattern keeps it linear: the
        # hybrid is built from the softmax base
        base = dataclasses.replace(cfg, pattern=(LayerSpec(),),
                                   name="llama3-100m")
        cfg = base.linearize(hybrid_every=4)
    return cfg


def train_demo(cfg, steps, *, ckpt_dir, resume_demo=False, device=None,
               seq_len=512, global_batch=8, log_every=10, log_fn=print):
    """Train ``cfg`` for ``steps`` steps (2 microbatches of
    ``global_batch`` rows of ``seq_len`` tokens, lr 6e-4 after 20 warm-up
    steps, full remat) with checkpoints in ``ckpt_dir``, resuming from
    the newest one there; with ``resume_demo`` first to ``steps // 2``,
    then again from that checkpoint. Returns the second run's history
    and final state."""
    run = RunConfig(num_microbatches=2, total_steps=steps, warmup_steps=20,
                    learning_rate=6e-4, remat="full")
    data = SyntheticLM(cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=0)
    kw = dict(device=device, log_every=log_every, log_fn=log_fn)
    if resume_demo:
        half = steps // 2
        log_fn(f"--- phase 1: train to step {half}, then stop ---")
        train(cfg, run, data, ckpt_dir=ckpt_dir, ckpt_every=25,
              max_steps=half, **kw)
        log_fn("--- phase 2: restart; auto-resume from the latest "
               "checkpoint ---")
    state, history = train(cfg, run, data, ckpt_dir=ckpt_dir, ckpt_every=50,
                           **kw)
    return history, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hybrid", action="store_true")
    ap.add_argument("--resume-demo", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one, removed at the end)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = model_100m(args.hybrid)
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.0f}M params")
    with tempfile.TemporaryDirectory(prefix="linear_llama3_ckpt-") as tmp:
        history, state = train_demo(cfg, args.steps,
                                    ckpt_dir=args.ckpt_dir or tmp,
                                    resume_demo=args.resume_demo,
                                    device=args.device)
    first = sum(h["loss"] for h in history[:5]) / max(len(history[:5]), 1)
    last = sum(h["loss"] for h in history[-5:]) / max(len(history[-5:]), 1)
    print(f"\n{cfg.name}: loss {first:.3f} -> {last:.3f} over "
          f"{len(history)} steps (final step {int(state['step'])})")
    return history, state


if __name__ == "__main__":
    main()
