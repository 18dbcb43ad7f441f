"""Quickstart on the PyTorch port: train a tiny Linear-Llama3 (the paper's
model family) on synthetic data for 60 steps and watch the loss fall.
The twin of ``examples/quickstart.py``; it imports only ``repro_torch``
and runs on the CUDA card, or with ``--device cpu`` on the plain PyTorch
path.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train.loop import train


def quickstart(device=None, *, steps=60, seq_len=128, global_batch=8,
               log_every=10, log_fn=print):
    """Train SMOKE linear-llama3-1b (linear attention, tiny dims) for
    ``steps`` steps of ``global_batch`` rows of ``seq_len`` tokens in 2
    microbatches on ``device`` (the card when None). Returns the first
    and the last step's loss."""
    cfg = get_smoke("linear-llama3-1b")
    run = RunConfig(num_microbatches=2, total_steps=steps, warmup_steps=5,
                    learning_rate=1e-3, remat="none")
    data = SyntheticLM(cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=0)
    _, history = train(cfg, run, data, device=device, log_every=log_every,
                       log_fn=log_fn)
    return history[0]["loss"], history[-1]["loss"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    first, last = quickstart(args.device)
    print(f"\nquickstart: loss {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first - 0.2 else 'WARN: no drop'})")
    return first, last


if __name__ == "__main__":
    main()
