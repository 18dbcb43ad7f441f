"""Serve a hybrid (linear + softmax attention) model with continuous
batching on the PyTorch port: the twin of ``examples/serve_hybrid.py``.
It imports only ``repro_torch`` and runs on the CUDA card, or with
``--device cpu`` on the plain PyTorch path.

Shows the paper's constant-memory-inference property end to end: the
linear layers' decode cache is a fixed (B, H, dk, dv) fp32 state (+ a
cumulative log decay) however long the generation runs, and the 1-in-4
softmax layers keep a ring-buffer KV cache bounded by their sliding
window, so the whole decode cache is O(1) in context length. Requests
with different prompt lengths are admitted into and evicted from the
decode batch mid-flight.

  PYTHONPATH=src python examples/torch_serve_hybrid.py [--device cpu]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import LayerSpec
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine

WINDOW = 2048      # the hybrid's softmax window (ModelConfig.linearize)


def hybrid_config():
    """SMOKE linear-llama3-1b's widths as a 4-layer 1/4 hybrid: 3 linear
    layers and 1 softmax layer with a 2048-token window."""
    base = get_smoke("linear-llama3-1b")
    dense = dataclasses.replace(base, pattern=(LayerSpec(),), n_layers=4,
                                name="smoke-dense")
    return dense.linearize(hybrid_every=4)


def serve_hybrid(device=None, *, n_requests=8, max_batch=4, max_len=256,
                 new_tokens=24, log_fn=print):
    """Serve ``n_requests`` ragged prompts (8 to 64 tokens) on
    ``max_batch`` decode slots, ``new_tokens`` sampled tokens each, with
    random fp32 params from seed 0 on ``device`` (the card when None);
    raises unless every request got its tokens, the linear state is the
    same size at ``max_len`` 256 and 4096 and the ring is capped at the
    window. Returns ``(tokens per request, engine.cache_stats())``."""
    device = resolve_device(device)
    cfg = hybrid_config()
    log_fn(f"serving {cfg.name} | pattern: {[s.mixer for s in cfg.pattern]}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(gen, cfg, device=device,
                           param_dtype=cfg.param_dtype)
    engine = ServeEngine(cfg, params, max_len=max_len, max_batch=max_batch,
                         device=device)

    # ragged requests over fewer decode slots: continuous batching
    rng = np.random.default_rng(0)
    uids = []
    for i in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 65)))
        uids.append(engine.submit(prompt, new_tokens, temperature=0.8,
                                  seed=1, stream=i))
    results = engine.run()
    lengths = {u: len(results[u]) for u in uids}
    log_fn(f"generated: {lengths}")
    if set(lengths.values()) != {new_tokens}:
        raise AssertionError(f"a request did not get {new_tokens} tokens: "
                             f"{lengths}")
    stats = engine.cache_stats()
    log_fn(f"decode-cache bytes: linear_state={stats['linear_state']} "
           f"kv_ring={stats['kv_ring']} (ring = sliding window, not "
           f"context length)")

    # constant memory: the linear state's size does not depend on length
    caches = {n: M.init_cache(cfg, batch=4, max_len=n, device=device)
              for n in (256, 4096)}
    lin = {n: tuple(c["layers"][0]["mixer"]["m"].shape)
           for n, c in caches.items()}
    ring = {n: tuple(c["layers"][3]["mixer"]["k"].shape)
            for n, c in caches.items()}
    log_fn(f"linear-attn state:  max_len=256 -> {lin[256]}, max_len=4096 -> "
           f"{lin[4096]}  (CONSTANT: the paper's claim)")
    log_fn(f"softmax KV ring:    max_len=256 -> {ring[256]}, max_len=4096 -> "
           f"{ring[4096]}  (bounded by the {WINDOW} window)")
    if lin[256] != lin[4096]:
        raise AssertionError(f"linear state grew with max_len: {lin}")
    if ring[4096][-2] != WINDOW:
        raise AssertionError(f"ring not capped at the sliding window: "
                             f"{ring}")
    log_fn("OK")
    return lengths, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return serve_hybrid(args.device)


if __name__ == "__main__":
    main()
