"""Serving launcher of the port: initialise a model and serve batched
requests through the continuous-batching engine, or, for encoder and
image models, one static batch through ``ServeEngine.generate``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch linear-llama3-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --variant HYBRID
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-110b
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --linearize 0      # Linear-MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
      --smoke --device cpu --max-batch 2 --prompt-len 16 --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --ckpt-dir ckpt --metrics-out serve.jsonl   # serve what was trained

Runs on the CUDA card unless ``--device`` names another device. Weights
are random, drawn from ``--seed``, or with ``--ckpt-dir`` the params of
the newest checkpoint the port's train loop wrote there (its fp32
masters, restored as stored; the forward casts them to ``cfg.dtype`` at
use, as in training); a directory without a checkpoint raises. The
config flags must name the trained config (checkpoints hold no config,
and those of the reference's package have other leaf paths).
``--metrics-out`` writes one ``request`` record a finished request and
the engine's ``summary`` as JSONL. ``--linearize K`` applies the paper's
Linear-X recipe to the chosen config (``--smoke`` included). For an
encoder or image model (``whisper-base``, ``llama-3.2-vision-90b``)
``--max-batch`` rows of ``--prompt-len`` random tokens are served with
random frames or image embeddings (N(0, 0.1²), drawn on the device),
``--new-tokens`` each; ``--requests`` is not read there.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="linear-llama3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="config-module variant (e.g. HYBRID, DENSE)")
    ap.add_argument("--linearize", type=int, default=None,
                    help="the paper's Linear-X recipe on the arch: 0 = "
                         "every softmax layer linear, k > 0 = a 1/k hybrid "
                         "(every k-th softmax layer kept, windowed 2048)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests to submit")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (continuous-batching grid)")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="max prompt length (ragged, varied per request)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue; submissions beyond "
                         "this many waiting requests are rejected "
                         "(0 = unbounded)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline: unfinished requests are "
                         "evicted this many seconds after submit (0 = none)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest checkpoint here")
    ap.add_argument("--metrics-out", default=None,
                    help="write serve telemetry (request records and the "
                         "summary) as JSONL here")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke, get_variant
    from repro_torch.core.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    device = resolve_device(args.device)
    if args.smoke:
        cfg = get_smoke(args.arch)
    elif args.variant:
        cfg = get_variant(args.arch, args.variant)
    else:
        cfg = get_config(args.arch)
    if args.linearize is not None:
        cfg = cfg.linearize(hybrid_every=args.linearize)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.ckpt_dir:
        params = _restore_params(args.ckpt_dir, cfg, gen, device)
    else:
        params = M.init_params(gen, cfg, device=device)
    sink = None
    if args.metrics_out:
        from repro_torch.obs import JsonlSink
        sink = JsonlSink(args.metrics_out)
    max_len = args.prompt_len + args.new_tokens
    engine = ServeEngine(cfg, params, max_len=max_len,
                         max_batch=args.max_batch, sink=sink,
                         max_queue=args.max_queue or None, device=device)
    try:
        if cfg.encoder is not None or cfg.n_image_tokens:
            out = _serve_static(args, cfg, engine, gen, device)
            n_done = out.shape[0]
        else:
            out = _serve_requests(args, cfg, engine, device)
            n_done = len(out)
        if sink is not None:
            engine.emit_summary(requests=n_done)
    finally:
        if sink is not None:
            sink.close()
    if sink is not None:
        print(f"[serve] telemetry -> {args.metrics_out}")
    return out


def _restore_params(ckpt_dir, cfg, gen, device):
    """The ``{"params": ...}`` subtree of the newest checkpoint under
    ``ckpt_dir``, restored (checksums verified) into fp32 master params of
    ``cfg``'s shapes."""
    from repro_torch.checkpoint.manager import CheckpointError, \
        CheckpointManager
    from repro_torch.models import model as M

    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise CheckpointError(f"no checkpoint under {ckpt_dir}")
    target = {"params": M.init_params(gen, cfg, device=device,
                                      param_dtype=cfg.param_dtype)}
    params = mgr.restore(step, target)["params"]
    print(f"[serve] restored params from step {step}")
    return params


def _serve_requests(args, cfg, engine, device):
    """Continuous batching: ragged prompts, more requests than slots.
    Returns ``{uid: new tokens}``."""
    import numpy as np

    from repro_torch.core.device import synchronize
    from repro_torch.serve.scheduler import QueueFullError

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1,
                        size=args.requests)
    uids = []
    rejected = 0
    for i, ln in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, size=int(ln))
        try:
            uids.append(engine.submit(
                prompt, args.new_tokens, temperature=args.temperature,
                seed=args.seed, stream=i,
                deadline_s=args.deadline_s or None))
        except QueueFullError:
            rejected += 1
    if rejected:
        print(f"[serve] queue full: rejected {rejected}/{args.requests} "
              f"requests (--max-queue {args.max_queue})")
    t0 = time.perf_counter()
    results = engine.run()
    synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(v) for v in results.values())
    stats = engine.cache_stats()
    print(f"[serve] {cfg.name} on {device}: {len(results)} requests "
          f"(prompts {lens.min()}..{lens.max()}) on {args.max_batch} slots "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s incl. prefill)")
    print(f"[serve] cache bytes: linear_state={stats['linear_state']} "
          f"kv_ring={stats['kv_ring']} conv={stats['conv']} "
          f"total={stats['total']}")
    s = engine.stats()
    if "ttft_s_p50" in s:
        print(f"[serve] ttft p50 {s['ttft_s_p50']*1e3:.1f}ms "
              f"p99 {s['ttft_s_p99']*1e3:.1f}ms; decode p50 "
              f"{s.get('decode_step_s_p50', 0)*1e3:.1f}ms p99 "
              f"{s.get('decode_step_s_p99', 0)*1e3:.1f}ms; "
              f"{s.get('decode_tokens_per_s', 0):.1f} decode tok/s")
    if uids and uids[0] in results:
        print("[serve] first result:", results[uids[0]][:16], "...")
    return results


def _serve_static(args, cfg, engine, gen, device):
    """The static-batch path of encoder and image models: one rectangular
    batch with its memories, as the reference's launcher serves them.
    Returns the (max_batch, new_tokens) int32 tokens."""
    import torch

    from repro_torch.core.device import synchronize

    kw = {}
    if cfg.encoder is not None:
        kw["enc_frames"] = torch.randn(
            (args.max_batch, cfg.encoder.n_frames, cfg.d_model),
            generator=gen, device=device) * 0.1
    if cfg.n_image_tokens:
        kw["img_emb"] = torch.randn(
            (args.max_batch, cfg.n_image_tokens, cfg.d_model),
            generator=gen, device=device) * 0.1
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.max_batch, args.prompt_len),
                            generator=gen, device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompts.cpu().numpy(), args.new_tokens,
                          temperature=args.temperature, seed=args.seed, **kw)
    synchronize(device)
    dt = time.perf_counter() - t0
    total_new = out.shape[0] * args.new_tokens
    print(f"[serve] {cfg.name}: static batch {out.shape} in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. prefill)")
    return out


if __name__ == "__main__":
    main()
