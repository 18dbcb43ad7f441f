#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers in PERF.md). Phases, each
printing one line of facts; any failure exits non-zero before the last
line:

1. facts: the card's name and power limit, torch, CUDA, nvcc, triton;
   TF32 off for fp32 matrix products;
2. build: nvcc builds every kernel under ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes (K1 at the serving shapes and, on ``sm90``, the
   training shape; K3, the decode step, on both routes at the serving
   shape, and on ``sm90`` at (dk, dv) = (128, 64) and (16, 64) and without
   log a; K2a and K2b, the two passes of the chunk backward, at the
   training shape; K4, K5a and K5b, flash attention's forward and two
   backward passes, at the hybrid's training shape, a prefill shape, a
   trimmed band, GQA 4:1, an explicit offset, a non-causal window and
   the bidirectional model's unmasked 2048 keys (phase 12), the zoo's
   head layouts 48:1, 48:4, 64:8 and 32:8 at dh 128 (phase 14), the
   cross family's unmasked Sq ≠ Sk shapes with ragged keys (phase 15);
   K1, K2a, K2b
   and K3 also on GLA's log a (logsigmoid of N(0, 0.5²) a token, a reset
   mid-chunk; phase 12), on both routes;
   and K1, K2a, K2b, K4, K5a and K5b at the shapes phase 10 gives them:
   a rank's chunk of S 1024, K2a/K2b with a nonzero end-state cotangent,
   K4/K5a/K5b with 1024 queries at q_offset 1024 over 2048 keys).
   K1, K2a, K2b, K4, K5a and K5b each have two routes: ``sm90`` (tensor
   cores) for bf16 at dh 64 and 128 (the chunk kernels: dk and dv in {64,
   128}), ``simt`` (CUDA cores) for fp32 and the rest; K3's ``sm90``
   (16-column slices of the state by asynchronous copies) takes dk a
   multiple of 16 up to 256 and dv a multiple of 4, in bf16 and fp32. Each case checks the route it took. Each is timed
   beside the plain version's time, the least time the card could take
   (the bound) and, for flash attention, the time of
   ``F.scaled_dot_product_attention`` on the same causal shape: ``sm90``
   in bf16 and ``simt`` in fp32 (K1 at S 512 and S 2048, the others at the
   train shape; K3 in bf16 on each route, in turns, with the wrapper's
   host us a call); K1, K2a, K2b, K3, K5a and K5b on ``sm90`` are bitwise
   equal on two launches;
4. serve: full-width ``linear-llama3-1b`` (random weights from a seed,
   bf16) answers 8 ragged greedy requests through ``ServeEngine``; every
   request finishes, the launch counters show K1 and K3 (16 a decode
   step) on the path, all on ``sm90``, and decode logits agree with a
   fresh prefill in bf16, with the params in fp32, and with the caches
   in fp32 too (``phase_decode_check``, which every serving path runs);
5. profile: host wall against device kernel time of one decode step
   (4 slots, with K3's device ms in it) and one prefill batch (4 x 512),
   with the top kernels (and for the hybrid after phase 6: a decode step
   and one exact-length prefill row of 300);
6. hybrid serve: the same with the LASP-2H ``HYBRID`` (12 linear layers,
   4 softmax layers with a 2048-token window): exact-length prefill
   through K1 and K4, decode through K3 (12 a step, ``sm90``) and the
   ring cache; the cache's ``linear_state`` is constant in ``max_len`` and
   ``kv_ring`` matches its formula;
7. train: full-width, full-depth ``linear-llama3-1b`` trains 10 steps
   through ``train()`` (fp32 masters, bf16 compute, 8 x 2048 packed
   tokens in 2 microbatches); every loss is finite, none is skipped, the
   loss falls, and each step launches K1, K2a and K2b 16 x 2 times, all
   on ``sm90``; then the profile of one train step;
8. hybrid train: the same with ``HYBRID``; each step launches K1, K2a and
   K2b 12 x 2 times and K4, K5a and K5b 4 x 2 times, all six on their
   ``sm90`` route;
9. grad check: a 2-layer fp32 copy of the config at full width, the same
   params on the card (kernels) and on the host CPU (plain versions): the
   loss and every parameter gradient agree; then a 4-layer copy of
   ``HYBRID`` (3 linear + 1 softmax layer) the same way, fp32, so all six
   routed kernels take their ``simt`` route;
10. sp, LASP-2 and LASP-2H sequence parallelism (the DP×SP step,
   ``ShardedStep``): (a) at (dp, sp) = (1, 1) over NCCL in this process,
   full ``CONFIG``, 3 steps on phase 7's data: losses within 2e-4 and
   grad norms within 2^-8 of phase 7's first three, peak memory; (b) two
   ranks on the one card over
   gloo (NCCL refuses two ranks on one device; gloo stages every exchange
   through the host), full width, depth cut to 4 layers (two ranks share
   80 GB and every step moves the flat gradients through the host),
   4 × 2048 tokens: b1 the ``HYBRID`` cut (3 linear + 1 softmax) at (1, 2)
   on packed rows (the autodiff backward) and b2 the ``CONFIG`` cut at
   (1, 2) on rows without resets (the faithful backward), each with its
   loss (2e-3) and gradients (3e-2 relative L2 a leaf) against one device,
   then 3 steps; b3 the ``CONFIG`` cut at (2, 1) with ZeRO-1, 3 losses
   within 2e-4 and grad norms within 2^-8 of (1, 1), and every param
   after the 3 steps within 1e-6 relative (1e-7 absolute) of replicated
   AdamW at (2, 1); b4 the GLA model of phase 12 cut to 4 layers at
   (1, 2) on packed rows, 3 losses within 2e-4 and grad norms within 2^-8
   of its (1, 1) run. Each rank prints its launches per step (every
   kernel on ``sm90``), its tape per step, its step walls and peak
   memory, and the state all-gather's bytes at C 512 and 1024 (equal);
11. strategies, the exchange strategies and the paper's SP baselines on
   two ranks sharing the card over gloo, as 10 (b): (a) one full-width
   layer, B 1 x H 16 x S 2·4096 x dh 128 in bf16, each rank its chunk:
   ``lasp2`` under "allgather", "ring" and "pipelined", each with both
   overlap orders, and ``lasp1`` against one device's ``lasp2`` on the
   whole sequence; ``ulysses_context_attention`` (with and without a
   2048 window), ``ring_attention`` and ``megatron_sp_attention`` against
   ``allgather_context_attention``; o, dq, dk and dv within phase 10's
   3e-2 relative L2, each case's launches (sm90 only), tape and wall;
   (b) 3 steps of ``ShardedStep`` at (1, 2) under "ulysses" on b1's cut
   and data and under "ring" on b2's: losses within 2e-4 and grad norms
   within 2^-8 of b1's and b2's, launches and tape per step;
12. variants, the paper's Linear-Llama3 variants (§4, Tables 2-3) at
   full width, built in code in ``main`` as Table 2 builds them: ``gla``
   (``CONFIG`` with GLA's silu feature map and data-dependent decay, a
   ``wdt`` gate a layer), ``elu1`` (``CONFIG`` with the elu1 feature
   map) and ``DENSE``. (b) ``gla`` serves phase 4's eight requests as
   phase 4 checks them (K1 16 a prefill batch and K3 16 a decode step on
   ``sm90``, decode logits against a fresh prefill, ``linear_state``
   the same at ``max_len`` 544 and 4096), K3 taking a log a (each
   layer's cumulative log decay falls every step), and its decode step
   and prefill are profiled; (c) ``gla`` trains 5 steps as phase 7 at lr
   1e-4, the loss falling, K1, K2a and K2b counted; (d) fp32 grad checks
   as phase 9 on 2 layers of ``gla`` (``wdt``'s gradient among the
   leaves), and of ``elu1`` and ``DENSE`` with ``causal=False``; (e)
   Table 3's masked-token loop (``causal=False``, clip, AdamW) 3 steps on
   ``DENSE`` (K4, K5a, K5b 16 each a step, unmasked, ``sm90``) and
   ``elu1`` (Alg. 1, no kernel) at 4 x 2048, losses finite. (a), the
   kernel cases, and (f), cell b4, run in phases 3 and 10;
13. ssm, the SSM family at full width (``mamba2-2.7b``: 64 layers of 80
   SSD heads, (d_state, headdim) = (128, 64); ``hymba-1.5b``: 32 layers,
   GQA 25:5 at dh 64 beside 25 SSD heads of (16, 64)): (a) K1, K2a, K2b
   and K3 at both SSD shapes on SSD's log a at init (down to about −8 a
   token), each against its plain version and timed (K1, K2a, K2b:
   (128, 64) on ``sm90``, (16, 64) on ``simt`` in bf16 and fp32), and
   K4, K5a, K5b timed at hymba's shape (their parity runs in phase 3);
   (b) mamba2, cut to 32 of its 64 layers (``MAMBA2_LAYERS``), serves
   phase 4's requests by left-padded buckets (K1 and K3 32 a call,
   ``sm90``; the reference's cache bytes per layer) with phase 4's
   decode check and a profile; (c) hymba, cut to 24 of its 32 layers
   (``HYMBA_LAYERS``), the same by exact length (K1 24 on ``simt``, K4
   24, K3 24), globals 0, 8, 16, the gap on a 1100-token prompt past the
   1024 window; (d) both
   train 5 steps as phase 7 under full remat at lr 1e-4; (e) fp32 grad
   checks of 2 layers of each against the host CPU;
14. zoo, the decoder-only zoo and MoE, each ``CONFIG`` cut to 2 layers at
   full width (random weights from a seed): codeqwen1.5-7b and
   qwen1.5-110b (QKV biases; GQA 32:32 and 64:8), granite-34b (MQA 48:1,
   GELU), starcoder2-15b (48:4, GELU), moonshot-v1-16b-a3b (64 experts,
   top 6, 2 shared; 16:16) and phi3.5-moe-42b-a6.6b (16 experts, top 2;
   32:8). K4, K5a and K5b timed at the new head layouts; (a) each serves
   phase 4's requests by exact length (K4 2 a prefill batch, ``sm90``)
   with phase 4's decode check (the MoE pair on a drop-free copy, its
   routes held to the prefill's: logits held up to a step whose routes
   differ), and the MoE pair at ``CONFIG`` capacity greedy-equal to the
   host CPU in fp32; (b) each trains 3 steps of phase 7's schedule at
   phase 13's lr (qwen1.5-110b at 1 layer, 2 x 2048, full remat), losses
   finite, K4, K5a, K5b 2 a microbatch; (c) Linear-MoE (moonshot,
   ``linearize=0``) serves through K1 and K3 and trains through K1, K2a,
   K2b; (d) fp32 grad checks of codeqwen (biases) and moonshot (router,
   experts, shared) against the host CPU;
15. cross, the cross family at full width, every cross layer's gate set
   to 1.0 after init (at its init value 0 a cross layer outputs 0, and
   no check would see its attention): (a) K4, K5a and K5b held to their
   plain versions and timed at every flash shape of this phase's paths
   (unmasked cross and encoder layers with Sq ≠ Sk and ragged key tiles,
   and the decoders' self-attention); (b) ``whisper-base`` whole (6
   encoder layers, 6 decoder layers of self + cross attention over 1500
   frames) serves 4 rows x 512 tokens, 32 new, through the engine's
   static-batch path (K4 18 a prefill) with phase 4's decode check, the
   cross layers' own decode outputs held to their prefill rows and a
   planted zeroed cross V it must catch in bf16 and fp32, trains 3 steps on phase 7's tokens with
   4 x 1500 frames a microbatch (K4, K5a, K5b counted a step), and its
   fp32 grad check covers the encoder and the gates; (c)
   ``llama-3.2-vision-90b`` serves at 5 layers (4 self + 1 cross over
   1601 image tokens) the same way, trains its 2-layer cut (a self and
   the cross layer) on 2 x 2048 under full remat, peak memory logged,
   and that cut's fp32 grad check runs at 1 x 512 tokens; (d) the
   Linear-X recipe: vision ``linearize=4`` at 5 layers serves (K1, K3,
   K4; the planted fault too), whisper ``linearize=0`` serves (the same)
   and trains (K1, K2a, K2b, K3 in
   the decoder, K4, K5a, K5b in the encoder and cross layers);
16. runtime, the runtime subsystems on the full-width train path
   (``CONFIG``, full depth, phase 7's ``RunConfig``, data and lr, 5 steps
   through ``train()`` a run): (a) the guard: a run with NaN gradients
   at step 2 (it must skip step 2 only; the per-leaf fingerprint of the
   params and moments, taken on the card, must not move across it), a
   forced skip at step 2 (the same losses, rtol 1e-6), steps 0–1 equal
   to phase 7's, ``GuardAbort`` at step 2 with two consecutive NaN
   steps, then the clean guarded run, its step p50 beside phase 7's; K1,
   K2a, K2b 32 a step each on ``sm90``; (b) that run's JSONL: compile,
   step × 5, summary, each step's MFU = model FLOPs / (wall × 989e12)
   within 1%; (e) the serve CLI (``--ckpt-dir``, ``--metrics-out``) on a
   checkpoint of that run's final params (the subtree the CLI restores,
   5.3 GB): the restored step printed, its greedy tokens equal to an
   engine's on the params in memory, K1 and K3 on ``sm90``, request
   records and a summary in the JSONL; on the 2-layer cut (full width,
   0.63 B params, 7.5 GB a checkpoint): (c) 4 steps with a checkpoint
   every 2 (the loop's ``save_async``: each one's host copy and disk
   write timed), that run's final state overwritten with NaN (0 for
   integer leaves) and restored with verification from its newest
   checkpoint: the restored fingerprint equal, the disk's free bytes,
   the bytes on disk and each wall and GB/s printed; (d) that checkpoint
   corrupted, a resume to step 6 (its final save synchronous, timed):
   the fallback event names steps 4 and 2, the recomputed losses equal
   an uninterrupted 6-step run's (rtol 1e-6); (f), in
   phase 10's spawn of two gloo ranks, the 2-layer cut at (1, 2) without
   and with the guard: the same losses bit for bit, the same tape counts,
   ``train.grads`` 4 bytes larger, no drift between the tape and the
   issued collectives; the guarded run's checkpoint resumed by the
   one-device loop, its next loss within phase 10's layout limit.
17. usp, the 3D DP×SP×TP layout on four ranks sharing the card over gloo,
   as 10 (b): (a) the ``HYBRID`` cut of 10 (b) (3 linear + 1 softmax
   layer, full width) at (dp, sp, tp) = (1, 2, 2) under "ulysses", ZeRO-1
   over the model pair, 3 steps on b1's params and packed rows: losses
   within 2e-4 and grad norms within 2^-8 of b1's (1, 2) allgather run;
   per step the 3D tape budget (the state gathers over the 4 token
   ranks, Ulysses' 4 all-to-alls over tp, its K/V gathers over sp, one
   gradient all-reduce, one ZeRO-1 param gather) with no drift between
   the tape and the collectives issued, K1, K2a, K2b 3 and K4, K5a, K5b
   1 a step on ``sm90``; step walls, peak memory, the ZeRO-1 group size
   per rank; (b) ``ulysses_context_attention`` at (1, 2, 2) on
   starcoder2-15b's softmax heads (48:4 x 128, bf16, causal, B 1, S
   4096: the GQA packing) and (c) ``windowed_context_attention`` at W 4
   on ``HYBRID``'s (16 x 128, window 2048, B 1, S 16384) in both halo
   modes; o, dq, dk, dv of (b) and (c) against ``flash_attention_op``
   on one device over the whole sequence, each rank its chunk, within
   the flash bf16 limit plus the ``sm90`` rounding bound (from the plain
   versions, in query blocks).
18. serve_sp, serving under a plan on four ranks sharing the card over
   gloo, every rank running ``ServeEngine(plan=)`` on the same requests
   with weights from one seed: (a) the prefill plan of the (4, 1)
   (data, model) layout serving ``CONFIG`` and ``HYBRID`` at full width
   and depth (prompts 4096, 1024 and 1023 split 4 ways where 4 divides
   them, ``CONFIG`` bucketing 1023 to 1024 with left padding; 32 greedy
   tokens; the hybrid's window rings sliced 4 ways and merged at
   decode); (b) the decode plan of the (1, 4) layout serving
   granite-34b's 2-layer cut (prompts 1024 and 300 prefilled whole, its
   rings sliced over the model group). Every rank's tape equals
   ``comm.budget``'s serving budgets; K1, K3, K4 launches per path, all
   ``sm90``; rank 0's sampled logits within ``TOL_LOGITS`` of the
   one-device engine forced onto the same tokens; walls and peaks per
   rank;
19. analysis, the port's checks on the card: (a) the PAL301 guard-band
   battery (``analysis.kernel_check``) over every route of all seven
   kernels, zero findings; (b) the step sanitizer (SAN201, SAN202,
   SAN204, SAN205) on ``CONFIG``'s one-device train step at phase 7's
   shape after a warm-up step and on the decode step of 4 slots, both
   under ``torch.cuda.set_sync_debug_mode("error")``, zero findings;
   SAN203 and SAN205 over the tapes phases 17 and 18 recorded in their
   rank runs (every step's collectives alike on a rank, every rank's
   alike); (c) ``remat="dots"`` against ``none`` and ``full``: 3 steps
   each from the same state, each step's loss and grad norm within
   ``TOL_REMAT`` (1e-5) of ``none``'s, step p50 and peak
   memory of each, K1, K2a, K2b on ``sm90``; (d) the roofline
   (``launch.roofline``, counted on the meta device) of phase 7's train
   step and phase 5's decode step beside their measured walls. Every
   phase's wall is printed (``phase_walls_s``).

The line before the last is the kernel table as JSON, 14 entries (K1,
K2a, K2b, K3, K4, K5a and K5b once per route; ``launches`` summed over
the paths that ran each, listed in ``launches_by_path``, phases 10's
and 11's per cell and rank, phase 12's to 14's per path; phase 13's
timings at the SSM shapes under ``ssm_cases``, phase 14's at the zoo's
head layouts under ``zoo_cases``, phase 15's at the cross shapes under
``cross_cases``); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' least times against the H100 SXM's data-sheet peaks (the
# kernel table's bounds and the roofline's kernel counts are one formula
# each, in repro_torch.obs.flops)
from repro_torch.obs.flops import bwd_bounds as _bwd_bounds  # noqa: E402
from repro_torch.obs.flops import chunk_bound as _chunk_bound  # noqa: E402
from repro_torch.obs.flops import decode_bound as _decode_bound  # noqa: E402
from repro_torch.obs.flops import flash_bounds as _flash_bounds  # noqa: E402
from repro_torch.obs.metrics import to_host  # noqa: E402

# Tolerances. o: the reference's kernel tests (tests/test_kernels.py:14).
# State and log decay: both sides accumulate in fp32 over up to 512 rows in
# another order (chunks of 64 against blocks of 128), which moves the sums
# by ~1e-6 relative; 1e-4 leaves two orders of margin.
TOL_O = {"bfloat16": 4e-2, "float32": 3e-4}
# Gradients: the reference's GRAD_TOL in fp32 (tests/test_kernels.py:15)
# and its bf16 kernel tolerance for bf16 outputs. dlog_a (fp32 on both
# sides) is a suffix sum of up to S terms of the size of the largest
# entries, so it also gets S·2^-24·max|dlog_a| of absolute slack: the fp32
# rounding of such a sum taken in another order.
TOL_GRAD = {"bfloat16": 4e-2, "float32": 1e-3}
TOL_STATE = 1e-4
TOL_LD = 1e-5
# Decode logits against a fresh prefill (``phase_decode_check``, each entry
# within tol + tol·|want|). In bf16: bf16 keeps an 8-bit mantissa (relative
# step 2^-8), and the chunked and recurrent forms round o, the residual
# stream and every projection at different points, through 16 layers
# (``TOL_LOGITS``) or the SSM family's 32 and 64 (``TOL_LOGITS_DEEP``, set
# from its readings 0.1709–0.2422, PERF.md §6); MoE stacks take
# ``TOL_LOGITS_DEEP`` at any depth: at 2 layers, with the prefill on the
# decode's routes, phi3.5-moe's decode gap read 0.1216 (bf16 moves its
# prefill logits by 0.1467); a planted wrong expert read reads 2.6 and
# 7.4 on the two MoE models but 0.08 on Linear-MoE, which only the
# fp32-caches limit sees (PERF.md §6). The vision model (d 8192,
# logits up to 9.1 at random init) takes ``TOL_LOGITS_DEEP`` at 5 layers:
# its bf16 decode gap read 0.125 where bf16 moves its prefill logits by
# 0.1242, while the fp32-caches gap read 4.9e-5; a zeroed cross V read
# 0.125 in bf16 too (1.31e-2 with fp32 caches): the logits barely see an
# image cross layer, which the decode check holds layer by layer
# instead (PERF.md §6). With
# the params in fp32 the
# decode caches' bf16 K/V and conv inputs are the only bf16 roundings
# (``TOL_LOGITS_FP32``, readings 0.0401–0.0671); with those caches in fp32
# too, only fp32 roundings are left (``TOL_LOGITS_EXACT``).
TOL_LOGITS = 1e-1
TOL_LOGITS_DEEP = 2.5e-1
TOL_LOGITS_FP32 = 1e-1
TOL_LOGITS_EXACT = 1e-3


def log(phase: str, **facts) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in facts.items()),
          flush=True)


def check(ok, message: str) -> None:
    """Fail the run (an explicit raise, kept under ``python -O``)."""
    if not ok:
        raise AssertionError(message)


def max_err_within(got, want, tol):
    """(max |got - want|, whether |got - want| <= tol + tol·|want|)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool((diff <= tol + tol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return float(diff.max()), ok


def limit_share(got, want, tol):
    """The largest |got - want| / (tol + tol·|want|): the share of
    ``max_err_within``'s limit that the worst entry takes (at most 1)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def max_err_bf16(got, want, extra=None):
    """(max |got - want|, whether |got - want| <= 2^-7·|want| +
    2^-8·rms(want) [+ extra]) for bf16 results that both sides accumulate
    in fp32 and round once: the two roundings of nearly equal fp32 values
    differ by at most one bf16 step (2^-7 relative), and 2^-8 of the
    tensor's rms covers entries near zero whose fp32 sums cancel in
    another order. The limit scales with the data, so a result off by a
    factor or by one tile of the band fails. ``extra`` is the flash
    ``sm90`` route's rounding of P and dS to bf16 inside its products,
    2^-8 times those products over absolute values
    (``sm90_rounding_bound``)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -8 * rms
    if extra is not None:
        limit = limit + extra
    ok = bool((diff <= limit).all()) and bool(torch.isfinite(got).all())
    return float(diff.max()), ok


BF16_LIMIT = "2^-7|want|+2^-8rms(want)"
SM90_LIMIT = BF16_LIMIT + "+2^-8A"


def time_ms(fn, arg_sets, iters):
    """Mean ms per call over ``iters`` calls after warm-up, timed with CUDA
    events. Calls rotate over ``arg_sets``, sized together above the 50 MB
    L2 cache, so each call finds its inputs in device memory as the
    serving path does."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, iters):
    """Device ms per call over ``iters`` calls after warm-up: the kernel
    rows that torch.profiler records on the card, summed, per call. Unlike
    ``time_ms`` it leaves out the host time of the wrapper, which
    back-to-back launches of a short kernel wait on."""
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / iters / 1e3


# ---------------------------------------------------------------------------
# Phase 1-2: facts and build.
# ---------------------------------------------------------------------------

def phase_facts() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    log("facts", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc[-1]), triton=triton_v,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_kernels()
    wall = time.perf_counter() - t0
    for stem, info in built.items():
        res = [ln.split("info    :")[-1].strip()
               for ln in info["ptxas"].splitlines()
               if "registers" in ln or "spill" in ln]
        log("build", kernel=stem, nvcc_s=f"{info['seconds']:.2f}",
            ptxas=repr("; ".join(res)))
    log("build", wall_s=f"{wall:.2f}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _ssd_log_a(gen, bh, s, nh):
    """SSD's log a at init, per row of BH = B·nh: −exp(a_log)·dt with
    a_log = log(h) for head h = 1..nh and dt = softplus(dt_bias + x·wdt),
    dt_bias the softplus⁻¹ of a step drawn log-uniform in [1e-3, 0.1]
    (``mamba2_init``), x·wdt ~ N(0, 0.1²) a token; down to about −8 a
    token on mamba2's head 80."""
    head = (torch.arange(bh, device="cuda") % nh + 1).float()[:, None]
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand(bh, 1, generator=gen,
                                                device="cuda"))
    dt = torch.nn.functional.softplus(
        torch.log(torch.expm1(dt0))
        + 0.1 * torch.randn(bh, s, generator=gen, device="cuda"))
    return -head * dt


def _chunk_inputs(gen, bh, s, d, dtype, la_kind, dv=None, nh=None):
    """q, k (BH, S, d), v (BH, S, dv, default d) and log a of ``la_kind``
    ("ssd": ``_ssd_log_a`` over ``nh`` heads, a reset mid-chunk)."""
    from repro_torch.core.linear_attention import RESET_LOG_A
    dev = "cuda"
    dv = dv or d
    q = (torch.randn(bh, s, d, generator=gen, device=dev) * 0.3).to(dtype)
    k = (torch.randn(bh, s, d, generator=gen, device=dev) * 0.3).to(dtype)
    v = (torch.randn(bh, s, dv, generator=gen, device=dev) * 0.5).to(dtype)
    la = torch.zeros(bh, s, device=dev)
    if la_kind == "reset":       # a reset mid-chunk, as left-padded prefill
        la[:, s // 2 - 7] = RESET_LOG_A
        la[:, 5] = RESET_LOG_A
    elif la_kind == "decay":
        la = -torch.randn(bh, s, generator=gen, device=dev).abs() * 0.03
    elif la_kind == "gla":       # GLA's gate at init, a reset mid-chunk
        la = torch.nn.functional.logsigmoid(
            torch.randn(bh, s, generator=gen, device=dev) * 0.5)
        la[:, s // 2 - 7] = RESET_LOG_A
    elif la_kind == "ssd":       # SSD's decay at init, a reset mid-chunk
        la = _ssd_log_a(gen, bh, s, nh)
        la[:, s // 2 - 7] = RESET_LOG_A
    return q, k, v, la


def phase_kernels() -> list:
    from repro_torch.core.linear_attention import pick_block
    from repro_torch.kernels import lasp2_chunk as lc
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_fwd,
                                                 lasp2_chunk_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, d = 64, 128               # 4 rows × 16 heads of 128
    failures = []
    k1_err = dict.fromkeys(lc.ROUTES, 0.0)
    # S 512 and 37 on both routes, the train path's S 2048 on sm90, where
    # the carried state sums the most rows, and a rank's chunk under SP at
    # W = 2 (phase 10 b1/b2: S 1024)
    cases = [(dt, s, lk) for dt in (torch.bfloat16, torch.float32)
             for s, lk in ((512, "zero"), (512, "reset"), (512, "decay"),
                           (512, "gla"), (37, "reset"))] \
        + [(torch.bfloat16, 2048, lk)
           for lk in ("zero", "reset", "decay", "gla")] \
        + [(torch.bfloat16, 1024, "reset")]
    for dtype, s, la_kind in cases:
        q, k, v, la = _chunk_inputs(gen, bh, s, d, dtype, la_kind)
        route = lc._route(dtype, d, d)
        before = lasp2_chunk_fwd.route_launches[route]
        o, st, ld = lasp2_chunk_fwd(q, k, v, la)
        torch.cuda.synchronize()
        o_p, st_p, ld_p = lasp2_chunk_fwd_plain(
            q, k, v, la, block_size=pick_block(s, 128))
        name = str(dtype).split(".")[-1]
        e_o, ok_o = max_err_within(o, o_p, TOL_O[name])
        e_s, ok_s = max_err_within(st, st_p, TOL_STATE)
        e_l, ok_l = max_err_within(ld, ld_p, TOL_LD)
        ok = ok_o and ok_s and ok_l and o.dtype == dtype \
            and lasp2_chunk_fwd.route_launches[route] - before == 1
        k1_err[route] = max(k1_err[route], e_o, e_s, e_l)
        log("kernels", kernel="lasp2_chunk_fwd", dtype=name, S=s,
            log_a=la_kind, route=route, err_o=f"{e_o:.3e}",
            tol_o=TOL_O[name], err_state=f"{e_s:.3e}", tol_state=TOL_STATE,
            err_log_decay=f"{e_l:.3e}",
            share_of_limit_o=f"{limit_share(o, o_p, TOL_O[name]):.3f}",
            share_of_limit_state=f"{limit_share(st, st_p, TOL_STATE):.3f}",
            ok=ok)
        if not ok:
            failures.append(f"lasp2_chunk_fwd {name} S={s} {la_kind}")

    # Times at the serving path's shape: K1 at BH 64, S 512 (4 prompts of
    # the 512 bucket; bf16 on sm90, fp32 on simt).
    k1 = {}   # route -> (ms, device ms, plain ms, bound ms, bound by)
    for dtype in (torch.bfloat16, torch.float32):
        sets = [_chunk_inputs(gen, bh, 512, d, dtype, "reset")
                for _ in range(2)]
        k1[lc._route(dtype, d, d)] = (
            time_ms(lambda *a: lasp2_chunk_fwd(*a), sets, 50),
            device_ms(lambda *a: lasp2_chunk_fwd(*a), sets, 20),
            time_ms(lambda *a: lasp2_chunk_fwd_plain(*a), sets, 10),
            *_chunk_bound(bh, 512, d, d, dtype))
    shapes = {"sm90": "BH64xS512x128 bf16", "simt": "BH64xS512x128 float32"}
    for route, (ms, dev, plain, bound, by) in k1.items():
        log("kernels", kernel=f"lasp2_chunk_fwd_{route}",
            shape=repr(shapes[route]), ms=f"{ms:.4f}", device_ms=f"{dev:.4f}",
            plain_ms=f"{plain:.4f}", bound_ms=f"{bound:.4f}", bound_by=by)
    check(not failures, "kernel parity failed: " + ", ".join(failures))
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"sm90": "lasp2_chunk_fwd_sm90.cu", "simt": "lasp2_chunk_fwd.cu"}
    return [
        {"name": f"lasp2_chunk_fwd_{route}", "route": "cuda",
         "source": csrc + sources[route],
         "replaces": "src/repro/kernels/lasp2_chunk.py:111",
         "launches": None, "max_abs_err": k1_err[route], "ms": ms,
         "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
         "bound_by": by, "library_ms": None, "timed_at": shapes[route]}
        for route, (ms, dev, plain, bound, by) in k1.items()]


def host_us(fn, arg_sets, n=1000):
    """Host us per call over ``n`` back-to-back calls after warm-up: the
    wall until the last call has returned, before the device is waited
    on. When the device keeps up (a short kernel), that is what the
    wrapper costs the host."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / n * 1e6


K3_SM90_KERNEL = "lasp2_decode_sm90_kernel"   # its name in profiler rows


def phase_decode() -> list:
    """K3, the decode step, on both routes against ``recurrent_step``: 8
    steps chained from a K1 prefill state at the serving shape (BH 64 = 4
    slots x 16 heads, 128 x 128, bf16 q/k/v, resets in the prompt and at
    step 3 for half the rows), each route forced by ``route=``; ``sm90``
    also at (dk, dv) = (128, 64) and (16, 64) and with ``log_a=None``, and
    bitwise equal on two launches. Times each route at the serving
    shape, in turns (simt, sm90, sm90, simt): CUDA events over
    400 launches, profiler device time over 100, and the wrapper's host us
    over 1,000, rotating 16 states above the 50 MB L2; beside them the
    device time of an in-place ``mul_`` over the same states (the copy
    floor)."""
    from repro_torch.core.linear_attention import RESET_LOG_A
    from repro_torch.kernels import lasp2_decode as ldm
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    step, plain = ldm.lasp2_decode_step, ldm.lasp2_decode_step_plain
    gen = torch.Generator(device="cuda").manual_seed(3)
    bh, d, bf16 = 64, 128, torch.bfloat16
    failures = []

    def draw(dk, dv, n, reset_at=None, gla=False):
        out = []
        for i in range(n):
            qs, ks = ((torch.randn(bh, dk, generator=gen, device="cuda")
                       * 0.3).to(bf16) for _ in range(2))
            vs = (torch.randn(bh, dv, generator=gen, device="cuda")
                  * 0.5).to(bf16)
            las = -torch.rand(bh, generator=gen, device="cuda") * 0.05
            if gla:              # GLA's gate at init, as _chunk_inputs
                las = torch.nn.functional.logsigmoid(torch.randn(
                    bh, generator=gen, device="cuda") * 0.5)
            if i == reset_at:
                las[: bh // 2] = RESET_LOG_A
            out.append((qs, ks, vs, las))
        return out

    def chained(steps, st0, ld0, route, no_log_a=False):
        """Errors of o (worst step), state and log decay after the steps,
        and whether all are within their limits with one launch a step,
        all on ``route``."""
        st_k, ld_k = st0.clone(), ld0.clone()
        st_p, ld_p = st0.clone(), ld0.clone()
        before = dict(step.route_launches)
        e_o, ok_o = 0.0, True
        for qs, ks, vs, las in steps:
            la = None if no_log_a else las
            o_k, st_k, ld_k = step(qs, ks, vs, la, st_k, ld_k, route=route)
            o_p, st_p, ld_p = plain(qs, ks, vs, la, st_p, ld_p)
            e, ok = max_err_within(o_k, o_p, TOL_O["float32"])
            e_o, ok_o = max(e_o, e), ok_o and ok
        torch.cuda.synchronize()
        e_s, ok_s = max_err_within(st_k, st_p, TOL_STATE)
        e_l, ok_l = max_err_within(ld_k, ld_p, TOL_LD)
        launched = {r: step.route_launches[r] - before[r] for r in before}
        want = {r: len(steps) * (r == route) for r in before}
        return (e_o, e_s, e_l), ok_o and ok_s and ok_l and launched == want

    q, k, v, la = _chunk_inputs(gen, bh, 512, d, bf16, "reset")
    _, st0, ld0 = lasp2_chunk_fwd(q, k, v, la)
    steps = draw(d, d, 8, reset_at=3)
    cases = [(route, d, d, "decay+reset", steps, st0, ld0)
             for route in ldm.ROUTES]
    # GLA's learned log a, from a GLA prefill state
    q, k, v, la = _chunk_inputs(gen, bh, 512, d, bf16, "gla")
    _, st_g, ld_g = lasp2_chunk_fwd(q, k, v, la)
    steps_g = draw(d, d, 8, reset_at=3, gla=True)
    cases += [(route, d, d, "gla+reset", steps_g, st_g, ld_g)
              for route in ldm.ROUTES]
    for dk, dv, no_la in ((128, 64, False), (16, 64, False), (d, d, True)):
        cases.append(("sm90", dk, dv, "None" if no_la else "decay+reset",
                      draw(dk, dv, 8, reset_at=None if no_la else 3),
                      torch.randn(bh, dk, dv, generator=gen, device="cuda"),
                      -torch.rand(bh, generator=gen, device="cuda")))
    err = dict.fromkeys(ldm.ROUTES, 0.0)
    for route, dk, dv, la_kind, case_steps, st, ldd in cases:
        no_la = la_kind == "None"
        (e_o, e_s, e_l), ok = chained(case_steps, st, ldd, route, no_la)
        ok = ok and (route == "simt" or ldm._route(bf16, dk, dv) == "sm90")
        err[route] = max(err[route], e_o, e_s, e_l)
        log("kernels", kernel=f"lasp2_decode_step_{route}", steps=8, BH=bh,
            dk=dk, dv=dv, log_a=la_kind,
            err_o=f"{e_o:.3e}", tol_o=TOL_O["float32"],
            err_state=f"{e_s:.3e}", tol_state=TOL_STATE,
            err_log_decay=f"{e_l:.3e}", tol_log_decay=TOL_LD, ok=ok)
        if not ok:
            failures.append(f"lasp2_decode_step_{route} {dk}x{dv} "
                            f"{la_kind}")
    # Fixed-order sums, no atomics: two launches agree bit for bit.
    outs = []
    for _ in range(2):
        st, ldd = st0.clone(), ld0.clone()
        o, _, _ = step(*steps[0], st, ldd, route="sm90")
        outs.append((o, st, ldd))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(*outs))
    log("kernels", kernel="lasp2_decode_step_sm90",
        check="two launches bitwise equal", shape=repr("BH64x128x128 bf16"),
        ok=same)
    if not same:
        failures.append("lasp2_decode_step_sm90 not bitwise repeatable")
    del outs, cases

    # 16 states of 4.2 MB: 67 MB rotate above the 50 MB L2, as a layer's
    # state finds itself after a step's 2.7 GB of weights
    dec_sets = []
    for _ in range(16):
        qs, ks, vs = (torch.randn(bh, d, generator=gen, device="cuda")
                      .to(bf16) for _ in range(3))
        dec_sets.append((qs, ks, vs, torch.zeros(bh, device="cuda"),
                         st0.clone(), ld0.clone()))
    order = ["simt", "sm90"]
    readings = {r: [] for r in order}
    for route in order + order[::-1]:
        fn = lambda *a, route=route: step(*a, route=route)
        readings[route].append((time_ms(fn, dec_sets, 400),
                                device_ms(fn, dec_sets, 100),
                                host_us(fn, dec_sets)))
    plain_ms = time_ms(lambda *a: plain(*a), dec_sets, 100)
    # The same state bytes read and written by one of PyTorch's own
    # elementwise kernels (in place, x 1.0): what moving them costs on this
    # card in practice, beside the bound's data-sheet rate.
    floor_ms = device_ms(lambda *a: a[4].mul_(1.0), dec_sets, 100)
    bound, by = _decode_bound(bh, d, d, 2)
    shape = "BH64x128x128 bf16"
    timed = {}
    for route, rs in readings.items():
        timed[route] = tuple(float(np.mean(x)) for x in zip(*rs))
        ms, dev, hus = timed[route]
        log("kernels", kernel=f"lasp2_decode_step_{route}", shape=repr(shape),
            ms=f"{ms:.4f}", device_ms=f"{dev:.5f}",
            device_ms_readings=repr([f"{r[1]:.5f}" for r in rs]),
            host_us=f"{hus:.2f}",
            host_us_readings=repr([f"{r[2]:.2f}" for r in rs]),
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}", bound_by=by,
            copy_floor_device_ms=f"{floor_ms:.5f}")
    check(not failures, "kernel parity failed: " + ", ".join(failures))
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"sm90": "lasp2_decode_sm90.cu", "simt": "lasp2_decode.cu"}
    return [{"name": f"lasp2_decode_step_{route}", "route": "cuda",
             "source": csrc + sources[route],
             "replaces": "src/repro/kernels/lasp2_decode.py:49",
             "launches": 0, "max_abs_err": err[route], "ms": ms,
             "device_ms": dev, "host_us": hus, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "copy_floor_device_ms": floor_ms, "timed_at": shape}
            for route, (ms, dev, hus) in timed.items()]


def _bwd_inputs(gen, bh, s, d, dtype, la_kind, cot="full", dv=None,
                nh=None):
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    dv = dv or d
    q, k, v, la = _chunk_inputs(gen, bh, s, d, dtype, la_kind, dv, nh)
    o, _, _ = lasp2_chunk_fwd(q, k, v, la)
    do = torch.randn(bh, s, dv, generator=gen, device="cuda").to(dtype)
    if cot == "state":            # only the end-of-chunk state is pulled on
        do.zero_()
    dst = torch.randn(bh, d, dv, generator=gen, device="cuda")
    return q, k, v, la, o, do, dst


def phase_bwd_kernels(kernels: list) -> list:
    """K2a and K2b (``lasp2_chunk_bwd``) against the plain passes at the
    training path's shape, BH 64 (4 rows x 16 heads) x S 2048 x 128, at S
    37, and in bf16 at a rank's chunk under SP at W = 2 (S 1024; every
    case but "state" pulls on both o and a random nonzero end-state
    cotangent, as ``dm_loc`` does under SP), each on the route its inputs
    take (bf16: ``sm90``, the tensor
    cores; fp32: ``simt``), all held to the same limits against the fp32
    plain versions. Times at that shape, each route: K1, K2a and K2b on
    ``sm90`` in bf16 and on ``simt`` in fp32 (K1's join its entries as
    their train-shape times); K1, K2a and K2b on ``sm90`` bitwise equal on
    two launches."""
    from repro_torch.core.linear_attention import pick_block
    from repro_torch.kernels import lasp2_chunk as lc
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd,
                                                 lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dkv_plain,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_bwd_dq_plain,
                                                 lasp2_chunk_bwd_plain,
                                                 lasp2_chunk_fwd,
                                                 lasp2_chunk_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bh, d, s_train, s_sp = 64, 128, 2048, 1024
    failures = []
    err_a = dict.fromkeys(lc.ROUTES, 0.0)
    err_b = dict.fromkeys(lc.ROUTES, 0.0)
    passes = (lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    cases = [(dt, s, lk, cot) for dt in (torch.bfloat16, torch.float32)
             for s, lk, cot in ((s_train, "zero", "full"),
                                (s_train, "reset", "full"),
                                (s_train, "decay", "full"),
                                (s_train, "gla", "full"),
                                (s_train, "reset", "state"),
                                (37, "reset", "full"))] \
        + [(torch.bfloat16, s_sp, "reset", "full")]
    for dtype, s, la_kind, cot in cases:
        ins = _bwd_inputs(gen, bh, s, d, dtype, la_kind, cot)
        route = lc._route(dtype, d, d)
        before = [fn.route_launches[route] for fn in passes]
        got = lasp2_chunk_bwd(*ins)
        torch.cuda.synchronize()
        want = lasp2_chunk_bwd_plain(*ins, block_size=pick_block(s, 128))
        name = str(dtype).split(".")[-1]
        errs = {}
        ok = [fn.route_launches[route] - n
              for fn, n in zip(passes, before)] == [1, 1]
        for key, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[key], good = max_err_within(g, w, TOL_GRAD[name])
            ok = ok and good and g.dtype == dtype
        slack = s * 2.0 ** -24 * float(want[3].abs().max())
        diff = (got[3] - want[3]).abs()
        errs["dla"] = float(diff.max())
        ok = ok and bool((diff <= 1e-3 + slack + 1e-3 * want[3].abs())
                         .all()) and bool(torch.isfinite(got[3]).all())
        if cot == "state":
            ok = ok and float(got[0].abs().max()) == 0.0
        err_a[route] = max(err_a[route], errs["dq"])
        err_b[route] = max(err_b[route], errs["dk"], errs["dv"], errs["dla"])
        log("kernels", kernel="lasp2_chunk_bwd", dtype=name, S=s,
            log_a=la_kind, cotangent=cot, route=route,
            **{f"err_{k}": f"{v:.3e}" for k, v in errs.items()},
            tol=TOL_GRAD[name], tol_dla="1e-3+S2^-24max|want|+1e-3|want|",
            dla_slack=f"{slack:.2e}", ok=ok)
        if not ok:
            failures.append(f"lasp2_chunk_bwd {name} S={s} {la_kind} {cot}")
        del ins, got, want

    # Times at the training path's shape with resets, bf16 (sm90) then fp32
    # (simt): two input sets of 5 x 33.5 MB each (bf16) rotate above the
    # 50 MB L2. K1's entries take these as their train-shape times.
    fwd = lambda q, k, v, la, *_: lasp2_chunk_fwd(q, k, v, la)
    fwd_p = lambda q, k, v, la, *_: lasp2_chunk_fwd_plain(q, k, v, la)
    dq = lambda q, k, v, la, o, do, dst: lasp2_chunk_bwd_dq(k, v, la, do)
    dq_p = lambda q, k, v, la, o, do, dst: lasp2_chunk_bwd_dq_plain(
        k, v, la, do)
    dkv = lambda *a: lasp2_chunk_bwd_dkv(*a)
    timed = {}   # entry name -> (ms, device ms, plain ms, bound ms, by)
    for dtype in (torch.bfloat16, torch.float32):
        route = lc._route(dtype, d, d)
        sets = [_bwd_inputs(gen, bh, s_train, d, dtype, "reset")
                for _ in range(2)]
        k1_bound = _chunk_bound(bh, s_train, d, d, dtype)
        a_bound, b_bound = _bwd_bounds(bh, s_train, d, d, dtype)
        n = 20 if route == "sm90" else 5
        for kname, fn, fn_p, bound in (
                ("lasp2_chunk_fwd", fwd, fwd_p, k1_bound),
                ("lasp2_chunk_bwd_dq", dq, dq_p, a_bound),
                ("lasp2_chunk_bwd_dkv", dkv, lasp2_chunk_bwd_dkv_plain,
                 b_bound)):
            timed[f"{kname}_{route}"] = (
                time_ms(fn, sets, n), device_ms(fn, sets, n),
                time_ms(fn_p, sets, 4), *bound)
        if route == "sm90":
            # K1, K2a and K2b sum in a fixed order with no atomics: two
            # launches agree bit for bit.
            for kname, fn in (("lasp2_chunk_fwd_sm90", fwd),
                              ("lasp2_chunk_bwd_dq_sm90", dq),
                              ("lasp2_chunk_bwd_dkv_sm90", dkv)):
                first, second = ((r,) if torch.is_tensor(r) else r
                                 for r in (fn(*sets[0]), fn(*sets[0])))
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(first, second))
                log("kernels", kernel=kname,
                    check="two launches bitwise equal",
                    shape=repr(f"BH{bh}xS{s_train}x{d} bf16"), ok=same)
                if not same:
                    failures.append(f"{kname} not bitwise repeatable")
                del first, second
        del sets
        torch.cuda.empty_cache()
    shapes = {kname: f"BH{bh}xS{s_train}x{d} "
              + ("float32" if kname.endswith("simt") else "bf16")
              for kname in timed}
    for kname, (ms, dev, plain, bound, by) in timed.items():
        log("kernels", kernel=kname, shape=repr(shapes[kname]),
            ms=f"{ms:.4f}", device_ms=f"{dev:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bound:.4f}", bound_by=by)
    check(not failures, "kernel parity failed: " + ", ".join(failures))
    for entry in kernels:
        if entry["name"].startswith("lasp2_chunk_fwd_"):
            ms, dev, plain, bound, _ = timed[entry["name"]]
            entry.update(train_shape=shapes[entry["name"]],
                         train_shape_ms=ms, train_shape_device_ms=dev,
                         train_shape_plain_ms=plain,
                         train_shape_bound_ms=bound)
    csrc = "src/repro_torch/kernels/csrc/"
    where = {"lasp2_chunk_bwd_dq_sm90": ("lasp2_chunk_bwd_dq_sm90.cu", 170,
                                         err_a["sm90"]),
             "lasp2_chunk_bwd_dq_simt": ("lasp2_chunk_bwd.cu", 170,
                                         err_a["simt"]),
             "lasp2_chunk_bwd_dkv_sm90": ("lasp2_chunk_bwd_sm90.cu", 207,
                                          err_b["sm90"]),
             "lasp2_chunk_bwd_dkv_simt": ("lasp2_chunk_bwd.cu", 207,
                                          err_b["simt"])}
    return [{"name": kname, "route": "cuda", "source": csrc + src,
             "replaces": f"src/repro/kernels/lasp2_chunk.py:{line}",
             "launches": None, "max_abs_err": err, "ms": ms,
             "device_ms": dev, "plain_ms": plain, "bound_ms": bound,
             "bound_by": by, "library_ms": None, "timed_at": shapes[kname]}
            for kname, (src, line, err) in where.items()
            for ms, dev, plain, bound, by in [timed[kname]]]


# Flash-attention cases against the plain versions: (what, B, Hq, Hkv, Sq,
# Sk, dh, dtype, causal, window, q_offset). The first is the hybrid's train
# shape (4 rows x 16 heads, S 2048, window 2048, bf16), then the same in
# fp32, one prefill row of an odd length, a band trimmed to a 512 window
# (bf16 and fp32), GQA 4:1, an explicit offset and a non-causal window
# (each in bf16 and fp32, or at dh 64 and 128), SMOKE's dh 16, and the
# hybrid's softmax layer under SP at W = 2 (phase 10 b1: rank 1's chunk of
# 1024 queries over both chunks' 2048 gathered keys, q_offset 1024), and
# the bidirectional softmax model's train shape (phase 12: no mask, no
# window, 2048 keys; bf16 and fp32), and hymba's attention heads (phase 13:
# GQA 25:5 at dh 64, S 2048, window 1024 and global; bf16 and fp32), and
# the zoo's new head layouts at dh 128 (phase 14: granite's MQA 48:1,
# starcoder2's 48:4, qwen1.5-110b's 64:8, phi3.5-moe's 32:8) in fp32; in
# bf16 phase 14 holds them at their training shape (``_flash_times``),
# and the cross family's unmasked shapes (Sq ≠ Sk, ragged key tiles) in
# fp32.
#
# Every flash shape of phase 15's paths, held and timed in bf16 there
# (``_flash_times``): (what, B, Hq, Hkv, Sq, Sk, dh, causal). The vision
# model's cross layer at its training shape (2 x 2048 text queries over
# 1601 image tokens: the default offset Sk − Sq is −447), with a 300-token
# prompt, and at the serving prefill (4 x 512) beside that prefill's
# self-attention; Whisper's cross layer (2048 text queries over 1500
# encoder frames, 1500 = 11·128 + 92) at training and serving, its encoder
# (1500 frames attending each other) and its decoder's self-attention at
# both. The vision cut's self-attention in training (64:8, 2048) is
# qwen1.5-110b's layout, held in phase 14.
CROSS_FLASH = [("x_vision", 2, 64, 8, 2048, 1601, 128, False),
               ("x_vision_prompt", 2, 64, 8, 300, 1601, 128, False),
               ("x_vision_prefill", 4, 64, 8, 512, 1601, 128, False),
               ("x_vision_self_prefill", 4, 64, 8, 512, 512, 128, True),
               ("x_whisper", 4, 8, 8, 2048, 1500, 64, False),
               ("x_whisper_prefill", 4, 8, 8, 512, 1500, 64, False),
               ("x_whisper_enc", 4, 8, 8, 1500, 1500, 64, False),
               ("x_whisper_self", 4, 8, 8, 2048, 2048, 64, True),
               ("x_whisper_self_prefill", 4, 8, 8, 512, 512, 64, True)]
# bf16 at dh 64 and 128 runs K4, K5a and K5b on their ``sm90`` route, the
# rest on ``simt``.
FLASH_CASES = [
    ("train", 4, 16, 16, 2048, 2048, 128, torch.bfloat16, True, 2048, None),
    ("train", 4, 16, 16, 2048, 2048, 128, torch.float32, True, 2048, None),
    ("prefill", 1, 16, 16, 300, 300, 128, torch.bfloat16, True, 2048, None),
    ("band512", 2, 16, 16, 2048, 2048, 128, torch.bfloat16, True, 512, None),
    ("band512", 2, 16, 16, 2048, 2048, 128, torch.float32, True, 512, None),
    ("gqa4", 2, 16, 4, 1024, 1024, 128, torch.bfloat16, True, None, None),
    ("gqa4", 2, 16, 4, 1024, 1024, 128, torch.float32, True, None, None),
    ("offset", 2, 8, 8, 256, 2048, 128, torch.bfloat16, True, 512, 1024),
    ("offset", 2, 8, 8, 256, 2048, 128, torch.float32, True, 512, 1024),
    ("noncausal", 1, 8, 2, 200, 333, 64, torch.bfloat16, False, 100, None),
    ("noncausal", 1, 8, 2, 200, 333, 128, torch.bfloat16, False, 100, None),
    ("dh16", 2, 4, 4, 100, 100, 16, torch.float32, True, None, None),
    ("sp", 4, 16, 16, 1024, 2048, 128, torch.bfloat16, True, 2048, 1024),
    ("bidir", 4, 16, 16, 2048, 2048, 128, torch.bfloat16, False, None, None),
    ("bidir", 4, 16, 16, 2048, 2048, 128, torch.float32, False, None, None),
    ("hymba", 4, 25, 5, 2048, 2048, 64, torch.bfloat16, True, 1024, None),
    ("hymba", 4, 25, 5, 2048, 2048, 64, torch.float32, True, 1024, None),
    ("hymba_global", 4, 25, 5, 2048, 2048, 64, torch.bfloat16, True, None,
     None),
    ("hymba_global", 4, 25, 5, 2048, 2048, 64, torch.float32, True, None,
     None),
    ("mqa48", 2, 48, 1, 1024, 1024, 128, torch.float32, True, None, None),
    ("gqa12", 2, 48, 4, 1024, 1024, 128, torch.float32, True, None, None),
    ("gqa8", 1, 64, 8, 1024, 1024, 128, torch.float32, True, None, None),
    ("gqa4x32", 2, 32, 8, 1024, 1024, 128, torch.float32, True, None,
     None),
] + [(what, b, hq, hkv, sq, sk, dh, torch.float32, False, None, None)
     for what, b, hq, hkv, sq, sk, dh, causal in CROSS_FLASH if not causal]
TOL_LSE = 1e-4      # fp32 on both sides, summed in another order
# o, dq, dk and dv: fp32 at TOL_O / TOL_GRAD, bf16 at the data-scaled
# max_err_bf16 limit.


def _flash_inputs(gen, b, hq, hkv, sq, sk, dh, dtype):
    dev = "cuda"
    q = torch.randn(b, hq, sq, dh, generator=gen, device=dev) * 0.4
    k = torch.randn(b, hkv, sk, dh, generator=gen, device=dev) * 0.4
    v = torch.randn(b, hkv, sk, dh, generator=gen, device=dev) * 0.5
    do = torch.randn(b, hq, sq, dh, generator=gen, device=dev)
    return tuple(x.to(dtype) for x in (q, k, v, do))


def _flash_check(q, k, v, do, dh, dtype, kw):
    """K4, K5a and K5b on one input set against their plain versions on
    the route the inputs take: o and lse, then dq, dk and dv from the plain
    forward's lse and delta; fp32 within ``TOL_O`` / ``TOL_GRAD`` and
    ``TOL_LSE``, bf16 within the data-scaled ``max_err_bf16`` (plus
    ``sm90_rounding_bound`` on ``sm90``). Returns (route, max |error| by
    result, the limits, ok)."""
    from repro_torch.kernels import flash_attention as fl
    route = fl._route(dtype, dh)
    o, lse = fl.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = fl.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1)
    name = str(dtype).split(".")[-1]
    bf16 = dtype == torch.bfloat16
    extra = fl.sm90_rounding_bound(q, k, v, do, lse_p, delta, **kw) \
        if route == "sm90" else (None, None, None, None)
    if bf16:
        close_o = close_g = max_err_bf16
    else:
        close_o = lambda g, w, _: max_err_within(g, w, TOL_O[name])
        close_g = lambda g, w, _: max_err_within(g, w, TOL_GRAD[name])
    e_o, ok_o = close_o(o, o_p, extra[0])
    e_l, ok_l = max_err_within(lse, lse_p, TOL_LSE)
    del o_p
    dq = fl.flash_attention_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    dq_p = fl.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)
    e_dq, ok_dq = close_g(dq, dq_p, extra[1])
    del dq_p
    dk_p, dv_p = fl.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p,
                                                  delta, **kw)
    e_dk, ok_dk = close_g(dk, dk_p, extra[2])
    e_dv, ok_dv = close_g(dv, dv_p, extra[3])
    ok = ok_o and ok_l and ok_dq and ok_dk and ok_dv and \
        all(t.dtype == dtype for t in (o, dq, dk, dv))
    tol = (SM90_LIMIT if route == "sm90" else BF16_LIMIT) if bf16 \
        else TOL_O[name]
    errs = {"o": e_o, "lse": e_l, "dq": e_dq, "dk": e_dk, "dv": e_dv}
    return route, errs, {"tol_o": tol, "tol_grads": tol if bf16
                         else TOL_GRAD[name]}, ok


def phase_flash_kernels() -> list:
    """K4, K5a and K5b against their plain versions over ``FLASH_CASES``,
    each on the route its inputs take; then times at the train shape: bf16
    (all three on ``sm90``) and fp32 (on ``simt``), with the SDPA forward
    and backward on the same causal inputs as the library yardstick (timed
    here only), and K5a's and K5b's run-to-run bitwise equality on
    ``sm90``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl
    gen = torch.Generator(device="cuda").manual_seed(2)
    failures = []
    errs = {}

    def worst(name, *values):
        errs[name] = max(errs.get(name, 0.0), *values)

    for what, b, hq, hkv, sq, sk, dh, dtype, causal, window, off in \
            FLASH_CASES:
        q, k, v, do = _flash_inputs(gen, b, hq, hkv, sq, sk, dh, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        route, e, tols, ok = _flash_check(q, k, v, do, dh, dtype, kw)
        worst(f"flash_attention_fwd_{route}", e["o"], e["lse"])
        worst(f"flash_attention_bwd_dq_{route}", e["dq"])
        worst(f"flash_attention_bwd_dkv_{route}", e["dk"], e["dv"])
        name = str(dtype).split(".")[-1]
        log("kernels", kernel="flash_attention", case=what,
            shape=f"B{b}xHq{hq}xHkv{hkv}xSq{sq}xSk{sk}x{dh}", dtype=name,
            route=route, causal=causal, window=window, q_offset=off,
            **{f"err_{t}": f"{x:.3e}" for t, x in e.items()}, **tols, ok=ok)
        if not ok:
            failures.append(f"flash {what} {name} dh{dh}")
        del q, k, v, do
    torch.cuda.empty_cache()

    # Times at the train shape, bf16 then fp32: two input sets (4 x 33.5 MB
    # each in bf16) rotate above the 50 MB L2. The SDPA forward and its
    # backward (dq, dk and dv in one call) on the same causal inputs (window
    # 2048 = S adds nothing) are the library yardstick.
    _, b, hq, hkv, sq, sk, dh, _, causal, window, _ = FLASH_CASES[0]
    kw = dict(causal=causal, window=window)
    mask = fl._mask(sq, sk, sk - sq, sk, causal, window, "cuda")
    pairs = b * hq * int(mask.sum())
    fwd = lambda q, k, v, *_: fl.flash_attention_fwd(q, k, v, **kw)
    fwd_p = lambda q, k, v, *_: fl.flash_attention_fwd_plain(q, k, v, **kw)
    dqk = lambda *a: fl.flash_attention_bwd_dq(*a, **kw)
    dqk_p = lambda *a: fl.flash_attention_bwd_dq_plain(*a, **kw)
    dkv = lambda *a: fl.flash_attention_bwd_dkv(*a, **kw)
    dkv_p = lambda *a: fl.flash_attention_bwd_dkv_plain(*a, **kw)
    sdpa = lambda q, k, v, *_: F.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    timed = {}   # entry name -> (ms, plain ms, (bound, by), library ms, shape)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        route = fl._route(dtype, dh)
        sets = []
        for _ in range(2):
            q, k, v, do = _flash_inputs(gen, b, hq, hkv, sq, sk, dh, dtype)
            o, lse = fl.flash_attention_fwd(q, k, v, **kw)
            sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
        lib_fwd = time_ms(sdpa, sets, 10)
        graphs = []
        for q, k, v, do, *_ in sets:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            graphs.append((sdpa(*leaves), leaves, do))
        lib_bwd = time_ms(lambda o, leaves, do: torch.autograd.grad(
            o, leaves, do, retain_graph=True), graphs, 10)
        del graphs
        bounds = _flash_bounds(b, hq, hkv, sq, sk, dh, dtype, pairs)
        shape = f"B{b}xH{hq}xS{sq}x{dh} {name} causal window {window}"
        timed[f"flash_attention_fwd_{route}"] = (
            time_ms(fwd, sets, 10), time_ms(fwd_p, sets, 2), bounds[0],
            lib_fwd, shape)
        timed[f"flash_attention_bwd_dq_{route}"] = (
            time_ms(dqk, sets, 10), time_ms(dqk_p, sets, 2), bounds[1],
            lib_bwd, shape)
        timed[f"flash_attention_bwd_dkv_{route}"] = (
            time_ms(dkv, sets, 10), time_ms(dkv_p, sets, 2), bounds[2],
            lib_bwd, shape)
        if dtype == torch.bfloat16:
            # K5a owns its dq rows and K5b sums over the GQA group in
            # registers, no atomics: two launches on the same inputs agree
            # bit for bit.
            for kname, fn in ((f"flash_attention_bwd_dq_{route}", dqk),
                              (f"flash_attention_bwd_dkv_{route}", dkv)):
                first, second = ((r,) if torch.is_tensor(r) else r
                                 for r in (fn(*sets[0]), fn(*sets[0])))
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(first, second))
                log("kernels", kernel=kname,
                    check="two launches bitwise equal", shape=repr(shape),
                    ok=same)
                if not same:
                    failures.append(f"{kname} not bitwise repeatable")
                del first, second
        del sets
        torch.cuda.empty_cache()
    for kname, (t, tp, (bound, by), lib, shape) in timed.items():
        log("kernels", kernel=kname, shape=repr(shape), ms=f"{t:.4f}",
            plain_ms=f"{tp:.4f}", bound_ms=f"{bound:.4f}", bound_by=by,
            sdpa_ms=f"{lib:.4f}", pairs=pairs)
    check(not failures, "kernel parity failed: " + ", ".join(failures))
    csrc = "src/repro_torch/kernels/csrc/"
    where = {
        "flash_attention_fwd_sm90": ("flash_attention_fwd_sm90.cu", 246),
        "flash_attention_fwd_simt": ("flash_attention_fwd.cu", 246),
        "flash_attention_bwd_dq_sm90": ("flash_attention_bwd_dq_sm90.cu",
                                        305),
        "flash_attention_bwd_dq_simt": ("flash_attention_bwd.cu", 305),
        "flash_attention_bwd_dkv_sm90": ("flash_attention_bwd_dkv_sm90.cu",
                                         355),
        "flash_attention_bwd_dkv_simt": ("flash_attention_bwd.cu", 355),
    }
    return [{"name": kname, "route": "cuda", "source": csrc + src,
             "replaces": f"src/repro/kernels/flash_attention.py:{line}",
             "launches": None, "max_abs_err": errs[kname], "ms": t,
             "plain_ms": tp, "bound_ms": bound, "bound_by": by,
             "library_ms": lib, "timed_at": shape}
            for kname, (src, line) in where.items()
            for t, tp, (bound, by), lib, shape in [timed[kname]]]


# ---------------------------------------------------------------------------
# Phases 4 and 6: serve full-width linear-llama3-1b and its hybrid.
# ---------------------------------------------------------------------------

def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _mixer_counts(cfg):
    """(layers that run the chunk kernels and K3: linear, mamba2 and hymba;
    layers that run flash attention: softmax, hymba and cross, and the
    encoder's) of ``cfg``."""
    mixers = [spec.mixer for spec in cfg.layer_specs()]
    ssm = mixers.count("mamba2") + mixers.count("hymba")
    enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    return mixers.count("linear") + ssm, mixers.count("softmax") \
        + mixers.count("hymba") + mixers.count("cross") + enc


def _cross(cfg) -> bool:
    return any(spec.mixer == "cross" for spec in cfg.pattern)


def _ssm(cfg) -> bool:
    return any(spec.mixer in ("mamba2", "hymba") for spec in cfg.pattern)


def _chunk_route(cfg) -> str:
    """The route K1, K2a and K2b take on ``cfg``'s chunk layers: (dk, dv) =
    (d_state, headdim) for SSD heads, (head_dim, head_dim) otherwise."""
    from repro_torch.core.device import torch_dtype
    from repro_torch.kernels import lasp2_chunk as lc
    dk = dv = cfg.head_dim
    if _ssm(cfg):
        dk, dv = cfg.mamba.d_state, cfg.mamba.headdim
    return lc._route(torch_dtype(cfg.dtype), dk, dv)


def _log_decays(cache):
    """Every layer's cumulative log decay (nested hymba dicts included)."""
    from repro_torch.core.tree import leaves_with_paths
    return [t.clone() for path, t in leaves_with_paths(cache["layers"])
            if path[-1] == "log_decay"]


def _count(kernels, name, path, n):
    """Add the launches a path made of kernel ``name`` to its entry."""
    entry = next(k for k in kernels if k["name"] == name)
    entry["launches"] = (entry["launches"] or 0) + n
    entry.setdefault("launches_by_path", {})[path] = n


def _zero(*fns) -> None:
    """Set each wrapper's launch counters, total and per route, to 0."""
    for fn in fns:
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0


def _read(fns, routed) -> list:
    """Each wrapper's total launches, then each routed wrapper's per route
    (in ``ROUTES`` order)."""
    from repro_torch.kernels.flash_attention import ROUTES
    return [fn.launches for fn in fns] + \
        [fn.route_launches[r] for fn in routed for r in ROUTES]


def _count_routed(kernels, counters, routed, launched, path) -> None:
    """Add a path's launches (as ``_read`` gives them) to the kernel
    entries: each unrouted wrapper's total, each routed one's per route."""
    from repro_torch.kernels.flash_attention import ROUTES
    names = [c.__name__ for c in counters] + \
        [f"{fn.__name__}_{r}" for fn in routed for r in ROUTES]
    skip = {fn.__name__ for fn in routed}
    for name, n in zip(names, launched):
        if n and name not in skip:
            _count(kernels, name, path, n)


class _Routes:
    """Within the block, wrap ``blocks.moe_route`` (``moe_apply`` looks it
    up at each call, so this sees every MoE layer): record each call's own
    top-k experts in ``idx`` (one (tokens, k) tensor a call, in layer
    order) and its last token's, as a sorted tuple, in ``calls``. With
    ``force`` (one (tokens, k) index tensor a call) each call routes by
    the forced experts instead, its gates its own probabilities at them.
    With ``plant`` each call sends its last token's first choice to the
    next expert under the right gate: a planted wrong expert read, which
    the decode check must see."""

    def __init__(self, force=None, plant=False):
        self.force, self.plant = force, plant

    def __enter__(self):
        from repro_torch.models import blocks as B
        self.blocks, self.route = B, B.moe_route
        self.idx, self.calls = [], []

        def spy(probs, k):
            gate, idx = self.route(probs, k)
            self.idx.append(idx)
            self.calls.append(tuple(sorted(idx[-1].tolist())))
            if self.force is not None:
                idx = self.force[len(self.idx) - 1]
                gate = probs.gather(-1, idx)
            if self.plant:
                idx = idx.clone()
                idx[-1, 0] = (idx[-1, 0] + 1) % probs.shape[-1]
            return gate, idx

        B.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.blocks.moe_route = self.route


class _CrossRows:
    """Within the block, wrap the cross mixer's prefill and decode entries
    in ``blocks._MIXERS`` and record, in layer order, each call's output
    at row 0's last position (a prefill's last query, a decoded token) in
    fp32 in ``rows``: the cross layers' own outputs, which the decode
    check holds layer by layer, however little they move the logits."""

    def __enter__(self):
        from repro_torch.models import blocks as B
        self.blocks, self.mixer = B, B._MIXERS["cross"]
        self.rows = []

        def last(out):
            self.rows.append(out[0][0, -1].float())
            return out

        B._MIXERS["cross"] = self.mixer._replace(
            prefill=lambda *a: last(self.mixer.prefill(*a)),
            decode=lambda *a: last(self.mixer.decode(*a)))
        return self

    def __exit__(self, *exc):
        self.blocks._MIXERS["cross"] = self.mixer


def _rel_rows(got, want) -> float:
    """The worst layer's max |got − want| over max |want|."""
    return max((float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                for g, w in zip(got, want)), default=0.0)


def _decode_logits(params, cfg, prompt, gen_toks, max_len, cache_dtype,
                   plant=False, memory=None):
    """Prefill ``prompt`` (rings ``max_len`` long; with the cross family's
    ``memory``), then 8 decode steps feeding ``gen_toks``, with the K/V
    rings, the memory's K/V and the conv inputs cached in ``cache_dtype``
    (and, with ``plant``, each MoE layer's decoded token sent to a wrong
    expert, each cross layer's cached V zeroed after the prefill): (each
    step's logits over the vocab, whether
    each layer's cumulative log decay fell over the steps, the MoE routes:
    the prefill's ``_Routes`` and each decode step's, each step's cross
    layer outputs: ``_CrossRows.rows``)."""
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    B.CACHE_DTYPE = cache_dtype
    try:
        tokens = torch.as_tensor(prompt, dtype=torch.int32,
                                 device="cuda")[None]
        with _Routes() as first:
            _, cache = M.prefill(params, tokens, cfg, max_len=max_len,
                                 **(memory or {}))
        if plant:
            for layer, spec in zip(cache["layers"], cfg.layer_specs()):
                if spec.mixer == "cross":
                    layer["mixer"]["v"].zero_()
        ld_prefill = _log_decays(cache)
        out, steps, cross = [], [], []
        for n in range(8):
            step_tok = torch.as_tensor(gen_toks[n:n + 1], dtype=torch.int32,
                                       device="cuda")
            with _Routes(plant=plant) as seen, _CrossRows() as rows:
                logits, cache = M.decode_step(params, step_tok, cache, cfg)
            out.append(logits[0, :cfg.vocab_size].float())
            steps.append(seen)
            cross.append(rows.rows)
    finally:
        B.CACHE_DTYPE = torch.bfloat16
    fell = [bool((b < a).all()) for a, b in zip(ld_prefill,
                                                 _log_decays(cache))]
    return out, fell, (first, steps), cross


def phase_decode_check(params, cfg, path, prompt, gen_toks,
                       max_len, memory=None, plant=False) -> None:
    """Decode against a fresh prefill, for every serving path. Each of 8
    steps' logits after a prefill of ``prompt`` and the tokens so far, held
    to a fresh prefill of the same, entry by entry within tol + tol·|want|,
    three ways: the bf16 serving params (``TOL_LOGITS``, or
    ``TOL_LOGITS_DEEP`` past 16 layers); the same params cast to fp32,
    with the caches bf16 as the reference keeps them (``TOL_LOGITS_FP32``);
    and fp32 with the caches fp32 too (``TOL_LOGITS_EXACT``), which shows
    the fp32 gap is the bf16 caches'. An MoE or image stack's bf16 run
    takes ``TOL_LOGITS_DEEP``. Logs max |prefill bf16 − prefill
    fp32|, how far bf16 moves a prefill's logits, beside them. Also checks
    K3 took a log a where the model has one: every such layer's cumulative
    log decay fell over the steps (and none did without one).

    MoE stacks (on a drop-free copy, so capacity drops nothing): routing
    is discontinuous, so a rounding that differs between the two forms
    (the bf16 K/V cache against the prefill's fp32 K/V) can send a token
    to another expert, after which the two forms compute different
    functions. So each run's fresh prefill routes every token by the
    experts that run's prefill and decode steps chose (``_Routes(force=)``)
    and every step's logits are compared; the steps whose own routes the
    prefill would have chosen otherwise (flips) are logged, and with fp32
    caches none may flip. A planted wrong expert read in decode
    (``_Routes(plant=)``) must fail the fp32-caches limit; its bf16 gap,
    the largest fault-free gap's upper yardstick, is logged.

    The cross family: every prefill (the decoded run's and the fresh ones)
    takes the row's ``memory``, and each cross layer's own output at the
    decoded token (``_CrossRows``) is held to the fresh prefill's last row
    of that layer, max |error| over max |want| within the run's limit: the
    cross layers move the logits little (a memory of N(0, 0.1²) attended
    almost evenly), so the logits alone barely see them. With ``plant``,
    the cross layers' cached V zeroed after the prefill (a planted fault)
    runs in bf16 and in fp32 with fp32 caches, and both must fail that
    layer check; their logits' gaps are logged beside the limits."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model as M
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    bf16, fp32 = torch.bfloat16, torch.float32
    moe = cfg.moe is not None
    tol_b = TOL_LOGITS if cfg.n_layers <= 16 and not moe \
        and not cfg.n_image_tokens else TOL_LOGITS_DEEP
    # name -> (params, cfg, cache dtype, planted fault, tolerance)
    setups = {"bf16": (params, cfg, bf16, False, tol_b),
              "fp32": (p32, cfg32, bf16, False, TOL_LOGITS_FP32),
              "fp32_caches_fp32": (p32, cfg32, fp32, False,
                                   TOL_LOGITS_EXACT)}
    if moe or plant:
        setups.update(planted_bf16=(params, cfg, bf16, True, tol_b),
                      planted_fp32_caches_fp32=(p32, cfg32, fp32, True,
                                                TOL_LOGITS_EXACT))
    cross = any(spec.mixer == "cross" for spec in cfg.layer_specs())
    mem = memory or {}
    runs = {name: _decode_logits(p, c, prompt, gen_toks, max_len, cdt,
                                 plant, mem)
            for name, (p, c, cdt, plant, _) in setups.items()}
    worst = dict.fromkeys(runs, 0.0)
    ok = dict.fromkeys(runs, True)
    c_worst = dict.fromkeys(runs, 0.0)      # the cross layers' own outputs
    c_ok = dict.fromkeys(runs, True)
    flips = {name: [] for name in runs}    # steps whose routes differ
    yard = scale = 0.0
    for n in range(8):
        full = torch.as_tensor(np.concatenate([prompt, gen_toks[:n + 1]]),
                               dtype=torch.int32, device="cuda")[None]
        with _CrossRows() as rows_b:
            ref_b = M.prefill(params, full, cfg, max_len=max_len, **mem)[0][
                0, :cfg.vocab_size].float()
        with _CrossRows() as rows_f:
            ref_f = M.prefill(p32, full, cfg32, max_len=max_len, **mem)[0][
                0, :cfg.vocab_size].float()
        for name, (logits, _, (first, steps), rows) in runs.items():
            p, c, _, _, tol = setups[name]
            want = ref_b if p is params else ref_f
            if cross:
                rel = _rel_rows(rows[n], (rows_b if p is params
                                          else rows_f).rows)
                c_worst[name] = max(c_worst[name], rel)
                c_ok[name] = c_ok[name] and rel <= tol
            if moe:
                force = [torch.cat([pre] + [steps[j].idx[layer]
                                            for j in range(n + 1)])
                         for layer, pre in enumerate(first.idx)]
                with _Routes(force=force) as seen:
                    want = M.prefill(p, full, c, max_len=max_len, **mem)[0][
                        0, :c.vocab_size].float()
                if seen.calls != steps[n].calls:
                    flips[name].append(n)
            err, within = max_err_within(logits[n], want, tol)
            worst[name] = max(worst[name], err)
            ok[name] = ok[name] and within
        yard = max(yard, float((ref_b - ref_f).abs().max()))
        scale = max(scale, float(ref_f.abs().max()))
    del p32
    _free()
    planted = [name for name in runs if name.startswith("planted")]
    fell = [f for name, (_, layers, *_) in runs.items()
            if name not in planted for f in layers]
    decays = _ssm(cfg) or cfg.linear_attn.decay != "none"
    took = all(fell) if decays else not any(fell)
    exact = not flips["fp32_caches_fp32"]
    if cross:
        caught = not any(c_ok[name] for name in planted)
    else:
        caught = not planted or not ok["planted_fp32_caches_fp32"]
    passed = all(ok[name] and c_ok[name] for name in runs
                 if name not in planted)
    extra = {}
    if moe:
        extra = {f"{name}_route_flip_steps":
                 repr(flips[name]) if flips[name] else "none"
                 for name in runs if name not in planted}
    if cross:
        extra.update({f"{name}_cross_layer_rel_err": f"{c_worst[name]:.4e}"
                      for name in runs})
    if planted:
        extra["planted_caught"] = caught
    log(path, check="decode logits vs fresh prefill", steps=8,
        prompt=len(prompt), max_len=max_len,
        **{f"{name}_max_abs_err": f"{worst[name]:.4e}" for name in runs},
        **{f"{name}_tol": setups[name][4] for name in runs}, **extra,
        bf16_vs_fp32_prefill=f"{yard:.4f}", max_abs_logit=f"{scale:.3f}",
        k3_took_log_a=decays and took,
        ok=passed and took and exact and caught)
    check(passed, f"{path}: decode vs prefill off: max |error| "
          f"{worst} (cross layers, relative: {c_worst}) against "
          f"tolerances { {name: s[4] for name, s in setups.items()} }")
    check(exact, f"{path}: with fp32 caches the decoded token's routes "
          f"left the prefill's at steps {flips['fp32_caches_fp32']}")
    if planted:
        check(caught, f"{path}: a planted fault (a wrong expert read, a "
              f"zeroed cross V) passed: logits "
              f"{worst['planted_fp32_caches_fp32']:.4e}, cross layers "
              f"{ {name: c_worst[name] for name in planted} }")
    check(took, f"{path}: log decay fell over decode in layers {fell} "
          f"(decay {decays})")


def _cache_formula(cfg, batch, max_len):
    """The decode cache's bytes by kind from the config: per linear layer
    B·H·(dh² + 1)·4, per SSD layer (mamba2, hymba's ``ssm``)
    B·nh·(d_state·headdim + 1)·4 (``linear_state``); per softmax layer
    2·B·n_kv·ring·dh·2 + B·ring·4, ring = min(window, ``max_len``), and
    ``max_len`` on every hymba layer (``kv_ring``); per SSD layer
    B·(d_conv − 1)·(d_in + 2·ngroups·d_state)·2 (``conv``); per cross
    layer the memory's K/V, 2·B·n_kv·n_mem·dh·2 (``kv_ring``)."""
    out = {"linear_state": 0, "kv_ring": 0, "conv": 0}
    for spec in cfg.layer_specs():
        if spec.mixer == "linear":
            out["linear_state"] += batch * cfg.n_heads * (
                cfg.head_dim ** 2 + 1) * 4
        if spec.mixer in ("mamba2", "hymba"):
            mb = cfg.mamba
            d_in = cfg.d_model * (mb.expand if spec.mixer == "mamba2" else 1)
            nh = d_in // mb.headdim
            out["linear_state"] += batch * nh * (mb.d_state * mb.headdim
                                                 + 1) * 4
            out["conv"] += batch * (mb.d_conv - 1) * (
                d_in + 2 * mb.ngroups * mb.d_state) * 2
        if spec.mixer in ("softmax", "hymba"):
            ring = max_len if spec.mixer == "hymba" else \
                min(spec.sliding_window or max_len, max_len)
            out["kv_ring"] += 2 * batch * cfg.n_kv_heads * ring \
                * cfg.head_dim * 2 + batch * ring * 4
        if spec.mixer == "cross":
            n_mem = cfg.n_image_tokens or cfg.encoder.n_frames
            out["kv_ring"] += 2 * batch * cfg.n_kv_heads * n_mem \
                * cfg.head_dim * 2
    return out


def phase_serve(kernels: list, cfg, path: str, want_cache=None,
                decode_cfg=None):
    """8 ragged greedy requests through ``ServeEngine`` (4 slots, max_len
    544). Pure recurrent stacks (linear, mamba2) prefill left-padded
    buckets; hybrids (LASP-2H, hymba) and stacks with softmax layers or
    MoE MLPs prefill by exact length. Checks the launches of K1 and K4 per
    prefill batch and K3 per decode step (K3 and K4 all on ``sm90``, K1 on
    its shapes' route: ``simt`` for hymba's 16 x 64 heads; none of them
    where the stack has no such layer), the cache footprint against its
    formula (and ``want_cache``, bytes by kind, where given), and decode
    logits against a fresh prefill, on the same params under
    ``decode_cfg`` where given (an MoE stack's drop-free copy)."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    from repro_torch.kernels.lasp2_decode import lasp2_decode_step
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    n_lin, n_soft = _mixer_counts(cfg)
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = _numel(params)
    log(path, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        softmax=n_soft, d_model=cfg.d_model, params=n_params, dtype=cfg.dtype,
        init_s=f"{time.perf_counter() - t0:.2f}")

    new_tokens, max_batch = 32, 4
    max_len = 512 + new_tokens
    engine = ServeEngine(cfg, params, max_len=max_len, max_batch=max_batch)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 513, size=8)     # as launch/serve.py draws them
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    uids = [engine.submit(p, new_tokens, seed=0, stream=i)
            for i, p in enumerate(prompts)]

    counters = (lasp2_chunk_fwd, lasp2_decode_step, flash_attention_fwd)
    routed = counters
    _zero(*counters)
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k3, k4, k1_sm90, k1_simt, k3_sm90, k3_simt, k4_sm90, k4_simt = \
        _read(counters, routed)
    k1_route = _chunk_route(cfg)
    k1_on = {"sm90": k1_sm90, "simt": k1_simt}

    stats = engine.stats()
    batches, steps = int(stats["prefill_batches"]), int(stats["decode_steps"])
    check(sorted(results) == sorted(uids), "not every request finished")
    for uid in uids:
        toks = results[uid]
        check(len(toks) == new_tokens, f"request {uid}: {len(toks)} tokens")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"request {uid}: token out of vocab")
    check(k1 == n_lin * batches and (k1 > 0) == (n_lin > 0),
          f"K1 launches {k1} != {n_lin} x {batches} prefill batches")
    check(k1_on[k1_route] == k1,
          f"K1 took sm90 {k1_sm90}, simt {k1_simt} times; want "
          f"{k1_route} only")
    check(k3 == n_lin * steps and (k3 > 0) == (n_lin > 0),
          f"K3 launches {k3} != {n_lin} x {steps} decode steps")
    check(k3_sm90 == k3 and k3_simt == 0,
          f"K3 took sm90 {k3_sm90}, simt {k3_simt} times; want sm90 only")
    check(k4 == n_soft * batches,
          f"K4 launches {k4} != {n_soft} x {batches} prefill batches")
    check(k4_sm90 == k4 and k4_simt == 0,
          f"K4 took sm90 {k4_sm90}, simt {k4_simt} times; want sm90 only")
    if n_lin:
        _count(kernels, f"lasp2_chunk_fwd_{k1_route}", path, k1)
        _count(kernels, "lasp2_decode_step_sm90", path, k3_sm90)
    if n_soft:
        _count(kernels, "flash_attention_fwd_sm90", path, k4_sm90)
    total_new = sum(len(t) for t in results.values())
    cache = engine.cache_stats()
    # linear_state (and conv) constant in max_len, each kind its formula
    longer = ServeEngine(cfg, params, max_len=4096, max_batch=max_batch)
    long_stats = longer.cache_stats()
    del longer
    check(all(long_stats[k] == cache[k] for k in ("linear_state", "conv")),
          f"linear_state {cache['linear_state']} or conv {cache['conv']} "
          f"moves with max_len: {long_stats}")
    formula = _cache_formula(cfg, max_batch, max_len)
    check(all(cache[k] == n for k, n in formula.items()),
          f"cache bytes {cache} != formula {formula}")
    check(want_cache is None
          or all(cache[k] == n for k, n in want_cache.items()),
          f"cache bytes {cache} != {want_cache}")
    log(path, requests=len(results), prompts=f"{lens.min()}..{lens.max()}",
        slots=max_batch, prefill_batches=batches, decode_steps=steps,
        k1_launches=k1, k1_sm90_launches=k1_sm90, k3_launches=k3,
        k3_sm90_launches=k3_sm90, k3_per_decode_step=k3 / steps,
        k4_per_prefill_batch=k4 / batches,
        k4_launches=k4, k4_sm90_launches=k4_sm90, k1_route=k1_route,
        wall_s=f"{wall:.3f}", tokens_per_s=f"{total_new / wall:.1f}",
        decode_tokens_per_s=f"{stats['decode_tokens_per_s']:.1f}",
        ttft_p50_ms=f"{stats['ttft_s_p50'] * 1e3:.2f}",
        prefill_p50_ms=f"{stats['prefill_s_p50'] * 1e3:.2f}",
        decode_step_p50_ms=f"{stats['decode_step_s_p50'] * 1e3:.3f}",
        cache_linear_state_bytes=cache["linear_state"],
        cache_kv_ring_bytes=cache["kv_ring"], cache_conv_bytes=cache["conv"],
        cache_total_bytes=cache["total"])

    phase_decode_check(params, decode_cfg or cfg, path, prompts[0],
                       results[uids[0]], max_len)
    return params


# ---------------------------------------------------------------------------
# Phase 5: where a decode step and a prefill batch spend their time.
# ---------------------------------------------------------------------------

def _profile(fn, n, match=None):
    """(host wall ms per call, device kernel ms per call, kernels per call,
    top kernels, (device ms, launches) per call of the kernels whose name
    holds ``match``) over ``n`` calls after warm-up. The wall is taken
    without the profiler; the device time is the sum of the kernel rows the
    profiler records on the card (0.0 when it records none). Only the card
    is traced: no number here reads host op events, and with them the
    profile of one full-width mamba2 train step took 49 s (PERF.md
    §6)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(r[0] for r in rows) / n / 1e3
    kernels = sum(r[1] for r in rows) / n
    top = sorted(rows, reverse=True)[:5]
    hits = [(t, c) for t, c, k in rows if match and match in k]
    return wall, device, kernels, ";".join(
        f"{k[:48]}:{t / n / 1e3:.3f}ms" for t, _, k in top), \
        (sum(t for t, _ in hits) / n / 1e3, sum(c for _, c in hits) / n)


def phase_profile(cfg, params, path: str, prefill_rows: int,
                  prefill_len: int, pads) -> None:
    """Profile one decode step of 4 slots and one prefill call:
    ``prefill_rows`` prompts of ``prefill_len`` tokens, left-padded by
    ``pads`` (pure linear stacks) or of exact length (``pads=None``).
    Returns the host wall ms per call, ``{"decode": ms, "prefill": ms}``."""
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    cache = M.init_cache(cfg, 4, 544)
    tok = torch.zeros(4, dtype=torch.int32, device=dev)

    def decode():
        nonlocal cache
        _, cache = M.decode_step(params, tok, cache, cfg)

    prompts = torch.zeros((prefill_rows, prefill_len), dtype=torch.int32,
                          device=dev)
    pad_lens = None if pads is None else torch.tensor(pads, device=dev)

    def prefill():
        M.prefill(params, prompts, cfg, max_len=544, pad_lens=pad_lens)

    walls = {}
    for name, fn, n in (
            (f"{path} decode_step B4", decode, 10),
            (f"{path} prefill B{prefill_rows}xS{prefill_len}", prefill, 3)):
        wall, device, kernels, top, (k3_ms, k3_n) = _profile(
            fn, n, K3_SM90_KERNEL)
        walls["decode" if fn is decode else "prefill"] = wall
        idle = f"{1 - device / wall:.3f}" if device else "not measured"
        k3 = {}
        if fn is decode:     # K3's share of the step's device time
            k3 = {"k3_sm90_device_ms": f"{k3_ms:.4f}" if device
                  else "not measured", "k3_sm90_launches": f"{k3_n:.0f}"}
        log("profile", what=repr(name), wall_ms=f"{wall:.3f}",
            device_kernel_ms=f"{device:.3f}" if device else "not measured",
            **k3, device_idle_share=idle, kernels_per_call=f"{kernels:.0f}",
            top=repr(top))
    return walls


# ---------------------------------------------------------------------------
# Phases 7 and 8: train full-width, full-depth linear-llama3-1b and its
# hybrid.
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 10, 2048, 8, 2


def train_setup(cfg, steps: int, lr: float, remat: str = "none",
                batch: int = TRAIN_BATCH, micro: int = TRAIN_MICRO):
    """Phase 7's ``RunConfig`` and data: 2 microbatches of 4 x 2048 from
    ``SyntheticLM`` (4 documents per row, so resets fall mid-row), peak
    learning rate ``lr`` after 2 warm-up steps, cosine over ``steps``;
    ``batch`` rows in ``micro`` microbatches where a model needs fewer
    tokens a microbatch."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    run = RunConfig(num_microbatches=micro, remat=remat,
                    learning_rate=lr, warmup_steps=2, total_steps=steps,
                    seed=0)
    return run, SyntheticLM(cfg.vocab_size, TRAIN_SEQ, batch, seed=0)


def phase_train(kernels: list, cfg, path: str, steps: int = TRAIN_STEPS,
                lr: float = 3e-4, remat: str = "none",
                batch: int = TRAIN_BATCH, micro: int = TRAIN_MICRO,
                require_fall: bool = True) -> list:
    """``steps`` steps through ``train()``: fp32 masters drawn on the card
    from seed 0, bf16 compute, ``SyntheticLM`` (4 documents per 2048-token
    row, so resets fall mid-row), 2 microbatches of 4 x 2048 (BH 64 at the
    kernels for linear-llama3), ``remat`` (under "full" each layer's
    forward, its K1 and K4 among it, runs again in the backward), no
    checkpoints (16 GB of state a save), peak learning rate ``lr`` after 2
    warm-up steps, cosine over ``steps``; ``batch`` and ``micro`` cut the
    tokens a step where the model needs it (never the width). The loss
    must fall unless ``require_fall`` is False (3 steps, 2 of them
    warm-up). Returns the history (one metrics dict a step)."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_fwd)
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_step

    run, data = train_setup(cfg, steps, lr, remat, batch, micro)
    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv,
                fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    routed = counters
    # the loop logs every step after the step's work: the counters read
    # there give each step's launches
    marks = []

    def log_fn(msg):
        if msg.startswith("step"):
            marks.append(_read(counters, routed))

    torch.cuda.reset_peak_memory_stats()
    _zero(*counters)
    t0 = time.perf_counter()
    state, hist = train(cfg, run, data, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = _read(counters, routed)
    peak = torch.cuda.max_memory_allocated()
    per_step = [[b - a for a, b in zip(prev, cur)]
                for prev, cur in zip([[0] * len(totals)] + marks, marks)]

    losses = [h["loss"] for h in hist]
    n_lin, n_soft = _mixer_counts(cfg)
    # K1, K2a, K2b, K4, K5a, K5b, then each on sm90 and on simt: the bf16
    # train path takes sm90 only, but for the chunk kernels at hymba's
    # 16 x 64 heads (simt); remat="full" runs each forward kernel twice
    lin, soft = n_lin * micro, n_soft * micro
    fwd = 2 if remat == "full" else 1
    on = (lambda n: [n, 0]) if _chunk_route(cfg) == "sm90" \
        else (lambda n: [0, n])
    want = [fwd * lin, lin, lin, fwd * soft, soft, soft] + on(fwd * lin) \
        + on(lin) * 2 + [fwd * soft, 0] + [soft, 0] * 2
    check(len(hist) == steps, f"{len(hist)} steps ran")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(not any(h["skipped"] for h in hist), "a step was skipped")
    check(not require_fall or np.mean(losses[-3:]) < losses[0],
          f"loss did not fall: {losses[0]:.4f} -> {losses[-3:]}")
    check(len(per_step) == steps and all(n == want for n in per_step),
          f"launches of K1, K2a, K2b, K4, K5a, K5b, then each sm90/simt, "
          f"per step {per_step}; want {want}")
    _count_routed(kernels, counters, routed, totals, path)
    dts = [h["dt"] for h in hist[1:]]      # step 0 carries the warm-up
    p50 = float(np.median(dts))
    tokens = batch * TRAIN_SEQ
    log(path, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        softmax=n_soft, decay=cfg.linear_attn.decay, steps=steps, lr=lr,
        batch=f"{batch}x{TRAIN_SEQ}", microbatches=micro,
        remat=run.remat, param_dtype=cfg.param_dtype, dtype=cfg.dtype,
        loss_first=f"{losses[0]:.4f}",
        loss_last3=f"{np.mean(losses[-3:]):.4f}",
        losses=repr([round(x, 4) for x in losses]),
        grad_norm_first=f"{hist[0]['grad_norm']:.3f}",
        launches_per_step_k1_k2a_k2b_k4_k5a_k5b_routed=repr(per_step[0]),
        launches_k1_k2a_k2b_k4_k5a_k5b_routed=repr(totals),
        wall_s=f"{wall:.2f}",
        step0_ms=f"{hist[0]['dt'] * 1e3:.1f}", step_p50_ms=f"{p50 * 1e3:.1f}",
        tokens_per_s=f"{tokens / p50:.0f}",
        max_memory_allocated_gb=f"{peak / 1e9:.2f}")

    step_fn = make_train_step(cfg, run)
    step_batch = data.microbatched(steps, micro)

    def one_step():
        nonlocal state
        state, _ = step_fn(state, step_batch)

    wall_ms, device, n_kernels, top, _ = _profile(one_step, 1)
    idle = f"{1 - device / wall_ms:.3f}" if device else "not measured"
    log("profile", what=repr(f"{path} step {batch}x{TRAIN_SEQ} "
                             f"({micro} microbatches)"),
        wall_ms=f"{wall_ms:.3f}",
        device_kernel_ms=f"{device:.3f}" if device else "not measured",
        device_idle_share=idle, kernels_per_call=f"{n_kernels:.0f}",
        top=repr(top))
    return hist


# ---------------------------------------------------------------------------
# Phase 9: full-width gradient checks, kernel path against plain path.
# ---------------------------------------------------------------------------

TOL_CHECK = 1e-3


def phase_grad_check(kernels: list, cfg, path: str,
                     causal: bool = True, tokens: int = 256) -> None:
    """A shallow fp32 copy of a config at full width (d_model 2048, 16
    heads of 128, vocab 128256): the same params on the card, where every
    linear layer runs K1, K2a and K2b and every softmax layer K4, K5a and
    K5b, and on the host CPU, where the wrappers take their plain versions;
    one row of ``tokens`` tokens (256) with a reset mid-row. TF32 is off
    (phase 1). The loss and every gradient agree within 1e-3
    relative-plus-absolute; SSD layers' ``a_log``, ``dt_bias`` and conv
    kernels are among the leaves, and so are the qkv biases (drawn from
    N(0, 0.5²), as they start at zero) and an MoE layer's router, expert
    stacks and shared experts (phase 14), and the cross family's gates
    (set to ``CROSS_GATE``) and encoder layers, on a memory (N(0, 0.1²)
    frames or image tokens, one row) drawn on the host (phase 15).
    ``causal=False``: the bidirectional model, whose linear layers run no
    kernel (paper Alg. 1 is two products) and whose softmax layers run
    K4, K5a and K5b unmasked. The params are drawn on the card and copied
    to the host (drawing the zoo's 1.2–1.9 B parameters on the host takes
    tens of seconds)."""
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_fwd)
    from repro_torch.models import model as M

    host = tree_map(lambda t: t.cpu(), M.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg,
        param_dtype="float32"))
    _free()
    if cfg.qkv_bias:       # zeros at init: draw them so they carry weight
        gen = torch.Generator().manual_seed(2)
        for layer in host["layers"]:
            for name in ("bq", "bk", "bv"):
                layer["mixer"][name].normal_(0.0, 0.5, generator=gen)
    mem_h = {}
    if _cross(cfg):
        _set_gates(host, CROSS_GATE)
        mem_h = _memory(cfg, 1, torch.Generator().manual_seed(3), "cpu")
    mem_c = {k: v.to("cuda") for k, v in mem_h.items()}
    card = tree_map(lambda t: t.to("cuda"), host)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(1, tokens + 1))
    resets = np.zeros((1, tokens), bool)
    resets[0, [0, 100]] = True

    def loss_and_grads(params, mem):
        leaves = [p.requires_grad_(True) for _, p in
                  leaves_with_paths(params)]
        loss = M.lm_loss(M.forward(params, torch.as_tensor(toks[:, :-1]),
                                   cfg, resets=torch.as_tensor(resets),
                                   causal=causal, **mem),
                         torch.as_tensor(toks[:, 1:]))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv,
                fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    routed = counters
    _zero(*counters)
    loss_c, grads_c = loss_and_grads(card, mem_c)
    torch.cuda.synchronize()
    launched = _read(counters, routed)
    n_lin, n_soft = _mixer_counts(cfg)
    chunk = n_lin if causal else 0
    # fp32: every routed kernel takes its simt route
    check(launched == [chunk] * 3 + [n_soft] * 3 + [0, chunk] * 3
          + [0, n_soft] * 3,
          f"card path launched K1, K2a, K2b, K4, K5a, K5b, then each "
          f"sm90/simt {launched} times")
    _count_routed(kernels, counters, routed, launched, path)
    loss_h, grads_h = loss_and_grads(host, mem_h)
    e_loss, ok = max_err_within(loss_c.cpu(), loss_h, TOL_CHECK)
    worst, worst_at = 0.0, ""
    names = ["/".join(p) for p, _ in leaves_with_paths(host)]
    leaf_names = {name.rsplit("/", 1)[-1] for name in names}
    need = set()
    if _ssm(cfg):
        need |= {"a_log", "dt_bias", "conv_x", "conv_b", "conv_c"}
    if cfg.qkv_bias:
        need |= {"bq", "bk", "bv"}
    if cfg.moe is not None:
        need |= {"router"}
        check(any("/experts/" in n for n in names)
              and (any("/shared/" in n for n in names)
                   == bool(cfg.moe.n_shared_experts)),
              f"MoE leaves missing: {names}")
    if _cross(cfg):
        need |= {"gate"}
    check(need <= leaf_names, f"leaves {sorted(need - leaf_names)} missing")
    check(cfg.encoder is None or {
        f"encoder/layers/{cfg.encoder.n_layers - 1}/mlp/w2",
        "encoder/final_norm/scale"} <= set(names), f"encoder leaves: {names}")
    bad = []
    for name, gc_, gh in zip(names, grads_c, grads_h):
        err, good = max_err_within(gc_.cpu(), gh, TOL_CHECK)
        if err > worst:
            worst, worst_at = err, name
        if not good:
            bad.append(name)
    log(path, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        softmax=n_soft, dtype=cfg.dtype, causal=causal,
        decay=cfg.linear_attn.decay, tokens=f"1x{tokens}", resets="0,100",
        loss_card=f"{float(loss_c):.6f}", loss_host=f"{float(loss_h):.6f}",
        err_loss=f"{e_loss:.3e}", leaves=len(names),
        max_abs_grad_err=f"{worst:.3e}", worst_leaf=worst_at, tol=TOL_CHECK,
        ok=ok and not bad)
    check(ok and not bad, f"gradients differ: loss ok={ok}, leaves {bad}")

# ---------------------------------------------------------------------------
# Phase 10: LASP-2 and LASP-2H sequence parallelism (the DP×SP step).
# ---------------------------------------------------------------------------

SP_ROWS, SP_SEQ, SP_STEPS, SP_LAYERS = 4, 2048, 3, 4
# Losses against one device, relative: the reference's DP×SP-vs-single-
# device limit (tests/distributed_checks.py:513-519). Between two runs of
# the same data and params, each step's loss and grad norm, relative:
# (a)'s (1, 1) steps against phase 7's one-device steps, and b3's (2, 1)
# with ZeRO-1 against (1, 1). The loss limit is the reference's between
# layouts. The grad norms part by bf16 rounding: the two bf16 backwards
# round at other points ((a): the CE gradient enters scaled by 1/n on one
# device, unscaled under SP; b3: each rank rounds its partial weight
# gradients), and from the first step with a nonzero learning rate the
# trajectories carry it; so their limit is bf16's resolution, 2^-8
# (PERF.md §6). The update itself is held bitwise-tight in b3, ZeRO-1
# against replicated AdamW.
TOL_SP_LOSS, TOL_SP_LAYOUT, TOL_SP_GNORM = 2e-3, 2e-4, 2.0 ** -8
# ZeRO-1 against replicated AdamW on the same layout and data after
# SP_STEPS steps, every param: the CPU test's limit
# (test_zero1_equals_replicated_adamw). Both runs reduce the same
# gradients and apply the same elementwise update.
TOL_ZERO1_RTOL, TOL_ZERO1_ATOL = 1e-6, 1e-7
# Gradients of the bf16 step under SP against the bf16 step on one device,
# relative L2 per leaf. The two round to bf16 at other points (a chunk's
# o is K1's bf16 intra part plus the fp32 prefix term, rounded again; dk
# and dv arrive by the reduce-scatter or the dM suffix sum), so they part
# by about what bf16 itself moves a gradient: the phase prints, beside
# each worst leaf, the same leaf's distance between one device's bf16 and
# fp32 gradients. 3e-2 is the size of that yardstick (PERF.md §6).
TOL_SP_GRAD = 3e-2


def _sp_counters():
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_fwd)
    return (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv,
            fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
            fl.flash_attention_bwd_dkv)


def _sp_batches(cfg, resets, seq=SP_SEQ, rows=SP_ROWS, micro=1):
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, seq, rows, seed=0)
    out = [data.microbatched(i, micro) for i in range(SP_STEPS)]
    if not resets:
        for b in out:
            b.pop("resets")
    return out


def _sp_params(cfg):
    from repro_torch.models import model as M
    return M.init_params(torch.Generator(device="cuda").manual_seed(1), cfg,
                         device="cuda", param_dtype="float32")


def _sp_run(**kw):
    from repro_torch.configs.base import RunConfig
    return RunConfig(**{**dict(num_microbatches=1, remat="none",
                               learning_rate=3e-4, warmup_steps=2,
                               total_steps=10, seed=0), **kw})


def _tape_counts(records):
    """{"op tag": [count, payload bytes]} of one step's tape."""
    out = {}
    for r in records:
        key = f"{r.op} {r.tag}"
        n, _ = out.get(key, (0, 0))
        out[key] = [n + 1, r.payload_bytes]
    return out


def _sp_steps(cfg, run, layout, state, batches, drift=False):
    """The DP×SP step over ``batches``, counters zeroed just before and
    read just after. Returns a dict: the final ``state``, the ``losses``
    and ``gnorms``, each step's ``tapes`` (tape counts), ``launched`` (as
    ``_read`` gives them), ``per_step`` launch lists, step ``walls`` and
    ``peak`` bytes; with ``drift`` also each step's flight-recorder
    ``drifts``: its tape against the collectives issued to
    ``torch.distributed``."""
    from contextlib import nullcontext

    from repro_torch.comm import primitives
    from repro_torch.obs import FlightRecorder
    from repro_torch.train.step import make_train_step
    step = make_train_step(cfg, run, layout)
    counters = _sp_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(*counters)
    out = {k: [] for k in ("losses", "gnorms", "tapes", "walls", "drifts",
                           "records")}
    marks = []
    for b in batches:
        t0 = time.perf_counter()
        with primitives.tape() as rec, \
                (primitives.issued() if drift else nullcontext()) as sent:
            state, m = step(state, b)
        torch.cuda.synchronize()
        m = to_host(m)         # the step returns device scalars
        out["walls"].append(time.perf_counter() - t0)
        marks.append(_read(counters, counters))
        out["tapes"].append(_tape_counts(rec))
        out["records"].append(list(rec))
        if drift:
            out["drifts"].append(FlightRecorder(None).on_compile(
                records=rec, issued=sent).drift)
        out["losses"].append(m["loss"])
        out["gnorms"].append(m["grad_norm"])
        check(not m["skipped"] and np.isfinite(m["loss"]),
              f"step skipped or non-finite: {m}")
    out["per_step"] = [[b - a for a, b in zip(prev, cur)] for prev, cur in
                       zip([[0] * len(marks[0])] + marks, marks)]
    return dict(out, state=state, launched=marks[-1],
                peak=torch.cuda.max_memory_allocated())


def _rel_errs(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def _flat_params(params):
    from repro_torch.core.tree import leaves_with_paths
    return torch.cat([p.detach().reshape(-1)
                      for _, p in leaves_with_paths(params)])


def _want_launches(k1, k2, flash):
    """``_read``'s list for K1, K2a, K2b, K4, K5a, K5b all on sm90."""
    totals = [k1, k2, k2, flash, flash, flash]
    return totals + [x for n in totals for x in (n, 0)]


def _sp_grad_check(rank, path, cfg, layout, params, batch):
    """The DP×SP step's reduced gradients and loss against one device's on
    the same rows (rank 0 computes the one-device side)."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.models import model as M
    from repro_torch.train.step import ShardedStep
    leaves = [p.requires_grad_(True) for _, p in leaves_with_paths(params)]
    gflat, ce, n = ShardedStep(cfg, _sp_run(), layout).grads(params, batch)
    loss_sp = float(ce / n)
    check(bool(torch.isfinite(gflat).all()), "non-finite SP gradients")
    if rank:
        return
    loss = M.lm_loss(M.forward(params, torch.as_tensor(batch["tokens"][0]),
                               cfg, resets=None if "resets" not in batch
                               else torch.as_tensor(batch["resets"][0])),
                     torch.as_tensor(batch["labels"][0]))
    grads = torch.autograd.grad(loss, leaves)
    loss_f32 = M.lm_loss(M.forward(
        params, torch.as_tensor(batch["tokens"][0]),
        dataclasses.replace(cfg, dtype="float32"),
        resets=None if "resets" not in batch
        else torch.as_tensor(batch["resets"][0])),
        torch.as_tensor(batch["labels"][0]))
    grads_f32 = torch.autograd.grad(loss_f32, leaves)
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp(min=1e-30))
    e_loss = abs(loss_sp - float(loss)) / abs(float(loss))
    worst, worst_at, yard, off = 0.0, "", 0.0, 0
    for (name, p), g, g32 in zip(leaves_with_paths(params), grads,
                                 grads_f32):
        g_sp = gflat[off:off + p.numel()].view_as(p)
        off += p.numel()
        err = rel(g_sp, g)
        if err > worst:
            worst, worst_at, yard = err, "/".join(name), rel(g, g32)
    log(path, rank=rank, check="grads_vs_one_device",
        loss_sp=f"{loss_sp:.6f}", loss_one_device=f"{float(loss):.6f}",
        rel_err_loss=f"{e_loss:.3e}", tol_loss=TOL_SP_LOSS,
        worst_rel_l2_grad=f"{worst:.3e}", worst_leaf=worst_at,
        same_leaf_bf16_vs_fp32_one_device=f"{yard:.3e}",
        tol_grad=TOL_SP_GRAD)
    check(e_loss <= TOL_SP_LOSS, f"{path}: loss {loss_sp} vs {float(loss)}")
    check(worst <= TOL_SP_GRAD, f"{path}: gradient {worst_at} off by "
          f"{worst:.3e} relative L2")


def _sp_cell(rank, path, cfg, layout, resets, grad_check):
    """One cell of phase 10 (b) on this rank: the gradient check, then
    SP_STEPS steps with their launches, tapes, walls and peak memory. With
    ZeRO-1 (dp > 1), the same steps again with replicated AdamW: every
    param after the last step agrees."""
    from repro_torch.train.step import state_from_params, zero1_degree
    run = _sp_run()
    params = _sp_params(cfg)
    batches = _sp_batches(cfg, resets)
    if grad_check:
        _sp_grad_check(rank, path, cfg, layout, params, batches[0])
        _free()
    state = state_from_params(params, zero1_degree(run, layout))
    res = _sp_steps(cfg, run, layout, state, batches)
    del state
    losses, tapes, per_step = res["losses"], res["tapes"], res["per_step"]
    n_lin, n_soft = _mixer_counts(cfg)
    # packed rows and data decay take the autodiff backward
    faithful = layout.sp > 1 and not resets \
        and cfg.linear_attn.decay != "data"
    want = _want_launches(n_lin * (2 if faithful else 1), n_lin, n_soft)
    check(all(n == want for n in per_step),
          f"{path} rank {rank}: launches per step of K1, K2a, K2b, K4, K5a, "
          f"K5b, then each sm90/simt {per_step}; want {want}")
    rows = SP_ROWS // layout.dp
    c = SP_SEQ // layout.sp
    state_bytes = rows * cfg.n_heads * (cfg.head_dim ** 2 + 1) * 4
    want_tape = {"all-reduce train.grads": 1}
    if layout.sp > 1:
        want_tape["all-gather lasp2.states"] = n_lin
        want_tape["all-gather lasp2.dstates" if faithful else
                  "reduce-scatter lasp2.states.bwd"] = n_lin
        for t in ("k", "v"):
            if n_soft:
                want_tape[f"all-gather lasp2h.{t}"] = n_soft
                want_tape[f"reduce-scatter lasp2h.{t}.bwd"] = n_soft
    if layout.dp > 1:
        want_tape["all-gather zero1.param_gather"] = 1
    for tape in tapes:
        check({k: v[0] for k, v in tape.items()} == want_tape,
              f"{path} rank {rank}: tape {tape}; want counts {want_tape}")
        if layout.sp > 1:
            check(tape["all-gather lasp2.states"][1] == state_bytes,
                  f"{path}: state payload {tape['all-gather lasp2.states']}")
    log(path, rank=rank, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        softmax=n_soft, decay=cfg.linear_attn.decay, dp=layout.dp,
        sp=layout.sp, rows_x_chunk=f"{rows}x{c}", resets=resets,
        backward=("faithful" if faithful else "autodiff") if layout.sp > 1
        else "one-device", zero1=run.zero1 and layout.dp > 1,
        transport="gloo (host-staged)",
        losses=repr([round(x, 6) for x in losses]),
        launches_per_step_k1_k2a_k2b_k4_k5a_k5b_routed=repr(per_step[0]),
        tape_per_step=repr(tapes[0]).replace(" ", ""),
        state_payload_bytes_per_linear_layer=state_bytes
        if layout.sp > 1 else "none",
        grad_norms=repr([round(x, 6) for x in res["gnorms"]]),
        step_wall_ms=repr([round(w * 1e3, 1) for w in res["walls"]]),
        max_memory_allocated_gb=f"{res['peak'] / 1e9:.2f}")
    if zero1_degree(run, layout) > 1:
        _zero1_vs_replicated(rank, path, cfg, layout, res, batches)
    return {"losses": losses, "gnorms": res["gnorms"],
            "launched": res["launched"]}


def _zero1_vs_replicated(rank, path, cfg, layout, res, batches):
    """The ZeRO-1 run ``res`` against replicated AdamW on the same layout,
    params and data: losses and every param after the last step, at the
    CPU test's limits."""
    from repro_torch.train.step import state_from_params
    got = _flat_params(res.pop("state")["params"]).cpu()
    _free()
    rep = _sp_steps(cfg, _sp_run(zero1=False), layout,
                    state_from_params(_sp_params(cfg)), batches)
    want = _flat_params(rep.pop("state")["params"]).cpu()
    _free()
    diff = (got - want).abs()
    over = int((diff > TOL_ZERO1_ATOL + TOL_ZERO1_RTOL * want.abs()).sum())
    e_loss = max(_rel_errs(res["losses"], rep["losses"]))
    log(path, rank=rank, check="zero1_vs_replicated_adamw",
        params=want.numel(), max_abs_param_diff=f"{float(diff.max()):.3e}",
        params_over_limit=over, bitwise_equal=bool(torch.equal(got, want)),
        rtol=TOL_ZERO1_RTOL, atol=TOL_ZERO1_ATOL,
        max_rel_err_loss=f"{e_loss:.3e}",
        replicated_tape_per_step=repr(rep["tapes"][0]).replace(" ", ""))
    check(over == 0, f"{path} rank {rank}: {over} params of ZeRO-1 off "
          f"replicated AdamW by up to {float(diff.max()):.3e}")
    check(e_loss <= TOL_ZERO1_RTOL, f"{path} rank {rank}: ZeRO-1 losses "
          f"{res['losses']} vs replicated {rep['losses']}")


def _sp_payload(rank, layout):
    """The forward exchange of one linear layer (4 rows, 16 heads of 128,
    bf16) at C 512 and C 1024: the same bytes."""
    from repro_torch.comm import primitives
    from repro_torch.core.lasp2 import SPConfig, lasp2
    gen = torch.Generator(device="cuda").manual_seed(2)
    sp = SPConfig(layout.sp_group)
    out = {}
    for c in (512, 1024):
        x = torch.randn(SP_ROWS, 16, c, 128, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        with primitives.tape() as rec:
            lasp2(x, x, x, sp=sp)
        out[c] = [r.payload_bytes for r in rec if r.tag == "lasp2.states"]
    log("sp_payload", rank=rank, rows=SP_ROWS, heads=16, dk=128, dv=128,
        lasp2_states_bytes_c512=out[512], lasp2_states_bytes_c1024=out[1024])
    check(out[512] == out[1024] == [SP_ROWS * 16 * (128 * 128 + 1) * 4],
          f"state payload moved with the chunk: {out}")


def _sp_guard_cell(rank, device, cut, layout, ckpt_dir):
    """Phase 16 (f) on this rank: ``train()`` of ``cut`` at (1, 2) for
    RT_F_STEPS + 1 steps without the guard, then RT_F_STEPS steps with it
    and a checkpoint (each with a sink on rank 0). Returns each run's
    losses, launches and rank 0's records."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.obs import InMemorySink
    from repro_torch.train.loop import train
    counters = _sp_counters()
    run = _sp_run()
    data = SyntheticLM(cut.vocab_size, SP_SEQ, SP_ROWS, seed=0)
    out = {}
    for name, r, steps, ckpt in (
            ("plain", run, RT_F_STEPS + 1, None),
            ("guard", dataclasses.replace(run, guard=True), RT_F_STEPS,
             ckpt_dir)):
        sink = InMemorySink() if rank == 0 else None
        _zero(*counters)
        t0 = time.perf_counter()
        _, hist = train(cut, r, data, device=device, params=_sp_params(cut),
                        layout=layout, sink=sink, ckpt_dir=ckpt,
                        ckpt_every=10 ** 9, max_steps=steps,
                        log_every=10 ** 9, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        log("sp_f_run", rank=rank, run=name, steps=steps,
            checkpoint=ckpt is not None,
            step_wall_ms=repr([round(h["dt"] * 1e3, 1) for h in hist]),
            wall_s=f"{time.perf_counter() - t0:.2f}")
        out[name] = {"losses": [h["loss"] for h in hist],
                     "launched": _read(counters, counters),
                     "records": sink.records if sink is not None else None}
        _free()
    return out


def _sp_rank(rank, world, device, linear_cut, hybrid_cut, gla_cut,
             guard_cut=None, guard_ckpt=None):
    """Phase 10 (b) on one of two ranks sharing the card over gloo, and
    phase 16 (f)."""
    from repro_torch.launch.mesh import make_training_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    sp_layout = make_training_groups(1, 2)
    dp_layout = make_training_groups(2, 1)
    out = {"b1": _sp_cell(rank, "sp_b1", hybrid_cut, sp_layout, True, True)}
    _free()
    out["b2"] = _sp_cell(rank, "sp_b2", linear_cut, sp_layout, False, True)
    _free()
    out["b3"] = _sp_cell(rank, "sp_b3", linear_cut, dp_layout, True, False)
    _free()
    out["b4"] = _sp_cell(rank, "sp_b4", gla_cut, sp_layout, True, False)
    _free()
    _sp_payload(rank, sp_layout)
    if guard_cut is not None:
        out["f"] = _sp_guard_cell(rank, device, guard_cut, sp_layout,
                                  guard_ckpt)
    return out


def _sp_guard_check(kernels, ranks, cut, ckpt_dir) -> None:
    """Phase 16 (f): the guarded cell at (1, 2) against the unguarded one
    (losses bitwise, the first step's tape: the same ops and counts,
    ``train.grads`` 4 bytes larger; no drift between tape and issued
    view), then the (1, 2) checkpoint resumed by the one-device loop: its
    next step's loss within phase 10's layout limit of the (1, 2) run's."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.loop import train
    for rank, res in enumerate(ranks):
        f = res["f"]
        for name in ("plain", "guard"):
            _count_routed(kernels, _sp_counters(), _sp_counters(),
                          f[name]["launched"], f"sp_f_{name}_rank{rank}")
        check(f["guard"]["losses"] == f["plain"]["losses"][:RT_F_STEPS],
              f"sp_f rank {rank}: guarded {f['guard']['losses']} vs "
              f"unguarded {f['plain']['losses']}")
    comp = {n: ranks[0]["f"][n]["records"][0] for n in ("plain", "guard")}
    ops = {n: {k.split("/", 1)[1]: v for k, v in c.items()
               if k.startswith("tape/") and k.endswith("_count")}
           for n, c in comp.items()}
    extra = comp["guard"]["tape/all-reduce_bytes"] - \
        comp["plain"]["tape/all-reduce_bytes"]
    run = dataclasses.replace(_sp_run(), guard=True)
    data = SyntheticLM(cut.vocab_size, SP_SEQ, SP_ROWS, seed=0)
    t0 = time.perf_counter()
    _, hist = train(cut, run, data, params=_sp_params(cut),
                    ckpt_dir=ckpt_dir, ckpt_every=10 ** 9,
                    max_steps=RT_F_STEPS + 1, log_every=10 ** 9,
                    log_fn=lambda *_: None)
    resume_s = time.perf_counter() - t0
    want = ranks[0]["f"]["plain"]["losses"][RT_F_STEPS]
    e_loss = abs(hist[0]["loss"] - want) / abs(want) if hist else None
    log("sp_f", arch=cut.name, layers=cut.n_layers, dp=1, sp=2,
        losses_guard=repr(ranks[0]["f"]["guard"]["losses"]),
        losses_plain=repr(ranks[0]["f"]["plain"]["losses"]),
        tape_counts_guard=repr(ops["guard"]).replace(" ", ""),
        tape_counts_plain=repr(ops["plain"]).replace(" ", ""),
        train_grads_extra_bytes=extra,
        drift_guard=comp["guard"]["drift"], drift_plain=comp["plain"]["drift"],
        resumed_one_device_step=hist[0]["step"] if hist else None,
        resumed_loss=hist[0]["loss"] if hist else None,
        loss_dp1sp2_same_step=want,
        rel_err=f"{e_loss:.3e}" if hist else None, tol=TOL_SP_LAYOUT,
        resume_wall_s=f"{resume_s:.2f}")
    check(ops["guard"] == ops["plain"], f"sp_f tape counts {ops}")
    check(extra == 4, f"sp_f: train.grads grew by {extra} bytes")
    check(comp["guard"]["drift"] == [] == comp["plain"]["drift"],
          f"sp_f drift {comp}")
    check(len(hist) == 1 and hist[0]["step"] == RT_F_STEPS,
          f"sp_f resume ran steps {[h['step'] for h in hist]}")
    check(e_loss <= TOL_SP_LAYOUT, f"sp_f resumed loss {hist[0]['loss']} "
          f"vs (1, 2)'s {want}")
    _free()


def phase_sp(kernels: list, linear, hybrid, gla, train_hist) -> list:
    """(a) The DP×SP step at (1, 1) over NCCL in this process, full width
    and depth, 3 steps on phase 7's data: losses and grad norms equal phase
    7's first three. Then the (1, 1) runs of b3's and b4's cuts. (b) Two
    ranks on the one card over gloo (NCCL refuses two ranks on one
    device), full width, depth cut to 4 layers: b1 ``HYBRID`` (3 linear +
    1 softmax) at (1, 2) on packed rows (the autodiff backward), b2
    ``CONFIG`` at (1, 2) on rows without resets (the faithful backward),
    b3 ``CONFIG`` at (2, 1) with ZeRO-1, its losses and grad norms against
    (a)'s (1, 1) run and its params against replicated AdamW at (2, 1); b4
    the GLA variant (``gla``, phase 12's) at (1, 2) on packed rows, its
    losses and grad norms against its (1, 1) run."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_training_groups, run_ranks
    from repro_torch.train.step import init_state, state_from_params
    linear_cut = dataclasses.replace(linear, n_layers=SP_LAYERS)
    hybrid_cut = dataclasses.replace(hybrid, n_layers=SP_LAYERS)
    gla_cut = dataclasses.replace(gla, n_layers=SP_LAYERS)
    want_loss = [h["loss"] for h in train_hist[:SP_STEPS]]
    want_gnorm = [h["grad_norm"] for h in train_hist[:SP_STEPS]]
    with tempfile.TemporaryDirectory(prefix="sp-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            layout = make_training_groups(1, 1)
            run = _sp_run(num_microbatches=TRAIN_MICRO,
                          total_steps=TRAIN_STEPS)
            state = init_state(torch.Generator(device="cuda").manual_seed(0),
                               linear, device="cuda")
            n_params = _numel(state["params"])
            batches = _sp_batches(linear, True, TRAIN_SEQ, TRAIN_BATCH,
                                  TRAIN_MICRO)
            res = _sp_steps(linear, run, layout, state, batches)
            del state, res["state"]
            _free()
            n_lin, _ = _mixer_counts(linear)
            want = _want_launches(*[n_lin * TRAIN_MICRO] * 2, 0)
            check(all(n == want for n in res["per_step"]),
                  f"sp_a launches per step {res['per_step']}; want {want}")
            check(all(t == {"all-reduce train.grads": [1, (n_params + 2) * 4]}
                      for t in res["tapes"]), f"sp_a tapes {res['tapes']}")
            e_loss = max(_rel_errs(res["losses"], want_loss))
            e_gnorm = max(_rel_errs(res["gnorms"], want_gnorm))
            log("sp_a", arch=linear.name, layers=linear.n_layers, dp=1,
                sp=1, transport="nccl", batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}",
                microbatches=TRAIN_MICRO,
                losses=repr([round(x, 6) for x in res["losses"]]),
                phase7_losses=repr([round(x, 6) for x in want_loss]),
                max_rel_err_loss=f"{e_loss:.3e}", tol_loss=TOL_SP_LAYOUT,
                grad_norms=repr([round(x, 6) for x in res["gnorms"]]),
                phase7_grad_norms=repr([round(x, 6) for x in want_gnorm]),
                max_rel_err_grad_norm=f"{e_gnorm:.3e}",
                tol_grad_norm=TOL_SP_GNORM,
                tape_per_step=repr(res["tapes"][0]).replace(" ", ""),
                step_wall_ms=repr([round(w * 1e3, 1) for w in res["walls"]]),
                max_memory_allocated_gb=f"{res['peak'] / 1e9:.2f}")
            check(e_loss <= TOL_SP_LAYOUT,
                  f"sp_a losses {res['losses']} vs phase 7's {want_loss}")
            check(e_gnorm <= TOL_SP_GNORM, f"sp_a grad norms "
                  f"{res['gnorms']} vs phase 7's {want_gnorm}")
            _count_routed(kernels, _sp_counters(), _sp_counters(),
                          res["launched"], "sp_a")
            refs = {}
            for cell, cut in (("b3", linear_cut), ("b4", gla_cut)):
                refs[cell] = _sp_steps(cut, _sp_run(), layout,
                                       state_from_params(_sp_params(cut)),
                                       _sp_batches(cut, True))
                del refs[cell]["state"]
                _free()
        finally:
            dist.destroy_process_group()
    guard_cut = dataclasses.replace(linear, n_layers=RT_CUT_LAYERS)
    guard_ckpt = tempfile.mkdtemp(prefix="sp-guard-")
    try:
        ranks = run_ranks(_sp_rank, 2, backend="gloo", device="cuda",
                          args=(linear_cut, hybrid_cut, gla_cut, guard_cut,
                                guard_ckpt), timeout_s=900)
        _sp_guard_check(kernels, ranks, guard_cut, guard_ckpt)
    finally:
        import shutil
        shutil.rmtree(guard_ckpt, ignore_errors=True)
    for rank, res in enumerate(ranks):
        for cell in ("b1", "b2", "b3", "b4"):
            _count_routed(kernels, _sp_counters(), _sp_counters(),
                          res[cell]["launched"], f"sp_{cell}_rank{rank}")
        for cell, what in (("b3", "(2, 1) ZeRO-1"), ("b4", "(1, 2) GLA")):
            got, ref = res[cell], refs[cell]
            e_loss = max(_rel_errs(got["losses"], ref["losses"]))
            e_gnorm = max(_rel_errs(got["gnorms"], ref["gnorms"]))
            log(f"sp_{cell}", rank=rank, losses=repr(got["losses"]),
                losses_dp1sp1=repr(ref["losses"]),
                max_rel_err_loss=f"{e_loss:.3e}", tol_loss=TOL_SP_LAYOUT,
                grad_norms=repr(got["gnorms"]),
                grad_norms_dp1sp1=repr(ref["gnorms"]),
                max_rel_err_grad_norm=f"{e_gnorm:.3e}",
                tol_grad_norm=TOL_SP_GNORM)
            check(e_loss <= TOL_SP_LAYOUT,
                  f"{cell} rank {rank}: {what} losses {got['losses']} vs "
                  f"(1, 1) {ref['losses']}")
            check(e_gnorm <= TOL_SP_GNORM,
                  f"{cell} rank {rank}: {what} grad norms {got['gnorms']} "
                  f"vs (1, 1) {ref['gnorms']}")
    return ranks


# ---------------------------------------------------------------------------
# Phase 11: the exchange strategies and the paper's SP baselines.
# ---------------------------------------------------------------------------

# (a) one layer at full width, B 1 x H 16 x S 2·4096 x dh 128 in bf16, each
# of two ranks its chunk of 4096. |log a| ~ 1e-4 a token keeps the prefix
# state's weight near e^-0.4 across a chunk, so the exchange matters.
ST_H, ST_C, ST_D, ST_WINDOW = 16, 4096, 128, 2048


def _st_tape(name):
    """The tape counts a case of phase 11 (a) must show at W 2."""
    def pair(op, tag, bwd_op=None):
        return {f"{op} {tag}": 1, f"{bwd_op or op} {tag}.bwd": 1}
    if name.startswith("lasp2_allgather"):
        return {"all-gather lasp2.states": 1, "all-gather lasp2.dstates": 1}
    if name.startswith("lasp2_ring"):
        return pair("collective-permute", "lasp2.ring")
    if name.startswith("lasp2_pipelined"):
        return {k: n for i in range(4) for k, n in pair(
            "collective-permute", f"lasp2.pipelined[{i}]").items()}
    if name == "lasp1":
        return pair("collective-permute", "lasp1")
    if name.startswith("ulysses"):
        return {**pair("all-to-all", "ulysses.in"),
                **pair("all-to-all", "ulysses.out")}
    if name == "ring_attention":
        return {"collective-permute ring_attn.k": 2,
                "collective-permute ring_attn.v": 2,
                "collective-permute ring_attn.k.bwd": 1,
                "collective-permute ring_attn.v.bwd": 1}
    return {k: n for t in "qkv" for k, n in pair(
        "all-gather", f"megatron.{t}", "reduce-scatter").items()}


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _fwd_bwd(fn, xs, dout):
    """o and the gradients of sum(o · dout) wrt ``xs``."""
    leaves = [x.detach().requires_grad_(True) for x in xs]
    o = fn(*leaves)
    grads = torch.autograd.grad((o.float() * dout).sum(), leaves)
    return [o.detach(), *grads]


def _st_case(rank, name, fn, xs, dout, want, kernels):
    """One case of phase 11 (a) on this rank: ``fn`` on the chunks ``xs``
    forward and backward twice, the first call held to ``want`` (o, dq,
    dk, dv; relative L2 each, the phase 10 limit) with its launches and
    tape checked, the second timed."""
    from repro_torch.comm import primitives
    counters = _sp_counters()
    _zero(*counters)
    with primitives.tape() as rec:
        got = _fwd_bwd(fn, xs, dout)
    torch.cuda.synchronize()
    launched = _read(counters, counters)
    tape = _tape_counts(rec)
    t0 = time.perf_counter()
    _fwd_bwd(fn, xs, dout)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errs = [_rel_l2(g, w) for g, w in zip(got, want)]
    n = len(counters)
    log("strategies_a", rank=rank, case=name,
        rel_l2_o_dq_dk_dv=repr([f"{e:.2e}" for e in errs]), tol=TOL_SP_GRAD,
        launches_k1_k2a_k2b_k4_k5a_k5b_routed=repr(launched),
        tape=repr(tape).replace(" ", ""),
        wall_ms_gloo_host_transport=f"{wall * 1e3:.1f}")
    check(max(errs) <= TOL_SP_GRAD and all(
        bool(torch.isfinite(g).all()) for g in got),
        f"phase 11 rank {rank}: {name} off by {errs} relative L2")
    check(not any(launched[n + 1::2]) and all(
        launched[n::2][i] for i in kernels),
        f"phase 11 rank {rank}: {name} launches {launched}; want kernels "
        f"{kernels} on sm90 only")
    want_tape = _st_tape(name)
    check({k: c for k, (c, _) in tape.items()} == want_tape,
          f"phase 11 rank {rank}: {name} tape {tape}; want {want_tape}")
    return launched


def _st_layers(rank, sp):
    """Phase 11 (a): each linear strategy, both overlap orders, and LASP-1
    against one device's ``lasp2`` on the whole sequence; Ulysses (with
    and without a window), Ring Attention and Megatron-SP against
    ``allgather_context_attention`` (causal, no window, as the
    reference's baselines). Returns the launches summed over the cases."""
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core import baselines
    from repro_torch.core.lasp2 import SPConfig, lasp2
    from repro_torch.core.lasp2h import (allgather_context_attention,
                                         ulysses_context_attention)
    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (1, ST_H, 2 * ST_C, ST_D)
    rnd = lambda scale: (torch.randn(shape, generator=gen, device="cuda")
                         * scale).to(torch.bfloat16)
    q, k, v, dout = rnd(0.3), rnd(0.3), rnd(0.5), rnd(1.0)
    log_a = -torch.rand(shape[:-1], generator=gen, device="cuda") * 2e-4
    chunk = lambda x: x[:, :, rank * ST_C:(rank + 1) * ST_C]
    xs, d_c, la_c = [chunk(x) for x in (q, k, v)], chunk(dout).float(), \
        chunk(log_a)
    total = None

    def case(name, fn, want, kernels):
        nonlocal total
        got = _st_case(rank, name, fn, xs, d_c, want, kernels)
        total = got if total is None else [a + b for a, b in zip(total, got)]

    want = [chunk(t) for t in _fwd_bwd(lambda a, b, c: lasp2(a, b, c, log_a),
                                       (q, k, v), dout.float())]
    for strategy in ("allgather", "ring", "pipelined"):
        for overlap in ("overlap", "none"):
            case(f"lasp2_{strategy}_{overlap}", lambda a, b, c, s=SPConfig(
                sp.group, comm=CommSpec(strategy, overlap)): lasp2(
                    a, b, c, la_c, sp=s), want, (0, 1, 2))
    case("lasp1", lambda a, b, c: baselines.lasp1(a, b, c, la_c, sp=sp),
         want, (0, 1, 2))
    spu = SPConfig(sp.group, comm=CommSpec("ulysses"))
    want = _fwd_bwd(lambda a, b, c: allgather_context_attention(
        a, b, c, sp=sp), xs, d_c)
    case("ulysses", lambda a, b, c: ulysses_context_attention(
        a, b, c, sp=spu), want, (3, 4, 5))
    case("ring_attention", lambda a, b, c: baselines.ring_attention(
        a, b, c, sp=sp), want, ())
    case("megatron_sp", lambda a, b, c: baselines.megatron_sp_attention(
        a, b, c, sp=sp), want, (3, 4, 5))
    want = _fwd_bwd(lambda a, b, c: allgather_context_attention(
        a, b, c, sp=sp, sliding_window=ST_WINDOW), xs, d_c)
    case("ulysses_window", lambda a, b, c: ulysses_context_attention(
        a, b, c, sp=spu, sliding_window=ST_WINDOW), want, (3, 4, 5))
    return total


def _st_cell(rank, path, cfg, layout, resets, strategy, base):
    """Phase 11 (b): SP_STEPS steps of the DP×SP step under ``strategy``
    on phase 10's params and data of the same cut, against that cell's
    run under "allgather" (``base``): losses 2e-4, grad norms 2^-8
    relative; launches and tape per step."""
    from repro_torch.train.step import state_from_params
    res = _sp_steps(cfg, _sp_run(comm_strategy=strategy), layout,
                    state_from_params(_sp_params(cfg)),
                    _sp_batches(cfg, resets))
    del res["state"]
    n_lin, n_soft = _mixer_counts(cfg)
    want = _want_launches(n_lin, n_lin, n_soft)      # autodiff backwards
    check(all(n == want for n in res["per_step"]),
          f"{path} rank {rank}: launches per step {res['per_step']}; want "
          f"{want}")
    if strategy == "ring":
        tags = {"collective-permute lasp2.ring": n_lin}
    else:
        tags = {"all-gather lasp2.states": n_lin,
                "all-to-all ulysses.in": n_soft,
                "all-to-all ulysses.out": n_soft}
    want_tape = {"all-reduce train.grads": 1, **tags, **{
        (f"reduce-scatter {k.split()[1]}" if k.startswith("all-gather")
         else k) + ".bwd": n for k, n in tags.items()}}
    for tape in res["tapes"]:
        check({k: v[0] for k, v in tape.items()} == want_tape,
              f"{path} rank {rank}: tape {tape}; want counts {want_tape}")
    e_loss = max(_rel_errs(res["losses"], base["losses"]))
    e_gnorm = max(_rel_errs(res["gnorms"], base["gnorms"]))
    log(path, rank=rank, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        softmax=n_soft, dp=layout.dp, sp=layout.sp, strategy=strategy,
        rows_x_chunk=f"{SP_ROWS}x{SP_SEQ // layout.sp}", resets=resets,
        losses=repr([round(x, 6) for x in res["losses"]]),
        allgather_losses=repr([round(x, 6) for x in base["losses"]]),
        max_rel_err_loss=f"{e_loss:.3e}", tol_loss=TOL_SP_LAYOUT,
        grad_norms=repr([round(x, 6) for x in res["gnorms"]]),
        allgather_grad_norms=repr([round(x, 6) for x in base["gnorms"]]),
        max_rel_err_grad_norm=f"{e_gnorm:.3e}", tol_grad_norm=TOL_SP_GNORM,
        launches_per_step_k1_k2a_k2b_k4_k5a_k5b_routed=repr(
            res["per_step"][0]),
        tape_per_step=repr(res["tapes"][0]).replace(" ", ""),
        transport="gloo (host-staged)",
        step_wall_ms=repr([round(w * 1e3, 1) for w in res["walls"]]),
        max_memory_allocated_gb=f"{res['peak'] / 1e9:.2f}")
    check(e_loss <= TOL_SP_LAYOUT, f"{path} rank {rank}: losses "
          f"{res['losses']} vs allgather {base['losses']}")
    check(e_gnorm <= TOL_SP_GNORM, f"{path} rank {rank}: grad norms "
          f"{res['gnorms']} vs allgather {base['gnorms']}")
    return res["launched"]


def _st_rank(rank, world, device, linear_cut, hybrid_cut, bases):
    """Phase 11 on one of two ranks sharing the card over gloo: (a) the
    layer cases, (b) the ulysses and ring steps against phase 10's b1 and
    b2 (``bases[rank]``)."""
    from repro_torch.core.lasp2 import SPConfig
    from repro_torch.launch.mesh import make_training_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    layout = make_training_groups(1, 2)
    out = {"a": _st_layers(rank, SPConfig(layout.sp_group))}
    _free()
    out["ulysses"] = _st_cell(rank, "strategies_ulysses", hybrid_cut,
                              layout, True, "ulysses", bases[rank]["b1"])
    _free()
    out["ring"] = _st_cell(rank, "strategies_ring", linear_cut, layout,
                           False, "ring", bases[rank]["b2"])
    return out


def phase_strategies(kernels: list, linear, hybrid, sp_ranks) -> None:
    """Phase 11 on two ranks sharing the card over gloo, as phase 10 (b):
    (a) one full-width layer under each exchange and baseline against its
    one-device or all-gather counterpart, (b) 3 steps of the DP×SP step
    at (1, 2) under "ulysses" (``HYBRID`` cut) and "ring" (``CONFIG``
    cut) against phase 10's b1 and b2."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(
        _st_rank, 2, backend="gloo", device="cuda",
        args=(dataclasses.replace(linear, n_layers=SP_LAYERS),
              dataclasses.replace(hybrid, n_layers=SP_LAYERS),
              [{c: {k: r[c][k] for k in ("losses", "gnorms")}
                for c in ("b1", "b2")} for r in sp_ranks]),
        timeout_s=600)
    for rank, res in enumerate(ranks):
        for cell, launched in res.items():
            _count_routed(kernels, _sp_counters(), _sp_counters(), launched,
                          f"strategies_{cell}_rank{rank}")
    log("strategies", ranks=len(ranks), transport="gloo (host-staged)",
        wall_s=f"{time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------------
# Phase 12: the paper's Linear-Llama3 variants (paper §4, Tables 2-3).
# ---------------------------------------------------------------------------

BIDIR_ROWS, BIDIR_STEPS, MASK_ID = 4, 3, 0
BIDIR_LR = 1e-3      # Table 3's (table3_bidirectional.py), no warm-up


def _mlm_batch(vocab, step, seed=0):
    """Table 3's masked-token batch (``benchmarks/table3_bidirectional.py``
    ``_mlm_batch``) at BIDIR_ROWS x TRAIN_SEQ: skewed tokens, 15% of them
    become ``MASK_ID``, every other label is -1."""
    rng = np.random.default_rng([seed, step])
    u = rng.random((BIDIR_ROWS, TRAIN_SEQ))
    tokens = np.minimum((vocab * u ** 4).astype(np.int64), vocab - 1)
    mask = rng.random((BIDIR_ROWS, TRAIN_SEQ)) < 0.15
    return np.where(mask, MASK_ID, tokens), np.where(mask, tokens, -1)


def table3_step(params, opt, leaves, cfg, step, lr):
    """One step of Table 3's loop on ``_mlm_batch(step)``, in place on
    ``params``: ``(new opt state, loss, grad norm before clipping)``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    inp, labels = (torch.as_tensor(x, device="cuda")
                   for x in _mlm_batch(cfg.vocab_size, step))
    loss = M.lm_loss(M.forward(params, inp, cfg, causal=False), labels)
    it = iter(torch.autograd.grad(loss, leaves))
    grads, norm = adamw.clip_by_global_norm(
        tree_map(lambda _: next(it), params), 1.0)
    opt = adamw.update(grads, opt, params, lr=lr, weight_decay=0.1)
    return opt, float(loss.detach()), float(norm)


def phase_bidir_train(kernels: list, cfg, path: str) -> None:
    """BIDIR_STEPS steps of Table 3's loop (``table3_bidirectional.py``
    ``step_fn``): forward with ``causal=False``, ``lm_loss`` over the
    masked tokens, clip to 1.0, AdamW (lr ``BIDIR_LR``, weight decay 0.1)
    from ``optim/adamw.py``; fp32 masters from seed 0, bf16 compute, full
    width and depth, 4 x 2048 tokens a step. Softmax layers launch K4, K5a
    and K5b unmasked on ``sm90``; linear layers (Alg. 1: two products)
    launch no kernel. Every loss is finite."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    n_lin, n_soft = _mixer_counts(cfg)
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, param_dtype="float32")
    opt = adamw.init(params)
    leaves = [p.requires_grad_(True) for _, p in leaves_with_paths(params)]
    counters = _sp_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(*counters)
    losses, gnorms, walls, marks = [], [], [], []
    for step in range(BIDIR_STEPS):
        t0 = time.perf_counter()
        opt, loss, norm = table3_step(params, opt, leaves, cfg, step,
                                      BIDIR_LR)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(norm)
        marks.append(_read(counters, counters))
    peak = torch.cuda.max_memory_allocated()
    per_step = [[b - a for a, b in zip(prev, cur)]
                for prev, cur in zip([[0] * len(marks[0])] + marks, marks)]
    want = _want_launches(0, 0, n_soft)
    check(all(np.isfinite(losses)), f"{path}: non-finite loss {losses}")
    check(all(n == want for n in per_step),
          f"{path}: launches per step of K1, K2a, K2b, K4, K5a, K5b, then "
          f"each sm90/simt {per_step}; want {want}")
    _count_routed(kernels, counters, counters, marks[-1], path)
    p50 = float(np.median(walls[1:]))
    log(path, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        softmax=n_soft, causal=False, feature_map=cfg.linear_attn.feature_map
        if n_lin else "none", objective="masked tokens 15% (Table 3)",
        steps=BIDIR_STEPS, batch=f"{BIDIR_ROWS}x{TRAIN_SEQ}",
        losses=repr([round(x, 4) for x in losses]),
        grad_norms=repr([round(x, 4) for x in gnorms]),
        launches_per_step_k1_k2a_k2b_k4_k5a_k5b_routed=repr(per_step[0]),
        step_wall_ms=repr([round(w * 1e3, 1) for w in walls]),
        step_p50_ms=f"{p50 * 1e3:.1f}",
        tokens_per_s=f"{BIDIR_ROWS * TRAIN_SEQ / p50:.0f}",
        max_memory_allocated_gb=f"{peak / 1e9:.2f}")


def phase_variants(kernels: list, gla, elu1, dense) -> None:
    """Phase 12, the paper's variants at full width, built in code as
    Table 2 builds them: (b) the GLA model (``gla``: silu feature map,
    data-dependent decay through ``wdt``) serving phase 4's eight
    requests, with phase 4's decode check; (c) 5 steps
    of GLA training as phase 7 trains, at lr 1e-4;
    (d) fp32 grad checks of 2 layers of ``gla`` (``wdt``'s gradient among
    the leaves) and of 2 layers each of ``elu1`` and ``dense`` under
    ``causal=False``; (e) Table 3's bidirectional training on ``dense``
    and ``elu1``. (a), the kernel cases, ran in phase 3: the "gla" log a
    through K1, K2a, K2b and K3 on both routes, and the 2048-key
    bidirectional flash case."""
    t0 = time.perf_counter()
    params = phase_serve(kernels, gla, "gla_serve")
    phase_profile(gla, params, "gla_serve", 4, 512, [0, 40, 100, 200])
    del params
    _free()
    # At phase 7's 3e-4 GLA's fifth step throws the loss up, in bf16 on
    # sm90 and in fp32 on simt alike (scripts/variant_lr_probe.py), and
    # the port's steps follow the reference's at that rate
    # (tests/test_torch_variants.py): the model's own dynamics at full
    # width, not a kernel's. 1e-4 trains it.
    phase_train(kernels, gla, "gla_train", steps=5, lr=1e-4)
    _free()
    for cfg, path, causal in ((gla, "gla_gradcheck", True),
                              (elu1, "bidir_elu1_gradcheck", False),
                              (dense, "bidir_dense_gradcheck", False)):
        phase_grad_check(kernels, dataclasses.replace(
            cfg, n_layers=2, dtype="float32"), path, causal=causal)
        _free()
    for cfg, path in ((dense, "bidir_dense_train"),
                      (elu1, "bidir_elu1_train")):
        phase_bidir_train(kernels, cfg, path)
        _free()
    log("variants", wall_s=f"{time.perf_counter() - t0:.1f}")


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 13: the SSM family, mamba2-2.7b and hymba-1.5b.
# ---------------------------------------------------------------------------

# The SSD heads' shapes at the kernels: (BH, dk = d_state, dv = headdim,
# heads): mamba2's 4 rows x 80 heads, hymba's 4 rows x 25 heads.
SSD_SHAPES = {"mamba2": (4 * 80, 128, 64, 80), "hymba": (4 * 25, 16, 64, 25)}
SSD_CHUNK_CASES = [("mamba2", torch.bfloat16, 512),
                   ("mamba2", torch.bfloat16, 2048),
                   ("hymba", torch.bfloat16, 2048),
                   ("hymba", torch.float32, 2048)]
# The reference's init_cache sizes at 4 slots (max_len 544; mamba2's the
# same at 4096), for mamba2 at its 64 layers; each layer holds 1/64.
MAMBA2_CACHE = {"linear_state": 671_170_560, "conv": 8_257_536}
# Phase 13 serves and trains mamba2 cut to 32 of its 64 layers and hymba
# to 24 of its 32, at full width, to keep the script inside its time
# limit (at full depth their serving and training took 75 and 71 s;
# PERF.md §6). Every layer holds the same cache bytes. Both stay deeper
# than 16 layers, where the decode check's deep limit starts.
MAMBA2_LAYERS, HYMBA_LAYERS = 32, 24
HYMBA_CACHE = {"kv_ring": 89_407_488, "linear_state": 13_120_000,
               "conv": 1_253_376}         # at hymba's 32 layers
SSM_TRAIN_STEPS = 5
# At phase 7's 3e-4 both models' fourth step throws the loss up (mamba2
# 16.18, hymba 20.03), in bf16 and in fp32 on simt alike
# (scripts/variant_lr_probe.py --arch ...), and at SMOKE the port's steps
# follow the reference's at 3e-4 and at a d_model·lr-matched 1e-2
# (tests/test_torch_mamba2.py, tests/test_torch_hymba.py): the models'
# own dynamics at full width, not a kernel's. 1e-4 trains both.
SSM_TRAIN_LR = 1e-4
# Without remat hymba's 32 layers keep ~2.3 GB of activations each a
# microbatch (phase 7's layers keep 37 GB over 16) beside 22.3 GB of
# masters, gradients and moments: ~96 GB, above the card's 80. Full remat
# keeps each layer's input only: ~30 GB predicted (PERF.md §6).
HYMBA_REMAT = "full"


def _note(kernels, name, err, case=None) -> None:
    """Fold a phase-13 case into a kernel entry: its worst error and, where
    timed, its timing at an SSD or hymba shape under ``ssm_cases``."""
    entry = next(k for k in kernels if k["name"] == name)
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if case is not None:
        entry.setdefault("ssm_cases", []).append(case)


def _timed_case(shape, ms, plain_ms, bound, library_ms=None):
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def _ssm_chunk_cases(kernels, gen, failures) -> None:
    """K1, K2a and K2b at the SSD shapes on SSD's log a (``_ssd_log_a``,
    down to about −8 a token, a reset mid-chunk) against the plain
    versions, under phase 3's limits: mamba2's (128, 64) in bf16 on
    ``sm90`` at S 512 and 2048, hymba's (16, 64) on ``simt`` in bf16 and
    fp32 at S 2048; each timed beside its plain version and bound."""
    from repro_torch.core.linear_attention import pick_block
    from repro_torch.kernels import lasp2_chunk as lc
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd,
                                                 lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dkv_plain,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_bwd_dq_plain,
                                                 lasp2_chunk_bwd_plain,
                                                 lasp2_chunk_fwd,
                                                 lasp2_chunk_fwd_plain)
    passes = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    fwd = lambda q, k, v, la, *_: lasp2_chunk_fwd(q, k, v, la)
    fwd_p = lambda q, k, v, la, *_: lasp2_chunk_fwd_plain(q, k, v, la)
    dq = lambda q, k, v, la, o, do, dst: lasp2_chunk_bwd_dq(k, v, la, do)
    dq_p = lambda q, k, v, la, o, do, dst: lasp2_chunk_bwd_dq_plain(
        k, v, la, do)
    dkv = lambda *a: lasp2_chunk_bwd_dkv(*a)
    for model, dtype, s in SSD_CHUNK_CASES:
        bh, dk, dv, nh = SSD_SHAPES[model]
        name = str(dtype).split(".")[-1]
        route = lc._route(dtype, dk, dv)
        sets = [_bwd_inputs(gen, bh, s, dk, dtype, "ssd", dv=dv, nh=nh)
                for _ in range(2)]
        q, k, v, la, o_in, do, dst = sets[0]
        before = [fn.route_launches[route] for fn in passes]
        o, st, ld = lasp2_chunk_fwd(q, k, v, la)
        got = lasp2_chunk_bwd(q, k, v, la, o_in, do, dst)
        torch.cuda.synchronize()
        launched = [fn.route_launches[route] - n
                    for fn, n in zip(passes, before)]
        block = pick_block(s, 128)
        o_p, st_p, ld_p = lasp2_chunk_fwd_plain(q, k, v, la,
                                                block_size=block)
        want = lasp2_chunk_bwd_plain(q, k, v, la, o_in, do, dst,
                                     block_size=block)
        errs, oks = {}, []
        for key, g, w, tol in (("o", o, o_p, TOL_O[name]),
                               ("state", st, st_p, TOL_STATE),
                               ("log_decay", ld, ld_p, TOL_LD),
                               ("dq", got[0], want[0], TOL_GRAD[name]),
                               ("dk", got[1], want[1], TOL_GRAD[name]),
                               ("dv", got[2], want[2], TOL_GRAD[name])):
            errs[key], good = max_err_within(g, w, tol)
            oks.append(good)
        slack = s * 2.0 ** -24 * float(want[3].abs().max())
        diff = (got[3] - want[3]).abs()
        errs["dla"] = float(diff.max())
        oks.append(bool((diff <= 1e-3 + slack + 1e-3 * want[3].abs()).all())
                   and bool(torch.isfinite(got[3]).all()))
        want_route = "sm90" if model == "mamba2" else "simt"
        ok = all(oks) and route == want_route and launched == [1, 1, 1] \
            and o.dtype == dtype
        share_o = limit_share(o, o_p, TOL_O[name])
        del o, st, ld, got, o_p, st_p, ld_p, want
        shape = f"BH{bh}xS{s}x{dk}x{dv} {name} ssd"
        n = 20 if route == "sm90" else 5
        k1_bound = _chunk_bound(bh, s, dk, dv, dtype)
        a_bound, b_bound = _bwd_bounds(bh, s, dk, dv, dtype)
        timed = {}
        for kname, fn, fn_p, bound in (
                ("lasp2_chunk_fwd", fwd, fwd_p, k1_bound),
                ("lasp2_chunk_bwd_dq", dq, dq_p, a_bound),
                ("lasp2_chunk_bwd_dkv", dkv, lasp2_chunk_bwd_dkv_plain,
                 b_bound)):
            timed[kname] = (time_ms(fn, sets, n), time_ms(fn_p, sets, 3),
                            bound)
        del sets
        torch.cuda.empty_cache()
        log("ssm_kernels", kernel="lasp2_chunk", model=model,
            shape=repr(shape), route=route, launches_k1_k2a_k2b=launched,
            **{f"err_{k}": f"{v:.3e}" for k, v in errs.items()},
            tol_o=TOL_O[name], tol_grads=TOL_GRAD[name],
            dla_slack=f"{slack:.2e}",
            share_of_limit_o=f"{share_o:.3f}",
            **{f"{kn}_ms": f"{t[0]:.4f}" for kn, t in timed.items()},
            **{f"{kn}_plain_ms": f"{t[1]:.4f}" for kn, t in timed.items()},
            **{f"{kn}_bound_ms": f"{t[2][0]:.4f}"
               for kn, t in timed.items()}, ok=ok)
        if not ok:
            failures.append(f"lasp2_chunk {model} {name} S={s}")
        for kname, key_errs in (("lasp2_chunk_fwd", ("o", "state",
                                                     "log_decay")),
                                ("lasp2_chunk_bwd_dq", ("dq",)),
                                ("lasp2_chunk_bwd_dkv", ("dk", "dv",
                                                         "dla"))):
            ms, plain, bound = timed[kname]
            _note(kernels, f"{kname}_{route}",
                  max(errs[k] for k in key_errs),
                  _timed_case(shape, ms, plain, bound))


def _ssm_decode_cases(kernels, gen, failures) -> None:
    """K3 at the SSD shapes: 8 steps chained from a K1 prefill state on
    SSD's log a (a reset at step 3 for half the rows), on each route,
    against ``recurrent_step``; timed on ``sm90`` over states rotating
    above the 50 MB L2."""
    from repro_torch.core.linear_attention import RESET_LOG_A
    from repro_torch.kernels import lasp2_decode as ldm
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    step, plain = ldm.lasp2_decode_step, ldm.lasp2_decode_step_plain
    bf16 = torch.bfloat16
    for model, (bh, dk, dv, nh) in SSD_SHAPES.items():
        q, k, v, la = _chunk_inputs(gen, bh, 512, dk, bf16, "ssd", dv, nh)
        _, st0, ld0 = lasp2_chunk_fwd(q, k, v, la)
        steps = []
        for i in range(8):
            qs, ks = ((torch.randn(bh, dk, generator=gen, device="cuda")
                       * 0.3).to(bf16) for _ in range(2))
            vs = (torch.randn(bh, dv, generator=gen, device="cuda")
                  * 0.5).to(bf16)
            las = _ssd_log_a(gen, bh, 1, nh)[:, 0].contiguous()
            if i == 3:
                las[: bh // 2] = RESET_LOG_A
            steps.append((qs, ks, vs, las))
        err = {}
        for route in ldm.ROUTES:
            st_k, ld_k = st0.clone(), ld0.clone()
            st_p, ld_p = st0.clone(), ld0.clone()
            before = dict(step.route_launches)
            e_o, ok = 0.0, True
            for qs, ks, vs, las in steps:
                o_k, st_k, ld_k = step(qs, ks, vs, las, st_k, ld_k,
                                       route=route)
                o_p, st_p, ld_p = plain(qs, ks, vs, las, st_p, ld_p)
                e, good = max_err_within(o_k, o_p, TOL_O["float32"])
                e_o, ok = max(e_o, e), ok and good
            torch.cuda.synchronize()
            e_s, ok_s = max_err_within(st_k, st_p, TOL_STATE)
            e_l, ok_l = max_err_within(ld_k, ld_p, TOL_LD)
            launched = {r: step.route_launches[r] - before[r]
                        for r in before}
            ok = ok and ok_s and ok_l and launched == {
                r: 8 * (r == route) for r in before}
            ok = ok and (route == "simt"
                         or ldm._route(bf16, dk, dv) == "sm90")
            err[route] = max(e_o, e_s, e_l)
            log("ssm_kernels", kernel=f"lasp2_decode_step_{route}",
                model=model, steps=8, BH=bh, dk=dk, dv=dv, log_a="ssd+reset",
                err_o=f"{e_o:.3e}", tol_o=TOL_O["float32"],
                err_state=f"{e_s:.3e}", tol_state=TOL_STATE,
                err_log_decay=f"{e_l:.3e}", ok=ok)
            if not ok:
                failures.append(f"lasp2_decode_step_{route} {model} ssd")
        # states rotating above the 50 MB L2
        n_sets = max(16, int(np.ceil(64e6 / (bh * dk * dv * 4))))
        dec_sets = [(*steps[i % 8][:3], steps[i % 8][3], st0.clone(),
                     ld0.clone()) for i in range(n_sets)]
        fn = lambda *a: step(*a, route="sm90")
        ms, dev = time_ms(fn, dec_sets, 400), device_ms(fn, dec_sets, 100)
        plain_ms = time_ms(lambda *a: plain(*a), dec_sets, 100)
        bound = _decode_bound(bh, dk, dv, 2)
        shape = f"BH{bh}x{dk}x{dv} bf16 ssd"
        log("ssm_kernels", kernel="lasp2_decode_step_sm90", model=model,
            shape=repr(shape), ms=f"{ms:.4f}", device_ms=f"{dev:.5f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound[0]:.5f}",
            bound_by=bound[1], states=n_sets)
        case = _timed_case(shape, ms, plain_ms, bound)
        case["device_ms"] = dev
        _note(kernels, "lasp2_decode_step_sm90", err["sm90"], case)
        _note(kernels, "lasp2_decode_step_simt", err["simt"])
        del dec_sets, steps
        torch.cuda.empty_cache()


def _ssm_flash_times(kernels, gen) -> None:
    """K4, K5a and K5b at hymba's attention shape in bf16 on ``sm90`` (B 4
    x Hq 25 x Hkv 5 x S 2048 x dh 64; window 1024, then global), beside the
    plain versions and bounds, and the SDPA forward and backward on K/V
    repeated to 25 heads (the library yardstick: ``is_causal`` for the
    global case, the boolean band mask for the window). Their parity ran
    in phase 3
    (``FLASH_CASES`` "hymba", "hymba_global")."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl
    b, hq, hkv, s, dh, dtype = 4, 25, 5, 2048, 64, torch.bfloat16
    route = fl._route(dtype, dh)
    for window in (1024, None):
        kw = dict(causal=True, window=window)
        mask = fl._mask(s, s, 0, s, True, window, "cuda")
        pairs = b * hq * int(mask.sum())
        sets = []
        for _ in range(2):
            q, k, v, do = _flash_inputs(gen, b, hq, hkv, s, s, dh, dtype)
            o, lse = fl.flash_attention_fwd(q, k, v, **kw)
            sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
        rep = lambda x: x.repeat_interleave(hq // hkv, dim=1)
        sdpa_sets = [(q, rep(k), rep(v), do) for q, k, v, do, *_ in sets]
        sdpa_kw = dict(is_causal=True) if window is None else \
            dict(attn_mask=mask)
        sdpa = lambda q, k, v, *_: F.scaled_dot_product_attention(
            q, k, v, **sdpa_kw)
        graphs = []
        for q, k, v, do in sdpa_sets:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            graphs.append((sdpa(*leaves), leaves, do))
        lib = (time_ms(sdpa, sdpa_sets, 10),
               time_ms(lambda o, leaves, do: torch.autograd.grad(
                   o, leaves, do, retain_graph=True), graphs, 10))
        del sdpa_sets, graphs
        bounds = _flash_bounds(b, hq, hkv, s, s, dh, dtype, pairs)
        shape = f"B{b}xHq{hq}xHkv{hkv}xS{s}x{dh} bf16 causal window {window}"
        for i, (kname, fn, fn_p) in enumerate((
                ("flash_attention_fwd",
                 lambda q, k, v, *_: fl.flash_attention_fwd(q, k, v, **kw),
                 lambda q, k, v, *_: fl.flash_attention_fwd_plain(
                     q, k, v, **kw)),
                ("flash_attention_bwd_dq",
                 lambda *a: fl.flash_attention_bwd_dq(*a, **kw),
                 lambda *a: fl.flash_attention_bwd_dq_plain(*a, **kw)),
                ("flash_attention_bwd_dkv",
                 lambda *a: fl.flash_attention_bwd_dkv(*a, **kw),
                 lambda *a: fl.flash_attention_bwd_dkv_plain(*a, **kw)))):
            ms, plain = time_ms(fn, sets, 10), time_ms(fn_p, sets, 2)
            library = lib[0] if i == 0 else lib[1]
            log("ssm_kernels", kernel=f"{kname}_{route}", model="hymba",
                shape=repr(shape), ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                bound_ms=f"{bounds[i][0]:.4f}", bound_by=bounds[i][1],
                sdpa_ms=f"{library:.4f}", pairs=pairs)
            _note(kernels, f"{kname}_{route}", 0.0,
                  _timed_case(shape, ms, plain, bounds[i], library))
        del sets
        torch.cuda.empty_cache()


def phase_ssm_kernels(kernels: list) -> None:
    """Phase 13 (a): the kernels at the SSM family's shapes against their
    plain versions, timed (``_ssm_chunk_cases``, ``_ssm_decode_cases``,
    ``_ssm_flash_times``); hymba's flash cases are checked in phase 3."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    failures = []
    _ssm_chunk_cases(kernels, gen, failures)
    _ssm_decode_cases(kernels, gen, failures)
    check(not failures, "kernel parity failed: " + ", ".join(failures))
    _ssm_flash_times(kernels, gen)


def phase_ssm(kernels: list, mamba2, hymba) -> None:
    """Phase 13, the SSM family at full width: (a) the kernels at its
    shapes; (b) mamba2-2.7b (``MAMBA2_LAYERS`` of its 64 layers, bf16)
    serves phase 4's eight requests by left-padded buckets (K1 and K3 a
    layer a prefill batch and a decode step, all ``sm90``; cache bytes
    the reference's, per layer) with phase 4's decode check; (c)
    hymba-1.5b (``HYMBA_LAYERS`` of its 32 layers, globals 0, 8, 16) the
    same by exact length (K1 on ``simt``, K4 and K3 a layer a call), and
    the decode check again on a 1100-token prompt, past the 1024 window,
    with rings 1280 long; (d) both train 5 steps as phase 7
    (mamba2 under full remat, hymba under ``HYMBA_REMAT``), at
    ``SSM_TRAIN_LR``; (e) fp32 grad checks of 2 layers of each against
    the host CPU (hymba: its global and a windowed layer, 1280
    tokens)."""
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    walls = {}

    def part(name):
        walls[name] = round(time.perf_counter() - t0 - sum(walls.values()),
                            1)

    phase_ssm_kernels(kernels)
    part("a")
    _free()
    mamba2 = dataclasses.replace(mamba2, n_layers=MAMBA2_LAYERS)
    params = phase_serve(kernels, mamba2, "mamba2_serve", want_cache={
        k: v * MAMBA2_LAYERS // 64 for k, v in MAMBA2_CACHE.items()})
    phase_profile(mamba2, params, "mamba2_serve", 4, 512, [0, 40, 100, 200])
    del params
    _free()
    part("b")
    hymba = dataclasses.replace(hymba, n_layers=HYMBA_LAYERS)
    flags = M.hymba_global_flags(hymba)
    global_layers = [i for i, f in enumerate(flags) if f]
    check(global_layers == [0, 8, 16],
          f"hymba global layers {global_layers}")
    log("hymba_serve", global_layers=global_layers,
        window=hymba.pattern[1].sliding_window)
    params = phase_serve(kernels, hymba, "hymba_serve", want_cache={
        k: v * HYMBA_LAYERS // 32 for k, v in HYMBA_CACHE.items()})
    phase_profile(hymba, params, "hymba_serve", 1, 300, None)
    # past the 1024 window: the windowed layers trim, the global ones not
    rng = np.random.default_rng(1)
    phase_decode_check(params, hymba, "hymba_long_decode",
                           rng.integers(0, hymba.vocab_size, size=1100),
                           rng.integers(0, hymba.vocab_size, size=8), 1280)
    del params
    _free()
    part("c")
    phase_train(kernels, mamba2, "mamba2_train", steps=SSM_TRAIN_STEPS,
                lr=SSM_TRAIN_LR, remat="full")
    _free()
    phase_train(kernels, hymba, "hymba_train", steps=SSM_TRAIN_STEPS,
                lr=SSM_TRAIN_LR, remat=HYMBA_REMAT)
    _free()
    part("d")
    phase_grad_check(kernels, dataclasses.replace(
        mamba2, n_layers=2, dtype="float32"), "mamba2_gradcheck")
    _free()
    phase_grad_check(kernels, dataclasses.replace(
        hymba, pattern=hymba.pattern[:2], n_layers=2, dtype="float32"),
        "hymba_gradcheck", tokens=1280)
    _free()
    part("e")
    log("ssm", wall_s=f"{time.perf_counter() - t0:.1f}",
        part_walls_s=repr(walls))


# ---------------------------------------------------------------------------
# Phase 14: the decoder-only zoo and MoE.
# ---------------------------------------------------------------------------

ZOO_ARCHS = {"codeqwen1.5-7b": "codeqwen", "qwen1.5-110b": "qwen110b",
             "granite-34b": "granite", "starcoder2-15b": "starcoder2",
             "moonshot-v1-16b-a3b": "moonshot",
             "phi3.5-moe-42b-a6.6b": "phi_moe"}
ZOO_LAYERS = 2
ZOO_TRAIN_STEPS = 3
# Phase 13's rate: at phase 7's 3e-4 codeqwen's third loss jumped from
# 12.24 to 36.26 (d_model·lr 1.23, above the 0.77 at which phase 13's
# models already spiked; PERF.md §6, PR 23).
ZOO_TRAIN_LR = SSM_TRAIN_LR
# qwen1.5-110b's two embeddings alone hold 2.49 B parameters: at 2 layers
# its fp32 masters, gradients and two moments (16 B a parameter) would be
# 83 GB, above the card's 80. It trains at 1 layer (3.85 B parameters,
# 61.6 GB of state) under full remat on one microbatch of 2 x 2048 (the
# microbatch is cut, never the width).
ZOO_TRAIN_CUT = {"qwen1.5-110b": dict(layers=1, batch=2, micro=1,
                                      remat="full")}
# At ``CONFIG`` capacity: phase 4's first 4 prompts on 4 slots, 8 new
# tokens, in fp32 on the card and on the host CPU.
MOE_CAP_REQUESTS, MOE_CAP_NEW = 4, 8


def _zoo_cut(cfg, layers=ZOO_LAYERS):
    return dataclasses.replace(cfg, n_layers=layers)


def _drop_free(cfg):
    """An MoE config's copy at capacity factor E/k, where every expert has
    room for every token (the reference's SMOKEs' setting); other configs
    as they are."""
    if cfg.moe is None:
        return cfg
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))


def _flash_times(kernels, gen, cases, path: str, key: str) -> None:
    """K4, K5a and K5b in bf16 on ``sm90`` at each of ``cases`` ((case,
    B, Hq, Hkv, Sq, Sk, dh, causal): shapes a main path runs), with the
    default query offset Sk − Sq: held to their plain versions on the
    first input set within phase 3's limits (``_flash_check``; the worst
    error joins each entry's ``max_abs_err``), then timed beside the plain
    versions, the bounds (over this mask's valid (query, key) pairs) and
    the SDPA forward and backward with K/V repeated to Hq heads (the
    library yardstick). Each timing joins its entry's ``key`` list."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl
    dtype = torch.bfloat16
    failures = []
    for what, b, hq, hkv, sq, sk, dh, causal in cases:
        kw = dict(causal=causal)
        route = fl._route(dtype, dh)
        pairs = b * hq * int(fl._mask(sq, sk, sk - sq, sk, causal, None,
                                      "cuda").expand(sq, sk).sum())
        sets = []
        for _ in range(2):
            q, k, v, do = _flash_inputs(gen, b, hq, hkv, sq, sk, dh, dtype)
            o, lse = fl.flash_attention_fwd(q, k, v, **kw)
            sets.append((q, k, v, do, lse, (do.float() * o.float()).sum(-1)))
        shape = (f"B{b}xHq{hq}xHkv{hkv}xSq{sq}xSk{sk}x{dh} bf16 "
                 f"{'causal' if causal else 'unmasked'}")
        _, e, tols, ok = _flash_check(*sets[0][:4], dh, dtype, kw)
        torch.cuda.empty_cache()
        log(path, kernel="flash_attention", case=what, shape=repr(shape),
            route=route, **{f"err_{t}": f"{x:.3e}" for t, x in e.items()},
            **tols, ok=ok)
        if not ok:
            failures.append(f"flash {what} {shape}")
        rep = lambda x: x.repeat_interleave(hq // hkv, dim=1)
        sdpa_sets = [(q, rep(k), rep(v), do) for q, k, v, do, *_ in sets]
        sdpa = lambda q, k, v, *_: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        graphs = []
        for q, k, v, do in sdpa_sets:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            graphs.append((sdpa(*leaves), leaves, do))
        lib = (time_ms(sdpa, sdpa_sets, 10),
               time_ms(lambda o, leaves, do: torch.autograd.grad(
                   o, leaves, do, retain_graph=True), graphs, 10))
        del sdpa_sets, graphs
        bounds = _flash_bounds(b, hq, hkv, sq, sk, dh, dtype, pairs)
        for i, (kname, fn, fn_p, err) in enumerate((
                ("flash_attention_fwd",
                 lambda q, k, v, *_: fl.flash_attention_fwd(q, k, v, **kw),
                 lambda q, k, v, *_: fl.flash_attention_fwd_plain(
                     q, k, v, **kw), max(e["o"], e["lse"])),
                ("flash_attention_bwd_dq",
                 lambda *a: fl.flash_attention_bwd_dq(*a, **kw),
                 lambda *a: fl.flash_attention_bwd_dq_plain(*a, **kw),
                 e["dq"]),
                ("flash_attention_bwd_dkv",
                 lambda *a: fl.flash_attention_bwd_dkv(*a, **kw),
                 lambda *a: fl.flash_attention_bwd_dkv_plain(*a, **kw),
                 max(e["dk"], e["dv"])))):
            ms, plain = time_ms(fn, sets, 10), time_ms(fn_p, sets, 2)
            library = lib[0] if i == 0 else lib[1]
            log(path, kernel=f"{kname}_{route}", case=what,
                shape=repr(shape), ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                bound_ms=f"{bounds[i][0]:.4f}", bound_by=bounds[i][1],
                sdpa_ms=f"{library:.4f}", pairs=pairs)
            entry = next(k for k in kernels
                         if k["name"] == f"{kname}_{route}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry.setdefault(key, []).append(
                dict(_timed_case(shape, ms, plain, bounds[i], library),
                     case=what))
        del sets
        torch.cuda.empty_cache()
    check(not failures, f"{path} parity failed: " + ", ".join(failures))


def phase_moe_capacity(cfg, params, path: str) -> None:
    """An MoE stack at its ``CONFIG`` capacity, where items drop (the
    capacity counts each call's tokens: a decode step routes the 4 slots'
    tokens): phase 4's first ``MOE_CAP_REQUESTS`` prompts, greedy, through
    ``ServeEngine`` on the card and on the host CPU, both in fp32 on the
    same weights (the serving params cast up); the greedy tokens equal."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.blocks import moe_capacity
    from repro_torch.serve.engine import ServeEngine
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 513, size=8)     # phase 4's draws
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in lens][:MOE_CAP_REQUESTS]

    def serve(p, device):
        eng = ServeEngine(cfg32, p, max_len=544, max_batch=4, device=device)
        uids = [eng.submit(pr, MOE_CAP_NEW, seed=0, stream=i)
                for i, pr in enumerate(prompts)]
        res = eng.run()
        return [res[u] for u in uids]

    t0 = time.perf_counter()
    p32 = tree_map(lambda t: t.float(), params)
    card = serve(p32, "cuda")
    t_card = time.perf_counter() - t0
    host_params = tree_map(lambda t: t.cpu(), p32)
    del p32
    _free()
    host = serve(host_params, "cpu")
    del host_params
    same = [bool(np.array_equal(a, b)) for a, b in zip(card, host)]
    moe = cfg.moe
    log(path, check="greedy tokens at CONFIG capacity, card vs host CPU "
        "(fp32)", capacity_factor=moe.capacity_factor,
        decode_capacity=moe_capacity(moe, 4),
        prefill_capacities=repr([moe_capacity(moe, len(pr))
                                 for pr in prompts]),
        requests=len(prompts), new_tokens=MOE_CAP_NEW,
        card_s=f"{t_card:.1f}",
        host_s=f"{time.perf_counter() - t0 - t_card:.1f}",
        equal=repr(same), ok=all(same))
    check(all(same), f"{path}: greedy tokens differ from the host's: "
          f"{[(list(a), list(b)) for a, b in zip(card, host)]}")


def phase_zoo(kernels: list) -> None:
    """Phase 14, the decoder-only zoo and MoE at full width, each
    ``CONFIG`` cut to ``ZOO_LAYERS`` layers (random weights from a seed):
    (a) each serves phase 4's eight requests by exact length through K4
    (``sm90``) with phase 4's decode check (the MoE pair on its drop-free
    copy, ``_drop_free``), and the MoE pair also at ``CONFIG`` capacity
    against the host CPU (``phase_moe_capacity``); (b) each trains
    ``ZOO_TRAIN_STEPS`` steps of phase 7's schedule (qwen1.5-110b as
    ``ZOO_TRAIN_CUT``), losses finite, K4, K5a, K5b counted a step; (c)
    Linear-MoE, ``moonshot-v1-16b-a3b`` linearized (every layer linear
    attention + MoE) serves (K1 a prefill batch, K3 a decode step,
    ``sm90``) and trains (K1, K2a, K2b); (d) fp32 grad checks of codeqwen
    (qkv biases) and moonshot (router, experts, shared experts) against
    the host CPU; K4, K5a and K5b held to their plain versions and timed
    at the zoo's head layouts (each ``ZOO_ARCHS`` config's Hq:Hkv with a
    group above 1, causal at the training microbatch's B 4 x S 2048:
    ``_flash_times``)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    walls = {}

    def part(name):
        walls[name] = round(time.perf_counter() - t0 - sum(walls.values()),
                            1)

    layouts = [(model, 4, c.n_heads, c.n_kv_heads, 2048, 2048, c.head_dim,
                True) for c, model in ((get_config(arch), model)
                                       for arch, model in ZOO_ARCHS.items())
               if c.n_kv_heads != c.n_heads]
    _flash_times(kernels, torch.Generator(device="cuda").manual_seed(14),
                 layouts, "zoo_kernels", "zoo_cases")
    part("times")
    for arch, short in ZOO_ARCHS.items():
        cfg = _zoo_cut(get_config(arch))
        params = phase_serve(kernels, cfg, f"zoo_{short}_serve",
                             decode_cfg=_drop_free(cfg))
        if cfg.moe is not None:
            phase_moe_capacity(cfg, params, f"zoo_{short}_capacity")
        del params
        _free()
    part("a")
    for arch, short in ZOO_ARCHS.items():
        cut = {"layers": ZOO_LAYERS, "batch": TRAIN_BATCH,
               "micro": TRAIN_MICRO, "remat": "none",
               **ZOO_TRAIN_CUT.get(arch, {})}
        layers = cut.pop("layers")
        phase_train(kernels, _zoo_cut(get_config(arch), layers),
                    f"zoo_{short}_train", steps=ZOO_TRAIN_STEPS,
                    lr=ZOO_TRAIN_LR, require_fall=False, **cut)
        _free()
    part("b")
    lmoe = _zoo_cut(get_config("moonshot-v1-16b-a3b", linearize=0))
    check({spec.mixer for spec in lmoe.pattern} == {"linear"}
          and lmoe.moe is not None, f"Linear-MoE pattern {lmoe.pattern}")
    params = phase_serve(kernels, lmoe, "zoo_linear_moe_serve",
                         decode_cfg=_drop_free(lmoe))
    del params
    _free()
    phase_train(kernels, lmoe, "zoo_linear_moe_train",
                steps=ZOO_TRAIN_STEPS, lr=ZOO_TRAIN_LR, require_fall=False)
    _free()
    part("c")
    for arch in ("codeqwen1.5-7b", "moonshot-v1-16b-a3b"):
        phase_grad_check(kernels, dataclasses.replace(
            _zoo_cut(get_config(arch)), dtype="float32"),
            f"zoo_{ZOO_ARCHS[arch]}_gradcheck")
        _free()
    part("d")
    log("zoo", wall_s=f"{time.perf_counter() - t0:.1f}",
        part_walls_s=repr(walls))


# ---------------------------------------------------------------------------
# Phase 15: the cross family, llama-3.2-vision-90b and whisper-base.
# ---------------------------------------------------------------------------

# Every cross layer starts with gate 0 and outputs tanh(0)·y = 0: no check
# would see its attention, and no gradient reaches its K4/K5 at step 0.
# Every part of phase 15 sets the gates to 1.0 after init (tanh 0.76).
CROSS_GATE = 1.0
CROSS_ROWS, CROSS_PROMPT, CROSS_NEW = 4, 512, 32
CROSS_TRAIN_STEPS = 3


def _set_gates(params, value) -> None:
    with torch.no_grad():
        for layer in params["layers"]:
            if "gate" in layer["mixer"]:
                layer["mixer"]["gate"].fill_(value)


def _memory(cfg, rows, gen, device="cuda", lead=()):
    """The model's memory, N(0, 0.1²) as the serve launcher draws it:
    ``{"enc_frames": (*lead, rows, n_frames, d)}`` for an encoder,
    ``{"img_emb": (*lead, rows, n_img, d)}`` for image tokens."""
    name, n = ("enc_frames", cfg.encoder.n_frames) if cfg.encoder \
        else ("img_emb", cfg.n_image_tokens)
    return {name: torch.randn((*lead, rows, n, cfg.d_model), generator=gen,
                              device=device) * 0.1}


def phase_cross_serve(kernels: list, cfg, path: str):
    """``CROSS_ROWS`` rows of ``CROSS_PROMPT`` random tokens, with a
    memory per row, through ``ServeEngine.generate`` (the static-batch
    path): one prefill (the encoder runs in it, once), then ``CROSS_NEW``
    − 1 decode steps. Gates at ``CROSS_GATE``. Checks K4 (every softmax,
    cross and encoder layer once, ``sm90``), K1 (every linear layer once)
    and K3 (every linear layer a decode step) launches, the cache bytes
    against their formula (the memory's K/V under ``kv_ring``), and
    phase 4's decode check on the first row with its memory, the cross
    layers' own outputs held layer by layer, and a zeroed cross V it must
    catch in bf16 and in fp32 with fp32 caches."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    from repro_torch.kernels.lasp2_decode import lasp2_decode_step
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    n_lin, n_flash = _mixer_counts(cfg)
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _set_gates(params, CROSS_GATE)
    torch.cuda.synchronize()
    log(path, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        flash_layers=n_flash, cross=sum(s.mixer == "cross"
                                        for s in cfg.layer_specs()),
        encoder_layers=cfg.encoder.n_layers if cfg.encoder else 0,
        d_model=cfg.d_model, params=_numel(params), dtype=cfg.dtype,
        gate=CROSS_GATE, init_s=f"{time.perf_counter() - t0:.2f}")
    mem = _memory(cfg, CROSS_ROWS,
                  torch.Generator(device="cuda").manual_seed(15))
    max_len = CROSS_PROMPT + CROSS_NEW
    engine = ServeEngine(cfg, params, max_len=max_len, max_batch=CROSS_ROWS)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(CROSS_ROWS, CROSS_PROMPT))
    counters = (lasp2_chunk_fwd, lasp2_decode_step, flash_attention_fwd)
    _zero(*counters)
    t0 = time.perf_counter()
    out = engine.generate(prompts, CROSS_NEW, **mem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k3, k4, k1_sm90, _, k3_sm90, _, k4_sm90, _ = \
        _read(counters, counters)
    stats = engine.stats()
    steps = int(stats["decode_steps"])
    k1_route = _chunk_route(cfg)
    check(out.shape == (CROSS_ROWS, CROSS_NEW)
          and ((out >= 0) & (out < cfg.vocab_size)).all(),
          f"{path}: tokens {out.shape} out of shape or vocab")
    check(steps == CROSS_NEW - 1, f"{path}: {steps} decode steps")
    check(k1 == n_lin and (k1_route == "simt" or k1_sm90 == k1),
          f"{path}: K1 launches {k1} (sm90 {k1_sm90}) != {n_lin} layers")
    check(k3 == n_lin * steps and k3_sm90 == k3,
          f"{path}: K3 launches {k3} (sm90 {k3_sm90}) != {n_lin} x {steps}")
    check(k4 == n_flash and k4_sm90 == k4,
          f"{path}: K4 launches {k4} (sm90 {k4_sm90}) != {n_flash} layers")
    if n_lin:
        _count(kernels, f"lasp2_chunk_fwd_{k1_route}", path, k1)
        _count(kernels, "lasp2_decode_step_sm90", path, k3_sm90)
    _count(kernels, "flash_attention_fwd_sm90", path, k4_sm90)
    cache = engine.cache_stats()
    formula = _cache_formula(cfg, CROSS_ROWS, max_len)
    check(all(cache[k] == n for k, n in formula.items()),
          f"{path}: cache bytes {cache} != formula {formula}")
    log(path, rows=CROSS_ROWS, prompt=CROSS_PROMPT, new_tokens=CROSS_NEW,
        memory=repr({k: tuple(v.shape) for k, v in mem.items()}),
        decode_steps=steps, k1_launches=k1, k3_launches=k3, k4_launches=k4,
        k4_sm90_launches=k4_sm90, wall_s=f"{wall:.3f}",
        tokens_per_s=f"{CROSS_ROWS * CROSS_NEW / wall:.1f}",
        prefill_ms=f"{stats['prefill_s_p50'] * 1e3:.2f}",
        decode_step_p50_ms=f"{stats['decode_step_s_p50'] * 1e3:.3f}",
        decode_tokens_per_s=f"{stats['decode_tokens_per_s']:.1f}",
        cache_kv_ring_bytes=cache["kv_ring"],
        cache_linear_state_bytes=cache["linear_state"],
        cache_total_bytes=cache["total"])
    phase_decode_check(params, cfg, path, prompts[0], out[0], max_len,
                       memory={k: v[:1] for k, v in mem.items()},
                       plant=True)
    return params


def phase_cross_train(kernels: list, cfg, path: str, batch: int,
                      micro: int, remat: str) -> list:
    """``CROSS_TRAIN_STEPS`` steps of the one-device step
    (``make_train_step``; ``train()`` refuses the family, whose data
    carries no memory) on phase 7's ``SyntheticLM`` rows of 2048 tokens,
    ``batch`` rows in ``micro`` microbatches, each microbatch with its
    own memory (``frames`` or ``img``), at ``ZOO_TRAIN_LR``, fp32 masters
    drawn on the card, gates at ``CROSS_GATE``. Losses finite, none
    skipped; K1, K2a, K2b, K4, K5a, K5b counted a step (under remat
    "full" each forward kernel twice, the encoder's too); peak memory;
    then the profile of one step."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_fwd)
    from repro_torch.train.step import init_state, make_train_step

    run, data = train_setup(cfg, CROSS_TRAIN_STEPS, ZOO_TRAIN_LR, remat,
                            batch, micro)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(torch.Generator(device="cuda").manual_seed(0), cfg)
    _set_gates(state["params"], CROSS_GATE)
    key = "frames" if cfg.encoder is not None else "img"
    gen = torch.Generator(device="cuda").manual_seed(16)
    batches = [dict(data.microbatched(i, micro), **{key: next(iter(
        _memory(cfg, batch // micro, gen, lead=(micro,)).values()))})
        for i in range(CROSS_TRAIN_STEPS + 1)]
    step_fn = make_train_step(cfg, run)
    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv,
                fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    _zero(*counters)
    hist, per_step, prev = [], [], _read(counters, counters)
    t0 = time.perf_counter()
    for i in range(CROSS_TRAIN_STEPS):
        ts = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        hist.append(dict(to_host(m), dt=time.perf_counter() - ts))
        cur = _read(counters, counters)
        per_step.append([b - a for a, b in zip(prev, cur)])
        prev = cur
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_lin, n_flash = _mixer_counts(cfg)
    lin, soft = n_lin * micro, n_flash * micro
    fwd = 2 if remat == "full" else 1
    want = [fwd * lin, lin, lin, fwd * soft, soft, soft] \
        + [fwd * lin, 0, lin, 0, lin, 0] \
        + [fwd * soft, 0, soft, 0, soft, 0]
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"{path}: non-finite loss {losses}")
    check(not any(h["skipped"] for h in hist), f"{path}: a step skipped")
    check(all(n == want for n in per_step),
          f"{path}: launches of K1, K2a, K2b, K4, K5a, K5b, then each "
          f"sm90/simt, per step {per_step}; want {want}")
    _count_routed(kernels, counters, counters, prev, path)
    p50 = float(np.median([h["dt"] for h in hist[1:]]))
    log(path, arch=cfg.name, layers=cfg.n_layers, linear=n_lin,
        flash_layers=n_flash, steps=CROSS_TRAIN_STEPS, lr=ZOO_TRAIN_LR,
        batch=f"{batch}x{TRAIN_SEQ}", microbatches=micro, remat=remat,
        memory=repr(tuple(batches[0][key].shape)), gate=CROSS_GATE,
        losses=repr([round(x, 4) for x in losses]),
        grad_norms=repr([round(h["grad_norm"], 3) for h in hist]),
        launches_per_step_k1_k2a_k2b_k4_k5a_k5b_routed=repr(per_step[0]),
        wall_s=f"{wall:.2f}", step0_ms=f"{hist[0]['dt'] * 1e3:.1f}",
        step_p50_ms=f"{p50 * 1e3:.1f}",
        tokens_per_s=f"{batch * TRAIN_SEQ / p50:.0f}",
        max_memory_allocated_gb=f"{peak / 1e9:.2f}")

    def one_step():
        nonlocal state
        state, _ = step_fn(state, batches[-1])

    wall_ms, device, n_kernels, top, _ = _profile(one_step, 1)
    idle = f"{1 - device / wall_ms:.3f}" if device else "not measured"
    log("profile", what=repr(f"{path} step {batch}x{TRAIN_SEQ} "
                             f"({micro} microbatches)"),
        wall_ms=f"{wall_ms:.3f}",
        device_kernel_ms=f"{device:.3f}" if device else "not measured",
        device_idle_share=idle, kernels_per_call=f"{n_kernels:.0f}",
        top=repr(top))
    del state
    return hist


def phase_cross(kernels: list) -> None:
    """Phase 15, the cross family at full width, gates at ``CROSS_GATE``
    (random weights from a seed): (a) K4, K5a, K5b held to their plain
    versions and timed at every flash shape of this phase's serving and
    training paths (``CROSS_FLASH``, ``_flash_times``); (b) whisper-base whole
    (6 encoder layers, 6 decoder layers of self + cross) serves
    (``phase_cross_serve``), trains ``CROSS_TRAIN_STEPS`` steps on phase
    7's 2 x 4 x 2048 tokens with 4 x 1500 frames a microbatch, and its
    fp32 grad check against the host CPU covers every leaf (the encoder's
    and the gates' among them); (c) llama-3.2-vision-90b serves at 5
    layers (one whole pattern: 4 self-attention + 1 cross over 1601 image
    tokens), trains its 2-layer cut ``pattern[3:5]`` (a self-attention
    and the cross layer: 3.81 B parameters, 61 GB of fp32 state) on one
    microbatch of 2 x 2048 under full remat, and the cut's fp32 grad check
    runs at 1 x 512 tokens; (d) the Linear-X recipe: vision
    ``linearize=4`` at 5 layers (3 linear, 1 softmax windowed 2048, 1
    cross) serves, whisper ``linearize=0`` (decoder self-attention
    linear) serves and trains."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    walls = {}

    def part(name):
        walls[name] = round(time.perf_counter() - t0 - sum(walls.values()),
                            1)

    _flash_times(kernels, torch.Generator(device="cuda").manual_seed(15),
                 CROSS_FLASH, "cross_kernels", "cross_cases")
    part("a")
    whisper = get_config("whisper-base")
    params = phase_cross_serve(kernels, whisper, "cross_whisper_serve")
    del params
    _free()
    phase_cross_train(kernels, whisper, "cross_whisper_train",
                      batch=TRAIN_BATCH, micro=TRAIN_MICRO, remat="none")
    _free()
    phase_grad_check(kernels, dataclasses.replace(whisper, dtype="float32"),
                     "cross_whisper_gradcheck")
    _free()
    part("b")
    vision = get_config("llama-3.2-vision-90b")
    params = phase_cross_serve(kernels, dataclasses.replace(vision,
                                                            n_layers=5),
                               "cross_vision_serve")
    del params
    _free()
    cut = dataclasses.replace(vision, n_layers=2, pattern=vision.pattern[3:5])
    phase_cross_train(kernels, cut, "cross_vision_train", batch=2, micro=1,
                      remat="full")
    _free()
    phase_grad_check(kernels, dataclasses.replace(cut, dtype="float32"),
                     "cross_vision_gradcheck", tokens=512)
    _free()
    part("c")
    vlin = dataclasses.replace(
        get_config("llama-3.2-vision-90b", linearize=4), n_layers=5)
    params = phase_cross_serve(kernels, vlin, "cross_vision_hybrid4_serve")
    del params
    _free()
    wlin = get_config("whisper-base", linearize=0)
    params = phase_cross_serve(kernels, wlin, "cross_whisper_linear_serve")
    del params
    _free()
    phase_cross_train(kernels, wlin, "cross_whisper_linear_train",
                      batch=TRAIN_BATCH, micro=TRAIN_MICRO, remat="none")
    _free()
    part("d")
    log("cross", wall_s=f"{time.perf_counter() - t0:.1f}",
        part_walls_s=repr(walls))


# ---------------------------------------------------------------------------
# Phase 16: the runtime subsystems on the full-width train path.
# ---------------------------------------------------------------------------

RT_STEPS = 5          # steps of each guarded run
RT_NAN_STEP = 2       # chaos: NaN gradients / a forced skip at this step
RT_RTOL = 1e-6        # the chaos drill's loss parity
RT_MFU_RTOL = 1e-2
RT_CUT_LAYERS = 2     # (d): the zoo's depth cut
RT_CUT_STEPS, RT_CUT_TOTAL, RT_CUT_EVERY = 4, 6, 2
RT_F_STEPS = 2        # (f): guarded steps at (1, 2) before the checkpoint


def _fingerprint(tree) -> list:
    """Per-leaf fingerprint of a tree of tensors, computed on the card:
    the int64 sum of each leaf's raw 32-bit words and the fp64 sum of its
    values (in pieces of 2^26 elements, so no leaf is copied whole)."""
    from repro_torch.core.tree import leaves_with_paths
    out = []
    for _, t in leaves_with_paths(tree):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        flat = t.detach().reshape(-1)
        bits = torch.zeros((), dtype=torch.int64, device=t.device)
        vals = torch.zeros((), dtype=torch.float64, device=t.device)
        for piece in flat.split(1 << 26):
            bits += piece.view(torch.int32).sum(dtype=torch.int64)
            vals += piece.double().sum()
        out.append(torch.stack([bits.double(), vals]))
    return [x.tolist() if isinstance(x, torch.Tensor) else x for x in out]


class _OptCapture:
    """Holds the Adam state ``adamw.init`` makes inside ``train()`` while
    the block runs (the phase fingerprints the moments between steps)."""

    def __enter__(self):
        from repro_torch.optim import adamw
        self._adamw, self._init = adamw, adamw.init
        self.opt = None

        def init(params):
            self.opt = self._init(params)
            return self.opt

        adamw.init = init
        return self

    def __exit__(self, *exc):
        self._adamw.init = self._init


class _FingerprintAt:
    """Data wrapper: at the fetch of each step's batch (the state is then
    the previous step's result) it fingerprints the params and moments."""

    def __init__(self, data, params, capture):
        self._data, self._params, self._capture = data, params, capture
        self.prints = {}

    def microbatched(self, step, a):
        opt = self._capture.opt
        self.prints[step] = _fingerprint({"p": self._params, "m": opt.m,
                                          "v": opt.v})
        return self._data.microbatched(step, a)

    def __getattr__(self, name):
        return getattr(self._data, name)


def _rt_train(cfg, run, data, *, params=None, sink=None, ckpt_dir=None,
              ckpt_every=50, max_steps=RT_STEPS):
    """``train()`` on the card with per-step launch marks of K1, K2a, K2b
    (totals, then each per route). Returns ``(state, history, per_step
    launches, totals, wall_s)``."""
    from repro_torch.train.loop import train
    counters = _sp_counters()[:3]       # K1, K2a, K2b
    marks = []

    def log_fn(msg):
        if msg.startswith("step"):
            marks.append(_read(counters, counters))

    _zero(*counters)
    t0 = time.perf_counter()
    state, hist = train(cfg, run, data, params=params, sink=sink,
                        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        log_every=1, log_fn=log_fn, max_steps=max_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = _read(counters, counters)
    per_step = [[b - a for a, b in zip(prev, cur)]
                for prev, cur in zip([[0] * len(totals)] + marks, marks)]
    return state, hist, per_step, totals, wall


def _rt_guard(kernels, cfg, run, data, train_hist, jsonl):
    """(a) and (b): the guard at full width and the train telemetry.
    Returns the clean guarded run's final state."""
    from repro_torch.models import model as M
    from repro_torch.obs import JsonlSink, read_jsonl
    from repro_torch.obs.flops import model_flops, peak_flops
    from repro_torch.resilience.guard import GuardAbort
    guard = dataclasses.replace(run, guard=True)
    n_lin, _ = _mixer_counts(cfg)
    lin = n_lin * TRAIN_MICRO
    want = [lin] * 3 + [lin, 0] * 3        # K1, K2a, K2b; each on sm90

    # the NaN run, fingerprinted between steps (params and moments)
    params = M.init_params(torch.Generator(device="cuda").manual_seed(
        run.seed), cfg, param_dtype=cfg.param_dtype)
    with _OptCapture() as capture:
        fdata = _FingerprintAt(data, params, capture)
        _, nan_hist, nan_steps, nan_tot, _ = _rt_train(
            cfg, dataclasses.replace(guard, chaos_nan_steps=(RT_NAN_STEP,)),
            fdata, params=params)
    # the prints are all that is kept: the wrapper holds the NaN run's
    # params and moments, which must not sit beside the clean run's
    prints = fdata.prints
    del fdata, params, capture
    _free()
    _, skip_hist, _, _, _ = _rt_train(
        cfg, dataclasses.replace(guard, chaos_skip_steps=(RT_NAN_STEP,)),
        data)
    _free()
    abort_at = None
    try:
        _rt_train(cfg, dataclasses.replace(
            guard, chaos_nan_steps=(1, RT_NAN_STEP),
            guard_max_consecutive_skips=2), data)
    except GuardAbort as e:
        abort_at = str(e).split(" at step ")[1].split(" ")[0]
    _free()
    # the clean guarded run last, with a JsonlSink: its state goes on
    torch.cuda.reset_peak_memory_stats()
    with JsonlSink(jsonl) as sink:
        state, hist, per_step, totals, wall = _rt_train(cfg, guard, data,
                                                        sink=sink)
    peak = torch.cuda.max_memory_allocated()
    chunk = _sp_counters()[:3]
    _count_routed(kernels, chunk, chunk, nan_tot, "runtime_guard")
    _count_routed(kernels, chunk, chunk, totals, "runtime_train")

    skipped = [h["step"] for h in nan_hist if h["skipped"]]
    nan_l = [h["loss"] for h in nan_hist]
    skip_l = [h["loss"] for h in skip_hist]
    ref_l = [h["loss"] for h in train_hist[:RT_NAN_STEP]]
    e_skip = max(_rel_errs(nan_l, skip_l))
    e_ref = max(_rel_errs(nan_l[:RT_NAN_STEP], ref_l))
    same = prints[RT_NAN_STEP] == prints[RT_NAN_STEP + 1]
    moved = prints[RT_NAN_STEP] != prints[RT_NAN_STEP - 1]
    p50 = float(np.median([h["dt"] for h in hist[1:]]))
    p50_7 = float(np.median([h["dt"] for h in train_hist[1:]]))
    log("runtime_guard", arch=cfg.name, layers=cfg.n_layers,
        steps=RT_STEPS, lr=run.learning_rate, total_steps=run.total_steps,
        nan_losses=repr([round(x, 6) for x in nan_l]),
        forced_skip_losses=repr([round(x, 6) for x in skip_l]),
        skipped_steps=skipped, max_rel_err_vs_forced_skip=f"{e_skip:.3e}",
        max_rel_err_steps_0_1_vs_phase7=f"{e_ref:.3e}", rtol=RT_RTOL,
        params_moments_unchanged_across_skip=same,
        fingerprint_moved_on_clean_step=moved,
        guard_metrics_at_skip=repr({k: nan_hist[RT_NAN_STEP][k] for k in (
            "skipped_steps", "consecutive_skips", "guard_spike",
            "guard_median")}),
        abort_raised_at_step=abort_at,
        launches_per_step_k1_k2a_k2b_routed=repr(per_step[0]),
        guarded_step_p50_ms=f"{p50 * 1e3:.1f}",
        phase7_step_p50_ms=f"{p50_7 * 1e3:.1f}",
        guard_overhead=f"{p50 / p50_7 - 1:+.4f}",
        max_memory_allocated_gb=f"{peak / 1e9:.2f}")
    check(skipped == [RT_NAN_STEP], f"NaN run skipped {skipped}")
    check(not any(h["skipped"] for h in hist), "the clean run skipped")
    check(e_skip <= RT_RTOL, f"NaN run {nan_l} vs forced skip {skip_l}")
    check(e_ref <= RT_RTOL, f"steps 0-1 {nan_l} vs phase 7 {ref_l}")
    check(same, "params or moments moved across the skipped step")
    check(moved, "the fingerprint did not move on a clean step")
    check(abort_at == str(RT_NAN_STEP), f"GuardAbort at {abort_at}")
    check(all(n == want for n in per_step + nan_steps),
          f"launches per step {per_step} / {nan_steps}; want {want}")

    # (b) the JSONL
    recs = read_jsonl(jsonl)
    kinds = [r["kind"] for r in recs]
    check(kinds == ["compile"] + ["step"] * RT_STEPS + ["summary"],
          f"record kinds {kinds}")
    from repro_torch.configs.base import ShapeConfig
    flops = model_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    steps = recs[1:-1]
    errs = [abs(r["mfu"] / (flops / (r["wall_s"] * 989e12)) - 1)
            for r in steps]
    mfu = [r["mfu"] for r in steps]
    tps = [r["tokens_per_s"] for r in steps]
    log("runtime_telemetry", records=len(recs), kinds=repr(sorted(set(kinds))),
        model_flops_per_step=f"{flops:.4e}", peak_flops=peak_flops(cfg.dtype),
        step_p50_tokens_per_s=f"{float(np.median(tps[1:])):.0f}",
        step_p50_mfu=f"{float(np.median(mfu[1:])):.4f}",
        mfu_per_step=repr([round(x, 4) for x in mfu]),
        max_rel_err_mfu_formula=f"{max(errs):.2e}",
        drift=recs[0]["drift"], phase_step_s_p50=recs[-1].get(
            "phase_step_s_p50"), phase_data_s_p50=recs[-1].get(
            "phase_data_s_p50"))
    check(max(errs) <= RT_MFU_RTOL, f"mfu off its formula by {max(errs)}")
    check(all(0 < m < 1 for m in mfu), f"mfu {mfu}")
    check(recs[0]["drift"] == [], f"drift {recs[0]['drift']}")
    return state, hist


def _du(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


class _CkptTimes:
    """Within the block, time every checkpoint write
    (``CheckpointManager._write``: the arrays to disk with their
    checksums, on whichever thread runs it) and every device-to-host copy
    of a tree to save (``manager._host_tree``): ``calls`` holds
    ``(what, step or None, wall s)`` in the order they end."""

    def __enter__(self):
        from repro_torch.checkpoint import manager
        self.manager, self.calls = manager, []
        self.write, self.host = manager.CheckpointManager._write, \
            manager._host_tree

        def write(mgr, step, *args):
            t0 = time.perf_counter()
            out = self.write(mgr, step, *args)
            self.calls.append(("write", step, time.perf_counter() - t0))
            return out

        def host(tree):
            t0 = time.perf_counter()
            out = self.host(tree)
            self.calls.append(("host_copy", None, time.perf_counter() - t0))
            return out

        manager.CheckpointManager._write, manager._host_tree = write, host
        return self

    def __exit__(self, *exc):
        self.manager.CheckpointManager._write = self.write
        self.manager._host_tree = self.host


def _rt_ckpt_io(state, ckpt_dir, calls):
    """(c) A train state (the 2-layer cut's, full width) and the
    checkpoint of it that ``train()`` wrote with ``save_async`` (the
    loop's periodic save; ``calls``: ``_CkptTimes``' record of that run):
    each asynchronous save's host copy and disk write, then one verified
    restore into the state itself, every leaf of which is first
    overwritten (NaN, or 0 for integer leaves); the restored state's
    fingerprint equals the one the state had."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import leaves_with_paths
    mgr = CheckpointManager(ckpt_dir)
    step = int(state["step"])
    nbytes = _du(Path(ckpt_dir) / f"step_{step:08d}")
    want = _fingerprint(state)
    with torch.no_grad():
        for _, t in leaves_with_paths(state):
            if isinstance(t, torch.Tensor):
                t.fill_(float("nan") if t.is_floating_point() else 0)
    clobbered = _fingerprint(state) != want
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mgr.restore(step, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = _fingerprint(state) == want
    writes = [(st, w) for what, st, w in calls if what == "write"]
    copies = [w for what, _, w in calls if what == "host_copy"]
    gbs = lambda sec: f"{nbytes / sec / 1e9:.3f}"
    log("runtime_ckpt_io", state_leaves=len(want), step=step,
        disk_free_gb=f"{shutil.disk_usage(ckpt_dir).free / 1e9:.1f}",
        bytes_on_disk=nbytes,
        save_async_host_copy_s=repr([round(w, 2) for w in copies]),
        save_async_write_s_by_step=repr({st: round(w, 2)
                                         for st, w in writes}),
        save_async_write_gb_per_s=repr([gbs(w) for _, w in writes]),
        restore_verified_s=f"{restore_s:.2f}",
        restore_gb_per_s=gbs(restore_s),
        overwritten_before_restore=clobbered, restored_equals_saved=same,
        ckpt_dir_fs=repr(str(ckpt_dir)))
    check(clobbered, "overwriting the state left its fingerprint as saved")
    check(same, "the restored state's fingerprint differs from the saved")
    check([st for st, _ in writes] == list(range(
        RT_CUT_EVERY, step + 1, RT_CUT_EVERY)),
        f"the loop wrote steps {writes}")


def _rt_serve(kernels, cfg, params, ckpt_dir, step, jsonl):
    """(e) The serve CLI on a checkpoint of (a)'s final params (the
    ``{"params": ...}`` subtree the CLI restores, saved here): its greedy
    tokens equal those of an engine on those params in memory, K1 and K3
    on sm90, and its JSONL holds the request records and the summary."""
    import contextlib
    import io

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    from repro_torch.kernels.lasp2_decode import lasp2_decode_step
    from repro_torch.launch import serve
    from repro_torch.obs import read_jsonl
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir, keep=1).save(step, {"params": params})
    save_s = time.perf_counter() - t0
    counters = (lasp2_chunk_fwd, lasp2_decode_step)
    _zero(*counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = serve.main(["--arch", cfg.name, "--ckpt-dir", ckpt_dir,
                              "--metrics-out", jsonl])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _read(counters, counters)
    k1, k3, k1_sm90, _, k3_sm90, _ = launched
    text = out.getvalue()
    print(text, end="", flush=True)
    _free()
    # the same requests, as launch/serve.py draws them, on the params in
    # memory
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 65, size=8)
    from repro_torch.core.tree import tree_map
    engine = ServeEngine(cfg, tree_map(lambda p: p.detach(), params),
                         max_len=64 + 32, max_batch=4)
    uids = [engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)), 32,
                          seed=0, stream=i) for i, n in enumerate(lens)]
    want = engine.run()
    same = sorted(results) == sorted(uids) and all(
        np.array_equal(results[u], want[u]) for u in uids)
    recs = read_jsonl(jsonl)
    kinds = [r["kind"] for r in recs]
    _count_routed(kernels, counters, counters, launched, "runtime_serve")
    log("runtime_serve", restored=repr(
        [ln for ln in text.splitlines() if "restored" in ln]),
        requests=len(results), tokens_equal_engine_on_memory_params=same,
        k1=k1, k1_sm90=k1_sm90, k3=k3, k3_sm90=k3_sm90,
        jsonl_kinds=repr({k: kinds.count(k) for k in set(kinds)}),
        params_ckpt_bytes=_du(ckpt_dir), params_save_s=f"{save_s:.2f}",
        wall_s=f"{wall:.2f}")
    check(f"[serve] restored params from step {step}" in text,
          f"the CLI did not restore step {step}: {text}")
    check(same, "the CLI's tokens differ from the engine on (a)'s params")
    check(k1 > 0 and k1 == k1_sm90 and k3 > 0 and k3 == k3_sm90,
          f"K1 {k1} (sm90 {k1_sm90}), K3 {k3} (sm90 {k3_sm90})")
    check(kinds == ["request"] * 8 + ["summary"], f"serve JSONL {kinds}")
    check(recs[-1].get("component") == "serve", f"summary {recs[-1]}")


def _rt_resume(cfg, run, data, ckpt_dir, jsonl):
    """(c) and (d), 2 layers at full width: 4 steps with a checkpoint
    every 2 (the loop's asynchronous saves), (c) on that run's final state
    and newest checkpoint, then (d): the newest checkpoint corrupted, a
    resume to step 6 with a sink (its one write: the final, synchronous
    save): the fallback event names the bad and the restored step, the
    recomputed losses equal an uninterrupted run's."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.obs import JsonlSink, read_jsonl
    from repro_torch.resilience import chaos
    _, full, _, _, _ = _rt_train(cfg, run, data, max_steps=RT_CUT_TOTAL)
    _free()
    with _CkptTimes() as io:
        state, _, _, _, _ = _rt_train(cfg, run, data, ckpt_dir=ckpt_dir,
                                      ckpt_every=RT_CUT_EVERY,
                                      max_steps=RT_CUT_STEPS)
    steps_before = CheckpointManager(ckpt_dir).all_steps()
    _rt_ckpt_io(state, ckpt_dir, io.calls)
    del state
    _free()
    chaos.corrupt_checkpoint(ckpt_dir)
    t0 = time.perf_counter()
    with _CkptTimes() as io, JsonlSink(jsonl) as sink:
        state, hist, _, _, _ = _rt_train(
            cfg, run, data, sink=sink, ckpt_dir=ckpt_dir,
            ckpt_every=10 ** 9, max_steps=RT_CUT_TOTAL)
    wall = time.perf_counter() - t0
    del state
    _free()
    recs = read_jsonl(jsonl)
    fallback = [r for r in recs if r.get("event") == "ckpt_fallback"]
    got = {h["step"]: h["loss"] for h in hist}
    want = {h["step"]: h["loss"] for h in full}
    steps = sorted(got)
    err = max(_rel_errs([got[s] for s in steps], [want[s] for s in steps]))
    writes = [(st, w) for what, st, w in io.calls if what == "write"]
    nbytes = _du(Path(ckpt_dir) / f"step_{RT_CUT_TOTAL:08d}")
    log("runtime_resume", arch=cfg.name, layers=cfg.n_layers,
        params=cfg.param_count(), ckpt_steps_before_corruption=steps_before,
        fallback=repr([{k: r[k] for k in ("bad_step", "restored_step",
                                          "error")} for r in fallback]),
        recomputed_steps=steps, max_rel_err_vs_uninterrupted=f"{err:.3e}",
        rtol=RT_RTOL, ckpt_bytes_on_disk=_du(ckpt_dir),
        final_save_sync_write_s=repr({st: round(w, 2) for st, w in writes}),
        final_save_gb_per_s=repr([f"{nbytes / w / 1e9:.3f}"
                                  for _, w in writes]),
        resume_run_wall_s=f"{wall:.2f}")
    check(len(fallback) == 1 and fallback[0]["bad_step"] == RT_CUT_STEPS
          and fallback[0]["restored_step"] == RT_CUT_EVERY,
          f"fallback events {fallback}")
    check(steps == list(range(RT_CUT_EVERY, RT_CUT_TOTAL)),
          f"recomputed steps {steps}")
    check(err <= RT_RTOL, f"resumed losses {got} vs {want}")
    check([st for st, _ in writes] == [RT_CUT_TOTAL],
          f"the resume wrote steps {writes}")


def phase_runtime(kernels: list, cfg, train_hist) -> None:
    """Phase 16: (a) the guard at full width and depth through ``train()``
    (phase 7's ``RunConfig`` and data, 5 steps): a NaN run, a forced-skip
    run, a consecutive-skip abort, then the clean guarded run; (b) its
    JSONL; (e) the serve CLI on a checkpoint of its final params; (c)
    checkpoint I/O and (d) resume and fallback, both on the 2-layer cut
    and its checkpoints. (f), the guarded cell at (1, 2), runs in phase
    10's spawn."""
    import shutil
    import tempfile
    run, data = train_setup(cfg, TRAIN_STEPS, 3e-4)
    tmp = Path(tempfile.mkdtemp(prefix="runtime-"))
    walls, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        walls[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    try:
        state, _ = _rt_guard(kernels, cfg, run, data, train_hist,
                             str(tmp / "train.jsonl"))
        params, step = state["params"], int(state["step"])
        del state
        _free()
        lap("ab")
        _rt_serve(kernels, cfg, params, str(tmp / "ckpt"), step,
                  str(tmp / "serve.jsonl"))
        del params
        _free()
        shutil.rmtree(tmp / "ckpt")
        lap("e")
        _rt_resume(dataclasses.replace(cfg, n_layers=RT_CUT_LAYERS), run,
                   data, str(tmp / "cut"), str(tmp / "resume.jsonl"))
        lap("cd")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("runtime", wall_s=f"{sum(walls.values()):.1f}",
        part_walls_s=repr(walls))


# ---------------------------------------------------------------------------
# Phase 17: the 3D DP×SP×TP layout on four ranks sharing the card.
# ---------------------------------------------------------------------------

USP_DIMS = (1, 2, 2)          # (dp, sp, tp): 4 gloo ranks on the one card
USP_GQA = (48, 4, 4096)       # (b) starcoder2-15b's softmax heads: hq, hkv, S
USP_HALO = (16, 16384, 2048)  # (c) HYBRID's softmax heads: h, S, window
USP_BLOCK = 512               # query rows a block of the plain references


def _flash_bound_blocked(q, k, v, do, window=None):
    """The ``sm90`` route's rounding bound of o, dq, dk and dv
    (``sm90_rounding_bound``, from the plain forward's lse and delta in
    fp32) over the whole sequence, causal (with ``window``), a block of
    USP_BLOCK queries at a time against only the keys the block can attend
    (a block's scores stay small); a key's bound is summed over the
    blocks, as its gradient is."""
    from repro_torch.kernels import flash_attention as fl
    q, k, v, do = (x.float() for x in (q, k, v, do))
    bound = [torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(k),
             torch.zeros_like(v)]
    for a in range(0, q.shape[2], USP_BLOCK):
        b = min(a + USP_BLOCK, q.shape[2])
        lo = 0 if window is None else max(a - window + 1, 0)
        kw = dict(causal=True, window=window, q_offset=a - lo)
        qb, dob, kb, vb = q[:, :, a:b], do[:, :, a:b], k[:, :, lo:b], \
            v[:, :, lo:b]
        ob, lse = fl.flash_attention_fwd_plain(qb, kb, vb, **kw)
        ext = fl.sm90_rounding_bound(qb, kb, vb, dob, lse,
                                     (dob * ob).sum(-1), **kw)
        for i, e in enumerate(ext):
            bound[i][:, :, slice(a, b) if i < 2 else slice(lo, b)] += e
    return bound


def _usp_flash_case(rank, name, fn, xs, dout, chunk, window=None):
    """``fn`` (the sharded attention) on this rank's chunks of ``xs``
    forward and backward against ``flash_attention_op`` on one device over
    the whole sequence (each rank its own chunk of o, dq, dk, dv): the
    same kernels, so they part only where the split sums a key's
    gradient in another order (in bf16 across ranks); within the flash
    bf16 limit plus the ``sm90`` rounding bound. (Both take delta from
    the kernel's bf16 o, as the reference's backward does; fp32 plain
    versions with their own delta are not the reference for that path:
    PERF.md §7.) Returns the sharded call's launches."""
    from repro_torch.kernels import ops
    counters = _sp_counters()
    _zero(*counters)
    t0 = time.perf_counter()
    got = _fwd_bwd(fn, [chunk(x) for x in xs], chunk(dout).float())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _read(counters, counters)
    want = _fwd_bwd(lambda a, b, c: ops.flash_attention_op(
        a, b, c, causal=True, sliding_window=window), xs, dout.float())
    bound = _flash_bound_blocked(*xs, dout, window)
    errs, oks = [], []
    for g, w, e in zip(got, want, bound):
        err, ok = max_err_bf16(g, chunk(w), chunk(e))
        errs.append(err)
        oks.append(ok)
    n = len(counters)
    log("usp", rank=rank, case=name, max_abs_err_o_dq_dk_dv=repr(
        [f"{e:.3e}" for e in errs]), tol=SM90_LIMIT,
        vs="flash_attention_op on one device, the whole sequence",
        launches_k1_k2a_k2b_k4_k5a_k5b_routed=repr(launched),
        fwd_bwd_wall_ms_gloo_host_transport=f"{wall * 1e3:.1f}")
    check(all(oks), f"phase 17 rank {rank}: {name} off the flash limit: "
          f"{errs}")
    check(all(launched[n + 2 * i] == launched[i] > 0 for i in (3, 4, 5))
          and not any(launched[n + 1::2]),
          f"phase 17 rank {rank}: {name} launches {launched}; want K4, "
          f"K5a, K5b on sm90 only")
    return launched


def _usp_step(rank, cfg, layout, base):
    """(a) SP_STEPS steps of ``cfg`` at (1, 2, 2) under "ulysses" on phase
    10 b1's params and packed rows: losses and grad norms against b1's
    (1, 2) allgather run; the tape per step the 3D budget with no drift;
    K1, K2a, K2b per linear and K4, K5a, K5b per softmax layer a step on
    sm90."""
    from repro_torch.train.step import state_from_params, zero1_degree
    run = _sp_run(comm_strategy="ulysses")
    zero1 = zero1_degree(run, layout)
    res = _sp_steps(cfg, run, layout,
                    state_from_params(_sp_params(cfg), zero1),
                    _sp_batches(cfg, True), drift=True)
    del res["state"]
    n_lin, n_soft = _mixer_counts(cfg)
    want = _want_launches(n_lin, n_lin, n_soft)      # autodiff backwards
    check(all(n == want for n in res["per_step"]),
          f"usp_a rank {rank}: launches per step {res['per_step']}; want "
          f"{want}")
    want_tape = {"all-gather lasp2.states": n_lin,
                 "reduce-scatter lasp2.states.bwd": n_lin,
                 "all-reduce train.grads": 1,
                 "all-gather zero1.param_gather": 1}
    for t in ("in", "out", "in.bwd", "out.bwd"):
        want_tape[f"all-to-all ulysses.{t}"] = n_soft
    for t in ("k", "v"):
        want_tape[f"all-gather ulysses.{t}"] = n_soft
        want_tape[f"reduce-scatter ulysses.{t}.bwd"] = n_soft
    for tape in res["tapes"]:
        check({k: v[0] for k, v in tape.items()} == want_tape,
              f"usp_a rank {rank}: tape {tape}; want counts {want_tape}")
    check(all(d == [] for d in res["drifts"]),
          f"usp_a rank {rank}: drift {res['drifts']}")
    e_loss = max(_rel_errs(res["losses"], base["losses"]))
    e_gnorm = max(_rel_errs(res["gnorms"], base["gnorms"]))
    c = SP_SEQ // layout.tokens
    log("usp_a", rank=rank, arch=cfg.name, layers=cfg.n_layers,
        linear=n_lin, softmax=n_soft, dp_sp_tp=repr(USP_DIMS),
        strategy="ulysses", rows_x_chunk=f"{SP_ROWS}x{c}",
        zero1_group_size=zero1,
        losses=repr([round(x, 6) for x in res["losses"]]),
        b1_dp1sp2_allgather_losses=repr([round(x, 6)
                                         for x in base["losses"]]),
        max_rel_err_loss=f"{e_loss:.3e}", tol_loss=TOL_SP_LAYOUT,
        grad_norms=repr([round(x, 6) for x in res["gnorms"]]),
        max_rel_err_grad_norm=f"{e_gnorm:.3e}", tol_grad_norm=TOL_SP_GNORM,
        launches_per_step_k1_k2a_k2b_k4_k5a_k5b_routed=repr(
            res["per_step"][0]),
        tape_per_step=repr(res["tapes"][0]).replace(" ", ""),
        tape_bytes_per_step=sum(n * b for n, b in res["tapes"][0].values()),
        drift=res["drifts"][0], transport="gloo (host-staged)",
        step_wall_ms=repr([round(w * 1e3, 1) for w in res["walls"]]),
        max_memory_allocated_gb=f"{res['peak'] / 1e9:.2f}")
    check(e_loss <= TOL_SP_LAYOUT, f"usp_a rank {rank}: losses "
          f"{res['losses']} vs b1 {base['losses']}")
    check(e_gnorm <= TOL_SP_GNORM, f"usp_a rank {rank}: grad norms "
          f"{res['gnorms']} vs b1 {base['gnorms']}")
    return res["launched"], _tape_san(f"phase 17 usp_a rank {rank}",
                                      res["records"], run.comm_dtype)


def _usp_rank(rank, world, device, hybrid_cut, base):
    """Phase 17 on one of four ranks sharing the card over gloo: (a) the
    3D step, (b) Ulysses' GQA packing at 48:4, (c) the halo attention in
    both modes."""
    import torch.distributed as dist
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core.lasp2 import SPConfig
    from repro_torch.core.lasp2h import (ulysses_context_attention,
                                         windowed_context_attention)
    from repro_torch.launch.mesh import make_training_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    layout = make_training_groups(*USP_DIMS)
    walls, out = {}, {}
    t0 = time.perf_counter()
    out["a"], san = _usp_step(rank, hybrid_cut, layout, base)
    _free()
    walls["a"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(17)
    hq, hkv, s = USP_GQA
    xs = _flash_inputs(gen, 1, hq, hkv, s, s, 128, torch.bfloat16)
    sp = SPConfig(layout.sp_group, comm=CommSpec("ulysses"),
                  tp_group=layout.tp_group, seq_group=layout.seq_group)
    c = s // layout.tokens
    t = layout.chunk_index
    out["b"] = _usp_flash_case(
        rank, "b_gqa_48_4", lambda a, b_, v: ulysses_context_attention(
            a, b_, v, sp=sp), xs[:3], xs[3],
        lambda x: x[:, :, t * c:(t + 1) * c])
    del xs
    _free()
    walls["b"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    h, s, window = USP_HALO
    xs = _flash_inputs(gen, 1, h, h, s, s, 128, torch.bfloat16)
    spw = SPConfig(dist.group.WORLD)
    c = s // world
    for mode in ("ppermute", "gather"):
        out[f"c_{mode}"] = _usp_flash_case(
            rank, f"c_halo_{mode}", lambda a, b_, v, m=mode:
            windowed_context_attention(a, b_, v, window, sp=spw,
                                       halo_mode=m), xs[:3], xs[3],
            lambda x: x[:, :, rank * c:(rank + 1) * c], window)
    del xs
    _free()
    walls["c"] = round(time.perf_counter() - t0, 1)
    log("usp_rank", rank=rank, part_walls_s=repr(walls))
    return dict(out, san=san)


def phase_usp(kernels: list, hybrid, sp_ranks) -> None:
    """Phase 17 on four ranks sharing the card over gloo (NCCL refuses two
    ranks on one device): (a) the ``HYBRID`` cut of phase 10 at (dp, sp,
    tp) = (1, 2, 2) under "ulysses", 3 steps on b1's params and packed
    rows, against b1's (1, 2) allgather run; (b)
    ``ulysses_context_attention`` at (1, 2, 2) on starcoder2-15b's softmax
    heads (48:4 x 128, bf16, causal, B 1, S 4096): the GQA packing; (c)
    ``windowed_context_attention`` at W 4 on ``HYBRID``'s softmax heads
    (16 x 128, window 2048, B 1, S 16384) in both halo modes; (b) and (c)
    against ``flash_attention_op`` on one device over the whole
    sequence. Returns each rank's (a) tapes read by the sanitizer
    (``_tape_san``), for phase 19."""
    import os

    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    base = {k: sp_ranks[0]["b1"][k] for k in ("losses", "gnorms")}
    # Four caching allocators share the card's 80 GB (about 15 GB a rank
    # in use at the backward's peak): expandable segments keep what each
    # holds reserved but free small. The ranks read it when they start.
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(
            _usp_rank, USP_DIMS[0] * USP_DIMS[1] * USP_DIMS[2],
            backend="gloo", device="cuda",
            args=(dataclasses.replace(hybrid, n_layers=SP_LAYERS), base),
            timeout_s=600)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    tapes = []
    for rank, res in enumerate(ranks):
        tapes.append(dict(res.pop("san"), phase=17, case="usp_a",
                          rank=rank))
        for cell, launched in res.items():
            _count_routed(kernels, _sp_counters(), _sp_counters(), launched,
                          f"usp_{cell}_rank{rank}")
    log("usp", ranks=len(ranks), dp_sp_tp=repr(USP_DIMS),
        transport="gloo (host-staged)",
        wall_s=f"{time.perf_counter() - t0:.1f}")
    return tapes


# ---------------------------------------------------------------------------
# Phase 18: serving under a plan (M10, first half), four gloo ranks.
# ---------------------------------------------------------------------------

SERVE_SP_W = 4
SERVE_SP_PROMPTS = (4096, 1024, 1023)   # 1023: bucketed, or prefilled whole
SERVE_SP_NEW = 32
SERVE_SP_MAX_LEN = 4608
SERVE_SP_DECODE_PROMPTS = (1024, 300)   # (b): granite, exact length
SERVE_SP_DECODE_MAX_LEN = 2048          # the ring: 4 slices of 512 slots
SERVE_SP_SEED = 18


def _serve_sp_engine():
    """A ``ServeEngine`` that records each sampling call (each prefill
    batch's, each decode step's): its rows' request uids and their logits
    (the vocab's columns, on the host), the tokens it returned, and each
    prefill batch's (rows, length). With ``forced`` (a recorded run's
    tokens) it returns those instead of sampling: the same requests then
    follow the same tokens through the same batches and slots."""
    from repro_torch.serve.engine import ServeEngine

    class Recording(ServeEngine):
        def __init__(self, *a, forced=None, **kw):
            super().__init__(*a, **kw)
            self.forced, self.calls, self.tokens = forced, [], []
            self.batches, self._rows = [], None

        def _admit(self, batch):
            self._rows = [r.uid for r in batch.requests]
            self.batches.append(tuple(batch.prompts.shape))
            try:
                return super()._admit(batch)
            finally:
                self._rows = None

        def _sample(self, logits, temps, seeds, steps):
            rows = self._rows if self._rows is not None else [
                r.uid if r is not None else None for r in self.sched.slots]
            self.calls.append((rows, logits[:, :self.cfg.vocab_size]
                               .float().cpu()))
            if self.forced is not None:
                tok = self.forced[len(self.calls) - 1]
            else:
                tok = super()._sample(logits, temps, seeds, steps)
            self.tokens.append(tok)
            return tok

    return Recording


def _serve_sp_case(rank, name, cfg, plan, prompts, max_len):
    """One engine under ``plan`` on this rank: greedy requests, its tape
    against ``comm.budget`` (every prefill batch's and decode step's
    budget), its K1/K3/K4 launches, its wall and peak; on rank 0 every
    sampled row's logits held to the one-device engine's on the same
    tokens (forced onto this run's, so batches and slots match), within
    phase 6's bf16 limit."""
    from repro_torch.comm import budget as B
    from repro_torch.comm import primitives
    from repro_torch.models import model as M
    params = M.init_params(torch.Generator(device="cuda").manual_seed(
        SERVE_SP_SEED), cfg)
    engines = _serve_sp_engine()
    engine = engines(cfg, params, plan=plan, max_len=max_len,
                     max_batch=len(prompts))
    rng = np.random.default_rng(SERVE_SP_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in prompts]
    for i, p in enumerate(prompts):
        engine.submit(p, SERVE_SP_NEW, seed=0, stream=i)
    counters = _serve_sp_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(*counters)
    t0 = time.perf_counter()
    with primitives.tape() as records:
        engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _read(counters, counters)
    peak = torch.cuda.max_memory_allocated()
    steps = int(engine.stats()["decode_steps"])
    budget = B.combine(
        [B.serve_prefill_budget(cfg, plan, b=b, s=s)
         for b, s in engine.batches]
        + [B.serve_decode_budget(cfg, plan, b=len(prompts),
                                 max_len=max_len)] * steps)
    violations = B.check_budget(records, budget)
    tags = {}
    for r in records:
        tags[r.tag] = tags.get(r.tag, 0) + 1
    n_lin, n_soft = _mixer_counts(cfg)
    worst, ok = 0.0, True
    tol = TOL_LOGITS if cfg.n_layers <= 16 else TOL_LOGITS_DEEP
    if rank == 0:
        # the one-device engine on the same requests, forced onto this
        # run's tokens: the same batches, slots and steps, no plan
        one = engines(cfg, params, max_len=max_len, max_batch=len(prompts),
                      forced=engine.tokens)
        for i, p in enumerate(prompts):
            one.submit(p, SERVE_SP_NEW, seed=0, stream=i)
        one.run()
        check([r for r, _ in one.calls] == [r for r, _ in engine.calls],
              f"phase 18 {name}: the one-device replay took other batches")
        for (rows, got), (_, want) in zip(engine.calls, one.calls):
            for i, uid in enumerate(rows):
                if uid is not None:
                    err, within = max_err_within(got[i], want[i], tol)
                    worst, ok = max(worst, err), ok and within
        del one
    log("serve_sp", rank=rank, case=name, arch=cfg.name,
        layers=cfg.n_layers, linear=n_lin, softmax=n_soft,
        plan_rules_seq_cache=repr((plan.rules.get("seq"),
                                   plan.rules.get("cache_seq"))),
        sp_degree=plan.sp_degree, prompts=repr([len(p) for p in prompts]),
        prefill_batches=repr(engine.batches), decode_steps=steps,
        sampled_calls=len(engine.calls), new_tokens=SERVE_SP_NEW,
        tape_by_tag=repr(dict(sorted(tags.items()))).replace(" ", ""),
        tape_bytes=sum(r.traffic_bytes for r in records),
        budget_violations=violations or "none",
        launches_k1_k3_k4_routed=repr(launched),
        kv_ring_bytes=engine.cache_stats()["kv_ring"],
        max_abs_err_vs_one_device_engine=f"{worst:.4e}" if rank == 0
        else "checked on rank 0", tol=tol, transport="gloo (host-staged)",
        wall_s=f"{wall:.2f}", max_memory_allocated_gb=f"{peak / 1e9:.2f}")
    san = _tape_san(f"phase 18 {name} rank {rank}", [records], "fp32",
                    split=plan.sp_degree > 1)
    check(not violations, f"phase 18 rank {rank} {name}: tape off its "
          f"budget: {violations}")
    check(ok, f"phase 18 {name}: logits off the one-device engine by "
          f"{worst:.4e}")
    want = [n_lin * len(engine.batches), n_lin * steps,
            n_soft * len(engine.batches)]
    check(launched[:3] == want and launched[3::2] == want,
          f"phase 18 rank {rank} {name}: launches K1/K3/K4 (total, then "
          f"per route) {launched}; want {want}, all on sm90")
    del engine, params
    _free()
    return launched, san


def _serve_sp_rank(rank, world, device, linear, hybrid, granite):
    """Phase 18 on one of four ranks sharing the card over gloo: (a) the
    prefill plan of the (4, 1) layout serving ``CONFIG`` and ``HYBRID``,
    (b) the decode plan of the (1, 4) layout serving granite-34b's 2-layer
    cut with its ring sliced over the model group."""
    from repro_torch.launch.mesh import (Axis, make_serving_groups,
                                         make_test_mesh)
    from repro_torch.sharding.rules import make_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    axes = (Axis.DATA, Axis.MODEL)
    pre = make_serving_groups(make_test_mesh((SERVE_SP_W, 1), axes))
    dec = make_serving_groups(make_test_mesh((1, SERVE_SP_W), axes))
    out, san = {}, {}
    for name, cfg in (("a_linear", linear), ("a_hybrid", hybrid)):
        plan = make_plan(pre, "prefill", n_kv_heads=cfg.n_kv_heads,
                         n_heads=cfg.n_heads)
        out[name], san[name] = _serve_sp_case(
            rank, name, cfg, plan, SERVE_SP_PROMPTS, SERVE_SP_MAX_LEN)
    plan = make_plan(dec, "decode", n_kv_heads=granite.n_kv_heads,
                     n_heads=granite.n_heads)
    check(plan.decode_cache_axis == Axis.MODEL,
          f"phase 18: granite's decode plan {plan.rules}")
    out["b_granite"], san["b_granite"] = _serve_sp_case(
        rank, "b_granite", granite, plan, SERVE_SP_DECODE_PROMPTS,
        SERVE_SP_DECODE_MAX_LEN)
    return dict(out, san=san)


def phase_serve_sp(kernels: list, linear, hybrid) -> None:
    """Phase 18 on four ranks sharing the card over gloo (NCCL refuses two
    ranks on one device): ``ServeEngine(plan=)`` with every rank running
    the same engine on the same requests. (a) ``make_plan((4, 1),
    "prefill")``: Linear-Llama3-1B ``CONFIG`` and ``HYBRID`` at full width
    and depth, prompts of 4096, 1024 and 1023 tokens split 4 ways (K1 on
    each rank's chunk and one state all-gather a linear layer; K4 on the
    gathered K/V; 1023 is bucketed and left-padded by ``CONFIG`` and
    prefilled whole by ``HYBRID``, whose 2048-slot window rings are sliced
    4 ways and merged at decode), 32 greedy tokens; (b) ``make_plan((1,
    4), "decode", n_kv_heads=1)``: granite-34b's 2-layer cut, prompts of
    1024 and 300 prefilled whole, its 2048-slot rings sliced over the
    model group, 32 greedy tokens. Every rank's tape against
    ``comm.budget``; rank 0's logits against the one-device path."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    granite = _zoo_cut(get_config("granite-34b"))
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(_serve_sp_rank, SERVE_SP_W, backend="gloo",
                          device="cuda", args=(linear, hybrid, granite),
                          timeout_s=600)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    counters = _serve_sp_counters()
    tapes = []
    for rank, res in enumerate(ranks):
        tapes += [dict(t, phase=18, case=case, rank=rank)
                  for case, t in res.pop("san").items()]
        for case, launched in res.items():
            _count_routed(kernels, counters, counters, launched,
                          f"serve_sp_{case}_rank{rank}")
    log("serve_sp", ranks=len(ranks), transport="gloo (host-staged)",
        wall_s=f"{time.perf_counter() - t0:.1f}")
    return tapes


def _tape_san(label, tapes, comm_dtype, split=True) -> dict:
    """What the sanitizer reads of a rank's tapes (one a step, or one a
    run): SAN203 on the first (``check_wire``; ``split``: a sequence was
    split over the ranks, so a sequence exchange must be on it), SAN205
    between consecutive ones, and the first one's fingerprint, which
    phase 19 holds alike across ranks."""
    from repro_torch.analysis.sanitizer import (check_determinism,
                                                check_wire, fingerprint)
    fps = [fingerprint(t) for t in tapes]
    found = check_wire(label, tapes[0], comm_dtype, split=split)
    for a, b in zip(fps, fps[1:]):
        found += check_determinism(label, a, b)
    return {"findings": [f.to_dict() for f in found], "fp": fps[0],
            "records": len(tapes[0])}


def _serve_sp_counters():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd
    from repro_torch.kernels.lasp2_decode import lasp2_decode_step
    return (lasp2_chunk_fwd, lasp2_decode_step, flash_attention_fwd)


# ---------------------------------------------------------------------------
# Phase 19: the analysis subsystem on the card.
# ---------------------------------------------------------------------------

REMAT_STEPS = 3
# Each step's loss and grad norm under full and dots against none's,
# relative. Recompute reruns the same kernels on the same inputs, so the
# modes agree to fp32 rounding (on an H100 they give the same bits), far
# inside the bf16 limit of 4e-2: at that limit a zeroed, stale or
# mis-saved gradient would pass, since the warm-up's small learning
# rates barely move the loss in 3 steps.
TOL_REMAT = 1e-5


def _analysis_battery() -> None:
    """(a) The PAL301 guard-band battery over every route of the seven
    kernels."""
    from repro_torch.analysis.kernel_check import (battery_cases, routes,
                                                   run_case)
    t0 = time.perf_counter()
    cases = battery_cases()
    found = []
    for case in cases:
        found += run_case(case, "cuda")
    for f in found:
        log("analysis_finding", finding=repr(str(f)))
    log("analysis_battery", cases=len(cases), routes=len(routes(cases)),
        route_list=repr([f"{k}:{r}" for k, r in routes(cases)]).replace(
            " ", ""), findings=len(found),
        wall_s=f"{time.perf_counter() - t0:.2f}")
    check(not found and len(routes(cases)) == 14,
          f"phase 19 battery: {len(found)} finding(s) over "
          f"{len(routes(cases))} routes")


def _analysis_sanitize(cfg, run, data, rank_tapes, min_tapes=8) -> None:
    """(b) The sanitizer on the full-width train step (phase 7's shape,
    after a warm-up step) and the decode step of 4 slots, sync debug mode
    set to error; SAN203 and SAN205 over phases 17's and 18's tapes."""
    from repro_torch.analysis.findings import Finding
    from repro_torch.analysis.sanitizer import (check_determinism,
                                                sanitize_decode,
                                                sanitize_train)
    from repro_torch.models import model as M
    from repro_torch.train.step import init_state, make_train_step
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                       run=run)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in data.microbatched(0, TRAIN_MICRO).items()}
    state, _ = make_train_step(cfg, run)(state, batch)        # warm-up
    torch.cuda.synchronize()
    found, _, state = sanitize_train(
        f"train_step[{cfg.name} {TRAIN_BATCH}x{TRAIN_SEQ}]", cfg, run,
        state, batch, sync_debug=True)
    torch.cuda.synchronize()
    del state, batch
    _free()
    t_train = time.perf_counter() - t0
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    cache = M.init_cache(cfg, 4, 544)
    tok = torch.zeros(4, dtype=torch.int32, device=dev)
    _, cache = M.decode_step(params, tok, cache, cfg)         # warm-up
    torch.cuda.synchronize()
    found_d, _ = sanitize_decode(f"decode_step[{cfg.name} B4]", cfg, params,
                                 tok, cache, sync_debug=True)
    found += found_d
    del params, cache
    _free()
    # the ranks' tapes: SAN203 and SAN205 within a rank, SAN205 across
    # the ranks of one case
    for t in rank_tapes:
        found += [Finding(**d) for d in t["findings"]]
    by_case = {}
    for t in rank_tapes:
        by_case.setdefault((t["phase"], t["case"]), []).append(t)
    for (phase, case), ts in sorted(by_case.items()):
        for t in ts[1:]:
            found += check_determinism(
                f"phase {phase} {case} rank 0 vs rank {t['rank']}",
                ts[0]["fp"], t["fp"])
    for f in found:
        log("analysis_finding", finding=repr(str(f)))
    log("analysis_sanitizer", train=f"{cfg.name} {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"({TRAIN_MICRO} microbatches)", decode="B4",
        sync_debug_mode="error", rank_tapes=len(rank_tapes),
        rank_cases=repr(sorted(f"{p}:{c}" for p, c in by_case)).replace(
            " ", ""),
        rank_records=sum(t["records"] for t in rank_tapes),
        findings=len(found), train_s=f"{t_train:.2f}",
        wall_s=f"{time.perf_counter() - t0:.2f}")
    check(not found and len(rank_tapes) >= min_tapes,
          f"phase 19 sanitizer: {len(found)} finding(s), "
          f"{len(rank_tapes)} rank tapes")


def _analysis_remat(cfg, run, data) -> dict:
    """(c) ``REMAT_STEPS`` steps under ``none``, ``full`` and ``dots``
    from the same state (seed 0) on the same batches: losses within
    ``TOL_REMAT`` of ``none``'s, and each step's grad norm (the
    gradient the remat mode's backward gave, before the update); step
    p50 and peak memory of each; K1, K2a and K2b all on ``sm90``.
    Returns the p50 seconds by mode."""
    from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd_dkv,
                                                 lasp2_chunk_bwd_dq,
                                                 lasp2_chunk_fwd)
    from repro_torch.train.step import init_state, make_train_step
    dev = torch.device("cuda")
    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                data.microbatched(i, TRAIN_MICRO).items()}
               for i in range(REMAT_STEPS)]
    out = {}
    for remat in ("none", "full", "dots"):
        rrun = dataclasses.replace(run, remat=remat)
        state = init_state(torch.Generator(device="cuda").manual_seed(0),
                           cfg, run=rrun)
        step = make_train_step(cfg, rrun)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero(*counters)
        losses, norms, walls = [], [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            m = to_host(m)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        launched = _read(counters, counters)
        out[remat] = {"losses": losses, "norms": norms,
                      "p50": float(np.median(walls)),
                      "walls": walls, "launched": launched,
                      "peak": torch.cuda.max_memory_allocated()}
        del state, step
        _free()
    base = out["none"]
    n_lin, _ = _mixer_counts(cfg)

    def gap(remat, key):
        return max(abs(a - b) / abs(b)
                   for a, b in zip(out[remat][key], base[key]))

    for remat, r in out.items():
        err, err_n = gap(remat, "losses"), gap(remat, "norms")
        fwd = 1 if remat == "none" else 2
        per = n_lin * TRAIN_MICRO * REMAT_STEPS
        want = [fwd * per, per, per, fwd * per, 0, per, 0, per, 0]
        log("analysis_remat", remat=remat, steps=REMAT_STEPS,
            batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}", microbatches=TRAIN_MICRO,
            losses=repr([round(x, 5) for x in r["losses"]]),
            grad_norms=repr([round(x, 5) for x in r["norms"]]),
            max_rel_err_loss_vs_none=f"{err:.3e}",
            max_rel_err_grad_norm_vs_none=f"{err_n:.3e}", tol=TOL_REMAT,
            step_ms=repr([round(w * 1e3, 1) for w in r["walls"]]),
            step_p50_ms=f"{r['p50'] * 1e3:.1f}",
            max_memory_allocated_gb=f"{r['peak'] / 1e9:.2f}",
            launches_k1_k2a_k2b_routed=repr(r["launched"]))
        check(err <= TOL_REMAT and err_n <= TOL_REMAT,
              f"phase 19 remat {remat}: losses {r['losses']} vs none "
              f"{base['losses']}, grad norms {r['norms']} vs none "
              f"{base['norms']}")
        check(r["launched"] == want, f"phase 19 remat {remat}: launches "
              f"{r['launched']}; want {want} (K1, K2a, K2b, then each "
              f"sm90/simt)")
    return {k: v["p50"] for k, v in out.items()}


def _analysis_roofline(cfg, run, train_p50_s, decode_ms) -> None:
    """(d) The roofline (counted on the meta device) of phase 7's train
    step and phase 5's decode step of 4 slots beside their walls."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import record
    t0 = time.perf_counter()
    rrun = dataclasses.replace(
        run, microbatch_tokens=TRAIN_BATCH * TRAIN_SEQ // TRAIN_MICRO)
    cells = (("train", ShapeConfig("phase7_train", TRAIN_SEQ, TRAIN_BATCH,
                                   "train"), rrun, train_p50_s * 1e3),
             ("decode", ShapeConfig("phase5_decode", 544, 4, "decode"),
              None, decode_ms))
    for what, shape, r, wall_ms in cells:
        rec = record(cfg.name, shape.name, cfg=cfg, shape=shape, run=r)
        t = rec["terms"]
        bound_ms = t["bound_s"] * 1e3
        log("analysis_roofline", step=what, shape=shape.name,
            flops=f"{rec['per_device']['flops']:.6e}",
            hbm_bytes=f"{rec['per_device']['hbm_bytes']:.6e}",
            compute_ms=f"{t['compute_s'] * 1e3:.3f}",
            memory_ms=f"{t['memory_s'] * 1e3:.3f}",
            collective_ms=f"{t['collective_s'] * 1e3:.3f}",
            dominant=t["dominant"], bound_ms=f"{bound_ms:.3f}",
            measured_ms=f"{wall_ms:.3f}",
            measured_over_bound=f"{wall_ms / bound_ms:.2f}",
            useful_flops_ratio=f"{rec['useful_flops_ratio']:.4f}",
            roofline_fraction=f"{rec['roofline_fraction']:.4f}",
            solve_equals_full_depth=rec["extrapolation"]["equals_full_depth"],
            kernel_launches=repr(rec["kernel_launches_at_checked_A"]).replace(
                " ", ""))
        check(rec["extrapolation"]["equals_full_depth"],
              f"phase 19 roofline {what}: the solve is not exact")
    log("analysis_roofline_wall", counted_on="meta (host)",
        wall_s=f"{time.perf_counter() - t0:.2f}")


def phase_analysis(kernels: list, cfg, train_hist, serve_walls,
                   rank_tapes) -> None:
    """Phase 19: the battery, the sanitizer, ``remat="dots"`` and the
    roofline on ``cfg`` (``CONFIG``) at phase 7's shape."""
    del kernels               # every launch here is a check, not the path
    t0 = time.perf_counter()
    run, data = train_setup(cfg, TRAIN_STEPS, 3e-4)
    walls = {}
    for part, fn in (("a", _analysis_battery),
                     ("b", lambda: _analysis_sanitize(cfg, run, data,
                                                      rank_tapes)),
                     ("c", lambda: _analysis_remat(cfg, run, data))):
        ts = time.perf_counter()
        res = fn()
        walls[part] = round(time.perf_counter() - ts, 1)
        _free()
    remat_p50 = res
    train_p50 = float(np.median([h["dt"] for h in train_hist[1:]]))
    ts = time.perf_counter()
    _analysis_roofline(cfg, run, train_p50, serve_walls["decode"])
    walls["d"] = round(time.perf_counter() - ts, 1)
    log("analysis", phase7_step_p50_ms=f"{train_p50 * 1e3:.1f}",
        remat_p50_ms=repr({k: round(v * 1e3, 1)
                           for k, v in remat_p50.items()}).replace(" ", ""),
        part_walls_s=repr(walls).replace(" ", ""),
        wall_s=f"{time.perf_counter() - t0:.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import LinearAttnConfig, get_config, get_variant
    linear = get_config("linear-llama3-1b")
    hybrid = get_variant("linear-llama3-1b", "HYBRID")
    dense = get_variant("linear-llama3-1b", "DENSE")
    # the paper's variants, built in code as Table 2 builds them
    gla = dataclasses.replace(linear, name=linear.name + "-gla",
                              linear_attn=LinearAttnConfig("silu", "data",
                                                           "autodiff"))
    elu1 = dataclasses.replace(linear, name=linear.name + "-elu1",
                               linear_attn=LinearAttnConfig("elu1", "none",
                                                            "faithful"))
    walls, start = {}, time.perf_counter()

    def timed(n, fn, *args):
        """Phase ``n``: ``fn(*args)``, its wall kept, the device freed."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[n] = round(time.perf_counter() - t0, 1)
        _free()
        return out

    smi = timed(1, phase_facts)
    timed(2, phase_build)

    def kernel_phases():
        kernels = phase_kernels()
        kernels += phase_decode()
        kernels += phase_bwd_kernels(kernels)
        return kernels + phase_flash_kernels()

    kernels = timed(3, kernel_phases)

    def serve(cfg, path, rows, length, steps):
        params = phase_serve(kernels, cfg, path)
        return phase_profile(cfg, params, path, rows, length, steps)

    serve_walls = timed(4, serve, linear, "serve", 4, 512,
                        [0, 40, 100, 200])
    timed(6, serve, hybrid, "hybrid_serve", 1, 300, None)
    train_hist = timed(7, phase_train, kernels, linear, "train")
    timed(8, phase_train, kernels, hybrid, "hybrid_train")
    timed(9, lambda: (
        phase_grad_check(kernels, dataclasses.replace(
            linear, n_layers=2, dtype="float32"), "gradcheck"),
        phase_grad_check(kernels, dataclasses.replace(
            hybrid, n_layers=4, dtype="float32"), "hybrid_gradcheck")))
    sp_ranks = timed(10, phase_sp, kernels, linear, hybrid, gla, train_hist)
    timed(11, phase_strategies, kernels, linear, hybrid, sp_ranks)
    timed(12, phase_variants, kernels, gla, elu1, dense)
    timed(13, phase_ssm, kernels, get_config("mamba2-2.7b"),
          get_config("hymba-1.5b"))
    timed(14, phase_zoo, kernels)
    timed(15, phase_cross, kernels)
    timed(16, phase_runtime, kernels, linear, train_hist)
    usp_tapes = timed(17, phase_usp, kernels, hybrid, sp_ranks)
    serve_sp_tapes = timed(18, phase_serve_sp, kernels, linear, hybrid)
    timed(19, phase_analysis, kernels, linear, train_hist, serve_walls,
          usp_tapes + serve_sp_tapes)
    log("walls", phase_walls_s=repr(walls).replace(" ", ""),
        total_s=f"{time.perf_counter() - start:.1f}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
