"""Constant-memory serving engine with continuous batching.

Twin of ``repro/serve/engine.py``. The decode cache holds,
per linear or mamba2 layer, only the fp32 ``dk × dv`` recurrent state plus
its cumulative log decay (mamba2 also its last d_conv − 1 conv inputs):
O(1) in context length; per softmax layer of a LASP-2H hybrid, a ring of
bf16 K/V as long as the layer's window (hymba: ``max_len``). Prefill
runs the chunked scan (the ``lasp2_chunk_fwd`` kernel on the card) and
flash attention (``flash_attention_fwd``) and lands the final per-layer
states and rings in the cache; decode advances every slot by one
recurrent step (the ``lasp2_decode_step`` kernel, updating the state in
place where the JAX engine donates it) and one ring-attention step.

Scheduling is continuous: a fixed grid of ``max_batch`` decode slots, with
per-step admission of waiting requests (batched prefill, grouped by
bucketed prompt length; by exact length for hybrids, whose softmax layers
would attend left-padding) and per-step eviction of finished ones
(:mod:`repro_torch.serve.scheduler`). Each request samples from its own
``(seed, stream)`` generator, so its tokens do not depend on what it was
batched with.

Under a serving plan (``plan``: ``sharding.rules.make_plan`` on a layout
with ranks, ``launch.mesh.make_serving_groups``) every rank of the plan's
world runs the same engine on the same requests: the scheduler is
deterministic, so their slot decisions agree. The rank holds its shard of
the weights (``sharding.rules.shard_params``) and of the cache
(``M.init_cache(plan=)``). The prompt splits over the SP group (LASP-2
and LASP-2H), and each softmax ring holds this rank's slice of its slots
where the plan places them. Where the plan places decode slots over data
(``plan.rows_place``) the slot grid's rows split over that axis:
admission prefill runs the whole batch and keeps the rows this rank owns
(under a prefill plan whose batch rule splits the batch over the same
axis, and whose blocks land in each rank's own slots, each rank prefills
only its block of rows, ``M.prefill``), each step decodes and samples the
rank's rows (each request with its own generator), and one all-gather
(tag ``serve.tokens``) hands every rank the same tokens, so every rank's
scheduler records the same step. ``cache_stats`` then reports this
rank's bytes. The static path prefills every row on every rank.

Encoder and image models (the cross family) serve through ``generate``
alone, as a static batch: their per-request memories (encoder frames,
image embeddings) do not batch continuously. Rectangular prompts are
prefilled by exact length with the memory (encoded once), then decoded
together; each cross layer's cache holds the memory's K/V.

API::

    engine = ServeEngine(cfg, params, max_len=2048, max_batch=8)
    uid = engine.submit([1, 2, 3], max_new_tokens=32, temperature=0.8)
    results = engine.run()          # {uid: np.ndarray of generated tokens}

    outs = engine.generate(prompts, max_new_tokens=32)   # ragged welcome
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.comm import primitives
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import model as M
from repro_torch.obs.metrics import Metrics, as_sink
from repro_torch.serve.scheduler import (ContinuousScheduler, PrefillBatch,
                                         Request)

_MASK64 = (1 << 64) - 1


def _mix_seed(seed: int, stream: int, step: int) -> int:
    """A 63-bit generator seed from ``(seed, stream, step)`` (splitmix64
    finaliser over the three words), so a request's draw at each step is
    fixed by its own identity alone."""
    x = 0
    for word in (seed, stream, step):
        x = (x ^ (word & _MASK64)) * 0x9E3779B97F4A7C15 & _MASK64
        x ^= x >> 30
        x = x * 0xBF58476D1CE4E5B9 & _MASK64
        x ^= x >> 27
        x = x * 0x94D049BB133111EB & _MASK64
        x ^= x >> 31
    return x >> 1


def _place(big, small, slots, rows=None, mine=None) -> None:
    """Write a prefill's cache tree ``small`` (rows in ``slots`` order, a
    list) into the engine's cache tree ``big``, leaf by leaf, at rows
    ``slots``; nested mixer dicts (hymba's ``attn``/``ssm``) included.
    ``rows`` (first slot, slots held): the plan places the grid's rows
    over an axis, so every leaf but ``pos`` (whole, ``cache_specs``) holds
    this rank's block of them and takes only the rows of its slots.
    ``mine``: the prefill held only the rows of these slots (its split
    rows), so every leaf but ``pos`` holds those rows alone."""
    if isinstance(big, dict):
        for name, sub in small.items():
            if name == "pos":
                _place(big[name], sub, slots)
            else:
                _place(big[name], sub, slots if mine is None else mine,
                       rows)
    elif isinstance(big, list):
        for b, s in zip(big, small):
            _place(b, s, slots, rows)
    elif rows is not None:
        first, n = rows
        own = [(j, s - first) for j, s in enumerate(slots)
               if first <= s < first + n]
        if own:
            src = torch.as_tensor([j for j, _ in own], device=small.device)
            dst = torch.as_tensor([s for _, s in own], device=big.device)
            big[dst] = small[src].to(big.dtype)
    else:
        big[torch.as_tensor(slots, device=big.device)] = small.to(big.dtype)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, plan=None,
                 max_len: int = 2048, max_batch: int = 8,
                 bucket_lengths: Optional[bool] = None, sink=None,
                 max_queue: Optional[int] = None,
                 finished_timeout: Optional[float] = None, device=None):
        """``device``: the CUDA card unless the caller names another one
        (``"cpu"`` in the tests); ``params`` must already live there.
        ``plan``: a serving plan (None: one device)."""
        self.device = resolve_device(device)
        param_dev = params["embed"]["table"].device
        if param_dev.type != self.device.type:
            raise ValueError(f"params on {param_dev}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.max_len = max_len
        self.max_batch = max_batch
        self.sink = as_sink(sink)
        self.metrics = Metrics()
        self._submit_t: Dict[int, float] = {}
        self._ttft: Dict[int, float] = {}
        # Length bucketing left-pads prompts, which is only exact for pure
        # recurrent stacks.
        self.bucket_lengths = M.pad_safe(cfg) if bucket_lengths is None \
            else bucket_lengths
        self.sched = ContinuousScheduler(max_batch, max_len,
                                         bucket_lengths=self.bucket_lengths,
                                         metrics=self.metrics,
                                         max_queue=max_queue,
                                         finished_timeout=finished_timeout)
        # the slot grid is allocated for the cross family too, so its
        # cache_stats() are the reference's
        self._cache = M.init_cache(cfg, max_batch, max_len,
                                   device=self.device, plan=plan)
        # this rank's block of slot rows where the plan places them over
        # data: (its place, first slot, slots held)
        self._rows = None
        place = plan.rows_place(max_batch) if plan is not None else None
        if place is not None:
            n = max_batch // place.size
            self._rows = (place, place.index * n, n)
        self._static = cfg.encoder is not None or bool(cfg.n_image_tokens)
        self._tok = np.zeros((max_batch,), np.int32)
        self._temps = np.zeros((max_batch,), np.float32)
        self._seeds = np.zeros((max_batch, 2), np.int64)   # (seed, stream)
        for kind, nbytes in self.cache_stats().items():
            if not kind.endswith("_arrays"):
                self.metrics.gauge(f"cache_bytes_{kind}", nbytes)

    # -- request API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               seed: int = 0, stream: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue one request; returns its uid. Work happens in step().

        ``(seed, stream)`` names the request's random stream. Raises
        :class:`repro_torch.serve.scheduler.QueueFullError` when the
        bounded admission queue is full, and ``ValueError`` for an encoder
        or image model (those serve through ``generate``)."""
        if self._static:
            raise ValueError(
                f"{self.cfg.name} needs encoder frames or image embeddings "
                f"per request: serve it with generate(..., enc_frames= or "
                f"img_emb=), the static-batch path")
        uid = self.sched.submit(prompt, max_new_tokens,
                                temperature=temperature, eos_id=eos_id,
                                seed=seed, stream=stream,
                                deadline_s=deadline_s)
        self._submit_t[uid] = time.perf_counter()
        return uid

    def step(self) -> List[Request]:
        """One scheduler tick: admit + prefill waiting requests into free
        slots, decode all active slots by one token. Returns the requests
        that finished this tick."""
        finished: List[Request] = list(self.sched.expire())
        for batch in self.sched.admit():
            finished += self._admit(batch)
        if self.sched.active:
            t0 = time.perf_counter()
            mine = slice(None)
            if self._rows is not None:
                mine = slice(self._rows[1], self._rows[1] + self._rows[2])
            logits, self._cache = M.decode_step(
                self.params,
                torch.as_tensor(self._tok[mine], device=self.device),
                self._cache, self.cfg, self.plan,
                rows=None if self._rows is None else self._rows[1:])
            steps = np.array([len(r.tokens) if r is not None else 0
                              for r in self.sched.slots])
            tok = self._sample(logits, self._temps[mine], self._seeds[mine],
                               steps[mine])
            if self._rows is not None:
                tok = primitives.allgather_states(
                    torch.as_tensor(tok, device=self.device),
                    self._rows[0].group, tiled=True,
                    tag="serve.tokens").cpu().numpy()
            synchronize(self.device)
            self.metrics.observe("decode_step_s", time.perf_counter() - t0)
            active = [i for i, r in enumerate(self.sched.slots)
                      if r is not None]
            self.metrics.inc("decode_steps")
            self.metrics.inc("decode_tokens", len(active))
            self._tok[active] = tok[active]
            finished += self.sched.record_step(tok)
        n_active = len(self.sched.active)
        self.metrics.gauge("active_slots", n_active)
        self.metrics.gauge("cache_occupancy", n_active / self.max_batch)
        for r in finished:
            self._finish(r)
        return finished

    def run(self) -> Dict[int, np.ndarray]:
        """Drive step() until all submitted requests finished; returns
        {uid: generated tokens}."""
        done: List[Request] = []
        while self.sched.has_work():
            done += self.step()
        return {r.uid: np.asarray(r.tokens, np.int32) for r in done}

    def _sample(self, logits, temps, seeds, steps) -> np.ndarray:
        """Greedy rows: argmax (first index on ties). Sampled rows: the
        Gumbel-max draw from the row's own ``(seed, stream, step)``
        generator."""
        tok = torch.argmax(logits, dim=-1)
        for i in np.flatnonzero(temps > 0.0):
            g = torch.Generator(device=logits.device).manual_seed(
                _mix_seed(int(seeds[i, 0]), int(seeds[i, 1]), int(steps[i])))
            u = torch.rand(logits.shape[-1], generator=g,
                           device=logits.device).clamp_(min=1e-20)
            gumbel = -torch.log(-torch.log(u))
            tok[i] = torch.argmax(logits[i].float() / float(temps[i])
                                  + gumbel)
        return tok.to(torch.int32).cpu().numpy()

    def _split_rows(self, slots) -> Optional[list]:
        """The slots of this rank's block of an admitted batch's rows where
        the plan's prefill splits them (``plan.prefill_rows_place``) over
        the axis the slot grid's rows split over, and every rank's block
        lands in its own slots; else None (the prefill runs every row and
        each rank keeps the rows of its slots). The same on every rank:
        the slots are."""
        place = self.plan.prefill_rows_place(len(slots)) \
            if self.plan is not None else None
        if place is None or self._rows is None or \
                self.plan.rows_axis(len(slots)) != \
                self.plan.rows_axis(self.max_batch):
            return None
        nb, n = len(slots) // place.size, self._rows[2]
        if any(s // n != j // nb for j, s in enumerate(slots)):
            return None
        return slots[place.index * nb:(place.index + 1) * nb]

    def _admit(self, batch: PrefillBatch) -> List[Request]:
        t0 = time.perf_counter()
        tokens = torch.as_tensor(batch.prompts, device=self.device)
        pad_lens = batch.pad_lens if self.bucket_lengths else None
        slots = [int(s) for s in batch.slots]
        mine = self._split_rows(slots)
        logits, small = M.prefill(self.params, tokens, self.cfg, self.plan,
                                  max_len=self.max_len, pad_lens=pad_lens,
                                  split_rows=mine is not None)
        _place(self._cache, small, slots,
               None if self._rows is None else self._rows[1:], mine)
        temps = np.array([r.temperature for r in batch.requests], np.float32)
        seeds = np.array([[r.seed, r.stream] for r in batch.requests],
                         np.int64)
        tok = self._sample(logits, temps, seeds, [0] * len(batch.requests))
        synchronize(self.device)
        now = time.perf_counter()
        self.metrics.observe("prefill_s", now - t0)
        self.metrics.inc("prefill_batches")
        self.metrics.inc("prefill_tokens", int(batch.prompts.size))
        for j, r in enumerate(batch.requests):
            self._tok[r.slot] = tok[j]
            self._temps[r.slot] = r.temperature
            self._seeds[r.slot] = seeds[j]
            # TTFT: submit() → the first token, sampled here from the
            # prefill logits.
            self._ttft[r.uid] = now - self._submit_t.get(r.uid, t0)
            self.metrics.observe("ttft_s", self._ttft[r.uid])
        return self.sched.record_prefill(batch, tok)

    def _finish(self, req: Request) -> None:
        """Emit the per-request telemetry record (kind="request")."""
        now = time.perf_counter()
        rec: Dict[str, Any] = {
            "kind": "request", "uid": req.uid,
            "prompt_len": req.prompt_len, "new_tokens": len(req.tokens),
            "finish_reason": req.finish_reason,
            "wall_s": now - self._submit_t.pop(req.uid, now),
        }
        ttft = self._ttft.pop(req.uid, None)
        if ttft is not None:
            rec["ttft_s"] = ttft
        self.sink.emit(rec)

    # -- one-shot batch API -------------------------------------------------

    def generate(self, prompts, max_new_tokens: int, *, temperature=0.0,
                 seed: int = 0, img_emb=None, enc_frames=None,
                 eos_id: Optional[int] = None):
        """prompts: (B, S) int (or a ragged list of 1-D prompts).
        Returns (B, max_new_tokens) int32; rows that stop early at EOS are
        padded by repeating their final token. With ``img_emb`` (B, n_img,
        d) or ``enc_frames`` (B, n_frames, d) the static-batch path runs
        (``_generate_static``)."""
        if img_emb is not None or enc_frames is not None:
            return self._generate_static(prompts, max_new_tokens,
                                         temperature=temperature, seed=seed,
                                         img_emb=img_emb,
                                         enc_frames=enc_frames,
                                         eos_id=eos_id)
        if self.sched.has_work():
            raise RuntimeError("generate() needs an idle engine; use "
                               "submit()/run() to mix")
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        uids = [self.submit(p, max_new_tokens, temperature=temperature,
                            eos_id=eos_id, seed=seed, stream=i)
                for i, p in enumerate(prompts)]
        results = self.run()
        out = np.zeros((len(uids), max_new_tokens), np.int32)
        for i, uid in enumerate(uids):
            t = results[uid]
            out[i, :len(t)] = t
            if len(t) < max_new_tokens:      # early EOS: repeat last token
                out[i, len(t):] = t[-1]
        return out

    @torch.no_grad()
    def _generate_static(self, prompts, max_new_tokens, *, temperature,
                         seed, img_emb, enc_frames, eos_id):
        """The reference's static-batch path: rectangular (B, S) prompts
        with ``S + max_new_tokens <= max_len``, one prefill by exact length
        with the memory (the encoder runs once, inside it: the
        reference's second encode feeds nothing decode reads), then a
        decode loop over the whole batch, sampled by ``_sample``: greedy is
        argmax; a positive ``temperature`` draws row ``i``'s step ``t``
        from its own ``(seed, i, t)`` generator, as the continuous path
        does (JAX's key stream cannot be reproduced). At
        EOS a row keeps decoding; once every row has emitted ``eos_id``
        the last tokens repeat to the end, as in the reference."""
        prompts = torch.as_tensor(np.asarray(prompts, np.int32),
                                  device=self.device)
        b, s = prompts.shape
        if s + max_new_tokens > self.max_len:
            raise ValueError("max_len too small")
        t0 = time.perf_counter()
        logits, cache = M.prefill(self.params, prompts, self.cfg, self.plan,
                                  max_len=self.max_len, img_emb=img_emb,
                                  enc_frames=enc_frames, split_rows=False)
        temps = np.full((b,), float(temperature))
        seeds = np.stack([np.full((b,), seed), np.arange(b)], axis=1)
        tok = self._sample(logits, temps, seeds, np.zeros((b,), np.int64))
        self.metrics.observe("prefill_s", time.perf_counter() - t0)
        self.metrics.inc("prefill_batches")
        self.metrics.inc("prefill_tokens", b * s)
        out = []
        done = np.zeros((b,), bool)
        for i in range(max_new_tokens):
            out.append(tok)
            if eos_id is not None:
                done |= out[-1] == eos_id
                if done.all():
                    out.extend([out[-1]] * (max_new_tokens - i - 1))
                    break
            if i == max_new_tokens - 1:
                break
            t0 = time.perf_counter()
            logits, cache = M.decode_step(
                self.params, torch.as_tensor(tok, device=self.device), cache,
                self.cfg, self.plan)
            tok = self._sample(logits, temps, seeds,
                               np.full((b,), i + 1, np.int64))
            self.metrics.observe("decode_step_s", time.perf_counter() - t0)
            self.metrics.inc("decode_steps")
            self.metrics.inc("decode_tokens", b)
        return np.stack(out[:max_new_tokens], axis=1).astype(np.int32)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Flat snapshot of the engine+scheduler telemetry: counters,
        gauges, latency histogram summaries (``decode_step_s_p50`` …
        ``ttft_s_p99``) and the steady-state decode throughput."""
        out = self.metrics.snapshot()
        dec = self.metrics.histograms.get("decode_step_s")
        if dec is not None and dec.total:
            out["decode_tokens_per_s"] = \
                self.metrics.counters.get("decode_tokens", 0) / dec.total
        return out

    def reset_metrics(self) -> None:
        """Drop the accumulated telemetry (e.g. after a warm-up pass, so
        the percentiles reflect the warm path): a fresh registry, shared
        with the scheduler, with the cache gauges seeded again."""
        self.metrics = self.sched.metrics = Metrics()
        for kind, nbytes in self.cache_stats().items():
            if not kind.endswith("_arrays"):
                self.metrics.gauge(f"cache_bytes_{kind}", nbytes)

    def emit_summary(self, **extra) -> Dict[str, Any]:
        """Emit (and return) the run's ``summary`` record through the
        sink: ``stats()`` and the caller's extras, ``component`` "serve"."""
        rec: Dict[str, Any] = {"kind": "summary", "component": "serve"}
        rec.update(self.stats())
        rec.update(extra)
        self.sink.emit(rec)
        return rec

    def cache_stats(self) -> Dict[str, int]:
        """Decode-cache footprint by kind (bytes) plus the tensor count per
        kind (``<kind>_arrays``), by leaf name as the reference counts
        them. ``linear_state`` is per linear or SSD layer
        ``B·H·(dk·dv + 1)·4`` bytes (fp32 state + log decay; for SSD H =
        nh, dk = d_state, dv = headdim), constant in context length and in
        ``max_len``; ``kv_ring`` per softmax or hymba layer
        ``2·B·n_kv·ring·head_dim·2`` (bf16 K/V) ``+ B·ring·4`` (int32
        positions), with ring = min(window, ``max_len``), or ``max_len``
        on every hymba layer; ``conv`` per SSD layer ``B·(d_conv −
        1)·(d_in + 2·ngroups·d_state)·2`` (bf16 conv inputs). A cross
        layer's memory K/V (``2·B·n_kv·n_mem·head_dim·2``) counts under
        ``kv_ring``, as the reference's leaf-name rule counts it."""
        stats = {"linear_state": 0, "kv_ring": 0, "conv": 0, "other": 0}
        arrays = dict.fromkeys(stats, 0)
        for path, t in leaves_with_paths(self._cache["layers"]):
            name = path[-1]
            kind = ("linear_state" if name in ("m", "log_decay")
                    else "kv_ring" if name in ("k", "v", "kpos")
                    else "conv" if name.startswith("conv_") else "other")
            stats[kind] += t.numel() * t.element_size()
            arrays[kind] += 1
        stats["total"] = sum(stats.values())
        stats.update({f"{k}_arrays": n for k, n in arrays.items()})
        return stats
