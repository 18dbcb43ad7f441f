"""Rank bodies and shared inputs of the port's sequence-parallel tests
(``tests/test_torch_lasp2_sp.py``, ``tests/test_torch_sp_step.py``,
``tests/test_torch_usp.py``).

Spawned ranks import this module by name, so it imports only numpy, torch
and ``repro_torch``: the JAX side of those tests runs in their own
reference subprocess. Inputs are made here from a seed with numpy, and
both sides read them from here.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import primitives
from repro_torch.core.linear_attention import RESET_LOG_A

# ---------------------------------------------------------------------------
# Layer level: lasp2, lasp2_with_state, allgather_context_attention.
# ---------------------------------------------------------------------------

WORLDS = (2, 4)
B, H, S, DK, DV = 2, 2, 256, 16, 32
HQ, HKV, DH = 4, 2, 16
# Document starts: 64 is a chunk start at W = 4; 128, a chunk start at
# W = 2 and 4, is not a document start, so no state resets there.
RESETS = (0, 64, 100, 200)
LINEAR_CASES = [(f"causal_{la}_{bwd}", True, la, bwd)
                for la in ("none", "decay", "resets")
                for bwd in ("faithful", "autodiff")] + [
    ("bidir_faithful", False, "none", "faithful"),
    ("bidir_autodiff", False, "none", "autodiff")]
ATTN_CASES = [("attn_causal", True, None), ("attn_window", True, 96),
              ("attn_bidir", False, None)]
PAYLOAD_SEQS = (512, 2048)


def layer_inputs():
    rng = np.random.default_rng(0)
    f32 = lambda x: x.astype(np.float32)
    ins = {"q": f32(rng.standard_normal((B, H, S, DK)) * 0.3),
           "k": f32(rng.standard_normal((B, H, S, DK)) * 0.3),
           "v": f32(rng.standard_normal((B, H, S, DV)) * 0.5),
           "decay": f32(-np.abs(rng.standard_normal((B, H, S))) * 0.03),
           "qs": f32(rng.standard_normal((B, HQ, S, DH)) * 0.5),
           "ks": f32(rng.standard_normal((B, HKV, S, DH)) * 0.5),
           "vs": f32(rng.standard_normal((B, HKV, S, DH)) * 0.5)}
    ins["resets"] = ins["decay"].copy()
    ins["resets"][..., list(RESETS)] = RESET_LOG_A
    return ins


def tape_rows(records):
    """A tape as ``op|tag|payload bytes`` strings (both sides' form)."""
    return [f"{r.op}|{r.tag}|{r.payload_bytes}" for r in records]


def _chunk(x, rank, world, axis):
    c = x.shape[axis] // world
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(rank * c, (rank + 1) * c), axis=axis)))


def _num(ts):
    return [t.detach().numpy() for t in ts]


def layer_rank(rank, world, device, npz_path=None):
    """Every layer-level case on this rank's chunk: outputs, gradients of
    ``sum(sin(o))`` and the tape of the forward and backward; then, with
    the reference's params at ``npz_path``, the model-level cases
    (``model_cases``) under "models"."""
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core.lasp2 import SPConfig, lasp2, lasp2_with_state
    from repro_torch.core.lasp2h import allgather_context_attention

    sp = SPConfig(dist.group.WORLD)
    ins = layer_inputs()
    seq = lambda name: _chunk(ins[name], rank, world, 2)
    res = {}

    def linear(name, causal, la, bwd, spc):
        xs = [seq(n).requires_grad_(True) for n in "qkv"]
        a = None if la == "none" else seq(la).requires_grad_(True)
        with primitives.tape() as rec:
            o = lasp2(*xs, a, sp=spc, causal=causal, backward=bwd)
            grads = torch.autograd.grad(torch.sin(o).sum(),
                                        xs + ([a] if a is not None else []))
        res[name] = {"o": o.detach().numpy(), "grads": _num(grads),
                     "tape": tape_rows(rec)}

    for name, causal, la, bwd in LINEAR_CASES:
        linear(name, causal, la, bwd, sp)
    linear("overlap_none", True, "decay", "faithful",
           SPConfig(dist.group.WORLD, comm=CommSpec(overlap="none")))
    with primitives.tape() as rec:
        o, st = lasp2_with_state(seq("q"), seq("k"), seq("v"), seq("decay"),
                                 sp=sp)
    res["with_state"] = {"o": o.numpy(), "state": st.numpy(),
                         "tape": tape_rows(rec)}
    for name, causal, window in ATTN_CASES:
        xs = [seq(n).requires_grad_(True) for n in ("qs", "ks", "vs")]
        with primitives.tape() as rec:
            o = allgather_context_attention(*xs, sp=sp, causal=causal,
                                            sliding_window=window)
            grads = torch.autograd.grad(torch.sin(o).sum(), xs)
        res[name] = {"o": o.detach().numpy(), "grads": _num(grads),
                     "tape": tape_rows(rec)}
    res["payload"] = {}
    for s in PAYLOAD_SEQS:
        x = torch.ones((1, 2, s // world, 16))
        with primitives.tape() as rec:
            lasp2(x, x, x, sp=sp)
        res["payload"][s] = tape_rows(rec)
    if npz_path is not None:
        res["models"] = model_cases(rank, world, device, npz_path)
    return res


# ---------------------------------------------------------------------------
# Model level: the paper's variants under sequence parallelism.
# ---------------------------------------------------------------------------

# GLA (data decay, packed rows: the autodiff backward) and Table 3's
# bidirectional pair (an elu1 linear model: the faithful Alg. 1/3 path;
# a softmax model: the K/V all-gather with causal=False), at SMOKE's
# widths, 2 layers, fp32.
MODEL_CASES = (("gla", True), ("bidir_linear", False),
               ("bidir_softmax", False))
MODEL_ROWS, MODEL_SEQ = 2, 64


def model_cfg(case, base=None):
    """The case's config from a config module (``repro_torch.configs.base``
    or the reference's ``repro.configs.base``)."""
    if base is None:
        from repro_torch.configs import base
    lac = base.LinearAttnConfig("silu", "data", "autodiff") if case == "gla" \
        else base.LinearAttnConfig("elu1", "none", "faithful")
    mixer = "softmax" if case == "bidir_softmax" else "linear"
    return base.ModelConfig(
        name=f"smoke-{case}", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=512,
        pattern=(base.LayerSpec(mixer=mixer),), linear_attn=lac,
        dtype="float32")


def model_batch(case):
    """GLA: next-token rows with documents starting inside chunks.
    Bidirectional: Table 3's masked tokens (15% become id 0, the other
    labels -1)."""
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 512, (MODEL_ROWS, MODEL_SEQ + 1)).astype(np.int32)
    if case == "gla":
        resets = np.zeros((MODEL_ROWS, MODEL_SEQ), bool)
        resets[:, 0] = True
        resets[0, 21] = resets[1, 40] = True
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "resets": resets}
    inp = toks[:, :-1]
    mask = rng.random(inp.shape) < 0.15
    return {"tokens": np.where(mask, 0, inp).astype(np.int32),
            "labels": np.where(mask, inp, -1).astype(np.int32)}


def ref_keys(tree, cfg):
    """A port tree (one dict per layer) as ``{path: array}`` in the
    reference's layout (layers stacked over groups per pattern position),
    paths joined by "/" as the reference's npz names them."""
    n = len(cfg.pattern)
    out = {f"embed/{k}": v.detach().numpy()
           for k, v in tree["embed"].items()}
    out["final_norm/scale"] = tree["final_norm"]["scale"].detach().numpy()
    for p in range(n):
        layers = tree["layers"][p::n]
        for mod, leaves in layers[0].items():
            for name in leaves:
                out[f"groups/{p}/{mod}/{name}"] = np.stack(
                    [layer[mod][name].detach().numpy() for layer in layers])
    return out


def model_cases(rank, world, device, npz_path):
    """Each ``MODEL_CASES`` model on this rank's chunk of the sequence
    under ``SPConfig(WORLD)``: logits, CE sum, label count, the gradients
    of the CE sum (this rank's part; the ranks' parts sum to the whole)
    and the tape. Rank 0 also runs the whole sequence on one device; GLA
    also runs ``ShardedStep.grads`` at (1, world), whose flat reduced
    gradients come back as a tree."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.lasp2 import SPConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.mesh import make_training_groups
    from repro_torch.models import model as M
    from repro_torch.models.weights import params_from_jax
    from repro_torch.train.step import ShardedStep

    sp = SPConfig(dist.group.WORLD)
    layout = make_training_groups(1, world)
    with np.load(npz_path) as npz:
        trees = {case: params_tree(npz, f"mp_{case}/")
                 for case, _ in MODEL_CASES}
    out = {}
    for case, causal in MODEL_CASES:
        cfg = model_cfg(case)
        params = params_from_jax(trees[case], cfg, device=device,
                                 dtype=torch.float32)
        batch = model_batch(case)
        leaves = [p.requires_grad_(True) for p in _flat_leaves(params)]

        def run(part, spc):
            x = {k: part(v) for k, v in batch.items()}
            logits = M.forward(params, x["tokens"], cfg,
                               resets=x.get("resets"), sp=spc,
                               causal=causal)
            ce, n, _ = M.lm_loss_sum(logits, x["labels"])
            it = iter(torch.autograd.grad(ce, leaves))
            return {"logits": logits.detach()[..., :cfg.vocab_size].numpy(),
                    "ce": float(ce.detach()), "n": int(n),
                    "grads": ref_keys(tree_map(lambda _: next(it), params),
                                      cfg)}

        with primitives.tape() as rec:
            res = run(lambda v: _chunk(v, rank, world, 1), sp)
        res["tape"] = tape_rows(rec)
        if rank == 0:
            res["one_device"] = run(torch.from_numpy, None)
        if case == "gla":
            gflat, _, _ = ShardedStep(cfg, RunConfig(), layout).grads(
                params, {k: v[None] for k, v in batch.items()})
            off = 0

            def piece(p):
                nonlocal off
                off += p.numel()
                return gflat[off - p.numel():off].view_as(p)

            res["sharded_grads"] = ref_keys(tree_map(piece, params), cfg)
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# Layer level: the exchange strategies and the baselines.
# ---------------------------------------------------------------------------

STRATEGIES = ("allgather", "ring", "pipelined", "ulysses")
OVERLAPS = ("overlap", "none")
WIRES = ("fp32", "bf16")
DECAYS = ("none", "decay", "resets")
# Ulysses over W 2 and 4 with GQA 8:4.
UHQ, UHKV = 8, 4
ULYSSES_CASES = [("uly_causal", None, "fp32"), ("uly_window", 96, "fp32"),
                 ("uly_bf16", None, "bf16")]


def strategy_case(strategy, overlap, wire, la):
    return f"{strategy}_{overlap}_{wire}_{la}"


def ulysses_inputs():
    rng = np.random.default_rng(1)
    f32 = lambda x: (x * 0.5).astype(np.float32)
    return {"qu": f32(rng.standard_normal((B, UHQ, S, DH))),
            "ku": f32(rng.standard_normal((B, UHKV, S, DH))),
            "vu": f32(rng.standard_normal((B, UHKV, S, DH)))}


def tape_totals(rows):
    """``op|tag|payload|traffic|steps`` rows summed by op, tag and payload
    into ``{key: [traffic, steps]}``: the port records a hop each call,
    the reference a loop's hops in one record."""
    out = {}
    for row in rows:
        op, tag, pb, traffic, steps = row.split("|")
        t = out.setdefault(f"{op}|{tag}|{pb}", [0, 0])
        t[0] += int(traffic)
        t[1] += int(steps)
    return out


def full_rows(records):
    return [f"{r.op}|{r.tag}|{r.payload_bytes}|{r.traffic_bytes}|{r.steps}"
            for r in records]


def issued_before_compute(seq, sp):
    """Per ``<strategy>_<overlap>``: the records on the tape when the
    strategy calls its intra-chunk ``compute``."""
    from repro_torch.comm.strategy import get_strategy
    from repro_torch.core.linear_attention import (chunk_summaries,
                                                   pick_block)
    k = seq("k")
    m_loc, a_loc = chunk_summaries(k, seq("v"), seq("decay"),
                                   block_size=pick_block(k.shape[-2], 128))
    out = {}
    for strategy in ("allgather", "ring", "pipelined"):
        for overlap in OVERLAPS:
            with primitives.tape() as rec:
                get_strategy(strategy)(
                    m_loc, a_loc, sp.group, sp.chunk_index, overlap,
                    lambda: out.__setitem__(f"{strategy}_{overlap}",
                                            len(rec)), torch.float32)
    return out


def strategies_rank(rank, world, device):
    """Every strategy and baseline case on this rank's chunk: outputs,
    gradients of ``sum(sin(o))`` and the tape (``full_rows``) of the
    forward and backward; and the errors of the causal-only strategies."""
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core import baselines
    from repro_torch.core.lasp2 import SPConfig, lasp2
    from repro_torch.core.lasp2h import ulysses_context_attention

    sp = SPConfig(dist.group.WORLD)
    ins = {**layer_inputs(), **ulysses_inputs()}
    seq = lambda name: _chunk(ins[name], rank, world, 2)
    res = {}

    def run(name, fn, names):
        xs = [seq(n).requires_grad_(True) for n in names]
        with primitives.tape() as rec:
            o = fn(*xs)
            grads = torch.autograd.grad(torch.sin(o).sum(), xs)
        res[name] = {"o": o.detach().numpy(), "grads": _num(grads),
                     "tape": full_rows(rec)}

    for strategy in STRATEGIES:
        for overlap in OVERLAPS:
            for wire in WIRES:
                spc = SPConfig(dist.group.WORLD,
                               comm=CommSpec(strategy, overlap, wire))
                for la in DECAYS:
                    names = "qkv" if la == "none" else ["q", "k", "v", la]
                    run(strategy_case(strategy, overlap, wire, la),
                        lambda *a, s=spc: lasp2(*a, sp=s), names)
    for name, window, wire in ULYSSES_CASES:
        spu = SPConfig(dist.group.WORLD, comm=CommSpec("ulysses", dtype=wire))
        run(name, lambda *a, w=window, s=spu: ulysses_context_attention(
            *a, sp=s, sliding_window=w), ("qu", "ku", "vu"))
    for la in ("none", "decay"):
        names = "qkv" if la == "none" else ["q", "k", "v", la]
        run(f"lasp1_{la}", lambda *a: baselines.lasp1(*a, sp=sp), names)
    run("ring_attn", lambda *a: baselines.ring_attention(*a, sp=sp),
        ("qs", "ks", "vs"))
    run("megatron", lambda *a: baselines.megatron_sp_attention(*a, sp=sp),
        ("qs", "ks", "vs"))
    res["issued"] = issued_before_compute(seq, sp)
    res["errors"] = {}
    for strategy in ("ring", "pipelined"):
        try:
            lasp2(seq("q"), seq("k"), seq("v"), causal=False,
                  sp=SPConfig(dist.group.WORLD, comm=CommSpec(strategy)))
            res["errors"][strategy] = None
        except ValueError as e:
            res["errors"][strategy] = str(e)
    return res


# ---------------------------------------------------------------------------
# Step level: the DP×SP step on SMOKE linear-llama3-1b.
# ---------------------------------------------------------------------------

ARCH = "linear-llama3-1b"
STEP_LAYOUTS = ((1, 4), (2, 2))
N_STEPS = 3
# tests/distributed_checks.py's 2D battery: 8 rows of 64 tokens, seed 3,
# 2 microbatches, no remat, lr 1e-3 with 2 warm-up steps.
RUN = dict(num_microbatches=2, remat="none", total_steps=10, warmup_steps=2,
           learning_rate=1e-3)
DATA = dict(seq_len=64, global_batch=8, seed=3)


def step_cfg():
    """SMOKE in fp32: the two frameworks round bf16 at other points."""
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(ARCH), dtype="float32")


def hybrid_step_cfg(base=None, layer_spec=None):
    """SMOKE's widths as a 4-layer hybrid (3 linear + 1 softmax layer with
    the hybrid's 2048-token window), fp32: the port's, or the
    reference's from its ``base`` SMOKE and ``LayerSpec``."""
    if base is None:
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import LayerSpec
        base, layer_spec = get_smoke(ARCH), LayerSpec
    dense = dataclasses.replace(base, pattern=(layer_spec(),), n_layers=4,
                                name="smoke-dense", dtype="float32")
    return dense.linearize(hybrid_every=4)


def params_tree(npz, prefix="param/"):
    """The reference's initial params (``<prefix><path>`` entries of the
    reference's npz) as the nested dict ``params_from_jax`` reads."""
    tree = {}
    for key in npz.files:
        if key.startswith(prefix):
            *path, leaf = key.split("/")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return tree


def _batches(drop_resets=False):
    from repro_torch.data.pipeline import SyntheticLM
    cfg = step_cfg()
    data = SyntheticLM(cfg.vocab_size, DATA["seq_len"], DATA["global_batch"],
                       seed=DATA["seed"])
    out = []
    for i in range(N_STEPS + 1):
        b = data.microbatched(i, RUN["num_microbatches"])
        if drop_resets:
            b.pop("resets")
        out.append(b)
    return out


def _params(npz_path, device, hybrid=False):
    from repro_torch.models.weights import params_from_jax
    with np.load(npz_path) as npz:
        tree = params_tree(npz, "hparam/" if hybrid else "param/")
    return params_from_jax(tree, hybrid_step_cfg() if hybrid else step_cfg(),
                           device=device, dtype=torch.float32)


def _steps(npz_path, device, layout, n, drop_resets=False, hybrid=False,
           **run_kw):
    """``n`` steps from the reference's params (of SMOKE, or of the
    hybrid cut); returns (state, losses, tape of the first step)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import (make_train_step, state_from_params,
                                        zero1_degree)
    run = RunConfig(**{**RUN, **run_kw})
    state = state_from_params(_params(npz_path, device, hybrid),
                              zero1_degree(run, layout))
    step = make_train_step(hybrid_step_cfg() if hybrid else step_cfg(), run,
                           layout)
    losses, first = [], None
    for i, batch in enumerate(_batches(drop_resets)[:n]):
        with primitives.tape() as rec:
            state, m = step(state, batch)
        first = first if first is not None else tape_rows(rec)
        losses.append(m["loss"])
    return state, losses, first


# The precision cells: SMOKE in bf16 compute at (2, 2) with ZeRO-1 under
# each of RunConfig's precision fields and both, and with neither (the
# tape they are held to).
PRECISION_FLAGS = {"none": {}, "cast_once": dict(cast_params_once=True),
                   "bf16_params": dict(bf16_params=True),
                   "both": dict(cast_params_once=True, bf16_params=True)}
FP32_WIRE_TAGS = ("train.grads", "zero1.param_gather")


def precision_cfg(get_smoke=None):
    """SMOKE in its own bf16 compute: the port's, or the reference's
    from its ``get_smoke``."""
    if get_smoke is None:
        from repro_torch.configs import get_smoke
    return get_smoke(ARCH)


def _precision_steps(npz_path, device, layout):
    """N_STEPS bf16-compute steps from the reference's params under each
    ``PRECISION_FLAGS`` setting: losses, grad norms, the first step's tape,
    the wire dtypes of its gradient reduction and param gather, and the
    params' dtypes after the steps. The ranks of token chunk 0 also return
    the trajectory: each step's lr, params (flat, fp32) and this rank's
    ZeRO-1 slices of the moments, with the leaves' paths and shapes and
    the slice's index."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.train.step import (make_train_step, state_from_params,
                                        zero1_degree)
    keep = layout.chunk_index == 0
    out = {}
    for name, flags in PRECISION_FLAGS.items():
        run = RunConfig(**RUN, **flags)
        state = state_from_params(_params(npz_path, device),
                                  zero1_degree(run, layout), run)
        step = make_train_step(precision_cfg(), run, layout)
        res = {"losses": [], "gnorms": [], "tape": None, "steps": []}
        for batch in _batches()[:N_STEPS]:
            with primitives.tape() as rec:
                state, m = step(state, batch)
            if res["tape"] is None:
                res["tape"] = tape_rows(rec)
                res["wire"] = [(r.tag, r.dtype) for r in rec
                               if r.tag in FP32_WIRE_TAGS]
            res["losses"].append(m["loss"])
            res["gnorms"].append(m["grad_norm"])
            if keep:
                res["steps"].append({
                    "lr": float(m["lr"]),
                    "params": _flat(state["params"]).numpy(),
                    "m": state["opt"].m.detach().clone().numpy(),
                    "v": state["opt"].v.detach().clone().numpy()})
        leaves = leaves_with_paths(state["params"])
        res["paths"] = [path for path, _ in leaves]
        res["shapes"] = [tuple(p.shape) for _, p in leaves]
        res["zero_index"] = layout.zero_index
        res["param_dtypes"] = sorted({str(p.dtype).replace("torch.", "")
                                      for p in _flat_leaves(state["params"])})
        res["opt_type"] = type(state["opt"]).__name__
        out[name] = res
    return out


def _flat(tree):
    from repro_torch.core.tree import leaves_with_paths
    return torch.cat([t.detach().reshape(-1).float()
                      for _, t in leaves_with_paths(tree)])


# The guarded cells: NaN gradients at step GUARD_NAN_STEP of N_STEPS.
GUARD_NAN_STEP = 1
GUARD_KEYS = ("skipped", "skipped_steps", "consecutive_skips", "guard_spike",
              "guard_median")
# Checkpoints across layouts: CKPT_STEPS steps saved, then resumed to
# CKPT_TOTAL, against an uninterrupted CKPT_TOTAL-step run; guard on, so
# the guard's state travels in the checkpoint too.
CKPT_STEPS, CKPT_TOTAL = 2, 4


def _guarded_steps(npz_path, device, layout, **run_kw):
    """N_STEPS guarded steps: losses, the guard's metrics per step and the
    first step's tape."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import (make_train_step, state_from_params,
                                        zero1_degree)
    run = RunConfig(**{**RUN, "guard": True, **run_kw})
    state = state_from_params(_params(npz_path, device),
                              zero1_degree(run, layout), run)
    step = make_train_step(step_cfg(), run, layout)
    out = {"losses": [], "metrics": [], "tape": None}
    for batch in _batches()[:N_STEPS]:
        with primitives.tape() as rec:
            state, m = step(state, batch)
        out["tape"] = out["tape"] or tape_rows(rec)
        out["losses"].append(m["loss"])
        out["metrics"].append([m[k] for k in GUARD_KEYS])
    return out


def ckpt_train(npz_path, device, layout, steps, ckpt_dir=None, sink=None,
               wrap=None):
    """``train()`` of the step config from the reference's params, guard
    on, checkpoints every CKPT_STEPS steps into ``ckpt_dir``, up to step
    ``steps`` (a run resumes from ``ckpt_dir``'s newest checkpoint), on
    the data ``wrap`` returns when it is given. Returns ``{step: loss}``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.loop import train
    cfg = step_cfg()
    data = SyntheticLM(cfg.vocab_size, DATA["seq_len"], DATA["global_batch"],
                       seed=DATA["seed"])
    if wrap is not None:
        data = wrap(data)
    _, hist = train(cfg, RunConfig(**RUN, guard=True), data, device=device,
                    params=_params(npz_path, device), layout=layout,
                    ckpt_dir=ckpt_dir, ckpt_every=CKPT_STEPS,
                    max_steps=steps, sink=sink, log_every=10 ** 9,
                    log_fn=lambda *_: None)
    return {h["step"]: h["loss"] for h in hist}


def _copy_ckpt(root, src, dst):
    """Rank 0 copies checkpoint directory ``src`` to ``dst`` (a resume
    writes its own checkpoints); every rank waits for the copy."""
    import os
    import shutil
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, src), os.path.join(root, dst))
    dist.barrier()
    return os.path.join(root, dst)


def ckpt_faults(npz_path, device, layout, root):
    """Faults of a multi-rank run with checkpoints, at (2, 2) with ZeRO-1:
    SIGTERM on rank 1 alone while step 0's batch is fetched (every rank
    must stop after step 0 and join the final save of step 1; the run
    then resumes to CKPT_TOTAL), and every write of rank 0 failing (every
    rank must raise at the step whose save surfaces the error, not hang
    in the final save's gather). Returns what each saw."""
    import os

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.resilience import chaos
    out = {}
    d = os.path.join(root, "dp2sp2_sigterm")
    wrap = (lambda data: chaos.InterruptData(data, at_step=0)) \
        if dist.get_rank() == 1 else None
    out["sigterm_steps"] = sorted(ckpt_train(npz_path, device, layout,
                                             CKPT_TOTAL, d, wrap=wrap))
    dist.barrier()
    out["sigterm_ckpts"] = CheckpointManager(d).all_steps()
    out["sigterm_resumed"] = ckpt_train(npz_path, device, layout,
                                        CKPT_TOTAL, d)

    def fail(*_a, **_k):
        raise OSError("injected write failure")
    original = CheckpointManager._write_with_retry
    if dist.get_rank() == 0:
        CheckpointManager._write_with_retry = fail
    try:
        ckpt_train(npz_path, device, layout, CKPT_TOTAL,
                   os.path.join(root, "dp2sp2_failed"))
        out["write_failure"] = None
    except (OSError, RuntimeError) as e:
        out["write_failure"] = type(e).__name__
    finally:
        CheckpointManager._write_with_retry = original
    return out


def bypass_drift(layout):
    """A primitive's all-reduce and one made straight to
    ``torch.distributed``, under the tape and the issued view: the issued
    view counts both (the second with no tag), and the flight recorder
    flags the one the tape never recorded; after the block the entry
    point is ``torch.distributed``'s own again."""
    from repro_torch.obs import FlightRecorder
    before = dist.all_reduce
    with primitives.tape() as taped, primitives.issued() as sent:
        primitives.psum_packed(torch.ones(4), layout.world_group,
                               tag="probe")
        dist.all_reduce(torch.ones(2), group=layout.world_group)
    snap = FlightRecorder(None).on_compile(records=taped, issued=sent)
    return {"drift": snap.drift, "tags": [r.tag for r in sent],
            "bytes": [r.nbytes for r in sent],
            "restored": dist.all_reduce is before}


def step_rank(rank, world, device, dp, sp, npz_path, ckpt_root=None):
    """The step-level cases of one (dp, sp) layout on this rank."""
    from repro_torch.launch.mesh import make_training_groups
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamState, Zero1AdamState

    layout = make_training_groups(dp, sp)
    res = {"layout": (layout.data_index, layout.chunk_index)}
    state, res["losses"], res["tape"] = _steps(npz_path, device, layout,
                                               N_STEPS)
    res["opt_type"] = type(state["opt"]).__name__
    if dp == 1:
        # rows without resets: the faithful backward
        _, res["faithful_losses"], res["faithful_tape"] = _steps(
            npz_path, device, layout, N_STEPS, drop_resets=True)
        _, res["bf16_losses"], res["bf16_tape"] = _steps(
            npz_path, device, layout, N_STEPS, comm_dtype="bf16")
        _, res["ring_losses"], res["ring_tape"] = _steps(
            npz_path, device, layout, N_STEPS, comm_strategy="ring")
        # remat="full" replays each layer's forward exchange in backward
        params = _params(npz_path, device)
        batch = _batches()[0]
        tok = _chunk(batch["tokens"][0], layout.chunk_index, sp, 1)
        lab = _chunk(batch["labels"][0], layout.chunk_index, sp, 1)
        from repro_torch.core.lasp2 import SPConfig
        spc = SPConfig(layout.sp_group)
        leaves = [p.requires_grad_(True) for p in _flat_leaves(params)]
        counts = {}
        for remat in ("none", "full"):
            with primitives.tape() as rec:
                loss, _, _ = M.lm_loss_sum(
                    M.forward(params, tok, step_cfg(), remat=remat, sp=spc),
                    lab)
                torch.autograd.grad(loss, leaves)
            counts[remat] = sum(r.tag == "lasp2.states" for r in rec)
        res["remat_counts"] = counts
    else:
        s_z, l_z, _ = _steps(npz_path, device, layout, 2)
        s_r, l_r, _ = _steps(npz_path, device, layout, 2, zero1=False)
        res["zero1_losses"], res["replicated_losses"] = l_z, l_r
        a, b = _flat(s_z["params"]), _flat(s_r["params"])
        res["zero1_param_diff"] = float((a - b).abs().max())
        res["zero1_params_close"] = bool(torch.allclose(a, b, rtol=1e-6,
                                                        atol=1e-7))
        assert isinstance(s_z["opt"], Zero1AdamState)
        assert isinstance(s_r["opt"], AdamState)
        res["nonfinite"] = _nonfinite(npz_path, device, layout)
        _, res["ulysses_losses"], res["ulysses_tape"] = _steps(
            npz_path, device, layout, N_STEPS, hybrid=True,
            comm_strategy="ulysses")
        res["guard_nan"] = _guarded_steps(npz_path, device, layout,
                                          chaos_nan_steps=(GUARD_NAN_STEP,))
        res["guard_clean"] = _guarded_steps(npz_path, device, layout)
        res["precision"] = _precision_steps(npz_path, device, layout)
        # checkpoints at (2, 2) with ZeRO-1, with the flight recorder on
        # rank 0
        from repro_torch.obs import InMemorySink
        import os
        sink = InMemorySink() if rank == 0 else None
        res["ckpt_full"] = ckpt_train(npz_path, device, layout, CKPT_TOTAL)
        ckpt_train(npz_path, device, layout, CKPT_STEPS,
                   os.path.join(ckpt_root, "dp2sp2"), sink=sink)
        res["records"] = sink.records if sink is not None else None
        res.update(ckpt_faults(npz_path, device, layout, ckpt_root))
        res["bypass"] = bypass_drift(layout)
        res["sanitizer"] = sanitized_steps(npz_path, device, layout)
    return res


def sanitized_steps(npz_path, device, layout):
    """The sanitizer over two bf16-wire steps at this layout, each with a
    fresh step (SAN201 to SAN205 as ``analysis.sanitizer.sanitize_train``
    checks them), and SAN203 on the first tape with a planted fp32 state
    gather."""
    from repro_torch.analysis.sanitizer import (check_wire, fingerprint,
                                                sanitize_train)
    from repro_torch.comm.primitives import CommRecord
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import state_from_params, zero1_degree
    run = RunConfig(**{**RUN, "comm_dtype": "bf16"})
    state = state_from_params(_params(npz_path, device),
                              zero1_degree(run, layout))
    found, tapes, _ = sanitize_train("train_step[dp=2,sp=2]", step_cfg(),
                                     run, state, _batches()[0], layout)
    planted = tapes[0] + [CommRecord("all-gather", 4, 4, 1, 2,
                                     tag="lasp2.states", dtype="float32",
                                     shape=(1,))]
    return {"findings": [str(f) for f in found],
            "planted": [f.code for f in check_wire("planted", planted,
                                                   "bf16")],
            "records": len(tapes[0]),
            "bf16": sum(r.dtype == "bfloat16" for r in tapes[0]),
            "same": fingerprint(tapes[0]) == fingerprint(tapes[1])}


def _flat_leaves(tree):
    from repro_torch.core.tree import leaves_with_paths
    return [t for _, t in leaves_with_paths(tree)]


def _nonfinite(npz_path, device, layout):
    """A NaN in the params on every rank: the step is skipped everywhere;
    params, moments and the Adam count stay, the step advances."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import (make_train_step, state_from_params,
                                        zero1_degree)
    run = RunConfig(**RUN)
    state = state_from_params(_params(npz_path, device),
                              zero1_degree(run, layout))
    with torch.no_grad():
        state["params"]["embed"]["table"][0, 0] = float("nan")
    tensors = lambda st: [t for t in _flat_leaves(
        {"p": st["params"], "o": st["opt"]}) if isinstance(t, torch.Tensor)]
    before = [t.detach().clone() for t in tensors(state)]
    new, m = make_train_step(step_cfg(), run, layout)(state, _batches()[0])
    same = all(torch.equal(a.detach(), b) or torch.allclose(
        a.detach(), b, rtol=0, atol=0, equal_nan=True)
        for a, b in zip(tensors(new), before))
    return {"skipped": m["skipped"], "step": new["step"],
            "count": new["opt"].count, "frozen": same}


# ---------------------------------------------------------------------------
# Step level: the SSM family (mamba2, hymba) at (1, 2).
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
# a dense decoder of the zoo (GQA 4:2, GELU-free SMOKE) through the same
# cells: its softmax layers take LASP-2H's K/V all-gather
ZOO_ARCHS = ("starcoder2-15b",)
SSM_PREFIX = {"mamba2-2.7b": "mparam/", "hymba-1.5b": "yparam/",
              "starcoder2-15b": "sparam/"}


def ssm_step_cfg(arch, get_smoke=None):
    """The arch's SMOKE in fp32: the port's, or the reference's from its
    ``get_smoke``."""
    if get_smoke is None:
        from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(arch), dtype="float32")


def ssm_steps(npz_path, device, arch, layout):
    """N_STEPS steps of ``arch``'s SMOKE from the reference's params, on
    packed rows (the autodiff backward under SP), on ``layout`` (None: the
    one-device step): losses, grad norms and the first step's tape."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.weights import params_from_jax
    from repro_torch.train.step import (make_train_step, state_from_params,
                                        zero1_degree)
    cfg = ssm_step_cfg(arch)
    with np.load(npz_path) as npz:
        tree = params_tree(npz, SSM_PREFIX[arch])
    run = RunConfig(**RUN)
    state = state_from_params(
        params_from_jax(tree, cfg, device=device, dtype=torch.float32),
        zero1_degree(run, layout))
    step = make_train_step(cfg, run, layout)
    data = SyntheticLM(cfg.vocab_size, DATA["seq_len"],
                       DATA["global_batch"], seed=DATA["seed"])
    res = {"losses": [], "gnorms": [], "tape": None}
    for i in range(N_STEPS):
        with primitives.tape() as rec:
            state, m = step(state, data.microbatched(
                i, RUN["num_microbatches"]))
        if res["tape"] is None:
            res["tape"] = tape_rows(rec)
        res["losses"].append(m["loss"])
        res["gnorms"].append(m["grad_norm"])
    return res


def ssm_rank(rank, world, device, npz_path, ckpt_root=None):
    """Both SSM SMOKE models and the zoo's at (dp, sp) = (1, ``world``) on
    this rank; then the checkpoints across layouts: save at (1, 2), resume
    at (1, 2) a one-device checkpoint and at (2, 1) the (2, 2) run's."""
    import os
    from repro_torch.launch.mesh import make_training_groups
    layout = make_training_groups(1, world)
    out = {arch: ssm_steps(npz_path, device, arch, layout)
           for arch in SSM_ARCHS + ZOO_ARCHS}
    dp_layout = make_training_groups(world, 1)
    out["ckpt_full"] = ckpt_train(npz_path, device, layout, CKPT_TOTAL)
    ckpt_train(npz_path, device, layout, CKPT_STEPS,
               os.path.join(ckpt_root, "dp1sp2"))
    out["resume_dev1_at_dp1sp2"] = ckpt_train(
        npz_path, device, layout, CKPT_TOTAL,
        _copy_ckpt(ckpt_root, "dev1", "dev1_to_dp1sp2"))
    out["resume_dp2sp2_at_dp2sp1"] = ckpt_train(
        npz_path, device, dp_layout, CKPT_TOTAL,
        _copy_ckpt(ckpt_root, "dp2sp2", "dp2sp2_to_dp2sp1"))
    return out


# ---------------------------------------------------------------------------
# The 3D DP×SP×TP layout (USP Ulysses, ZeRO-1 over (data, model)) and the
# windowed halo attention.
# ---------------------------------------------------------------------------

# tests/distributed_checks.py's _cfg3d: a linear and a softmax layer, GQA
# 4:2, fp32 here; 8 rows of 64 tokens, seed 5; 1 microbatch, lr 1e-3.
RUN3D = dict(num_microbatches=1, remat="none", total_steps=10,
             warmup_steps=2, learning_rate=1e-3)
DATA3D = dict(seq_len=64, global_batch=8, seed=5)
N3D = 3
# each cell: (name, (dp, sp, tp), strategy); the 4-rank ones run in one
# spawn, (2, 2, 2) in an 8-rank one
CELLS3D = (("dp1sp2tp2_ulysses", (1, 2, 2), "ulysses"),
           ("dp1sp2tp2_allgather", (1, 2, 2), "allgather"),
           ("dp2sp1tp2_ulysses", (2, 1, 2), "ulysses"),
           ("dp1sp4tp1_allgather", (1, 4, 1), "allgather"),
           ("dp2sp2tp2_ulysses", (2, 2, 2), "ulysses"))
ZERO1_CELLS = ("dp1sp2tp2_ulysses", "dp2sp1tp2_ulysses")
# the halo cases: (window, halo mode) at W 2 and 4 over S 256
HALO_WINDOWS = (32, 64)
HALO_MODES = ("ppermute", "gather")


def cfg3d(base=None):
    """The 3D battery's hybrid SMOKE, fp32: from the port's config module
    or the reference's (``base``)."""
    if base is None:
        from repro_torch.configs import base
    return base.ModelConfig(
        name="hybrid-smoke", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512,
        pattern=(base.LayerSpec(mixer="linear"),
                 base.LayerSpec(mixer="softmax")),
        linear_attn=base.LinearAttnConfig(feature_map="identity",
                                          decay="none"),
        dtype="float32")


def data3d(pkg_data=None):
    if pkg_data is None:
        from repro_torch.data import pipeline as pkg_data
    return pkg_data.SyntheticLM(512, DATA3D["seq_len"],
                                DATA3D["global_batch"], seed=DATA3D["seed"])


def group_rows(records):
    """A tape as ``op|tag|group size`` strings."""
    return [f"{r.op}|{r.tag}|{r.group}" for r in records]


def params3d(npz_path, device):
    from repro_torch.models.weights import params_from_jax
    with np.load(npz_path) as npz:
        tree = params_tree(npz, "p3d/")
    return params_from_jax(tree, cfg3d(), device=device, dtype=torch.float32)


def steps3d(npz_path, device, layout, n=N3D, **run_kw):
    """``n`` steps of the 3D battery's hybrid from the reference's params
    on ``layout`` (None: one device): losses, grad norms, the first step's
    tape (``op|tag|payload`` and ``op|tag|group size`` rows), the state."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import (make_train_step, state_from_params,
                                        zero1_degree)
    run = RunConfig(**{**RUN3D, **run_kw})
    state = state_from_params(params3d(npz_path, device),
                              zero1_degree(run, layout))
    step = make_train_step(cfg3d(), run, layout)
    data = data3d()
    out = {"losses": [], "gnorms": [], "tape": None, "groups": None}
    for i in range(n):
        with primitives.tape() as rec:
            state, m = step(state, data.microbatched(
                i, RUN3D["num_microbatches"]))
        if out["tape"] is None:
            out["tape"], out["groups"] = tape_rows(rec), group_rows(rec)
        out["losses"].append(m["loss"])
        out["gnorms"].append(m["grad_norm"])
    return out, state


def ckpt3d(npz_path, device, layout, steps, ckpt_dir=None, zero1=True):
    """``train()`` of the 3D battery under "ulysses" with the guard, a
    checkpoint every 2 steps into ``ckpt_dir``, up to step ``steps`` (a
    run resumes from ``ckpt_dir``'s newest). Returns ``{step: loss}``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.loop import train
    run = RunConfig(**RUN3D, guard=True, comm_strategy="ulysses",
                    zero1=zero1)
    _, hist = train(cfg3d(), run, data3d(), device=device,
                    params=params3d(npz_path, device), layout=layout,
                    ckpt_dir=ckpt_dir, ckpt_every=2, max_steps=steps,
                    log_every=10 ** 9, log_fn=lambda *_: None)
    return {h["step"]: h["loss"] for h in hist}


def halo_cases(rank, group):
    """``windowed_context_attention`` on this rank's chunk of S over
    ``group`` at every window and halo mode: o, the gradients of
    ``sum(sin(o))`` and the tape."""
    from repro_torch.core.lasp2 import SPConfig
    from repro_torch.core.lasp2h import windowed_context_attention
    sp = SPConfig(group)
    w, t = sp.degree, sp.chunk_index
    ins = layer_inputs()
    res = {}
    for window in HALO_WINDOWS:
        for mode in HALO_MODES:
            xs = [_chunk(ins[n], t, w, 2).requires_grad_(True)
                  for n in ("qs", "ks", "vs")]
            with primitives.tape() as rec:
                o = windowed_context_attention(*xs, window, sp=sp,
                                               halo_mode=mode)
                grads = torch.autograd.grad(torch.sin(o).sum(), xs)
            res[f"w{window}_{mode}"] = {"o": o.detach().numpy(),
                                        "grads": _num(grads),
                                        "tape": tape_rows(rec)}
    return res


def _zero1_pair(npz_path, device, layout):
    """2 steps under "ulysses" with ZeRO-1 and with replicated AdamW."""
    (z, s_z), (r, s_r) = (steps3d(npz_path, device, layout, 2,
                                  comm_strategy="ulysses", zero1=zero1)
                          for zero1 in (True, False))
    a, b = _flat(s_z["params"]), _flat(s_r["params"])
    return {"zero1_losses": z["losses"], "replicated_losses": r["losses"],
            "opt_numel": s_z["opt"].m.numel(), "param_numel": a.numel(),
            "param_diff": float((a - b).abs().max()),
            "params_close": bool(torch.allclose(a, b, rtol=1e-6,
                                                atol=1e-7))}


def usp_rank(rank, world, device, npz_path, ckpt_root):
    """Every 3D case of the ``world``-rank layouts on this rank: at world 4
    the (1, 2, 2), (2, 1, 2), (1, 4, 1) and (2, 2) layouts (steps, ZeRO-1,
    checkpoints crossing 3D and 2D, the refusal of the ring on 3D, the
    halo cases at W 4 over the world and W 2 over (2, 2)'s SP pairs); at
    world 8 the (2, 2, 2) layout (steps, the forward's wire bytes under
    "ulysses" and "allgather")."""
    import os

    from repro_torch.launch.mesh import make_training_groups
    cells = [c for c in CELLS3D
             if c[1][0] * c[1][1] * c[1][2] == world]
    layouts = {dims: make_training_groups(*dims) for _, dims, _ in cells}
    res = {"place": {dims: (lay.data_index, lay.seq_index,
                            lay.chunk_index % lay.tp, lay.zero_index)
                     for dims, lay in layouts.items()}}
    for name, dims, strategy in cells:
        res[name], _ = steps3d(npz_path, device, layouts[dims],
                               comm_strategy=strategy)
    if world == 8:
        res["wire"] = wire_bytes(npz_path, device, layouts[(2, 2, 2)])
        return res
    for name, dims, _ in CELLS3D:
        if name in ZERO1_CELLS:
            res[f"{name}_zero1"] = _zero1_pair(npz_path, device,
                                               layouts[dims])
    res["ring_refusal"] = _ring_refusal(layouts[(1, 2, 2)])
    # checkpoints: (1, 2, 2) <-> (2, 2) with ZeRO-1 of degree 2 on both
    # sides; one device <-> (1, 2, 2) with replicated moments (a ZeRO-1
    # checkpoint holds flat moments, one device's a tree: each refuses the
    # other, in both packages)
    l3, l2 = layouts[(1, 2, 2)], make_training_groups(2, 2)
    res["full_122"] = ckpt3d(npz_path, device, l3, 4)
    res["full_22"] = ckpt3d(npz_path, device, l2, 4)
    ckpt3d(npz_path, device, l3, 2, os.path.join(ckpt_root, "d122"))
    ckpt3d(npz_path, device, l3, 2, os.path.join(ckpt_root, "d122rep"),
           zero1=False)
    ckpt3d(npz_path, device, l2, 2, os.path.join(ckpt_root, "d22"))
    res["d122_at_22"] = ckpt3d(npz_path, device, l2, 4, _copy_ckpt(
        ckpt_root, "d122", "d122_at_22"))
    res["d22_at_122"] = ckpt3d(npz_path, device, l3, 4, _copy_ckpt(
        ckpt_root, "d22", "d22_at_122"))
    res["dev1_at_122"] = ckpt3d(npz_path, device, l3, 4, _copy_ckpt(
        ckpt_root, "dev1", "dev1_at_122"), zero1=False)
    res["dev1_at_122_zero1"] = _refused_resume(
        npz_path, device, l3, _copy_ckpt(ckpt_root, "dev1",
                                         "dev1_at_122_zero1"))
    res["halo4"] = halo_cases(rank, dist.group.WORLD)
    res["halo2"] = halo_cases(rank, l2.sp_group)
    return res


def _refused_resume(npz_path, device, layout, ckpt_dir):
    """A resume that must fail: the error's type, or "resumed"."""
    from repro_torch.checkpoint.manager import CheckpointError
    try:
        ckpt3d(npz_path, device, layout, 4, ckpt_dir)
    except CheckpointError as e:
        return type(e).__name__
    return "resumed"


def _ring_refusal(layout):
    """``lasp2`` under "ring" on the 3D layout's split: the message."""
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core.lasp2 import SPConfig, lasp2
    sp = SPConfig(layout.sp_group, comm=CommSpec(strategy="ring"),
                  tp_group=layout.tp_group, seq_group=layout.seq_group)
    x = torch.ones((1, 2, 16, 16))
    try:
        lasp2(x, x, x, sp=sp)
    except ValueError as e:
        return str(e)
    return "no error"


def wire_bytes(npz_path, device, layout):
    """The hybrid's forward on this rank's rows and chunk under "ulysses"
    (the 3D split) and "allgather" (the token group alone): the tape's
    rows of the softmax layer's exchange (``ulysses.*``, ``lasp2h.*``)
    and their traffic bytes."""
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core.lasp2 import SPConfig
    from repro_torch.models import model as M
    from repro_torch.train.step import shard_batch
    batch = shard_batch({k: torch.as_tensor(v) for k, v in
                         data3d().microbatched(0, 1).items()}, layout)
    params = params3d(npz_path, device)
    out = {}
    for strategy, prefix in (("ulysses", "ulysses."),
                             ("allgather", "lasp2h.")):
        sp = SPConfig(layout.sp_group, comm=CommSpec(strategy=strategy),
                      tp_group=layout.tp_group, seq_group=layout.seq_group)
        with torch.no_grad(), primitives.tape() as rec:
            M.forward(params, batch["tokens"][0], cfg3d(), sp=sp)
        mine = [r for r in rec if r.tag.startswith(prefix)]
        out[strategy] = {"rows": tape_rows(mine),
                         "bytes": sum(r.traffic_bytes for r in mine)}
    return out
