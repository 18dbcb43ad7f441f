"""Rank bodies and shared inputs of ``tests/test_torch_serve_sp.py``:
serving under a plan on gloo ranks.

Spawned ranks import this module by name, so it imports only numpy, torch
and ``repro_torch`` (the JAX side runs in the test's reference
subprocess, which builds its configs and inputs from here too). Configs
are built by functions that take a package's ``get_smoke``, ``LayerSpec``
and ``LinearAttnConfig``, so both packages get the same ones.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.comm import primitives

W = 4                                   # ranks of the serving layouts
MAX_LEN = 128                           # engine and prefill ring length
NEW_TOKENS = 6
PROMPT_LENS = (64, 32, 31)              # 31 does not divide W
PREFILL_B, PREFILL_S = 2, 64
PAD_LENS = (1, 37)                      # resets in chunk 0 and chunk 2
DECODE_STEPS = 3

# sharded_decode_attention (the reference's distributed check) and
# ring_decode_attention inputs
DEC_B, DEC_HQ, DEC_HKV, DEC_S, DEC_DH = 2, 4, 2, 512, 16
CACHE_LENS = (512, 300, 37)
RING_B, RING_R, RING_WINDOW = 3, 64, 40

SSM_IDS = {"mamba2": "mamba2-2.7b", "hymba": "hymba-1.5b"}
# moe_drop: moonshot SMOKE at capacity factor 1.0 (capacity t/4: items
# drop), where the port's per-chunk capacity differed from the
# reference's global dispatch under a plan that sets fsdp_axis
PREFILL_CFGS = ("linear", "linear_bf16", "hybrid", "hybrid_ulysses", "gla",
                "mamba2", "hymba", "moe_drop")
# collectives of the port's own: what the reference's GSPMD moves
# without a named primitive (``comm.budget``)
PORT_ONLY_TAGS = ("prefill.last", "prefill.rows", "mamba2.conv", "ring.k",
                  "ring.v", "ring_decode.o", "ring_decode.m",
                  "ring_decode.l", "moe.counts")
# ... among them the weight, vocab, cache and slot placements' exchanges,
# by tag prefix
PLACEMENT_TAGS = ("fsdp.", "tp.", "cache_seq.", "serve.tokens")
# the cross family's gates (0 at init hides a cross layer's output)
CROSS_GATE = 0.5

# the placing plans of the 4 ranks, (name, layout dims, kind), and the
# configs each runs: prefill + 3 decode steps against the reference's
# outputs for the same params and tokens (a plan does not change the
# function); the engines' greedy tokens against the reference's engines
PLACED = (("p22", (2, 2), "prefill"), ("d22", (2, 2), "decode"),
          ("d14", (1, 4), "decode"))
# (rows: the hybrid with 3 heads, which the model axis of (2, 2) does
# not divide: its prefill plan takes the batch-over-model branch, 2 rows
# over model, each rank prefilling its row)
PLACED_CFGS = {"p22": ("linear", "hybrid", "gla", "granite", "mamba2",
                       "moe", "hymba", "moe_drop", "rows", "whisper"),
               "d22": ("linear", "hybrid", "gla", "granite", "mamba2",
                       "hymba", "moe_drop", "whisper"),
               "d14": ("linear", "hybrid", "gla", "mamba2", "hymba",
                       "moe_drop", "whisper")}
PLACED_ENGINES = ("linear", "hybrid", "granite")


def strategy(name):
    """The comm strategy of a prefill case: "ulysses" for the cases so
    named, else the paper's all-gather."""
    return "ulysses" if name.endswith("_ulysses") else "allgather"


def make_cfg(name, get_smoke, layer_spec, linear_attn_config):
    """A SMOKE config of either package by name."""
    base = get_smoke("linear-llama3-1b")
    if name == "linear":
        return dataclasses.replace(base, dtype="float32")
    if name == "linear_bf16":
        return base
    if name == "gla":
        return dataclasses.replace(
            base, dtype="float32",
            linear_attn=linear_attn_config(feature_map="silu", decay="data",
                                           backward="autodiff"))
    if name in ("hybrid", "hybrid_ulysses"):
        dense = dataclasses.replace(base, pattern=(layer_spec(),),
                                    n_layers=4, name="smoke-dense",
                                    dtype="float32")
        cfg = dense.linearize(hybrid_every=4)
        # a window no prompt length divides: the reference then takes the
        # K/V all-gather (its banded form, which shifts a halo without a
        # named collective, needs S % window == 0)
        pattern = tuple(dataclasses.replace(sp, sliding_window=24)
                        if sp.mixer == "softmax" else sp
                        for sp in cfg.pattern)
        return dataclasses.replace(cfg, pattern=pattern, name="smoke-hybrid")
    if name in SSM_IDS:
        return dataclasses.replace(get_smoke(SSM_IDS[name]), dtype="float32")
    if name == "granite":
        return dataclasses.replace(get_smoke("granite-34b"), dtype="float32")
    if name == "starcoder":
        return get_smoke("starcoder2-15b")
    if name in ("moe", "moe_drop"):
        cfg = dataclasses.replace(get_smoke("moonshot-v1-16b-a3b"),
                                  dtype="float32")
        if name == "moe_drop":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=1.0))
        return cfg
    if name == "whisper":
        return dataclasses.replace(get_smoke("whisper-base"),
                                   dtype="float32")
    if name == "rows":
        return dataclasses.replace(
            make_cfg("hybrid", get_smoke, layer_spec, linear_attn_config),
            n_heads=3, n_kv_heads=3, name="smoke-rows")
    raise KeyError(name)


def plan_kw(cfg):
    """``make_plan``'s sizes of a prefill of ``PREFILL_B`` rows of
    ``cfg``'s fp32 params: the batch-over-model branch is taken where
    the model axis does not divide the heads."""
    return dict(global_batch=PREFILL_B, params_bytes=4 * cfg.param_count())


def frames(cfg):
    """The encoder frames of a prefill of ``PREFILL_B`` rows (None
    without an encoder)."""
    if cfg.encoder is None:
        return None
    rng = np.random.default_rng(17)
    return rng.standard_normal((PREFILL_B, cfg.encoder.n_frames,
                                cfg.d_model)).astype(np.float32)


def port_cfg(name):
    from repro_torch.configs import LayerSpec, LinearAttnConfig, get_smoke
    return make_cfg(name, get_smoke, LayerSpec, LinearAttnConfig)


def decode_inputs():
    rng = np.random.default_rng(3)
    f32 = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    ins = {"q": f32(DEC_B, DEC_HQ, 1, DEC_DH),
           "k": f32(DEC_B, DEC_HKV, DEC_S, DEC_DH),
           "v": f32(DEC_B, DEC_HKV, DEC_S, DEC_DH),
           "rq": f32(RING_B, DEC_HQ, 1, DEC_DH),
           "rk": f32(RING_B, DEC_HKV, RING_R, DEC_DH),
           "rv": f32(RING_B, DEC_HKV, RING_R, DEC_DH)}
    # ragged rings: row 0 wrapped past R (positions 36..99), row 1 filled
    # to 20 (the rest never written), row 2 wrapped once (30..93)
    kpos = np.full((RING_B, RING_R), -1, np.int32)
    for row, last in ((0, 99), (1, 19), (2, 93)):
        for p in range(max(0, last - RING_R + 1), last + 1):
            kpos[row, p % RING_R] = p
    ins["kpos"] = kpos
    ins["qpos"] = np.array([99, 19, 93], np.int32)
    return ins


def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]


def prefill_tokens():
    rng = np.random.default_rng(11)
    return rng.integers(0, 512, (PREFILL_B, PREFILL_S)).astype(np.int32)


def decode_tokens():
    rng = np.random.default_rng(13)
    return rng.integers(0, 512, (DECODE_STEPS, PREFILL_B)).astype(np.int32)


def tape_rows(records):
    return sorted({f"{r.op}|{r.tag}|{r.payload_bytes}" for r in records})


def placed(tag):
    """True for a placement's exchange (``PLACEMENT_TAGS``)."""
    return any(tag == t or (t.endswith(".") and tag.startswith(t))
               for t in PLACEMENT_TAGS)


def _params(npz, name, cfg, plan=None):
    from repro_torch.models.weights import params_from_jax
    prefix = f"param/{name}/"
    flat = {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}
    tree = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    tree = _lists(tree)
    return params_from_jax(tree, cfg, device="cpu",
                           dtype=torch.float32 if cfg.dtype == "float32"
                           else None, plan=plan)


def _lists(node):
    """Dicts keyed "0", "1", … back into lists (the reference's stacks)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _gathered_cache(cache, group):
    """A cache with every sliced ring's K/V gathered back to R slots (in
    rank order along the slot dim), as numpy."""
    def walk(node):
        if isinstance(node, dict):
            if "kpos" in node and node["k"].shape[2] != node["kpos"].shape[1]:
                k, v = (primitives.allgather_states(
                    node[n].contiguous(), group, gather_axis=2, tiled=True,
                    tag="test.ring") for n in ("k", "v"))
                return {"k": k.float().numpy(), "v": v.float().numpy(),
                        "kpos": node["kpos"].numpy().copy()}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return np.array(node.float() if node.is_floating_point() else node)
    return walk(cache)


def _layout(dims, axes=None):
    from repro_torch.launch.mesh import (Axis, make_serving_groups,
                                         make_test_mesh)
    return make_serving_groups(make_test_mesh(
        dims, axes or (Axis.DATA, Axis.MODEL)))


def _places(layout):
    """This rank's index along each axis and each axis group's ranks."""
    import torch.distributed as dist
    return {a.name: (layout.index[a],
                     dist.get_process_group_ranks(layout.group(a)))
            for a in layout.axes}


def serve_rank(rank, world, device, npz_path):
    """Every W-4 case on this rank: the two decode attentions, prefill
    under the (4, 1) prefill plan, prefill and decode steps under the
    (1, 4) decode plan, both plans' engines; with tapes and budgets."""
    from repro_torch.comm import budget as B
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core.lasp2 import SPConfig
    from repro_torch.launch.mesh import Axis
    from repro_torch.core.lasp2h import (ring_decode_attention,
                                         sharded_decode_attention)
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding.rules import make_plan
    import torch.distributed as dist

    res = {}
    ins = {k: torch.from_numpy(v) for k, v in decode_inputs().items()}
    sp = SPConfig(dist.group.WORLD)
    c = DEC_S // W
    shard = lambda x: x[:, :, rank * c:(rank + 1) * c]
    for n in CACHE_LENS:
        with primitives.tape() as rec:
            o = sharded_decode_attention(ins["q"], shard(ins["k"]),
                                         shard(ins["v"]), n, sp=sp)
        res[f"decode/{n}"] = o.numpy()
        res[f"decode/{n}/tape"] = tape_rows(rec)
        res[f"decode/{n}/budget"] = B.check_budget(rec, B.decode_merge_budget(
            W, b=DEC_B, hq=DEC_HQ, dh=DEC_DH))
    r = RING_R // W
    rs = lambda x: x[..., rank * r:(rank + 1) * r]
    with primitives.tape() as rec:
        o = ring_decode_attention(
            ins["rq"], ins["rk"][:, :, rank * r:(rank + 1) * r],
            ins["rv"][:, :, rank * r:(rank + 1) * r], rs(ins["kpos"]),
            ins["qpos"], sliding_window=RING_WINDOW, sp=sp)
    res["ring"] = o.numpy()
    res["ring/tape"] = tape_rows(rec)

    with np.load(npz_path) as npz:
        prefill_lay = _layout((W, 1))
        decode_lay = _layout((1, W))
        train_lay = _layout((2, 2), (Axis.DATA, Axis.SEQUENCE))
        tplan = make_plan(train_lay, "train", global_batch=4, n_kv_heads=4)
        res["places"] = {"prefill": _places(prefill_lay),
                         "decode": _places(decode_lay),
                         "train": _places(train_lay)}
        res["train_plan"] = (tplan.sp.degree, tplan.sp.chunk_index,
                             train_lay.training.chunk_index,
                             train_lay.training.data_index)
        toks = torch.from_numpy(prefill_tokens())
        for name in PREFILL_CFGS:
            cfg = port_cfg(name)
            pplan = make_plan(prefill_lay, "prefill", n_kv_heads=4,
                              comm=CommSpec(strategy(name)))
            params = _params(npz, name, cfg, pplan)
            with primitives.tape() as rec:
                logits, cache = M.prefill(params, toks, cfg, pplan,
                                          max_len=MAX_LEN)
            res[f"prefill/{name}/logits"] = logits.float().numpy()
            res[f"prefill/{name}/cache"] = _gathered_cache(
                cache, pplan.cache_sp().group)
            res[f"prefill/{name}/tape"] = tape_rows(rec)
            res[f"prefill/{name}/budget"] = B.check_budget(
                rec, B.serve_prefill_budget(cfg, pplan, b=PREFILL_B,
                                            s=PREFILL_S, params=_shapes(cfg)))
            steps = []
            with primitives.tape() as rec:
                for tok in decode_tokens():
                    lg, cache = M.decode_step(params, torch.from_numpy(tok),
                                              cache, cfg, pplan)
                    steps.append(lg.float().numpy())
            res[f"prefill/{name}/steps"] = np.stack(steps)
            res[f"prefill/{name}/decode_budget"] = B.check_budget(
                rec, B.combine([B.serve_decode_budget(
                    cfg, pplan, b=PREFILL_B, max_len=MAX_LEN,
                    params=_shapes(cfg))] * DECODE_STEPS))
        # left padding across chunks (CONFIG is pad-safe)
        pplan = make_plan(prefill_lay, "prefill", n_kv_heads=4)
        cfg = port_cfg("linear")
        params = _params(npz, "linear", cfg, pplan)
        logits, cache = M.prefill(params, toks, cfg, pplan, max_len=MAX_LEN,
                                  pad_lens=torch.tensor(PAD_LENS))
        res["pad/logits"] = logits.numpy()
        res["pad/cache"] = _gathered_cache(cache, None)
        # the decode plan: granite (MQA) prefills locally, its ring sliced
        dplan = make_plan(decode_lay, "decode", n_kv_heads=1)
        cfg = port_cfg("granite")
        params = _params(npz, "granite", cfg, dplan)
        with primitives.tape() as rec:
            logits, cache = M.prefill(params, toks, cfg, dplan,
                                      max_len=MAX_LEN)
        res["dprefill/tape"] = tape_rows(rec)
        res["dprefill/budget"] = B.check_budget(rec, B.serve_prefill_budget(
            cfg, dplan, b=PREFILL_B, s=PREFILL_S, params=_shapes(cfg)))
        res["dprefill/logits"] = logits.numpy()
        res["dprefill/cache"] = _placed_cache(cache, cfg, dplan)
        steps = []
        with primitives.tape() as rec:
            for tok in decode_tokens():
                lg, cache = M.decode_step(params, torch.from_numpy(tok),
                                          cache, cfg, dplan)
                steps.append(lg.numpy())
        res["dprefill/steps"] = np.stack(steps)
        res["dprefill/decode_tape"] = tape_rows(rec)
        res["dprefill/decode_budget"] = B.check_budget(
            rec, B.combine([B.serve_decode_budget(
                cfg, dplan, b=PREFILL_B, max_len=MAX_LEN,
                params=_shapes(cfg))] * DECODE_STEPS))
        # the engines: both plans against the reference's engines
        for name, plan in (("linear", pplan), ("hybrid", pplan),
                           ("granite", dplan)):
            cfg = port_cfg(name)
            params = _params(npz, name, cfg, plan)
            eng = ServeEngine(cfg, params, plan=plan, max_len=MAX_LEN,
                              max_batch=4, device="cpu")
            with primitives.tape() as rec:
                res[f"engine/{name}"] = eng.generate(prompts(), NEW_TOKENS)
            res[f"engine/{name}/tape"] = tape_rows(rec)
            res[f"engine/{name}/kv_bytes"] = eng.cache_stats()["kv_ring"]
        res.update(_placed_cases(npz, toks))
    return res


def _held(tree) -> int:
    from repro_torch.core.tree import leaves_with_paths
    return sum(t.numel() * t.element_size()
               for _, t in leaves_with_paths(tree))


def _report(cfg, plan, kind, b, max_len):
    """``launch.dryrun.memory_report`` of a ``kind`` cell of ``b`` rows and
    ``max_len`` tokens placed by ``plan``, the rank's own."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import memory_report
    cell = build_cell(cfg.name, None, plan.layout, cfg_override=cfg,
                      shape=ShapeConfig("rank", max_len, b, kind),
                      plan=plan,
                      run=RunConfig(infer_bf16=cfg.dtype == "bfloat16"))
    return memory_report(cell)


def _placed_cache(cache, cfg, plan):
    """A cache gathered back whole, as numpy: every leaf over each axis
    its ``cache_specs`` entry splits where the rank holds a slice (rows,
    heads, ring slots, conv channels)."""
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import cache_specs
    from repro_torch.core.tree import leaves_with_paths
    b = cache["pos"].shape[0]
    ring = max([t.shape[1] for path, t in leaves_with_paths(cache["layers"])
                if path[-1] == "kpos"] + [1])
    whole = M.init_cache(cfg, b, ring, device="meta")
    specs = cache_specs(whole, plan)

    def walk(node, w, spec):
        if isinstance(node, dict):
            return {k: walk(node[k], w[k], spec[k]) for k in node}
        if isinstance(node, list):
            return [walk(*z) for z in zip(node, w, spec)]
        for dim, entry in enumerate(spec):
            if entry is None or node.shape[dim] == w.shape[dim]:
                continue
            axis = entry[0] if isinstance(entry, tuple) else entry
            node = primitives.allgather_states(
                node.contiguous(), plan.place(axis).group, gather_axis=dim,
                tiled=True, tag="test.gather")
        return np.array(node.float() if node.is_floating_point() else node)
    return walk(cache, whole, specs)


def _placed_cases(npz, toks):
    """Every placing plan of ``PLACED`` on its configs: this rank's held
    params and cache bytes against the dry run's ``memory_report``, its
    tapes against the extended budgets, prefill + decode steps with the
    cache gathered back, and the engines' greedy tokens."""
    from repro_torch.comm import budget as B
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import make_plan
    res = {}
    for key, dims, kind in PLACED:
        lay = _layout(dims)
        for name in PLACED_CFGS[key] + tuple(
                n for n in PLACED_ENGINES if n not in PLACED_CFGS[key]):
            cfg = port_cfg(name)
            plan = make_plan(lay, kind, n_kv_heads=cfg.n_kv_heads,
                             n_heads=cfg.n_heads, **plan_kw(cfg))
            if name == "moe":
                params = _moe_params(cfg, plan)
            else:
                params = _params(npz, name, cfg, plan)
            out = f"{key}/{name}"
            if name in PLACED_CFGS[key]:
                enc = frames(cfg)
                with primitives.tape() as rec:
                    logits, cache = M.prefill(
                        params, toks, cfg, plan, max_len=MAX_LEN,
                        enc_frames=None if enc is None
                        else torch.from_numpy(enc))
                res[f"{out}/logits"] = logits.float().numpy()
                res[f"{out}/cache"] = _placed_cache(cache, cfg, plan)
                res[f"{out}/tags"] = sorted({r.tag for r in rec})
                res[f"{out}/tp"] = plan.tp_size()
                budgets = [B.check_budget(rec, B.serve_prefill_budget(
                    cfg, plan, b=PREFILL_B, s=PREFILL_S,
                    params=_shapes(cfg)))]
                held = {"params": _held(params)}
                report = _report(cfg, plan, kind, PREFILL_B, MAX_LEN)
                if kind == "prefill":
                    held["cache"] = _held(cache)
                # the rows a rank's cache holds (its block where the
                # prefill split them) decode alone
                place = plan.prefill_rows_place(PREFILL_B)
                first, n = (0, PREFILL_B) if place is None else (
                    place.index * (PREFILL_B // place.size),
                    PREFILL_B // place.size)
                steps = []
                with primitives.tape() as rec:
                    for tok in decode_tokens():
                        lg, cache = M.decode_step(
                            params, torch.from_numpy(tok[first:first + n]),
                            cache, cfg, plan,
                            rows=None if place is None else (first, n))
                        steps.append(lg.float())
                if place is not None:
                    steps = [primitives.allgather_states(
                        lg.contiguous(), place.group, tiled=True,
                        tag="test.gather") for lg in steps]
                res[f"{out}/steps"] = np.stack([lg.numpy() for lg in steps])
                res[f"{out}/decode_tags"] = sorted({r.tag for r in rec})
                budgets.append(B.check_budget(rec, B.combine(
                    [B.serve_decode_budget(cfg, plan, b=n,
                                           max_len=MAX_LEN,
                                           params=_shapes(cfg))]
                    * DECODE_STEPS)))
                res[f"{out}/budget"] = budgets
                res[f"{out}/held"] = (held, {k: report[k] for k in held})
                if name == "moe":
                    whole = _moe_params(cfg, None)
                    want_l, want_c = M.prefill(whole, toks, cfg,
                                               max_len=MAX_LEN)
                    res[f"{out}/want_cache"] = _gathered_cache(want_c, None)
                    want = []
                    for tok in decode_tokens():
                        lg, want_c = M.decode_step(
                            whole, torch.from_numpy(tok), want_c, cfg)
                        want.append(lg.float().numpy())
                    res[f"{out}/want"] = (want_l.numpy(), np.stack(want))
            if name in PLACED_ENGINES:
                eng = _Recorded(cfg, params, plan=plan, max_len=MAX_LEN,
                                max_batch=4, device="cpu")
                with primitives.tape() as rec:
                    res[f"{out}/engine"] = eng.generate(prompts(),
                                                        NEW_TOKENS)
                report = _report(cfg, plan, "decode", 4, MAX_LEN)
                res[f"{out}/engine_held"] = (
                    (_held(params), _held(eng._cache)),
                    (report["params"], report["cache"]))
                res[f"{out}/engine_tags"] = sorted({r.tag for r in rec})
                res[f"{out}/engine_budget"] = B.check_budget(
                    rec, _engine_budget(cfg, plan, eng))
    return res


def _Recorded(*args, **kw):
    """A ``ServeEngine`` that keeps each admitted prefill batch's (rows,
    length) in ``admitted``."""
    from repro_torch.serve.engine import ServeEngine

    class Recorded(ServeEngine):
        def _admit(self, batch):
            self.admitted.append(tuple(batch.prompts.shape))
            return super()._admit(batch)

    eng = Recorded(*args, **kw)
    eng.admitted = []
    return eng


def _shapes(cfg):
    """``cfg``'s whole params on meta: the shapes the budgets read."""
    from repro_torch.models import model as M
    return M.init_params(None, cfg, device="meta")


def _moe_params(cfg, plan):
    """MoE SMOKE params drawn from seed 0 (the reference holds the port's
    one-device MoE, ``test_torch_moe.py``), this rank's shard under
    ``plan``."""
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import shard_params
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    return params if plan is None else shard_params(params, plan)


def _engine_budget(cfg, plan, eng):
    """An engine run's budget: each prefill batch's and each decode
    step's (``stats()`` counts them; the batches are (rows, length) of
    the prompts admitted together)."""
    from repro_torch.comm import budget as B
    shapes = _shapes(cfg)
    parts = [B.serve_prefill_budget(cfg, plan, b=b, s=s, params=shapes)
             for b, s in eng.admitted]
    parts += [B.serve_decode_budget(cfg, plan, b=eng.max_batch,
                                    max_len=eng.max_len, engine=True,
                                    params=shapes)] * \
        int(eng.stats()["decode_steps"])
    return B.combine(parts)


def forward_rank(rank, world, device, npz_path):
    """The dense + SP forward of starcoder2-15b SMOKE under the prefill
    plan of the (4, 2) layout: this rank's chunk of the logits."""
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import make_plan
    cfg = port_cfg("starcoder")
    lay = _layout((4, 2))
    plan = make_plan(lay, "prefill", global_batch=2,
                     n_kv_heads=cfg.n_kv_heads)
    with np.load(npz_path) as npz:
        params = _params(npz, "starcoder", cfg, plan)
        toks = torch.from_numpy(npz["starcoder/tokens"])
    with primitives.tape() as rec:
        out = M.forward(params, toks, cfg, plan)
    report = _report(cfg, plan, "prefill", toks.shape[0], toks.shape[1])
    return {"logits": out.float().numpy(), "tape": tape_rows(rec),
            "index": (lay.index, plan.sp.chunk_index),
            "places": _places(lay),
            "held": (_held(params), report["params"])}
