"""Model builder: init / forward / loss / prefill / decode over the layer
stack.

Twin of ``repro/models/model.py`` for the ported slices.
The reference stacks each pattern position's params over groups and runs
the stack with ``lax.scan``; here the stack is a Python list of layers,
layer ``g·len(pattern) + p`` built from ``pattern[p]``, walked in a loop.

Params are a plain dict::

    {"embed": {"table", "lm_head"}, "layers": [layer params, ...],
     "final_norm": {"scale"}}

plus, for a config with an encoder (Whisper), ``"encoder": {"layers":
[softmax + dense layer params, ...], "final_norm": {"scale"}}``. Image
embeddings (``img_emb``) and encoder frames (``enc_frames``) are stub
frontends, as in the reference: the caller gives (B, n_mem, d_model)
embeddings.

The decode cache is ``{"layers": [{"mixer": {...}}, ...], "pos": (B,)
int32}``: a linear layer holds ``m`` (B, H, dk, dv) fp32 and ``log_decay``
(B, H) fp32; a softmax layer a ring of ``k``, ``v`` (B, Hkv, R, dh) bf16
and ``kpos`` (B, R) int32; a mamba2 layer ``m`` (B, nh, d_state,
headdim) and ``log_decay`` (B, nh) fp32 and ``conv_x``, ``conv_b``,
``conv_c`` (B, d_conv − 1, C) bf16; a hymba layer both, nested under
``attn`` and ``ssm``; a cross layer the memory's ``k``, ``v`` (B, Hkv,
n_mem, dh) bf16, written at prefill and only read by decode.

Serving under a plan (``plan``, a ``sharding.rules.Parallelism`` whose
layout has ranks, ``launch.mesh.make_serving_groups``): every rank gets
the whole prompt and holds its shard of the weights
(``sharding.rules.shard_params``); ``plan.sp_for(S)`` decides whether
the prompt splits over the SP group, and each rank then runs its chunk
(RoPE and pad positions absolute) through the layers' exchanges. Each
layer's fsdp-split leaves are gathered over data just before it runs
(tags ``fsdp.<leaf>``) and dropped after it, one layer's whole weights
at a time, as XLA's FSDP does; the leaves a layer computes whole over
model are gathered too (``tp.cols.<leaf>``: the q/k/v columns of heads,
the SSD heads or the experts the model axis does not divide). The rest
stays the rank's slice over model: its heads, SSD heads, experts, ff
columns and vocab rows (``blocks``, ``layers``), the encoder's layers
split as the decoder's. A prefill plan whose batch rule splits the rows
(the batch-over-model branch) has each rank prefill its rows. The
decode cache holds what
``sharding.rules.cache_specs`` gives the rank (``init_cache(plan=)``):
its rows where the plan places decode slots over data (``pos`` stays
whole), its heads, its ring slots.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from repro_torch.comm import primitives
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.device import resolve_device, torch_dtype
from repro_torch.models import blocks
from repro_torch.models.blocks import Ctx
from repro_torch.models.layers import (embed_init, embed_lookup, logits_out,
                                       rmsnorm, rmsnorm_init,
                                       sinusoidal_positions)
from repro_torch.sharding.rules import (cache_specs, layer_split,
                                        param_specs, shard_tree)

# The encoder's layers: bidirectional softmax attention and a dense MLP.
ENCODER_SPEC = LayerSpec(mixer="softmax", mlp="dense")

REMAT_MODES = ("none", "full", "dots")

# remat="dots" keeps these ops' outputs (jax.checkpoint_policies.
# checkpoint_dots: the dot products) and recomputes everything else,
# the kernels' launches included (a Pallas call is not a dot either).
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None, param_dtype=None):
    """Random params with the reference's shapes and scales.

    ``generator`` must live on ``device`` (the CUDA card unless the caller
    names another device, e.g. ``torch.Generator().manual_seed(0)`` with
    ``device="cpu"``). Matrices and embeddings are stored in
    ``param_dtype`` (a config dtype name): by default ``cfg.dtype`` (bf16
    serving params); training passes ``cfg.param_dtype`` for fp32
    masters. Norm scales, the SSD heads' 1-D leaves (``dt_bias``,
    ``a_log``, ``d_skip``) and the cross layers' 0-d ``gate`` are fp32
    either way. With ``cfg.encoder`` the encoder's layers are drawn after
    the decoder's. ``generator`` None with ``device="meta"`` gives the
    shapes alone (``launch.cells``, the dry run).
    """
    device = resolve_device(device)
    if generator is None and device.type == "meta":
        generator = torch.Generator(device="cpu")
    elif generator is None or generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}: create the generator on the device")
    dtype = torch_dtype(param_dtype or cfg.dtype)
    params = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                            device, tie=cfg.tie_embeddings),
        "layers": [blocks.layer_init(generator, cfg, spec, dtype, device)
                   for spec in cfg.layer_specs()],
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [blocks.layer_init(generator, cfg, ENCODER_SPEC, dtype,
                                         device)
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": rmsnorm_init(cfg.d_model, device)}
    return params


def _device(params) -> torch.device:
    return params["embed"]["table"].device


def hymba_global_flags(cfg: ModelConfig):
    """Per layer, whether a hymba layer attends unwindowed; None without
    hymba layers. Hymba keeps full attention in its first, middle and last
    layers: a single-position pattern (SMOKE) marks layers 0, n // 2 and
    n − 1, as the reference's traced flags; a multi-position pattern
    (``CONFIG``) marks them statically by ``LayerSpec.is_global``."""
    specs = cfg.layer_specs()
    if not any(spec.mixer == "hymba" for spec in specs):
        return None
    if len(cfg.pattern) == 1:
        n = cfg.n_layers
        return [i in (0, n // 2, n - 1) for i in range(n)]
    return [spec.is_global for spec in specs]


def _layer_ctxs(ctx: Ctx, cfg: ModelConfig, pl=None, encoder=False):
    """One ``Ctx`` per layer: ``ctx`` itself, or a copy carrying the
    layer's hymba flag (a copy, so a layer recomputed under remat reads
    its own) and, under a serving plan's :class:`Placement` ``pl``, its
    ``LayerSplit`` (the encoder's layers' with ``encoder``)."""
    if encoder:
        n = cfg.encoder.n_layers
        ctxs = [ctx] * n
    else:
        flags = hymba_global_flags(cfg)
        ctxs = [ctx] * cfg.n_layers if flags is None else \
            [dataclasses.replace(ctx, is_global=f) for f in flags]
    if pl is None:
        return ctxs
    splits = pl.encoder if encoder else pl.layers
    return [dataclasses.replace(c, split=s) for c, s in zip(ctxs, splits)]


# ---------------------------------------------------------------------------
# Weights under a serving plan: gathered at use, one layer at a time.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """What a serving plan places on ``cfg``'s params on this rank, decided
    once a call (:func:`placement`): ``specs``, ``param_specs`` of the
    whole params; ``layers``, each layer's ``LayerSplit``; ``encoder``,
    each encoder layer's."""

    specs: Any
    layers: tuple
    encoder: tuple = ()


def placement(cfg: ModelConfig, plan) -> Optional[Placement]:
    """The :class:`Placement` of ``cfg`` under ``plan``; None without a
    plan or on a layout without ranks (nothing placed)."""
    if plan is None or plan.layout is None or plan.layout.groups is None:
        return None
    specs = param_specs(init_params(None, cfg, device="meta"), plan)
    enc = specs["encoder"]["layers"] if cfg.encoder is not None else []
    return Placement(specs, tuple(
        layer_split(cfg, spec, specs["layers"][i], plan)
        for i, spec in enumerate(cfg.layer_specs())), tuple(
        layer_split(cfg, ENCODER_SPEC, lspecs, plan) for lspecs in enc))


def gather_params(tree, specs, plan, whole, prefix=()):
    """``tree`` (this rank's leaves) with every fsdp-split dim gathered
    over data (tag ``fsdp.<path>``), then, on the leaves ``whole`` passes
    (a test of the leaf path), every model-split dim over model (tag
    ``tp.cols.<path>``)."""
    if isinstance(tree, dict):
        return {k: gather_params(v, specs[k], plan, whole, prefix + (k,))
                for k, v in tree.items()}
    fsdp, tp = plan.fsdp_place(), plan.tp_place()
    name = ".".join(prefix)
    for axis, place, tag, keep in (
            (plan.fsdp_axis, fsdp, "fsdp.", True),
            (plan.tp_axis, tp, "tp.cols.", whole(prefix))):
        if place is None or not keep:
            continue
        for dim, entry in enumerate(specs):
            if entry == axis:
                tree = primitives.allgather_states(
                    tree.contiguous(), place.group, gather_axis=dim,
                    tiled=True, tag=tag + name)
    return tree


def _layer_use(pl: Optional[Placement], plan, encoder=False):
    """``use(i, p)``: layer ``i``'s params ``p`` (an encoder layer's with
    ``encoder``) as the layer computes on them under ``plan`` (None
    without placements): the leaves its ``LayerSplit`` names gathered
    whole over model."""
    if pl is None or (plan.fsdp_place() is None
                      and plan.tp_place() is None):
        return None
    specs = pl.specs["encoder"]["layers"] if encoder else pl.specs["layers"]
    splits = pl.encoder if encoder else pl.layers
    return lambda i, p: gather_params(p, specs[i], plan, splits[i].gathered)


def _embed(params, pl: Optional[Placement], plan, name):
    """``(embed params holding ``name`` (``lm_head``'s falls back on the
    tied ``table``) gathered over data, the model ``Place`` when its spec
    splits the vocab rows over model, else None)``."""
    emb = params["embed"]
    if pl is None:
        return emb, None
    leaf = name if name in emb else "table"
    spec = pl.specs["embed"][leaf]
    w = gather_params(emb[leaf], spec, plan, lambda path: False,
                      ("embed", leaf))
    tp = plan.tp_place() if spec[0] == plan.tp_axis else None
    return {name: w, "table": w}, tp


def _lookup(params, tokens, pl, plan, dtype):
    emb, tp = _embed(params, pl, plan, "table")
    return embed_lookup(emb, tokens, dtype, tp=tp)


def _logits(params, x, cfg: ModelConfig, pl, plan):
    emb, tp = _embed(params, pl, plan, "lm_head")
    return logits_out(emb, x, cfg.vocab_size, tp=tp)


def _run_layers(layers, x, ctxs, specs, remat, use=None):
    """``(x, summed aux)`` through ``layers``, each recomputed in the
    backward under ``remat="full"``, or all but its dot products' outputs
    under ``remat="dots"``. ``use(i, p)`` gives layer ``i`` the params
    it computes on (``_layer_use``), freed after it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, lctx, spec) in enumerate(zip(layers, ctxs, specs)):
        if use is not None:
            p = use(i, p)
        if remat == "full":
            x, a = torch.utils.checkpoint.checkpoint(
                blocks.layer_apply, p, x, lctx, spec, use_reentrant=False)
        elif remat == "dots":
            x, a = torch.utils.checkpoint.checkpoint(
                blocks.layer_apply, p, x, lctx, spec, use_reentrant=False,
                context_fn=_DOTS_CONTEXT)
        else:
            x, a = blocks.layer_apply(p, x, lctx, spec)
        aux = aux + a
    return x, aux


def encode(params, frames, cfg: ModelConfig, plan=None, *,
           remat: str = "none"):
    """Whisper-style bidirectional encoder over (stub) frame embeddings
    (B, n_frames, d_model): the sinusoid added in ``cfg.dtype``, softmax
    layers without RoPE and unmasked, then the encoder's final norm. Under
    a ``plan`` every rank encodes all its rows' frames (the reference's
    GSPMD may split them; the function is the same), each layer on the
    rank's heads and ff columns as the decoder's layers split
    (``sharding.rules.LayerSplit``): its output is the memory every
    rank's cross layers read whole."""
    dtype = torch_dtype(cfg.dtype)
    device = _device(params)
    x = torch.as_tensor(frames, device=device).to(dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=device).to(dtype)[None]
    enc = params["encoder"]
    n = len(enc["layers"])
    pl = placement(cfg, plan)
    ctx = Ctx(cfg=cfg, positions=None, causal=False)
    x, _ = _run_layers(enc["layers"], x,
                       _layer_ctxs(ctx, cfg, pl, encoder=True),
                       [ENCODER_SPEC] * n, remat,
                       _layer_use(pl, plan, encoder=True))
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _memories(params, cfg: ModelConfig, img_emb, enc_frames, remat,
              plan=None):
    """``(img_emb, enc_out)`` for the cross layers, on the params' device:
    an encoder config encodes ``enc_frames``; an image config takes
    ``img_emb`` as it is. Each raises when its memory is missing."""
    enc_out = None
    if cfg.encoder is not None:
        if enc_frames is None:
            raise ValueError("whisper-style model needs enc_frames")
        enc_out = encode(params, enc_frames, cfg, plan, remat=remat)
    if img_emb is not None:
        img_emb = torch.as_tensor(img_emb, device=_device(params))
    elif cfg.n_image_tokens and any(spec.mixer == "cross"
                                    for spec in cfg.pattern):
        raise ValueError("image model needs img_emb")
    return img_emb, enc_out


def forward(params, tokens, cfg: ModelConfig, plan=None, *, resets=None,
            remat: str = "none", sp=None, causal: bool = True, img_emb=None,
            enc_frames=None):
    """Full-sequence forward → logits (B, S, padded_vocab) in ``cfg.dtype``
    (``forward_with_aux`` without the MoE layers' router loss)."""
    return forward_with_aux(params, tokens, cfg, plan, resets=resets,
                            remat=remat, sp=sp, causal=causal,
                            img_emb=img_emb, enc_frames=enc_frames)[0]


def _plan_split(plan, s: int):
    """``(sp, t, c)``: the SP config a serving ``plan`` gives a sequence
    of ``s`` tokens (None when it stays whole), this rank's chunk index
    and the chunk length. The manual train plan is not a serving plan:
    its caller passes chunks (``sp=``)."""
    if plan is None:
        return None, 0, s
    if plan.sp_manual:
        raise ValueError("the manual train plan runs inside the DP×SP step "
                         "(train.step.ShardedStep), which passes sp=")
    sp = plan.sp_for(s)
    if sp is None:
        return None, 0, s
    return sp, sp.chunk_index, s // sp.degree


def forward_with_aux(params, tokens, cfg: ModelConfig, plan=None, *,
                     resets=None, remat: str = "none", sp=None,
                     causal: bool = True, img_emb=None, enc_frames=None):
    """Full-sequence forward → ``(logits (B, S, padded_vocab) in
    ``cfg.dtype``, aux)``; ``aux`` is the MoE layers' router loss summed
    over layers (a 0-d fp32 tensor; dense layers add 0).

    tokens: (B, S) int; ``resets`` (B, S) bool marks document starts of
    packed rows (the linear state is zeroed there). ``remat="full"``
    recomputes each layer in the backward pass (``torch.utils.checkpoint``
    of the layer's ``(x, aux)``) instead of keeping its activations;
    ``"dots"`` keeps the outputs of its matrix products (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``) and recomputes the rest, the kernels included
    (selective checkpointing, the reference's ``checkpoint_dots``);
    ``"none"`` keeps everything.
    ``causal=False`` is the bidirectional model (paper Table 3): softmax
    layers attend to every key, linear layers read the whole sequence's
    state (no decay, resets ignored). ``sp``
    (``core.lasp2.SPConfig``): ``tokens`` and ``resets`` are this rank's
    chunk ``t`` of a sequence split over ``sp.degree`` ranks; its RoPE
    positions are ``t·S + arange(S)``. Under ``remat="full"`` a layer's
    recompute issues its forward exchanges again inside the backward.
    Cross layers attend ``img_emb`` (B, n_img, d) or the encoder's output
    over ``enc_frames`` (B, n_frames, d); the encoder runs under the same
    ``remat``. A serving ``plan`` takes the whole ``tokens`` (and
    ``resets``) and, when it splits them (``plan.sp_for(S)``), returns
    this rank's chunk ``t`` of the logits, (B, S / W, padded_vocab), as
    the reference's GSPMD leaves them sharded.
    """
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                         f"{remat!r}")
    dtype = torch_dtype(cfg.dtype)
    device = _device(params)
    tokens = tokens.to(device)
    if plan is not None:
        if sp is not None:
            raise ValueError("pass a plan or sp, not both")
        sp, t, c = _plan_split(plan, tokens.shape[1])
        tokens = tokens[:, t * c:(t + 1) * c]
        if resets is not None:
            resets = resets[:, t * c:(t + 1) * c]
    _, s = tokens.shape
    pl = placement(cfg, plan)
    x = _lookup(params, tokens, pl, plan, dtype)
    positions = torch.arange(s, device=device)
    if sp is not None:
        positions = sp.chunk_index * s + positions
    img_emb, enc_out = _memories(params, cfg, img_emb, enc_frames, remat,
                                 plan)
    ctx = Ctx(cfg=cfg, positions=positions, sp=sp, causal=causal,
              resets=None if resets is None else resets.to(device),
              img_emb=img_emb, enc_out=enc_out, plan=plan)
    x, aux = _run_layers(params["layers"], x, _layer_ctxs(ctx, cfg, pl),
                         cfg.layer_specs(), remat, _layer_use(pl, plan))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg, pl, plan), aux


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss_sum(logits, labels):
    """Unnormalized masked cross-entropy over positions with label >= 0:
    ``(ce_sum, n_valid, lse * mask)``, in fp32."""
    lf = logits.float()
    labels = labels.to(lf.device).long()
    mask = labels >= 0
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    ce_sum = torch.sum((lse - gold) * mask)
    return ce_sum, mask.sum(), lse * mask


def lm_loss(logits, labels):
    """Mean cross-entropy over positions with label >= 0."""
    ce_sum, n_valid, _ = lm_loss_sum(logits, labels)
    return ce_sum / n_valid.clamp(min=1)


# ---------------------------------------------------------------------------
# Decode (single token, cached)
# ---------------------------------------------------------------------------

def pad_safe(cfg: ModelConfig) -> bool:
    """True if left-padded (length-bucketed) prefill is exact for this
    config: every mixer is recurrent (the state reset at the first real
    token erases the filler) and every MLP is position-wise."""
    mixers = {sp.mixer for sp in cfg.pattern}
    if not all(sp.mixer in ("linear", "mamba2") and sp.mlp != "moe"
               for sp in cfg.pattern):
        return False
    return not (cfg.qkv_bias and "mamba2" in mixers)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               plan=None):
    """Decode cache: per linear or mamba2 layer a constant-size fp32 state
    plus its cumulative log decay (``max_len`` does not change its size;
    mamba2 also keeps its last d_conv − 1 conv inputs), per softmax layer a
    ring-buffer KV cache (ring = the sliding window of the hybrids'
    softmax layers, capped at ``max_len``; every hymba layer's ring is
    ``max_len`` long); ``pos`` is per row, since rows of a continuous
    batch sit at different offsets. Under a serving ``plan`` with ranks
    every leaf holds this rank's slice per ``sharding.rules.cache_specs``
    (its rows, heads, ring slots, conv channels), allocated at that size;
    ``pos`` stays whole."""
    device = resolve_device(device)
    if plan is None or plan.layout is None or plan.layout.groups is None:
        layers = [blocks.layer_cache(cfg, spec, batch, max_len, device)
                  for spec in cfg.layer_specs()]
        return {"layers": layers, "pos": torch.zeros(
            (batch,), dtype=torch.int32, device=device)}
    whole = init_cache(cfg, batch, max_len, device="meta")
    local = shard_tree(whole, cache_specs(whole, plan), plan.layout)
    return _materialize(local, device)


def _materialize(tree, device, name=""):
    """Meta leaves as tensors on ``device``: ring positions -1 (never
    written), everything else zeros."""
    if isinstance(tree, dict):
        return {k: _materialize(v, device, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_materialize(v, device, name) for v in tree]
    return torch.full(tree.shape, -1 if name == "kpos" else 0,
                      dtype=tree.dtype, device=device)


def decode_step(params, token, cache, cfg: ModelConfig, plan=None, *,
                rows=None, img_emb=None, enc_out=None):
    """One decode step. token: (B,) int → (logits (B, V), new cache).

    No prefix re-scan: every linear or SSD layer advances its recurrent
    state by one step (on CUDA in place, so the returned cache holds the
    caller's state tensors; SSD layers return new conv caches); every
    softmax layer writes one ring slot in place (on every device) and
    attends to the ring; every cross layer reads the memory's K/V that
    prefill cached (``img_emb`` and ``enc_out`` are the reference's
    arguments; no layer reads them). Under a serving ``plan`` a rank
    decodes the rows its cache holds: every row, or with ``rows`` (first,
    count) its block of them (a ``ServeEngine``'s slot grid placed over
    data, ``init_cache(plan=)``), whose tokens ``token`` then holds;
    ``cache["pos"]`` stays whole and advances for every row. A sliced
    ring is written by its slot's owner and read through the
    flash-decoding merge over the plan's group.
    """
    dtype = torch_dtype(cfg.dtype)
    pos_all = cache["pos"]
    token = token.to(pos_all.device)
    pl = placement(cfg, plan)
    pos = pos_all if rows is None else pos_all[rows[0]:rows[0] + rows[1]]
    x = _lookup(params, token[:, None], pl, plan, dtype)
    ctx = Ctx(cfg=cfg, positions=pos[:, None], decode_pos=pos,
              img_emb=img_emb, enc_out=enc_out, plan=plan,
              rows=None if rows is None else plan.rows_place(len(pos_all)))
    use = _layer_use(pl, plan)
    new_layers = []
    for i, (p, c, lctx, spec) in enumerate(zip(
            params["layers"], cache["layers"], _layer_ctxs(ctx, cfg, pl),
            cfg.layer_specs())):
        if use is not None:
            p = use(i, p)
        x, nc = blocks.layer_decode(p, x, c, lctx, spec)
        new_layers.append(nc)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x, cfg, pl, plan)
    return logits[:, 0, :], {"layers": new_layers, "pos": pos_all + 1}


# ---------------------------------------------------------------------------
# Prefill (full prompt → cache)
# ---------------------------------------------------------------------------

def _row_block(t, place):
    """``t``'s (rows first) block of rows this rank holds along ``place``
    (None: ``t`` whole; None stays None)."""
    if t is None or place is None:
        return t
    n = t.shape[0] // place.size
    return t[place.index * n:(place.index + 1) * n]


def prefill(params, tokens, cfg: ModelConfig, plan=None, *, max_len=None,
            pad_lens=None, img_emb=None, enc_frames=None,
            split_rows: bool = True):
    """Run the prompt, returning (logits of the last position (B, V),
    decode cache).

    ``pad_lens`` (B,) enables length-bucketed batched prefill for pure
    recurrent stacks: row ``b`` is LEFT-padded with ``pad_lens[b]`` filler
    tokens, its positions start at ``-pad_lens[b]`` so real tokens sit at
    0..L-1, filler embeddings are zeroed, and a state reset
    (``RESET_LOG_A``) at the first real token erases the filler's
    contribution to the state. The zeroed filler rows stay exactly zero
    through every layer (norms, projections, mamba2's conv, gate and
    ``wo`` all map 0 to 0), so mamba2's conv sees at the first real token
    the zeros of a sequence start. Softmax layers build their ring caches
    for ``max_len`` (default: the prompt length); cross layers cache the
    K/V of ``img_emb`` or of the encoder's output over ``enc_frames``
    (encoded here, once).

    Under a serving ``plan`` that splits the prompt (``plan.sp_for(S)``),
    rank ``t`` runs columns ``t·C … t·C + C − 1``: positions, the filler
    mask and the reset at the first real token are those columns' own,
    so a left-padded row's reset may fall in any chunk. Only the last
    rank holds the last position: its final hidden state reaches every
    rank through one all-gather (tag ``prefill.last``), so every rank
    returns the same logits. Where a prefill plan's batch rule splits the
    rows (``plan.prefill_rows_place``: the batch-over-model branch; off
    with ``split_rows=False``), a rank prefills its block of them alone
    and its cache holds those rows (``pos`` stays whole); the last
    position's hidden states are gathered back over that axis (tag
    ``prefill.rows``), so every rank returns every row's logits. The
    cache holds this rank's slice per ``sharding.rules.cache_specs``.
    """
    device = _device(params)
    dtype = torch_dtype(cfg.dtype)
    tokens = tokens.to(device)
    b, s = tokens.shape
    max_len = max_len or s
    sp, t, c = _plan_split(plan, s)
    pl = placement(cfg, plan)
    rows = plan.prefill_rows_place(b) if plan is not None and split_rows \
        else None
    if pad_lens is not None:
        pad_lens = torch.as_tensor(pad_lens, device=device).long()
    whole_pads = pad_lens
    tokens, pad_lens, img_emb, enc_frames = (
        _row_block(z, rows) for z in (tokens, pad_lens, img_emb, enc_frames))
    x = _lookup(params, tokens[:, t * c:(t + 1) * c], pl, plan, dtype)
    cols = torch.arange(t * c, (t + 1) * c, device=device)[None, :]
    resets = None
    if pad_lens is not None:
        if not pad_safe(cfg):
            raise ValueError(
                "pad_lens prefill requires a pure linear/SSM stack with "
                "dense MLPs")
        positions = cols - pad_lens[:, None]                    # (B, C)
        resets = cols == pad_lens[:, None]
        x = torch.where((cols >= pad_lens[:, None])[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=device))
    else:
        positions = cols[0]
    img_emb, enc_out = _memories(params, cfg, img_emb, enc_frames, "none",
                                 plan)
    ctx = Ctx(cfg=cfg, positions=positions, resets=resets, img_emb=img_emb,
              enc_out=enc_out, sp=sp, plan=plan, rows=rows)
    use = _layer_use(pl, plan)
    caches = []
    for i, (p, lctx, spec) in enumerate(zip(
            params["layers"], _layer_ctxs(ctx, cfg, pl),
            cfg.layer_specs())):
        if use is not None:
            p = use(i, p)
        x, c_ = blocks.layer_prefill(p, x, lctx, spec, max_len)
        caches.append(c_)
    x = x[:, -1:, :]
    if sp is not None:
        x = primitives.allgather_states(x, sp.group, tag="prefill.last")[-1]
    if rows is not None:
        x = primitives.allgather_states(x.contiguous(), rows.group,
                                        tiled=True, tag="prefill.rows")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(params, x, cfg, pl, plan)
    pos = torch.full((b,), s, dtype=torch.int32, device=device)
    if whole_pads is not None:                    # per-row true lengths
        pos = pos - whole_pads.to(torch.int32)
    return logits[:, 0, :], {"layers": caches, "pos": pos}
