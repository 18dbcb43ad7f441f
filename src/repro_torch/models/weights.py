"""Carry the reference's params across: JAX tree (as numpy) → port params.

The reference stacks each pattern position's layer params over groups
(``params["groups"][p][...][g]``); the port keeps one dict per layer, with
layer ``g·len(pattern) + p`` taken from group ``g`` of position ``p``. A
Whisper encoder's layers are stacked the same way under ``encoder/groups/0``
(one pattern position, one group per encoder layer). Leaf names are the
same on both sides.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import torch_dtype
from repro_torch.models.model import ENCODER_SPEC
from repro_torch.sharding.rules import shard_params


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(_flatten(sub, prefix + (str(key),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_flatten(sub, prefix + (str(i),)))
        return out
    return {prefix: np.asarray(tree)}


_ATTN = (("wq",), ("wk",), ("wv",), ("wo",))
_BIAS = (("bq",), ("bk",), ("bv",))
_MOE = (("router",), ("experts", "w1"), ("experts", "w3"), ("experts", "w2"))
_SHARED = (("shared", "w1"), ("shared", "w2"), ("shared", "w3"))
_SSM = (("wx",), ("wz",), ("wb",), ("wc",), ("wdt",), ("dt_bias",),
        ("a_log",), ("d_skip",), ("conv_x",), ("conv_b",), ("conv_c",),
        ("gnorm", "scale"), ("wo",))


def _layer_paths(spec, cfg: ModelConfig):
    """The leaf paths of one layer's params, by mixer and MLP. ``wdt`` is
    GLA's gate in a linear mixer with ``decay="data"`` and the SSD step
    projection in a mamba2 mixer (and hymba's ``ssm``): picked by mixer.
    Attention projections carry ``bq``, ``bk``, ``bv`` under ``qkv_bias``;
    a gelu MLP has no ``w3``; an MoE MLP holds the router, the experts'
    weights (stacked over experts) and, with shared experts, their SwiGLU
    MLP. A cross mixer holds softmax's projections and its 0-d ``gate``."""
    if spec.mixer not in ("linear", "softmax", "mamba2", "hymba", "cross") \
            or spec.mlp not in ("dense", "moe", "none"):
        raise NotImplementedError(
            f"params_from_jax: unknown mixer={spec.mixer!r} "
            f"mlp={spec.mlp!r}")
    attn = _ATTN + (_BIAS if cfg.qkv_bias else ())
    mixer = {"softmax": attn,
             "cross": attn + (("gate",),),
             "linear": attn + ((("wdt",),) if cfg.linear_attn.decay
                               == "data" else ()),
             "mamba2": _SSM,
             "hymba": tuple(("attn",) + p for p in attn)
             + tuple(("ssm",) + p for p in _SSM)}[spec.mixer]
    paths = [("ln1", "scale")] + [("mixer",) + p for p in mixer]
    if spec.mlp == "dense":
        paths += [("ln2", "scale"), ("mlp", "w1"), ("mlp", "w2")]
        if cfg.mlp_act == "swiglu":
            paths.append(("mlp", "w3"))
    elif spec.mlp == "moe":
        paths += [("ln2", "scale")] + [("mlp",) + p for p in _MOE]
        if cfg.moe.n_shared_experts:
            paths += [("mlp",) + p for p in _SHARED]
    return paths


def _nest(items):
    """``[(path, leaf), ...]`` → the nested dict those paths name."""
    out = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def params_from_jax(params_np, cfg: ModelConfig, *, device, dtype=None,
                    plan=None):
    """Port params from the reference's ``init_params`` tree, with numpy
    leaves (``jax.tree.map(np.asarray, params)``).

    Matrices, expert stacks and embeddings are cast to ``dtype`` (default
    ``cfg.dtype``); leaves of at most one dimension (norm scales, the qkv
    biases, the SSD heads' ``dt_bias``, ``a_log`` and ``d_skip``, the
    cross layers' 0-d ``gate``) stay fp32, as the reference keeps them,
    since a bf16 ``a_log`` would move every head's decay. Raises on any
    leaf it does not map and on any leaf the port needs that the tree
    lacks. Under a serving ``plan`` with ranks the result is this rank's
    shard (``sharding.rules.shard_params``).
    """
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    flat = _flatten(params_np)

    def tensor(arr):
        want = torch.float32 if arr.ndim <= 1 else dtype
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=want)

    def leaf(*path):
        if path not in flat:
            raise KeyError(f"params_from_jax: tree has no leaf "
                           f"{'.'.join(path)}")
        return flat[path]

    def take(*path):
        arr = leaf(*path)
        del flat[path]
        return tensor(arr)

    def stack(prefix, pattern, n_groups):
        """The layers of a stack whose pattern position ``p`` holds its
        leaves under ``prefix + ("groups", p)``, stacked over groups:
        layer ``g·len(pattern) + p`` is group ``g`` of position ``p``."""
        paths = [_layer_paths(spec, cfg) for spec in pattern]
        layers = [{} for _ in range(n_groups * len(pattern))]
        for p, layer_paths in enumerate(paths):
            items = [[] for _ in range(n_groups)]
            for path in layer_paths:
                key = prefix + ("groups", str(p)) + path
                arr = leaf(*key)
                if arr.shape[0] != n_groups:
                    raise ValueError(f"params_from_jax: {'.'.join(key)} "
                                     f"stacks {arr.shape[0]} groups, config "
                                     f"has {n_groups}")
                for g in range(n_groups):
                    items[g].append((path, tensor(arr[g])))
                del flat[key]
            for g in range(n_groups):
                layers[g * len(pattern) + p] = _nest(items[g])
        return layers

    layers = stack((), cfg.pattern, cfg.n_groups)
    embed = {"table": take("embed", "table")}
    if not cfg.tie_embeddings:
        embed["lm_head"] = take("embed", "lm_head")
    out = {"embed": embed, "layers": layers,
           "final_norm": {"scale": take("final_norm", "scale")}}
    if cfg.encoder is not None:
        out["encoder"] = {
            "layers": stack(("encoder",), (ENCODER_SPEC,),
                            cfg.encoder.n_layers),
            "final_norm": {"scale": take("encoder", "final_norm",
                                         "scale")}}
    if flat:
        raise ValueError("params_from_jax: unmapped leaves "
                         + ", ".join(".".join(k) for k in sorted(flat)))
    if plan is not None and plan.layout is not None:
        out = shard_params(out, plan)
    return out
