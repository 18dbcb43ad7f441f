"""Carry the reference's params across: JAX tree (as numpy) → port params.

The reference stacks each pattern position's layer params over groups
(``params["groups"][p][...][g]``); the port keeps one dict per layer, with
layer ``g·len(pattern) + p`` taken from group ``g`` of position ``p``. Leaf
names are the same on both sides.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import torch_dtype


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


def params_from_jax(params_np, cfg: ModelConfig, *, device, dtype=None):
    """Port params from the reference's ``init_params`` tree, with numpy
    leaves (``jax.tree.map(np.asarray, params)``).

    Matrices and embeddings are cast to ``dtype`` (default ``cfg.dtype``),
    norm scales kept fp32. Raises on any leaf it does not map and on any
    leaf the port needs that the tree lacks.
    """
    dtype = torch_dtype(cfg.dtype) if dtype is None else dtype
    flat = _flatten(params_np)

    def tensor(arr, name):
        want = torch.float32 if name == "scale" else dtype
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
        return tensor(arr, path[-1])

    def unstacked(p, g, *path):
        """Group ``g`` of pattern position ``p``'s stacked leaf ``path``."""
        key = ("groups", str(p)) + path
        arr = leaf(*key)
        if arr.shape[0] != cfg.n_groups:
            raise ValueError(f"params_from_jax: {'.'.join(key)} stacks "
                             f"{arr.shape[0]} groups, config has "
                             f"{cfg.n_groups}")
        return tensor(arr[g], path[-1])

    def layer_leaves(spec):
        mixer = ("wq", "wk", "wv", "wo")
        if spec.mixer == "linear" and cfg.linear_attn.decay == "data":
            mixer += ("wdt",)          # GLA's gate
        return {"ln1": ("scale",), "ln2": ("scale",), "mixer": mixer,
                "mlp": ("w1", "w2", "w3")}

    for spec in cfg.pattern:
        if spec.mixer not in ("linear", "softmax") or spec.mlp != "dense":
            raise NotImplementedError(
                f"params_from_jax: mixer={spec.mixer!r} "
                f"mlp={spec.mlp!r} is ported in a later slice")
    layers = [{mod: {name: unstacked(p, g, mod, name) for name in names}
               for mod, names in layer_leaves(spec).items()}
              for g in range(cfg.n_groups)
              for p, spec in enumerate(cfg.pattern)]
    for p, spec in enumerate(cfg.pattern):
        for mod, names in layer_leaves(spec).items():
            for name in names:
                del flat[("groups", str(p), mod, name)]
    embed = {"table": take("embed", "table")}
    if not cfg.tie_embeddings:
        embed["lm_head"] = take("embed", "lm_head")
    out = {"embed": embed, "layers": layers,
           "final_norm": {"scale": take("final_norm", "scale")}}
    if flat:
        raise ValueError("params_from_jax: unmapped leaves "
                         + ", ".join(".".join(k) for k in sorted(flat)))
    return out
