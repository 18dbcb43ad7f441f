"""``remat="dots"`` against the reference's ``remat="dots"``
(``jax.checkpoint_policies.checkpoint_dots``), at SMOKE size in fp32.

The port keeps the outputs of ``mm``, ``bmm``, ``addmm`` and ``baddbmm``
per layer (selective checkpointing) and recomputes the rest: the loss
and every leaf's gradient equal the reference's (loss 3e-4, gradients
1e-3) for the linear ``CONFIG``, the ``HYBRID`` cut (3 linear + 1 softmax
layer) and mamba2, and the backward under ``dots`` runs fewer ``mm`` ops
than under ``full`` (counted at dispatch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models import model as JM
from repro_torch.configs import get_smoke
from repro_torch.configs.base import LayerSpec
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax

LOSS_TOL = 3e-4
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _hybrid(base, layer_spec):
    """The paper's 1/4 hybrid on the SMOKE widths: 3 linear + 1 softmax
    layer."""
    dense = dataclasses.replace(base, pattern=(layer_spec(),), n_layers=4,
                                name="smoke-dense", dtype="float32")
    return dense.linearize(hybrid_every=4)


def _cfgs(kind):
    if kind == "hybrid":
        return (_hybrid(j_get_smoke("linear-llama3-1b"), JLayerSpec),
                _hybrid(get_smoke("linear-llama3-1b"), LayerSpec))
    arch = {"config": "linear-llama3-1b", "mamba2": "mamba2-2.7b"}[kind]
    return (dataclasses.replace(j_get_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke(arch), dtype="float32"))


def _port_grads_as_jax(grads, cfg):
    """A port gradient tree in the reference's layout (layers stacked over
    groups per pattern position), flattened with paths."""
    n = len(cfg.pattern)
    num = lambda t: t.detach().float().numpy()

    def stacked(layers):
        if isinstance(layers[0], dict):
            return {k: stacked([l[k] for l in layers]) for k in layers[0]}
        return np.stack([num(l) for l in layers])

    tree = {"embed": {k: num(v) for k, v in grads["embed"].items()},
            "groups": [stacked(grads["layers"][p::n]) for p in range(n)],
            "final_norm": {"scale": num(grads["final_norm"]["scale"])}}
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _tokens(vocab, b=2, s=32, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_loss(tp, toks, labels, cfg, remat):
    return TM.lm_loss(TM.forward(tp, torch.as_tensor(toks), cfg,
                                 remat=remat), torch.as_tensor(labels))


def _port_params(jp, cfg):
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                         dtype=torch.float32)
    for _, p in leaves_with_paths(tp):
        p.requires_grad_(True)
    return tp


@pytest.mark.parametrize("kind", ["config", "hybrid", "mamba2"])
def test_dots_matches_reference_dots(kind):
    """Loss (3e-4) and every leaf's gradient (1e-3) under ``dots`` against
    the reference's ``dots`` on the same params and tokens."""
    jcfg, tcfg = _cfgs(kind)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    toks, labels = _tokens(jcfg.vocab_size)

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(toks), jcfg, remat="dots")
        return JM.lm_loss(logits, jnp.asarray(labels))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = _port_params(jp, tcfg)
    tl = _port_loss(tp, toks, labels, tcfg, "dots")
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    leaves = [p for _, p in leaves_with_paths(tp)]
    it = iter(torch.autograd.grad(tl, leaves))
    grads = _rebuild(tp, it)
    want = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    got = _port_grads_as_jax(grads, tcfg)
    assert len(got) == len(want)
    for path, g in got:
        np.testing.assert_allclose(
            g, np.asarray(want[path], np.float32), rtol=GRAD_TOL,
            atol=GRAD_TOL, err_msg=f"{kind} grad {jax.tree_util.keystr(path)}")


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls (the backward's recompute included)."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_backward_runs_fewer_mm_than_full():
    """The backward under ``dots`` reruns none of the forward's products:
    fewer ``mm`` ops than under ``full``, which recomputes each layer's
    whole forward; the gradients are the same (1e-6)."""
    jcfg, tcfg = _cfgs("config")
    tp = _port_params(JM.init_params(jax.random.PRNGKey(2), jcfg), tcfg)
    toks, labels = _tokens(tcfg.vocab_size)
    leaves = [p for _, p in leaves_with_paths(tp)]
    counts, grads = {}, {}
    for remat in ("full", "dots", "none"):
        loss = _port_loss(tp, toks, labels, tcfg, remat)
        with _CountMM() as mode:
            grads[remat] = torch.autograd.grad(loss, leaves)
        counts[remat] = mode.mm
    assert counts["none"] <= counts["dots"] < counts["full"], counts
    for a, b in zip(grads["dots"], grads["full"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_remat_refuses_unknown_mode():
    _, tcfg = _cfgs("config")
    tp = _port_params(JM.init_params(jax.random.PRNGKey(0),
                                     _cfgs("config")[0]), tcfg)
    toks, _ = _tokens(tcfg.vocab_size, s=8)
    with pytest.raises(ValueError, match="remat must be one of"):
        TM.forward(tp, torch.as_tensor(toks), tcfg, remat="offload")
