"""Port vs reference: the model on ``get_smoke("linear-llama3-1b")``.

The reference's params, moved across with ``params_from_jax``, and the
same numpy tokens go through ``repro.models.model`` (XLA path on the CPU)
and ``repro_torch.models.model`` (plain PyTorch path on the CPU).
Tolerances: fp32 3e-4, the reference's kernel tolerance. bf16 4e-2 on
logits (the reference's bf16 kernel tolerance): the two frameworks round
the bf16 activations at other points, one ulp being 2^-8 relative. bf16
states: 5e-2 relative plus 1e-2 of the tensor's largest magnitude, since
an entry near zero is a sum over the sequence of rounded products of
large terms, so its error scales with the tensor, not with the entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import LinearAttnConfig as JLinearAttnConfig
from repro.models import model as JM
from repro_torch.configs import get_smoke
from repro_torch.configs.base import LinearAttnConfig
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax

LOGIT_TOL = {"float32": 3e-4, "bfloat16": 4e-2}
STATE_TOL = {"float32": (3e-4, 0.0), "bfloat16": (5e-2, 1e-2)}


def _cfgs(dtype):
    jcfg = dataclasses.replace(j_get_smoke("linear-llama3-1b"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke("linear-llama3-1b"), dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs("float32")
    return JM.init_params(jax.random.PRNGKey(0), jcfg)


def _port_params(jax_params, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), tcfg,
                           device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(
        np.int32)


def _close_logits(t, j, cfg, tol, what):
    v = cfg.vocab_size
    np.testing.assert_allclose(t.float().numpy()[..., :v],
                               np.asarray(j, np.float32)[..., :v],
                               rtol=tol, atol=tol, err_msg=what)
    # padded-vocab columns are masked on both sides
    assert (t.float().numpy()[..., v:] <= -1e29).all()


def _close_cache(tc, jc, cfg, tol):
    tol, scale_tol = tol
    n = len(cfg.pattern)
    for i, layer in enumerate(tc["layers"]):
        g, p = divmod(i, n)
        for name in ("m", "log_decay"):
            want = np.asarray(jc["layers"][p]["mixer"][name][g])
            np.testing.assert_allclose(
                layer["mixer"][name].numpy(), want, rtol=tol,
                atol=max(tol, scale_tol * float(np.abs(want).max())),
                err_msg=f"layer {i} {name}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_params_from_jax_maps_every_leaf(jax_params):
    jcfg, tcfg = _cfgs("float32")
    tp = _port_params(jax_params, tcfg)
    n_jax = sum(x.size for x in jax.tree.leaves(jax_params))
    n_port = (sum(t.numel() for t in tp["embed"].values())
              + tp["final_norm"]["scale"].numel()
              + sum(t.numel() for layer in tp["layers"]
                    for mod in layer.values() for t in mod.values()))
    assert n_port == n_jax
    # param_count leaves out the final norm, in both packages
    assert tcfg.param_count() == jcfg.param_count() == n_jax - tcfg.d_model
    assert len(tp["layers"]) == tcfg.n_layers
    # layer g·len(pattern) + p is group g of pattern position p
    np.testing.assert_array_equal(
        tp["layers"][1]["mixer"]["wq"].numpy(),
        np.asarray(jax_params["groups"][0]["mixer"]["wq"][1]))
    assert tp["layers"][0]["ln1"]["scale"].dtype == torch.float32
    bf = params_from_jax(jax.tree.map(np.asarray, jax_params),
                         dataclasses.replace(tcfg, dtype="bfloat16"),
                         device="cpu")
    assert bf["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln2"]["scale"].dtype == torch.float32


def test_params_from_jax_rejects_unknown_and_missing_leaves(jax_params):
    _, tcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray, jax_params)
    extra = dict(tree, embed=dict(tree["embed"], bias=np.zeros(3)))
    with pytest.raises(ValueError, match="unmapped leaves embed.bias"):
        params_from_jax(extra, tcfg, device="cpu")
    missing = dict(tree, final_norm={})
    with pytest.raises(KeyError, match="final_norm.scale"):
        params_from_jax(missing, tcfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(jax_params, dtype):
    jcfg, tcfg = _cfgs(dtype)
    tp = _port_params(jax_params, tcfg)
    toks = _tokens(2, 40)
    jl, _ = JM.forward(jax_params, jnp.asarray(toks), jcfg, remat="none")
    tl = TM.forward(tp, torch.as_tensor(toks), tcfg)
    assert tl.shape == (2, 40, tcfg.padded_vocab)
    _close_logits(tl, jl, tcfg, LOGIT_TOL[dtype], "forward logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_match_reference(jax_params, dtype, padded):
    """prefill logits and cache (m, log_decay, pos), with and without
    left-padding ``pad_lens``, then one decode step from that cache."""
    jcfg, tcfg = _cfgs(dtype)
    tp = _port_params(jax_params, tcfg)
    toks = _tokens(3, 32, seed=1)
    pad = np.array([5, 0, 17], np.int32) if padded else None
    jl, jc = JM.prefill(jax_params, jnp.asarray(toks), jcfg,
                        pad_lens=None if pad is None else jnp.asarray(pad))
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, pad_lens=pad)
    _close_logits(tl, jl, tcfg, LOGIT_TOL[dtype], "prefill logits")
    _close_cache(tc, jc, tcfg, STATE_TOL[dtype])
    tok = np.array([7, 300, 11], np.int32)
    jl, jc = JM.decode_step(jax_params, jnp.asarray(tok), jc, jcfg)
    tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
    _close_logits(tl, jl, tcfg, LOGIT_TOL[dtype], "decode logits")
    _close_cache(tc, jc, tcfg, STATE_TOL[dtype])


def test_decode_continues_forward(jax_params):
    """Port only: prefill + token-by-token decode reproduces the full
    forward's logits (the recurrent form continues the chunked scan)."""
    _, tcfg = _cfgs("float32")
    tp = _port_params(jax_params, tcfg)
    toks = torch.as_tensor(_tokens(2, 24, seed=2))
    full = TM.forward(tp, toks, tcfg)
    lg, cache = TM.prefill(tp, toks[:, :16], tcfg)
    _close_logits(lg, full[:, 15].numpy(), tcfg, 3e-4, "prefill")
    for i in range(16, 24):
        lg, cache = TM.decode_step(tp, toks[:, i], cache, tcfg)
        _close_logits(lg, full[:, i].numpy(), tcfg, 3e-4, f"pos {i}")


@pytest.mark.parametrize("variant", ["retention", "gqa"])
def test_config_variants_match_reference(variant):
    """The mixer paths the base config leaves idle: a fixed per-head decay
    (log a on top of the prefill resets) and grouped K/V heads (repeated
    to the query heads for the recurrence), fp32, with left-padding."""
    jcfg, tcfg = _cfgs("float32")
    if variant == "retention":
        jcfg = dataclasses.replace(jcfg, linear_attn=JLinearAttnConfig(
            feature_map="identity", decay="retention"))
        tcfg = dataclasses.replace(tcfg, linear_attn=LinearAttnConfig(
            feature_map="identity", decay="retention"))
    else:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=2)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = _port_params(jp, tcfg)
    toks = _tokens(2, 24, seed=3)
    jl, _ = JM.forward(jp, jnp.asarray(toks), jcfg, remat="none")
    _close_logits(TM.forward(tp, torch.as_tensor(toks), tcfg), jl, tcfg,
                  3e-4, "forward")
    pad = np.array([0, 9], np.int32)
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, pad_lens=jnp.asarray(pad))
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, pad_lens=pad)
    _close_logits(tl, jl, tcfg, 3e-4, "prefill")
    _close_cache(tc, jc, tcfg, STATE_TOL["float32"])
    tok = np.array([3, 4], np.int32)
    jl, jc = JM.decode_step(jp, jnp.asarray(tok), jc, jcfg)
    tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
    _close_logits(tl, jl, tcfg, 3e-4, "decode")
    _close_cache(tc, jc, tcfg, STATE_TOL["float32"])
