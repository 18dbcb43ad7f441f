"""Port vs reference: MoE routing and Linear-MoE on the CPU.

``repro_torch.models.blocks.moe_apply`` against the reference's one-device
dispatch (``repro.models.blocks._moe_dispatch``) on the same fp32 inputs
and weights: capacity with ``int()`` truncation, drops past it, the sink
row, ties among router probabilities, the load-balance and router-z aux.
Then Linear-MoE, the paper's recipe on moonshot-v1-16b-a3b
(``get_config(arch, linearize=0)`` and the 1/2 hybrid) at SMOKE size, and
both CLIs on it. Tolerances: the MoE layer's output and aux 1e-5 in fp32
(the same fp32 operations on both sides); its gradients, losses, params
and moments 1e-3 (the reference's ``GRAD_TOL``); logits 3e-4.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import blocks as JB
from repro.models import model as JM
from repro.sharding.rules import local_plan
from repro_torch.configs.base import MoEConfig
from repro_torch.core.tree import leaves_with_paths
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from test_torch_mamba2 import _close_cache, _close_logits
from test_torch_zoo import (_step_pair, cfgs, close_step, jparams, port,
                            tokens)

ROOT = Path(__file__).resolve().parent.parent
MOE_TOL = 1e-5
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _layer(arch, cf=None, seed=0):
    """The reference's and the port's SMOKE (fp32, ``capacity_factor`` =
    ``cf`` where given) and one MoE MLP's fp32 params on each side."""
    jcfg, tcfg = cfgs(arch)
    if cf is not None:
        moe = dataclasses.replace(jcfg.moe, capacity_factor=cf)
        jcfg = dataclasses.replace(jcfg, moe=moe)
        tcfg = dataclasses.replace(tcfg, moe=MoEConfig(
            **dataclasses.asdict(moe)))
    jp = JB.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a, np.float32)), jp)
    return jcfg, tcfg, jp, tp


def _jax_moe(jp, x, jcfg):
    ctx = JB.Ctx(cfg=jcfg, plan=local_plan())
    return JB._moe_dispatch(jp, x, ctx)


def _kept(tcfg, idx, tokens_):
    """How many of the call's (token, choice) items fit their expert."""
    cap = TB.moe_capacity(tcfg.moe, tokens_)
    counts = np.bincount(idx.reshape(-1), minlength=tcfg.moe.num_experts)
    return int(np.minimum(counts, cap).sum()), int(counts.sum())


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf,tokens_,e,k,want", [
    (1.25, 4, 64, 6, 6),       # moonshot CONFIG, a 4-slot decode step
    (1.25, 4, 16, 2, 2),       # phi3.5-moe CONFIG, the same
    (1.25, 8192, 64, 6, 960),  # moonshot, a 4 x 2048 microbatch
    (1.25, 8192, 16, 2, 1280),
    (1.0, 10, 4, 2, 5), (1.0, 11, 4, 2, 5),      # int() truncates 5.5
    (4.0, 48, 8, 2, 48), (2.0, 48, 4, 2, 48)])   # SMOKEs: drop-free
def test_capacity_is_the_reference_formula(cf, tokens_, e, k, want):
    """``max(int(cf · t · k / E), k)`` over the whole call's tokens."""
    moe = MoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
    assert TB.moe_capacity(moe, tokens_) == want
    assert max(int(JMoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
                   .capacity_factor * tokens_ * k / e), k) == want


@pytest.mark.parametrize("arch,cf", [
    ("moonshot-v1-16b-a3b", None), ("moonshot-v1-16b-a3b", 1.0),
    ("phi3.5-moe-42b-a6.6b", None), ("phi3.5-moe-42b-a6.6b", 1.0),
    ("phi3.5-moe-42b-a6.6b", 0.5)])
def test_moe_layer_output_aux_and_grads_match_reference(arch, cf):
    """One MoE MLP on 3 x 16 tokens, drop-free (the SMOKE's capacity
    factor E/k) and at 1.0 and 0.5, where items drop: y and aux within
    1e-5; the gradient of sum(sin(y)) + aux with respect to the input and
    every leaf (router, experts, shared) within 1e-3."""
    jcfg, tcfg, jp, tp = _layer(arch, cf)
    x = (np.random.default_rng(1).standard_normal((3, 16, tcfg.d_model))
         * 0.7).astype(np.float32)
    jy, jaux = _jax_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = TB.moe_apply(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=MOE_TOL,
                               atol=MOE_TOL)
    probs = torch.softmax(torch.as_tensor(x).reshape(48, -1)
                          @ tp["router"], -1)
    _, idx = TB.moe_route(probs, tcfg.moe.top_k)
    kept, items = _kept(tcfg, idx.numpy(), 48)
    assert (kept < items) == (cf is not None), (kept, items)

    def jfn(p, xx):
        y, aux = _jax_moe(p, xx, jcfg)
        return jnp.sum(jnp.sin(y)) + aux

    jg, jgx = jax.grad(jfn, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in leaves_with_paths(tp)]
    tx = torch.as_tensor(x).requires_grad_(True)
    y, aux = TB.moe_apply(tp, tx, tcfg)
    grads = torch.autograd.grad(torch.sin(y).sum() + aux, leaves + [tx])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               rtol=GRAD_TOL, atol=GRAD_TOL, err_msg="x")
    for (path, _), g in zip(leaves_with_paths(tp), grads):
        want = jg
        for key in path:
            want = want[key]
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("kind", ["all_equal", "pairs", "bf16_grid"])
def test_route_breaks_ties_as_jax_top_k(kind):
    """Among equal probabilities the lower expert comes first, as in
    ``jax.lax.top_k``: every index of the top 6 of 64 equal, on three
    kinds of ties (all experts equal; experts equal in pairs; values on a
    coarse grid, many equal)."""
    rng = np.random.default_rng(7)
    t, e, k = 40, 64, 6
    if kind == "all_equal":
        probs = np.full((t, e), 1.0 / e, np.float32)
    elif kind == "pairs":
        probs = np.repeat(rng.random((t, e // 2)), 2, axis=1)
    else:
        probs = rng.integers(0, 5, size=(t, e)) / 8.0
    probs = probs.astype(np.float32)
    jg, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tg, ti = TB.moe_route(torch.as_tensor(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("router", ["zero", "pairs"])
def test_moe_layer_with_tied_router_matches_reference(router):
    """moonshot SMOKE's MoE MLP at capacity factor 1.0 with a router whose
    logits tie (all zero: every token picks experts 0 and 1; columns
    repeated in pairs: each token's choices tie two by two), so the tie
    order decides which items drop; y and aux within 1e-5."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, tcfg, jp, tp = _layer(arch, 1.0)
    w = np.asarray(jp["router"])
    w = np.zeros_like(w) if router == "zero" else np.repeat(
        w[:, ::2], 2, axis=1)
    jp = dict(jp, router=jnp.asarray(w))
    tp = dict(tp, router=torch.as_tensor(w))
    x = (np.random.default_rng(2).standard_normal((2, 12, tcfg.d_model))
         * 0.7).astype(np.float32)
    jy, jaux = _jax_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = TB.moe_apply(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=MOE_TOL,
                               atol=MOE_TOL)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_dropping_copy_forward_and_step_match_reference(arch):
    """A SMOKE copy at capacity factor 1.0, which drops items: forward
    logits and aux (fp32 3e-4 and 1e-5) and one train step (1e-3)."""
    jcfg, tcfg, _, _ = _layer(arch, 1.0)
    jp = jparams(arch)
    toks = tokens(2, 24)
    jl, jaux = JM.forward(jp, jnp.asarray(toks), jcfg, remat="none")
    tl, taux = TM.forward_with_aux(port(jp, tcfg), torch.as_tensor(toks),
                                   tcfg)
    _close_logits(tl, jl, tcfg, 3e-4, "forward logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=MOE_TOL,
                               atol=MOE_TOL)
    close_step(*_step_pair(jcfg, tcfg, jp), tcfg)


def test_aux_enters_the_objective_not_the_reported_loss():
    """The step reports the cross-entropy alone; its gradients are those
    of cross-entropy + MOE_AUX_COEF · aux (the router's gradient moves
    with the coefficient)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import step as S
    _, tcfg = cfgs("phi3.5-moe-42b-a6.6b")
    tp = port(jparams("phi3.5-moe-42b-a6.6b"), tcfg, torch.float32)
    toks = torch.as_tensor(tokens(2, 17, seed=4)).long()
    micro = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    total, ce = S.make_loss_fn(tcfg, RunConfig(remat="none"))(tp, micro)
    logits, aux = TM.forward_with_aux(tp, micro["tokens"], tcfg)
    np.testing.assert_allclose(float(ce), float(TM.lm_loss(
        logits, micro["labels"])), rtol=1e-6)
    np.testing.assert_allclose(float(total - ce),
                               float(S.MOE_AUX_COEF * aux), rtol=1e-5)
    assert float(aux) > 1.0


# ---------------------------------------------------------------------------
# Linear-MoE: the paper's recipe on moonshot
# ---------------------------------------------------------------------------

def _linear_moe(linearize):
    jc, tc = cfgs("moonshot-v1-16b-a3b")
    return jc.linearize(hybrid_every=linearize), \
        tc.linearize(hybrid_every=linearize)


@pytest.mark.parametrize("linearize", [0, 2])
def test_linear_moe_forward_step_and_decode_match_reference(linearize):
    """``linearize=0`` (every layer linear attention + MoE) and ``2`` (a
    1/2 hybrid: linear, then softmax with a 2048 window): the configs'
    patterns equal the reference's; forward logits and aux (fp32 3e-4,
    1e-5), one train step (1e-3), prefill caches and 6 decode steps
    (3e-4)."""
    jcfg, tcfg = _linear_moe(linearize)
    assert [dataclasses.asdict(s) for s in tcfg.pattern] == \
        [dataclasses.asdict(s) for s in jcfg.pattern]
    assert {s.mixer for s in tcfg.pattern} == (
        {"linear"} if linearize == 0 else {"linear", "softmax"})
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = port(jp, tcfg)
    toks = tokens(2, 20, seed=6)
    jl, jaux = JM.forward(jp, jnp.asarray(toks), jcfg, remat="none")
    tl, taux = TM.forward_with_aux(tp, torch.as_tensor(toks), tcfg)
    _close_logits(tl, jl, tcfg, 3e-4, "forward logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=MOE_TOL,
                               atol=MOE_TOL)
    close_step(*_step_pair(jcfg, tcfg, jp), tcfg)
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=32)
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, max_len=32)
    _close_logits(tl, jl, tcfg, 3e-4, "prefill logits")
    _close_cache(tc, jc, tcfg, 3e-4)
    rng = np.random.default_rng(3)
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for step in range(6):
        tok = rng.integers(0, 512, size=2).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
        _close_logits(tl, jl, tcfg, 3e-4, f"decode step {step}")


def test_linear_moe_clis_on_the_cpu():
    """``--arch moonshot-v1-16b-a3b --linearize 0 --smoke --device cpu``
    through both CLIs: the server answers every request (linear states,
    no K/V ring), the trainer's loss falls."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "1"}
    common = ["--arch", "moonshot-v1-16b-a3b", "--linearize", "0",
              "--smoke", "--device", "cpu"]
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *common,
         "--requests", "4", "--max-batch", "2", "--prompt-len", "16",
         "--new-tokens", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr[-3000:]
    assert "4 requests" in serve.stdout and "kv_ring=0" in serve.stdout
    assert "smoke-linear" in serve.stdout
    tr = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--steps", "20", "--seq", "64", "--batch", "4", "--lr", "1e-3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert tr.returncode == 0, tr.stderr[-3000:]
    assert "over 20 steps (improved)" in tr.stdout, tr.stdout
