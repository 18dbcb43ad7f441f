"""Port vs reference: the paper's Linear-Llama3 variants (paper §4).

Table 2's five attention modules (basic, lightning, retention, GLA's
data-dependent decay, based's taylor feature map), each pure and as a 1/4
hybrid; Table 3's bidirectional pair (an elu1 linear model and a softmax
model, ``causal=False``, masked-token labels of -1); Table 4's hybrid
ratios. The configs are built in code, as the reference's benchmarks
build them (``benchmarks/table2_convergence.py``,
``table3_bidirectional.py``, ``table4_hybrid_ratio.py``), at SMOKE's
widths (d_model 64, 4 heads of 16) with 4 or 8 layers. The reference's
params go across with ``params_from_jax`` as fp32; tokens come from numpy
with a seed. Tolerances: the reference's kernel tests'
(``tests/test_kernels.py:14-15``), fp32 3e-4 for logits and states, 1e-3
for losses and gradients (each leaf at its own scale); the change an
AdamW step makes to every param within 1e-3 and 1e-7 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as TB
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.optim import adamw as tadamw

LOGIT_TOL, GRAD_TOL = 3e-4, 1e-3
UPDATE_ATOL = 1e-7
VOCAB = 512
# Table 2's modules (benchmarks/table2_convergence.py:33-40)
MODULES = {
    "basic": dict(feature_map="identity", decay="none", backward="faithful"),
    "lightning": dict(feature_map="silu", decay="lightning",
                      backward="faithful"),
    "retention": dict(feature_map="identity", decay="retention",
                      backward="faithful"),
    "gla": dict(feature_map="silu", decay="data", backward="autodiff"),
    "based": dict(feature_map="taylor", decay="none", backward="autodiff")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is fastest beside the suite's
    parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _dense(B, n_layers=4, mixer="softmax"):
    """SMOKE's widths in the layout of Table 2's tiny Llama3."""
    return B.ModelConfig(name="llama3-tiny", family="dense",
                         n_layers=n_layers, d_model=64, n_heads=4,
                         n_kv_heads=4, d_ff=160, vocab_size=VOCAB,
                         pattern=(B.LayerSpec(mixer=mixer),),
                         dtype="float32")


def _variant(B, module, hybrid):
    """Table 2's ``_variant``: linearize, then the module's settings."""
    cfg = _dense(B).linearize(hybrid_every=4 if hybrid else 0)
    return dataclasses.replace(
        cfg, linear_attn=B.LinearAttnConfig(**MODULES[module]))


def _both(build, *args):
    return build(JB, *args), build(TB, *args)


def _port(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu", dtype=torch.float32)


def _jax_layout(tree, cfg):
    """A port tree (one dict per layer) in the reference's layout (layer
    params stacked over groups per pattern position), as numpy."""
    n = len(cfg.pattern)
    num = lambda t: t.detach().float().numpy()
    groups = []
    for p in range(n):
        layers = tree["layers"][p::n]
        groups.append({mod: {name: np.stack([num(l[mod][name])
                                             for l in layers])
                             for name in layers[0][mod]}
                       for mod in layers[0]})
    return {"embed": {k: num(v) for k, v in tree["embed"].items()},
            "groups": groups,
            "final_norm": {"scale": num(tree["final_norm"]["scale"])}}


def _close_trees(port_tree, jax_tree, cfg, tol, what, atol=None):
    """Every leaf within ``rtol=tol`` and ``atol``: by default ``tol``
    times min(1, the leaf's largest |value|), so a small leaf (GLA's
    ``wdt``, scale 0.01) is held to its own scale, never looser than
    ``tol`` absolute."""
    got = jax.tree_util.tree_flatten_with_path(_jax_layout(port_tree, cfg))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    assert len(got) == len(want)
    for path, g in got:
        w = np.asarray(want[path], np.float32)
        limit = atol if atol is not None else \
            tol * min(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(
            g, w, rtol=tol, atol=limit,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _close_adamw_step(new, old, grads, cfg, lr, what):
    """The change one AdamW step made to every param, ``new - old``,
    against the reference's ``adamw.update`` on the same gradients and
    params (a first step, fp32), within rtol 1e-3 and atol 1e-7. A first
    step moves each element by about ±lr, so holding the params at 1e-3
    could not tell an update left out from one made; this can, and sees
    the weight-decay term lr·0.1·p of a leaf at scale 0.01. (The
    gradients are held to the reference's separately: Adam's
    g / (|g| + eps) turns the fp32 noise of a gradient within a few eps of
    zero into a change of up to lr, so the two sides' steps are compared
    on one gradient.)"""
    jold, jg = _jax_layout(old, cfg), _jax_layout(grads, cfg)
    jnew, _ = jadamw.update(jg, jadamw.init(jold), jold, lr=lr,
                            weight_decay=0.1)
    delta = tree_map(lambda a, b: a.detach() - b, new, old)
    jdelta = jax.tree.map(lambda a, b: np.asarray(a, np.float32) - b,
                          jnew, jold)
    _close_trees(delta, jdelta, cfg, GRAD_TOL, what, atol=UPDATE_ATOL)


def _close_logits(got, want, what):
    np.testing.assert_allclose(got.detach().numpy()[..., :VOCAB],
                               np.asarray(want)[..., :VOCAB],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=what)


def _lm_batch(b=2, s=32, seed=0):
    """Next-token rows with document starts mid-row."""
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    resets = np.zeros((b, s), bool)
    resets[:, 0] = True
    resets[0, 13] = resets[1, 20] = True
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32), \
        resets


def _mlm_batch(b=2, s=32, seed=0):
    """Table 3's masked-token objective (``_mlm_batch``): 15% of tokens
    become id 0, the other labels are -1."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.15
    return np.where(mask, 0, tokens).astype(np.int32), \
        np.where(mask, tokens, -1).astype(np.int32)


def _step_both(jcfg, tcfg, jparams, inputs, labels, *, resets=None,
               causal=True):
    """Logits, loss and gradients of ``lm_loss`` on both sides, then one
    clipped AdamW step (Table 3's loop: clip 1.0, lr 1e-3, weight decay
    0.1), all held to the reference: the gradients leaf by leaf at their
    own scale, the step by the change it made to every param."""
    jres = None if resets is None else jnp.asarray(resets)

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(inputs), jcfg, remat="none",
                               resets=jres, causal=causal)
        return JM.lm_loss(logits, jnp.asarray(labels)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tp = _port(jparams, tcfg)
    leaves = [p.requires_grad_(True) for _, p in leaves_with_paths(tp)]
    tlogits = TM.forward(tp, torch.as_tensor(inputs), tcfg, causal=causal,
                         resets=None if resets is None
                         else torch.as_tensor(resets))
    tl = TM.lm_loss(tlogits, torch.as_tensor(labels))
    _close_logits(tlogits, jlogits, "logits")
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    it = iter(torch.autograd.grad(tl, leaves))
    tg = tree_map(lambda _: next(it), tp)
    _close_trees(tg, jg, tcfg, GRAD_TOL, "grad")

    _, jnorm = jadamw.clip_by_global_norm(jg, 1.0)
    tg, tnorm = tadamw.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=GRAD_TOL)
    old = tree_map(lambda p: p.detach().clone(), tp)
    with torch.no_grad():
        tadamw.update(tg, tadamw.init(tp), tp, lr=1e-3, weight_decay=0.1)
    _close_adamw_step(tp, old, tg, tcfg, 1e-3, "AdamW update")
    return tp, tg


@pytest.mark.parametrize("hybrid", [False, True], ids=["pure", "hybrid4"])
@pytest.mark.parametrize("module", list(MODULES))
def test_table2_forward_grads_and_adamw_step(module, hybrid):
    """Logits (3e-4), loss, every gradient (1e-3 of its leaf's scale) and
    the change one clipped AdamW step made to every param (1e-3, atol
    1e-7) on packed rows with resets. GLA's
    gradients include ``wdt``, the gate each linear layer adds."""
    jcfg, tcfg = _both(_variant, module, hybrid)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    inputs, labels, resets = _lm_batch()
    tp, tg = _step_both(jcfg, tcfg, jparams, inputs, labels, resets=resets)
    linear = [i for i, s in enumerate(tcfg.layer_specs())
              if s.mixer == "linear"]
    assert len(linear) == (3 if hybrid else 4)
    for i, layer in enumerate(tp["layers"]):
        assert ("wdt" in layer["mixer"]) == (module == "gla"
                                             and i in linear)
    if module == "gla":
        for i in linear:
            assert tg["layers"][i]["mixer"]["wdt"].shape == (64, 4)
            assert float(tg["layers"][i]["mixer"]["wdt"].abs().max()) > 0


# jitted: eager dispatch of the reference's layer scan costs more than
# compiling it once
_j_decode = jax.jit(JM.decode_step, static_argnums=3)
_j_prefill = jax.jit(JM.prefill, static_argnums=2)


def _decode_both(jcfg, tcfg, jparams, tp, jcache, tcache, toks, what):
    for n, tok in enumerate(toks):
        jl, jcache = _j_decode(jparams, jnp.asarray(tok), jcache, jcfg)
        tl, tcache = TM.decode_step(tp, torch.as_tensor(tok), tcache, tcfg)
        _close_logits(tl, jl, f"{what} decode step {n}")
    for i, layer in enumerate(tcache["layers"]):
        g, p = divmod(i, len(tcfg.pattern))
        for name in ("m", "log_decay"):
            want = np.asarray(jcache["layers"][p]["mixer"][name][g])
            assert layer["mixer"][name].shape == want.shape
            np.testing.assert_allclose(layer["mixer"][name].numpy(), want,
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=f"{what} layer {i} {name}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("module", list(MODULES))
def test_pure_prefill_and_decode_match_reference(module):
    """Left-padded prefill (logits and the cache's state and log decay)
    and 8 greedy-free decode steps from it; then 8 decode steps from an
    empty ``init_cache``, which sizes taylor's state 1 + dh + dh² rows,
    as the reference (the cache that serving slots are made of)."""
    jcfg, tcfg = _both(_variant, module, False)
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    tp = _port(jparams, tcfg)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, VOCAB, (3, 24)).astype(np.int32)
    pad = np.array([5, 0, 11], np.int32)
    steps = rng.integers(0, VOCAB, (8, 3)).astype(np.int32)
    jl, jcache = _j_prefill(jparams, jnp.asarray(prompt), jcfg,
                            pad_lens=jnp.asarray(pad))
    tl, tcache = TM.prefill(tp, torch.as_tensor(prompt), tcfg, pad_lens=pad)
    _close_logits(tl, jl, "prefill")
    _decode_both(jcfg, tcfg, jparams, tp, jcache, tcache, steps, "prefill")
    dk = 1 + 16 + 16 * 16 if module == "based" else 16
    tcache = TM.init_cache(tcfg, 3, 64, device="cpu")
    assert tcache["layers"][0]["mixer"]["m"].shape == (3, 4, dk, 16)
    _decode_both(jcfg, tcfg, jparams, tp, JM.init_cache(jcfg, 3, 64),
                 tcache, steps, "init_cache")


@pytest.mark.parametrize("linear", [True, False], ids=["elu1", "softmax"])
def test_table3_bidirectional_matches_reference(linear):
    """Table 3's pair under ``causal=False`` on its masked-token batch:
    logits, loss, gradients and one clipped AdamW step. The linear model
    reads the whole sequence's state (paper Alg. 1); the softmax model
    attends to every key."""
    def build(B):
        return dataclasses.replace(
            _dense(B, mixer="linear" if linear else "softmax"),
            linear_attn=B.LinearAttnConfig("elu1", "none", "faithful"))
    jcfg, tcfg = _both(build)
    jparams = JM.init_params(jax.random.PRNGKey(4), jcfg)
    inputs, labels = _mlm_batch()
    assert (labels == -1).mean() > 0.7
    _step_both(jcfg, tcfg, jparams, inputs, labels, causal=False)
    # bidirectional: a later token moves an earlier position's logits
    tp = _port(jparams, tcfg)
    moved = inputs.copy()
    moved[:, -1] = (moved[:, -1] + 1) % VOCAB
    a, b = (TM.forward(tp, torch.as_tensor(x), tcfg, causal=False)
            for x in (inputs, moved))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 0


@pytest.mark.parametrize("every", [8, 2])
def test_table4_hybrid_ratio_matches_reference(every):
    """Table 4's ``linearize(hybrid_every)`` on 8 layers: the pattern, the
    logits, the loss and the gradients."""
    jcfg, tcfg = _both(lambda B: _dense(B, n_layers=8).linearize(
        hybrid_every=every))
    mixers = [s.mixer for s in tcfg.layer_specs()]
    assert mixers == [s.mixer for s in jcfg.pattern] * jcfg.n_groups
    assert mixers.count("softmax") == 8 // every
    jparams = JM.init_params(jax.random.PRNGKey(5), jcfg)
    inputs, labels, resets = _lm_batch(seed=6)
    _step_both(jcfg, tcfg, jparams, inputs, labels, resets=resets)


def test_params_from_jax_carries_wdt_only_for_data_decay():
    """``mixer.wdt`` maps for GLA's linear layers (none on its hybrid's
    softmax layer) and is an unmapped leaf for any other decay."""
    jcfg, tcfg = _both(_variant, "gla", True)
    jparams = JM.init_params(jax.random.PRNGKey(6), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    assert [s.mixer for s in tcfg.pattern] == ["linear"] * 3 + ["softmax"]
    np.testing.assert_array_equal(
        tp["layers"][1]["mixer"]["wdt"].numpy(),
        tree["groups"][1]["mixer"]["wdt"][0])
    assert "wdt" not in tp["layers"][3]["mixer"]
    n_port = sum(t.numel() for _, t in leaves_with_paths(tp))
    assert n_port == sum(x.size for x in jax.tree.leaves(jparams))
    _, basic = _both(_variant, "basic", True)
    with pytest.raises(ValueError, match="unmapped leaves.*wdt"):
        params_from_jax(tree, basic, device="cpu")


def test_gla_train_step_and_checkpoint_roundtrip(tmp_path):
    """One-device train step of the GLA hybrid (2 microbatches, resets)
    against the reference's: loss and grad norm within 1e-3, both moments
    within 1e-3 of each leaf's scale, the change to every param (``wdt``
    included) within 1e-3 and 1e-7 of the reference's AdamW on the same
    gradients; then the new state through a checkpoint and
    back, bitwise, ``wdt`` and its Adam moments among the leaves."""
    from repro.configs.base import RunConfig as JRun
    from repro.data.pipeline import SyntheticLM
    from repro.sharding.rules import local_plan
    from repro.train.step import init_state as j_init_state
    from repro.train.step import make_train_step as j_make_train_step
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import (_accum_grads, make_loss_fn,
                                        make_train_step, state_from_params)
    jcfg, tcfg = _both(_variant, "gla", True)
    kw = dict(num_microbatches=2, remat="none", warmup_steps=0,
              total_steps=10, learning_rate=1e-3)
    jrun, trun = JRun(**kw), RunConfig(**kw)
    jstate = j_init_state(jax.random.PRNGKey(7), jcfg, jrun)
    tstate = state_from_params(_port(jstate["params"], tcfg))
    old = tree_map(lambda p: p.detach().clone(), tstate["params"])
    batch = SyntheticLM(VOCAB, 32, 4, seed=8, mean_doc_len=8).microbatched(
        0, 2)
    jnew, jm = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))(
        jstate, batch)
    tnew, tm = make_train_step(tcfg, trun)(tstate, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=key)
    # the step's change to every param against the reference's AdamW on
    # the port's own clipped gradients of the old params
    grads, _ = _accum_grads(make_loss_fn(tcfg, trun),
                            tree_map(lambda p: p.clone().requires_grad_(True),
                                     old),
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    grads, _ = tadamw.clip_by_global_norm(grads, trun.grad_clip)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    _close_adamw_step(tnew["params"], old, grads, tcfg, tm["lr"], "update")
    _close_trees(tnew["opt"].m, jnew["opt"].m, tcfg, GRAD_TOL, "m")
    _close_trees(tnew["opt"].v, jnew["opt"].v, tcfg, GRAD_TOL, "v")

    tree = {"params": tnew["params"], "m": tnew["opt"].m,
            "v": tnew["opt"].v}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree)
    target = tree_map(torch.zeros_like, tree)
    out = mgr.restore(1, target)
    paths = ["/".join(p) for p, _ in leaves_with_paths(out)]
    assert sum(p.endswith("mixer/wdt") for p in paths) == 3 * 3
    for (_, a), (_, b) in zip(leaves_with_paths(out),
                              leaves_with_paths(tree)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lr", [3e-4, 1e-2])
def test_gla_train_trajectory_matches_reference(lr):
    """Five one-device train steps of the pure GLA model on the card's
    GLA training schedule (2 microbatches, resets, warm-up 2, cosine over
    5) against the reference's: every step's loss and grad norm within
    1e-3. At 3e-4, the card's
    learning rate at which full width's loss rises at step 4; at 1e-2,
    d_model · lr (0.64) matches full width's at 3e-4 (0.61), the most one
    sign-like Adam step can move the gate x · wdt."""
    from repro.configs.base import RunConfig as JRun
    from repro.data.pipeline import SyntheticLM
    from repro.sharding.rules import local_plan
    from repro.train.step import init_state as j_init_state
    from repro.train.step import make_train_step as j_make_train_step
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.step import make_train_step, state_from_params
    jcfg, tcfg = _both(_variant, "gla", False)
    kw = dict(num_microbatches=2, remat="none", warmup_steps=2,
              total_steps=5, learning_rate=lr)
    jrun, trun = JRun(**kw), RunConfig(**kw)
    jstate = j_init_state(jax.random.PRNGKey(10), jcfg, jrun)
    tstate = state_from_params(_port(jstate["params"], tcfg))
    data = SyntheticLM(VOCAB, 64, 4, seed=11, mean_doc_len=16)
    jstep = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))
    tstep = make_train_step(tcfg, trun)
    got, want = [], []
    for step in range(5):
        batch = data.microbatched(step, 2)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        got.append((tm["loss"], tm["grad_norm"]))
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("module", ["gla", "based"])
def test_engine_serves_variant_like_reference(module):
    """The serving engine on a pure GLA and a pure based model: ragged
    prompts in left-padded buckets, fewer slots than requests, greedy
    tokens equal to the reference engine's. Its slots are ``init_cache``
    states, taylor's 1 + dh + dh² rows deep and constant in ``max_len``."""
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.serve.engine import ServeEngine
    jcfg, tcfg = _both(lambda B: dataclasses.replace(
        _variant(B, module, False), n_layers=2))
    jparams = JM.init_params(jax.random.PRNGKey(8), jcfg)
    tp = _port(jparams, tcfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
               for n in (5, 12, 19)]
    jeng = JServeEngine(jcfg, jparams, max_len=48, max_batch=2)
    teng = ServeEngine(tcfg, tp, max_len=48, max_batch=2, device="cpu")
    juids = [jeng.submit(p, 6) for p in prompts]
    tuids = [teng.submit(p, 6) for p in prompts]
    jres, tres = jeng.run(), teng.run()
    for ju, tu in zip(juids, tuids):
        np.testing.assert_array_equal(tres[tu], jres[ju])
    dk = 1 + 16 + 256 if module == "based" else 16
    longer = ServeEngine(tcfg, tp, max_len=4096, max_batch=2, device="cpu")
    assert teng.cache_stats()["linear_state"] == \
        longer.cache_stats()["linear_state"] == \
        2 * 2 * 4 * (dk * 16 + 1) * 4
