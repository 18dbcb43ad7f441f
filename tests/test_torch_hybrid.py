"""Port vs reference: the LASP-2H hybrid (3 linear layers + 1 softmax layer
with a sliding window) on the CPU at SMOKE size.

The SMOKE hybrid is built as ``tests/test_serve_parity.py:33-42`` builds
it, with window 2048 (the paper's) and 16 (so the ring cache wraps). The
reference's params, carried across with ``params_from_jax``, and the same
numpy tokens go through ``repro`` (XLA path on the CPU: its softmax layer
takes the banded form when ``S % window == 0`` and flash attention
otherwise) and ``repro_torch`` (the plain versions of the kernels).
Tolerances: fp32 3e-4 on logits and caches, bf16 4e-2 on logits (the
reference's kernel tolerances, ``tests/test_kernels.py:14``); the ring's
K/V, which both sides round to bf16 at the same point, one bf16 step
(2^-7 relative): fp32 values that differ by ~1e-7 may round apart;
losses, gradients and params 1e-3 (its ``GRAD_TOL``); positions exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs import get_variant as j_get_variant
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import local_plan
from repro.train.loop import train as j_train
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, get_smoke, get_variant
from repro_torch.configs.base import LayerSpec, RunConfig
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_step, state_from_params
from test_torch_train import _close_trees

ARCH = "linear-llama3-1b"
TOL = {"float32": 3e-4, "bfloat16": 4e-2}
GRAD_TOL = 1e-3
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE shapes: one intra-op thread is fastest while the suite's
    parallel workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _hybrid(base, layer_spec, window, dtype):
    dense = dataclasses.replace(base, pattern=(layer_spec(),), n_layers=4,
                                name="smoke-dense", dtype=dtype)
    cfg = dense.linearize(hybrid_every=4)   # 3 linear + 1 softmax
    pattern = tuple(dataclasses.replace(sp, sliding_window=window)
                    if sp.mixer == "softmax" else sp for sp in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern,
                               name=f"{cfg.name}-w{window}")


def _cfgs(window, dtype="float32"):
    return (_hybrid(j_get_smoke(ARCH), JLayerSpec, window, dtype),
            _hybrid(get_smoke(ARCH), LayerSpec, window, dtype))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs(16)
    return JM.init_params(jax.random.PRNGKey(0), jcfg)


def _port(jparams, tcfg, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu", dtype=dtype)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(
        np.int32)


def _close_logits(t, j, cfg, tol, what):
    v = cfg.vocab_size
    np.testing.assert_allclose(t.float().numpy()[..., :v],
                               np.asarray(j, np.float32)[..., :v],
                               rtol=tol, atol=tol, err_msg=what)


def _close_cache(tc, jc, cfg, tol):
    """Every layer's cache: linear (m, log_decay) and softmax (k, v, kpos),
    and the positions."""
    n = len(cfg.pattern)
    for i, layer in enumerate(tc["layers"]):
        g, p = divmod(i, n)
        for name, t in layer["mixer"].items():
            want = np.asarray(jc["layers"][p]["mixer"][name][g])
            assert t.shape == want.shape, (i, name)
            if name == "kpos":
                np.testing.assert_array_equal(t.numpy(), want)
            elif t.dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    t.float().numpy(), want.astype(np.float32),
                    rtol=BF16_STEP, atol=tol, err_msg=f"layer {i} {name}")
            else:
                np.testing.assert_allclose(
                    t.float().numpy(), want.astype(np.float32), rtol=tol,
                    atol=tol, err_msg=f"layer {i} {name}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_hybrid_variant_matches_reference():
    """``get_variant`` reaches the paper's hybrid; ``linearize=4`` on the
    all-linear ``CONFIG`` does not."""
    got = get_variant(ARCH, "HYBRID")
    want = j_get_variant(ARCH, "HYBRID")
    assert got.name == want.name == "linear-llama3-1b-hybrid4"
    assert [s.mixer for s in got.layer_specs()] == \
        ["linear", "linear", "linear", "softmax"] * 4
    assert [(s.mixer, s.sliding_window) for s in got.pattern] == \
        [(s.mixer, s.sliding_window) for s in want.pattern]
    assert got.param_count() == want.param_count()
    assert all(s.mixer == "linear"
               for s in get_config(ARCH, linearize=4).pattern)


@pytest.mark.parametrize("window,s", [(16, 48), (16, 40), (2048, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(jparams, window, s, dtype):
    """Forward logits on both sides of the reference's banded switch:
    S a multiple of the window (banded XLA form) and not (flash)."""
    jcfg, tcfg = _cfgs(window, dtype)
    toks = _tokens(2, s)
    jl, _ = JM.forward(jparams, jnp.asarray(toks), jcfg, remat="none")
    tl = TM.forward(_port(jparams, tcfg), torch.as_tensor(toks), tcfg)
    _close_logits(tl, jl, tcfg, TOL[dtype], "forward logits")


def test_forward_at_the_paper_window(jparams):
    """S = 2048 = the paper's window: the reference runs the banded form
    over one full window; fp32."""
    jcfg, tcfg = _cfgs(2048)
    toks = _tokens(1, 2048, seed=4)
    jl, _ = JM.forward(jparams, jnp.asarray(toks), jcfg, remat="none")
    tl = TM.forward(_port(jparams, tcfg), torch.as_tensor(toks), tcfg)
    _close_logits(tl, jl, tcfg, TOL["float32"], "forward logits S=2048")


@pytest.mark.parametrize("window,s,max_len", [(16, 20, 64), (2048, 20, 64),
                                              (16, 9, 32)])
def test_prefill_and_decode_through_ring_wrap(jparams, window, s, max_len):
    """Prefill logits and every cache (the ring's bf16 K/V and kpos), then
    decode steps past the end of the ring, each against the reference."""
    jcfg, tcfg = _cfgs(window)
    tp = _port(jparams, tcfg)
    toks = _tokens(3, s, seed=1)
    jl, jc = JM.prefill(jparams, jnp.asarray(toks), jcfg, max_len=max_len)
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, max_len=max_len)
    _close_logits(tl, jl, tcfg, TOL["float32"], "prefill logits")
    _close_cache(tc, jc, tcfg, TOL["float32"])
    ring = tc["layers"][3]["mixer"]["k"].shape[2]
    assert ring == min(window, max_len)
    rng = np.random.default_rng(2)
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    # past a wrap of the ring where the window is the ring
    steps = ring - s % ring + 3 if window <= max_len else 4
    for step in range(steps):
        tok = rng.integers(0, 512, size=3).astype(np.int32)
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], f"decode step {step}")
    _close_cache(tc, jc, tcfg, TOL["float32"])


def test_gqa_hybrid_matches_reference():
    """Grouped K/V heads (4 query heads, 2 KV heads) through the softmax
    layer: forward, prefill with its ring, and decode past a wrap."""
    jcfg, tcfg = (dataclasses.replace(c, n_kv_heads=2) for c in _cfgs(16))
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = _port(jp, tcfg)
    toks = _tokens(2, 20, seed=6)
    jl, _ = JM.forward(jp, jnp.asarray(toks), jcfg, remat="none")
    _close_logits(TM.forward(tp, torch.as_tensor(toks), tcfg), jl, tcfg,
                  TOL["float32"], "forward")
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=32)
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, max_len=32)
    _close_logits(tl, jl, tcfg, TOL["float32"], "prefill")
    _close_cache(tc, jc, tcfg, TOL["float32"])
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for step in range(3):
        tok = np.array([step, 300 + step], np.int32)
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], f"decode {step}")


def test_decode_continues_forward(jparams):
    """Port only: prefill + decode through the wrap reproduces the full
    forward's logits (window 16 over 40 positions)."""
    _, tcfg = _cfgs(16)
    tp = _port(jparams, tcfg)
    toks = torch.as_tensor(_tokens(2, 40, seed=3))
    full = TM.forward(tp, toks, tcfg)
    lg, cache = TM.prefill(tp, toks[:, :12], tcfg, max_len=64)
    _close_logits(lg, full[:, 11].numpy(), tcfg, 3e-4, "prefill")
    for i in range(12, 40):
        lg, cache = TM.decode_step(tp, toks[:, i], cache, tcfg)
        _close_logits(lg, full[:, i].numpy(), tcfg, 3e-4, f"pos {i}")


@pytest.mark.parametrize("window,lens", [(2048, [6, 11, 16]),
                                         (16, [6, 20, 20, 13])])
def test_greedy_tokens_match_reference_engine(jparams, window, lens):
    """Both engines, ragged prompts, fewer slots than requests: the hybrid
    groups prompts by exact length (no left-padding) and the tokens are
    equal; the cache footprints are equal by kind."""
    jcfg, tcfg = _cfgs(window)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in lens]
    jeng = JServeEngine(jcfg, jparams, max_len=64, max_batch=2)
    teng = ServeEngine(tcfg, _port(jparams, tcfg), max_len=64, max_batch=2,
                       device="cpu")
    assert not teng.bucket_lengths and not jeng.bucket_lengths
    juids = [jeng.submit(p, 8) for p in prompts]
    tuids = [teng.submit(p, 8) for p in prompts]
    jres, tres = jeng.run(), teng.run()
    for ju, tu, p in zip(juids, tuids, prompts):
        np.testing.assert_array_equal(tres[tu], jres[ju],
                                      err_msg=f"prompt len {len(p)}")
    assert teng.stats()["prefill_batches"] == jeng.stats()["prefill_batches"]
    js, ts = jeng.cache_stats(), teng.cache_stats()
    for kind in ("linear_state", "kv_ring", "total"):
        assert ts[kind] == js[kind], kind
    assert ts["kv_ring_arrays"] == js["kv_ring_arrays"] == 3


def test_cache_stats_formula_and_constant_linear_state(jparams):
    """``linear_state`` does not move with ``max_len``; ``kv_ring`` is
    2·B·n_kv·ring·dh·2 + B·ring·4 per softmax layer, ring =
    min(window, max_len)."""
    _, tcfg = _cfgs(16)
    tp = _port(jparams, tcfg)
    stats = {n: ServeEngine(tcfg, tp, max_len=n, max_batch=3,
                            device="cpu").cache_stats() for n in (8, 64)}
    assert stats[8]["linear_state"] == stats[64]["linear_state"] == \
        3 * 3 * tcfg.n_heads * (tcfg.head_dim ** 2 + 1) * 4
    for n, st in stats.items():
        ring = min(16, n)
        assert st["kv_ring"] == \
            2 * 3 * tcfg.n_kv_heads * ring * tcfg.head_dim * 2 + 3 * ring * 4
        assert st["total"] == st["linear_state"] + st["kv_ring"]


def test_prefill_rejects_left_padding_for_hybrids(jparams):
    _, tcfg = _cfgs(16)
    assert not TM.pad_safe(tcfg)
    with pytest.raises(ValueError, match="pad_lens"):
        TM.prefill(_port(jparams, tcfg), torch.as_tensor(_tokens(2, 8)),
                   tcfg, pad_lens=np.array([0, 3]))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,s", [(16, 64), (16, 56), (2048, 64)])
def test_loss_and_grads_match_reference(jparams, window, s):
    """lm_loss and every parameter gradient against jax.value_and_grad, on
    packed rows (the linear layers reset at document starts, the softmax
    layer attends across them), banded (S % window == 0) and flash
    reference paths; 1e-3."""
    jcfg, tcfg = _cfgs(window)
    batch = JSyntheticLM(jcfg.vocab_size, s, 2, seed=5,
                         mean_doc_len=16).batch(0)
    assert batch["resets"][:, 1:].any()

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(batch["tokens"]), jcfg,
                               remat="none",
                               resets=jnp.asarray(batch["resets"]))
        return JM.lm_loss(logits, jnp.asarray(batch["labels"]))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tp = state_from_params(_port(jparams, tcfg, torch.float32))["params"]
    leaves = [p for _, p in leaves_with_paths(tp)]
    tl = TM.lm_loss(TM.forward(tp, torch.as_tensor(batch["tokens"]), tcfg,
                               resets=torch.as_tensor(batch["resets"])),
                    torch.as_tensor(batch["labels"]))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    it = iter(torch.autograd.grad(tl, leaves))
    _close_trees(tree_map(lambda _: next(it), tp), jg, tcfg, GRAD_TOL,
                 "grad")


def test_train_step_matches_reference():
    """One step from the same state (2 microbatches, packed documents,
    window 16 over 32 tokens): loss, grad norm, every param and both Adam
    moments; 1e-3."""
    jcfg, tcfg = _cfgs(16)
    kw = dict(num_microbatches=2, remat="none", warmup_steps=0,
              total_steps=10, learning_rate=1e-3)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jstate = j_init_state(jax.random.PRNGKey(3), jcfg, jrun)
    tstate = state_from_params(_port(jstate["params"], tcfg, torch.float32))
    batch = JSyntheticLM(jcfg.vocab_size, 32, 4, seed=2,
                         mean_doc_len=8).microbatched(0, 2)
    jnew, jm = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))(
        jstate, batch)
    tnew, tm = make_train_step(tcfg, trun)(tstate, batch)
    for key in ("loss", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=key)
    _close_trees(tnew["params"], jnew["params"], tcfg, GRAD_TOL, "param")
    _close_trees(tnew["opt"].m, jnew["opt"].m, tcfg, GRAD_TOL, "m")
    _close_trees(tnew["opt"].v, jnew["opt"].v, tcfg, GRAD_TOL, "v")


def test_loss_trajectory_matches_reference_train():
    """8 steps of train() from the reference's initial params (window 16
    over 48-token rows) follow the reference's train() loss within 1e-3."""
    jcfg, tcfg = _cfgs(16)
    kw = dict(num_microbatches=2, total_steps=8, warmup_steps=2,
              learning_rate=1e-3, remat="none")
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    quiet = dict(log_every=10 ** 9, log_fn=lambda *_: None)
    _, jhist = j_train(jcfg, jrun, JSyntheticLM(jcfg.vocab_size, 48, 4,
                                                seed=0), **quiet)
    params = _port(JM.init_params(jax.random.PRNGKey(jrun.seed), jcfg),
                   tcfg, torch.float32)
    _, thist = train(tcfg, trun, SyntheticLM(tcfg.vocab_size, 48, 4, seed=0),
                     device="cpu", params=params, **quiet)
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"step {t['step']}")


def test_train_cli_takes_variant(monkeypatch):
    """``--variant HYBRID`` selects the hybrid (on a card only, so the
    config is read back from the call to train())."""
    seen = {}

    def fake_train(cfg, run, data, **kw):
        seen["cfg"] = cfg
        return None, [{"loss": 1.0}]

    monkeypatch.setattr("repro_torch.train.loop.train", fake_train)
    train_cli.main(["--variant", "HYBRID", "--device", "cpu", "--steps",
                    "1"])
    assert seen["cfg"].name == "linear-llama3-1b-hybrid4"


def test_serve_cli_takes_variant(monkeypatch):
    """``--variant HYBRID`` serves the hybrid (full width, so the config is
    read back from the call to init_params and the run stops there)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_init(generator, cfg, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr("repro_torch.models.model.init_params", fake_init)
    with pytest.raises(Stop):
        serve_cli.main(["--variant", "HYBRID", "--device", "cpu"])
    assert seen["cfg"].name == "linear-llama3-1b-hybrid4"
