"""Port vs reference: the decoder-only zoo on the CPU at SMOKE size.

The dense decoders (codeqwen1.5-7b and qwen1.5-110b with QKV biases,
granite-34b with MQA, starcoder2-15b with GQA) and the MoE pair
(moonshot-v1-16b-a3b with shared experts, phi3.5-moe-42b-a6.6b). The
reference's params, carried across with ``params_from_jax``, and the same
numpy inputs go through ``repro`` (XLA on the CPU) and ``repro_torch``
(the plain versions of the kernels). The biases start at zero in both
packages, so the tests draw them at random first: a bias the port dropped
would show. Tolerances: logits fp32 3e-4, bf16 4e-2 (the reference's
kernel tolerances, ``tests/test_kernels.py:14``); caches fp32 3e-4, bf16
K/V one bf16 step; losses, gradients, params and moments 1e-3 (its
``GRAD_TOL``); the GELU 1e-6, where both sides compute the same fp32
function.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import local_plan
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import make_train_step, state_from_params
from test_torch_mamba2 import _close_cache, _close_logits
from test_torch_train import _close_trees

DENSE = ("codeqwen1.5-7b", "qwen1.5-110b", "granite-34b", "starcoder2-15b")
MOE = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
ARCHS = DENSE + MOE
TOL = {"float32": 3e-4, "bfloat16": 4e-2}
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE shapes: one intra-op thread is fastest while the suite's
    parallel workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cfgs(arch, dtype="float32", **changes):
    """The reference's and the port's SMOKE of ``arch`` in ``dtype``."""
    return (dataclasses.replace(j_get_smoke(arch), dtype=dtype, **changes),
            dataclasses.replace(get_smoke(arch), dtype=dtype, **changes))


def with_random_biases(jparams, seed=0):
    """The reference's params with ``bq``, ``bk``, ``bv`` (zeros at init)
    drawn from N(0, 0.5²), so the bias path carries weight."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, jparams)
    for group in out["groups"]:
        mixer = group["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in mixer:
                mixer[name] = (rng.standard_normal(mixer[name].shape)
                               * 0.5).astype(np.float32)
    return jax.tree.map(jnp.asarray, out)


@functools.lru_cache(maxsize=None)
def jparams(arch, seed=0, **changes):
    jcfg, _ = cfgs(arch, **changes)
    return with_random_biases(JM.init_params(jax.random.PRNGKey(seed),
                                             jcfg), seed)


def port(jp, tcfg, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=dtype)


def tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Configs, weights and the GELU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("llama-3.2-vision-90b",
                                          "whisper-base"))
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_equal_the_reference_field_for_field(arch, which):
    """Every field of the port's ``ModelConfig`` (``moe``, ``encoder``
    and the pattern's specs among them) equals the reference's, and so
    do ``param_count`` and ``active_param_count``; the cross family's
    counts also under the Linear-X recipe (``linearize`` 0 and 4)."""
    got = (get_config if which == "config" else get_smoke)(arch)
    want = (j_get_config if which == "config" else j_get_smoke)(arch)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        elif f.name == "pattern":
            a = [dataclasses.asdict(s) for s in a]
            b = [dataclasses.asdict(s) for s in b]
        assert a == b, f.name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    if arch not in ARCHS:
        for k in (0, 4):
            assert got.linearize(k).param_count() \
                == want.linearize(k).param_count()


def test_gelu_is_the_reference_tanh_form():
    """``mlp_apply(act="gelu")`` against the reference's on the same fp32
    inputs, with identity weights so the products are exact: the GELU
    itself over [−6, 6] within 1e-6. ``jax.nn.gelu`` defaults to the tanh
    form; the exact erf form differs from it by up to 4.7e-4 here."""
    d = 64
    x = np.linspace(-6.0, 6.0, 200 * d, dtype=np.float32).reshape(200, d)
    eye = np.eye(d, dtype=np.float32)
    want = JL.mlp_apply({"w1": jnp.asarray(eye), "w2": jnp.asarray(eye)},
                        jnp.asarray(x), local_plan(), act="gelu")
    got = TL.mlp_apply({"w1": torch.as_tensor(eye),
                        "w2": torch.as_tensor(eye)}, torch.as_tensor(x),
                       act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "moonshot-v1-16b-a3b"])
def test_params_from_jax_maps_the_bias_and_moe_leaves(arch):
    """bf16 serving params: the biases stay fp32 and bitwise the
    reference's; the router, the expert stacks (E, d, d_ff) and the shared
    experts are bf16; a missing leaf raises."""
    _, tcfg = cfgs(arch, dtype="bfloat16")
    jp = jparams(arch)
    tp = port(jp, tcfg)
    layer = tp["layers"][1]
    if tcfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            assert layer["mixer"][name].dtype == torch.float32
            np.testing.assert_array_equal(
                layer["mixer"][name].numpy(),
                np.asarray(jp["groups"][0]["mixer"][name][1]))
        drop = ("mixer", "bk")
    else:
        moe = tcfg.moe
        assert layer["mlp"]["router"].dtype == torch.bfloat16
        assert tuple(layer["mlp"]["experts"]["w2"].shape) == (
            moe.num_experts, tcfg.d_ff, tcfg.d_model)
        assert set(layer["mlp"]["shared"]) == {"w1", "w2", "w3"}
        assert layer["mlp"]["shared"]["w1"].shape[1] == \
            tcfg.d_ff * moe.n_shared_experts
        drop = ("mlp", "experts", "w3")
    missing = jax.tree.map(np.asarray, jp)
    node = missing["groups"][0]
    for key in drop[:-1]:
        node = node[key]
    del node[drop[-1]]
    with pytest.raises(KeyError, match=drop[-1]):
        params_from_jax(missing, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# Forward, train step, prefill and decode, the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch, dtype):
    """Logits, and the MoE layers' summed router loss (fp32 1e-5, bf16
    1e-3: the router logits are bf16 products there)."""
    jcfg, tcfg = cfgs(arch, dtype)
    toks = tokens(2, 24)
    jl, jaux = JM.forward(jparams(arch), jnp.asarray(toks), jcfg,
                          remat="none")
    tl, taux = TM.forward_with_aux(port(jparams(arch), tcfg),
                                   torch.as_tensor(toks), tcfg)
    _close_logits(tl, jl, tcfg, TOL[dtype], "forward logits")
    tol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(taux), float(jaux), rtol=tol, atol=tol)
    assert (float(taux) > 0) == (arch in MOE)


def _step_pair(jcfg, tcfg, jp, **kw):
    """One train step of both packages from the same fp32 masters on the
    same batch (2 microbatches of packed rows): (port new state, port
    metrics, reference new state, reference metrics)."""
    kw = dict(num_microbatches=2, remat="full", warmup_steps=0,
              total_steps=10, learning_rate=1e-3, **kw)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jstate = {"params": jp, "opt": jadamw.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = state_from_params(port(jp, tcfg, torch.float32))
    batch = JSyntheticLM(jcfg.vocab_size, 32, 4, seed=2,
                         mean_doc_len=8).microbatched(0, 2)
    jnew, jm = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))(
        jstate, batch)
    tnew, tm = make_train_step(tcfg, trun)(tstate, batch)
    return tnew, tm, jnew, jm


def close_step(tnew, tm, jnew, jm, tcfg):
    for key in ("loss", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=key)
    _close_trees(tnew["params"], jnew["params"], tcfg, GRAD_TOL, "param")
    _close_trees(tnew["opt"].m, jnew["opt"].m, tcfg, GRAD_TOL, "m")
    _close_trees(tnew["opt"].v, jnew["opt"].v, tcfg, GRAD_TOL, "v")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step under ``remat="full"``: the loss (the cross-entropy alone,
    the MoE aux only in the objective), grad norm, every param (biases,
    router, experts, shared experts) and both Adam moments; 1e-3."""
    jcfg, tcfg = cfgs(arch)
    close_step(*_step_pair(jcfg, tcfg, jparams(arch)), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_reference(arch):
    """Exact-length prefill of 3 rows (the MoE capacity counts all 3
    rows' tokens, as the reference's): logits and every cache leaf; then 6
    decode steps of the 3 rows, logits and caches; fp32."""
    jcfg, tcfg = cfgs(arch)
    jp = jparams(arch)
    tp = port(jp, tcfg)
    toks = tokens(3, 13, seed=1)
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=24)
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, max_len=24)
    _close_logits(tl, jl, tcfg, TOL["float32"], "prefill logits")
    _close_cache(tc, jc, tcfg, TOL["float32"])
    rng = np.random.default_rng(3)
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for step in range(6):
        tok = rng.integers(0, 512, size=3).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], f"decode step {step}")
    _close_cache(tc, jc, tcfg, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference(arch):
    """Both engines, 4 requests on 2 slots, prompts of two lengths (exact-
    length prefill: none of these configs is pad-safe), fp32 (in bf16 a
    near-tie of two logits may break either way in the two frameworks):
    equal greedy tokens and prefill batches. Every decode step routes both
    slots of the grid through the MoE layers, in both."""
    jcfg, tcfg = cfgs(arch)
    jp = jparams(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (7, 7, 12, 12)]
    jeng = JServeEngine(jcfg, jp, max_len=32, max_batch=2)
    teng = ServeEngine(tcfg, port(jp, tcfg), max_len=32, max_batch=2,
                       device="cpu")
    assert not teng.bucket_lengths and not jeng.bucket_lengths
    juids = [jeng.submit(p, 6) for p in prompts]
    tuids = [teng.submit(p, 6) for p in prompts]
    jres, tres = jeng.run(), teng.run()
    for ju, tu, p in zip(juids, tuids, prompts):
        np.testing.assert_array_equal(tres[tu], jres[ju],
                                      err_msg=f"prompt len {len(p)}")
    assert teng.stats()["prefill_batches"] == jeng.stats()["prefill_batches"]
    js, ts = jeng.cache_stats(), teng.cache_stats()
    for kind in ("linear_state", "kv_ring", "total"):
        assert ts[kind] == js[kind], kind


@pytest.mark.parametrize("what", ["forward", "step"])
def test_granite_with_its_gelu_matches_reference(what):
    """granite-34b's ``CONFIG`` uses the GELU MLP (no ``w3``); its SMOKE
    is SwiGLU, so a SMOKE copy with ``mlp_act="gelu"`` carries the GELU
    through the forward (fp32 3e-4) and one train step (1e-3)."""
    arch = "granite-34b"
    jcfg, tcfg = cfgs(arch, mlp_act="gelu")
    jp = jparams(arch, mlp_act="gelu")
    assert "w3" not in jp["groups"][0]["mlp"]
    if what == "forward":
        toks = tokens(2, 24)
        jl, _ = JM.forward(jp, jnp.asarray(toks), jcfg, remat="none")
        tl = TM.forward(port(jp, tcfg), torch.as_tensor(toks), tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], "forward logits")
    else:
        close_step(*_step_pair(jcfg, tcfg, jp), tcfg)


@pytest.mark.parametrize("lr", [3e-4, 1e-2])
def test_train_trajectory_matches_reference(lr):
    """starcoder2-15b SMOKE, five train steps on the card's training
    schedule (2 microbatches, resets, warm-up 2, cosine over 5): every
    step's loss and grad norm within 1e-3 of the reference's. At 3e-4, and
    at 1e-2, where d_model · lr (0.64) is full width's at phase 14's 1e-4
    (0.61), the most one sign-like Adam step moves a projection's
    output."""
    from repro_torch.data.pipeline import SyntheticLM
    arch = "starcoder2-15b"
    jcfg, tcfg = cfgs(arch)
    kw = dict(num_microbatches=2, remat="none", warmup_steps=2,
              total_steps=5, learning_rate=lr)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jp = jparams(arch)
    jstate = {"params": jp, "opt": jadamw.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = state_from_params(port(jp, tcfg, torch.float32))
    data = SyntheticLM(tcfg.vocab_size, 64, 4, seed=11, mean_doc_len=16)
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


def test_half_width_gelu_cut_spikes_in_both_packages():
    """The witness for the 2-layer cuts' loss spike on the card (phase 14
    (b): starcoder2-15b at full width, 1e-4, 12.02 → 46.66 at step 2):
    starcoder2-15b at half width (d_model 3072, 24:2 heads of 128, the
    GELU MLP at 4·d_model), 1 layer, vocab 8192, at 2e-4, so d_model · lr
    is full width's at 1e-4 (0.61), on the card's schedule (2 warm-up
    steps, cosine over 3, 2 microbatches, resets). The reference's loss
    jumps by more than 1 at step 2 and the port follows it on the same
    weights and batches: every step's loss and grad norm within 1e-3."""
    from repro_torch.data.pipeline import SyntheticLM
    arch = "starcoder2-15b"
    cut = dict(n_layers=1, d_model=3072, n_heads=24, n_kv_heads=2,
               d_ff=12288, vocab_size=8192, dtype="float32")
    jcfg = dataclasses.replace(j_get_config(arch), **cut)
    tcfg = dataclasses.replace(get_config(arch), **cut)
    assert tcfg.mlp_act == "gelu"
    kw = dict(num_microbatches=2, remat="none", warmup_steps=2,
              total_steps=3, learning_rate=0.6144 / 3072)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = {"params": jp, "opt": jadamw.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = state_from_params(port(jp, tcfg, torch.float32))
    del jp
    data = SyntheticLM(tcfg.vocab_size, 64, 4, seed=0)
    jstep = jax.jit(j_make_train_step(jcfg, JRunConfig(**kw), local_plan()))
    tstep = make_train_step(tcfg, RunConfig(**kw))
    got, want = [], []
    saved = torch.get_num_threads()
    torch.set_num_threads(4)        # d_model 3072: more than SMOKE's one
    try:
        for step in range(3):
            batch = data.microbatched(step, 2)
            jstate, jm = jstep(jstate, batch)
            tstate, tm = tstep(tstate, batch)
            got.append((tm["loss"], tm["grad_norm"]))
            want.append((float(jm["loss"]), float(jm["grad_norm"])))
    finally:
        torch.set_num_threads(saved)
    print("reference (loss, grad norm) a step:", want, "port:", got)
    assert want[2][0] > want[0][0] + 1.0, want
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_adamw_pieces_change_no_bit(monkeypatch):
    """``update`` works each leaf in ``UPDATE_PIECE``-element pieces: with
    pieces of 7 elements (none of the leaves a whole number of them) the
    params and both moments after two steps equal the one-piece result
    bit for bit, decayed and undecayed leaves alike."""
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(0)
    params = {"embed": {"table": torch.randn(13, 9, generator=gen)},
              "ln1": {"scale": torch.randn(9, generator=gen)}}
    grads = [{"embed": {"table": torch.randn(13, 9, generator=gen)},
              "ln1": {"scale": torch.randn(9, generator=gen)}}
             for _ in range(2)]

    def run():
        p = {k: {n: t.clone() for n, t in d.items()}
             for k, d in params.items()}
        state = adamw.init(p)
        for g in grads:
            state = adamw.update(g, state, p, lr=1e-2)
        return p, state

    whole = run()
    monkeypatch.setattr(adamw, "UPDATE_PIECE", 7)
    pieces = run()
    for a, b in ((whole[0], pieces[0]), (whole[1].m, pieces[1].m),
                 (whole[1].v, pieces[1].v)):
        for key in ("embed", "ln1"):
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), (key, name)
