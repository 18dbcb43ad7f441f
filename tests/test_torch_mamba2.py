"""Port vs reference: mamba2 (SSD) on the CPU at SMOKE size.

The reference's params, carried across with ``params_from_jax``, and the
same numpy inputs go through ``repro`` (XLA path on the CPU) and
``repro_torch`` (the plain versions of the kernels). Tolerances: fp32
3e-4 on outputs, logits and caches, bf16 4e-2 on logits (the reference's
kernel tolerances, ``tests/test_kernels.py:14``); the bf16 conv caches,
which both sides round at the same point, one bf16 step (2^-7 relative);
losses, gradients, params and moments 1e-3 (its ``GRAD_TOL``).
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

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import local_plan
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import LayerSpec, MoEConfig, RunConfig
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_step, state_from_params
from test_torch_train import _close_trees

ARCH = "mamba2-2.7b"
ROOT = Path(__file__).resolve().parent.parent
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


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_get_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke(ARCH), dtype=dtype))


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(jax.random.PRNGKey(0), _cfgs()[0])


def _port(jparams, tcfg, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu", dtype=dtype)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(
        np.int32)


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _close_logits(t, j, cfg, tol, what):
    v = cfg.vocab_size
    np.testing.assert_allclose(t.float().numpy()[..., :v],
                               np.asarray(j, np.float32)[..., :v],
                               rtol=tol, atol=tol, err_msg=what)


def _close_cache(tc, jc, cfg, tol):
    """Every cache leaf of every layer (nested dicts included) and the
    positions: fp32 leaves within ``tol``, bf16 ones one bf16 step."""
    n = len(cfg.pattern)
    for i, layer in enumerate(tc["layers"]):
        g, p = divmod(i, n)
        for path, t in leaves_with_paths(layer):
            want = jc["layers"][p]
            for key in path:
                want = want[key]
            want = np.asarray(want[g])
            what = f"layer {i} {'/'.join(path)}"
            assert t.shape == want.shape, what
            if path[-1] == "kpos":
                np.testing.assert_array_equal(t.numpy(), want)
            elif t.dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    t.float().numpy(), want.astype(np.float32),
                    rtol=BF16_STEP, atol=tol, err_msg=what)
            else:
                _close(t, want, tol, what)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# Configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_equal_the_reference_field_for_field(arch, which):
    """``get_config``/``get_smoke`` of the SSM family: every field of the
    port's ``ModelConfig`` (the pattern's specs, ``mamba`` among them)
    equals the reference's, and so does ``param_count``."""
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


def test_param_count_is_the_reference_approximation():
    """``param_count`` is approximate, as the reference's (its docstring):
    against the leaves ``layer_init`` makes it counts a second norm a
    layer (a mamba2 layer has no ``ln2``/``mlp``), two of the three
    nh-wide SSD vectors, and no final norm. The exact full-width count,
    2,831,074,816, is what the card trains as fp32 masters."""
    smoke = get_smoke(ARCH)
    layer = TB.layer_init(torch.Generator().manual_seed(0), smoke,
                          smoke.pattern[0], torch.float32, "cpu")
    assert "mlp" not in layer and "ln2" not in layer
    n_layer = sum(t.numel() for _, t in leaves_with_paths(layer))
    embed = 2 * smoke.padded_vocab * smoke.d_model
    nh = smoke.mamba.expand * smoke.d_model // smoke.mamba.headdim
    assert smoke.param_count() == embed + smoke.n_layers * (
        n_layer + smoke.d_model - nh)
    cfg = get_config(ARCH)
    nh = cfg.mamba.expand * cfg.d_model // cfg.mamba.headdim
    assert cfg.param_count() + cfg.n_layers * (nh - cfg.d_model) \
        + cfg.d_model == 2_831_074_816


def test_params_from_jax_keeps_1d_leaves_fp32_and_raises_on_strays(jparams):
    """bf16 serving params: the matrices and conv kernels are bf16, the
    1-D leaves (``dt_bias``, ``a_log``, ``d_skip``, norm scales) fp32 and
    bitwise the reference's; a leaf the port does not map raises, and so
    does an unknown mixer."""
    tcfg = get_smoke(ARCH)
    tp = _port(jparams, tcfg)
    mixer = tp["layers"][1]["mixer"]
    for name in ("dt_bias", "a_log", "d_skip"):
        assert mixer[name].dtype == torch.float32, name
        np.testing.assert_array_equal(
            mixer[name].numpy(), np.asarray(jparams["groups"][0]["mixer"]
                                            [name][1]))
    assert mixer["gnorm"]["scale"].dtype == torch.float32
    for name in ("wx", "wdt", "conv_x", "wo"):
        assert mixer[name].dtype == torch.bfloat16, name
    stray = jax.tree.map(np.asarray, jparams)
    stray["groups"][0]["mixer"]["extra"] = np.zeros((2, 3), np.float32)
    with pytest.raises(ValueError, match="unmapped leaves groups.0.mixer."
                       "extra"):
        params_from_jax(stray, tcfg, device="cpu")
    missing = jax.tree.map(np.asarray, jparams)
    del missing["groups"][0]["mixer"]["a_log"]
    with pytest.raises(KeyError, match="a_log"):
        params_from_jax(missing, tcfg, device="cpu")
    bogus = dataclasses.replace(tcfg, pattern=(LayerSpec("bogus", "dense"),))
    with pytest.raises(NotImplementedError, match="unknown mixer"):
        params_from_jax(missing, bogus, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b",
                                  "codeqwen1.5-7b", "moonshot-v1-16b-a3b"])
def test_decay_mask_and_zero1_pieces_cover_the_ssm_leaves(arch):
    """The flat decay mask leaves ``dt_bias``, ``a_log``, ``d_skip`` and
    the norm scales (``gnorm`` among them) undecayed, as the reference's
    (equal counts); ZeRO-1's padded size is the reference's; its shards
    cover the raveled params, SSD leaves included, exactly once. The same
    for the zoo's new leaves: codeqwen's ``bq``, ``bk``, ``bv`` (undecayed)
    and moonshot's router, expert stacks and shared experts (decayed)."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = _port(jp, get_smoke(arch), torch.float32)
    mask = adamw.decay_mask(tp)
    assert float(mask.sum()) == float(jadamw.decay_mask(jp).sum())
    off = 0
    for path, t in leaves_with_paths(tp):
        undecayed = path[-1] in ("dt_bias", "a_log", "d_skip", "scale",
                                 "bq", "bk", "bv")
        assert bool((mask[off:off + t.numel()] == 0).all()) == undecayed, \
            path
        off += t.numel()
    flat = torch.cat([t.reshape(-1) for _, t in leaves_with_paths(tp)])
    for n in (2, 3):
        padded = adamw.zero1_padded_size(tp, n)
        assert padded == jadamw.zero1_padded_size(jp, n)
        got = torch.cat([adamw.flat_slice(tp, i * padded // n,
                                          (i + 1) * padded // n)
                         for i in range(n)])
        assert torch.equal(got[:flat.numel()], flat)
        assert not got[flat.numel():].any()


@pytest.mark.parametrize("spec,ok", [
    (LayerSpec("mamba2", "none"), True), (LayerSpec("hymba", "dense"), True),
    (LayerSpec("linear", "none"), True), (LayerSpec("cross", "dense"), True),
    (LayerSpec("softmax", "moe"), True), (LayerSpec("bogus", "dense"), False)])
def test_layer_init_takes_every_mixer_and_rejects_unknown_ones(spec, ok):
    cfg = dataclasses.replace(get_smoke(ARCH), pattern=(spec,), d_ff=32,
                              moe=MoEConfig(num_experts=4))
    gen = torch.Generator().manual_seed(0)
    if ok:
        TB.layer_init(gen, cfg, spec, torch.float32, "cpu")
    else:
        with pytest.raises(NotImplementedError, match="unknown layer"):
            TB.layer_init(gen, cfg, spec, torch.float32, "cpu")


# ---------------------------------------------------------------------------
# The SSD mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches_reference(cached):
    """Depthwise causal conv + silu and its last K−1 inputs, from zeros or
    from a cache of earlier inputs; fp32 3e-4."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if cached else None
    jy, jc = JB._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if cache is None else jnp.asarray(cache))
    ty, tc = TB._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                             None if cache is None else torch.as_tensor(cache))
    _close(ty, jy, TOL["float32"], "conv output")
    _close(tc, jc, 0.0, "conv cache")
    np.testing.assert_array_equal(tc.numpy(), x[:, -3:])


def test_mixer_output_and_every_leaf_gradient_match_reference(jparams):
    """One mamba2 mixer on packed rows (resets mid-row): its output and
    the gradient of sum(sin(y)) with respect to the input and every leaf,
    ``a_log``, ``dt_bias`` and the conv kernels among them; 1e-3."""
    jcfg, tcfg = _cfgs()
    spec = tcfg.pattern[0]
    jmix = jax.tree.map(lambda a: a[0], jparams["groups"][0]["mixer"])
    tmix = _port(jparams, tcfg, torch.float32)["layers"][0]["mixer"]
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 48, tcfg.d_model)) * 0.5).astype(np.float32)
    resets = np.zeros((2, 48), bool)
    resets[:, [0, 17, 30]] = True

    def jfn(p, xx):
        ctx = JB.Ctx(cfg=jcfg, plan=local_plan(),
                     resets=jnp.asarray(resets))
        ctx._spec = spec
        return JB.mamba2_apply(p, xx, ctx)

    jy = jfn(jmix, jnp.asarray(x))
    jg, jgx = jax.grad(lambda p, xx: jnp.sum(jnp.sin(jfn(p, xx))),
                       argnums=(0, 1))(jmix, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in leaves_with_paths(tmix)]
    tx = torch.as_tensor(x).requires_grad_(True)
    ty = TB.mamba2_apply(tmix, tx, TB.Ctx(cfg=tcfg,
                                          resets=torch.as_tensor(resets)),
                         spec)
    _close(ty, jy, GRAD_TOL, "mixer output")
    grads = torch.autograd.grad(torch.sin(ty).sum(), leaves + [tx])
    _close(grads[-1], jgx, GRAD_TOL, "grad x")
    names = [p for p, _ in leaves_with_paths(tmix)]
    assert {"a_log", "dt_bias", "conv_x", "conv_b", "conv_c", "wdt"} <= {
        p[0] for p in names}
    for path, g in zip(names, grads):
        want = jg
        for key in path:
            want = want[key]
        assert float(np.abs(np.asarray(want)).max()) > 0, path
        _close(g, want, GRAD_TOL, f"grad {'/'.join(path)}")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(jparams, dtype):
    jcfg, tcfg = _cfgs(dtype)
    toks = _tokens(2, 40)
    jl, _ = JM.forward(jparams, jnp.asarray(toks), jcfg, remat="none")
    tl = TM.forward(_port(jparams, tcfg), torch.as_tensor(toks), tcfg)
    _close_logits(tl, jl, tcfg, TOL[dtype], "forward logits")


@pytest.mark.parametrize("pad", [False, True])
def test_prefill_caches_and_decode_match_reference(jparams, pad):
    """Prefill (exact length, or left-padded buckets with ``pad_lens``):
    logits and every cache leaf (fp32 ``m``, ``log_decay``; bf16
    ``conv_*``); then 8 decode steps, logits and caches; fp32."""
    jcfg, tcfg = _cfgs()
    tp = _port(jparams, tcfg)
    toks = _tokens(3, 21, seed=1)
    kw = {}
    if pad:
        pad_lens = np.array([0, 5, 19], np.int32)   # 2 real tokens < K−1
        toks[1, :5] = 0
        toks[2, :19] = 0
        kw = dict(pad_lens=pad_lens)
    jl, jc = JM.prefill(jparams, jnp.asarray(toks), jcfg, max_len=40,
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, max_len=40, **kw)
    _close_logits(tl, jl, tcfg, TOL["float32"], "prefill logits")
    _close_cache(tc, jc, tcfg, TOL["float32"])
    rng = np.random.default_rng(3)
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for step in range(8):
        tok = rng.integers(0, 512, size=3).astype(np.int32)
        jl, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], f"decode step {step}")
    _close_cache(tc, jc, tcfg, TOL["float32"])


def test_padded_filler_rows_stay_zero_and_decode_continues_forward(jparams):
    """Port only: left-padded prefill equals the unpadded prefill of the
    row (logits and every cache leaf but the log decay, which sums the
    filler's and the reset's log a too, as the reference's), the filler
    rows stay exactly zero through every mamba2 layer, and decode
    continues the full forward."""
    _, tcfg = _cfgs()
    tp = _port(jparams, tcfg)
    toks = torch.as_tensor(_tokens(1, 30, seed=4))
    padded = torch.cat([torch.zeros((1, 6), dtype=toks.dtype), toks], 1)
    lg_p, c_p = TM.prefill(tp, padded, tcfg, pad_lens=np.array([6]))
    lg, c = TM.prefill(tp, toks, tcfg)
    _close(lg_p, lg.numpy(), 3e-4, "padded prefill logits")
    for (path, a), (_, b) in zip(leaves_with_paths(c_p),
                                 leaves_with_paths(c)):
        if path[-1] != "log_decay":   # holds the filler's and reset's log a
            _close(a, b.float().numpy(), 3e-4, "/".join(path))
    seen = []
    hook = TB.layer_prefill

    def spy(params, x, ctx, spec, max_len):
        out = hook(params, x, ctx, spec, max_len)
        seen.append(float(out[0][:, :6].abs().max()))
        return out

    TB.layer_prefill = spy
    try:
        TM.prefill(tp, padded, tcfg, pad_lens=np.array([6]))
    finally:
        TB.layer_prefill = hook
    assert seen == [0.0] * tcfg.n_layers
    # decode reads its conv inputs from the bf16 cache, as the reference:
    # one bf16 step (2^-7 relative) of them moves these logits by ~5e-4
    full = TM.forward(tp, toks, tcfg)
    lg, cache = TM.prefill(tp, toks[:, :10], tcfg)
    for i in range(10, 30):
        lg, cache = TM.decode_step(tp, toks[:, i], cache, tcfg)
        _close(lg, full[:, i].detach().numpy(), 4e-3, f"pos {i}")


def decode_gap(tp, tcfg, toks, n_prompt, max_len):
    """Max |logits| gap of each decode step after a prefill of
    ``toks[:, :n_prompt]`` against a fresh prefill of the tokens so far."""
    _, cache = TM.prefill(tp, toks[:, :n_prompt], tcfg, max_len=max_len)
    gap = 0.0
    for i in range(n_prompt, toks.shape[1]):
        lg, cache = TM.decode_step(tp, toks[:, i], cache, tcfg)
        want, _ = TM.prefill(tp, toks[:, :i + 1], tcfg, max_len=max_len)
        gap = max(gap, float((lg - want).abs().max()))
    return gap


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_fp32_decode_gap_is_the_bf16_caches(jparams, monkeypatch,
                                            cache_dtype):
    """Port only, fp32: decode against a fresh prefill. The conv inputs the
    cache keeps in bf16 (as the reference's) are the decode's only bf16
    rounding: with them the gap is above 1e-4; with ``CACHE_DTYPE`` fp32
    only fp32 rounding is left, ≤ 1e-5."""
    _, tcfg = _cfgs()
    monkeypatch.setattr(TB, "CACHE_DTYPE", getattr(torch, cache_dtype))
    gap = decode_gap(_port(jparams, tcfg), tcfg,
                     torch.as_tensor(_tokens(1, 32, seed=5)), 24, 40)
    if cache_dtype == "bfloat16":
        assert gap > 1e-4
    else:
        assert gap <= 1e-5


def test_engine_greedy_tokens_and_cache_stats_match_reference(jparams):
    """Both engines, ragged prompts in left-padded buckets, fewer slots
    than requests: equal greedy tokens and prefill batches; the cache
    footprint by kind (``linear_state``, ``conv``) equal to the
    reference's, to the formulas, and constant in ``max_len``."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (3, 11, 16, 9, 2)]
    jeng = JServeEngine(jcfg, jparams, max_len=64, max_batch=2)
    teng = ServeEngine(tcfg, _port(jparams, tcfg), max_len=64, max_batch=2,
                       device="cpu")
    assert teng.bucket_lengths and jeng.bucket_lengths
    juids = [jeng.submit(p, 8) for p in prompts]
    tuids = [teng.submit(p, 8) for p in prompts]
    jres, tres = jeng.run(), teng.run()
    for ju, tu, p in zip(juids, tuids, prompts):
        np.testing.assert_array_equal(tres[tu], jres[ju],
                                      err_msg=f"prompt len {len(p)}")
    assert teng.stats()["prefill_batches"] == jeng.stats()["prefill_batches"]
    js, ts = jeng.cache_stats(), teng.cache_stats()
    # bytes by kind; the reference counts its arrays stacked over groups
    for kind in ("linear_state", "kv_ring", "conv", "other", "total"):
        assert ts[kind] == js[kind], kind
    mb = tcfg.mamba
    d_in, nh = mb.expand * tcfg.d_model, mb.expand * tcfg.d_model // \
        mb.headdim
    assert ts["linear_state"] == tcfg.n_layers * 2 * nh * (
        mb.d_state * mb.headdim + 1) * 4
    assert ts["conv"] == tcfg.n_layers * 2 * (mb.d_conv - 1) * (
        d_in + 2 * mb.ngroups * mb.d_state) * 2
    assert ts["kv_ring"] == ts["other"] == 0
    assert ts["conv_arrays"] == 3 * tcfg.n_layers
    longer = ServeEngine(tcfg, _port(jparams, tcfg), max_len=4096,
                         max_batch=2, device="cpu").cache_stats()
    assert longer == ts


def test_full_width_cache_bytes_equal_the_reference_init_cache():
    """Full mamba2 at 4 slots: ``linear_state`` 671,170,560 B and ``conv``
    8,257,536 B, the sizes of the reference's ``init_cache`` (its shapes,
    taken without allocating), at ``max_len`` 544 and 4096 alike."""
    jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
    for max_len in (544, 4096):
        shapes = jax.eval_shape(lambda: JM.init_cache(jcfg, 4, max_len))
        want = {"m": 0, "log_decay": 0, "conv": 0}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes["layers"])[0]:
            name = path[-1].key
            want["conv" if name.startswith("conv_") else name] += \
                int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        got = TM.init_cache(tcfg, 4, max_len, device="meta")
        by = {"m": 0, "log_decay": 0, "conv": 0}
        for path, t in leaves_with_paths(got["layers"]):
            name = path[-1]
            by["conv" if name.startswith("conv_") else name] += \
                t.numel() * t.element_size()
        assert by == want
        assert by["m"] + by["log_decay"] == 671_170_560
        assert by["conv"] == 8_257_536


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def test_train_step_matches_reference():
    """One step from the same state, 2 microbatches of packed rows,
    ``remat="full"`` on both sides: loss, grad norm, every param and both
    Adam moments; 1e-3."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_microbatches=2, remat="full", warmup_steps=0,
              total_steps=10, learning_rate=1e-3)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jstate = j_init_state(jax.random.PRNGKey(3), jcfg, jrun)
    tstate = state_from_params(_port(jstate["params"], tcfg, torch.float32))
    batch = JSyntheticLM(jcfg.vocab_size, 32, 4, seed=2,
                         mean_doc_len=8).microbatched(0, 2)
    assert batch["resets"][..., 1:].any()
    jnew, jm = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))(
        jstate, batch)
    tnew, tm = make_train_step(tcfg, trun)(tstate, batch)
    for key in ("loss", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=key)
    _close_trees(tnew["params"], jnew["params"], tcfg, GRAD_TOL, "param")
    _close_trees(tnew["opt"].m, jnew["opt"].m, tcfg, GRAD_TOL, "m")
    _close_trees(tnew["opt"].v, jnew["opt"].v, tcfg, GRAD_TOL, "v")


@pytest.mark.parametrize("lr", [3e-4, 1e-2])
def test_train_trajectory_matches_reference(lr):
    """Five train steps on the card's training schedule (2 microbatches,
    resets, warm-up 2, cosine over 5) follow the reference's: every
    step's loss and grad norm within 1e-3. At 3e-4, phase 7's rate; at
    1e-2, d_model · lr (0.64) near full width's at 3e-4 (0.77), the most
    one sign-like Adam step moves a projection's output."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_microbatches=2, remat="none", warmup_steps=2,
              total_steps=5, learning_rate=lr)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jstate = j_init_state(jax.random.PRNGKey(10), jcfg, jrun)
    tstate = state_from_params(_port(jstate["params"], tcfg, torch.float32))
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


def test_crash_resume_bitwise(tmp_path):
    """The reference's crash-resume case on mamba2 SMOKE: 8 steps straight
    against 4 + restart + 4, identical params (``gnorm`` nested) and
    moments."""
    cfg = get_smoke(ARCH)
    run = RunConfig(num_microbatches=1, total_steps=8, warmup_steps=2,
                    learning_rate=1e-3, remat="none")
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=1)

    def run_to(ckpt, steps):
        return train(cfg, run, data, device="cpu", ckpt_dir=str(ckpt),
                     ckpt_every=4, log_every=10 ** 9,
                     log_fn=lambda *_: None, max_steps=steps)

    full, _ = run_to(tmp_path / "a", 8)
    run_to(tmp_path / "b", 4)                         # "crash"
    resumed, hist = run_to(tmp_path / "b", 8)
    assert hist[0]["step"] == 4, "must resume from the checkpoint"
    assert resumed["step"] == full["step"] == 8
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 8
    pairs = zip(leaves_with_paths({"p": full["params"], "o": full["opt"]}),
                leaves_with_paths({"p": resumed["params"],
                                   "o": resumed["opt"]}))
    paths = []
    for (path, a), (_, b) in pairs:
        paths.append(path)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        else:
            assert a == b, path
    assert ("p", "layers", "1", "mixer", "gnorm", "scale") in paths


def test_cli_smoke_runs_mamba2_on_the_cpu():
    """``--arch mamba2-2.7b --smoke --device cpu`` through both CLIs: the
    server answers every request, the trainer's loss falls."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "1"}
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "5", "--max-batch",
         "2", "--prompt-len", "24", "--new-tokens", "6"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr[-3000:]
    assert "5 requests" in serve.stdout and "conv=" in serve.stdout
    tr = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "20", "--seq", "64",
         "--batch", "4", "--lr", "1e-3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert tr.returncode == 0, tr.stderr[-3000:]
    assert "over 20 steps (improved)" in tr.stdout, tr.stdout
