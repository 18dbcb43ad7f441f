"""Port vs reference: hymba (parallel attention and SSD heads) on the CPU
at SMOKE size.

SMOKE is a single-position pattern (window 16): its global layers are
the first, middle and last (the reference's traced flags); a two-position
pattern at SMOKE's widths (a global layer, then a windowed one) takes the
static flags of ``CONFIG``. The reference's params, carried across with
``params_from_jax``, and the same numpy tokens go through ``repro`` (XLA
path on the CPU) and ``repro_torch`` (the plain versions of the
kernels). Tolerances: fp32 3e-4 on logits and caches, bf16 4e-2 on
logits (the reference's kernel tolerances, ``tests/test_kernels.py:14``);
bf16 cache leaves one bf16 step (2^-7 relative); positions exact;
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
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import local_plan
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import LayerSpec, RunConfig
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import make_train_step, state_from_params
from test_torch_mamba2 import _close_cache, _close_logits, decode_gap
from test_torch_train import _close_trees

ARCH = "hymba-1.5b"
ROOT = Path(__file__).resolve().parent.parent
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


def _static(base, layer_spec):
    """SMOKE's widths in ``CONFIG``'s form: a static global layer, then a
    windowed one (window 16), 4 layers."""
    return dataclasses.replace(
        base, name=base.name + "-static", pattern=(
            layer_spec(mixer="hymba", mlp="dense", is_global=True),
            layer_spec(mixer="hymba", mlp="dense", sliding_window=16,
                       is_global=False)))


def _cfgs(kind="dynamic", dtype="float32"):
    j, t = j_get_smoke(ARCH), get_smoke(ARCH)
    if kind == "static":
        j, t = _static(j, JLayerSpec), _static(t, LayerSpec)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


@pytest.fixture(scope="module")
def jparams():
    return {kind: JM.init_params(jax.random.PRNGKey(0), _cfgs(kind)[0])
            for kind in ("dynamic", "static")}


def _port(jp, tcfg, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                           device="cpu", dtype=dtype)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(b, s)).astype(
        np.int32)


def test_global_flags_match_the_reference():
    """SMOKE (one position, 4 layers): layers 0, 2 and 3 global, as the
    reference's traced flags; ``CONFIG``: layers 0, 8, 16 and 24, its
    static ``is_global``; no hymba layer, no flags."""
    smoke = get_smoke(ARCH)
    want = np.asarray(JM.hymba_global_flags(j_get_smoke(ARCH)))
    assert TM.hymba_global_flags(smoke) == list(want.reshape(-1)) == \
        [True, False, True, True]
    full = TM.hymba_global_flags(get_config(ARCH))
    assert [i for i, f in enumerate(full) if f] == [0, 8, 16, 24]
    assert JM.hymba_global_flags(j_get_config(ARCH)) is None   # static
    assert [s.is_global for s in j_get_config(ARCH).pattern] * 4 == full
    assert TM.hymba_global_flags(get_smoke("mamba2-2.7b")) is None


@pytest.mark.parametrize("kind", ["dynamic", "static"])
@pytest.mark.parametrize("s", [32, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(jparams, kind, s, dtype):
    """Window 16 over S 32 (a multiple of the window: the reference's
    static layers take its banded form) and 40; the window matters: the
    same params with every layer global give other logits."""
    jcfg, tcfg = _cfgs(kind, dtype)
    toks = _tokens(2, s)
    jl, _ = JM.forward(jparams[kind], jnp.asarray(toks), jcfg, remat="none")
    tp = _port(jparams[kind], tcfg)
    tl = TM.forward(tp, torch.as_tensor(toks), tcfg)
    _close_logits(tl, jl, tcfg, TOL[dtype], "forward logits")
    if dtype == "float32" and kind == "dynamic":
        every = dataclasses.replace(tcfg, pattern=(dataclasses.replace(
            tcfg.pattern[0], sliding_window=10 ** 6),))
        other = TM.forward(tp, torch.as_tensor(toks), every)
        assert float((other - tl).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_loss_and_grads_match_reference(jparams, kind):
    """lm_loss and every parameter gradient (``attn`` and ``ssm`` leaves,
    ``a_log``, ``dt_bias`` and the conv kernels among them) against
    jax.value_and_grad on packed rows, window 16 over S 48; 1e-3."""
    jcfg, tcfg = _cfgs(kind)
    batch = JSyntheticLM(jcfg.vocab_size, 48, 2, seed=5,
                         mean_doc_len=16).batch(0)
    assert batch["resets"][:, 1:].any()

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(batch["tokens"]), jcfg,
                               remat="none",
                               resets=jnp.asarray(batch["resets"]))
        return JM.lm_loss(logits, jnp.asarray(batch["labels"]))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams[kind])
    tp = state_from_params(_port(jparams[kind], tcfg,
                                 torch.float32))["params"]
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
    window 16 over 32 tokens, ``remat="full"``): loss, grad norm, every
    param and both Adam moments; 1e-3."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_microbatches=2, remat="full", warmup_steps=0,
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


@pytest.mark.parametrize("lr", [3e-4, 1e-2])
def test_train_trajectory_matches_reference(lr):
    """Five train steps on the card's training schedule (2 microbatches,
    resets, warm-up 2, cosine over 5) follow the reference's: every
    step's loss and grad norm within 1e-3. At 3e-4, phase 7's rate; at
    1e-2, d_model · lr (0.64) near full width's at 3e-4 (0.48)."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_microbatches=2, remat="none", warmup_steps=2,
              total_steps=5, learning_rate=lr)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jstate = j_init_state(jax.random.PRNGKey(10), jcfg, jrun)
    tstate = state_from_params(_port(jstate["params"], tcfg, torch.float32))
    data = JSyntheticLM(tcfg.vocab_size, 64, 4, seed=11, mean_doc_len=16)
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


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_prefill_caches_and_decode_match_reference(jparams, kind):
    """Exact-length prefill of 20 tokens: logits and every cache leaf (the
    ``attn`` ring, ``max_len`` 48 long on every layer, windowed ones
    included; the ``ssm`` state, log decay and conv inputs); then 8 decode
    steps past the window, logits and caches; fp32."""
    jcfg, tcfg = _cfgs(kind)
    tp = _port(jparams[kind], tcfg)
    toks = _tokens(3, 20, seed=1)
    jl, jc = JM.prefill(jparams[kind], jnp.asarray(toks), jcfg, max_len=48)
    tl, tc = TM.prefill(tp, torch.as_tensor(toks), tcfg, max_len=48)
    _close_logits(tl, jl, tcfg, TOL["float32"], "prefill logits")
    _close_cache(tc, jc, tcfg, TOL["float32"])
    assert {c["mixer"]["attn"]["k"].shape[2] for c in tc["layers"]} == {48}
    rng = np.random.default_rng(2)
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for step in range(8):
        tok = rng.integers(0, 512, size=3).astype(np.int32)
        jl, jc = jdecode(jparams[kind], jnp.asarray(tok), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(tok), tc, tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], f"decode step {step}")
    _close_cache(tc, jc, tcfg, TOL["float32"])


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_fp32_decode_gap_is_the_bf16_caches(jparams, monkeypatch,
                                            cache_dtype):
    """Port only, fp32, 8 decode steps past the window: the K/V rings and
    conv inputs the cache keeps in bf16 (as the reference's) are the
    decode's only bf16 rounding: with them the gap to a fresh prefill is
    above 1e-4; with ``CACHE_DTYPE`` fp32 it is ≤ 1e-5."""
    _, tcfg = _cfgs()
    monkeypatch.setattr(TB, "CACHE_DTYPE", getattr(torch, cache_dtype))
    gap = decode_gap(_port(jparams["dynamic"], tcfg), tcfg,
                     torch.as_tensor(_tokens(1, 32, seed=5)), 24, 40)
    if cache_dtype == "bfloat16":
        assert gap > 1e-4
    else:
        assert gap <= 1e-5


def test_engine_greedy_tokens_and_cache_stats_match_reference(jparams):
    """Both engines, ragged prompts longer than the window, fewer slots
    than requests: prefill by exact length (no left-padding), equal greedy
    tokens; the cache bytes by kind equal the reference's and the
    formulas (every ring ``max_len`` long)."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (6, 20, 20, 13)]
    jeng = JServeEngine(jcfg, jparams["dynamic"], max_len=40, max_batch=2)
    teng = ServeEngine(tcfg, _port(jparams["dynamic"], tcfg), max_len=40,
                       max_batch=2, device="cpu")
    assert not teng.bucket_lengths and not jeng.bucket_lengths
    juids = [jeng.submit(p, 8) for p in prompts]
    tuids = [teng.submit(p, 8) for p in prompts]
    jres, tres = jeng.run(), teng.run()
    for ju, tu, p in zip(juids, tuids, prompts):
        np.testing.assert_array_equal(tres[tu], jres[ju],
                                      err_msg=f"prompt len {len(p)}")
    assert teng.stats()["prefill_batches"] == jeng.stats()["prefill_batches"]
    js, ts = jeng.cache_stats(), teng.cache_stats()
    for kind in ("linear_state", "kv_ring", "conv", "other", "total"):
        assert ts[kind] == js[kind], kind
    mb, n = tcfg.mamba, tcfg.n_layers
    nh = tcfg.d_model // mb.headdim
    assert ts["kv_ring"] == n * (2 * 2 * tcfg.n_kv_heads * 40
                                 * tcfg.head_dim * 2 + 2 * 40 * 4)
    assert ts["linear_state"] == n * 2 * nh * (mb.d_state * mb.headdim
                                               + 1) * 4
    assert ts["conv"] == n * 2 * (mb.d_conv - 1) * (
        tcfg.d_model + 2 * mb.ngroups * mb.d_state) * 2


def test_full_width_cache_bytes_equal_the_reference_init_cache():
    """Full hymba at 4 slots and ``max_len`` 544: ``kv_ring`` 89,407,488 B,
    ``linear_state`` 13,120,000 B, ``conv`` 1,253,376 B, the sizes of the
    reference's ``init_cache`` (its shapes, taken without allocating)."""
    shapes = jax.eval_shape(lambda: JM.init_cache(j_get_config(ARCH), 4,
                                                  544))
    kind = lambda name: ("linear_state" if name in ("m", "log_decay") else
                         "kv_ring" if name in ("k", "v", "kpos") else "conv")
    want = dict.fromkeys(("linear_state", "kv_ring", "conv"), 0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["layers"])[0]:
        want[kind(path[-1].key)] += int(np.prod(leaf.shape)) \
            * leaf.dtype.itemsize
    got = dict.fromkeys(want, 0)
    cache = TM.init_cache(get_config(ARCH), 4, 544, device="meta")
    for path, t in leaves_with_paths(cache["layers"]):
        got[kind(path[-1])] += t.numel() * t.element_size()
    assert got == want == {"linear_state": 13_120_000,
                           "kv_ring": 89_407_488, "conv": 1_253_376}


def test_cli_smoke_runs_hymba_on_the_cpu():
    """``--arch hymba-1.5b --smoke --device cpu`` through both CLIs: the
    server answers every request, the trainer's loss falls."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "1"}
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "4", "--max-batch",
         "2", "--prompt-len", "24", "--new-tokens", "6"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr[-3000:]
    assert "4 requests" in serve.stdout and "kv_ring=" in serve.stdout
    tr = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "20", "--seq", "64",
         "--batch", "4", "--lr", "1e-3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert tr.returncode == 0, tr.stderr[-3000:]
    assert "over 20 steps (improved)" in tr.stdout, tr.stdout
