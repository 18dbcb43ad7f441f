"""Port vs reference: the cross family on the CPU at SMOKE size.

``llama-3.2-vision-90b`` (four self-attention layers and one cross layer
over image embeddings) and ``whisper-base`` (a bidirectional encoder over
audio frames, decoder cross layers over its output), native and under
the Linear-X recipe. The reference's params, carried across with
``params_from_jax``, and the same numpy inputs go through ``repro`` (XLA
on the CPU) and ``repro_torch`` (the plain versions of the kernels).

Every cross layer starts with ``gate`` = 0, so it outputs tanh(0)·y = 0
and no parity check would see it; every test here sets the gates to 0.5
in the reference's tree before carrying it across, and one test shows
that the memory then moves the logits (and with a gate of 0 does not).
Tolerances: logits fp32 3e-4, bf16 4e-2 (``tests/test_kernels.py:14``);
caches as ``test_torch_zoo.py``; losses, gradients, params and moments
1e-3 (its ``GRAD_TOL``); decode against the full forward 3e-2, as
``tests/test_models.py`` holds the reference.
"""

import dataclasses
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_IDS
from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.core import lasp2h as jlasp2h
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import train as j_train_cli
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sharding.rules import local_plan
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.core import lasp2h as tlasp2h
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import TrainingGroups
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import (ShardedStep, make_train_step,
                                    state_from_params)
from test_torch_mamba2 import _close_cache, _close_logits
from test_torch_train import _close_trees

VISION, WHISPER = "llama-3.2-vision-90b", "whisper-base"
ARCHS = (VISION, WHISPER)
# (arch, linearize): native, and the Linear-X recipe each runs on the card
VARIANTS = ((VISION, None), (WHISPER, None), (VISION, 4), (WHISPER, 0))
TOL = {"float32": 3e-4, "bfloat16": 4e-2}
GRAD_TOL = 1e-3
GATE = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE shapes: one intra-op thread is fastest while the suite's
    parallel workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def cfgs(arch, dtype="float32", linearize=None):
    """The reference's and the port's SMOKE of ``arch`` in ``dtype``, under
    ``linearize`` when given."""
    j, t = j_get_smoke(arch), get_smoke(arch)
    if linearize is not None:
        j, t = j.linearize(linearize), t.linearize(linearize)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def with_gates(jparams, cfg, gate):
    """The reference's params (numpy) with every cross layer's gate set to
    ``gate``."""
    out = jax.tree.map(np.asarray, jparams)
    for p, spec in enumerate(cfg.pattern):
        if spec.mixer == "cross":
            g = out["groups"][p]["mixer"]["gate"]
            out["groups"][p]["mixer"]["gate"] = np.full_like(g, gate)
    return out


@functools.lru_cache(maxsize=None)
def jparams(arch, linearize=None, gate=GATE):
    jcfg, _ = cfgs(arch, linearize=linearize)
    return jax.tree.map(jnp.asarray, with_gates(
        JM.init_params(jax.random.PRNGKey(0), jcfg), jcfg, gate))


def port(jp, tcfg, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=dtype)


def tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(
        np.int32)


def memories(cfg, b, seed=0, lead=()):
    """The model's memory inputs, N(0, 0.1²) as ``tests/test_models.py``
    draws them: ``{"enc_frames": (*lead, b, n_frames, d)}`` for an
    encoder, ``{"img_emb": (*lead, b, n_img, d)}`` for image tokens."""
    rng = np.random.default_rng(seed)
    draw = lambda n: (rng.standard_normal((*lead, b, n, cfg.d_model))
                      * 0.1).astype(np.float32)
    kw = {}
    if cfg.encoder is not None:
        kw["enc_frames"] = draw(cfg.encoder.n_frames)
    if cfg.n_image_tokens:
        kw["img_emb"] = draw(cfg.n_image_tokens)
    return kw


def as_jax(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def as_torch(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


# ---------------------------------------------------------------------------
# Pieces: the sinusoid, the decode attention, one cross layer, the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(16, 64), (1500, 512)])
def test_sinusoidal_positions_match_reference(n, d):
    got = TL.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        JL.sinusoidal_positions(n, d)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hq,hkv,cache_len,window", [
    (4, 2, 24, None), (4, 4, 17, None), (8, 2, 20, 6)])
def test_sharded_decode_attention_matches_reference(hq, hkv, cache_len,
                                                    window):
    """The one-device branch (``sp=None``): a query against the first
    ``cache_len`` slots of a 24-slot cache, optionally windowed; fp32
    3e-4; an ``sp`` of degree 1 is that branch too. The sharded merge
    (degree > 1) is held to the reference's on gloo ranks in
    ``test_torch_serve_sp.py``."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, hq, 1, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, 24, 16)).astype(np.float32)
            for _ in range(2))
    want = jlasp2h.sharded_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cache_len,
        sliding_window=window)
    got = tlasp2h.sharded_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        cache_len, sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    one = tlasp2h.sharded_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        cache_len, sliding_window=window,
        sp=types.SimpleNamespace(degree=1))
    assert torch.equal(one, got)


@pytest.mark.parametrize("memory", ["img_emb", "enc_out"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_layer_matches_reference(memory, dtype):
    """One cross mixer over 10 text tokens and a 7-token memory, through
    either memory field of ``Ctx``; gate 0.5."""
    jcfg, tcfg = cfgs(VISION, dtype)
    spec = jcfg.pattern[-1]
    jp = JB.cross_init(jax.random.PRNGKey(3), jcfg, spec)
    jp["gate"] = jnp.asarray(GATE, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if v.ndim == 0 else getattr(torch, dtype))
        for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    mem = (rng.standard_normal((2, 7, 64)) * 0.1).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jctx = JB.Ctx(cfg=jcfg, plan=local_plan(), **{memory: jnp.asarray(mem)})
    want = JB.cross_apply(jp, jnp.asarray(x).astype(jdt), jctx)
    tctx = TB.Ctx(cfg=tcfg, **{memory: torch.from_numpy(mem)})
    got = TB.cross_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                         tctx)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    jcfg, tcfg = cfgs(WHISPER, dtype)
    jp = jparams(WHISPER)
    frames = memories(jcfg, 2, seed=5)["enc_frames"]
    want = JM.encode(jp, jnp.asarray(frames), jcfg, local_plan())
    got = TM.encode(port(jp, tcfg), torch.from_numpy(frames), tcfg)
    assert got.shape == (2, 16, 64) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def test_params_from_jax_keeps_0d_and_1d_leaves_fp32():
    """bf16 serving params: the cross gates (0-d) and norm scales (1-D)
    arrive in fp32, bitwise the reference's; matrices in bf16; the
    encoder's layers and final norm are mapped."""
    jcfg, tcfg = cfgs(WHISPER, "bfloat16")
    jp = jax.tree.map(np.asarray, jparams(WHISPER))
    jp["groups"][1]["mixer"]["gate"] = np.asarray([0.3, 0.7], np.float32)
    tp = port(jp, tcfg)
    gates = [layer["mixer"]["gate"] for layer in tp["layers"][1::2]]
    assert all(g.dtype == torch.float32 and g.ndim == 0 for g in gates)
    assert [float(g) for g in gates] == [np.float32(0.3), np.float32(0.7)]
    enc = tp["encoder"]
    assert len(enc["layers"]) == 2
    assert enc["final_norm"]["scale"].dtype == torch.float32
    assert enc["layers"][1]["mixer"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        enc["layers"][1]["mlp"]["w2"].float().numpy(),
        torch.from_numpy(np.array(jp["encoder"]["groups"][0]["mlp"]["w2"][1])).to(
            torch.bfloat16).float().numpy())


def test_init_params_shapes_match_reference():
    """The port's own init draws the reference's tree: every leaf's shape,
    the encoder's included, and the gates zero in fp32."""
    jcfg, tcfg = cfgs(WHISPER)
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu",
                        param_dtype="float32")
    jp = jparams(WHISPER, gate=0.0)
    want = jax.tree.map(np.asarray, jp)
    got = port(jp, tcfg)
    assert [(p, t.shape) for p, t in leaves_with_paths(tp)] == \
        [(p, t.shape) for p, t in leaves_with_paths(got)]
    assert all(float(layer["mixer"]["gate"]) == 0.0
               for layer in tp["layers"][1::2])
    assert sum(t.numel() for _, t in leaves_with_paths(tp)) == sum(
        x.size for x in jax.tree.leaves(want))


# ---------------------------------------------------------------------------
# Forward, gradients, the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,linearize", VARIANTS)
def test_forward_with_aux_matches_reference(arch, linearize, dtype):
    jcfg, tcfg = cfgs(arch, dtype, linearize)
    jp = jparams(arch, linearize)
    toks = tokens(2, 24)
    kw = memories(jcfg, 2)
    jl, jaux = jax.jit(lambda p, t, m: JM.forward(p, t, jcfg, remat="none",
                                                  **m))(
        jp, jnp.asarray(toks), as_jax(kw))
    tl, taux = TM.forward_with_aux(port(jp, tcfg), torch.as_tensor(toks),
                                   tcfg, **as_torch(kw))
    _close_logits(tl, jl, tcfg, TOL[dtype], "forward logits")
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_moves_the_logits_only_through_the_gate(arch):
    """With gates at 0.5 a different memory moves the logits (by ten times
    the fp32 tolerance); with gates at 0 it does not move them at all."""
    _, tcfg = cfgs(arch)
    toks = torch.as_tensor(tokens(2, 12))
    a, b = (as_torch(memories(tcfg, 2, seed=s)) for s in (0, 1))
    for gate, moves in ((GATE, True), (0.0, False)):
        tp = port(jparams(arch, gate=gate), tcfg)
        la, lb = (TM.forward(tp, toks, tcfg, **m) for m in (a, b))
        gap = float((la - lb)[..., :tcfg.vocab_size].abs().max())
        assert (gap > 10 * TOL["float32"]) if moves else gap == 0.0, gap


def test_missing_memory_raises_as_the_reference():
    for arch, key in ((WHISPER, "enc_frames"), (VISION, "img_emb")):
        _, tcfg = cfgs(arch)
        with pytest.raises(ValueError, match=key.split("_")[0]):
            TM.forward(port(jparams(arch), tcfg),
                       torch.as_tensor(tokens(1, 8)), tcfg)
    jcfg, _ = cfgs(WHISPER)
    with pytest.raises(ValueError, match="needs enc_frames"):
        JM.forward(jparams(WHISPER), jnp.asarray(tokens(1, 8)), jcfg)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_reference(arch, remat):
    """lm_loss and the gradient of every leaf, the gates' and the
    encoder's among them, against jax.value_and_grad; 1e-3."""
    jcfg, tcfg = cfgs(arch)
    jp = jparams(arch)
    toks = tokens(2, 24, seed=6)
    labels = np.roll(toks, -1, axis=1)
    kw = memories(jcfg, 2, seed=6)

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(toks), jcfg, remat=remat,
                               **as_jax(kw))
        return JM.lm_loss(logits, jnp.asarray(labels))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = state_from_params(port(jp, tcfg, torch.float32))["params"]
    leaves = [p for _, p in leaves_with_paths(tp)]
    tl = TM.lm_loss(TM.forward(tp, torch.as_tensor(toks), tcfg, remat=remat,
                               **as_torch(kw)), torch.as_tensor(labels))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    grads = torch.autograd.grad(tl, leaves)
    gate_grads = [float(g) for (path, _), g in
                  zip(leaves_with_paths(tp), grads) if path[-1] == "gate"]
    assert gate_grads and all(g != 0.0 for g in gate_grads)
    it = iter(grads)
    _close_trees(tree_map(lambda _: next(it), tp), jg, tcfg, GRAD_TOL,
                 "grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of both packages from the same fp32 masters, 2
    microbatches of packed rows with their ``frames`` / ``img``, remat
    full: loss, grad norm, every param and both Adam moments; 1e-3."""
    jcfg, tcfg = cfgs(arch)
    jp = jparams(arch)
    kw = dict(num_microbatches=2, remat="full", warmup_steps=0,
              total_steps=10, learning_rate=1e-3)
    jrun, trun = JRunConfig(**kw), RunConfig(**kw)
    jstate = {"params": jp, "opt": jadamw.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = state_from_params(port(jp, tcfg, torch.float32))
    batch = JSyntheticLM(jcfg.vocab_size, 32, 4, seed=2,
                         mean_doc_len=8).microbatched(0, 2)
    mem = memories(jcfg, 2, seed=7, lead=(2,))
    batch["frames" if jcfg.encoder else "img"] = next(iter(mem.values()))
    jnew, jm = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))(
        jstate, batch)
    tnew, tm = make_train_step(tcfg, trun)(tstate, batch)
    for key in ("loss", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=key)
    _close_trees(tnew["params"], jnew["params"], tcfg, GRAD_TOL, "param")
    _close_trees(tnew["opt"].m, jnew["opt"].m, tcfg, GRAD_TOL, "m")
    _close_trees(tnew["opt"].v, jnew["opt"].v, tcfg, GRAD_TOL, "v")


def test_sharded_step_refuses_the_cross_family():
    """The DP×SP step refuses an encoder or image config, and frames or
    images in a batch, as the reference's manual step does."""
    run = RunConfig()
    layout = TrainingGroups(dp=1, sp=1, data_index=0, chunk_index=0,
                            sp_group=None, dp_group=None, world_group=None)
    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="encoder/VLM"):
            ShardedStep(get_smoke(arch), run, layout)
    step = ShardedStep(get_smoke("linear-llama3-1b"), run, layout)
    for key in ("frames", "img"):
        with pytest.raises(NotImplementedError, match="encoder/VLM"):
            step.grads({}, {"tokens": np.zeros((1, 1, 8)), key: 0})


# ---------------------------------------------------------------------------
# Prefill, decode, the static-batch engine, the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,linearize", VARIANTS)
def test_prefill_and_decode_match_reference_and_forward(arch, linearize):
    """Prefill of 16 tokens with the memory: last logits and every cache
    leaf (the cross layers' memory K/V among them) against the
    reference's; then 8 decode steps, logits against the reference's
    (3e-4) and against the full forward over the 24 tokens (3e-2, the
    twin of ``tests/test_models.py:72-101``)."""
    jcfg, tcfg = cfgs(arch, linearize=linearize)
    jp = jparams(arch, linearize)
    tp = port(jp, tcfg)
    toks = tokens(2, 24, seed=8)
    kw = memories(jcfg, 2, seed=8)
    full = TM.forward(tp, torch.as_tensor(toks), tcfg, **as_torch(kw))
    jl, jc = JM.prefill(jp, jnp.asarray(toks[:, :16]), jcfg, max_len=24,
                        **as_jax(kw))
    tl, tc = TM.prefill(tp, torch.as_tensor(toks[:, :16]), tcfg, max_len=24,
                        **as_torch(kw))
    _close_logits(tl, jl, tcfg, TOL["float32"], "prefill logits")
    _close_logits(tl, full[:, 15], tcfg, 3e-2, "prefill vs forward")
    _close_cache(tc, jc, tcfg, TOL["float32"])
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
    for i in range(16, 24):
        jl, jc = jdecode(jp, jnp.asarray(toks[:, i]), jc)
        tl, tc = TM.decode_step(tp, torch.as_tensor(toks[:, i]), tc, tcfg)
        _close_logits(tl, jl, tcfg, TOL["float32"], f"decode pos {i}")
        _close_logits(tl, full[:, i], tcfg, 3e-2, f"decode vs forward {i}")
    _close_cache(tc, jc, tcfg, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_static_path_matches_reference(arch):
    """``generate`` with the memory through both engines (the static-batch
    path), fp32: equal greedy tokens and equal cache bytes by kind (the
    cross layers' memory K/V under ``kv_ring``); ``submit`` refuses the
    config, which needs a memory per request."""
    jcfg, tcfg = cfgs(arch)
    jp = jparams(arch)
    prompts = tokens(2, 10, seed=9)
    kw = memories(jcfg, 2, seed=9)
    jeng = JServeEngine(jcfg, jp, max_len=32, max_batch=2)
    teng = ServeEngine(tcfg, port(jp, tcfg), max_len=32, max_batch=2,
                       device="cpu")
    want = jeng.generate(jnp.asarray(prompts), 6, **as_jax(kw))
    got = teng.generate(prompts, 6, **kw)
    assert got.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    js, ts = jeng.cache_stats(), teng.cache_stats()
    for kind in ("linear_state", "kv_ring", "total"):
        assert ts[kind] == js[kind], kind
    with pytest.raises(ValueError, match="generate"):
        teng.submit(prompts[0], 4)


def test_engine_static_path_samples_each_row_from_its_own_stream():
    """With a temperature the static path draws row ``i``'s step ``t``
    from the ``(seed, i, t)`` generator, as the continuous path does: the
    same call repeats its tokens, and appending a row leaves the earlier
    rows' tokens as they were (one generator shared by the batch would
    shift their later draws)."""
    jcfg, tcfg = cfgs("whisper-base")
    teng = ServeEngine(tcfg, port(jparams("whisper-base"), tcfg),
                       max_len=32, max_batch=3, device="cpu")
    prompts = tokens(3, 10, seed=4)
    kw = memories(jcfg, 3, seed=4)
    two = {k: v[:2] for k, v in kw.items()}
    a = teng.generate(prompts[:2], 6, temperature=1.0, seed=3, **two)
    np.testing.assert_array_equal(
        a, teng.generate(prompts[:2], 6, temperature=1.0, seed=3, **two))
    b = teng.generate(prompts, 6, temperature=1.0, seed=3, **kw)
    np.testing.assert_array_equal(b[:2], a)
    greedy = teng.generate(prompts[:2], 6, **two)
    assert not np.array_equal(a, greedy)


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_serve_static_and_train_refuses_in_both_packages(
        arch, capsys, monkeypatch):
    """Serving takes the static path; training raises in both packages:
    their loops feed batches without frames or images (the reference
    fails in its model, the port refuses up front)."""
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--max-batch", "2", "--prompt-len", "16",
                          "--new-tokens", "4"])
    assert out.shape == (2, 4)
    assert "static batch (2, 4)" in capsys.readouterr().out
    args = ["--arch", arch, "--smoke", "--steps", "1", "--seq", "32",
            "--batch", "2"]
    with pytest.raises(ValueError, match="frames or image"):
        train_cli.main(args + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    with pytest.raises((ValueError, AttributeError)):
        j_train_cli.main()


# ---------------------------------------------------------------------------
# Every architecture of the reference's registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_IDS)
def test_every_registered_smoke_matches_reference(arch):
    """The port's ``get_smoke(arch)`` for each of the reference's
    ``ALL_IDS``: the forward's logits (fp32 3e-4) and loss (1e-3), with
    the memories ``tests/test_models.py`` gives the cross family and its
    gates at 0.5."""
    jcfg, tcfg = cfgs(arch)
    jp = with_gates(JM.init_params(jax.random.PRNGKey(1), jcfg), jcfg, GATE)
    toks = tokens(2, 16, seed=10, vocab=jcfg.vocab_size)
    labels = np.roll(toks, -1, axis=1)
    kw = memories(jcfg, 2, seed=10)
    jl, _ = jax.jit(lambda p, t, m: JM.forward(p, t, jcfg, remat="none",
                                               **m))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(toks), as_jax(kw))
    tl = TM.forward(port(jp, tcfg), torch.as_tensor(toks), tcfg,
                    **as_torch(kw))
    _close_logits(tl, jl, tcfg, TOL["float32"], "logits")
    np.testing.assert_allclose(
        float(TM.lm_loss(tl, torch.as_tensor(labels))),
        float(JM.lm_loss(jl, jnp.asarray(labels))), rtol=GRAD_TOL,
        atol=GRAD_TOL)
