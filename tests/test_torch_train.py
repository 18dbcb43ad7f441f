"""Port vs reference: one-device training of linear-llama3 SMOKE.

The reference's params, carried across with ``params_from_jax(...,
dtype=torch.float32)`` as fp32 masters, and the same numpy batches go
through ``repro`` (XLA path on the CPU) and ``repro_torch`` (plain PyTorch
path on the CPU). Tolerances are stated per test: losses, gradients and
params 1e-3 (the reference's ``GRAD_TOL``); optimizer math 1e-6, where
both sides do the same fp32 elementwise operations.
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

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import doc_segments as j_doc_segments
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.sharding.rules import local_plan
from repro.train.loop import train as j_train
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.data.pipeline import SyntheticLM, doc_segments
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.train.loop import StepWatchdog, train
from repro_torch.train.step import (init_state, make_train_step,
                                    state_from_params)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-3
ARCH = "linear-llama3-1b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The SMOKE shapes are tiny: one intra-op thread is fastest, and the
    suite's parallel workers share the cores (with a thread per core in
    every worker, each small op's thread barrier thrashes)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_get_smoke(ARCH), dtype=dtype),
            dataclasses.replace(get_smoke(ARCH), dtype=dtype))


def _runs(**kw):
    return JRunConfig(**kw), RunConfig(**kw)


def _masters(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu", dtype=torch.float32)


def _jax_layout(tree, cfg):
    """A port tree (one dict per layer) in the reference's layout (layer
    params stacked over groups per pattern position; an encoder's layers
    stacked likewise), as numpy."""
    n = len(cfg.pattern)
    num = lambda t: t.detach().float().numpy()

    def stacked(layers):
        """One pattern position's layers, leaf by leaf (nested dicts such
        as hymba's ``attn``/``ssm`` included), stacked over groups."""
        if isinstance(layers[0], dict):
            return {k: stacked([l[k] for l in layers]) for k in layers[0]}
        return np.stack([num(l) for l in layers])

    groups = [stacked(tree["layers"][p::n]) for p in range(n)]
    out = {"embed": {k: num(v) for k, v in tree["embed"].items()},
           "groups": groups,
           "final_norm": {"scale": num(tree["final_norm"]["scale"])}}
    if "encoder" in tree:        # one pattern position, a group a layer
        enc = tree["encoder"]
        out["encoder"] = {
            "groups": [stacked(enc["layers"])],
            "final_norm": {"scale": num(enc["final_norm"]["scale"])}}
    return out


def _close_trees(port_tree, jax_tree, cfg, tol, what):
    got = jax.tree_util.tree_flatten_with_path(_jax_layout(port_tree, cfg))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jax_tree)[0])
    assert len(got) == len(want)
    for path, g in got:
        np.testing.assert_allclose(
            g, np.asarray(want[path], np.float32), rtol=tol, atol=tol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# Data and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 42)])
def test_synthetic_lm_batches_equal_reference_bitwise(seed, step):
    for kw in ({}, {"mean_doc_len": 64}, {"pack_documents": False}):
        want = JSyntheticLM(1000, 256, 4, seed=seed, **kw).batch(step)
        got = SyntheticLM(1000, 256, 4, seed=seed, **kw).batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(doc_segments(got["resets"]),
                                      j_doc_segments(want["resets"]))
    got = SyntheticLM(1000, 64, 8, seed=seed).microbatched(step, 4)
    want = JSyntheticLM(1000, 64, 8, seed=seed).microbatched(step, 4)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        SyntheticLM(1000, 64, 8).microbatched(0, 3)


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    p = {"w1": rng.standard_normal((8, 6)).astype(np.float32),
         "norm": {"scale": np.ones((5,), np.float32)}}
    g = [{"w1": rng.standard_normal((8, 6)).astype(np.float32) * 0.5,
          "norm": {"scale": rng.standard_normal((5,)).astype(np.float32)}}
         for _ in range(5)]
    return p, g


def test_adamw_update_matches_reference_over_steps():
    """Five AdamW steps (weight decay on the matrix, none on the norm
    scale); same fp32 elementwise math on both sides: 1e-6."""
    p_np, gs = _opt_trees(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = jadamw.init(jp)
    tp = {"w1": torch.from_numpy(p_np["w1"].copy()),
          "norm": {"scale": torch.from_numpy(p_np["norm"]["scale"].copy())}}
    tst = tadamw.init(tp)
    for i, g in enumerate(gs):
        lr = 1e-2 * (i + 1)
        jp, jst = jadamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                lr=lr, b1=0.9, b2=0.95, weight_decay=0.1)
        tg = {"w1": torch.from_numpy(g["w1"]),
              "norm": {"scale": torch.from_numpy(g["norm"]["scale"])}}
        tst = tadamw.update(tg, tst, tp, lr=lr, b1=0.9, b2=0.95,
                            weight_decay=0.1)
        for name, tree, jtree in (("p", tp, jp), ("m", tst.m, jst.m),
                                  ("v", tst.v, jst.v)):
            for t, j in ((tree["w1"], jtree["w1"]),
                         (tree["norm"]["scale"], jtree["norm"]["scale"])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} step {i}")
        assert tst.count == int(jst.count) == i + 1


def test_cosine_schedule_and_clip_match_reference():
    kw = dict(base_lr=1e-3, warmup_steps=10, total_steps=100, min_lr=1e-6)
    for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        want = float(jadamw.cosine_schedule(jnp.int32(step), **kw))
        np.testing.assert_allclose(tadamw.cosine_schedule(step, **kw), want,
                                   rtol=1e-6, atol=1e-12, err_msg=str(step))
    for max_norm in (0.5, 100.0):         # clipping, and none
        _, gs = _opt_trees(1)
        jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, gs[0]),
                                            max_norm)
        tg = {"w1": torch.from_numpy(gs[0]["w1"]),
              "norm": {"scale": torch.from_numpy(gs[0]["norm"]["scale"])}}
        tg, tn = tadamw.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(tg["w1"].numpy(), np.asarray(jg["w1"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tg["norm"]["scale"].numpy(),
                                   np.asarray(jg["norm"]["scale"]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Loss and gradients of the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return JM.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("with_resets", [False, True])
def test_loss_and_grads_match_reference(jparams, with_resets):
    """lm_loss and every parameter gradient of the fp32 SMOKE model
    against jax.value_and_grad of the reference, with and without packed
    documents (resets mid-row); 1e-3."""
    jcfg, tcfg = _cfgs()
    batch = JSyntheticLM(jcfg.vocab_size, 64, 3, seed=5,
                         mean_doc_len=16).batch(0)
    resets = batch["resets"] if with_resets else None
    assert not with_resets or resets[:, 1:].any()

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(batch["tokens"]), jcfg,
                               remat="none",
                               resets=None if resets is None
                               else jnp.asarray(resets))
        return JM.lm_loss(logits, jnp.asarray(batch["labels"]))

    jl, jg = jax.value_and_grad(jloss)(jparams)
    tp = state_from_params(_masters(jparams, tcfg))["params"]
    leaves = [p for _, p in leaves_with_paths(tp)]
    grads = {}
    for remat in ("none", "full"):
        tl = TM.lm_loss(TM.forward(
            tp, torch.as_tensor(batch["tokens"]), tcfg, remat=remat,
            resets=None if resets is None else torch.as_tensor(resets)),
            torch.as_tensor(batch["labels"]))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL,
                                   atol=TOL)
        it = iter(torch.autograd.grad(tl, leaves))
        grads[remat] = tree_map(lambda _: next(it), tp)
    _close_trees(grads["none"], jg, tcfg, TOL, "grad")
    # remat="full" recomputes each layer and gives the same gradient
    for (_, a), (_, b) in zip(leaves_with_paths(grads["none"]),
                              leaves_with_paths(grads["full"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_lm_loss_masks_negative_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[:, -1] = -1
    labels[0, 1] = -1
    want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = TM.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    ce, n, _ = TM.lm_loss_sum(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert int(n) == 7


# ---------------------------------------------------------------------------
# Train step, trajectory, loop
# ---------------------------------------------------------------------------

def test_train_step_matches_reference():
    """One step from the same state (2 microbatches, packed documents):
    loss, grad norm, lr, every param and both Adam moments; 1e-3."""
    jcfg, tcfg = _cfgs()
    jrun, trun = _runs(num_microbatches=2, remat="none", warmup_steps=0,
                       total_steps=10, learning_rate=1e-3)
    jstate = j_init_state(jax.random.PRNGKey(3), jcfg, jrun)
    tstate = state_from_params(_masters(jstate["params"], tcfg))
    batch = JSyntheticLM(jcfg.vocab_size, 32, 4, seed=2,
                         mean_doc_len=8).microbatched(0, 2)
    jnew, jm = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))(
        jstate, batch)
    tnew, tm = make_train_step(tcfg, trun)(tstate, batch)
    for key in ("loss", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    assert tm["skipped"] == 0.0 and tnew["step"] == 1
    assert tnew["opt"].count == int(jnew["opt"].count) == 1
    _close_trees(tnew["params"], jnew["params"], tcfg, TOL, "param")
    _close_trees(tnew["opt"].m, jnew["opt"].m, tcfg, TOL, "m")
    _close_trees(tnew["opt"].v, jnew["opt"].v, tcfg, TOL, "v")


def test_loss_trajectory_matches_reference_train():
    """Twin of examples/quickstart.py at 10 steps in fp32: the port's
    train() from the reference's initial params follows the reference's
    train() loss step by step within 1e-3."""
    jcfg, tcfg = _cfgs()
    kw = dict(num_microbatches=2, total_steps=10, warmup_steps=2,
              learning_rate=1e-3, remat="none")
    jrun, trun = _runs(**kw)
    quiet = dict(log_every=10 ** 9, log_fn=lambda *_: None)
    _, jhist = j_train(jcfg, jrun, JSyntheticLM(jcfg.vocab_size, 64, 4,
                                                seed=0), **quiet)
    params = _masters(JM.init_params(jax.random.PRNGKey(jrun.seed), jcfg),
                      tcfg)
    _, thist = train(tcfg, trun, SyntheticLM(tcfg.vocab_size, 64, 4, seed=0),
                     device="cpu", params=params, **quiet)
    assert [h["step"] for h in thist] == list(range(10))
    for t, j in zip(thist, jhist):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=TOL, atol=TOL,
                                   err_msg=f"step {t['step']}")
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)


def test_loss_decreases():
    """Twin of test_loss_decreases: 60 bf16 steps (fp32 masters) drop the
    SMOKE loss by more than 0.2."""
    cfg = get_smoke(ARCH)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    run = RunConfig(num_microbatches=1, total_steps=60, warmup_steps=5,
                    learning_rate=1e-3, remat="none")
    state, hist = train(cfg, run, SyntheticLM(cfg.vocab_size, 128, 8, seed=0),
                        device="cpu", log_every=10 ** 9,
                        log_fn=lambda *_: None)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.2
    assert state["params"]["layers"][0]["mixer"]["wq"].dtype == torch.float32


def test_nonfinite_grad_skipped():
    """A NaN in the params makes the gradient non-finite: the step is
    skipped, params, moments and the Adam count stay, the step advances."""
    _, cfg = _cfgs("bfloat16")
    run = RunConfig(num_microbatches=1, total_steps=5, remat="none")
    state = init_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = make_train_step(cfg, run)
    batch = SyntheticLM(cfg.vocab_size, 32, 4, seed=0).microbatched(0, 1)
    with torch.no_grad():
        state["params"]["embed"]["table"][0, 0] = float("nan")
    tensors = lambda st: [t for _, t in leaves_with_paths(
        {"p": st["params"], "o": st["opt"]}) if isinstance(t, torch.Tensor)]
    before = [t.detach().clone() for t in tensors(state)]
    new, metrics = step(state, batch)
    assert metrics["skipped"] == 1.0
    assert new["step"] == 1 and new["opt"].count == 0
    for a, b in zip(tensors(new), before):
        torch.testing.assert_close(a.detach(), b, equal_nan=True, rtol=0,
                                   atol=0)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for _ in range(20):
        assert not wd.record(0.1)
    assert wd.record(1.0)
    assert wd.slow_steps == 1


def test_watchdog_compile_spike_cannot_poison_window():
    """The first recorded step carries the kernel builds (or a resume):
    never flagged, never in the rolling window, so later genuinely slow
    steps still trip the detector."""
    wd = StepWatchdog(factor=3.0, warmup=1)
    assert wd.record(30.0) is False
    for _ in range(12):
        assert not wd.record(0.1)
    assert 30.0 not in wd.times
    assert wd.record(0.5) is True
    assert wd.slow_steps == 1


def _run(ckpt, steps, cfg, run, data):
    return train(cfg, run, data, device="cpu", ckpt_dir=str(ckpt),
                 ckpt_every=5, log_every=10 ** 9, log_fn=lambda *_: None,
                 max_steps=steps)


def test_checkpoints_pruned(tmp_path):
    cfg = get_smoke(ARCH)
    run = RunConfig(num_microbatches=1, total_steps=20, warmup_steps=2,
                    remat="none")
    _run(tmp_path / "c", 20, cfg, run, SyntheticLM(cfg.vocab_size, 32, 4))
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert len(mgr.all_steps()) <= 3
    assert mgr.latest_step() == 20


def test_crash_resume_bitwise(tmp_path):
    """Train 20 straight vs train 10 + restart + 10: identical params and
    moments. The reference's twin runs mamba2 SMOKE, which the port has
    not ported yet; this one runs linear-llama3 SMOKE."""
    cfg = get_smoke(ARCH)
    run = RunConfig(num_microbatches=1, total_steps=20, warmup_steps=2,
                    learning_rate=1e-3, remat="none")
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=1)
    full, _ = _run(tmp_path / "a", 20, cfg, run, data)
    _run(tmp_path / "b", 10, cfg, run, data)              # "crash"
    resumed, hist = _run(tmp_path / "b", 20, cfg, run, data)
    assert hist[0]["step"] == 10, "must resume from the checkpoint"
    assert resumed["step"] == full["step"] == 20
    assert resumed["opt"].count == full["opt"].count
    for (path, a), (_, b) in zip(
            leaves_with_paths({"p": full["params"], "o": full["opt"]}),
            leaves_with_paths({"p": resumed["params"],
                               "o": resumed["opt"]})):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg="/".join(path))


def test_checkpoint_roundtrip_dtypes_and_fallback(tmp_path):
    """Leaves restore in place with their dtypes (bf16 by its raw-bits
    rule, never cast); a corrupt latest checkpoint is rejected and the
    newest valid one restores."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "h": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16),
            "n": 7}
    mgr.save(1, tree)
    tree2 = {"w": tree["w"] + 1, "h": tree["h"], "n": 8}
    mgr.save_async(2, tree2)
    mgr.wait()
    target = {"w": torch.zeros(3, 4), "h": torch.zeros(3,
                                                       dtype=torch.bfloat16),
              "n": 0}
    out = mgr.restore(1, target)
    assert out["w"] is target["w"] and out["n"] == 7
    torch.testing.assert_close(out["w"], tree["w"], rtol=0, atol=0)
    torch.testing.assert_close(out["h"], tree["h"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="never converted"):
        mgr.restore(1, {"w": torch.zeros(3, 4, dtype=torch.float64)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": torch.zeros(4, 3)})
    arrays = tmp_path / "step_00000002" / "arrays.npz"
    raw = bytearray(arrays.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    arrays.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(2, target)
    step, out, rejected = mgr.restore_latest_valid(target)
    assert step == 1 and [s for s, _ in rejected] == [2]
    assert out["n"] == 7


def test_train_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "5", "--seq", "64", "--batch", "4"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "over 5 steps" in out.stdout
