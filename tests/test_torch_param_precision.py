"""Port vs reference: the train steps' two precision fields,
``RunConfig.cast_params_once`` and ``RunConfig.bf16_params``, at SMOKE
size on the CPU.

Both packages start from the reference's initial params (carried across
through numpy with ``params_from_jax`` as fp32 masters; under
``bf16_params`` the port's ``state_from_params`` stores the matrices in
bf16 as the reference's ``init_state`` does) and take the same numpy
batches. The reference casts by rank in its own layout, where each
pattern position's layers are stacked over a leading group axis: a
layer's norm scales, biases and SSD vectors have 2 dims there and are
cast with the matrices; the final norms' scales and the cross layers'
0-d gates stay fp32.

Tolerances: in bf16 compute, losses and grad norms 4e-2 (the
reference's bf16 limit, ``tests/test_kernels.py:14``); the fp32 moments
and the params over 3 steps as ``tests/torch_precision.py`` sets out
(each leaf's moments within 4e-2 in norm; each param within one rounding
a step plus the learning rate times the difference of the Adam
directions that each package's own moments give, so a skipped or
reversed update fails, which the control tests show). The bitwise
checks compare the port with itself.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.sharding.rules import local_plan
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.weights import params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as step_module
from repro_torch.train.loop import train
from repro_torch.train.step import (cast_matrices, init_state,
                                    make_loss_fn, make_train_step,
                                    state_from_params)
import torch_precision as P
import torch_sp_ranks as R
from test_torch_train import _jax_layout, _masters

ARCH = "linear-llama3-1b"
TOL_LOSS = 4e-2
LR = 1e-3
FLAGS = {name: flags for name, flags in R.PRECISION_FLAGS.items() if flags}
RUN = dict(num_microbatches=2, remat="none", warmup_steps=0, total_steps=10,
           learning_rate=LR)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(arch=ARCH, dtype="bfloat16"):
    return (dataclasses.replace(j_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _keyed(tree):
    return {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_dtypes(tree, cfg):
    """The dtype of each port leaf under the reference's path for it
    (layers stacked per pattern position; every layer of a position must
    agree)."""
    n = len(cfg.pattern)
    out = {}
    for path, leaf in leaves_with_paths(tree):
        if path[0] == "encoder" and path[1] == "layers":
            key = ("encoder", "groups", "0") + path[3:]
        elif path[0] == "layers":
            key = ("groups", str(int(path[1]) % n)) + path[2:]
        else:
            key = path
        name = "".join(f"[{k!r}]" if not k.isdigit() else f"[{k}]"
                       for k in key)
        dt = str(leaf.dtype).replace("torch.", "")
        assert out.setdefault(name, dt) == dt, name
    return out


@pytest.mark.parametrize("arch", ["linear-llama3-1b", "mamba2-2.7b",
                                  "hymba-1.5b", "codeqwen1.5-7b",
                                  "whisper-base"])
@pytest.mark.parametrize("bf16", [False, True])
def test_init_dtypes_match_reference(arch, bf16):
    """Under ``bf16_params`` (and without) every param leaf has the
    dtype of its reference counterpart in ``init_state``, the moments are
    fp32 in both, and a bf16 leaf equals the reference's bit for bit
    (both round the same fp32 draw to nearest even); ``init_state``
    draws the same dtypes. Covers norm scales, QKV biases (codeqwen),
    SSD vectors (mamba2, hymba), the encoder and the 0-d gates
    (whisper)."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jrun, trun = JRunConfig(bf16_params=bf16), RunConfig(bf16_params=bf16)
    jstate = j_init_state(jax.random.PRNGKey(0), jcfg, jrun)
    want = {k: str(v.dtype) for k, v in _keyed(jstate["params"]).items()}
    ref_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                              jstate["params"])
    tstate = state_from_params(params_from_jax(ref_params, tcfg,
                                               device="cpu",
                                               dtype=torch.float32), 1, trun)
    got = _ref_dtypes(tstate["params"], tcfg)
    assert got == want
    assert ("bfloat16" in got.values()) == bf16
    drawn = init_state(torch.Generator().manual_seed(0), tcfg, device="cpu",
                       run=trun)
    assert _ref_dtypes(drawn["params"], tcfg) == want
    for st in (tstate, drawn):
        assert {m.dtype for _, m in leaves_with_paths(st["opt"].m)} == \
            {torch.float32}
    assert {str(m.dtype) for m in jax.tree.leaves(jstate["opt"].m)} == \
        {"float32"}
    # bf16 values compared through their exact fp32 upcasts
    layout = _keyed(_jax_layout(tstate["params"], tcfg))
    for key, value in _keyed(ref_params).items():
        assert np.array_equal(layout[key], value), key


N_STEPS = 3


def _snap(keyed):
    return {k: np.array(v, np.float64) for k, v in keyed.items()}


@functools.lru_cache(maxsize=None)
def _reference_run(flags):
    """The reference's N_STEPS bf16-compute steps (2 microbatches, packed
    documents) under ``flags``: (its initial params, its metrics and its
    trajectory, ``torch_precision``'s format)."""
    jcfg, _ = _cfgs()
    jrun = JRunConfig(**RUN, **FLAGS[flags])
    jstate = j_init_state(jax.random.PRNGKey(3), jcfg, jrun)
    init = jax.tree.map(np.asarray, jstate["params"])
    jstep = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))
    metrics, traj = [], []
    for i in range(N_STEPS):
        jstate, jm = jstep(jstate, _DATA.microbatched(i, 2))
        metrics.append({k: float(jm[k]) for k in ("loss", "grad_norm")})
        traj.append({"lr": float(jm["lr"]),
                     "params": _snap(_keyed(jstate["params"])),
                     "m": _snap(_keyed(jstate["opt"].m)),
                     "v": _snap(_keyed(jstate["opt"].v)),
                     "dtypes": {k: str(v.dtype) for k, v in
                                _keyed(jstate["params"]).items()}})
    return init, metrics, traj


_DATA = JSyntheticLM(j_get_smoke(ARCH).vocab_size, 32, 4, seed=2,
                     mean_doc_len=8)


def _port_run(flags):
    """The port's N_STEPS from the reference's initial params under
    ``flags``: (param dtypes in the reference's keys, metrics,
    trajectory)."""
    _, tcfg = _cfgs()
    trun = RunConfig(**RUN, **FLAGS[flags])
    init, _, _ = _reference_run(flags)
    tstate = state_from_params(_masters(init, tcfg), 1, trun)
    tstep = make_train_step(tcfg, trun)
    metrics, traj = [], []
    for i in range(N_STEPS):
        tstate, tm = tstep(tstate, _DATA.microbatched(i, 2))
        metrics.append({"loss": float(tm["loss"]),
                        "grad_norm": float(tm["grad_norm"]),
                        "skipped": float(tm["skipped"])})
        traj.append({"lr": float(tm["lr"]), **{
            name: _snap(_keyed(_jax_layout(tree, tcfg))) for name, tree in
            (("params", tstate["params"]), ("m", tstate["opt"].m),
             ("v", tstate["opt"].v))}})
    return _ref_dtypes(tstate["params"], tcfg), metrics, traj


@pytest.mark.parametrize("flags", list(FLAGS))
def test_one_device_step_matches_reference(flags):
    """3 bf16-compute steps (2 microbatches, packed documents) under each
    flag and both, from the reference's state, against its steps under
    the same flags: each step's loss and grad norm within 4e-2, each
    leaf's fp32 moments within 4e-2 in norm after every step, every param
    within the bound the two packages' moments give it
    (``torch_precision``: one rounding a step in the leaf's dtype plus
    the learning rate times the difference of the two Adam directions),
    the share of elements whose directions straddle 0 within 1%, and
    each param's dtype the reference's."""
    _, want_metrics, ref = _reference_run(flags)
    dtypes, metrics, port = _port_run(flags)
    assert dtypes == ref[-1]["dtypes"]
    for tm, jm in zip(metrics, want_metrics, strict=True):
        assert tm["skipped"] == 0.0
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=TOL_LOSS,
                                       atol=TOL_LOSS, err_msg=key)
    assert P.mismatches(port, ref, dtypes, LR) == []


def _tampered_update(kind):
    """AdamW that, after its update, undoes (``skip``) or reverses
    (``flip``) the change to every bf16 leaf: what a port that dropped or
    inverted the rounding update of the bf16 leaves would do."""
    real = tadamw.update

    def update(grads, state, params, **kw):
        low = [(p, p.detach().clone()) for _, p in leaves_with_paths(params)
               if p.dtype == torch.bfloat16]
        out = real(grads, state, params, **kw)
        with torch.no_grad():
            for p, old in low:
                p.copy_(old if kind == "skip" else
                        (2 * old.float() - p.float()).to(p.dtype))
        return out
    return update


@pytest.mark.parametrize("kind", ["skip", "flip"])
def test_reference_check_rejects_a_wrong_bf16_update(kind, monkeypatch):
    """The control of the test above: with the bf16 leaves' update skipped
    or reversed under both flags, the params break their bound at the
    first step, where the moments still agree."""
    monkeypatch.setattr(tadamw, "update", _tampered_update(kind))
    _, _, ref = _reference_run("both")
    dtypes, _, port = _port_run("both")
    found = P.mismatches(port, ref, dtypes, LR)
    assert any(f.startswith("step 1 params ") for f in found), found
    # the first step's moments come from the same params: they agree
    assert not any(f.startswith(("step 1 m ", "step 1 v ")) for f in found)


def _handed_to_adamw(monkeypatch, accumulate=None):
    """One bf16-compute step under ``cast_params_once`` with no clipping:
    the gradients AdamW receives, and the fp32 sum over the 2
    microbatches of each microbatch's gradients of this step's bf16
    copies, halved (the reference's ``acc + g.astype(f32)``, then the
    mean). ``accumulate`` replaces the step's gradient accumulation."""
    _, tcfg = _cfgs()
    run = RunConfig(**RUN, cast_params_once=True, grad_clip=1e30)
    state = init_state(torch.Generator().manual_seed(0), tcfg, device="cpu",
                       run=run)
    batch = SyntheticLM(tcfg.vocab_size, 32, 4, seed=2).microbatched(0, 2)
    copies = tree_map(lambda p: p.requires_grad_(True),
                      cast_matrices(state["params"], torch.bfloat16))
    leaves = [p for _, p in leaves_with_paths(copies)]
    assert any(p.dtype == torch.bfloat16 for p in leaves)
    loss_fn = make_loss_fn(tcfg, run)
    want = None
    for i in range(2):
        total, _ = loss_fn(copies, {k: torch.as_tensor(v[i])
                                    for k, v in batch.items()})
        grads = [g.float() for g in torch.autograd.grad(total, leaves)]
        want = grads if want is None else [a + g for a, g in
                                           zip(want, grads)]
    want = [a / 2 for a in want]
    seen, real = [], tadamw.update

    def update(grads, *args, **kw):
        seen.extend(g.detach().clone() for _, g in leaves_with_paths(grads))
        return real(grads, *args, **kw)
    monkeypatch.setattr(tadamw, "update", update)
    if accumulate is not None:
        monkeypatch.setattr(step_module, "_accum_grads", accumulate)
    make_train_step(tcfg, run)(state, batch)
    assert len(seen) == len(want)
    return seen, want


def test_cast_params_once_sums_microbatches_in_fp32(monkeypatch):
    """Under ``cast_params_once`` the one-device step hands AdamW fp32
    gradients, each the fp32 sum of the microbatches' gradients of the
    bf16 copies, bit for bit."""
    seen, want = _handed_to_adamw(monkeypatch)
    for g, w in zip(seen, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


def _bf16_sum(loss_fn, params, batch):
    """``_accum_grads`` with the sum kept in each leaf's own dtype."""
    leaves = [p for _, p in leaves_with_paths(params)]
    acc, losses = None, []
    for i in range(batch["tokens"].shape[0]):
        total, loss = loss_fn(params, {k: v[i] for k, v in batch.items()})
        grads = torch.autograd.grad(total, leaves)
        acc = list(grads) if acc is None else [a + g for a, g in
                                               zip(acc, grads)]
        losses.append(loss.detach())
    acc = [a.float() / batch["tokens"].shape[0] for a in acc]
    it = iter(acc)
    return tree_map(lambda _: next(it), params), torch.stack(losses).mean()


def test_fp32_sum_check_rejects_a_bf16_sum(monkeypatch):
    """The control of the test above: a step that sums the microbatches'
    bf16 gradients in bf16 hands AdamW other values."""
    seen, want = _handed_to_adamw(monkeypatch, accumulate=_bf16_sum)
    assert sum(int((g != w).sum()) for g, w in zip(seen, want)) > 0


def test_cast_params_once_keeps_step_0s_loss_bitwise():
    """The copies hold the values each use's cast gives: step 0's loss
    with ``cast_params_once`` equals the loss without it, bit for bit, in
    bf16 compute."""
    _, tcfg = _cfgs()
    batch = SyntheticLM(tcfg.vocab_size, 32, 4, seed=2).microbatched(0, 2)
    losses = []
    for flag in (False, True):
        run = RunConfig(**RUN, cast_params_once=flag)
        state = init_state(torch.Generator().manual_seed(0), tcfg,
                           device="cpu", run=run)
        _, m = make_train_step(tcfg, run)(state, batch)
        losses.append(m["loss"])
    assert torch.equal(losses[0], losses[1])


def _snapshot(state):
    return [t.detach().clone() for _, t in leaves_with_paths(
        {"p": state["params"], "o": state["opt"]})
        if isinstance(t, torch.Tensor)]


def test_cast_params_once_is_a_bitwise_noop_in_fp32():
    """With ``cfg.dtype`` float32 the copies are the masters: 2 steps
    with and without the flag give the same losses, params and moments,
    bit for bit."""
    _, tcfg = _cfgs(dtype="float32")
    data = SyntheticLM(tcfg.vocab_size, 32, 4, seed=2)
    out = []
    for flag in (False, True):
        run = RunConfig(**RUN, cast_params_once=flag)
        state = init_state(torch.Generator().manual_seed(0), tcfg,
                           device="cpu", run=run)
        step, losses = make_train_step(tcfg, run), []
        for i in range(2):
            state, m = step(state, data.microbatched(i, 2))
            losses.append(m["loss"])
        out.append((losses, _snapshot(state)))
    (l0, s0), (l1, s1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert len(s0) == len(s1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_guarded_skip_leaves_bf16_params_and_moments_bitwise():
    """Both flags and the guard, NaN gradients at step 1: step 1 is
    skipped, and the bf16 params, the fp32 moments and Adam's count are
    bit for bit those after step 0."""
    _, tcfg = _cfgs()
    run = RunConfig(**RUN, cast_params_once=True, bf16_params=True,
                    guard=True, chaos_nan_steps=(1,))
    state = init_state(torch.Generator().manual_seed(0), tcfg, device="cpu",
                       run=run)
    step = make_train_step(tcfg, run)
    data = SyntheticLM(tcfg.vocab_size, 32, 4, seed=2)
    state, m0 = step(state, data.microbatched(0, 2))
    assert float(m0["skipped"]) == 0.0
    before = _snapshot(state)
    assert any(t.dtype == torch.bfloat16 for t in before)
    state, m1 = step(state, data.microbatched(1, 2))
    assert float(m1["skipped"]) == 1.0 and state["step"] == 2
    after = _snapshot(state)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_bf16_params_resume_is_bitwise(tmp_path):
    """``train()`` under ``bf16_params``: 6 steps straight against 3, a
    restart and 3 more from the step-3 checkpoint (bf16 leaves stored as
    their bits): the same params and moments, bit for bit, the params
    still bf16."""
    _, tcfg = _cfgs()
    run = RunConfig(num_microbatches=1, total_steps=6, warmup_steps=2,
                    learning_rate=LR, remat="none", bf16_params=True)
    data = SyntheticLM(tcfg.vocab_size, 32, 4, seed=1)
    quiet = dict(device="cpu", ckpt_every=3, log_every=10 ** 9,
                 log_fn=lambda *_: None)
    full, _ = train(tcfg, run, data, ckpt_dir=str(tmp_path / "a"), **quiet)
    train(tcfg, run, data, ckpt_dir=str(tmp_path / "b"), max_steps=3,
          **quiet)
    resumed, hist = train(tcfg, run, data, ckpt_dir=str(tmp_path / "b"),
                          **quiet)
    assert hist[0]["step"] == 3, "must resume from the checkpoint"
    assert resumed["step"] == full["step"] == 6
    assert resumed["params"]["layers"][0]["mixer"]["wq"].dtype == \
        torch.bfloat16
    a, b = _snapshot(full), _snapshot(resumed)
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
