"""Port vs reference: the numerical health guard (``resilience.guard``)
and the guarded one-device train step, at SMOKE size on the CPU.

The verdicts run on scripted norm sequences through both packages and
must agree exactly: the same fp32 operations in the same order. The
guarded step runs 6 steps from the reference's params (carried across
with ``params_from_jax`` as fp32 masters) with NaN gradients injected at
step 3 in both: losses and grad norms within the reference's GRAD_TOL
1e-3, the ``GUARD_METRICS`` exactly, the final params within its fp32
kernel tolerance 3e-4 (``tests/test_kernels.py:14-15``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.resilience import guard as jguard
from repro.sharding.rules import local_plan
from repro.train.loop import train as j_train
from repro.train.step import init_state as j_init_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import RunConfig
from repro_torch.core.tree import leaves_with_paths
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.resilience import guard as tguard
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_step, state_from_params
from test_torch_train import _cfgs, _close_trees, _masters, _runs

TOL = 1e-3
TOL_PARAM = 3e-4
NAN = float("nan")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# Verdicts on scripted sequences
# ---------------------------------------------------------------------------

# (window, [(gnorm, nonfinite), ...]): below the warm-up, a spike after
# it, NaN, consecutive skips, and a window that wraps
SEQUENCES = {
    "warmup": (8, [(0.1, False), (50.0, False), (0.3, False),
                   (2.5, False)]),
    "spike": (16, [(0.1, False)] * 8 + [(10.0, False), (0.1, False),
                                        (0.12, False), (3.0, False)]),
    "nan": (8, [(0.5, False), (NAN, True), (0.4, False), (float("inf"),
                                                          True)]),
    "consecutive": (8, [(0.2, False)] + [(NAN, True)] * 4 + [(0.3, False),
                                                             (NAN, True)]),
    "wrap": (4, [(0.1 * (i % 5 + 1), False) for i in range(9)]
             + [(5.0, False), (NAN, True)]
             + [(0.2 + 0.05 * i, False) for i in range(6)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_verdicts_match_reference(name):
    """Every step's scale, ok, guard leaves and info values equal the
    reference's (fp32 exact), with warmup 4 and 8 both."""
    window, seq = SEQUENCES[name]
    for warmup in (4, jguard.GUARD_WARMUP):
        jg = jguard.guard_init(window)
        tg = tguard.guard_init(window)
        for i, (gnorm, bad) in enumerate(seq):
            kw = dict(grad_clip=1.0, spike_factor=4.0, warmup=warmup)
            js, jok, jg, jinfo = jguard.guard_verdict(
                jg, jnp.float32(gnorm), jnp.asarray(bad), **kw)
            ts, tok, tg, tinfo = tguard.guard_verdict(
                tg, torch.tensor(gnorm, dtype=torch.float32),
                torch.tensor(bad), **kw)
            at = f"{name} warmup {warmup} step {i}"
            assert float(ts) == float(js), at
            assert bool(tok) == bool(jok), at
            assert set(tg) == set(jg), at
            for k in jg:
                np.testing.assert_array_equal(tg[k].numpy(),
                                              np.asarray(jg[k]),
                                              err_msg=f"{at} {k}")
                assert tg[k].dtype == {"norm_window": torch.float32}.get(
                    k, torch.int32)
            assert set(tinfo) == set(jinfo) == set(tguard.GUARD_METRICS)
            for k in jinfo:
                assert float(tinfo[k]) == float(jinfo[k]), f"{at} {k}"


def test_rolling_median_matches_reference():
    """The reference's rolling-median cases: empty → 0, the lower middle
    of an even count, unfilled slots ignored, count past the window."""
    w = [3.0, 1.0, 0.0, 0.0]
    full = [4.0, 2.0, 8.0, 6.0]
    for vals, count, want in ((w, 0, 0.0), (w, 1, 3.0), (w, 2, 1.0),
                              (full, 4, 4.0), (full, 100, 4.0)):
        got = tguard.rolling_median(torch.tensor(vals),
                                    torch.tensor(count, dtype=torch.int32))
        ref = jguard.rolling_median(jnp.asarray(vals, jnp.float32),
                                    jnp.int32(count))
        assert float(got) == float(ref) == want


def test_chaos_helpers():
    """``chaos_hit`` on a step tuple; ``chaos_poison_nan`` fills in place
    at a scheduled step only."""
    assert tguard.chaos_hit(3, (1, 3)) and not tguard.chaos_hit(2, (1, 3))
    assert not tguard.chaos_hit(0, ())
    x = torch.ones(5)
    assert tguard.chaos_poison_nan(x, 2, (3,)) is x and torch.equal(
        x, torch.ones(5))
    tguard.chaos_poison_nan(x, 3, (3,))
    assert torch.isnan(x).all()


def test_run_config_guard_fields_are_validated():
    RunConfig(guard=True, chaos_nan_steps=(1, 5), chaos_skip_steps=(2,))
    for bad in (dict(guard_window=0), dict(guard_spike_factor=0.0),
                dict(guard_max_consecutive_skips=0),
                dict(chaos_nan_steps=[3]), dict(chaos_skip_steps=(-1,))):
        with pytest.raises(ValueError):
            RunConfig(**bad)


# ---------------------------------------------------------------------------
# The guarded one-device step
# ---------------------------------------------------------------------------

N_STEPS = 6
NAN_STEP = 3


def _guarded(chaos=(), skip=(), guard=True):
    return _runs(num_microbatches=2, remat="none", warmup_steps=2,
                 total_steps=10, learning_rate=1e-3, guard=guard,
                 chaos_nan_steps=chaos, chaos_skip_steps=skip)


def _port_steps(trun, jparams, tcfg, batches):
    state = state_from_params(_masters(jparams, tcfg), run=trun)
    step = make_train_step(tcfg, trun)
    hist, snaps = [], []
    for b in batches:
        snaps.append([t.detach().clone() for _, t in leaves_with_paths(
            {"p": state["params"], "m": state["opt"].m,
             "v": state["opt"].v})])
        state, m = step(state, b)
        hist.append(m)
    return state, hist, snaps


@pytest.fixture(scope="module")
def guarded():
    """6 guarded steps with NaN at step 3 in both packages, and the port's
    forced-skip run at step 3."""
    jcfg, tcfg = _cfgs()
    jrun, trun = _guarded(chaos=(NAN_STEP,))
    jstate = j_init_state(jax.random.PRNGKey(3), jcfg, jrun)
    jparams = jstate["params"]
    data = JSyntheticLM(jcfg.vocab_size, 32, 4, seed=2, mean_doc_len=8)
    batches = [data.microbatched(i, 2) for i in range(N_STEPS)]
    jstep = jax.jit(j_make_train_step(jcfg, jrun, local_plan()))
    jhist = []
    for b in batches:
        jstate, m = jstep(jstate, b)
        jhist.append({k: float(v) for k, v in m.items()})
    tstate, thist, snaps = _port_steps(trun, jparams, tcfg, batches)
    _, skip_run = _guarded(skip=(NAN_STEP,))
    _, skip_hist, _ = _port_steps(skip_run, jparams, tcfg, batches)
    return dict(jstate=jstate, jhist=jhist, tstate=tstate, thist=thist,
                snaps=snaps, skip_hist=skip_hist, tcfg=tcfg,
                jparams=jparams, batches=batches)


def test_guarded_step_matches_reference(guarded):
    """Losses, grad norms and lr within 1e-3, ``skipped`` and every
    ``GUARD_METRICS`` value exactly, the guard's state leaf by leaf, and
    the final params, moments and Adam count (3e-4)."""
    jhist, thist = guarded["jhist"], guarded["thist"]
    for i, (t, j) in enumerate(zip(thist, jhist)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=TOL, atol=TOL,
                                       err_msg=f"step {i} {key}")
        for key in ("skipped",) + tguard.GUARD_METRICS:
            assert t[key] == j[key], (i, key, t[key], j[key])
    assert [t["skipped"] for t in thist] == [float(i == NAN_STEP)
                                             for i in range(N_STEPS)]
    tstate, jstate, tcfg = guarded["tstate"], guarded["jstate"], \
        guarded["tcfg"]
    assert tstate["step"] == int(jstate["step"]) == N_STEPS
    assert tstate["opt"].count == int(jstate["opt"].count) == N_STEPS - 1
    for k, v in jstate["guard"].items():
        np.testing.assert_allclose(tstate["guard"][k].numpy(), np.asarray(v),
                                   rtol=TOL, atol=0, err_msg=k)
    _close_trees(tstate["params"], jstate["params"], tcfg, TOL_PARAM,
                 "param")
    _close_trees(tstate["opt"].m, jstate["opt"].m, tcfg, TOL_PARAM, "m")
    _close_trees(tstate["opt"].v, jstate["opt"].v, tcfg, TOL_PARAM, "v")


def test_skipped_step_leaves_params_and_moments_equal(guarded):
    """The NaN step changes no param and no moment (``torch.equal``)."""
    before, after = guarded["snaps"][NAN_STEP], guarded["snaps"][NAN_STEP + 1]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not all(torch.equal(a, b) for a, b in
                   zip(guarded["snaps"][NAN_STEP - 1], before))


def test_nan_step_equals_forced_skip(guarded):
    """A NaN step behaves exactly as a forced skip: the same losses and
    guard metrics at every step, bit for bit."""
    for t, s in zip(guarded["thist"], guarded["skip_hist"]):
        assert t["loss"] == s["loss"]
        for key in ("skipped",) + tguard.GUARD_METRICS:
            assert t[key] == s[key]


def test_clean_guarded_trajectory_is_bitwise_unguarded(guarded):
    """On clean steps the guard's clip is the plain clip's formula: the
    guarded losses, grad norms and final params equal the unguarded run's
    bit for bit; with the guard off no guard state or metric appears."""
    _, g_run = _guarded()
    _, p_run = _guarded(guard=False)
    tcfg, jparams, batches = guarded["tcfg"], guarded["jparams"], \
        guarded["batches"]
    g_state, g_hist, _ = _port_steps(g_run, jparams, tcfg, batches)
    p_state, p_hist, _ = _port_steps(p_run, jparams, tcfg, batches)
    assert [h["loss"] for h in g_hist] == [h["loss"] for h in p_hist]
    assert [h["grad_norm"] for h in g_hist] == \
        [h["grad_norm"] for h in p_hist]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_paths(g_state["params"]),
        leaves_with_paths(p_state["params"])))
    assert "guard" not in p_state and "guard" in g_state
    assert not set(tguard.GUARD_METRICS) & set(p_hist[0])


def test_guard_abort_at_threshold_in_both_packages():
    """A persistent NaN source from step 2 with a threshold of 2: both
    loops raise ``GuardAbort`` at step 3, after the same skip log."""
    jcfg, tcfg = _cfgs("bfloat16")
    kw = dict(num_microbatches=1, remat="none", total_steps=8,
              warmup_steps=2, guard=True, chaos_nan_steps=(2, 3, 4, 5),
              guard_max_consecutive_skips=2)
    jrun, trun = _runs(**kw)
    logs = {"jax": [], "torch": []}
    with pytest.raises(jguard.GuardAbort, match="at step 3"):
        j_train(jcfg, jrun, JSyntheticLM(jcfg.vocab_size, 32, 4, seed=0),
                log_every=10 ** 9, log_fn=logs["jax"].append)
    with pytest.raises(tguard.GuardAbort, match="at step 3"):
        train(tcfg, trun, SyntheticLM(tcfg.vocab_size, 32, 4, seed=0),
              device="cpu", log_every=10 ** 9, log_fn=logs["torch"].append)
    guard = {k: [m for m in v if m.startswith("[guard]")]
             for k, v in logs.items()}
    assert guard["torch"] == guard["jax"] == [
        "[guard] step 2 skipped (non-finite update; consecutive 1)",
        "[guard] step 3 skipped (non-finite update; consecutive 2)"]
