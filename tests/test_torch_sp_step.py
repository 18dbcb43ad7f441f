"""Port vs reference: the DP×SP train step, ZeRO-1 and the DP×SP CLI on
gloo ranks, at SMOKE size.

The reference's manual DP×SP step (``repro/train/step.py``) takes 3 steps
at (dp, sp) = (1, 4) and (2, 2), and at (1, 4) on rows without resets
(the faithful backward), on 4 virtual CPU devices in one subprocess
started from this file (``python tests/test_torch_sp_step.py
--jax-reference out.npz``), which also writes its initial params. The
port starts from those params (``params_from_jax``, fp32 masters) on 4
gloo ranks (``launch.mesh.run_ranks``) of the same layouts, each rank its
rows and chunk of the same seeded global batch, through the plain
versions of the kernels. SMOKE runs in fp32 on both sides (the frameworks
round bf16 at other points). Tolerances: losses 1e-3, as the one-device
step's (``tests/test_torch_train.py``); ZeRO-1 against replicated AdamW
1e-6, and the bf16 wire against fp32 2e-2
(``tests/distributed_checks.py:513-549``).

The guard and checkpoints across layouts ride the same spawns: the
guarded step at (2, 2) against the reference's guarded manual step
(NaN gradients at step 1), and ``train()`` checkpoints written at
(2, 2) with ZeRO-1, at (1, 2) and on one device, resumed at (2, 1), on
one device and at (1, 2); resumed losses within 1e-5 of the
uninterrupted runs'.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_sp_ranks as R
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import TrainingGroups, run_ranks

HERE = Path(__file__).resolve()
ROOT = HERE.parent.parent
TOL = 1e-3
TOL_RESUME = 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's losses, tapes and initial params."""
    out = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(HERE), "--jax-reference",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    """Checkpoint directories of the layout cells, by the layout that
    wrote them."""
    return tmp_path_factory.mktemp("ckpt")


def _port(ref, dp, sp, ckpt_root):
    ranks = run_ranks(R.step_rank, dp * sp,
                      args=(dp, sp, str(ref), str(ckpt_root)),
                      timeout_s=300)
    with np.load(ref) as npz:
        want = {k: npz[k] for k in npz.files
                if not k.startswith(("param/", "hparam/"))}
    return dp, sp, ranks, want


@pytest.fixture(scope="module")
def sp4(ref, ckpt_root):
    """The port at (dp, sp) = (1, 4): pure sequence parallelism."""
    return _port(ref, 1, 4, ckpt_root)


@pytest.fixture(scope="module")
def dp2sp2(ref, ckpt_root):
    """The port at (2, 2), ZeRO-1 over the data pairs."""
    return _port(ref, 2, 2, ckpt_root)


@pytest.fixture(params=["sp4", "dp2sp2"])
def port(request):
    return request.getfixturevalue(request.param)


def _rows(arr):
    return [str(x) for x in arr]


def test_layout_places_ranks_data_major(port):
    """Global rank r sits at data index r // sp, chunk index r % sp."""
    dp, sp, ranks, _ = port
    assert [r["layout"] for r in ranks] == [
        divmod(i, sp) for i in range(dp * sp)]


def test_step_losses_match_reference(port):
    """3 steps of packed rows (resets: the autodiff backward under SP):
    every rank reports the reference's losses within 1e-3."""
    dp, sp, ranks, want = port
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want[f"dp{dp}sp{sp}/loss"],
                                   rtol=TOL, atol=TOL)


def test_faithful_step_losses_match_reference(sp4):
    """Rows without resets take the faithful Alg. 3/4 backward: 3 steps
    at (1, 4) within 1e-3 of the reference's."""
    dp, sp, ranks, want = sp4
    for r in ranks:
        np.testing.assert_allclose(r["faithful_losses"],
                                   want[f"dp{dp}sp{sp}/faithful_loss"],
                                   rtol=TOL, atol=TOL)
        assert any("lasp2.dstates" in row for row in r["faithful_tape"])


def test_step_tape(port):
    """One step's collectives: per linear layer and microbatch one forward
    state all-gather (its backward: the reduce-scatter on packed rows),
    ONE gradient all-reduce, and under ZeRO-1 ONE param all-gather; each
    with the reference's payload. (The reference records while it traces,
    and traces its microbatch and layer scans once, so its tape holds each
    row once.)"""
    dp, sp, ranks, want = port
    cfg = R.step_cfg()
    per_step = cfg.n_layers * R.RUN["num_microbatches"]
    ref_rows = _rows(want[f"dp{dp}sp{sp}/tape"])
    for r in ranks:
        tape = r["tape"]
        fwd = [x for x in tape if not x.split("|")[1].endswith(".bwd")]
        assert sorted(set(fwd)) == sorted(ref_rows)
        states = [x for x in fwd if "|lasp2.states|" in x]
        assert len(states) == per_step
        assert sum("|train.grads|" in x for x in tape) == 1
        assert sum("|zero1.param_gather|" in x for x in tape) == \
            (1 if dp > 1 else 0)
        assert sum(x.startswith("reduce-scatter|lasp2.states.bwd")
                   for x in tape) == per_step


def test_ring_step_matches_reference(sp4):
    """The "ring" strategy at (1, 4) on packed rows: 3 steps within 1e-3
    of the reference's ring step; per linear layer and microbatch W-1 = 3
    state hops forward and 3 back, no state all-gather."""
    dp, sp, ranks, want = sp4
    per_step = R.step_cfg().n_layers * R.RUN["num_microbatches"]
    for r in ranks:
        np.testing.assert_allclose(r["ring_losses"],
                                   want[f"dp{dp}sp{sp}/ring_loss"],
                                   rtol=TOL, atol=TOL)
        fwd = [x for x in r["ring_tape"]
               if not x.split("|")[1].endswith(".bwd")]
        assert set(fwd) == set(_rows(want[f"dp{dp}sp{sp}/ring_tape"]))
        tags = [x.split("|")[1] for x in r["ring_tape"]]
        assert tags.count("lasp2.ring") == tags.count("lasp2.ring.bwd") \
            == (sp - 1) * per_step
        assert "lasp2.states" not in tags


def test_ulysses_step_matches_reference(dp2sp2):
    """The "ulysses" strategy at (2, 2) on the hybrid cut (3 linear + 1
    softmax layer), ZeRO-1: 3 steps within 1e-3 of the reference's
    ulysses step; per microbatch the linear layers' state all-gathers and
    the softmax layer's two all-to-alls forward (their mirrors backward),
    no K/V all-gather."""
    dp, sp, ranks, want = dp2sp2
    micro = R.RUN["num_microbatches"]
    for r in ranks:
        np.testing.assert_allclose(r["ulysses_losses"],
                                   want[f"dp{dp}sp{sp}/ulysses_loss"],
                                   rtol=TOL, atol=TOL)
        # the reference records the all-to-alls' mirrors, not the
        # reduce-scatters of its gathers
        assert {x for x in r["ulysses_tape"]
                if not x.startswith("reduce-scatter|")} == set(
            _rows(want[f"dp{dp}sp{sp}/ulysses_tape"]))
        tags = [x.split("|")[1] for x in r["ulysses_tape"]
                if not x.split("|")[1].endswith(".bwd")]
        assert tags.count("lasp2.states") == 3 * micro
        assert tags.count("ulysses.in") == tags.count("ulysses.out") == micro
        assert not any(t.startswith("lasp2h.") for t in tags)


def test_sanitizer_wire_and_determinism_at_dp2sp2(dp2sp2):
    """The sanitizer on two bf16-wire steps at (2, 2) on every rank: no
    finding (SAN201 to SAN205: no host sync, no float64, bf16 on every
    sequence exchange, params and moments in place, the same collectives
    in both steps); a planted fp32 state gather is SAN203."""
    _, _, ranks, _ = dp2sp2
    for r in ranks:
        san = r["sanitizer"]
        assert san["findings"] == [], san["findings"]
        assert san["planted"] == ["SAN203"]
        assert san["same"] and san["bf16"] > 0
        assert san["records"] > san["bf16"]     # the fp32 grads and gather


def test_bf16_wire_halves_state_bytes(sp4):
    """comm_dtype="bf16" at (1, 4): the state gathers carry half the bytes,
    the collective counts are unchanged, the losses stay within 2e-2."""
    _, _, ranks, _ = sp4
    for r in ranks:
        np.testing.assert_allclose(r["bf16_losses"], r["losses"], rtol=2e-2,
                                   atol=2e-2)
        assert len(r["bf16_tape"]) == len(r["tape"])
        for a, b in zip(r["tape"], r["bf16_tape"]):
            op_a, tag_a, n_a = a.split("|")
            op_b, tag_b, n_b = b.split("|")
            assert (op_a, tag_a) == (op_b, tag_b)
            want = int(n_a) // 2 if tag_a.startswith("lasp2.states") \
                else int(n_a)
            assert int(n_b) == want, (a, b)


def test_remat_full_replays_the_forward_gathers(sp4):
    """remat="full" recomputes each layer in the backward, exchange
    included: the state all-gathers of one forward and backward double."""
    _, _, ranks, _ = sp4
    n = R.step_cfg().n_layers
    for r in ranks:
        assert r["remat_counts"] == {"none": n, "full": 2 * n}


@pytest.fixture(scope="module")
def ssm(ref, dp2sp2, ckpt_root):
    """The SSM family's SMOKE models at (1, 2) on two gloo ranks, and on
    one device (the one-device step), from the reference's params; with
    the checkpoint cells (after (2, 2) wrote its checkpoint): one device
    saves before the spawn and resumes (1, 2)'s after it."""
    import shutil
    local = {"ckpt_full": R.ckpt_train(str(ref), "cpu", None, R.CKPT_TOTAL)}
    R.ckpt_train(str(ref), "cpu", None, R.CKPT_STEPS,
                 str(ckpt_root / "dev1"))
    ranks = run_ranks(R.ssm_rank, 2, args=(str(ref), str(ckpt_root)),
                      timeout_s=300)
    shutil.copytree(ckpt_root / "dp1sp2", ckpt_root / "dp1sp2_to_dev1")
    local["resume_dp1sp2_on_dev1"] = R.ckpt_train(
        str(ref), "cpu", None, R.CKPT_TOTAL,
        str(ckpt_root / "dp1sp2_to_dev1"))
    local.update({arch: R.ssm_steps(str(ref), "cpu", arch, None)
                  for arch in R.SSM_ARCHS + R.ZOO_ARCHS})
    with np.load(ref) as npz:
        want = {k: npz[k] for k in npz.files if k.startswith("ssm/")}
    return ranks, local, want


@pytest.mark.parametrize("arch", R.SSM_ARCHS)
def test_ssm_steps_match_reference_at_1x2(ssm, arch):
    """3 steps of packed rows at (1, 2): mamba2's layers take LASP-2 with
    the autodiff backward, hymba's the same for its SSD heads and the K/V
    all-gather with its window for its attention heads; every rank's
    losses and grad norms within 1e-3 of the reference's manual step at
    (1, 2)."""
    ranks, _, want = ssm
    for r in ranks:
        np.testing.assert_allclose(r[arch]["losses"],
                                   want[f"ssm/{arch}/sp/loss"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r[arch]["gnorms"],
                                   want[f"ssm/{arch}/sp/gnorm"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", R.SSM_ARCHS)
def test_ssm_step_tape(ssm, arch):
    """One step's collectives at (1, 2), with the reference's payloads: per
    mamba2 (or hymba SSD) layer and microbatch one forward state
    all-gather, ``lasp2.states``, and its reduce-scatter backward; per
    hymba layer and microbatch the K/V all-gathers too; ONE gradient
    all-reduce."""
    ranks, _, want = ssm
    cfg = R.ssm_step_cfg(arch)
    per_step = cfg.n_layers * R.RUN["num_microbatches"]
    for r in ranks:
        tape = r[arch]["tape"]
        fwd = [x for x in tape if not x.split("|")[1].endswith(".bwd")]
        assert sorted(set(fwd)) == sorted(_rows(want[f"ssm/{arch}/tape"]))
        tags = [x.split("|")[1] for x in fwd]
        assert tags.count("lasp2.states") == per_step
        assert tags.count("lasp2h.k") == tags.count("lasp2h.v") == \
            (per_step if arch == "hymba-1.5b" else 0)
        assert tags.count("train.grads") == 1
        assert sum(x.startswith("reduce-scatter|lasp2.states.bwd")
                   for x in tape) == per_step


@pytest.mark.parametrize("arch", R.SSM_ARCHS)
def test_ssm_sp_misses_the_conv_halo_as_the_reference_does(ssm, arch):
    """A reference finding the port keeps: under the manual DP×SP step each
    rank's causal conv starts its chunk from zeros, not from rank r−1's
    last d_conv − 1 inputs (no halo), so (1, 2) departs from one device
    by more than 1e-3 here (the reference's linear-llama3 SMOKE, with no
    conv, stays within 1e-6: ROADMAP Queue 3). The port's gap between
    (1, 2) and one device is the reference's, step by step, within
    1e-5."""
    ranks, local, want = ssm
    ref_gap = want[f"ssm/{arch}/sp/loss"] - want[f"ssm/{arch}/local/loss"]
    assert np.abs(ref_gap).max() > 1e-3, ref_gap
    for r in ranks:
        gap = np.asarray(r[arch]["losses"]) - np.asarray(
            local[arch]["losses"])
        np.testing.assert_allclose(gap, ref_gap, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", R.ZOO_ARCHS)
def test_dense_zoo_steps_match_reference_at_1x2(ssm, arch):
    """starcoder2-15b SMOKE (GQA 4:2) at (1, 2): every rank's 3 losses and
    grad norms within 1e-3 of the reference's manual step at (1, 2), and
    of its own one-device step (no conv, so no halo gap)."""
    ranks, local, want = ssm
    for r in ranks:
        for key, got in (("loss", r[arch]["losses"]),
                         ("gnorm", r[arch]["gnorms"])):
            np.testing.assert_allclose(got, want[f"ssm/{arch}/sp/{key}"],
                                       rtol=TOL, atol=TOL, err_msg=key)
        np.testing.assert_allclose(r[arch]["losses"],
                                   local[arch]["losses"], rtol=TOL,
                                   atol=TOL)
    tags = [x.split("|")[1] for x in ranks[0][arch]["tape"]]
    per_step = R.ssm_step_cfg(arch).n_layers * R.RUN["num_microbatches"]
    assert tags.count("lasp2h.k") == tags.count("lasp2h.v") == per_step


def test_moe_is_refused_under_the_dp_sp_step_by_both_packages(ref):
    """A reference finding the port keeps: moonshot-v1-16b-a3b SMOKE under
    the manual DP×SP step at (1, 2). The reference's step raises while it
    traces (its ``moe_apply`` opens a ``shard_map`` of its own inside the
    step's manual one; recorded by the subprocess); the port's
    ``ShardedStep`` raises ``NotImplementedError`` before any rank
    work."""
    from repro_torch.configs import get_smoke
    from repro_torch.train.step import make_train_step
    with np.load(ref) as npz:
        err = str(npz["moe/ref_error"])
    assert err.startswith("ValueError") and "shard_map" in err, err
    cfg = get_smoke("moonshot-v1-16b-a3b")
    layout = TrainingGroups(1, 2, 0, 0, None, None, None)
    with pytest.raises(NotImplementedError, match="MoE layers"):
        make_train_step(cfg, RunConfig(), layout)


def test_zero1_equals_replicated_adamw(dp2sp2):
    """ZeRO-1 over the data ranks against replicated AdamW at (2, 2), 2
    steps: losses within 1e-6, every param within 1e-6 relative and 1e-7
    absolute."""
    _, _, ranks, _ = dp2sp2
    for r in ranks:
        assert r["opt_type"] == "Zero1AdamState"
        np.testing.assert_allclose(r["zero1_losses"], r["replicated_losses"],
                                   rtol=1e-6, atol=1e-6)
        assert r["zero1_params_close"], r["zero1_param_diff"]


def test_nonfinite_step_is_skipped_on_every_rank(dp2sp2):
    """A NaN in the params at (2, 2) with ZeRO-1: every rank skips the step
    (one reduction, one verdict); params, moments and the Adam count stay;
    the step advances."""
    _, _, ranks, _ = dp2sp2
    for r in ranks:
        assert r["nonfinite"] == {"skipped": 1.0, "step": 1, "count": 0,
                                  "frozen": True}


def test_guarded_sharded_step_matches_reference(dp2sp2):
    """The guarded ``ShardedStep`` at (2, 2) with ZeRO-1 and NaN gradients
    at step 1: every rank's losses within 1e-3 of the reference's guarded
    manual step, ``skipped`` and the ``GUARD_METRICS`` equal, step 1 the
    only skip."""
    _, _, ranks, want = dp2sp2
    for r in ranks:
        got = r["guard_nan"]
        np.testing.assert_allclose(got["losses"], want["guard/loss"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(np.array(got["metrics"]),
                                      want["guard/metrics"])
        assert [m[0] for m in got["metrics"]] == [
            float(i == R.GUARD_NAN_STEP) for i in range(R.N_STEPS)]


def test_guard_adds_no_collective(dp2sp2):
    """The guarded step's tape holds the unguarded step's collectives, op
    for op and tag for tag; only ``train.grads`` grows, by the 4 bytes of
    the loss-health scalar; its forward rows are the reference's guarded
    step's; on clean steps the guarded losses are the unguarded ones, bit
    for bit."""
    _, _, ranks, want = dp2sp2
    for r in ranks:
        plain, guarded = r["tape"], r["guard_clean"]["tape"]
        assert len(plain) == len(guarded)
        for a, b in zip(plain, guarded):
            op_a, tag_a, n_a = a.split("|")
            op_b, tag_b, n_b = b.split("|")
            assert (op_a, tag_a) == (op_b, tag_b)
            assert int(n_b) - int(n_a) == (4 if tag_a == "train.grads"
                                           else 0), (a, b)
        fwd = [x for x in guarded if not x.split("|")[1].endswith(".bwd")]
        assert sorted(set(fwd)) == sorted(_rows(want["guard/tape"]))
        assert r["guard_clean"]["losses"] == r["losses"]


def test_flight_recorder_sees_no_drift_under_a_layout(dp2sp2):
    """``train(sink=)`` at (2, 2): only rank 0 emits; its ``compile``
    record holds the first step's tape and issued view, op by op the same
    counts and payload bytes, and no drift."""
    _, _, ranks, _ = dp2sp2
    assert all(r["records"] is None for r in ranks[1:])
    records = ranks[0]["records"]
    assert [r["kind"] for r in records] == ["compile"] + \
        ["step"] * R.CKPT_STEPS + ["summary"]
    comp = records[0]
    assert comp["drift"] == []
    ops = {k.split("/", 1)[1].rsplit("_", 1)[0] for k in comp
           if k.startswith("tape/")}
    assert ops == {"all-gather", "reduce-scatter", "all-reduce"}
    for op in ops:
        for what in ("count", "bytes"):
            assert comp[f"tape/{op}_{what}"] == comp[f"issued/{op}_{what}"]
    assert comp["tape/all-reduce_count"] == 1
    assert all(r["mfu"] > 0 for r in records[1:-1])


def test_issued_view_flags_a_collective_that_bypasses_the_primitives(
        dp2sp2):
    """At (2, 2), an all-reduce made straight to ``torch.distributed``
    beside a primitive's: the issued view counts both, with their bytes,
    the primitive's tag on its own and none on the other, and the flight
    recorder reports the drift; the entry point is unwrapped after."""
    _, _, ranks, _ = dp2sp2
    for r in ranks:
        got = r["bypass"]
        assert got["tags"] == ["probe", ""]
        assert got["bytes"] == [16, 8]
        assert got["drift"] == ["all-reduce: 2 issued, the tape records 1"]
        assert got["restored"]


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_step(dp2sp2):
    """At (2, 2) with ZeRO-1, SIGTERM reaches rank 1 alone during step 0:
    every rank stops after step 0 and joins the final save (ZeRO-1's
    gather), which writes step 1; the resumed run's losses are the
    uninterrupted run's within 1e-5."""
    _, _, ranks, _ = dp2sp2
    full = ranks[0]["ckpt_full"]
    steps = list(range(1, R.CKPT_TOTAL))
    for r in ranks:
        assert r["sigterm_steps"] == [0]
        assert r["sigterm_ckpts"] == [1]
        assert sorted(r["sigterm_resumed"]) == steps
        np.testing.assert_allclose([r["sigterm_resumed"][s] for s in steps],
                                   [full[s] for s in steps],
                                   rtol=TOL_RESUME, atol=TOL_RESUME)


def test_failed_write_on_rank_0_raises_on_every_rank(dp2sp2):
    """At (2, 2) with ZeRO-1, every checkpoint write of rank 0 fails:
    rank 0 raises its OSError and the other ranks a RuntimeError at the
    same step, so no rank waits in a gather the others never reach (the
    spawn ends within its time limit)."""
    _, _, ranks, _ = dp2sp2
    assert [r["write_failure"] for r in ranks] == \
        ["OSError"] + ["RuntimeError"] * (len(ranks) - 1)


@pytest.mark.parametrize("cell", ["dp2sp2_at_dp2sp1", "dp1sp2_on_dev1",
                                  "dev1_at_dp1sp2"])
def test_checkpoint_resumes_on_another_layout(ssm, dp2sp2, cell):
    """``train()`` checkpoints at step 2 of a guarded run, resumed to step
    4 on another layout: written at (2, 2) with ZeRO-1 (the data ranks'
    moment slices gathered) and resumed at (2, 1); written at (1, 2) and
    resumed on one device; written on one device and resumed at (1, 2).
    The resumed steps' losses are within 1e-5 of the uninterrupted runs'
    of both layouts."""
    ranks, local, _ = ssm
    dp2sp2_full = dp2sp2[2][0]["ckpt_full"]
    if cell == "dp2sp2_at_dp2sp1":
        resumed = [r["resume_dp2sp2_at_dp2sp1"] for r in ranks]
        wants = [dp2sp2_full]
    elif cell == "dp1sp2_on_dev1":
        resumed = [local["resume_dp1sp2_on_dev1"]]
        wants = [ranks[0]["ckpt_full"], local["ckpt_full"]]
    else:
        resumed = [r["resume_dev1_at_dp1sp2"] for r in ranks]
        wants = [local["ckpt_full"], ranks[0]["ckpt_full"]]
    steps = list(range(R.CKPT_STEPS, R.CKPT_TOTAL))
    for got in resumed:
        assert sorted(got) == steps, "must resume from the checkpoint"
        for want in wants:
            np.testing.assert_allclose([got[s] for s in steps],
                                       [want[s] for s in steps],
                                       rtol=TOL_RESUME, atol=TOL_RESUME)


def test_zero1_degree_change_raises_in_both_packages(ref, dp2sp2,
                                                     ckpt_root):
    """A checkpoint written at (2, 2) with ZeRO-1 onto another ZeRO-1
    degree: with no ZeRO-1 (the moments a tree, not flat) both packages
    raise ``CheckpointError`` (missing paths); at degree 3 (another padded
    length) both raise ``ValueError`` (a shape); at degree 4 (the same
    padded length) both restore, each rank its slice."""
    import torch
    from repro_torch.checkpoint.manager import (CheckpointManager,
                                                zero1_shards)
    from repro_torch.train.step import state_from_params
    with np.load(ref) as npz:
        want = {k: str(npz[f"zero1/{k}"]) for k in ("tree", "padded",
                                                    "same")}
    assert want == {"tree": "CheckpointError", "padded": "ValueError",
                    "same": "restored"}
    mgr = CheckpointManager(str(ckpt_root / "dp2sp2"))
    step = mgr.latest_step()
    run = RunConfig(**R.RUN, guard=True)
    full = mgr.restore(step, {"opt": {"m": torch.zeros(
        2 * state_from_params(R._params(str(ref), "cpu"), 2)["opt"].m
        .numel())}})["opt"]["m"]
    for name, dp in (("tree", 1), ("padded", 3), ("same", 4)):
        state = state_from_params(R._params(str(ref), "cpu"), dp, run)
        shards = zero1_shards(state, TrainingGroups(dp, 1, dp - 1, 0, None,
                                                    None, None))
        try:
            mgr.restore(step, state, shards=shards)
            got = "restored"
        except Exception as e:      # noqa: BLE001 — the type is the check
            got = type(e).__name__
        assert got == want[name], name
        if got == "restored":       # this rank's slice of the stored m
            n = state["opt"].m.numel()
            assert torch.equal(state["opt"].m, full[(dp - 1) * n:dp * n])


def test_run_config_fields_carry_the_reference_defaults():
    """Every field of the port's RunConfig, the SP and ZeRO-1 knobs among
    them, exists in the reference's with the same default."""
    from repro.configs.base import RunConfig as JRunConfig
    want, got = JRunConfig(), RunConfig()
    for f in dataclasses.fields(RunConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7])
def test_zero1_pieces_match_reference(n_shards):
    """ZeRO-1's padded size and decay-mask count on the SMOKE params equal
    the reference's; the flat slice and mask of each shard cover the
    raveled params exactly once; one AdamW step on a shard equals the
    reference's ``zero1_update_shard`` (1e-6)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.models.weights import params_from_jax
    from repro_torch.optim import adamw
    jcfg = dataclasses.replace(j_get_smoke(R.ARCH), dtype="float32")
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             R.step_cfg(), device="cpu", dtype=torch.float32)
    padded = adamw.zero1_padded_size(params, n_shards)
    assert padded == jadamw.zero1_padded_size(jparams, n_shards)
    n = sum(p.numel() for _, p in leaves_with_paths(params))
    assert float(adamw.decay_mask(params).sum()) == float(
        jadamw.decay_mask(jparams).sum())
    shard = padded // n_shards
    flat = torch.cat([p.reshape(-1) for _, p in leaves_with_paths(params)])
    mask = adamw.decay_mask(params)
    for i in range(n_shards):
        lo, hi = i * shard, (i + 1) * shard
        got = adamw.flat_slice(params, lo, hi)
        assert torch.equal(got[:max(n - lo, 0)], flat[lo:hi])
        assert not got[max(n - lo, 0):].any()
        assert torch.equal(adamw.decay_mask(params, lo, hi)[:max(n - lo, 0)],
                           mask[lo:hi])
    rng = np.random.default_rng(0)
    g, m, v, p, d = (rng.standard_normal(64).astype(np.float32)
                     for _ in range(5))
    v, d = np.abs(v), (d > 0).astype(np.float32)
    want = jadamw.zero1_update_shard(*(jnp.asarray(x) for x in (g, m, v, p,
                                                               d)),
                                     jnp.asarray(3), lr=1e-3)
    mt, vt = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    new_p = adamw.zero1_update_shard(torch.from_numpy(g), mt, vt,
                                     torch.from_numpy(p), torch.from_numpy(d),
                                     3, lr=1e-3)
    for a, b in zip((new_p, mt, vt), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_sp_config_refuses_unknown_knob_values():
    """The overlap mode, the wire dtype and the strategy are checked when
    the split's spec is made, before any collective."""
    from repro_torch.comm.spec import CommSpec
    from repro_torch.core.lasp2 import SPConfig
    with pytest.raises(ValueError, match="overlap mode"):
        SPConfig(None, comm=CommSpec(overlap="ring"))
    with pytest.raises(ValueError, match="comm_dtype"):
        SPConfig(None, comm=CommSpec(dtype="fp8"))
    # a run's knobs fail when the run is made, whatever its layout
    with pytest.raises(ValueError, match="comm strategy"):
        RunConfig(comm_strategy="smoke")
    with pytest.raises(ValueError, match="overlap mode"):
        RunConfig(comm_overlap="ring")
    with pytest.raises(ValueError, match="comm_dtype"):
        RunConfig(comm_dtype="fp8")


def test_one_device_checkpoint_onto_a_zero1_layout_raises(tmp_path):
    """Checkpoints under a layout arrived with M9, and a multi-rank run no
    longer refuses a checkpoint directory; what it cannot restore it
    refuses before any collective: a one-device checkpoint (a tree of
    moments) restoring onto a ZeRO-1 layout (flat moment slices) raises
    ``CheckpointError`` for the missing paths, in the first try and in
    the fallback."""
    from repro_torch.checkpoint.manager import CheckpointError
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.loop import train
    cfg = R.step_cfg()
    run = RunConfig(total_steps=1, num_microbatches=1, remat="none")
    data = SyntheticLM(cfg.vocab_size, 8, 2)
    train(cfg, run, data, device="cpu", ckpt_dir=str(tmp_path),
          log_fn=lambda *_: None)
    layout = TrainingGroups(dp=2, sp=1, data_index=0, chunk_index=0,
                            sp_group=None, dp_group=None, world_group=None)
    logs = []
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        train(cfg, run, data, device="cpu", ckpt_dir=str(tmp_path),
              layout=layout, log_fn=logs.append)
    assert logs == ["[resume] checkpoint step 1 invalid (CheckpointError); "
                    "falling back"]


def test_train_cli_under_torchrun_with_sp_degree_2():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train
    --sp-degree 2 --device cpu``: two gloo ranks train and the loss
    falls."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--sp-degree", "2", "--steps", "20",
         "--seq", "64", "--batch", "4", "--lr", "1e-3"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("over 20 steps (improved)") == 1, out.stdout


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_train_cli_under_torchrun_with_comm_strategy(strategy):
    """``--comm-strategy ring`` and ``ulysses`` under torchrun with
    ``--sp-degree 2 --device cpu``: the loss falls (SMOKE is all linear,
    so "ulysses" exchanges as "allgather")."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--sp-degree", "2", "--steps", "20",
         "--seq", "64", "--batch", "4", "--lr", "1e-3", "--comm-strategy",
         strategy],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("over 20 steps (improved)") == 1, out.stdout


# ---------------------------------------------------------------------------
# The reference side (run as a script, in its own process).
# ---------------------------------------------------------------------------

def _jax_reference(path):
    import jax

    from repro.comm import primitives as jprim
    from repro.comm.spec import CommSpec
    from repro.configs import get_smoke
    from repro.configs.base import LayerSpec
    from repro.configs.base import RunConfig as JRunConfig
    from repro.data.pipeline import SyntheticLM
    from repro.launch.mesh import make_training_mesh
    from repro.sharding.rules import make_plan
    from repro.train.step import init_state, make_train_step

    smoke = dataclasses.replace(get_smoke(R.ARCH), dtype="float32")
    hybrid = R.hybrid_step_cfg(get_smoke(R.ARCH), LayerSpec)
    run = JRunConfig(**R.RUN)
    data = SyntheticLM(smoke.vocab_size, R.DATA["seq_len"],
                       R.DATA["global_batch"], seed=R.DATA["seed"])
    out = {}
    cells = [(dp, sp, "", "allgather") for dp, sp in R.STEP_LAYOUTS] + [
        (1, 4, "faithful_", "allgather"), (1, 4, "ring_", "ring"),
        (2, 2, "ulysses_", "ulysses")]
    for dp, sp, kind, strategy in cells:
        cfg = hybrid if strategy == "ulysses" else smoke
        plan = make_plan(make_training_mesh(dp, sp), "train",
                         global_batch=R.DATA["global_batch"],
                         n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                         zero1=True, comm=CommSpec(strategy=strategy,
                                                   dtype="fp32"))
        state = init_state(jax.random.PRNGKey(0), cfg, run, plan)
        prefix = "hparam" if cfg is hybrid else "param"
        if not any(k.startswith(f"{prefix}/") for k in out):
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                    state["params"])[0]:
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in p)
                out[f"{prefix}/{key}"] = np.asarray(leaf)
        step = jax.jit(make_train_step(cfg, run, plan))
        losses = []
        for i in range(R.N_STEPS):
            batch = data.microbatched(i, run.num_microbatches)
            if kind == "faithful_":
                batch.pop("resets")
            with jprim.tape() as rec:       # records while jit traces
                state, m = step(state, batch)
            if i == 0:
                out[f"dp{dp}sp{sp}/{kind}tape"] = np.array(
                    R.tape_rows(rec))
            losses.append(float(m["loss"]))
        out[f"dp{dp}sp{sp}/{kind}loss"] = np.array(losses)
    _jax_guard_reference(out, smoke, data)
    _jax_ssm_reference(out)
    np.savez(path, **out)


def _jax_guard_reference(out, cfg, data):
    """The guarded manual step at (2, 2) with NaN gradients at step
    ``R.GUARD_NAN_STEP``: losses, the guard's metrics and the first
    step's tape; then its state saved and restored onto ZeRO-1 degree 1
    (1, 4), 3 (3, 1) and 4 (4, 1): the error type or "restored"."""
    import tempfile

    import jax

    from repro.checkpoint.manager import CheckpointManager
    from repro.comm import primitives as jprim
    from repro.comm.spec import CommSpec
    from repro.configs.base import RunConfig as JRunConfig
    from repro.launch.mesh import make_training_mesh
    from repro.sharding.rules import make_plan
    from repro.train.step import init_state, make_train_step

    run = JRunConfig(**R.RUN, guard=True,
                     chaos_nan_steps=(R.GUARD_NAN_STEP,))

    def plan(dp, sp):
        mesh = make_training_mesh(dp, sp, devices=jax.devices()[:dp * sp])
        return make_plan(mesh, "train", global_batch=R.DATA["global_batch"],
                         n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                         zero1=True, comm=CommSpec(dtype="fp32"))

    state = init_state(jax.random.PRNGKey(0), cfg, run, plan(2, 2))
    step = jax.jit(make_train_step(cfg, run, plan(2, 2)))
    losses, metrics = [], []
    for i in range(R.N_STEPS):
        with jprim.tape() as rec:       # records while jit traces
            state, m = step(state, data.microbatched(
                i, run.num_microbatches))
        if i == 0:
            out["guard/tape"] = np.array(R.tape_rows(rec))
        losses.append(float(m["loss"]))
        metrics.append([float(m[k]) for k in R.GUARD_KEYS])
    out["guard/loss"] = np.array(losses)
    out["guard/metrics"] = np.array(metrics)
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, state)
        for name, (dp, sp) in (("tree", (1, 4)), ("padded", (3, 1)),
                               ("same", (4, 1))):
            target = init_state(jax.random.PRNGKey(0), cfg, run, plan(dp, sp))
            try:
                mgr.restore(1, target)
                out[f"zero1/{name}"] = np.array("restored")
            except Exception as e:    # noqa: BLE001 — the type is recorded
                out[f"zero1/{name}"] = np.array(type(e).__name__)


def _jax_ssm_reference(out):
    """The SSM family's SMOKE models at (1, 2) under the manual DP×SP step
    and on one device (``local_plan``): N_STEPS losses and grad norms
    each, the tape of the first (1, 2) step, the initial params."""
    import jax

    from repro.comm import primitives as jprim
    from repro.comm.spec import CommSpec
    from repro.configs import get_smoke
    from repro.configs.base import RunConfig as JRunConfig
    from repro.data.pipeline import SyntheticLM
    from repro.launch.mesh import make_training_mesh
    from repro.sharding.rules import local_plan, make_plan
    from repro.train.step import init_state, make_train_step

    run = JRunConfig(**R.RUN)
    for arch in R.SSM_ARCHS + R.ZOO_ARCHS:
        cfg = R.ssm_step_cfg(arch, get_smoke)
        data = SyntheticLM(cfg.vocab_size, R.DATA["seq_len"],
                           R.DATA["global_batch"], seed=R.DATA["seed"])
        mesh = make_training_mesh(1, 2, devices=jax.devices()[:2])
        plans = {"sp": make_plan(mesh, "train",
                                 global_batch=R.DATA["global_batch"],
                                 n_kv_heads=cfg.n_kv_heads,
                                 n_heads=cfg.n_heads, zero1=True,
                                 comm=CommSpec(dtype="fp32")),
                 "local": local_plan()}
        for where, plan in plans.items():
            state = init_state(jax.random.PRNGKey(0), cfg, run, plan)
            if where == "local":
                for p, leaf in jax.tree_util.tree_flatten_with_path(
                        state["params"])[0]:
                    key = "/".join(str(getattr(k, "key", getattr(
                        k, "idx", k))) for k in p)
                    out[f"{R.SSM_PREFIX[arch]}{key}"] = np.asarray(leaf)
            step = jax.jit(make_train_step(cfg, run, plan))
            losses, gnorms = [], []
            for i in range(R.N_STEPS):
                with jprim.tape() as rec:       # records while jit traces
                    state, m = step(state, data.microbatched(
                        i, run.num_microbatches))
                if i == 0 and where == "sp":
                    out[f"ssm/{arch}/tape"] = np.array(R.tape_rows(rec))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            out[f"ssm/{arch}/{where}/loss"] = np.array(losses)
            out[f"ssm/{arch}/{where}/gnorm"] = np.array(gnorms)
    # MoE under the manual step: the reference refuses it while tracing
    cfg = R.ssm_step_cfg("moonshot-v1-16b-a3b", get_smoke)
    mesh = make_training_mesh(1, 2, devices=jax.devices()[:2])
    plan = make_plan(mesh, "train", global_batch=R.DATA["global_batch"],
                     n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                     zero1=True, comm=CommSpec(dtype="fp32"))
    state = init_state(jax.random.PRNGKey(0), cfg, run, plan)
    data = SyntheticLM(cfg.vocab_size, R.DATA["seq_len"],
                       R.DATA["global_batch"], seed=R.DATA["seed"])
    try:
        jax.jit(make_train_step(cfg, run, plan))(
            state, data.microbatched(0, run.num_microbatches))
        out["moe/ref_error"] = np.array("none: the step ran")
    except Exception as e:            # noqa: BLE001 — recorded, then held
        out["moe/ref_error"] = np.array(f"{type(e).__name__}: {e}"[:400])


if __name__ == "__main__":
    if sys.argv[1:2] != ["--jax-reference"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_sp_step.py --jax-reference "
                         "OUT.npz")
    _jax_reference(sys.argv[2])
