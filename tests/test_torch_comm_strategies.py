"""Port vs reference: the exchange strategies of LASP-2 layers, Ulysses
context attention and the paper's SP baselines, on gloo ranks.

The reference's sharded ``lasp2`` under the "allgather", "ring" and
"pipelined" strategies (fp32 and bf16 wires; no decay, decay, and decay
with document resets), its ``ulysses_context_attention`` (GQA 8:4,
causal, a window, a bf16 wire) and its ``lasp1``, ``ring_attention`` and
``megatron_sp_attention`` run on sp meshes of 2 and 4 virtual CPU devices
in one subprocess started from this file (``python
tests/test_torch_comm_strategies.py --jax-reference out.npz``), which
writes every result into one npz. The reference's ``lasp2`` maps
"ulysses" to "allgather" (``src/repro/core/lasp2.py:446-449``) and its
overlap modes give the same values, so the port's "ulysses" cases and
both of its overlap modes are held against the reference's result of the
same exchange. The port runs the same seeded numpy inputs
(``torch_sp_ranks``) on 2 and 4 gloo ranks, each rank its sequence chunk,
through the plain versions of the kernels. Tolerances: the reference's
kernel tests' (``tests/test_kernels.py:14-15``) on an fp32 wire, outputs
3e-4 and gradients 1e-3; on a bf16 wire its bf16 check's 3e-2
(``tests/distributed_checks.py:254``). Tapes: the port records every hop
when it is made, the reference a loop's hops in one record, so they are
compared summed by op, tag and payload; the port also records the
backward of each all-gather and hop (tag ``<tag>.bwd``), which the
reference's autodiff emits without a record, so those are compared apart.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_sp_ranks as R
from repro_torch.launch.mesh import run_ranks

HERE = Path(__file__).resolve()
OUT_TOL, GRAD_TOL, BF16_TOL = 3e-4, 1e-3, 3e-2
LINEAR = [(s, o, w, la) for s in R.STRATEGIES for o in R.OVERLAPS
          for w in R.WIRES for la in R.DECAYS]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results (one subprocess for the file)."""
    out = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(HERE), "--jax-reference",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module", params=R.WORLDS, ids=lambda w: f"W{w}")
def port(request):
    """The port's results at W ranks, each rank's chunk and tapes."""
    w = request.param
    return w, run_ranks(R.strategies_rank, w, timeout_s=300)


def _cat(ranks, name, i=None):
    parts = [r[name]["o"] if i is None else r[name]["grads"][i]
             for r in ranks]
    return np.concatenate(parts, axis=2)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _split(rows):
    """(forward rows, backward rows) of a tape."""
    bwd = [r for r in rows if r.split("|")[1].endswith(".bwd")]
    return [r for r in rows if r not in bwd], bwd


def _check(ranks, ref, key, name, tol_o, tol_g):
    """Outputs and every gradient of ``name`` against the reference's
    ``key``; the forward tape's totals equal the reference's."""
    _close(_cat(ranks, name), ref[f"{key}/o"], tol_o, f"{key} o")
    for i in range(len(ranks[0][name]["grads"])):
        _close(_cat(ranks, name, i), ref[f"{key}/g{i}"], tol_g,
               f"{key} grad {i}")
    want = R.tape_totals([str(x) for x in ref[f"{key}/tape"]])
    for r in ranks:
        fwd, _ = _split(r[name]["tape"])
        got = R.tape_totals(fwd)
        assert got == {k: v for k, v in want.items()
                       if not k.split("|")[1].endswith(".bwd")}, key


@pytest.mark.parametrize("strategy,overlap,wire,la", LINEAR,
                         ids=[R.strategy_case(*c) for c in LINEAR])
def test_lasp2_strategy_matches_reference(ref, port, strategy, overlap, wire,
                                          la):
    """``lasp2`` under each strategy, overlap mode and wire: outputs and the
    gradients of sum(sin(o)) wrt q, k, v and log_a against the
    reference's, at the fp32 limits (3e-4, 1e-3) or the bf16 wire's
    (3e-2)."""
    w, ranks = port
    exchange = "allgather" if strategy == "ulysses" else strategy
    key = f"W{w}/{exchange}_{wire}_{la}"
    tol_o, tol_g = (OUT_TOL, GRAD_TOL) if wire == "fp32" \
        else (BF16_TOL, BF16_TOL)
    _check(ranks, ref, key, R.strategy_case(strategy, overlap, wire, la),
           tol_o, tol_g)


@pytest.mark.parametrize("wire", R.WIRES)
@pytest.mark.parametrize("strategy", ["ring", "pipelined"])
def test_ring_tapes_count_hops(port, strategy, wire):
    """The ring: W-1 permutes of the full fp32 state forward, 2(W-1) with
    the backward, no gather; the pipelined ring: k = 4 chains (dv 32) of
    W-1 permutes of a quarter of the state each way. A bf16 wire: the same
    counts, half the bytes."""
    w, ranks = port
    k = 1 if strategy == "ring" else 4
    state = R.B * R.H * R.DK * R.DV * (4 if wire == "fp32" else 2) // k
    for r in ranks:
        tape = r[R.strategy_case(strategy, "overlap", wire, "decay")]["tape"]
        fwd, bwd = _split(tape)
        assert len(fwd) == len(bwd) == k * (w - 1)
        assert {x.split("|")[0] for x in tape} == {"collective-permute"}
        assert {int(x.split("|")[2]) for x in tape} == {state}


def test_overlap_issues_the_exchange_before_the_kernel(port):
    """Under "overlap" the exchange is in flight when the intra-chunk
    kernel is called: the all-gather, or every ring chain's first hop (1
    for "ring", k = 4 for "pipelined"); under "none" nothing is issued
    before it."""
    _, ranks = port
    for r in ranks:
        assert r["issued"] == {
            "allgather_overlap": 1, "ring_overlap": 1,
            "pipelined_overlap": 4, "allgather_none": 0, "ring_none": 0,
            "pipelined_none": 0}


def test_ulysses_linear_layers_exchange_as_allgather(port):
    """On linear layers "ulysses" is the all-gather: the same tape as
    "allgather", and the same values to the bit."""
    _, ranks = port
    for r in ranks:
        for wire in R.WIRES:
            for la in R.DECAYS:
                a = r[R.strategy_case("allgather", "overlap", wire, la)]
                u = r[R.strategy_case("ulysses", "overlap", wire, la)]
                assert a["tape"] == u["tape"]
                np.testing.assert_array_equal(a["o"], u["o"])


@pytest.mark.parametrize("name,window,wire", R.ULYSSES_CASES,
                         ids=[c[0] for c in R.ULYSSES_CASES])
def test_ulysses_context_attention_matches_reference(ref, port, name, window,
                                                     wire):
    """Ulysses, GQA 8:4: outputs and the gradients wrt q, k, v against the
    reference's (fp32 limits, or 3e-2 on a bf16 wire); two all-to-alls
    forward (the packed q‖k‖v in, the output back) and their two mirrors
    backward, each as the reference records them; a bf16 wire halves the
    in-leg's bytes."""
    w, ranks = port
    key = f"W{w}/{name}"
    tol = (OUT_TOL, GRAD_TOL) if wire == "fp32" else (BF16_TOL, BF16_TOL)
    _check(ranks, ref, key, name, *tol)
    el = 4 if wire == "fp32" else 2
    qkv = R.B * (R.UHQ + 2 * R.UHKV) * (R.S // w) * R.DH * el
    out = R.B * R.UHQ * (R.S // w) * R.DH * 4
    for r in ranks:
        rows = [x.split("|") for x in r[name]["tape"]]
        assert [(op, tag, int(pb)) for op, tag, pb, _, _ in rows] == [
            ("all-to-all", "ulysses.in", qkv), ("all-to-all", "ulysses.out",
                                                out),
            ("all-to-all", "ulysses.out.bwd", out),
            ("all-to-all", "ulysses.in.bwd", qkv)]
        assert sorted(r[name]["tape"]) == sorted(
            str(x) for x in ref[f"{key}/tape"])


@pytest.mark.parametrize("name", ["lasp1_none", "lasp1_decay", "ring_attn",
                                  "megatron"])
def test_baseline_matches_reference(ref, port, name):
    """LASP-1 (without and with decay), Ring Attention and Megatron-SP
    (GQA 4:2, causal) against the reference's baselines: outputs 3e-4,
    gradients 1e-3, forward tape totals."""
    w, ranks = port
    _check(ranks, ref, f"W{w}/{name}", name, OUT_TOL, GRAD_TOL)


def test_baseline_tapes(port):
    """LASP-1: W-1 hops of the state forward, W-1 back. Ring Attention: W
    hops each of K and V forward (the last one's result unused, so W-1
    back). Megatron-SP: three tiled all-gathers of the whole sequence's
    q, k and v (traffic (W-1) × the chunk), their reduce-scatters back."""
    w, ranks = port
    state = R.B * R.H * R.DK * R.DV * 4
    kv = R.B * R.HKV * (R.S // w) * R.DH * 4
    q = R.B * R.HQ * (R.S // w) * R.DH * 4
    for r in ranks:
        for la in ("none", "decay"):
            fwd, bwd = _split(r[f"lasp1_{la}"]["tape"])
            assert fwd == [f"collective-permute|lasp1|{state}|{state}|1"] \
                * (w - 1)
            assert len(bwd) == w - 1
        fwd, bwd = _split(r["ring_attn"]["tape"])
        assert sorted(fwd) == sorted(
            [f"collective-permute|ring_attn.{t}|{kv}|{kv}|1"
             for t in "kv"] * w)
        assert len(bwd) == 2 * (w - 1)
        fwd, bwd = _split(r["megatron"]["tape"])
        assert fwd == [f"all-gather|megatron.q|{q}|{(w - 1) * q}|1",
                       f"all-gather|megatron.k|{kv}|{(w - 1) * kv}|1",
                       f"all-gather|megatron.v|{kv}|{(w - 1) * kv}|1"]
        assert sorted(x.split("|")[1] for x in bwd) == [
            "megatron.k.bwd", "megatron.q.bwd", "megatron.v.bwd"]


def test_ring_strategies_are_causal_only(port):
    """``causal=False`` under "ring" or "pipelined" raises, as the
    reference's ``lasp2`` does: the bidirectional form needs the total
    state, not a prefix."""
    _, ranks = port
    for r in ranks:
        for strategy in ("ring", "pipelined"):
            assert "causal-only" in r["errors"][strategy]


def test_strategy_names_and_heads_are_checked():
    """An unknown strategy raises when the spec is made (the reference's
    message and registry order); Ulysses refuses head counts that do not
    split over the ranks, kv heads first under GQA, and the DP×SP step
    refuses them before any collective; pack and unpack are inverse,
    block i holding q_i ‖ k_i ‖ v_i."""
    import dataclasses

    import torch
    from repro.comm.strategy import registered_strategies as jnames
    from repro_torch.comm.spec import CommSpec
    from repro_torch.comm.strategy import get_strategy, registered_strategies
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.lasp2h import (check_ulysses_heads, pack_ulysses,
                                         unpack_ulysses)
    from repro_torch.launch.mesh import TrainingGroups
    from repro_torch.train.step import ShardedStep
    assert registered_strategies() == jnames() == R.STRATEGIES
    for bad in ("smoke-signals", "Ring", ""):
        with pytest.raises(ValueError, match="unknown comm strategy"):
            CommSpec(strategy=bad)
        with pytest.raises(ValueError, match="unknown comm strategy"):
            get_strategy(bad)
    check_ulysses_heads(8, 4, 4)
    for hq, hkv in ((8, 2), (6, 4)):
        with pytest.raises(ValueError, match="divisible"):
            check_ulysses_heads(hq, hkv, 4)
    layout = TrainingGroups(dp=1, sp=4, data_index=0, chunk_index=0,
                            sp_group=None, dp_group=None, world_group=None)
    cfg = dataclasses.replace(R.hybrid_step_cfg(), n_kv_heads=2)
    with pytest.raises(ValueError, match="divisible"):
        ShardedStep(cfg, RunConfig(comm_strategy="ulysses"), layout)
    ShardedStep(cfg, RunConfig(comm_strategy="ring"), layout)
    q = torch.arange(2 * 8 * 3 * 2, dtype=torch.float32).reshape(2, 8, 3, 2)
    k, v = q[:, :4] + 1000, q[:, 4:] + 2000
    packed = pack_ulysses(q, k, v, 2)
    for i in range(2):
        block = packed[:, i * 8:(i + 1) * 8]
        for got, want in zip(unpack_ulysses(block, 8, 4, 2),
                             (q[:, 4 * i:4 * i + 4], k[:, 2 * i:2 * i + 2],
                              v[:, 2 * i:2 * i + 2])):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The reference side (run as a script, in its own process).
# ---------------------------------------------------------------------------

def _jax_reference(path):
    import jax
    import jax.numpy as jnp

    from repro.comm import primitives as jprim
    from repro.comm.spec import CommSpec
    from repro.core.baselines import lasp1, megatron_sp_attention, \
        ring_attention
    from repro.core.lasp2 import SPConfig, lasp2
    from repro.core.lasp2h import ulysses_context_attention
    from repro.launch.mesh import make_sp_mesh

    assert jax.device_count() >= max(R.WORLDS), jax.devices()
    ins = {k: jnp.asarray(v) for k, v in
           {**R.layer_inputs(), **R.ulysses_inputs()}.items()}
    out = {}

    def run(key, fn, names):
        def fwd_bwd(*a):
            o, pull = jax.vjp(fn, *a)
            return o, pull(jnp.cos(o))

        with jprim.tape() as rec:      # records while jit traces
            o, grads = jax.jit(fwd_bwd)(*[ins[n] for n in names])
        out[f"{key}/o"] = np.asarray(o)
        out[f"{key}/tape"] = np.array(R.full_rows(rec))
        for i, g in enumerate(grads):
            out[f"{key}/g{i}"] = np.asarray(g)

    for w in R.WORLDS:
        mesh = make_sp_mesh(w)
        sp = SPConfig(mesh=mesh)
        for strategy in ("allgather", "ring", "pipelined"):
            for wire in R.WIRES:
                comm = CommSpec(strategy=strategy, dtype=wire)
                for la in R.DECAYS:
                    names = "qkv" if la == "none" else ["q", "k", "v", la]
                    run(f"W{w}/{strategy}_{wire}_{la}",
                        lambda *a, c=comm: lasp2(*a, sp=sp, comm=c), names)
        for name, window, wire in R.ULYSSES_CASES:
            spu = SPConfig(mesh=mesh, comm=CommSpec(dtype=wire))
            run(f"W{w}/{name}", lambda *a, win=window, s=spu:
                ulysses_context_attention(*a, sp=s, sliding_window=win),
                ("qu", "ku", "vu"))
        for la in ("none", "decay"):
            names = "qkv" if la == "none" else ["q", "k", "v", la]
            run(f"W{w}/lasp1_{la}", lambda *a: lasp1(*a, sp=sp), names)
        run(f"W{w}/ring_attn", lambda *a: ring_attention(*a, sp=sp),
            ("qs", "ks", "vs"))
        run(f"W{w}/megatron", lambda *a: megatron_sp_attention(*a, sp=sp),
            ("qs", "ks", "vs"))
    np.savez(path, **out)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--jax-reference"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_comm_strategies.py "
                         "--jax-reference OUT.npz")
    _jax_reference(sys.argv[2])
