"""Port vs reference: LASP-2 and LASP-2H sequence parallelism, layer by
layer, on gloo ranks.

The reference's sharded ``lasp2`` (both backwards; no decay, decay, and
decay with document resets; causal and bidirectional),
``lasp2_with_state`` and ``allgather_context_attention`` run on sp meshes
of 2 and 4 virtual CPU devices in one subprocess started from this file
(``python tests/test_torch_lasp2_sp.py --jax-reference out.npz``, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` as
``tests/test_distributed.py`` sets it), which writes every result into one
npz. The port runs the same seeded numpy inputs (``torch_sp_ranks``) on 2
and 4 gloo ranks (``launch.mesh.run_ranks``), each rank its sequence
chunk, through the plain versions of the kernels. Tolerances are the
reference's kernel tests' (``tests/test_kernels.py:14-15``): outputs and
states 3e-4, gradients 1e-3. Tapes: the reference records at trace
time, the port at call time; the port also records each all-gather's
backward reduce-scatter (tag ``<tag>.bwd``), which the reference's
autodiff emits without a record, so those are compared apart.

The same ranks then run three SMOKE-width models under SP from the
reference's params (``torch_sp_ranks.MODEL_CASES``): GLA on packed rows
and Table 3's bidirectional elu1 and softmax models, held to the port's
one-device run and to the reference's one-device ``value_and_grad``.
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
OUT_TOL, GRAD_TOL = 3e-4, 1e-3


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """The reference's results and the model cases' initial params (one
    subprocess for the file)."""
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
def ref(ref_path):
    with np.load(ref_path) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture(scope="module", params=R.WORLDS, ids=lambda w: f"W{w}")
def port(request, ref_path):
    """The port's results at W ranks: outputs and gradients concatenated
    over the ranks' chunks, and each rank's tapes; the model cases from
    the reference's params."""
    w = request.param
    return w, run_ranks(R.layer_rank, w, args=(str(ref_path),),
                        timeout_s=300)


def _cat(ranks, name, key, i=None, axis=2):
    parts = [r[name][key] if i is None else r[name][key][i] for r in ranks]
    return np.concatenate(parts, axis=axis)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _fwd_tape(rows):
    """A port tape without the backward reduce-scatters of its gathers."""
    return [r for r in rows if not r.split("|")[1].endswith(".bwd")]


def _rows(arr):
    return [str(x) for x in arr]


@pytest.mark.parametrize("name,causal,la,bwd", R.LINEAR_CASES,
                         ids=[c[0] for c in R.LINEAR_CASES])
def test_lasp2_matches_reference(ref, port, name, causal, la, bwd):
    """Outputs (3e-4) and the gradients of sum(sin(o)) wrt q, k, v (1e-3)
    and, on the autodiff path, wrt log_a (1e-3, resets included); the
    faithful path's log_a gradient is zero, as the reference's. The tape
    of forward and backward equals the reference's."""
    w, ranks = port
    key = f"W{w}/{name}"
    _close(_cat(ranks, name, "o"), ref[f"{key}/o"], OUT_TOL, f"{key} o")
    for i, n in enumerate("qkv"):
        _close(_cat(ranks, name, "grads", i), ref[f"{key}/d{n}"], GRAD_TOL,
               f"{key} d{n}")
    if la != "none":
        dla = _cat(ranks, name, "grads", 3, axis=2)
        if bwd == "faithful":
            assert not dla.any() and not ref[f"{key}/dla"].any()
        else:
            _close(dla, ref[f"{key}/dla"], GRAD_TOL, f"{key} dlog_a")
    for r in ranks:
        assert _fwd_tape(r[name]["tape"]) == _rows(ref[f"{key}/tape"])


def test_lasp2_tape_is_one_state_gather_each_way(port):
    """Causal LASP-2: exactly one forward all-gather of the packed M‖A,
    (B·H·(dk·dv + 1)·4 bytes); then the faithful backward's one all-gather
    of dM, or the autodiff backward's one reduce-scatter of the gathered
    cotangent (W times the payload)."""
    w, ranks = port
    packed = R.B * R.H * (R.DK * R.DV + 1) * 4
    for r in ranks:
        assert r["causal_decay_faithful"]["tape"] == [
            f"all-gather|lasp2.states|{packed}",
            f"all-gather|lasp2.dstates|{R.B * R.H * R.DK * R.DV * 4}"]
        assert r["causal_resets_autodiff"]["tape"] == [
            f"all-gather|lasp2.states|{packed}",
            f"reduce-scatter|lasp2.states.bwd|{w * packed}"]


def test_state_payload_does_not_grow_with_sequence(port):
    """The paper's claim: the forward exchange's bytes are the same at
    S 512 and 2048 (one all-gather of B·H·(dk·dv + 1) fp32)."""
    _, ranks = port
    want = [f"all-gather|lasp2.states|{2 * (16 * 16 + 1) * 4}"]
    for r in ranks:
        assert [r["payload"][s] for s in R.PAYLOAD_SEQS] == [want, want]


def test_overlap_none_is_bitwise_overlap(port):
    """The scheduler orders the exchange against the intra-chunk kernel;
    the values are the same to the bit."""
    _, ranks = port
    for r in ranks:
        a, b = r["causal_decay_faithful"], r["overlap_none"]
        np.testing.assert_array_equal(a["o"], b["o"])
        for x, y in zip(a["grads"], b["grads"]):
            np.testing.assert_array_equal(x, y)
        assert a["tape"] == b["tape"]


def test_lasp2_with_state_matches_reference(ref, port):
    """Prefill under SP: outputs and the global end state (the same on
    every rank), 3e-4."""
    w, ranks = port
    key = f"W{w}/with_state"
    _close(_cat(ranks, "with_state", "o"), ref[f"{key}/o"], OUT_TOL, key)
    for r in ranks:
        _close(r["with_state"]["state"], ref[f"{key}/state"], OUT_TOL, key)
        assert r["with_state"]["tape"] == _rows(ref[f"{key}/tape"])


@pytest.mark.parametrize("name,causal,window", R.ATTN_CASES,
                         ids=[c[0] for c in R.ATTN_CASES])
def test_allgather_context_attention_matches_reference(ref, port, name,
                                                       causal, window):
    """LASP-2H (Alg. 7), GQA 4:2: outputs 3e-4, gradients of sum(sin(o))
    wrt q, k, v 1e-3; one all-gather each of K and V forward, and their
    reduce-scatters backward."""
    w, ranks = port
    key = f"W{w}/{name}"
    _close(_cat(ranks, name, "o"), ref[f"{key}/o"], OUT_TOL, f"{key} o")
    for i, n in enumerate("qkv"):
        _close(_cat(ranks, name, "grads", i), ref[f"{key}/d{n}"], GRAD_TOL,
               f"{key} d{n}")
    kv = R.B * R.HKV * (R.S // w) * R.DH * 4
    for r in ranks:
        assert _fwd_tape(r[name]["tape"]) == _rows(ref[f"{key}/tape"]) == [
            f"all-gather|lasp2h.k|{kv}", f"all-gather|lasp2h.v|{kv}"]
        assert sorted(r[name]["tape"]) == sorted(
            _rows(ref[f"{key}/tape"]) + [
                f"reduce-scatter|lasp2h.k.bwd|{w * kv}",
                f"reduce-scatter|lasp2h.v.bwd|{w * kv}"])


@pytest.mark.parametrize("t", range(4))
def test_combines_match_reference(t):
    """The gathered-state combines around the exchange (Alg. 2 line 9,
    Alg. 4 line 9) against the reference's, with a reset inside chunk 1
    (the where-masked exponent keeps every weight finite): 1e-6."""
    import jax.numpy as jnp
    import torch
    from repro.core import linear_attention as jla
    from repro_torch.core import linear_attention as tla
    rng = np.random.default_rng(t)
    ms = rng.standard_normal((4, 2, 3, 8, 8)).astype(np.float32)
    las = (-np.abs(rng.standard_normal((4, 2, 3))) * 0.5).astype(np.float32)
    las[1, 0, 1] = tla.RESET_LOG_A
    cum = np.cumsum(las, axis=0)
    for port, ref in ((tla.prefix_state_combine, jla.prefix_state_combine),
                      (tla.suffix_grad_combine, jla.suffix_grad_combine)):
        got = port(torch.from_numpy(ms), torch.from_numpy(cum), t)
        want = ref(jnp.asarray(ms), jnp.asarray(cum), t)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_tape_summary_and_wire_dtype_match_reference():
    """The tape's totals per op (the reference's keys and values on the
    same records) and the wire-dtype table."""
    import jax.numpy as jnp
    import torch
    from repro.comm import primitives as jprim
    from repro_torch.comm import primitives as tprim
    rows = [("all-gather", 100, 300, 1, 4, "lasp2.states"),
            ("reduce-scatter", 400, 300, 1, 4, "lasp2.states.bwd"),
            ("all-reduce", 80, 120, 1, 4, "train.grads"),
            ("all-gather", 100, 300, 1, 4, "lasp2.states")]
    assert tprim.tape_summary([tprim.CommRecord(*r) for r in rows]) == \
        jprim.tape_summary([jprim.CommRecord(*r) for r in rows])
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16),
                           (None, jnp.float32, torch.float32)):
        assert jprim.wire_dtype(name) == jdt and \
            tprim.wire_dtype(name) == tdt
    with pytest.raises(ValueError, match="comm_dtype"):
        tprim.wire_dtype("fp8")


# ---------------------------------------------------------------------------
# Model level: GLA and the bidirectional pair under sequence parallelism.
# ---------------------------------------------------------------------------

def _close_grads(got, want, scale, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        _close(got[key] * scale, want[key], GRAD_TOL, f"{what} {key}")


@pytest.mark.parametrize("case,causal", R.MODEL_CASES,
                         ids=[c[0] for c in R.MODEL_CASES])
def test_model_under_sp_matches_one_device(ref, port, case, causal):
    """The model forward on each rank's chunk (GLA on packed rows with
    ``wdt``'s gate; the elu1 and softmax models with ``causal=False``):
    logits concatenated over the ranks within 3e-4, and the mean CE's
    gradients (the ranks' parts summed, over the global label count)
    within 1e-3, of the port's one-device run and of the reference's
    one-device ``value_and_grad``."""
    w, ranks = port
    parts = [r["models"][case] for r in ranks]
    one = parts[0]["one_device"]
    logits = np.concatenate([p["logits"] for p in parts], axis=1)
    n = sum(p["n"] for p in parts)
    assert n == one["n"] > 0
    grads = {k: sum(p["grads"][k] for p in parts) for k in one["grads"]}
    for what, want_logits, want_grads in (
            ("one device", one["logits"],
             {k: g / n for k, g in one["grads"].items()}),
            ("reference", ref[f"model/{case}/logits"],
             {k[len(f"model/{case}/grad/"):]: ref[k] for k in ref
              if k.startswith(f"model/{case}/grad/")})):
        _close(logits, want_logits, OUT_TOL, f"W{w} {case} logits vs {what}")
        _close_grads(grads, want_grads, 1.0 / n,
                     f"W{w} {case} grads vs {what}")
    np.testing.assert_allclose(sum(p["ce"] for p in parts) / n,
                               float(ref[f"model/{case}/loss"]),
                               rtol=GRAD_TOL)
    if case == "gla":
        assert any(k.endswith("mixer/wdt") for k in grads)
        assert all(np.abs(g).max() > 0 for k, g in grads.items()
                   if k.endswith("mixer/wdt"))


def test_model_under_sp_tapes(port):
    """Per layer, what each model case exchanges: GLA the causal state
    gather and (autodiff) its reduce-scatter; the bidirectional linear
    model Alg. 1's gather of K^T V and Alg. 3's gather of dM (the faithful
    backward, no resets); the softmax model its K and V gathers and their
    reduce-scatters. ShardedStep's GLA gradients equal the summed ranks'
    over the label count (1e-6)."""
    w, ranks = port
    layers = 2
    want = {"gla": {"all-gather|lasp2.states": layers,
                    "reduce-scatter|lasp2.states.bwd": layers},
            "bidir_linear": {"all-gather|lasp2.noncausal": layers,
                             "reduce-scatter|lasp2.noncausal.bwd": 0,
                             "all-gather|lasp2.nc.dstates": layers},
            "bidir_softmax": {"all-gather|lasp2h.k": layers,
                              "all-gather|lasp2h.v": layers,
                              "reduce-scatter|lasp2h.k.bwd": layers,
                              "reduce-scatter|lasp2h.v.bwd": layers}}
    for r in ranks:
        for case, counts in want.items():
            ops = ["|".join(row.split("|")[:2])
                   for row in r["models"][case]["tape"]]
            assert {k: ops.count(k) for k in counts} == counts, (case, ops)
            assert len(ops) == sum(counts.values()), (case, ops)
    parts = [r["models"]["gla"] for r in ranks]
    n = sum(p["n"] for p in parts)
    summed = {k: sum(p["grads"][k] for p in parts) / n
              for k in parts[0]["grads"]}
    for r in ranks:
        for k, g in r["models"]["gla"]["sharded_grads"].items():
            np.testing.assert_allclose(g, summed[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The reference side (run as a script, in its own process).
# ---------------------------------------------------------------------------

def _jax_reference(path):
    import jax
    import jax.numpy as jnp

    from repro.comm import primitives as jprim
    from repro.core.lasp2 import SPConfig, lasp2, lasp2_with_state
    from repro.core.lasp2h import allgather_context_attention
    from repro.launch.mesh import make_sp_mesh

    assert jax.device_count() >= max(R.WORLDS), jax.devices()
    ins = {k: jnp.asarray(v) for k, v in R.layer_inputs().items()}
    out = {}

    def run(key, fn, args):
        def fwd_bwd(*a):
            o, pull = jax.vjp(fn, *a)
            return o, pull(jnp.cos(o))

        with jprim.tape() as rec:      # records while jit traces
            o, grads = jax.jit(fwd_bwd)(*args)
        out[f"{key}/o"] = np.asarray(o)
        out[f"{key}/tape"] = np.array(R.tape_rows(rec))
        return grads

    for w in R.WORLDS:
        sp = SPConfig(mesh=make_sp_mesh(w))
        for name, causal, la, bwd in R.LINEAR_CASES:
            key = f"W{w}/{name}"
            args = [ins["q"], ins["k"], ins["v"]]
            if la != "none":
                args.append(ins[la])
            grads = run(key, lambda *a, c=causal, b=bwd: lasp2(
                *a, sp=sp, causal=c, backward=b), args)
            for n, g in zip(("dq", "dk", "dv", "dla"), grads):
                out[f"{key}/{n}"] = np.asarray(g)
        key = f"W{w}/with_state"
        with jprim.tape() as rec:
            o, st = jax.jit(lambda *a: lasp2_with_state(*a, sp=sp))(
                ins["q"], ins["k"], ins["v"], ins["decay"])
        out[f"{key}/o"], out[f"{key}/state"] = np.asarray(o), np.asarray(st)
        out[f"{key}/tape"] = np.array(R.tape_rows(rec))
        for name, causal, window in R.ATTN_CASES:
            key = f"W{w}/{name}"
            grads = run(key, lambda *a, c=causal, win=window:
                        allgather_context_attention(
                            *a, sp=sp, causal=c, sliding_window=win),
                        [ins["qs"], ins["ks"], ins["vs"]])
            for n, g in zip(("dq", "dk", "dv"), grads):
                out[f"{key}/{n}"] = np.asarray(g)
    _jax_model_reference(out)
    np.savez(path, **out)


def _jax_model_reference(out):
    """The model cases on one device: initial params (``mp_<case>/``),
    logits, the mean CE and its gradients."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base
    from repro.models import model as JM

    def keyed(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in p): np.asarray(leaf)
                for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    for i, (case, causal) in enumerate(R.MODEL_CASES):
        cfg = R.model_cfg(case, base)
        params = JM.init_params(jax.random.PRNGKey(10 + i), cfg)
        batch = {k: jnp.asarray(v) for k, v in R.model_batch(case).items()}

        def loss(p):
            logits, _ = JM.forward(p, batch["tokens"], cfg, remat="none",
                                   resets=batch.get("resets"), causal=causal)
            return JM.lm_loss(logits, batch["labels"]), logits

        (val, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
        out[f"model/{case}/logits"] = np.asarray(logits)[
            ..., :cfg.vocab_size]
        out[f"model/{case}/loss"] = np.asarray(val)
        for k, v in keyed(params).items():
            out[f"mp_{case}/{k}"] = v
        for k, v in keyed(grads).items():
            out[f"model/{case}/grad/{k}"] = v


if __name__ == "__main__":
    if sys.argv[1:2] != ["--jax-reference"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_lasp2_sp.py --jax-reference "
                         "OUT.npz")
    _jax_reference(sys.argv[2])
