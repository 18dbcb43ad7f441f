"""Port vs reference: serving under a plan, on gloo ranks, at SMOKE size.

The reference runs in one subprocess started from this file (``python
tests/test_torch_serve_sp.py --jax-reference out.npz``) on 8 virtual CPU
devices: ``sharded_decode_attention`` and ``ring_decode_attention`` with
``sp`` over a 4-device sequence mesh (the first as
``tests/distributed_checks.py:325-335`` checks it), the dense + SP forward
of starcoder2-15b SMOKE under the prefill plan of the (4, 2) (data,
model) mesh (``distributed_checks.py:339-361``), ``M.prefill`` and
``M.decode_step`` under ``make_plan(mesh (4, 1), "prefill")`` for
linear-llama3-1b SMOKE (fp32 and bf16), its 1/4 hybrid and its GLA
variant, mamba2-2.7b and hymba-1.5b SMOKE and moonshot SMOKE at a
dropping capacity, granite-34b SMOKE under ``make_plan(mesh (1, 4),
"decode", n_kv_heads=1)``, the dropping MoE and whisper-base SMOKE under
the (1, 4) decode plan, a 3-head hybrid under the (2, 2) prefill plan's
batch-over-model branch, and ``ServeEngine(plan=)`` under both plans; it
writes every result, its tapes and its initial params into one npz.

The port runs the same inputs and params (``torch_serve_ranks``) on one
spawn of 4 gloo ranks and one of 8 (the (4, 2) forward). Tolerances:
the decode attentions 2e-4 (the reference check's), the bf16 forward
2e-2 (its check's), prefill and decode fp32 3e-4 and bf16 4e-2
(``tests/test_kernels.py:14-15``; rings are stored in bf16 in both
packages and take 4e-2; a bf16 model's states take
``tests/test_torch_models.py``'s 5e-2 relative plus 1e-2 of the tensor's
largest magnitude, an entry near zero being a sum of rounded products of
large terms), greedy tokens exact. Tapes: every rank's equals
the ``comm.budget`` of what it ran, and its rows (op, tag, payload) the
reference's, apart from the port's own (``PORT_ONLY_TAGS`` and the
placements' exchanges, ``PLACEMENT_TAGS``: what GSPMD moves without a
named primitive).

Every plan's placements are applied: a rank holds its shard of the
weights and of the cache, and its Σ ``nbytes`` of each equals the dry
run's ``memory_report`` for that plan. The same 4-rank spawn also runs
the (2, 2) (data, model) prefill and decode plans and the (1, 4) decode
plan (``torch_serve_ranks.PLACED``: FSDP over data, heads, kv heads, ff
and vocab over model, decode slots over data) on linear, its hybrid, GLA
and granite against the reference outputs above for the same params and
tokens (a plan does not change the function), mamba2 and hymba SMOKE
against the reference's prefill-plan outputs, a drop-free MoE SMOKE
against the port's one-device path, and the engines' greedy tokens
against the reference's engines. The pieces that compute on their shard
there are held to the reference under its own plans too: moonshot SMOKE
at capacity factor 1.0 (``moe_drop``: capacity t/4, items drop; the
reference's global dispatch under its (4, 1) prefill and (1, 4) decode
plans), whisper-base SMOKE (gates 0.5, its encoder frames from a seed)
under the (1, 4) decode plan, and the hybrid with 3 heads, which takes
the batch-over-model branch of the (2, 2) prefill plan (2 rows over
model, each rank prefilling its row).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_serve_ranks as R
from repro_torch.launch.mesh import run_ranks

HERE = Path(__file__).resolve()
TOL_DECODE = 2e-4
TOL_FWD_BF16 = 2e-2
TOL = {"float32": 3e-4, "bfloat16": 4e-2}
TOL_RING = 4e-2
STATE_SCALE_TOL_BF16 = (5e-2, 1e-2)


@pytest.fixture(scope="module")
def ref():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ref.npz"
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, str(HERE), "--jax-reference",
                               str(out)], env=env, capture_output=True,
                              text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        ranks = {4: run_ranks(R.serve_rank, 4, args=(str(out),),
                              timeout_s=600),
                 8: run_ranks(R.forward_rank, 8, args=(str(out),),
                              timeout_s=600)}
        with np.load(out) as npz:
            want = {k: npz[k] for k in npz.files
                    if not k.startswith("param/")}
    return want, ranks


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _rows(want, key):
    return sorted(str(x) for x in want[key])


def _fwd(rows, port_only=R.PORT_ONLY_TAGS):
    """Tape rows without the port's own: what the reference records."""
    return sorted(r for r in rows if r.split("|")[1] not in port_only
                  and not R.placed(r.split("|")[1]))


def _times(rows, factor):
    """Rows with every payload ``factor`` times as large."""
    out = []
    for r in rows:
        op, tag, nbytes = r.split("|")
        out.append(f"{op}|{tag}|{int(nbytes) * factor}")
    return sorted(out)


def _unplaced(rows):
    return sorted(r for r in rows if not R.placed(r.split("|")[1]))


@pytest.mark.parametrize("cache_len", R.CACHE_LENS)
def test_sharded_decode_attention_matches_reference(ref, cache_len):
    """A 512-slot cache sharded 4 ways at cache_len 512, 300 and 37 (the
    last leaves three shards fully masked): every rank's merged output
    within 2e-4 of the reference's ``sp=`` run and of its one-device run;
    the tape is the three ``decode.*`` gathers of the merge's budget."""
    want, ranks = ref
    for res in ranks[4]:
        got = res[f"decode/{cache_len}"]
        for key in ("sp", "local"):
            np.testing.assert_allclose(got, want[f"decode/{cache_len}/{key}"],
                                       rtol=TOL_DECODE, atol=TOL_DECODE)
        assert res[f"decode/{cache_len}/budget"] == []
        assert res[f"decode/{cache_len}/tape"] == _rows(
            want, f"decode/{cache_len}/tape")


def test_ring_decode_attention_matches_reference(ref):
    """A ragged 64-slot ring (wrapped rows, a row never filled past 20)
    with per-row query positions and a window of 40, its slots sharded 4
    ways: within 2e-4 of the reference's ``sp=`` run; tape rows
    ``ring_decode.o``, ``.m``, ``.l``, the reference's."""
    want, ranks = ref
    for res in ranks[4]:
        np.testing.assert_allclose(res["ring"], want["ring/sp"],
                                   rtol=TOL_DECODE, atol=TOL_DECODE)
        np.testing.assert_allclose(res["ring"], want["ring/local"],
                                   rtol=TOL_DECODE, atol=TOL_DECODE)
        assert res["ring/tape"] == _rows(want, "ring/tape")


def test_dense_sp_forward_under_prefill_plan_matches_reference(ref):
    """starcoder2-15b SMOKE (bf16) under the prefill plan of the (4, 2)
    layout: each rank's chunk of the logits, put back in sequence order,
    within 2e-2 of the reference's forward under the same plan (and of
    its one-device forward); the model axis's two ranks agree exactly.
    Each rank holds its shard of the weights (FSDP over 4, heads and
    vocab over 2), ``memory_report``'s bytes; its K/V gathers move its
    own kv heads, half the reference's payload."""
    want, ranks = ref
    chunks = {}
    for r, res in enumerate(ranks[8]):
        d, m = divmod(r, 2)
        assert res["places"] == {"DATA": (d, [m, 2 + m, 4 + m, 6 + m]),
                                 "MODEL": (m, [2 * d, 2 * d + 1])}
        _, t = res["index"]
        if t in chunks:
            np.testing.assert_array_equal(res["logits"], chunks[t])
        chunks[t] = res["logits"]
    got = np.concatenate([chunks[t] for t in range(4)], axis=1)
    v = want["starcoder/logits_sp"].shape[-1]
    for key in ("logits_sp", "logits_local"):
        np.testing.assert_allclose(got[..., :v], want[f"starcoder/{key}"],
                                   rtol=TOL_FWD_BF16, atol=TOL_FWD_BF16)
    # each model rank gathers its own kv heads: the reference's K/V
    # gathers see every head (its model axis is not manual there)
    assert _times(_fwd(ranks[8][0]["tape"]), 2) == _rows(want,
                                                         "starcoder/tape")
    for res in ranks[8]:
        held, report = res["held"]
        assert held == report, (held, report)


def _check_cache(got, want_prefix, want, tol):
    flat = _flat(got)
    keys = [k[len(want_prefix):] for k in want if k.startswith(want_prefix)]
    assert sorted(keys) == sorted(flat), (sorted(keys), sorted(flat))
    for key, arr in flat.items():
        w = want[want_prefix + key]
        if key.endswith("kpos") or key == "pos":
            np.testing.assert_array_equal(arr, w, err_msg=key)
        elif key.split("/")[-1] in ("k", "v"):
            np.testing.assert_allclose(arr, w, rtol=TOL_RING, atol=TOL_RING,
                                       err_msg=key)
        elif tol == TOL["bfloat16"]:
            rel, scale = STATE_SCALE_TOL_BF16
            np.testing.assert_allclose(
                arr, w, rtol=rel,
                atol=max(rel, scale * float(np.abs(w).max())), err_msg=key)
        else:
            np.testing.assert_allclose(arr, w, rtol=tol, atol=tol,
                                       err_msg=key)


def test_serving_groups_follow_the_reference_reshape(ref):
    """Rank r sits at the row-major multi-index of r over the layout's
    sizes (the reference's ``reshape`` of its devices); each axis's group
    lists its ranks in global order. A (data, sequence) layout takes its
    groups from ``make_training_groups``, and its train plan's SP config
    is the training layout's (chunk r % 2)."""
    _, ranks = ref
    for r, res in enumerate(ranks[4]):
        d, s = divmod(r, 2)
        assert res["places"] == {
            "prefill": {"DATA": (r, [0, 1, 2, 3]), "MODEL": (0, [r])},
            "decode": {"DATA": (0, [r]), "MODEL": (r, [0, 1, 2, 3])},
            "train": {"DATA": (d, [s, 2 + s]),
                      "SEQUENCE": (s, [2 * d, 2 * d + 1])}}
        assert res["train_plan"] == (2, s, s, d)


@pytest.mark.parametrize("name", R.PREFILL_CFGS)
def test_prefill_under_plan_matches_reference(ref, name):
    """``M.prefill(plan=)`` of 2 × 64 tokens split 4 ways, then 3 decode
    steps: every rank's last logits, every cache leaf (states, log decay,
    the rings gathered back from their 4 slices) and each step's logits
    against the reference's under its prefill plan. GLA's and SSD's log
    decays sum the gathered chunk decays (nonzero); the hybrid's 24-slot
    window ring and hymba's 128-slot rings are sliced 4 ways and merged
    at decode (under "ulysses" the hybrid's softmax layers take the two
    all-to-alls and its ring its own K/V gathers, ``ring.k``,
    ``ring.v``); mamba2's and hymba's convs start from the previous chunk's
    inputs (``mamba2.conv``), whose last rank's tails are the conv
    caches, as the reference's conv over the whole sequence gives."""
    want, ranks = ref
    tol = TOL["bfloat16" if name.endswith("bf16") else "float32"]
    for res in ranks[4]:
        np.testing.assert_allclose(res[f"prefill/{name}/logits"],
                                   want[f"prefill/{name}/logits"],
                                   rtol=tol, atol=tol)
        _check_cache(res[f"prefill/{name}/cache"],
                     f"prefill/{name}/cache/", want, tol)
        np.testing.assert_allclose(res[f"prefill/{name}/steps"],
                                   want[f"prefill/{name}/steps"],
                                   rtol=tol, atol=tol)
    if name == "gla":
        assert np.abs(want["prefill/gla/cache/layers/0/mixer/log_decay"]
                      ).min() > 0


def test_left_padded_prefill_splits_across_chunks(ref):
    """Two rows bucketed to 64 with 1 and 37 filler tokens: the reset at
    the first real token falls in chunk 0 and in chunk 2; logits, states
    and log decays match the reference's ``pad_lens`` prefill under its
    plan within 3e-4."""
    want, ranks = ref
    for res in ranks[4]:
        np.testing.assert_allclose(res["pad/logits"], want["pad/logits"],
                                   rtol=TOL["float32"], atol=TOL["float32"])
        _check_cache(res["pad/cache"], "pad/cache/", want, TOL["float32"])


def test_decode_plan_slices_the_ring_over_model(ref):
    """granite-34b SMOKE (MQA, 1 KV head) under the decode plan of the
    (1, 4) layout: the prompt prefills without SP (a tape of the TP
    placements' exchanges alone, its budget), the 128-slot ring is sliced
    4 ways over the model group, and 3 decode steps merge it (every q head
    gathered, ``tp.q``): logits and the gathered ring within the
    reference's; the decode tape is the budget and, without the
    placements' rows, the reference's."""
    want, ranks = ref
    for res in ranks[4]:
        assert res["dprefill/tape"] and all(
            R.placed(r.split("|")[1]) for r in res["dprefill/tape"])
        assert res["dprefill/budget"] == []
        np.testing.assert_allclose(res["dprefill/logits"],
                                   want["dprefill/logits"],
                                   rtol=TOL["float32"], atol=TOL["float32"])
        _check_cache(res["dprefill/cache"], "dprefill/cache/", want,
                     TOL["float32"])
        np.testing.assert_allclose(res["dprefill/steps"],
                                   want["dprefill/steps"],
                                   rtol=TOL["float32"], atol=TOL["float32"])
        assert res["dprefill/decode_budget"] == []
        assert _unplaced(res["dprefill/decode_tape"]) == _rows(
            want, "dprefill/decode_tape")


@pytest.mark.parametrize("name", ["linear", "hybrid", "granite"])
def test_engine_under_plan_matches_reference(ref, name):
    """``ServeEngine(plan=)``: three requests of 64, 32 and 31 tokens, 6
    greedy tokens each, equal to the reference's ``ServeEngine(plan=)``
    on every rank. Under the prefill plan the linear stack buckets 31 to
    32 and left-pads it across chunks, the hybrid prefills it locally (31
    does not divide 4); under the decode plan granite's ring is sliced.
    A rank holds a quarter of every sliced ring's K/V bytes."""
    want, ranks = ref
    for res in ranks[4]:
        np.testing.assert_array_equal(res[f"engine/{name}"],
                                      want[f"engine/{name}"])
    kv = ranks[4][0][f"engine/{name}/kv_bytes"]
    if name == "linear":
        assert kv == 0
    else:
        assert kv < int(want[f"engine/{name}/kv_bytes"])


@pytest.mark.parametrize("name", R.PREFILL_CFGS)
def test_prefill_tape_is_the_budget_and_the_reference_rows(ref, name):
    """Each rank's prefill tape is ``comm.budget.serve_prefill_budget``
    (one ``lasp2.states`` gather a linear layer, ``lasp2h.k`` and
    ``lasp2h.v`` a softmax layer, one ``prefill.last``), its decode
    steps' tapes ``serve_decode_budget`` (three ``ring_decode.*`` gathers
    a sliced ring and step), and the prefill's rows without the port's own
    are the reference's; so are the engines' rows."""
    want, ranks = ref
    for res in ranks[4]:
        assert res[f"prefill/{name}/budget"] == []
        assert res[f"prefill/{name}/decode_budget"] == []
        assert _fwd(res[f"prefill/{name}/tape"]) == _rows(
            want, f"prefill/{name}/tape")
        assert any(r.split("|")[1] == "prefill.last"
                   for r in res[f"prefill/{name}/tape"])
        for eng in ("linear", "hybrid"):
            assert _fwd(res[f"engine/{eng}/tape"]) == _rows(
                want, f"engine/{eng}/tape")
        assert _unplaced(res["engine/granite/tape"]) == _rows(
            want, "engine/granite/tape")
        assert any(r.split("|")[1].startswith("fsdp.")
                   for r in res[f"prefill/{name}/tape"])


def _want(name, kind="prefill"):
    """The reference's key prefix holding ``name``'s outputs: its prefill
    plan's; granite's under its decode plan; MoE at a dropping capacity
    under the plan of the same kind; whisper under the (1, 4) decode
    plan; the 3-head hybrid under the batch-over-model branch."""
    if name == "granite":
        return "dprefill"
    if name == "rows":
        return "prows"
    if name == "whisper" or (name == "moe_drop" and kind == "decode"):
        return f"dplan/{name}"
    return f"prefill/{name}"


def _whole(tags, prefix):
    """The ``tp.cols.*`` / ``tp.cache.*`` rows on the leaves under
    ``prefix`` (``mixer.``, ``mlp.``): none where the piece computes on
    its shard."""
    return [t for t in tags if t.startswith(("tp.cols." + prefix,
                                             "tp.cache."))]


def _check_split_pieces(name, tags, dtags, tp, kind):
    """The tags of the pieces that compute on their shard: MoE experts
    and their one all-reduce, the SSD heads (the group norm's statistic,
    the conv B/C gather at decode), cross and encoder layers on their
    heads (under the prefill plan the memory slots lie over data and
    decode merges them, ``decode.*``, gathering none), the prefill rows'
    gather."""
    if tp > 1 and name in ("moe", "moe_drop"):
        assert not _whole(tags + dtags, "mlp."), tags
        assert "tp.experts" in tags and "tp.experts" in dtags
    if tp > 1 and name in ("mamba2", "hymba"):
        ssm = "mixer." if name == "mamba2" else "mixer.ssm."
        assert not _whole(tags + dtags, ssm), tags + dtags
        assert "tp.gnorm" in tags and {"tp.gnorm", "tp.conv"} <= set(dtags)
    if tp > 1 and name == "whisper":
        assert not _whole(tags + dtags, ""), tags + dtags
        assert not any(t.startswith("cache_seq.") for t in tags + dtags)
        assert "tp.mixer" in tags
        assert ("decode.o" in dtags) == (kind == "prefill")
    if name == "rows":
        assert "prefill.rows" in tags and tp == 1


@pytest.mark.parametrize("key,name", [
    (key, name) for key, _, _ in R.PLACED for name in R.PLACED_CFGS[key]])
def test_placed_plan_matches_reference(ref, key, name):
    """Under the (2, 2) prefill and decode plans and the (1, 4) decode
    plan every rank holds its shard of the weights (FSDP over data;
    heads, kv heads, ff and vocab over model) and its cache slice, and
    ``M.prefill`` + 3 decode steps give the reference's logits, cache
    (gathered back leaf by leaf over the axes its specs split) and steps
    for the same params and tokens within 3e-4. The drop-free MoE matches
    the port's one-device path (``test_torch_moe.py`` holds that to the
    reference). Each piece computes on its shard (``_check_split_pieces``:
    MoE on the rank's experts, one ``tp.experts`` all-reduce and no
    ``tp.cols.mlp.*`` row; mamba2's and hymba's SSD heads; whisper's cross
    and encoder layers on their heads; the 3-head hybrid's prefill rows
    over model). MoE at capacity factor 1.0 (items drop) matches the
    reference's global dispatch under its plan of the same kind, whisper
    (gates 0.5; under p22 its memory slots over data, read through the
    flash-decoding merge) its (1, 4) decode plan's, the 3-head hybrid its
    batch-over-model branch's. Held params (and under the prefill plan
    the prefill's cache) equal the dry run's ``memory_report`` byte for
    byte; every tape is within ``serve_prefill_budget`` /
    ``serve_decode_budget``, with ``fsdp.*`` rows exactly where the plan
    places weights over data of size > 1 and ``tp.*`` rows where the
    plan's model axis is > 1."""
    want, ranks = ref
    tol = TOL["float32"]
    dims, kind = {k: (d, c) for k, d, c in R.PLACED}[key]
    for res in ranks[4]:
        out = f"{key}/{name}"
        if name == "moe":
            w_logits, w_steps = res[f"{out}/want"]
            np.testing.assert_allclose(res[f"{out}/logits"], w_logits,
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(res[f"{out}/steps"], w_steps,
                                       rtol=tol, atol=tol)
            w_cache = {f"moe/{k}": v for k, v in
                       _flat(res[f"{out}/want_cache"]).items()}
            _check_cache(res[f"{out}/cache"], "moe/", w_cache, tol)
        else:
            w = _want(name, kind)
            np.testing.assert_allclose(res[f"{out}/logits"],
                                       want[f"{w}/logits"],
                                       rtol=tol, atol=tol)
            _check_cache(res[f"{out}/cache"], f"{w}/cache/", want, tol)
            np.testing.assert_allclose(res[f"{out}/steps"],
                                       want[f"{w}/steps"],
                                       rtol=tol, atol=tol)
        assert res[f"{out}/budget"] == [[], []]
        held, report = res[f"{out}/held"]
        assert held == report, (held, report)
        tags, tp = res[f"{out}/tags"], res[f"{out}/tp"]
        assert any(t.startswith("fsdp.") for t in tags) == (dims[0] > 1)
        assert any(t.startswith("tp.") for t in tags) == (tp > 1)
        assert tp == (1 if name == "rows" else dims[1])
        _check_split_pieces(name, tags, res[f"{out}/decode_tags"], tp, kind)


@pytest.mark.parametrize("key,name", [
    (key, name) for key, _, _ in R.PLACED for name in R.PLACED_ENGINES])
def test_placed_engine_matches_reference(ref, key, name):
    """``ServeEngine(plan=)`` under each placing plan: the reference
    engines' greedy tokens on every rank; the rank's held params and slot
    grid equal ``memory_report`` of the decode cell; the tape within the
    budgets of each admitted batch and decode step; decode slots split
    over data (the (2, 2) decode plan: 2 of the 4 a rank, the sampled
    tokens gathered, ``serve.tokens``) and nowhere else."""
    want, ranks = ref
    kind = dict((k, c) for k, _, c in R.PLACED)[key]
    dims = dict((k, d) for k, d, _ in R.PLACED)[key]
    for res in ranks[4]:
        out = f"{key}/{name}"
        np.testing.assert_array_equal(res[f"{out}/engine"],
                                      want[f"engine/{name}"])
        held, report = res[f"{out}/engine_held"]
        assert held == report, (held, report)
        assert res[f"{out}/engine_budget"] == []
        assert ("serve.tokens" in res[f"{out}/engine_tags"]) == \
            (kind == "decode" and dims[0] > 1)


# ---------------------------------------------------------------------------
# The reference's side (runs in its own subprocess).
# ---------------------------------------------------------------------------

def _jax_reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.comm.primitives import tape
    from repro.comm.spec import CommSpec
    from repro.configs import LayerSpec, LinearAttnConfig, get_smoke
    from repro.core.lasp2 import SPConfig
    from repro.core.lasp2h import (ring_decode_attention,
                                   sharded_decode_attention)
    from repro.launch.mesh import DATA_AXIS, MODEL_AXIS, make_sp_mesh
    from repro.models import model as M
    from repro.serve.engine import ServeEngine
    from repro.sharding.rules import make_plan

    out = {}
    rows = lambda recs: np.array(sorted({f"{r.op}|{r.tag}|{r.payload_bytes}"
                                         for r in recs}))
    cfg_of = lambda name: R.make_cfg(name, get_smoke, LayerSpec,
                                     LinearAttnConfig)
    devs = np.asarray(jax.devices())

    def save_params(name, params):
        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{prefix}/{k}")
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, f"{prefix}/{i}")
            else:
                out[f"param{prefix}"] = np.asarray(node, np.float32)
        walk(params, f"/{name}")

    def save_cache(prefix, cache, cfg):
        """Per layer, as the port's one dict a layer: layer g·P + p is
        group g of pattern position p."""
        n_pat = len(cfg.pattern)
        for p, c in enumerate(cache["layers"]):
            flat = jax.tree_util.tree_flatten_with_path(c)[0]
            for path, leaf in flat:
                keys = "/".join(k.key for k in path)
                for g in range(leaf.shape[0]):
                    out[f"{prefix}layers/{g * n_pat + p}/{keys}"] = \
                        np.asarray(leaf[g], np.float32) \
                        if jnp.issubdtype(leaf.dtype, jnp.floating) \
                        else np.asarray(leaf[g])
        out[f"{prefix}pos"] = np.asarray(cache["pos"])

    # the decode attentions over a 4-device sequence mesh
    ins = {k: jnp.asarray(v) for k, v in R.decode_inputs().items()}
    sp = SPConfig(mesh=make_sp_mesh(4))
    for n in R.CACHE_LENS:
        with tape() as recs:
            o = jax.jit(lambda a, b, c, cl=n: sharded_decode_attention(
                a, b, c, cl, sp=sp))(ins["q"], ins["k"], ins["v"])
        out[f"decode/{n}/sp"] = np.asarray(o)
        out[f"decode/{n}/tape"] = rows(recs)
        out[f"decode/{n}/local"] = np.asarray(sharded_decode_attention(
            ins["q"], ins["k"], ins["v"], n))
    ring_args = (ins["rq"], ins["rk"], ins["rv"], ins["kpos"], ins["qpos"])
    with tape() as recs:
        out["ring/sp"] = np.asarray(jax.jit(
            lambda *a: ring_decode_attention(
                *a, sliding_window=R.RING_WINDOW, sp=sp))(*ring_args))
    out["ring/tape"] = rows(recs)
    out["ring/local"] = np.asarray(ring_decode_attention(
        *ring_args, sliding_window=R.RING_WINDOW))

    # the dense + SP forward on (4, 2)
    cfg = cfg_of("starcoder")
    mesh42 = Mesh(devs[:8].reshape(4, 2), (DATA_AXIS, MODEL_AXIS))
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    save_params("starcoder", params)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                              cfg.vocab_size)
    out["starcoder/tokens"] = np.asarray(toks, np.int32)
    plan = make_plan(mesh42, "prefill", global_batch=2,
                     n_kv_heads=cfg.n_kv_heads)
    with tape() as recs:
        got, _ = jax.jit(lambda p, t: M.forward(p, t, cfg, plan,
                                                remat="none"))(params, toks)
    out["starcoder/tape"] = rows(recs)
    out["starcoder/logits_sp"] = np.asarray(got, np.float32)[
        ..., :cfg.vocab_size]
    local, _ = jax.jit(lambda p, t: M.forward(p, t, cfg, remat="none"))(
        params, toks)
    out["starcoder/logits_local"] = np.asarray(local, np.float32)[
        ..., :cfg.vocab_size]

    # prefill and decode under the prefill plan of (4, 1)
    pplan = make_plan(Mesh(devs[:4].reshape(4, 1), (DATA_AXIS, MODEL_AXIS)),
                      "prefill", n_kv_heads=4)
    dplan = make_plan(Mesh(devs[:4].reshape(1, 4), (DATA_AXIS, MODEL_AXIS)),
                      "decode", n_kv_heads=1)
    toks = jnp.asarray(R.prefill_tokens())
    params_of = {}
    for name in R.PREFILL_CFGS + ("granite", "whisper", "rows"):
        cfg = cfg_of(name)
        params = M.init_params(jax.random.PRNGKey(0), cfg)
        # every cross gate at CROSS_GATE: at 0 a cross layer outputs 0
        params_of[name] = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.full_like(x, R.CROSS_GATE)
            if getattr(path[-1], "key", None) == "gate" else x, params)
        save_params(name, params_of[name])

    def prefill_and_steps(prefix, name, plan, **kw):
        cfg = cfg_of(name)
        params = params_of[name]
        enc = R.frames(cfg)
        if enc is not None:
            kw["enc_frames"] = jnp.asarray(enc)
        with tape() as recs:
            logits, cache = jax.jit(lambda p, t: M.prefill(
                p, t, cfg, plan, max_len=R.MAX_LEN, **kw))(params, toks)
        out[f"{prefix}/tape"] = rows(recs)
        out[f"{prefix}/logits"] = np.asarray(logits, np.float32)
        save_cache(f"{prefix}/cache/", cache, cfg)
        steps = []
        decode = jax.jit(lambda p, t, c: M.decode_step(p, t, c, cfg, plan))
        with tape() as recs:
            for tok in R.decode_tokens():
                lg, cache = decode(params, jnp.asarray(tok), cache)
                steps.append(np.asarray(lg, np.float32))
        out[f"{prefix}/decode_tape"] = rows(recs)
        out[f"{prefix}/steps"] = np.stack(steps)

    for name in R.PREFILL_CFGS:
        plan = make_plan(Mesh(devs[:4].reshape(4, 1),
                              (DATA_AXIS, MODEL_AXIS)), "prefill",
                         n_kv_heads=4, comm=CommSpec(R.strategy(name)))
        prefill_and_steps(f"prefill/{name}", name, plan)
    prefill_and_steps("dprefill", "granite", dplan)
    # the placed cases' own: MoE at a dropping capacity and whisper under
    # the (1, 4) decode plan, the 3-head hybrid under the batch-over-model
    # branch of the (2, 2) prefill plan
    dplan4 = make_plan(Mesh(devs[:4].reshape(1, 4), (DATA_AXIS, MODEL_AXIS)),
                       "decode", n_kv_heads=4)
    for name in ("moe_drop", "whisper"):
        prefill_and_steps(f"dplan/{name}", name, dplan4)
    cfg = cfg_of("rows")
    rplan = make_plan(Mesh(devs[:4].reshape(2, 2), (DATA_AXIS, MODEL_AXIS)),
                      "prefill", n_kv_heads=cfg.n_kv_heads,
                      n_heads=cfg.n_heads, **R.plan_kw(cfg))
    assert rplan.tp_axis is None and rplan.rules["batch"] == MODEL_AXIS
    prefill_and_steps("prows", "rows", rplan)
    cfg = cfg_of("linear")
    logits, cache = jax.jit(lambda p, t: M.prefill(
        p, t, cfg, pplan, max_len=R.MAX_LEN,
        pad_lens=jnp.asarray(R.PAD_LENS)))(params_of["linear"], toks)
    out["pad/logits"] = np.asarray(logits, np.float32)
    save_cache("pad/cache/", cache, cfg)

    # the engines
    for name, plan in (("linear", pplan), ("hybrid", pplan),
                       ("granite", dplan)):
        eng = ServeEngine(cfg_of(name), params_of[name], plan=plan,
                          max_len=R.MAX_LEN, max_batch=4)
        with tape() as recs:
            out[f"engine/{name}"] = eng.generate(R.prompts(), R.NEW_TOKENS)
        out[f"engine/{name}/tape"] = rows(recs)
        out[f"engine/{name}/kv_bytes"] = np.int64(
            eng.cache_stats()["kv_ring"])
    np.savez(out_path, **out)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-reference":
        _jax_reference(sys.argv[2])
    else:
        sys.exit("usage: test_torch_serve_sp.py --jax-reference OUT.npz")
