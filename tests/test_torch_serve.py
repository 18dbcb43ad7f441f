"""Port serving engine vs the reference engine, on the CPU at SMOKE size.

The JAX engine is built once (greedy parity); every other test drives the
port alone."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.obs.metrics import InMemorySink
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import QueueFullError

MAX_NEW = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_get_smoke("linear-llama3-1b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke("linear-llama3-1b"),
                               dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in lens]


def test_greedy_tokens_match_reference_engine(setup):
    """Twin of tests/test_serve_parity.py:65-83 across the two packages:
    ragged prompts into left-pad buckets, fewer slots than requests."""
    jcfg, tcfg, jp, tp = setup
    prompts = _prompts([5, 9, 16, 23])
    jeng = JServeEngine(jcfg, jp, max_len=64, max_batch=2)
    sink = InMemorySink()
    teng = ServeEngine(tcfg, tp, max_len=64, max_batch=2, device="cpu",
                       sink=sink)
    juids = [jeng.submit(p, MAX_NEW) for p in prompts]
    tuids = [teng.submit(p, MAX_NEW) for p in prompts]
    jres, tres = jeng.run(), teng.run()
    for ju, tu, p in zip(juids, tuids, prompts):
        assert tres[tu].dtype == np.int32 and len(tres[tu]) == MAX_NEW
        np.testing.assert_array_equal(
            tres[tu], jres[ju], err_msg=f"prompt len {len(p)}")
    s = teng.stats()
    assert s["prefill_batches"] >= 2 and s["decode_steps"] >= MAX_NEW
    assert s["finished_length"] == len(prompts)
    recs = sink.by_kind("request")
    assert sorted(r["uid"] for r in recs) == sorted(tuids)
    assert all(r["new_tokens"] == MAX_NEW and r["ttft_s"] > 0 for r in recs)


def test_linear_cache_constant_in_max_len(setup):
    _, tcfg, _, tp = setup
    short = ServeEngine(tcfg, tp, max_len=64, max_batch=2, device="cpu")
    long = ServeEngine(tcfg, tp, max_len=4096, max_batch=2, device="cpu")
    st = short.cache_stats()
    assert st["linear_state"] == long.cache_stats()["linear_state"]
    # per linear layer B·H·(dk·dv + 1)·4 bytes
    per = 2 * tcfg.n_heads * (tcfg.head_dim ** 2 + 1) * 4
    assert st["linear_state"] == per * tcfg.n_layers == st["total"]


def test_sampled_tokens_independent_of_batching(setup):
    """Same (seed, stream) → same sampled tokens, alone or batched with
    other requests in other slots."""
    _, tcfg, _, tp = setup
    target, *others = _prompts([11, 7, 20, 13], seed=3)

    def run(batch_with):
        eng = ServeEngine(tcfg, tp, max_len=64, max_batch=3, device="cpu")
        for i, p in enumerate(batch_with):
            eng.submit(p, MAX_NEW, temperature=1.0, seed=9, stream=100 + i)
        uid = eng.submit(target, MAX_NEW, temperature=1.0, seed=5, stream=1)
        return eng.run()[uid]

    alone = run([])
    assert np.array_equal(alone, run(others))
    assert np.array_equal(alone, run(others[:1]))
    eng = ServeEngine(tcfg, tp, max_len=64, max_batch=3, device="cpu")
    other_stream = eng.submit(target, MAX_NEW, temperature=1.0, seed=5,
                              stream=2)
    assert not np.array_equal(alone, eng.run()[other_stream])


def test_bounded_queue_raises_queue_full(setup):
    _, tcfg, _, tp = setup
    eng = ServeEngine(tcfg, tp, max_len=64, max_batch=1, max_queue=2,
                      device="cpu")
    p = _prompts([4])[0]
    eng.submit(p, 2)
    eng.submit(p, 2)
    with pytest.raises(QueueFullError):
        eng.submit(p, 2)
    assert eng.stats()["rejected"] == 1
    assert len(eng.run()) == 2


def test_generate_and_static_path(setup):
    """Ragged prompts through the continuous path; with ``enc_frames`` the
    static-batch path, whose greedy tokens equal the reference's (the
    linear SMOKE has no encoder, so both packages ignore the frames)."""
    jcfg, tcfg, jp, tp = setup
    eng = ServeEngine(tcfg, tp, max_len=64, max_batch=2, device="cpu")
    out = eng.generate(_prompts([3, 8, 5]), 4)
    assert out.shape == (3, 4) and out.dtype == np.int32
    prompts = np.stack(_prompts([6, 6], seed=4))
    frames = np.zeros((2, 2, 64), np.float32)
    want = JServeEngine(jcfg, jp, max_len=64, max_batch=2).generate(
        prompts, 4, enc_frames=frames)
    got = eng.generate(prompts, 4, enc_frames=frames)
    assert got.shape == (2, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_rejects_params_on_another_device(setup):
    _, tcfg, _, tp = setup
    meta = dict(tp, embed={k: v.to("meta") for k, v in tp["embed"].items()})
    with pytest.raises(ValueError, match="params on meta"):
        ServeEngine(tcfg, meta, max_len=64, device="cpu")


def test_serve_cli_smoke_on_cpu(capsys):
    results = serve_cli.main(["--smoke", "--device", "cpu", "--requests",
                              "3", "--max-batch", "2", "--prompt-len", "12",
                              "--new-tokens", "3"])
    assert len(results) == 3
    assert all(len(t) == 3 for t in results.values())
    assert "linear-llama3-1b-smoke on cpu" in capsys.readouterr().out


def test_init_params_shapes_and_dtypes():
    cfg = get_smoke("linear-llama3-1b")
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)
    assert p["embed"]["table"].dtype == torch.bfloat16
    assert p["layers"][0]["mixer"]["wq"].shape == (cfg.d_model, cfg.d_model)
    assert p["final_norm"]["scale"].dtype == torch.float32
    q = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(p["layers"][1]["mlp"]["w2"], q["layers"][1]["mlp"]["w2"])
    with pytest.raises(ValueError, match="generator on"):
        TM.init_params(torch.Generator(), cfg, device="meta")
