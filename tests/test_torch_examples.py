"""The port's twins of the reference's examples (``examples/torch_*.py``)
on the CPU, each through the function that holds its body, at a reduced
size where its full size would be slow here: quickstart at 60 steps of 4
x 64 tokens (the example's 8 x 128 on the card), serve_hybrid whole,
train_linear_llama3's resume demo on a 2-layer cut of its ~100M model
(whose config is checked field by field against the reference
example's), long_context_sp on its 8 ranks at S 512, H 2, d 16 (65536,
8, 64 on the card). Each twin defaults to the card and raises without
one, and imports nothing of JAX or ``repro``.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
# the twins import by name (spawned ranks find the long-context one there)
if str(EXAMPLES) not in sys.path:
    sys.path.insert(0, str(EXAMPLES))

import torch_long_context_sp as long_sp          # noqa: E402
import torch_quickstart as quick                 # noqa: E402
import torch_serve_hybrid as serve               # noqa: E402
import torch_train_linear_llama3 as train_twin   # noqa: E402

TWINS = {"quickstart": quick, "serve_hybrid": serve,
         "train_linear_llama3": train_twin, "long_context_sp": long_sp}
TOL_BF16 = 4e-2
quiet = dict(log_fn=lambda *_: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_quickstart_twin_learns():
    """60 steps of SMOKE linear-llama3-1b: the loss drops by more than 0.2
    (the example's "OK: learning")."""
    first, last = quick.quickstart("cpu", seq_len=64, global_batch=4,
                                   log_every=10 ** 9, **quiet)
    assert last < first - 0.2, (first, last)


def test_serve_hybrid_twin_and_its_cache_bytes_match_the_reference():
    """8 ragged requests on 4 slots, 24 sampled tokens each; the example's
    constant-state and ring-cap asserts pass; the engine's cache bytes are
    the reference engine's for the same config."""
    import jax

    from repro.configs import get_smoke as j_get_smoke
    from repro.configs.base import LayerSpec as JLayerSpec
    from repro.models import model as JM
    from repro.serve.engine import ServeEngine as JServeEngine
    lengths, stats = serve.serve_hybrid("cpu", **quiet)
    assert len(lengths) == 8 and set(lengths.values()) == {24}
    base = j_get_smoke("linear-llama3-1b")
    jcfg = dataclasses.replace(base, pattern=(JLayerSpec(),), n_layers=4,
                               name="smoke-dense").linearize(hybrid_every=4)
    want = JServeEngine(jcfg, JM.init_params(jax.random.PRNGKey(0), jcfg),
                        max_len=256, max_batch=4).cache_stats()
    for kind in ("linear_state", "kv_ring"):
        assert stats[kind] == want[kind], kind


@pytest.mark.parametrize("hybrid", [False, True])
def test_train_twin_config_is_the_reference_examples(hybrid):
    """``model_100m`` field for field as the reference example builds it
    (the hybrid through its detour), with the same parameter count."""
    import train_linear_llama3 as ref_example
    got, want = train_twin.model_100m(hybrid), ref_example.model_100m(hybrid)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_train_twin_resume_demo_is_the_straight_run(tmp_path):
    """The resume demo on a 2-layer cut of the ~100M model (d 64, 4
    heads, vocab 512) for 4 steps: the second run resumes at step 2, ends
    at step 4, and its params and moments are a straight 4-step run's,
    bit for bit."""
    cfg = dataclasses.replace(train_twin.model_100m(False), n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                              vocab_size=512, head_dim=None)
    kw = dict(device="cpu", seq_len=64, global_batch=4, log_every=10 ** 9,
              **quiet)
    hist, state = train_twin.train_demo(cfg, 4, ckpt_dir=str(tmp_path / "a"),
                                        resume_demo=True, **kw)
    _, straight = train_twin.train_demo(cfg, 4, ckpt_dir=str(tmp_path / "b"),
                                        **kw)
    assert [h["step"] for h in hist] == [2, 3]
    assert int(state["step"]) == 4
    from repro_torch.core.tree import leaves_with_paths
    a, b = (leaves_with_paths({"p": s["params"], "o": s["opt"]})
            for s in (state, straight))
    assert len(a) == len(b)
    for (path, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path


def _tagged_rank(rank, world, device, *args):
    """The twin's rank, its result tagged with the rank."""
    return {**long_sp._rank(rank, world, device, *args), "rank": rank}


def test_long_context_sp_twin_on_eight_ranks():
    """8 gloo ranks, bf16: LASP-2 sharded within the bf16 limit of the
    local computation; LASP-2's tape one all-gather of the packed states
    (B·H·(d² + 1) fp32), LASP-1's W-1 = 7 hops (both held to their
    budgets inside the ranks), Megatron-SP's three all-gathers of the
    chunk's bf16 q, k, v; each rank ran the ``rank_fn`` given, and every
    rank's result comes back in rank order."""
    b, h, s, d, w = 1, 2, 512, 16, 8
    rel, tapes, ranks = long_sp.long_context_sp(
        "cpu", world=w, b=b, h=h, s=s, d=d, rank_fn=_tagged_rank, **quiet)
    assert [r["rank"] for r in ranks] == list(range(w))
    assert rel < TOL_BF16, rel
    lasp2_tape, lasp1_tape, megatron_tape = (tapes[c] for c in long_sp.CASES)
    assert lasp2_tape == {"all-gather": [1, b * h * (d * d + 1) * 4]}
    assert lasp1_tape["collective-permute"][0] == w - 1
    assert megatron_tape == {"all-gather": [3, 3 * b * h * (s // w) * d * 2]}


@pytest.mark.parametrize("name", list(TWINS))
def test_twins_run_on_the_card_by_default(name, monkeypatch):
    """Without ``--device`` a twin runs on the card, and without one it
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--steps", "2"] if name == "train_linear_llama3" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TWINS[name].main(argv)


def test_twins_load_no_jax():
    """The four twins import without loading JAX or anything of
    ``repro``."""
    code = ("import sys; sys.path.insert(0, 'examples'); "
            "import torch_quickstart, torch_serve_hybrid, "
            "torch_train_linear_llama3, torch_long_context_sp; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
