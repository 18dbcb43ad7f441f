"""The port's fault tolerance on the CPU: the chaos injectors on the
port's ``CheckpointManager`` (twins of ``tests/test_resilience.py``'s
cases that ``tests/test_torch_train.py`` does not hold), sharded
restores, ``InterruptData`` through ``train()``, and the chaos drill at
(dp, sp) = (2, 2) on gloo ranks."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointError,
                                            CheckpointManager)
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.resilience import chaos
from repro_torch.train.loop import train

ARCH = "linear-llama3-1b"


def _tree(k=1.0):
    return {"params": {"w": torch.arange(8.0) * k, "b": torch.ones(3) * k},
            "step": int(k), "count": torch.tensor(int(k), dtype=torch.int32)}


def _zeros():
    return {"params": {"w": torch.zeros(8), "b": torch.zeros(3)}, "step": 0,
            "count": torch.zeros((), dtype=torch.int32)}


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=2, backoff_s=0.0)
    mgr._savez = chaos.FlakySavez(fails=99)   # every attempt fails
    mgr.save_async(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.wait()                                # raised once, then clear


def test_async_save_error_surfaces_on_next_save(tmp_path):
    import time
    mgr = CheckpointManager(str(tmp_path), retries=1, backoff_s=0.0)
    mgr._savez = chaos.FlakySavez(fails=99)
    mgr.save_async(1, _tree())
    for _ in range(100):                      # let the thread fail
        if mgr._thread is None or not mgr._thread.is_alive():
            break
        time.sleep(0.01)
    mgr._savez = np.savez
    with pytest.raises(OSError):
        mgr.save_async(2, _tree(2.0))         # surfaces the step-1 error
    mgr.save_async(2, _tree(2.0))
    mgr.wait()
    assert mgr.latest_step() == 2


def test_kill_mid_save_and_retry(tmp_path):
    """A killed writer leaves the previous checkpoint (atomic), its error
    surfaces on ``wait()``; a flaky writer is retried until it writes."""
    mgr = CheckpointManager(str(tmp_path), backoff_s=0.0)
    mgr.save(1, _tree())
    mgr._savez = chaos.KillingSavez()
    mgr.save_async(2, _tree(2.0))
    with pytest.raises(chaos.KillSave):
        mgr.wait()
    assert mgr.latest_step() == 1
    flaky = chaos.FlakySavez(fails=2)
    mgr._savez = flaky
    mgr.save(5, _tree(5.0))
    assert flaky.calls == 3
    out = mgr.restore(5, _zeros())
    torch.testing.assert_close(out["params"]["w"], torch.arange(8.0) * 5)
    assert out["step"] == 5 and int(out["count"]) == 5
    assert out["count"].shape == ()


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "remove"])
def test_damaged_checkpoint_raises_corrupt_error(tmp_path, damage):
    """Flipped array bytes, a torn manifest, a missing arrays file: each
    raises ``CheckpointCorruptError`` naming the file;
    ``restore_latest_valid`` then raises when nothing older exists."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    if damage == "corrupt":
        chaos.corrupt_checkpoint(str(tmp_path), 1)
        match = "checksum|unreadable"
    elif damage == "truncate":
        chaos.truncate_manifest(str(tmp_path), 1)
        match = "manifest"
    else:
        os.remove(tmp_path / "step_00000001" / "arrays.npz")
        match = "arrays.npz"
    with pytest.raises(CheckpointCorruptError, match=match):
        mgr.restore(1, _zeros())
    with pytest.raises(CheckpointError):
        mgr.restore_latest_valid(_zeros())


def test_restore_errors_and_subtrees(tmp_path):
    """A missing step lists the steps there are; a subtree restores by
    path; a missing path raises ``CheckpointError``; checksums can be
    skipped (``verify=False``)."""
    mgr = CheckpointManager(str(tmp_path))
    full = {"opt": {"m": torch.full((8,), 3.0), "v": torch.full((8,), 4.0)},
            "params": {"w": torch.arange(8.0)}, "step": 9}
    mgr.save(9, full)
    with pytest.raises(CheckpointError, match=r"\[9\]"):
        mgr.restore(7, full)
    out = mgr.restore(9, {"params": {"w": torch.zeros(8)}})
    torch.testing.assert_close(out["params"]["w"], torch.arange(8.0))
    with pytest.raises(CheckpointError, match="nope"):
        mgr.restore(9, {"nope": torch.zeros(2)})
    out = mgr.restore(9, {"opt": {"m": torch.zeros(8)}}, verify=False)
    assert float(out["opt"]["m"][0]) == 3.0


def test_sharded_restore_slices_a_stored_vector(tmp_path):
    """``shards``: each of 4 slices of a stored 1-d array restores into a
    quarter-length target; a target whose full length differs raises
    ``ValueError`` (a shape)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"opt": {"m": torch.arange(12.0)}})
    for i in range(4):
        out = mgr.restore(1, {"opt": {"m": torch.zeros(3)}},
                          shards={"opt/m": (i, 4)})
        torch.testing.assert_close(out["opt"]["m"],
                                   torch.arange(3.0 * i, 3.0 * i + 3))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"opt": {"m": torch.zeros(4)}},
                    shards={"opt/m": (0, 4)})


def test_injectors_deliver_at_exact_steps():
    """``InterruptData`` raises its signal when the step's batch is
    fetched and not before; the wrappers delegate the data interface."""
    class _Fake:
        vocab_size = 7

        def batch(self, step):
            return {"step": step}

        def microbatched(self, step, a):
            return {"step": step, "a": a}

    d = chaos.InterruptData(_Fake(), at_step=3, signum=signal.SIGUSR1)
    hits = []
    old = signal.signal(signal.SIGUSR1, lambda *_: hits.append(1))
    try:
        d.batch(2)
        assert hits == []
        d.microbatched(3, 1)
        assert hits == [1]
    finally:
        signal.signal(signal.SIGUSR1, old)
    s = chaos.StragglerData(_Fake(), at_step=99, sleep_s=0.0)
    assert s.batch(0) == {"step": 0}
    assert s.microbatched(1, 2) == {"step": 1, "a": 2}
    assert s.vocab_size == 7


def test_interrupt_through_train_saves_and_exits_cleanly(tmp_path):
    """SIGTERM delivered while step 3's batch is fetched: the loop finishes
    step 3, logs the signal, saves a final checkpoint at step 4 and
    returns; the resumed run continues from step 4."""
    cfg = get_smoke(ARCH)
    run = RunConfig(num_microbatches=1, total_steps=6, warmup_steps=2,
                    remat="none", guard=True)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    logs = []
    state, hist = train(cfg, run, chaos.InterruptData(data, at_step=3),
                        device="cpu", ckpt_dir=str(tmp_path), ckpt_every=100,
                        log_every=10 ** 9, log_fn=logs.append)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert "[signal] interrupted at step 3; saving" in logs
    assert state["step"] == 4
    assert CheckpointManager(str(tmp_path)).all_steps() == [4]
    _, hist2 = train(cfg, run, data, device="cpu", ckpt_dir=str(tmp_path),
                     log_every=10 ** 9, log_fn=lambda *_: None)
    assert [h["step"] for h in hist2] == [4, 5]


def test_drill_at_2x2_passes_every_finding(tmp_path):
    """``python -m repro_torch.resilience.drill --dp 2 --sp 2 --device
    cpu``: one spawn of 4 gloo ranks for the training findings; exit 0,
    all six findings ok, the reference's report form."""
    from repro_torch.resilience import drill
    out, metrics = tmp_path / "drill.json", tmp_path / "drill.jsonl"
    rc = drill.main(["--dp", "2", "--sp", "2", "--device", "cpu",
                     "--out", str(out), "--metrics-out", str(metrics)])
    doc = json.loads(out.read_text())
    assert rc == 0, doc
    assert doc["kind"] == "chaos_drill" and doc["mesh"] == "2x2"
    assert doc["device"] == "cpu" and drill.drill_config().head_dim == 64
    assert doc["passed"] and doc["rtol"] == 1e-6
    assert [f["name"] for f in doc["findings"]] == [
        "nan_skip_parity", "corrupt_fallback_resume", "save_ioerror_retry",
        "kill_mid_save", "straggler_step", "consecutive_skip_abort"]
    assert all(f["ok"] for f in doc["findings"])
    fallback = doc["findings"][1]["detail"]["fallback_events"]
    assert fallback[0]["bad_step"] == 8 and fallback[0]["restored_step"] == 4
