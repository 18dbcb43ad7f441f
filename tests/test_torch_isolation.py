"""The port stands alone: no JAX, nothing of ``repro``, no quiet CPU
fallback, and kernels only where a CUDA tensor asks for one."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import _build, ops
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd,
                                             lasp2_chunk_bwd_dkv,
                                             lasp2_chunk_bwd_dq,
                                             lasp2_chunk_fwd)
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels.lasp2_decode import lasp2_decode_step
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import train
from repro_torch.train.step import init_state

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py", ROOT / "chip_kernel_ab.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 15
    assert len([p for p in files if p.parent.name == "examples"]) == 4
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_without_loading_jax():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.models.weights, repro_torch.launch.train, "
            "repro_torch.train.loop, repro_torch.checkpoint.manager, "
            "repro_torch.comm.primitives, repro_torch.comm.strategy, "
            "repro_torch.comm.spec, repro_torch.core.baselines, "
            "repro_torch.core.lasp2, repro_torch.launch.mesh, "
            "repro_torch.sharding.rules, repro_torch.comm.budget, "
            "repro_torch.launch.cells, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.analysis, "
            "repro_torch.analysis.__main__, repro_torch.analysis.lint, "
            "repro_torch.analysis.rules, repro_torch.analysis.sanitizer, "
            "repro_torch.analysis.kernel_check; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("linear-llama3-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(torch.Generator().manual_seed(0), cfg)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 2, 32)


def test_cpu_tensors_take_plain_versions_not_kernels():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16))
                                .astype(np.float32)) for _ in range(3))
    saved = lasp2_chunk_fwd.launches, lasp2_decode_step.launches
    lasp2_chunk_fwd.launches = lasp2_decode_step.launches = 0
    try:
        _, st, ld = ops.linear_attention_op(q, k, v)
        ops.linear_decode_op(q[:, :, 0], k[:, :, 0], v[:, :, 0], None, st,
                             ld)
        assert lasp2_chunk_fwd.launches == 0
        assert lasp2_decode_step.launches == 0
    finally:
        lasp2_chunk_fwd.launches, lasp2_decode_step.launches = saved


def test_kernel_wrappers_raise_on_other_devices():
    q = torch.zeros((2, 8, 16), device="meta")
    la = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        lasp2_chunk_fwd(q, q, q, la)
    with pytest.raises(ValueError, match="several devices"):
        lasp2_chunk_fwd(q, q, q, torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="want q, k"):
        lasp2_chunk_fwd(q, q, q[:, :4], la)
    x = torch.zeros((2, 16), device="meta")
    st = torch.zeros((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        lasp2_decode_step(x, x, x, la[:, 0], st, la[:, 0])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _build.build_kernels.__wrapped__()
    assert not list((tmp_path / "build").glob("*.so"))


def test_train_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("linear-llama3-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, RunConfig(total_steps=1), SyntheticLM(cfg.vocab_size, 8, 2),
              log_fn=lambda *_: None)
    from repro_torch.launch import train as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--smoke", "--steps", "1"])


def test_backward_on_cpu_tensors_takes_plain_versions():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16))
                                .astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    la = torch.zeros((1, 2, 40), requires_grad=True)
    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    saved = [c.launches for c in counters]
    try:
        for c in counters:
            c.launches = 0
        o, st, _ = ops.linear_attention_op(q, k, v, la)
        grads = torch.autograd.grad(o.sum() + st.sum(), (q, k, v, la))
        assert all(torch.isfinite(g).all() for g in grads)
        assert [c.launches for c in counters] == [0, 0, 0]
    finally:
        for c, n in zip(counters, saved):
            c.launches = n


def test_backward_wrappers_raise_on_other_devices():
    x = torch.zeros((2, 8, 16), device="meta")
    la = torch.zeros((2, 8), device="meta")
    st = torch.zeros((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        lasp2_chunk_bwd(x, x, x, la, x, x, st)
    with pytest.raises(ValueError, match="no kernel for meta"):
        lasp2_chunk_bwd_dkv(x, x, x, la, x, x, st)
    with pytest.raises(ValueError, match="no kernel for meta"):
        lasp2_chunk_bwd_dq(x, x, la, x)
    with pytest.raises(ValueError, match="several devices"):
        lasp2_chunk_bwd(x, x, x, la, x, x, torch.zeros((2, 16, 16)))
    with pytest.raises(ValueError, match="want o, dO"):
        lasp2_chunk_bwd(x, x, x, la, x[:, :4], x, st)


FLASH = (fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
         fl.flash_attention_bwd_dkv)


def test_flash_on_cpu_tensors_takes_plain_versions():
    """ops.flash_attention_op and FlashAttention, forward and backward, on
    CPU tensors launch nothing."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 4, 40, 16)).astype(
        np.float32)).requires_grad_(True)
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32)).requires_grad_(True) for _ in range(2))
    saved = [c.launches for c in FLASH]
    try:
        for c in FLASH:
            c.launches = 0
        o = ops.flash_attention_op(q, k, v, sliding_window=8)
        o2 = fl.FlashAttention.apply(q, k, v, True, None, None, 0, 40)
        grads = torch.autograd.grad(o.sum() + o2.sum(), (q, k, v))
        assert all(torch.isfinite(g).all() for g in grads)
        assert [c.launches for c in FLASH] == [0, 0, 0]
    finally:
        for c, n in zip(FLASH, saved):
            c.launches = n


def test_flash_wrappers_raise_on_other_devices():
    x = torch.zeros((1, 2, 8, 16), device="meta")
    lse = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        fl.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fl.FlashAttention.apply(x, x, x, True, None, None, 0, 8)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fl.flash_attention_bwd_dq(x, x, x, x, lse, lse)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fl.flash_attention_bwd_dkv(x, x, x, x, lse, lse)
    with pytest.raises(ValueError, match="several devices"):
        fl.flash_attention_fwd(x, torch.zeros((1, 2, 8, 16)), x)
    with pytest.raises(ValueError, match="several devices"):
        fl.flash_attention_bwd_dkv(x, x, x, x, torch.zeros((1, 2, 8)), lse)
