"""The port's roofline (``repro_torch.launch.roofline``) on the CPU: its
``CostVector`` algebra against the reference's on the same numbers, the
(A, G) solve equal to the full-depth count on SMOKE cells (counted on
the meta device, the kernels as their own work), and the CLI's record
for ``linear-llama3-1b`` × ``train_4k`` with the reference's keys.
"""

import dataclasses
import json

import pytest

from repro.launch.hlo_analysis import CostVector as JCostVector
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import roofline as R
from repro_torch.obs import flops as F

RECORD_KEYS = {"per_device", "terms", "model_flops", "useful_flops_ratio",
               "roofline_fraction", "extrapolation"}


def test_cost_vector_algebra_matches_reference():
    """+, - and scale give the reference's fields on the same numbers."""
    a = dict(flops=3.0e12, hbm_bytes=7.5e9, coll_bytes=1.25e6,
             coll_by_op={"all-gather": 1.0e6, "all-reduce": 2.5e5})
    b = dict(flops=1.0e12, hbm_bytes=2.5e9, coll_bytes=5.0e5,
             coll_by_op={"all-gather": 5.0e5})
    ours = (R.CostVector(**a), R.CostVector(**b))
    ref = (JCostVector(**a), JCostVector(**b))
    for op in (lambda x, y: x + y, lambda x, y: x - y,
               lambda x, y: x.scale(3) - y.scale(0.5),
               lambda x, y: (x - y) + y.scale(2)):
        got, want = op(*ours), op(*ref)
        assert (got.flops, got.hbm_bytes, got.coll_bytes, got.coll_by_op) \
            == (want.flops, want.hbm_bytes, want.coll_bytes,
                want.coll_by_op)


def _smoke(arch, n_layers=None):
    cfg = get_smoke(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


@pytest.mark.parametrize("arch,kind", [
    ("linear-llama3-1b", "train"), ("linear-llama3-1b", "decode"),
    ("mamba2-2.7b", "train")])
def test_solve_equals_full_depth_count(arch, kind):
    """The (A, G) solve at the cell's depth equals the full-depth count
    exactly; the record has the reference's keys; the kernels count as
    their own work (K1 twice a layer and microbatch under remat "full",
    K2a and K2b once; K3 once a layer a decode step)."""
    cfg = _smoke(arch, n_layers=4)
    if kind == "train":
        shape = ShapeConfig("t", 64, 8, "train")
        run = RunConfig(microbatch_tokens=128)          # A = 4 of 2 rows
    else:
        shape, run = ShapeConfig("d", 64, 2, "decode"), None
    rec = R.record(arch, shape.name, cfg=cfg, shape=shape, run=run)
    assert RECORD_KEYS <= set(rec)
    ext = rec["extrapolation"]
    assert ext["equals_full_depth"] is True
    assert ext["solved_flops"] == ext["full_depth_flops"] > 0
    assert ext["solved_hbm_bytes"] == ext["full_depth_hbm_bytes"] > 0
    assert ext["G"] == 4
    launches = rec["kernel_launches_at_checked_A"]
    if kind == "train":
        assert ext["A"] == 4 and ext["checked_at_A"] == 2
        n = 4 * 2
        assert launches == {"K1": 2 * n, "K2a": n, "K2b": n}
        # the solve extrapolates the microbatch loop: A = 4 costs more
        assert rec["per_device"]["flops"] > ext["full_depth_flops"]
    else:
        assert launches == {"K3": 4}
        assert rec["per_device"]["flops"] == ext["full_depth_flops"]
    t = rec["terms"]
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    assert t["collective_s"] == 0.0       # one card: no exchange


def test_kernel_work_is_the_kernel_table_formula():
    """A linear layer's K1 adds ``obs.flops.chunk_fwd_work`` of its
    (B·H, S, dk, dv), not its plain version's products."""
    cfg = _smoke("linear-llama3-1b", n_layers=1)
    shape = ShapeConfig("d", 64, 2, "prefill")
    cell = R._cell("linear-llama3-1b", shape, cfg, RunConfig())
    counter = R.Counter()
    with R.kernels_as_work(counter), counter:
        cell.fn(*cell.abstract_args)
    assert counter.kernels == {"K1": 1}
    with_kernel = counter.flops
    flops, _ = F.chunk_fwd_work(2 * cfg.n_heads, 64, cfg.head_dim,
                                cfg.head_dim, 2)
    counter2 = R.Counter()
    with R.kernels_as_work(counter2):
        cell.fn(*cell.abstract_args)        # the kernel's work only
    assert counter2.flops == flops and with_kernel > flops


def test_cli_writes_the_reference_record(tmp_path):
    """``python -m repro_torch.launch.roofline --arch linear-llama3-1b
    --shape train_4k`` on the meta device: one JSON with the reference's
    keys, the solve exact."""
    assert R.main(["--arch", "linear-llama3-1b", "--shape", "train_4k",
                   "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "linear-llama3-1b__train_4k.json")
                     .read_text())
    assert rec["status"] == "ok" and RECORD_KEYS <= set(rec)
    assert {"flops", "hbm_bytes", "collective_bytes", "coll_by_op"} == set(
        rec["per_device"])
    assert rec["extrapolation"]["equals_full_depth"] is True
    assert rec["extrapolation"]["A"] == 256
    assert rec["terms"]["dominant"] in ("compute", "memory")
