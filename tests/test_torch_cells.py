"""Port vs reference: collective budgets (``repro_torch.comm.budget``),
cells (``launch.cells``) and the plan-level dry run (``launch.dryrun``).

Budgets: every budget function against the reference's over a grid of
world sizes, strategies, wire dtypes, slices and backward modes (the
values of ``tests/test_comm.py:63-80`` among them), and ``check_budget``
on a synthetic tape finding the violations ``tests/test_comm.py:82-100``
finds in HLO. Cells: every ``ALL_IDS`` × ``SHAPES`` cell at 16×16 on
meta tensors takes the reference's microbatch count and note, computed by
the reference's own ``choose_microbatches``, ``resolve_config`` and
``make_plan`` (its ``build_cell`` lowers for XLA, which needs the 256
devices; the plan functions read a mesh's shape only). The dry run: a
record for every cell at 16×16 and 2×16×16 with the reference's keys, and
each rank's param bytes those the reference's specs imply.
"""

import itertools
import json
import types

import jax
import numpy as np
import pytest

from repro.comm import budget as JB
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import cells as JC
from repro.launch.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS, SEQ_AXIS
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.comm import budget as B
from repro_torch.comm.primitives import CommRecord
from repro_torch.configs import ALL_IDS
from repro_torch.configs.base import SHAPES
from repro_torch.launch import cells as C
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Axis, Layout, make_production_mesh

AXES = {DATA_AXIS: Axis.DATA, MODEL_AXIS: Axis.MODEL, POD_AXIS: Axis.POD,
        SEQ_AXIS: Axis.SEQUENCE}
REF_KEYS = ("arch", "shape", "mesh", "devices", "status", "note",
            "config_name", "params_b", "num_microbatches")


def _same(got, want):
    assert dict(got.counts) == dict(want.counts)
    assert dict(got.max_traffic) == dict(want.max_traffic)
    assert got.strict == want.strict and got.note == want.note


@pytest.mark.parametrize("strategy", ["allgather", "ring", "pipelined",
                                      "ulysses"])
def test_lasp2_budget_matches_reference(strategy):
    for world, grad, bwd, n, dt in itertools.product(
            (2, 4, 8, 64), (False, True), ("faithful", "autodiff"),
            (1, 2, 4), ("fp32", "bf16")):
        sb = B.packed_state_bytes(2, 16, 128, 128, dt)
        assert sb == JB.packed_state_bytes(2, 16, 128, 128, dt)
        assert B.comm_itemsize(dt) == JB.comm_itemsize(dt)
        _same(B.lasp2_budget(strategy, world, with_grad=grad, backward=bwd,
                             n_slices=n, state_bytes=sb),
              JB.lasp2_budget(strategy, world, with_grad=grad, backward=bwd,
                              n_slices=n, state_bytes=sb))


@pytest.mark.parametrize("strategy", ["allgather", "ring", "pipelined",
                                      "ulysses"])
def test_context_budgets_match_reference(strategy):
    for degree, sp, grad, dt, item in itertools.product(
            (2, 4, 8), (1, 2), (False, True), ("fp32", "bf16"), (2, 4)):
        kw = dict(sp=sp, b=2, hq=16, hkv=4, c=512, dh=128, with_grad=grad,
                  comm_dtype=dt, compute_itemsize=item)
        _same(B.hybrid_context_budget(strategy, degree, **kw),
              JB.hybrid_context_budget(strategy, degree, **kw))
    kw = dict(b=1, hq=8, hkv=8, c=64, dh=64)
    _same(B.allgather_context_budget(4, **kw),
          JB.allgather_context_budget(4, **kw))
    _same(B.ulysses_context_budget(4, sp=2, **kw),
          JB.ulysses_context_budget(4, sp=2, **kw))


def test_budget_tables():
    """``tests/test_comm.py:63-80`` in the port, and against the
    reference's ring baseline."""
    assert B.lasp2_budget("allgather", 8).counts == {"all-gather": 1}
    assert B.lasp2_budget("allgather", 8, with_grad=True).counts == \
        {"all-gather": 2}
    assert B.lasp2_budget("allgather", 8, with_grad=True,
                          backward="autodiff").counts == \
        {"all-gather": 1, "reduce-scatter": 1}
    assert B.lasp2_budget("ring", 8).counts == {"collective-permute": 7}
    assert B.lasp2_budget("ring", 8, with_grad=True).counts == \
        {"collective-permute": 14}
    assert B.lasp2_budget("pipelined", 8, n_slices=4).counts == \
        {"collective-permute": 28}
    assert B.ring_baseline_budget(64, with_grad=True).counts == \
        {"collective-permute": 126}
    for w, g in itertools.product((2, 8, 64), (False, True)):
        _same(B.ring_baseline_budget(w, with_grad=g),
              JB.ring_baseline_budget(w, with_grad=g))
    with pytest.raises(ValueError):
        B.lasp2_budget("smoke-signals", 8)
    with pytest.raises(ValueError):
        JB.lasp2_budget("smoke-signals", 8)


def _rec(op, nbytes, group, tag=""):
    return CommRecord(op, nbytes, (group - 1) * nbytes, 1, group, tag)


def test_check_budget_on_synthetic_tape():
    """The tape of one 8-rank all-gather of f32[8,16] and one hop: the
    violations ``tests/test_comm.py``'s HLO case finds."""
    tape = [_rec("all-gather", 8 * 16 * 4, 8),
            CommRecord("collective-permute", 512, 512, 1, 8)]
    ok = B.CollectiveBudget({"all-gather": 1, "collective-permute": 1})
    assert B.check_budget(tape, ok) == []
    bad = B.CollectiveBudget({"all-gather": 2})
    assert len(B.check_budget(tape, bad)) == 2  # wrong count + the hop
    loose = B.CollectiveBudget({"all-gather": 1}, strict=False)
    assert B.check_budget(tape, loose) == []
    capped = B.CollectiveBudget({"all-gather": 1, "collective-permute": 1},
                                max_traffic={"all-gather": 10.0})
    assert any("exceeds budget" in v for v in B.check_budget(tape, capped))
    with pytest.raises(AssertionError, match="budget violated"):
        B.assert_budget(tape, bad)


def _mesh(axes, sizes):
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, sizes)))


@pytest.mark.parametrize("dims", [(1, 4, 1), (2, 2, 1), (4, 1, 1),
                                  (1, 2, 2), (2, 1, 2), (2, 2, 2)])
def test_train_step_axis_budget_matches_reference(dims):
    axes = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
    jmesh = _mesh(axes[:2] if dims[2] == 1 else axes,
                  dims[:2] if dims[2] == 1 else dims)
    layout = Layout(tuple(AXES[a] for a in jmesh.axis_names),
                    tuple(jmesh.shape.values()))
    for kw in (dict(n_sp_layers=2), dict(n_sp_layers=1, n_hybrid_layers=1),
               dict(n_sp_layers=3, n_hybrid_layers=1,
                    comm_strategy="ulysses", microbatches=2),
               dict(n_sp_layers=1, backward="faithful", zero1=False)):
        want = JB.train_step_axis_budget(jmesh, **kw)
        got = B.train_step_axis_budget(layout, **kw)
        assert got.counts == {(op, tuple(AXES[a] for a in ax)): n
                              for (op, ax), n in want.counts.items()}
        assert got.note == want.note


def test_check_axis_budget_reads_tags_and_group_sizes():
    """At (2, 2, 2) under "ulysses": a step's tape (one linear and one
    softmax layer) meets the budget; a gather on the wrong group size, a
    missing ZeRO-1 gather and an unknown tag are each caught."""
    layout = Layout((Axis.DATA, Axis.SEQUENCE, Axis.MODEL), (2, 2, 2))
    budget = B.train_step_axis_budget(layout, n_sp_layers=1,
                                      n_hybrid_layers=1,
                                      comm_strategy="ulysses")
    tape = [_rec("all-gather", 8, 4, "lasp2.states"),
            _rec("reduce-scatter", 8, 4, "lasp2.states.bwd"),
            _rec("all-reduce", 8, 8, "train.grads"),
            _rec("all-gather", 8, 4, "zero1.param_gather")]
    tape += [_rec("all-to-all", 8, 2, f"ulysses.{t}")
             for t in ("in", "out", "in.bwd", "out.bwd")]
    tape += [_rec("all-gather", 8, 2, f"ulysses.{t}") for t in "kv"]
    tape += [_rec("reduce-scatter", 8, 2, f"ulysses.{t}.bwd") for t in "kv"]
    assert B.check_axis_budget(tape, layout, budget) == []
    wrong = [_rec("all-gather", 8, 8, "lasp2.states")] + tape[1:]
    assert any("group of 8" in v for v in B.check_axis_budget(
        wrong, layout, budget))
    assert B.check_axis_budget(tape[:3] + tape[4:], layout, budget)
    assert any("not a train-step" in v for v in B.check_axis_budget(
        tape + [_rec("all-gather", 8, 2, "mystery")], layout, budget))


def _ref_dp(mesh, plan):
    """The reference ``build_cell``'s dp for a train cell."""
    dp = int(np.prod([mesh.shape[a] for a in plan.dp_axes
                      if a in mesh.axis_names]))
    if plan.sp is not None and not plan.manual_axes:
        dp = mesh.shape.get(POD_AXIS, 1)
    return dp


@pytest.mark.parametrize("arch", ALL_IDS)
def test_build_cell_matches_reference(arch):
    """Every shape at 16×16: the config (after ``long_500k``'s switch),
    the note, and a train cell's microbatch count; the abstract args are
    meta tensors and the plan is the reference's."""
    mesh = _mesh((DATA_AXIS, MODEL_AXIS), (16, 16))
    for shape in SHAPES:
        cell = C.build_cell(arch, shape, make_production_mesh())
        jcfg, note = JC.resolve_config(arch, shape)
        assert cell.note == note and cell.cfg.name == jcfg.name
        assert [s.mixer for s in cell.cfg.pattern] == \
            [s.mixer for s in jcfg.pattern]
        js = J_SHAPES[shape]
        jplan = JR.make_plan(mesh, js.kind, global_batch=js.global_batch,
                             n_kv_heads=jcfg.n_kv_heads,
                             n_heads=jcfg.n_heads,
                             params_bytes=jcfg.param_count() * 2)
        want_a = JC.choose_microbatches(js, _ref_dp(mesh, jplan)) \
            if js.kind == "train" else 1
        assert cell.run.num_microbatches == want_a
        assert C.choose_microbatches(SHAPES[shape], 16) == \
            JC.choose_microbatches(js, 16)
        leaves = jax.tree_util.tree_leaves(cell.abstract_args,
                                           is_leaf=lambda x: hasattr(
                                               x, "device"))
        assert all(t.device.type == "meta" for t in leaves
                   if hasattr(t, "device"))


def _ref_shards(arch, shape_name):
    """Per port leaf path, the devices the reference's spec splits it over
    in a cell at 16×16 (its ``build_cell``'s plan and its FSDP rule for
    prefill); a stacked leaf ``groups/p/...`` is layer ``g·P + p``'s."""
    mesh = _mesh((DATA_AXIS, MODEL_AXIS), (16, 16))
    cfg, _ = JC.resolve_config(arch, shape_name)
    js = J_SHAPES[shape_name]
    plan = JR.make_plan(mesh, js.kind, global_batch=js.global_batch,
                        n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                        params_bytes=cfg.param_count() * 2)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    if js.kind == "prefill":
        total = sum(int(np.prod(l.shape)) * (2 if len(l.shape) >= 2 else 4)
                    for l in jax.tree_util.tree_leaves(shapes))
        if total / 16 <= 6 * 2 ** 30:
            plan.fsdp_axis = None
    flat = jax.tree_util.tree_flatten_with_path(
        JR.param_specs(shapes, plan), is_leaf=lambda x: isinstance(x, JR.P))
    size = lambda e: mesh.shape[e] if isinstance(e, str) \
        else int(np.prod([mesh.shape[a] for a in e]))
    out = {}
    for path, spec in flat[0]:
        keys = tuple(str(k.key) if hasattr(k, "key") else str(k.idx)
                     for k in path)
        entries = [e for e in tuple(spec) if e is not None]
        n = int(np.prod([size(e) for e in entries]))
        if "groups" not in keys:
            out[keys] = n
            continue
        i = keys.index("groups")
        p, rest = int(keys[i + 1]), keys[i + 2:]
        n_pat, n_groups = ((len(cfg.pattern), cfg.n_groups) if i == 0
                           else (1, cfg.encoder.n_layers))
        for g in range(n_groups):
            out[keys[:i] + ("layers", str(g * n_pat + p)) + rest] = n
    return out


def _port_param_bytes(params, shards, prefix=()):
    """The port's params' bytes, each leaf over the reference's shards."""
    if isinstance(params, dict):
        return sum(_port_param_bytes(v, shards, prefix + (k,))
                   for k, v in params.items())
    if isinstance(params, list):
        return sum(_port_param_bytes(v, shards, prefix + (str(i),))
                   for i, v in enumerate(params))
    return params.numel() * params.element_size() // shards[prefix]


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b", "whisper-base",
                                  "linear-llama3-1b"])
def test_dry_run_param_bytes_are_the_reference_specs(arch, tmp_path):
    """Every shape at 16×16: the dry run's per-rank param bytes are the
    port's leaves (matrices bf16 in inference cells, fp32 masters in
    train cells; norm scales fp32, where the reference's stacked (G, d)
    scales are cast with its matrices) each divided over the devices the
    reference's spec for that leaf splits it over."""
    for shape in SHAPES:
        rec = dryrun.run_one(arch, shape, False, str(tmp_path))
        assert rec["status"] == "ok", rec.get("error")
        cell = C.build_cell(arch, shape, make_production_mesh())
        params = cell.abstract_args[0]
        params = params["params"] if shape == "train_4k" else params
        assert rec["memory"]["params"] == _port_param_bytes(
            params, _ref_shards(arch, shape)), shape
        assert rec["memory"]["activations"] == "not counted"


def test_dry_run_writes_every_cell_with_the_reference_keys(tmp_path):
    """``run_all`` over ``ALL_IDS`` × ``SHAPES`` at 16×16 and 2×16×16:
    one JSON a cell, status ok, the reference's keys; a prefill cell's
    collectives are its serving budget, its TP exchanges included; the
    CLI runs one cell."""
    for multi in (False, True):
        res = dryrun.run_all(multi, str(tmp_path), archs=ALL_IDS)
        assert len(res) == len(ALL_IDS) * len(SHAPES)
        assert set(res.values()) == {"ok"}
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 2 * len(ALL_IDS) * len(SHAPES)
    for f in files:
        rec = json.loads(f.read_text())
        assert all(k in rec for k in REF_KEYS), f.name
    rec = json.loads((tmp_path / "linear-llama3-1b__prefill_32k__16x16.json"
                      ).read_text())
    # 16 state gathers, prefill.last and tp.logits; tp.mixer and tp.mlp
    # a layer and tp.embed (FSDP dropped: 1B fits the prefill budget)
    assert rec["collectives"]["counts"] == {"all-gather": 18,
                                            "all-reduce": 33}
    assert dryrun.main(["--arch", "granite-34b", "--shape", "decode_32k",
                        "--out", str(tmp_path / "cli")]) == 0
