"""Port vs reference: the 3D DP×SP×TP layout (USP Ulysses, ZeRO-1 over
(data, model)) and the windowed halo attention, on gloo ranks, at SMOKE
size.

The reference's 3D battery (``tests/distributed_checks.py:799-957``: a
linear and a softmax layer, GQA 4:2, ``SyntheticLM(512, 64, 8, seed=5)``,
one microbatch) takes 3 steps at (dp, sp, tp) = (1, 2, 2), (2, 1, 2) and
(2, 2, 2) under "ulysses", at (1, 2, 2) and (1, 4, 1) under "allgather",
and on one device, on 8 virtual CPU devices in one subprocess started
from this file (``python tests/test_torch_usp.py --jax-reference
out.npz``), which also records its tapes, the forward's wire bytes at
(2, 2, 2), its refusals and ``windowed_context_attention`` at W 2 and 4,
and writes its initial params. The port starts from those params
(``params_from_jax``, fp32) on gloo ranks: one spawn of 4 ranks holds
every 4-rank layout's cases, one of 8 ranks the (2, 2, 2) layout's.
Tolerances: losses against the reference at the same layout 1e-3;
ulysses against allgather at the same token split 2e-4 (the reference's
own limit, ``distributed_checks.py:848-851``); every layout against the
port's one device 2e-3; ZeRO-1 against replicated AdamW 1e-6; halo
attention o 3e-4, gradients 1e-3; resumed losses 1e-5.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_sp_ranks as R
from repro_torch.comm.budget import check_axis_budget, train_step_axis_budget
from repro_torch.comm.primitives import CommRecord
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import Axis, Layout, TrainingGroups, run_ranks

HERE = Path(__file__).resolve()
ROOT = HERE.parent.parent
TOL = 1e-3
TOL_STRATEGY = 2e-4
TOL_DEVICE = 2e-3
TOL_RESUME = 1e-5
CELLS = {name: (dims, strategy) for name, dims, strategy in R.CELLS3D}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's losses, tapes, refusals, halo outputs and initial
    params."""
    out = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(HERE), "--jax-reference",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as npz:
        want = {k: npz[k] for k in npz.files if not k.startswith("p3d/")}
    return out, want


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """The port on one device (the main process) and on the 4- and 8-rank
    spawns; with the checkpoint cells: one device saves before the 4-rank
    spawn, and resumes (1, 2, 2)'s replicated-moment checkpoint after
    it."""
    npz, _ = ref
    root = tmp_path_factory.mktemp("ckpt")
    local = {"dev1": R.steps3d(str(npz), "cpu", None)[0],
             "full_dev1": R.ckpt3d(str(npz), "cpu", None, 4)}
    R.ckpt3d(str(npz), "cpu", None, 2, str(root / "dev1"))
    ranks = {w: run_ranks(R.usp_rank, w, args=(str(npz), str(root)),
                          timeout_s=600) for w in (4, 8)}
    shutil.copytree(root / "d122rep", root / "d122_on_dev1")
    local["d122_on_dev1"] = R.ckpt3d(str(npz), "cpu", None, 4,
                                     str(root / "d122_on_dev1"))
    return local, ranks


def _cell(port, name):
    dims, _ = CELLS[name]
    return port[1][dims[0] * dims[1] * dims[2]]


def test_layout_places_ranks_sequence_major(port):
    """Global rank r = (d·sp + s)·tp + m: each rank's (data, sequence,
    model) index and its zero-group index d·tp + m."""
    _, ranks = port
    for w, rs in ranks.items():
        for r, res in enumerate(rs):
            for (dp, sp, tp), place in res["place"].items():
                d, rest = divmod(r, sp * tp)
                s, m = divmod(rest, tp)
                assert place == (d, s, m, d * tp + m), (dp, sp, tp, r)


@pytest.mark.parametrize("name", list(CELLS))
def test_3d_steps_match_reference(ref, port, name):
    """3 steps at each layout: every rank's losses and grad norms within
    1e-3 of the reference's manual step at the same layout, and within
    2e-3 of the port's one-device step."""
    _, want = ref
    local, _ = port
    for r in _cell(port, name):
        got = r[name]
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(got[f"{key}es" if key == "loss"
                                           else "gnorms"],
                                       want[f"{name}/{key}"], rtol=TOL,
                                       atol=TOL, err_msg=key)
        np.testing.assert_allclose(got["losses"], local["dev1"]["losses"],
                                   rtol=TOL_DEVICE, atol=TOL_DEVICE)
    np.testing.assert_allclose(local["dev1"]["losses"], want["dev1/loss"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["dp1sp2tp2_ulysses", "dp2sp1tp2_ulysses",
                                  "dp2sp2tp2_ulysses"])
def test_ulysses_matches_allgather_at_the_same_token_split(port, name):
    """Ulysses' two all-to-alls (and at sp > 1 the residual K/V gathers)
    against the K/V all-gather over the same 4 token chunks a row, at
    (1, 2, 2) and (1, 4, 1): losses within 2e-4."""
    _, ranks = port
    for base in ("dp1sp2tp2_allgather", "dp1sp4tp1_allgather"):
        want = ranks[4][0][base]["losses"]
        for r in _cell(port, name):
            np.testing.assert_allclose(r[name]["losses"], want,
                                       rtol=TOL_STRATEGY, atol=TOL_STRATEGY)


def _budget(dims, strategy):
    """``comm.budget.train_step_axis_budget`` of one step (one microbatch,
    one linear and one softmax layer, packed rows: the autodiff backward)
    at ``dims``, and its (data, sequence, model) layout."""
    layout = Layout((Axis.DATA, Axis.SEQUENCE, Axis.MODEL), dims)
    return layout, train_step_axis_budget(
        layout, n_sp_layers=1, n_hybrid_layers=1, comm_strategy=strategy,
        backward="autodiff")


def _records(rows):
    """``op|tag|group size`` rows back into records the budget reads."""
    out = []
    for row in rows:
        op, tag, group = row.split("|")
        out.append(CommRecord(op, 0, 0, 1, int(group), tag))
    return out


@pytest.mark.parametrize("name", list(CELLS))
def test_step_tape_is_the_per_axis_budget(ref, port, name):
    """One step's collectives at each layout are exactly
    ``comm.budget.train_step_axis_budget`` (the budget of
    ``docs/parallelism.md``), each record's group the size of its axes:
    per hybrid layer 4 all-to-alls on groups of
    tp (``ulysses.in``, ``ulysses.out`` and their mirrors), the residual
    K/V gathers and their reduce-scatters on groups of sp when sp > 1,
    the linear layer's state gather on the sp·tp token group, ONE
    ``train.grads`` over the world, ONE ZeRO-1 param gather over the
    dp·tp zero group; nothing else. The forward rows (op, tag, payload)
    are the reference's; at tp 1 the tape is the 2D step's."""
    _, want = ref
    dims, strategy = CELLS[name]
    ref_rows = {str(x) for x in want[f"{name}/tape"]}
    for r in _cell(port, name):
        got = r[name]
        layout, budget = _budget(dims, strategy)
        assert check_axis_budget(_records(got["groups"]), layout,
                                 budget) == []
        fwd = {x for x in got["tape"] if not x.split("|")[1].endswith(".bwd")}
        # the reference records the all-to-alls' mirrors, not the
        # reduce-scatters of its gathers
        assert fwd == {x for x in ref_rows
                       if not x.split("|")[1].endswith(".bwd")}


def test_ulysses_moves_fewer_wire_bytes_than_the_allgather(ref, port):
    """At (2, 2, 2) the softmax layer's forward exchange under "ulysses"
    (2 all-to-alls over tp 2, K/V gathers over sp 2) moves fewer wire
    bytes than the K/V all-gather over the 4 token ranks; each tape's
    rows are the reference's forward rows."""
    _, want = ref
    for r in port[1][8]:
        uly, ag = r["wire"]["ulysses"], r["wire"]["allgather"]
        assert 0 < uly["bytes"] < ag["bytes"], (uly, ag)
        assert uly["bytes"] == int(want["wire/ulysses"])
        assert ag["bytes"] == int(want["wire/allgather"])
        for strategy in ("ulysses", "allgather"):
            assert sorted(set(r["wire"][strategy]["rows"])) == sorted(
                str(x) for x in want[f"wire/{strategy}/rows"])


@pytest.mark.parametrize("name", R.ZERO1_CELLS)
def test_zero1_over_data_and_model_equals_replicated_adamw(port, name):
    """ZeRO-1 over the zero group (dp·tp: 2 at (1, 2, 2), where dp is 1;
    4 at (2, 1, 2)): each rank holds 1/(dp·tp) of the padded moments; 2
    steps' losses and every param within 1e-6 of replicated AdamW."""
    dims, _ = CELLS[name]
    for r in _cell(port, name):
        got = r[f"{name}_zero1"]
        degree = dims[0] * dims[2]
        assert got["opt_numel"] * degree >= got["param_numel"]
        assert got["opt_numel"] * degree < got["param_numel"] + 4 * degree
        np.testing.assert_allclose(got["zero1_losses"],
                                   got["replicated_losses"], rtol=1e-6,
                                   atol=1e-6)
        assert got["params_close"], got["param_diff"]


@pytest.mark.parametrize("cell", ["d122_at_22", "d22_at_122", "dev1_at_122",
                                  "d122_on_dev1"])
def test_checkpoints_cross_3d_and_2d_layouts(port, cell):
    """``train()`` checkpoints at step 2 of guarded "ulysses" runs, resumed
    to step 4 elsewhere: written at (1, 2, 2) with ZeRO-1 over the model
    pair (degree 2) and resumed at (2, 2) with ZeRO-1 over the data pair,
    and the other way round; written on one device and resumed at
    (1, 2, 2) with replicated moments, and the other way round. The
    resumed losses are within 1e-5 of the uninterrupted runs' of both
    layouts. A one-device checkpoint onto (1, 2, 2) with ZeRO-1 (a tree
    of moments onto flat slices) raises ``CheckpointError`` in the first
    try and the fallback, as it does at (2, 1) and in the reference."""
    local, ranks = port
    rs = ranks[4]
    full = {"122": rs[0]["full_122"], "22": rs[0]["full_22"],
            "dev1": local["full_dev1"]}
    writer, reader = {"d122_at_22": ("122", "22"),
                      "d22_at_122": ("22", "122"),
                      "dev1_at_122": ("dev1", "122"),
                      "d122_on_dev1": ("122", "dev1")}[cell]
    resumed = [local[cell]] if reader == "dev1" else [r[cell] for r in rs]
    assert all(r["dev1_at_122_zero1"] == "CheckpointError" for r in rs)
    for got in resumed:
        assert sorted(got) == [2, 3], "must resume from the checkpoint"
        for want in (full[writer], full[reader]):
            np.testing.assert_allclose([got[s] for s in (2, 3)],
                                       [want[s] for s in (2, 3)],
                                       rtol=TOL_RESUME, atol=TOL_RESUME)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("window", R.HALO_WINDOWS)
@pytest.mark.parametrize("mode", R.HALO_MODES)
def test_windowed_context_attention_matches_reference(ref, port, world,
                                                      window, mode):
    """``windowed_context_attention`` at W 2 and 4 against the reference's
    (its "gather" halo; its "ppermute" where XLA-CPU runs it, else the
    gather stands for it: both halo modes compute one function): o within
    3e-4, dq, dk, dv within 1e-3 on every rank's chunk; the tape holds the
    halo exchange (``halo.k``, ``halo.v``: ring hops or gathers of the
    last ``window`` tokens) and its backward, nothing else."""
    _, want = ref
    key = f"halo/w{world}/{window}"
    ref_mode = mode if f"{key}_{mode}/o" in want else "gather"
    ranks = port[1][4][:world]
    got_o = np.concatenate([r[f"halo{world}"][f"w{window}_{mode}"]["o"]
                            for r in ranks], axis=2)
    np.testing.assert_allclose(got_o, want[f"{key}_{ref_mode}/o"],
                               rtol=3e-4, atol=3e-4)
    for i, name in enumerate("qkv"):
        got = np.concatenate([r[f"halo{world}"][f"w{window}_{mode}"]
                              ["grads"][i] for r in ranks], axis=2)
        np.testing.assert_allclose(got, want[f"{key}_{ref_mode}/d{name}"],
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    op = "collective-permute" if mode == "ppermute" else "all-gather"
    back = "collective-permute" if mode == "ppermute" else "reduce-scatter"
    halo = 2 * 2 * window * 16 * 4           # B × Hkv × window × dh × fp32
    for r in ranks:
        tape = r[f"halo{world}"][f"w{window}_{mode}"]["tape"]
        assert sorted(tape) == sorted(
            [f"{op}|halo.k|{halo}", f"{op}|halo.v|{halo}",
             f"{back}|halo.k.bwd|{(world if mode == 'gather' else 1) * halo}",
             f"{back}|halo.v.bwd|{(world if mode == 'gather' else 1) * halo}"])
    if f"{key}_{mode}/tape" in want:
        assert {x for x in tape if ".bwd" not in x} == set(
            str(x) for x in want[f"{key}_{mode}/tape"] if ".bwd" not in x)


def test_windowed_ppermute_on_xla_cpu_is_recorded(ref):
    """What XLA-CPU does with the reference's "ppermute" halo on a full SP
    mesh: either it runs (and the test above holds the port's ppermute to
    it) or its error is recorded here."""
    _, want = ref
    for world in (2, 4):
        for window in R.HALO_WINDOWS:
            key = f"halo/w{world}/{window}_ppermute"
            assert f"{key}/o" in want or f"{key}/error" in want


def test_windowed_context_attention_equals_one_device_flash():
    """With no split the function is one flash call with the window, bit
    for bit; an unknown halo mode raises."""
    import torch
    from repro_torch.core.lasp2h import windowed_context_attention
    from repro_torch.kernels import ops
    ins = R.layer_inputs()
    q, k, v = (torch.from_numpy(ins[n]) for n in ("qs", "ks", "vs"))
    got = windowed_context_attention(q, k, v, 32)
    want = ops.flash_attention_op(q, k, v, causal=True, sliding_window=32)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="halo_mode"):
        windowed_context_attention(q, k, v, 32, halo_mode="ring")


def _layout(dp, sp, tp):
    return TrainingGroups(dp, sp, 0, 0, None, None, None, tp=tp)


def test_refusals_in_both_packages(ref, port):
    """The 3D layout refuses what the reference's 3D plan and step refuse,
    with the reference's messages: the ring and pipelined exchanges (the
    plan; ``lasp2`` itself on a 3D split), heads that tp does not divide
    (GQA 4:2 at tp 4: the kv heads bind; the message names the tp group
    where the reference names its "model" axis), and
    ``grad_compression`` under a layout (the step). On one device ``grad_compression`` is accepted
    and inert, as the reference's pod branch never fires there."""
    from repro_torch.train.step import make_train_step
    _, want = ref
    cfg = R.cfg3d()
    for strategy in ("ring", "pipelined"):
        with pytest.raises(ValueError) as e:
            make_train_step(cfg, RunConfig(comm_strategy=strategy),
                            _layout(1, 2, 2))
        assert str(e.value) == str(want[f"refuse/{strategy}"])
    for r in port[1][4]:
        assert r["ring_refusal"] == str(want["refuse/lasp2_ring"])
    with pytest.raises(ValueError) as e:
        make_train_step(cfg, RunConfig(comm_strategy="ulysses"),
                        _layout(1, 2, 4))
    # the reference names its mesh axis; the port, which has no mesh
    # axes, names the group that stands for it
    heads = "n_heads=4, n_kv_heads=2"
    assert heads in str(want["refuse/heads"])
    assert heads in str(e.value) and "tp group size 4" in str(e.value)
    with pytest.raises(NotImplementedError) as e:
        make_train_step(cfg, RunConfig(grad_compression=True),
                        _layout(1, 2, 2))
    assert str(e.value) == str(want["refuse/grad_compression"])
    # on one device: accepted and inert
    plain = R.steps3d(str(ref[0]), "cpu", None, 1)[0]["losses"]
    inert = R.steps3d(str(ref[0]), "cpu", None, 1,
                      grad_compression=True)[0]["losses"]
    assert plain == inert


def test_train_cli_refuses_a_3d_ring_before_any_rank_work(monkeypatch):
    """``--tp-degree 2 --comm-strategy ring`` and a sequence that sp×tp
    does not divide: the CLI raises before it joins a process group."""
    from repro_torch.launch import train as ttrain
    monkeypatch.setenv("WORLD_SIZE", "4")
    base = ["--smoke", "--device", "cpu", "--sp-degree", "2",
            "--tp-degree", "2", "--steps", "1"]
    with pytest.raises(ValueError, match="3D DP×SP×TP"):
        ttrain.main(base + ["--comm-strategy", "ring", "--seq", "64"])
    with pytest.raises(ValueError, match="by sp×tp"):
        ttrain.main(base + ["--seq", "66"])
    with pytest.raises(ValueError, match="must equal the 4 ranks"):
        ttrain.main(base + ["--dp-degree", "2", "--seq", "64"])


README_FLAGS = ["--arch", "linear-llama3-1b", "--smoke", "--steps", "20",
                "--seq", "256", "--dp-degree", "2", "--sp-degree", "2",
                "--tp-degree", "2", "--comm-strategy", "ulysses"]


def test_3d_train_cli_in_both_packages():
    """The README's 3D command in both packages: the reference's CLI on 8
    virtual CPU devices, the port's under ``torchrun --nproc-per-node 8``
    on gloo ranks (``--device cpu``); both train and the loss falls."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "1"}
    outs = [subprocess.run(
        [sys.executable, "-m", "repro.launch.train"] + README_FLAGS,
        cwd=ROOT, env={**env, "JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                       "--xla_force_host_platform_device_count=8"},
        capture_output=True, text=True, timeout=600),
        subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train"]
        + README_FLAGS + ["--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)]
    for out in outs:
        assert out.returncode == 0, out.stderr[-3000:]
        assert out.stdout.count("over 20 steps (improved)") == 1, out.stdout


# ---------------------------------------------------------------------------
# The reference side (run as a script, in its own process).
# ---------------------------------------------------------------------------

def _jax_reference(path):
    import jax

    from repro.comm import primitives as jprim
    from repro.comm.spec import CommSpec
    from repro.configs import base as jbase
    from repro.configs.base import RunConfig as JRunConfig
    from repro.data import pipeline as jdata
    from repro.launch.mesh import make_training_mesh
    from repro.sharding.rules import local_plan, make_plan
    from repro.train.step import init_state, make_train_step

    cfg = R.cfg3d(jbase)
    data = R.data3d(jdata)
    run = JRunConfig(**R.RUN3D)

    def plan(dims, strategy, **kw):
        n = dims[0] * dims[1] * dims[2]
        mesh = make_training_mesh(*dims, devices=jax.devices()[:n])
        return make_plan(mesh, "train", global_batch=8,
                         n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                         comm=CommSpec(strategy=strategy, dtype="fp32"),
                         zero1=True, **kw)

    out = {}
    for name, dims, strategy in R.CELLS3D + (("dev1", None, None),):
        p = local_plan() if dims is None else plan(dims, strategy)
        state = init_state(jax.random.PRNGKey(0), cfg, run, p)
        if name == "dev1":
            for keys, leaf in jax.tree_util.tree_flatten_with_path(
                    state["params"])[0]:
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in keys)
                out[f"p3d/{key}"] = np.asarray(leaf)
        step = jax.jit(make_train_step(cfg, run, p))
        losses, gnorms = [], []
        for i in range(R.N3D):
            with jprim.tape() as rec:       # records while jit traces
                state, m = step(state, data.microbatched(
                    i, R.RUN3D["num_microbatches"]))
            if i == 0:
                out[f"{name}/tape"] = np.array(R.tape_rows(rec))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[f"{name}/loss"] = np.array(losses)
        out[f"{name}/gnorm"] = np.array(gnorms)
    _jax_wire(out, cfg, plan)
    _jax_refusals(out, cfg, run, plan)
    _jax_halo(out)
    np.savez(path, **out)


def _jax_wire(out, cfg, plan):
    """The forward of the hybrid at (2, 2, 2) under "ulysses" and
    "allgather" (``distributed_checks.py:919-957``): the softmax layer's
    tape rows and traffic bytes, recorded while it lowers."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.comm import primitives as jprim
    from repro.core.compat import shard_map
    from repro.launch.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
    from repro.models import model as JM

    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.asarray(R.data3d().microbatched(0, 1)["tokens"][0])
    for strategy, prefix in (("ulysses", "ulysses."),
                             ("allgather", "lasp2h.")):
        p = plan((2, 2, 2), strategy)

        def fwd(prm, t):
            return JM.forward(prm, t, cfg, p, remat="none")[0]

        with jprim.tape() as recs:
            jax.jit(shard_map(
                fwd, mesh=p.mesh,
                in_specs=(P(), P(DATA_AXIS, (SEQ_AXIS, MODEL_AXIS))),
                out_specs=P(DATA_AXIS, (SEQ_AXIS, MODEL_AXIS), None),
                axis_names=set(p.manual_axes),
                check_vma=False)).lower(params, tokens)
        mine = [r for r in recs if r.tag.startswith(prefix)]
        out[f"wire/{strategy}"] = np.array(sum(r.traffic_bytes
                                               for r in mine))
        out[f"wire/{strategy}/rows"] = np.array(sorted(set(
            R.tape_rows(mine))))


def _jax_refusals(out, cfg, run, plan):
    """The reference's messages: its plan on a 3D mesh under "ring" and
    "pipelined", ``lasp2`` under "ring" on a 3D split, its plan at tp 4
    with 2 kv heads, its manual step with ``grad_compression``."""
    import dataclasses as dc

    import jax.numpy as jnp

    from repro.comm.spec import CommSpec
    from repro.core.lasp2 import SPConfig, lasp2
    from repro.launch.mesh import MODEL_AXIS
    from repro.train.step import make_train_step

    for strategy in ("ring", "pipelined"):
        try:
            plan((1, 2, 2), strategy)
            out[f"refuse/{strategy}"] = np.array("no error")
        except ValueError as e:
            out[f"refuse/{strategy}"] = np.array(str(e))
    mesh = plan((1, 2, 2), "allgather").mesh
    sp = SPConfig(mesh=mesh, tp_axis=MODEL_AXIS, comm=CommSpec("ring"))
    x = jnp.ones((1, 2, 64, 16))
    try:
        lasp2(x, x, x, sp=sp)
        out["refuse/lasp2_ring"] = np.array("no error")
    except ValueError as e:
        out["refuse/lasp2_ring"] = np.array(str(e))
    try:
        plan((1, 2, 4), "ulysses")
        out["refuse/heads"] = np.array("no error")
    except ValueError as e:
        out["refuse/heads"] = np.array(str(e))
    try:
        make_train_step(cfg, dc.replace(run, grad_compression=True),
                        plan((1, 2, 2), "allgather"))
        out["refuse/grad_compression"] = np.array("no error")
    except NotImplementedError as e:
        out["refuse/grad_compression"] = np.array(str(e))


def _jax_halo(out):
    """``windowed_context_attention`` at W 2 and 4 on a sequence mesh: o,
    the gradients of ``sum(sin(o))`` and the tape, per window and halo
    mode; a mode XLA-CPU cannot run records its error instead."""
    import jax
    import jax.numpy as jnp

    from repro.comm import primitives as jprim
    from repro.comm.spec import CommSpec
    from repro.core.lasp2 import SPConfig
    from repro.core.lasp2h import windowed_context_attention
    from repro.launch.mesh import make_sp_mesh

    ins = R.layer_inputs()
    q, k, v = (jnp.asarray(ins[n]) for n in ("qs", "ks", "vs"))
    for world in (2, 4):
        sp = SPConfig(mesh=make_sp_mesh(world), comm=CommSpec(dtype="fp32"))
        for window in R.HALO_WINDOWS:
            for mode in R.HALO_MODES:
                key = f"halo/w{world}/{window}_{mode}"

                def f(q_, k_, v_):
                    return windowed_context_attention(
                        q_, k_, v_, window, sp=sp, halo_mode=mode)
                try:
                    with jprim.tape() as rec:       # records while it traces
                        o = jax.jit(f)(q, k, v)
                        grads = jax.jit(jax.grad(
                            lambda *a: jnp.sum(jnp.sin(f(*a))),
                            argnums=(0, 1, 2)))(q, k, v)
                except Exception as e:    # noqa: BLE001 — recorded, then held
                    out[f"{key}/error"] = np.array(
                        f"{type(e).__name__}: {e}"[:400])
                    continue
                out[f"{key}/o"] = np.asarray(o)
                for name, g in zip("qkv", grads):
                    out[f"{key}/d{name}"] = np.asarray(g)
                out[f"{key}/tape"] = np.array(R.tape_rows(rec))


if __name__ == "__main__":
    if sys.argv[1:2] != ["--jax-reference"] or len(sys.argv) != 3:
        raise SystemExit("usage: test_torch_usp.py --jax-reference OUT.npz")
    _jax_reference(sys.argv[2])
