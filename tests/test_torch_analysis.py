"""The port's analysis subsystem (``repro_torch.analysis``) at SMOKE size on
the CPU: every lint rule and every SAN code with a planted case that it
flags and a clean twin that it passes (the battery of
``tests/test_analysis.py``), JL101's and JL104's findings against the
reference's rules on the same sources, the suppression routes,
``--explain``, the port's repo lint clean with an empty suppression file,
the PAL301 guard-band harness with planted out-of-bounds entries, the
findings document against the reference's keys, and the SMOKE train and
decode steps sanitized clean.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import lint as jlint
from repro_torch.analysis import kernel_check as kc
from repro_torch.analysis import sanitizer as S
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.findings import AnalysisResult, Finding
from repro_torch.analysis.lint import (discover_files, lint_file,
                                       load_suppressions, run_lint)
from repro_torch.analysis.rules import explain
from repro_torch.comm.primitives import CommRecord
from repro_torch.launch.mesh import Axis

ROOT = Path(__file__).resolve().parent.parent
# the axis words, never spelled: both packages' JL101 walk this file
DATA, SEQ, MODEL, POD = (a.name.lower() for a in
                         (Axis.DATA, Axis.SEQUENCE, Axis.MODEL, Axis.POD))


def _lint(text, codes, name="fx.py", **kw):
    return lint_file(Path(name), text=text, codes=set(codes), **kw)


def _codes(findings):
    return [f.code for f in findings]


def _where(findings):
    return [(f.code, f.line) for f in findings]


def _ref(text, codes, **kw):
    return jlint.lint_file(Path("fx.py"), text=text, codes=set(codes), **kw)


# --- JL101: raw axis-name literals -----------------------------------------

JL101_SOURCES = {
    "flagged": f'''
def f(mesh):
    return mesh.shape.get("{DATA}", 1)

spec = P("{SEQ}", None)
names = {{"{MODEL}", "{POD}"}}
''',
    "clean": '''
from repro_torch.launch.mesh import Axis

def f(layout):
    return layout.shape.get(Axis.DATA, 1)
''',
    "denied": f'''
if cfg.linear_attn.decay == "{DATA}":
    pass
cfg2 = LinearAttnConfig("{DATA}", kind="{SEQ}")
with timer.phase("{SEQ}"):
    pass
g(decay="{MODEL}")
''',
    "model_live": f'''
spec = P(None, ("{SEQ}", "{MODEL}"))
deg = mesh.shape["{MODEL}"]
''',
}


@pytest.mark.parametrize("name", sorted(JL101_SOURCES))
def test_jl101_matches_reference(name):
    """The same (code, line) as the reference's JL101 on the same source;
    4 findings flagged, 3 on the live model axis, none clean or denied."""
    text = JL101_SOURCES[name]
    got = _where(_lint(text, ["JL101"]))
    assert got == _where(_ref(text, ["JL101"]))
    assert len(got) == {"flagged": 4, "clean": 0, "denied": 0,
                        "model_live": 3}[name]
    assert "Axis" in explain("JL101")


# --- JL102: host syncs in the hot path -------------------------------------

_JL102_BAD = '''
import numpy as np
import torch

def f(x):
    print(x)
    torch.cuda.synchronize()
    np.asarray(x)
    a = x.item()
    b = x.tolist()
    c = x.cpu()
    return x.numpy()
'''


def test_jl102_flags_host_syncs_in_scope():
    got = _lint(_JL102_BAD, ["JL102"], sync_scope=True)
    assert _codes(got) == ["JL102"] * 7
    assert {f.line for f in got} == set(range(6, 13))


def test_jl102_out_of_scope_silent_and_clean_twin():
    assert _lint(_JL102_BAD, ["JL102"], sync_scope=False) == []
    clean = '''
import torch

def f(x, y):
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, y), x.to("cuda", non_blocking=True)
'''
    assert _lint(clean, ["JL102"], sync_scope=True) == []


def test_jl102_decorator_exempts():
    fenced = '''
import torch
from repro_torch.analysis.decorators import host_sync_allowed

@host_sync_allowed
def fence(x):
    torch.cuda.synchronize()
    return x.cpu()
'''
    assert _lint(fenced, ["JL102"], sync_scope=True) == []


def test_jl102_scope_follows_the_port_layout():
    """The rule's scope is the port's hot path: core/, kernels/, comm/,
    train/step.py, obs/metrics.py; not the loop or the launchers."""
    src = ROOT / "src" / "repro_torch"
    for rel, want in (("core/lasp2.py", 1), ("train/step.py", 1),
                      ("obs/metrics.py", 1), ("train/loop.py", 0),
                      ("launch/train.py", 0)):
        got = lint_file(src / rel, text="y = x.item()\n", codes={"JL102"})
        assert len(got) == want, rel


# --- JL104: nondeterminism in the hot path ---------------------------------

_JL104_REF_BAD = '''
import time
from random import shuffle
import numpy as np

def f(x):
    return x + np.random.normal() + time.time()
'''


def test_jl104_matches_reference_on_its_sources():
    for text in (_JL104_REF_BAD, "import jax\n\ndef f(k, x):\n    return x\n"):
        got = _where(_lint(text, ["JL104"], det_scope=True))
        assert got == _where(_ref(text, ["JL104"], det_scope=True))
    assert len(_lint(_JL104_REF_BAD, ["JL104"], det_scope=True)) == 3


def test_jl104_flags_torch_global_rng_and_passes_generators():
    bad = '''
import torch

def f(x):
    torch.manual_seed(0)
    a = torch.rand(3)
    b = torch.randn_like(x)
    return torch.randperm(4), torch.randint(0, 5, (2,))
'''
    assert _codes(_lint(bad, ["JL104"], det_scope=True)) == ["JL104"] * 5
    clean = '''
import torch

def f(x, gen):
    return torch.rand(3, generator=gen), torch.randint(0, 5, (2,),
                                                       generator=gen)
'''
    assert _lint(clean, ["JL104"], det_scope=True) == []
    assert _lint(bad, ["JL104"], det_scope=False) == []


def test_jl104_exempts_the_build_by_name():
    build = ROOT / "src" / "repro_torch" / "kernels" / "_build.py"
    assert lint_file(build, codes={"JL104"}) == []
    other = ROOT / "src" / "repro_torch" / "kernels" / "ops.py"
    assert _codes(lint_file(other, text="import time\n",
                            codes={"JL104"})) == ["JL104"]


# --- JL105: kernel debug debris --------------------------------------------

_CU_BAD = '''
#include <cstdio>
__device__ float twice(float x) {
    printf("x = %f\\n", x);
    return 2 * x;
}
__global__ void k(float* o) {
    if (threadIdx.x == 0) { printf("block %d\\n", blockIdx.x); }
}
int host(void) {
    setenv("CUDA_LAUNCH_BLOCKING", "1", 1);
    return 0;
}
'''

_CU_CLEAN = '''
#include <cstdio>
// printf("a commented debug line")
__global__ void k(float* o) { o[threadIdx.x] = 1.f; }
int host(int err) {
    if (err) { printf("launch failed: %d\\n", err); }
    return err;
}
'''


def test_jl105_flags_device_printf_and_launch_blocking_in_cuda():
    got = _lint(_CU_BAD, ["JL105"], name="k.cu")
    assert _where(got) == [("JL105", 4), ("JL105", 8), ("JL105", 11)]
    assert _lint(_CU_CLEAN, ["JL105"], name="k.cuh") == []


def test_jl105_flags_debug_nvcc_flags_and_launch_blocking_in_python():
    bad = '''
import os
NVCC_FLAGS = ("-O3", "-G", "-lineinfo")
os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
os.environ.setdefault("CUDA_LAUNCH_BLOCKING", "1")
'''
    assert _where(_lint(bad, ["JL105"])) == [
        ("JL105", 3), ("JL105", 3), ("JL105", 4), ("JL105", 5)]
    clean = '''
import os
NVCC_FLAGS = ("-O3", "-Xptxas=-v")
level = os.environ.get("CUDA_LAUNCH_BLOCKING")
'''
    assert _lint(clean, ["JL105"]) == []


# --- suppressions, discovery, explain --------------------------------------

def test_inline_disable_routes_to_suppressed(tmp_path):
    p = tmp_path / "fx.py"
    p.write_text(f'ax = "{SEQ}"  # torchlint: disable=JL101\n')
    res = run_lint([p], suppressions=[])
    assert res.findings == [] and _codes(res.suppressed) == ["JL101"]
    cu = tmp_path / "k.cu"
    cu.write_text('__global__ void k() { printf("x"); }  '
                  '// torchlint: disable=JL105\n')
    res = run_lint([cu], suppressions=[])
    assert res.findings == [] and _codes(res.suppressed) == ["JL105"]


def test_suppression_file_routes_to_suppressed(tmp_path):
    p = tmp_path / "fx.py"
    p.write_text(f'ax = "{SEQ}"\n')
    sup = tmp_path / "suppressions.txt"
    sup.write_text("# comment\nfx.py JL101\n")
    res = run_lint([p], suppressions=load_suppressions(sup))
    assert res.findings == [] and _codes(res.suppressed) == ["JL101"]
    res2 = run_lint([p], suppressions=[("fx.py", "JL102")])
    assert _codes(res2.findings) == ["JL101"]
    sup.write_text("fx.py JL101 extra-token\n")
    with pytest.raises(ValueError, match="bad suppression line"):
        load_suppressions(sup)


def test_explain_known_and_unknown(capsys):
    for code in ("JL101", "JL102", "JL104", "JL105", "PAL301", "SAN201",
                 "SAN202", "SAN203", "SAN204", "SAN205"):
        assert code in explain(code.lower())
    with pytest.raises(KeyError, match="unknown rule code"):
        explain("JL103")       # JAX-only: no tracer in eager code
    assert analysis_main(["--explain", "SAN203"]) == 0
    assert "bf16" in capsys.readouterr().out
    assert analysis_main(["--explain", "JL106"]) == 2


def test_port_lint_clean_with_empty_suppressions():
    """Zero findings over the port, nothing suppressed, the suppression
    file empty; discovery covers the package, its CUDA sources, the
    port's tests and chip_smoke.py, and skips __pycache__."""
    res = run_lint()
    assert res.ok, "\n".join(str(f) for f in res.findings)
    assert load_suppressions() == [] and res.suppressed == []
    files = discover_files(ROOT)
    rel = {p.relative_to(ROOT).as_posix() for p in files}
    assert "chip_smoke.py" in rel and "tests/torch_sp_ranks.py" in rel
    assert "src/repro_torch/kernels/csrc/sm90.cuh" in rel
    assert "tests/test_torch_analysis.py" in rel
    assert not any(p.startswith("src/repro/") for p in rel)
    assert not [p for p in files if "__pycache__" in p.parts]
    assert res.checked["files"] == len(files)


def test_findings_document_has_the_reference_keys(tmp_path):
    """``AnalysisResult.to_dict()`` and each finding's keys equal the
    reference's for the same content; the reference's report script
    renders the port's document."""
    kw = dict(code="SAN203", path="train_step[dp=2,sp=2]", line=0,
              message="carries float32")
    ours = AnalysisResult(findings=[Finding(**kw)], checked={"programs": 5})
    ref = jfindings.AnalysisResult(findings=[jfindings.Finding(**kw)],
                                   checked={"programs": 5})
    assert ours.to_dict() == ref.to_dict()
    assert list(ours.to_dict()) == ["ok", "counts", "checked", "findings",
                                    "suppressed"]
    p = tmp_path / "findings.json"
    p.write_text(ours.to_json())
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "report.py"), str(p)],
        capture_output=True, text=True, check=True)
    assert "**FAIL**" in out.stdout and "SAN203" in out.stdout


def test_cli_lint_only_writes_json(tmp_path):
    out = tmp_path / "f.json"
    assert analysis_main(["--lint-only", "--no-kernel-check", "--json",
                          str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["checked"]["files"] > 100


# --- PAL301: the guard-band battery ----------------------------------------

@pytest.fixture(scope="module")
def cases():
    return kc.battery_cases()


def test_battery_covers_every_route_and_runs_clean_on_plain_versions(cases):
    """Every route of the seven kernels (14), the reference's variants,
    lengths off the tile multiples; the harness on the plain versions
    finds nothing."""
    assert kc.routes(cases) == sorted(
        (k, r) for k in ("K1", "K2a", "K2b", "K3", "K4", "K5a", "K5b")
        for r in ("sm90", "simt"))
    names = " ".join(c.name for c in cases)
    for variant in kc.FLASH_VARIANTS:
        assert f",{variant}," in names
    assert "S=100" in names and "no decay" in names
    found, n = kc.check_kernels("cpu", cases)
    assert found == [] and n == len(cases)


def _write_past(case, out):
    def launch(views):
        kc.plain_launch(case)(views)
        o = views[out]
        torch.as_strided(o, (1,), (1,), o.storage_offset() + o.numel()
                         ).fill_(0)
    return launch


def _read_past(case, inp):
    def launch(views):
        x = dict(views)
        t = views[inp]
        x[inp] = torch.as_strided(t, t.shape, t.stride(),
                                  t.storage_offset() + 1)
        kc.plain_launch(case)(x)
    return launch


@pytest.mark.parametrize("kernel", ["K1", "K2b", "K3", "K4", "K5a"])
def test_planted_out_of_bounds_entries_are_flagged(cases, kernel):
    """A fake entry that writes one element past an output (a changed
    margin), or reads one past an input (NaN from the margin), is a
    PAL301 finding naming the kernel and variant."""
    case = next(c for c in cases if c.kernel == kernel)
    out = next(iter(case.outputs))
    inp = next(iter(case.inputs))
    wrote = kc.run_case(case, "cpu", launch=_write_past(case, out))
    assert _codes(wrote) == ["PAL301"]
    assert wrote[0].path == case.label and "margin" in wrote[0].message
    read = kc.run_case(case, "cpu", launch=_read_past(case, inp))
    assert read and set(_codes(read)) == {"PAL301"}
    assert any("non-finite" in f.message or "differs" in f.message
               for f in read)


# --- the sanitizer ----------------------------------------------------------

def test_san201_and_san202_flag_planted_syncs_and_float64():
    x = torch.ones(4)

    def bad():
        y = x * 2
        if bool(torch.isfinite(y).all()):       # a host branch
            y = y + float(y.sum())
        torch.nonzero(y)
        return y.double()

    _, found = S.watched("prog", bad)
    assert sorted(_codes(found)) == ["SAN201", "SAN201", "SAN202"]
    msgs = " ".join(f.message for f in found)
    assert "_local_scalar_dense ×2" in msgs and "nonzero" in msgs

    def clean():
        y = x * 2
        return torch.where(torch.isfinite(y).all(), y, torch.zeros_like(y))

    assert S.watched("prog", clean)[1] == []


def _rec(tag, dtype="bfloat16", op="all-gather", shape=(2, 3)):
    return CommRecord(op, 12, 12, 1, 2, tag=tag, dtype=dtype, shape=shape)


def test_san203_wire_dtype():
    """bf16 wire: the state exchange in fp32 is flagged, the fp32-by-design
    tags pass, a tape with no sequence exchange is vacuous."""
    ok = [_rec("lasp2.states"), _rec("lasp2.states.bwd", op="reduce-scatter"),
          _rec("train.grads", "float32", "all-reduce"),
          _rec("zero1.param_gather", "float32"),
          _rec("ulysses.in", "float32", "all-to-all")]
    assert S.check_wire("p", ok, "bf16") == []
    bad = ok + [_rec("lasp2h.k", "float32")]
    assert _codes(S.check_wire("p", bad, "bf16")) == ["SAN203"]
    assert "lasp2h.k" in S.check_wire("p", bad, "bf16")[0].message
    vacuous = S.check_wire("p", ok[2:], "bf16")
    assert _codes(vacuous) == ["SAN203"] and "vacuous" in vacuous[0].message
    # a program that split no sequence (a decode plan) owes no exchange
    assert S.check_wire("p", ok[2:] + [_rec("decode.o", "float32")], "bf16",
                        split=False) == []
    # an fp32 wire takes nothing wider than fp32
    assert S.check_wire("p", ok, "fp32") == []


def test_san204_storage_and_san205_drift():
    a, b = torch.zeros(3), torch.zeros(3)
    before = S.storage({"params": {"w": a}, "opt": {"m": b}},
                       lambda p: True)
    same = S.storage({"params": {"w": a}, "opt": {"m": b}}, lambda p: True)
    assert S.check_storage("p", before, same, "param") == []
    moved = S.storage({"params": {"w": a.clone()}, "opt": {"m": b}},
                      lambda p: True)
    assert _codes(S.check_storage("p", before, moved, "param")) == ["SAN204"]
    assert _codes(S.check_storage("p", {}, {}, "param")) == ["SAN204"]
    fp = S.fingerprint([_rec("lasp2.states"), _rec("train.grads")])
    assert S.check_determinism("p", fp, list(fp)) == []
    drift = S.fingerprint([_rec("lasp2.states", shape=(2, 4)),
                           _rec("train.grads")])
    found = S.check_determinism("p", fp, drift)
    assert _codes(found) == ["SAN205"] and "#0" in found[0].message


def test_smoke_train_step_sanitizes_clean():
    """The one-device SMOKE train step: no host sync, no float64, params
    and moments in place, the same collectives twice."""
    assert S.sanitize_one_device("cpu") == []


def test_smoke_decode_step_sanitizes_clean():
    """The SMOKE hybrid's decode step: its rings stay in place."""
    assert S.sanitize_decode_smoke("cpu") == []


def test_a_step_that_copies_its_params_is_flagged(monkeypatch):
    """SAN204 and SAN201 on a planted step: it replaces a param with a new
    tensor and branches on the loss on the host."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train import step as T
    cfg = S.smoke_cfg()
    run = RunConfig(remat="none", warmup_steps=0)
    state = T.init_state(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    real = T.make_train_step

    def planted(cfg_, run_, layout=None):
        inner = real(cfg_, run_, layout)

        def step(st, batch):
            st, m = inner(st, batch)
            if float(m["loss"]) > 0:
                st["params"]["final_norm"]["scale"] = \
                    st["params"]["final_norm"]["scale"].clone()
            return st, m
        return step

    monkeypatch.setattr(T, "make_train_step", planted)
    found, _, _ = S.sanitize_train("planted", cfg, run, state,
                                   S.smoke_batch(cfg, rows=2, seq=16),
                                   runs=1)
    assert sorted(_codes(found)) == ["SAN201", "SAN204"]
