"""The step sanitizer: SAN201 to SAN205 (twin of
``repro/analysis/sanitizer.py``).

The reference compiles its train and decode steps and reads the HLO. The
port has no compiler, so it watches one call of the step instead, under
a ``TorchDispatchMode`` (every aten op the step runs, the backward's
included) and the collective tape (``comm.primitives.tape()``):

* SAN201 — no host sync inside the step: no ``aten._local_scalar_dense``
  (``.item()``, ``float(t)``, ``bool(t)``), no op whose output shape
  depends on the data (``nonzero``, ``masked_select``, ``unique``), no
  ``aten.equal``, no copy from the card to the CPU; on the card the call
  also runs under ``torch.cuda.set_sync_debug_mode("error")``;
* SAN202 — no float64 or complex128 tensor enters or leaves an op;
* SAN203 — with ``comm_dtype="bf16"`` every exchange on the tape carries
  bf16, but the fp32 ones ``comm.budget.WIRE_FP32_TAGS`` names (with
  ``"fp32"``: none carries more than fp32), and a tape with no such
  exchange is flagged as vacuous;
* SAN204 — the train step's params and Adam moments, and the decode
  step's ring K/V and key positions (and, on the card, its linear and SSD
  states), keep their storage: the twin of the reference's donation;
* SAN205 — two runs of the step, each with fresh closures, issue the
  same collectives (op, tag, dtype, shape, group size).

Programs (:func:`run_sanitizer`): the one-device train step and the
decode step, then the reference's rank programs — the (1, 8) and (2, 4)
train steps and the (2, 2, 2) Ulysses hybrid — on gloo ranks, at SMOKE
size on the CPU. The checks are plain functions of what a call produced
(:func:`sync_findings`, :func:`check_wire`, :func:`check_storage`,
:func:`check_determinism`), so the tests and ``chip_smoke.py`` reuse them
on their own calls.
"""

from __future__ import annotations

import contextlib
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import AnalysisResult, Finding

aten = torch.ops.aten

# ops that make the host wait for the card, or whose output shape the
# host must read from it
_SYNC_OPS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
             aten._unique, aten._unique2, aten.unique_dim,
             aten.unique_consecutive, aten.equal, aten.is_nonzero}
_WIDE = {torch.float64, torch.complex128}
_HERE = Path(__file__).resolve().parent
_PKG = _HERE.parent


def _site() -> str:
    """``file:line`` of the innermost frame of the port outside this
    package (the op's call site), or ''."""
    for fr in reversed(traceback.extract_stack()):
        p = Path(fr.filename).resolve()
        if _PKG in p.parents and _HERE not in p.parents and p.parent != _HERE:
            return f"{p.relative_to(_PKG.parent).as_posix()}:{fr.lineno}"
    return ""


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class StepWatch(TorchDispatchMode):
    """Records the host syncs (SAN201) and float64 tensors (SAN202) of
    the ops run while it is active: ``events[(code, op)] = [count,
    first call site]``."""

    def __init__(self):
        super().__init__()
        self.events: Dict[Tuple[str, str], list] = {}

    def _note(self, code, what):
        ev = self.events.get((code, what))
        if ev is None:
            self.events[(code, what)] = [1, _site()]
        else:
            ev[0] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        name = str(packet).split(".")[-1]
        if packet in _SYNC_OPS:
            self._note("SAN201", f"aten.{name}")
        elif packet is aten._to_copy and args[0].is_cuda \
                and torch.device(kwargs.get("device") or args[0].device
                                 ).type == "cpu":
            self._note("SAN201", "copy to the CPU (aten._to_copy)")
        elif packet is aten.copy_ and args[0].device.type == "cpu" \
                and args[1].is_cuda:
            self._note("SAN201", "copy to the CPU (aten.copy_)")
        out = func(*args, **kwargs)
        for t in (*_tensors(args), *_tensors(kwargs), *_tensors(out)):
            if t.dtype in _WIDE:
                self._note("SAN202", f"aten.{name} {t.dtype}")
                break
        return out


def sync_findings(label: str, watch: StepWatch,
                  sync_error: Optional[BaseException] = None
                  ) -> List[Finding]:
    """SAN201 and SAN202 findings from a watched call (one per op and
    code), and SAN201 for an error raised by the card's sync debug
    mode."""
    out = []
    for (code, what), (count, site) in sorted(watch.events.items()):
        msg = (f"{what} ×{count} inside the step — the host waits for the "
               f"card (a step with a sync cannot be captured as one graph)"
               if code == "SAN201" else
               f"{what} ×{count} inside the step — a double-precision "
               f"tensor (a numpy float64 or a promotion reached the step)")
        out.append(Finding(code=code, path=label, line=0, message=msg,
                           source=site))
    if sync_error is not None:
        out.append(Finding(
            code="SAN201", path=label, line=0,
            message=f"torch.cuda sync debug mode raised: "
                    f"{str(sync_error).splitlines()[0][:200]}",
            source=_error_site(sync_error)))
    return out


def _error_site(err: BaseException) -> str:
    for fr in reversed(traceback.extract_tb(err.__traceback__)):
        p = Path(fr.filename).resolve()
        if _PKG in p.parents and _HERE not in p.parents:
            return f"{p.relative_to(_PKG.parent).as_posix()}:{fr.lineno}"
    return ""


@contextlib.contextmanager
def _sync_debug(enabled: bool):
    """``torch.cuda.set_sync_debug_mode("error")`` for the block when
    ``enabled``, restored after."""
    if not enabled:
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def watched(label: str, fn: Callable[[], object], *,
            sync_debug: bool = False):
    """Run ``fn()`` under a :class:`StepWatch` (and, with ``sync_debug``,
    the card's sync debug mode set to error). Returns ``(result or None,
    SAN201/SAN202 findings)``; a sync the debug mode raised at is a
    finding, not an exception."""
    err = None
    result = None
    with StepWatch() as watch:
        try:
            with _sync_debug(sync_debug):
                result = fn()
        except RuntimeError as e:
            if not sync_debug or "synchroniz" not in str(e):
                raise
            err = e
    return result, sync_findings(label, watch, err)


# ---------------------------------------------------------------------------
# SAN203, SAN204, SAN205: checks of what a call produced.
# ---------------------------------------------------------------------------

def check_wire(label: str, records: Sequence, comm_dtype: str, *,
               split: bool = True) -> List[Finding]:
    """SAN203 over a tape. With ``comm_dtype="bf16"`` every record whose
    tag ``comm.budget.wire_exempt`` does not name carries bf16; with
    ``"fp32"`` none carries more than 4 bytes an element (bf16 activations
    stay bf16: the knob only narrows). Where the program ``split`` a
    sequence over ranks, at least one such record must exist: a tape
    without one makes the check vacuous (the reference asks it of meshes
    with a sequence axis above 1)."""
    from repro_torch.comm.budget import wire_exempt
    from repro_torch.comm.primitives import wire_dtype
    wire = wire_dtype(comm_dtype)
    want = str(wire).split(".")[-1]
    out, n = [], 0
    for r in records:
        if wire_exempt(r.tag):
            continue
        n += 1
        width = getattr(torch, r.dtype).itemsize if r.dtype else 0
        bad = r.dtype != want if wire == torch.bfloat16 \
            else width > wire.itemsize
        if bad:
            out.append(Finding(
                code="SAN203", path=label, line=0,
                message=f"comm_dtype={comm_dtype}: {r.op} {r.tag} carries "
                        f"{r.dtype} (shape {list(r.shape)}) — expected "
                        f"{want} on the wire",
                source=f"{r.op}|{r.tag}|{r.dtype}|{list(r.shape)}|"
                       f"{r.group}"))
    if split and n == 0:
        out.append(Finding(
            code="SAN203", path=label, line=0,
            message="no sequence exchange on the tape — the wire-dtype "
                    "check would be vacuous (did the LASP-2 exchange "
                    "run?)"))
    return out


def storage(tree, keep: Callable[[tuple], bool]) -> Dict[tuple, int]:
    """``{path: data_ptr}`` of the tensor leaves of ``tree`` whose path
    ``keep`` accepts."""
    from repro_torch.core.tree import leaves_with_paths
    return {path: leaf.data_ptr() for path, leaf in leaves_with_paths(tree)
            if isinstance(leaf, torch.Tensor) and keep(path)}


def check_storage(label: str, before: Dict[tuple, int],
                  after: Dict[tuple, int], what: str) -> List[Finding]:
    """SAN204: every leaf of ``before`` holds the same storage after the
    step; an empty ``before`` is flagged (the check would be vacuous)."""
    if not before:
        return [Finding(code="SAN204", path=label, line=0,
                        message=f"no {what} to check — the storage check "
                                f"would be vacuous")]
    moved = [p for p, ptr in before.items() if after.get(p) != ptr]
    if not moved:
        return []
    return [Finding(
        code="SAN204", path=label, line=0,
        message=f"{len(moved)} of {len(before)} {what} leaves got new "
                f"storage in the step (first: {'/'.join(moved[0])}) — a "
                f"copy per step where the update should be in place",
        source="/".join(moved[0]))]


def fingerprint(records: Sequence) -> List[tuple]:
    """The tape as ``(op, tag, dtype, shape, group)`` rows."""
    return [(r.op, r.tag, r.dtype, tuple(r.shape), r.group)
            for r in records]


def check_determinism(label: str, fp1: List[tuple], fp2: List[tuple]
                      ) -> List[Finding]:
    """SAN205: two runs' fingerprints are equal."""
    if fp1 == fp2:
        return []
    diff = next((i for i, (a, b) in enumerate(zip(fp1, fp2)) if a != b),
                min(len(fp1), len(fp2)))
    first = fp1[diff] if diff < len(fp1) else "<missing>"
    second = fp2[diff] if diff < len(fp2) else "<missing>"
    return [Finding(
        code="SAN205", path=label, line=0,
        message=f"the collectives drift between two runs of the step "
                f"(first divergence at #{diff}: {first} vs {second}) — "
                f"something nondeterministic decides what the step sends")]


# ---------------------------------------------------------------------------
# The programs.
# ---------------------------------------------------------------------------

def _opt_moment(path) -> bool:
    return path[:1] == ("params",) or path[:2] in (("opt", "m"),
                                                   ("opt", "v"))


def sanitize_train(label: str, cfg, run, state, batch, layout=None, *,
                   sync_debug: bool = False, runs: int = 2):
    """SAN201 to SAN205 over ``runs`` calls of the train step (each with
    a fresh ``make_train_step``) on ``state``, which they update.
    Returns ``(findings, tapes, state)``."""
    from repro_torch.comm import primitives
    from repro_torch.train.step import make_train_step
    findings: List[Finding] = []
    tapes = []
    for i in range(runs):
        step = make_train_step(cfg, run, layout)
        before = storage({"params": state["params"], "opt": state["opt"]},
                         _opt_moment)
        with primitives.tape() as recs:
            out, found = watched(label, lambda: step(state, batch),
                                 sync_debug=sync_debug)
        state = out[0]
        tapes.append(list(recs))
        if i == 0:
            findings += found
            findings += check_storage(
                label, before,
                storage({"params": state["params"], "opt": state["opt"]},
                        _opt_moment), "param and moment")
            if layout is not None and layout.tokens > 1:
                findings += check_wire(label, recs, run.comm_dtype or
                                       "fp32")
    if runs > 1:
        findings += check_determinism(label, fingerprint(tapes[0]),
                                      fingerprint(tapes[1]))
    return findings, tapes, state


def _decode_leaf(device):
    """The cache leaves the decode step updates in place: ring (and cross
    memory) K/V and key positions; on the card also every linear and SSD
    state, which K3 updates in place (the plain version on the CPU
    returns new tensors by design)."""
    names = {"k", "v", "kpos"}
    if torch.device(device).type == "cuda":
        names |= {"m", "log_decay"}
    return lambda path: path[-1] in names


def sanitize_decode(label: str, cfg, params, token, cache, *,
                    sync_debug: bool = False, runs: int = 2):
    """SAN201, SAN202, SAN204 and SAN205 over ``runs`` calls of
    ``models.model.decode_step``. Returns ``(findings, cache)``."""
    from repro_torch.comm import primitives
    from repro_torch.models import model as M
    device = cache["pos"].device
    keep = _decode_leaf(device)
    findings: List[Finding] = []
    fps = []
    for i in range(runs):
        before = storage(cache["layers"], keep)
        with primitives.tape() as recs:
            out, found = watched(
                label, lambda: M.decode_step(params, token, cache, cfg),
                sync_debug=sync_debug)
        _, cache = out
        fps.append(fingerprint(recs))
        if i == 0:
            findings += found
            findings += check_storage(label, before,
                                      storage(cache["layers"], keep),
                                      "decode cache")
    if runs > 1:
        findings += check_determinism(label, fps[0], fps[1])
    return findings, cache


def smoke_cfg():
    from repro_torch.configs import get_smoke
    return get_smoke("linear-llama3-1b")


def hybrid_smoke_cfg():
    """The reference's tiny linear + softmax hybrid: the program that
    carries the Ulysses all-to-alls on a 3D layout, and the decode
    program with a ring cache."""
    from repro_torch.configs.base import (LayerSpec, LinearAttnConfig,
                                          ModelConfig)
    return ModelConfig(
        name="hybrid-smoke", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512,
        pattern=(LayerSpec(mixer="linear"), LayerSpec(mixer="softmax")),
        linear_attn=LinearAttnConfig(feature_map="identity", decay="none"))


def smoke_batch(cfg, *, micro: int = 1, rows: int = 8, seq: int = 64,
                seed: int = 0):
    """A (micro, rows, seq) batch of random tokens from ``seed``, labels
    shifted, document starts at the rows' first token."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (micro, rows, seq + 1),
                         generator=gen, dtype=torch.int32)
    resets = torch.zeros((micro, rows, seq), dtype=torch.bool)
    resets[..., 0] = True
    return {"tokens": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous(), "resets": resets}


def _state(cfg, run, device, layout=None, seed: int = 0):
    from repro_torch.train.step import init_state, zero1_degree
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return init_state(gen, cfg, device=device,
                      zero1=zero1_degree(run, layout), run=run)


def sanitize_one_device(device) -> List[Finding]:
    """The one-device SMOKE train step (bf16 compute on the card)."""
    from repro_torch.configs.base import RunConfig
    cfg = smoke_cfg()
    run = RunConfig(remat="none", num_microbatches=2, warmup_steps=0)
    state = _state(cfg, run, device)
    batch = {k: v.to(device) for k, v in
             smoke_batch(cfg, micro=2, rows=4).items()}
    warm = torch.device(device).type == "cuda"
    if warm:                       # builds and loads the kernels
        from repro_torch.train.step import make_train_step
        state, _ = make_train_step(cfg, run)(state, batch)
    return sanitize_train("train_step[one device]", cfg, run, state, batch,
                          sync_debug=warm)[0]


def sanitize_decode_smoke(device, batch: int = 2, max_len: int = 64
                          ) -> List[Finding]:
    """The decode step of the SMOKE hybrid (a linear layer and a ring)."""
    from repro_torch.models import model as M
    cfg = hybrid_smoke_cfg()
    gen = torch.Generator(device=torch.device(device)).manual_seed(0)
    params = M.init_params(gen, cfg, device=device)
    cache = M.init_cache(cfg, batch, max_len, device=device)
    token = torch.zeros((batch,), dtype=torch.int32, device=device)
    warm = torch.device(device).type == "cuda"
    if warm:
        _, cache = M.decode_step(params, token, cache, cfg)
    return sanitize_decode("decode_step[serve]", cfg, params, token, cache,
                           sync_debug=warm)[0]


# The reference's rank programs: (dp, sp, tp, strategy, hybrid config).
RANK_PROGRAMS = ((1, 8, 1, "allgather", False),
                 (2, 4, 1, "allgather", False),
                 (2, 2, 2, "ulysses", True))


def train_rank(rank, world, device, dp, sp, tp, strategy, hybrid):
    """One rank of a sanitized (dp, sp, tp) train step (bf16 on the wire,
    ZeRO-1): its findings as dicts and its two tapes' fingerprints."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_training_groups
    cfg = hybrid_smoke_cfg() if hybrid else smoke_cfg()
    layout = make_training_groups(dp, sp, tp)
    run = RunConfig(remat="none", comm_strategy=strategy, comm_dtype="bf16",
                    zero1=True, dp_degree=dp, sp_degree=sp, tp_degree=tp)
    label = (f"train_step[dp={dp},sp={sp},tp={tp},comm={strategy},"
             f"comm_dtype=bf16]")
    found, tapes, _ = sanitize_train(
        label, cfg, run, _state(cfg, run, device, layout),
        smoke_batch(cfg), layout)
    return {"findings": [f.to_dict() for f in found],
            "fingerprints": [fingerprint(t) for t in tapes]}


def sanitize_ranks(dp, sp, tp, strategy, hybrid, *, device="cpu"
                   ) -> List[Finding]:
    """A rank program on ``dp·sp·tp`` spawned gloo ranks; every rank's
    findings, each once."""
    from repro_torch.launch.mesh import run_ranks
    res = run_ranks(train_rank, dp * sp * tp, backend="gloo", device=device,
                    args=(dp, sp, tp, strategy, hybrid))
    seen, out = set(), []
    for r in res:
        for d in r["findings"]:
            key = (d["code"], d["path"], d["message"])
            if key not in seen:
                seen.add(key)
                out.append(Finding(**d))
    return out


def run_sanitizer(device="cuda", *, ranks: bool = True) -> AnalysisResult:
    """The battery: the one-device train step, the decode step and, with
    ``ranks``, the reference's three rank programs on gloo ranks."""
    result = AnalysisResult()
    result.findings += sanitize_one_device(device)
    result.findings += sanitize_decode_smoke(device)
    n = 2
    if ranks:
        for prog in RANK_PROGRAMS:
            result.findings += sanitize_ranks(*prog, device=device)
        n += len(RANK_PROGRAMS)
    result.checked["programs"] = n
    return result
