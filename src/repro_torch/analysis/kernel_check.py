"""PAL301: the guard-band battery (twin of ``repro/analysis/pallas_check.py``).

The reference evaluates every Pallas BlockSpec index map at every grid
point under ``eval_shape``. The port's grids are computed in the ``.cu``
host code, out of Python's sight, so its twin runs the kernels instead:
every route of every kernel (``sm90`` and ``simt`` of K1, K2a, K2b, K3,
K4, K5a and K5b) is launched through its C entry (the ``*_entry``
functions of ``repro_torch.kernels``, the wrappers' own launches) on
tensors that are views in the middle of larger buffers:

* an input's margins hold NaN: a read outside it turns an output
  non-finite (a masked lane multiplied by 0 stays NaN);
* an output's margins, and the output itself, hold a sentinel: a write
  outside it changes a margin, a tile left unwritten keeps the sentinel.

A case yields a finding when an output (or a state updated in place) is
not finite or differs from the plain version on the unpadded inputs by
more than ``LIMIT`` of its largest magnitude (a read outside the input,
or of the wrong rows), when a margin changed (a write outside), or when
an input changed. ``LIMIT`` is loose on purpose: parity proper is
``chip_smoke.py``'s phase 3; this catches rows and tiles out of place.

Variants follow the reference's battery: the chunk forward and both
backward passes; flash causal, causal with ``q_offset=0``, a window of
48, ``kv_len`` 100 short of Sk, and a nonzero ``q_offset`` (the LASP-2H
rank offset), each through K4, K5a and K5b; the decode step with and
without decay. Each runs at the smallest shape its route admits, with
lengths that are not tile multiples (S 100, Sq 72, Sk 136).

On the CPU the same harness drives the plain versions (``launch`` writes
their results into the output views), which is how the tests plant a
fault: a launch that writes one element past an output, or reads one
past an input, must be flagged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding

MARGIN = 4096                  # elements of guard band on each side
OUT_SENTINEL = -4097.0         # bf16- and fp32-exact
LIMIT = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
SEED = 0

S_CHUNK = 100                  # chunk rows: not a multiple of 64
SQ, SK = 72, 136               # flash lengths: not multiples of 64 / 128
WINDOW, KV_LEN, Q_OFFSET = 48, 100, 40


@dataclass
class Case:
    """One launch of one kernel route.

    ``inputs`` are host tensors made from the seed; ``outputs`` maps each
    output to its ``(shape, dtype)``; ``inout`` names the inputs the
    kernel updates in place (checked like outputs). ``entry(views)``
    launches the C entry on the card; ``plain(inputs)`` gives every
    output and in-place input on the host."""

    kernel: str
    name: str
    route: str
    inputs: Dict[str, torch.Tensor]
    outputs: Dict[str, Tuple[tuple, torch.dtype]]
    entry: Callable[[dict], None]
    plain: Callable[[dict], Dict[str, torch.Tensor]]
    inout: Tuple[str, ...] = ()
    limit_dtype: torch.dtype = torch.float32
    label: str = field(init=False)

    def __post_init__(self):
        self.label = f"{self.kernel} {self.name}"


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of ``t`` (NaN compares equal to itself)."""
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _guarded(shape, dtype, device, fill, value=None):
    """``(buffer, view)``: a flat buffer of ``numel + 2·MARGIN`` elements
    filled with ``fill``, and the ``shape`` view at offset ``MARGIN``
    (16-byte aligned for both dtypes), holding ``value`` if given."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.full((n + 2 * MARGIN,), fill, dtype=dtype, device=device)
    view = buf[MARGIN:MARGIN + n].view(shape)
    if value is not None:
        view.copy_(value)
    return buf, view


def _margins(buf: torch.Tensor):
    return buf[:MARGIN], buf[buf.numel() - MARGIN:]


def plain_launch(case: Case) -> Callable[[dict], None]:
    """The CPU's ``launch``: the plain versions' results written into the
    output views."""
    def launch(views):
        got = case.plain({k: views[k] for k in case.inputs})
        for k, v in got.items():
            views[k].copy_(v)
    return launch


def run_case(case: Case, device, launch: Optional[Callable] = None
             ) -> List[Finding]:
    """Launch ``case`` on guarded views on ``device`` (the C entry on the
    card, the plain versions on the CPU, or ``launch``) and return its
    findings."""
    device = torch.device(device)
    if launch is None:
        launch = case.entry if device.type == "cuda" else plain_launch(case)
    bufs, views = {}, {}
    for k, t in case.inputs.items():
        bufs[k], views[k] = _guarded(t.shape, t.dtype, device,
                                     float("nan"), t)
    for k, (shape, dtype) in case.outputs.items():
        bufs[k], views[k] = _guarded(shape, dtype, device, OUT_SENTINEL)
    before = {k: _bits(b).clone() for k, b in bufs.items()}
    err = None
    try:
        launch(views)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception as e:          # a launch error is a finding too
        err = e
    out: List[Finding] = []

    def find(msg):
        out.append(Finding(code="PAL301", path=case.label, line=0,
                           message=msg))

    if err is not None:
        find(f"launch failed: {type(err).__name__}: {err}")
        return out
    for k, b in bufs.items():
        lo, hi = _margins(_bits(b))
        blo, bhi = _margins(before[k])
        if not (torch.equal(lo, blo) and torch.equal(hi, bhi)):
            changed = int((lo != blo).sum()) + int((hi != bhi).sum())
            find(f"{k}: {changed} margin element(s) changed — a write "
                 f"outside the tensor")
    for k in case.inputs:
        if k in case.inout:
            continue
        end = bufs[k].numel() - MARGIN
        if not torch.equal(_bits(bufs[k])[MARGIN:end],
                           before[k][MARGIN:end]):
            find(f"{k}: an input changed")
    want = case.plain({k: t.clone() for k, t in case.inputs.items()})
    limit = LIMIT[case.limit_dtype]
    for k, w in want.items():
        got = views[k].detach().float().cpu()
        w = w.float()
        if not torch.isfinite(got).all():
            bad = int((~torch.isfinite(got)).sum())
            find(f"{k}: {bad} non-finite element(s) — a read outside an "
                 f"input")
            continue
        scale = max(float(w.abs().max()), 1e-6)
        e = float((got - w).abs().max()) / scale
        if e > limit:
            find(f"{k}: differs from the plain version by {e:.3g} of its "
                 f"largest magnitude (limit {limit:g}) — rows read or "
                 f"written out of place")
    return out


# ---------------------------------------------------------------------------
# The battery.
# ---------------------------------------------------------------------------

def _randn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen) * scale).to(dtype)


def _chunk_cases(gen) -> List[Case]:
    from repro_torch.kernels import lasp2_chunk as lc
    out = []
    # sm90: bf16 with dk = dv = 64 (its smallest); simt: fp32, dk 16, dv 64
    for route, dtype, dk, dv in (("sm90", torch.bfloat16, 64, 64),
                                 ("simt", torch.float32, 16, 64)):
        assert lc._route(dtype, dk, dv) == route
        bh, s = 2, S_CHUNK
        q = _randn(gen, bh, s, dk, scale=0.3, dtype=dtype)
        k = _randn(gen, bh, s, dk, scale=0.3, dtype=dtype)
        v = _randn(gen, bh, s, dv, scale=0.5, dtype=dtype)
        la = -_randn(gen, bh, s).abs() * 0.03
        o, _, _ = lc.lasp2_chunk_fwd_plain(q, k, v, la, block_size=s)
        do = _randn(gen, bh, s, dv, dtype=dtype)
        dst = _randn(gen, bh, dk, dv)
        tag = f"[{route},S={s},dk={dk},dv={dv}]"

        def fwd_plain(x):
            o_, st, ld = lc.lasp2_chunk_fwd_plain(
                x["q"], x["k"], x["v"], x["log_a"], block_size=s)
            return {"o": o_, "state": st, "log_decay": ld}

        def dq_plain(x):
            return {"dq": lc.lasp2_chunk_bwd_dq_plain(
                x["k"], x["v"], x["log_a"], x["do"], block_size=s)}

        def dkv_plain(x):
            dk_, dv_, dla = lc.lasp2_chunk_bwd_dkv_plain(
                x["q"], x["k"], x["v"], x["log_a"], x["o"], x["do"],
                x["dstate"], block_size=s)
            return {"dk": dk_, "dv": dv_, "dla": dla}

        out += [
            Case("K1", "lasp2_chunk_fwd" + tag, route,
                 {"q": q, "k": k, "v": v, "log_a": la},
                 {"o": ((bh, s, dv), dtype),
                  "state": ((bh, dk, dv), torch.float32),
                  "log_decay": ((bh,), torch.float32)},
                 lambda x, r=route: lc.fwd_entry(
                     r, x["q"], x["k"], x["v"], x["log_a"], x["o"],
                     x["state"], x["log_decay"]),
                 fwd_plain, limit_dtype=dtype),
            Case("K2a", "lasp2_chunk_bwd_dq" + tag, route,
                 {"k": k, "v": v, "log_a": la, "do": do},
                 {"dq": ((bh, s, dk), dtype)},
                 lambda x, r=route: lc.bwd_dq_entry(
                     r, x["k"], x["v"], x["log_a"], x["do"], x["dq"]),
                 dq_plain, limit_dtype=dtype),
            Case("K2b", "lasp2_chunk_bwd_dkv" + tag, route,
                 {"q": q, "k": k, "v": v, "log_a": la, "o": o, "do": do,
                  "dstate": dst},
                 {"dk": ((bh, s, dk), dtype), "dv": ((bh, s, dv), dtype),
                  "dla": ((bh, s), torch.float32)},
                 lambda x, r=route: lc.bwd_dkv_entry(
                     r, x["q"], x["k"], x["v"], x["log_a"], x["o"],
                     x["do"], x["dstate"], x["dk"], x["dv"], x["dla"]),
                 dkv_plain, limit_dtype=dtype),
        ]
    return out


FLASH_VARIANTS = {
    "causal": dict(causal=True),
    "causal,q_offset=0": dict(causal=True, q_offset=0),
    "window": dict(causal=True, window=WINDOW),
    "kv_len": dict(causal=True, kv_len=KV_LEN),
    "q_offset": dict(causal=True, q_offset=Q_OFFSET),
}


def _flash_cases(gen) -> List[Case]:
    from repro_torch.kernels import flash_attention as fl
    out = []
    # sm90: bf16 at dh 64 (its smallest); simt: fp32 at dh 16
    for route, dtype, dh in (("sm90", torch.bfloat16, 64),
                             ("simt", torch.float32, 16)):
        assert fl._route(dtype, dh) == route
        b, hq, hkv = 1, 4, 2                  # GQA 2:1, Sk != Sq
        q = _randn(gen, b, hq, SQ, dh, scale=0.4, dtype=dtype)
        k = _randn(gen, b, hkv, SK, dh, scale=0.4, dtype=dtype)
        v = _randn(gen, b, hkv, SK, dh, scale=0.5, dtype=dtype)
        do = _randn(gen, b, hq, SQ, dh, dtype=dtype)
        for variant, kw in FLASH_VARIANTS.items():
            scale, q_off, kv_len = fl._resolve(q, k, None, kw.get("q_offset"),
                                               kw.get("kv_len"))
            full = dict(causal=kw["causal"], window=kw.get("window"),
                        scale=scale, q_offset=q_off, kv_len=kv_len)
            o, lse = fl.flash_attention_fwd_plain(q, k, v, **full)
            delta = (do.float() * o.float()).sum(-1)
            tag = f"[{route},{variant},dh={dh}]"

            def fwd_plain(x, full=full):
                o_, lse_ = fl.flash_attention_fwd_plain(
                    x["q"], x["k"], x["v"], **full)
                return {"o": o_, "lse": lse_}

            def dq_plain(x, full=full):
                return {"dq": fl.flash_attention_bwd_dq_plain(
                    x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                    **full)}

            def dkv_plain(x, full=full):
                dk_, dv_ = fl.flash_attention_bwd_dkv_plain(
                    x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                    **full)
                return {"dk": dk_, "dv": dv_}

            bwd_in = {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                      "delta": delta}
            out += [
                Case("K4", "flash_attention_fwd" + tag, route,
                     {"q": q, "k": k, "v": v},
                     {"o": (tuple(q.shape), dtype),
                      "lse": (tuple(q.shape[:3]), torch.float32)},
                     lambda x, r=route, full=full: fl.fwd_entry(
                         r, x["q"], x["k"], x["v"], x["o"], x["lse"],
                         **full),
                     fwd_plain, limit_dtype=dtype),
                Case("K5a", "flash_attention_bwd_dq" + tag, route, bwd_in,
                     {"dq": (tuple(q.shape), dtype)},
                     lambda x, r=route, full=full: fl.bwd_dq_entry(
                         r, x["q"], x["k"], x["v"], x["do"], x["lse"],
                         x["delta"], x["dq"], **full),
                     dq_plain, limit_dtype=dtype),
                Case("K5b", "flash_attention_bwd_dkv" + tag, route, bwd_in,
                     {"dk": (tuple(k.shape), dtype),
                      "dv": (tuple(v.shape), dtype)},
                     lambda x, r=route, full=full: fl.bwd_dkv_entry(
                         r, x["q"], x["k"], x["v"], x["do"], x["lse"],
                         x["delta"], x["dk"], x["dv"], **full),
                     dkv_plain, limit_dtype=dtype),
            ]
    return out


def _decode_cases(gen) -> List[Case]:
    from repro_torch.kernels import lasp2_decode as dc
    out = []
    # sm90: dk 16, dv 4 (its smallest); simt: dk 16 with dv 6 (no
    # multiple of 4), which the table sends there
    for route, dtype, dk, dv, decay in (
            ("sm90", torch.bfloat16, 16, 4, True),
            ("sm90", torch.float32, 16, 4, False),
            ("simt", torch.float32, 16, 6, True)):
        assert dc._route(dtype, dk, dv) == route
        bh = 5
        ins = {"q": _randn(gen, bh, dk, scale=0.3, dtype=dtype),
               "k": _randn(gen, bh, dk, scale=0.3, dtype=dtype),
               "v": _randn(gen, bh, dv, scale=0.5, dtype=dtype),
               "state": _randn(gen, bh, dk, dv),
               "log_decay": -_randn(gen, bh).abs()}
        if decay:
            ins["log_a"] = -_randn(gen, bh).abs() * 0.1

        def plain(x):
            o, st, ld = dc.lasp2_decode_step_plain(
                x["q"], x["k"], x["v"], x.get("log_a"), x["state"],
                x["log_decay"])
            return {"o": o, "state": st, "log_decay": ld}

        tag = f"[{route},{str(dtype).split('.')[-1]},dk={dk},dv={dv}" \
              f"{'' if decay else ',no decay'}]"
        out.append(Case(
            "K3", "lasp2_decode_step" + tag, route, ins,
            {"o": ((bh, dv), torch.float32)},
            lambda x, r=route: dc.entry_launch(
                r, x["q"], x["k"], x["v"], x.get("log_a"), x["state"],
                x["log_decay"], x["o"]),
            plain, inout=("state", "log_decay")))
    return out


def battery_cases(seed: int = SEED) -> List[Case]:
    """Every case of the battery, its inputs made on the host from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return _chunk_cases(gen) + _flash_cases(gen) + _decode_cases(gen)


def routes(cases: List[Case]) -> List[Tuple[str, str]]:
    """The distinct (kernel, route) pairs ``cases`` cover."""
    return sorted({(c.kernel, c.route) for c in cases})


def check_kernels(device="cuda", cases: Optional[List[Case]] = None):
    """Run the battery on ``device``; returns ``(findings, cases run)``."""
    cases = battery_cases() if cases is None else cases
    findings: List[Finding] = []
    for case in cases:
        findings += run_case(case, device)
    return findings, len(cases)
