"""torchlint: the port's AST and source rules (twin of
``repro/analysis/rules.py``).

Each rule has a code, a one-line title and an ``--explain`` text
(``python -m repro_torch.analysis --explain JL102``). Rules are plain
functions ``rule(ctx) -> list[Finding]`` over a :class:`FileContext`; the
runner (``repro_torch.analysis.lint``) handles discovery, scoping, the
inline ``# torchlint: disable=CODE`` marker and the suppression file.

Scoping, decided per file by the runner:

* JL101 (axis literals) runs on every discovered Python file;
* JL102 (host syncs) on the hot-path modules ``core/``, ``kernels/``,
  ``comm/``, ``train/step.py`` and ``obs/metrics.py`` (whose deliberate
  fences carry ``@host_sync_allowed``);
* JL104 (nondeterminism) on ``core/``, ``kernels/``, ``comm/`` and
  ``train/step.py``, less ``kernels/_build.py``;
* JL105 (debug debris) on the CUDA sources (``printf`` in device code,
  ``CUDA_LAUNCH_BLOCKING``) and every Python file (``-G`` or
  ``-lineinfo`` in ``NVCC_FLAGS``, ``CUDA_LAUNCH_BLOCKING`` set).

The reference's JL103 (a Tracer isinstance) and JL106 (an unmasked
dynamic ``pl.load``) have no meaning in eager PyTorch and CUDA C++: eager
code has no tracer, and the kernel battery (``kernel_check``, PAL301)
catches an unmasked read or write at run time.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding
# The axis words come from the port's Axis members, never spelled here:
# the reference's JL101 walks this file too.
from repro_torch.launch.mesh import Axis

AXIS_NAMES = frozenset(a.name.lower() for a in Axis)

# Non-axis meanings the axis words also carry (JL101 deny contexts): the
# data-dependent decay *kind* of linear-attention configs and phase-timer
# labels.
_KIND_NAMES = {"decay", "kind"}
_KIND_CALLS = {"phase", "LinearAttnConfig"}

_HOST_SYNC_DECORATOR = "host_sync_allowed"


# ---------------------------------------------------------------------------
# File context.
# ---------------------------------------------------------------------------

@dataclass
class FileContext:
    """One file plus the per-node bookkeeping rules need: a Python file
    parsed to its AST, or a CUDA source (``cuda``) kept as text."""

    path: str                      # display path (repo-relative)
    text: str
    sync_scope: bool = False       # JL102 applies
    det_scope: bool = False        # JL104 applies
    axis_exempt: bool = False      # JL101 skipped
    cuda: bool = False             # a .cu / .cuh source: text rules only
    tree: Optional[ast.AST] = None
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.lines = self.text.splitlines()
        if self.cuda:
            return
        self.tree = ast.parse(self.text, filename=self.path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def src(self, node) -> str:
        ln = getattr(node, "lineno", 0)
        return self.lines[ln - 1].strip() if 0 < ln <= len(self.lines) else ""

    def finding(self, code, node, message) -> Finding:
        return Finding(code=code, path=self.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, source=self.src(node))

    def line_finding(self, code, line, message) -> Finding:
        src = self.lines[line - 1].strip() if line <= len(self.lines) else ""
        return Finding(code=code, path=self.path, line=line, message=message,
                       source=src)

    def ancestors(self, node):
        while node in self.parents:
            node = self.parents[node]
            yield node

    def in_host_sync_allowed(self, node) -> bool:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in anc.decorator_list:
                    if _terminal_name(dec) == _HOST_SYNC_DECORATOR:
                        return True
        return False


def _terminal_name(node) -> Optional[str]:
    """Rightmost identifier of a Name/Attribute/Call chain."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _base_name(node) -> Optional[str]:
    """Leftmost identifier: ``np.random.normal`` -> ``np``."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node) -> str:
    """``torch.cuda.synchronize`` for that attribute chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ---------------------------------------------------------------------------
# JL101 — raw axis-name string literals.
# ---------------------------------------------------------------------------

def _axis_literal_denied(ctx: FileContext, node: ast.Constant) -> bool:
    """True when an axis-word literal is *not* a mesh-axis usage."""
    prev = node
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.Compare):
            others = [anc.left] + list(anc.comparators)
            for other in others:
                if other is prev:
                    continue
                if _terminal_name(other) in _KIND_NAMES:
                    return True
        if isinstance(anc, ast.keyword) and anc.arg in _KIND_NAMES:
            return True
        if isinstance(anc, ast.Call):
            if _terminal_name(anc.func) in _KIND_CALLS:
                return True
            return False        # any other call: axis context, flag it
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef, ast.Module)):
            return False
        prev = anc
    return False


def check_axis_literals(ctx: FileContext) -> List[Finding]:
    if ctx.cuda or ctx.axis_exempt:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value in AXIS_NAMES
                and not _axis_literal_denied(ctx, node)):
            out.append(ctx.finding(
                "JL101", node,
                f'raw axis-name literal "{node.value}" — use a member of '
                f"repro_torch.launch.mesh.Axis (DATA / SEQUENCE / MODEL / "
                f"POD)"))
    return out


# ---------------------------------------------------------------------------
# JL102 — host syncs in hot-path modules.
# ---------------------------------------------------------------------------

_SYNC_NAMES = {"block_until_ready", "device_get"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
# tensor methods that copy to the host (no arguments: ``.cpu()``), and
# the named device-wide fence
_TENSOR_SYNC_METHODS = {"tolist", "cpu", "numpy"}
_CUDA_SYNC = {"torch.cuda.synchronize", "cuda.synchronize"}


def _sync_call(node: ast.Call) -> Optional[str]:
    f = node.func
    name = _terminal_name(f)
    bare = not node.args and not node.keywords
    if isinstance(f, ast.Name) and name == "print":
        return "print()"
    if isinstance(f, ast.Attribute) and _dotted(f) in _CUDA_SYNC:
        return "torch.cuda.synchronize()"
    if name in _SYNC_NAMES:
        return f"{name}()"
    if isinstance(f, ast.Attribute) and name == "item" and bare:
        return ".item()"
    if isinstance(f, ast.Attribute) and name in _TENSOR_SYNC_METHODS \
            and bare and _base_name(f.value) not in _NUMPY_ALIASES:
        return f".{name}()"
    if (isinstance(f, ast.Attribute) and name == "asarray"
            and _base_name(f.value) in _NUMPY_ALIASES):
        return "np.asarray()"
    return None


def check_host_syncs(ctx: FileContext) -> List[Finding]:
    if ctx.cuda or not ctx.sync_scope:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _sync_call(node)
        if what is None or ctx.in_host_sync_allowed(node):
            continue
        out.append(ctx.finding(
            "JL102", node,
            f"host-sync call {what} in a hot-path module — the host waits "
            f"for the card and the launch queue drains; return device "
            f"values and read them after the caller's fence "
            f"(repro_torch.obs), or mark a deliberate fence with "
            f"@host_sync_allowed"))
    return out


# ---------------------------------------------------------------------------
# JL104 — nondeterminism sources in the hot path.
# ---------------------------------------------------------------------------

_NONDET_MODULES = {"time", "random"}
# torch's draws from the global generator unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}


def _torch_global_draw(node: ast.Call) -> Optional[str]:
    f = node.func
    if not isinstance(f, ast.Attribute) or _base_name(f) != "torch":
        return None
    if f.attr == "manual_seed":
        return _dotted(f)
    if f.attr in _TORCH_DRAWS \
            and not any(kw.arg == "generator" for kw in node.keywords):
        return _dotted(f)
    return None


def check_nondeterminism(ctx: FileContext) -> List[Finding]:
    if ctx.cuda or not ctx.det_scope:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in _NONDET_MODULES:
                    out.append(ctx.finding(
                        "JL104", node,
                        f"import of '{alias.name}' in the hot path — a "
                        f"clock or the host RNG makes two runs of a step "
                        f"differ; pass seeds and timestamps in"))
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] in _NONDET_MODULES:
                out.append(ctx.finding(
                    "JL104", node,
                    f"import from '{node.module}' in the hot path (see "
                    f"JL104 --explain)"))
        elif (isinstance(node, ast.Attribute) and node.attr == "random"
                and _base_name(node) in _NUMPY_ALIASES):
            out.append(ctx.finding(
                "JL104", node,
                "np.random in the hot path — the host RNG's global state "
                "breaks bitwise replay; take a torch.Generator"))
        elif isinstance(node, ast.Call):
            what = _torch_global_draw(node)
            if what is not None:
                out.append(ctx.finding(
                    "JL104", node,
                    f"{what}() on torch's global generator — the port's "
                    f"rule is an explicit generator=: a draw from global "
                    f"state depends on whatever drew before it"))
    return out


# ---------------------------------------------------------------------------
# JL105 — debug debris in the kernels and their build.
# ---------------------------------------------------------------------------

_DEBUG_NVCC = {"-G", "--device-debug", "-lineinfo", "--generate-line-info"}
_LAUNCH_BLOCKING = "CUDA_LAUNCH_BLOCKING"
_CUDA_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CUDA_STRING = re.compile(r'"(?:\\.|[^"\\])*"')
_DEVICE_FN = re.compile(r"\b__(?:global|device)__\b")
_PRINTF = re.compile(r"\bprintf\s*\(")


def _blank(match) -> str:
    """The match with every character but newlines made a space (line
    numbers stay)."""
    return re.sub(r"[^\n]", " ", match.group(0))


def _device_spans(code: str) -> List[Tuple[int, int]]:
    """``[start, end)`` character spans of the bodies of ``__global__`` and
    ``__device__`` functions (comments and strings already blanked): from
    the first ``{`` after the qualifier to its matching ``}``. A
    declaration that ends at ``;`` first has no body."""
    spans = []
    for m in _DEVICE_FN.finditer(code):
        i = m.end()
        while i < len(code) and code[i] not in "{;":
            i += 1
        if i >= len(code) or code[i] == ";":
            continue
        depth, j = 0, i
        while j < len(code):
            if code[j] == "{":
                depth += 1
            elif code[j] == "}":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        spans.append((i, j + 1))
    return spans


def _check_cuda_debris(ctx: FileContext) -> List[Finding]:
    out = []
    stripped = _CUDA_COMMENT.sub(_blank, ctx.text)
    code = _CUDA_STRING.sub(_blank, stripped)
    spans = _device_spans(code)
    for m in _PRINTF.finditer(code):
        if any(a <= m.start() < b for a, b in spans):
            out.append(ctx.line_finding(
                "JL105", code.count("\n", 0, m.start()) + 1,
                "printf in device code — debug scaffolding; every thread "
                "that reaches it writes to a buffer the host drains at the "
                "next sync"))
    for m in re.finditer(_LAUNCH_BLOCKING, stripped):
        out.append(ctx.line_finding(
            "JL105", stripped.count("\n", 0, m.start()) + 1,
            f"{_LAUNCH_BLOCKING} set in a kernel source — every launch "
            f"then waits for the card"))
    return out


def _sets_launch_blocking(node: ast.AST) -> bool:
    """``os.environ[...] = ...``, ``os.environ.setdefault(...)``,
    ``os.putenv(...)`` or ``os.environ.update(...)`` naming
    ``CUDA_LAUNCH_BLOCKING``."""
    def names_it(sub):
        return any(isinstance(n, ast.Constant) and n.value == _LAUNCH_BLOCKING
                   for n in ast.walk(sub))
    if isinstance(node, ast.Assign):
        return any(isinstance(t, ast.Subscript) and names_it(t.slice)
                   for t in node.targets)
    if isinstance(node, ast.Call) and _terminal_name(node.func) in (
            "setdefault", "putenv", "update", "__setitem__"):
        return any(names_it(a) for a in node.args) \
            or any(kw.arg == _LAUNCH_BLOCKING for kw in node.keywords)
    return False


def check_debug_debris(ctx: FileContext) -> List[Finding]:
    if ctx.cuda:
        return _check_cuda_debris(ctx)
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                for t in node.targets):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(
                        sub.value, str) and sub.value in _DEBUG_NVCC:
                    out.append(ctx.finding(
                        "JL105", sub,
                        f"nvcc flag {sub.value} in NVCC_FLAGS — device "
                        f"debug info turns optimisation off (-G) or bloats "
                        f"every library; pass it by hand when debugging"))
        if _sets_launch_blocking(node):
            out.append(ctx.finding(
                "JL105", node,
                f"{_LAUNCH_BLOCKING} set in code — every launch then waits "
                f"for the card; set it in the shell when debugging"))
    return out


# ---------------------------------------------------------------------------
# Registry + explain docs.
# ---------------------------------------------------------------------------

Rule = Callable[[FileContext], List[Finding]]

RULES: Dict[str, Tuple[str, Rule]] = {
    "JL101": ("raw axis-name string literal", check_axis_literals),
    "JL102": ("host sync in the hot path", check_host_syncs),
    "JL104": ("nondeterminism in the hot path", check_nondeterminism),
    "JL105": ("kernel debug debris", check_debug_debris),
}

EXPLAIN: Dict[str, str] = {
    "JL101": """\
JL101 — raw axis-name string literal

The mesh axes are the members of repro_torch.launch.mesh.Axis (DATA,
SEQUENCE, MODEL, POD); the port spells their names nowhere. Layouts,
plans, budgets and tests name an axis by its member, so renaming one is
a change the interpreter checks instead of a repo-wide search with
silent misses. The reference's own JL101 walks tests/ and src/ — the
port's files included — so an axis word as a literal fails both lints.
MODEL is a live axis (the 3D DP×SP×TP layout's Ulysses head group).

Denied contexts (not flagged): the words are also linear-attention decay
kinds (cfg.linear_attn.decay == ...) and phase-timer labels: comparisons
with names or attributes called `decay`/`kind`, `decay=`/`kind=`
keywords, and arguments of `phase(...)`/`LinearAttnConfig(...)`.

Fix: from repro_torch.launch.mesh import Axis; Axis.SEQUENCE.
""",
    "JL102": """\
JL102 — host sync in a hot-path module

.item(), .tolist(), .cpu(), .numpy(), np.asarray, torch.cuda.synchronize,
block_until_ready and print() make the host wait for the card: the
launch queue drains and the next kernel starts only after a round trip.
In the hot path (core/, kernels/, comm/, train/step.py, obs/metrics.py)
that is a stall every step, and a step that waits cannot be captured as
one CUDA graph. float(t), int(t) and bool(t) of a tensor sync too but
cannot be told from host numbers by reading the source; the sanitizer's
SAN201 catches them at run time.

The fences are the legitimate holders: obs/metrics.py's helpers wait so
that phase walls charge queued work to the right phase and read a step's
metrics after it, core/device.synchronize before a host clock read, and
comm/primitives' gloo staging, which must copy device tensors through
host memory. They carry
@repro_torch.analysis.decorators.host_sync_allowed, which exempts the
enclosing function.

Fix: return 0-d device tensors and read them after the caller's fence
(repro_torch.obs.metrics.to_host); make a branch a torch.where.
""",
    "JL104": """\
JL104 — time/random/np.random or torch's global RNG in the hot path

The hot path (core/, kernels/, comm/, train/step.py) must give the same
result from the same inputs: a host clock read or a draw from a global
RNG makes two runs of a step differ, and the sanitizer's SAN205 then
sees the collectives drift. The port's rule is explicit generators:
torch.rand*, torch.randint, torch.randperm, torch.normal and friends
take generator=, and torch.manual_seed (which resets global state) is
not called there at all.

kernels/_build.py is exempt by name: it times the nvcc build on the
host, before any kernel runs, and its clock reads reach no tensor.

Fix: take a torch.Generator as an argument; timestamps belong to the
drivers (train/loop.py, repro_torch.obs).
""",
    "JL105": """\
JL105 — kernel debug debris

printf in device code (a __global__ or __device__ function body) writes
through a buffer the host drains at the next sync, from every thread
that reaches it; -G or -lineinfo in NVCC_FLAGS turns device optimisation
off or puts line tables into every library the port builds;
CUDA_LAUNCH_BLOCKING set in code (Python or a kernel source) makes every
launch wait for the card. All are debugging scaffolding.

Fix: delete the printf; pass debug flags to nvcc by hand; set
CUDA_LAUNCH_BLOCKING=1 in the shell for one debugging run.
""",
    "PAL301": """\
PAL301 — a kernel reads or writes outside its tensors

The guard-band battery (repro_torch.analysis.kernel_check) calls every
route of every kernel (K1, K2a, K2b, K3, K4, K5a, K5b) through its C
entry with each input and output a view in the middle of a larger
buffer: the margins of an input hold NaN, the margins of an output a
sentinel. A non-finite output, or one that differs from the plain
version on the unpadded inputs, is a read outside the input (or a wrong
one); a changed margin is a write outside the output. Lengths are not
tile multiples and every route runs at the smallest shape it admits,
with the reference battery's variants (chunk forward and both backward
passes; flash causal, q_offset 0, a window, kv_len short of Sk and a
nonzero q_offset; the decode step).

Fix: bound the tail tile's loads and stores by the true length (TMA
clips by the tensor map; a plain load needs its row test).
""",
    "SAN201": """\
SAN201 — host sync inside a step

One call of the train or decode step runs under a TorchDispatchMode that
flags aten._local_scalar_dense (behind .item(), float(t), int(t),
bool(t)), the ops whose output shape depends on the data (nonzero,
masked_select, unique), aten.equal and copies from the card to the CPU.
On the card the call also runs under
torch.cuda.set_sync_debug_mode("error"), which raises at any
synchronizing call the mode cannot see. A step with a host sync cannot
be captured as one CUDA graph and drains the launch queue every step.
""",
    "SAN202": """\
SAN202 — float64 in a step

No tensor that enters or leaves an op of the train or decode step is
float64 or complex128: one means a numpy float64 or a Python-side
promotion reached the card, doubling bytes and leaving the tensor
cores (the H100's fp64 rate is a fraction of its fp32 rate).
""",
    "SAN203": """\
SAN203 — comm_dtype=bf16 exchange not bf16 on the wire

With comm_dtype="bf16", every exchange on the collective tape
(comm.primitives.tape()) carries bf16, except those comm/budget.py names
as fp32 by design: the packed gradient all-reduce (train.grads), the
ZeRO-1 parameter gather and checkpoint gather, Ulysses' all-to-alls and
their K/V gathers (compute dtype), the flash-decoding merge and the
serving exchanges. A tape with no bf16 exchange at all is flagged too:
the check would be vacuous (did the LASP-2 exchange run?).
""",
    "SAN204": """\
SAN204 — state that should stay in place got new storage

The reference donates the train state and the decode cache; the port
updates them in place. After one step every param and every Adam moment
holds the same storage (data_ptr) as before it, and so do the decode
cache's ring K/V and key positions and, on the card, every linear and
SSD state (K3 updates them in place; the plain version on the CPU
returns new tensors by design). New storage means a copy of the params,
the moments or the cache per step: peak memory doubles for them.
""",
    "SAN205": """\
SAN205 — the collectives drift between two runs of a step

Two runs of the same step, each with fresh closures, issue the same
sequence of collectives (op, tag, dtype, shape, group size) on the tape.
A drift means something nondeterministic decides what the step sends —
dict ordering, a host clock, a global RNG (JL104's run-time twin) — and
the collective budgets stop meaning anything.
""",
}


def explain(code: str) -> str:
    try:
        return EXPLAIN[code.upper()]
    except KeyError:
        known = ", ".join(sorted(EXPLAIN))
        raise KeyError(f"unknown rule code {code!r}; known: {known}")
