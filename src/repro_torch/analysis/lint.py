"""torchlint runner: file discovery, rule scoping, suppressions (twin of
``repro/analysis/lint.py``).

Discovery covers the port: ``src/repro_torch/`` (its Python files and the
CUDA sources under ``kernels/csrc/``), ``tests/test_torch_*.py``,
``tests/torch_*.py`` and ``chip_smoke.py``, skipping ``__pycache__``.
Two suppression mechanisms:

* inline: ``# torchlint: disable=JL102`` (``//`` in a CUDA source;
  comma-separated codes) on the offending line;
* the suppression file ``src/repro_torch/analysis/suppressions.txt``:
  lines of ``<repo-relative-path> <CODE>``. It stays EMPTY for the
  hot-path modules: violations there get fixed, not listed.

Suppressed findings are still collected (``AnalysisResult.suppressed``).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import AnalysisResult, Finding
from repro_torch.analysis.rules import RULES, FileContext

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", ".ruff_cache",
              "node_modules"}
_CUDA_SUFFIXES = (".cu", ".cuh")

# JL102 scope: hot-path modules (src/repro_torch-relative) and the obs
# fencing helpers (whose deliberate sites carry @host_sync_allowed).
_SYNC_PREFIXES = ("core/", "kernels/", "comm/")
_SYNC_FILES = ("train/step.py", "obs/metrics.py")
# JL104 scope: the hot path. kernels/_build.py times the nvcc build on
# the host before any kernel runs: its clock reaches no tensor.
_DET_PREFIXES = ("core/", "kernels/", "comm/")
_DET_FILES = ("train/step.py",)
_DET_EXEMPT = ("kernels/_build.py",)

_AXIS_EXEMPT = ("launch/mesh.py",)

_DISABLE_RE = re.compile(r"(?:#|//)\s*torchlint:\s*disable=([A-Z0-9,\s]+)")

SUPPRESSION_FILE = Path(__file__).resolve().parent / "suppressions.txt"


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _keep(p: Path) -> bool:
    return not any(part in _SKIP_DIRS for part in p.parts)


def discover_files(root: Optional[Path] = None) -> List[Path]:
    """The port's files under ``root`` (the checkout by default); a file
    is itself; a directory that is not a checkout gives its Python and
    CUDA files."""
    root = Path(root) if root else repo_root()
    if root.is_file():
        return [root]
    pkg = root / "src" / "repro_torch"
    if not pkg.is_dir():
        return [p for p in sorted(root.rglob("*"))
                if p.suffix in (".py",) + _CUDA_SUFFIXES and _keep(p)]
    out = [p for p in sorted(pkg.rglob("*.py")) if _keep(p)]
    out += [p for p in sorted((pkg / "kernels" / "csrc").glob("*"))
            if p.suffix in _CUDA_SUFFIXES]
    tests = root / "tests"
    if tests.is_dir():
        out += sorted(tests.glob("test_torch_*.py"))
        out += sorted(tests.glob("torch_*.py"))
    smoke = root / "chip_smoke.py"
    if smoke.is_file():
        out.append(smoke)
    return out


def _port_rel(path: Path, root: Path) -> Optional[str]:
    """src/repro_torch-relative posix path, or None outside it."""
    try:
        return path.resolve().relative_to(
            (root / "src" / "repro_torch").resolve()).as_posix()
    except ValueError:
        return None


def _inline_disabled(text: str) -> dict:
    """line number -> set of disabled codes."""
    out = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def load_suppressions(path: Optional[Path] = None) -> List[Tuple[str, str]]:
    path = path or SUPPRESSION_FILE
    entries: List[Tuple[str, str]] = []
    if not Path(path).exists():
        return entries
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(
                f"{path}: bad suppression line {raw!r} "
                f"(want '<repo-relative-path> <CODE>')")
        entries.append((parts[0], parts[1]))
    return entries


def _suppressed_by_file(f: Finding,
                        entries: Sequence[Tuple[str, str]]) -> bool:
    return any(f.code == code and f.path.endswith(path)
               for path, code in entries)


def make_context(path: Path, *, root: Optional[Path] = None,
                 text: Optional[str] = None,
                 sync_scope: Optional[bool] = None,
                 det_scope: Optional[bool] = None) -> FileContext:
    root = Path(root) if root else repo_root()
    text = path.read_text() if text is None else text
    rel = _port_rel(path, root)
    try:
        display = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        display = str(path)
    auto_sync = rel is not None and (rel.startswith(_SYNC_PREFIXES)
                                     or rel in _SYNC_FILES)
    auto_det = rel is not None and rel not in _DET_EXEMPT and (
        rel.startswith(_DET_PREFIXES) or rel in _DET_FILES)
    return FileContext(
        path=display, text=text,
        sync_scope=auto_sync if sync_scope is None else sync_scope,
        det_scope=auto_det if det_scope is None else det_scope,
        axis_exempt=rel in _AXIS_EXEMPT,
        cuda=path.suffix in _CUDA_SUFFIXES)


def lint_file(path: Path, *, root: Optional[Path] = None,
              text: Optional[str] = None,
              sync_scope: Optional[bool] = None,
              det_scope: Optional[bool] = None,
              codes: Optional[Set[str]] = None) -> List[Finding]:
    """All raw findings for one file (no suppression filtering)."""
    ctx = make_context(Path(path), root=root, text=text,
                       sync_scope=sync_scope, det_scope=det_scope)
    findings: List[Finding] = []
    for code, (_title, rule) in RULES.items():
        if codes is not None and code not in codes:
            continue
        findings.extend(rule(ctx))
    return findings


def run_lint(paths: Optional[Iterable[Path]] = None, *,
             root: Optional[Path] = None,
             suppressions: Optional[Sequence[Tuple[str, str]]] = None
             ) -> AnalysisResult:
    root = Path(root) if root else repo_root()
    files = [Path(p) for p in paths] if paths else discover_files(root)
    if suppressions is None:
        suppressions = load_suppressions()
    result = AnalysisResult()
    for path in files:
        text = path.read_text()
        disabled = _inline_disabled(text)
        for f in lint_file(path, root=root, text=text):
            if f.code in disabled.get(f.line, ()) \
                    or _suppressed_by_file(f, suppressions):
                result.suppressed.append(f)
            else:
                result.findings.append(f)
    result.checked["files"] = len(files)
    return result
