"""Finding records shared by the port's checks (twin of
``repro/analysis/findings.py``, the same fields and the same JSON).

A :class:`Finding` is one violation: from the AST lint (``JL*`` codes,
anchored to a source line), the kernel guard-band battery (``PAL301``,
anchored to a kernel and variant) or the step sanitizer (``SAN*`` codes,
anchored to a program label). All three emit one machine-readable shape,
so one JSON document holds a whole run and ``scripts/report.py`` can
render it.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List


@dataclass
class Finding:
    """One violation.

    ``path`` is the offending file (AST rules), a kernel variant like
    ``K1 lasp2_chunk_fwd[sm90]`` (battery) or a program label like
    ``train_step[dp=2,sp=4]`` (sanitizer). ``line`` is 1-based; 0 means
    "whole program". ``source`` carries the offending source line or op.
    """

    code: str
    path: str
    line: int
    message: str
    col: int = 0
    source: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.code} {self.message}"


@dataclass
class AnalysisResult:
    """Everything one analysis run produced: surviving findings, what was
    suppressed, and what was checked."""

    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    checked: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return out

    def extend(self, other: "AnalysisResult") -> None:
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        for k, v in other.checked.items():
            self.checked[k] = self.checked.get(k, 0) + v

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "counts": self.counts(),
                "checked": dict(self.checked),
                "findings": [f.to_dict() for f in self.findings],
                "suppressed": [f.to_dict() for f in self.suppressed]}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)
