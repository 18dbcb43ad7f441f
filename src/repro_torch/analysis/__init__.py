"""The port's analysis subsystem (twin of ``repro/analysis``).

Three checks over the port:

* **the lint** (``lint`` + ``rules``): AST rules JL101, JL102, JL104 and
  JL105 over the port's Python files and, for JL105, its CUDA sources
  (axis-name literals, host syncs, nondeterminism, debug debris);
* **the kernel battery** (``kernel_check``, PAL301): every route of every
  kernel launched on inputs and outputs that sit in the middle of larger
  buffers, to catch reads and writes outside them;
* **the sanitizer** (``sanitizer``, SAN201 to SAN205): one call of the
  train or decode step under a dispatch mode and the collective tape (no
  host sync, no float64, bf16 on the wire, storage kept, the same
  collectives twice).

CLI: ``python -m repro_torch.analysis`` (``--explain CODE``, ``--json
OUT``, ``--device cpu``). This module stays import-light: nothing here
imports torch.
"""

from repro_torch.analysis.decorators import host_sync_allowed
from repro_torch.analysis.findings import AnalysisResult, Finding

__all__ = ["AnalysisResult", "Finding", "host_sync_allowed"]
