"""One validated communication spec (twin of ``repro/comm/spec.py``).

The three knobs of the sequence-parallel exchanges, the strategy, the
overlap mode and the wire dtype, travel as one frozen value from
``RunConfig.comm_spec()`` through ``core.lasp2.SPConfig`` to the layers.
The reference's deprecation shim (``resolve_comm_spec`` and the loose
keywords it folds in) serves JAX call sites the port never had, so the
port has none.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.comm.primitives import _COMM_DTYPES
from repro_torch.comm.strategy import OVERLAP_MODES, registered_strategies


@dataclass(frozen=True)
class CommSpec:
    """``strategy``: a name in ``comm.strategy.registered_strategies()``;
    ``overlap``: one of ``OVERLAP_MODES`` ("overlap" | "none");
    ``dtype``: the wire dtype ("fp32" | "bf16")."""

    strategy: str = "allgather"
    overlap: str = "overlap"
    dtype: str = "fp32"

    def __post_init__(self):
        names = registered_strategies()
        if self.strategy not in names:
            raise ValueError(f"unknown comm strategy {self.strategy!r}; "
                             f"expected one of {names}")
        if self.overlap not in OVERLAP_MODES:
            raise ValueError(f"unknown overlap mode {self.overlap!r}; "
                             f"expected one of {OVERLAP_MODES}")
        if self.dtype not in _COMM_DTYPES:
            raise ValueError(f"unknown comm_dtype {self.dtype!r}; expected "
                             f"one of {tuple(_COMM_DTYPES)}")
