"""Device policy of the port's entry points.

``init_params``, ``ServeEngine`` and the serving CLI run on the CUDA card
unless the caller names another device. Without a card and without an
explicit request they raise: they never quietly continue on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card, which must exist; an explicit device
    (``"cpu"`` in the tests) is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run its plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ``"float32"``) → torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work, so a host clock read after it
    times device work and not its enqueue. No-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
