"""The allowlist marker the port's lint recognizes (twin of
``repro/analysis/decorators.py``).

Import-light on purpose: hot-path modules (``repro_torch.obs.metrics``,
``repro_torch.core.device``) import this at module load.
"""

from __future__ import annotations

HOST_SYNC_ATTR = "__torchlint_host_sync_allowed__"


def host_sync_allowed(fn):
    """Mark a function as a *deliberate* host-sync site (JL102 exempt).

    The legitimate holders are the fences: ``obs.metrics``'s helpers,
    which wait for the card so that phase walls charge queued work to
    the right phase and read a step's metrics after it, and
    ``core.device.synchronize``, which a host clock read waits on. The
    lint recognizes the decorator *textually* (any ``@host_sync_allowed``
    on the enclosing ``def``), so applying it shows in the diff; the
    runtime marker attribute is set too, so tooling can find the sites by
    import.
    """
    setattr(fn, HOST_SYNC_ATTR, True)
    return fn
