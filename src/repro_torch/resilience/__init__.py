"""Fault tolerance of the port (twin of ``repro/resilience``).

* :mod:`repro_torch.resilience.guard`: the numerical health guard of the
  train steps (the loss-health scalar rides the one gradient all-reduce,
  rolling-median spike clipping, skip counters, the consecutive-skip
  abort).
* :mod:`repro_torch.resilience.chaos`: deterministic fault injectors for
  the drill and the tests (checkpoint corruption, flaky and killed saves,
  SIGTERM at a step, straggler steps).
* ``python -m repro_torch.resilience.drill``: the real train loop over
  the DP×SP step on gloo ranks under a fault schedule, checking recovery
  and loss parity with the fault-free run.
"""

from repro_torch.resilience.guard import (GUARD_METRICS, GuardAbort,  # noqa: F401
                                          guard_init, guard_verdict,
                                          rolling_median)
