#!/usr/bin/env python3
"""Run a ``chip_smoke.py`` and print the wall of each of its phase
functions, for a version of the script that prints no per-phase walls
of its own (this one prints ``[walls] phase_walls_s=...``):

    python3 chip_phase_walls.py path/to/chip_smoke.py

Every module-level ``phase_*`` function of that script is wrapped before
its ``main()`` runs; each call prints ``PHASE_WALL <name> <seconds>``,
nested calls indented by their depth, and the run ends with
``PHASE_WALL TOTAL <seconds>``. Spawned ranks import the script by name
and run it unwrapped. The exit code is the script's.
"""

import importlib.util
import sys
import time
from pathlib import Path

_depth = [0]


def _timed(name, fn):
    def call(*args, **kwargs):
        _depth[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _depth[0] -= 1
            print(f"PHASE_WALL {'  ' * _depth[0]}{name} "
                  f"{time.perf_counter() - t0:.1f}", flush=True)
    return call


def main(path: str) -> int:
    path = Path(path).resolve()
    sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    for name, fn in list(vars(smoke).items()):
        if name.startswith("phase_") and callable(fn):
            setattr(smoke, name, _timed(name, fn))
    t0 = time.perf_counter()
    rc = smoke.main()
    print(f"PHASE_WALL TOTAL {time.perf_counter() - t0:.1f}", flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: chip_phase_walls.py PATH/TO/chip_smoke.py")
    sys.exit(main(sys.argv[1]))
