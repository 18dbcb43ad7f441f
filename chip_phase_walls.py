#!/usr/bin/env python3
"""Walls of ``chip_smoke.py`` on the card, two ways:

    python3 chip_phase_walls.py path/to/chip_smoke.py
    python3 chip_phase_walls.py --ab PARENT_DIR [CHANGE_DIR]

The first runs that script and prints the wall of each of its phase
functions, for a version of the script that prints no per-phase walls of
its own (this one prints ``[walls] phase_walls_s=...``). Every
module-level ``phase_*`` function is wrapped before its ``main()`` runs;
each call prints ``PHASE_WALL <name> <seconds>``, nested calls indented
by their depth, and the run ends with ``PHASE_WALL TOTAL <seconds>``.
Spawned ranks import the script by name and run it unwrapped. The exit
code is the script's.

The second compares two checkouts in turns, parent, change, change,
parent, each in a process of its own on the one card, ``CHANGE_DIR``
defaulting to this script's directory. A run takes phase 7 of that
tree's ``chip_smoke.py`` (10 full-width train steps of
``linear-llama3-1b`` through ``train()``, then one profiled step) and
then one full-width AdamW update of that tree's ``optim.adamw`` (the
update the step makes, with ``ok`` True where it takes one), profiled
per op. It prints the card's name and power limit, phase 7's ``[train]``
and ``[profile]`` lines, ``P7 {"p50_ms": ..., "step_ms": [...]}`` (step
0, which carries the warm-up, left out) and ``ADAMW {"wall_ms": ...,
"device_ms": ..., "ops": [[op, kernel, launches, device ms], ...],
"kernels": [[kernel, launches, device ms], ...]}``.
Exit 0 iff every run exits 0.
"""

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

_depth = [0]

AB_CODE = r'''
import inspect, json, re, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as C
print(C.phase_facts(), flush=True)
C.phase_build()
from repro_torch.configs import get_config
cfg = get_config("linear-llama3-1b")
kernels = [{"name": f"{n}_{r}", "launches": None}
           for n in ("lasp2_chunk_fwd", "lasp2_chunk_bwd_dq",
                     "lasp2_chunk_bwd_dkv", "flash_attention_fwd",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
           for r in ("sm90", "simt")]
hist = C.phase_train(kernels, cfg, "train")
dts = [h["dt"] * 1e3 for h in hist[1:]]
print("P7", json.dumps({"p50_ms": float(np.median(dts)),
                        "step_ms": [round(d, 2) for d in dts]}), flush=True)
del hist
C._free()

from torch.profiler import ProfilerActivity, profile
from repro_torch.core.tree import tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw
params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
grads = tree_map(lambda p: p * 1e-3, params)
kw = {}
if "ok" in inspect.signature(adamw.update).parameters:
    kw["ok"] = torch.ones((), dtype=torch.bool, device="cuda")
opt = [adamw.init(params)]


def update():
    opt[0] = adamw.update(grads, opt[0], params, lr=1e-4, **kw)


for _ in range(2):
    update()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    update()
torch.cuda.synchronize()
wall = (time.perf_counter() - t0) / 5 * 1e3
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    update()
    torch.cuda.synchronize()


def kind(name):
    """The elementwise kernel's template (vectorized or not) and the
    functors or kernel functions its name holds; else the name's head."""
    for k in ("vectorized_elementwise_kernel", "unrolled_elementwise_kernel",
              "elementwise_kernel<128, 2"):
        if k in name:
            what = dict.fromkeys(w for w in re.findall(
                r"\w+Functor|\w+_kernel\w*", name.split(k, 1)[1])
                if w not in ("BinaryFunctor", "AUnaryFunctor",
                             "BUnaryFunctor"))
            return k + ":" + "/".join(list(what)[:3])
    return name[:60]


ops = {}
for e in prof.events():
    if e.device_type != torch.autograd.DeviceType.CPU:
        continue
    for k in getattr(e, "kernels", []):
        row = ops.setdefault((e.name, kind(k.name)), [0, 0.0])
        row[0] += 1
        row[1] += k.duration / 1e3
rows = sorted(([op, kn, n, round(ms, 4)] for (op, kn), (n, ms)
               in ops.items()), key=lambda r: -r[3])
top = sorted(((e.self_device_time_total / 1e3, e.count, kind(e.key))
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA),
             reverse=True)
print("ADAMW", json.dumps({"wall_ms": round(wall, 3),
                           "device_ms": round(sum(t[0] for t in top), 3),
                           "ops": rows,
                           "kernels": [[k, n, round(ms, 4)]
                                       for ms, n, k in top[:12]]}),
      flush=True)
'''


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


def phase_walls(path: str) -> int:
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


def ab(parent: str, change: str) -> int:
    trees = (Path(parent).resolve(), Path(change).resolve())
    rc = 0
    for tag, tree in zip(("parent", "change", "change", "parent"),
                         (trees[0], trees[1], trees[1], trees[0])):
        r = subprocess.run([sys.executable, "-c", AB_CODE], cwd=tree,
                           capture_output=True, text=True, timeout=600)
        keep = [line for line in r.stdout.splitlines() if line.startswith(
            ("[train]", "[profile]", "P7", "ADAMW", "NVIDIA"))]
        print(f"=== {tag} {tree} rc={r.returncode}", flush=True)
        print("\n".join(keep), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 1 and args[0] != "--ab":
        sys.exit(phase_walls(args[0]))
    if args[:1] == ["--ab"] and len(args) in (2, 3):
        sys.exit(ab(args[1], args[2] if len(args) == 3
                    else str(Path(__file__).resolve().parent)))
    raise SystemExit(__doc__)
