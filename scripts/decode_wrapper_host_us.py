#!/usr/bin/env python3
"""Host us per call of the port's decode-step wrapper (K3,
``repro_torch.kernels.lasp2_decode.lasp2_decode_step``) on the card,
against another version of the same wrapper.

    python3 scripts/decode_wrapper_host_us.py [--against FILE] [--route R]

Times runs of 1,000 back-to-back calls at the serving shape (BH 64 = 4
slots x 16 heads, dk = dv = 128, bf16 q/k/v, an explicit log a) with
``chip_smoke.host_us``. ``--against`` names another tree's
``kernels/lasp2_decode.py`` (unpack it with ``git archive`` into a
directory that ``.gitignore`` lists): it is loaded beside this checkout's
wrapper, on this checkout's kernels and helpers, and the two wrappers run
in turns (other, this, this, other, three times over) in one process on
one card. ``--route`` forces this checkout's wrapper onto a route; the
other takes its own table. Prints one JSON line; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on sys.path)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location("other_lasp2_decode", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path)
    ap.add_argument("--route", choices=("sm90", "simt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_wrapper_host_us: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import lasp2_decode as ldm
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, d = 64, 128
    sets = []
    for _ in range(16):              # 16 x 4.2 MB of state > 50 MB of L2
        q, k, v = (torch.randn(bh, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        sets.append((q, k, v, torch.zeros(bh, device="cuda"),
                     torch.randn(bh, d, d, generator=gen, device="cuda"),
                     torch.zeros(bh, device="cuda")))
    kw = {} if args.route is None else {"route": args.route}
    this = ldm.lasp2_decode_step
    fns = {"this": lambda *a: this(*a, **kw)}
    if args.against is not None:
        fns["other"] = _load(args.against.resolve()).lasp2_decode_step
    order = list(fns)[::-1]
    readings = {name: [] for name in fns}
    for _ in range(3):
        for name in order + order[::-1]:
            readings[name].append(chip_smoke.host_us(fns[name], sets))
    print(json.dumps({
        "against": None if args.against is None else str(args.against),
        "route": args.route or "table", "calls_a_run": 1000,
        "median_host_us": {n: statistics.median(r)
                           for n, r in readings.items()},
        "host_us": readings, "kind": torch.cuda.get_device_name(0)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
