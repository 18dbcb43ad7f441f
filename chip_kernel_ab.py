#!/usr/bin/env python3
"""The ``simt`` kernels of two checkouts timed in turns on one card:

    python3 chip_kernel_ab.py PARENT_DIR [CHANGE_DIR]

Runs parent, change, change, parent, each in a process of its own that
imports ``repro_torch`` from that tree's ``src``, ``CHANGE_DIR``
defaulting to this script's directory. A run times, with CUDA events over
two input sets in turns (each warmed once), at phase 3's fp32 shapes:

* K4, K5a, K5b: B 4 x H 16 x S 2048 x dh 128, causal, window 2048, 10
  calls each;
* K1, K2a, K2b: BH 64 x S 2048 x dk 128 x dv 128, decays from
  ``-U(0, 0.03)``, 10 calls each.

It prints the card's name and power limit as ``nvidia-smi`` gives them,
then one line a run, ``AB <parent|change> {"k4_simt_fp32": ms, ...}``.
Exit 0 iff every run exits 0.
"""
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import lasp2_chunk as lc

torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)


def ms(fn, sets, n):
    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def randn(*shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


out = {}
kw = dict(causal=True, window=2048)
sets = []
for _ in range(2):
    q, k = randn(4, 16, 2048, 128, scale=0.4), randn(4, 16, 2048, 128,
                                                    scale=0.4)
    v, do = randn(4, 16, 2048, 128, scale=0.5), randn(4, 16, 2048, 128)
    o, lse = fl.flash_attention_fwd(q, k, v, **kw)
    sets.append((q, k, v, do, lse, (do * o).sum(-1)))
out["k4_simt_fp32"] = ms(
    lambda q, k, v, *_: fl.flash_attention_fwd(q, k, v, **kw), sets, 10)
out["k5a_simt_fp32"] = ms(
    lambda *a: fl.flash_attention_bwd_dq(*a, **kw), sets, 10)
out["k5b_simt_fp32"] = ms(
    lambda *a: fl.flash_attention_bwd_dkv(*a, **kw), sets, 10)
del sets
sets = []
for _ in range(2):
    q, k, v = (randn(64, 2048, 128, scale=0.3) for _ in range(3))
    la = -torch.rand(64, 2048, generator=gen, device="cuda") * 0.03
    o, _, _ = lc.lasp2_chunk_fwd(q, k, v, la)
    sets.append((q, k, v, la, o, randn(64, 2048, 128),
                 randn(64, 128, 128)))
out["k1_simt_fp32_s2048"] = ms(
    lambda q, k, v, la, *_: lc.lasp2_chunk_fwd(q, k, v, la), sets, 10)
out["k2a_simt_fp32"] = ms(
    lambda q, k, v, la, o, do, dst: lc.lasp2_chunk_bwd_dq(k, v, la, do),
    sets, 10)
out["k2b_simt_fp32"] = ms(lambda *a: lc.lasp2_chunk_bwd_dkv(*a), sets, 10)
print(json.dumps(out))
'''


def main(argv) -> int:
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    parent = argv[0]
    change = argv[1] if len(argv) == 2 else str(Path(__file__).parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for name, root in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        run = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"AB {name} {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
