"""CLI: ``python -m repro_torch.analysis`` (twin of ``python -m
repro.analysis``).

The default run is all three checks: the lint over the port, the PAL301
guard-band battery over every kernel route, and the step sanitizer on
the one-device train step, the decode step and the reference's rank
programs. It runs on the card unless ``--device cpu`` is given; there the
battery drives the plain versions and the rank programs run on gloo
ranks. Exit 0 iff no finding survives the suppressions.

  python -m repro_torch.analysis                 # everything, on the card
  python -m repro_torch.analysis --device cpu    # everything, on the CPU
  python -m repro_torch.analysis --lint-only src/repro_torch/train/step.py
  python -m repro_torch.analysis --sanitize-only
  python -m repro_torch.analysis --explain JL102
  python -m repro_torch.analysis --json findings.json   # scripts/report.py
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torchlint (AST) + kernel guard-band battery + step "
                    "sanitizer")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the port)")
    ap.add_argument("--lint-only", action="store_true",
                    help="AST rules + kernel battery only")
    ap.add_argument("--sanitize-only", action="store_true",
                    help="step sanitizer only")
    ap.add_argument("--no-kernel-check", action="store_true",
                    help="skip the PAL301 guard-band battery")
    ap.add_argument("--json", dest="json_out", metavar="PATH",
                    help="write the machine-readable findings document")
    ap.add_argument("--explain", metavar="CODE",
                    help="print the rule doc for CODE and exit")
    ap.add_argument("--device", default=None,
                    help="where the battery and the sanitizer run: the "
                         "card by default, 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    if args.explain:
        from repro_torch.analysis.rules import explain
        try:
            print(explain(args.explain))
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2
        return 0

    from repro_torch.analysis.findings import AnalysisResult
    result = AnalysisResult()
    device = None
    sanitize = not args.lint_only and not args.paths
    battery = not args.sanitize_only and not args.no_kernel_check
    if sanitize or battery:
        from repro_torch.core.device import resolve_device
        device = resolve_device(args.device)

    if not args.sanitize_only:
        from pathlib import Path

        from repro_torch.analysis.lint import discover_files, run_lint
        paths = None
        if args.paths:
            paths = []
            for p in args.paths:
                paths += discover_files(Path(p))
        result.extend(run_lint(paths))
        if battery:
            from repro_torch.analysis.kernel_check import check_kernels
            kf, n_cases = check_kernels(device)
            result.findings += kf
            result.checked["kernel_cases"] = n_cases

    if sanitize:
        from repro_torch.analysis.sanitizer import run_sanitizer
        result.extend(run_sanitizer(device))

    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(result.to_json())

    for f in result.findings:
        print(f)
    n_sup = len(result.suppressed)
    checked = ", ".join(f"{v} {k}" for k, v in sorted(
        result.checked.items()))
    if result.ok:
        print(f"OK: 0 findings ({checked}"
              + (f"; {n_sup} suppressed" if n_sup else "") + ")")
        return 0
    counts = ", ".join(f"{k}×{v}" for k, v in sorted(
        result.counts().items()))
    print(f"FAIL: {len(result.findings)} finding(s) [{counts}] "
          f"({checked})", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
