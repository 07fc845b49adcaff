#!/usr/bin/env python
"""Run simlint on the PyTorch engine — the structural-invariant verifier of
``repro_torch.analysis.simlint`` — from the CLI.

    python scripts/simlint_torch.py                 # on the GPU
    python scripts/simlint_torch.py --device cpu    # on the CPU
    python scripts/simlint_torch.py --device cpu --json out.json
    python scripts/simlint_torch.py --device cpu --rule R1 --rule R6
    python scripts/simlint_torch.py --device cpu --entry simulate --entry batch
    python scripts/simlint_torch.py --list

Without ``--device`` the lint runs on the GPU and raises where there is
none.  Exit status: 0 when no error-severity findings, 1 when any rule
errored, 2 on bad usage.  Warnings never fail the run.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="simlint_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--rule", action="append", metavar="RN",
                    help="run only this rule (repeatable), e.g. --rule R2")
    ap.add_argument("--entry", action="append", metavar="NAME",
                    help="run only this entry point (repeatable); rules "
                         "whose entries are all filtered out report nothing")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write findings as JSON ('-' for stdout)")
    ap.add_argument("--list", action="store_true",
                    help="list rules and entry points, then exit")
    ap.add_argument("--device", default=None,
                    help="device to lint on (default: the GPU)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import simlint

    if args.list:
        for rid in sorted(simlint.RULES):
            spec = simlint.RULES[rid]
            print(f"{rid}  {spec.name:20s} entries={','.join(spec.entries)}")
            print(f"    {spec.doc}")
        print("entry points:", ", ".join(simlint.ENTRY_NAMES))
        return 0

    try:
        findings = simlint.run_lint(rules=args.rule, entries=args.entry,
                                    device=args.device)
    except ValueError as e:
        print(f"simlint: {e}", file=sys.stderr)
        return 2

    print(simlint.format_report(findings, rules=args.rule))

    if args.json:
        payload = {
            "findings": [f.to_dict() for f in findings],
            "summary": simlint.summarize(findings),
            "rules_run": sorted(args.rule) if args.rule
            else sorted(simlint.RULES),
            "entries": list(args.entry) if args.entry
            else list(simlint.ENTRY_NAMES),
        }
        text = json.dumps(payload, indent=2)
        if args.json == "-":
            print(text)
        else:
            with open(args.json, "w") as fh:
                fh.write(text + "\n")

    return 1 if any(f.severity == "error" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
