"""``python -m repro_torch.analysis`` — run the EdgeKV lint suite.

Exit status: 0 when no findings (warnings included in output but only
``error``-severity findings fail the run unless ``--strict``), 1 when
findings fail the run, 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .engine import RULES, Finding, analyze_paths
from . import rules as _rules  # noqa: F401  (registers the plugins)


def _list_rules() -> str:
    lines = ["registered rules:"]
    for rid in sorted(RULES):
        rule = RULES[rid]
        scope = ("all files" if rule.scopes is None
                 else ", ".join(rule.scopes))
        lines.append(f"  {rid} [{rule.severity}] {rule.summary}")
        lines.append(f"         scope: {scope}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=("determinism / jit-purity / protocol-invariant "
                     "static analysis for the EdgeKV reproduction"))
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to analyze "
                             "(default: src/repro_torch)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as a JSON array")
    parser.add_argument("--select", action="append", default=None,
                        metavar="RULE",
                        help="run only these rule ids (repeatable, "
                             "comma lists accepted)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--strict", action="store_true",
                        help="fail on warnings too, not just errors")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    select = None
    if args.select:
        select = {r.strip().upper()
                  for group in args.select for r in group.split(",")
                  if r.strip()}
    try:
        findings = analyze_paths(args.paths, select=select)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())

    failing = [f for f in findings
               if args.strict or f.severity == "error"]
    if failing and not args.as_json:
        errs = sum(1 for f in failing if f.severity == "error")
        warns = len(findings) - errs
        tail = f", {warns} warning(s)" if warns else ""
        print(f"\n{errs} error(s){tail} in "
              f"{len({f.path for f in findings})} file(s)")
    elif not findings and not args.as_json:
        print("repro_torch.analysis: clean")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())


def _findings_digest(findings: List[Finding]) -> str:
    """Stable one-line digest used by the test suite."""
    return ";".join(f"{f.rule}@{f.path}:{f.line}" for f in findings)
