"""``python -m repro_torch.obs`` — inspect trace files from the command
line.

Subcommands (all operate on ``repro.obs.trace/v1`` JSON files, the
format :meth:`TraceSet.to_json` writes and ``fig_trace`` emits):

* ``summarize TRACE``        per-stage mean/p95/share table (+ metrics)
* ``diff A B``               stage-mean and metric deltas between traces
* ``flamegraph TRACE``       text flamegraph + critical path
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .metrics import MetricsRegistry, format_snapshot
from .trace import STAGES, TraceSet


def _cmd_summarize(ns: argparse.Namespace) -> int:
    ts = TraceSet.from_json(ns.trace)
    doc = {
        "ops": len(ts),
        "meta": ts.meta,
        "stages": {dt: ts.stage_summary(dtype=dt if dt != "all" else None)
                   for dt in ["all"] + ts.dtypes},
        "metrics": ts.metrics,
    }
    if ns.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
        return 0
    print(f"{ns.trace}: {len(ts)} ops  meta={ts.meta}")
    for dt, stages in doc["stages"].items():
        if not stages:
            continue
        print(f"\n[{dt}]")
        print(f"  {'stage':<9} {'mean_ms':>9} {'p95_ms':>9} {'share':>7}")
        for stage in STAGES:
            s = stages[stage]
            print(f"  {stage:<9} {s['mean'] * 1e3:9.4f} "
                  f"{s['p95'] * 1e3:9.4f} {s['share']:7.1%}")
    if ts.metrics:
        print("\n[metrics]")
        for line in format_snapshot(ts.metrics):
            print("  " + line)
    return 0


def _cmd_diff(ns: argparse.Namespace) -> int:
    a, b = TraceSet.from_json(ns.a), TraceSet.from_json(ns.b)
    sa, sb = a.stage_summary(), b.stage_summary()
    print(f"{'stage':<9} {'a_mean_ms':>10} {'b_mean_ms':>10} {'delta':>9}")
    for stage in STAGES:
        ma, mb = sa[stage]["mean"], sb[stage]["mean"]
        print(f"{stage:<9} {ma * 1e3:10.4f} {mb * 1e3:10.4f} "
              f"{(mb - ma) * 1e3:+9.4f}")
    md = MetricsRegistry.diff(a.metrics, b.metrics)
    changed = {k: v for k, v in md.items() if v}
    if changed:
        print("\nmetric deltas (b - a):")
        for line in format_snapshot(changed):
            print("  " + line)
    return 0


def _cmd_flamegraph(ns: argparse.Namespace) -> int:
    ts = TraceSet.from_json(ns.trace)
    sys.stdout.write(ts.flamegraph(width=ns.width, split=ns.split))
    print("critical path (mean contribution; share of ops dominated):")
    for row in ts.critical_path():
        print(f"  {row['stage']:<9} {row['mean'] * 1e3:9.4f}ms  "
              f"dominates {row['dominates']:6.1%}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="per-stage summary of a trace")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("diff", help="stage/metric deltas between traces")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=_cmd_diff)

    p = sub.add_parser("flamegraph", help="text flamegraph + critical path")
    p.add_argument("trace")
    p.add_argument("--width", type=int, default=60)
    p.add_argument("--split", choices=("dtype", "none"), default="dtype")
    p.set_defaults(fn=_cmd_flamegraph)

    ns = ap.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    raise SystemExit(main())
