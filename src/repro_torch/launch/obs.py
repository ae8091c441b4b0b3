# Counterpart of src/repro/launch/obs.py: a verbatim copy over the port's `obs` with
# the package renamed; nothing of it is left unported.
"""Trace/metrics summarizer + merger for ``repro_torch.obs`` run directories.

``python -m repro_torch.launch.obs RUN_DIR`` finds every ``trace.jsonl`` /
``trace.json`` under the directory (a single file path works too), prints a
per-span aggregate table (count, total/mean/max ms) and, when a
``metrics.json`` snapshot is present, the metrics table.  With
``--merge-out PATH`` all discovered events are merged into one
Chrome-trace/Perfetto ``trace.json`` — the multi-process/multi-host story:
each worker streams its own JSONL sink, the merger joins them on one
timeline (tracks keyed by pid).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.pipeline ... --trace /tmp/run
    PYTHONPATH=src python -m repro_torch.launch.obs /tmp/run
    PYTHONPATH=src python -m repro_torch.launch.obs /tmp/run \
        --merge-out /tmp/run/merged.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

from repro_torch.obs import chrome_trace, read_events, span_summary

TRACE_NAMES = ("trace.jsonl", "trace.json")


def find_trace_files(root: str) -> List[str]:
    """Trace files under ``root`` (depth-first, stable order).  A
    ``trace.json`` next to a ``trace.jsonl`` is skipped — it is the export
    of the same events, and counting both would double every span."""
    if os.path.isfile(root):
        return [root]
    out: List[str] = []
    for d, _, files in sorted(os.walk(root)):
        present = [n for n in TRACE_NAMES if n in files]
        if "trace.jsonl" in present:
            out.append(os.path.join(d, "trace.jsonl"))
        elif present:
            out.append(os.path.join(d, present[0]))
    return out


def find_metrics_files(root: str) -> List[str]:
    if os.path.isfile(root):
        return []
    return [os.path.join(d, "metrics.json")
            for d, _, files in sorted(os.walk(root))
            if "metrics.json" in files]


def summary_table(rows: List[Dict]) -> str:
    if not rows:
        return "(no spans)"
    w = max(len(r["name"]) for r in rows)
    lines = [f"{'span'.ljust(w)}  {'count':>6}  {'total_ms':>10}  "
             f"{'mean_ms':>10}  {'max_ms':>10}"]
    for r in rows:
        lines.append(f"{r['name'].ljust(w)}  {r['count']:>6}  "
                     f"{r['total_ms']:>10.2f}  {r['mean_ms']:>10.2f}  "
                     f"{r['max_ms']:>10.2f}")
    return "\n".join(lines)


def metrics_table(snapshots: Dict[str, Dict]) -> str:
    """Render merged metrics snapshots (counters summed across files,
    gauges/histograms reported per file when they collide)."""
    lines = []
    for path, snap in snapshots.items():
        lines.append(f"# {path}")
        w = max((len(n) for n in snap), default=6)
        for name, s in sorted(snap.items()):
            if s["type"] == "histogram":
                val = (f"count={s.get('count', 0)}"
                       + (f" mean={s['mean']:.6g} p95={s['p95']:.6g}"
                          if s.get("count") else ""))
            else:
                val = f"{s['value']:.6g}"
            lines.append(f"  {name.ljust(w)}  {s['type']:<9}  {val}")
    return "\n".join(lines) if lines else "(no metrics snapshots)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize/merge repro_torch.obs traces from a run directory")
    ap.add_argument("run_dir", help="run directory (or a single trace file)")
    ap.add_argument("--merge-out", metavar="PATH",
                    help="write all events as one Chrome-trace JSON file")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of tables")
    args = ap.parse_args(argv)

    files = find_trace_files(args.run_dir)
    if not files and not args.merge_out:
        print(f"no trace files under {args.run_dir}", file=sys.stderr)
        return 1
    events = []
    for path in files:
        events.extend(read_events(path))
    spans = span_summary(events)

    if args.merge_out:
        doc = chrome_trace(events)
        with open(args.merge_out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"# merged {len(events)} events from {len(files)} file(s) "
              f"-> {args.merge_out}")

    snapshots = {}
    for mp in find_metrics_files(args.run_dir):
        with open(mp) as f:
            snapshots[mp] = json.load(f)

    if args.json:
        print(json.dumps({"files": files, "events": len(events),
                          "spans": spans, "metrics": snapshots}, indent=1))
        return 0
    print(f"# {len(events)} events from {len(files)} trace file(s)")
    print(summary_table(spans))
    if snapshots:
        print()
        print(metrics_table(snapshots))
    return 0


if __name__ == "__main__":
    sys.exit(main())
