"""Incident report renderer: flight bundles / JSONL traces -> human text.

    python -m repro_torch.obs.report flight/flight-*.json
    python -m repro_torch.obs.report trace.jsonl

A copy of ``repro.obs.report`` (stdlib plus this package's histogram):
it renders either package's bundles and traces to the same text.

Takes either a flight-recorder bundle (``flight.py``) or a raw JSONL
trace (``export_jsonl``) and prints an incident summary: what fired (the
alert's tenant / program / window), the partition-health gauges at
capture time, per-name event counts, a latency digest per span name, any
span whose parent was overwritten out of the ring, and the tail of the
event timeline.  Pure stdlib + stdout: the point is to be runnable on a
downloaded artifact with nothing else installed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .flight import BUNDLE_MARKER
from .histogram import LogHistogram


def load(path: str) -> dict:
    """Load a bundle (single JSON object) or a JSONL trace (one event per
    line), normalised to the bundle schema."""
    p = pathlib.Path(path)
    text = p.read_text()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and BUNDLE_MARKER in doc:
        return doc
    if isinstance(doc, dict) and "traceEvents" in doc:   # chrome trace
        return {"reason": f"trace {p.name}", "events": doc["traceEvents"]}
    events = []
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise SystemExit(
                f"ERROR: {path}:{i + 1}: neither a flight bundle nor "
                f"parseable JSONL ({e})")
    return {"reason": f"trace {p.name}", "events": events}


def _fmt_val(v, width: int = 60) -> str:
    s = json.dumps(v, default=str) if isinstance(v, (dict, list)) else str(v)
    return s if len(s) <= width else s[:width - 3] + "..."


def _alert_lines(alert: dict) -> list[str]:
    kind = alert.get("kind", "unknown")
    out = [f"  kind       {kind}"]
    if kind == "burn_rate":
        win = alert.get("window", {})
        out += [
            f"  policy     {alert.get('policy')}",
            f"  tenant     {alert.get('tenant')}",
            f"  program    {alert.get('program')}",
            f"  objective  latency <= {alert.get('objective_s')}s at "
            f"{alert.get('availability_target'):.3%} availability",
            f"  burn rate  fast {alert.get('burn_fast')}x / slow "
            f"{alert.get('burn_slow')}x (threshold "
            f"{alert.get('threshold')}x)",
            f"  window     fast {win.get('fast_s')}s: "
            f"{_fmt_val(win.get('fast'))}",
            f"             slow {win.get('slow_s')}s: "
            f"{_fmt_val(win.get('slow'))}",
        ]
    elif kind == "gauge_drift":
        out += [f"  gauge      {alert.get('gauge')} = {alert.get('value')}"
                f" (baseline {alert.get('baseline')})"]
        out += [f"  breach     {r}" for r in alert.get("reasons", [])]
    elif kind == "retrace_rate":
        win = alert.get("window", {})
        out += [f"  rate       {alert.get('rate_per_s')}/s over "
                f"{win.get('window_s')}s (max {alert.get('max_per_s')}/s, "
                f"{win.get('retraces')} retraces)"]
    else:
        out += [f"  context    {_fmt_val(alert)}"]
    return out


def render(bundle: dict, tail: int = 15) -> str:
    """One incident summary string for a bundle/trace document."""
    events = bundle.get("events", [])
    lines = ["=" * 72,
             f"INCIDENT  {bundle.get('reason', '?')}"]
    if "created_utc" in bundle:
        lines.append(f"captured  {bundle['created_utc']} "
                     f"(bundle seq {bundle.get('seq')})")
    stats = bundle.get("stats")
    if stats:
        lines.append(
            f"recorder  {stats.get('since_reset', 0)} events in ring, "
            f"{stats.get('dropped', 0)} dropped since reset, "
            f"{stats.get('overwritten', 0)} overwritten lifetime, "
            f"{stats.get('open_spans', 0)} open spans")
    lines.append("=" * 72)

    context = bundle.get("context")
    alerts = [e["args"] for e in events if e.get("name") == "obs.alert"]
    if isinstance(context, dict) and context.get("kind"):
        alerts = [context] + [a for a in alerts if a != context]
    if alerts:
        lines.append(f"\nALERTS ({len(alerts)})")
        for a in alerts:
            lines += _alert_lines(a)
            lines.append("")
    snap = bundle.get("snapshot", {})
    active = []
    for v in snap.values():
        if isinstance(v, dict):
            active += v.get("active_alerts", [])
    if active and not alerts:
        lines.append(f"\nACTIVE ALERTS AT CAPTURE ({len(active)})")
        for a in active:
            lines += _alert_lines(a)
            lines.append("")

    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("HEALTH GAUGES")
        for k in sorted(gauges):
            lines.append(f"  {k:<40} {gauges[k]}")
    counters = snap.get("counters", {})
    if counters:
        lines.append("COUNTERS")
        for k in sorted(counters):
            lines.append(f"  {k:<40} {counters[k]}")

    by_name: dict[str, int] = {}
    spans: dict[str, LogHistogram] = {}
    dangling = 0
    span_ids = {e["args"]["span_id"] for e in events
                if "span_id" in e.get("args", {})}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
        args = e.get("args", {})
        pid = args.get("parent_id", args.get("dangling_parent_id"))
        if pid is not None and pid not in span_ids:
            dangling += 1
        if e.get("ph") == "X":
            spans.setdefault(e["name"], LogHistogram()).record(
                float(e.get("dur", 0.0)) * 1e-6)
    if by_name:
        lines.append(f"\nEVENTS ({len(events)} in ring)")
        for k in sorted(by_name, key=by_name.get, reverse=True):
            lines.append(f"  {k:<40} {by_name[k]}")
    if dangling:
        lines.append(f"  [!] {dangling} span(s) with a parent overwritten "
                     "out of the ring (re-parented to root on export)")
    if spans:
        lines.append("\nSPAN LATENCY (seconds)")
        lines.append(f"  {'span':<24} {'n':>6} {'p50':>10} {'p99':>10} "
                     f"{'max':>10}")
        for k in sorted(spans):
            h = spans[k]
            lines.append(f"  {k:<24} {h.n:>6} {h.percentile(50):>10.6f} "
                         f"{h.percentile(99):>10.6f} {h.vmax:>10.6f}")

    if events:
        lines.append(f"\nTIMELINE TAIL (last {min(tail, len(events))} "
                     "events, ts in s since recorder start)")
        for e in events[-tail:]:
            ts = float(e.get("ts", 0.0)) * 1e-6
            args = {k: v for k, v in e.get("args", {}).items()
                    if k not in ("span_id", "parent_id")}
            lines.append(f"  {ts:>10.4f}  {e['name']:<24} "
                         f"{_fmt_val(args, 70)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="render a flight-recorder bundle or JSONL trace into "
                    "a human-readable incident summary")
    ap.add_argument("path", nargs="+",
                    help="flight-*.json bundle(s) or a JSONL trace")
    ap.add_argument("--tail", type=int, default=15,
                    help="timeline tail length (default 15)")
    args = ap.parse_args(argv)
    for p in args.path:
        print(render(load(p), tail=args.tail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
