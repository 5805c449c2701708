"""Usage-report renderer: a cost-ledger snapshot -> per-tenant tables.

    python -m repro_torch.obs.usage usage_ledger.json
    python -m repro_torch.obs.usage flight/flight-*.json --top 5

A copy of ``repro.obs.usage`` (stdlib only): it renders either package's
ledger dumps, snapshots and bundles to the same text.

Takes a ``CostLedger.dump()`` snapshot, a full ``obs.snapshot()`` record
containing one, or a flight-recorder bundle (the registered ledger
provider rides inside every bundle) and prints the usage breakdown: a
per-tenant table (requests, dispatches, device seconds, windowed
device-time share, modeled flops/bytes, achieved-vs-roofline
utilization) plus the top-k most expensive series by device time.  Like
``report`` it is pure stdlib + stdout — runnable on a downloaded
artifact with nothing else installed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .flight import BUNDLE_MARKER
from .ledger import SNAPSHOT_KIND


def _find_ledger(doc) -> dict | None:
    """The first cost-ledger snapshot nested anywhere in ``doc``."""
    if isinstance(doc, dict):
        if doc.get("kind") == SNAPSHOT_KIND:
            return doc
        for v in doc.values():
            got = _find_ledger(v)
            if got is not None:
                return got
    return None


def load(path: str) -> dict:
    """Load a ledger snapshot from a dump, an obs snapshot, or a flight
    bundle (which embeds the full snapshot under ``"snapshot"``)."""
    p = pathlib.Path(path)
    try:
        doc = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        raise SystemExit(f"ERROR: {path}: not JSON ({e})")
    if isinstance(doc, dict) and BUNDLE_MARKER in doc:
        doc = doc.get("snapshot", {})
    ledger = _find_ledger(doc)
    if ledger is None:
        raise SystemExit(
            f"ERROR: {path}: no cost-ledger snapshot found (expected a "
            f'dict with kind == "{SNAPSHOT_KIND}" at any nesting level)')
    return ledger


def _eng(v: float) -> str:
    """Engineering-compact: 1.23e9 -> '1.23G'."""
    for thresh, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"),
                           (1e3, "k")):
        if abs(v) >= thresh:
            return f"{v / thresh:.2f}{suffix}"
    return f"{v:.2f}"


def render(ledger: dict, top: int = 10) -> str:
    totals = ledger.get("totals", {})
    tenants = ledger.get("tenants", {})
    series = ledger.get("series", [])
    lines = ["=" * 78,
             f"USAGE LEDGER  ({totals.get('series', 0)} series, "
             f"window {ledger.get('window_s')}s)",
             f"totals    {totals.get('requests', 0)} requests "
             f"({totals.get('dispatched', 0)} dispatched / "
             f"{totals.get('cached', 0)} cached), "
             f"{totals.get('device_s', 0.0):.4f} device-s, "
             f"{_eng(totals.get('flops', 0.0))}F, "
             f"{_eng(totals.get('hbm_bytes', 0.0))}B hbm, "
             f"{_eng(totals.get('coll_bytes', 0.0))}B coll",
             "=" * 78]

    if tenants:
        lines.append(
            f"\n{'tenant':<16} {'reqs':>6} {'disp':>6} {'cached':>6} "
            f"{'device_s':>10} {'share':>7} {'flops':>9} {'hbm':>9} "
            f"{'util':>6}")
        for t in sorted(tenants,
                        key=lambda t: -tenants[t].get("device_s", 0.0)):
            a = tenants[t]
            lines.append(
                f"{t:<16} {a.get('requests', 0):>6} "
                f"{a.get('dispatched', 0):>6} {a.get('cached', 0):>6} "
                f"{a.get('device_s', 0.0):>10.4f} "
                f"{a.get('window_share', 0.0):>6.1%} "
                f"{_eng(a.get('flops', 0.0)):>9} "
                f"{_eng(a.get('hbm_bytes', 0.0)):>9} "
                f"{a.get('utilization', 0.0):>6.1%}")

    ranked = sorted(series, key=lambda s: -s.get("device_s", 0.0))[:top]
    if ranked:
        lines.append(f"\nTOP {len(ranked)} SERIES BY DEVICE TIME")
        lines.append(
            f"{'tenant':<14} {'program':<12} {'graph':<14} {'ep':>3} "
            f"{'reqs':>5} {'device_s':>10} {'p99_s':>10} {'util':>6}")
        for s in ranked:
            hist = s.get("device_hist", {})
            lines.append(
                f"{s.get('tenant', '?'):<14} {s.get('program', '?'):<12} "
                f"{str(s.get('graph', '?'))[:12]:<14} "
                f"{s.get('epoch', 0):>3} {s.get('requests', 0):>5} "
                f"{s.get('device_s', 0.0):>10.4f} "
                f"{hist.get('p99', 0.0):>10.6f} "
                f"{s.get('utilization', 0.0):>6.1%}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.usage",
        description="render a cost-ledger snapshot (ledger dump, obs "
                    "snapshot, or flight bundle) as per-tenant usage "
                    "tables")
    ap.add_argument("path", nargs="+",
                    help="usage_*.json dump(s), obs snapshot, or "
                         "flight-*.json bundle(s)")
    ap.add_argument("--top", type=int, default=10,
                    help="series to list in the expensive-series table "
                         "(default 10)")
    args = ap.parse_args(argv)
    for p in args.path:
        print(render(load(p), top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
