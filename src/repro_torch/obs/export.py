"""Trace exporters: JSONL and Chrome trace-event format (Perfetto-loadable).

A copy of ``repro.obs.export`` (stdlib only, over the port's recorder),
kept in the port so that ``repro_torch`` imports nothing of the JAX
package.  Both exporters serialise the recorder's ring contents (oldest
first).  The JSONL export is the machine-diffable artifact; the Chrome
trace loads directly in https://ui.perfetto.dev or
``chrome://tracing`` so a served request's span tree (admission -> batch ->
dispatch -> execute -> materialize) can be walked visually.

Chrome trace-event mapping (the subset we emit):

  * spans   -> complete events, ``ph: "X"`` with ``ts``/``dur`` in
    microseconds; ``args.span_id`` / ``args.parent_id`` carry the explicit
    tree (the serving drain interleaves batches, so stack-based nesting on
    one tid is not enough to reconstruct parenthood);
  * instants -> ``ph: "i"`` with thread scope (``s: "t"``);
  * every event gets ``pid`` 0 and the recording thread's ident as ``tid``.

Dangling parents: the ring buffer overwrites oldest-first, so a long-lived
trace can keep a child span whose parent was already evicted.  The Chrome
exporter re-parents such spans to the root — ``parent_id`` is replaced by
``dangling_parent_id`` so the tree stays connected (Perfetto renders a
disconnected id as a silently separate track) while the original id stays
auditable; the bundle-level count lands in ``otherData.dangling_parents``.
The JSONL export stays verbatim (it is the machine-diffable artifact).
"""
from __future__ import annotations

import json
from typing import Any

from .recorder import Recorder, get


def _chrome_event(e: dict, span_ids: set | None = None) -> dict[str, Any]:
    args = e["args"]
    if span_ids is not None and args.get("parent_id") is not None \
            and args["parent_id"] not in span_ids:
        # parent span overwritten by ring wraparound: re-parent to root,
        # keep the original id for the audit trail (copy — never mutate
        # the recorder's live ring entries)
        args = dict(args)
        args["dangling_parent_id"] = args.pop("parent_id")
    out = {"name": e["name"], "ph": e["ph"], "ts": e["ts"],
           "pid": 0, "tid": e["tid"], "args": args}
    if e["ph"] == "X":
        out["dur"] = e["dur"]
    else:
        out["s"] = "t"
    return out


def export_jsonl(path: str, recorder: Recorder | None = None) -> int:
    """One JSON object per line per recorded event; returns the count."""
    rec = recorder if recorder is not None else get()
    events = rec.events()
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e, sort_keys=True, default=str) + "\n")
    return len(events)


def export_chrome_trace(path: str, recorder: Recorder | None = None) -> int:
    """Chrome trace-event JSON (``{"traceEvents": [...]}``); returns the
    event count.  Load in Perfetto / chrome://tracing."""
    rec = recorder if recorder is not None else get()
    raw = rec.events()
    span_ids = {e["args"]["span_id"] for e in raw
                if "span_id" in e["args"]}
    events = [_chrome_event(e, span_ids) for e in raw]
    n_dangling = sum("dangling_parent_id" in e["args"] for e in events)
    doc: dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if n_dangling:
        doc["otherData"] = {"dangling_parents": n_dangling}
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, default=str)
    return len(events)
