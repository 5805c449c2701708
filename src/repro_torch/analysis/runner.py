"""Scan driver + CLI for ``python -m repro_torch.analysis``.

The flags, exit codes and JSON report (schema ``repro.analysis/v1``, the
same keys) of ``repro.analysis.runner``; the default root is
``src/repro_torch``.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage/config errors
(unparseable suppressions, unknown rule ids, bad paths).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable

from . import rules as _rules  # noqa: F401  (imports register the catalogue)
from .base import Finding, all_rules, module_info
from .suppressions import SuppressionError, apply, discover, parse

_SKIP_DIRS = {"__pycache__", ".git"}


def iter_sources(roots: Iterable[str]) -> list[str]:
    out: list[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def scan(paths: Iterable[str],
         rule_ids: Iterable[str] | None = None) -> list[Finding]:
    """Run (a subset of) the catalogue over source files; findings sorted
    by file/line for stable output."""
    catalogue = all_rules()
    if rule_ids is not None:
        unknown = set(rule_ids) - set(catalogue)
        if unknown:
            raise SuppressionError(
                f"unknown rule id(s) in --rules: {', '.join(sorted(unknown))}")
        catalogue = {i: catalogue[i] for i in rule_ids}
    findings: list[Finding] = []
    for path in paths:
        try:
            mod = module_info(path)
        except SyntaxError as e:
            findings.append(Finding("PARSE", path, e.lineno or 0, 0,
                                    "<module>", f"syntax error: {e.msg}"))
            continue
        for rule in catalogue.values():
            findings.extend(rule.check(mod))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def render_text(findings: list[Finding]) -> str:
    lines = [f"{f.file}:{f.line}:{f.col}: {f.rule} [{f.symbol}] "
             f"{f.message}" for f in findings]
    return "\n".join(lines)


def report_json(unsuppressed: list[Finding], suppressed: list[Finding],
                unused: list, roots: list[str]) -> dict:
    return {
        "schema": "repro.analysis/v1",
        "roots": roots,
        "rules": {i: {"family": r.family, "name": r.name,
                      "summary": r.summary}
                  for i, r in sorted(all_rules().items())},
        "counts": {"unsuppressed": len(unsuppressed),
                   "suppressed": len(suppressed)},
        "findings": [f.to_json() for f in unsuppressed],
        "suppressed": [f.to_json() for f in suppressed],
        "unused_suppressions": [
            {"rule": s.rule, "path_glob": s.path_glob,
             "symbol_glob": s.symbol_glob, "lineno": s.lineno}
            for s in unused],
        "ok": not unsuppressed,
    }


def run_clean(root: str) -> bool:
    """True iff a default scan of ``root`` has zero unsuppressed findings.
    Used by the tier-1 test and ``chip_smoke.py``'s analysis phase."""
    supp_path = discover(root)
    supps = []
    if supp_path:
        with open(supp_path, encoding="utf-8") as f:
            supps = parse(f.read(), all_rules(), supp_path)
    findings = scan(iter_sources([root]))
    kept, _ = apply(findings, supps)
    return not kept


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant checker for the PyTorch port: trace-"
                    "safety, retrace hazards, lock discipline, aliasing, "
                    "layering, state shape.")
    ap.add_argument("roots", nargs="*", default=None,
                    help="files or directories to scan (default: "
                         "src/repro_torch found relative to cwd)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("-o", "--output", default=None,
                    help="write the report here as well as stdout summary")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--suppressions", default=None,
                    help=f"explicit suppressions file (default: nearest "
                         f"analysis_suppressions.txt above the scan root)")
    ap.add_argument("--no-suppressions", action="store_true",
                    help="ignore any suppressions file (show everything)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for i, r in sorted(all_rules().items()):
            print(f"{i}  {r.family:<16} {r.name}\n      {r.summary}")
        return 0

    roots = args.roots or []
    if not roots:
        default = os.path.join("src", "repro_torch")
        if not os.path.isdir(default):
            print("error: no roots given and ./src/repro_torch not found",
                  file=sys.stderr)
            return 2
        roots = [default]
    for r in roots:
        if not os.path.exists(r):
            print(f"error: no such path: {r}", file=sys.stderr)
            return 2

    rule_ids = args.rules.split(",") if args.rules else None

    supps = []
    supp_origin = None
    if not args.no_suppressions:
        supp_origin = args.suppressions or discover(roots[0])
        if args.suppressions and not os.path.isfile(args.suppressions):
            print(f"error: suppressions file not found: "
                  f"{args.suppressions}", file=sys.stderr)
            return 2
        if supp_origin:
            try:
                with open(supp_origin, encoding="utf-8") as f:
                    supps = parse(f.read(), all_rules(), supp_origin)
            except SuppressionError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2

    try:
        findings = scan(iter_sources(roots), rule_ids)
    except SuppressionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    kept, silenced = apply(findings, supps)
    unused = [s for s in supps if not s.used]

    if args.format == "json":
        payload = report_json(kept, silenced, unused, list(roots))
        text = json.dumps(payload, indent=2, sort_keys=True)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as f:
                f.write(text + "\n")
            print(f"wrote {args.output}: {len(kept)} unsuppressed, "
                  f"{len(silenced)} suppressed")
        else:
            print(text)
    else:
        if kept:
            print(render_text(kept))
        for s in unused:
            print(f"warning: unused suppression "
                  f"{supp_origin}:{s.lineno} ({s.rule} {s.path_glob} "
                  f"{s.symbol_glob}) — matched nothing, delete it",
                  file=sys.stderr)
        print(f"repro_torch.analysis: {len(kept)} unsuppressed finding(s), "
              f"{len(silenced)} suppressed, "
              f"{len(all_rules())} rules over {len(roots)} root(s)")
    return 1 if kept else 0
