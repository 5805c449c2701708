"""Suppressions file: the only way to silence a finding, always justified.

The grammar, errors and discovery of ``repro.analysis.suppressions``; the
port's own file is ``src/repro_torch/analysis_suppressions.txt``, which the
upward walk from ``src/repro_torch`` finds before the repository root's.

Format (text, one entry per line — 3.10-compatible, no toml):

    RULE_ID  path-glob  [symbol-glob]  --  justification

* ``RULE_ID`` must name a registered rule — an unknown id is a hard error
  (exit 2), so a renamed/removed rule can't leave a stale suppression
  silently masking nothing (or worse, the wrong thing).
* ``path-glob`` matches the finding's file path with ``fnmatch`` against
  both the display path and its trailing components, so
  ``obs/recorder.py`` matches ``src/repro_torch/obs/recorder.py``.
* ``symbol-glob`` (optional) narrows to the dotted qualname
  (``Recorder._record``); omit to match the whole file.
* the ``--  justification`` is mandatory: a suppression with no reason is
  a parse error.

The file is discovered by walking upward from the scan root looking for
``analysis_suppressions.txt`` (so the CLI works from the repo root or
anywhere inside it), or passed explicitly with ``--suppressions``.
Suppressions that matched nothing in a run are reported as warnings —
they are debt to delete.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Iterable

from .base import Finding

FILENAME = "analysis_suppressions.txt"


class SuppressionError(Exception):
    """Malformed file or unknown rule id — maps to exit code 2."""


@dataclasses.dataclass
class Suppression:
    rule: str
    path_glob: str
    symbol_glob: str          # "*" when omitted
    justification: str
    lineno: int
    used: bool = False

    def matches(self, f: Finding) -> bool:
        if f.rule != self.rule:
            return False
        path = f.file.replace("\\", "/")
        ok_path = fnmatch.fnmatch(path, self.path_glob)
        if not ok_path:
            # allow repo-relative globs against absolute/prefixed paths
            parts = path.split("/")
            ok_path = any(
                fnmatch.fnmatch("/".join(parts[i:]), self.path_glob)
                for i in range(len(parts)))
        return ok_path and fnmatch.fnmatch(f.symbol, self.symbol_glob)


def parse(text: str, known_rules: Iterable[str],
          origin: str = FILENAME) -> list[Suppression]:
    known = set(known_rules)
    out: list[Suppression] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "--" not in line:
            raise SuppressionError(
                f"{origin}:{lineno}: missing ` -- justification` "
                f"(every suppression must say why): {line!r}")
        head, _, justification = line.partition("--")
        justification = justification.strip()
        if not justification:
            raise SuppressionError(
                f"{origin}:{lineno}: empty justification")
        fields = head.split()
        if len(fields) not in (2, 3):
            raise SuppressionError(
                f"{origin}:{lineno}: expected `RULE_ID path-glob "
                f"[symbol-glob] -- why`, got {len(fields)} fields")
        rule = fields[0]
        if rule not in known:
            raise SuppressionError(
                f"{origin}:{lineno}: unknown rule id {rule!r} "
                f"(known: {', '.join(sorted(known))}) — delete or fix "
                "this stale suppression")
        out.append(Suppression(rule, fields[1],
                               fields[2] if len(fields) == 3 else "*",
                               justification, lineno))
    return out


def discover(scan_root: str) -> str | None:
    """Nearest analysis_suppressions.txt at or above scan_root."""
    d = os.path.abspath(scan_root)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        cand = os.path.join(d, FILENAME)
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def apply(findings: list[Finding],
          supps: list[Suppression]) -> tuple[list[Finding], list[Finding]]:
    """(unsuppressed, suppressed); marks each matching Suppression used."""
    kept, silenced = [], []
    for f in findings:
        hit = None
        for s in supps:
            if s.matches(f):
                hit = s
                s.used = True
                break
        (silenced if hit else kept).append(f)
    return kept, silenced
