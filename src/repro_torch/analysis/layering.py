"""Layering & purity rules (the port of ``repro.analysis.layering``).

LP001  no per-kind / per-channel string branching in ``gserve/`` — the
       program registry exists so the serving layer never special-cases
       programs; a ``.kind == "sssp"`` comparison reintroduces the
       N-programs × M-call-sites maintenance matrix;
LP002  no wall-clock ``time.time()`` (alias-aware) anywhere in
       src/repro_torch — measured intervals must use the monotonic
       ``perf_counter`` (NTP steps make wall-clock intervals go negative);
       true timestamps are suppressed case by case;
LP003  import layering: ``core`` must not import engine/stream/gserve/obs,
       ``engine`` must not import stream/gserve, ``stream`` must not
       import gserve, ``obs`` must not import gserve, and ``analysis``
       imports no sibling subsystem at all (it must stay runnable with
       zero heavyweight deps).  Besides, no module of
       the port imports ``repro`` (the JAX package) or ``jax``: the
       port's first contract.  Relative imports are resolved to absolute
       ``repro_torch.*`` names first, and package names are compared as
       whole dotted parts, so ``repro_torch`` is never taken for
       ``repro``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .base import (PACKAGE, Finding, ImportMap, ModuleInfo, Rule, dotted,
                   package_of, qualname_at, register_rule)

_BRANCH_ATTRS = {"kind", "channel"}

#: Every sibling subsystem, for a layer that may import none of them.
ANY_SIBLING = "*"

# subsystem -> subsystems it must never import
LAYERING: dict[str, tuple[str, ...]] = {
    "core": ("engine", "stream", "gserve", "obs"),
    "engine": ("stream", "gserve"),
    "stream": ("gserve",),
    "obs": ("gserve",),
    "analysis": (ANY_SIBLING,),
}

#: Top-level packages no module of the port imports: the JAX package and
#: JAX itself.
FOREIGN = ("repro", "jax")


class KindBranching(Rule):
    id = "LP001"
    family = "layering"
    name = "kind-string-branching-in-gserve"
    summary = ("no `.kind`/`.channel` == string-constant comparisons in "
               "gserve/ — program dispatch goes through the registry; "
               "catches reversed operand order a grep misses")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.subsystem != "gserve":
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left] + list(node.comparators)
            has_attr = any(
                isinstance(s, ast.Attribute) and s.attr in _BRANCH_ATTRS
                for s in sides)
            has_str = any(
                isinstance(s, ast.Constant) and isinstance(s.value, str)
                for s in sides)
            if has_attr and has_str:
                yield self.finding(
                    mod, node, qualname_at(mod.tree, node),
                    "per-kind/per-channel string comparison in the "
                    "serving layer: dispatch must go through the program "
                    "registry, not string branching")


class WallClock(Rule):
    id = "LP002"
    family = "layering"
    name = "wall-clock-time"
    summary = ("no time.time() in src/repro_torch (alias-aware: catches "
               "`from time import time as now`) — intervals use the "
               "monotonic time.perf_counter(); genuine timestamps get a "
               "suppression")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        imports = ImportMap(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if not d:
                continue
            if imports.resolve(d) == "time.time" or d == "time.time":
                yield self.finding(
                    mod, node, qualname_at(mod.tree, node),
                    f"wall-clock time.time() (written `{d}()`): intervals "
                    "must use time.perf_counter(); if this is a genuine "
                    "timestamp, suppress with a justification")


def _import_targets(node: ast.AST, pkg: str) -> list[str]:
    """Absolute dotted names an import statement brings in."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        base = ImportMap.resolve_from(node, pkg)
        return [f"{base}.{a.name}" if base else a.name for a in node.names]
    return []


class ImportLayering(Rule):
    id = "LP003"
    family = "layering"
    name = "import-layering"
    summary = ("no module imports repro (the JAX package) or jax; core "
               "never imports engine/stream/gserve/obs; engine never "
               "imports stream/gserve; stream/obs never import gserve; "
               "analysis imports no repro_torch sibling (relative imports "
               "resolved first)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        forbidden = LAYERING.get(mod.subsystem, ())
        pkg = package_of(mod)
        for node in ast.walk(mod.tree):
            for t in _import_targets(node, pkg):
                msg = self._violation(mod, t.split("."), forbidden)
                if msg:
                    yield self.finding(mod, node, "<module>", msg)
                    break

    @staticmethod
    def _violation(mod: ModuleInfo, parts: list[str],
                   forbidden: tuple[str, ...]) -> str | None:
        head = parts[0]
        if head in FOREIGN:
            return (f"the port must not import {'.'.join(parts)}: "
                    f"{PACKAGE} imports nothing of the JAX package nor "
                    "jax (it keeps its own copy of what it needs)")
        if head != PACKAGE or len(parts) < 2:
            return None
        sub = parts[1]
        if sub == mod.subsystem:
            return None
        if sub in forbidden or ANY_SIBLING in forbidden:
            what = "any sibling" if ANY_SIBLING in forbidden \
                else ", ".join(forbidden)
            return (f"{mod.subsystem!r} must not import {PACKAGE}.{sub} "
                    f"(layering: {mod.subsystem} forbids {what})")
        return None


register_rule(KindBranching())
register_rule(WallClock())
register_rule(ImportLayering())
