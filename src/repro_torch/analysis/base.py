"""Shared infrastructure for the port's AST invariant checker.

The counterpart of ``repro.analysis.base``, kept in the port so that
``repro_torch.analysis`` imports nothing of the JAX package.  Every rule
operates on a ``ModuleInfo`` — one parsed source file plus the context the
rules scope on: the path relative to the ``repro_torch`` package
(``engine/runtime.py``) and the subsystem (``engine``).  Fixtures outside the package tree declare a
virtual path in a leading comment (``# analysis-virtual-path: engine/x.py``)
so the same scoping logic exercises them.

Rules subclass ``Rule`` and register themselves via ``register_rule`` at
import time; ``all_rules()`` is the single catalogue the runner, the CLI
``--rules`` filter, and the suppressions validator share — an unknown rule
id can exist nowhere.

Everything here is stdlib-only on purpose: the analyzer runs before any
heavyweight dependency (torch, numpy) is installed or imported.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterable, Iterator

#: The package whose tree the rules scope on; relative imports resolve
#: below it.
PACKAGE = "repro_torch"

_VIRTUAL_PATH_RE = re.compile(
    r"^#\s*analysis-virtual-path:\s*(\S+)\s*$", re.MULTILINE)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str                 # rule id, e.g. "LD001"
    file: str                 # display path (as scanned, relative to cwd)
    line: int
    col: int
    symbol: str               # dotted qualname context, e.g. "Recorder.disable"
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ModuleInfo:
    """A parsed source file plus the context rules scope on."""
    path: str                 # display path of the file on disk
    rel: str                  # package-relative, e.g. "engine/runtime.py"
    subsystem: str            # first component of rel ("" for top-level)
    tree: ast.Module
    source: str


def module_info(path: str, display: str | None = None) -> ModuleInfo:
    with open(path, encoding="utf-8") as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    rel = _package_relative(path)
    m = _VIRTUAL_PATH_RE.search(source[:400])
    if m:                     # fixtures pin their scoping path explicitly
        rel = m.group(1)
    subsystem = rel.split("/", 1)[0] if "/" in rel else ""
    return ModuleInfo(display or path, rel, subsystem, tree, source)


def _package_relative(path: str) -> str:
    """The path below the innermost ``repro_torch`` directory (an exact
    part: ``repro`` or ``repro_torch_old`` never match), else the file's
    name."""
    parts = path.replace("\\", "/").split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i + 1:])
    return parts[-1]


class Rule:
    """One invariant. Subclasses set the class attributes and implement
    ``check``; ``finding`` builds a ``Finding`` with the rule id filled."""

    id: str = ""
    family: str = ""          # "trace-safety" | "retrace-hazard" | ...
    name: str = ""
    summary: str = ""         # one line; ``--list-rules`` and the README

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node: ast.AST, symbol: str,
                message: str) -> Finding:
        return Finding(self.id, mod.path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), symbol, message)


_RULES: dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    assert rule.id and rule.id not in _RULES, rule.id
    _RULES[rule.id] = rule
    return rule


def all_rules() -> dict[str, Rule]:
    """id -> rule, every registered rule (importing repro_torch.analysis
    registers the full catalogue)."""
    return dict(_RULES)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_functions(tree: ast.Module) -> Iterator[tuple[str, ast.AST]]:
    """Yield (qualname, node) for every function/method, depth-first.
    Qualnames are dotted through classes and enclosing functions:
    ``Recorder.disable``, ``GraphServer.drain.<locals>.body``-style nesting
    collapses to plain dots (``drain.body``) for readable suppressions."""

    def rec(node: ast.AST, prefix: str) -> Iterator[tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from rec(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def qualname_at(tree: ast.Module, target: ast.AST) -> str:
    """Dotted qualname of the innermost function/class containing target
    (best effort; "<module>" at top level)."""
    best = "<module>"
    best_span = None
    t_line = getattr(target, "lineno", None)
    if t_line is None:
        return best
    for q, fn in walk_functions(tree):
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= t_line <= end:
            span = end - fn.lineno
            if best_span is None or span <= best_span:
                best, best_span = q, span
    return best


def package_of(mod: ModuleInfo) -> str:
    """Dotted package of a module from its relative path:
    ``engine/runtime.py`` -> ``repro_torch.engine``."""
    pkg = mod.rel.rsplit("/", 1)[0].replace("/", ".") \
        if "/" in mod.rel else ""
    return f"{PACKAGE}.{pkg}" if pkg else PACKAGE


class ImportMap:
    """Alias-aware import resolution for one module.

    ``resolve(dotted(call.func))`` maps a Call's func back to a canonical
    dotted name: ``from time import time as now; now()`` resolves to
    ``time.time`` — the aliasing the grep guards could never see.
    """

    def __init__(self, mod: ModuleInfo):
        self.aliases: dict[str, str] = {}       # local name -> dotted origin
        pkg = package_of(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = self.resolve_from(node, pkg)
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{base}.{a.name}"

    @staticmethod
    def resolve_from(node: ast.ImportFrom, pkg: str) -> str:
        """Absolute dotted base of a ``from X import ...`` given the
        importing module's package (``repro_torch.stream``)."""
        if node.level == 0:
            return node.module or ""
        parts = pkg.split(".")
        # level=1: current package; each extra level strips one component
        base_parts = parts[: len(parts) - (node.level - 1)]
        base = ".".join(p for p in base_parts if p)
        if node.module:
            base = f"{base}.{node.module}" if base else node.module
        return base

    def resolve(self, name: str) -> str:
        """Canonical dotted origin of a dotted local name."""
        head, _, rest = name.partition(".")
        origin = self.aliases.get(head, head)
        return f"{origin}.{rest}" if rest else origin
