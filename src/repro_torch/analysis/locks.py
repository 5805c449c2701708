"""Lock-discipline rule: guarded state is written under the lock, always.

The port of ``repro.analysis.locks``; the rule does not depend on the
framework, and in the port it covers the same classes (``GraphServer``,
the ``CostLedger``, the recorder, the plan cache).

Incident record: the reference's ``GraphServer._ledger_shares`` refreshed
``self._shares_cache`` without holding ``self._lock`` while ``set_ledger``
wrote the same attribute under it — a torn-read window on the drain path
that this rule catches.

LD001 applies to every class that creates a ``self._lock`` (``Lock`` /
``RLock``) in ``__init__``.  The guarded attribute set is inferred, not
declared: an attribute is *guarded* if any method mutates it lexically
inside ``with self._lock:`` — or inside a method that is itself only ever
called with the lock held (computed as a fixpoint over intra-class call
sites; ``__init__`` counts as a locked context since no other thread can
hold a reference yet).  Any other mutation of a guarded attribute —
assignment, augmented assignment, ``del``, or a mutating method call
(``.append``/``.pop``/``.update``/...) — is flagged.

Deliberately lock-free fast paths (the Recorder's GIL-atomic record path)
are real designs; they are expressed as suppressions with their
justification, not by weakening the rule.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .base import Finding, ModuleInfo, Rule, register_rule

_MUTATORS = {"append", "add", "update", "pop", "popitem", "clear",
             "move_to_end", "setdefault", "remove", "discard", "extend",
             "insert", "appendleft", "popleft"}
_LOCK_CTORS = {"Lock", "RLock"}


def _creates_lock(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "_lock" and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    return True
    return False


def _is_self_lock(node: ast.AST) -> bool:
    """True for a ``with self._lock`` context expression (not
    ``other._lock`` — CostLedger.merge locks the *other* ledger to read it,
    which guards nothing on self)."""
    return (isinstance(node, ast.Attribute) and node.attr == "_lock"
            and isinstance(node.value, ast.Name) and node.value.id == "self")


def _self_attr_writes(node: ast.AST) -> Iterator[tuple[str, ast.AST]]:
    """(attr, node) for every mutation of ``self.<attr>`` in the subtree,
    excluding nested with-self._lock bodies (handled by the caller's
    lexical walk)."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) \
                else [sub.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Attribute) and \
                            isinstance(leaf.value, ast.Name) and \
                            leaf.value.id == "self":
                        yield leaf.attr, sub
                        break
        elif isinstance(sub, ast.Delete):
            for t in sub.targets:
                base = t
                while isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        base.value.id == "self":
                    yield base.attr, sub
        elif isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in _MUTATORS:
            recv = sub.func.value
            while isinstance(recv, ast.Subscript):
                recv = recv.value
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    recv.value.id == "self":
                yield recv.attr, sub


def _split_writes(method: ast.AST) -> tuple[list, list]:
    """(locked_writes, bare_writes) for one method body, where each entry
    is (attr, node).  A write is *locked* if any enclosing ``with``
    statement in the method uses ``self._lock``."""
    locked_spans: list[tuple[int, int]] = []
    for sub in ast.walk(method):
        if isinstance(sub, ast.With):
            if any(_is_self_lock(item.context_expr)
                   for item in sub.items):
                locked_spans.append(
                    (sub.lineno, getattr(sub, "end_lineno", sub.lineno)))
    locked, bare = [], []
    for attr, node in _self_attr_writes(method):
        line = node.lineno
        if any(lo <= line <= hi for lo, hi in locked_spans):
            locked.append((attr, node))
        else:
            bare.append((attr, node))
    return locked, bare


class UnguardedWrite(Rule):
    id = "LD001"
    family = "lock-discipline"
    name = "guarded-attr-written-without-lock"
    summary = ("in classes owning self._lock, attributes ever mutated "
               "under the lock must always be mutated under it (the "
               "GraphServer._shares_cache torn-write class); deliberate "
               "lock-free paths need a suppression with justification")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef) or not _creates_lock(cls):
                continue
            methods = {n.name: n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            splits = {name: _split_writes(m) for name, m in methods.items()}

            # intra-class call sites: method -> set of (caller, locked?)
            call_sites: dict[str, set[tuple[str, bool]]] = {}
            for caller, m in methods.items():
                locked_spans = [
                    (w.lineno, getattr(w, "end_lineno", w.lineno))
                    for w in ast.walk(m) if isinstance(w, ast.With)
                    and any(_is_self_lock(i.context_expr) for i in w.items)]
                for sub in ast.walk(m):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Attribute) and \
                            isinstance(sub.func.value, ast.Name) and \
                            sub.func.value.id == "self" and \
                            sub.func.attr in methods:
                        in_lock = any(lo <= sub.lineno <= hi
                                      for lo, hi in locked_spans)
                        call_sites.setdefault(sub.func.attr, set()).add(
                            (caller, in_lock))

            # fixpoint: a method runs in a locked context if it is
            # __init__, or every intra-class call site is locked or comes
            # from a locked-context method.
            locked_ctx = {"__init__"}
            changed = True
            while changed:
                changed = False
                for name in methods:
                    if name in locked_ctx:
                        continue
                    sites = call_sites.get(name)
                    if sites and all(locked or caller in locked_ctx
                                     for caller, locked in sites):
                        locked_ctx.add(name)
                        changed = True

            guarded: set[str] = set()
            for name, (locked, _bare) in splits.items():
                for attr, _ in locked:
                    guarded.add(attr)
                if name in locked_ctx and name != "__init__":
                    for attr, _ in _bare_of(splits, name):
                        guarded.add(attr)

            for name, (_locked, bare) in splits.items():
                if name == "__init__" or name in locked_ctx:
                    continue
                for attr, node in bare:
                    if attr in guarded:
                        yield self.finding(
                            mod, node, f"{cls.name}.{name}",
                            f"write to self.{attr} outside `with "
                            f"self._lock` but {cls.name} also mutates it "
                            "under the lock — torn-write/torn-read hazard")


def _bare_of(splits, name):
    return splits[name][1]


register_rule(UnguardedWrite())
