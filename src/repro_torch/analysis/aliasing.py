"""Aliasing rule: owner state that gets mutated in place must be fresh.

The port of ``repro.analysis.aliasing``, over numpy's and torch's views.

Incident record: the reference's ``StreamSession`` assigned the array
returned by ``local_reauction`` straight to ``self.owner``.  That array
was a jax-backed, read-only view; the next in-place ``self.owner[idx] =
p`` raised ``ValueError: assignment destination is read-only`` — but only
on the first *streamed* update after a re-auction, which no unit test
hit.  The fix wraps it in ``np.array(...)`` (a writable copy).  In the
port the same class of bug is silent: ``torch.from_numpy(a)``,
``t.numpy()``, ``t.detach()``, ``t.view(...)`` and ``torch.as_tensor(a)``
share memory with their source, so an in-place write through the field
corrupts whoever else holds the buffer (a plan's host mirror, the
caller's array) instead of raising.  AL001 makes the bug class
unrepresentable.

Scope: classes in ``stream/`` modules.  For each ``self.<attr>`` that the
class mutates in place (``self.attr[...] = ...``, ``self.attr += ...``,
or mutating method calls, in-place torch methods ``add_``/``copy_``/...
included), every assignment ``self.attr = <expr>`` must be *provably
fresh*: a copying constructor (``np.array``, ``np.copy``,
``np.zeros/ones/full/empty/arange/concatenate/stack``, ``torch.tensor``,
``torch.zeros/ones/full/empty/arange/cat/stack``, ``.copy()``,
``.clone()``, ``list()/dict()/set()`` displays), or a local name that was
itself assigned fresh in the same function (slices of fresh stay fresh).
``np.asarray``, ``torch.as_tensor``, ``torch.from_numpy``, ``.numpy()``,
``.detach()`` and ``.view(...)`` are *not* fresh — each is a documented
no-copy passthrough, which is exactly how the incident array sneaked in.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .base import Finding, ImportMap, ModuleInfo, Rule, dotted, \
    register_rule

_FRESH_NP = {"array", "copy", "zeros", "ones", "full", "empty", "arange",
             "concatenate", "stack", "zeros_like", "ones_like",
             "full_like", "empty_like", "repeat", "tile", "where"}
#: torch constructors that always allocate (``torch.as_tensor`` and
#: ``torch.from_numpy`` do not: they share their argument's memory).
_FRESH_TORCH = {"tensor", "zeros", "ones", "full", "empty", "arange",
                "cat", "concat", "stack", "zeros_like", "ones_like",
                "full_like", "empty_like", "where", "clone", "randn",
                "rand", "randint", "linspace"}
_MUTATORS = {"append", "add", "update", "pop", "clear", "setdefault",
             "remove", "discard", "extend", "insert", "fill", "sort",
             "resize", "put",
             # torch's in-place tensor methods
             "add_", "sub_", "mul_", "div_", "copy_", "fill_", "zero_",
             "index_put_", "index_add_", "index_copy_", "index_fill_",
             "scatter_", "scatter_add_", "scatter_reduce_",
             "masked_fill_", "clamp_", "neg_"}


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_fresh(expr: ast.AST, fresh_locals: set[str],
              imports: ImportMap) -> bool:
    """Provably returns a newly allocated, writable object."""
    if isinstance(expr, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp, ast.Constant)):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in fresh_locals
    if isinstance(expr, ast.Subscript):
        # a slice of a fresh array is a view *of a writable array* — fine
        return _is_fresh(expr.value, fresh_locals, imports)
    if isinstance(expr, ast.BinOp):
        return True               # arithmetic allocates a new array
    if isinstance(expr, ast.Call):
        # method tails are checked on the raw Attribute so chains whose
        # base is itself a call — torch.from_numpy(x).clone() — still count
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in ("copy", "clone") and not expr.args:
                return True                      # x.copy(), t.clone()
            if expr.func.attr in ("astype", "tolist"):        # copies
                return True
        d = dotted(expr.func) or ""
        for name in (d, imports.resolve(d)):
            head, _, tail = name.rpartition(".")
            if head in ("np", "numpy") and tail in _FRESH_NP:
                return True
            if head == "torch" and tail in _FRESH_TORCH:
                return True
        if d in ("list", "dict", "set", "bytearray", "sorted"):
            return True
    return False


def _function_fresh_locals(fn: ast.AST, imports: ImportMap) -> set[str]:
    """Local names assigned a fresh expression anywhere in fn (single
    forward pass; sufficient for straight-line construction code)."""
    fresh: set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1 and \
                isinstance(sub.targets[0], ast.Name):
            if _is_fresh(sub.value, fresh, imports):
                fresh.add(sub.targets[0].id)
            else:
                fresh.discard(sub.targets[0].id)
    return fresh


class StaleViewAssignment(Rule):
    id = "AL001"
    family = "aliasing"
    name = "non-fresh-assignment-to-mutated-owner-field"
    summary = ("in stream/ classes, fields mutated in place must only be "
               "assigned provably-fresh values (np.array/.copy()/"
               ".clone()/torch.tensor); np.asarray, torch.as_tensor, "
               "torch.from_numpy, .numpy(), .detach() and .view() share "
               "their source's memory — the local_reauction read-only "
               "view class")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.subsystem != "stream":
            return
        imports = ImportMap(mod)
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            mutated: set[str] = set()
            for sub in ast.walk(cls):
                if isinstance(sub, (ast.Assign, ast.AugAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        if isinstance(t, ast.Subscript):
                            attr = _self_attr(t.value)
                            if attr:
                                mutated.add(attr)
                        elif isinstance(sub, ast.AugAssign):
                            attr = _self_attr(t)
                            if attr:
                                mutated.add(attr)
                elif isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in _MUTATORS:
                    attr = _self_attr(sub.func.value)
                    if attr:
                        mutated.add(attr)
            if not mutated:
                continue
            for m in cls.body:
                if not isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    continue
                fresh = _function_fresh_locals(m, imports)
                for sub in ast.walk(m):
                    if not isinstance(sub, ast.Assign):
                        continue
                    for t in sub.targets:
                        attr = _self_attr(t)
                        if attr in mutated and \
                                not _is_fresh(sub.value, fresh, imports):
                            yield self.finding(
                                mod, sub, f"{cls.name}.{m.name}",
                                f"self.{attr} is mutated in place "
                                f"elsewhere in {cls.name} but this "
                                "assignment is not provably fresh — a "
                                "shared or read-only view here corrupts "
                                "its source or raises on the next "
                                "in-place write; wrap in np.array(...) or "
                                ".clone()")


register_rule(StaleViewAssignment())
