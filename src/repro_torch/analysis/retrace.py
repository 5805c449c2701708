"""Retrace-hazard rules: cache keys must be stable and total.

The port of ``repro.analysis.retrace``; the rules do not depend on the
framework.  The port keys its caches on request content — the serving
result cache (``gserve/cache.py``), the scheduler's batch keys
(``gserve/scheduler.py``) and the program registry's entries
(``engine/registry.py``) — as the reference keys jit's.  Anything
unstable (dict order), unhashable (lists/dicts in a key), or *partial* (a
key function that silently skips a parameter) either crashes at dispatch,
misses the cache on every call, or — worst — serves a stale result for a
semantically different request.

Incident record: the pagerank ``iters=None`` cache-identity bug — a cache
key built with ``params.get("iters")`` collapsed the default and an
explicit ``None`` onto the same entry while validation treated them
differently.  Key functions index declared params totally
(``params[name]``), and RH003 keeps it that way.

RH001  ``tuple(d.items()/keys()/values())`` without a surrounding
       ``sorted(...)`` inside key-building code — dict iteration order is
       insertion order, so two semantically equal requests can produce
       different cache keys (scoped to registry/scheduler/cache modules);
RH002  mutable default argument values (list/dict/set displays) anywhere —
       shared across calls, and unhashable if they reach a cache key;
RH003  ``params.get(...)``/``kw.get(...)`` inside a ``*key*``-named
       function — key construction must fail loudly on a missing param,
       not silently alias requests (the pagerank incident).
"""
from __future__ import annotations

import ast
from typing import Iterator

from .base import (Finding, ModuleInfo, Rule, qualname_at, register_rule,
                   walk_functions)

_KEY_MODULES = ("registry.py", "scheduler.py", "cache.py")
_DICT_ITERS = {"items", "keys", "values"}
_PARAMS_NAMES = {"params", "kw", "kwargs"}


class UnsortedDictKey(Rule):
    id = "RH001"
    family = "retrace-hazard"
    name = "dict-order-dependent-cache-key"
    summary = ("tuple(d.items()/keys()/values()) without sorted(...) in "
               "registry/scheduler/cache key code — insertion order leaks "
               "into cache identity, aliasing or splitting cache entries")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.rel.endswith(_KEY_MODULES):
            return
        # parent chain so we can see whether a tuple() call sits inside a
        # sorted() call
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "tuple" and node.args):
                continue
            inner = node.args[0]
            # tuple(sorted(...)) — fine, regardless of what's inside
            if isinstance(inner, ast.Call) and \
                    isinstance(inner.func, ast.Name) and \
                    inner.func.id == "sorted":
                continue
            has_dict_iter = any(
                isinstance(s, ast.Call)
                and isinstance(s.func, ast.Attribute)
                and s.func.attr in _DICT_ITERS and not s.args
                for s in ast.walk(inner))
            if not has_dict_iter:
                continue
            # sorted(tuple(d.items())) and friends — also fine
            p = parents.get(node)
            guarded = False
            while p is not None and not isinstance(
                    p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
                if isinstance(p, ast.Call) and \
                        isinstance(p.func, ast.Name) and \
                        p.func.id == "sorted":
                    guarded = True
                    break
                p = parents.get(p)
            if guarded:
                continue
            yield self.finding(
                mod, node, qualname_at(mod.tree, node),
                "tuple() over dict .items()/.keys()/.values() without "
                "sorted(): insertion order becomes cache-key identity")


class MutableDefault(Rule):
    id = "RH002"
    family = "retrace-hazard"
    name = "mutable-default-argument"
    summary = ("list/dict/set literal default argument — shared across "
               "calls and unhashable if it reaches a cache key; default to "
               "None and construct inside")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for q, fn in walk_functions(mod.tree):
            args = fn.args
            for default in list(args.defaults) + \
                    [d for d in args.kw_defaults if d is not None]:
                if isinstance(default, (ast.List, ast.Dict, ast.Set,
                                        ast.ListComp, ast.DictComp,
                                        ast.SetComp)):
                    yield self.finding(
                        mod, default, q,
                        f"mutable default argument in {q!r}: evaluated "
                        "once, shared across calls, unhashable as a cache "
                        "key")
                elif isinstance(default, ast.Call) and \
                        isinstance(default.func, ast.Name) and \
                        default.func.id in ("list", "dict", "set"):
                    yield self.finding(
                        mod, default, q,
                        f"mutable default argument in {q!r}")


class GetInKeyFunction(Rule):
    id = "RH003"
    family = "retrace-hazard"
    name = "silent-get-in-key-function"
    summary = ("params.get()/kw.get() inside a *key*-named function — a "
               "missing param silently aliases distinct requests onto one "
               "cache entry (the pagerank iters=None incident); index "
               "declared params totally")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for q, fn in walk_functions(mod.tree):
            if "key" not in fn.name.lower():
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == "get" and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id in _PARAMS_NAMES:
                    yield self.finding(
                        mod, sub, q,
                        f"{sub.func.value.id}.get() inside key function "
                        f"{q!r}: missing params must raise, not default — "
                        "silent defaults alias cache identities")


register_rule(UnsortedDictKey())
register_rule(MutableDefault())
register_rule(GetInKeyFunction())
