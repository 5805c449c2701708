"""Trace-safety rules: keep recorded, captured and autograd paths free of
host syncs.

The port of ``repro.analysis.trace_safety``.  Where the reference guards
jit traces, the port guards the places where a host sync costs most in
PyTorch: the ``forward``/``backward`` of ``torch.autograd.Function``
subclasses (a backward runs on autograd's device thread, so a sync there
serialises it with everything queued before it), the recompute of
``torch.utils.checkpoint.checkpoint``, and functions handed to
``torch.compile``, ``torch.jit.script``/``trace``, ``torch.func.*``,
``torch.vmap`` or captured by ``torch.cuda.graph`` /
``make_graphed_callables`` (where a sync breaks the graph, or raises
under capture).

Incident record (the reason this family exists): the reference's first
cut of the engine instrumentation computed ``jnp.max``/``jnp.all``
reductions while building recorder event arguments.  Each served result
then dispatched a fresh single-op device computation on the host-sync
path and the observability overhead benchmark blew its 3% budget.  In the
port ``torch.amax(...)`` in an event argument is the same bug: a kernel
launch and a device-to-host read per event.

TS001  no ``torch.*`` calls (alias-aware: ``import torch as T``,
       ``from torch import amax``) inside recorder event/span/counter
       arguments;
TS002  no host syncs (``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
       ``np.asarray``/``np.array``/``bool|int|float(torch...)``/
       ``torch.cuda.synchronize()``/``.synchronize()``) inside functions
       reachable from a trace root; ``bool|int|float`` of a tensor
       reduction (``bool((a != b).any())``) counts as ``torch...``;
TS003  no Python ``if``/``while``/``assert``/ternary on a device value (a
       ``torch.*`` expression or a tensor reduction such as ``x.any()``)
       inside those same functions — the branch reads the tensor back to
       the host, and under ``torch.compile`` or graph capture it breaks
       the graph or is frozen into it.

Predicates that return Python values without touching a tensor's data
(``torch.is_grad_enabled()``, ``torch.is_tensor``,
``torch.cuda.is_available()``, ``torch.distributed.is_initialized()``,
``torch.jit.is_scripting()``, ``torch.finfo``, ...) give static branches
and stay legal.

"Reachable from a trace root" is computed per module: roots are the
``forward``/``backward`` (and ``setup_context``/``jvp``/``vjp``) methods
of ``torch.autograd.Function`` subclasses, functions decorated with or
passed to a tracer above (every bare name in the call's arguments, so
``checkpoint(pinned, r, x)`` roots the closure ``pinned``), and the body
of a ``with torch.cuda.graph(...)`` block — plus every module-local
function they call by bare name, transitively, and functions nested in a
traced one.  A host driver that merely *calls* ``checkpoint(step, ...)``
or ``Function.apply`` is not traced; ``step`` and ``forward`` are.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .base import (Finding, ImportMap, ModuleInfo, Rule, dotted,
                   qualname_at, register_rule, walk_functions)

# subsystems whose modules hold trace roots
TRACED_SUBSYSTEMS = ("kernels", "models", "core", "engine", "train")

_RECORDER_METHODS = {"event", "gauge", "counter", "begin", "end"}
#: Callables whose function arguments run under a trace, a recompute or a
#: capture (resolved dotted names), and prefixes whose every member does.
_TRACERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
            "torch.vmap", "torch.utils.checkpoint.checkpoint",
            "torch.utils.checkpoint.checkpoint_sequential",
            "torch.cuda.make_graphed_callables"}
_TRACER_PREFIXES = ("torch.func.",)
_GRAPH_CAPTURE = {"torch.cuda.graph"}
_FUNCTION_BASES = {"torch.autograd.Function",
                   "torch.autograd.function.Function"}
_FUNCTION_METHODS = {"forward", "backward", "setup_context", "jvp", "vjp"}
#: torch calls that return Python values from metadata or process state,
#: never from a tensor's data: no device work, no sync, a static branch.
_STATIC = {
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled",
    "torch.is_tensor", "torch.is_storage", "torch.is_floating_point",
    "torch.is_complex", "torch.is_autocast_enabled", "torch.numel",
    "torch.get_default_dtype", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.device", "torch.dtype",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_name",
    "torch.cuda.get_device_capability",
    "torch.cuda.is_current_stream_capturing",
    "torch.distributed.is_available", "torch.distributed.is_initialized",
    "torch.distributed.get_rank", "torch.distributed.get_world_size",
    "torch.jit.is_scripting", "torch.jit.is_tracing",
    "torch.compiler.is_compiling", "torch.compiler.is_dynamo_compiling",
}
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: Tensor reductions whose result, read as a Python value (``bool(...)``,
#: ``int(...)``, an ``if``), is a device read: ``bool((a != b).any())``,
#: the port's own idiom for a convergence test.
_REDUCTIONS = {"any", "all", "sum", "max", "min", "amax", "amin", "mean",
               "prod", "norm", "count_nonzero", "argmax", "argmin"}


def _torch_name(d: str, imports: ImportMap) -> str | None:
    """The canonical ``torch.*`` name a dotted call target resolves to
    (alias-aware), else None."""
    resolved = imports.resolve(d)
    return resolved if resolved.split(".")[0] == "torch" else None


def _is_torch_call(node: ast.AST, imports: ImportMap) -> bool:
    """True for any ``torch.<op>(...)`` (alias-aware) in the subtree that
    is not a static predicate (:data:`_STATIC`)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = dotted(sub.func)
            name = _torch_name(d, imports) if d else None
            if name and name not in _STATIC:
                return True
    return False


def _reads_device(node: ast.AST, imports: ImportMap) -> bool:
    """True when the subtree holds a device value a Python read would
    sync on: a non-static ``torch.*`` call, or a tensor reduction method
    (``x.any()``, ``(a != b).sum()``)."""
    if _is_torch_call(node, imports):
        return True
    return any(isinstance(sub, ast.Call)
               and isinstance(sub.func, ast.Attribute)
               and sub.func.attr in _REDUCTIONS
               for sub in ast.walk(node))


def _is_tracer(node: ast.AST, imports: ImportMap) -> bool:
    """True when a call target or decorator (``torch.compile`` or
    ``torch.compile(mode=...)``) is a tracer."""
    if isinstance(node, ast.Call):
        node = node.func
    d = dotted(node)
    name = _torch_name(d, imports) if d else None
    return bool(name) and (name in _TRACERS
                           or name.startswith(_TRACER_PREFIXES))


def _is_function_subclass(cls: ast.ClassDef, imports: ImportMap) -> bool:
    for base in cls.bases:
        d = dotted(base)
        if d and imports.resolve(d) in _FUNCTION_BASES:
            return True
    return False


def _callee_names(call: ast.AST) -> Iterator[str]:
    """Bare function names referenced anywhere in a call's arguments
    (covers ``checkpoint(f, ...)``, ``vmap(partial(f, k))``)."""
    for sub in ast.walk(call):
        if isinstance(sub, ast.Name):
            yield sub.id


def _called_names(node: ast.AST) -> Iterator[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
            yield sub.func.id


def traced_regions(mod: ModuleInfo) -> dict[str, list[ast.AST]]:
    """symbol -> the AST nodes that run traced under it: every function
    reachable from a trace root, and the bodies of graph-capture blocks
    (under their enclosing function's qualname)."""
    imports = ImportMap(mod)
    funcs = dict(walk_functions(mod.tree))
    by_name: dict[str, list[str]] = {}
    for q in funcs:
        by_name.setdefault(q.rsplit(".", 1)[-1], []).append(q)

    roots: set[str] = set()
    captured: dict[str, list[ast.AST]] = {}
    for q, fn in funcs.items():
        if any(_is_tracer(dec, imports) for dec in fn.decorator_list):
            roots.add(q)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and \
                _is_function_subclass(node, imports):
            prefix = qualname_at(mod.tree, node)
            prefix = "" if prefix == "<module>" else prefix + "."
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and \
                        item.name in _FUNCTION_METHODS:
                    roots.add(f"{prefix}{node.name}.{item.name}")
        elif isinstance(node, ast.Call) and _is_tracer(node.func, imports):
            # functions *passed to* a tracer become roots; the enclosing
            # function is deliberately NOT one: it runs eagerly
            for name in _callee_names(node):
                roots.update(by_name.get(name, ()))
        elif isinstance(node, ast.With) and any(
                isinstance(i.context_expr, ast.Call)
                and (n := dotted(i.context_expr.func))
                and imports.resolve(n) in _GRAPH_CAPTURE
                for i in node.items):
            captured.setdefault(qualname_at(mod.tree, node),
                                []).extend(node.body)
            for stmt in node.body:
                for name in _called_names(stmt):
                    roots.update(by_name.get(name, ()))

    # nested functions inherit their parent's traced-ness; plus fixpoint
    # over module-local calls by bare name
    traced = {q for q in roots if q in funcs}
    changed = True
    while changed:
        changed = False
        for q in funcs:
            if q not in traced and "." in q and \
                    q.rsplit(".", 1)[0] in traced:
                traced.add(q)
                changed = True
        for q in list(traced):
            for name in _called_names(funcs[q]):
                for cand in by_name.get(name, ()):
                    if cand not in traced:
                        traced.add(cand)
                        changed = True
    out = {q: [funcs[q]] for q in traced}
    for q, body in captured.items():
        if q not in out:
            out[q] = body
    return out


class TorchInRecorderArgs(Rule):
    id = "TS001"
    family = "trace-safety"
    name = "torch-in-recorder-args"
    summary = ("recorder event/span/counter arguments must not call "
               "torch.* (each call launches device work, and reading it "
               "syncs, per recorded event — the jnp.max overhead "
               "regression); use Python or numpy on synced host values")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        imports = ImportMap(mod)
        # local names bound to the process recorder: ``rec = _obs.get()``
        rec_names: set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                d = dotted(node.value.func) or ""
                if d.endswith(".get") and ("obs" in d or "rec" in d):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            rec_names.add(t.id)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RECORDER_METHODS):
                continue
            recv = node.func.value
            is_rec = (isinstance(recv, ast.Name) and recv.id in rec_names)
            if not is_rec and isinstance(recv, ast.Call):
                d = dotted(recv.func) or ""
                is_rec = d.endswith(".get") and ("obs" in d or "rec" in d)
            if not is_rec:
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if _is_torch_call(arg, imports):
                    yield self.finding(
                        mod, arg, qualname_at(mod.tree, node),
                        f"torch.* call inside recorder .{node.func.attr}() "
                        "arguments launches device work (and a sync to "
                        "read it) per recorded event; compute on synced "
                        "host values instead")
                    break


class HostSyncInTrace(Rule):
    id = "TS002"
    family = "trace-safety"
    name = "host-sync-in-traced-function"
    summary = ("no .item()/.tolist()/.cpu()/.numpy()/np.asarray/np.array/"
               "bool|int|float(torch...)/torch.cuda.synchronize() inside "
               "autograd.Function forward/backward, checkpoint recomputes, "
               "torch.compile/jit/func/vmap bodies or CUDA-graph captures "
               "— a host sync serialises or breaks them")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.subsystem not in TRACED_SUBSYSTEMS:
            return
        imports = ImportMap(mod)
        for q, nodes in traced_regions(mod).items():
            for sub in (s for n in nodes for s in ast.walk(n)):
                if not isinstance(sub, ast.Call):
                    continue
                msg = self._sync(sub, imports, q)
                if msg:
                    yield self.finding(mod, sub, q, msg)

    @staticmethod
    def _sync(call: ast.Call, imports: ImportMap, q: str) -> str | None:
        d = dotted(call.func) or ""
        resolved = imports.resolve(d) if d else ""
        if resolved in ("numpy.asarray", "numpy.array") or \
                d in ("np.asarray", "np.array"):
            return (f"{d}() inside traced function {q!r} copies a device "
                    "tensor to the host (a sync), or freezes a value at "
                    "trace time; keep it a tensor")
        if resolved == "torch.cuda.synchronize":
            return (f"torch.cuda.synchronize() inside traced function "
                    f"{q!r} waits for the whole device")
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in _SYNC_ATTRS and not call.args and \
                not call.keywords:
            return (f".{call.func.attr}() inside traced function {q!r} "
                    "forces a host sync")
        if isinstance(call.func, ast.Name) and \
                call.func.id in ("float", "int", "bool") and \
                call.args and _reads_device(call.args[0], imports):
            return (f"{call.func.id}(torch...) inside traced function "
                    f"{q!r} reads a device value back to the host (a "
                    "sync; a graph break under torch.compile)")
        return None


class TracedBranch(Rule):
    id = "TS003"
    family = "trace-safety"
    name = "python-branch-on-traced-value"
    summary = ("no Python if/while/assert/ternary on a torch.* expression "
               "inside traced functions — use torch.where/masking "
               "(data-dependent Python control flow syncs, and breaks or "
               "freezes a graph); static predicates such as "
               "torch.is_grad_enabled() stay legal")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.subsystem not in TRACED_SUBSYSTEMS:
            return
        imports = ImportMap(mod)
        for q, nodes in traced_regions(mod).items():
            for sub in (s for n in nodes for s in ast.walk(n)):
                test = None
                kind = None
                if isinstance(sub, (ast.If, ast.While)):
                    test, kind = sub.test, type(sub).__name__.lower()
                elif isinstance(sub, ast.IfExp):
                    test, kind = sub.test, "ternary"
                elif isinstance(sub, ast.Assert):
                    test, kind = sub.test, "assert"
                if test is None or not _reads_device(test, imports):
                    continue
                yield self.finding(
                    mod, sub, q,
                    f"Python {kind} on a torch.* expression inside traced "
                    f"function {q!r}: data-dependent control flow reads "
                    "the device value back; use torch.where or masking")


register_rule(TorchInRecorderArgs())
register_rule(HostSyncInTrace())
register_rule(TracedBranch())
