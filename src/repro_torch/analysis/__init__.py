"""repro_torch.analysis — AST invariant checker for the PyTorch port.

The port of ``repro.analysis``: the same twelve rule ids, CLI, exit codes,
suppressions format and JSON report, each rule written for the port's
idiom.  Stdlib-only static analysis enforcing the invariants the test
suite can't see until they bite at runtime: host syncs and data-dependent
branches in autograd/checkpoint/compile roots (TS*), retrace/cache-key
hazards (RH*), lock discipline (LD*), view-aliasing freshness (AL*),
layering/purity (LP*, including "no module of the port imports ``repro``
or ``jax``") and state shape (SR*).  It imports no torch, no numpy, no
jax and nothing of ``repro``.

CLI:   python -m repro_torch.analysis [roots...] [--format json] [-o report.json]
Test:  repro_torch.analysis.run_clean("src/repro_torch")
Docs:  src/repro_torch/analysis/README.md — rule catalogue, each rule's
       torch form beside the incident motivating it.
"""
from . import rules as _rules  # noqa: F401  (registers the catalogue)
from .base import Finding, all_rules, module_info
from .runner import main, run_clean, scan
from .suppressions import Suppression, SuppressionError, parse

__all__ = ["Finding", "Suppression", "SuppressionError", "all_rules",
           "main", "module_info", "parse", "run_clean", "scan"]
