"""repro_torch.analysis — the port's AST invariant checker.

Four layers, all on the host (the analyzer reads source and runs nothing):
  * the port scans clean with its own suppressions file, which is found
    from ``src/repro_torch``, parsed and fully used;
  * every rule flags its bad fixtures under ``tests/fixtures/torch_analysis``
    exactly at the ``# FLAG: RULE`` markers and passes its good ones,
    including the four translated incidents;
  * held against ``repro.analysis``: the rules that do not depend on the
    framework (RH001-RH003, LD001, LP001, LP002, SR001 on numpy) give the
    same (rule, path, line, symbol) set on the reference's fixtures and on
    ``src/repro_torch`` without suppressions; each rule the port rewrote
    flags the same lines in its translation of the reference's fixture;
    the suppression grammar, ``apply`` and the CLI (exit codes, ``--rules``,
    ``--list-rules``, the JSON report) behave as the reference's on the
    same inputs;
  * importing ``repro_torch.analysis`` and listing its rules loads neither
    torch, numpy, jax nor repro.
"""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as RA
from repro.analysis import suppressions as RS
from repro_torch import analysis as TA
from repro_torch.analysis import suppressions as TS
from repro_torch.analysis.base import module_info, walk_functions
from repro_torch.analysis.runner import iter_sources
from repro_torch.analysis.trace_safety import traced_regions

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FIXTURES = REPO / "tests" / "fixtures" / "torch_analysis"
REF_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
_FLAG = re.compile(r"#\s*FLAG:\s*([A-Z]{2}\d{3})")

RULE_IDS = {"TS001", "TS002", "TS003", "RH001", "RH002", "RH003", "LD001",
            "AL001", "LP001", "LP002", "LP003", "SR001"}
#: Rules whose check does not depend on the framework: the two analyzers
#: must agree on them finding for finding (SR001 on numpy's allocators).
FRAMEWORK_FREE = ("RH001", "RH002", "RH003", "LD001", "LP001", "LP002",
                  "SR001")


def expected_flags(path: Path) -> set[tuple[str, int]]:
    out = set()
    for lineno, line in enumerate(path.read_text().splitlines(), start=1):
        for rule in _FLAG.findall(line):
            out.add((rule, lineno))
    return out


BAD_FIXTURES = sorted(FIXTURES.glob("*_bad.py")) + \
    sorted(FIXTURES.glob("incident_*.py"))
GOOD_FIXTURES = sorted(FIXTURES.glob("*_good.py"))


# ---------------------------------------------------------------------------
# the port scans clean
# ---------------------------------------------------------------------------

def test_port_scans_clean():
    assert TA.run_clean(str(PORT)), (
        "unsuppressed analyzer findings in src/repro_torch — run "
        "`python -m repro_torch.analysis src/repro_torch` for the list; fix "
        "them or add a justified entry to "
        "src/repro_torch/analysis_suppressions.txt")


def test_port_suppressions_are_found_parsed_and_fully_used():
    path = TS.discover(str(PORT))
    assert path == str(PORT / "analysis_suppressions.txt")
    supps = TS.parse(Path(path).read_text(), TA.all_rules(), path)
    assert supps
    kept, silenced = TS.apply(TA.scan(iter_sources([str(PORT)])), supps)
    assert not kept
    unused = [(s.rule, s.path_glob, s.symbol_glob) for s in supps
              if not s.used]
    assert not unused, f"stale suppressions (matched nothing): {unused}"
    assert {f.rule for f in silenced} == {"LD001", "LP002"}


def test_catalogue_is_the_references_twelve_rules():
    port, ref = TA.all_rules(), RA.all_rules()
    assert set(port) == set(ref) == RULE_IDS
    for rule_id, rule in port.items():
        assert rule.family == ref[rule_id].family, rule_id
        assert rule.summary and rule.name


@pytest.mark.parametrize("path,rel,subsystem", [
    ("src/repro_torch/engine/runtime.py", "engine/runtime.py", "engine"),
    ("src/repro_torch/__init__.py", "__init__.py", ""),
    ("src/repro_torch/analysis/base.py", "analysis/base.py", "analysis"),
    # the JAX package's tree is not the port's: no part is `repro_torch`
    ("src/repro/engine/runtime.py", "runtime.py", ""),
])
def test_paths_are_relative_to_the_port_package(path, rel, subsystem):
    mod = module_info(str(REPO / path))
    assert (mod.rel, mod.subsystem) == (rel, subsystem)


# ---------------------------------------------------------------------------
# per-rule fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", BAD_FIXTURES, ids=lambda p: p.stem)
def test_bad_fixture_flagged(path):
    expected = expected_flags(path)
    assert expected, f"{path.name} has no # FLAG markers"
    got = {(f.rule, f.line) for f in TA.scan([str(path)])}
    assert got == expected, (
        f"{path.name}: expected {sorted(expected)}, got {sorted(got)}")


@pytest.mark.parametrize("path", GOOD_FIXTURES, ids=lambda p: p.stem)
def test_good_fixture_clean(path):
    got = [(f.rule, f.line, f.message) for f in TA.scan([str(path)])]
    assert not got, f"{path.name}: unexpected findings {got}"


def test_every_rule_has_a_bad_fixture_hit():
    hit = set()
    for path in BAD_FIXTURES:
        hit |= {rule for rule, _ in expected_flags(path)}
    assert set(TA.all_rules()) <= hit, (
        f"rules without a bad fixture: {sorted(set(TA.all_rules()) - hit)}")


#: The port's trace roots (TS002/TS003), by module: every
#: ``torch.autograd.Function``'s forward and backward and the remat
#: recompute's closure.
ROOTS = {
    "kernels/ops.py": {"_SelectiveScan.forward", "_SelectiveScan.backward"},
    "models/flash_vjp.py": {"_FlashFA2.forward", "_FlashFA2.backward"},
    "core/collectives.py": {f"{c}.{m}" for c in (
        "_GatherShard", "_CopyToTp", "_ReduceFromTp", "_ScaleGrad")
        for m in ("forward", "backward")},
    "models/lm.py": {"_run_blocks.pinned", "_run_blocks.repeat"},
}
#: Host drivers that read the device on purpose, once a sweep or a round:
#: none is reachable from a root.
HOST_DRIVERS = {
    "engine/runtime.py": ("_run_loop", "_run_loop.local_phase",
                          "_run_lanes", "_run_lanes.local_phase"),
    "core/dfep.py": ("_run_rounds",),
    "core/etsch.py": ("_local_fixed_point", "run_etsch"),
}


@pytest.mark.parametrize("rel", sorted(set(ROOTS) | set(HOST_DRIVERS)))
def test_port_roots_are_traced_and_host_drivers_are_not(rel):
    mod = module_info(str(PORT / rel))
    traced = set(traced_regions(mod))
    assert ROOTS.get(rel, set()) <= traced
    names = {q for q, _ in walk_functions(mod.tree)}
    for q in HOST_DRIVERS.get(rel, ()):
        assert q in names, q
        assert q not in traced, q


# ---------------------------------------------------------------------------
# held against the reference analyzer
# ---------------------------------------------------------------------------

def _keys(findings, root, rules=FRAMEWORK_FREE) -> set:
    return {(f.rule, os.path.relpath(f.file, root), f.line, f.symbol)
            for f in findings if f.rule in rules}


REF_INPUTS = [f"{r}_{k}.py" for r in ("rh001", "rh002", "rh003", "ld001",
                                      "lp001", "lp002")
              for k in ("bad", "good")] + [
    "incident_pagerank_iters.py", "sr001_good.py", "incident_scalar_state.py"]


@pytest.mark.parametrize("name", REF_INPUTS)
def test_framework_free_rules_agree_on_the_reference_fixtures(name):
    path = str(REF_FIXTURES / name)
    want = _keys(RA.scan([path]), REPO)
    got = _keys(TA.scan([path]), REPO)
    assert got == want
    assert {(r, ln) for r, _, ln, _ in want} == \
        expected_flags(REF_FIXTURES / name)


def test_framework_free_rules_agree_over_the_port_unsuppressed():
    paths = iter_sources([str(PORT)])
    want = _keys(RA.scan(paths), PORT)
    got = _keys(TA.scan(paths), PORT)
    assert got == want
    # the reference's own exemptions, found in the port's copies
    assert len(want) == 9
    assert {(r, p, s) for r, p, _, s in want} == {
        ("LP002", "ckpt/checkpoint.py", "CheckpointManager._write")} | {
        ("LD001", "obs/recorder.py", f"Recorder.{m}") for m in (
            "disable", "_record", "counter", "gauge", "begin", "end")}


#: Each rule the port rewrote: the reference's fixture beside its port
#: translation, which puts the same violation on the same line.
REWRITTEN = [(rule, ref, port) for rule, ref, port in (
    ("TS001", "ts001_bad.py", "ts001_bad.py"),
    ("TS002", "ts002_bad.py", "ts002_bad.py"),
    ("TS003", "ts003_bad.py", "ts003_bad.py"),
    ("AL001", "al001_bad.py", "al001_bad.py"),
    ("LP003", "lp003_bad.py", "lp003_bad.py"),
    ("SR001", "incident_scalar_state.py", "incident_scalar_state.py"),
    ("TS001", "ts001_good.py", "ts001_good.py"),
    ("TS002", "ts002_good.py", "ts002_good.py"),
    ("TS003", "ts003_good.py", "ts003_good.py"),
    ("AL001", "al001_good.py", "al001_good.py"),
    ("LP003", "lp003_good.py", "lp003_good.py"),
    ("SR001", "sr001_good.py", "sr001_good.py"))]


@pytest.mark.parametrize("rule,ref,port", REWRITTEN,
                         ids=[p.removesuffix(".py") for _, _, p in REWRITTEN])
def test_rewritten_rule_flags_the_lines_the_reference_flags(rule, ref, port):
    want = {f.line for f in RA.scan([str(REF_FIXTURES / ref)])
            if f.rule == rule}
    got = {f.line for f in TA.scan([str(FIXTURES / port)]) if f.rule == rule}
    assert got == want
    assert want == {ln for r, ln in expected_flags(REF_FIXTURES / ref)
                    if r == rule}


def _parsed(mod, text):
    try:
        return [(s.rule, s.path_glob, s.symbol_glob, s.justification,
                 s.lineno) for s in mod.parse(text, RA.all_rules())]
    except mod.SuppressionError as e:
        return ("error", str(e))


GRAMMAR = {
    "valid": "LP002 foo.py -- a timestamp\n"
             "LD001 obs/*.py Recorder.* -- lock-free record path\n",
    "comments_and_blanks": "# why\n\n   \nRH002 x.py -- shared default\n",
    "missing_reason": "LP002 foo.py\n",
    "empty_reason": "LP002 foo.py --   \n",
    "unknown_rule": "ZZ999 foo.py -- whatever\n",
    "too_many_fields": "LP002 a.py b c -- x\n",
    "too_few_fields": "LP002 -- x\n",
}


@pytest.mark.parametrize("case", sorted(GRAMMAR))
def test_suppression_grammar_matches_reference(case):
    got = _parsed(TS, GRAMMAR[case])
    assert got == _parsed(RS, GRAMMAR[case])
    if case in ("valid", "comments_and_blanks"):
        assert got and got[0] != "error"
    else:
        assert got[0] == "error"


#: (fixture, suppressions text): a whole-file match, a symbol glob that
#: narrows, and an entry that matches nothing.
APPLY = {
    "round_trip": ("lp002_bad.py",
                   "LP002 tests/fixtures/analysis/lp002_bad.py -- fixture\n"),
    "symbol_glob": ("ld001_bad.py",
                    "LD001 *ld001_bad.py Widget.refresh -- only refresh\n"),
    "unused": ("lp002_good.py", "LP002 nowhere/*.py -- never matches\n"),
}


@pytest.mark.parametrize("case", sorted(APPLY))
def test_suppression_apply_matches_reference(case):
    name, text = APPLY[case]
    path = str(REF_FIXTURES / name)

    def run(analysis, supp_mod):
        supps = supp_mod.parse(text, analysis.all_rules())
        kept, silenced = supp_mod.apply(analysis.scan([path]), supps)
        return (_keys(kept, REPO), _keys(silenced, REPO),
                [s.used for s in supps])

    got = run(TA, TS)
    assert got == run(RA, RS)
    kept, silenced, used = got
    assert used == [case != "unused"]
    if case == "symbol_glob":
        assert kept and silenced
        assert {s for *_, s in silenced} == {"Widget.refresh"}


def _cli(package, args, cwd):
    return subprocess.run(
        [sys.executable, "-m", package, *args], capture_output=True,
        text=True, cwd=cwd, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


#: name -> the CLI's arguments ({ref} a reference fixture, {tmp} the test's
#: directory); each runs under both packages.
CLI = {
    "clean_exit_0": ["{ref}/rh001_good.py"],
    "findings_exit_1": ["{ref}/lp001_bad.py", "--no-suppressions"],
    "json_report": ["{ref}/lp001_bad.py", "{ref}/ld001_bad.py",
                    "--no-suppressions", "--format", "json"],
    "json_report_file": ["{ref}/rh002_bad.py", "--no-suppressions",
                         "--format", "json", "-o", "{tmp}/report.json"],
    "rules_filter": ["{ref}/ld001_bad.py", "{ref}/lp002_bad.py",
                     "--no-suppressions", "--rules", "LD001"],
    "explicit_suppressions": ["{ref}/lp002_bad.py", "--suppressions",
                              "{tmp}/ok.txt"],
    "unused_suppression_warns": ["{ref}/lp002_good.py", "--suppressions",
                                 "{tmp}/ok.txt"],
    "unknown_rules_filter_exit_2": ["{ref}/lp002_good.py", "--rules",
                                    "NOPE01"],
    "unknown_suppression_rule_exit_2": ["{ref}/lp002_good.py",
                                        "--suppressions", "{tmp}/stale.txt"],
    "missing_reason_exit_2": ["{ref}/lp002_good.py", "--suppressions",
                              "{tmp}/reasonless.txt"],
    "missing_suppressions_file_exit_2": ["{ref}/lp002_good.py",
                                         "--suppressions", "{tmp}/none.txt"],
    "no_such_path_exit_2": ["{ref}/does_not_exist.py"],
    "list_rules": ["--list-rules"],
}
EXIT = {"clean_exit_0": 0, "findings_exit_1": 1, "json_report": 1,
        "json_report_file": 1, "rules_filter": 1,
        "explicit_suppressions": 0, "unused_suppression_warns": 0,
        "list_rules": 0}
_TEXT_FINDING = re.compile(r"^(.*):(\d+):(\d+): ([A-Z]{2}\d{3}) \[(.*?)\] ")


def _cli_result(package, case, tmp):
    out_dir = tmp / package
    out_dir.mkdir()
    (out_dir / "ok.txt").write_text(
        "LP002 */lp002_bad.py measure -- fixture timestamps\n")
    (out_dir / "stale.txt").write_text("XX123 foo.py -- stale\n")
    (out_dir / "reasonless.txt").write_text("LP002 foo.py\n")
    args = [a.format(ref=REF_FIXTURES, tmp=out_dir) for a in CLI[case]]
    proc = _cli(package, args, tmp)
    res = {"rc": proc.returncode}
    if case == "list_rules":
        res["ids"] = set(re.findall(r"^([A-Z]{2}\d{3})  ", proc.stdout,
                                    re.MULTILINE))
    elif "--format" in args:
        text = (out_dir / "report.json").read_text() if "-o" in args \
            else proc.stdout
        payload = json.loads(text)
        res["keys"] = sorted(payload)
        res["schema"] = payload["schema"]
        res["ok"] = payload["ok"]
        res["counts"] = payload["counts"]
        res["rules"] = sorted(payload["rules"])
        res["findings"] = sorted(
            (f["rule"], os.path.relpath(f["file"], REPO), f["line"],
             f["col"], f["symbol"], tuple(sorted(f)))
            for f in payload["findings"])
    else:
        res["findings"] = sorted(
            m.groups() for m in map(_TEXT_FINDING.match,
                                    proc.stdout.splitlines()) if m)
        res["error"] = proc.stderr.startswith("error:")
        res["warning"] = "warning: unused suppression" in proc.stderr
    return res


@pytest.mark.parametrize("case", sorted(CLI))
def test_cli_matches_reference(case, tmp_path):
    got = _cli_result("repro_torch.analysis", case, tmp_path)
    want = _cli_result("repro.analysis", case, tmp_path)
    assert got == want
    assert got["rc"] == EXIT.get(case, 2)
    if case == "list_rules":
        assert got["ids"] == RULE_IDS
    elif "findings" in got:
        assert bool(got["findings"]) == (got["rc"] == 1)
    if "keys" in got:
        assert got["schema"] == "repro.analysis/v1" and got["ok"] is False
        assert got["counts"]["unsuppressed"] == len(got["findings"]) > 0
    if case.endswith("_exit_2") and case != "no_such_path_exit_2":
        assert got["error"]
    if case == "unused_suppression_warns":
        assert got["warning"]


def test_cli_scans_the_port_clean_by_default():
    """With no roots, from the repository's root, the CLI scans
    ``src/repro_torch`` with the port's own suppressions."""
    proc = _cli("repro_torch.analysis", [], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"0 unsuppressed finding\(s\), 9 suppressed, 12 rules",
                     proc.stdout), proc.stdout
    assert "warning" not in proc.stderr
    proc = _cli("repro_torch.analysis", ["src/repro_torch",
                                         "--no-suppressions"], REPO)
    assert proc.returncode == 1


# ---------------------------------------------------------------------------
# stdlib only
# ---------------------------------------------------------------------------

def test_importing_the_analyzer_loads_no_heavy_package():
    code = ("import sys\n"
            "import repro_torch.analysis as A\n"
            "assert A.main(['--list-rules']) == 0\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax', 'repro')\n"
            "             if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_package_loads_its_subpackages_on_first_use():
    import repro_torch
    from repro_torch import core, engine, kernels
    assert repro_torch.core is core and repro_torch.engine is engine
    assert repro_torch.kernels is kernels
    with pytest.raises(AttributeError):
        repro_torch.no_such_module


def test_analyzer_sources_import_only_the_standard_library():
    allowed = set(sys.stdlib_module_names) | {"__future__"}
    for path in sorted((PORT / "analysis").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
