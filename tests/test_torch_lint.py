"""The port's static lint (``crdt_benches_tpu_torch/lint/``) against the
JAX package's (``crdt_benches_tpu/lint/``).

- The rules ported as they were (G006-G008, G011-G025, G027-G029): both
  linters over JAX's fixture corpus (``tests/lint_fixtures``, read-only),
  file by file and directory by directory, with each directory's
  ``artifact.json`` for the artifact rules, give the same (rule, line)
  set.
- The torch twins (G001, G002, G004, G005, G026 and G009's twin, the
  launch boundary): their own corpus (``tests/torch_lint/lint_fixtures``)
  is flagged exactly, ``# expect: G0xx`` line by line.  The same corpus
  pins the port's changes to ported rules: G011's fence tags
  (``fence_tags/``), and the resolver's and G015's precision
  (``precision/``, against JAX's findings).
- The port's package lints clean with jax blocked, and a small armed CPU
  serve drain's report is the artifact for the five cross-checks, which
  are clean.
- The CLI: exit codes, the json and SARIF shapes, ``--fix`` exact and
  idempotent, ``--boundaries``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from crdt_benches_tpu.lint.core import run_lint as jax_lint
from crdt_benches_tpu_torch.lint import SANITIZERS
from crdt_benches_tpu_torch.lint.__main__ import main as lint_main
from crdt_benches_tpu_torch.lint.core import run_lint
from crdt_benches_tpu_torch.lint.rules import RULES

REPO = Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "lint_fixtures"
TWINS = REPO / "tests" / "torch_lint" / "lint_fixtures"
PACKAGE = REPO / "crdt_benches_tpu_torch"

#: The rules the port carries over as they were.
PORTED = {f"G{n:03d}" for n in (6, 7, 8, *range(11, 26), 27, 28, 29)}
#: The torch twins.
TWIN_RULES = {"G001", "G002", "G004", "G005", "G009", "G026"}
ARTIFACT_KW = ("sync_artifact", "thread_artifact", "fs_artifact",
               "lifecycle_artifact", "ranges_artifact")
_EXPECT_RE = re.compile(r"expect:\s*(G\d{3})")


def expected_markers(path: Path) -> set[tuple[str, int]]:
    out = set()
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if "#" in line:
            out |= {(m.group(1), i)
                    for m in _EXPECT_RE.finditer(line.split("#", 1)[1])}
    return out


def _artifacts(d: Path) -> dict:
    a = d / "artifact.json"
    return {k: str(a) for k in ARTIFACT_KW} if a.exists() else {}


JAX_TARGETS = sorted(JAX_FIXTURES.glob("**/*.py")) + sorted(
    {p.parent for p in JAX_FIXTURES.glob("**/*.py")})


@pytest.mark.parametrize(
    "target", JAX_TARGETS, ids=lambda p: str(p.relative_to(JAX_FIXTURES)))
def test_ported_rules_equal_jax_on_its_corpus(target):
    kw = _artifacts(target if target.is_dir() else target.parent)
    want = {(f.path, f.rule, f.line) for f in jax_lint([str(target)], **kw)
            if f.rule in PORTED}
    got = {(f.path, f.rule, f.line) for f in run_lint([str(target)], **kw)
           if f.rule in PORTED}
    assert got == want


def test_jax_corpus_exercises_every_ported_rule():
    seen = {r for p in JAX_FIXTURES.glob("**/*.py")
            for r, _ in expected_markers(p)}
    assert PORTED <= seen
    assert set(RULES) == PORTED | TWIN_RULES
    assert not {"G003", "G010"} & set(RULES)


#: Corpus directories linted as a unit by tests of their own.
UNIT_DIRS = ("launch", "fence_tags")
TWIN_FILES = sorted(p for p in TWINS.glob("**/*.py")
                    if not set(UNIT_DIRS) & set(p.parts))


@pytest.mark.parametrize("path", TWIN_FILES,
                         ids=lambda p: str(p.relative_to(TWINS)))
def test_twin_fixture_flagged_exactly(path):
    got = {(f.rule, f.line) for f in run_lint([str(path)])}
    assert got == expected_markers(path)
    assert got  # every file holds at least one hazard


def test_launch_boundary_corpus_flagged_exactly():
    """G009's twin lints ``launch/`` as a unit: the table against the
    ``.cu`` entries, every launch site's argument count and check()."""
    d = TWINS / "launch"
    findings = run_lint([str(d)])
    got = {(f.path, f.rule, f.line) for f in findings}
    want = {(str(p), r, ln) for p in d.glob("*.py")
            for r, ln in expected_markers(p)}
    cu = str(d / "csrc" / "kernels.cu")
    assert {g for g in got if g[0] != cu} == want
    assert [f.msg.split("`")[1] for f in findings if f.path == cu] == [
        'extern "C" int crdt_norow']


@pytest.mark.parametrize("streamed", [False, True])
def test_fence_tags_are_dead_checked_by_g011(streamed):
    """A fence tag the block names no surface for is dead-checked like a
    bare fence, also when every fence of the tag went uncrossed;
    ``genesis`` is scoped by the artifact's ``lifecycle.stream``.  Against
    the streamed run the port's G011 equals JAX's."""
    d = TWINS / "fence_tags"
    src = d / "fence_tags.py"
    art = d / ("artifact_streamed.json" if streamed else "artifact.json")
    got = {(f.rule, f.line) for f in run_lint(
        [str(d)], sync_artifact=str(art), select={"G011"})}
    want = expected_markers(src)
    if streamed:
        want |= {("G011", i) for i, line in enumerate(
            src.read_text().splitlines(), start=1)
            if "expect-streamed: G011" in line}
        assert got == {(f.rule, f.line) for f in jax_lint(
            [str(d)], sync_artifact=str(art), select={"G011"})}
    assert got == want
    assert len(want) == 2 + streamed


def test_twins_cover_every_twin_rule():
    seen = {r for p in TWIN_FILES + sorted((TWINS / "launch").glob("*.py"))
            if "precision" not in p.parts for r, _ in expected_markers(p)}
    assert seen == TWIN_RULES


PRECISION = sorted((TWINS / "precision").glob("*.py"))


@pytest.mark.parametrize("path", PRECISION, ids=lambda p: p.name)
def test_port_precision_fixes_differ_from_jax_only_where_marked(path):
    """The port's two precision changes to ported rules (a library
    object's method links to no package function; ``+=`` on an immutable
    attribute is a swap under G015): JAX's linter flags what the port's
    does plus the lines marked ``# jax-only:``."""
    jax_only = {(m.group(1), i) for i, line in enumerate(
        path.read_text().splitlines(), start=1)
        for m in re.finditer(r"jax-only:\s*(G\d{3})", line)}
    assert jax_only
    want = expected_markers(path)
    assert {(f.rule, f.line) for f in run_lint([str(path)])} == want
    assert {(f.rule, f.line) for f in jax_lint([str(path)])} == (
        want | jax_only)


def test_walkers_prune_the_twin_corpus():
    """Both packages' directory walks skip ``lint_fixtures``: linting the
    corpus' parent finds none of its hazards."""
    parent = str(TWINS.parent)
    assert all("lint_fixtures" not in f.path for f in run_lint([parent]))
    assert all("lint_fixtures" not in f.path for f in jax_lint([parent]))


def test_port_package_lints_clean_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "from crdt_benches_tpu_torch.lint.__main__ import main; "
            "rc = main(['crdt_benches_tpu_torch']); "
            "assert not any(m == 'crdt_benches_tpu' or "
            "m.startswith('crdt_benches_tpu.') for m in sys.modules); "
            "sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "graftlint: clean"


@pytest.mark.parametrize("stream", [False, True], ids=["eager", "streamed"])
def test_armed_cpu_drain_cross_checks_are_clean(tmp_path, monkeypatch,
                                                stream):
    """A tiny serve drain with every sanitizer armed; its report's five
    blocks are the artifact of G011, G017, G021, G025 and G029, which
    find no dead declaration and no unattributed counter.  The streamed
    drain's ``lifecycle`` block records ``stream``, so G011 holds it to
    LazyStreams' ``fence=genesis`` fences too, and it crosses both."""
    from crdt_benches_tpu_torch.serve import bench, workload

    monkeypatch.setitem(workload.MIXES, "tiny", {"synth-small": 1.0})
    rep = bench.run_serve_bench(
        mix="tiny", n_docs=16, batch=8, macro_k=4, batch_chars=32,
        classes=(128, 512), slots=(8, 4), arrival_span=2, verify_sample=4,
        device="cpu", sanitize=SANITIZERS, stream=stream,
        log=lambda *a, **k: None)
    assert rep["verify_ok"]
    assert rep["lifecycle"]["stream"] is stream
    genesis = {q: n for q, n in rep["boundary_syncs"]["entries"].items()
               if q.startswith("LazyStreams.")}
    assert (sorted(genesis) == ["LazyStreams._install",
                                "LazyStreams._materialize"]) == stream
    art = tmp_path / "report.json"
    art.write_text(json.dumps({k: rep[k] for k in (
        "boundary_syncs", "thread_crossings", "fs_ops", "lifecycle",
        "ranges")}, default=str))
    kw = {k: str(art) for k in ARTIFACT_KW}
    assert run_lint([str(PACKAGE)], **kw) == []
    # each cross-check ran (a dropped block would be a finding)
    for rule, key in (("G011", "boundary_syncs"), ("G017",
                      "thread_crossings"), ("G021", "fs_ops"),
                      ("G025", "lifecycle"), ("G029", "ranges")):
        broken = tmp_path / f"no_{key}.json"
        broken.write_text(json.dumps({"other": {}}))
        found = run_lint([str(PACKAGE / "lint" / "core.py")],
                         select={rule}, **{k: str(broken)
                                           for k in ARTIFACT_KW})
        assert [f.rule for f in found] == [rule]
        assert key in found[0].msg


def test_cli_exit_codes_and_reporters(capsys):
    dirty = str(TWINS / "module" / "g004_inplace.py")
    assert lint_main([str(PACKAGE / "lint" / "core.py")]) == 0
    assert capsys.readouterr().out.strip() == "graftlint: clean"
    assert lint_main([dirty]) == 1
    assert "G004" in capsys.readouterr().out
    assert lint_main([str(TWINS / "no_such_dir")]) == 1
    assert "G000" in capsys.readouterr().out
    # an artifact rule selected with no artifact fails, never no-ops
    assert lint_main([dirty, "--select", "G011"]) == 1
    assert "--sync-artifact" in capsys.readouterr().out
    assert lint_main([dirty, "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["count"] == 1 and set(doc["findings"][0]) == {
        "rule", "path", "line", "col", "message"}
    assert lint_main([dirty, "--format", "sarif"]) == 1
    sarif = json.loads(capsys.readouterr().out)
    assert sarif["version"] == "2.1.0"
    (run,) = sarif["runs"]
    assert run["tool"]["driver"]["rules"] == [{"id": "G004"}]
    (res,) = run["results"]
    assert res["level"] == "error" and res["ruleId"] == "G004"
    assert res["locations"][0]["physicalLocation"]["region"][
        "startLine"] == 19


def test_cli_fix_is_exact_and_idempotent(tmp_path, capsys):
    d = tmp_path / "ops"
    d.mkdir()
    path = d / "g005_fixable.py"
    shutil.copy(TWINS / "ops" / "g005_fixable.py", path)
    assert lint_main([str(path), "--fix", "--select", "G005"]) == 1
    out = capsys.readouterr().out
    assert out.count("G005 fixed") == 5 and out.count("G005 NOT fixed") == 1
    src = path.read_text()
    for call in ("torch.arange(8, dtype=torch.int64)",
                 "torch.zeros((2, 3), dtype=torch.float32)",
                 "torch.full((2,), 1.5, dtype=torch.float32)",
                 "torch.tensor([True, False], dtype=torch.bool)",
                 "torch.arange(0, 10, 2,  # expect: G005\n"
                 "                     dtype=torch.int64)",
                 "torch.arange(n)  #"):
        assert call in src, call
    findings = run_lint([str(path)])
    assert [(f.rule, f.line) for f in findings] == [("G005", 14)]
    assert lint_main([str(path), "--fix", "--select", "G005"]) == 1
    assert "G005 fixed" not in capsys.readouterr().out
    assert path.read_text() == src


def test_cli_boundaries_dump_the_port_registry(capsys):
    assert lint_main(["--boundaries"]) == 0
    table = json.loads(capsys.readouterr().out)
    step = table["crdt_benches_tpu_torch.serve.pool.fleet_step"]
    assert step == {"dtypes": ["int32"] * 4,
                    "shapes": [None, "R B", "R B", "R B"], "donates": [0]}
    assert "crdt_benches_tpu_torch.ops.resolve.resolve_batch_rows" in table
    assert all(not k.startswith("crdt_benches_tpu.") for k in table)


def test_changed_mode_needs_nothing_but_git(tmp_path, capsys, monkeypatch):
    """``--changed`` outside a git worktree lints the full targets."""
    monkeypatch.chdir(tmp_path)
    target = tmp_path / "clean.py"
    target.write_text("x = 1\n")
    assert lint_main([str(target), "--changed"]) == 0
    assert "graftlint: clean" in capsys.readouterr().out
