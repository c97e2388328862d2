"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``crdt_benches_tpu_torch`` is not
``crdt_benches_tpu``), and the plain reference and the yardstick load
nothing of the program either."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from perfbench.run import FORBIDDEN, forbidden_modules
from perfbench.spec import ROOT

PROGRAM = "crdt_benches_tpu_torch"
#: Modules that judge or count and may not load the program.
YARDSTICK = ("perfbench/reference/replay.py", "perfbench/inputs.py",
             "perfbench/workcount.py", "perfbench/peaks.py",
             "perfbench/roofline")


def imported_tops(path: str) -> set[str]:
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(*rel: str) -> list[str]:
    out = []
    for r in rel:
        p = os.path.join(ROOT, r)
        if os.path.isdir(p):
            out += [os.path.join(d, f) for d, _, fs in os.walk(p)
                    for f in fs if f.endswith(".py")]
        else:
            out.append(p)
    return out


def test_whole_name_compare():
    assert "crdt_benches_tpu" in FORBIDDEN
    assert PROGRAM.split(".", 1)[0] not in FORBIDDEN
    assert "crdt_benches_tpu" not in forbidden_modules()


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources("perfbench"):
        assert not imported_tops(path) & set(FORBIDDEN), path


def test_yardstick_imports_nothing_of_the_program():
    for path in sources(*YARDSTICK):
        assert PROGRAM not in imported_tops(path), path


def test_modules_loaded_by_a_run(tiny_root):
    """A whole run in a fresh process (both drivers, traced and not, the
    reference) loads the program but neither JAX nor the JAX package;
    the reference alone loads nothing of the program."""
    code = f"""
import json, sys
from perfbench import run
from perfbench.spec import find_cell
for cell in ("tiny.upstream", "tiny.downstream"):
    for traced in (False, True):
        run.run_cell(find_cell(cell, {tiny_root!r}), 3, 0.1, traced,
                     device="cpu")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert PROGRAM in tops
    assert not tops & set(FORBIDDEN)
    code = ("import json, sys\n"
            "from perfbench.reference import replay\n"
            "from perfbench import inputs, workcount\n"
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & {*FORBIDDEN, PROGRAM, "torch"}
