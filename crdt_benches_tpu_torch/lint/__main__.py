"""graftlint CLI for the PyTorch port.

    python -m crdt_benches_tpu_torch.lint [paths...] [--format text|json|sarif]
                                    [--select G001,G002] [--boundaries]
                                    [--changed] [--fix]
                                    [--sync-artifact bench.json]
                                    [--thread-artifact bench.json]
                                    [--fs-artifact bench.json]
                                    [--lifecycle-artifact bench.json]
                                    [--ranges-artifact bench.json]

Exits nonzero when any finding survives suppression (CI gates on this);
``--format sarif`` emits SARIF 2.1.0 for CI annotation surfaces with
the SAME exit-code semantics (a reporter changes the rendering, never
the gate).

``--changed`` lints only the .py files touched in the working tree
(``git diff --name-only HEAD`` + untracked), the pre-commit fast path —
no changed Python files is a clean exit, not a G000 (nothing was
skipped, there was nothing to check).

``--fix`` applies the G005 implicit-dtype autofixer (lint/fix.py: the
torch factories) to the targets, then lints what remains; refused sites are reported and
still fail the gate.

``--sync-artifact`` hands G011 a serve bench artifact whose
``boundary_syncs`` block is the runtime fence ground truth (dead
declared fences / unattributed runtime fences become findings).

``--thread-artifact`` is G017's twin: the artifact's
``thread_crossings`` block (the race sanitizer's publish-point and
cross-thread-access counters) is cross-checked against the static
``# graftlint: publish`` markers — usually the same artifact file as
``--sync-artifact``.

``--fs-artifact`` is G021's: the artifact's ``fs_ops`` block (the fs
sanitizer's per-protocol entry and op counters) is cross-checked
against the static ``# graftlint: durable=`` protocol markers — dead
declared protocols and unattributed runtime fs ops both fail.

``--lifecycle-artifact`` is G025's: the artifact's ``lifecycle`` block
(the lifecycle sanitizer's state-machine transition and resource
acquire/release counters) is cross-checked against the static
``# graftlint: state=`` / ``acquire=`` / ``release=`` markers — dead
declared machines/resources and unattributed runtime transitions both
fail.

``--ranges-artifact`` is G029's: the artifact's ``ranges`` block (the
range sanitizer's index-check and clamp-mask dispatch counters) is
cross-checked against the static ``# graftlint: inrange=... check=`` /
``mask=`` declarations — dead declared facts/masks and unattributed
runtime counters both fail.

``--boundaries`` dumps the ``@boundary`` contract registry as JSON by
importing the package modules that declare them (the only mode that
imports anything heavy, torch; plain linting is pure-AST, and neither
mode imports jax).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .core import format_json, format_sarif, format_text, run_lint


def changed_py_files() -> list[str] | None:
    """Working-tree .py changes vs HEAD (tracked mods + untracked), with
    the intentionally-dirty fixture corpus excluded.  None = git failed
    (not a repo / no HEAD) — the caller falls back to a full lint rather
    than silently checking nothing.  git emits TOPLEVEL-relative names,
    so they are resolved against the toplevel — running from a
    subdirectory must not silently drop (and skip linting) every file
    outside it."""

    def git(*args) -> subprocess.CompletedProcess | None:
        try:
            proc = subprocess.run(
                ["git", *args], capture_output=True, text=True,
                timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        return proc if proc.returncode == 0 else None

    top = git("rev-parse", "--show-toplevel")
    if top is None or not top.stdout.strip():
        return None
    root = top.stdout.strip()
    files: list[str] = []
    for cmd in (
        ("diff", "--name-only", "HEAD", "--"),
        ("ls-files", "--others", "--exclude-standard"),
    ):
        proc = git(*cmd)
        if proc is None:
            return None
        files.extend(
            ln.strip() for ln in proc.stdout.splitlines() if ln.strip()
        )
    out = []
    for f in dict.fromkeys(files):  # de-dup, keep order
        if not f.endswith(".py"):
            continue
        if "lint_fixtures" in f.replace("\\", "/").split("/"):
            continue
        path = os.path.join(root, f)
        if os.path.isfile(path):  # deleted files have nothing to lint
            out.append(path)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="graftlint")
    ap.add_argument(
        "paths", nargs="*", default=["crdt_benches_tpu_torch"],
        help="files or directories to lint (default: the package)",
    )
    ap.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
    )
    ap.add_argument(
        "--select", default="",
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--changed", action="store_true",
        help="lint only .py files changed vs HEAD (plus untracked)",
    )
    ap.add_argument(
        "--fix", action="store_true",
        help="apply the G005 implicit-dtype autofixer, then lint",
    )
    ap.add_argument(
        "--sync-artifact", default=None, metavar="JSON",
        help="serve bench artifact for the G011 fence-cost cross-check",
    )
    ap.add_argument(
        "--thread-artifact", default=None, metavar="JSON",
        help="serve bench artifact for the G017 publish-point "
             "cross-check (thread_crossings block)",
    )
    ap.add_argument(
        "--fs-artifact", default=None, metavar="JSON",
        help="serve bench artifact for the G021 durable-protocol "
             "cross-check (fs_ops block)",
    )
    ap.add_argument(
        "--lifecycle-artifact", default=None, metavar="JSON",
        help="serve bench artifact for the G025 lifecycle machine/"
             "resource cross-check (lifecycle block)",
    )
    ap.add_argument(
        "--ranges-artifact", default=None, metavar="JSON",
        help="serve bench artifact for the G029 value-range "
             "cross-check (ranges block)",
    )
    ap.add_argument(
        "--boundaries", action="store_true",
        help="dump the @boundary contract registry as JSON and exit",
    )
    args = ap.parse_args(argv)

    if args.boundaries:
        # importing serve/engine registers every @boundary contract
        import importlib

        for mod in (
            "crdt_benches_tpu_torch.serve.pool",
            "crdt_benches_tpu_torch.engine.replay",
            "crdt_benches_tpu_torch.engine.replay_range",
            "crdt_benches_tpu_torch.engine.merge",
            "crdt_benches_tpu_torch.engine.merge_range",
            "crdt_benches_tpu_torch.engine.downstream",
            "crdt_benches_tpu_torch.engine.downstream_range",
        ):
            importlib.import_module(mod)
        from .boundary import boundary_table

        print(json.dumps(boundary_table(), indent=2))
        return 0

    paths = args.paths
    if args.changed:
        changed = changed_py_files()
        if changed is None:
            print(
                "graftlint: --changed needs a git worktree; "
                "linting the full targets instead",
                file=sys.stderr,
            )
        elif not changed:
            print("graftlint: no changed python files")
            return 0
        else:
            paths = changed

    if args.fix:
        from .fix import fix_g005

        for r in fix_g005(paths):
            verdict = "fixed" if r.applied else "NOT fixed"
            print(f"{r.path}:{r.line}: G005 {verdict}: {r.detail}")

    select = {
        s.strip() for s in args.select.split(",") if s.strip()
    } or None
    findings = run_lint(
        paths, select=select, sync_artifact=args.sync_artifact,
        thread_artifact=args.thread_artifact,
        fs_artifact=args.fs_artifact,
        lifecycle_artifact=args.lifecycle_artifact,
        ranges_artifact=args.ranges_artifact,
    )
    out = (
        format_json(findings) if args.format == "json"
        else format_sarif(findings) if args.format == "sarif"
        else format_text(findings)
    )
    print(out)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
