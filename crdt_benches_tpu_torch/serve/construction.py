"""Construction cost of a serving fleet: RSS probes and the fleet-size
table (the JAX package's ``serve/construction.py``).

Streaming construction (``serve/workload.py FleetSpec`` and
``serve/scheduler.py LazyStreams``) claims that set-up time and host memory
scale with the active set, not the fleet.  This module measures it:

- :func:`current_rss_bytes` and :func:`peak_rss_bytes`, the two RSS probes
  of every report's ``construction`` block (``VmRSS`` from
  ``/proc/self/status`` now; ``ru_maxrss``, the process's high-water mark);
- :func:`probe`, one fleet built to a ready scheduler (spec or sessions,
  pool, streams, scheduler; no drain) in either mode, its construction time
  and RSS.  The pool's buckets are allocated on ``device``, so a probe on
  the card measures the card's pool;
- :func:`scaling_table`, the fleet-size table.  ``ru_maxrss`` only grows
  in a process, and Linux folds the spawning process's peak into a child's
  at exec, so each (size, mode) cell runs :func:`probe` in a fresh
  interpreter (``python -m crdt_benches_tpu_torch.serve.construction``,
  the device passed as a flag) started by a small launcher process
  (:func:`run_fresh`), and reads its one JSON line; eager rows stop at
  ``eager_limit`` docs, and a cell that fails or times out is an
  ``{"error": ...}`` row.

The table rides a serve run's report (``construction.scaling``) through
``bench/__main__.py --serve-stream-scaling``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

#: The checkout holding the package: the cell subprocesses run from it, so
#: ``python -m`` finds the package without an installation.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


#: The launcher a cell runs under (:func:`run_fresh`): it starts the cell,
#: applies the time limit (killing the cell past it) and passes the exit
#: code on.  Its own peak is small, so the cell's ``ru_maxrss`` is the
#: cell's own, not the table's caller's.
_LAUNCH = ("import subprocess, sys; "
           "sys.exit(subprocess.run(sys.argv[2:], "
           "timeout=float(sys.argv[1])).returncode)")


def current_rss_bytes() -> int:
    """This process's resident set size now, in bytes (``VmRSS``; the
    high-water mark where ``/proc`` has none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return peak_rss_bytes()


def peak_rss_bytes() -> int:
    """This process's peak RSS in bytes (``ru_maxrss``, KiB on Linux).  It
    only grows within a process and takes in the spawning process's peak at
    exec, so :func:`scaling_table` runs each cell through
    :func:`run_fresh`."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_fresh(cmd: list[str], timeout: float) -> subprocess.CompletedProcess:
    """``cmd`` in a fresh process started by a small launcher, run from
    the checkout, its output captured; past ``timeout`` seconds the
    launcher kills it and exits non-zero (``subprocess.TimeoutExpired``
    here only if the launcher itself hangs)."""
    return subprocess.run(
        [sys.executable, "-c", _LAUNCH, str(timeout), *cmd],
        capture_output=True, text=True, timeout=timeout + 60, cwd=_ROOT)


def probe(
    n_docs: int,
    *,
    mix: str = "mixed",
    seed: int = 0,
    arrival_span: int = 8,
    arrival_dist: str = "uniform",
    serve_tiers: str | None = None,
    stream: bool = True,
    batch: int = 64,
    batch_chars: int = 256,
    classes=(256, 1024, 4096, 8192, 49152),
    slots=(2048, 512, 128, 32, 16),
    device="cuda",
) -> dict:
    """Build one fleet to a ready scheduler, with no drain, and report its
    cost: a ``FleetSpec`` and ``LazyStreams`` (every doc in genesis) when
    ``stream``, else ``build_fleet`` and ``prepare_streams``."""
    # imported here: serve/bench.py imports this module's probes
    from .bench import parse_tier_spec
    from .pool import DocPool
    from .scheduler import FleetScheduler, LazyStreams, prepare_streams
    from .workload import FleetSpec, build_fleet

    warm_docs = 0
    if serve_tiers:
        slots, warm_docs = parse_tier_spec(serve_tiers, slots)
    fleet_kw = dict(mix=mix, seed=seed, arrival_span=arrival_span,
                    arrival_dist=arrival_dist)
    rss0 = current_rss_bytes()
    pool = None
    t0 = time.perf_counter()
    try:
        if stream:
            spec = FleetSpec.build(n_docs, **fleet_kw)
            pool = DocPool(classes=classes, slots=slots, device=device,
                           warm_docs=warm_docs)
            streams = LazyStreams(spec, pool, batch=batch,
                                  batch_chars=batch_chars)
        else:
            sessions = build_fleet(n_docs, **fleet_kw)
            pool = DocPool(classes=classes, slots=slots, device=device,
                           warm_docs=warm_docs)
            streams = prepare_streams(sessions, pool, batch=batch,
                                      batch_chars=batch_chars)
        sched = FleetScheduler(pool, streams, batch=batch,
                               batch_chars=batch_chars)
        ms = (time.perf_counter() - t0) * 1e3
        assert not sched.done or n_docs == 0
        return {
            "n_docs": int(n_docs),
            "mode": "stream" if stream else "eager",
            "construction_ms": ms,
            "rss_before_bytes": rss0,
            "rss_after_bytes": current_rss_bytes(),
            "peak_rss_bytes": peak_rss_bytes(),
            "genesis_docs": pool.genesis_docs,
        }
    finally:
        if pool is not None:
            pool.close()


def scaling_table(
    sizes,
    *,
    mix: str = "mixed",
    seed: int = 0,
    arrival_span: int = 8,
    arrival_dist: str = "uniform",
    serve_tiers: str | None = None,
    eager_limit: int = 65536,
    timeout: float = 900.0,
    device="cuda",
    log=print,
) -> list[dict]:
    """One fresh-subprocess :func:`probe` per (size, mode) cell, in
    ascending size: a stream row at every size, an eager row up to
    ``eager_limit`` docs (0: none).  A failed or timed-out cell becomes an
    ``{"error": ...}`` row, never a missing one."""
    rows: list[dict] = []
    for n in sorted({int(s) for s in sizes}):
        for mode in ("stream", "eager"):
            if mode == "eager" and (not eager_limit or n > eager_limit):
                continue
            cmd = [
                sys.executable, "-m",
                "crdt_benches_tpu_torch.serve.construction",
                "--n-docs", str(n), "--mode", mode,
                "--mix", mix, "--seed", str(seed),
                "--arrival-span", str(arrival_span),
                "--arrival-dist", arrival_dist,
                "--device", str(device),
            ]
            if serve_tiers:
                cmd += ["--serve-tiers", serve_tiers]
            try:
                out = run_fresh(cmd, timeout)
            except subprocess.TimeoutExpired:
                rows.append({"n_docs": n, "mode": mode,
                             "error": f"timeout after {timeout:g}s"})
                log(f"construction: {mode}/{n} TIMED OUT")
                continue
            if out.returncode != 0:
                # a cell past its time limit: the launcher's traceback
                # ends with "timed out after N seconds"
                tail = (out.stderr or out.stdout or "").strip()
                rows.append({"n_docs": n, "mode": mode,
                             "error": tail[-400:] or "nonzero exit"})
                log(f"construction: {mode}/{n} FAILED")
                continue
            row = json.loads(out.stdout.strip().splitlines()[-1])
            rows.append(row)
            log(f"construction: {mode}/{n}: "
                f"{row['construction_ms']:.0f} ms, peak rss "
                f"{row['peak_rss_bytes'] / 2**20:.0f} MiB")
    return rows


def main(argv=None) -> int:
    """``python -m crdt_benches_tpu_torch.serve.construction``: one probe,
    one JSON line on stdout (a :func:`scaling_table` cell)."""
    ap = argparse.ArgumentParser(
        description="construction-cost probe (one fleet, no drain)")
    ap.add_argument("--n-docs", type=int, required=True)
    ap.add_argument("--mode", choices=("stream", "eager"), default="stream")
    ap.add_argument("--mix", default="mixed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-span", type=int, default=8)
    ap.add_argument("--arrival-dist", default="uniform")
    ap.add_argument("--serve-tiers", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    row = probe(args.n_docs, mix=args.mix, seed=args.seed,
                arrival_span=args.arrival_span,
                arrival_dist=args.arrival_dist, serve_tiers=args.serve_tiers,
                stream=args.mode == "stream", device=args.device)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
