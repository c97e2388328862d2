"""One run of one cell of ``BENCHMARK.json``.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace 0|1

Set-up (counted in ``setup_s`` from the process's start): the trace is
read and relabelled by the seed, the cell's driver builds the program's
engine, and its warm runs build and run every shape the window uses.
``--trace 0`` then repeats whole runs back to back for ``--seconds``
seconds and reports the cell's end-to-end metrics; ``--trace 1`` profiles
the traffic mix's ``traced_runs`` whole runs and reports its per-layer
metrics.  Once the window has closed the peak memory is read, a seeded
sample of replicas is decoded, the program's state is freed, and the
plain reference replays the trace: ``correct`` holds when every run left
every replica at the reference's length and every sampled replica at its
text.  The last stdout line is one JSON object.

``--control 1`` puts the control (the reference with the order of each
batch's patches broken) in the program's place and judges it the same
way; it never runs in a measured run.

Exit codes: 0 a result was printed; 2 the cell or the program could not
be found; 3 no CUDA device, or fewer than the cell asks for; 4 the
process held JAX or the JAX package once the window had closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from perfbench import capture, inputs
from perfbench.reference import replay as reference
from perfbench.spec import ROOT, Cell, find_cell

#: Top-level module names that may not be loaded when the result prints.
FORBIDDEN = ("jax", "jaxlib", "flax", "crdt_benches_tpu")
#: Build and kernel caches, at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


@dataclass
class Window:
    """What the end-to-end readers read: the timed window's runs."""

    runs: int
    seconds: float  # host clock, first run's start to last run's end
    elements_per_run: int
    run_ms: list[float]  # each run on the device's clock (CUDA events)
    setup_s: float


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def sample_replicas(R: int, seed: int, k: int) -> list[int]:
    """Replicas 0 and R - 1 and up to ``k`` more drawn from the seed."""
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    drawn = rng.choice(R, size=min(k, R), replace=False).tolist()
    return sorted({0, R - 1, *drawn})


def _timed_window(sess, seconds: float, on_cuda: bool):
    """Whole runs back to back until ``seconds`` have passed; returns
    (runs, elapsed s, each run's ms, every run's lengths, last state)."""
    import torch

    pairs, lengths, host_ms = [], [], []
    state = None
    t0 = time.perf_counter()
    while True:
        state = None  # the previous run's state is freed before the next
        t_run = time.perf_counter()
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        state = sess.run()
        lengths.append(sess.lengths(state))
        if on_cuda:
            ev[1].record()
            pairs.append(ev)
        host_ms.append((time.perf_counter() - t_run) * 1e3)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if on_cuda:
        torch.cuda.synchronize()
        run_ms = [a.elapsed_time(b) for a, b in pairs]
    else:
        run_ms = host_ms
    return len(lengths), elapsed, run_ms, lengths, state


def run_cell(cell: Cell, seed: int, seconds: float, trace_mode: bool,
             device: str = "cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last)."""
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    on_cuda = device == "cuda"
    data_dir = os.path.join(cell.root, "perfbench", "data")
    trace = inputs.load(cfg["trace"], seed, data_dir=data_dir)
    R = cfg["replicas"]
    sample = sample_replicas(R, seed, traffic["sample_replicas"])
    metrics: dict = {}
    device_info: dict = {"platform": "gpu" if on_cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_cuda
                                  else "cpu"),
                         "count": cell.workload["chips"]}
    breakdown = None
    if control:
        text = reference.replay_out_of_order(trace.start, trace.patches,
                                             cfg["batch"])
        runs, lengths = 1, [np.full(R, len(text))]
        texts = {r: text for r in sample}
        device_info["memory_peak_bytes"] = 0
    else:
        sess = cell.module("drivers", traffic["driver"]).Session(
            cell, trace, device)
        for _ in range(traffic["warm_runs"]):
            sess.lengths(sess.run())
        if on_cuda:
            torch.cuda.synchronize()
        # the set-up's objects (a trace is ~800,000 of them) leave the
        # collector's reach: a full collection walking them in the window
        # took 0.1-0.25 s, a downstream apply's worth of jitter
        gc.collect()
        gc.freeze()
        setup_s = time.monotonic() - t_start
        log(f"{cell.name}: set-up {setup_s:.3f} s")
        if trace_mode:
            from torch.profiler import record_function

            lengths, held = [], {}

            def once():
                held.clear()  # the previous run's state is freed first
                with record_function("perfbench.run"):
                    st = sess.run()
                with record_function("perfbench.length_fetch"):
                    lengths.append(sess.lengths(st))
                held["state"] = st

            cap = capture.record(once, traffic["traced_runs"], on_cuda,
                                 cell.root)
            runs, state = len(lengths), held.pop("state")
            cap.trace, cap.config, cap.root = trace, cfg, cell.root
            if on_cuda:
                from perfbench.peaks import card_peaks

                cap.peaks = card_peaks()
                device_info["power_limit"] = cap.peaks.power_limit
                log(f"peaks: {cap.peaks}")
            device_info["busy_s"] = cap.busy_s
            device_info["window_s"] = cap.window_s
            for m in cell.metrics("per_layer"):
                v = cell.module("metrics", m["name"]).read(cap)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            for note in cap.notes:
                log(note)
            breakdown = {"device_ops": cap.top_device_ops(),
                         "idle_gaps": cap.gaps}
            log(f"traced {cap.runs} runs: window {cap.window_s:.6f} s, "
                f"device busy {cap.busy_s:.6f} s, {len(cap.device)} device "
                "events; one more run with the host side for the gaps")
            del cap
        else:
            runs, elapsed, run_ms, lengths, state = _timed_window(
                sess, seconds, on_cuda)
            win = Window(runs=runs, seconds=elapsed,
                         elements_per_run=sess.elements, run_ms=run_ms,
                         setup_s=setup_s)
            log(f"window: {runs} runs in {elapsed:.6f} s, run ms median "
                f"{float(np.median(run_ms)):.4f} max {max(run_ms):.4f}")
            for m in cell.metrics("end_to_end"):
                v = cell.module("metrics", m["name"]).read(win)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated() if on_cuda else 0)
        texts = {r: sess.decode(state, r) for r in sample}
        del state, sess
        if on_cuda:
            torch.cuda.empty_cache()

    # the plain reference, once the window has closed and the state is freed
    t_ref = time.monotonic()
    want = reference.replay(trace.start, trace.patches)
    if trace.end and want != trace.end:
        raise RuntimeError("the reference replay differs from the trace's "
                           "published end content")
    bad_runs = [int((np.asarray(ln) != len(want)).sum()) for ln in lengths]
    text_bad = sum(texts[r] != want for r in sample)
    failed = sum(b > 0 for b in bad_runs) + int(text_bad > 0
                                                and bad_runs[-1] == 0)
    checks = {"len_bad": {"value": sum(bad_runs), "limit": 0},
              "text_bad": {"value": text_bad, "limit": 0}}
    log(f"reference {time.monotonic() - t_ref:.3f} s; {runs} runs x {R} "
        f"replicas' lengths and {len(sample)} replicas' text compared")
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": runs,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], t_start: float | None = None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ.setdefault(var, os.path.join(ROOT, "build", "perfbench",
                                                sub))
    try:
        cell = find_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        log(f"cannot run {args.workload!r}: {e}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on an NVIDIA GPU only")
        return 3
    if torch.cuda.device_count() < cell.workload["chips"]:
        log(f"{cell.name} needs {cell.workload['chips']} CUDA devices, "
            f"found {torch.cuda.device_count()}")
        return 3
    try:
        import crdt_benches_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not in this checkout: {e}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start, control=bool(args.control))
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
