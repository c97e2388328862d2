"""The traced window: whole runs under ``torch.profiler``, reduced to what
the per-layer readers and the breakdown read.  Nothing is written to disk.

Two captures.  The measured one records the device's activity alone
(kernels, copies, fills): recording every host-side op as well doubles
a downstream apply's host time (74,000 launches an apply), and the idle
share would then measure the profiler.  Its window is the host clock
from the first run's start to the last run's end.  A second capture of
one run records the host side too, only to name the longest idle gaps by
what the host was doing (the harness's ``perfbench.*`` range and the
innermost op or runtime call open when the gap began).
"""

from __future__ import annotations

import glob
import os
import re
import time
from dataclasses import dataclass, field

WINDOW = "perfbench.window"
_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def kernel_base(name: str) -> str:
    """A device event's function name without its return type, anonymous
    namespaces, template arguments and parameters
    (``void a::(anonymous namespace)::b<4>(int*)`` -> ``a::b``)."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    return head[5:].strip() if head.startswith("void ") else head


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def program_kernels(root: str) -> frozenset[str]:
    """The names of the program's own kernels: every ``__global__``
    function of its CUDA sources in the checkout at ``root``."""
    names: set[str] = set()
    for path in glob.glob(os.path.join(root, "crdt_benches_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path, encoding="utf-8") as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return frozenset(names)


def _device_events(prof, on_device):
    """(device events, host events) of a finished profile; the profiler's
    copies of ``record_function`` ranges on the device are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        span = (name, s, s + ev.duration_ns())
        if ev.device_type() != DeviceType.CUDA:
            host.append(span)
        elif on_device and not (getattr(ev, "is_user_annotation", bool)()
                                or name.startswith("perfbench.")):
            device.append(span)
    return device, host


def union(spans) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted((s, e) for _, s, e in spans if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def name_gaps(device, host) -> list[tuple[str, float]]:
    """The ten longest idle stretches of the device inside the host's
    ``WINDOW`` range, each named by what the host was doing as it began."""
    window = next(((s, e) for n, s, e in host if n == WINDOW), None)
    if window is None:
        return []
    busy = [(max(s, window[0]), min(e, window[1])) for s, e in union(device)]
    edges = [window[0]] + [x for s, e in busy if e > s for x in (s, e)] \
        + [window[1]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    out = []
    for length, at in gaps[:10]:
        open_ = sorted((s, n) for n, s, e in host if s <= at < e)
        ours = [n for _, n in open_ if n.startswith("perfbench.")]
        inner = [n for _, n in open_ if not n.startswith("perfbench.")]
        out.append(((ours[-1] if ours else "outside the runs") + " / "
                    + (inner[-1] if inner else "python"), length / 1e9))
    return out


@dataclass
class Capture:
    """One traced window of ``runs`` whole runs."""

    runs: int
    window_s: float  # host clock, first run's start to last run's end
    device: list[tuple[str, int, int]]  # (name, start ns, end ns)
    hand: frozenset[str] = frozenset()  # the program's own kernel names
    gaps: list[tuple[str, float]] = field(default_factory=list)
    trace: object = None  # perfbench.inputs.Trace
    config: dict = field(default_factory=dict)
    peaks: object = None  # perfbench.peaks.Peaks, None off the card
    root: str = ""
    notes: list[str] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which some kernel, copy or fill ran."""
        return sum(e - s for s, e in union(self.device)) / 1e9

    def is_hand_kernel(self, name: str) -> bool:
        return (not is_copy(name)
                and kernel_base(name).rsplit("::", 1)[-1] in self.hand)

    def device_time_s(self, pick) -> tuple[float, int]:
        """Summed duration and count of the device events ``pick(name)``
        accepts."""
        hits = [e - s for n, s, e in self.device if pick(n)]
        return sum(hits) / 1e9, len(hits)

    def work(self, role: str) -> list[tuple[int, int]]:
        """(bytes, operations) of each launch of role ``role`` in one run,
        from ``perfbench/roofline/<role>.py``."""
        from perfbench.spec import load_module

        return load_module(self.root, "roofline", role).work(self.trace,
                                                              self.config)

    def roofline_pct(self, role: str, kernels: tuple[str, ...]):
        """The role's bound over its kernels' time, in percent: None off
        the card, and where the kernels launched another number of times
        than the role's work has launches (the role runs elsewhere)."""
        if self.peaks is None:
            return None
        secs, n = self.device_time_s(lambda nm: kernel_base(nm).rsplit(
            "::", 1)[-1] in kernels)
        per_run = self.work(role)
        if n == 0 or n != self.runs * len(per_run):
            self.notes.append(f"{role}: {n} launches of {kernels}, want "
                              f"{self.runs} x {len(per_run)}; not read")
            return None
        bounds = [self.peaks.bound_s(b, o) for b, o in per_run]
        total = sum(t for t, _ in bounds)
        by_bytes = sum(t for t, by in bounds if by == "bytes")
        self.notes.append(
            f"{role}: {n} launches, {secs:.6f} s, bound {total:.6f} s a run, "
            f"{'bytes' if 2 * by_bytes >= total else 'operations'} bind")
        return 100.0 * self.runs * total / secs

    def top_device_ops(self) -> list[tuple[str, float]]:
        """The ten device functions, copies or fills that took most time."""
        tot: dict[str, int] = {}
        for n, s, e in self.device:
            key = n if is_copy(n) else kernel_base(n)
            tot[key] = tot.get(key, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        return [(k, v / 1e9) for k, v in top]


def record(run_once, runs: int, on_cuda: bool, root: str) -> Capture:
    """Profile ``runs`` calls of ``run_once`` (the device alone on the
    card), then one more call with the host side, for the gaps' names."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    sync()
    with profile(activities=[cuda] if on_cuda else [cpu]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run_once()
        sync()
        window_s = time.perf_counter() - t0
    device, _ = _device_events(prof, on_cuda)
    del prof
    with profile(activities=[cpu, cuda] if on_cuda else [cpu]) as prof:
        with record_function(WINDOW):
            run_once()
        sync()
    gaps = name_gaps(*_device_events(prof, on_cuda))
    return Capture(runs=runs, window_s=window_s, device=device,
                   hand=program_kernels(root), gaps=gaps)
