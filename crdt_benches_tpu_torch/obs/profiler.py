"""Device-profiler capture of steady serve rounds (``--serve-profile N``;
the JAX package's ``obs/profiler.py`` over ``torch.profiler``).

Ask the serve bench for ``profile_rounds=N`` and it records a
``torch.profiler`` trace spanning N **steady** macro-rounds — barrier
rounds are left out by the round classification that feeds the latency
histograms (``ServeStats.note_round``) — then parses the trace and embeds
a top-ops table in the report's ``profile`` block.  On a CUDA device the
profiler records CUDA activity and the table holds the device's kernels,
copies and fills; on the CPU (``device="cpu"``) it records CPU activity
and the table holds the CPU operators.

The profiler is a small state machine driven by two scheduler hooks:

- ``round_begin()`` — at the top of every macro-round; starts the capture
  once a steady round has been seen;
- ``round_end(steady)`` — counts steady rounds inside the window and
  closes it after N; a non-steady round inside it is a ``dirty_round``.

``finalize(fence)`` stops a capture still open (``fence`` waits for the
device first, so the trace holds finished work) and returns the summary,
or None when nothing was captured.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import tempfile
from collections import defaultdict

#: Trace-event categories of device work (torch's Kineto export).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The category of a CPU operator, the table's rows without a device.
CPU_CAT = "cpu_op"


class DeviceProfiler:
    """Capture N steady macro-rounds with ``torch.profiler``."""

    def __init__(self, n_rounds: int, logdir: str | None = None,
                 device: str = "cuda"):
        self.n_rounds = max(1, int(n_rounds))
        self._owns_dir = logdir is None
        self.logdir = logdir or tempfile.mkdtemp(prefix="crdt_profile_")
        self.device = getattr(device, "type", device)
        self.state = "wait"  # wait -> ready -> on -> done
        self.captured = 0
        self.dirty_rounds = 0  # non-steady rounds inside the window
        self.summary: dict | None = None
        self._prof = None

    # ---- scheduler hooks ----

    def round_begin(self) -> None:
        if self.state != "ready":
            return
        from torch.profiler import ProfilerActivity, profile

        act = (ProfilerActivity.CUDA if self.device == "cuda"
               else ProfilerActivity.CPU)
        self._prof = profile(activities=[act])
        self._prof.start()
        self.state = "on"

    def round_end(self, steady: bool) -> None:
        if self.state == "wait":
            if steady:
                self.state = "ready"  # open the window next round
            return
        if self.state == "on":
            if steady:
                self.captured += 1
                if self.captured >= self.n_rounds:
                    self._stop()
            else:
                # a barrier round landed inside the window: counted in
                # the summary, not hidden
                self.dirty_rounds += 1

    # ---- capture lifecycle ----

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self.state = "done"
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))

    def finalize(self, fence=None) -> dict | None:
        """Close an open capture (fencing the device first so the
        dispatches in flight land in the trace), parse it, and return the
        ``profile`` block.  Idempotent, and safe on a crashed drain: a
        failing fence still stops the capture."""
        if self.state == "on":
            try:
                if fence is not None:
                    fence()
            finally:
                self._stop()
        if self.state != "done":
            self._cleanup()
            return None
        if self.summary is None:
            self.summary = {
                "rounds": self.captured,
                "requested": self.n_rounds,
                "dirty_rounds": self.dirty_rounds,
                "top_ops": top_ops(self.logdir),
            }
            if not self._owns_dir:
                self.summary["logdir"] = self.logdir
            self._cleanup()
        return self.summary

    def _cleanup(self) -> None:
        if self._owns_dir:
            shutil.rmtree(self.logdir, ignore_errors=True)


def _trace_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return []
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def top_ops(logdir: str, limit: int = 15) -> list[dict]:
    """The complete ("X") events of every trace file under ``logdir``
    (``*.json``, ``*.json.gz``) as a top-ops table: total duration and
    call count a name, heaviest first.  The device's events (kernels,
    copies, fills) when the traces hold any, else the CPU operators."""
    events = []
    for pattern in ("*.json", "*.json.gz"):
        for path in sorted(glob.glob(os.path.join(logdir, "**", pattern),
                                     recursive=True)):
            events.extend(e for e in _trace_events(path)
                          if isinstance(e, dict) and e.get("ph") == "X")
    device = any(e.get("cat") in DEVICE_CATS for e in events)
    keep = DEVICE_CATS if device else (CPU_CAT,)
    agg: dict[str, float] = defaultdict(float)
    cnt: dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("cat") not in keep:
            continue
        name = ev.get("name", "")
        dur_ms = float(ev.get("dur", 0)) / 1e3
        if not name or dur_ms <= 0:
            continue
        agg[name] += dur_ms
        cnt[name] += 1
    return [
        {"name": name[:160], "total_ms": round(ms, 3), "calls": cnt[name]}
        for name, ms in sorted(agg.items(), key=lambda kv: -kv[1])[:limit]
    ]
