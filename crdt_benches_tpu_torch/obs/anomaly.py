"""Online anomaly detection over the serve time-series (``--serve-soak``;
the JAX package's ``obs/anomaly.py``).

A soak run is only useful if degradation is *caught*, not eyeballed out
of a 10k-window artifact afterwards.  :class:`AnomalyDetector` consumes
the same stream the recorder folds (per-round latencies, closed
windows) and maintains three online detectors:

- **stuck-round watchdog** (per round): a macro-round whose wall time
  exceeds the watchdog threshold — explicit ``watchdog_s``, or
  ``watchdog_factor`` x the rolling median of steady rounds (floored at
  ``watchdog_min_s``) — fires ``stuck_round``; the next on-time round
  clears it.  Compile- and barrier-flagged rounds are exempt (they are
  *known* slow, the same exemption the latency quantiles apply), so a
  chaos ``stall`` fault is exactly what trips it;
- **throughput degradation** (per window): robust location/scale over
  the window throughput history (median/MAD); a full window below
  ``median - mad_k * 1.4826 * MAD`` AND below ``(1 - drop_frac) *
  median`` fires ``throughput_degradation``.  Windows whose occupancy
  has collapsed relative to history are skipped — a fleet legitimately
  draining down is not a regression — and anomalous windows are kept
  out of the history so a real degradation cannot normalize itself;
- **monotonic growth / leak** (per window): resident-set size and
  journal bytes-per-op that rise strictly across the last
  ``leak_windows`` full windows by more than ``leak_frac`` fire
  ``rss_leak`` / ``journal_growth``; a plateau clears them.

Every fire/clear lands in :attr:`events` (the artifact's versioned
``anomalies`` block) and the active set feeds ``/healthz``.  The run's
exit-code contract: anomalies that fired AND cleared are history (a
stall the engine absorbed is a demonstration, not a failure); an
anomaly still active at drain end fails the run.
"""

from __future__ import annotations

from collections import deque
from statistics import median

#: Bump when the ``anomalies`` artifact block changes shape.
ANOMALIES_VERSION = 1


class AnomalyDetector:
    """Shared-nothing online detectors; pure host arithmetic per call."""

    def __init__(self, *, watchdog_s: float = 0.0,
                 watchdog_factor: float = 25.0, watchdog_min_s: float = 1.0,
                 mad_k: float = 5.0, drop_frac: float = 0.5,
                 min_windows: int = 6, history: int = 64,
                 leak_windows: int = 8, leak_frac: float = 0.25):
        self.watchdog_s = float(watchdog_s)
        self.watchdog_factor = watchdog_factor
        self.watchdog_min_s = watchdog_min_s
        self.mad_k = mad_k
        self.drop_frac = drop_frac
        self.min_windows = min_windows
        self.leak_windows = max(3, int(leak_windows))
        self.leak_frac = leak_frac
        self.events: list[dict] = []
        self._active: dict[str, dict] = {}
        self._lat = deque(maxlen=64)
        self._tput = deque(maxlen=history)
        self._occ = deque(maxlen=history)
        self._rss = deque(maxlen=history)
        self._jrate = deque(maxlen=history)

    # ---- event bookkeeping ----

    def _fire(self, kind: str, round_no: int, value: float,
              threshold: float, **detail) -> None:
        ev = self._active.get(kind)
        if ev is not None:
            ev["last_round"] = round_no
            ev["rounds_active"] += 1
            return
        ev = {
            "kind": kind,
            "round": round_no,
            "last_round": round_no,
            "rounds_active": 1,
            "value": value,
            "threshold": threshold,
            "cleared": False,
            "cleared_round": None,
            "detail": detail,
        }
        self._active[kind] = ev
        self.events.append(ev)

    def _clear(self, kind: str, round_no: int) -> None:
        ev = self._active.pop(kind, None)
        if ev is not None:
            ev["cleared"] = True
            ev["cleared_round"] = round_no

    def active_kinds(self) -> list[str]:
        return sorted(self._active)

    @property
    def fired(self) -> int:
        return len(self.events)

    @property
    def uncleared(self) -> int:
        return len(self._active)

    # ---- per-round: the stuck-round watchdog ----

    def _watchdog_threshold(self) -> float | None:
        if self.watchdog_s > 0:
            return self.watchdog_s
        if len(self._lat) < 8:
            return None  # auto mode needs a latency baseline first
        return max(
            self.watchdog_min_s, self.watchdog_factor * median(self._lat)
        )

    def note_round(self, seconds: float, *, skip: bool,
                   round_no: int) -> None:
        """One macro-round's wall time.  ``skip`` marks compile /
        snapshot-barrier rounds — known-slow, excluded from both the
        threshold check and the rolling baseline."""
        if skip:
            return
        thr = self._watchdog_threshold()
        if thr is not None and seconds > thr:
            self._fire("stuck_round", round_no, seconds, thr)
            return  # a stalled round must not drag the baseline up
        if thr is not None:
            self._clear("stuck_round", round_no)
        self._lat.append(seconds)

    # ---- per-window: throughput + leak detectors ----

    @staticmethod
    def _monotonic_growth(hist: deque, n: int) -> float | None:
        """Relative growth over the last ``n`` samples IF they rise
        strictly; None otherwise (or with too little history)."""
        if len(hist) < n:
            return None
        tail = list(hist)[-n:]
        if any(b <= a for a, b in zip(tail, tail[1:])):
            return None
        if tail[0] <= 0:
            return None
        return tail[-1] / tail[0] - 1.0

    def note_window(self, w: dict) -> None:
        """One closed time-series window (an `obs/timeseries.py` window
        dict).  Partial windows only feed the leak history."""
        round_no = w.get("end_round", 0)
        rss = w.get("rss_bytes")
        if rss:
            self._rss.append(rss)
            g = self._monotonic_growth(self._rss, self.leak_windows)
            if g is not None and g >= self.leak_frac:
                self._fire("rss_leak", round_no, float(rss), g,
                           windows=self.leak_windows)
            else:
                self._clear("rss_leak", round_no)
        if w.get("journal_bytes") and w.get("ops"):
            self._jrate.append(w["journal_bytes"] / w["ops"])
            g = self._monotonic_growth(self._jrate, self.leak_windows)
            if g is not None and g >= self.leak_frac:
                self._fire("journal_growth", round_no,
                           self._jrate[-1], g,
                           windows=self.leak_windows)
            else:
                self._clear("journal_growth", round_no)
        if not w.get("full"):
            return  # rate checks need comparable window lengths
        tput = w.get("throughput", 0.0)
        occ = w.get("occupancy", 0.0)
        if len(self._tput) >= self.min_windows:
            med = median(self._tput)
            mad = median(abs(x - med) for x in self._tput)
            occ_med = median(self._occ) if self._occ else 0.0
            draining = occ_med > 0 and occ < 0.5 * occ_med
            low = (
                med > 0
                and tput < med - self.mad_k * 1.4826 * mad
                and tput < (1.0 - self.drop_frac) * med
            )
            if low and not draining:
                self._fire("throughput_degradation", round_no, tput,
                           med, mad=mad, median=med)
                return  # keep the degraded window out of the baseline
            self._clear("throughput_degradation", round_no)
        self._tput.append(tput)
        self._occ.append(occ)

    # ---- artifact surface ----

    def block(self) -> dict:
        """The versioned ``anomalies`` artifact block."""
        return {
            "version": ANOMALIES_VERSION,
            "watchdog_s": self.watchdog_s or None,
            "fired": self.fired,
            "uncleared": self.uncleared,
            "active": self.active_kinds(),
            "events": [dict(e) for e in self.events],
        }
