"""Live serve status: a thread-confined stdlib HTTP endpoint (the JAX
package's ``obs/status.py``).

A drain used to be a black box until its artifact landed; this module
makes the run observable WHILE it serves.  ``--serve-status PORT``
starts :class:`StatusServer` — a ``ThreadingHTTPServer`` on its own
daemon thread — serving three read-only endpoints:

- ``/healthz`` — liveness + health: 200 when the drain is publishing
  and no anomaly is active, 503 (with the reason) otherwise, including
  when the publisher has gone silent past ``stale_after`` seconds — an
  external probe sees a wedged host even when the process is alive;
- ``/status.json`` — the latest per-round snapshot (current round,
  occupancy, queue depth, shed/deferred/quarantine totals, degraded
  and fault state), fields advancing monotonically through the drain;
- ``/metrics`` — the drain's full typed-metric registry rendered in
  Prometheus text exposition format (``# HELP`` / ``# TYPE``, counters
  as ``_total``, histograms as cumulative ``_bucket``/``_sum``/
  ``_count``, registry keys like ``serve.shard.ops{shard="3"}`` parsed
  into real label sets with proper value escaping).

Isolation contract: the serving hot path never constructs sockets,
never renders, never mutates the registry — it only swaps immutable
snapshot references in via :meth:`StatusServer.publish_status` /
:meth:`publish_metrics` (one attribute store each; CPython makes the
reference swap atomic).  All socket work and rendering happens on the
server's own threads against whatever snapshot is current.  The publisher
methods are owned by the **hot** thread, the handler surface by the
**status** threads, and the only mutable state crossing between them —
the status and metrics snapshots — crosses in the two publish methods as
an atomic reference swap of an object the publisher never touches again.
Health is a single immutable ``(ok, reason)`` tuple swap for the same
reason (two separate field stores could be observed torn).  The two
publish methods are publish points of the race sanitizer
(``lint/race_sanitizer.py``: ``published``, ``share``), and the readers
pass its ``reveal`` gate: armed, a snapshot read on a handler thread
before its publish, or changed after it, raises there.

A polling terminal view ships as the module CLI::

    python -m crdt_benches_tpu_torch.obs.status --watch --url http://127.0.0.1:8787
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from threading import Thread

from ..lint.race_sanitizer import published, reveal, share

# ---------------------------------------------------------------------------
# Prometheus text exposition (format version 0.0.4)
# ---------------------------------------------------------------------------

_LABELED_RE = re.compile(r"^(?P<base>[^{]+)(?:\{(?P<labels>.*)\})?$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')
_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def split_labeled_name(name: str) -> tuple[str, dict[str, str]]:
    """``'serve.shard.ops{shard="3"}'`` -> (``serve.shard.ops``,
    ``{"shard": "3"}``).  Unlabeled names return an empty dict."""
    m = _LABELED_RE.match(name)
    if m is None:
        return name, {}
    labels = dict(_LABEL_PAIR_RE.findall(m.group("labels") or ""))
    return m.group("base"), labels


def prom_name(base: str) -> str:
    """A registry base name as a valid Prometheus metric name."""
    out = _NAME_SANITIZE_RE.sub("_", base)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(v: str) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _num(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".10g")


def render_prometheus(metrics: dict) -> str:
    """Render a ``MetricsRegistry.to_dict()`` snapshot as Prometheus
    text exposition.  Same-base labeled series share one ``# HELP`` /
    ``# TYPE`` header; counters gain the ``_total`` suffix; histograms
    emit cumulative ``_bucket`` lines (``le`` merged into the series'
    own labels), ``_sum`` and ``_count``."""
    lines: list[str] = []

    def _grouped(table: dict) -> dict[str, list[tuple[dict, object]]]:
        groups: dict[str, list[tuple[dict, object]]] = {}
        for name in sorted(table):
            base, labels = split_labeled_name(name)
            groups.setdefault(base, []).append((labels, table[name]))
        return groups

    for base, series in _grouped(metrics.get("counters", {})).items():
        n = prom_name(base) + "_total"
        lines.append(f"# HELP {n} registry counter {base}")
        lines.append(f"# TYPE {n} counter")
        for labels, value in series:
            lines.append(f"{n}{_label_str(labels)} {_num(value)}")
    for base, series in _grouped(metrics.get("gauges", {})).items():
        n = prom_name(base)
        lines.append(f"# HELP {n} registry gauge {base}")
        lines.append(f"# TYPE {n} gauge")
        for labels, g in series:
            lines.append(f"{n}{_label_str(labels)} {_num(g['value'])}")
    for base, series in _grouped(metrics.get("histograms", {})).items():
        n = prom_name(base)
        lines.append(f"# HELP {n} registry histogram {base}")
        lines.append(f"# TYPE {n} histogram")
        for labels, h in series:
            cum = 0
            for bound, c in zip(h["bounds"], h["counts"]):
                cum += c
                bl = dict(labels, le=_num(bound))
                lines.append(f"{n}_bucket{_label_str(bl)} {cum}")
            bl = dict(labels, le="+Inf")
            lines.append(f"{n}_bucket{_label_str(bl)} {h['count']}")
            ls = _label_str(labels)
            lines.append(f"{n}_sum{ls} {_num(h['sum'])}")
            lines.append(f"{n}_count{ls} {h['count']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the status server
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):  # graftlint: thread=status
    server_version = "crdt-serve-status/1"

    def log_message(self, *args) -> None:  # no stderr chatter per scrape
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler API)
        owner: StatusServer = self.server.owner  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            ok, reason = owner.health()
            body = json.dumps({"ok": ok, "reason": reason}).encode()
            self._reply(200 if ok else 503, body, "application/json")
        elif path == "/status.json":
            body = json.dumps(owner.status_snapshot()).encode()
            self._reply(200, body, "application/json")
        elif path == "/metrics":
            body = render_prometheus(owner.metrics_snapshot()).encode()
            self._reply(200, body, CONTENT_TYPE_LATEST)
        else:
            self._reply(
                404,
                b'{"error": "unknown path", '
                b'"endpoints": ["/healthz", "/status.json", "/metrics"]}',
                "application/json",
            )


class StatusServer:
    """Read-only HTTP view over published snapshots.

    The publisher (the drain) calls :meth:`publish_status` /
    :meth:`publish_metrics` with plain dicts it will not mutate again;
    the handler threads only ever read the current reference.  Health
    combines the published verdict with a staleness check
    (``stale_after`` seconds without a publish -> 503)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 stale_after: float | None = None):
        self._host = host
        self._want_port = int(port)
        self.stale_after = stale_after
        self._status: dict = {}
        self._metrics: dict = {}
        # ONE immutable tuple, swapped atomically: a reader that raced
        # two separate ok/reason stores could pair a new verdict with a
        # stale reason
        self._health: tuple[bool, str] = (True, "")
        self._last_publish = time.monotonic()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: Thread | None = None

    # ---- lifecycle (driver side only, never in a hot scope) ----

    def start(self) -> int:
        httpd = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        httpd.daemon_threads = True
        httpd.owner = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = Thread(
            target=httpd.serve_forever, name="serve-status", daemon=True
        )
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---- publisher side (hot path: reference swaps only) ----

    @published
    def publish_status(self, snapshot: dict) -> None:  # graftlint: publish=status  # graftlint: thread=hot
        snapshot["ts"] = time.time()
        self._status = share(snapshot, "StatusServer.status")
        self._last_publish = time.monotonic()

    @published
    def publish_metrics(self, metrics: dict) -> None:  # graftlint: publish=status  # graftlint: thread=hot
        self._metrics = share(metrics, "StatusServer.metrics")

    def set_health(self, ok: bool, reason: str = "") -> None:  # graftlint: thread=hot
        self._health = (ok, reason)  # immutable tuple: atomic swap

    # ---- reader side (handler threads) ----

    def status_snapshot(self) -> dict:  # graftlint: thread=status
        return reveal(self._status)

    def metrics_snapshot(self) -> dict:  # graftlint: thread=status
        return reveal(self._metrics)

    def health(self) -> tuple[bool, str]:  # graftlint: thread=status
        if self.stale_after is not None:
            silent = time.monotonic() - self._last_publish
            if silent > self.stale_after:
                return False, f"stale: no publish for {silent:.1f}s"
        ok, reason = self._health
        if not ok:
            return False, reason or "anomaly active"
        return True, ""


# ---------------------------------------------------------------------------
# polling terminal view
# ---------------------------------------------------------------------------


def _fetch_json(url: str, timeout: float = 2.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def watch(url: str, interval: float = 1.0, count: int | None = None,
          out=None) -> int:
    """Poll ``URL/status.json`` and print one line per sample.  Returns
    0; a scrape error prints and retries (the run may still be coming
    up) unless ``count`` is exhausted."""
    out = out or sys.stdout
    seen = 0
    while count is None or seen < count:
        try:
            s = _fetch_json(url.rstrip("/") + "/status.json")
        except (OSError, ValueError) as e:  # conn refused, cut body, ...
            print(f"watch: {url}: {e}", file=out)
        else:
            anomalies = s.get("anomalies_active") or []
            print(
                f"round {s.get('round', '?'):>6}  "
                f"rounds {s.get('rounds', '?'):>5}  "
                f"occ {s.get('occupancy', 0.0):.2f}  "
                f"queue {s.get('queue_depth', 0):>4}  "
                f"ops {s.get('ops', 0):>8}  "
                f"shed {s.get('shed_ops', 0)}  "
                f"deferred {s.get('deferred_ops', 0)}  "
                f"degraded {int(bool(s.get('degraded')))}  "
                + (f"ANOMALY[{','.join(anomalies)}]" if anomalies
                   else "healthy"),
                file=out,
            )
        seen += 1
        if count is None or seen < count:
            time.sleep(interval)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m crdt_benches_tpu_torch.obs.status",
        description="poll a live serve drain's status endpoint",
    )
    ap.add_argument("--watch", action="store_true",
                    help="poll /status.json and print one line per "
                         "sample (the only mode; flag kept explicit)")
    ap.add_argument("--url", default=None,
                    help="status server base URL "
                         "(default http://127.0.0.1:PORT)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--count", type=int, default=None,
                    help="stop after N samples (default: forever)")
    args = ap.parse_args(argv)
    url = args.url or f"http://{args.host}:{args.port}"
    return watch(url, interval=args.interval, count=args.count)


if __name__ == "__main__":
    sys.exit(main())
