"""Serving observability: counters, latency histograms, Prometheus text.

The reference has no serving observability at all (bela/upmix.cpp's
render loop keeps no statistics; python-prototype/main.py prints ad-hoc
progress).  A production multi-stream server needs scrapeable metrics:
how many sessions, how fast the pool dispatches, how close each block
comes to the real-time deadline.  This module is dependency-free
(stdlib only) and deliberately tiny: fixed log-spaced histogram
buckets so `record()` is O(#buckets) worst case and lock-cheap — it is
called once per pool dispatch (~ms scale), not per sample.

Consumed by `upmix.serve_stream.StreamServer` (every server keeps a
`ServerMetrics`; the wire protocol's `UPMQ` query and the optional
HTTP listener both render from `StreamServer.metrics_snapshot()`).
"""

from __future__ import annotations

import threading

# Upper bounds (seconds) for the latency histograms: 100 us .. ~105 s in
# x2 steps — spans a sub-ms direct-attach dispatch to a multi-second
# compile stall with one fixed, Prometheus-friendly bucket ladder.
_BUCKET_BOUNDS = tuple(1e-4 * (2.0 ** k) for k in range(21))


class LatencyHistogram:
    """Fixed-bucket latency histogram with Prometheus-style cumulative
    export and quantile estimates.

    Thread-safe: `record` and `snapshot` take an internal lock (both
    are rare relative to the audio math — one record per pool block).
    """

    def __init__(self, bounds=_BUCKET_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +1 = +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float):
        s = float(seconds)
        i = 0
        for b in self.bounds:
            if s <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += s
            self._count += 1
            if s > self._max:
                self._max = s

    def _quantile_from(self, counts, n, smax, q: float) -> float:
        """Upper-bound q-quantile from an already-captured counts
        vector (the first bucket boundary whose cumulative count
        reaches q·N) — the same estimator Prometheus's
        histogram_quantile uses, minus the within-bucket
        interpolation.  Returns 0.0 when empty."""
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                return self.bounds[i] if i < len(self.bounds) else smax
        return smax

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_from(self._counts, self._count,
                                       self._max, q)

    def snapshot(self) -> dict:
        # One lock acquisition captures counts AND quantiles: a record()
        # landing between a counts copy and a later quantile() call
        # would make p50/p95/p99 inconsistent with count/buckets in the
        # same snapshot.
        with self._lock:
            counts = list(self._counts)
            total, ssum, smax = self._count, self._sum, self._max
            quantiles = {
                f"p{int(q * 100)}": self._quantile_from(counts, total,
                                                        smax, q)
                for q in (0.5, 0.95, 0.99)
            }
        cum = 0
        buckets = []
        for b, c in zip(self.bounds, counts):
            cum += c
            buckets.append([b, cum])
        snap = {
            "count": total,
            "sum": ssum,
            "max": smax,
            "buckets": buckets,  # cumulative, Prometheus 'le' semantics
        }
        snap.update(quantiles)
        return snap


class ServerMetrics:
    """The stream server's metric set: monotonically increasing
    counters plus two latency histograms.

    `counters` is a plain dict so `StreamServer.stats` can alias it
    (the pre-metrics public surface keeps working).  Dict item
    assignment is atomic under the GIL and every counter is
    incremented under one of the server's existing locks, so no extra
    lock is held on the hot path.
    """

    COUNTER_KEYS = (
        "accepted",            # sessions admitted (incl. resumes)
        "rejected",            # pool-full / bad-token refusals
        "blocks",              # pool dispatches
        "frames",              # output frames delivered to clients
        "late_zero_blocks",    # realtime ticks where an ACTIVE slot had
                               # no input queued (zeros injected)
        "resumed",             # parked sessions resumed by token
        "parked_expired",      # parked sessions reclaimed by resume_ttl
        "checkpoints",         # save_checkpoint completions
        "dispatcher_failures", # dispatcher thread died (server stopped)
    )

    def __init__(self):
        self.counters = {k: 0 for k in self.COUNTER_KEYS}
        # Chip+host time of one pool dispatch (push_blocks + fetch).
        self.dispatch_seconds = LatencyHistogram()
        # The whole locked dispatcher cycle: dispatch + mix + per-slot
        # accounting.  cycle - dispatch = host-side serving overhead.
        self.cycle_seconds = LatencyHistogram()

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "dispatch_seconds": self.dispatch_seconds.snapshot(),
            "cycle_seconds": self.cycle_seconds.snapshot(),
        }


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    # Prometheus wants plain floats; repr keeps full precision.
    return repr(float(v))


def prometheus_text(snapshot: dict, prefix: str = "upmix") -> str:
    """Render a `StreamServer.metrics_snapshot()` dict in the Prometheus
    text exposition format (v0.0.4)."""
    lines = []

    def emit(name, mtype, help_text, samples):
        lines.append(f"# HELP {prefix}_{name} {help_text}")
        lines.append(f"# TYPE {prefix}_{name} {mtype}")
        for suffix, labels, value in samples:
            lbl = ""
            if labels:
                pairs = ",".join(
                    f'{k}="{_prom_escape(str(v))}"' for k, v in labels.items()
                )
                lbl = "{" + pairs + "}"
            lines.append(f"{prefix}_{name}{suffix}{lbl} {_fmt(value)}")

    for key, val in sorted(snapshot.get("counters", {}).items()):
        emit(f"{key}_total", "counter", f"Total {key.replace('_', ' ')}.",
             [("", None, val)])
    for key, val in sorted(snapshot.get("gauges", {}).items()):
        emit(key, "gauge", f"Current {key.replace('_', ' ')}.",
             [("", None, val)])
    for hname in ("dispatch_seconds", "cycle_seconds"):
        h = snapshot.get(hname)
        if not h:
            continue
        samples = [
            ("_bucket", {"le": _fmt(b)}, c) for b, c in h["buckets"]
        ]
        samples.append(("_bucket", {"le": "+Inf"}, h["count"]))
        samples.append(("_sum", None, h["sum"]))
        samples.append(("_count", None, h["count"]))
        emit(hname, "histogram", f"Stream-server {hname} histogram.",
             samples)
    info = snapshot.get("config")
    if info:
        emit("server_info", "gauge", "Static server configuration.",
             [("", {k: str(v) for k, v in sorted(info.items())}, 1.0)])
    return "\n".join(lines) + "\n"
