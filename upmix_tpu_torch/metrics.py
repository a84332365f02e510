"""Latency histogram for the port's job server.

The port's copy of `upmix_tpu.metrics.LatencyHistogram` (`run_jobs`
reports completed-job wall-time percentiles from it).  The stream
server's `ServerMetrics` and the Prometheus text come with the stream
server.  Standard library only.
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
