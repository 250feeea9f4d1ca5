"""Online time-series pipeline: ring-buffered per-metric windows with
streaming quantile sketches, cheap enough to run inside the frame loop.

Counterpart of ``bevy_ggrs_tpu/obs/timeseries.py``, a copy: pure Python,
so its floats are the JAX package's exactly.

The existing ``Metrics`` sink keeps *lifetime* aggregates (count, mean,
reservoir percentiles at exit). Capacity work needs the *live* view: what
is admission latency p99 **right now**, over the last few hundred
samples, while the arrival ladder is still climbing — without buffering
every sample (an open-loop load test at saturation produces millions) and
without a per-sample cost that would itself bend the measurement.

Two estimators per series, by design:

- a **P² streaming sketch** (Jain & Chlamtac 1985) per tracked quantile
  (p50/p95/p99): five markers per quantile, O(1) update, no buffer — the
  whole-stream estimate the Prometheus summary rows export;
- an **exact windowed percentile** over a bounded ring of the most recent
  ``window`` samples — the knee detector's signal (a saturating ladder
  step must see the *current* step's latency, not the whole run's).

The ``null_timeseries`` singleton keeps every call site unconditional,
like ``null_metrics``. ``obs.prom.export_prometheus(..., timeseries=...)``
renders ``{ns}_ts_{name}`` summaries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: Default tracked quantiles — matches the Metrics summary/Prom surface.
QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


class P2Quantile:
    """One streaming quantile, five markers, O(1) per sample — the classic
    P² estimator. Exact until 5 samples, then piecewise-parabolic marker
    adjustment; never buffers the stream."""

    __slots__ = ("q", "count", "_seed", "_h", "_n", "_np", "_dn")

    def __init__(self, q: float):
        self.q = float(q)
        self.count = 0
        self._seed: List[float] = []  # first five samples, then retired
        self._h: Optional[List[float]] = None  # marker heights
        self._n: Optional[List[int]] = None  # marker positions (1-based)
        self._np: Optional[List[float]] = None  # desired positions
        self._dn: Optional[List[float]] = None  # desired increments

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        h = self._h
        if h is None:
            self._seed.append(x)
            if len(self._seed) == 5:
                self._seed.sort()
                q = self.q
                self._h = self._seed
                self._seed = []
                self._n = [1, 2, 3, 4, 5]
                self._np = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
                self._dn = [0.0, q / 2, q, (1 + q) / 2, 1.0]
            return
        n, npos, dn = self._n, self._np, self._dn
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            npos[i] += dn[i]
        for i in (1, 2, 3):
            d = npos[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1) or (
                d <= -1.0 and n[i - 1] - n[i] < -1
            ):
                d = 1 if d >= 0 else -1
                # Parabolic prediction; fall back to linear when it would
                # leave the markers out of order (the P² guard).
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d)
                    * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d)
                    * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1])
                )
                if not (h[i - 1] < hp < h[i + 1]):
                    hp = h[i] + d * (h[i + d] - h[i]) / (n[i + d] - n[i])
                h[i] = hp
                n[i] += d

    def value(self) -> float:
        if self._h is not None:
            return self._h[2]
        if not self._seed:
            return 0.0
        srt = sorted(self._seed)
        pos = self.q * (len(srt) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(srt) - 1)
        frac = pos - lo
        return srt[lo] * (1.0 - frac) + srt[hi] * frac


def _exact_percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile of a small sorted list."""
    if not values:
        return 0.0
    pos = q * (len(values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    frac = pos - lo
    return values[lo] * (1.0 - frac) + values[hi] * frac


class MetricWindow:
    """One series: a bounded ring of recent samples + one P² sketch per
    tracked quantile + min/max/sum running aggregates."""

    __slots__ = (
        "name", "window", "count", "total", "minimum", "maximum", "last",
        "_ring", "_idx", "_sketches",
    )

    def __init__(
        self,
        name: str,
        window: int = 512,
        quantiles: Tuple[float, ...] = QUANTILES,
    ):
        self.name = name
        self.window = int(window)
        self.count = 0
        self.total = 0.0
        self.minimum = float("inf")
        self.maximum = float("-inf")
        self.last = 0.0
        self._ring: List[float] = []
        self._idx = 0
        self._sketches = [P2Quantile(q) for q in quantiles]

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.minimum:
            self.minimum = value
        if value > self.maximum:
            self.maximum = value
        self.last = value
        ring = self._ring
        if len(ring) < self.window:
            ring.append(value)
        else:
            ring[self._idx] = value
            self._idx = (self._idx + 1) % self.window
        for sk in self._sketches:
            sk.add(value)

    # -- readers ---------------------------------------------------------

    def percentile(self, q: float) -> float:
        """Whole-stream estimate from the matching P² sketch (exact
        windowed reads go through :meth:`window_percentile`)."""
        for sk in self._sketches:
            if abs(sk.q - q) < 1e-12:
                return sk.value()
        raise KeyError(f"quantile {q} is not tracked on {self.name!r}")

    def window_values(self) -> List[float]:
        """The ring in chronological order (oldest first) — consumers
        like ``WindowSLO`` slice the tail as the short window, so the
        rotation matters once the ring has wrapped."""
        ring = self._ring
        if len(ring) < self.window or self._idx == 0:
            return list(ring)
        return ring[self._idx:] + ring[: self._idx]

    def window_percentile(self, q: float) -> float:
        """Exact percentile over the ring (the last ``window`` samples)."""
        return _exact_percentile(sorted(self._ring), q)

    def window_mean(self) -> float:
        return (sum(self._ring) / len(self._ring)) if self._ring else 0.0

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "count": self.count,
            "last": self.last,
            "min": 0.0 if self.count == 0 else self.minimum,
            "max": 0.0 if self.count == 0 else self.maximum,
            "mean": (self.total / self.count) if self.count else 0.0,
            "window_n": len(self._ring),
            "window_mean": self.window_mean(),
        }
        srt = sorted(self._ring)
        for sk in self._sketches:
            key = f"p{sk.q * 100:g}".replace(".", "_")
            out[key] = sk.value()
            out[f"window_{key}"] = _exact_percentile(srt, sk.q)
        return out


class TimeSeries:
    """The per-process pipeline: name -> :class:`MetricWindow`, guarded by
    the same cardinality discipline as ``Metrics`` (new names past
    ``max_series`` are dropped and counted, never raised)."""

    enabled = True

    def __init__(
        self,
        window: int = 512,
        max_series: int = 256,
        quantiles: Tuple[float, ...] = QUANTILES,
    ):
        self.window = int(window)
        self.max_series = int(max_series)
        self.quantiles = tuple(quantiles)
        self.series: Dict[str, MetricWindow] = {}
        self.dropped = 0

    def observe(self, name: str, value: float) -> None:
        w = self.series.get(name)
        if w is None:
            if len(self.series) >= self.max_series:
                self.dropped += 1
                return
            w = self.series[name] = MetricWindow(
                name, self.window, self.quantiles
            )
        w.observe(value)

    def window_for(self, name: str) -> Optional[MetricWindow]:
        return self.series.get(name)

    def names(self) -> List[str]:
        return sorted(self.series)

    def percentile(self, name: str, q: float, windowed: bool = False) -> float:
        w = self.series.get(name)
        if w is None:
            return 0.0
        return w.window_percentile(q) if windowed else w.percentile(q)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: w.snapshot() for name, w in sorted(self.series.items())}


class _NullTimeSeries:
    """Disabled pipeline: observe is a bound no-op, readers are empty —
    call sites stay unconditional (the ``null_metrics`` pattern)."""

    enabled = False
    dropped = 0
    series: Dict[str, MetricWindow] = {}

    def observe(self, name: str, value: float) -> None:
        pass

    def window_for(self, name: str) -> Optional[MetricWindow]:
        return None

    def names(self) -> List[str]:
        return []

    def percentile(self, name: str, q: float, windowed: bool = False) -> float:
        return 0.0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {}


null_timeseries = _NullTimeSeries()
