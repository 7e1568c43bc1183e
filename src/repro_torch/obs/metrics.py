"""Typed metrics registry with stable dotted names.

``Counter`` / ``Gauge`` / ``Histogram`` instruments live in a
:class:`MetricsRegistry` keyed by dotted names (``sim.refusals.writes``,
``sim.cache.gateway.hits``, ...).  Snapshots are flat ``{name: number}``
dicts — JSON-ready, diff-able, and what the scenario engine and the
``python -m repro_torch.obs`` CLI consume.

A registry built with ``enabled=False`` hands out a shared null
instrument whose mutators are no-ops bound at class-definition time —
the disabled hot path is one attribute call with an empty body, so
instrumented code needs no ``if metrics:`` guards.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple, Union

Number = Union[int, float]


class Counter:
    """Monotonically increasing count."""
    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def snapshot_into(self, out: Dict[str, Number]) -> None:
        out[self.name] = self.value


class Gauge:
    """Point-in-time value (set, not accumulated)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def snapshot_into(self, out: Dict[str, Number]) -> None:
        out[self.name] = self.value


class Histogram:
    """Fixed-bucket histogram (log-spaced by default) plus exact
    count/sum/min/max; quantiles interpolate within the winning bucket."""
    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    #: default bucket upper bounds: 1us .. ~100s, 5 per decade
    DEFAULT_BOUNDS = tuple(
        10.0 ** (-6 + i / 5.0) for i in range(41))

    def __init__(self, name: str,
                 bounds: Optional[Iterable[float]] = None) -> None:
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None \
            else self.DEFAULT_BOUNDS
        self.counts = [0] * (len(self.bounds) + 1)   # +1 overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        lo, hi = 0, len(self.bounds)
        while lo < hi:                         # first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1

    def quantile(self, q: float) -> float:
        if not self.count:
            return math.nan
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                lo = self.bounds[i - 1] if i else (
                    self.min if math.isfinite(self.min) else 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - (acc - c)) / c
                return min(max(lo + (hi - lo) * frac, self.min), self.max)
        return self.max

    def snapshot_into(self, out: Dict[str, Number]) -> None:
        out[self.name + ".count"] = self.count
        out[self.name + ".sum"] = self.sum
        if self.count:
            out[self.name + ".mean"] = self.sum / self.count
            out[self.name + ".min"] = self.min
            out[self.name + ".max"] = self.max
            out[self.name + ".p95"] = self.quantile(0.95)
            out[self.name + ".p99"] = self.quantile(0.99)


class _NullInstrument:
    """Shared no-op stand-in handed out by a disabled registry."""
    __slots__ = ()
    name = "<disabled>"
    value = 0

    def inc(self, n: Number = 1) -> None:
        pass

    def set(self, v: Number) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snapshot_into(self, out: Dict[str, Number]) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Name -> instrument map; instruments are created on first use."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        if not self.enabled:
            return NULL_INSTRUMENT
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, *args)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Iterable[float]] = None) -> Histogram:
        return self._get(name, Histogram, *(() if bounds is None
                                            else (bounds,)))

    # --------------------------------------------------------- snapshots
    def snapshot(self) -> Dict[str, Number]:
        out: Dict[str, Number] = {}
        for name in sorted(self._instruments):
            self._instruments[name].snapshot_into(out)  # type: ignore[attr-defined]
        return out

    @staticmethod
    def diff(before: Dict[str, Number],
             after: Dict[str, Number]) -> Dict[str, Number]:
        """``after - before`` per shared key, plus keys new in ``after``."""
        out: Dict[str, Number] = {}
        for k, v in after.items():
            b = before.get(k)
            out[k] = v - b if isinstance(b, (int, float)) else v
        return out


def format_snapshot(snap: Dict[str, Number],
                    prefix: str = "") -> List[str]:
    """Render a flat snapshot as aligned ``name value`` lines."""
    rows: List[Tuple[str, Number]] = [
        (k, v) for k, v in sorted(snap.items()) if k.startswith(prefix)]
    width = max((len(k) for k, _ in rows), default=0)
    return [f"{k:<{width}}  {v:g}" if isinstance(v, float)
            else f"{k:<{width}}  {v}" for k, v in rows]
