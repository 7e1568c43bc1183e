"""Phi-accrual heartbeat failure detector (Hayashibara et al. 2004).

The accrual family replaces the binary alive/dead verdict of timeout
detectors with a continuous *suspicion level*

    phi(t) = -log10( P_later(t - t_last) )

where ``P_later(dt)`` is the probability that a heartbeat arrives more
than ``dt`` after the previous one, estimated from a sliding window of
observed inter-arrival times. The application picks a threshold: crossing
``phi = 8`` means the detector is wrong once in 1e8 decisions.

This implementation uses the **exponential model** popularized by
Cassandra: ``P_later(dt) = exp(-dt / mean)``, hence

    phi(dt) = dt / mean * log10(e)

which is closed-form, parameter-light, and — the property the simulator
needs — *array-friendly*: a whole suspicion timeline is one numpy column
expression, so the vectorized engine batches per-gateway phi curves the
same way it batches delay columns. Everything here is pure and seedable:
no wall clock, no hidden state beyond the explicit observation window.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

LOG10_E = math.log10(math.e)

# Conservative floor on the estimated mean interval: a burst of
# back-to-back heartbeats must not make the detector hair-triggered.
MIN_MEAN_S = 1e-6


def phi_timeline(dt_since_last, mean_interval) -> np.ndarray:
    """Vectorized suspicion level for elapsed times ``dt_since_last``.

    Pure numpy (broadcasting on both arguments): ``phi = dt / mean *
    log10(e)`` under the exponential inter-arrival model. Negative
    elapsed times clamp to 0 (a heartbeat just arrived)."""
    dt = np.maximum(np.asarray(dt_since_last, dtype=np.float64), 0.0)
    mean = np.maximum(np.asarray(mean_interval, dtype=np.float64), MIN_MEAN_S)
    return dt / mean * LOG10_E


def detection_delay(mean_interval: float, threshold: float = 8.0) -> float:
    """Closed-form time from last heartbeat until ``phi`` crosses
    ``threshold``: the inverse of :func:`phi_timeline`. This is the
    detector's contribution to the unavailability window — the simulator's
    fault driver uses it to schedule recovery."""
    return threshold * max(mean_interval, MIN_MEAN_S) / LOG10_E


def suspicion_times(heartbeat_times: Sequence[float], crash_time: float,
                    threshold: float = 8.0, window: int = 100) -> float:
    """When does a detector observing ``heartbeat_times`` (ascending) and
    a crash at ``crash_time`` first suspect the peer? Vectorized over the
    heartbeat history: the window mean at the crash instant determines the
    closed-form crossing time."""
    hb = np.asarray(heartbeat_times, dtype=np.float64)
    hb = hb[hb <= crash_time]
    if len(hb) < 2:
        raise ValueError("need >= 2 heartbeats before the crash to "
                         "estimate an inter-arrival mean")
    intervals = np.diff(hb)[-window:]
    return float(hb[-1]) + detection_delay(float(intervals.mean()), threshold)


def phi_trace(arrivals: Sequence[float], times: Sequence[float],
              window: int = 100) -> np.ndarray:
    """Vectorized replay of a :class:`PhiAccrualDetector` fed ``arrivals``
    (ascending heartbeat observation times) and queried at ``times``.

    At query instant ``t`` the suspicion level uses the sliding
    ``window``-mean of the inter-arrival intervals observed up to ``t``
    and the elapsed time since the last arrival — exactly the stateful
    detector's estimate, evaluated for a whole query grid in one numpy
    expression (cumsum over intervals + one searchsorted). 0.0 before two
    arrivals (no estimate, no suspicion).
    """
    a = np.asarray(arrivals, dtype=np.float64)
    t = np.atleast_1d(np.asarray(times, dtype=np.float64))
    phi = np.zeros(len(t))
    if len(a) < 2:
        return phi
    iv = np.diff(a)
    csum = np.concatenate([[0.0], np.cumsum(iv)])
    last = np.searchsorted(a, t, side="right") - 1  # index of last arrival
    ok = last >= 1
    li = last[ok]
    lo = np.maximum(li - window, 0)
    mean = np.maximum((csum[li] - csum[lo]) / (li - lo), MIN_MEAN_S)
    phi[ok] = np.maximum(t[ok] - a[li], 0.0) / mean * LOG10_E
    return phi


def suspicion_intervals(arrivals: Sequence[float], *,
                        threshold: float = 8.0, window: int = 100,
                        horizon: Optional[float] = None) -> np.ndarray:
    """Closed-form suspicion windows for a detector observing ``arrivals``
    (ascending heartbeat times).

    For each observed arrival ``a_i`` (from the second on), suspicion
    holds from ``a_i + detection_delay(window-mean at a_i)`` — the phi
    crossing instant under the exponential model — until the next beat
    lands; the final gap runs to ``horizon`` (default: the last arrival,
    i.e. no trailing window). Returns a ``(k, 2)`` array of ``[t_on,
    t_off)`` intervals, ascending and non-overlapping — the vectorized
    counterpart of replaying :func:`phi_trace` and thresholding it.
    """
    a = np.asarray(arrivals, dtype=np.float64)
    if len(a) < 2:
        return np.zeros((0, 2))
    iv = np.diff(a)
    csum = np.concatenate([[0.0], np.cumsum(iv)])
    idx = np.arange(1, len(a))          # estimate exists from a_1 on
    lo = np.maximum(idx - window, 0)
    mean = np.maximum((csum[idx] - csum[lo]) / (idx - lo), MIN_MEAN_S)
    on = a[1:] + threshold * mean / LOG10_E
    off = np.empty(len(a) - 1)
    off[:-1] = a[2:]
    off[-1] = float(a[-1]) if horizon is None else float(horizon)
    keep = on < off
    return np.stack([on[keep], off[keep]], axis=1)


def interval_intersection(intervals_a: np.ndarray,
                          intervals_b: np.ndarray) -> np.ndarray:
    """Intersection of two ``(k, 2)`` interval sets (each ascending and
    non-overlapping): the classic two-pointer merge."""
    A = np.asarray(intervals_a, dtype=np.float64).reshape(-1, 2)
    B = np.asarray(intervals_b, dtype=np.float64).reshape(-1, 2)
    out: List[List[float]] = []
    i = j = 0
    while i < len(A) and j < len(B):
        lo = max(A[i][0], B[j][0])
        hi = min(A[i][1], B[j][1])
        if lo < hi:
            out.append([lo, hi])
        if A[i][1] <= B[j][1]:
            i += 1
        else:
            j += 1
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def mutual_suspicion(arrivals_a: Sequence[float],
                     arrivals_b: Sequence[float], *,
                     threshold: float = 8.0, window: int = 100,
                     horizon: Optional[float] = None):
    """Symmetric suspicion across a cut: detector A observes B's beats
    (``arrivals_a``) and vice versa. Returns ``(intervals_a, intervals_b,
    overlap)`` where each interval set is per :func:`suspicion_intervals`
    and ``overlap`` is their intersection — the two-sided danger window
    during which BOTH sides suspect each other, i.e. exactly when
    split-brain refusal (not failover) must hold on both sides of a
    network partition.
    """
    ia = suspicion_intervals(arrivals_a, threshold=threshold,
                             window=window, horizon=horizon)
    ib = suspicion_intervals(arrivals_b, threshold=threshold,
                             window=window, horizon=horizon)
    return ia, ib, interval_intersection(ia, ib)


def false_positive_rate(arrivals: Sequence[float], *,
                        threshold: float = 8.0, window: int = 100,
                        resolution: float = 1e-3,
                        until: Optional[float] = None) -> float:
    """Fraction of query instants at which a detector observing
    ``arrivals`` from a LIVE peer would (wrongly) suspect it.

    The query grid sweeps ``[first arrival, until or last arrival)`` at
    ``resolution`` — every decision the application could have made while
    the peer was demonstrably alive (its beats kept coming). This is the
    measurable counterpart of the model's one-in-10**phi error claim,
    driven from simulated heartbeat traffic
    (:meth:`repro_torch.sim.cluster.SimEdgeKV.heartbeat_arrivals`).
    """
    a = np.asarray(arrivals, dtype=np.float64)
    if len(a) < 2:
        return 0.0
    end = float(a[-1]) if until is None else float(until)
    t = np.arange(float(a[0]), end, resolution)
    if not len(t):
        return 0.0
    return float((phi_trace(a, t, window) >= threshold).mean())


class PhiAccrualDetector:
    """Stateful per-peer detector: feed heartbeats, query suspicion.

    Parameters
    ----------
    threshold:
        Suspicion level at which a peer is declared failed (8 ~= one
        false positive per 1e8 decisions under the model).
    window:
        Sliding-window length for the inter-arrival estimate.
    min_mean_s:
        Floor on the estimated mean interval (guards against bursts).
    """

    def __init__(self, threshold: float = 8.0, window: int = 100,
                 min_mean_s: float = MIN_MEAN_S):
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_mean_s = float(min_mean_s)
        self._intervals: Dict[str, Deque[float]] = {}
        self._last: Dict[str, float] = {}

    # ------------------------------------------------------------ feeding
    def heartbeat(self, peer: str, t: float) -> None:
        last = self._last.get(peer)
        if last is not None:
            if t < last:
                raise ValueError(f"heartbeat for {peer!r} moves time "
                                 f"backwards ({t} < {last})")
            iv = self._intervals.setdefault(
                peer, deque(maxlen=self.window))
            iv.append(t - last)
        self._last[peer] = t

    def forget(self, peer: str) -> None:
        """Drop a peer's history (it left the ring on purpose)."""
        self._intervals.pop(peer, None)
        self._last.pop(peer, None)

    # ------------------------------------------------------------ querying
    def mean_interval(self, peer: str) -> Optional[float]:
        iv = self._intervals.get(peer)
        if not iv:
            return None
        return max(sum(iv) / len(iv), self.min_mean_s)

    def phi(self, peer: str, now: float) -> float:
        """Current suspicion level for ``peer``. 0.0 until two heartbeats
        have been observed (no estimate -> no suspicion)."""
        mean = self.mean_interval(peer)
        last = self._last.get(peer)
        if mean is None or last is None:
            return 0.0
        return float(phi_timeline(now - last, mean))

    def suspect(self, peer: str, now: float) -> bool:
        return self.phi(peer, now) >= self.threshold

    def suspected(self, now: float) -> List[str]:
        """All peers over threshold at ``now`` (detection sweep)."""
        return [p for p in self._last if self.suspect(p, now)]

    def detection_delay(self, peer: str) -> Optional[float]:
        """Time after ``peer``'s last heartbeat until it would be declared
        failed — the closed-form inverse of the peer's current estimate."""
        mean = self.mean_interval(peer)
        if mean is None:
            return None
        return detection_delay(mean, self.threshold)

    def phi_curve(self, peer: str, times: Sequence[float]) -> np.ndarray:
        """Suspicion timeline at query ``times`` given the peer's current
        estimate — one vectorized expression (the fast-engine hook)."""
        mean = self.mean_interval(peer)
        last = self._last.get(peer)
        if mean is None or last is None:
            return np.zeros(len(np.atleast_1d(np.asarray(times))))
        return phi_timeline(np.asarray(times, dtype=np.float64) - last, mean)
