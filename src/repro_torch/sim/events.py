"""Minimal deterministic discrete-event engine (virtual time, generators).

A tiny simpy-style core: processes are generators that ``yield`` either a
:class:`Timeout` (advance virtual time) or ``resource.acquire()`` (FIFO
queueing). Deterministic given seeds — identical runs reproduce identical
latency traces, which the reproduction tests rely on.

Simultaneous events are ordered by *process id* (creation order), not by
global push order: a process created earlier always wins a virtual-time
tie. This makes the tie-break a pure function of (time, process) — the
property the vectorized fast path (:mod:`repro_torch.sim.vectorized`) relies on
to reproduce the generator engine's traces bit-for-bit without replaying
the event heap one Timeout at a time.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Callable, Dict, Generator, List, Optional, Tuple


class Environment:
    def __init__(self) -> None:
        self.now: float = 0.0
        self._q: List[Tuple[float, int, int, Callable[[], None]]] = []
        self._seq = 0
        self._pids: Dict[Generator, int] = {}
        self._next_pid = 0

    def _pid(self, gen: Generator) -> int:
        pid = self._pids.get(gen)
        if pid is None:
            pid = self._pids[gen] = self._next_pid
            self._next_pid += 1
        return pid

    def _push(self, at: float, pid: int, fn: Callable[[], None]) -> None:
        heapq.heappush(self._q, (at, pid, self._seq, fn))
        self._seq += 1

    def process(self, gen: Generator) -> Generator:
        """Start a process now."""
        self._push(self.now, self._pid(gen), lambda: self._step(gen, None))
        return gen

    def _step(self, gen: Generator, value) -> None:
        try:
            ev = gen.send(value)
        except StopIteration:
            self._pids.pop(gen, None)
            return
        ev._register(self, gen)

    def run(self, until: float = float("inf")) -> None:
        while self._q and self._q[0][0] <= until:
            at, _, _, fn = heapq.heappop(self._q)
            self.now = at
            fn()


class DeferredEnvironment(Environment):
    """Environment stand-in for the vectorized engine.

    ``process()`` only *registers* the generator (with a pid from the same
    counter as the oracle engine, so virtual-time tie-breaks agree); the
    fast engine in :mod:`repro_torch.sim.vectorized` steps registered generators
    itself and advances ``now`` directly. Only ``Timeout``-yielding
    auxiliary processes (e.g. ``SimEdgeKV.churn_proc``) are supported.
    """

    def __init__(self) -> None:
        super().__init__()
        self.pending: List[Tuple[int, Generator]] = []

    def process(self, gen: Generator) -> Generator:
        self.pending.append((self._pid(gen), gen))
        return gen

    def run(self, until: float = float("inf")) -> None:
        raise RuntimeError(
            "DeferredEnvironment is driven by the vectorized engine; "
            "use SimEdgeKV.run_closed_loop/run_open_loop")


class Timeout:
    """``yield Timeout(dt)`` resumes the process after ``dt`` virtual secs."""

    __slots__ = ("delay",)

    def __init__(self, delay: float):
        if delay < 0:
            raise ValueError("negative delay")
        self.delay = delay

    def _register(self, env: Environment, gen: Generator) -> None:
        env._push(env.now + self.delay, env._pid(gen),
                  lambda: env._step(gen, None))


class Resource:
    """FIFO server pool (capacity ``c``). Holder must call ``release()``.

    Models a serialized stage — e.g. an etcd leader's fsync/commit pipeline.
    Tracks utilization for the energy/efficiency discussion.
    """

    def __init__(self, env: Environment, capacity: int = 1):
        self.env = env
        self.capacity = capacity
        self.busy = 0
        self.waiters: deque = deque()
        self.busy_time = 0.0
        self._last_change = 0.0

    def _account(self) -> None:
        self.busy_time += self.busy * (self.env.now - self._last_change)
        self._last_change = self.env.now

    class _Acquire:
        __slots__ = ("res",)

        def __init__(self, res: "Resource"):
            self.res = res

        def _register(self, env: Environment, gen: Generator) -> None:
            res = self.res
            if res.busy < res.capacity:
                res._account()
                res.busy += 1
                env._push(env.now, env._pid(gen),
                          lambda: env._step(gen, None))
            else:
                res.waiters.append(gen)

    def acquire(self) -> "Resource._Acquire":
        return Resource._Acquire(self)

    def release(self) -> None:
        self._account()
        if self.waiters:
            gen = self.waiters.popleft()
            # hand over the slot without dropping busy count
            self.env._push(self.env.now, self.env._pid(gen),
                           lambda: self.env._step(gen, None))
        else:
            self.busy -= 1

    def utilization(self, horizon: Optional[float] = None) -> float:
        self._account()
        t = horizon if horizon is not None else self.env.now
        return self.busy_time / (t * self.capacity) if t > 0 else 0.0
