"""Deterministic fault injection for the serve path: the port's copy of
``repro/runtime/faults.py`` (host numpy, nothing here touches the card).

Overload runs drive the scheduler through its failure modes on purpose
(pool exhaustion, deadline expiry, a slot dying mid-prefill, an aborted
serve) with every firing decided by an explicit pass count or a seeded RNG,
never by a wall-clock race:

* **Virtual clock.**  With ``virtual_clock=True`` the server reads time
  through :meth:`now`, and its scheduler loop advances it by ``tick_s``
  once per iteration (``Server._tick``), so deadlines and queue waits are
  functions of scheduling decisions alone: the same queue sheds the same
  requests on every host, and on the card as on the CPU.  The clock starts
  at 1.0, not 0.0: ``throughput_report`` reads ``t_* == 0.0`` as "never
  stamped".
* **Armed fault points.**  :meth:`arm` registers a fault at a named point
  (``"prefill"``, ``"decode"``); the server calls :meth:`check` there and
  an armed match raises :class:`InjectedFault`.  ``after`` skips the first
  N eligible passes, ``times`` bounds the firings, ``prob`` makes each
  decision a seeded coin flip instead.  The scheduler sheds the request of
  a prefill fault; a decode fault aborts ``serve()``, which resets the
  server.

Forced pool exhaustion needs no hook: :meth:`hold_blocks` takes and pins
blocks through the pool's public allocator, as a co-tenant would.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.runtime.kv_pool import KVPool, PoolExhausted


class InjectedFault(RuntimeError):
    """Raised by ``FaultInjector.check`` at an armed fault point."""


@dataclasses.dataclass
class _Arm:
    point: str
    uid: Optional[int]      # restrict to one request (None = any)
    after: int              # skip this many eligible passes first
    times: int              # firings before the arm exhausts (-1 = forever)
    prob: float             # >0: seeded coin flip instead of pass counting
    seen: int = 0
    fired: int = 0

    def exhausted(self) -> bool:
        return self.times >= 0 and self.fired >= self.times


class FaultInjector:
    """Seeded, deterministic fault source attached to a ``Server`` via
    ``Server.attach_faults``."""

    def __init__(self, seed: int = 0, virtual_clock: bool = False,
                 tick_s: float = 0.01):
        self.rng = np.random.default_rng(seed)
        self.virtual_clock = bool(virtual_clock)
        self.tick_s = float(tick_s)
        self._t = 1.0
        self._arms: list[_Arm] = []
        self._held: list[tuple[KVPool, int]] = []
        self.fired = collections.Counter()

    # -------------------------------------------------------------- clock --
    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += float(dt)

    def tick(self) -> None:
        """One scheduler-loop iteration's worth of virtual time."""
        self._t += self.tick_s

    def time_source(self):
        """The clock the scheduler (and its ``MetricsHub``) should read:
        this injector's virtual clock when armed, wall time otherwise."""
        if self.virtual_clock:
            return self.now
        return time.perf_counter

    # ------------------------------------------------------- fault points --
    def arm(self, point: str, uid: Optional[int] = None, after: int = 0,
            times: int = 1, prob: float = 0.0) -> None:
        self._arms.append(_Arm(point, uid, int(after), int(times),
                               float(prob)))

    def check(self, point: str, uid: Optional[int] = None) -> None:
        """Raise ``InjectedFault`` when an armed spec matches this pass."""
        for a in self._arms:
            if a.point != point or a.exhausted():
                continue
            if a.uid is not None and uid is not None and a.uid != uid:
                continue
            if a.prob > 0.0:
                if self.rng.random() >= a.prob:
                    continue
            else:
                a.seen += 1
                if a.seen <= a.after:
                    continue
            a.fired += 1
            self.fired[point] += 1
            raise InjectedFault(
                f"injected fault at {point}"
                + (f" (uid={uid})" if uid is not None else ""))

    # ------------------------------------------------------ pool pressure --
    def hold_blocks(self, pool: KVPool, n: int) -> int:
        """Pin up to ``n`` blocks through the public allocator (forced
        exhaustion); returns how many were actually acquired."""
        got = 0
        for _ in range(int(n)):
            try:
                self._held.append((pool, pool.alloc()))
            except PoolExhausted:
                break
            got += 1
        return got

    def release_blocks(self, n: Optional[int] = None) -> int:
        """Release ``n`` held blocks (newest first; all when ``None``)."""
        n = len(self._held) if n is None else min(int(n), len(self._held))
        for _ in range(n):
            pool, bid = self._held.pop()
            pool.release(bid)
        return n
