"""Observability for the serve path: the counterpart of
``repro/runtime/metrics.py`` (host Python, nothing here touches the card).

``MetricsHub`` is the registry the server emits into:

* **Counters, gauges, histograms**, keyed by ``(name, sorted labels)``.
  Histograms keep exact nearest-rank percentiles while the observation
  count stays at or below ``MetricsConfig.hist_max_exact`` and fold into a
  fixed bucket ladder past it (a percentile is then the covering bucket's
  upper bound).
* **Spans**: ``span()`` and ``complete()`` stamp the serve phases
  (admission, prefill, prefill chunk, decode step, controller update) from
  the scheduler's own clock, wall time or a ``FaultInjector``'s virtual
  clock (``bind_clock``), and export them as Chrome/Perfetto
  ``trace_event`` JSON, one ``tid`` row per phase name.
* **Sinks**: a JSONL event stream (every line ``{"ts": float, "kind": str,
  ...}``; :func:`validate_jsonl` is its schema check) and a Prometheus-style
  text exposition.  Both are the reference's, byte for byte, for the same
  emitted values.
* **First-use watchdog**: :class:`RetraceWatchdog`.  The reference hooks
  JAX's compile events; eager PyTorch has none.  The port's one-time costs
  are a kernel library's build and load (``kernels/build.py:on_load``) and
  a capacity bucket's first decode step (a new key in the server's
  ``_trace_counts``), so those are what it counts: armed at the end of the
  first serve drain, any later first use warns and counts, as a reference
  retrace does.

**Overhead.**  Emission is plain Python over host values the serve loop
already holds: no ``.cpu()``, no ``.item()``, no synchronisation.  A
disabled hub returns from every method at once (``span`` hands back a
cached null context), so the serve is bitwise the same with the hub on or
off.
"""
from __future__ import annotations

import bisect
import collections
import json
import math
import time
import warnings
from typing import Any, Callable, Optional

from repro_torch.configs.base import MetricsConfig

# Default histogram bucket upper bounds (seconds): a log ladder from 100 us
# to a minute, then +inf
DEFAULT_BUCKETS: tuple = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, float("inf"))


def nearest_rank_pct(vals, q: float) -> float:
    """Nearest-rank percentile: rank = ceil(q*n) with float fuzz rounded
    away first (a bare ceil of 0.95*20 = 18.999999999999996 would report
    the max as p95 for every n <= 20).  Any sequence; sorts internally."""
    if not vals:
        return 0.0
    vals = sorted(vals)
    rank = math.ceil(round(q * len(vals), 9))
    return vals[min(len(vals) - 1, max(0, rank - 1))]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _flat_name(name: str, lkey: tuple) -> str:
    """``name{k="v",...}``: one instrument's snapshot and exposition key."""
    if not lkey:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in lkey) + "}"


class Histogram:
    """Fixed-bucket streaming histogram: exact nearest-rank percentiles
    while ``count <= max_exact`` (``max_exact=0``: exact forever), then the
    covering bucket's upper bound (the +inf bucket reports the observed
    max)."""

    __slots__ = ("buckets", "counts", "count", "total", "vmin", "vmax",
                 "max_exact", "_exact")

    def __init__(self, max_exact: int = 2048, buckets: tuple = ()):
        b = tuple(float(x) for x in (buckets or DEFAULT_BUCKETS))
        if sorted(b) != list(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {b}")
        if not b or math.isfinite(b[-1]):
            b = b + (float("inf"),)
        self.buckets = b
        self.counts = [0] * len(b)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.max_exact = int(max_exact)
        self._exact: Optional[list] = []

    @property
    def exact(self) -> bool:
        return self._exact is not None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        if self._exact is not None:
            self._exact.append(v)
            if self.max_exact and self.count > self.max_exact:
                self._exact = None          # fold: bucketed from here on

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if self._exact is not None:
            return nearest_rank_pct(self._exact, q)
        rank = max(1, math.ceil(round(q * self.count, 9)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                ub = self.buckets[i]
                return ub if math.isfinite(ub) else self.vmax
        return self.vmax

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p95": 0.0, "p99": 0.0,
                    "exact": True}
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(0.5), "p90": self.percentile(0.9),
                "p95": self.percentile(0.95), "p99": self.percentile(0.99),
                "exact": self.exact}


class _NullSpan:
    """Cached no-op context manager of the disabled hub."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One timed phase: stamps enter and exit from the hub's clock, appends
    a Chrome ``"ph": "X"`` trace event (tracing on) and folds the duration
    into histogram ``hist`` when given."""

    __slots__ = ("hub", "name", "labels", "hist", "t0", "dur")

    def __init__(self, hub: "MetricsHub", name: str, hist: Optional[str],
                 labels: dict):
        self.hub = hub
        self.name = name
        self.labels = labels
        self.hist = hist
        self.t0 = 0.0
        self.dur = 0.0

    def __enter__(self):
        self.t0 = self.hub.now()
        return self

    def __exit__(self, *exc):
        t1 = self.hub.now()
        self.dur = max(0.0, t1 - self.t0)
        if self.hist is not None:
            self.hub.observe(self.hist, self.dur, **self.labels)
        self.hub._trace_complete(self.name, self.t0, self.dur, self.labels)
        return False


class MetricsHub:
    """Registry of counters, gauges and histograms with trace and JSONL
    sinks.  ``MetricsConfig(enabled=False)``, the default, makes every
    method a no-op.  Exports: :meth:`snapshot` (a JSON-ready dict),
    :meth:`exposition` (Prometheus text), :meth:`trace_events`
    (Chrome/Perfetto), :meth:`events` (the JSONL ring) and :meth:`flush`
    (the configured sink files)."""

    def __init__(self, cfg: Optional[MetricsConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        cfg = cfg if cfg is not None else MetricsConfig()
        if cfg.cadence < 1:
            raise ValueError(f"metrics cadence must be >= 1, "
                             f"got {cfg.cadence}")
        if cfg.hist_max_exact < 0 or cfg.events_keep < 1:
            raise ValueError(
                f"hist_max_exact must be >= 0 and events_keep >= 1; got "
                f"{cfg.hist_max_exact}/{cfg.events_keep}")
        self.cfg = cfg
        self.enabled = bool(cfg.enabled)
        self._trace_on = self.enabled and (cfg.trace or bool(cfg.trace_path))
        self._clock: Callable[[], float] = clock or time.perf_counter
        self._t0: Optional[float] = None      # trace-timestamp origin
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self._events: collections.deque = collections.deque(
            maxlen=cfg.events_keep)
        self._trace: collections.deque = collections.deque(
            maxlen=cfg.events_keep)
        self._tids: dict = {}                  # phase name -> trace row
        self._jsonl = None                     # lazy append handle
        self.watchdog = RetraceWatchdog(self)
        if self.enabled and cfg.watchdog:
            self.watchdog.install()

    # ------------------------------------------------------------- clock --
    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Read time from ``clock`` (the scheduler's: a ``FaultInjector``'s
        virtual clock when one is attached)."""
        self._clock = clock

    def now(self) -> float:
        return float(self._clock())

    def _us(self, t: float) -> float:
        """Trace timestamp in microseconds after the first stamp."""
        if self._t0 is None:
            self._t0 = t
        return (t - self._t0) * 1e6

    # -------------------------------------------------------- instruments --
    def inc(self, name: str, value: float = 1, **labels) -> float:
        """Increment a counter; returns the new value (0.0 disabled)."""
        if not self.enabled:
            return 0.0
        k = (name, _label_key(labels))
        v = self._counters.get(k, 0) + value
        self._counters[k] = v
        return v

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self._gauges[(name, _label_key(labels))] = float(value)

    def set_counter(self, name: str, value: float, **labels) -> None:
        """Overwrite a counter with a total kept elsewhere (``KVPool.stats``
        counts; the hub mirrors)."""
        if not self.enabled:
            return
        self._counters[(name, _label_key(labels))] = value

    def observe(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        k = (name, _label_key(labels))
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = Histogram(self.cfg.hist_max_exact,
                                           self.cfg.hist_buckets)
        h.observe(value)

    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get((name, _label_key(labels)), 0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get((name, _label_key(labels)))

    def percentile(self, name: str, q: float, **labels) -> float:
        h = self._hists.get((name, _label_key(labels)))
        return h.percentile(q) if h is not None else 0.0

    def hist_mean(self, name: str, **labels) -> float:
        h = self._hists.get((name, _label_key(labels)))
        if h is None or h.count == 0:
            return 0.0
        return h.total / h.count

    def hist_count(self, name: str, **labels) -> int:
        h = self._hists.get((name, _label_key(labels)))
        return h.count if h is not None else 0

    # ------------------------------------------------------------ tracing --
    def span(self, name: str, hist: Optional[str] = None, **labels):
        """Timed phase context: ``with hub.span("prefill",
        hist="prefill_s", slot=i): ...``.  Disabled, or enabled with tracing
        off and no ``hist``, it is the cached null context (no clock read)."""
        if not self.enabled or (hist is None and not self._trace_on):
            return _NULL_SPAN
        return _Span(self, name, hist, labels)

    def complete(self, name: str, t0: float, hist: Optional[str] = None,
                 **labels) -> None:
        """Record a phase that started at ``t0`` (an earlier ``now()``) and
        ends now: the twin of :meth:`span` for a phase whose ends straddle
        control flow (the decode step)."""
        if not self.enabled:
            return
        dur = max(0.0, self.now() - t0)
        if hist is not None:
            self.observe(hist, dur, **labels)
        self._trace_complete(name, t0, dur, labels)

    def _trace_complete(self, name: str, t0: float, dur: float,
                        labels: dict) -> None:
        if not self._trace_on:
            return
        tid = self._tids.setdefault(name, len(self._tids) + 1)
        self._trace.append({"name": name, "cat": "serve", "ph": "X",
                            "ts": self._us(t0), "dur": dur * 1e6,
                            "pid": 0, "tid": tid,
                            "args": {k: _jsonable(v)
                                     for k, v in labels.items()}})

    def instant(self, name: str, **labels) -> None:
        """Zero-duration trace marker (sheds, preemptions, bucket
        switches)."""
        if not self._trace_on:
            return
        tid = self._tids.setdefault(name, len(self._tids) + 1)
        self._trace.append({"name": name, "cat": "serve", "ph": "i",
                            "ts": self._us(self.now()), "pid": 0,
                            "tid": tid, "s": "t",
                            "args": {k: _jsonable(v)
                                     for k, v in labels.items()}})

    # -------------------------------------------------------- JSONL events --
    def event(self, kind: str, **payload) -> None:
        """One structured event ``{"ts": <clock>, "kind": kind,
        **payload}``: into the in-memory ring and, with ``jsonl_path``, one
        JSON line."""
        if not self.enabled:
            return
        rec = {"ts": self.now(), "kind": str(kind)}
        for k, v in payload.items():
            rec[k] = _jsonable(v)
        self._events.append(rec)
        if self.cfg.jsonl_path:
            if self._jsonl is None:
                self._jsonl = open(self.cfg.jsonl_path, "a")
            self._jsonl.write(json.dumps(rec) + "\n")

    def events(self) -> list:
        return list(self._events)

    # ------------------------------------------------------------- exports --
    def snapshot(self) -> dict:
        """JSON-ready state of every instrument (flat ``name{labels}``
        keys; histograms as their summary dicts)."""
        return {
            "counters": {_flat_name(n, lk): v
                         for (n, lk), v in sorted(self._counters.items())},
            "gauges": {_flat_name(n, lk): v
                       for (n, lk), v in sorted(self._gauges.items())},
            "histograms": {_flat_name(n, lk): h.snapshot()
                           for (n, lk), h in sorted(self._hists.items())},
            "retraces_post_warmup": self.watchdog.retraces_post_warmup,
        }

    def exposition(self, prefix: str = "sparseinfer_") -> str:
        """Prometheus-style text exposition (histograms as summaries:
        ``{quantile="..."}`` lines plus ``_sum`` and ``_count``)."""
        lines: list = []
        seen: set = set()

        def family(name: str, mtype: str) -> str:
            fam = prefix + _sanitize(name)
            if fam not in seen:
                seen.add(fam)
                lines.append(f"# TYPE {fam} {mtype}")
            return fam

        for (n, lk), v in sorted(self._counters.items()):
            fam = family(n, "counter")
            lines.append(f"{_flat_name(fam, lk)} {_fmt(v)}")
        for (n, lk), v in sorted(self._gauges.items()):
            fam = family(n, "gauge")
            lines.append(f"{_flat_name(fam, lk)} {_fmt(v)}")
        for (n, lk), h in sorted(self._hists.items()):
            fam = family(n, "summary")
            for q in (0.5, 0.9, 0.95, 0.99):
                qlk = lk + (("quantile", f"{q:g}"),)
                lines.append(f"{_flat_name(fam, qlk)} "
                             f"{_fmt(h.percentile(q))}")
            lines.append(f"{_flat_name(fam + '_sum', lk)} {_fmt(h.total)}")
            lines.append(f"{_flat_name(fam + '_count', lk)} {h.count}")
        fam = family("retraces_post_warmup", "counter")
        lines.append(f"{fam} {self.watchdog.retraces_post_warmup}")
        return "\n".join(lines) + "\n"

    def trace_events(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object (load it in
        ui.perfetto.dev)."""
        return {"traceEvents": list(self._trace),
                "displayTimeUnit": "ms",
                "otherData": {"source": "repro_torch.runtime.metrics"}}

    def write_trace(self, path: Optional[str] = None) -> Optional[str]:
        path = path or self.cfg.trace_path
        if not path:
            return None
        with open(path, "w") as f:
            json.dump(self.trace_events(), f)
        return path

    def write_snapshot(self, path: Optional[str] = None) -> Optional[str]:
        path = path or self.cfg.snapshot_path
        if not path:
            return None
        with open(path, "w") as f:
            f.write(self.exposition())
        return path

    def flush(self) -> None:
        """Flush the JSONL handle and write the configured trace and
        exposition files."""
        if not self.enabled:
            return
        if self._jsonl is not None:
            self._jsonl.flush()
        self.write_trace()
        self.write_snapshot()

    def close(self) -> None:
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        self.watchdog.uninstall()


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, bool, type(None))):
        return v
    if isinstance(v, (int, float)):
        return v
    try:
        import numpy as _np
        if isinstance(v, _np.integer):
            return int(v)
        if isinstance(v, _np.floating):
            return float(v)
        if isinstance(v, _np.ndarray):
            return v.tolist()
    except Exception:                                   # pragma: no cover
        pass
    return str(v)


def validate_jsonl(path: str, max_lines: int = 0) -> int:
    """Schema check of the JSONL sink: every line a JSON object with a
    numeric ``ts`` and a non-empty string ``kind``.  Returns the number of
    valid lines; raises ``ValueError`` at the first violation."""
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if max_lines and n >= max_lines:
                break
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON ({e})") from None
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{i + 1}: not an object")
            if not isinstance(rec.get("ts"), (int, float)) \
                    or isinstance(rec.get("ts"), bool):
                raise ValueError(f"{path}:{i + 1}: missing numeric 'ts'")
            if not (isinstance(rec.get("kind"), str) and rec["kind"]):
                raise ValueError(f"{path}:{i + 1}: missing 'kind'")
            n += 1
    if n == 0:
        raise ValueError(f"{path}: no JSONL records")
    return n


# ---------------------------------------------------------------------------
# First-use watchdog
# ---------------------------------------------------------------------------
# One process-wide dispatch to every installed watchdog, as the reference's
# one jax.monitoring listener: a first use is a property of the process (a
# kernel library loads once for every server in it), not of one hub.
_ACTIVE_WATCHDOGS: list = []
_LISTENER_INSTALLED = [False]


def note_first_use(what: str) -> None:
    """Report a one-time cost paid now: a kernel library built or loaded,
    or a capacity bucket's first decode step.  Every installed watchdog
    counts it."""
    for w in list(_ACTIVE_WATCHDOGS):
        w._on_first_use(what)


def _on_library_load(name: str) -> None:
    note_first_use(f"kernel library {name}")


def _install_listener() -> None:
    if not _LISTENER_INSTALLED[0]:
        from repro_torch.kernels import build
        build.on_load(_on_library_load)
        _LISTENER_INSTALLED[0] = True


class RetraceWatchdog:
    """Post-warmup first-use alarm, the port's stand-in for the reference's
    retrace watchdog.

    The reference counts JAX traces through ``jax.monitoring``.  Eager
    PyTorch traces nothing; what the port pays once is a kernel library's
    build and load and a capacity bucket's first decode step, reported
    through :func:`note_first_use`.  ``compiles`` counts every first use
    since :meth:`install`; once :meth:`arm`-ed (the server arms it at the
    end of its first serve drain, when everything the configuration needs
    has been used) any further first use warns and adds to
    ``retraces_post_warmup`` and the hub's ``retrace_post_warmup`` counter,
    and records a ``retrace`` event.  The names are the reference's."""

    def __init__(self, hub: Optional[MetricsHub] = None):
        self.hub = hub
        self.armed = False
        self.compiles = 0                 # first uses since install()
        self.retraces_post_warmup = 0     # first uses while armed

    def install(self) -> None:
        _install_listener()
        if self not in _ACTIVE_WATCHDOGS:
            _ACTIVE_WATCHDOGS.append(self)

    def uninstall(self) -> None:
        if self in _ACTIVE_WATCHDOGS:
            _ACTIVE_WATCHDOGS.remove(self)

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def _on_first_use(self, what: str) -> None:
        self.compiles += 1
        if not self.armed:
            return
        self.retraces_post_warmup += 1
        hub = self.hub
        if hub is not None and hub.enabled:
            hub.inc("retrace_post_warmup")
            hub.event("retrace", n=self.retraces_post_warmup, what=what)
            hub.instant("retrace", n=self.retraces_post_warmup)
        warnings.warn(
            f"post-warmup retrace: first use of {what} after the serve "
            "warmup boundary; nothing should be built or set up after the "
            "first drain (check the bucket-ladder warmup)", stacklevel=2)

    def report(self) -> dict:
        return {"installed": self in _ACTIVE_WATCHDOGS,
                "armed": self.armed,
                "compiles": self.compiles,
                "retraces_post_warmup": self.retraces_post_warmup}
