"""Online adaptive-alpha controller of the serve path: the counterpart of
``repro/runtime/controller.py`` (host numpy, nothing here touches the card).

The paper (§V-B) calls the predictor's conservativeness ``alpha`` "a
control knob for optimizing LLM inference" and tunes it offline; this loop
tunes it online.  Every decode step returns per-layer telemetry
(``core.sparse_mlp.MLP_STAT_KEYS``): predicted, realized and actual
density, clamp overflow, the batch-union demand and a false-negative
signal, which comes from the masked strategy's full gate on audit steps or,
with ``native_fn``, from the pallas kernels' in-kernel proxy every step.
Between steps the controller EMA-filters it and applies, per layer ``l``
(and per SLA tier when tiered)::

    e_l     = density_ema[l] - target_density          # >0: too dense
    fn_ex   = max(fn_ema[l] - fn_budget, 0)            # audit overshoot
    dalpha  = clip(-gain * e_l + fn_gain * fn_ex, +-max_step)
    alpha_l = clip(alpha_l + dalpha, alpha_min, alpha_max)

Raising alpha keeps more neurons, so the density term is negative feedback;
the false-negative term only ever raises alpha.  With ``tiers`` the state
is (T, L): each tier starts from the schedule plus its alpha offset and
regulates toward its own target; tiers with no live slot in a step are
frozen for that step.  ``capacity_hint`` sizes the capacity to the observed
union demand plus slack; the server's bucket ladder reads it between steps.

A sharded config (``tp_shards``) wraps the controller in
``DistributedController``, which takes the per-shard riders off each
step's stats and keeps per-(layer, shard) EMAs for the skew report and the
per-shard bucket ladder.

Not ported yet: the checkpoint helpers ``save_controller`` /
``restore_controller`` (controller checkpoints on disk).
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ControllerConfig, SLATier
from repro_torch.core.predictor import AlphaSchedule
from repro_torch.core.selection import expected_capacity
from repro_torch.core.sparse_mlp import (SHARD_RIDER_KEYS, SHARD_STAT_KEY,
                                         SHARD_UNION_KEY)

# the step-by-step trace is a reporting aid and must not grow without bound
TRAJECTORY_KEEP = 4096


def aggregate_tier_stats(stats: dict, tier_idx: np.ndarray, n_tiers: int,
                         active: Optional[np.ndarray] = None):
    """Per-slot decode telemetry, dict of (L, B) arrays, averaged over each
    tier's live slots -> (dict of (T, L) arrays, (T,) slot counts).  An
    empty tier gets zeros and count 0 (the controller freezes it)."""
    tier_idx = np.asarray(tier_idx)
    b = tier_idx.shape[0]
    act = np.ones(b, bool) if active is None else np.asarray(active, bool)
    counts = np.zeros(n_tiers, np.int64)
    onehot = np.zeros((n_tiers, b), np.float32)
    for t in range(n_tiers):
        sel = act & (tier_idx == t)
        counts[t] = int(sel.sum())
        if counts[t]:
            onehot[t, sel] = 1.0 / counts[t]
    out = {}
    for k, v in stats.items():
        v = np.asarray(v, np.float32)
        if v.ndim != 2 or v.shape[1] != b:
            raise ValueError(f"stats[{k!r}] shape {v.shape} != (L, {b})")
        out[k] = np.ascontiguousarray((v @ onehot.T).T)     # (T, L)
    return out, counts


@dataclasses.dataclass
class ControllerState:
    """Host-side state, (L,) per controlled layer or (T, L) when tiered."""

    alphas: np.ndarray        # live per-layer alpha
    density_ema: np.ndarray   # realized-density estimate
    overflow_ema: np.ndarray  # capacity-overflow fraction estimate
    fn_ema: np.ndarray        # false-negative-rate estimate
    predicted_ema: np.ndarray  # predictor keep-rate estimate
    union_ema: Optional[np.ndarray] = None  # batch-union demand estimate
    steps: int = 0            # decode steps observed
    audits: int = 0           # audit steps observed


class AlphaController:
    """Feedback controller owning the per-layer (x per-tier) alphas.

    Drive pattern (``runtime.server.Server.generate``)::

        audit = ctl.is_audit_step()
        ..., stats = decode(..., alphas=ctl.alphas(), audit=audit)
        ctl.observe(stats_as_numpy, audit=audit)

    With ``tiers`` the stats are aggregated per tier first
    (:func:`aggregate_tier_stats`) and passed with their slot counts.
    ``native_fn``: the serving strategy's own telemetry carries the
    false-negative signal (pallas), so ``fn_ema`` updates every step and
    there are no audit steps.
    """

    def __init__(self, cfg: ControllerConfig, schedule: AlphaSchedule,
                 num_layers: int, tiers: Optional[Sequence[SLATier]] = None,
                 native_fn: bool = False):
        self.cfg = cfg
        self.num_layers = num_layers
        self.native_fn = bool(native_fn)
        self.tiers: Optional[tuple] = tuple(tiers) if tiers else None
        a0 = schedule.init_state(num_layers).astype(np.float32)
        if self.tiers:
            a0 = np.stack([a0 + np.float32(t.alpha_offset)
                           for t in self.tiers])            # (T, L)
            self._target = np.asarray(
                [t.target(cfg.target_density) for t in self.tiers],
                np.float32)[:, None]                         # (T, 1)
        else:
            self._target = np.float32(cfg.target_density)
        t = np.broadcast_to(self._target, a0.shape).astype(np.float32)
        self.state = ControllerState(
            alphas=np.clip(a0, cfg.alpha_min, cfg.alpha_max),
            density_ema=t.copy(),
            overflow_ema=np.zeros_like(a0),
            fn_ema=np.zeros_like(a0),
            predicted_ema=t.copy(),
            union_ema=t.copy(),
        )
        # the sparse-prefill rider: chunks fold their realized density into
        # an EMA of their own (a chunk union over S rows is another
        # operating point than a batch union over B slots) and nudge alpha
        # at prefill_weight of the decode gain
        self.prefill_ema = t.copy()
        self.prefill_chunks = 0
        self._trajectory: collections.deque = collections.deque(
            maxlen=TRAJECTORY_KEEP)

    @property
    def n_tiers(self) -> int:
        return len(self.tiers) if self.tiers else 1

    # ------------------------------------------------------------- inputs --
    def alphas(self) -> np.ndarray:
        """Alphas for the next decode step, (L,) or (T, L) (a copy)."""
        return self.state.alphas.copy()

    def slot_alphas(self, tier_idx: np.ndarray) -> np.ndarray:
        """(L, B) alphas: column b holds slot b's tier alphas."""
        a = self.state.alphas
        if a.ndim == 1:
            a = a[None]
        return np.ascontiguousarray(
            a[np.asarray(tier_idx)].T.astype(np.float32))

    def is_audit_step(self) -> bool:
        """True when the NEXT decode step should run the masked audit
        (exact false negatives).  Never with ``native_fn``."""
        if self.native_fn:
            return False
        p = self.cfg.audit_period
        return p > 0 and (self.state.steps + 1) % p == 0

    # ------------------------------------------------------------- update --
    def observe(self, stats: dict, audit: bool = False,
                tier_counts: Optional[np.ndarray] = None) -> None:
        """Fold one decode step's telemetry, arrays shaped like the state,
        into the EMAs and apply the update law.  ``tier_counts`` (T,) freezes
        the tiers that had no live slot.  An audit step updates only the
        false-negative estimate: the masked path's densities are on another
        scale (per token, no clamp) than the serving strategy's."""
        s, c = self.state, self.cfg
        beta = np.float32(c.ema)
        if tier_counts is not None:
            upd = (np.asarray(tier_counts) > 0)[:, None]     # (T, 1)
            if upd.shape[0] != self.n_tiers:
                raise ValueError(
                    f"tier_counts width {upd.shape[0]} != {self.n_tiers}")
        else:
            upd = np.bool_(True)

        def ema(prev, obs):
            obs = np.asarray(obs, np.float32)
            if obs.shape != prev.shape:
                raise ValueError(
                    f"telemetry shape {obs.shape} != state {prev.shape}")
            return np.where(upd, (1 - beta) * prev + beta * obs, prev)

        if audit:
            s.fn_ema = ema(s.fn_ema, stats["false_neg_rate"])
            s.audits += 1
        else:
            s.density_ema = ema(s.density_ema, stats["realized_density"])
            s.predicted_ema = ema(s.predicted_ema,
                                  stats["predicted_density"])
            s.overflow_ema = ema(s.overflow_ema, stats["overflow_frac"])
            union = stats.get("union_demand_frac")
            if union is None:
                union = (np.asarray(stats["realized_density"], np.float32)
                         + np.asarray(stats["overflow_frac"], np.float32))
            if s.union_ema is None:
                s.union_ema = (s.density_ema + s.overflow_ema).astype(
                    np.float32)
            s.union_ema = ema(s.union_ema, union)
            if self.native_fn:
                s.fn_ema = ema(s.fn_ema, stats["false_neg_rate"])
        s.steps += 1

        err = s.density_ema - self._target
        fn_excess = np.maximum(s.fn_ema - np.float32(c.fn_budget), 0.0)
        dalpha = np.clip(-c.gain * err + c.fn_gain * fn_excess,
                         -c.max_step, c.max_step)
        s.alphas = np.where(
            upd,
            np.clip(s.alphas + dalpha.astype(np.float32),
                    c.alpha_min, c.alpha_max),
            s.alphas).astype(np.float32)
        self._trajectory.append({
            "step": s.steps,
            "audit": bool(audit),
            "mean_density": float(s.density_ema.mean()),
            "mean_alpha": float(s.alphas.mean()),
            "mean_overflow": float(s.overflow_ema.mean()),
            "mean_fn": float(s.fn_ema.mean()),
        })

    def observe_prefill(self, stats: dict,
                        tier: Optional[int] = None) -> None:
        """Fold one prefill chunk's (L,) telemetry into the prefill EMA and
        nudge alpha at ``prefill_weight`` of the decode gain.  ``tier``: the
        owning request's tier row when tiered (every other tier is
        frozen)."""
        s, c = self.state, self.cfg
        obs = np.asarray(stats["realized_density"], np.float32)
        if obs.shape != (self.num_layers,):
            raise ValueError(
                f"prefill telemetry shape {obs.shape} != "
                f"({self.num_layers},)")
        beta = np.float32(c.ema)
        w = np.float32(c.prefill_weight)
        if self.tiers:
            t = 0 if tier is None else int(tier)
            self.prefill_ema[t] = (1 - beta) * self.prefill_ema[t] + beta * obs
            err = self.prefill_ema[t] - self._target[t]
            dalpha = np.clip(-c.gain * w * err, -c.max_step, c.max_step)
            s.alphas[t] = np.clip(s.alphas[t] + dalpha.astype(np.float32),
                                  c.alpha_min, c.alpha_max)
        else:
            self.prefill_ema = (1 - beta) * self.prefill_ema + beta * obs
            err = self.prefill_ema - self._target
            dalpha = np.clip(-c.gain * w * err, -c.max_step, c.max_step)
            s.alphas = np.clip(s.alphas + dalpha.astype(np.float32),
                               c.alpha_min, c.alpha_max).astype(np.float32)
        self.prefill_chunks += 1

    # ------------------------------------------------------------ outputs --
    def capacity_hint(self, k: int, slack: float = 1.3,
                      multiple: int = 128) -> int:
        """Recommended capacity in neurons: the batch-union demand EMA, max
        over tiers and layers, plus slack, rounded up to ``multiple``."""
        demand = self.state.union_ema
        if demand is None:
            demand = self.state.density_ema + self.state.overflow_ema
        keep = min(1.0, float(np.max(demand)))
        return expected_capacity(k, 1.0 - keep, slack, multiple)

    def converged(self, tol: float = 0.02) -> bool:
        return bool(np.all(np.abs(
            self.state.density_ema - self._target) <= tol))

    def report(self) -> dict:
        """Summary for throughput reports (the reference's keys)."""
        s = self.state
        rep = {
            "steps": s.steps,
            "audits": s.audits,
            "native_fn": self.native_fn,
            "target_density": self.cfg.target_density,
            "mean_realized_density": float(s.density_ema.mean()),
            "mean_false_neg": float(s.fn_ema.mean()),
            "mean_overflow": float(s.overflow_ema.mean()),
            "mean_union_demand": (float(s.union_ema.mean())
                                  if s.union_ema is not None else None),
            "prefill_chunks": self.prefill_chunks,
            "mean_prefill_density": float(self.prefill_ema.mean()),
            "converged_2pct": self.converged(0.02),
        }
        if self.tiers:
            rep["tiers"] = {
                t.name: {
                    "target_density": t.target(self.cfg.target_density),
                    "realized_density": float(s.density_ema[i].mean()),
                    "alpha_per_layer": [round(float(v), 4)
                                        for v in s.alphas[i]],
                    "density_per_layer": [round(float(v), 4)
                                          for v in s.density_ema[i]],
                    "false_neg": float(s.fn_ema[i].mean()),
                }
                for i, t in enumerate(self.tiers)
            }
        else:
            rep["density_per_layer"] = [round(float(v), 4)
                                        for v in s.density_ema]
            rep["alpha_per_layer"] = [round(float(v), 4) for v in s.alphas]
        return rep

    @property
    def trajectory(self) -> list[dict]:
        return list(self._trajectory)

    def publish_metrics(self, hub) -> None:
        """Write the controller's state into a ``runtime.metrics.MetricsHub``
        as gauges: per tier realized and predicted density and false-negative
        rate, per layer alpha and density (tier-labelled when tiered), and
        progress.  Host values only; no-op on a disabled hub."""
        if not getattr(hub, "enabled", False):
            return
        s = self.state
        hub.set_gauge("controller_steps", s.steps)
        hub.set_gauge("controller_audits", s.audits)
        hub.set_gauge("prefill_chunks", self.prefill_chunks)
        hub.set_gauge("prefill_density", float(self.prefill_ema.mean()))
        if self.tiers:
            for i, t in enumerate(self.tiers):
                lt = {"tier": t.name}
                hub.set_gauge("tier_target_density",
                              t.target(self.cfg.target_density), **lt)
                hub.set_gauge("tier_realized_density",
                              float(s.density_ema[i].mean()), **lt)
                hub.set_gauge("tier_predicted_density",
                              float(s.predicted_ema[i].mean()), **lt)
                hub.set_gauge("tier_fn_rate",
                              float(s.fn_ema[i].mean()), **lt)
                hub.set_gauge("tier_overflow",
                              float(s.overflow_ema[i].mean()), **lt)
                for layer in range(self.num_layers):
                    hub.set_gauge("alpha", float(s.alphas[i, layer]),
                                  layer=layer, **lt)
                    hub.set_gauge("layer_density",
                                  float(s.density_ema[i, layer]),
                                  layer=layer, **lt)
        else:
            hub.set_gauge("realized_density", float(s.density_ema.mean()))
            hub.set_gauge("predicted_density",
                          float(s.predicted_ema.mean()))
            hub.set_gauge("fn_rate", float(s.fn_ema.mean()))
            hub.set_gauge("overflow", float(s.overflow_ema.mean()))
            for layer in range(self.num_layers):
                hub.set_gauge("alpha", float(s.alphas[layer]), layer=layer)
                hub.set_gauge("layer_density",
                              float(s.density_ema[layer]), layer=layer)

    # -------------------------------------------------------- persistence --
    def state_dict(self) -> tuple[dict, dict]:
        """(array tree, scalar meta): the reference's snapshot layout, with
        the shape-defining config in the meta."""
        s = self.state
        tree = {
            "alphas": s.alphas,
            "density_ema": s.density_ema,
            "overflow_ema": s.overflow_ema,
            "fn_ema": s.fn_ema,
            "predicted_ema": s.predicted_ema,
            "union_ema": (s.union_ema if s.union_ema is not None
                          else s.density_ema + s.overflow_ema),
        }
        meta = {
            "steps": int(s.steps),
            "audits": int(s.audits),
            "num_layers": int(self.num_layers),
            "native_fn": bool(self.native_fn),
            "tiers": [t.name for t in self.tiers] if self.tiers else [],
            "prefill_chunks": int(self.prefill_chunks),
            "prefill_ema": np.asarray(self.prefill_ema,
                                      np.float32).tolist(),
        }
        return tree, meta

    def load_state_dict(self, tree: dict, meta: dict) -> None:
        """Restore a :meth:`state_dict` snapshot; a snapshot of another
        tier set, depth or ``native_fn`` mode is rejected."""
        tiers = [t.name for t in self.tiers] if self.tiers else []
        if list(meta.get("tiers", [])) != tiers:
            raise ValueError(
                f"controller checkpoint tier mismatch: saved "
                f"{meta.get('tiers')} vs configured {tiers}")
        if int(meta.get("num_layers", self.num_layers)) != self.num_layers:
            raise ValueError(
                f"controller checkpoint layer-count mismatch: saved "
                f"{meta.get('num_layers')} vs configured {self.num_layers}")
        if bool(meta.get("native_fn", self.native_fn)) != self.native_fn:
            # the false-negative EMA is on another scale in the other mode
            raise ValueError(
                f"controller checkpoint native_fn mismatch: saved "
                f"{meta.get('native_fn')} vs configured {self.native_fn}")
        s = self.state
        for name in ("alphas", "density_ema", "overflow_ema", "fn_ema",
                     "predicted_ema", "union_ema"):
            arr = np.asarray(tree[name], np.float32)
            if arr.shape != s.alphas.shape:
                raise ValueError(
                    f"controller checkpoint shape mismatch at {name}: "
                    f"{arr.shape} vs {s.alphas.shape}")
            setattr(s, name, arr)
        s.steps = int(meta.get("steps", 0))
        s.audits = int(meta.get("audits", 0))
        pe = meta.get("prefill_ema")
        if pe is not None:
            arr = np.asarray(pe, np.float32)
            if arr.shape == s.alphas.shape:
                self.prefill_ema = arr
        self.prefill_chunks = int(meta.get("prefill_chunks", 0))


def remap_shard_ema(ema: np.ndarray, ms_new: int) -> np.ndarray:
    """Per-(layer, shard) EMAs of an ``ms_old``-way split carried onto
    ``ms_new`` model shards (a restart on another grid).  Shard s of the
    old split owns the neuron tile [s/ms_old, (s+1)/ms_old) of a layer;
    new shard t gets the overlap-weighted mean of the old tiles it covers,
    which keeps each layer's mean across shards."""
    ema = np.asarray(ema, np.float32)
    ms_old = ema.shape[-1]
    if ms_old == ms_new:
        return ema.copy()
    # w[t, s] = |tile_t_new & tile_s_old| / |tile_t_new|: rows sum to 1
    lo_new = np.arange(ms_new, dtype=np.float64)[:, None] / ms_new
    hi_new = lo_new + 1.0 / ms_new
    lo_old = np.arange(ms_old, dtype=np.float64)[None, :] / ms_old
    hi_old = lo_old + 1.0 / ms_old
    overlap = np.clip(np.minimum(hi_new, hi_old)
                      - np.maximum(lo_new, lo_old), 0.0, None)
    w = (overlap * ms_new).astype(np.float32)            # (ms_new, ms_old)
    return np.einsum("ls,ts->lt", ema, w)


class DistributedController:
    """:class:`AlphaController` for a tensor-sharded config.

    The sharded strategies reduce their telemetry to the (L, B)
    ``MLP_STAT_KEYS`` the inner controller takes, and add two riders
    (``core.sparse_mlp.SHARD_RIDER_KEYS``, (L, B, ms) a step): each
    shard's realized density and its union's selection demand.  This
    wrapper pops them before the per-tier or batch aggregation sees the
    stats, keeps per-(layer, shard) EMAs of both, and feeds two readers:
    ``shard_skew`` (a hot neuron block concentrating demand on one shard)
    and ``shard_capacity_hints`` (each shard's rung of the per-shard bucket
    ladder, sized to its own union demand).  It records the (data, model)
    grid it served; a snapshot of another grid is remapped
    (:func:`remap_shard_ema`), not rejected.  Everything else is the inner
    controller's."""

    def __init__(self, inner: AlphaController, n_shards: int,
                 n_data_shards: int = 1):
        self.inner = inner
        self.n_shards = int(n_shards)
        self.n_data_shards = int(n_data_shards)
        self.shard_density_ema = np.zeros(
            (inner.num_layers, self.n_shards), np.float32)
        self.shard_union_ema = np.zeros(
            (inner.num_layers, self.n_shards), np.float32)
        self._shard_steps = 0
        self.stats_regrids = 0   # snapshots of another grid absorbed

    def __getattr__(self, name):
        # only reached for names this wrapper lacks: the inner controller's
        return getattr(self.inner, name)

    def consume_shard_stats(self, stats: dict,
                            active: Optional[np.ndarray] = None,
                            fold: bool = True) -> dict:
        """Pop the riders from a decode step's stats, fold them into the
        shard EMAs over the live slots, and return the (L, B) rest.
        ``fold=False`` only strips them (audit steps: the masked path's
        realized densities are on another scale than the serving
        strategy's)."""
        if SHARD_STAT_KEY not in stats:
            return stats
        stats = dict(stats)
        riders = {k: np.asarray(stats.pop(k), np.float32)
                  for k in SHARD_RIDER_KEYS if k in stats}
        if not fold:
            return stats
        for k, v in riders.items():
            if v.ndim != 3 or v.shape[-1] != self.n_shards:
                raise ValueError(
                    f"per-shard telemetry {k} shape {v.shape} != "
                    f"(L, B, {self.n_shards})")
        if active is not None:
            sel = np.asarray(active, bool)
            if not sel.any():
                return stats
            riders = {k: v[:, sel] for k, v in riders.items()}
        beta = np.float32(self.inner.cfg.ema)

        def fold_ema(prev, v):
            obs = v.mean(axis=1)                              # (L, ms)
            if self._shard_steps == 0:
                return obs
            return (1 - beta) * prev + beta * obs

        self.shard_density_ema = fold_ema(self.shard_density_ema,
                                          riders[SHARD_STAT_KEY])
        union = riders.get(SHARD_UNION_KEY)
        if union is not None:
            self.shard_union_ema = fold_ema(self.shard_union_ema, union)
        self._shard_steps += 1
        return stats

    def shard_capacity_hints(self, k: int) -> np.ndarray:
        """(ms,) local capacities in neurons: each shard's union demand
        (the largest over layers of its EMA, a fraction of its k/ms rows)
        times ``shard_slack``.  The server rounds them up to ladder rungs
        between decode steps."""
        k_local = k // self.n_shards
        slack = float(getattr(self.inner.cfg, "shard_slack", 1.3))
        demand = np.clip(self.shard_union_ema.max(axis=0) * slack, 0.0, 1.0)
        return np.maximum(1, np.ceil(demand * k_local)).astype(np.int64)

    def shard_skew(self) -> dict:
        """Per-layer imbalance of realized density across the model shards:
        (max - min) / mean (0 = balanced)."""
        e = self.shard_density_ema
        spread = e.max(-1) - e.min(-1)
        mean = np.maximum(e.mean(-1), 1e-9)
        return {
            "per_layer_skew": [round(float(v), 4) for v in spread / mean],
            "max_skew": float((spread / mean).max()),
            "mean_shard_density": [round(float(v), 4) for v in e.mean(0)],
            "mean_shard_union_demand": [round(float(v), 4)
                                        for v in self.shard_union_ema
                                        .mean(0)],
        }

    def report(self) -> dict:
        rep = self.inner.report()
        rep["n_shards"] = self.n_shards
        rep["n_data_shards"] = self.n_data_shards
        rep["shard_skew"] = self.shard_skew()
        return rep

    def publish_metrics(self, hub) -> None:
        """The inner controller's gauges and the sharded ones: realized
        density and union demand per (layer, shard), and the largest
        skew."""
        if not getattr(hub, "enabled", False):
            return
        self.inner.publish_metrics(hub)
        from repro_torch.runtime.distributed import shard_gauge_rows
        for layer, shard, dens, union in shard_gauge_rows(
                self.shard_density_ema, self.shard_union_ema):
            hub.set_gauge("shard_density", dens, layer=layer, shard=shard)
            if union is not None:
                hub.set_gauge("shard_union_demand", union,
                              layer=layer, shard=shard)
        hub.set_gauge("shard_max_skew", self.shard_skew()["max_skew"])

    def state_dict(self) -> tuple[dict, dict]:
        tree, meta = self.inner.state_dict()
        tree = dict(tree, shard_density_ema=self.shard_density_ema,
                    shard_union_ema=self.shard_union_ema)
        meta = dict(meta, n_shards=self.n_shards,
                    n_data_shards=self.n_data_shards,
                    shard_steps=self._shard_steps)
        return tree, meta

    def load_state_dict(self, tree: dict, meta: dict) -> None:
        """Restore a :meth:`state_dict` snapshot.  One of another (data,
        model) grid has its shard EMAs remapped onto this one (the inner
        state does not depend on the grid) and counts in
        ``stats_regrids``."""
        saved_ms = int(meta.get("n_shards", self.n_shards))
        saved_ds = int(meta.get("n_data_shards", self.n_data_shards))
        regrid = (saved_ms, saved_ds) != (self.n_shards, self.n_data_shards)
        tree = dict(tree)
        shard_ema = tree.pop("shard_density_ema", None)
        union_ema = tree.pop("shard_union_ema", None)
        self.inner.load_state_dict(tree, meta)
        for name, arr in (("shard_density_ema", shard_ema),
                          ("shard_union_ema", union_ema)):
            if arr is None:
                continue
            arr = np.asarray(arr, np.float32)
            if arr.shape != (self.inner.num_layers, saved_ms):
                raise ValueError(
                    f"controller checkpoint {name} shape {arr.shape} != "
                    f"({self.inner.num_layers}, {saved_ms})")
            setattr(self, name, remap_shard_ema(arr, self.n_shards))
        if regrid:
            warnings.warn(
                "controller snapshot of (data, model) grid "
                f"{(saved_ds, saved_ms)} remapped onto "
                f"{(self.n_data_shards, self.n_shards)}", stacklevel=2)
            self.stats_regrids += 1
        self._shard_steps = int(meta.get("shard_steps", 0))
