"""Serving runtime: prefill + decode with KV caches and the slot-refill
continuous batching scheduler — counterpart of ``repro/runtime/server.py``.

Each batch index is a slot holding one request at its own sequence
position; when a request finishes its slot is refilled from the queue
between decode steps (a batch-1 prefill at the prompt's natural length,
copied into the slot).  Each request's SLA tier adds a per-slot alpha
offset to the per-layer schedule; dead slots get ``DEAD_SLOT_ALPHA`` so they
drop out of the batch-union selection.

With ``ServeConfig.prefill_chunk`` a refilled slot goes pending instead: its
prompt, zero-padded to whole chunks, streams through ``prefill_chunk`` into
batch-1 scratch caches, at most ``prefill_interleave`` chunks per loop
iteration between decode steps.  A pending slot is dead in the decode union;
the last chunk's logits give its first token and the scratch is copied in.

With ``ServeConfig.paged_kv`` the per-slot ``max_len`` caches give way to
one block pool per layer and per-slot block tables (``runtime/kv_pool.py``
keeps the host books).  A finished prefill is written into blocks the slot
owns; the decode step writes each slot's new K/V into its table's block
and attends its pages (the paged-attention kernels with
``ModelConfig.paged_attn_kernel`` and a float pool).  When a slot retires,
its full prompt blocks are committed to a prefix trie, and with a
``Request.session_id`` its whole chain is kept.  A chunked admission whose
prompt starts with committed blocks, or extends its session's history,
admits those by reference: its scratch is seeded from the pool and the
chunks they cover are skipped.  The session's SLA tier sticks across
turns.  The pool persists across ``serve()`` calls.

With ``ServeConfig.controller`` enabled (and a sparse strategy) the
adaptive-alpha controller (``runtime/controller.py``) owns the alphas: each
decode step returns its (L, B) MLP telemetry, which the controller folds in
between steps (per SLA tier with ``per_tier``).  Every ``audit_period``-th
step runs the masked strategy, whose full gate gives exact false negatives
(not under pallas, whose kernels report a proxy every step).  With
``SparseInferConfig.capacity_buckets`` (gather, pallas) the controller's
union-demand hint picks a rung of the capacity ladder between steps;
``adapt_capacity`` without a ladder re-sizes the capacity at refill
boundaries.  Sparse prefill chunks feed the controller's prefill rider.

Overload handling, as the reference's.  ``max_queue_depth`` sheds the
excess of a queue up front; a request past its deadline (``deadline_s``, or
``default_deadline_s``) sheds with what it emitted, queued, mid-prefill or
resident.  With ``preempt`` (paged pool) an exhausted pool parks the
lowest-priority resident request (tier priority, then fewest emitted
tokens, then slot index): its prompt blocks stay in the trie, so its resume
admits them by reference, and it requeues; past ``max_preemptions`` it
sheds.  A queue head that has waited half its deadline parks a
strictly-lower-tier resident the same way.  ``pressure_gate`` defers
admissions while the pool's pressure is at or above it.  Without
``preempt`` an exhausted pool raises ``PoolExhausted``.  A
``runtime.faults.FaultInjector`` (``attach_faults``) arms fault points
(``prefill`` sheds its request, ``decode`` aborts the serve, which resets
the server) and can replace the clock with a virtual one that ticks once a
scheduler-loop iteration, so every overload decision is a function of
scheduling alone.

``ServeConfig.metrics`` enables the metrics hub (``runtime/metrics.py``):
spans for admission, prefill, prefill chunks, the decode step and the
controller update, events for every admission, first token, completion,
shed, preemption and bucket switch, and the controller's and pool's gauges
every ``cadence`` decode steps.  Spans close only where the loop already
waits for the card (the decode step after its tokens are read, a
monolithic prefill after its first token), so a prefill chunk's span is its
host enqueue time.

A sharded config (``SparseInferConfig.tp_shards``/``dp_shards``) decodes
through the shard-local selections of ``runtime/distributed.py`` on the
one device; its prefill stays dense.  The controller is then a
``DistributedController``, and with a capacity ladder each model shard
picks its own rung from its own union demand: the ladder's keys are bucket
tuples, the full ``len(ladder) ** tp_shards`` product when that is at most
``ControllerConfig.bucket_tuple_cap``, else one rung shared by every shard.
Every tuple's local shapes are checked against the kernels' plans at
construction and as it activates.

Not ported yet: controller checkpoints, and placing a shard grid on
several devices (the reference's ``mesh``).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (DEFAULT_SLA_TIERS, ControllerConfig,
                                      MetricsConfig, ModelConfig,
                                      PagedKVConfig)
from repro_torch.core.predictor import packed_width
from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import predict as KP
from repro_torch.kernels import sparse_mlp_fused as KF
from repro_torch.models.common import greedy_sample
from repro_torch.runtime.controller import (TRAJECTORY_KEEP,
                                            AlphaController,
                                            DistributedController,
                                            aggregate_tier_stats)
from repro_torch.runtime.faults import InjectedFault
from repro_torch.runtime.kv_pool import KVPool, PoolExhausted
from repro_torch.runtime.metrics import MetricsHub, note_first_use
from repro_torch.sharding import sparse as SSP

# SMs of the card the shard-grid checks plan for (an H100's); the shapes a
# kernel refuses do not depend on it
_PLAN_SMS = 132


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    max_len: int = 256
    max_new_tokens: int = 32
    greedy: bool = True
    # slot-refill continuous batching; the reference's legacy chunked
    # scheduler (False) is not ported
    slot_refill: bool = True
    sla_tiers: tuple = DEFAULT_SLA_TIERS
    # the online adaptive-alpha controller; off, the static schedule (plus
    # tier offsets) decodes every step
    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig)
    # run every capacity bucket's decode step once, on copies of the
    # caches, before the first controller step, so the first bucket switch
    # meets no first-use cost
    warm_buckets: bool = False
    # fixed prefill chunk in tokens; 0 = monolithic batch-1 prefill.  Must
    # divide max_len
    prefill_chunk: int = 0
    # at most this many prefill chunks per decode-loop iteration (the
    # TTFT-vs-inter-token-latency knob)
    prefill_interleave: int = 1
    # paged KV pool with prefix reuse and sessions; None keeps the dense
    # per-slot caches.  block_size must divide max_len, and prefill_chunk
    # must be a multiple of it
    paged_kv: Optional[PagedKVConfig] = None
    # ---- overload handling
    # serve() takes at most this many requests; the rest shed up front
    # ("queue_depth").  0 = unbounded
    max_queue_depth: int = 0
    # Request.deadline_s of requests that set none (0 = no deadline)
    default_deadline_s: float = 0.0
    # tier-aware preemption on pool exhaustion and deadline pressure (needs
    # paged_kv); off, an exhausted pool raises PoolExhausted
    preempt: bool = False
    # KVPool.pressure() at or above which refills defer while anything is
    # resident; 1.0 disables the gate
    pressure_gate: float = 1.0
    # preemptions a request takes before it sheds ("pool") instead
    max_preemptions: int = 4
    # the metrics hub; disabled (the default) it is a no-op and the serve is
    # bitwise the metrics-free one
    metrics: MetricsConfig = dataclasses.field(default_factory=MetricsConfig)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new: int = 32
    sla: str = "balanced"        # ServeConfig.sla_tiers entry
    session_id: Optional[str] = None  # paged serving: keep this request's
                                 # KV chain under the id; a later request
                                 # with the same id whose prompt extends the
                                 # history admits by reference and takes
                                 # the session's SLA tier
    out: Optional[np.ndarray] = None
    latency_s: float = 0.0       # admission -> last token (incl. queue wait)
    t_admit: float = 0.0         # Server._now() at admission (serve() entry)
    t_start: float = 0.0         # Server._now() at dequeue
    t_end: float = 0.0           # Server._now() at completion
    queue_wait_s: float = 0.0    # admission -> dequeue
    ttft_s: float = 0.0          # admission -> first token
    deadline_s: float = 0.0      # deadline after admission (0 = none; unset,
                                 # ServeConfig.default_deadline_s fills it)
    outcome: str = ""            # "completed" | "shed" ("" = never served)
    shed_reason: str = ""        # of a shed: "deadline" | "pool" |
                                 # "queue_depth" | "fault"
    preemptions: int = 0         # times parked and requeued


def _splice_slot(full: dict, one: dict, slot: int) -> None:
    """Copy a batch-1 cache tree into batch slot ``slot`` of a full-batch
    cache tree, in place (the reference returns an updated copy)."""
    for f, o in zip(full["blocks"], one["blocks"]):
        for name, buf in f.items():
            buf[slot:slot + 1].copy_(o[name])


def _clone_caches(caches: dict) -> dict:
    return {"blocks": [{name: buf.clone() for name, buf in layer.items()}
                       for layer in caches["blocks"]]}


def _seed_scratch(pool: dict, seed: torch.Tensor) -> dict:
    """A batch-1 scratch cache gathered from the pool by ``seed`` (nbps,):
    adopted blocks, and the NULL block (zeros) on every other lane, which
    reads exactly like a freshly zeroed cache."""
    return {"blocks": [{name: buf[seed].reshape((1, -1) + buf.shape[2:])
                        for name, buf in layer.items()}
                       for layer in pool["blocks"]]}


def _commit_owned(pool: dict, one: dict, owned: torch.Tensor,
                  nb_re: int) -> None:
    """Write a finished batch-1 prefill's sequence blocks nb_re.. into the
    pool blocks ``owned`` (ids the slot owns, distinct), in place.  Adopted
    blocks below nb_re are left as they are, and nothing else is written:
    not the NULL block, not the write-off block."""
    n = owned.numel()
    for f, o in zip(pool["blocks"], one["blocks"]):
        for name, buf in f.items():
            src = o[name][0].reshape((-1,) + buf.shape[1:])
            buf[owned] = src[nb_re:nb_re + n].to(buf.dtype)


class Server:
    """Slot-refill continuous batching over a model module (``models.lm``).

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to serve on the CPU with the plain kernel versions."""

    def __init__(self, model_mod, cfg: ModelConfig, scfg: ServeConfig,
                 params: dict, device="cuda"):
        self.device = resolve_device(device)
        self._grids_checked: set = set()   # (bucket, shard) plans asked
        if scfg.prefill_chunk:
            if scfg.prefill_chunk < 1 or scfg.max_len % scfg.prefill_chunk:
                raise ValueError(
                    f"prefill_chunk={scfg.prefill_chunk} must be positive "
                    f"and divide max_len={scfg.max_len} (so every padded "
                    "prompt fits the cache)")
            if scfg.prefill_interleave < 1:
                raise ValueError(
                    f"prefill_interleave={scfg.prefill_interleave} must be "
                    ">= 1 (chunks per decode-loop iteration)")
            if cfg.family not in model_mod.CHUNK_PREFILL_FAMILIES:
                raise NotImplementedError(
                    f"family {cfg.family!r} has no chunked prefill")
        if scfg.preempt and scfg.paged_kv is None:
            raise ValueError(
                "ServeConfig.preempt needs the paged KV pool (paged_kv): "
                "preemption parks the victim's block chain in the prefix "
                "trie so its resume admits by reference")
        if not 0.0 < scfg.pressure_gate <= 1.0:
            raise ValueError(
                f"pressure_gate={scfg.pressure_gate} must be in (0, 1]")
        if scfg.max_queue_depth < 0 or scfg.default_deadline_s < 0.0 \
                or scfg.max_preemptions < 1:
            raise ValueError(
                "max_queue_depth/default_deadline_s must be >= 0 and "
                f"max_preemptions >= 1; got {scfg.max_queue_depth}/"
                f"{scfg.default_deadline_s}/{scfg.max_preemptions}")
        pk = scfg.paged_kv
        if pk is not None:
            pfams = getattr(model_mod, "PAGED_KV_FAMILIES", ())
            if cfg.family not in pfams:
                raise ValueError(
                    f"paged_kv: family {cfg.family!r} has no paged decode "
                    f"path (supported: {pfams})")
            if pk.block_size < 1 or scfg.max_len % pk.block_size:
                raise ValueError(
                    f"paged_kv.block_size={pk.block_size} must be positive "
                    f"and divide max_len={scfg.max_len}")
            if scfg.prefill_chunk and scfg.prefill_chunk % pk.block_size:
                raise ValueError(
                    f"prefill_chunk={scfg.prefill_chunk} must be a multiple "
                    f"of paged_kv.block_size={pk.block_size} so trie-aligned "
                    "reuse lands on chunk boundaries")
        if not scfg.slot_refill:
            raise NotImplementedError(
                "the legacy chunked scheduler is not ported; use "
                "slot_refill=True")
        if not scfg.greedy:
            raise NotImplementedError("only greedy decoding is ported")
        if cfg.sparse.enabled and (cfg.sparse.tp_shards
                                   or cfg.sparse.dp_shards):
            # the grid must take the batch, and every shard whole row
            # groups, int8 quant groups and ladder rungs
            _, ms = SSP.resolve_grid(cfg.sparse, scfg.batch)
            SSP.validate_shardable(cfg.sparse, cfg.d_ff, ms)
        self.mod = model_mod
        self.cfg = cfg
        self.scfg = scfg
        self.params = (model_mod.prepare_sparse(params, cfg.sparse)
                       if cfg.sparse.enabled else params)
        self._tier_index = {t.name: i for i, t in enumerate(scfg.sla_tiers)}
        self._tier_offsets = np.asarray(
            [t.alpha_offset for t in scfg.sla_tiers], np.float32)
        self.decode_steps = 0        # decode steps run (all serve calls)
        self.prefill_chunks_run = 0       # admission chunks run
        self.prefill_chunks_skipped = 0   # chunks saved by prefix reuse
                                          # (paged KV pool only)
        self.kv_pool: Optional[KVPool] = None
        self._pool: Optional[dict] = None
        # ---- overload accounting and fault injection
        self.faults = None                # runtime.faults.FaultInjector
        self.preempt_count = 0            # victims parked and requeued
        self.shed_count = 0               # terminal sheds, every reason
        self.admissions_deferred = 0      # refills held back by the gate
        # the hub reads the scheduler's clock: wall time until
        # attach_faults binds the injector's.  Not ``self._now``: a bound
        # method would make server and hub a reference cycle, which keeps
        # the weights on the card until the cycle collector runs
        self.metrics = MetricsHub(scfg.metrics)
        if pk is not None:
            self._nbps = scfg.max_len // pk.block_size
            self._init_paged_state()
        # ---- the adaptive-alpha controller; it lives across serve() and
        # generate() calls, so adaptation carries over between requests
        self.controller: Optional[AlphaController] = None
        self.warmup_steps = 0        # decode steps run by warm_buckets
        if cfg.sparse.capacity_buckets and not (scfg.controller.enabled
                                                and cfg.sparse.enabled):
            warnings.warn(
                "SparseInferConfig.capacity_buckets set but the controller "
                "is disabled: the bucket ladder needs capacity_hint to pick "
                "buckets; decoding uses the static capacity_frac",
                stacklevel=2)
        if scfg.controller.enabled and cfg.sparse.enabled:
            self._build_controller_fns()
        if cfg.sparse.enabled and cfg.sparse.tp_shards \
                and cfg.sparse.strategy == "pallas":
            # the static capacity's shard grid; a ladder's tuples are
            # checked as they activate
            self._check_shard_grids(
                (cfg.sparse.shard_capacity(cfg.d_ff),) * cfg.sparse.tp_shards)
        self._init_controller_state()
        self._cfg0 = self.cfg          # reset() restores it

    def _init_paged_state(self) -> None:
        """Fresh host pool manager and zeroed device block pool."""
        pk = self.scfg.paged_kv
        n_blocks = (pk.pool_blocks
                    or self.scfg.batch * self._nbps + KVPool._RESERVED)
        self.kv_pool = KVPool(n_blocks, pk.block_size,
                              max_sessions=pk.max_sessions,
                              prefix_cache=pk.prefix_cache)
        self._pool = self.mod.init_kv_pool(self.cfg, n_blocks, pk.block_size,
                                           self.device)

    def reset(self) -> None:
        """Restore the cross-serve state (controller, capacity bucket, KV
        pool, admission and overload counters) to its fresh-construction
        value, so the next serve() is a new server's.  serve() calls it
        when the scheduler raises.  The hub's instruments are cumulative
        across serves, as the reference's; its sinks are flushed, so what
        the aborted serve recorded reaches its files."""
        if self.cfg is not self._cfg0:
            # maybe_adapt_capacity moved the capacity mid-serve
            self.cfg = self._cfg0
            self._build_controller_fns()
        self._init_controller_state()
        if self.scfg.paged_kv is not None:
            self._init_paged_state()
        self.prefill_chunks_run = 0
        self.prefill_chunks_skipped = 0
        self.preempt_count = 0
        self.shed_count = 0
        self.admissions_deferred = 0
        self.metrics.flush()

    # ------------------------------------------------------ fault plumbing --
    def attach_faults(self, injector) -> None:
        """Install a ``runtime.faults.FaultInjector``: its armed points fire
        through ``_fault``, and with ``virtual_clock`` every time the
        scheduler reads (deadlines, stamps, queue waits, the hub's spans and
        events) is ``injector.now()``, advanced one tick per loop
        iteration."""
        self.faults = injector
        self.metrics.bind_clock(injector.time_source())

    def _now(self) -> float:
        f = self.faults
        if f is not None and f.virtual_clock:
            return f.now()
        return time.perf_counter()

    def _tick(self) -> None:
        f = self.faults
        if f is not None and f.virtual_clock:
            f.tick()

    def _fault(self, point: str, uid: Optional[int] = None) -> None:
        if self.faults is not None:
            self.faults.check(point, uid)

    # -------------------------------------------------------- observability --
    def publish_gauges(self) -> None:
        """Refresh the hub's gauge families from host state: the
        controller's per-tier and per-layer alphas and densities, the pool's
        occupancy, pressure and counters, and the active capacity bucket
        with its share of d_ff.  Host values the loop already holds: no
        sync.  The scheduler calls it every ``MetricsConfig.cadence`` decode
        steps and at each drain."""
        hub = self.metrics
        if not hub.enabled:
            return
        if self.controller is not None:
            self.controller.publish_metrics(hub)
        if self.kv_pool is not None:
            self.kv_pool.publish_metrics(hub)
        hub.set_gauge("admissions_deferred", self.admissions_deferred)
        cap = getattr(self, "_active_cap", None)
        g = self.cfg.sparse.group_size
        if isinstance(cap, tuple):
            k_local = self.cfg.d_ff // max(1, len(cap))
            for s, c in enumerate(cap):
                hub.set_gauge("capacity_bucket_groups", int(c), shard=s)
                hub.set_gauge("bucket_occupancy",
                              min(1.0, int(c) * g / max(1, k_local)),
                              shard=s)
        elif cap:
            hub.set_gauge("capacity_bucket_groups", int(cap))
            hub.set_gauge("bucket_occupancy",
                          min(1.0, int(cap) * g / self.cfg.d_ff))

    def _serve_epilogue(self) -> None:
        """After a drain: refresh the gauges, record the drain, arm the
        first-use watchdog (by the end of the first drain everything this
        configuration uses has been built and used once) and flush the
        sinks."""
        hub = self.metrics
        if not hub.enabled:
            return
        self.publish_gauges()
        hub.event("serve_end",
                  completed=int(hub.counter_value("requests_completed")),
                  shed=self.shed_count, preemptions=self.preempt_count,
                  retraces_post_warmup=hub.watchdog.retraces_post_warmup)
        if self.scfg.metrics.watchdog:
            hub.watchdog.arm()
        hub.flush()

    def metrics_report(self) -> dict:
        """The hub's snapshot and the watchdog's state, for reports."""
        hub = self.metrics
        rep: dict = {"enabled": hub.enabled,
                     "watchdog": hub.watchdog.report()}
        if hub.enabled:
            rep["snapshot"] = hub.snapshot()
            rep["events"] = len(hub.events())
            rep["trace_events"] = len(hub.trace_events()["traceEvents"])
        return rep

    # ------------------------------------------------------- controller ---
    def _build_controller_fns(self) -> None:
        """The controller's decode configurations against the current
        ``self.cfg``: one per capacity bucket of a ``capacity_buckets``
        ladder (gather, pallas), else one, plus the audit configuration
        (strategy masked).  A tensor-sharded config keys its buckets by
        tuples of per-shard local rungs: all ``len(ladder) ** tp_shards``
        of them when that is at most ``bucket_tuple_cap``, else the uniform
        ones (with a warning).  Switching buckets between decode steps is
        a dict lookup.  ``_trace_counts`` counts, per bucket, its first
        decode step and every later one during which a kernel library had
        to be built or loaded: the CUDA kernels take every shape without a
        rebuild, so after warmup each bucket stays at 1."""
        cfg = self.cfg
        self._trace_counts: collections.Counter = collections.Counter()
        self._bucket_cfgs: dict = {}
        self._warmed_buckets = False
        self._local_ladder: tuple = ()
        self._per_shard_buckets = False
        ms = max(1, cfg.sparse.tp_shards or 1)
        if (cfg.sparse.capacity_buckets
                and cfg.sparse.strategy in ("gather", "pallas")
                and cfg.sparse.tp_shards):
            # (every rung splits evenly over the shards: checked at
            # construction)
            sc = self.scfg.controller
            local = tuple(capg // ms
                          for capg in cfg.sparse.capacity_ladder(cfg.d_ff))
            self._local_ladder = local
            n_tuples = len(local) ** ms
            self._per_shard_buckets = (sc.per_shard_buckets
                                       and n_tuples <= sc.bucket_tuple_cap)
            if sc.per_shard_buckets and not self._per_shard_buckets:
                warnings.warn(
                    f"per-shard bucket ladder would need {n_tuples} "
                    f"configurations (len(ladder)={len(local)} ** "
                    f"tp_shards={ms}) > bucket_tuple_cap="
                    f"{sc.bucket_tuple_cap}: falling back to uniform bucket "
                    "tuples (every shard shares one ladder rung); shrink "
                    "the ladder or raise the cap", stacklevel=2)
            tuples = (itertools.product(local, repeat=ms)
                      if self._per_shard_buckets
                      else [(c,) * ms for c in local])
            for t in map(tuple, tuples):
                self._bucket_cfgs[t] = cfg.replace(
                    sparse=dataclasses.replace(
                        cfg.sparse, capacity_override=max(t) * ms,
                        shard_bucket_caps=t))
            self._active_cap = (max(local),) * ms     # start the widest
            self._check_shard_grids(self._active_cap)
        elif cfg.sparse.capacity_buckets and cfg.sparse.strategy in (
                "gather", "pallas"):
            for capg in cfg.sparse.capacity_ladder(cfg.d_ff):
                self._bucket_cfgs[capg] = cfg.replace(
                    sparse=dataclasses.replace(cfg.sparse,
                                               capacity_override=capg))
            self._active_cap = max(self._bucket_cfgs)   # start the widest
        else:
            if cfg.sparse.capacity_buckets:
                warnings.warn(
                    "SparseInferConfig.capacity_buckets set but strategy="
                    f"{cfg.sparse.strategy!r} has no capacity selection: "
                    "the ladder applies to gather/pallas only; decoding "
                    "runs without buckets", stacklevel=2)
            self._bucket_cfgs[0] = cfg
            self._active_cap = 0
        self._initial_cap = self._active_cap
        self._audit_cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, strategy="masked"))

    def _init_controller_state(self) -> None:
        """A fresh controller (construction and :meth:`reset` share it).
        Under pallas its kernels report false negatives every step
        (``native_fn``): no audit steps."""
        cfg, scfg = self.cfg, self.scfg
        if not (scfg.controller.enabled and cfg.sparse.enabled):
            self.controller = None
            return
        tiers = scfg.sla_tiers if scfg.controller.per_tier else None
        # one alpha per layer: the dense family, the only one ported
        ctl = AlphaController(
            scfg.controller, cfg.sparse.alpha_schedule(), cfg.n_layers,
            tiers=tiers, native_fn=cfg.sparse.strategy == "pallas")
        if cfg.sparse.tp_shards:
            # the sharded strategies' per-shard riders: skew, per-shard
            # bucket hints, and stripped before the aggregation
            ctl = DistributedController(
                ctl, cfg.sparse.tp_shards,
                n_data_shards=max(1, cfg.sparse.dp_shards or 1))
        self.controller = ctl
        self._active_cap = self._initial_cap
        # the active bucket of every controller decode step
        self.bucket_history: collections.deque = collections.deque(
            maxlen=TRAJECTORY_KEEP)

    def _count_setup(self, key, loaded_before: int) -> None:
        new = key not in self._trace_counts
        loaded = build.n_loaded() > loaded_before
        if new or loaded:
            self._trace_counts[key] += 1
        if new and not loaded:    # a library load reports itself
            note_first_use(f"capacity bucket {key}")

    @staticmethod
    def _pick_rung(ladder: tuple, need: int) -> int:
        """The smallest rung of a sorted ladder covering ``need`` groups
        (the widest if none does)."""
        for rung in ladder:
            if rung >= need:
                return rung
        return ladder[-1]

    def _check_shard_grids(self, caps: tuple) -> None:
        """Ask the kernels' plans for each model shard's local shape under
        the bucket tuple ``caps`` (strategy pallas): the predictor's at
        (B/ds, d/32 words, k/ms rows, G) and the fused MLP's at (B/ds, d,
        C_l*G rows).  The port has no fallback kernel, so a shape they
        refuse raises here, once per (bucket, shard), before a decode step
        meets it.  Batches past a decode launch take the chunk kernels,
        which take every row count."""
        sp = self.cfg.sparse
        if sp.strategy != "pallas":
            return
        ds = max(1, sp.dp_shards or 1)
        bt = max(1, self.scfg.batch // ds)
        if bt > KF.MAX_BATCH:
            return
        d, g = self.cfg.d_model, sp.group_size
        k_l = self.cfg.d_ff // len(caps)
        for s, capg in enumerate(caps):
            if (capg, s) in self._grids_checked:
                continue
            try:
                KP.margins_plan(bt, packed_width(d), k_l, g,
                                lambda cluster, smem: _PLAN_SMS // cluster)
                if sp.weight_dtype == "int8":
                    KF.decode_q_plan(bt, d, capg * g, g, sp.quant_group_size,
                                     _PLAN_SMS, lambda nb, mode, smem: 1)
                else:
                    KF.decode_plan(bt, d, capg * g, g, _PLAN_SMS,
                                   lambda nb, smem: 1)
            except ValueError as e:
                raise ValueError(
                    f"shard {s} at bucket {capg} local groups: the kernels "
                    f"refuse its local shape ({e})") from None
            self._grids_checked.add((capg, s))

    def _select_bucket(self):
        """The smallest capacity bucket covering the controller's
        union-demand hint, picked between decode steps.  Under the
        per-shard ladder each model shard's rung covers its own union
        demand (``shard_capacity_hints``), so a skewed shard widens only
        itself."""
        ctl = self.controller
        if ctl is None or len(self._bucket_cfgs) <= 1 or ctl.state.steps == 0:
            return self._active_cap
        g = self.cfg.sparse.group_size
        if isinstance(self._active_cap, tuple):
            ms = len(self._active_cap)
            if (self._per_shard_buckets
                    and isinstance(ctl, DistributedController)
                    and ctl._shard_steps > 0):
                needs = [-(-int(h) // g)                     # local groups
                         for h in ctl.shard_capacity_hints(self.cfg.d_ff)]
            else:
                need = -(-ctl.capacity_hint(self.cfg.d_ff) // g)
                needs = [-(-need // ms)] * ms                 # C -> C/ms
            t = tuple(self._pick_rung(self._local_ladder, n) for n in needs)
            if t not in self._bucket_cfgs:        # uniform tuples only
                t = (max(t),) * ms
            self._active_cap = t
            self._check_shard_grids(t)
            return t
        need = -(-ctl.capacity_hint(self.cfg.d_ff) // g)  # neurons -> groups
        for capg in sorted(self._bucket_cfgs):
            if capg >= need:
                self._active_cap = capg
                break
        else:
            self._active_cap = max(self._bucket_cfgs)
        return self._active_cap

    def _warm_bucket_ladder(self, tok, caches, lengths, alphas,
                            table=None) -> None:
        """Run every bucket's decode step once on copies of the caches (a
        decode step writes its caches in place), so nothing advances."""
        if self._warmed_buckets or len(self._bucket_cfgs) <= 1:
            self._warmed_buckets = True
            return
        tok = torch.as_tensor(tok, device=self.device)
        lengths = torch.as_tensor(lengths, device=self.device)
        if table is not None:
            table = torch.as_tensor(table, device=self.device)
        for key, cfg_b in self._bucket_cfgs.items():
            loaded = build.n_loaded()
            self.mod.decode_step(self.params, cfg_b, tok,
                                 _clone_caches(caches), lengths,
                                 alphas=alphas, collect_stats=True,
                                 block_table=table)
            self._count_setup(key, loaded)
            self.warmup_steps += 1
        self._warmed_buckets = True

    def maybe_adapt_capacity(self) -> bool:
        """Move the static capacity toward the controller's hint (without a
        bucket ladder, at refill boundaries).  True when it changed."""
        ctl, sc = self.controller, self.scfg.controller
        if ctl is None or not sc.adapt_capacity or ctl.state.steps == 0:
            return False
        if len(self._bucket_cfgs) > 1 or 0 not in self._bucket_cfgs:
            return False              # the bucket ladder owns capacity
        k = self.cfg.d_ff
        hint = ctl.capacity_hint(k)
        new_cfg = self.cfg.replace(sparse=dataclasses.replace(
            self.cfg.sparse, capacity_frac=min(1.0, hint / k)))
        if new_cfg.sparse.capacity(k) == self.cfg.sparse.capacity(k):
            return False
        if new_cfg.sparse.tp_shards:
            # a capacity that does not split over the shards would raise
            # mid-serve: keep the current one
            try:
                new_cfg.sparse.shard_capacity(k)
            except ValueError:
                return False
        self.cfg = new_cfg
        self._build_controller_fns()
        return True

    def _observe_step(self, stats: dict, tier_idx: np.ndarray,
                      active: Optional[np.ndarray], audit: bool) -> None:
        """Fold one decode step's (L, B) telemetry into the controller: per
        tier when tiered, else the mean over the live slots (``active``
        None: every slot, as in generate())."""
        ctl = self.controller
        if isinstance(ctl, DistributedController):
            # take the per-shard riders off before the (L, B) aggregation;
            # an audit step's only go (masked densities are on another
            # scale than the serving strategy's)
            stats = ctl.consume_shard_stats(stats, active, fold=not audit)
        if ctl.tiers:
            agg, counts = aggregate_tier_stats(stats, tier_idx, ctl.n_tiers,
                                               active)
            ctl.observe(agg, audit=audit, tier_counts=counts)
        else:
            sel = slice(None) if active is None else active
            ctl.observe({k: v[:, sel].mean(-1) for k, v in stats.items()},
                        audit=audit)

    # ------------------------------------------------------- alpha plumbing
    def _tier_of(self, req: Request) -> int:
        try:
            return self._tier_index[req.sla]
        except KeyError:
            raise ValueError(
                f"request {req.uid}: unknown SLA tier {req.sla!r} "
                f"(configured: {sorted(self._tier_index)})") from None

    def _slot_alpha_matrix(self, tier_idx: np.ndarray,
                           active: Optional[np.ndarray] = None
                           ) -> np.ndarray:
        """(n_layers, B) per-layer-per-slot alphas: the static schedule, or
        the controller's alphas, plus each slot's tier offset (a tiered
        controller holds the tiers' alphas itself); dead slots get
        ``DEAD_SLOT_ALPHA``."""
        ctl = self.controller
        if ctl is not None and ctl.tiers:
            mat = ctl.slot_alphas(tier_idx)
        else:
            base = (self.cfg.sparse.alpha_schedule().alphas(self.cfg.n_layers)
                    if ctl is None else ctl.alphas())
            mat = (base[:, None]
                   + self._tier_offsets[tier_idx][None, :]).astype(np.float32)
        if active is not None and not active.all():
            mat[:, ~np.asarray(active, bool)] = DEAD_SLOT_ALPHA
        return mat

    def _decode(self, tok, caches, lengths, alphas=None, table=None,
                cfg: Optional[ModelConfig] = None):
        """One decode step -> (tokens, caches); with ``cfg`` (a controller
        configuration: a bucket's or the audit's) also the step's (L, B)
        telemetry as numpy."""
        if table is not None:
            table = torch.as_tensor(table, device=self.device)
        out = self.mod.decode_step(
            self.params, cfg or self.cfg,
            torch.as_tensor(tok, device=self.device), caches,
            torch.as_tensor(lengths, device=self.device), alphas=alphas,
            block_table=table, collect_stats=cfg is not None)
        self.decode_steps += 1
        if cfg is None:
            logits, caches = out
            return greedy_sample(logits), caches
        logits, caches, stats = out
        return greedy_sample(logits), caches, {
            k: v.cpu().numpy() for k, v in stats.items()}

    def _decode_ctrl(self, audit: bool, tok, caches, lengths, alphas,
                     table=None):
        """A controller decode step: the audit configuration, or the active
        bucket's."""
        key = self._active_cap
        loaded = build.n_loaded()
        out = self._decode(tok, caches, lengths, alphas, table,
                           self._audit_cfg if audit
                           else self._bucket_cfgs[key])
        if not audit:
            self._count_setup(key, loaded)
        self.bucket_history.append(key)
        return out

    def _prefill_alphas(self, t: int) -> np.ndarray:
        """(n_layers,) alphas of one request's prefill chunks: the decode
        slots' alphas for a request of tier ``t`` (pad rows get the dead
        alpha in the model)."""
        ctl = self.controller
        if ctl is not None and ctl.tiers:
            return ctl.slot_alphas(np.asarray([t]))[:, 0]
        base = (self.cfg.sparse.alpha_schedule().alphas(self.cfg.n_layers)
                if ctl is None else ctl.alphas())
        return (base + self._tier_offsets[t]).astype(np.float32)

    # ------------------------------------------------------- paged KV ----
    def _prefill_salt(self, t: int) -> bytes:
        """Trie hash salt: everything besides the tokens that determines a
        prefill-origin block's content.  Dense prefill depends on the
        tokens alone (empty salt); sparse prefill skips MLP rows by the
        per-layer alphas, so they fold in and a committed block matches
        only a request that would have prefilled it identically."""
        sp = self.cfg.sparse
        if not (sp.enabled and sp.sparse_prefill
                and not (sp.tp_shards or sp.dp_shards)):
            return b""
        return np.asarray(self._prefill_alphas(t), np.float32).tobytes()

    def _match_reuse(self, r: Request, t: int, plen: int) -> dict:
        """Longest prefix a paged admission can take by reference: the
        request's own session chain (continuation of its retained cache,
        decode-written reply blocks included) or the prefix trie of
        committed prompt blocks, whichever covers more.  The reuse boundary
        is chunk-aligned and always leaves the final chunk to run (it gives
        the first token).  Matched full blocks past the boundary come back
        as ``cow_ids``: they are referenced here, and ``place`` adopts them
        for writing, forking the shared originals (copy-on-write)."""
        pool = self.kv_pool
        pc = self.scfg.prefill_chunk
        bs = pool.block_size
        prompt = np.asarray(r.prompt, np.int32)
        salt = self._prefill_salt(t)
        meta: dict = {"adopted": 0, "ids": [], "cow_ids": [],
                      "hashes": pool.block_hashes(salt, prompt)}
        if not (pool.prefix_cache and pc):
            return meta
        ids: list[int] = []
        sess = pool.lookup_session(r.session_id) if r.session_id else None
        if sess is not None:
            hist = sess["history"]
            n = min(plen, len(hist))
            eq = prompt[:n] == hist[:n]
            m = n if eq.all() else int(np.argmax(~eq))
            ids = sess["chain"][: m // bs]
        tids = pool.match_prefix(salt, prompt)
        if len(tids) > len(ids):
            ids = tids
        if not ids:
            return meta
        r_max = ((plen - 1) // pc) * pc
        nb_re = (min(len(ids) * bs, r_max) // pc) * (pc // bs)
        # reference every matched block now, adopted and COW candidates:
        # an eviction cascade before place() could otherwise reissue one
        for b in ids:
            pool.incref(b)
        meta["adopted"] = nb_re
        meta["ids"] = ids[:nb_re]
        meta["cow_ids"] = ids[nb_re:]
        if nb_re:
            pool.stats["reuse_hits"] += 1
            pool.stats["reused_blocks"] += nb_re
            pool.stats["reused_tokens"] += nb_re * bs
        return meta

    def paged_stats(self) -> dict:
        """Pool occupancy and reuse counters plus admission chunk and
        overload counts (empty without ``ServeConfig.paged_kv``); the
        reference's keys."""
        if self.kv_pool is None:
            return {}
        return {**self.kv_pool.snapshot(),
                "prefill_chunks_run": self.prefill_chunks_run,
                "prefill_chunks_skipped": self.prefill_chunks_skipped,
                "preemptions": self.preempt_count,
                "shed": self.shed_count,
                "admissions_deferred": self.admissions_deferred}

    # ----------------------------------------------------------- single ---
    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts (B, P) int32 -> (B, max_new) greedy ids: one fixed batch
        run to completion (the reference path of the scheduler tests), on
        the static schedule or, with the controller, on the 'balanced'
        tier's adapted alphas."""
        ctl = self.controller
        bal = self._tier_index.get("balanced")
        if bal is None:
            if ctl is not None and ctl.tiers:
                raise ValueError(
                    "generate() runs the whole batch on the 'balanced' tier "
                    "but ServeConfig.sla_tiers has no such tier "
                    f"({sorted(self._tier_index)})")
            bal = 0
        with torch.inference_mode():
            b, plen = prompts.shape
            logits, caches = self.mod.prefill(
                self.params, self.cfg,
                torch.as_tensor(np.asarray(prompts, np.int32),
                                device=self.device), self.scfg.max_len)
            tok = greedy_sample(logits)[:, None]
            out = [tok]
            lengths = np.full(b, plen, np.int32)
            tiers = np.full(b, bal)
            for _ in range(max_new - 1):
                if ctl is None:
                    tok, caches = self._decode(tok, caches, lengths)
                else:
                    audit = ctl.is_audit_step()
                    self._select_bucket()
                    alphas = (self._slot_alpha_matrix(tiers) if ctl.tiers
                              else ctl.alphas())
                    if self.scfg.warm_buckets and not self._warmed_buckets:
                        self._warm_bucket_ladder(tok, caches, lengths,
                                                 alphas)
                    tok, caches, stats = self._decode_ctrl(
                        audit, tok, caches, lengths, alphas)
                    self._observe_step(stats, tiers, None, audit)
                tok = tok[:, None]
                out.append(tok)
                lengths += 1
            return torch.cat(out, dim=1).cpu().numpy()


    # ------------------------------------------------------ batched queue --
    def serve(self, requests: list[Request]) -> list[Request]:
        """Run a queue through the slot-refill scheduler.  Every request is
        validated before any work starts; the excess over
        ``max_queue_depth`` sheds at once ("queue_depth")."""
        t_adm = self._now()           # latency clocks start here
        for r in requests:
            self._tier_of(r)
            # every stamp serve() sets is reset: a re-served Request object
            # would otherwise carry the previous run's into this report
            r.t_admit = t_adm
            r.t_start = r.t_end = 0.0
            r.queue_wait_s = r.ttft_s = r.latency_s = 0.0
            r.out = None
            r.outcome = r.shed_reason = ""
            r.preemptions = 0
            if r.deadline_s <= 0.0 and self.scfg.default_deadline_s > 0.0:
                r.deadline_s = self.scfg.default_deadline_s
            if len(r.prompt) + r.max_new > self.scfg.max_len:
                raise ValueError(
                    f"request {r.uid}: prompt {len(r.prompt)} + max_new "
                    f"{r.max_new} exceeds max_len {self.scfg.max_len}")
        hub = self.metrics
        hub.event("serve_start", requests=len(requests))
        overflow: list[Request] = []
        mqd = self.scfg.max_queue_depth
        if mqd and len(requests) > mqd:
            requests, overflow = requests[:mqd], requests[mqd:]
            for r in overflow:
                r.outcome, r.shed_reason = "shed", "queue_depth"
                r.out = np.zeros(0, np.int32)
                hub.inc("requests_shed", reason="queue_depth")
                hub.event("shed", uid=r.uid, reason="queue_depth")
            self.shed_count += len(overflow)
        with torch.inference_mode():
            try:
                done = self._serve_slot_refill(requests)
            except Exception:
                # the scheduler died with slots, pool and controller half
                # updated: start the next serve from a fresh state
                self.reset()
                raise
        self._serve_epilogue()
        return done + overflow

    def _serve_slot_refill(self, requests: list[Request]) -> list[Request]:
        scfg, B = self.scfg, self.scfg.batch
        pc = scfg.prefill_chunk
        hub = self.metrics            # every method a no-op when disabled
        queue = collections.deque(requests)
        done: list[Request] = []
        # victims for preemption and shedding: lowest tier priority first,
        # then fewest emitted tokens (least sunk work), then slot index
        prio = np.asarray([t.priority for t in scfg.sla_tiers], np.int64)
        paged = self.kv_pool is not None
        pool_mgr = self.kv_pool
        if paged:
            # session-sticky SLA tiers, resolved before any admission
            for r in requests:
                sess = pool_mgr.lookup_session(r.session_id)
                if sess is not None:
                    r.sla = sess["tier"]
            # the device pool persists across serve() calls (sessions and
            # committed prefixes keep admitting by reference)
            caches = self._pool
            bs_, nbps = pool_mgr.block_size, self._nbps
            table = np.full((B, nbps), KVPool.TRASH, np.int32)
            slot_meta: list[Optional[dict]] = [None] * B
        else:
            caches = self.mod.init_caches(self.cfg, B, scfg.max_len,
                                          self.device)
            table = None
        tok = np.zeros((B, 1), np.int32)
        lengths = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        tier_idx = np.zeros(B, np.int64)
        slot_req: list[Optional[Request]] = [None] * B
        slot_out: list[list[int]] = [[] for _ in range(B)]
        pending: dict[int, dict] = {}          # slot -> chunked admission
        alpha_mat: Optional[np.ndarray] = None  # changes only at refills
        ctl = self.controller
        # the controller's prefill rider: telemetry of the chunks that run
        # sparse
        # (a sharded config's prefill runs dense: no rider)
        prefill_stats = (ctl is not None and self.cfg.sparse.sparse_prefill
                         and not (self.cfg.sparse.tp_shards
                                  or self.cfg.sparse.dp_shards))
        # admission back-off latch: set when a placement failed on an
        # exhausted pool with resident work to wait for, cleared by every
        # block release.  Preempting a peer at admission instead would
        # ping-pong two equal-tier requests until both shed
        pool_wait = [False]

        def victim_key(j: int) -> tuple:
            return (prio[tier_idx[j]], len(slot_out[j]), j)

        def finish(i: int) -> None:
            r = slot_req[i]
            r.out = np.asarray(slot_out[i][: r.max_new], np.int32)
            r.outcome = "completed"
            r.t_end = self._now()
            r.latency_s = r.t_end - (r.t_admit if r.t_admit else r.t_start)
            hub.inc("requests_completed")
            hub.observe("latency_s", r.latency_s, tier=r.sla)
            hub.event("complete", uid=r.uid, tier=r.sla,
                      tokens=len(r.out), latency_s=r.latency_s)
            done.append(r)
            if paged:
                _release_slot(i, r)
            slot_req[i] = None
            active[i] = False

        def _expired(r: Request, now: float) -> bool:
            return (r.deadline_s > 0.0 and r.t_admit > 0.0
                    and now - r.t_admit > r.deadline_s)

        def _shed(r: Request, reason: str, toks=None) -> None:
            """Terminal shed: returned with the tokens it emitted, outside
            the served throughput (t_end stays 0)."""
            r.outcome, r.shed_reason = "shed", reason
            r.out = np.asarray(toks if toks is not None else [], np.int32)
            self.shed_count += 1
            hub.inc("requests_shed", reason=reason)
            hub.event("shed", uid=r.uid, tier=r.sla, reason=reason,
                      tokens=len(r.out))
            hub.instant("shed", uid=r.uid, reason=reason)
            done.append(r)

        def _clear_slot(i: int) -> None:
            nonlocal alpha_mat
            slot_req[i] = None
            slot_out[i] = []
            active[i] = False
            alpha_mat = None

        def _shed_slot(i: int, reason: str) -> None:
            r = slot_req[i]
            if paged:
                _release_slot(i, r, store=False)
            _shed(r, reason, toks=slot_out[i])
            _clear_slot(i)

        def _preempt_slot(i: int) -> None:
            """Park slot i's prompt blocks in the trie (evictable yet
            matchable, so the resume admits them by reference), free its
            decode blocks and requeue the request; its emitted tokens are
            decoded again on resume (decode-written KV is not bitwise
            prefill KV, so re-prefilling them would not be exact).  Past
            ``max_preemptions`` it sheds instead: the livelock guard for a
            pool that can never hold it."""
            r = slot_req[i]
            if r.preemptions >= scfg.max_preemptions:
                _shed_slot(i, "pool")
                return
            _release_slot(i, r, store=False)
            r.preemptions += 1
            r.outcome = "preempted"       # until it completes or sheds
            self.preempt_count += 1
            hub.inc("preemptions", tier=r.sla)
            hub.event("preempt", uid=r.uid, tier=r.sla,
                      preemptions=r.preemptions)
            hub.instant("preempt", uid=r.uid)
            _clear_slot(i)
            queue.append(r)

        def _relieve(exclude: Optional[int] = None,
                     max_prio: Optional[int] = None) -> bool:
            """Free pool headroom by preempting the first active slot in
            victim order.  ``exclude`` (the slot that needs the block) is
            chosen only when it is the sole candidate; ``max_prio``
            (admission) admits only strictly lower tiers as victims."""
            cands = [j for j in range(B) if active[j] and j != exclude
                     and slot_meta[j] is not None
                     and (max_prio is None or prio[tier_idx[j]] < max_prio)]
            if (not cands and max_prio is None and exclude is not None
                    and active[exclude] and slot_meta[exclude] is not None):
                cands = [exclude]
            if not cands:
                return False
            _preempt_slot(min(cands, key=victim_key))
            return True

        def _kill_pending(i: int, reason: str) -> None:
            """Abort a mid-prefill admission (deadline or injected fault):
            drop its scratch caches and every reference ``_match_reuse``
            took, adopted and unconsumed copy-on-write candidates, and
            shed it."""
            pool_wait[0] = False
            st = pending.pop(i)
            m = st.get("meta")
            if paged and m is not None:
                for b in m["ids"] + m["cow_ids"]:
                    pool_mgr.release(b)
            _shed(st["req"], reason)

        def _release_slot(i: int, r: Request, store: bool = True) -> None:
            """Retire slot i's table row: commit its prefill-origin full
            prompt blocks to the trie (deduplicated against existing
            chains), then keep the whole chain, reply blocks and partial
            tail included, under the request's session, or release every
            reference (committed blocks park in the evictable LRU).
            ``store=False`` (preemption, shedding) keeps no session, but the
            prompt blocks still commit: a preempted request's resume admits
            them by reference."""
            pool_wait[0] = False          # headroom is released below
            meta = slot_meta[i]
            written = int(lengths[i])          # prompt + decoded-token KV
            n_chain = -(-written // bs_) if written else 0
            chain = [int(table[i, j]) for j in range(n_chain)]
            # decode-written KV is not bitwise prefill KV: only full prompt
            # blocks are committable
            n_prompt_full = meta["plen"] // bs_
            chain[:n_prompt_full] = pool_mgr.commit_chain(
                meta["hashes"][:n_prompt_full], chain[:n_prompt_full],
                owned_from=meta["adopted"])
            sid = r.session_id
            if store and sid is not None:
                hist = np.concatenate(
                    [np.asarray(r.prompt, np.int32),
                     np.asarray(slot_out[i], np.int32)])[:written]
                tier = self.scfg.sla_tiers[meta["tier"]].name
                pool_mgr.store_session(sid, chain, hist, tier)
            else:
                for b in chain:
                    pool_mgr.release(b)
            table[i, :] = KVPool.TRASH
            slot_meta[i] = None

        def place(i: int, r: Request, first: int, t: int, one: dict,
                  meta: Optional[dict] = None) -> bool:
            """Activate slot i with a finished prefill: copy the batch-1
            caches into the slot (dense), or write them into blocks the slot
            owns (paged).  False when the pool cannot hold the request even
            after relief: it is then requeued at the head (resident work
            will release blocks) or shed ("pool"), and the slot left
            empty."""
            nonlocal alpha_mat
            plen = len(r.prompt)
            r.ttft_s = self._now() - (r.t_admit if r.t_admit else r.t_start)
            hub.observe("ttft_s", r.ttft_s, tier=r.sla)
            hub.event("first_token", uid=r.uid, tier=r.sla, ttft_s=r.ttft_s)
            slot_req[i] = r
            slot_out[i] = [first]
            tok[i, 0] = first
            lengths[i] = plen
            tier_idx[i] = t
            active[i] = True
            if paged:
                meta = meta or {"adopted": 0, "ids": [], "cow_ids": [],
                                "hashes": pool_mgr.block_hashes(
                                    self._prefill_salt(t),
                                    np.asarray(r.prompt, np.int32))}
                nb_re = meta["adopted"]
                nb_prompt = -(-plen // bs_)
                # matched blocks past the reuse boundary were re-run: adopt
                # them for writing (copy-on-write forks the shared
                # originals; the commit below rewrites every owned block,
                # the matched ones with the same content).  Their reference
                # was taken in _match_reuse; ensure_writable consumes it,
                # and raises before consuming it when the fork finds no
                # block
                cow = meta["cow_ids"]
                owned: list[int] = []
                j = nb_re
                while j < nb_prompt:
                    k = j - nb_re
                    try:
                        wid = (pool_mgr.ensure_writable(cow[k])[0]
                               if k < len(cow) else pool_mgr.alloc())
                    except PoolExhausted:
                        if not scfg.preempt:
                            raise
                        # slot i holds no blocks yet, so it is never its
                        # own victim; an admission displaces only strictly
                        # lower tiers (peers wait, see pool_wait)
                        if _relieve(exclude=i, max_prio=int(prio[t])):
                            continue          # headroom freed: retry
                        # roll back every reference this placement holds
                        for b in owned + cow[k:] + meta["ids"]:
                            pool_mgr.release(b)
                        table[i, :] = KVPool.TRASH
                        _clear_slot(i)
                        if active.any() or pending:
                            queue.appendleft(r)
                            pool_wait[0] = True
                        else:
                            _shed(r, "pool")  # nothing resident to wait for
                        return False
                    owned.append(wid)
                    j += 1
                _commit_owned(caches, one,
                              torch.as_tensor(owned, dtype=torch.long,
                                              device=self.device), nb_re)
                table[i, :nb_re] = meta["ids"][:nb_re]
                table[i, nb_re:nb_prompt] = owned
                table[i, nb_prompt:] = KVPool.TRASH
                meta["plen"] = plen
                meta["tier"] = t
                slot_meta[i] = meta
            else:
                _splice_slot(caches, one, i)
            alpha_mat = None
            return True

        def admit(i: int) -> None:
            """Fill slot i from the queue, as one "admission" span."""
            if not queue:
                return
            with hub.span("admission", slot=i):
                _admit(i)

        def _admit(i: int) -> None:
            """With chunked prefill the slot goes pending (admitting by
            reference what the pool holds, when paged); otherwise a batch-1
            prefill at the prompt's natural length is copied into the slot.
            Requests that expired in the queue shed here."""
            while queue:
                if pool_wait[0]:
                    return        # exhaustion latch: wait for a release
                if (paged and scfg.pressure_gate < 1.0
                        and (active.any() or pending)
                        and pool_mgr.pressure() >= scfg.pressure_gate):
                    # admission backpressure: never with nothing resident,
                    # so the loop always makes progress
                    self.admissions_deferred += 1
                    return
                r = queue.popleft()
                if _expired(r, self._now()):
                    _shed(r, "deadline")
                    continue
                if paged:
                    sess = pool_mgr.lookup_session(r.session_id)
                    if sess is not None:
                        r.sla = sess["tier"]    # session-sticky tier
                t = self._tier_of(r)
                plen = len(r.prompt)
                now = self._now()
                r.t_start = now
                r.queue_wait_s = now - r.t_admit if r.t_admit else 0.0
                hub.observe("queue_wait_s", r.queue_wait_s, tier=r.sla)
                hub.event("admit", uid=r.uid, tier=r.sla, plen=plen,
                          queue_wait_s=r.queue_wait_s)
                if pc:
                    toks = np.zeros((1, -(-plen // pc) * pc), np.int32)
                    toks[0, :plen] = np.asarray(r.prompt, np.int32)
                    st = {"req": r, "tier": t, "tokens": toks, "off": 0}
                    if paged:
                        st["meta"] = m = self._match_reuse(r, t, plen)
                    if paged and m["adopted"]:
                        # admit by reference: seed the scratch with the
                        # adopted blocks and start at the reuse boundary
                        st["off"] = m["adopted"] * bs_
                        seed = np.zeros(nbps, np.int64)      # NULL lanes
                        seed[:m["adopted"]] = m["ids"][:m["adopted"]]
                        st["caches"] = _seed_scratch(
                            caches, torch.as_tensor(seed,
                                                    device=self.device))
                        self.prefill_chunks_skipped += st["off"] // pc
                    else:
                        st["caches"] = self.mod.init_caches(
                            self.cfg, 1, scfg.max_len, self.device)
                    pending[i] = st
                    return
                try:
                    self._fault("prefill", r.uid)
                except InjectedFault:
                    _shed(r, "fault")     # the slot died mid-prefill
                    continue
                with hub.span("prefill", hist="prefill_s", slot=i,
                              uid=r.uid):
                    logits, one = self.mod.prefill(
                        self.params, self.cfg, torch.as_tensor(
                            np.asarray(r.prompt, np.int32)[None, :],
                            device=self.device), scfg.max_len)
                    first = int(greedy_sample(logits)[0])
                if not place(i, r, first, t, one):
                    if pool_wait[0]:
                        return    # backpressure latched: stop admitting
                    continue      # shed on pool exhaustion: try the next
                if r.max_new <= 1:
                    finish(i)     # prefill alone satisfied it; keep draining
                    continue
                return

        def advance_prefill(budget: int) -> None:
            """Run up to ``budget`` prefill chunks, round-robin over the
            pending slots."""
            while budget > 0 and pending:
                for i in sorted(pending):
                    if budget <= 0:
                        break
                    st = pending[i]
                    r = st["req"]
                    try:
                        self._fault("prefill", r.uid)
                    except InjectedFault:
                        # the admission dies cleanly and the slot refills
                        _kill_pending(i, "fault")
                        admit(i)
                        continue
                    chunk = torch.as_tensor(
                        st["tokens"][:, st["off"]:st["off"] + pc],
                        device=self.device)
                    with hub.span("prefill_chunk", hist="prefill_chunk_s",
                                  slot=i, uid=r.uid):
                        out = self.mod.prefill_chunk(
                            self.params, self.cfg, chunk, st["caches"],
                            st["off"], len(r.prompt),
                            alphas=self._prefill_alphas(st["tier"]),
                            collect_stats=prefill_stats)
                    if prefill_stats:
                        logits, st["caches"], stats = out
                        ctl.observe_prefill(
                            {k: v[:, 0].cpu().numpy()
                             for k, v in stats.items()},
                            tier=st["tier"] if ctl.tiers else None)
                    else:
                        logits, st["caches"] = out
                    st["off"] += pc
                    budget -= 1
                    self.prefill_chunks_run += 1
                    if st["off"] >= st["tokens"].shape[1]:
                        first = int(greedy_sample(logits)[0])
                        del pending[i]
                        if not place(i, r, first, st["tier"], st["caches"],
                                     st.get("meta")):
                            admit(i)   # requeued or shed; a no-op while
                            #            the exhaustion latch holds
                        elif r.max_new <= 1:
                            finish(i)
                            admit(i)   # refill: may go pending again

        def ensure_write_blocks() -> None:
            """Before a decode step every live slot's write position must
            land in a block it owns: allocate on first touch (TRASH lanes
            are the unallocated tail).  Under ``preempt`` an exhausted pool
            preempts a victim instead of raising, possibly the slot itself;
            every retry preempts or sheds one slot, so this ends."""
            for i in range(B):
                if not active[i]:
                    continue
                j = int(lengths[i]) // bs_
                while active[i] and table[i, j] == KVPool.TRASH:
                    try:
                        table[i, j] = pool_mgr.alloc()
                    except PoolExhausted:
                        if not scfg.preempt:
                            raise
                        _relieve(exclude=i)

        for i in range(B):
            admit(i)
        # each iteration ticks the virtual clock and decodes, prefills,
        # admits or sheds, so the loop ends; its order is the reference's,
        # one iteration for one, so deadlines expire at the same steps
        step_n = 0                    # decode steps (the gauge cadence)
        while active.any() or pending or queue:
            self._tick()
            now = self._now()
            # deadlines: resident and mid-prefill requests shed with what
            # they emitted (queued ones shed at dequeue)
            for i in range(B):
                if active[i] and _expired(slot_req[i], now):
                    _shed_slot(i, "deadline")
            for i in [j for j in sorted(pending)
                      if _expired(pending[j]["req"], now)]:
                _kill_pending(i, "deadline")
            # deadline pressure: a queue head that has waited half its
            # deadline parks a strictly-lower-tier resident and takes its
            # slot in this iteration
            if scfg.preempt and queue:
                h = queue[0]
                if (h.deadline_s > 0.0 and h.t_admit > 0.0
                        and now - h.t_admit >= 0.5 * h.deadline_s):
                    cands = [j for j in range(B) if active[j]
                             and prio[tier_idx[j]] < prio[self._tier_of(h)]]
                    if cands:
                        _preempt_slot(min(cands, key=victim_key))
            # refill empty slots: deferred admissions retry and slots freed
            # by sheds and preemptions fill
            if queue and not pool_wait[0]:
                for i in range(B):
                    if slot_req[i] is None and i not in pending:
                        admit(i)
            if pending:
                # interleave admissions with decode steps
                advance_prefill(scfg.prefill_interleave)
                if not active.any():
                    continue      # nothing decoding yet: keep prefilling
            if not active.any():
                continue          # deferred or shed everything this pass
            if paged:
                ensure_write_blocks()
                if not active.any():
                    continue      # exhaustion relief preempted every slot
            self._fault("decode")   # fatal: aborts serve(), which resets
            t_dec = hub.now() if hub.enabled else 0.0
            if ctl is not None:
                # rebuilt every step: the controller adapts between steps
                alphas = self._slot_alpha_matrix(tier_idx, active)
                if scfg.warm_buckets and not self._warmed_buckets:
                    self._warm_bucket_ladder(tok, caches, lengths, alphas,
                                             table)
                audit = ctl.is_audit_step()
                prev_cap = self._active_cap
                self._select_bucket()      # between-step bucket switch
                if hub.enabled and self._active_cap != prev_cap:
                    hub.inc("bucket_switches")
                    hub.event("bucket_switch", bucket=self._active_cap)
                    hub.instant("bucket_switch")
                ntok, caches, stats = self._decode_ctrl(
                    audit, tok, caches, lengths, alphas, table)
                with hub.span("controller_update",
                              hist="controller_update_s"):
                    self._observe_step(stats, tier_idx, active, audit)
            else:
                if alpha_mat is None:
                    alpha_mat = self._slot_alpha_matrix(tier_idx, active)
                ntok, caches = self._decode(tok, caches, lengths, alpha_mat,
                                            table)
            ntok = ntok.cpu().numpy()
            # the step ends where the host reads its tokens; under the
            # virtual clock the span has no duration
            hub.complete("decode_step", t_dec, hist="decode_step_s")
            step_n += 1
            if hub.enabled and step_n % scfg.metrics.cadence == 0:
                self.publish_gauges()
            refill = []
            for i in range(B):
                if not active[i]:
                    continue
                slot_out[i].append(int(ntok[i]))
                tok[i, 0] = int(ntok[i])
                lengths[i] += 1
                if len(slot_out[i]) >= slot_req[i].max_new:
                    finish(i)
                    refill.append(i)
            if refill:
                alpha_mat = None
                if queue:
                    self.maybe_adapt_capacity()   # a refill boundary
                    for i in refill:
                        admit(i)
        if paged:
            self._pool = caches
        return done


def throughput_report(requests: list[Request]) -> dict:
    """Tokens over the true wall-clock window (first dequeue to last
    completion), per-request latency, TTFT and queue-wait statistics, and
    the overload outcomes; the reference's keys.  Its percentiles come from
    an exact-mode ``MetricsHub`` (``hist_max_exact=0``): nearest rank for
    any queue size."""
    # served = completion stamped (t_start may be the clock's 0.0)
    served = [r for r in requests if r.t_end > 0.0 and r.t_end >= r.t_start]
    toks = sum(len(r.out) for r in served if r.out is not None)
    wall = (max(r.t_end for r in served) - min(r.t_start for r in served)
            if served else 0.0)
    hub = MetricsHub(MetricsConfig(enabled=True, hist_max_exact=0,
                                   watchdog=False))
    for r in served:
        hub.observe("latency_s", r.latency_s)
        if r.ttft_s > 0.0:
            hub.observe("ttft_s", r.ttft_s)
        if r.t_admit > 0.0:
            hub.observe("queue_wait_s", r.queue_wait_s)
    pct = hub.percentile
    # every request the scheduler touched ends "completed" or "shed" (with
    # a reason); a preempted request that completed counts in both
    # "completed" and "preempted"
    n_shed = sum(1 for r in requests if r.outcome == "shed")
    shed_reasons: dict = {}
    for r in requests:
        if r.outcome == "shed" and r.shed_reason:
            k = f"shed_{r.shed_reason}"
            shed_reasons[k] = shed_reasons.get(k, 0) + 1
    return {"requests": len(requests), "tokens": toks,
            "completed": sum(1 for r in requests
                             if r.outcome == "completed"),
            "shed": n_shed,
            "shed_rate": float(n_shed / len(requests)) if requests else 0.0,
            **shed_reasons,
            "preempted": sum(1 for r in requests if r.preemptions > 0),
            "preemptions": sum(r.preemptions for r in requests),
            "total_s": wall,
            "tok_per_s": float(toks / wall) if wall > 0.0 else 0.0,
            "mean_latency_s": hub.hist_mean("latency_s"),
            "p50_latency_s": pct("latency_s", 0.5),
            "p95_latency_s": pct("latency_s", 0.95),
            "mean_ttft_s": hub.hist_mean("ttft_s"),
            "p50_ttft_s": pct("ttft_s", 0.5),
            "p95_ttft_s": pct("ttft_s", 0.95),
            "mean_queue_wait_s": hub.hist_mean("queue_wait_s"),
            "p50_queue_wait_s": pct("queue_wait_s", 0.5),
            "p95_queue_wait_s": pct("queue_wait_s", 0.95)}
