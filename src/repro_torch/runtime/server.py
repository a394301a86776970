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

Not ported yet: the alpha controller and capacity-bucket ladder (and with
it the controller's prefill rider), the paged KV pool, overload handling
and the metrics hub.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import DEFAULT_SLA_TIERS, ModelConfig
from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
from repro_torch.device import resolve_device
from repro_torch.models.common import greedy_sample


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
    # fixed prefill chunk in tokens; 0 = monolithic batch-1 prefill.  Must
    # divide max_len
    prefill_chunk: int = 0
    # at most this many prefill chunks per decode-loop iteration (the
    # TTFT-vs-inter-token-latency knob)
    prefill_interleave: int = 1


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new: int = 32
    sla: str = "balanced"        # ServeConfig.sla_tiers entry
    out: Optional[np.ndarray] = None
    latency_s: float = 0.0       # admission -> last token (incl. queue wait)
    t_admit: float = 0.0         # perf_counter at admission (serve() entry)
    t_start: float = 0.0         # perf_counter at dequeue
    t_end: float = 0.0           # perf_counter at completion
    queue_wait_s: float = 0.0    # admission -> dequeue
    ttft_s: float = 0.0          # admission -> first token
    outcome: str = ""            # "completed" ("" = never served)


def _splice_slot(full: dict, one: dict, slot: int) -> None:
    """Copy a batch-1 cache tree into batch slot ``slot`` of a full-batch
    cache tree, in place (the reference returns an updated copy)."""
    for f, o in zip(full["blocks"], one["blocks"]):
        for name, buf in f.items():
            buf[slot:slot + 1].copy_(o[name])


class Server:
    """Slot-refill continuous batching over a model module (``models.lm``).

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to serve on the CPU with the plain kernel versions."""

    def __init__(self, model_mod, cfg: ModelConfig, scfg: ServeConfig,
                 params: dict, device="cuda"):
        self.device = resolve_device(device)
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
        if not scfg.slot_refill:
            raise NotImplementedError(
                "the legacy chunked scheduler is not ported; use "
                "slot_refill=True")
        if not scfg.greedy:
            raise NotImplementedError("only greedy decoding is ported")
        if cfg.sparse.enabled and cfg.sparse.strategy in ("masked", "gather"):
            raise NotImplementedError(
                f"strategy {cfg.sparse.strategy!r} is not ported yet "
                "(ROADMAP Queue A, masked and gather strategies)")
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
        self.prefill_chunks_skipped = 0   # chunks saved by prefix reuse:
                                          # 0 until the paged KV pool

    # ------------------------------------------------------- alpha plumbing
    def _tier_of(self, req: Request) -> int:
        try:
            return self._tier_index[req.sla]
        except KeyError:
            raise ValueError(
                f"request {req.uid}: unknown SLA tier {req.sla!r} "
                f"(configured: {sorted(self._tier_index)})") from None

    def _slot_alpha_matrix(self, tier_idx: np.ndarray,
                           active: np.ndarray) -> np.ndarray:
        """(n_layers, B) per-layer-per-slot alphas: the static schedule plus
        each slot's tier offset; dead slots get ``DEAD_SLOT_ALPHA``."""
        base = self.cfg.sparse.alpha_schedule().alphas(self.cfg.n_layers)
        mat = (base[:, None]
               + self._tier_offsets[tier_idx][None, :]).astype(np.float32)
        mat[:, ~active] = DEAD_SLOT_ALPHA
        return mat

    def _decode(self, tok, caches, lengths, alphas=None):
        logits, caches = self.mod.decode_step(
            self.params, self.cfg, torch.as_tensor(tok, device=self.device),
            caches, torch.as_tensor(lengths, device=self.device),
            alphas=alphas)
        self.decode_steps += 1
        return greedy_sample(logits), caches

    def _prefill_alphas(self, t: int) -> np.ndarray:
        """(n_layers,) alphas of one request's prefill chunks: the static
        schedule plus its tier's offset (pad rows get the dead alpha in the
        model)."""
        base = self.cfg.sparse.alpha_schedule().alphas(self.cfg.n_layers)
        return (base + self._tier_offsets[t]).astype(np.float32)

    # ----------------------------------------------------------- single ---
    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts (B, P) int32 -> (B, max_new) greedy ids: one fixed batch
        run to completion on the static schedule (the reference path of the
        scheduler tests)."""
        with torch.inference_mode():
            b, plen = prompts.shape
            logits, caches = self.mod.prefill(
                self.params, self.cfg,
                torch.as_tensor(np.asarray(prompts, np.int32),
                                device=self.device), self.scfg.max_len)
            tok = greedy_sample(logits)[:, None]
            out = [tok]
            lengths = np.full(b, plen, np.int32)
            for _ in range(max_new - 1):
                tok, caches = self._decode(tok, caches, lengths)
                tok = tok[:, None]
                out.append(tok)
                lengths += 1
            return torch.cat(out, dim=1).cpu().numpy()

    # ------------------------------------------------------ batched queue --
    def serve(self, requests: list[Request]) -> list[Request]:
        """Run a queue through the slot-refill scheduler; every request is
        validated before any work starts."""
        t_adm = time.perf_counter()
        for r in requests:
            self._tier_of(r)
            r.t_admit = t_adm
            r.t_start = r.t_end = 0.0
            r.queue_wait_s = r.ttft_s = r.latency_s = 0.0
            r.out = None
            r.outcome = ""
            if len(r.prompt) + r.max_new > self.scfg.max_len:
                raise ValueError(
                    f"request {r.uid}: prompt {len(r.prompt)} + max_new "
                    f"{r.max_new} exceeds max_len {self.scfg.max_len}")
        with torch.inference_mode():
            return self._serve_slot_refill(requests)

    def _serve_slot_refill(self, requests: list[Request]) -> list[Request]:
        B = self.scfg.batch
        pc = self.scfg.prefill_chunk
        queue = collections.deque(requests)
        done: list[Request] = []
        caches = self.mod.init_caches(self.cfg, B, self.scfg.max_len,
                                      self.device)
        tok = np.zeros((B, 1), np.int32)
        lengths = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        tier_idx = np.zeros(B, np.int64)
        slot_req: list[Optional[Request]] = [None] * B
        slot_out: list[list[int]] = [[] for _ in range(B)]
        pending: dict[int, dict] = {}          # slot -> chunked admission
        alpha_mat: Optional[np.ndarray] = None  # changes only at refills

        def finish(i: int) -> None:
            r = slot_req[i]
            r.out = np.asarray(slot_out[i][: r.max_new], np.int32)
            r.outcome = "completed"
            r.t_end = time.perf_counter()
            r.latency_s = r.t_end - r.t_admit
            done.append(r)
            slot_req[i] = None
            active[i] = False

        def place(i: int, r: Request, first: int, t: int, one: dict) -> None:
            """Activate slot i with a finished prefill."""
            nonlocal alpha_mat
            r.ttft_s = time.perf_counter() - r.t_admit
            _splice_slot(caches, one, i)
            slot_req[i] = r
            slot_out[i] = [first]
            tok[i, 0] = first
            lengths[i] = len(r.prompt)
            tier_idx[i] = t
            active[i] = True
            alpha_mat = None

        def admit(i: int) -> None:
            """Fill slot i from the queue.  With chunked prefill the slot
            goes pending; otherwise a batch-1 prefill at the prompt's
            natural length is copied into the slot."""
            while queue:
                r = queue.popleft()
                t = self._tier_of(r)
                plen = len(r.prompt)
                r.t_start = time.perf_counter()
                r.queue_wait_s = r.t_start - r.t_admit
                if pc:
                    toks = np.zeros((1, -(-plen // pc) * pc), np.int32)
                    toks[0, :plen] = np.asarray(r.prompt, np.int32)
                    pending[i] = {
                        "req": r, "tier": t, "tokens": toks, "off": 0,
                        "caches": self.mod.init_caches(
                            self.cfg, 1, self.scfg.max_len, self.device)}
                    return
                prompt = torch.as_tensor(
                    np.asarray(r.prompt, np.int32)[None, :],
                    device=self.device)
                logits, one = self.mod.prefill(self.params, self.cfg, prompt,
                                               self.scfg.max_len)
                place(i, r, int(greedy_sample(logits)[0]), t, one)
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
                    chunk = torch.as_tensor(
                        st["tokens"][:, st["off"]:st["off"] + pc],
                        device=self.device)
                    logits, st["caches"] = self.mod.prefill_chunk(
                        self.params, self.cfg, chunk, st["caches"],
                        st["off"], len(r.prompt),
                        alphas=self._prefill_alphas(st["tier"]))
                    st["off"] += pc
                    budget -= 1
                    self.prefill_chunks_run += 1
                    if st["off"] >= st["tokens"].shape[1]:
                        del pending[i]
                        place(i, r, int(greedy_sample(logits)[0]),
                              st["tier"], st["caches"])
                        if r.max_new <= 1:
                            finish(i)
                            admit(i)   # refill: may go pending again

        for i in range(B):
            admit(i)
        while active.any() or pending or queue:
            if queue:
                for i in range(B):
                    if slot_req[i] is None and i not in pending:
                        admit(i)
            if pending:
                # interleave admissions with decode steps
                advance_prefill(self.scfg.prefill_interleave)
            if not active.any():
                continue          # nothing decoding yet: keep prefilling
            if alpha_mat is None:
                alpha_mat = self._slot_alpha_matrix(tier_idx, active)
            ntok, caches = self._decode(tok, caches, lengths, alpha_mat)
            ntok = ntok.cpu().numpy()
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
                for i in refill:
                    admit(i)
        return done


def _nearest_rank_pct(vals: list, q: float) -> float:
    """Nearest-rank percentile, rank = ceil(q*n) with float fuzz rounded
    away (as the reference's metrics.nearest_rank_pct)."""
    if not vals:
        return 0.0
    vals = sorted(vals)
    rank = math.ceil(round(q * len(vals), 9))
    return vals[min(len(vals) - 1, max(0, rank - 1))]


def throughput_report(requests: list[Request]) -> dict:
    """Tokens over the true wall-clock window (first dequeue to last
    completion) plus per-request latency, TTFT and queue-wait statistics;
    the reference's report keys.  Shedding and preemption are not ported,
    so their counts are 0 here."""
    served = [r for r in requests if r.t_end > 0.0 and r.t_end >= r.t_start]
    toks = sum(len(r.out) for r in served if r.out is not None)
    wall = (max(r.t_end for r in served) - min(r.t_start for r in served)
            if served else 0.0)
    lat = [r.latency_s for r in served]
    ttft = [r.ttft_s for r in served if r.ttft_s > 0.0]
    qw = [r.queue_wait_s for r in served if r.t_admit > 0.0]

    def mean(v):
        return float(sum(v) / len(v)) if v else 0.0
    n_shed = sum(1 for r in requests if r.outcome == "shed")
    return {"requests": len(requests), "tokens": toks,
            "completed": sum(1 for r in requests
                             if r.outcome == "completed"),
            "shed": n_shed,
            "shed_rate": float(n_shed / len(requests)) if requests else 0.0,
            "preempted": 0, "preemptions": 0,
            "total_s": wall,
            "tok_per_s": float(toks / wall) if wall > 0.0 else 0.0,
            "mean_latency_s": mean(lat),
            "p50_latency_s": _nearest_rank_pct(lat, 0.5),
            "p95_latency_s": _nearest_rank_pct(lat, 0.95),
            "mean_ttft_s": mean(ttft),
            "p50_ttft_s": _nearest_rank_pct(ttft, 0.5),
            "p95_ttft_s": _nearest_rank_pct(ttft, 0.95),
            "mean_queue_wait_s": mean(qw),
            "p50_queue_wait_s": _nearest_rank_pct(qw, 0.5),
            "p95_queue_wait_s": _nearest_rank_pct(qw, 0.95)}
