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

Not ported yet: the alpha controller and capacity-bucket ladder (and with
it the controller's prefill rider), overload handling (preemption,
shedding, deadlines, the pressure gate: pool exhaustion raises
``PoolExhausted``) and the metrics hub.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (DEFAULT_SLA_TIERS, ModelConfig,
                                      PagedKVConfig)
from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
from repro_torch.device import resolve_device
from repro_torch.models.common import greedy_sample
from repro_torch.runtime.kv_pool import KVPool


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
    # paged KV pool with prefix reuse and sessions; None keeps the dense
    # per-slot caches.  block_size must divide max_len, and prefill_chunk
    # must be a multiple of it
    paged_kv: Optional[PagedKVConfig] = None


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
        self.prefill_chunks_skipped = 0   # chunks saved by prefix reuse
                                          # (paged KV pool only)
        self.kv_pool: Optional[KVPool] = None
        self._pool: Optional[dict] = None
        if pk is not None:
            self._nbps = scfg.max_len // pk.block_size
            self._init_paged_state()

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

    def _decode(self, tok, caches, lengths, alphas=None, table=None):
        if table is not None:
            table = torch.as_tensor(table, device=self.device)
        logits, caches = self.mod.decode_step(
            self.params, self.cfg, torch.as_tensor(tok, device=self.device),
            caches, torch.as_tensor(lengths, device=self.device),
            alphas=alphas, block_table=table)
        self.decode_steps += 1
        return greedy_sample(logits), caches

    def _prefill_alphas(self, t: int) -> np.ndarray:
        """(n_layers,) alphas of one request's prefill chunks: the static
        schedule plus its tier's offset (pad rows get the dead alpha in the
        model)."""
        base = self.cfg.sparse.alpha_schedule().alphas(self.cfg.n_layers)
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
        """Pool occupancy and reuse counters plus admission chunk counts
        (empty without ``ServeConfig.paged_kv``); the reference's keys,
        its overload counters 0 (overload handling is not ported)."""
        if self.kv_pool is None:
            return {}
        return {**self.kv_pool.snapshot(),
                "prefill_chunks_run": self.prefill_chunks_run,
                "prefill_chunks_skipped": self.prefill_chunks_skipped,
                "preemptions": 0, "shed": 0, "admissions_deferred": 0}

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
            caches = self.mod.init_caches(self.cfg, B, self.scfg.max_len,
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

        def finish(i: int) -> None:
            r = slot_req[i]
            r.out = np.asarray(slot_out[i][: r.max_new], np.int32)
            r.outcome = "completed"
            r.t_end = time.perf_counter()
            r.latency_s = r.t_end - r.t_admit
            done.append(r)
            if paged:
                release_slot(i, r)
            slot_req[i] = None
            active[i] = False

        def release_slot(i: int, r: Request) -> None:
            """Retire slot i's table row: commit its prefill-origin full
            prompt blocks to the trie (deduplicated against existing
            chains), then keep the whole chain, reply blocks and partial
            tail included, under the request's session, or release every
            reference (committed blocks park in the evictable LRU)."""
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
            if sid is not None:
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
                  meta: Optional[dict] = None) -> None:
            """Activate slot i with a finished prefill: copy the batch-1
            caches into the slot (dense), or write them into blocks the slot
            owns (paged)."""
            nonlocal alpha_mat
            r.ttft_s = time.perf_counter() - r.t_admit
            plen = len(r.prompt)
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
                # was taken in _match_reuse; ensure_writable consumes it.
                # Without overload handling an exhausted pool raises.
                cow = meta["cow_ids"]
                owned = [pool_mgr.ensure_writable(cow[j - nb_re])[0]
                         if j - nb_re < len(cow) else pool_mgr.alloc()
                         for j in range(nb_re, nb_prompt)]
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
            slot_req[i] = r
            slot_out[i] = [first]
            tok[i, 0] = first
            lengths[i] = plen
            tier_idx[i] = t
            active[i] = True
            alpha_mat = None

        def admit(i: int) -> None:
            """Fill slot i from the queue.  With chunked prefill the slot
            goes pending (admitting by reference what the pool holds, when
            paged); otherwise a batch-1 prefill at the prompt's natural
            length is copied into the slot."""
            while queue:
                r = queue.popleft()
                if paged:
                    sess = pool_mgr.lookup_session(r.session_id)
                    if sess is not None:
                        r.sla = sess["tier"]    # session-sticky tier
                t = self._tier_of(r)
                plen = len(r.prompt)
                r.t_start = time.perf_counter()
                r.queue_wait_s = r.t_start - r.t_admit
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
                            self.cfg, 1, self.scfg.max_len, self.device)
                    pending[i] = st
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
                              st["tier"], st["caches"], st.get("meta"))
                        if r.max_new <= 1:
                            finish(i)
                            admit(i)   # refill: may go pending again

        def ensure_write_blocks() -> None:
            """Before a decode step every live slot's write position must
            land in a block it owns: allocate on first touch (TRASH lanes
            are the unallocated tail)."""
            for i in range(B):
                if active[i]:
                    j = int(lengths[i]) // bs_
                    if table[i, j] == KVPool.TRASH:
                        table[i, j] = pool_mgr.alloc()

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
            if paged:
                ensure_write_blocks()
            if alpha_mat is None:
                alpha_mat = self._slot_alpha_matrix(tier_idx, active)
            ntok, caches = self._decode(tok, caches, lengths, alpha_mat,
                                        table)
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
        if paged:
            self._pool = caches
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
