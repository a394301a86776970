"""Deterministic synthetic LM data with per-host sharding and skip-ahead:
counterpart of ``repro/data/pipeline.py``.

Batch content is a pure function of (seed, step, host_id), drawn with
numpy exactly as the reference draws it, so a restarted or straggling host
regenerates the batch it owes for any step and the port trains on the
reference's tokens bit for bit.  ``DataIterator`` hands each batch over as
tensors on the trainer's device.  On a rank mesh every rank draws the
whole global batch, as the reference's single-host run does (host 0 of
1), and keeps its data line's contiguous rows (``rules.slot_range``: line
j of D takes rows [j·B/D, (j+1)·B/D); B must divide by the lines).
``make_batch_specs`` gives one host batch's shapes and dtypes as tensors on the ``meta`` device (the
reference's ``ShapeDtypeStruct``s), for the dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.sharding import rules as R


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    # synthetic corpus: Zipfian unigrams + short-range induction structure
    zipf_a: float = 1.2


class SyntheticSource:
    """Zipfian tokens with planted copy structure (so models can learn)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.probs = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> dict:
        """Global step -> this host's shard of the global batch, as int32
        numpy arrays ``{"tokens", "labels"}`` of (global_batch / n_hosts,
        seq_len)."""
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        toks = rng.choice(cfg.vocab, size=(per_host, cfg.seq_len + 1),
                          p=self.probs).astype(np.int32)
        # the second half repeats the first half for a random half of the
        # rows: a learnable signal
        half = (cfg.seq_len + 1) // 2
        copy_rows = rng.random(per_host) < 0.5
        toks[copy_rows, half:2 * half] = toks[copy_rows, :half]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class DataIterator:
    """Stateful iterator with exact skip-ahead (resume, straggler catch-up):
    each ``next`` is ``batch_at(step)`` as int64 tensors on ``device``,
    this rank's data line's rows of it on a ``mesh``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, device="cpu",
                 mesh=None):
        self.source = SyntheticSource(cfg)
        self.step = start_step
        self.device = torch.device(device)
        rows = R.slot_range(cfg.global_batch // cfg.n_hosts, mesh) \
            if mesh is not None else None
        self.rows = None if rows is None else slice(rows.start, rows.stop)

    def skip_to(self, step: int) -> None:
        """O(1) seek: the contract resume and stragglers rely on."""
        self.step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = self.source.batch_at(self.step)
        self.step += 1
        if self.rows is not None:
            batch = {k: v[self.rows] for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device=self.device, dtype=torch.int64)
                for k, v in batch.items()}


def make_batch_specs(cfg: DataConfig, extra: Optional[dict] = None,
                     device="meta") -> dict:
    """One host batch's stand-ins: int32 ``tokens`` and ``labels``
    (global_batch / n_hosts, seq_len) on ``device`` (``meta``: shapes and
    dtypes, no memory; elsewhere zeros), plus ``extra``'s entries."""
    per_host = cfg.global_batch // cfg.n_hosts
    specs = {k: torch.zeros((per_host, cfg.seq_len), dtype=torch.int32,
                            device=device) for k in ("tokens", "labels")}
    if extra:
        specs.update(extra)
    return specs
