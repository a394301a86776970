"""Token embeddings and output tables: counterpart of
``repro/layers/embeddings.py``."""
from __future__ import annotations

import torch


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu") -> dict:
    table = torch.randn((vocab, d), generator=generator, device=device)
    return {"table": (table * d ** -0.5).to(dtype)}


init_unembed = init_embedding


def embed(params: dict, tokens: torch.Tensor, scale_by_sqrt_d: bool = False,
          dtype=torch.bfloat16, rows=None) -> torch.Tensor:
    """Table rows of ``tokens`` in ``dtype``; ``scale_by_sqrt_d`` (gemma)
    multiplies them by sqrt(d), rounded to ``dtype`` first as the reference
    does.  ``rows``: the rows already looked up (a vocabulary-split
    table's, ``models/common.py:embed``)."""
    if rows is None:
        rows = params["table"][tokens.long()]
    x = rows.to(dtype)
    if scale_by_sqrt_d:
        x = x * torch.tensor(params["table"].shape[-1] ** 0.5, dtype=dtype,
                             device=x.device)
    return x
