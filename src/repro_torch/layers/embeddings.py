"""Token embeddings and output tables: counterpart of
``repro/layers/embeddings.py``."""
from __future__ import annotations

import torch


def init_embedding(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu") -> dict:
    table = torch.randn((vocab, d), generator=generator, device=device)
    return {"table": (table * d ** -0.5).to(dtype)}


init_unembed = init_embedding


def embed(params: dict, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"][tokens.long()].to(dtype)
