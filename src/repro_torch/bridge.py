"""Carry a reference parameter tree over to the port.

The JAX package's ``init_lm`` stacks every layer's leaves along a leading
(L, ...) axis under ``params["blocks"]``; the port keeps one dict per layer.
``params_from_numpy`` takes that tree with numpy leaves (a caller converts
with ``jax.tree.map(np.asarray, params)``) and returns the port's params.
It imports nothing of JAX: a bfloat16 leaf arrives as an ``ml_dtypes``
numpy array and is widened to float32 (exactly) before the cast back.
A quantized MLP node (the reference's ``prepare_sparse`` with int8 weights:
int8 leaves, float32 scales and the int32 ``sign_wg``) carries over leaf
for leaf, in its own dtypes.  ``pool_from_numpy`` does the same for a
paged KV pool (the reference's ``init_kv_pool`` tree: leaves
(L, N, block, ...) under ``blocks``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _convert(node, device, index=None):
    if isinstance(node, dict):
        return {k: _convert(v, device, index) for k, v in node.items()}
    return _tensor(node if index is None else np.asarray(node)[index], device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference params (numpy leaves, layer-stacked ``blocks``) -> the
    port's params on ``device`` with a per-layer ``blocks`` list.  Raises
    without a GPU unless ``device`` is ``"cpu"``."""
    if cfg.family != "dense" or "first_blocks" in tree:
        raise NotImplementedError("only the dense family is ported")
    device = resolve_device(device)
    out = {k: _convert(v, device) for k, v in tree.items() if k != "blocks"}
    n = np.asarray(tree["blocks"]["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"blocks hold {n} layers, config has "
                         f"{cfg.n_layers}")
    out["blocks"] = [_convert(tree["blocks"], device, i) for i in range(n)]
    return out


def pool_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference paged KV pool (numpy leaves (L, N, block, ...) under
    ``blocks``) -> the port's pool ``{"blocks": [per-layer {"k", "v"[,
    "k_scale", "v_scale"]}]}`` on ``device``.  Raises without a GPU unless
    ``device`` is ``"cpu"``."""
    if cfg.family != "dense" or set(tree) != {"blocks"}:
        raise NotImplementedError("only the dense family's pool is ported")
    device = resolve_device(device)
    n = np.asarray(tree["blocks"]["k"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"pool holds {n} layers, config has "
                         f"{cfg.n_layers}")
    return {"blocks": [_convert(tree["blocks"], device, i)
                       for i in range(n)]}
