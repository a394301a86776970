"""Carry a reference parameter tree over to the port.

The JAX package's ``init_lm`` stacks every layer's leaves along a leading
(L, ...) axis under ``params["blocks"]`` (a moe config's dense first layers
apart, under ``params["first_blocks"]``; an encoder-decoder's under
``enc_blocks`` and ``dec_blocks``; a vlm's under ``self_blocks`` and
``cross_blocks``, the cross blocks' gates as (n_groups,) leaves; a
hybrid config's Mamba2 layers under ``mamba`` and ``mamba_tail`` and its
LoRAs under ``lora``, one a shared-block invocation, beside the one
unstacked ``shared`` block; an xlstm config's under ``mlstm`` and
``slstm``); the port keeps one dict per layer, in layer order, in a list
of the same name.
``params_from_numpy`` takes that tree with numpy leaves (a caller converts
with ``jax.tree.map(np.asarray, params)``) and returns the port's params.
It imports nothing of JAX: a bfloat16 leaf arrives as an ``ml_dtypes``
numpy array and is widened to float32 (exactly) before the cast back.
A quantized MLP node (the reference's ``prepare_sparse`` with int8 weights:
int8 leaves, float32 scales and the int32 ``sign_wg``) carries over leaf
for leaf, in its own dtypes; an MoE node (router, expert stacks
(E, f, d), their sign pack, the shared expert) carries over the same way.
``pool_from_numpy`` does the same for a paged KV pool (the reference's
``init_kv_pool`` tree: leaves (L, N, block, ...) under ``blocks``, and
under ``first`` for a moe config's first layers).
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


def _n_stacked(node) -> int:
    """The leading (layer) extent of a stacked subtree."""
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.asarray(node).shape[0]


def _block_lists(cfg: ModelConfig) -> dict:
    """The stacked lists of an encdec, vlm, hybrid or xlstm tree and their
    lengths (0: the tree has no such list)."""
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
    if cfg.family == "hybrid":
        ae = cfg.attn_every
        n_main = cfg.n_layers // ae * ae
        return {"mamba": n_main, "mamba_tail": cfg.n_layers - n_main,
                "lora": n_main // ae if cfg.shared_lora_rank else 0}
    if cfg.family == "xlstm":
        p = cfg.slstm_every or 4
        return {"mlstm": cfg.n_layers // p * (p - 1),
                "slstm": cfg.n_layers // p}
    p = cfg.cross_every
    return {"self_blocks": cfg.n_layers // p * (p - 1),
            "cross_blocks": cfg.n_layers // p}


def _lists(tree: dict, cfg: ModelConfig, device) -> dict:
    """The stacked lists of an encdec, vlm, hybrid or xlstm tree -> one
    converted dict a layer under each list's name."""
    out = {}
    for name, n in _block_lists(cfg).items():
        got = _n_stacked(tree[name]) if name in tree else 0
        if got != n:
            raise ValueError(f"{name} hold {got} layers, config "
                             f"{cfg.name} has {n}")
        if n:
            out[name] = [_convert(tree[name], device, i) for i in range(n)]
    return out


def _per_layer(tree: dict, cfg: ModelConfig, stacks: tuple, device,
               what: str) -> list:
    """The stacked subtrees ``stacks`` (first layers, then the rest) ->
    one converted dict a layer, in layer order."""
    fam = ("dense", "moe")
    if cfg.family not in fam:
        raise NotImplementedError(
            f"family {cfg.family!r}: a per-layer {what!r} list is "
            f"{fam}'s (the other families keep their own lists, and have "
            "no paged pool)")
    first = stacks[0]
    if (first in tree) != bool(cfg.first_dense_layers):
        raise ValueError(f"{what}: {first!r} present must match "
                         f"first_dense_layers={cfg.first_dense_layers}")
    layers = []
    for name in stacks:
        if name in tree:
            layers += [_convert(tree[name], device, i)
                       for i in range(_n_stacked(tree[name]))]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{what} hold {len(layers)} layers, config has "
                         f"{cfg.n_layers}")
    return layers


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference params (numpy leaves, layer-stacked ``blocks`` and, for a
    moe config's dense first layers, ``first_blocks``) -> the port's
    params on ``device`` with a per-layer ``blocks`` list (encdec, vlm,
    hybrid and xlstm: per-layer lists under their stacks' names).  Raises
    without a GPU unless ``device`` is ``"cpu"``."""
    device = resolve_device(device)
    if cfg.family in ("encdec", "vlm", "hybrid", "xlstm"):
        names = _block_lists(cfg)
        out = {k: _convert(v, device) for k, v in tree.items()
               if k not in names}
        out.update(_lists(tree, cfg, device))
        return out
    out = {k: _convert(v, device) for k, v in tree.items()
           if k not in ("first_blocks", "blocks")}
    out["blocks"] = _per_layer(tree, cfg, ("first_blocks", "blocks"),
                               device, "blocks")
    return out


def pool_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference paged KV pool (numpy leaves (L, N, block, ...) under
    ``blocks``, a moe config's first layers under ``first``) -> the port's
    pool ``{"blocks": [per-layer {"k", "v"[, "k_scale", "v_scale"]}]}`` on
    ``device``.  Raises without a GPU unless ``device`` is ``"cpu"``."""
    device = resolve_device(device)
    if not set(tree) <= {"first", "blocks"}:
        raise ValueError(f"pool tree keys {sorted(tree)}: want 'blocks' "
                         "and, with first_dense_layers, 'first'")
    return {"blocks": _per_layer(tree, cfg, ("first", "blocks"), device,
                                 "pool")}
