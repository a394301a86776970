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
A LayerNorm's ``scale`` and ``bias`` leaves (any family, ``cfg.norm``)
carry over like every other leaf.
``pool_from_numpy`` does the same for a paged KV pool (the reference's
``init_kv_pool`` tree: leaves (L, N, block, ...) under ``blocks``, and
under ``first`` for a moe config's first layers).
``params_to_numpy`` is the inverse of ``params_from_numpy``: the port's
tree (params, gradients, AdamW moments) back to the reference's stacked
layout with numpy leaves, for every block list above; bfloat16 leaves
come back as float32 (exactly), since numpy has no bfloat16 of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.tree import FAMILY_LISTS, LAYER_LISTS


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
    """The port's per-layer lists of ``cfg``'s family (``FAMILY_LISTS``)
    and their lengths (0: the tree has no such list).  A dense or moe
    ``blocks`` holds every layer, a moe config's dense first ones too."""
    if cfg.family == "encdec":
        n = (cfg.n_enc_layers, cfg.n_layers)
    elif cfg.family == "hybrid":
        ae = cfg.attn_every
        n_main = cfg.n_layers // ae * ae
        n = (n_main, cfg.n_layers - n_main,
             n_main // ae if cfg.shared_lora_rank else 0)
    elif cfg.family == "xlstm":
        p = cfg.slstm_every or 4
        n = (cfg.n_layers // p * (p - 1), cfg.n_layers // p)
    elif cfg.family == "vlm":
        p = cfg.cross_every
        n = (cfg.n_layers // p * (p - 1), cfg.n_layers // p)
    else:
        n = (cfg.n_layers,)
    return dict(zip(FAMILY_LISTS[cfg.family], n, strict=True))


def _lists(tree: dict, cfg: ModelConfig, device) -> dict:
    """The stacked lists of an encdec, vlm, hybrid or xlstm tree -> one
    converted dict a layer under each list's name (dense and moe:
    ``_per_layer``)."""
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
    out = {k: _convert(v, device) for k, v in tree.items()
           if k not in LAYER_LISTS}
    if "blocks" in _block_lists(cfg):
        out["blocks"] = _per_layer(tree, cfg, ("first_blocks", "blocks"),
                                   device, "blocks")
    else:
        out.update(_lists(tree, cfg, device))
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _stack_layers(layers: list) -> dict:
    """Per-layer dicts (same keys) -> one dict of (L, ...) numpy leaves."""
    if isinstance(layers[0], dict):
        return {k: _stack_layers([d[k] for d in layers]) for k in layers[0]}
    return np.stack([_numpy(t) for t in layers])


def _to_numpy(node):
    if isinstance(node, dict):
        return {k: _to_numpy(v) for k, v in node.items()}
    return _numpy(node)


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The port's tree -> the reference's layout with numpy leaves: each
    per-layer list stacked along a leading axis under its name (a moe
    config's dense first layers split off under ``first_blocks``)."""
    names = [n for n, k in _block_lists(cfg).items() if k]
    out = {k: _to_numpy(v) for k, v in params.items() if k not in names}
    for name in names:
        layers = params[name]
        if name == "blocks" and cfg.first_dense_layers:
            nf = cfg.first_dense_layers
            out["first_blocks"] = _stack_layers(layers[:nf])
            layers = layers[nf:]
        out[name] = _stack_layers(layers)
    return out
