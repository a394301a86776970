"""Walks over the port's parameter trees: nested dicts (walked in sorted
key order, as ``jax.tree`` walks the reference's) and lists (in order);
anything else is a leaf (a tensor, a numpy array, a tuple).

The reference stacks each layer's leaves along a leading axis; the port
keeps one dict a layer in a list (``FAMILY_LISTS``, the one table of
them: ``bridge`` stacks and unstacks by it).  Where a per-leaf rule
of the reference reads the stacked leaf (AdamW's decay by rank, int8
compression's per-tensor scale), ``reference_ndim`` and
``reference_groups`` give the port's leaves that reading."""
from __future__ import annotations

from typing import Any, Callable


# each family's per-layer lists, in the order the bridge stacks them: the
# reference stacks each along a leading axis (a moe config's dense first
# layers apart, under "first_blocks")
FAMILY_LISTS = {
    "dense": ("blocks",), "moe": ("blocks",),
    "encdec": ("enc_blocks", "dec_blocks"),
    "vlm": ("self_blocks", "cross_blocks"),
    "hybrid": ("mamba", "mamba_tail", "lora"),
    "xlstm": ("mlstm", "slstm")}
LAYER_LISTS = frozenset({"first_blocks"}.union(*FAMILY_LISTS.values()))


def flatten(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in walk order; a path is a tuple of dict keys and
    list indices."""
    out: list = []
    _walk(tree, (), out)
    return out


def _walk(node, path: tuple, out: list) -> None:
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``out`` (and so every leaf) until the cycle collector
    # runs
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk(v, path + (i,), out)
    else:
        out.append((path, node))


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a nested dict / list / tuple tree
    (``meta`` tensors too: their shapes and dtypes)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    return 0


def path_str(path: tuple) -> str:
    """``("blocks", 0, "attn", "wq")`` -> ``"blocks/0/attn/wq"``."""
    return "/".join(str(p) for p in path)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in walk
    order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_build(v, it) for v in node]
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def reference_ndim(path: tuple, leaf) -> int:
    """A leaf's rank in the reference's layer-stacked layout: its own plus
    one inside a per-layer list."""
    stacked = any(isinstance(p, str) and p in LAYER_LISTS for p in path)
    return leaf.ndim + int(stacked)


def reference_groups(tree) -> list:
    """Per leaf in walk order, the key of the reference's stacked leaf it
    is a layer of (a leaf outside the per-layer lists is its own).  Layers
    of one list whose dicts hold other keys stack apart: a moe config's
    dense first layers (an ``"mlp"`` node) are the reference's
    ``first_blocks``, its MoE layers (``"moe"``) its ``blocks``."""
    keys = []
    for path, _ in flatten(tree):
        key = path
        for i, p in enumerate(path[:-1]):
            if isinstance(p, str) and p in LAYER_LISTS and \
                    isinstance(path[i + 1], int):
                layer = tree
                for q in path[:i + 2]:
                    layer = layer[q]
                kinds = tuple(sorted(layer)) if isinstance(layer, dict) \
                    else ()
                key = path[:i + 1] + (kinds,) + path[i + 2:]
                break
        keys.append(key)
    return keys
