"""Input, parameter and cache stand-ins and the step functions of every
(arch x shape x step kind) cell of the shape matrix: the counterpart of
``repro/launch/specs.py``.

The reference builds ``jax.ShapeDtypeStruct``s with their shardings; the
port builds tensors on the ``meta`` device (shapes and dtypes, no memory).
The same functions build real tensors on ``cuda`` or ``cpu``.  Its
shardings are ``param_shardings``: for a rank of a ``launch.mesh.
RankMesh``, each leaf's ``sharding.train.LeafShard`` (the whole extent,
this rank's part of it, every rank's), which ``opt_state_specs`` gives
AdamW's moments and ``train_params`` places an ``init_lm`` tree by, one
layer at a time.  The dry run places nothing: it costs one card's whole
tree (ROADMAP item 15.4).  Parameters are in the dtypes the port holds them
in, the config's ``param_dtype`` (the reference's serve shapes cast every
float leaf to bfloat16; the port's server keeps them as loaded).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, make_batch_specs
from repro_torch.models import encdec, lm, vision_lm
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update
from repro_torch.sharding import train as ST
from repro_torch.tree import flatten, tree_map, unflatten


def model_module(cfg: ModelConfig):
    """``models.vision_lm`` for the vlm family, ``models.encdec`` for
    encdec, else ``models.lm``."""
    return {"vlm": vision_lm, "encdec": encdec}.get(cfg.family, lm)


def extra_input_name(cfg: ModelConfig) -> str:
    """The stub embeddings a cross-attention family takes beside its
    tokens ("images", "frames"), else ""."""
    return {"vlm": "images", "encdec": "frames"}.get(cfg.family, "")


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """The step's inputs at the cell's ``global_batch``: int32 tokens
    (train: tokens and labels (B, S); prefill: tokens (B, S); decode: one
    new token (B, 1) against a ``seq_len`` cache) and, for the vlm and
    encdec families, bfloat16 image or frame embeddings (B, T, d).  Zeros
    on any device but ``meta``."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out: dict[str, Any] = make_batch_specs(
            DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b),
            device=device)
    else:
        out = {"tokens": torch.zeros((b, s if shape.kind == "prefill" else 1),
                                     dtype=torch.int32, device=device)}
    name = extra_input_name(cfg)
    if name:
        n = cfg.n_image_tokens if name == "images" else cfg.n_frames
        out[name] = torch.zeros((b, n, cfg.d_model), dtype=torch.bfloat16,
                                device=device)
    return out


def param_shapes(cfg: ModelConfig, serve: bool = False,
                 device="meta") -> dict:
    """The model's parameter tree (``init_lm`` with seed 0); ``serve``:
    through ``prepare_sparse`` when sparsity is on (sign packs, int8
    weights), as the server holds it."""
    mod = model_module(cfg)
    params = mod.init_lm(cfg, 0, device=device)
    if serve and cfg.sparse.enabled:
        params = mod.prepare_sparse(params, cfg.sparse)
    return params


def param_shardings(cfg: ModelConfig, mesh, mode: str = "train"):
    """The tree of ``sharding.train.LeafShard`` of the model's parameters
    on this rank of ``mesh`` by the reference's train rules ('model' and
    the data lines): each leaf's whole extent and every rank's part of it
    (the reference's ``param_shardings``; dense family).  The serve
    placement is ``sharding.sparse.serve_param_shardings``."""
    if mode != "train":
        raise ValueError(f"param_shardings mode {mode!r}: train (the serve "
                         "placement is sharding.sparse's)")
    _check_placed_family(cfg)
    return ST.layout_of(param_shapes(cfg), mesh, cfg)


def opt_state_specs(param_shards) -> AdamWState:
    """AdamW's state placed like its params: ``mu`` and ``nu`` take their
    param's ``LeafShard``, ``step`` (a host int) is the same on every
    rank (the reference's ``opt_state_specs``)."""
    return AdamWState(None, param_shards, param_shards)


def train_params(cfg: ModelConfig, mesh, seed: int = 0, device="cuda"):
    """``init_lm(cfg, seed)``'s weights, this rank's part of each leaf by
    the train rules, drawn and placed one node (a table, a block) at a
    time: the whole tree is never on the rank's device."""
    _check_placed_family(cfg)
    return model_module(cfg).init_lm(
        cfg, seed, device,
        place=lambda node: ST.place_train_params(node, mesh, cfg))


def _check_placed_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not placed on a mesh: "
            "training and serving on a mesh run the dense family (ROADMAP "
            "Queue A item 15.5)")


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, device="meta"):
    """The decode caches of the cell: ``init_caches`` at ``global_batch``
    and ``seq_len`` (each family's layout, one dict a layer)."""
    return model_module(cfg).init_caches(cfg, shape.global_batch,
                                         shape.seq_len, device=device)


def _cast_bf16(p: torch.Tensor) -> torch.Tensor:
    """Mixed precision: a float matrix is used in bfloat16, its float32
    master keeps the gradient."""
    if p.is_floating_point() and p.ndim >= 2:
        return p.to(torch.bfloat16)
    return p


def make_step_fn(cfg: ModelConfig, shape: ShapeConfig):
    """The function each cell runs, the reference's:

    - train: ``train_step(params, opt_state, batch) -> (params, opt_state,
      metrics)``: ``lm_loss`` on bfloat16-cast weights, gradients into the
      float32 masters (``params``' leaves must require grad), summed over
      ``cfg.microbatches`` equal slices of the batch and averaged, then
      ``adamw_update`` (params and moments updated in place);
    - prefill: ``prefill_step(params, batch) -> (logits, caches)`` at the
      full sequence with caches of ``seq_len``;
    - decode: ``serve_step(params, batch, caches) -> (logits, caches)``,
      one token at cache length ``seq_len - 1``.
    """
    mod = model_module(cfg)
    name = extra_input_name(cfg)

    def extra(batch) -> tuple:
        return (batch[name],) if name else ()

    if shape.kind == "train":
        opt = AdamWConfig()
        m = max(1, cfg.microbatches)

        def grads_of(params, batch):
            flat = flatten(params)
            leaves = [p for _, p in flat]
            cast = unflatten(params, [_cast_bf16(p) for p in leaves])
            loss, metrics = mod.lm_loss(cast, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), metrics, grads

        def train_step(params, opt_state, batch):
            gsum, lsum = None, 0.0
            for i in range(m):
                one = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                       for k, v in batch.items()}
                loss, metrics, grads = grads_of(params, one)
                grads = [g.float() for g in grads]
                gsum = grads if gsum is None else [
                    a + g for a, g in zip(gsum, grads)]
                lsum = lsum + loss
            grads = unflatten(params, [g / m for g in gsum])
            params, opt_state, om = adamw_update(opt, params, grads,
                                                 opt_state)
            metrics = tree_map(lambda v: v.detach(), metrics)
            return params, opt_state, dict(metrics, loss=lsum / m, **om)

        return train_step

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return mod.prefill(params, cfg, batch["tokens"],
                                   *extra(batch), max_len=shape.seq_len)
        return prefill_step

    def serve_step(params, batch, caches):
        with torch.no_grad():
            return mod.decode_step(params, cfg, batch["tokens"], caches,
                                   shape.seq_len - 1)
    return serve_step
