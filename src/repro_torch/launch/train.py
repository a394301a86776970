"""Training launcher: counterpart of ``repro/launch/train.py``.

On the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --steps 100 --global-batch 4 --seq 256 --ckpt-dir build/ckpt

On the CPU (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch prosparse-llama2-7b --reduced --device cpu --steps 20 \
        --global-batch 4 --seq 64 --ckpt-dir build/ckpt

On a mesh of ranks (dense family; gloo ranks of the CPU, or NCCL with a
card a rank):
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch prosparse-llama2-7b --reduced --device cpu --mesh 2x2 \
        --steps 4 --global-batch 4 --seq 32 --ckpt-dir build/ckpt

It wires the param and optimizer state, the data pipeline, checkpoints and
resume, and the straggler watchdog (``runtime/trainer.py``).  ``--mesh``
is the reference's: ``D`` (data), ``DxM`` (data, model) or ``PxDxM``
(pod, data, model); "" or "1" trains on one device.  A mesh spawns its
ranks through ``launch/ranks.py:run_ranks`` (gloo on the CPU, NCCL with
one card a rank), each places its part of the state by the reference's
train rules, and rank 0 prints.  Other families than dense raise under a
mesh (ROADMAP Queue A item 15.5).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import arch_names, get_config, \
    reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.ranks import is_rank_zero, run_ranks
from repro_torch.launch.specs import model_module
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

# every collective of a training rank, and the whole spawn, end by then
RANK_TIMEOUT = 3600.0


def parse_mesh(spec: str):
    """The reference's ``--mesh``: None for "" or "1", else (shape, axes):
    ``D`` over ('data',), ``DxM`` over ('data', 'model'), ``PxDxM`` over
    ('pod', 'data', 'model')."""
    if not spec or spec == "1":
        return None
    try:
        dims = tuple(int(x) for x in spec.split("x"))
        names = {1: ("data",), 2: ("data", "model"),
                 3: ("pod", "data", "model")}[len(dims)]
    except (ValueError, KeyError):
        raise SystemExit(f"--mesh {spec!r}: want D, DxM or PxDxM") from None
    return dims, names


def extra_batch_fn(cfg: ModelConfig, batch_size: int, device="cuda"):
    """The stub modality inputs of a step (vlm: images, encdec: frames),
    float32 draws from ``default_rng(step)`` as the reference's, on
    ``device``; None for the other families."""
    names = {"vlm": ("images", cfg.n_image_tokens),
             "encdec": ("frames", cfg.n_frames)}
    if cfg.family not in names:
        return None
    name, n = names[cfg.family]

    def fn(step):
        rng = np.random.default_rng(step)
        arr = rng.standard_normal((batch_size, n, cfg.d_model),
                                  dtype=np.float32)
        return {name: torch.from_numpy(arr).to(device)}
    return fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_names())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="",
                    help="D, DxM or PxDxM ranks (data, model, pod); '' or "
                         "'1': one device")
    ap.add_argument("--ckpt-dir", required=True,
                    help="where checkpoints go and --resume reads them")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh)
    cfg = _config(args)
    if mesh is None:
        out = _train(args)
    else:
        if cfg.family != "dense":
            raise NotImplementedError(
                f"--mesh {args.mesh!r}: {cfg.name} is of family "
                f"{cfg.family!r}; training on a mesh runs the dense family "
                "(ROADMAP Queue A item 15.5)")
        outs = run_ranks(_train_rank, mesh[0], mesh[1], args=(args,),
                         device=args.device, timeout=RANK_TIMEOUT)
        out = outs[0]
        if any(o["history"] != out["history"] for o in outs):
            raise RuntimeError("the ranks' histories differ")
    if not is_rank_zero():
        return out
    if out["resumed"] is not None:
        print(f"resumed at step {out['resumed']}")
    hist = out["history"]
    for h in hist[:3] + hist[-3:]:
        print(json.dumps(h))
    print(f"straggler steps flagged: {out['flagged']}")
    return out


def _config(args) -> ModelConfig:
    return reduced_config(args.arch) if args.reduced else get_config(
        args.arch)


def _train_rank(mesh, device, args) -> dict:
    return _train(args, mesh, device)


def _train(args, mesh=None, device=None) -> dict:
    """Build the trainer of ``args`` (on this rank of ``mesh``, on its
    ``device``), resume if asked, train, save; the history and what to
    print."""
    cfg = _config(args)
    mod = model_module(cfg)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         grad_compression=args.grad_compression)
    opt = AdamWConfig(lr_peak=args.lr,
                      warmup_steps=min(100, args.steps // 5 or 1),
                      decay_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.global_batch)
    device = device or args.device
    trainer = Trainer(mod, cfg, tcfg, opt, dcfg, device=device,
                      extra_batch=extra_batch_fn(cfg, args.global_batch,
                                                 device),
                      mesh=mesh)
    trainer.init_state()
    resumed = trainer.global_step if (
        args.resume and trainer.maybe_resume()) else None
    hist = trainer.run()
    trainer.save(blocking=True)
    return {"history": hist, "resumed": resumed,
            "flagged": trainer.watchdog.flagged}


if __name__ == "__main__":
    main()
