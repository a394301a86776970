"""Training launcher: counterpart of ``repro/launch/train.py``.

On the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --steps 100 --global-batch 4 --seq 256 --ckpt-dir build/ckpt

On the CPU (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch prosparse-llama2-7b --reduced --device cpu --steps 20 \
        --global-batch 4 --seq 64 --ckpt-dir build/ckpt

It wires the param and optimizer state, the data pipeline, checkpoints and
resume, and the straggler watchdog (``runtime/trainer.py``) on one
device.  The reference's ``--mesh`` (its placement over a device mesh) is
not ported: any value but "" or "1" raises.
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
from repro_torch.launch.specs import model_module
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def parse_mesh(spec: str) -> None:
    if spec and spec != "1":
        raise NotImplementedError(
            f"--mesh {spec!r}: the placement over several devices is not "
            "ported (ROADMAP Queue A item 15); train on one device")


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
                    help="not ported: only '' or '1' (one device)")
    ap.add_argument("--ckpt-dir", required=True,
                    help="where checkpoints go and --resume reads them")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    parse_mesh(args.mesh)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    mod = model_module(cfg)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         grad_compression=args.grad_compression)
    opt = AdamWConfig(lr_peak=args.lr,
                      warmup_steps=min(100, args.steps // 5 or 1),
                      decay_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.global_batch)
    trainer = Trainer(mod, cfg, tcfg, opt, dcfg, device=args.device,
                      extra_batch=extra_batch_fn(cfg, args.global_batch,
                                                 args.device))
    trainer.init_state()
    if args.resume and trainer.maybe_resume():
        print(f"resumed at step {trainer.global_step}")
    hist = trainer.run()
    trainer.save(blocking=True)
    for h in hist[:3] + hist[-3:]:
        print(json.dumps(h))
    print(f"straggler steps flagged: {trainer.watchdog.flagged}")


if __name__ == "__main__":
    main()
