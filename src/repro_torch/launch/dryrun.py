"""Dry run of the shape matrix on one card: the counterpart of
``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch qwen3-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

Every (arch x shape) cell builds its parameters, inputs, caches and (train)
AdamW moments on the ``meta`` device, so nothing is allocated, and runs its
step (``launch/specs.py:make_step_fn``) once under ``launch/costs.py``'s
counters.  It writes ``results/dryrun_torch/<arch>__<shape>__h100x1.json``
(skipped when it exists, unless ``--force``; ``--out`` another directory):
the status (``ok``; ``skipped`` with the reference's reason; ``failed``
with the error: a failing cell is a bug, and the exit code is 1), the
bytes by part in the dtypes the port holds (params, optimizer state,
caches, inputs, and the peak of what the step allocates), whether the
whole fits one card at the shape's ``global_batch``, the largest batch
that fits (bytes are affine in the batch: a second run at another batch
gives the line), and ``step_cost``.  ``--all`` sweeps the reference's
assigned archs (every registered arch but ``prosparse*``); ``--arch``
reaches any.  Runs on the CPU; no card is needed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.costs import step_cost
from repro_torch.launch.mesh import HBM_PER_CARD
from repro_torch.optim.adamw import init_adamw
from repro_torch.tree import leaves, tree_bytes

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
DEVICE_NAME = "h100x1"


def affine_max(b1: int, t1: float, b2: int, t2: float, limit: float
               ) -> int:
    """The largest batch b with t(b) <= limit on the line through (b1, t1)
    and (b2, t2) (bytes against batch, which grow with it); 0 when even
    b = 1 does not fit."""
    slope = (t1 - t2) / (b1 - b2)
    return max(0, math.floor((limit - (t1 - slope * b1)) / slope))


def build(cfg, shape: ShapeConfig, device="meta"):
    """(step, its arguments, bytes by part) of a cell on ``device``."""
    step = S.make_step_fn(cfg, shape)
    inputs = S.input_specs(cfg, shape, device)
    parts = {"inputs": tree_bytes(inputs)}
    if shape.kind == "train":
        params = S.param_shapes(cfg, device=device)
        for p in leaves(params):
            p.requires_grad_(p.is_floating_point())
        opt = init_adamw(params)
        parts.update(params=tree_bytes(params),
                     opt_state=tree_bytes((opt.mu, opt.nu)))
        return step, (params, opt, inputs), parts
    params = S.param_shapes(cfg, serve=True, device=device)
    parts["params"] = tree_bytes(params)
    if shape.kind == "prefill":
        return step, (params, inputs), parts
    caches = S.cache_structs(cfg, shape, device)
    parts["caches"] = tree_bytes(caches)
    return step, (params, inputs, caches), parts


def measure(cfg, shape: ShapeConfig) -> tuple:
    """(bytes by part, step_cost, total bytes) of one meta run."""
    step, args, parts = build(cfg, shape)
    cost = step_cost(step, *args)
    return parts, cost, sum(parts.values()) + cost["transient_peak_bytes"]


def run_cell(arch: str, shape_name: str) -> dict:
    """The record of a registered arch at a shape of ``SHAPES``."""
    return cell_record(get_config(arch), SHAPES[shape_name])


def cell_record(cfg, shape: ShapeConfig) -> dict:
    """The record of ``cfg`` at ``shape`` (module docstring)."""
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": cfg.name, "shape": shape.name, "device": DEVICE_NAME,
           "kind": shape.kind, "status": None}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    parts, cost, total = measure(cfg, shape)
    b1 = shape.global_batch
    b2 = b1 // 2 if b1 > 1 else 2
    _, _, total2 = measure(cfg, dataclasses.replace(shape, global_batch=b2))
    state = sum(parts.values())
    rec.update(
        status="ok", global_batch=b1,
        bytes=dict(parts, state=state,
                   transient_peak=cost["transient_peak_bytes"],
                   total=total),
        hbm_bytes=HBM_PER_CARD, fits=total <= HBM_PER_CARD,
        fits_state=state <= HBM_PER_CARD,
        max_batch=affine_max(b1, total, b2, total2, HBM_PER_CARD),
        step_cost=cost, dry_s=round(time.time() - t0, 2))
    return rec


def cell_path(arch: str, shape_name: str, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape_name}__{DEVICE_NAME}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=arch_names())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="sweep every assigned (arch x shape) cell")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if not (args.all or args.arch):
        ap.error("give --arch or --all")
    assigned = [a for a in arch_names() if not a.startswith("prosparse")]
    archs = [args.arch] if args.arch else assigned
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            path = cell_path(arch, shape_name, args.out)
            if os.path.exists(path) and not args.force:
                print(f"[skip-cached] {arch} {shape_name}")
                continue
            try:
                rec = run_cell(arch, shape_name)
            except Exception as e:  # a failing cell is a bug
                rec = {"arch": arch, "shape": shape_name,
                       "device": DEVICE_NAME, "status": "failed",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            extra = ""
            if rec["status"] == "ok":
                b = rec["bytes"]
                extra = (f" total={b['total'] / 2**30:.2f}GiB fits="
                         f"{rec['fits']} max_batch={rec['max_batch']} "
                         f"flops={rec['step_cost']['flops']:.3g} "
                         f"dry={rec['dry_s']:.1f}s")
            elif rec["status"] == "failed":
                extra = " " + rec["error"][:200]
            print(f"[{rec['status']}] {arch} {shape_name}{extra}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
