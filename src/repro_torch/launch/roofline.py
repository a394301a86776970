"""Roofline over the dry run's records on one card: the counterpart of
``repro/launch/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--json] [--dir D]

Two terms per (arch x shape), at the H100's constants
(``launch/mesh.py``):

  compute = step FLOPs / 989 TF/s (dense bfloat16)
  memory  = step HBM bytes / 3.35 TB/s

from ``step_cost`` in each ``results/dryrun_torch/*__h100x1.json``.  One
card has no collective term.  MODEL_FLOPS = 6·N·D (train) or 2·N·D
(prefill, decode), N the (active, for MoE) parameter count, D the tokens
of the step; MODEL/step FLOPs shows what remat and the whole-cell
attention add.  ``roofline_fraction`` is the useful model math at peak
over the dominant term; ``fits_hbm_state``: params, optimizer state,
caches and inputs fit the card's memory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import DEVICE_NAME, RESULTS_DIR
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16


def model_flops(arch: str, shape_name: str) -> float:
    """6·N·D (train) or 2·N·D, N the (active) params, D the tokens."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch       # one token a sequence


def analyze_cell(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    cost = rec["step_cost"]
    terms = {"compute_s": cost["flops"] / PEAK_FLOPS_BF16,
             "memory_s": cost["bytes"] / HBM_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    return {
        "arch": rec["arch"], "shape": rec["shape"], "kind": rec["kind"],
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "step_flops": cost["flops"],
        "useful_flops_ratio": round(mf / max(cost["flops"], 1.0), 4),
        "roofline_fraction": round(
            (mf / PEAK_FLOPS_BF16) / max(max(terms.values()), 1e-12), 4),
        "state_bytes": rec["bytes"]["state"],
        "total_bytes": rec["bytes"]["total"],
        "fits_hbm_state": bool(rec["fits_state"]),
        "fits": bool(rec["fits"]),
        "max_batch": rec["max_batch"],
    }


def whats_next(row: dict) -> str:
    """One sentence: what would move the dominant term down."""
    if row["dominant"] == "memory":
        if row["kind"] == "decode":
            return ("decode is weight/KV-bandwidth bound: SparseInfer row "
                    "skipping + int8 KV cut the bytes (the paper's regime)")
        return "increase arithmetic intensity: larger batch or fuse"
    if row["useful_flops_ratio"] < 0.4:
        return ("compute is remat/attention-heavy: relax the checkpoint "
                "policy or skip masked attention blocks (useful ratio "
                f"{row['useful_flops_ratio']})")
    return "near compute-bound: only kernel-level tensor-core use left"


def full_table(results_dir: str = RESULTS_DIR) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(
            results_dir, f"*__{DEVICE_NAME}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "skipped": rec["reason"][:60]})
            continue
        row = analyze_cell(rec)
        if row:
            row["next"] = whats_next(row)
            rows.append(row)
        else:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "failed": rec.get("error", "?")[:80]})
    return rows


def markdown_table(rows: list[dict]) -> str:
    out = ["| arch | shape | compute s | memory s | dominant | MODEL/step "
           "flops | roofline frac | state GiB | total GiB | fits | max "
           "batch |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | skipped: "
                       f"{r['skipped']} | — | — | — | — | — | — |")
            continue
        if "failed" in r:
            out.append(f"| {r['arch']} | {r['shape']} | FAILED "
                       f"{r['failed']} | | | | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} | "
            f"{r['memory_s']:.4g} | {r['dominant']} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{r['state_bytes'] / 2**30:.2f} | "
            f"{r['total_bytes'] / 2**30:.2f} | "
            f"{'y' if r['fits'] else 'NO'} | {r['max_batch']} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = full_table(args.dir)
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    print(markdown_table(rows))
    for r in rows:
        if "next" in r:
            print(f"- {r['arch']} × {r['shape']}: {r['next']}")


if __name__ == "__main__":
    main()
