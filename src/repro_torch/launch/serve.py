"""Serving launcher: slot-refill batched generation with SparseInfer decode.

On the GPU, at the model's published shape (random weights from --seed):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --strategy pallas
On the CPU at reduced size:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --reduced --device cpu --strategy pallas
Chunked sparse prefill with int8 MLP weights (add --reduced --device cpu
--quant-group-size 32 for the CPU):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --strategy pallas --prompt-len 96 \
        --max-len 256 --prefill-chunk 64 --sparse-prefill --weight-dtype int8
The paged KV pool (blocks of 16 tokens; with chunked prefill, prompts that
share committed blocks admit by reference):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --strategy pallas --max-len 256 \
        --prefill-chunk 64 --paged-kv 16

Prints the reference's JSON throughput report (with ``paged``: the pool's
counters, under --paged-kv).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs.base import PagedKVConfig
from repro_torch.configs.registry import arch_names, get_config, \
    reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.server import Request, Server, ServeConfig, \
    throughput_report


def parse_sla_mix(mix: str, n_requests: int) -> list:
    """``"latency:1,balanced:2"`` -> a tier name per request, interleaved
    round-robin in weight proportion."""
    pairs = []
    for part in mix.split(","):
        name, _, w = part.strip().partition(":")
        pairs.append((name, int(w) if w else 1))
    total = sum(w for _, w in pairs)
    if total <= 0 or any(w < 0 for _, w in pairs):
        raise ValueError(f"--sla-mix needs positive weights, got {mix!r}")
    out, acc = [], [0.0] * len(pairs)
    for _ in range(n_requests):
        for j, (_, w) in enumerate(pairs):
            acc[j] += w / total
        j = max(range(len(pairs)), key=lambda j: acc[j])
        acc[j] -= 1.0
        out.append(pairs[j][0])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_names())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--strategy", default=None,
                    choices=[None, "dense", "masked", "gather", "pallas"])
    ap.add_argument("--sla-mix", default="balanced:1",
                    help="comma list tier:weight (latency, balanced, "
                         "quality), e.g. latency:1,balanced:2,quality:1")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="fixed prefill chunk in tokens (must divide "
                         "--max-len); 0 = monolithic prefill.  Admissions "
                         "stream through chunks interleaved with decode "
                         "steps")
    ap.add_argument("--prefill-interleave", type=int, default=1,
                    help="max prefill chunks per decode-loop iteration "
                         "(higher = faster admission, more decode jitter)")
    ap.add_argument("--sparse-prefill", action="store_true",
                    help="sign-bit sparse prediction for prefill chunks "
                         "(one chunk-union selection per chunk; needs "
                         "--prefill-chunk)")
    ap.add_argument("--weight-dtype", default="", choices=("", "int8"),
                    help="quantize the sparse-MLP weights at load time "
                         "('int8': int8 leaves + per-group scales through "
                         "the int8 kernels; '' = float weights)")
    ap.add_argument("--quant-group-size", type=int, default=128,
                    help="quantization group width (must divide d_model "
                         "and d_ff and be a multiple of the selection "
                         "group size)")
    ap.add_argument("--paged-kv", type=int, default=0, metavar="BLOCK",
                    help="enable the paged KV pool with this block size in "
                         "tokens (0 = dense per-slot caches); prefix reuse "
                         "and sessions need the pool")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="total pool blocks (0 = auto-size to exactly fit "
                         "--batch x --max-len)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.strategy:
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, strategy=args.strategy,
            enabled=args.strategy != "dense"))
    if args.weight_dtype:
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, weight_dtype=args.weight_dtype,
            quant_group_size=args.quant_group_size))
    if args.sparse_prefill:
        if not args.prefill_chunk:
            raise SystemExit("--sparse-prefill needs --prefill-chunk "
                             "(chunk-union selection is per prefill chunk)")
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, sparse_prefill=True,
            prefill_max_tokens=max(cfg.sparse.prefill_max_tokens,
                                   args.prefill_chunk)))
    params = lm.init_lm(cfg, args.seed, device)
    srv = Server(lm, cfg, ServeConfig(
        batch=args.batch, max_len=args.max_len, max_new_tokens=args.max_new,
        prefill_chunk=args.prefill_chunk,
        prefill_interleave=args.prefill_interleave,
        paged_kv=(PagedKVConfig(block_size=args.paged_kv,
                                pool_blocks=args.pool_blocks)
                  if args.paged_kv else None)), params, device=device)
    rng = np.random.default_rng(args.seed)
    slas = parse_sla_mix(args.sla_mix, args.requests)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=args.prompt_len),
                    max_new=args.max_new, sla=slas[i])
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = srv.serve(reqs)
    rep = throughput_report(done)
    rep["wall_s"] = time.perf_counter() - t0
    rep["scheduler"] = "slot_refill"
    rep["sla_mix"] = {s: slas.count(s) for s in dict.fromkeys(slas)}
    rep["sla_applied"] = True
    rep["sparse"] = {"enabled": cfg.sparse.enabled,
                     "strategy": cfg.sparse.strategy,
                     "alpha": cfg.sparse.alpha_base,
                     "capacity_frac": round(cfg.sparse.capacity_frac, 4),
                     "weight_dtype": cfg.sparse.weight_dtype or "float"}
    if args.prefill_chunk:
        rep["prefill"] = {"chunk": args.prefill_chunk,
                          "interleave": args.prefill_interleave,
                          "sparse": bool(args.sparse_prefill),
                          "prefill_chunks_run": srv.prefill_chunks_run,
                          "prefill_chunks_skipped":
                              srv.prefill_chunks_skipped}
    if args.paged_kv:
        rep["paged"] = srv.paged_stats()
    rep["device"] = str(device)
    print(json.dumps(rep, indent=1))
    return rep


if __name__ == "__main__":
    main()
