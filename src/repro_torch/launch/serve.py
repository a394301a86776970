"""Serving launcher: slot-refill (or legacy chunked) batched generation
with SparseInfer decode.

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
The adaptive-alpha controller, per SLA tier, on the gather strategy with a
masked audit every 4th step (on the CPU: --reduced --device cpu):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --strategy gather --controller \
        --per-tier --audit-period 4 --sla-mix latency:1,balanced:1,quality:1
Overload handling on an oversubscribed paged pool, with the metrics hub's
sinks (on the CPU: --reduced --device cpu --max-len 64 --paged-kv 8):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --strategy pallas --max-len 256 \
        --prefill-chunk 64 --paged-kv 16 --pool-blocks 18 --preempt \
        --default-deadline 30 --max-queue-depth 12 --requests 16 \
        --metrics-jsonl build/m.jsonl --metrics-trace build/t.json \
        --metrics-snapshot build/s.prom
The legacy chunked scheduler (fixed chunks of --batch run to completion,
the uniform schedule; the report says "scheduler": "chunked" and
"sla_applied": false), on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --reduced --device cpu --no-slot-refill
The sparse decode placed on a (data, model) mesh of local ranks (dense
family; ranks share the card under gloo, or take a card each under NCCL;
on the CPU add --reduced --device cpu):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch prosparse-llama2-7b --strategy gather --mesh-shape 2x2 \
        --batch 4
The cross-attention families take stub frame or image embeddings (drawn
from ``np.random.default_rng(0)``, (batch, n_frames | n_image_tokens,
d_model) float32, as the reference's CLI draws them), on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --reduced --device cpu --requests 2
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-90b --reduced --device cpu --requests 2

Prints the reference's JSON throughput report (with ``paged``: the pool's
counters, under --paged-kv; with ``controller``: its report, under
--controller; with ``metrics``: the hub's snapshot and the watchdog, under
--metrics or any --metrics-* path; with ``mesh``: the mesh, the grid and
every rank's kernel launches with their sum, each rank's parameter bytes
beside the one-device total, each rank's slot range and KV bytes beside
the one-device KV's, each rank's peak device memory (null on the CPU) and
the backend, under --mesh-shape, where rank 0's report is printed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import (ControllerConfig, MetricsConfig,
                                      PagedKVConfig)
from repro_torch.configs.registry import arch_names, get_config, \
    reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import is_rank_zero, run_ranks
from repro_torch.launch.specs import model_module
from repro_torch.runtime.server import Request, Server, ServeConfig, \
    throughput_report
from repro_torch.sharding import sparse as SSP

# seconds a --mesh-shape run, and each of its collectives, may take before
# the run fails
RANK_TIMEOUT = 3600.0


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
    ap.add_argument("--alpha", type=float, default=None,
                    help="the predictor's static alpha (the paper's knob): "
                         "sets alpha_base and alpha_early")
    ap.add_argument("--slot-refill", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="slot-refill continuous batching (default); "
                         "--no-slot-refill selects the legacy chunked "
                         "scheduler")
    ap.add_argument("--sla-mix", default="balanced:1",
                    help="comma list tier:weight (latency, balanced, "
                         "quality), e.g. latency:1,balanced:2,quality:1")
    ap.add_argument("--controller", action="store_true",
                    help="adapt per-layer alpha online toward "
                         "--target-density")
    ap.add_argument("--per-tier", action="store_true",
                    help="one controller (alpha vector, density target) per "
                         "SLA tier")
    ap.add_argument("--target-density", type=float, default=0.25)
    ap.add_argument("--ctrl-gain", type=float, default=0.5)
    ap.add_argument("--audit-period", type=int, default=8,
                    help="a masked-strategy audit step (exact false "
                         "negatives) every N decode steps; 0 = none "
                         "(pallas never audits)")
    ap.add_argument("--adapt-capacity", action="store_true",
                    help="re-size the capacity at refill boundaries from "
                         "the observed demand (superseded by "
                         "--capacity-buckets)")
    ap.add_argument("--capacity-buckets", default="",
                    help="comma list of capacity fractions forming the "
                         "bucket ladder, e.g. 0.125,0.25,0.5: the "
                         "controller picks a bucket between decode steps "
                         "(gather, pallas)")
    ap.add_argument("--warm-buckets", action="store_true",
                    help="run every capacity bucket's decode step once "
                         "before the first controller step")
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
                         "--batch x --max-len; fewer oversubscribe the "
                         "pool)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="requests beyond this queue depth shed at once "
                         "(outcome shed, reason queue_depth; 0 = "
                         "unbounded)")
    ap.add_argument("--default-deadline", type=float, default=0.0,
                    help="seconds after admission before a request with no "
                         "deadline of its own sheds (0 = none)")
    ap.add_argument("--preempt", action="store_true",
                    help="tier-aware preemption on pool exhaustion: park the "
                         "lowest-priority slot's prompt blocks in the trie "
                         "and requeue it (its resume admits them by "
                         "reference); needs --paged-kv")
    ap.add_argument("--pressure-gate", type=float, default=1.0,
                    help="defer admissions while pool pressure is at or "
                         "above this fraction (1.0 = off; 0.8-0.95 is the "
                         "useful range)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the metrics hub (counters, gauges, "
                         "histograms, the first-use watchdog) without file "
                         "sinks; any --metrics-* path implies it")
    ap.add_argument("--metrics-jsonl", default="", metavar="PATH",
                    help="append the serve's events as JSON lines")
    ap.add_argument("--metrics-trace", default="", metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "serve phases")
    ap.add_argument("--metrics-snapshot", default="", metavar="PATH",
                    help="write a Prometheus-style text exposition of every "
                         "instrument at each drain")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--controller-ckpt", default="", metavar="DIR",
                    help="directory for controller checkpoints: the server "
                         "restores the latest at startup (alpha and EMA "
                         "state survive restarts) and writes one after the "
                         "serve")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", default="",
                    help="the reference's GSPMD weights-TP mesh: not ported "
                         "(ROADMAP Queue A item 15); use --mesh-shape")
    ap.add_argument("--mesh-shape", default="",
                    help="serve the sparse decode on a mesh of local ranks, "
                         "DxM (data x model), e.g. 2x2 (batch slots split "
                         "2 ways over 'data': each line decodes and keeps "
                         "the KV of its B/D slots; the FFN hidden dim, the "
                         "heads and the vocabulary 2 ways over 'model'), "
                         "or M (model only); the report gives every rank's "
                         "slot range and KV bytes (dense family)")
    args = ap.parse_args(argv)
    if args.mesh:
        if args.mesh_shape:
            raise SystemExit("--mesh and --mesh-shape are exclusive: the "
                             "rank mesh owns the placement it runs on")
        raise NotImplementedError(
            f"--mesh {args.mesh!r}: the GSPMD mesh is not ported (ROADMAP "
            "Queue A item 15); use --mesh-shape")
    device = resolve_device(args.device)
    if args.mesh_shape:
        try:
            dims = tuple(int(v) for v in args.mesh_shape.split("x"))
        except ValueError:
            raise SystemExit(f"--mesh-shape {args.mesh_shape!r}: want M or "
                             "DxM") from None
        axes = ("model",) if len(dims) == 1 else ("data", "model")
        rep = run_ranks(_serve_rank, dims, axes, args=(args,),
                        device=args.device, timeout=RANK_TIMEOUT)[0]
    else:
        rep = _serve(args, device)
    if is_rank_zero():
        print(json.dumps(rep, indent=1))
    return rep


def _serve_rank(mesh, device, args) -> dict:
    return _serve(args, device, mesh)


def _serve(args, device, mesh=None) -> dict:
    """Build the config, the weights (placed a layer at a time on a mesh
    rank), the server and the requests of ``args``; serve; the report."""
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.strategy:
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, strategy=args.strategy,
            enabled=args.strategy != "dense"))
    if args.alpha is not None:
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, alpha_base=args.alpha, alpha_early=args.alpha))
    if args.capacity_buckets:
        cfg = cfg.replace(sparse=dataclasses.replace(
            cfg.sparse, capacity_buckets=tuple(
                float(v) for v in args.capacity_buckets.split(","))))
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
    mod = model_module(cfg)
    kw, extra = {}, {}
    if mesh is not None:
        # a rank's part of each table and layer, kept as it is drawn
        kw["place"] = lambda node: SSP.place_serve_params(node, mesh, cfg)
        extra["mesh"] = mesh
    params = mod.init_lm(cfg, args.seed, device, **kw)
    # the cross-attention families' stub frames or images
    if cfg.family in ("vlm", "encdec"):
        name, n = (("images", cfg.n_image_tokens) if cfg.family == "vlm"
                   else ("frames", cfg.n_frames))
        extra["extra_inputs"] = {name: np.random.default_rng(0)
                                 .standard_normal((args.batch, n, cfg.d_model),
                                                  dtype=np.float32)}
    ccfg = ControllerConfig(enabled=args.controller,
                            target_density=args.target_density,
                            gain=args.ctrl_gain,
                            audit_period=args.audit_period,
                            adapt_capacity=args.adapt_capacity,
                            per_tier=args.per_tier)
    mcfg = MetricsConfig(
        enabled=bool(args.metrics or args.metrics_jsonl or args.metrics_trace
                     or args.metrics_snapshot),
        jsonl_path=args.metrics_jsonl, trace=bool(args.metrics_trace),
        trace_path=args.metrics_trace, snapshot_path=args.metrics_snapshot)
    srv = Server(mod, cfg, ServeConfig(
        batch=args.batch, max_len=args.max_len, max_new_tokens=args.max_new,
        slot_refill=args.slot_refill, controller=ccfg,
        warm_buckets=args.warm_buckets,
        prefill_chunk=args.prefill_chunk,
        prefill_interleave=args.prefill_interleave,
        paged_kv=(PagedKVConfig(block_size=args.paged_kv,
                                pool_blocks=args.pool_blocks)
                  if args.paged_kv else None),
        max_queue_depth=args.max_queue_depth,
        default_deadline_s=args.default_deadline, preempt=args.preempt,
        pressure_gate=args.pressure_gate, metrics=mcfg,
        controller_ckpt=args.controller_ckpt), params,
        device=device, **extra)
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
    rep["scheduler"] = "slot_refill" if args.slot_refill else "chunked"
    rep["sla_mix"] = {s: slas.count(s) for s in dict.fromkeys(slas)}
    # the chunked scheduler decodes every chunk on the uniform schedule
    rep["sla_applied"] = bool(args.slot_refill)
    rep["sparse"] = {"enabled": cfg.sparse.enabled,
                     "strategy": cfg.sparse.strategy,
                     "alpha": cfg.sparse.alpha_base,
                     # srv.cfg: --adapt-capacity may have moved it
                     "capacity_frac": round(srv.cfg.sparse.capacity_frac, 4),
                     "weight_dtype": cfg.sparse.weight_dtype or "float"}
    if cfg.sparse.capacity_buckets:
        rep["sparse"]["capacity_buckets"] = list(
            cfg.sparse.capacity_ladder(cfg.d_ff))
        rep["sparse"]["active_bucket"] = getattr(srv, "_active_cap", None)
    if args.prefill_chunk:
        rep["prefill"] = {"chunk": args.prefill_chunk,
                          "interleave": args.prefill_interleave,
                          "sparse": bool(args.sparse_prefill),
                          "prefill_chunks_run": srv.prefill_chunks_run,
                          "prefill_chunks_skipped":
                              srv.prefill_chunks_skipped}
    if args.paged_kv:
        rep["paged"] = srv.paged_stats()
    if srv.controller is not None:
        rep["controller"] = srv.controller.report()
    if mcfg.enabled:
        rep["metrics"] = srv.metrics_report()
        rep["metrics"]["sinks"] = {
            k: v for k, v in (("jsonl", args.metrics_jsonl),
                              ("trace", args.metrics_trace),
                              ("snapshot", args.metrics_snapshot)) if v}
        srv.metrics.close()
    rep["device"] = str(device)
    if mesh is not None:
        sp = srv.cfg.sparse
        peaks = [None] * mesh.size
        dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None,
                               group=mesh.host_group)
        rep["mesh"] = {"shape": list(mesh.shape),
                       "axes": list(mesh.axis_names),
                       "backend": dist.get_backend(),
                       "grid": [sp.dp_shards, sp.tp_shards],
                       "launches": srv.mesh_launch_counts(),
                       "param_bytes": srv.mesh_param_bytes(),
                       "slots": srv.mesh_slots(),
                       "peak_bytes": peaks}
    return rep


if __name__ == "__main__":
    main()
