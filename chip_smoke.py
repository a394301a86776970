#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build   nvcc-compile every kernel source in src/repro_torch/csrc/.
  2. kernels each CUDA kernel against its plain PyTorch version on the card
             at prosparse-llama2-7b's full width (d=4096, k=11008, G=8,
             C=288, int8 quant groups of 128): the decode kernels at B in
             {1, 4, 16}, alpha in {1.0, 1.03, per-slot with a dead slot};
             the chunk kernels at S in {17, 64, 128, 256} rows with pad
             rows (each run twice and bitwise equal); the int8
             decode kernel at B in {1, 4, 16}; small-shape edge cases; a
             decode batch of 24 through the ops layer.  Each is timed at
             the main path's shape beside its bound, its plain version and
             a library yardstick where one PyTorch call computes it (the
             float32 chunk MLP: three matmuls on the selected rows gathered
             beforehand, and on all rows; the int8 one beside the float32
             one at the same shape); then the float32 and the int8 chunk
             MLPs' scaling lines, S in {16, 32, 64, 128, 256} at the full
             and a third of the selection (and none at S=64), each with
             the kernel's phase trace of one launch.
  3. decode  prosparse-llama2-7b at full width, 2 layers, float32 compute
             and KV cache: 8 teacher-forced decode steps on the card against
             the same weights on the CPU (plain kernel versions), logits and
             stats.
  4. prefill the same 2 layers: a 160-token prompt in chunks of 64 through
             sparse prefill on the card against the CPU, with float32 and
             with int8 MLP weights.
  5. serve   prosparse-llama2-7b at full width and all 32 layers through
             Server.serve (strategy pallas, batch 4, 8 requests, mixed SLA
             tiers); the kernel launch counters must show two launches per
             sparse MLP per decode step.
  6. serve-chunked  the same model with chunked sparse prefill (chunks of
             64, 96-192-token prompts), once with float32 and once with int8
             MLP weights; the counters must show two launches per sparse MLP
             per decode step and per prefill chunk.
  7. paged kernels  paged_attention and paged_kv_write against their plain
             versions at full width (H = K = 32, hd = 128, block 16): B in
             {1, 4, 16}, max_len 256 and 2048, fragmented tables with a shared
             block, lengths 0, a block boundary and max_len - 1, bf16 and
             float32 pools; edges (GQA rep 2-8 and 48, softcap, window,
             block 1/8/32, hd 64/256, and the cluster split's boundaries:
             idle CTAs, spans ending on a tile of every CTA, windows of 1
             row and of the last segment, none live, rep 8 at max_len
             8192), each run twice and bitwise equal; the write bitwise
             with collisions.  Each is timed at the main path's shape (B=4,
             bf16 pool, 64-192 live tokens) beside its bound, its plain
             version and a library call (attention: SDPA on a view gathered
             beforehand, and gather + SDPA); the attention also with one
             live row per slot, at doubled and equal lengths (its scaling),
             at every cluster size, and at a long-context shape (B=16,
             max_len 4096, lengths 512-4095) with its share of the bound.
  8. paged decode  2 full-width float32 layers against a fragmented float32
             pool, 8 teacher-forced steps: the kernel route on the card
             against the plain route on the CPU and the gather route on the
             card.
  9. serve-paged  all 32 layers through Server.serve with the paged KV pool
             (bf16 pool, block 16, paged_attn_kernel, chunked sparse
             prefill): a shared 128-token system prompt admitted by
             reference, a second serve() of two sessions' turn 2, exact
             launch counts, and a reused-prefix request's tokens equal to a
             fresh server's.
 10. sign kernels  sign_pack and predict_counts against their plain versions,
             bitwise, at full width: the gate weights (11008 x d) and x at B
             in {1, 4, 16, 24, 64} (64: a gather prefill chunk) plus a
             (G, B, d) batch, float32 and bf16, d in
             {4096, 4000} (a padded last word), zeros and -0.0 in the input;
             predict_margins bitwise against core.predictor.margins at alpha
             in {1.0, 1.03, per-slot with a dead slot}.  Timed at the main
             path's shapes (x at B=4, the gate weights at load, counts at
             B=4) beside their bounds and plain versions; no PyTorch call
             packs bits or counts popcounts, so no library yardstick.
 11. strategies  the 2 full-width float32 layers of phase 3 with strategies
             masked and gather, 8 teacher-forced steps on the card against
             the CPU: logits within 1e-3, stats reported, launches exact;
             then a 64-row gather sparse-prefill chunk (the controller
             serve's chunk MLP), card against CPU, logits within 1e-3.
 12. serve-controller  all 32 layers through Server.serve with the
             adaptive-alpha controller per SLA tier (batch 4, 8 requests of
             mixed tiers, chunked sparse prefill feeding the prefill rider,
             a warmed 3-rung capacity ladder): strategy gather with a masked
             audit every 4th step, then strategy pallas (native false
             negatives, no audits).  Launch counts exact from load to
             drain; audits, bucket sequence and the controller's report
             printed; a profile of a gather step and of a masked audit step.
             With random weights the union demand stays near 1, so the
             ladder holds its top rung through the serve; a forced low
             demand estimate must then select the lowest rung.
 13. report  a {"kernels": [...]} line, then {"ok": true, "device": ...}.

It exits non-zero without a GPU, and without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate
# outside the tensor cores (where most kernels' arithmetic runs) and the
# dense TF32 and bf16 tensor-core rates (the chunk MLPs' products)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12

SLEEP_CYCLES = 10_000_000   # ~5 ms at the H100's ~1.98 GHz SM clock

D, K, G = 4096, 11008, 8
QG = 128                  # int8 quant group width
BATCHES = (1, 4, 16)
CHUNK_ROWS = (17, 64, 128, 256)
SCALING_ROWS = (16, 32, 64, 128, 256)   # the chunk MLP's scaling line
MAIN_BATCH = 4            # the serve phase's batch: the main path's shape
MAIN_CHUNK = 64           # the chunked serve phase's prefill chunk
PAGE_BLOCK = 16           # the paged pool's block size
PAGED_NBPS = (16, 128)    # blocks per slot: max_len 256 and 2048
MAIN_LIVE = (64, 100, 150, 192)   # the timed paged shape's slot lengths
# the port's kernels by namespace (profiler rows)
OWN_KERNELS = ("mlp::", "predict::", "paged::", "paged_write::", "sign::",
               "counts::")
D_PAD = 4000              # a width that is not a multiple of 32
# capacity fractions of the controller serve's ladder: 144, 288 and 560 of
# the 1376 row groups
CTRL_BUCKETS = (0.1, 0.2, 0.4)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def cuda_ms(fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` in ms, with the host out of the way:
    before each timed call the stream first sleeps (``torch.cuda._sleep``,
    ~5 ms) so that the host has enqueued the whole call behind the sleep,
    and the CUDA events around the call bracket device work only (a call
    that synchronizes inside still waits for the host after that point).
    With ``flush`` (a callable that evicts the L2) each call follows a
    flush, so the kernel finds its inputs in HBM as inside a decode step."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def tc_bound_ms(n_bytes: float, tf32_flops: float,
                bf16_flops: float = 0.0) -> tuple[float, str]:
    """bound_ms for the tensor-core chunk MLPs: the flops of the TF32 passes
    the kernel runs (each product of split operands takes one pass a pair
    of parts) at the TF32 dense peak, plus those of its bf16 products at
    the bf16 peak."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = tf32_flops / TF32_OPS_PER_S + bf16_flops / BF16_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def chunk_q_work(rows: int, count: int, cap: int, xbytes: int,
                 sel_rows) -> tuple[int, int, int, int]:
    """Bytes, flops, TF32-pass flops and bf16 flops of one int8 chunk-MLP
    call: count*G int8 rows of the three matrices, their gate/up scales,
    one wd scale row per quant row-group the selection touches, x, the
    selection and its count read once, y written once; 6 flops per token,
    selected row and column.  The passes: gate and up one bf16 product each
    with bf16 x (int8 and bf16 x exact), two TF32 passes each with float32
    x (x split); down two TF32 passes (h split, float32)."""
    import torch
    q_rows = int(torch.unique(sel_rows // (QG // G)).numel())
    n_bytes = (3 * count * G * D + 2 * count * G * (D // QG) * 4
               + q_rows * D * 4 + rows * D * xbytes + cap * 4 + 4
               + rows * D * 4)
    mat = 2 * rows * count * G * D
    if xbytes == 2:
        return n_bytes, 3 * mat, 2 * mat, 2 * mat
    return n_bytes, 3 * mat, 6 * mat, 0


def chunk_mlp_work(rows: int, count: int, cap: int,
                   xbytes: int) -> tuple[int, int]:
    """Bytes and flops of one chunk-MLP call: count*G rows of the three
    float32 matrices, x, the selection and its count read once, y written
    once; 6 flops per token, selected row and column."""
    n_bytes = (3 * count * G * D * 4 + rows * D * xbytes + cap * 4 + 4
               + rows * D * 4)
    return n_bytes, 6 * rows * count * G * D


def _gathered_mlp(wg, wu, wd, sel_rows):
    """The library yardstick of the chunk MLP: the selected rows of the
    three matrices gathered beforehand, then three float32 matmuls."""
    import torch
    take = [m.reshape(K // G, G, D)[sel_rows].reshape(-1, D).contiguous()
            for m in (wg, wu, wd)]
    return lambda x: (torch.relu(x @ take[0].T) * (x @ take[1].T)) @ take[2]


def phase_chunk_scaling(traced: bool = True) -> None:
    """The float32 chunk MLP's time against the chunk's rows S and against
    the selected rows (count full and a third of it; none at S=64, the
    fixed cost), bf16 x, beside its bounds and the gathered-rows library
    yardstick at each point: whether the time follows S x rows
    (operations) or the rows alone (bytes or latency).  One more launch at
    each point records the kernel's phase trace (KF.phase_times).  Then a
    contiguous read of the same weight bytes by one PyTorch reduction: the
    rate a plain read reaches on this card.  Then the same line for the
    int8 chunk MLP on the same weights quantized (qg=128; no PyTorch call
    computes it), and a contiguous read of its weight bytes.  ``traced``
    False leaves out the traced launches (for kernels that take no trace);
    run alone from a script that puts a checkout's ``src`` on sys.path, it
    times that checkout's kernels."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    cap = SparseInferConfig().capacity(K)
    x0 = torch.randn((MAIN_CHUNK, D), generator=gen, device=dev)
    gm, _ = KP.predict_chunk_group_margins(
        P.pack_signs(wg), x0, torch.ones(MAIN_CHUNK, device=dev),
        d_valid=D, group_size=G)
    sel = S.capacity_select(S.union_margin(gm), cap)
    full = int(sel.count)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for rows in SCALING_ROWS:
        x = torch.randn((rows, D), generator=gen, device=dev).to(
            torch.bfloat16)
        xf = x.float()
        for count in (full, full // 3, 0):
            if count == 0 and rows != MAIN_CHUNK:
                continue
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            t = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(
                x, wg, wu, wd, sel.indices, cnt, group_size=G), flush=flush)
            lib = _gathered_mlp(wg, wu, wd, sel.indices[:count].long())
            t_lib = cuda_ms(lambda: lib(xf), flush=flush)
            n_bytes, flops = chunk_mlp_work(rows, count, cap, 2)
            tc = tc_bound_ms(n_bytes, 2 * flops)
            cc = bound_ms(n_bytes, flops)
            phases = "not traced"
            if traced:   # one more launch with its phase trace, L2 flushed
                trace = torch.zeros(
                    (KF.chunk_plan(x, cap * G).grid, KF.TRACE_POINTS),
                    dtype=torch.int64, device=dev)
                flush()
                KF.fused_sparse_mlp_chunk(x, wg, wu, wd, sel.indices, cnt,
                                          group_size=G, trace=trace)
                phases = " ".join(f"{k} {v:.4f}" for k, v in
                                  KF.phase_times(trace).items())
            print(f"[scaling] fused_sparse_mlp_chunk S={rows} x=bfloat16 "
                  f"count={count}/{cap}: kernel {t:.4f} ms, gathered-rows "
                  f"3-matmul {t_lib:.4f} ms, bound {tc[0]:.4f} ms "
                  f"({tc[1]}, TF32 x2 passes) / {cc[0]:.4f} ms ({cc[1]}, "
                  f"CUDA cores); one traced launch, ms: {phases}",
                  flush=True)
    # what a plain read of the same bytes takes on this card: one PyTorch
    # reduction over a contiguous buffer of the three matrices' selected
    # rows (113 MB at the full selection)
    n_bytes, _ = chunk_mlp_work(MAIN_CHUNK, full, cap, 2)
    flat = torch.ones(3 * full * G * D, device=dev)
    t_read = cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[scaling] a contiguous read of the selected weights' "
          f"{3 * full * G * D * 4 / 1e6:.1f} MB (torch.sum): {t_read:.4f} ms,"
          f" {3 * full * G * D * 4 / t_read / 1e9:.3f} TB/s (bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del flat
    # ---- the int8 chunk MLP on the same weights, quantized (qg=128)
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    qargs = [qn[n] for n in QNAMES]
    del wg, wu, wd
    for rows in SCALING_ROWS:
        x = torch.randn((rows, D), generator=gen, device=dev).to(
            torch.bfloat16)
        for count in (full, full // 3, 0):
            if count == 0 and rows != MAIN_CHUNK:
                continue
            cnt = torch.tensor(count, dtype=torch.int32, device=dev)
            t = cuda_ms(lambda: KF.fused_sparse_mlp_chunk_q(
                x, *qargs, sel.indices, cnt, group_size=G), flush=flush)
            n_bytes, flops, tf32, bf16 = chunk_q_work(
                rows, count, cap, 2, sel.indices[:count].long())
            tc = tc_bound_ms(n_bytes, tf32, bf16)
            cc = bound_ms(n_bytes, flops)
            phases = "not traced"
            if traced:
                trace = torch.zeros(
                    (KF.chunk_plan(x, cap * G, 1, G).grid, KF.TRACE_POINTS),
                    dtype=torch.int64, device=dev)
                flush()
                KF.fused_sparse_mlp_chunk_q(x, *qargs, sel.indices, cnt,
                                            group_size=G, trace=trace)
                phases = " ".join(f"{k} {v:.4f}" for k, v in
                                  KF.phase_times(trace).items())
            print(f"[scaling] fused_sparse_mlp_chunk_q S={rows} x=bfloat16 "
                  f"count={count}/{cap}: kernel {t:.4f} ms, bound "
                  f"{tc[0]:.4f} ms ({tc[1]}, bf16 gate/up, TF32 x2 down; share "
                  f"{tc[0] / t:.3f}) / {cc[0]:.4f} ms ({cc[1]}, CUDA cores); "
                  f"one traced launch, ms: {phases}", flush=True)
    # a plain read of the int8 kernel's weight bytes (28 MB at the full
    # selection), as float32 words
    n_bytes = chunk_q_work(MAIN_CHUNK, full, cap, 2,
                           sel.indices[:full].long())[0]
    flat = torch.ones(3 * full * G * D // 4, device=dev)
    t_read = cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[scaling] a contiguous read of the selected int8 weights' "
          f"{3 * full * G * D / 1e6:.1f} MB (torch.sum): {t_read:.4f} ms,"
          f" {3 * full * G * D / t_read / 1e9:.3f} TB/s (bound "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del qn, qargs, flat, flush_buf
    torch.cuda.empty_cache()


def phase_build() -> None:
    from repro_torch.kernels import build
    t = build.build()
    print(f"[build] {sorted(build.SIGNATURES)} in {t:.1f} s", flush=True)
    for name, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def _alpha_cases(b: int, device):
    import torch
    from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
    per_slot = torch.linspace(0.9, 1.1, b, device=device)
    if b > 1:
        per_slot[-1] = DEAD_SLOT_ALPHA
    return {"1.0": torch.full((b,), 1.0, device=device),
            "1.03": torch.full((b,), 1.03, device=device),
            "per-slot+dead": per_slot}


def phase_kernels(results: dict) -> None:
    """Each kernel against its plain version at full width."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    sign_wg = P.pack_signs(wg)
    w = sign_wg.shape[1]
    cap = SparseInferConfig().capacity(K)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for xdt in (torch.bfloat16, torch.float32):
        xbytes = torch.tensor([], dtype=xdt).element_size()
        for b in BATCHES:
            x = torch.randn((b, D), generator=gen, device=dev).to(xdt)
            for aname, alpha in _alpha_cases(b, dev).items():
                tag = f"B={b} x={str(xdt)[6:]} alpha={aname}"
                # ---- predictor: bitwise
                gm, cnt = KP.predict_group_margins(sign_wg, x, alpha,
                                                   d_valid=D, group_size=G)
                gm_r, cnt_r = ref.predict_group_margins_ref(sign_wg, x, D,
                                                            alpha, G)
                torch.cuda.synchronize()
                if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                    bad = int((gm != gm_r).sum())
                    fail(f"predict_group_margins {tag}: {bad} margins and "
                         f"counts {cnt.tolist()} vs {cnt_r.tolist()} differ")
                # ---- fused MLP over this selection, full and cut short
                sel, _ = S.capacity_select_with_stats(S.union_margin(gm), cap)
                full = int(sel.count)
                for count in sorted({full, full // 3}):
                    cnt_t = torch.tensor(count, dtype=torch.int32, device=dev)
                    y, tel = KF.fused_sparse_mlp(
                        x, wg, wu, wd, sel.indices, cnt_t, gm,
                        group_size=G, collect_stats=True)
                    y0 = KF.fused_sparse_mlp(x, wg, wu, wd, sel.indices,
                                             cnt_t, group_size=G)
                    y_r = ref.fused_sparse_mlp_ref(x, wg, wu, wd,
                                                   sel.indices, cnt_t,
                                                   group_size=G)
                    tel_r = ref.fused_mlp_telemetry_ref(
                        x, wg, sel.indices, cnt_t, gm, group_size=G)
                    torch.cuda.synchronize()
                    # tolerance: float32 sums in another order; with bf16
                    # inputs h is rounded to bf16, where one ulp of h's
                    # float32 value can move it by one bf16 ulp (2^-8)
                    rtol = 2e-3 if xdt == torch.bfloat16 else 1e-4
                    scale = float(y_r.abs().max()) or 1.0
                    err = float((y - y_r).abs().max())
                    if err > rtol * scale or not torch.equal(y, y0):
                        fail(f"fused_sparse_mlp {tag} count={count}: max abs "
                             f"err {err:.3e} > {rtol} x max|y| {scale:.3e}, "
                             f"or y differs with/without telemetry")
                    _check_telemetry(tel, tel_r, x, wg, sel.indices, count,
                                     f"{tag} count={count}")
                    results.setdefault("fused_err", {})[(b, xdt)] = max(
                        err, results.get("fused_err", {}).get((b, xdt), 0.0))
                if aname == "1.0":
                    results.setdefault("sel", {})[(b, xdt)] = (x, alpha, sel)
            # ---- timings on the alpha=1.0 selection of this shape
            x, alpha, sel = results["sel"][(b, xdt)]
            count = int(sel.count)
            t_pred = cuda_ms(lambda: KP.predict_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G), flush=flush)
            t_pred_plain = cuda_ms(lambda: ref.predict_group_margins_ref(
                sign_wg, x, D, alpha, G), iters=5, flush=flush)
            pb = K * w * 4 + b * D * xbytes + b * 4 + b * (K // G) * 4 + b * 4
            p_bound = bound_ms(pb, 3 * b * K * w)
            t_mlp = cuda_ms(lambda: KF.fused_sparse_mlp(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                flush=flush)
            t_mlp_plain = cuda_ms(lambda: ref.fused_sparse_mlp_ref(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                flush=flush)
            xf = x.float()
            t_dense = cuda_ms(lambda: (torch.relu(xf @ wg.T) * (xf @ wu.T))
                              @ wd, flush=flush)
            mb = 3 * count * G * D * 4 + b * D * xbytes + cap * 4 + b * D * 4
            m_bound = bound_ms(mb, 6 * b * count * G * D)
            err = results["fused_err"][(b, xdt)]
            print(f"[kernels] predict_group_margins B={b} x={str(xdt)[6:]}: "
                  f"max_abs_err 0 (bitwise, 9 cases) kernel {t_pred:.4f} ms "
                  f"plain {t_pred_plain:.4f} ms bound {p_bound[0]:.4f} ms "
                  f"({p_bound[1]})", flush=True)
            print(f"[kernels] fused_sparse_mlp B={b} x={str(xdt)[6:]} "
                  f"count={count}/{cap}: max_abs_err {err:.3e} kernel "
                  f"{t_mlp:.4f} ms plain {t_mlp_plain:.4f} ms bound "
                  f"{m_bound[0]:.4f} ms ({m_bound[1]}) dense-3-matmul "
                  f"{t_dense:.4f} ms", flush=True)
            if b == MAIN_BATCH and xdt == torch.bfloat16:
                results["predict_group_margins"] = dict(
                    max_abs_err=0.0, ms=t_pred, plain_ms=t_pred_plain,
                    bound_ms=p_bound[0], bound_by=p_bound[1],
                    library_ms=None)
                results["fused_sparse_mlp"] = dict(
                    max_abs_err=err, ms=t_mlp, plain_ms=t_mlp_plain,
                    bound_ms=m_bound[0], bound_by=m_bound[1],
                    library_ms=t_dense)
    results.pop("sel")
    del wg, wu, wd, flush_buf
    torch.cuda.empty_cache()
    phase_kernel_edges()


def phase_kernel_edges() -> None:
    """The kernels' other paths at small shapes, against the plain
    versions: d not a multiple of 32 (padded signs) or of 128 (a partial
    column tile), G in {1, 8, 16}, ungated, fatrelu, a zero count."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.core import selection as S
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 0
    for d, k, g, b, gated, act, thr in [
            (100, 512, 8, 3, True, "relu", 0.0),
            (128, 512, 1, 1, False, "relu", 0.0),
            (196, 768, 16, 16, True, "fatrelu", 0.05),
            (256, 256, 8, 7, False, "fatrelu", 0.0)]:
        w = {m: torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
             for m in ("wg", "wu", "wd")}
        wu = w["wu"] if gated else None
        sign = P.pack_signs(w["wg"])
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((b, d), generator=gen, device=dev).to(xdt)
            alpha = torch.linspace(0.9, 1.1, b, device=dev)
            gm, cnt = ops.predict_group_margins(sign, x, d, alpha,
                                                group_size=g)
            gm_r, cnt_r = ref.predict_group_margins_ref(sign, x, d, alpha, g)
            if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                fail(f"predict_group_margins d={d} k={k} G={g} B={b} "
                     f"{xdt}: differs from its plain version")
            sel = S.capacity_select(S.union_margin(gm), max(1, k // g // 4))
            for count in (sel.count, torch.zeros((), dtype=torch.int32,
                                                 device=dev)):
                y, tel = ops.fused_sparse_mlp(
                    x, w["wg"], wu, w["wd"], sel.indices, count, gm,
                    group_size=g, activation=act, fatrelu_threshold=thr,
                    collect_stats=True)
                y_r = ref.fused_sparse_mlp_ref(
                    x, w["wg"], wu, w["wd"], sel.indices, count,
                    group_size=g, activation=act, fatrelu_threshold=thr)
                tel_r = ref.fused_mlp_telemetry_ref(
                    x, w["wg"], sel.indices, count, gm, group_size=g,
                    activation=act, fatrelu_threshold=thr)
                scale = float(y_r.abs().max()) or 1.0
                err = float((y - y_r).abs().max())
                rtol = 2e-3 if xdt == torch.bfloat16 else 1e-4
                if err > rtol * scale or not torch.equal(tel, tel_r):
                    fail(f"fused_sparse_mlp d={d} k={k} G={g} B={b} {xdt} "
                         f"gated={gated} {act} count={int(count)}: err "
                         f"{err:.3e}, telemetry {tel.tolist()} vs "
                         f"{tel_r.tolist()}")
                n += 1
    print(f"[kernels] {n} small-shape cases (padded d, partial column tile, "
          "G in {1, 8, 16}, ungated, fatrelu, zero count) agree with the "
          "plain versions", flush=True)


def _check_telemetry(tel, tel_r, x, wg, sel_idx, count, tag) -> None:
    """Telemetry is equal, except that ``actual`` / ``false_neg`` may be off
    by the number of computed rows whose gate pre-activation lies within
    float rounding of 0 (there the two sums may disagree on its sign).
    ``wg``: the (k, d) float gate weights (the dequantized view for int8)."""
    import torch
    if torch.equal(tel, tel_r):
        return
    k, d = wg.shape
    rows = wg.reshape(k // G, G, d)[sel_idx[:count].long()].reshape(-1, d)
    g = x.float() @ rows.T
    scale = (x.float().abs() @ rows.abs().T)
    near = ((g.abs() <= 1e-5 * scale).sum(-1)).to(torch.int32)   # (B,)
    diff = (tel - tel_r).abs()
    print(f"[kernels] telemetry {tag}: differs by {diff.tolist()} where "
          f"{near.tolist()} gate values lie within rounding of 0",
          flush=True)
    # each differing token's gate value nearest 0, against its sum of
    # |x w| (float32 rounding of that sum is ~6e-8 of it)
    for b in (diff.sum(-1) > 0).nonzero().flatten().tolist():
        i = int((g[b].abs() / scale[b]).argmin())
        print(f"[kernels] telemetry {tag}: token {b}'s gate value nearest 0"
              f" is {float(g[b, i]):.3e} (reference sum) against sum |x w| "
              f"{float(scale[b, i]):.3e}: {float(g[b, i].abs() / scale[b, i]):.2e}"
              " of it", flush=True)
    if not (torch.equal(tel[:, 2], tel_r[:, 2])
            and bool((diff[:, :2] <= near[:, None]).all())):
        fail(f"fused_sparse_mlp telemetry {tag}: {tel.tolist()} vs "
             f"{tel_r.tolist()}")


def _chunk_alphas(s: int, device):
    """Per-row alphas of a prefill chunk: the schedule's two values, and
    dead pad rows at the end (a padded last chunk)."""
    import torch
    from repro_torch.core.sparse_mlp import DEAD_SLOT_ALPHA
    a = torch.full((s,), 1.0, device=device)
    a[1::3] = 1.03
    a[s - max(1, s // 8):] = DEAD_SLOT_ALPHA
    return a


QNAMES = ("wg_q", "wg_s", "wu_q", "wu_s", "wd_q", "wd_s")


def phase_chunk_kernels(results: dict) -> None:
    """The chunk predictor (bitwise, and per row equal to the decode one),
    the chunk MLP and the two int8 MLP kernels against their plain
    versions at full width; timings at the main path's shapes."""
    import torch
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_mlp_fused as KF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wu = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    wd = torch.randn((K, D), generator=gen, device=dev) * K ** -0.5
    qn = Q.quantize_mlp_node({"wg_t": wg, "wu_t": wu, "wd_t": wd}, QG, G)
    qargs = [qn[n] for n in QNAMES]
    wg_deq = Q.dense_view(qn)["wg_t"]
    sign_wg = qn["sign_wg"]
    w = sign_wg.shape[1]
    cap = SparseInferConfig().capacity(K)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def check_y(name, tag, y, y0, y_r, rtol):
        scale = float(y_r.abs().max()) or 1.0
        err = float((y - y_r).abs().max())
        if err > rtol * scale or not torch.equal(y, y0):
            fail(f"{name} {tag}: max abs err {err:.3e} > {rtol} x max|y| "
                 f"{scale:.3e}, or y differs with/without telemetry")
        results.setdefault("err", {})[name] = max(
            err, results.get("err", {}).get(name, 0.0))
        return err

    cases = [(s, True) for s in CHUNK_ROWS] + [(b, False) for b in BATCHES]
    for xdt in (torch.bfloat16, torch.float32):
        for rows, chunk in cases:
            x = torch.randn((rows, D), generator=gen, device=dev).to(xdt)
            alpha = _chunk_alphas(rows, dev) if chunk else \
                torch.linspace(0.9, 1.1, rows, device=dev)
            tag = f"{'S' if chunk else 'B'}={rows} x={str(xdt)[6:]}"
            gm, cnt = KP.predict_chunk_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G)
            if chunk:
                gm_r, cnt_r = ref.predict_chunk_group_margins_ref(
                    sign_wg, x, D, alpha, G)
                # the decode kernel's outputs on each row alone
                one = [KP.predict_group_margins(
                    sign_wg, x[i:i + 1], alpha[i:i + 1], d_valid=D,
                    group_size=G) for i in range(rows)]
                gm_1 = torch.cat([o[0] for o in one])
                cnt_1 = torch.cat([o[1] for o in one])
                torch.cuda.synchronize()
                if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)
                        and torch.equal(gm, gm_1)
                        and torch.equal(cnt, cnt_1)):
                    fail(f"predict_chunk_group_margins {tag}: differs from "
                         "its plain version or from the decode kernel")
            sel, _ = S.capacity_select_with_stats(S.union_margin(gm), cap)
            full = int(sel.count)
            for count in sorted({full, full // 3}):
                cnt_t = torch.tensor(count, dtype=torch.int32, device=dev)
                ctag = f"{tag} count={count}"
                if chunk:
                    y, tel = KF.fused_sparse_mlp_chunk(
                        x, wg, wu, wd, sel.indices, cnt_t, gm, group_size=G,
                        collect_stats=True)
                    y0 = _same_twice(
                        f"{ctag} without telemetry",
                        lambda: KF.fused_sparse_mlp_chunk(
                            x, wg, wu, wd, sel.indices, cnt_t,
                            group_size=G), name="fused_sparse_mlp_chunk")
                    y_r, tel_r = ref.fused_sparse_mlp_chunk_ref(
                        x, wg, wu, wd, sel.indices, cnt_t, gm, group_size=G,
                        collect_stats=True)
                    torch.cuda.synchronize()
                    # as phase 2's fused_sparse_mlp: h rounded to bf16
                    check_y("fused_sparse_mlp_chunk", ctag, y, y0, y_r,
                            2e-3 if xdt == torch.bfloat16 else 1e-4)
                    _check_telemetry(tel, tel_r, x, wg, sel.indices, count,
                                     ctag)
                qname = "fused_sparse_mlp_chunk_q" if chunk \
                    else "fused_sparse_mlp_q"
                y, tel = getattr(KF, qname)(x, *qargs, sel.indices, cnt_t,
                                            gm, group_size=G,
                                            collect_stats=True)
                if chunk:
                    y0 = _same_twice(
                        f"{ctag} without telemetry",
                        lambda: KF.fused_sparse_mlp_chunk_q(
                            x, *qargs, sel.indices, cnt_t, group_size=G),
                        name=qname)
                else:
                    y0 = KF.fused_sparse_mlp_q(x, *qargs, sel.indices, cnt_t,
                                               group_size=G)
                y_r, tel_r = ref.fused_sparse_mlp_q_ref(
                    x, *qargs, sel.indices, cnt_t, gm, group_size=G,
                    collect_stats=True)
                torch.cuda.synchronize()
                # tolerance: float32 products summed in another order (the
                # decode kernel scales per product, not per quant group); h
                # stays float32
                check_y(qname, ctag, y, y0, y_r, 1e-4)
                _check_telemetry(tel, tel_r, x, wg_deq, sel.indices, count,
                                 ctag)
            main = (rows == MAIN_CHUNK and chunk) or \
                (rows == MAIN_BATCH and not chunk)
            if not main or xdt != torch.bfloat16:
                continue
            # ---- timings at the main path's shapes (bf16 activations)
            xbytes = 2
            count = full
            sel_rows = sel.indices[:count].long()
            q_rows = int(torch.unique(sel_rows // (QG // G)).numel())
            io = rows * D * xbytes + cap * 4 + 4 + rows * D * 4
            flops = 6 * rows * count * G * D
            q_bytes = (3 * count * G * D + 2 * count * G * (D // QG) * 4
                       + q_rows * D * 4 + io)
            qname = "fused_sparse_mlp_chunk_q" if chunk \
                else "fused_sparse_mlp_q"
            t_q = cuda_ms(lambda: getattr(KF, qname)(
                x, *qargs, sel.indices, sel.count, group_size=G),
                flush=flush)
            t_q_plain = cuda_ms(lambda: ref.fused_sparse_mlp_q_ref(
                x, *qargs, sel.indices, sel.count, group_size=G), iters=5,
                flush=flush)
            qb = bound_ms(q_bytes, flops)
            if chunk:
                # the tensor cores' products (bf16 gate/up, two TF32
                # passes for down, with bf16 x), beside the CUDA-core bound
                # and the float32 chunk kernel
                q_bytes, _, tf32, bf16 = chunk_q_work(rows, count, cap,
                                                      xbytes, sel_rows)
                cc = qb
                qb = tc_bound_ms(q_bytes, tf32, bf16)
                t_f = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(
                    x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                    flush=flush)
                print(f"[kernels] {qname} {tag} count={count}/{cap}: "
                      f"max_abs_err {results['err'][qname]:.3e} kernel "
                      f"{t_q:.4f} ms plain {t_q_plain:.4f} ms bound "
                      f"{qb[0]:.4f} ms ({qb[1]}, bf16 gate/up, TF32 x2 "
                      f"down; share "
                      f"{qb[0] / t_q:.3f}) / {cc[0]:.4f} ms ({cc[1]}, CUDA "
                      f"cores); the float32 chunk kernel at this shape "
                      f"{t_f:.4f} ms", flush=True)
            else:
                print(f"[kernels] {qname} {tag} count={count}/{cap}: "
                      f"max_abs_err {results['err'][qname]:.3e} kernel "
                      f"{t_q:.4f} ms plain {t_q_plain:.4f} ms bound "
                      f"{qb[0]:.4f} ms ({qb[1]})", flush=True)
            results[qname] = dict(
                max_abs_err=results["err"][qname], ms=t_q,
                plain_ms=t_q_plain, bound_ms=qb[0], bound_by=qb[1],
                library_ms=None)
            if not chunk:
                continue
            t_pred = cuda_ms(lambda: KP.predict_chunk_group_margins(
                sign_wg, x, alpha, d_valid=D, group_size=G), flush=flush)
            t_pred_plain = cuda_ms(
                lambda: ref.predict_chunk_group_margins_ref(
                    sign_wg, x, D, alpha, G), iters=5, flush=flush)
            pb = bound_ms(K * w * 4 + rows * D * xbytes + rows * 4
                          + rows * (K // G) * 4 + rows * 4, 3 * rows * K * w)
            t_mlp = cuda_ms(lambda: KF.fused_sparse_mlp_chunk(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                flush=flush)
            t_mlp_plain = cuda_ms(lambda: ref.fused_sparse_mlp_chunk_ref(
                x, wg, wu, wd, sel.indices, sel.count, group_size=G),
                iters=5, flush=flush)
            xf = x.float()
            t_dense = cuda_ms(lambda: (torch.relu(xf @ wg.T) * (xf @ wu.T))
                              @ wd, flush=flush)
            gathered = _gathered_mlp(wg, wu, wd, sel_rows)
            t_lib = cuda_ms(lambda: gathered(xf), flush=flush)
            del gathered
            mb_bytes, _ = chunk_mlp_work(rows, count, cap, xbytes)
            mb = tc_bound_ms(mb_bytes, 2 * flops)
            mb_cc = bound_ms(mb_bytes, flops)
            print(f"[kernels] predict_chunk_group_margins {tag}: "
                  f"max_abs_err 0 (bitwise, and per row equal to "
                  f"predict_group_margins) kernel {t_pred:.4f} ms plain "
                  f"{t_pred_plain:.4f} ms bound {pb[0]:.4f} ms ({pb[1]})",
                  flush=True)
            print(f"[kernels] fused_sparse_mlp_chunk {tag} count={count}/"
                  f"{cap}: max_abs_err "
                  f"{results['err']['fused_sparse_mlp_chunk']:.3e} kernel "
                  f"{t_mlp:.4f} ms plain {t_mlp_plain:.4f} ms bound "
                  f"{mb[0]:.4f} ms ({mb[1]}, TF32 x2 passes; share "
                  f"{mb[0] / t_mlp:.3f}) / {mb_cc[0]:.4f} ms ({mb_cc[1]}, "
                  f"CUDA cores) gathered-rows-3-matmul {t_lib:.4f} ms "
                  f"dense-3-matmul {t_dense:.4f} ms", flush=True)
            results["predict_chunk_group_margins"] = dict(
                max_abs_err=0.0, ms=t_pred, plain_ms=t_pred_plain,
                bound_ms=pb[0], bound_by=pb[1], library_ms=None)
            results["fused_sparse_mlp_chunk"] = dict(
                max_abs_err=results["err"]["fused_sparse_mlp_chunk"],
                ms=t_mlp, plain_ms=t_mlp_plain, bound_ms=mb[0],
                bound_by=mb[1], library_ms=t_lib)
    # the errors over every case, not only those before the timed one
    for name in ("fused_sparse_mlp_chunk", "fused_sparse_mlp_q",
                 "fused_sparse_mlp_chunk_q"):
        results[name]["max_abs_err"] = results["err"][name]
    print("[kernels] chunk and int8 kernels agree with their plain versions"
          f" at S in {CHUNK_ROWS}, B in {BATCHES}, bf16 and float32 x, full"
          " and cut-short counts; both chunk kernels bitwise equal in two "
          "runs", flush=True)
    del wg, wu, wd, qn, qargs, wg_deq, flush_buf
    torch.cuda.empty_cache()
    phase_chunk_edges()
    phase_big_decode_batch()


def phase_chunk_edges() -> None:
    """The chunk and int8 kernels' other paths at small shapes: rows not a
    multiple of the 16-row block, token tiles of 8, 16, 32 and 64 rows,
    padded d, a partial column tile, G in {1, 8, 16}, quant groups
    narrower than 4 columns, ungated, fatrelu, a zero count."""
    import torch
    from repro_torch.core import quantize as Q
    from repro_torch.core import selection as S
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    n = 0
    for d, k, g, qg, s, gated, act, thr in [
            (100, 500, 1, 4, 3, True, "relu", 0.0),
            (128, 512, 8, 32, 37, True, "relu", 0.0),
            (192, 768, 16, 64, 20, False, "fatrelu", 0.05),
            (64, 256, 1, 2, 5, True, "fatrelu", 0.0),
            (256, 512, 8, 64, 12, True, "relu", 0.0)]:
        w = {m: torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
             for m in ("wg", "wu", "wd")}
        wu = w["wu"] if gated else None
        qn = Q.quantize_mlp_node({"wg_t": w["wg"], "wu_t": wu,
                                  "wd_t": w["wd"]}, qg, g)
        qargs = [qn.get(m) for m in QNAMES]
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((s, d), generator=gen, device=dev).to(xdt)
            alpha = _chunk_alphas(s, dev)
            gm, cnt = ops.predict_chunk_group_margins(qn["sign_wg"], x, d,
                                                      alpha, group_size=g)
            gm_r, cnt_r = ref.predict_group_margins_ref(qn["sign_wg"], x, d,
                                                        alpha, g)
            if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                fail(f"predict_chunk_group_margins d={d} k={k} G={g} S={s} "
                     f"{xdt}: differs from its plain version")
            sel = S.capacity_select(S.union_margin(gm), max(1, k // g // 4))
            kw = dict(group_size=g, activation=act, fatrelu_threshold=thr,
                      collect_stats=True)
            for count in (sel.count, torch.zeros((), dtype=torch.int32,
                                                 device=dev)):
                for name, out, want in [
                        ("fused_sparse_mlp_chunk",
                         ops.fused_sparse_mlp_chunk(
                             x, w["wg"], wu, w["wd"], sel.indices, count,
                             gm, **kw),
                         ref.fused_sparse_mlp_chunk_ref(
                             x, w["wg"], wu, w["wd"], sel.indices, count,
                             gm, **kw)),
                        ("fused_sparse_mlp_chunk_q",
                         ops.fused_sparse_mlp_chunk_q(
                             x, *qargs, sel.indices, count, gm, **kw),
                         ref.fused_sparse_mlp_q_ref(
                             x, *qargs, sel.indices, count, gm, **kw))]:
                    (y, tel), (y_r, tel_r) = out, want
                    scale = float(y_r.abs().max()) or 1.0
                    err = float((y - y_r).abs().max())
                    rtol = 2e-3 if (xdt == torch.bfloat16
                                    and not name.endswith("_q")) else 1e-4
                    if err > rtol * scale or not torch.equal(tel, tel_r):
                        fail(f"{name} d={d} k={k} G={g} qg={qg} S={s} {xdt} "
                             f"gated={gated} {act} count={int(count)}: err "
                             f"{err:.3e}, telemetry {tel.tolist()} vs "
                             f"{tel_r.tolist()}")
                    n += 1
    print(f"[kernels] {n} small-shape cases of the chunk and int8 kernels "
          "(rows not a multiple of 16, padded d, partial column tile, G in "
          "{1, 8, 16}, qg in {2, 4, 32, 64}, ungated, fatrelu, zero count) "
          "agree with the plain versions", flush=True)


def phase_big_decode_batch() -> None:
    """A decode batch of 24 with sparse_max_batch=32 through the ops layer:
    the decode kernels take 16 rows, so the predictor and the MLP launch
    their chunk twins; the result must match the CPU's plain versions."""
    import torch
    from repro_torch.core import sparse_mlp as SM
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    mlp = SM.init_gated_mlp(gen, D, K, device=dev)
    b = 24
    x = torch.randn((b, D), generator=gen, device=dev)
    alpha = torch.linspace(0.95, 1.05, b, device=dev)
    for weights in ("", "int8"):
        cfg = SM.SparseInferConfig(enabled=True, strategy="pallas",
                                   sparse_max_batch=32, weight_dtype=weights,
                                   quant_group_size=QG)
        params = SM.prepare_sparse_params(mlp, cfg)
        ops.reset_launch_counts()
        y, st = SM.pallas_mlp(params, x, cfg, alpha, return_stats=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        fused = "fused_sparse_mlp_chunk_q" if weights \
            else "fused_sparse_mlp_chunk"
        want = {n: int(n in ("predict_chunk_group_margins", fused))
                for n in counts}
        if counts != want:
            fail(f"decode batch of {b}: launches {counts}, want {want}")
        cpu = {kk: v.cpu() for kk, v in params.items()}
        y_c, st_c = SM.pallas_mlp(cpu, x.cpu(), cfg, alpha.cpu(),
                                  return_stats=True)
        err = float((y.cpu() - y_c).abs().max())
        scale = float(y_c.abs().max())
        same = [kk for kk in ("predicted_density", "realized_density",
                              "union_demand_frac")
                if not torch.equal(st[kk].cpu(), st_c[kk])]
        if err > 1e-4 * scale or same:
            fail(f"decode batch of {b} ({weights or 'float32'} weights): "
                 f"err {err:.3e} of max|y| {scale:.3e}; stats differ {same}")
        print(f"[kernels] decode batch of {b} (sparse_max_batch=32, "
              f"{weights or 'float32'} weights): launched {counts}; y within "
              f"{err:.3e} of the CPU, selection stats equal", flush=True)
    del mlp, params
    torch.cuda.empty_cache()


def phase_prefill() -> None:
    """Two full-width float32 layers, sparse prefill of a 160-token prompt
    in chunks of 64: card (CUDA kernels) vs CPU (plain versions), with
    float32 and with int8 MLP weights."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    plen, chunk, max_len = 160, MAIN_CHUNK, 256
    n_chunks = -(-plen // chunk)
    rng = np.random.default_rng(5)
    tokens = np.zeros((1, n_chunks * chunk), np.int64)
    tokens[0, :plen] = rng.integers(0, base.vocab, size=plen)
    fp = lm.init_lm(base.replace(n_layers=2), 0, "cuda")
    for weights in ("", "int8"):
        cfg = base.replace(
            n_layers=2, dtype="float32", kv_cache_dtype="float32",
            sparse=dataclasses.replace(
                base.sparse, strategy="pallas", enabled=True,
                sparse_prefill=True, weight_dtype=weights,
                quant_group_size=QG))
        params = {"cuda": lm.prepare_sparse(fp, cfg.sparse)}
        params["cpu"] = _to(params["cuda"], "cpu")
        alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)
        out = {}
        for dev in ("cuda", "cpu"):
            ops.reset_launch_counts()
            caches = lm.init_caches(cfg, 1, max_len, dev)
            logits, stats = [], []
            with torch.inference_mode():
                for off in range(0, n_chunks * chunk, chunk):
                    lg, caches, st = lm.prefill_chunk(
                        params[dev], cfg,
                        torch.as_tensor(tokens[:, off:off + chunk],
                                        device=dev),
                        caches, off, plen, alphas=alphas,
                        collect_stats=True)
                    logits.append(lg.float().cpu())
                    stats.append({k: v.cpu() for k, v in st.items()})
            out[dev] = (torch.stack(logits), stats, ops.launch_counts())
        counts = out["cuda"][2]
        fused = "fused_sparse_mlp_chunk_q" if weights \
            else "fused_sparse_mlp_chunk"
        want = {n: (cfg.n_layers * n_chunks
                    if n in ("predict_chunk_group_margins", fused) else 0)
                for n in counts}
        if counts != want:
            fail(f"prefill: launches {counts}, want {want}")
        lg_c, lg_p = out["cuda"][0], out["cpu"][0]
        if not bool(torch.isfinite(lg_c).all()):
            fail("prefill: non-finite logits on the card")
        # the logits of the chunk that holds the last prompt token
        diff = (lg_c[-1] - lg_p[-1]).abs()
        n_diff = sum(int((a[k] != b[k]).sum())
                     for a, b in zip(out["cuda"][1], out["cpu"][1])
                     for k in MLP_STAT_KEYS)
        n_all = len(MLP_STAT_KEYS) * cfg.n_layers * n_chunks
        worst = max(float((a[k] - b[k]).abs().max())
                    for a, b in zip(out["cuda"][1], out["cpu"][1])
                    for k in MLP_STAT_KEYS)
        tol = 1e-3
        print(f"[prefill] {weights or 'float32'} weights, {plen} tokens in "
              f"{n_chunks} chunks of {chunk}: logits max abs diff "
              f"{float(diff.max()):.3e}, median {float(diff.median()):.3e} "
              f"(tolerance {tol}); {n_diff} of {n_all} stat entries differ, "
              f"by at most {worst:.3e}; launches {counts}", flush=True)
        stat_tol = 2 * cfg.sparse.group_size / cfg.d_ff
        if float(diff.max()) > tol or worst > stat_tol:
            fail(f"prefill: logits differ by {float(diff.max())} or a stat "
                 f"by {worst} (tolerance {stat_tol})")
        del params
    del fp
    torch.cuda.empty_cache()


def phase_serve_chunked(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server with chunked
    sparse prefill, with float32 and with int8 MLP weights."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    tiers = ("latency", "balanced", "quality")
    for weights in ("", "int8"):
        cfg = base.replace(sparse=dataclasses.replace(
            base.sparse, strategy="pallas", enabled=True,
            sparse_prefill=True, weight_dtype=weights, quant_group_size=QG,
            prefill_max_tokens=max(base.sparse.prefill_max_tokens,
                                   MAIN_CHUNK)))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, 0, "cuda")
        srv = Server(lm, cfg, ServeConfig(
            batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
            prefill_chunk=MAIN_CHUNK), params, device="cuda")
        del params        # int8: the server keeps only the quantized MLPs
        torch.cuda.synchronize()
        kind = weights or "float32"
        print(f"[serve-chunked] {kind} MLP weights, prefill chunks of "
              f"{MAIN_CHUNK}, sparse prefill; init "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.default_rng(6)
        plens = [int(p) for p in rng.integers(96, 193, size=8)]
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=p),
                        max_new=16, sla=tiers[i % 3])
                for i, p in enumerate(plens)]
        ops.reset_launch_counts()
        steps0, chunks0 = srv.decode_steps, srv.prefill_chunks_run
        done = srv.serve(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps = srv.decode_steps - steps0
        chunks = srv.prefill_chunks_run - chunks0
        rep = throughput_report(done)
        rep["prefill_chunks_run"] = chunks
        rep["prefill_chunks_skipped"] = srv.prefill_chunks_skipped
        print(f"[serve-chunked] {kind} throughput_report {json.dumps(rep)}",
              flush=True)
        print(f"[serve-chunked] {kind} peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; decode "
              f"steps {steps}; prefill chunks {chunks}; launches {counts}",
              flush=True)
        if len(done) != 8 or any(
                r.outcome != "completed" or len(r.out) != 16
                or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                for r in done):
            fail(f"serve-chunked ({kind}): not every request completed with "
                 "16 valid tokens")
        fused = "fused_sparse_mlp_q" if weights else "fused_sparse_mlp"
        L = cfg.n_layers
        want = {n: 0 for n in counts}
        want.update({"predict_group_margins": L * steps, fused: L * steps,
                     "predict_chunk_group_margins": L * chunks,
                     fused.replace("mlp", "mlp_chunk"): L * chunks})
        if steps == 0 or chunks != sum(-(-p // MAIN_CHUNK) for p in plens) \
                or counts != want:
            fail(f"serve-chunked ({kind}): launches {counts}, want {want} "
                 f"(2 per sparse MLP x {L} layers x {steps} decode steps "
                 f"and x {chunks} prefill chunks)")
        results[f"launches_chunked_{kind}"] = counts
        profile_prefill_chunk(srv, cfg, kind)
        del srv
        torch.cuda.empty_cache()


def phase_decode() -> None:
    """Two full-width float32 layers: card (CUDA kernels) vs CPU (plain)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
    from repro_torch.models import lm

    # float32 compute AND KV cache for the check: the int8 cache rounds q
    # and p to bf16, which amplifies the card's float32 drift from the CPU
    # enough to reorder a capacity-clamped selection (with random weights
    # ~99.8% of groups predict active, so the top-C cut falls among
    # near-equal margins).  The int8 cache is run after it, reported only;
    # phase 4 serves it.
    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32",
                       sparse=dataclasses.replace(base.sparse,
                                                  strategy="pallas",
                                                  enabled=True))
    b, steps = DEC_BATCH, DEC_STEPS
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")

    def run(run_cfg, dev):
        return _teacher_forced(params[dev], run_cfg, dev)

    logits, stats = {}, {}
    for dev in ("cuda", "cpu"):
        logits[dev], stats[dev] = run(cfg, dev)
    if not bool(torch.isfinite(logits["cuda"]).all()):
        fail("decode: non-finite logits on the card")
    diff = (logits["cuda"] - logits["cpu"]).abs()
    # tolerance: float32 sums taken in another order on the card (logits
    # are O(1); ~1e-5 apart when both pick the same groups)
    tol = 1e-3
    print(f"[decode] logits max abs diff {float(diff.max()):.3e}, median "
          f"{float(diff.median()):.3e} (tolerance {tol})", flush=True)
    if float(diff.max()) > tol:
        fail(f"decode: logits differ by {float(diff.max())}")
    # stats: an input element within rounding of 0 may take the other sign
    # bit on the card, which moves every margin by 1 + alpha and can carry
    # a group across 0; each entry must lie within 2 groups (2 G / k), and
    # the count of entries that differ at all is printed
    stat_tol = 2 * cfg.sparse.group_size / cfg.d_ff
    for k in MLP_STAT_KEYS:
        a, r = stats["cuda"][k], stats["cpu"][k]
        n_diff = int((a != r).sum())
        worst = float((a - r).abs().max())
        print(f"[decode] stat {k}: {n_diff} of {a.numel()} (step, layer, "
              f"slot) entries differ, by at most {worst:.3e} (tolerance "
              f"{stat_tol:.3e})", flush=True)
        if worst > stat_tol:
            fail(f"decode: stat {k} differs by {worst}")
    same = int((logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).sum())
    print(f"[decode] greedy tokens equal in {same} of {b * steps} (reported "
          "only: random weights give near-flat logits)", flush=True)
    # the int8 cache, reported only (see above)
    q8 = cfg.replace(kv_cache_dtype="int8")
    l8 = {dev: run(q8, dev) for dev in ("cuda", "cpu")}
    d8 = (l8["cuda"][0] - l8["cpu"][0]).abs()
    n8 = sum(int((l8["cuda"][1][k] != l8["cpu"][1][k]).sum())
             for k in MLP_STAT_KEYS)
    print(f"[decode] int8 KV (reported only): logits max abs diff "
          f"{float(d8.max()):.3e}, median {float(d8.median()):.3e}; "
          f"{n8} of {len(MLP_STAT_KEYS) * b * steps * cfg.n_layers} stat "
          "entries differ", flush=True)
    del params
    torch.cuda.empty_cache()


DEC_BATCH, DEC_PLEN, DEC_STEPS, DEC_MAX_LEN = 4, 16, 8, 32


def _teacher_forced(params, cfg, dev):
    """Prefill a seeded batch of 4 prompts, then 8 teacher-forced decode
    steps with per-slot alphas (the schedule plus SLA-like offsets) ->
    (logits (steps, B, V), stats {key: (steps, L, B)}) on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
    from repro_torch.models import lm
    b, plen, steps = DEC_BATCH, DEC_PLEN, DEC_STEPS
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(b, plen))
    forced = rng.integers(0, cfg.vocab, size=(steps, b, 1))
    alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None] + \
        np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]
    with torch.inference_mode():
        lg, caches = lm.prefill(params, cfg,
                                torch.as_tensor(prompt, device=dev),
                                DEC_MAX_LEN)
        out_l, out_s = [], []
        for t in range(steps):
            lg, caches, st = lm.decode_step(
                params, cfg, torch.as_tensor(forced[t], device=dev), caches,
                torch.full((b,), plen + t, device=dev), alphas=alphas,
                collect_stats=True)
            out_l.append(lg.float().cpu())
            out_s.append({k: v.cpu() for k, v in st.items()})
    return torch.stack(out_l), {k: torch.stack([s[k] for s in out_s])
                                for k in MLP_STAT_KEYS}


def phase_decode_strategies() -> None:
    """The two layers of phase_decode with strategies masked and gather:
    their margins run the sign_pack and predict_counts kernels on the card
    (one launch each per layer and step) and the plain versions on the
    CPU."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    cfg0 = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32")
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg0, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")
    L = cfg0.n_layers
    for strategy in ("masked", "gather"):
        cfg = cfg0.replace(sparse=dataclasses.replace(
            base.sparse, strategy=strategy, enabled=True))
        ops.reset_launch_counts()
        card = _teacher_forced(params["cuda"], cfg, "cuda")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {n: L * DEC_STEPS if n in ("sign_pack", "predict_counts")
                else 0 for n in counts}
        if counts != want:
            fail(f"{strategy} decode: launches {counts}, want {want}")
        cpu = _teacher_forced(params["cpu"], cfg, "cpu")
        if not bool(torch.isfinite(card[0]).all()):
            fail(f"{strategy} decode: non-finite logits on the card")
        diff = (card[0] - cpu[0]).abs()
        # tolerance as phase_decode: float32 sums in another order
        tol = 1e-3
        n_diff = sum(int((card[1][k] != cpu[1][k]).sum())
                     for k in MLP_STAT_KEYS)
        worst = max(float((card[1][k] - cpu[1][k]).abs().max())
                    for k in MLP_STAT_KEYS)
        print(f"[strategies] {strategy}: logits max abs diff "
              f"{float(diff.max()):.3e}, median {float(diff.median()):.3e} "
              f"(tolerance {tol}); {n_diff} of "
              f"{len(MLP_STAT_KEYS) * DEC_STEPS * L * DEC_BATCH} stat "
              f"entries differ, by at most {worst:.3e}; launches {counts}",
              flush=True)
        for k in MLP_STAT_KEYS:
            print(f"[strategies] {strategy} stat {k}: card mean "
                  f"{float(card[1][k].mean()):.5f}, CPU mean "
                  f"{float(cpu[1][k].mean()):.5f}", flush=True)
        if float(diff.max()) > tol:
            fail(f"{strategy} decode: logits differ by {float(diff.max())}")
    _gather_prefill_chunks(params, cfg0)
    del params
    torch.cuda.empty_cache()


def _gather_prefill_chunks(params, cfg0) -> None:
    """Strategy gather with sparse prefill, as the controller serve runs
    its prompts: a 100-token prompt in chunks of 64 (a full chunk, then 36
    rows and 28 pad rows), each chunk's 64 rows one union selection, card
    against CPU.  Logits of the last chunk within 1e-3; each stat entry
    within 2 groups, as phase_prefill holds them."""
    import numpy as np
    import torch
    from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = cfg0.replace(sparse=dataclasses.replace(
        cfg0.sparse, strategy="gather", enabled=True, sparse_prefill=True,
        prefill_max_tokens=max(cfg0.sparse.prefill_max_tokens, MAIN_CHUNK)))
    plen, chunk, L = 100, MAIN_CHUNK, cfg.n_layers
    n_chunks = -(-plen // chunk)
    rng = np.random.default_rng(11)
    tokens = np.zeros((1, n_chunks * chunk), np.int64)
    tokens[0, :plen] = rng.integers(0, cfg.vocab, size=plen)
    alphas = cfg.sparse.alpha_schedule().alphas(L)
    out = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        caches = lm.init_caches(cfg, 1, DEC_MAX_LEN * 4, dev)
        logits, stats = [], []
        with torch.inference_mode():
            for off in range(0, n_chunks * chunk, chunk):
                lg, caches, st = lm.prefill_chunk(
                    params[dev], cfg,
                    torch.as_tensor(tokens[:, off:off + chunk], device=dev),
                    caches, off, plen, alphas=alphas, collect_stats=True)
                logits.append(lg.float().cpu())
                stats.append({k: v.cpu() for k, v in st.items()})
        out[dev] = (logits[-1], stats, ops.launch_counts())
    counts = out["cuda"][2]
    want = {n: L * n_chunks if n in ("sign_pack", "predict_counts") else 0
            for n in counts}
    if counts != want:
        fail(f"gather prefill: launches {counts}, want {want}")
    lg_c, lg_p = out["cuda"][0], out["cpu"][0]
    if not bool(torch.isfinite(lg_c).all()):
        fail("gather prefill: non-finite logits on the card")
    diff = (lg_c - lg_p).abs()
    pairs = list(zip(out["cuda"][1], out["cpu"][1]))
    n_diff = sum(int((a[k] != b[k]).sum()) for a, b in pairs
                 for k in MLP_STAT_KEYS)
    worst = max(float((a[k] - b[k]).abs().max()) for a, b in pairs
                for k in MLP_STAT_KEYS)
    tol, stat_tol = 1e-3, 2 * cfg.sparse.group_size / cfg.d_ff
    print(f"[strategies] gather sparse prefill, {plen} tokens in {n_chunks} "
          f"chunks of {chunk}: logits max abs diff {float(diff.max()):.3e}, "
          f"median {float(diff.median()):.3e} (tolerance {tol}); {n_diff} of "
          f"{len(MLP_STAT_KEYS) * L * n_chunks} stat entries differ, by at "
          f"most {worst:.3e} (tolerance {stat_tol:.3e}); launches {counts}",
          flush=True)
    for k in MLP_STAT_KEYS:
        print(f"[strategies] gather prefill stat {k}: card "
              f"{[round(float(a[k].mean()), 5) for a, _ in pairs]}, CPU "
              f"{[round(float(b[k].mean()), 5) for _, b in pairs]}",
              flush=True)
    if float(diff.max()) > tol or worst > stat_tol:
        fail(f"gather prefill: logits differ by {float(diff.max())} or a "
             f"stat by {worst}")


def _to(tree, device):
    import torch
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if torch.is_tensor(tree) else tree


def phase_serve(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(sparse=dataclasses.replace(
        base.sparse, strategy="pallas", enabled=True))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, ServeConfig(batch=MAIN_BATCH, max_len=128,
                                      max_new_tokens=16), params,
                 device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"d_ff={cfg.d_ff}, weights {cfg.param_dtype}, compute {cfg.dtype},"
          f" KV {cfg.kv_cache_dtype}; init {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    tiers = ("latency", "balanced", "quality")
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=int(rng.integers(32, 65))),
                    max_new=16, sla=tiers[i % 3]) for i in range(8)]
    ops.reset_launch_counts()
    steps0 = srv.decode_steps
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = srv.decode_steps - steps0
    rep = throughput_report(done)
    print(f"[serve] throughput_report {json.dumps(rep)}", flush=True)
    print(f"[serve] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; decode steps {steps}; launches {counts}", flush=True)
    if len(done) != 8 or any(r.outcome != "completed" or len(r.out) != 16
                             or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                             for r in done):
        fail("serve: not every request completed with 16 valid tokens")
    want = cfg.n_layers * steps
    if steps == 0 or counts != {
            n: want if n in ("predict_group_margins", "fused_sparse_mlp")
            else 0 for n in counts}:
        fail(f"serve: launches {counts}, want {want} of each kernel "
             f"(2 per sparse MLP x {cfg.n_layers} layers x {steps} steps)")
    results["launches"] = counts
    profile_decode(srv, cfg)
    del srv, params
    torch.cuda.empty_cache()


def profile_decode(srv, cfg) -> None:
    """Where one full-depth decode step's time goes."""
    import torch
    from repro_torch.models import lm

    b = srv.scfg.batch
    caches = lm.init_caches(cfg, b, srv.scfg.max_len, "cuda")
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    profile_step(f"decode step (B={b}, {cfg.n_layers} layers)",
                 lambda: lm.decode_step(srv.params, cfg, tok, caches,
                                        lengths))


def profile_prefill_chunk(srv, cfg, kind: str) -> None:
    """Where one full-depth sparse prefill chunk's time goes, for a
    balanced-tier request (with random weights the latency tier's lower
    alpha predicts no group active, and its MLP kernel has no work)."""
    import torch
    from repro_torch.models import lm

    pc = srv.scfg.prefill_chunk
    caches = lm.init_caches(cfg, 1, srv.scfg.max_len, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (1, pc), generator=gen,
                         device="cuda")
    alphas = srv._prefill_alphas(srv._tier_index["balanced"])
    profile_step(f"prefill chunk (S={pc}, {cfg.n_layers} layers, {kind} "
                 "MLP weights)",
                 lambda: lm.prefill_chunk(srv.params, cfg, toks, caches, 0,
                                          pc, alphas=alphas))


def profile_step(label: str, fn, steps: int = 3) -> None:
    """Host wall time of ``fn`` against device busy time (torch.profiler),
    and the largest kernels by name.  The profiler's count of the port's
    kernels is held against the launch counters: a run in which it missed
    launches reports no device busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
    launched = sum(ops.launch_counts().values())
    # device-side rows only: a CPU op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    seen = sum(e.count for e in events
               if e.key.removeprefix("void ").startswith(OWN_KERNELS))
    busy = sum(e.self_device_time_total for e in events) / steps / 1e3
    if not events or seen != launched:
        print(f"[profile] {label}: {wall:.3f} ms host wall; device busy not "
              f"measured (the profiler recorded {seen} of {launched} "
              "launches of the port's kernels)", flush=True)
    else:
        print(f"[profile] {label}: {wall:.3f} ms host wall, {busy:.3f} ms "
              f"device busy, idle share {max(0.0, 1 - busy / wall):.3f}",
              flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} ms"
              f"/step  x{e.count // steps:<4d} {e.key[:90]}", flush=True)


def _paged_inputs(gen, rng, b, h, kvh, hd, bs, nbps, kv_dtype, q_dtype,
                  lengths=None):
    """q, a random pool, a fragmented table (slots 0 and 1 share their first
    block) and lengths: max_len - 1, 0 and a block boundary first, then
    random ones, unless ``lengths`` is given."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    n = 2 + b * nbps + 3
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    if b > 1:
        table[1, 0] = table[0, 0]
    s_max = nbps * bs
    if lengths is None:
        lengths = [(s_max - 1, 0, bs)[i] if i < 3
                   else int(rng.integers(1, s_max)) for i in range(b)]
    kp = torch.randn((n, bs, kvh, hd), generator=gen, device=dev)
    vp = torch.randn((n, bs, kvh, hd), generator=gen, device=dev)
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    return (q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype),
            torch.as_tensor(table.astype(np.int32), device=dev),
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def _check_attention(tag, out, want, vp) -> float:
    """Tolerance: the output is a weighted mean of v rows.  bf16 pools
    round p to bf16 before the PV product, where a float32 ulp of
    difference can move p by one bf16 ulp: 2^-8 * max|v|.  float32 pools
    differ in summation order only: 1e-4 * max|v|."""
    import torch
    torch.cuda.synchronize()
    vmax = float(vp.float().abs().max())
    tol = (2 ** -8 if vp.dtype == torch.bfloat16 else 1e-4) * vmax
    err = float((out - want).abs().max())
    if not bool(torch.isfinite(out).all()) or err > tol:
        fail(f"paged_attention {tag}: max abs err {err:.3e} > {tol:.3e}")
    return err


def _attention_bound(lengths, b, h, kvh, hd, nbps, elem) -> tuple:
    """Bytes: each live K and V row read once, q read, out (float32)
    written, the table and lengths read; operations: the QK and PV
    multiply-adds of the live rows."""
    live = int((lengths.long() + 1).clamp(max=nbps * PAGE_BLOCK).sum())
    n_bytes = (2 * live * kvh * hd * elem + b * h * hd * elem
               + b * h * hd * 4 + b * nbps * 4 + b * 4)
    return live, bound_ms(n_bytes, 4 * h * live * hd)


def paged_scaling(gen, rng, flush) -> None:
    """paged_attention's time (B=4, H = K = 32, hd 128, bf16) with one
    live row per slot (the fixed cost), at the main path's lengths, at
    those lengths doubled (max_len 512) and at every length 192: a kernel
    bound by latency follows the longest slot, one bound by bytes the live
    rows.  At the main lengths also each cluster size (checked against the
    plain version) and the planned one with the L2 warm."""
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    for label, nbps, lens in (
            ("one live row each", PAGED_NBPS[0], (0,) * MAIN_BATCH),
            ("main", PAGED_NBPS[0], MAIN_LIVE),
            ("main, max_len 512", 2 * PAGED_NBPS[0], MAIN_LIVE),
            ("doubled", 2 * PAGED_NBPS[0], tuple(2 * n for n in MAIN_LIVE)),
            ("all 192", PAGED_NBPS[0], (192,) * MAIN_BATCH)):
        q, kp, vp, table, lengths = _paged_inputs(
            gen, rng, MAIN_BATCH, 32, 32, 128, PAGE_BLOCK, nbps,
            torch.bfloat16, torch.bfloat16, lengths=lens)
        t = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table, lengths),
                    iters=50, flush=flush)
        live, bound = _attention_bound(lengths, MAIN_BATCH, 32, 32, 128,
                                       nbps, 2)
        print(f"[paged] scaling {label}: lengths {list(lens)} ({live} live "
              f"rows, longest {max(lens) + 1}): kernel {t:.4f} ms, bound "
              f"{bound[0]:.4f} ms", flush=True)
        if label == "main":
            # the cluster size against the plan's choice, L2 flushed and warm
            want = ref.paged_attention_ref(q, kp, vp, table, lengths)
            sweep = {}
            for p in (1, 2, 4, 8):
                _check_attention(f"main shape, P={p}", KA.paged_attention(
                    q, kp, vp, table, lengths, cluster=p), want, vp)
                sweep[p] = cuda_ms(lambda p=p: KA.paged_attention(
                    q, kp, vp, table, lengths, cluster=p), iters=50,
                    flush=flush)
            warm = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table,
                                                      lengths), iters=50)
            print("[paged] scaling main by cluster size: " + ", ".join(
                f"P={p} {t:.4f} ms ({KA.launch_plan(q, kp, table, p).fit} "
                "clusters fit)" for p, t in sweep.items())
                + f"; planned P={KA.launch_plan(q, kp, table).cluster} with "
                f"the L2 warm {warm:.4f} ms", flush=True)
        del q, kp, vp


def phase_paged_kernels(results: dict) -> None:
    """paged_attention and paged_kv_write against their plain versions at
    full width and at the edges, then the timings at the main path's
    shape, the attention's scaling with the slot lengths and the
    long-context shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    rng = np.random.default_rng(8)
    h = kvh = 32
    hd, bs = 128, PAGE_BLOCK
    worst = 0.0
    for kv_dtype in (torch.bfloat16, torch.float32):
        for b in BATCHES:
            for nbps in PAGED_NBPS:
                q, kp, vp, table, lengths = _paged_inputs(
                    gen, rng, b, h, kvh, hd, bs, nbps, kv_dtype, kv_dtype)
                tag = (f"B={b} max_len={nbps * bs} pool={str(kv_dtype)[6:]}"
                       f" lengths={lengths.tolist()[:4]}")
                err = _check_attention(
                    tag, KA.paged_attention(q, kp, vp, table, lengths),
                    ref.paged_attention_ref(q, kp, vp, table, lengths), vp)
                worst = max(worst, err)
                print(f"[paged] paged_attention {tag}: max_abs_err "
                      f"{err:.3e}", flush=True)
                del q, kp, vp
    n_edge = phase_paged_edges()
    n_write = phase_paged_write()
    # ---- timings at the main path's shape: B=4, bf16, max_len 256
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    b, nbps = MAIN_BATCH, PAGED_NBPS[0]
    q, kp, vp, table, lengths = _paged_inputs(
        gen, rng, b, h, kvh, hd, bs, nbps, torch.bfloat16, torch.bfloat16,
        lengths=MAIN_LIVE)
    err = _check_attention(
        "main shape", _same_twice(
            "main shape", lambda: KA.paged_attention(q, kp, vp, table,
                                                     lengths)),
        ref.paged_attention_ref(q, kp, vp, table, lengths), vp)
    pl = KA.launch_plan(q, kp, table)
    t_k, t_p, t_lib, t_gl = _time_attention(q, kp, vp, table, lengths,
                                            flush, plain_iters=10)
    live, a_bound = _attention_bound(lengths, b, h, kvh, hd, nbps, 2)
    # the decode step's write: each slot's row at its length
    blk = table.gather(1, (lengths.long() // bs)[:, None])[:, 0]
    off = lengths % bs
    vals = torch.randn((b, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    t_w = cuda_ms(lambda: KA.paged_kv_write(kp, vals, blk, off), iters=50)
    t_wp = cuda_ms(lambda: ref.paged_kv_write_ref(kp, vals, blk, off),
                   iters=20)
    bl, ol = blk.long(), off.long()
    t_wl = cuda_ms(lambda: kp.index_put_((bl, ol), vals), iters=50)
    w_bound = bound_ms(2 * b * kvh * hd * 2 + 2 * b * 4, 0)
    print(f"[paged] paged_attention B={b} bf16 lengths {list(MAIN_LIVE)} "
          f"({live} live rows; {pl}): max_abs_err {err:.3e}, bitwise "
          f"repeatable; kernel {t_k:.4f} ms plain {t_p:.4f} ms bound "
          f"{a_bound[0]:.4f} ms ({a_bound[1]}) sdpa-on-gathered-view "
          f"{t_lib:.4f} ms gather+sdpa {t_gl:.4f} ms (kernel / sdpa "
          f"{t_k / t_lib:.3f})", flush=True)
    print(f"[paged] paged_kv_write B={b} bf16: bitwise, kernel {t_w:.4f} ms"
          f" plain {t_wp:.4f} ms bound {w_bound[0]:.5f} ms ({w_bound[1]}) "
          f"index_put_ {t_wl:.4f} ms", flush=True)
    results["paged_attention"] = dict(
        max_abs_err=max(worst, err), ms=t_k, plain_ms=t_p,
        bound_ms=a_bound[0], bound_by=a_bound[1], library_ms=t_lib)
    results["paged_kv_write"] = dict(
        max_abs_err=0.0, ms=t_w, plain_ms=t_wp, bound_ms=w_bound[0],
        bound_by=w_bound[1], library_ms=t_wl)
    del q, kp, vp
    paged_scaling(gen, rng, flush)
    paged_long(gen, rng, flush)
    print(f"[paged] paged_attention agrees with its plain version in "
          f"{2 * len(BATCHES) * len(PAGED_NBPS)} full-width cases (max "
          f"abs err {worst:.3e}) and {n_edge} edge cases; "
          f"paged_kv_write is bitwise in {n_write} cases", flush=True)
    del flush_buf
    torch.cuda.empty_cache()


def _same_twice(tag, fn, name="paged_attention"):
    """fn() twice on the same inputs: the outputs must be bitwise equal
    (no float atomics, fixed reduction orders)."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name} {tag}: two runs on the same inputs differ "
             f"by {float((a - b).abs().max()):.3e}")
    return a


def _time_attention(q, kp, vp, table, lengths, flush, plain_iters):
    """The kernel, its plain version, SDPA on a dense (B, K, S, hd) view
    gathered beforehand (the gather left out of its time), and the gather
    and SDPA together (H = K: SDPA takes no GQA here)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    b, _, hd = q.shape
    kvh = kp.shape[2]
    s_max = table.shape[1] * kp.shape[1]
    tab = table.long()

    def view(pages):
        return pages[tab].reshape(b, s_max, kvh, hd).transpose(1, 2)
    live_mask = (torch.arange(s_max, device=q.device)[None, :]
                 <= lengths[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    t_k = cuda_ms(lambda: KA.paged_attention(q, kp, vp, table, lengths),
                  iters=50, flush=flush)
    t_p = cuda_ms(lambda: ref.paged_attention_ref(q, kp, vp, table,
                                                  lengths),
                  iters=plain_iters, flush=flush)
    kd, vd = view(kp).contiguous(), view(vp).contiguous()
    t_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=live_mask), iters=50, flush=flush)
    del kd, vd
    t_gl = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, view(kp), view(vp), attn_mask=live_mask), iters=20,
        flush=flush)
    return t_k, t_p, t_lib, t_gl


def paged_long(gen, rng, flush) -> None:
    """The long-context timed shape: B=16, H = K = 32, hd 128, bf16 pool,
    max_len 4096, lengths spread over 512-4095 (a ~1.1 GB pool, ~0.6 GB
    of live K and V rows per call)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    b, h, kvh, hd, nbps = 16, 32, 32, 128, 4096 // PAGE_BLOCK
    # the phase's seed alone: these lengths do not move with the draws of
    # the cases before this one
    lens = [int(x) for x in
            np.random.default_rng(8).integers(512, 4096, size=b)]
    q, kp, vp, table, lengths = _paged_inputs(
        gen, rng, b, h, kvh, hd, PAGE_BLOCK, nbps, torch.bfloat16,
        torch.bfloat16, lengths=lens)
    err = _check_attention(
        "long shape", _same_twice(
            "long shape", lambda: KA.paged_attention(q, kp, vp, table,
                                                     lengths)),
        ref.paged_attention_ref(q, kp, vp, table, lengths), vp)
    pl = KA.launch_plan(q, kp, table)
    t_k, t_p, t_lib, t_gl = _time_attention(q, kp, vp, table, lengths,
                                            flush, plain_iters=3)
    live, bound = _attention_bound(lengths, b, h, kvh, hd, nbps, 2)
    print(f"[paged] paged_attention long shape B={b} bf16 max_len "
          f"{nbps * PAGE_BLOCK} lengths {min(lens)}-{max(lens)} ({live} live "
          f"rows; {pl}): max_abs_err {err:.3e}, bitwise repeatable; kernel "
          f"{t_k:.4f} ms plain {t_p:.4f} ms bound {bound[0]:.4f} ms "
          f"({bound[1]}; share of bound {bound[0] / t_k:.3f}) "
          f"sdpa-on-gathered-view {t_lib:.4f} ms gather+sdpa {t_gl:.4f} ms",
          flush=True)
    del q, kp, vp
    torch.cuda.empty_cache()


def phase_paged_edges() -> int:
    """paged_attention's other paths: GQA rep 2/4/6/8 and 48 (six CTAs'
    groups of query heads), hd 64 and 256, block 1/8/32, softcap, window
    (with a length past it: no live lane, a uniform softmax), float32 q on
    a bf16 pool, lengths past max_len; then the cluster split's edges at
    P = 8: a slot shorter than one CTA's share (P - 1 idle CTAs), spans
    that end exactly on a tile of every CTA and one past it, lengths at a
    page boundary, windows of 1 row, of a tile and a few rows, and of the
    last ceil(max_len / P) rows, none live at P = 8, and rep 8 at max_len
    8192.  Each case twice: bitwise equal runs."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attn as KA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.default_rng(9)
    bf, f32 = torch.bfloat16, torch.float32

    def small(pl, s_max, bs, window):
        return [s_max - 1, 0, bs, s_max + 10, 3]

    def split(pl, s_max, bs, window):
        p, tr = pl.cluster, pl.tile_rows
        return [0, p - 2, p * tr - 1, p * tr, 9 * bs - 1, 9 * bs, s_max - 1]

    def windowed(pl, s_max, bs, window):
        return [s_max - 1, 0, 77, s_max + window + 3]

    def given(*lens):
        return lambda pl, s_max, bs, window: list(lens)

    cases = [
        (3, 8, 4, 64, 8, 6, bf, bf, 0.0, 0, small),
        (3, 16, 4, 128, 1, 40, f32, f32, 0.0, 0, small),
        (2, 16, 2, 64, 32, 3, bf, f32, 30.0, 0, small),
        (5, 8, 8, 128, 16, 4, f32, bf, 0.0, 7, small),
        (5, 4, 1, 256, 8, 5, bf, bf, 20.0, 9, small),
        (4, 32, 4, 64, 8, 16, f32, f32, 0.0, 0, small),
        (7, 8, 8, 128, 16, 64, bf, bf, 0.0, 0, split),
        (7, 8, 8, 128, 16, 64, f32, f32, 0.0, 0, split),
        (7, 8, 8, 128, 16, 64, bf, f32, 0.0, 0, split),
        (4, 8, 8, 128, 16, 64, bf, bf, 0.0, 1, windowed),
        (4, 8, 8, 128, 16, 64, bf, bf, 0.0, 35, windowed),
        (4, 8, 8, 128, 16, 64, f32, f32, 5.0, 128, windowed),
        (2, 32, 4, 128, 16, 512, bf, bf, 0.0, 0, given(8191, 5000)),
        (2, 32, 4, 128, 16, 512, bf, f32, 0.0, 0, given(4095, 8191)),
        (4, 16, 16, 64, 16, 32, bf, bf, 0.0, 0, given(511, 0, 200, 33)),
        (3, 8, 4, 256, 16, 32, f32, f32, 0.0, 0, given(511, 100, 0)),
        (3, 8, 4, 256, 16, 32, bf, bf, 30.0, 0, given(300, 511, 17)),
        (2, 48, 1, 128, 16, 8, bf, bf, 0.0, 0, given(127, 50)),
        (3, 12, 2, 128, 16, 8, f32, f32, 0.0, 0, given(127, 64, 5)),
    ]
    for (b, h, kvh, hd, bs, nbps, kv_dt, q_dt, softcap, window,
         lens_of) in cases:
        s_max = nbps * bs
        q, kp, vp, table, _ = _paged_inputs(
            gen, rng, b, h, kvh, hd, bs, nbps, kv_dt, q_dt, lengths=[0] * b)
        pl = KA.launch_plan(q, kp, table)
        lengths = lens_of(pl, s_max, bs, window)[:b]
        lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
        kw = dict(softcap=softcap, window=window)
        tag = (f"B={b} H={h} K={kvh} hd={hd} block={bs} max_len={s_max} "
               f"{str(kv_dt)[6:]}/{str(q_dt)[6:]} softcap={softcap} "
               f"window={window} lengths={lengths} (P={pl.cluster}, "
               f"tile {pl.tile_rows} rows, {pl.smem_bytes} B)")
        err = _check_attention(
            tag, _same_twice(tag, lambda: ops.paged_attention(
                q, kp, vp, table, lens, **kw)),
            ref.paged_attention_ref(q, kp, vp, table, lens, **kw), vp)
        print(f"[paged] edge {tag}: max_abs_err {err:.3e}", flush=True)
    return len(cases)


def phase_paged_write() -> int:
    """paged_kv_write bitwise against its plain version, with several slots
    on one row of the write-off block (the last one wins) and a row size
    that is not a multiple of 16 bytes."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attn as KA
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(10)
    n = 0
    for dt in (torch.bfloat16, torch.float32):
        for b, row in ((16, (32, 128)), (4, (32, 128)), (9, (3, 5))):
            pages = torch.randn((40, PAGE_BLOCK) + row, generator=gen,
                                device=dev).to(dt)
            vals = torch.randn((b,) + row, generator=gen, device=dev).to(dt)
            blocks = rng.integers(2, 40, size=b)
            offsets = rng.integers(0, PAGE_BLOCK, size=b)
            blocks[: b // 2] = 1                    # the write-off block
            offsets[: b // 2] = rng.integers(0, 2, size=b // 2)
            perm = rng.permutation(b)
            blk = torch.as_tensor(blocks[perm].astype(np.int32), device=dev)
            off = torch.as_tensor(offsets[perm].astype(np.int32), device=dev)
            got, want = pages.clone(), pages.clone()
            KA.paged_kv_write(got, vals, blk, off)
            ref.paged_kv_write_ref(want, vals, blk, off)
            torch.cuda.synchronize()
            last = max(i for i in range(b) if int(blk[i]) == int(blk[0])
                       and int(off[i]) == int(off[0]))
            if not (torch.equal(got, want) and torch.equal(
                    got[int(blk[0]), int(off[0])], vals[last])):
                fail(f"paged_kv_write B={b} row={row} {dt}: differs from "
                     "its plain version or the last slot did not win")
            n += 1
    return n


def phase_sign_kernels(results: dict) -> None:
    """sign_pack and predict_counts against their plain versions at full
    width, bitwise, and predict_margins against core.predictor.margins;
    then the timings at the main path's shapes."""
    import torch
    from repro_torch.core import predictor as P
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import sign_pack as KS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    n = 0

    def same(tag, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape \
                else "shape"
            fail(f"{tag}: differs from its plain version ({bad})")
        return 1

    for d in (D, D_PAD):
        wg = torch.randn((K, d), generator=gen, device=dev) * d ** -0.5
        wg[0, :96] = 0.0
        wg[1, :96] = -0.0
        for wdt in (torch.float32, torch.bfloat16):
            w_t = wg.to(wdt)
            n += same(f"sign_pack wg ({K}, {d}) {wdt}", KS.sign_pack(w_t),
                      ref.sign_pack_ref(w_t))
        pw = KS.sign_pack(wg)
        # 64: a gather prefill chunk's rows (four token tiles of counts)
        for b in (1, 4, 16, 24, MAIN_CHUNK):
            x = torch.randn((b, d), generator=gen, device=dev)
            x[0, ::7] = 0.0
            x[-1, 1::5] = -0.0
            for xdt in (torch.float32, torch.bfloat16):
                tag = f"B={b} d={d} x={str(xdt)[6:]}"
                px = KS.sign_pack(x.to(xdt))
                n += same(f"sign_pack {tag}", px, ref.sign_pack_ref(x.to(xdt)))
                n += same(f"predict_counts {tag}", KP.predict_counts(pw, px),
                          ref.predict_counts_ref(pw, px))
                for aname, alpha in _alpha_cases(b, dev).items():
                    n += same(f"predict_margins {tag} alpha={aname}",
                              ops.predict_margins(pw, px, d, alpha),
                              P.margins(pw, px, d, alpha))
        xg = torch.randn((2, MAIN_BATCH, d), generator=gen, device=dev)
        pxg = ops.sign_pack(xg)
        n += same(f"sign_pack (2, {MAIN_BATCH}, {d})", pxg,
                  ref.sign_pack_ref(xg))
        n += same(f"predict_counts (2, {MAIN_BATCH}, {d})",
                  ops.predict_counts(pw, pxg), ref.predict_counts_ref(pw, pxg))
    print(f"[signs] sign_pack, predict_counts and predict_margins bitwise "
          f"equal to their plain versions in {n} cases (d in {{{D}, "
          f"{D_PAD}}}, B in {{1, 4, 16, 24, {MAIN_CHUNK}}} and "
          f"(2, {MAIN_BATCH}), float32 "
          f"and bf16, zeros and -0.0)", flush=True)
    # ---- timings at the main path's shapes: x (B=4, bf16) per MLP call,
    # the float32 gate weights at load, the counts at B=4
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()
    b, w = MAIN_BATCH, D // 32
    x = torch.randn((b, D), generator=gen, device=dev).to(torch.bfloat16)
    wg = torch.randn((K, D), generator=gen, device=dev) * D ** -0.5
    pw, px = KS.sign_pack(wg), KS.sign_pack(x)
    t_sx = cuda_ms(lambda: KS.sign_pack(x), iters=50, flush=flush)
    t_sx_plain = cuda_ms(lambda: ref.sign_pack_ref(x), iters=20, flush=flush)
    b_sx = bound_ms(b * D * 2 + b * w * 4, b * D)
    t_sw = cuda_ms(lambda: KS.sign_pack(wg), iters=10)
    t_sw_plain = cuda_ms(lambda: ref.sign_pack_ref(wg), iters=3)
    b_sw = bound_ms(K * D * 4 + K * w * 4, K * D)
    t_c = cuda_ms(lambda: KP.predict_counts(pw, px), iters=50, flush=flush)
    t_c_plain = cuda_ms(lambda: ref.predict_counts_ref(pw, px), iters=5,
                        flush=flush)
    b_c = bound_ms(K * w * 4 + b * w * 4 + b * K * 4, 3 * b * K * w)
    print(f"[signs] sign_pack x B={b} bf16: kernel {t_sx:.4f} ms plain "
          f"{t_sx_plain:.4f} ms bound {b_sx[0]:.5f} ms ({b_sx[1]})",
          flush=True)
    print(f"[signs] sign_pack gate weights ({K}, {D}) float32 (at load): "
          f"kernel {t_sw:.4f} ms plain {t_sw_plain:.4f} ms bound "
          f"{b_sw[0]:.4f} ms ({b_sw[1]})", flush=True)
    print(f"[signs] predict_counts B={b}: kernel {t_c:.4f} ms plain "
          f"{t_c_plain:.4f} ms bound {b_c[0]:.4f} ms ({b_c[1]})", flush=True)
    results["sign_pack"] = dict(max_abs_err=0.0, ms=t_sx, plain_ms=t_sx_plain,
                                bound_ms=b_sx[0], bound_by=b_sx[1],
                                library_ms=None)
    results["predict_counts"] = dict(
        max_abs_err=0.0, ms=t_c, plain_ms=t_c_plain, bound_ms=b_c[0],
        bound_by=b_c[1], library_ms=None)
    del wg, pw, flush_buf
    torch.cuda.empty_cache()


def phase_paged_decode() -> None:
    """Two full-width float32 layers decoding against a fragmented float32
    pool: the kernel route on the card against the plain route on the CPU
    and against the gather route on the card."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(n_layers=2, dtype="float32", kv_cache_dtype="float32",
                       paged_attn_kernel=True,
                       sparse=dataclasses.replace(base.sparse,
                                                  strategy="pallas",
                                                  enabled=True))
    b, steps, bs, nbps = MAIN_BATCH, 8, PAGE_BLOCK, 4
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")
    rng = np.random.default_rng(11)
    n = 2 + b * nbps + 3
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    table[1, 0] = table[0, 0]            # a shared prefix block, read only
    table = table.astype(np.int32)
    lens0 = np.asarray([20, 17, 33, 47])
    # stale random content everywhere: the history of the live lanes
    shape = (n, bs, cfg.n_kv_heads, cfg.resolved_head_dim)
    pool_np = [{k: rng.standard_normal(shape).astype(np.float32)
                for k in ("k", "v")} for _ in range(cfg.n_layers)]
    forced = rng.integers(0, cfg.vocab, size=(steps, b, 1))
    alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None] + \
        np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]

    def run(run_cfg, dev):
        pool = {"blocks": [{k: torch.from_numpy(v).to(dev)
                            for k, v in layer.items()}
                           for layer in pool_np]}
        tab = torch.as_tensor(table, device=dev)
        out_l, out_s = [], []
        with torch.inference_mode():
            for t in range(steps):
                lg, pool, st = lm.decode_step(
                    params[dev], run_cfg,
                    torch.as_tensor(forced[t], device=dev), pool,
                    torch.as_tensor(lens0 + t, device=dev), alphas=alphas,
                    collect_stats=True, block_table=tab)
                out_l.append(lg.float().cpu())
                out_s.append({k: v.cpu() for k, v in st.items()})
        return torch.stack(out_l), {k: torch.stack([s[k] for s in out_s])
                                    for k in MLP_STAT_KEYS}

    ops.reset_launch_counts()
    kern = run(cfg, "cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    L = cfg.n_layers
    if counts["paged_attention"] != L * steps or \
            counts["paged_kv_write"] != 2 * L * steps:
        fail(f"paged decode: launches {counts}, want {L * steps} "
             f"paged_attention and {2 * L * steps} paged_kv_write")
    cpu = run(cfg, "cpu")
    gather = run(cfg.replace(paged_attn_kernel=False), "cuda")
    if not bool(torch.isfinite(kern[0]).all()):
        fail("paged decode: non-finite logits on the card")
    # as phase 3: float32 sums in another order; a stat may move by 2 groups
    tol, stat_tol = 1e-3, 2 * cfg.sparse.group_size / cfg.d_ff
    for name, other in (("CPU plain route", cpu),
                        ("card gather route", gather)):
        diff = (kern[0] - other[0]).abs()
        worst = max(float((kern[1][k] - other[1][k]).abs().max())
                    for k in MLP_STAT_KEYS)
        n_diff = sum(int((kern[1][k] != other[1][k]).sum())
                     for k in MLP_STAT_KEYS)
        print(f"[paged-decode] kernel route vs {name}: logits max abs diff "
              f"{float(diff.max()):.3e}, median {float(diff.median()):.3e} "
              f"(tolerance {tol}); {n_diff} of "
              f"{len(MLP_STAT_KEYS) * steps * L * b} stat entries differ, by"
              f" at most {worst:.3e}", flush=True)
        if float(diff.max()) > tol or worst > stat_tol:
            fail(f"paged decode vs {name}: logits differ by "
                 f"{float(diff.max())} or a stat by {worst}")
    print(f"[paged-decode] launches on the card {counts}", flush=True)
    del params
    torch.cuda.empty_cache()


def phase_serve_paged(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server with the
    paged KV pool (bf16, block 16, paged_attn_kernel), chunked sparse
    prefill (chunks of 64) and float32 MLP weights."""
    import numpy as np
    import torch
    from repro_torch.configs.base import PagedKVConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    cfg = base.replace(kv_cache_dtype="bfloat16", paged_attn_kernel=True,
                       sparse=dataclasses.replace(
                           base.sparse, strategy="pallas", enabled=True,
                           sparse_prefill=True,
                           prefill_max_tokens=max(
                               base.sparse.prefill_max_tokens, MAIN_CHUNK)))
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK,
                       paged_kv=PagedKVConfig(block_size=PAGE_BLOCK))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, "cuda")
    srv = Server(lm, cfg, scfg, params, device="cuda")
    torch.cuda.synchronize()
    pool_bytes = sum(t.numel() * t.element_size()
                     for layer in srv._pool["blocks"] for t in layer.values())
    print(f"[serve-paged] {cfg.n_layers} layers, KV pool "
          f"{srv.kv_pool.n_blocks} blocks x {PAGE_BLOCK} tokens "
          f"{cfg.kv_cache_dtype}, {pool_bytes / 1e9:.3f} GB; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(12)
    system = rng.integers(0, cfg.vocab, size=128)
    # uid 0 shares the system prompt and finishes first (8 new tokens);
    # uids 4-6 share it too and are admitted only when a slot frees, after
    # uid 0 committed its prompt blocks.  Sharers keep one tier: the
    # sparse-prefill alphas salt the trie.
    specs = [(True, 8, "balanced", None), (False, 16, "latency", "sA"),
             (False, 16, "quality", "sB"), (False, 16, "balanced", None),
             (True, 16, "balanced", None), (True, 16, "balanced", None),
             (True, 16, "balanced", None), (False, 16, "quality", None)]
    reqs = []
    for uid, (share, max_new, sla, sid) in enumerate(specs):
        own = rng.integers(0, cfg.vocab, size=int(
            rng.integers(16, 41) if share else rng.integers(60, 151)))
        prompt = np.concatenate([system, own]) if share else own
        reqs.append(Request(uid=uid, prompt=prompt, max_new=max_new,
                            sla=sla, session_id=sid))
    L = cfg.n_layers

    def serve(batch, label):
        ops.reset_launch_counts()
        steps0, run0 = srv.decode_steps, srv.prefill_chunks_run
        skip0 = srv.prefill_chunks_skipped
        done = srv.serve(batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps = srv.decode_steps - steps0
        chunks = srv.prefill_chunks_run - run0
        skipped = srv.prefill_chunks_skipped - skip0
        if len(done) != len(batch) or any(
                r.outcome != "completed" or len(r.out) != r.max_new
                or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                for r in done):
            fail(f"serve-paged {label}: not every request completed with "
                 "valid tokens")
        want = {k: 0 for k in counts}
        want.update({"predict_group_margins": L * steps,
                     "fused_sparse_mlp": L * steps,
                     "paged_attention": L * steps,
                     "paged_kv_write": 2 * L * steps,
                     "predict_chunk_group_margins": L * chunks,
                     "fused_sparse_mlp_chunk": L * chunks})
        n_chunks = sum(-(-len(r.prompt) // MAIN_CHUNK) for r in batch)
        if steps == 0 or counts != want or chunks + skipped != n_chunks:
            fail(f"serve-paged {label}: launches {counts}, want {want} "
                 f"({steps} decode steps, {chunks} chunks run + {skipped} "
                 f"skipped of {n_chunks})")
        rep = throughput_report(done)
        print(f"[serve-paged] {label}: throughput_report {json.dumps(rep)}",
              flush=True)
        print(f"[serve-paged] {label}: decode steps {steps}; prefill chunks "
              f"run {chunks}, skipped {skipped}; launches {counts}; "
              f"paged_stats {json.dumps(srv.paged_stats())}", flush=True)
        return done, counts

    done, counts = serve(reqs, "8 requests")
    results["launches_paged"] = counts
    st = srv.paged_stats()
    if st["reuse_hits"] < 3 or st["prefill_chunks_skipped"] < 6:
        fail(f"serve-paged: the three later sharers of the system prompt "
             f"did not admit by reference: {st}")
    hist = {r.uid: np.concatenate([r.prompt, r.out]) for r in done}
    turn2 = [Request(uid=10 + u, prompt=np.concatenate(
                 [hist[u], rng.integers(0, cfg.vocab, size=8)]),
                 max_new=16, session_id=sid)
             for u, sid in ((1, "sA"), (2, "sB"))]
    done2, _ = serve(turn2, "turn 2 of two sessions")
    tiers = {r.uid: r.sla for r in done2}
    if tiers != {11: "latency", 12: "quality"}:
        fail(f"serve-paged: session tiers did not stick: {tiers}")
    # a sharer alone, admitted by reference, against a fresh server
    probe = np.concatenate([system, rng.integers(0, cfg.vocab, size=24)])
    skip0 = srv.prefill_chunks_skipped
    [got], _ = serve([Request(uid=20, prompt=probe, max_new=16)],
                     "a reused prefix alone")
    if srv.prefill_chunks_skipped - skip0 != 2:
        fail("serve-paged: the probe did not admit its 128-token prefix by "
             "reference")
    print(f"[serve-paged] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    srv.kv_pool.check_invariants()
    fresh = Server(lm, cfg, scfg, params, device="cuda")
    [want] = fresh.serve([Request(uid=20, prompt=probe, max_new=16)])
    torch.cuda.synchronize()
    if not np.array_equal(got.out, want.out):
        fail(f"serve-paged: the reused-prefix request emitted {got.out} "
             f"but {want.out} on a fresh server")
    print(f"[serve-paged] the reused-prefix request's 16 tokens equal a "
          f"fresh server's", flush=True)
    del fresh, params
    profile_paged_decode(srv, cfg)
    del srv
    torch.cuda.empty_cache()


def profile_paged_decode(srv, cfg) -> None:
    """Where one full-depth paged decode step's time goes: B=4, every slot
    at length 64 over its own 16 pool blocks (a pool of its own)."""
    import torch
    from repro_torch.models import lm

    b, nbps = srv.scfg.batch, srv._nbps
    pool = lm.init_kv_pool(cfg, b * nbps + 2, PAGE_BLOCK, "cuda")
    table = (torch.arange(b * nbps, dtype=torch.int32, device="cuda")
             + 2).reshape(b, nbps)
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    profile_step(f"paged decode step (B={b}, {cfg.n_layers} layers, "
                 f"{cfg.kv_cache_dtype} pool, paged kernels)",
                 lambda: lm.decode_step(srv.params, cfg, tok, pool, lengths,
                                        block_table=table))


def phase_serve_controller(results: dict) -> None:
    """All 32 full-width layers through the slot-refill server with the
    adaptive-alpha controller per SLA tier: strategy gather (masked audit
    every 4th step), then pallas (native false negatives).  The launch
    counters are reset before the server is built, so they cover the sign
    pack at load too."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ControllerConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import (Request, Server, ServeConfig,
                                            throughput_report)

    base = get_config("prosparse-llama2-7b")
    scfg = ServeConfig(batch=MAIN_BATCH, max_len=256, max_new_tokens=16,
                       prefill_chunk=MAIN_CHUNK, warm_buckets=True,
                       controller=ControllerConfig(enabled=True,
                                                   per_tier=True,
                                                   audit_period=4))
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, base.vocab, size=int(p))
               for p in rng.integers(64, 129, size=8)]
    tiers = ("latency", "balanced", "quality")
    L = base.n_layers
    for strategy in ("gather", "pallas"):
        cfg = base.replace(sparse=dataclasses.replace(
            base.sparse, strategy=strategy, enabled=True,
            sparse_prefill=True, capacity_buckets=CTRL_BUCKETS,
            prefill_max_tokens=max(base.sparse.prefill_max_tokens,
                                   MAIN_CHUNK)))
        t0 = time.perf_counter()
        params = lm.init_lm(cfg, 0, "cuda")
        ops.reset_launch_counts()
        srv = Server(lm, cfg, scfg, params, device="cuda")
        del params
        ladder = cfg.sparse.capacity_ladder(cfg.d_ff)
        reqs = [Request(uid=i, prompt=p, max_new=16, sla=tiers[i % 3])
                for i, p in enumerate(prompts)]
        t1 = time.perf_counter()
        done = srv.serve(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps, warm = srv.decode_steps, srv.warmup_steps
        chunks = srv.prefill_chunks_run
        ctl = srv.controller
        rep = throughput_report(done)
        print(f"[serve-controller] {strategy}: ladder {list(ladder)} groups; "
              f"init {t1 - t0:.1f} s, serve {time.perf_counter() - t1:.1f} s;"
              f" throughput_report {json.dumps(rep)}", flush=True)
        print(f"[serve-controller] {strategy}: decode steps {steps} (+{warm} "
              f"warmup), prefill chunks {chunks}, audits {ctl.state.audits}; "
              f"launches {counts}", flush=True)
        print(f"[serve-controller] {strategy}: bucket sequence "
              f"{list(srv.bucket_history)}; setups per bucket "
              f"{dict(srv._trace_counts)}", flush=True)
        print(f"[serve-controller] {strategy}: controller report "
              f"{json.dumps(ctl.report())}", flush=True)
        if len(done) != 8 or any(
                r.outcome != "completed" or len(r.out) != 16
                or not ((r.out >= 0) & (r.out < cfg.vocab)).all()
                for r in done):
            fail(f"serve-controller ({strategy}): not every request "
                 "completed with 16 valid tokens")
        want = {n: 0 for n in counts}
        if strategy == "gather":
            # x's sign pack and the counts in every MLP call: decode steps,
            # warmup steps and prefill chunks; the gate weights' at load
            want["sign_pack"] = L * (1 + steps + warm + chunks)
            want["predict_counts"] = L * (steps + warm + chunks)
            audits = steps // 4
        else:
            want.update({"sign_pack": L,
                         "predict_group_margins": L * (steps + warm),
                         "fused_sparse_mlp": L * (steps + warm),
                         "predict_chunk_group_margins": L * chunks,
                         "fused_sparse_mlp_chunk": L * chunks})
            audits = 0
        if steps == 0 or counts != want:
            fail(f"serve-controller ({strategy}): launches {counts}, want "
                 f"{want}")
        if (ctl.state.steps, ctl.state.audits, ctl.prefill_chunks) != \
                (steps, audits, chunks) or ctl.native_fn != (
                    strategy == "pallas"):
            fail(f"serve-controller ({strategy}): controller saw "
                 f"{ctl.state.steps} steps, {ctl.state.audits} audits, "
                 f"{ctl.prefill_chunks} prefill chunks; want {steps}, "
                 f"{audits}, {chunks}")
        if warm != len(ladder) or set(srv._trace_counts.values()) != {1} \
                or not set(srv.bucket_history) <= set(ladder):
            fail(f"serve-controller ({strategy}): warmup {warm} steps, "
                 f"setups {dict(srv._trace_counts)}, buckets "
                 f"{set(srv.bucket_history)} (ladder {ladder})")
        # random weights keep the union demand near 1, so the serve holds
        # the top rung; a forced demand estimate must move the selection
        # down the ladder (slack 1.3, rounded up to 128 neurons: 0.05 ->
        # 96 groups -> the lowest rung, 0.15 -> 272 -> the middle one)
        held = ctl.state.union_ema
        picks = {}
        for demand in (0.05, 0.15, 1.0):
            ctl.state.union_ema = np.full_like(ctl.state.density_ema,
                                               demand)
            picks[demand] = srv._select_bucket()
        ctl.state.union_ema = held
        print(f"[serve-controller] {strategy}: forced union demand -> "
              f"bucket {picks}", flush=True)
        if list(picks.values()) != sorted(ladder):
            fail(f"serve-controller ({strategy}): forced demands selected "
                 f"{picks}, want the rungs {sorted(ladder)} in order")
        results[f"launches_ctrl_{strategy}"] = counts
        if strategy == "gather":
            profile_controller_steps(srv, cfg)
        del srv
        torch.cuda.empty_cache()


def profile_controller_steps(srv, cfg) -> None:
    """Where one full-depth controller decode step's time goes: a gather
    step at the 288-group rung and a masked audit step, B=4, balanced-tier
    alphas, caches at length 64, telemetry collected."""
    import numpy as np
    import torch
    from repro_torch.models import lm

    b = srv.scfg.batch
    caches = lm.init_caches(cfg, b, srv.scfg.max_len, "cuda")
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    alphas = srv._slot_alpha_matrix(
        np.full(b, srv._tier_index["balanced"]))
    for label, c in ((f"gather decode step (B={b}, {cfg.n_layers} layers, "
                      "bucket 288 groups)", srv._bucket_cfgs[288]),
                     (f"masked audit step (B={b}, {cfg.n_layers} layers)",
                      srv._audit_cfg)):
        profile_step(label, lambda c=c: lm.decode_step(
            srv.params, c, tok, caches, lengths, alphas=alphas,
            collect_stats=True))


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from the repo")
    sys.path.insert(0, src)
    # tolerances are set against full-float32 matrix products: TF32 keeps
    # ~3 decimal digits and would hide (or fake) a kernel fault
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[gpu] {gpu_line()}", flush=True)
    t0 = time.perf_counter()
    results: dict = {}
    for phase, args in ((phase_build, ()), (phase_kernels, (results,)),
                        (phase_chunk_kernels, (results,)),
                        (phase_chunk_scaling, ()),
                        (phase_paged_kernels, (results,)),
                        (phase_sign_kernels, (results,)),
                        (phase_decode, ()), (phase_prefill, ()),
                        (phase_paged_decode, ()),
                        (phase_decode_strategies, ()),
                        (phase_serve, (results,)),
                        (phase_serve_chunked, (results,)),
                        (phase_serve_paged, (results,)),
                        (phase_serve_controller, (results,))):
        t = time.perf_counter()
        phase(*args)
        print(f"[time] {phase.__name__}: {time.perf_counter() - t:.1f} s",
              flush=True)
    print(f"[done] all phases in {time.perf_counter() - t0:.1f} s",
          flush=True)
    src_of = "src/repro_torch/csrc/{}.cu".format
    launches = {
        **results["launches"],
        **{n: results["launches_chunked_float32"][n]
           for n in ("predict_chunk_group_margins", "fused_sparse_mlp_chunk")},
        **{n: results["launches_chunked_int8"][n]
           for n in ("fused_sparse_mlp_q", "fused_sparse_mlp_chunk_q")},
        **{n: results["launches_paged"][n]
           for n in ("paged_attention", "paged_kv_write")},
        **{n: results["launches_ctrl_gather"][n]
           for n in ("sign_pack", "predict_counts")}}
    replaces = {
        "predict_group_margins": "src/repro/kernels/predict.py:263",
        "fused_sparse_mlp": "src/repro/kernels/sparse_mlp_fused.py:300",
        "predict_chunk_group_margins": "src/repro/kernels/predict.py:216",
        "fused_sparse_mlp_chunk": "src/repro/kernels/sparse_mlp_fused.py:499",
        "fused_sparse_mlp_q": "src/repro/kernels/sparse_mlp_fused.py:397",
        "fused_sparse_mlp_chunk_q":
            "src/repro/kernels/sparse_mlp_fused.py:597",
        "paged_attention": "src/repro/kernels/paged_attn.py:125",
        "paged_kv_write": "src/repro/kernels/paged_attn.py:164",
        "sign_pack": "src/repro/kernels/sign_pack.py:73",
        "predict_counts": "src/repro/kernels/predict.py:85"}
    kernels = [{"name": n, "route": "cuda", "source": src_of(n),
                "replaces": r, "launches": launches[n], **results[n]}
               for n, r in replaces.items()]
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
