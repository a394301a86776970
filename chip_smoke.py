#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build   nvcc-compile every kernel source in src/repro_torch/csrc/.
  2. kernels each CUDA kernel against its plain PyTorch version on the card
             at prosparse-llama2-7b's full width (d=4096, k=11008, G=8),
             B in {1, 4, 16}, alpha in {1.0, 1.03, per-slot with a dead
             slot}; timed beside its bound, its plain version and a library
             yardstick.
  3. decode  prosparse-llama2-7b at full width, 2 layers, float32 compute
             and KV cache: 8 teacher-forced decode steps on the card against
             the same weights on the CPU (plain kernel versions), logits and
             stats.
  4. serve   prosparse-llama2-7b at full width and all 32 layers through
             Server.serve (strategy pallas, batch 4, 8 requests, mixed SLA
             tiers); the kernel launch counters must show two launches per
             sparse MLP per decode step.
  5. report  a {"kernels": [...]} line, then {"ok": true, "device": ...}.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 rate
# outside the tensor cores — the kernels' arithmetic runs on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

D, K, G = 4096, 11008, 8
BATCHES = (1, 4, 16)
MAIN_BATCH = 4            # the serve phase's batch: the main path's shape


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
    """Mean device time of ``fn`` in ms from CUDA events.  With ``flush``
    (a callable that evicts the L2) each launch follows a flush and the
    flush's own time is subtracted, so the kernel finds its inputs in HBM
    as it does inside a decode step."""
    import torch

    def timed(body):
        for _ in range(3):
            body()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            body()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

    if flush is None:
        return timed(fn)

    def both():
        flush()
        fn()
    return max(timed(both) - timed(flush), 0.0)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


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
    float rounding of 0 (there the two sums may disagree on its sign)."""
    import torch
    if torch.equal(tel, tel_r):
        return
    rows = wg.reshape(K // G, G, D)[sel_idx[:count].long()].reshape(-1, D)
    g = x.float() @ rows.T
    scale = (x.float().abs() @ rows.abs().T)
    near = ((g.abs() <= 1e-5 * scale).sum(-1)).to(torch.int32)   # (B,)
    diff = (tel - tel_r).abs()
    print(f"[kernels] telemetry {tag}: differs by {diff.tolist()} where "
          f"{near.tolist()} gate values lie within rounding of 0",
          flush=True)
    if not (torch.equal(tel[:, 2], tel_r[:, 2])
            and bool((diff[:, :2] <= near[:, None]).all())):
        fail(f"fused_sparse_mlp telemetry {tag}: {tel.tolist()} vs "
             f"{tel_r.tolist()}")


def phase_decode() -> None:
    """Two full-width float32 layers: card (CUDA kernels) vs CPU (plain)."""
    import numpy as np
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
    b, plen, steps, max_len = 4, 16, 8, 32
    params = {"cuda": lm.prepare_sparse(lm.init_lm(cfg, 0, "cuda"))}
    params["cpu"] = _to(params["cuda"], "cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(b, plen))
    forced = rng.integers(0, cfg.vocab, size=(steps, b, 1))
    # per-slot alphas: schedule plus SLA-like offsets
    alphas = cfg.sparse.alpha_schedule().alphas(cfg.n_layers)[:, None] + \
        np.asarray([0.0, -0.02, 0.02, 0.0], np.float32)[None, :]

    def run(run_cfg, dev):
        with torch.inference_mode():
            lg, caches = lm.prefill(params[dev], run_cfg,
                                    torch.as_tensor(prompt, device=dev),
                                    max_len)
            out_l, out_s = [], []
            for t in range(steps):
                lg, caches, st = lm.decode_step(
                    params[dev], run_cfg,
                    torch.as_tensor(forced[t], device=dev), caches,
                    torch.full((b,), plen + t, device=dev), alphas=alphas,
                    collect_stats=True)
                out_l.append(lg.float().cpu())
                out_s.append({k: v.cpu() for k, v in st.items()})
        return torch.stack(out_l), {k: torch.stack([s[k] for s in out_s])
                                    for k in MLP_STAT_KEYS}

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
    if steps == 0 or counts != {"predict_group_margins": want,
                                "fused_sparse_mlp": want}:
        fail(f"serve: launches {counts}, want {want} of each kernel "
             f"(2 per sparse MLP x {cfg.n_layers} layers x {steps} steps)")
    results["launches"] = counts
    profile_decode(srv, cfg)
    del srv, params
    torch.cuda.empty_cache()


def profile_decode(srv, cfg, steps: int = 3) -> None:
    """Where one full-depth decode step's time goes: host wall time against
    device busy time (torch.profiler), and the largest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm

    b = srv.scfg.batch
    caches = lm.init_caches(cfg, b, srv.scfg.max_len, "cuda")
    tok = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
    lengths = torch.full((b,), 64, device="cuda")
    with torch.inference_mode():
        lm.decode_step(srv.params, cfg, tok, caches, lengths)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                lm.decode_step(srv.params, cfg, tok, caches, lengths)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
    # device-side rows only: a CPU op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / steps / 1e3
    if not events:
        print(f"[profile] decode step {wall:.2f} ms host wall; device time "
              "not measured (the profiler saw no device events)", flush=True)
        return
    print(f"[profile] decode step (B={b}, {cfg.n_layers} layers): "
          f"{wall:.3f} ms host wall, {busy:.3f} ms device busy, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} ms"
              f"/step  x{e.count // steps:<4d} {e.key[:90]}", flush=True)


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
    phase_build()
    phase_kernels(results)
    phase_decode()
    phase_serve(results)
    print(f"[done] all phases in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kernels = [
        {"name": "predict_group_margins", "route": "cuda",
         "source": "src/repro_torch/csrc/predict_group_margins.cu",
         "replaces": "src/repro/kernels/predict.py:240",
         "launches": results["launches"]["predict_group_margins"],
         **results["predict_group_margins"]},
        {"name": "fused_sparse_mlp", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_sparse_mlp.cu",
         "replaces": "src/repro/kernels/sparse_mlp_fused.py:221",
         "launches": results["launches"]["fused_sparse_mlp"],
         **results["fused_sparse_mlp"]},
    ]
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
