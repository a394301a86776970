"""Launchers of the fused sparse-MLP CUDA kernels, the counterparts of the
Pallas kernels of ``repro/kernels/sparse_mlp_fused.py``:

==========================  =====================================  ========
launcher                    source                                 weights
==========================  =====================================  ========
fused_sparse_mlp            csrc/fused_sparse_mlp.cu (B <= 16)     float32
fused_sparse_mlp_chunk      csrc/fused_sparse_mlp_chunk.cu         float32
fused_sparse_mlp_q          csrc/fused_sparse_mlp_q.cu (B <= 16)   int8
fused_sparse_mlp_chunk_q    csrc/fused_sparse_mlp_chunk_q.cu       int8
==========================  =====================================  ========

All four share the kernel template of ``csrc/fused_sparse_mlp.cuh``; each
source instantiates its own.  Callers go through ``kernels.ops``, which
picks the plain version for CPU tensors and counts launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# columns of the telemetry output, in order (per-token int32 row counts)
TELEMETRY_COLS = ("actual", "false_neg", "realized")

MAX_BATCH = 16          # rows a decode launch takes; the chunk kernels
                        # take any number, in row blocks of 16
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLANS: dict[tuple, tuple] = {}


def _plan(name: str, code: int, b: int, d: int, cap_rows: int,
          device) -> tuple:
    """(grid, dc, n_slices, rows_per_slice, smem) of a launch shape."""
    key = (name, code, b, d, cap_rows, device)
    if key not in _PLANS:
        out = (ctypes.c_int * 5)()
        lib = build.load(name)
        with torch.cuda.device(device):
            rc = getattr(lib, f"{name}_plan")(code, b, d, cap_rows, out)
        build.check(name, rc)
        _PLANS[key] = tuple(out)
    return _PLANS[key]


def _launch(name: str, x, wg, wu, wd, wg_s, wu_s, wd_s, sel_indices,
            sel_count, gm_tok, *, group_size: int, activation: str,
            fatrelu_threshold: float, collect_stats: bool):
    b, d = x.shape
    k = wg.shape[0]
    g = group_size
    cap = sel_indices.shape[0]
    dev = x.device
    quant = wg_s is not None
    wdt = torch.int8 if quant else torch.float32
    mats = [m for m in (wg, wu, wd) if m is not None]
    scales = [s for s in (wg_s, wu_s, wd_s) if s is not None]
    if not x.is_cuda or any(t.device != dev for t in mats + scales) \
            or sel_indices.device != dev:
        raise ValueError(f"{name} launches on CUDA tensors of one device")
    if any(m.dtype != wdt for m in mats) \
            or any(s.dtype != torch.float32 for s in scales):
        raise ValueError(f"{name} reads {wdt} weights and float32 scales")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"unsupported x dtype {x.dtype}")
    chunk = "chunk" in name
    if any(m.shape != (k, d) for m in mats) or k % g or d % 4 or cap < 1 \
            or b < 1 or (b > MAX_BATCH and not chunk):
        raise ValueError(f"bad shapes x={tuple(x.shape)} w=({k}, {d}) "
                         f"C={cap} G={g} for {name}")
    qg = 0
    if quant:
        qg = d // wg_s.shape[1]
        if (wu is None) != (wu_s is None) or qg * wg_s.shape[1] != d \
                or k % qg or qg % g \
                or any(s.shape != (k, d // qg) for s in (wg_s, wu_s)
                       if s is not None) or wd_s.shape != (k // qg, d):
            raise ValueError(f"bad quant layout for {name}: qg={qg} "
                             f"scales {[tuple(s.shape) for s in scales]}")
    if collect_stats and (gm_tok is None or gm_tok.shape != (b, k // g)):
        raise ValueError("collect_stats needs per-token group margins "
                         "(B, k/G)")
    act_kind = 1 if (activation == "fatrelu" or fatrelu_threshold > 0.0) \
        else 0
    if act_kind == 0 and activation != "relu":
        raise ValueError(f"activation {activation!r} is not sparsifiable")
    sel = sel_indices.to(torch.int32).contiguous()
    count = torch.as_tensor(sel_count, dtype=torch.int32,
                            device=dev).reshape(())
    x = x.contiguous()
    code = _X_DTYPES[x.dtype]
    grid, dc, n_slices, rps, smem = _plan(name, code, b, d, cap * g, dev)
    y = torch.empty((b, d), dtype=torch.float32, device=dev)
    ws = torch.zeros((1 + 3 * b,), dtype=torch.int32, device=dev)  # bar+tel
    tel = ws[1:].view(b, 3)
    hbuf = torch.empty((cap * g * b,), dtype=torch.float32, device=dev)
    part = torch.empty((n_slices * b * d,), dtype=torch.float32, device=dev)
    gm = gm_tok.float().contiguous() if collect_stats else None

    wg, wu, wd, wg_s, wu_s, wd_s = (
        t.contiguous() if t is not None else None
        for t in (wg, wu, wd, wg_s, wu_s, wd_s))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = build.load(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(
        x.data_ptr(), code, ptr(wg), ptr(wu), ptr(wd), ptr(wg_s), ptr(wu_s),
        ptr(wd_s), sel.data_ptr(), count.data_ptr(), ptr(gm), y.data_ptr(),
        tel.data_ptr() if collect_stats else None, hbuf.data_ptr(),
        part.data_ptr(), ws.data_ptr(), b, d, k, cap, g, qg, act_kind,
        float(fatrelu_threshold), grid, dc, n_slices, rps, smem, stream)
    build.check(name, rc)
    if collect_stats:
        return y, tel
    return y


def fused_sparse_mlp(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                     gm_tok=None, *, group_size: int = 8,
                     activation: str = "relu", fatrelu_threshold: float = 0.0,
                     collect_stats: bool = False):
    """One launch: x (B <= 16, d) float32/bfloat16; w*_t (k, d) float32
    neuron-major (``wu_t`` None = ungated); sel_indices (C,) int32 group
    ids; sel_count () int32 on the device.  Returns y (B, d) float32, and
    with ``collect_stats`` (needs ``gm_tok`` (B, k/G) float32) also the
    (B, 3) int32 telemetry of ``TELEMETRY_COLS``."""
    return _launch("fused_sparse_mlp", x, wg_t, wu_t, wd_t, None, None, None,
                   sel_indices, sel_count, gm_tok, group_size=group_size,
                   activation=activation,
                   fatrelu_threshold=fatrelu_threshold,
                   collect_stats=collect_stats)


def fused_sparse_mlp_chunk(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                           gm_tok=None, *, group_size: int = 8,
                           activation: str = "relu",
                           fatrelu_threshold: float = 0.0,
                           collect_stats: bool = False):
    """:func:`fused_sparse_mlp` for any number of rows (a prefill chunk):
    one selection drives every 16-row block."""
    return _launch("fused_sparse_mlp_chunk", x, wg_t, wu_t, wd_t, None, None,
                   None, sel_indices, sel_count, gm_tok,
                   group_size=group_size, activation=activation,
                   fatrelu_threshold=fatrelu_threshold,
                   collect_stats=collect_stats)


def fused_sparse_mlp_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, sel_indices,
                       sel_count, gm_tok=None, *, group_size: int = 8,
                       activation: str = "relu",
                       fatrelu_threshold: float = 0.0,
                       collect_stats: bool = False):
    """:func:`fused_sparse_mlp` over int8 weights: w*_q (k, d) int8,
    ``wg_s``/``wu_s`` (k, d/qg) and ``wd_s`` (k/qg, d) float32 scales."""
    return _launch("fused_sparse_mlp_q", x, wg_q, wu_q, wd_q, wg_s, wu_s,
                   wd_s, sel_indices, sel_count, gm_tok,
                   group_size=group_size, activation=activation,
                   fatrelu_threshold=fatrelu_threshold,
                   collect_stats=collect_stats)


def fused_sparse_mlp_chunk_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                             sel_indices, sel_count, gm_tok=None, *,
                             group_size: int = 8, activation: str = "relu",
                             fatrelu_threshold: float = 0.0,
                             collect_stats: bool = False):
    """:func:`fused_sparse_mlp_q` for any number of rows (a prefill
    chunk)."""
    return _launch("fused_sparse_mlp_chunk_q", x, wg_q, wu_q, wd_q, wg_s,
                   wu_s, wd_s, sel_indices, sel_count, gm_tok,
                   group_size=group_size, activation=activation,
                   fatrelu_threshold=fatrelu_threshold,
                   collect_stats=collect_stats)
