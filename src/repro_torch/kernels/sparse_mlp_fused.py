"""Launcher of the fused sparse-MLP CUDA kernel
(``csrc/fused_sparse_mlp.cu``), the counterpart of the Pallas kernel
``repro/kernels/sparse_mlp_fused.py:fused_sparse_mlp``.

Callers go through ``kernels.ops``, which picks the plain version for CPU
tensors and counts launches."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# columns of the telemetry output, in order (per-token int32 row counts)
TELEMETRY_COLS = ("actual", "false_neg", "realized")

MAX_BATCH = 16
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLANS: dict[tuple, tuple] = {}


def _plan(code: int, b: int, d: int, cap_rows: int, device) -> tuple:
    """(grid, dc, n_slices, rows_per_slice, smem) of a launch shape."""
    key = (code, b, d, cap_rows, device)
    if key not in _PLANS:
        out = (ctypes.c_int * 5)()
        lib = build.load("fused_sparse_mlp")
        with torch.cuda.device(device):
            rc = lib.fused_sparse_mlp_plan(code, b, d, cap_rows, out)
        build.check("fused_sparse_mlp", rc)
        _PLANS[key] = tuple(out)
    return _PLANS[key]


def fused_sparse_mlp(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                     gm_tok=None, *, group_size: int = 8,
                     activation: str = "relu", fatrelu_threshold: float = 0.0,
                     collect_stats: bool = False):
    """One launch: x (B, d) float32/bfloat16; w*_t (k, d) float32
    neuron-major (``wu_t`` None = ungated); sel_indices (C,) int32 group
    ids; sel_count () int32 on the device.  Returns y (B, d) float32, and
    with ``collect_stats`` (needs ``gm_tok`` (B, k/G) float32) also the
    (B, 3) int32 telemetry of ``TELEMETRY_COLS``."""
    b, d = x.shape
    k = wg_t.shape[0]
    g = group_size
    cap = sel_indices.shape[0]
    dev = x.device
    mats = [m for m in (wg_t, wu_t, wd_t) if m is not None]
    if not x.is_cuda or any(m.device != dev for m in mats) \
            or sel_indices.device != dev:
        raise ValueError("fused_sparse_mlp launches on CUDA tensors of one "
                         "device")
    if any(m.dtype != torch.float32 for m in mats):
        raise NotImplementedError(
            "fused_sparse_mlp reads float32 weights; bf16 and int8 weights "
            "are later work (ROADMAP Queue B)")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"unsupported x dtype {x.dtype}")
    if any(m.shape != (k, d) for m in mats) or k % g or d % 4 \
            or not 1 <= b <= MAX_BATCH or cap < 1:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w=({k}, {d}) "
                         f"C={cap} G={g}")
    if collect_stats and (gm_tok is None or gm_tok.shape != (b, k // g)):
        raise ValueError("collect_stats needs per-token group margins "
                         "(B, k/G)")
    sel = sel_indices.to(torch.int32).contiguous()
    count = torch.as_tensor(sel_count, dtype=torch.int32,
                            device=dev).reshape(())
    x = x.contiguous()
    mats = [m.contiguous() for m in mats]
    code = _X_DTYPES[x.dtype]
    grid, dc, n_slices, rps, smem = _plan(code, b, d, cap * g, dev)
    y = torch.empty((b, d), dtype=torch.float32, device=dev)
    ws = torch.zeros((1 + 3 * b,), dtype=torch.int32, device=dev)  # bar+tel
    tel = ws[1:].view(b, 3)
    hbuf = torch.empty((cap * g * b,), dtype=torch.float32, device=dev)
    part = torch.empty((n_slices * b * d,), dtype=torch.float32, device=dev)
    gm = gm_tok.float().contiguous() if collect_stats else None
    act_kind = 1 if (activation == "fatrelu" or fatrelu_threshold > 0.0) \
        else 0
    if act_kind == 0 and activation != "relu":
        raise ValueError(f"activation {activation!r} is not sparsifiable")
    wg, wu, wd = wg_t.contiguous(), \
        (wu_t.contiguous() if wu_t is not None else None), wd_t.contiguous()
    lib = build.load("fused_sparse_mlp")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fused_sparse_mlp(
        x.data_ptr(), code, wg.data_ptr(),
        wu.data_ptr() if wu is not None else None, wd.data_ptr(),
        sel.data_ptr(), count.data_ptr(),
        gm.data_ptr() if gm is not None else None, y.data_ptr(),
        tel.data_ptr() if collect_stats else None, hbuf.data_ptr(),
        part.data_ptr(), ws.data_ptr(), b, d, k, cap, g, act_kind,
        float(fatrelu_threshold), grid, dc, n_slices, rps, smem, stream)
    build.check("fused_sparse_mlp", rc)
    if collect_stats:
        return y, tel
    return y
