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

Three share the CUDA-core kernel template of ``csrc/fused_sparse_mlp.cuh``;
each source instantiates its own.  ``fused_sparse_mlp_chunk`` runs the
tensor-core kernel of ``csrc/fused_sparse_mlp_chunk_tc.cuh``, launched with
its own scratch from ``plan`` (tile sizes, the split of d, the slices, the
grid and the shared memory), kept on the host so that the CPU tests reach
it.  Callers go through ``kernels.ops``, which picks the plain version for
CPU tensors and counts launches."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

# columns of the telemetry output, in order (per-token int32 row counts)
TELEMETRY_COLS = ("actual", "false_neg", "realized")

MAX_BATCH = 16          # rows a decode launch takes; the chunk kernels
                        # take any number
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


# ------------------------------------------- the tensor-core chunk kernel --
# csrc/fused_sparse_mlp_chunk_tc.cuh: kThreads, kStages, kRows, kKC, kCols,
# kKR, kSliceUnit, kMaxNT, kMaxSplits, kMinSliceRows, kTracePoints
THREADS, STAGES = 128, 4
ROWS, KC = 64, 32           # gate/up: weight rows per item, d per stage
COLS, KR = 128, 32          # down: d columns per item, rows per stage
SLICE_UNIT = 8              # down's slices start on multiples of 8 rows
MAX_NT, MAX_SPLITS, MIN_SLICE_ROWS = 8, 16, 64
MAX_BLOCKS_PER_SM = 2
SMEM_LIMIT = 232448         # shared memory a block can use on an H100
INT32_MAX = 2 ** 31 - 1
TRACE_POINTS = 8            # see phase_times


class Plan(NamedTuple):
    nt: int              # 8-token MMA tiles per token tile
    token_tile: int      # tokens of a token tile: 8 * nt
    s_pad: int           # S rounded up to whole token tiles
    k_chunks: int        # 32-column chunks of d
    col_tiles: int       # 128-column tiles of d (down)
    grid: int            # blocks, all resident (cooperative launch)
    max_splits: int      # cap on the split of d (gate/up)
    smem_bytes: int      # dynamic shared memory per block
    gu_floats: int       # split partials of g, then of u
    h_stride: int        # hT's row: C*G rounded up to 8
    h_floats: int        # hT: s_pad x h_stride
    part_floats: int     # slice partials of y: slices x S x d


def token_tiles(s: int) -> int:
    """nt: 8-token MMA tiles in a token tile, the power of two that covers
    S, at most 8 (a longer chunk walks several token tiles)."""
    nt = 1
    while nt < MAX_NT and 8 * nt < s:
        nt *= 2
    return nt


def stage_bytes(nt: int, x_elem: int) -> int:
    """One stage of the ring: gate/up's Wg, Wu (64 x 32 floats) and x
    (8*nt rows of 32 values) tiles, swizzled, or down's Wd (32 rows of 128
    floats, padded to 132: bulk copies fill it row by row) and hT (64
    tokens x 32 floats, swizzled) tiles, whichever is larger."""
    return max(2 * ROWS * KC * 4 + 8 * nt * KC * x_elem,
               KR * (COLS + 4) * 4 + 8 * MAX_NT * KR * 4)


def splits(grid: int, row_tiles: int, max_splits: int) -> int:
    """The kernel's split of d for ``row_tiles`` live 64-row tiles: as many
    as the grid has blocks for, at most ``max_splits``."""
    s = grid // row_tiles if row_tiles > 0 else 1
    return max(1, min(s, max_splits))


def slices(grid: int, col_tiles: int, nrows: int) -> int:
    """The kernel's slices of ``nrows`` selected rows for down: as many as
    the grid has blocks for beside the column tiles, each of at least 64
    rows (0 when no row is selected)."""
    if nrows <= 0:
        return 0
    return max(1, min(grid // col_tiles, -(-nrows // MIN_SLICE_ROWS)))


def split_chunks(ks: int, k_chunks: int, n_splits: int) -> range:
    """The 32-column chunks of d that gate/up's split ``ks`` sums, in its
    order: ks, ks + n_splits, ...  (the splits of a row tile read
    neighbouring pieces of the same rows at the same time)."""
    return range(ks, k_chunks, n_splits)


def slice_range(sl: int, nrows: int, n_slices: int) -> tuple[int, int]:
    """The selected rows of down's slice ``sl``: near-equal parts of the
    8-row units, cut at nrows."""
    units = -(-nrows // SLICE_UNIT)
    lo, hi = sl * units // n_slices, (sl + 1) * units // n_slices
    return min(nrows, lo * SLICE_UNIT), min(nrows, hi * SLICE_UNIT)


def plan(s: int, d: int, cap_rows: int, x_elem: int, sms: int,
         occupancy) -> Plan:
    """The launch for a chunk of ``s`` rows of width ``d`` over at most
    ``cap_rows`` (= C*G) selected rows, ``x_elem``-byte x (4 float32, 2
    bf16), on a card of ``sms`` SMs; ``occupancy(nt, smem)`` says how many
    blocks one SM holds at once.  The grid is resident: at most 2 blocks a
    SM, as many as the card holds.  The split of d is capped at 16, at the
    32-column chunks of d, and so that the split partials stay within a
    quarter of the weight bytes an item reads.  Raises ValueError on a
    shape the kernel does not take and RuntimeError when the card cannot
    hold one block."""
    if s < 1 or d < 4 or d % 4 or cap_rows < 1 or x_elem not in (2, 4):
        raise ValueError(
            f"fused_sparse_mlp_chunk: bad shape S={s} d={d} C*G={cap_rows} "
            f"x bytes={x_elem} (d must be a positive multiple of 4)")
    nt = token_tiles(s)
    tn = 8 * nt
    s_pad = -(-s // tn) * tn
    k_chunks = -(-d // KC)
    col_tiles = -(-d // COLS)
    smem = STAGES * stage_bytes(nt, x_elem)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_sparse_mlp_chunk: {smem} bytes of shared "
                         f"memory exceed the limit of {SMEM_LIMIT}")
    per_sm = min(occupancy(nt, smem), MAX_BLOCKS_PER_SM)
    if per_sm < 1:
        raise RuntimeError(
            f"fused_sparse_mlp_chunk: a block of {THREADS} threads with "
            f"{smem} bytes of shared memory cannot be scheduled on this card")
    grid = per_sm * sms
    max_splits = max(1, min(MAX_SPLITS, k_chunks,
                            k_chunks * KC // (4 * s_pad)))
    row_tiles = -(-cap_rows // ROWS)
    items = max(rt * splits(grid, rt, max_splits)
                for rt in range(1, row_tiles + 1))
    gu = 2 * items * ROWS * s_pad
    h_stride = -(-cap_rows // SLICE_UNIT) * SLICE_UNIT
    h = s_pad * h_stride
    part = slices(grid, col_tiles, cap_rows) * s * d
    if max(gu, h, part, s_pad * d) > INT32_MAX:
        raise ValueError(
            f"fused_sparse_mlp_chunk: S={s} x d={d} over {cap_rows} rows "
            f"needs {max(gu, h, part)} floats of scratch, past the limit of "
            f"{INT32_MAX}")
    return Plan(nt, tn, s_pad, k_chunks, col_tiles, grid, max_splits, smem,
                gu, h_stride, h, part)


_CHUNK_PLANS: dict = {}


def _card_occupancy(device, code: int):
    """``plan``'s occupancy from the card's calculator for this kernel."""
    lib = build.load("fused_sparse_mlp_chunk")

    def occupancy(nt: int, smem: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.fused_sparse_mlp_chunk_occupancy(code, nt, smem,
                                                      ctypes.byref(out))
        build.check("fused_sparse_mlp_chunk", rc)
        return out.value
    return occupancy


def chunk_plan(x: torch.Tensor, cap_rows: int) -> Plan:
    """The plan ``fused_sparse_mlp_chunk`` launches x with (made once per
    shape, on the card's occupancy)."""
    s, d = x.shape
    code = _X_DTYPES[x.dtype]
    key = (x.device.index, code, s, d, cap_rows)
    pl = _CHUNK_PLANS.get(key)
    if pl is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        pl = _CHUNK_PLANS[key] = plan(s, d, cap_rows, x.element_size(), sms,
                                      _card_occupancy(x.device, code))
    return pl


def phase_times(trace: torch.Tensor) -> dict:
    """Where a launch's time went, from its phase trace (grid x 8 int64: per
    block the global ns at start, gate/up done, past barrier 1, combine
    done, past barrier 2, down done, past barrier 3 and end): each phase
    and barrier from the last block to reach its start to the last to
    reach its end, in ms."""
    t = trace.double().cpu()
    last = t.max(0).values
    ms = lambda v: float(v) / 1e6                          # noqa: E731
    names = ("gate_up", "barrier_1", "combine", "barrier_2", "down",
             "barrier_3", "slice_sum")
    out = {"launch_skew": ms(last[0] - t[:, 0].min())}
    out.update({n: ms(last[i + 1] - (last[i] if i else t[:, 0].min()))
                for i, n in enumerate(names)})
    out["total"] = ms(last[7] - t[:, 0].min())
    return out


def _launch_chunk(x, wg, wu, wd, sel_indices, sel_count, gm_tok, *,
                  group_size: int, activation: str, fatrelu_threshold: float,
                  collect_stats: bool, trace: torch.Tensor | None = None):
    name = "fused_sparse_mlp_chunk"
    s, d = x.shape
    k = wg.shape[0]
    g = group_size
    cap = sel_indices.shape[0]
    dev = x.device
    mats = [m for m in (wg, wu, wd) if m is not None]
    if not x.is_cuda or any(t.device != dev for t in mats) \
            or sel_indices.device != dev:
        raise ValueError(f"{name} launches on CUDA tensors of one device")
    if any(m.dtype != torch.float32 for m in mats):
        raise ValueError(f"{name} reads float32 weights")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"unsupported x dtype {x.dtype}")
    if any(m.shape != (k, d) for m in mats) or k % g or d % 4 or cap < 1 \
            or s < 1:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w=({k}, {d}) "
                         f"C={cap} G={g} for {name}")
    if collect_stats and (gm_tok is None or gm_tok.shape != (s, k // g)):
        raise ValueError("collect_stats needs per-token group margins "
                         "(B, k/G)")
    act_kind = 1 if (activation == "fatrelu" or fatrelu_threshold > 0.0) \
        else 0
    if act_kind == 0 and activation != "relu":
        raise ValueError(f"activation {activation!r} is not sparsifiable")
    x = x.contiguous()
    if x.data_ptr() % 16:       # 16-byte copies of x's rows
        x = x.clone()
    wg, wu, wd = (t.contiguous() if t is not None else None
                  for t in (wg, wu, wd))
    if any(m.data_ptr() % 16 for m in (wg, wu, wd) if m is not None):
        raise ValueError(f"{name} reads weights in 16-byte copies: their "
                         "storage must be 16-byte aligned")
    pl = chunk_plan(x, cap * g)
    if trace is not None and (trace.dtype != torch.int64
                              or trace.device != dev
                              or trace.numel() < pl.grid * TRACE_POINTS):
        raise ValueError(f"{name}: trace takes {pl.grid} x {TRACE_POINTS} "
                         "int64 on the launch's device")
    sel = sel_indices.to(torch.int32).contiguous()
    count = torch.as_tensor(sel_count, dtype=torch.int32,
                            device=dev).reshape(())
    y = torch.empty((s, d), dtype=torch.float32, device=dev)
    # zeroed: the grid barrier, the telemetry
    ws = torch.zeros((4 + 3 * s,), dtype=torch.int32, device=dev)
    tel = ws[4:].view(s, 3)
    scratch = torch.empty((pl.gu_floats + pl.h_floats + pl.part_floats,),
                          dtype=torch.float32, device=dev)
    gu = scratch[:pl.gu_floats]
    ht = scratch[pl.gu_floats:pl.gu_floats + pl.h_floats]
    part = scratch[pl.gu_floats + pl.h_floats:]
    gm = gm_tok.float().contiguous() if collect_stats else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = build.load(name)
    rc = lib.fused_sparse_mlp_chunk(
        x.data_ptr(), _X_DTYPES[x.dtype], ptr(wg), ptr(wu), ptr(wd),
        sel.data_ptr(), count.data_ptr(), ptr(gm), y.data_ptr(),
        tel.data_ptr() if collect_stats else None, gu.data_ptr(),
        ht.data_ptr(), part.data_ptr(), ws.data_ptr(), ptr(trace),
        pl.gu_floats // 2, s, d, k, cap, g, act_kind,
        float(fatrelu_threshold), pl.nt, pl.s_pad, pl.max_splits,
        pl.h_stride, pl.grid, pl.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
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
                           collect_stats: bool = False, trace=None):
    """:func:`fused_sparse_mlp` for any number of rows (a prefill chunk):
    one selection drives the whole chunk, on the tensor cores.  ``trace``
    (grid x 8 int64, see :func:`phase_times`) takes the launch's phase
    trace."""
    return _launch_chunk(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                         gm_tok, group_size=group_size,
                         activation=activation,
                         fatrelu_threshold=fatrelu_threshold,
                         collect_stats=collect_stats, trace=trace)


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
