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

The two decode kernels stream the selected rows, cut into equal ranges a
block, through a ring of 16-byte copies and run on the CUDA cores: the
float32 one launched from ``decode_plan`` (the batch width, the rounds of
d, the stages, the chain batch, the ring, the shared memory and the grid),
the int8 one, with the quant scales applied per slab, from
``decode_q_plan`` (also the gate/up layout of the quant width).
The two chunk kernels run the tensor-core kernel of
``csrc/fused_sparse_mlp_chunk_tc.cuh`` (float32 or int8 weights), launched
with their own scratch from ``plan`` (tile sizes, the split of d, the
slices, the grid and the shared memory).  The plans are kept on the host
so that the CPU tests reach them.  Callers go through ``kernels.ops``,
which picks the plain version for CPU tensors and counts launches."""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

# columns of the telemetry output, in order (per-token int32 row counts)
TELEMETRY_COLS = ("actual", "false_neg", "realized")

MAX_BATCH = 16          # rows a decode launch takes; the chunk kernels
                        # take any number
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _quant_layout(name: str, k: int, d: int, g: int, wu, wg_s, wu_s,
                  wd_s) -> int:
    """The quant group width qg of int8 scales wg_s/wu_s (k, d/qg) and
    wd_s (k/qg, d); raises unless qg divides d and k and G divides qg."""
    scales = [s for s in (wg_s, wu_s, wd_s) if s is not None]
    qg = d // wg_s.shape[1] if wg_s.ndim == 2 and wg_s.shape[1] else 0
    if qg < 1 or (wu is None) != (wu_s is None) or qg * wg_s.shape[1] != d \
            or k % qg or qg % g \
            or any(s.shape != (k, d // qg) for s in (wg_s, wu_s)
                   if s is not None) or wd_s.shape != (k // qg, d):
        raise ValueError(f"bad quant layout for {name}: qg={qg} "
                         f"scales {[tuple(s.shape) for s in scales]}")
    return qg


# ---------------------------------------------- the float32 decode kernel --
# csrc/fused_sparse_mlp.cu: kThreads, kWarps, kXRegs, kTile, kRowsStep,
# kStages, kTracePoints.  The layout is decided here only: the kernel takes
# it from the plan, and its C entry checks that the buffers hold what the
# kernel writes.
D_THREADS, D_WARPS = 256, 8
D_XREGS = 64                      # x values a thread holds for a round
D_TILE, D_ROWS_STEP = 2 * D_THREADS, 16
D_STAGES = 8                      # the most stages a ring has
D_RING_BUDGET = 96 * 1024         # bytes of the ring, at least 2 stages
D_ROWS_BUDGET = 16 * 1024         # bytes of a chain batch's rows
D_TRACE_POINTS = 8                # see decode_phase_times


class DPlan(NamedTuple):
    nb: int              # tokens of the instantiation: 4, 8 or 16
    round_cols: int      # columns of d a gate/up stage: 4096, 2048, 1024
    rounds: int          # gate/up rounds of a row
    row_floats: int      # a chain row: 2 nb carried sums, 8 x 2 nb warp sums
    stage_bytes: int     # a gate/up stage: a round of Wg and of Wu
    down_stage_bytes: int
    chain_rows: int      # rows of a chain batch
    ring: int            # bytes of the ring
    smem_bytes: int      # the ring and a chain batch's rows
    grid: int            # blocks, all resident (cooperative launch)
    tiles: int           # down's D_TILE-column tiles of d
    h_floats: int        # h: C*G rows of nb floats
    part_floats: int     # down's runs: (grid + tiles) slots of nb x D_TILE


def decode_plan(b: int, d: int, cap_rows: int, group_size: int, sms: int,
                occupancy) -> DPlan:
    """The launch of the float32 decode kernel for b tokens of width d over
    at most ``cap_rows`` (= C*G) selected rows in groups of ``group_size``,
    on a card of ``sms`` SMs; ``occupancy(nb, smem)`` says how many blocks
    one SM holds at once.  A stage of gate/up holds one row's round of Wg
    and of Wu; one of down up to 16 rows of a 512-column tile of Wd and
    their h rows.  The ring holds as many of the larger stage as fit in
    D_RING_BUDGET bytes (2 to 8); a chain batch as many rows as one block
    takes at one block a SM, within D_ROWS_BUDGET bytes.  The grid is
    resident: at most 2 blocks a SM.  Raises ValueError on a shape the
    kernel does not take and RuntimeError when the card cannot hold one
    block."""
    name = "fused_sparse_mlp"
    g = group_size
    if not 1 <= b <= MAX_BATCH or d < 4 or d % 4 or cap_rows < 1 or g < 1 \
            or cap_rows % g:
        raise ValueError(
            f"{name}: bad shape B={b} d={d} C*G={cap_rows} G={g} (B <= "
            f"{MAX_BATCH}; d a positive multiple of 4; C*G a multiple of G)")
    nb = 4 if b <= 4 else 8 if b <= 8 else 16
    rc = D_THREADS * D_XREGS // nb    # x of a thread's columns: 64 values
    s1 = 2 * min(d, rc) * 4
    s2 = min(g, D_ROWS_STEP) * (D_TILE + nb) * 4
    big = max(s1, s2)
    ring = max(2, min(D_STAGES, D_RING_BUDGET // big)) * big
    row_floats = (1 + D_WARPS) * 2 * nb
    chain_rows = max(1, min(-(-cap_rows // sms),
                            D_ROWS_BUDGET // (row_floats * 4)))
    smem = ring + chain_rows * row_floats * 4
    per_sm = min(occupancy(nb, smem), MAX_BLOCKS_PER_SM)
    if per_sm < 1:
        raise RuntimeError(
            f"{name}: a block of {D_THREADS} threads with {smem} bytes of "
            "shared memory cannot be scheduled on this card")
    grid = per_sm * sms
    tiles = -(-d // D_TILE)
    return DPlan(nb, rc, -(-d // rc), row_floats, s1, s2, chain_rows, ring,
                 smem, grid, tiles, cap_rows * nb,
                 (grid + tiles) * nb * D_TILE)


_D_PLANS: dict = {}
_BARRIERS: dict = {}


def _barrier(dev, stream: int) -> torch.Tensor:
    """The float32 decode kernel's grid-barrier counter for launches on
    ``stream``: zeroed once here; every launch leaves it at zero."""
    bar = _BARRIERS.get((dev.index, stream))
    if bar is None:
        bar = _BARRIERS[(dev.index, stream)] = torch.zeros(
            (1,), dtype=torch.int32, device=dev)
    return bar


def decode_phase_times(trace: torch.Tensor) -> dict:
    """Where a decode launch's time went, float32 or int8, from its phase
    trace (grid x 8 int64: per block the global ns at start, first gate/up
    stage landed, gate/up stream done, gate/up done (chains included), past
    barrier 1, down done, past barrier 2 and end): each phase from the last
    block to reach its start to the last to reach its end, in ms.  Rows
    left at zero (a buffer longer than the grid) are not blocks."""
    t = trace.double().cpu()
    t = t[(t != 0).any(1)]
    last = t.max(0).values
    ms = lambda v: float(v) / 1e6                          # noqa: E731
    names = ("first_stage", "gate_up_stream", "chain", "barrier_1", "down",
             "barrier_2", "run_sum")
    out = {"launch_skew": ms(last[0] - t[:, 0].min())}
    out.update({n: ms(last[i + 1] - (last[i] if i else t[:, 0].min()))
                for i, n in enumerate(names)})
    out["total"] = ms(last[7] - t[:, 0].min())
    return out


def _launch(name: str, x, wg, wu, wd, sel_indices, sel_count, gm_tok, *,
            group_size: int, activation: str, fatrelu_threshold: float,
            collect_stats: bool, trace: torch.Tensor | None = None):
    """One launch of the float32 decode kernel."""
    b, d = x.shape
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
            or b < 1 or b > MAX_BATCH:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w=({k}, {d}) "
                         f"C={cap} G={g} for {name}")
    if collect_stats and (gm_tok is None or gm_tok.shape != (b, k // g)):
        raise ValueError("collect_stats needs per-token group margins "
                         "(B, k/G)")
    act_kind = _act_kind(activation, fatrelu_threshold)
    wg, wu, wd = (t.contiguous() if t is not None else None
                  for t in (wg, wu, wd))
    if any(t.data_ptr() % 16 for t in (wg, wu, wd) if t is not None):
        raise ValueError(f"{name} reads weights in 16-byte copies: their "
                         "storage must be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:       # 16-byte loads of x's rows
        x = x.clone()
    code = _X_DTYPES[x.dtype]
    key = (dev.index, code, b, d, cap * g, g)
    pl = _D_PLANS.get(key)
    if pl is None:
        lib = build.load(name)

        def occupancy(nb: int, smem: int) -> int:
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                rc = lib.fused_sparse_mlp_occupancy(code, nb, smem,
                                                    ctypes.byref(out))
            build.check(name, rc)
            return out.value
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pl = _D_PLANS[key] = decode_plan(b, d, cap * g, g, sms, occupancy)
    if trace is not None and (trace.dtype != torch.int64
                              or trace.device != dev
                              or trace.numel() < pl.grid * D_TRACE_POINTS):
        raise ValueError(f"{name}: trace takes {pl.grid} x "
                         f"{D_TRACE_POINTS} int64 on the launch's device")
    sel = sel_indices.to(torch.int32).contiguous()
    count = torch.as_tensor(sel_count, dtype=torch.int32,
                            device=dev).reshape(())
    y = torch.empty((b, d), dtype=torch.float32, device=dev)
    tel = tel_part = gm = None
    if collect_stats:
        tel = torch.empty((b, 3), dtype=torch.int32, device=dev)
        tel_part = torch.empty((pl.grid, 3 * MAX_BATCH), dtype=torch.int32,
                               device=dev)
        gm = gm_tok.float().contiguous()
    scratch = torch.empty((pl.h_floats + pl.part_floats,),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = build.load(name).fused_sparse_mlp(
        x.data_ptr(), code, ptr(wg), ptr(wu), ptr(wd), sel.data_ptr(),
        count.data_ptr(), ptr(gm), y.data_ptr(), ptr(tel), ptr(tel_part),
        scratch.data_ptr(), scratch[pl.h_floats:].data_ptr(),
        _barrier(dev, stream).data_ptr(), ptr(trace), b, d, k, cap, g,
        act_kind, float(fatrelu_threshold), pl.nb, pl.row_floats,
        pl.stage_bytes, pl.down_stage_bytes, pl.chain_rows, pl.ring, pl.grid,
        pl.smem_bytes, stream)
    build.check(name, rc)
    if collect_stats:
        return y, tel
    return y


def _act_kind(activation: str, fatrelu_threshold: float) -> int:
    """The kernels' activation code: 0 relu, 1 fatrelu(threshold)."""
    if activation == "fatrelu" or fatrelu_threshold > 0.0:
        return 1
    if activation != "relu":
        raise ValueError(f"activation {activation!r} is not sparsifiable")
    return 0


# ------------------------------------------------ the int8 decode kernel --
# csrc/fused_sparse_mlp_q.cu: kThreads, kPiece, kNBp, kState, kTile,
# kRowsStep, kStages, kTracePoints; the gate/up modes kSlab16, kSlab1.  The
# layout is decided here only: the kernel takes it from the plan, and its C
# entry checks that the buffers hold what the kernel writes.
Q_THREADS, Q_PIECE, Q_NBP = 256, 16, 4
Q_ROUND_COLS = Q_PIECE * Q_THREADS  # columns of d a gate/up stage
Q_STATE = 4 * Q_NBP                 # a chain row's carried sums
Q_TILE, Q_ROWS_STEP = 2 * Q_THREADS, 16
Q_STAGES = 6                        # stages of the ring a launch uses
Q_SLAB16, Q_SLAB1 = 0, 1
Q_ROWS_BUDGET = 48 * 1024           # bytes of a chain batch's rows
Q_TRACE_POINTS = 8                  # see decode_phase_times


class QPlan(NamedTuple):
    nb: int              # tokens of the instantiation: 4, 8 or 16
    passes: int          # gate/up passes of Q_NBP tokens
    mode: int            # Q_SLAB16 or Q_SLAB1
    lanes: int           # lanes whose partials one item sums
    items: int           # items (slab partials) of a row in one round
    slab_scales: int     # Q_SLAB16: gate (and up) scales a stage carries
    row_floats: int      # a chain row: Q_STATE, items, Q_SLAB16's scales
    stage_bytes: int     # a gate/up stage
    down_stage_bytes: int
    chain_rows: int      # rows of a chain batch
    stages: int          # stages of the ring
    ring: int            # bytes of the ring
    smem_bytes: int      # the ring and a chain batch's rows
    grid: int            # blocks, all resident (cooperative launch)
    tiles: int           # down's Q_TILE-column tiles of d
    h_floats: int        # h: C*G rows of nb floats
    part_floats: int     # down's runs: (grid + tiles) slots of nb x Q_TILE


def q_mode(qg: int) -> int:
    """How gate/up meets the quant slabs of width qg: 16-column pieces
    inside a slab (qg a multiple of 16), else one column a piece."""
    return Q_SLAB16 if qg % Q_PIECE == 0 else Q_SLAB1


def q_lanes(qg: int) -> int:
    """Lanes whose partials one item sums: the largest power of two <= 32
    that divides the pieces of a slab."""
    w = qg // Q_PIECE if q_mode(qg) == Q_SLAB16 else qg
    lanes = 1
    while lanes < 32 and w % (2 * lanes) == 0:
        lanes *= 2
    return lanes


def q_items(d: int, qg: int) -> int:
    """Items (lane-group partials) a row holds in one round of up to 4096
    columns (every round but the last has exactly this many)."""
    width = Q_PIECE if q_mode(qg) == Q_SLAB16 else 1
    return -(-min(d, Q_ROUND_COLS) // (width * q_lanes(qg)))


def q_round_slabs(d: int, qg: int) -> int:
    """The gate and up scales a Q_SLAB16 stage brings of its row: the slabs
    a round of 4096 columns touches (all of them when d fits one round)."""
    if q_mode(qg) != Q_SLAB16:
        return 0
    return d // qg if d <= Q_ROUND_COLS else -(-Q_ROUND_COLS // qg) + 1


def q_row_floats(d: int, qg: int) -> int:
    """Floats of a row in a chain batch: the sums carried from round to
    round (Q_STATE), the round's items (gate, then up, Q_NBP tokens each),
    then for Q_SLAB16 the round's gate and up scales; a multiple of 4."""
    f = Q_STATE + q_items(d, qg) * 2 * Q_NBP + 2 * q_round_slabs(d, qg)
    return -(-f // 4) * 4


def q_stage_bytes(d: int, qg: int) -> int:
    """A gate/up stage: a row of Wg and of Wu, up to 4096 columns, each
    padded to 16 bytes, then the round's gate and up scales."""
    return 2 * (-(-min(d, Q_ROUND_COLS) // 16) * 16) \
        + -(-2 * q_round_slabs(d, qg) * 4 // 16) * 16


def q_down_stage_bytes(group_size: int, nb: int) -> int:
    """A down stage: up to 16 rows of 512 bytes of Wd, their h rows of nb
    floats, a scale row piece of 512 floats."""
    rs = min(group_size, Q_ROWS_STEP)
    return rs * Q_TILE + rs * nb * 4 + Q_TILE * 4


def q_range(n: int, grid: int, blk: int) -> tuple[int, int]:
    """Block blk's share [lo, hi) of n rows (gate/up) or units (down):
    equal contiguous ranges, in order."""
    return n * blk // grid, n * (blk + 1) // grid


def q_owner(u: int, n: int, grid: int) -> int:
    """The block whose share of n holds u (the kernel's phase 3)."""
    return ((u + 1) * grid - 1) // n


def decode_q_plan(b: int, d: int, cap_rows: int, group_size: int, qg: int,
                  sms: int, occupancy) -> QPlan:
    """The launch of the int8 decode kernel for b tokens of width d over at
    most ``cap_rows`` (= C*G) selected rows in groups of ``group_size``
    with quant width qg, on a card of ``sms`` SMs; ``occupancy(nb, mode,
    smem)`` says how many blocks one SM holds at once.  Gate/up runs on
    the CUDA cores in passes of 4 tokens and rounds of up to 4096 columns;
    a chain batch holds as many rows as one block takes at one block a SM,
    within Q_ROWS_BUDGET bytes (at least one row: every d fits, since a
    row holds one round).  The ring has Q_STAGES stages.  The grid is
    resident: at most 2 blocks a SM.  Raises ValueError on a shape the
    kernel does not take and RuntimeError when the card cannot hold one
    block."""
    name = "fused_sparse_mlp_q"
    g = group_size
    if not 1 <= b <= MAX_BATCH or d < 4 or d % 4 or cap_rows < 1 or g < 1 \
            or cap_rows % g or qg < 1 or d % qg or qg % g:
        raise ValueError(
            f"{name}: bad shape B={b} d={d} C*G={cap_rows} G={g} qg={qg} "
            f"(B <= {MAX_BATCH}; d a positive multiple of 4 and of qg; qg "
            "a multiple of G)")
    nb = 4 if b <= 4 else 8 if b <= 8 else 16
    mode = q_mode(qg)
    row_floats = q_row_floats(d, qg)
    s1, s2 = q_stage_bytes(d, qg), q_down_stage_bytes(g, nb)
    ring = Q_STAGES * max(s1, s2)
    chain_rows = max(1, min(-(-cap_rows // sms),
                            Q_ROWS_BUDGET // (row_floats * 4)))
    smem = ring + chain_rows * row_floats * 4
    per_sm = min(occupancy(nb, mode, smem), MAX_BLOCKS_PER_SM)
    if per_sm < 1:
        raise RuntimeError(
            f"{name}: a block of {Q_THREADS} threads with {smem} bytes of "
            "shared memory cannot be scheduled on this card")
    grid = per_sm * sms
    tiles = -(-d // Q_TILE)
    return QPlan(nb, -(-b // Q_NBP), mode, q_lanes(qg), q_items(d, qg),
                 q_round_slabs(d, qg), row_floats, s1, s2, chain_rows,
                 Q_STAGES, ring, smem, grid, tiles, cap_rows * nb,
                 (grid + tiles) * nb * Q_TILE)


_Q_PLANS: dict = {}


# the int8 decode kernel traces the same 8 points
q_phase_times = decode_phase_times


def _launch_q(x, mats, scales, sel_indices, sel_count, gm_tok, *,
              group_size: int, activation: str, fatrelu_threshold: float,
              collect_stats: bool, trace: torch.Tensor | None = None):
    """One launch of the int8 decode kernel: ``mats`` (wg, wu, wd) int8,
    ``scales`` (wg_s, wu_s, wd_s) float32 (wu and wu_s None: ungated)."""
    name = "fused_sparse_mlp_q"
    wg, wu, wd = mats
    wg_s, wu_s, wd_s = scales
    b, d = x.shape
    k = wg.shape[0]
    g = group_size
    cap = sel_indices.shape[0]
    dev = x.device
    live = [t for t in (wg, wu, wd, wg_s, wu_s, wd_s) if t is not None]
    if not x.is_cuda or any(t.device != dev for t in live) \
            or sel_indices.device != dev:
        raise ValueError(f"{name} launches on CUDA tensors of one device")
    if any(m.dtype != torch.int8 for m in (wg, wu, wd) if m is not None) \
            or any(s.dtype != torch.float32
                   for s in (wg_s, wu_s, wd_s) if s is not None):
        raise ValueError(f"{name} reads int8 weights and float32 scales")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"unsupported x dtype {x.dtype}")
    if any(m.shape != (k, d) for m in (wg, wu, wd) if m is not None) \
            or k % g or d % 4 or cap < 1 or b < 1 or b > MAX_BATCH:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w=({k}, {d}) "
                         f"C={cap} G={g} for {name}")
    qg = _quant_layout(name, k, d, g, wu, wg_s, wu_s, wd_s)
    if collect_stats and (gm_tok is None or gm_tok.shape != (b, k // g)):
        raise ValueError("collect_stats needs per-token group margins "
                         "(B, k/G)")
    act_kind = _act_kind(activation, fatrelu_threshold)
    wg, wu, wd, wg_s, wu_s, wd_s = (
        t.contiguous() if t is not None else None
        for t in (wg, wu, wd, wg_s, wu_s, wd_s))
    if any(t.data_ptr() % 16 for t in (wg, wu, wd, wg_s, wu_s, wd_s)
           if t is not None):
        raise ValueError(f"{name} reads weights and scales in 16-byte "
                         "copies: their storage must be 16-byte aligned")
    x = x.contiguous()
    if x.data_ptr() % 16:       # 16-byte copies of x's rows
        x = x.clone()
    code = _X_DTYPES[x.dtype]
    key = (dev.index, code, b, d, cap * g, g, qg)
    pl = _Q_PLANS.get(key)
    if pl is None:
        lib = build.load(name)

        def occupancy(nb: int, mode: int, smem: int) -> int:
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                rc = lib.fused_sparse_mlp_q_occupancy(code, nb, mode, smem,
                                                      ctypes.byref(out))
            build.check(name, rc)
            return out.value
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pl = _Q_PLANS[key] = decode_q_plan(b, d, cap * g, g, qg, sms,
                                           occupancy)
    if trace is not None and (trace.dtype != torch.int64
                              or trace.device != dev
                              or trace.numel() < pl.grid * Q_TRACE_POINTS):
        raise ValueError(f"{name}: trace takes {pl.grid} x "
                         f"{Q_TRACE_POINTS} int64 on the launch's device")
    sel = sel_indices.to(torch.int32).contiguous()
    count = torch.as_tensor(sel_count, dtype=torch.int32,
                            device=dev).reshape(())
    y = torch.empty((b, d), dtype=torch.float32, device=dev)
    ws = torch.zeros((1 + 3 * b,), dtype=torch.int32, device=dev)  # bar+tel
    tel = ws[1:].view(b, 3)
    scratch = torch.empty((pl.h_floats + pl.part_floats,),
                          dtype=torch.float32, device=dev)
    gm = gm_tok.float().contiguous() if collect_stats else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = build.load(name).fused_sparse_mlp_q(
        x.data_ptr(), code, ptr(wg), ptr(wg_s), ptr(wu), ptr(wu_s), ptr(wd),
        ptr(wd_s), sel.data_ptr(), count.data_ptr(), ptr(gm), y.data_ptr(),
        tel.data_ptr() if collect_stats else None, scratch.data_ptr(),
        scratch[pl.h_floats:].data_ptr(), ws.data_ptr(), ptr(trace), b, d, k,
        cap, g, qg, act_kind, float(fatrelu_threshold), pl.nb, pl.mode,
        pl.lanes, pl.items, pl.slab_scales, pl.row_floats, pl.stage_bytes,
        pl.down_stage_bytes, pl.chain_rows, pl.stages, pl.ring, pl.grid,
        pl.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    build.check(name, rc)
    if collect_stats:
        return y, tel
    return y


# ------------------------------------------- the tensor-core chunk kernel --
# csrc/fused_sparse_mlp_chunk_tc.cuh: kThreads, kStages, kRows, kKC, kCols,
# kKR, kSliceUnit, kMaxNT, kMaxSplits, kMinSliceRows, kTracePoints; for
# int8 weights kKCQ, kStagesQ, kDStrideQ, kSlotBytes
THREADS, STAGES = 128, 4
ROWS, KC = 64, 32           # gate/up: weight rows per item, d per stage
COLS, KR = 128, 32          # down: d columns per item, rows per stage
SLICE_UNIT = 8              # down's slices start on multiples of 8 rows
MAX_NT, MAX_SPLITS, MIN_SLICE_ROWS = 8, 16, 64
KC_Q, STAGES_Q = 128, 3     # int8: d per gate/up stage, ring stages
DSTRIDE_Q = COLS + 16       # int8: bytes a Wd-tile row (padded)
SLOT_BYTES = COLS * 4       # int8: one scale row of a down tile
MAX_BLOCKS_PER_SM = 2
SMEM_LIMIT = 232448         # shared memory a block can use on an H100
INT32_MAX = 2 ** 31 - 1
TRACE_POINTS = 8            # see phase_times


class Plan(NamedTuple):
    nt: int              # 8-token MMA tiles per token tile
    token_tile: int      # tokens of a token tile: 8 * nt
    s_pad: int           # S rounded up to whole token tiles
    k_chunks: int        # chunks of d (chunk_cols wide)
    col_tiles: int       # 128-column tiles of d (down)
    grid: int            # blocks, all resident (cooperative launch)
    max_splits: int      # cap on the split of d (gate/up)
    smem_bytes: int      # dynamic shared memory per block
    gu_floats: int       # split partials of g, then of u
    h_stride: int        # hT's row: C*G rounded up to 8
    h_floats: int        # hT: s_pad x h_stride (int8: (big, small) pairs)
    part_floats: int     # slice partials of y: slices x S x d
    chunk_cols: int      # columns of d a gate/up stage: 32, int8 128
    slice_unit: int      # down's slices start on multiples of it


def token_tiles(s: int) -> int:
    """nt: 8-token MMA tiles in a token tile, the power of two that covers
    S, at most 8 (a longer chunk walks several token tiles)."""
    nt = 1
    while nt < MAX_NT and 8 * nt < s:
        nt *= 2
    return nt


def stage_bytes(nt: int, x_elem: int, w_elem: int = 4) -> int:
    """One stage of the ring.  float32 weights: gate/up's Wg, Wu (64 x 32
    floats) and x (8*nt rows of 32 values) tiles, swizzled, or down's Wd
    (32 rows of 128 floats, padded to 132: bulk copies fill it row by row)
    and hT (64 tokens x 32 floats, swizzled) tiles, whichever is larger.
    int8 weights: gate/up's Wg, Wu (64 x 128 bytes), x (8*nt rows of 128
    values) and the 64 rows' gate and up scales of the stage's first slab,
    or down's Wd (32 rows of 128 bytes, padded to 144), hT (8*nt
    tokens x 32 (big, small) pairs) and 4 scale rows of 128 floats (down
    cuts the ring into more stages of its own size)."""
    if w_elem == 1:
        return max(2 * ROWS * KC_Q + 8 * nt * KC_Q * x_elem + 2 * ROWS * 4,
                   KR * DSTRIDE_Q + 8 * nt * KR * 8 + KR // 8 * SLOT_BYTES)
    return max(2 * ROWS * KC * 4 + 8 * nt * KC * x_elem,
               KR * (COLS + 4) * 4 + 8 * MAX_NT * KR * 4)


def sel_bytes(n_groups: int) -> int:
    """int8: the selection's group ids, in shared memory after the ring."""
    return -(-n_groups * 4 // 16) * 16


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
    """The chunks of d that gate/up's split ``ks`` sums, in its order: ks,
    ks + n_splits, ...  (the splits of a row tile read neighbouring pieces
    of the same rows at the same time)."""
    return range(ks, k_chunks, n_splits)


def slice_range(sl: int, nrows: int, n_slices: int,
                unit: int = SLICE_UNIT) -> tuple[int, int]:
    """The selected rows of down's slice ``sl``: near-equal parts of the
    ``unit``-row units, cut at nrows."""
    units = -(-nrows // unit)
    lo, hi = sl * units // n_slices, (sl + 1) * units // n_slices
    return min(nrows, lo * unit), min(nrows, hi * unit)


def plan(s: int, d: int, cap_rows: int, x_elem: int, sms: int,
         occupancy, w_elem: int = 4, group_size: int = 8) -> Plan:
    """The launch for a chunk of ``s`` rows of width ``d`` over at most
    ``cap_rows`` (= C*G) selected rows, ``x_elem``-byte x (4 float32, 2
    bf16) and ``w_elem``-byte weights (4 float32, 1 int8), on a card of
    ``sms`` SMs; ``occupancy(nt, smem)`` says how many blocks one SM holds
    at once.  The grid is resident: at most 2 blocks a SM, as many as the
    card holds.  The split of d is capped at 16, at the chunks of d, and so
    that the split partials stay within a quarter of the float32 weight
    bytes an item reads (within the int8 ones).  int8 down slices start on
    multiples of lcm(8, G), so that no selection group straddles two.
    Raises ValueError on a shape the kernel does not take and RuntimeError
    when the card cannot hold one block."""
    name = "fused_sparse_mlp_chunk" + ("_q" if w_elem == 1 else "")
    if s < 1 or d < 4 or d % 4 or cap_rows < 1 or x_elem not in (2, 4) \
            or w_elem not in (1, 4) or group_size < 1:
        raise ValueError(
            f"{name}: bad shape S={s} d={d} C*G={cap_rows} x bytes={x_elem} "
            f"weight bytes={w_elem} G={group_size} (d must be a positive "
            "multiple of 4)")
    kc, stages = (KC_Q, STAGES_Q) if w_elem == 1 else (KC, STAGES)
    nt = token_tiles(s)
    tn = 8 * nt
    s_pad = -(-s // tn) * tn
    k_chunks = -(-d // kc)
    col_tiles = -(-d // COLS)
    smem = stages * stage_bytes(nt, x_elem, w_elem)
    if w_elem == 1:
        smem += sel_bytes(-(-cap_rows // group_size))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory exceed the "
                         f"limit of {SMEM_LIMIT}")
    per_sm = min(occupancy(nt, smem), MAX_BLOCKS_PER_SM)
    if per_sm < 1:
        raise RuntimeError(
            f"{name}: a block of {THREADS} threads with {smem} bytes of "
            "shared memory cannot be scheduled on this card")
    grid = per_sm * sms
    max_splits = max(1, min(MAX_SPLITS, k_chunks,
                            k_chunks * kc // (4 * s_pad)))
    row_tiles = -(-cap_rows // ROWS)
    items = max(rt * splits(grid, rt, max_splits)
                for rt in range(1, row_tiles + 1))
    gu = 2 * items * ROWS * s_pad
    h_stride = -(-cap_rows // SLICE_UNIT) * SLICE_UNIT
    h = s_pad * h_stride * (2 if w_elem == 1 else 1)
    part = slices(grid, col_tiles, cap_rows) * s * d
    if max(gu, h, part, s_pad * d) > INT32_MAX:
        raise ValueError(
            f"{name}: S={s} x d={d} over {cap_rows} rows needs "
            f"{max(gu, h, part)} floats of scratch, past the limit of "
            f"{INT32_MAX}")
    unit = SLICE_UNIT if w_elem == 4 else math.lcm(SLICE_UNIT, group_size)
    return Plan(nt, tn, s_pad, k_chunks, col_tiles, grid, max_splits, smem,
                gu, h_stride, h, part, kc, unit)


_CHUNK_PLANS: dict = {}


def _card_occupancy(device, code: int, name: str):
    """``plan``'s occupancy from the card's calculator for kernel
    ``name``."""
    lib = build.load(name)

    def occupancy(nt: int, smem: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(lib, f"{name}_occupancy")(code, nt, smem,
                                                   ctypes.byref(out))
        build.check(name, rc)
        return out.value
    return occupancy


def chunk_plan(x: torch.Tensor, cap_rows: int, w_elem: int = 4,
               group_size: int = 8) -> Plan:
    """The plan a chunk kernel launches x with over ``w_elem``-byte weights
    (made once per shape, on the card's occupancy)."""
    s, d = x.shape
    code = _X_DTYPES[x.dtype]
    name = "fused_sparse_mlp_chunk" + ("_q" if w_elem == 1 else "")
    unit = group_size if w_elem == 1 else 0
    key = (x.device.index, code, s, d, cap_rows, w_elem, unit)
    pl = _CHUNK_PLANS.get(key)
    if pl is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        pl = _CHUNK_PLANS[key] = plan(s, d, cap_rows, x.element_size(), sms,
                                      _card_occupancy(x.device, code, name),
                                      w_elem, group_size)
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


def _launch_chunk(name: str, x, mats, scales, sel_indices, sel_count,
                  gm_tok, *, group_size: int, activation: str,
                  fatrelu_threshold: float, collect_stats: bool,
                  trace: torch.Tensor | None = None):
    """One launch of a tensor-core chunk kernel: ``mats`` (wg, wu, wd) and,
    for int8 weights, ``scales`` (wg_s, wu_s, wd_s), else None."""
    wg, wu, wd = mats
    quant = scales is not None
    wg_s, wu_s, wd_s = scales if quant else (None, None, None)
    s, d = x.shape
    k = wg.shape[0]
    g = group_size
    cap = sel_indices.shape[0]
    dev = x.device
    live = [t for t in (wg, wu, wd, wg_s, wu_s, wd_s) if t is not None]
    if not x.is_cuda or any(t.device != dev for t in live) \
            or sel_indices.device != dev:
        raise ValueError(f"{name} launches on CUDA tensors of one device")
    wdt = torch.int8 if quant else torch.float32
    if any(m.dtype != wdt for m in (wg, wu, wd) if m is not None) \
            or (quant and any(t.dtype != torch.float32
                              for t in (wg_s, wu_s, wd_s) if t is not None)):
        raise ValueError(f"{name} reads {wdt} weights"
                         + (" and float32 scales" if quant else ""))
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"unsupported x dtype {x.dtype}")
    if any(m.shape != (k, d) for m in (wg, wu, wd) if m is not None) \
            or k % g or d % 4 or cap < 1 or s < 1:
        raise ValueError(f"bad shapes x={tuple(x.shape)} w=({k}, {d}) "
                         f"C={cap} G={g} for {name}")
    qg = _quant_layout(name, k, d, g, wu, wg_s, wu_s, wd_s) if quant else 0
    if collect_stats and (gm_tok is None or gm_tok.shape != (s, k // g)):
        raise ValueError("collect_stats needs per-token group margins "
                         "(B, k/G)")
    act_kind = _act_kind(activation, fatrelu_threshold)
    x = x.contiguous()
    if x.data_ptr() % 16:       # 16-byte copies of x's rows
        x = x.clone()
    wg, wu, wd, wg_s, wu_s, wd_s = (
        t.contiguous() if t is not None else None
        for t in (wg, wu, wd, wg_s, wu_s, wd_s))
    if any(t.data_ptr() % 16 for t in (wg, wu, wd, wd_s) if t is not None):
        raise ValueError(f"{name} reads weights in 16-byte copies: their "
                         "storage must be 16-byte aligned")
    pl = chunk_plan(x, cap * g, 1 if quant else 4, g)
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
    head = (x.data_ptr(), _X_DTYPES[x.dtype])
    if quant:
        weights = (ptr(wg), ptr(wg_s), ptr(wu), ptr(wu_s), ptr(wd),
                   ptr(wd_s))
    else:
        weights = (ptr(wg), ptr(wu), ptr(wd))
    shape = (s, d, k, cap, g) + ((qg,) if quant else ())
    tiles = (pl.nt, pl.s_pad, pl.max_splits, pl.h_stride) \
        + ((pl.slice_unit,) if quant else ())
    rc = getattr(lib, name)(
        *head, *weights, sel.data_ptr(), count.data_ptr(), ptr(gm),
        y.data_ptr(), tel.data_ptr() if collect_stats else None,
        gu.data_ptr(), ht.data_ptr(), part.data_ptr(), ws.data_ptr(),
        ptr(trace), pl.gu_floats // 2, *shape, act_kind,
        float(fatrelu_threshold), *tiles, pl.grid, pl.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(name, rc)
    if collect_stats:
        return y, tel
    return y


def fused_sparse_mlp(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                     gm_tok=None, *, group_size: int = 8,
                     activation: str = "relu", fatrelu_threshold: float = 0.0,
                     collect_stats: bool = False, trace=None):
    """One launch: x (B <= 16, d) float32/bfloat16; w*_t (k, d) float32
    neuron-major, 16-byte aligned (``wu_t`` None = ungated); sel_indices
    (C,) int32 group ids; sel_count () int32 on the device.  Returns y (B,
    d) float32, and with ``collect_stats`` (needs ``gm_tok`` (B, k/G)
    float32) also the (B, 3) int32 telemetry of ``TELEMETRY_COLS``.
    ``trace`` (grid x 8 int64, see :func:`decode_phase_times`) takes the
    launch's phase trace."""
    return _launch("fused_sparse_mlp", x, wg_t, wu_t, wd_t, sel_indices,
                   sel_count, gm_tok, group_size=group_size,
                   activation=activation,
                   fatrelu_threshold=fatrelu_threshold,
                   collect_stats=collect_stats, trace=trace)


def fused_sparse_mlp_chunk(x, wg_t, wu_t, wd_t, sel_indices, sel_count,
                           gm_tok=None, *, group_size: int = 8,
                           activation: str = "relu",
                           fatrelu_threshold: float = 0.0,
                           collect_stats: bool = False, trace=None):
    """:func:`fused_sparse_mlp` for any number of rows (a prefill chunk):
    one selection drives the whole chunk, on the tensor cores.  ``trace``
    (grid x 8 int64, see :func:`phase_times`) takes the launch's phase
    trace."""
    return _launch_chunk("fused_sparse_mlp_chunk", x, (wg_t, wu_t, wd_t),
                         None, sel_indices, sel_count, gm_tok,
                         group_size=group_size,
                         activation=activation,
                         fatrelu_threshold=fatrelu_threshold,
                         collect_stats=collect_stats, trace=trace)


def fused_sparse_mlp_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s, sel_indices,
                       sel_count, gm_tok=None, *, group_size: int = 8,
                       activation: str = "relu",
                       fatrelu_threshold: float = 0.0,
                       collect_stats: bool = False, trace=None):
    """:func:`fused_sparse_mlp` over int8 weights: w*_q (k, d) int8,
    ``wg_s``/``wu_s`` (k, d/qg) and ``wd_s`` (k/qg, d) float32 scales, all
    16-byte aligned.  ``trace`` (grid x 8 int64, see
    :func:`decode_phase_times`) takes the launch's phase trace."""
    return _launch_q(x, (wg_q, wu_q, wd_q), (wg_s, wu_s, wd_s), sel_indices,
                     sel_count, gm_tok, group_size=group_size,
                     activation=activation,
                     fatrelu_threshold=fatrelu_threshold,
                     collect_stats=collect_stats, trace=trace)


def fused_sparse_mlp_chunk_q(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                             sel_indices, sel_count, gm_tok=None, *,
                             group_size: int = 8, activation: str = "relu",
                             fatrelu_threshold: float = 0.0,
                             collect_stats: bool = False, trace=None):
    """:func:`fused_sparse_mlp_q` for any number of rows (a prefill chunk),
    on the tensor cores.  ``trace`` (grid x 8 int64, see
    :func:`phase_times`) takes the launch's phase trace."""
    return _launch_chunk("fused_sparse_mlp_chunk_q", x, (wg_q, wu_q, wd_q),
                         (wg_s, wu_s, wd_s), sel_indices, sel_count, gm_tok,
                         group_size=group_size, activation=activation,
                         fatrelu_threshold=fatrelu_threshold,
                         collect_stats=collect_stats, trace=trace)
