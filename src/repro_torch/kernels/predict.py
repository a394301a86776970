"""Launchers of the predictor CUDA kernels, the counterparts of the Pallas
kernels of ``repro/kernels/predict.py``:

* ``predict_group_margins`` (``csrc/predict_group_margins.cu``): a decode
  batch of at most ``MAX_BATCH`` tokens;
* ``predict_chunk_group_margins`` (``csrc/predict_chunk_group_margins.cu``):
  a prefill chunk of any number of rows, tiled over tokens;
* ``predict_counts`` (``csrc/predict_counts.cu``): the paper's Listing-1
  negative-product counts from pre-packed signs, any number of rows.

All three instantiate ``csrc/predict_margins.cuh``: the first two with x's
values and the margins epilogue, so every row's outputs are bitwise the
same from either, the third with x's packed words and the counts
epilogue.  :func:`margins_plan` is the only place their launch layout is
decided.  Callers go through ``kernels.ops``, which picks the plain version
for CPU tensors and counts launches."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import build

PACK = 32
MAX_BATCH = 16          # tokens a decode launch takes (SparseInferConfig
                        # .sparse_max_batch's default)
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
X_PACKED = 2            # x_dtype of packed sign words (the counts kernel)

# csrc/predict_margins.cuh's constants
CLUSTER = 8             # CTAs that share one packing of x of a large tile
SOLO_TOKENS = 8         # a tile of at most this many tokens: no cluster
TILE_TOKENS = 64        # tokens of a token tile at most
MMA_ROWS, MMA_TOKENS = 16, 8   # the b1 MMA's M and N
THREADS = 256
SMEM_LIMIT = 230400     # dynamic shared memory a block: 227 KB on sm_90
                        # less 2 KB kept for the kernel's static 1 KB


@dataclasses.dataclass(frozen=True)
class MarginsPlan:
    """The launch of the predictor kernels (``csrc/predict_margins.cuh``):
    a grid of ``ctas`` x ``token_tiles`` CTAs in clusters of ``cluster``;
    CTA i takes the units [i*n_units/ctas, (i+1)*n_units/ctas) of
    ``unit_rows`` gate rows and all tokens of its tile."""
    tile: int           # tokens of a token tile (the last may hold fewer)
    tile_pad: int       # tile rounded up to MMA_TOKENS
    token_tiles: int
    cluster: int        # CTAs that share one packing of x: 1 or CLUSTER
    unit_rows: int      # lcm(16, G): no group straddles two CTAs
    n_units: int
    ctas: int           # CTAs per token tile, a multiple of cluster
    rows_max: int       # rows of the largest CTA range
    xstride: int        # words a row of packed signs, x's and w's (16 mod 32)
    rstride: int        # ints per row of the products (8 mod 32)
    smem: int           # bytes of dynamic shared memory


def margins_smem(tile_pad: int, xstride: int, rows_max: int,
                 rstride: int, counts: bool = False) -> int:
    """Shared memory of one CTA: its gate-sign rows and the tile's x
    signs (both ``xstride`` words a row), the products, popc(w) per row,
    popc(x) and, for the margins epilogue, the kept-group counts per
    token."""
    return 4 * ((rows_max + tile_pad) * xstride + rows_max * rstride
                + rows_max + (1 if counts else 2) * tile_pad)


def margins_plan(s: int, w: int, k: int, group_size: int,
                 max_clusters, counts: bool = False) -> MarginsPlan:
    """The launch for ``s`` tokens of ``w`` sign words over ``k`` gate rows
    in groups of ``group_size``; with ``counts``, of the counts kernel
    (x packed, ``group_size`` 1).  ``max_clusters(cluster, smem)`` says how
    many clusters of ``cluster`` CTAs with ``smem`` bytes of shared memory
    the card runs at once; it is asked at SMEM_LIMIT, which no plan passes.
    Token tiles hold up to TILE_TOKENS tokens; a tile of more than
    SOLO_TOKENS is packed by a cluster of CLUSTER CTAs, a smaller one by
    each CTA alone, and packed x needs no cluster.  Each tile takes an
    equal share of the card's clusters, so all tiles run at once, or more
    where a CTA's rows and tokens would not fit in SMEM_LIMIT bytes (then
    they run in waves), but at most one CTA a unit; fewer tokens a tile
    where even that does not fit.  Raises ValueError on a shape the kernel
    does not take and RuntimeError when the card cannot run one cluster."""
    g = group_size
    if s < 1 or w < 1 or k < 1 or g < 1 or k % g or (counts and g != 1):
        raise ValueError(f"predictor: bad shape S={s} w={w} k={k} G={g} "
                         "(k a positive multiple of G; G=1 for counts)")
    unit = math.lcm(MMA_ROWS, g)
    n_units = -(-k // unit)
    xstride = -(-w // 16) * 16 | 16
    for cap in range(TILE_TOKENS, 0, -MMA_TOKENS):
        tiles = -(-s // cap)
        tile = -(-s // tiles)
        tile_pad = -(-tile // MMA_TOKENS) * MMA_TOKENS
        rstride = tile_pad + (40 - tile_pad % 32) % 32
        cluster = CLUSTER if tile > SOLO_TOKENS and not counts else 1
        fit = max_clusters(cluster, SMEM_LIMIT)
        if fit < 1:
            raise RuntimeError(
                f"predictor: a cluster of {cluster} CTAs of {THREADS} "
                "threads cannot be scheduled on this card")
        most = -(-n_units // cluster)        # one CTA a unit
        for clusters in range(max(1, min(fit // tiles, most)), most + 1):
            ctas = cluster * clusters
            rows_max = -(-n_units // ctas) * unit
            smem = margins_smem(tile_pad, xstride, rows_max, rstride,
                                counts)
            if smem <= SMEM_LIMIT:
                break
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"predictor: S={s} w={w} k={k} G={g} needs {smem} bytes of "
            f"shared memory at {MMA_TOKENS} tokens a tile (limit "
            f"{SMEM_LIMIT})")
    if tiles > 65535:
        raise ValueError(f"predictor: S={s} makes {tiles} token tiles "
                         "(limit 65535)")
    return MarginsPlan(tile, tile_pad, tiles, cluster, unit, n_units, ctas,
                       rows_max, xstride, rstride, smem)


_PLANS: dict = {}


def _plan_for(lib, name: str, device, xd: int, b: int, w: int, k: int,
              g: int) -> MarginsPlan:
    """margins_plan on this card's occupancy calculator, once a shape
    (``xd`` X_PACKED: the counts kernel's)."""
    key = (name, device.index, xd, b, w, k, g)
    pl = _PLANS.get(key)
    if pl is None:
        counts = xd == X_PACKED

        def max_clusters(cluster: int, smem: int) -> int:
            args = (w, smem) if counts else (xd, w, cluster, smem)
            with torch.cuda.device(device):
                n = getattr(lib, f"{name}_max_clusters")(*args)
            if n < 0:
                build.check(name, -n)
            return n
        pl = _PLANS[key] = margins_plan(b, w, k, g, max_clusters, counts)
    return pl


def _launch(name: str, packed_w: torch.Tensor, x: torch.Tensor,
            alpha: torch.Tensor, d_valid: int, group_size: int):
    k, w = packed_w.shape
    b, dp = x.shape
    if not (x.is_cuda and packed_w.device == x.device
            and alpha.device == x.device):
        raise ValueError(f"{name} launches on CUDA tensors of one device")
    if x.dtype not in _X_DTYPES or packed_w.dtype != torch.int32 \
            or alpha.dtype != torch.float32:
        raise ValueError(f"unsupported dtypes x={x.dtype} "
                         f"packed_w={packed_w.dtype} alpha={alpha.dtype}")
    max_b = MAX_BATCH if name == "predict_group_margins" else b
    if dp != w * PACK or k % group_size or not 1 <= b <= max_b \
            or alpha.shape != (b,):
        raise ValueError(f"bad shapes for {name}: x={tuple(x.shape)} "
                         f"packed_w={tuple(packed_w.shape)} "
                         f"alpha={tuple(alpha.shape)} group_size={group_size}")
    x, packed_w, alpha = x.contiguous(), packed_w.contiguous(), \
        alpha.contiguous()
    lib = build.load(name)
    xd = _X_DTYPES[x.dtype]
    pl = _plan_for(lib, name, x.device, xd, b, w, k, group_size)
    gm = torch.empty((b, k // group_size), dtype=torch.float32,
                     device=x.device)
    cnt = torch.zeros((b,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, name)(
        x.data_ptr(), xd, packed_w.data_ptr(), alpha.data_ptr(),
        gm.data_ptr(), cnt.data_ptr(), b, w, k, group_size, float(d_valid),
        pl.tile, pl.cluster, pl.unit_rows, pl.ctas, pl.rstride, pl.smem,
        stream)
    build.check(name, rc)
    return gm, cnt


def predict_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                          alpha: torch.Tensor, *, d_valid: int,
                          group_size: int = 8):
    """One launch: packed gate signs (k, w) int32, x (B <= 16, w*32)
    float32 or bfloat16 zero-padded past ``d_valid``, alpha (B,) float32,
    all on one CUDA device -> (gm (B, k/G) float32, cnt (B,) int32)."""
    return _launch("predict_group_margins", packed_w, x, alpha, d_valid,
                   group_size)


def predict_chunk_group_margins(packed_w: torch.Tensor, x: torch.Tensor,
                                alpha: torch.Tensor, *, d_valid: int,
                                group_size: int = 8):
    """:func:`predict_group_margins` for any number of rows S (a prefill
    chunk), one launch tiled over tokens."""
    return _launch("predict_chunk_group_margins", packed_w, x, alpha,
                   d_valid, group_size)


def predict_counts(packed_w: torch.Tensor,
                   packed_x: torch.Tensor) -> torch.Tensor:
    """One launch: packed gate signs (k, w) int32 and packed x (B >= 1, w)
    int32, on one CUDA device -> (B, k) int32 counts of sign bits that
    differ; every output written by the kernel (nothing zeroed)."""
    k, w = packed_w.shape
    if not (packed_x.is_cuda and packed_w.device == packed_x.device):
        raise ValueError("predict_counts launches on CUDA tensors of one "
                         "device")
    if packed_w.dtype != torch.int32 or packed_x.dtype != torch.int32:
        raise ValueError(f"unsupported dtypes packed_w={packed_w.dtype} "
                         f"packed_x={packed_x.dtype}")
    if packed_x.ndim != 2 or packed_x.shape[1] != w or k < 1 or w < 1 \
            or packed_x.shape[0] < 1:
        raise ValueError(f"bad shapes for predict_counts: packed_w="
                         f"{tuple(packed_w.shape)} packed_x="
                         f"{tuple(packed_x.shape)}")
    b = packed_x.shape[0]
    packed_w, packed_x = packed_w.contiguous(), packed_x.contiguous()
    lib = build.load("predict_counts")
    pl = _plan_for(lib, "predict_counts", packed_x.device, X_PACKED, b, w,
                   k, 1)
    out = torch.empty((b, k), dtype=torch.int32, device=packed_x.device)
    stream = torch.cuda.current_stream(packed_x.device).cuda_stream
    rc = lib.predict_counts(packed_w.data_ptr(), packed_x.data_ptr(),
                            out.data_ptr(), b, w, k, pl.tile, pl.cluster,
                            pl.unit_rows, pl.ctas, pl.rstride, pl.smem,
                            stream)
    build.check("predict_counts", rc)
    return out
