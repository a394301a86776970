"""Launchers of the paged-attention CUDA kernels, the counterparts of the
Pallas kernels of ``repro/kernels/paged_attn.py``:

* ``paged_attention`` (``csrc/paged_attention.cu``): decode attention of
  every slot over its pool pages, read through its block table, by a
  thread-block cluster per (kv head, slot) that splits the slot's live
  span over up to 8 CTAs;
* ``paged_kv_write`` (``csrc/paged_kv_write.cu``): the decode step's K or V
  row of every slot written into its pool page, in place.

``plan`` is the attention launch's shape arithmetic (cluster size, tile
rows, shared memory), kept on the host so that the CPU tests reach it.

Callers go through ``kernels.ops``, which picks the plain version for CPU
tensors and counts launches."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SMEM_LIMIT = 232448       # shared memory a block can use on an H100
MAX_HEAD_DIM = 256
# csrc/paged_attention.cu: kThreads, kStages, kStageBytes, kMinTileRows,
# kMaxTileRows, kMaxRepGroup, kMaxCluster
THREADS, STAGES, STAGE_BYTES = 128, 3, 8192
MIN_TILE_ROWS, MAX_TILE_ROWS = 8, 64
MAX_REP_GROUP, MAX_CLUSTER = 8, 8
# the split: while the whole grid fits on the card at once, halve a CTA's
# rows down to TARGET_ROWS; past one wave, only down to MAX_SEG_ROWS
TARGET_ROWS, MAX_SEG_ROWS = 64, 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    cluster: int      # P: CTAs that split one slot's live span
    rep_group: int    # query heads per CTA
    tile_rows: int    # K/V rows per shared-memory tile
    seg_rows: int     # score rows a CTA holds: ceil(max_len / P)
    smem_bytes: int   # dynamic shared memory per CTA
    clusters: int     # clusters in the grid: B x K x query-head groups
    fit: int          # clusters the card runs at once (max_clusters)


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def tile_rows(row_bytes: int) -> int:
    """Rows of one ~8 KB tile of the ring."""
    return min(max(STAGE_BYTES // row_bytes // 8 * 8, MIN_TILE_ROWS),
               MAX_TILE_ROWS)


def rep_group(rep: int) -> int:
    """Query heads per CTA: the next power of two, at most 8."""
    g = 1
    while g < rep and g < MAX_REP_GROUP:
        g *= 2
    return g


def smem_bytes(rg: int, hd: int, elem: int, bs: int, seg_rows: int,
               tr: int) -> int:
    """The layout of csrc/paged_attention.cu:layout: the tile ring (reused
    for the row groups' partial outputs), q, the partial output, the
    segment's scores, its maxima and sums, and its block ids."""
    ring = STAGES * tr * hd * elem
    red = THREADS // (hd * elem // 16) * hd * 4
    return (_align16(max(ring, red)) + 2 * _align16(rg * hd * 4)
            + _align16(rg * seg_rows * 4) + 2 * _align16(rg * 4)
            + _align16((-(-seg_rows // bs) + 1) * 4))


def segment(t_lo: int, t_hi: int, p: int, rank: int) -> tuple[int, int]:
    """The rows [a, a + n) of the live span [t_lo, t_hi] that CTA ``rank``
    of a cluster of ``p`` scores (n may be 0)."""
    span = t_hi - t_lo + 1
    chunk = -(-span // p)
    a = t_lo + rank * chunk
    return a, max(0, min(chunk, t_hi + 1 - a))


def plan(b: int, h: int, kvh: int, hd: int, bs: int, nbps: int,
         elem: int, max_clusters, cluster: int | None = None) -> Plan:
    """The attention launch for B slots of H query heads over K kv heads,
    head dim hd, pool blocks of bs rows, nbps blocks per slot and
    ``elem``-byte pool values.  ``max_clusters(p, smem)`` says how many
    clusters of p CTAs with smem bytes each the card runs at once.

    The grid has B x K x ceil(rep / rep_group) clusters whatever P is.  P
    (1-8) doubles while a CTA would hold more than TARGET_ROWS of max_len
    and the doubled clusters still all fit on the card at once (a second
    wave costs a whole kernel's latency); then, over several waves, while
    a CTA would hold more than MAX_SEG_ROWS; then while its shared memory
    exceeds the limit.  ``cluster`` fixes P instead (chip_smoke.py's
    sweep).  Raises ValueError on a shape the kernel does not take and
    RuntimeError when the card cannot schedule one such cluster."""
    vec = 16 // elem
    if (b < 1 or kvh < 1 or h < kvh or h % kvh or hd < vec or hd % vec
            or hd > MAX_HEAD_DIM or bs < 1 or nbps < 1 or b > 65535):
        raise ValueError(
            f"paged_attention: bad shape B={b} H={h} K={kvh} hd={hd} "
            f"block={bs} nbps={nbps} (hd must be a multiple of {vec} and "
            f"at most {MAX_HEAD_DIM}; H a multiple of K; B at most 65535)")
    s_max = nbps * bs
    rg = rep_group(h // kvh)
    clusters = b * kvh * math.ceil(h // kvh / rg)
    tr = tile_rows(hd * elem)

    def seg(p):
        return -(-s_max // p)

    def smem(p):
        return smem_bytes(rg, hd, elem, bs, seg(p), tr)
    if cluster is not None:
        if cluster not in (1, 2, 4, 8):
            raise ValueError(f"paged_attention: a cluster of {cluster} "
                             "CTAs (1, 2, 4 or 8)")
        p = cluster
    else:
        p = 1
        while (p < MAX_CLUSTER and 2 * p <= s_max and seg(p) > TARGET_ROWS
               and smem(2 * p) <= SMEM_LIMIT
               and clusters <= max_clusters(2 * p, smem(2 * p))):
            p *= 2
        while p < MAX_CLUSTER and seg(p) > MAX_SEG_ROWS:
            p *= 2
        while p < MAX_CLUSTER and smem(p) > SMEM_LIMIT:
            p *= 2
    if smem(p) > SMEM_LIMIT:
        raise ValueError(
            f"paged_attention: {smem(p)} bytes of shared memory per CTA "
            f"for {rg} query heads x max_len {s_max} split over a cluster "
            f"of {p} exceed the limit of {SMEM_LIMIT}")
    fit = max_clusters(p, smem(p))
    if fit < 1:
        raise RuntimeError(
            f"paged_attention: a cluster of {p} CTAs with {smem(p)} bytes "
            "of shared memory each cannot be scheduled on this card")
    return Plan(p, rg, tr, seg(p), smem(p), clusters, fit)


def _on_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} launches on CUDA tensors of one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


_MAX_CLUSTERS: dict = {}   # launch shape -> clusters that fit at once
_PLANS: dict = {}


def _card_max_clusters(lib, device, qd, kd, b, h, kvh, hd, bs, nbps, tr):
    """``plan``'s max_clusters from the card's occupancy calculator
    (cudaOccupancyMaxActiveClusters for this launch), asked once per
    shape."""
    def max_clusters(p: int, smem: int) -> int:
        key = (device.index, qd, kd, b, h, kvh, hd, bs, nbps, p, tr, smem)
        n = _MAX_CLUSTERS.get(key)
        if n is None:
            with torch.cuda.device(device):
                n = lib.paged_attention_max_clusters(*key[1:])
            if n < 0:
                build.check("paged_attention", -n)
            _MAX_CLUSTERS[key] = n
        return n
    return max_clusters


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor,
                table: torch.Tensor, cluster: int | None = None) -> Plan:
    """The plan ``paged_attention`` launches these tensors with, on the
    card's occupancy (made once per shape)."""
    b, h, hd = q.shape
    _, bs, kvh, _ = k_pages.shape
    nbps = table.shape[1]
    qd, kd = _DTYPES[q.dtype], _DTYPES[k_pages.dtype]
    key = (q.device.index, qd, kd, b, h, kvh, hd, bs, nbps, cluster)
    pl = _PLANS.get(key)
    if pl is None:
        elem = k_pages.element_size()
        pl = _PLANS[key] = plan(
            b, h, kvh, hd, bs, nbps, elem, _card_max_clusters(
                build.load("paged_attention"), q.device, qd, kd, b, h, kvh,
                hd, bs, nbps, tile_rows(hd * elem)), cluster)
    return pl


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, *, softcap: float = 0.0,
                    window: int = 0,
                    cluster: int | None = None) -> torch.Tensor:
    """One launch: q (B, H, hd) float32 or bfloat16; k/v pages
    (N, block, K, hd) float32 or bfloat16 (one dtype); table (B, nbps) and
    lengths (B,) integer -> (B, H, hd) float32.  ``cluster`` overrides the
    planned cluster size (see ``plan``)."""
    _on_cuda("paged_attention", q, k_pages, v_pages, table, lengths)
    b, h, hd = q.shape
    n, bs, kvh, hd_p = k_pages.shape
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_attention takes float32 or bfloat16: q="
                         f"{q.dtype} pages={k_pages.dtype}/{v_pages.dtype}")
    if (hd_p != hd or v_pages.shape != k_pages.shape or table.ndim != 2
            or table.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(
            f"bad shapes for paged_attention: q={tuple(q.shape)} pages="
            f"{tuple(k_pages.shape)} table={tuple(table.shape)} lengths="
            f"{tuple(lengths.shape)}")
    pl = launch_plan(q, k_pages, table, cluster)
    q, k_pages, v_pages = _aligned(q), _aligned(k_pages), _aligned(v_pages)
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    # one folded constant, computed in double as the TPU kernel does
    scale = (hd ** -0.5) / softcap if softcap > 0.0 else hd ** -0.5
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    lib = build.load("paged_attention")
    rc = lib.paged_attention(
        q.data_ptr(), _DTYPES[q.dtype], k_pages.data_ptr(),
        v_pages.data_ptr(), _DTYPES[k_pages.dtype], table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, kvh, hd, n, bs,
        table.shape[1], float(scale), float(softcap), int(window),
        pl.cluster, pl.tile_rows, pl.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", rc)
    return out


def paged_kv_write(pages: torch.Tensor, vals: torch.Tensor,
                   blocks: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """One launch: pages (N, block, ...) float32 or bfloat16, written in
    place at ``pages[blocks[b], offsets[b]] = vals[b]`` (vals (B, ...) cast
    to the pages' dtype; the last slot wins on a collision).  Returns
    ``pages``."""
    _on_cuda("paged_kv_write", pages, vals, blocks, offsets)
    if pages.dtype not in _DTYPES:
        raise ValueError(f"paged_kv_write takes float32 or bfloat16 pages, "
                         f"not {pages.dtype}")
    b = vals.shape[0]
    if (vals.shape[1:] != pages.shape[2:] or b < 1
            or blocks.shape != (b,) or offsets.shape != (b,)):
        raise ValueError(
            f"bad shapes for paged_kv_write: pages={tuple(pages.shape)} "
            f"vals={tuple(vals.shape)} blocks={tuple(blocks.shape)} "
            f"offsets={tuple(offsets.shape)}")
    if not pages.is_contiguous() or pages.data_ptr() % 16:
        raise ValueError("paged_kv_write writes in place: pages must be "
                         "contiguous and 16-byte aligned")
    vals = _aligned(vals.to(pages.dtype))
    blocks = blocks.to(torch.int32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    n, bs = pages.shape[:2]
    row_bytes = pages[0, 0].numel() * pages.element_size()
    lib = build.load("paged_kv_write")
    rc = lib.paged_kv_write(
        pages.data_ptr(), vals.data_ptr(), blocks.data_ptr(),
        offsets.data_ptr(), b, n, bs, row_bytes,
        torch.cuda.current_stream(pages.device).cuda_stream)
    build.check("paged_kv_write", rc)
    return pages
