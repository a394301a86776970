"""Launchers of the paged-attention CUDA kernels, the counterparts of the
Pallas kernels of ``repro/kernels/paged_attn.py``:

* ``paged_attention`` (``csrc/paged_attention.cu``): decode attention of
  every slot over its pool pages, read through its block table;
* ``paged_kv_write`` (``csrc/paged_kv_write.cu``): the decode step's K or V
  row of every slot written into its pool page, in place.

Callers go through ``kernels.ops``, which picks the plain version for CPU
tensors and counts launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SMEM_LIMIT = 232448       # shared memory a block can use on an H100
MAX_HEAD_DIM = 256
_WARPS, _REP_GROUP = 4, 4  # csrc/paged_attention.cu kWarps, kRepGroup
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(rep: int, hd: int, s_max: int) -> int:
    """Dynamic shared memory of one attention block: q, the warps'
    partial outputs, reduction scratch, l, and the float32 scores of every
    lane of each of its rep query heads."""
    return 4 * (rep * hd + _WARPS * _REP_GROUP * hd + _WARPS + rep
                + rep * s_max)


def _on_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name} launches on CUDA tensors of one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, *, softcap: float = 0.0,
                    window: int = 0) -> torch.Tensor:
    """One launch: q (B, H, hd) float32 or bfloat16; k/v pages
    (N, block, K, hd) float32 or bfloat16 (one dtype); table (B, nbps) and
    lengths (B,) integer -> (B, H, hd) float32."""
    _on_cuda("paged_attention", q, k_pages, v_pages, table, lengths)
    b, h, hd = q.shape
    n, bs, kvh, hd_p = k_pages.shape
    nbps = table.shape[1] if table.ndim == 2 else 0
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_attention takes float32 or bfloat16: q="
                         f"{q.dtype} pages={k_pages.dtype}/{v_pages.dtype}")
    vec = 16 // k_pages.element_size()
    if (hd_p != hd or v_pages.shape != k_pages.shape or b < 1
            or h % kvh or hd % vec or hd > MAX_HEAD_DIM or nbps < 1
            or table.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(
            f"bad shapes for paged_attention: q={tuple(q.shape)} pages="
            f"{tuple(k_pages.shape)} table={tuple(table.shape)} lengths="
            f"{tuple(lengths.shape)} (hd must be a multiple of {vec} and "
            f"at most {MAX_HEAD_DIM}; H a multiple of K)")
    smem = smem_bytes(h // kvh, hd, nbps * bs)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"paged_attention: {smem} bytes of shared memory for rep="
            f"{h // kvh} x max_len={nbps * bs} scores exceed {SMEM_LIMIT}")
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
        lengths.data_ptr(), out.data_ptr(), b, h, kvh, hd, n, bs, nbps,
        float(scale), float(softcap), int(window),
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
