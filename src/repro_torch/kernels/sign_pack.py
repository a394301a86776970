"""Launcher of the sign-packing CUDA kernel (``csrc/sign_pack.cu``), the
counterpart of the Pallas kernel of ``repro/kernels/sign_pack.py``.

Layout: LSB-first along the last axis, bit ``b`` of word ``i`` is
``v[i*32 + b] < 0``; zero, -0.0, NaN and the lanes past ``d`` pack as
positive, as ``core.predictor.pack_signs`` does.  Any ``d`` is taken: the
kernel reads the last word's missing lanes as zero.

``plan`` is the launch's host plan (route, grid, loads a thread), kept in
Python so that the CPU tests reach it.  Callers go through
``kernels.ops``, which picks the plain version for CPU tensors and counts
launches."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

PACK = 32
_V_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/sign_pack.cu: kThreads, kUnroll; blocks a SM at 256 threads
THREADS, UNROLL, BLOCKS_PER_SM = 256, 4, 8
WARPS = THREADS // 32
H100_SMS = 132


class Plan(NamedTuple):
    route: str          # "vector": 16-byte loads; "scalar": a warp a word
    vec_words: int      # words a row the vector route makes (d // 32)
    loads: int          # the vector route's 16-byte loads
    scalar_words: int   # words the scalar route makes
    blocks: int         # the grid
    loads_per_thread: int   # the vector route's loads a thread, at most


def plan(rows: int, d: int, elem: int, ptr: int,
         sms: int = H100_SMS) -> Plan:
    """The launch of a (rows, d) pack of ``elem``-byte values at address
    ``ptr``: the vector route where every row starts 16-byte aligned
    (``d * elem % 16 == 0`` and ``ptr % 16 == 0``), its full words by
    16-byte loads and each row's partial last word by the scalar route;
    else the scalar route for every word.  The grid gives each thread one
    load (a warp one word on the scalar route), at most the card's
    resident blocks; past that the threads loop, ``UNROLL`` loads in
    flight."""
    if rows < 1 or d < 1 or elem not in (2, 4):
        raise ValueError(f"sign_pack plan: rows={rows} d={d} elem={elem}")
    w = -(-d // PACK)
    vector = (d * elem) % 16 == 0 and ptr % 16 == 0
    vec_words = d // PACK if vector else 0
    loads = rows * vec_words * (PACK * elem // 16)
    scalar_words = rows * (w - vec_words)
    need = max(-(-loads // THREADS), -(-scalar_words // WARPS), 1)
    blocks = min(need, sms * BLOCKS_PER_SM)
    per_thread = -(-loads // (blocks * THREADS))
    return Plan("vector" if vector else "scalar", vec_words, loads,
                scalar_words, blocks, per_thread)


def sign_pack(v: torch.Tensor) -> torch.Tensor:
    """One launch: v (rows, d) float32 or bfloat16 on a CUDA device ->
    (rows, ceil(d/32)) int32."""
    if not v.is_cuda:
        raise ValueError("sign_pack launches on a CUDA tensor")
    if v.dtype not in _V_DTYPES:
        raise ValueError(f"sign_pack takes float32 or bfloat16, not "
                         f"{v.dtype}")
    if v.ndim != 2 or v.shape[0] < 1 or v.shape[1] < 1:
        raise ValueError(f"sign_pack takes (rows, d), got {tuple(v.shape)}")
    rows, d = v.shape
    v = v.contiguous()
    pl = plan(rows, d, v.element_size(), v.data_ptr(),
              torch.cuda.get_device_properties(v.device).multi_processor_count)
    lib = build.load("sign_pack")
    out = torch.empty((rows, -(-d // PACK)), dtype=torch.int32,
                      device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.sign_pack(v.data_ptr(), _V_DTYPES[v.dtype], out.data_ptr(),
                       rows, d, pl.vec_words, pl.blocks, stream)
    build.check("sign_pack", rc)
    return out
