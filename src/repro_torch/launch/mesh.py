"""The card's constants for the dry run and the roofline: the counterpart
of the hardware constants in ``repro/launch/mesh.py``.

One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, from NVIDIA's
data sheet; a card set below 700 W runs slower under load.  There is no
``make_production_mesh``: placing a shard grid over several cards is
ROADMAP item 15, and one card needs no mesh.
"""
from __future__ import annotations

# HBM3 bandwidth of one H100 80GB SXM5 (700 W), bytes/s
HBM_BW = 3.35e12
# dense bfloat16 tensor-core peak of one H100 SXM5 (700 W), FLOP/s
PEAK_FLOPS_BF16 = 989e12
# device memory of one H100 80GB HBM3: 81559 MiB, as nvidia-smi reports it
HBM_PER_CARD = 81559 * 2**20
