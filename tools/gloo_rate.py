#!/usr/bin/env python3
"""What a gloo collective costs between ranks that share the card:

    python3 tools/gloo_rate.py

On a mesh of 2 ranks over ('model',) and of 2x2 over ('data', 'model')
(``repro_torch.launch.ranks.run_ranks``, gloo: the ranks share card 0),
each rank times four all_gathers of a 90 MB float32 CUDA tensor (one
layer's rows of one prosparse-llama2-7b MLP leaf at ms=2: 5504 x 4096)
and the median of 50 all_reduces of 8 floats, each synchronised.  It
prints the seconds per all_gather and the all_reduce median a rank."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def rate(mesh, dev, mb: int):
    import torch
    import torch.distributed as dist
    t = torch.ones(mb * 2**20 // 4, device=dev)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    gathers = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_gather(parts, t)
        torch.cuda.synchronize()
        gathers.append(time.perf_counter() - t0)
    small = torch.ones(8, device=dev)
    reduces = []
    for _ in range(50):
        t0 = time.perf_counter()
        dist.all_reduce(small)
        torch.cuda.synchronize()
        reduces.append(time.perf_counter() - t0)
    return gathers, sorted(reduces)[len(reduces) // 2]


def main() -> None:
    from repro_torch.launch.ranks import run_ranks
    for shape, axes in (((2,), ("model",)), ((2, 2), ("data", "model"))):
        outs = run_ranks(rate, shape, axes, args=(90,), device="cuda",
                         timeout=300)
        print(f"[gloo] all_gather of 90 MB a rank over {shape}: seconds "
              f"{[[round(x, 3) for x in o[0]] for o in outs]}; all_reduce "
              f"of 8 floats, median ms {[round(o[1] * 1e3, 3) for o in outs]}",
              flush=True)


if __name__ == "__main__":
    main()
