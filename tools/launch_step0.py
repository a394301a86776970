#!/usr/bin/env python3
"""Step 0 of the KV write's (#8) and sign_pack's (#9) redesign, on the card:

    python3 tools/launch_step0.py SRC

SRC is the ``src`` directory of a checkout, say the parent commit's
unpacked by ``git archive``.  It builds ``tools/launch_empty.cu`` (an empty
kernel, by ``chip_smoke.empty_kernel``) and times, with
``chip_smoke.cuda_ms`` (CUDA events behind a ~5 ms GPU sleep):

* the empty launch at 1, 4, 8, 16, 32, 132 and 1056 blocks of 128
  threads, and at 1 and 8 blocks with the L2 flushed before each launch;
* ``chip_smoke.time_write_and_pack`` on SRC's kernels: the decode step's
  K and V write at B=4 and 16 (32 KV heads x hd 128, bf16, block 16; the
  paired launch where SRC has one, else the targets' arithmetic and two
  launches) beside one and two launches of the single entry, two
  ``index_put_`` with and without the targets' arithmetic, and the byte
  bound; sign_pack on x at B in {1, 4, 64} (bf16, with the L2 flushed and
  with x in the L2) and on the (11008, 4096) gate weights in float32 and
  bf16."""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    src = os.path.abspath(sys.argv[1])
    sys.path[:0] = [src, str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import paged_attn as KA

    if not torch.cuda.is_available():
        sys.exit("launch_step0: no GPU")
    if not KA.__file__.startswith(src):
        sys.exit(f"launch_step0: repro_torch came from {KA.__file__}")
    print(f"[gpu] {cs.gpu_line()}", flush=True)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for blocks in (1, 4, 8, 16, 32, 132, 1056):
        print(f"[step0] empty launch, {blocks} blocks: "
              f"{cs.empty_ms(blocks):.4f} ms", flush=True)
    for blocks in (1, 8):
        print(f"[step0] empty launch, {blocks} blocks, L2 flushed: "
              f"{cs.empty_ms(blocks, flush=flush_buf.zero_):.4f} ms",
              flush=True)
    del flush_buf
    cs.time_write_and_pack()
    print(f"[gpu] {cs.gpu_line()}", flush=True)


if __name__ == "__main__":
    main()
