"""Time chip_smoke.py's chunked serve phase with another checkout's port.

    python3 tools/serve_ab.py SRC

puts SRC (a checkout's ``src``, say the parent commit's unpacked by ``git
archive <commit> src | tar -x -C build/parent``) first on ``sys.path``,
builds its kernels (into that checkout's ``build/``) and runs
``chip_smoke.phase_serve_chunked`` twice, printing each run's seconds.
Run it for both checkouts in turns in one call on one card (other, this,
this, other): the phase's serve walls are host-bound and move between
calls.  Needs a GPU.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit("usage: python3 tools/serve_ab.py SRC")
    src = os.path.abspath(sys.argv[1])
    sys.path[:0] = [src, HERE]
    import torch
    import chip_smoke as C
    import repro_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[ab] {os.path.dirname(os.path.dirname(repro_torch.__file__))} "
          f"{C.gpu_line()}", flush=True)
    C.phase_build()
    for _ in range(2):
        t = time.perf_counter()
        C.phase_serve_chunked({})
        print(f"[ab] {sys.argv[1]} phase_serve_chunked "
              f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
