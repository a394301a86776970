#!/usr/bin/env python3
"""Step 0 of the sign-bit predictor's redesign, on the card:

    python3 tools/predict_step0.py OLD_SRC

OLD_SRC is the ``src`` directory of a checkout whose
``repro_torch/csrc/predict_margins.cuh`` holds the kernel before the
redesign (one warp per weight row, x's signs packed with one ballot per
word in every block), say the parent commit's unpacked by ``git archive``.
It builds, under ``build/predict_step0/``:

* that kernel as it is, and two throw-away builds of it: one whose phase 1
  copies pre-packed signs instead of packing x ("prepacked"), and one whose
  per-token shuffle trees are taken out ("notree", wrong by design: it
  shows what the trees cost);
* ``tools/predict_ubench.cu``: the CUDA-core popcount rate, the binary
  ``mma.sync`` rates (``.and.popc``, ``.xor.popc``) beside int8's, and a
  check of the b1 m16n8k256 fragment layout the new kernel assumes.

Then it prints the old kernel's time at S in {1, 4, 16, 32, 64, 128, 256}
(bf16 x; float32 at 4 and 64), the throw-away builds beside it at S in
{4, 16, 64}, the rates and the layout check, each kernel timed with
``chip_smoke.cuda_ms`` (CUDA events, the L2 flushed before each launch).

    python3 tools/predict_step0.py --counts SRC

times the sign-bit kernels of the checkout whose ``src`` is SRC (say the
parent commit's, unpacked by ``git archive``), bf16 x on
prosparse-llama2-7b's gate signs: ``predict_counts`` at B in {1, 4, 16,
64, 256} beside its bounds; ``predict_group_margins`` at B=4 through its
launcher (the ``torch.zeros`` of cnt included), as the kernel alone, as a
throw-away build of it that packs no x ("nopack", wrong by design: it
shows what packing costs), and the ``torch.zeros`` alone;
``predict_chunk_group_margins`` at S=64 through its launcher.

    python3 tools/predict_step0.py --counts-ctas

times this checkout's ``predict_counts`` (the counts instantiation of
``predict_margins.cuh``) at B in {1, 4, 16, 64, 128, 256} on plans that
give each token tile 132 to 2752 CTAs (``margins_plan`` asked with that
many CTAs at once; more than the card runs at once make waves), each
checked bitwise against the plain version."""
import ctypes
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "build" / "predict_step0"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
P_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
STUB = """#include "{hdr}"
extern "C" int {name}(const void* x, int x_dtype, const void* pw,
                      const void* alpha, void* gm, void* cnt, int S, int w,
                      int k, int G, float d_valid, void* stream) {{
  return predict::dispatch(x, x_dtype, pw, alpha, gm, cnt, S, w, k, G,
                           d_valid, stream);
}}
"""


def variants(old_header: str) -> dict[str, str]:
    """The old template and its two throw-away builds, by name."""
    pack = old_header[old_header.index(
        "  for (int t = warp; t < B * w; t += kWarps) {"):
        old_header.index("  __syncthreads();\n\n  // 2.")]
    prepacked = old_header.replace(pack, (
        "  {  // x holds (B, w) pre-packed words\n"
        "    const uint32_t* xw =\n"
        "        reinterpret_cast<const uint32_t*>(x) + (size_t)tok0 * w;\n"
        "    for (int t = threadIdx.x; t < B * w; t += kThreads) "
        "px[t] = xw[t];\n  }\n")).replace(
        "  x += (size_t)tok0 * w * 32;\n", "")
    tree = ("        for (int o = 16; o > 0; o >>= 1) "
            "v += __shfl_xor_sync(0xffffffffu, v, o);\n")
    if tree not in old_header or prepacked == old_header:
        sys.exit("predict_step0: OLD_SRC's predict_margins.cuh is not the "
                 "kernel before the redesign")
    return {"old": old_header, "prepacked": prepacked,
            "notree": old_header.replace(tree, "")}


def build(old_src: str) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    hdr = pathlib.Path(old_src) / "repro_torch" / "csrc" / \
        "predict_margins.cuh"
    sources = {}
    for name, text in variants(hdr.read_text()).items():
        (OUT / f"{name}_margins.cuh").write_text(text)
        (OUT / f"{name}.cu").write_text(
            STUB.format(hdr=f"{name}_margins.cuh", name=name))
        sources[name] = OUT / f"{name}.cu"
    sources["ubench"] = HERE / "predict_ubench.cu"
    procs = {name: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o",
         str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"predict_step0: nvcc failed for {name}:\n{log}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "Used" in line})
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def counts_step0(src: str) -> None:
    """The ``--counts`` part: see the module docstring."""
    sys.path[:0] = [src, str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.core import predictor as P
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        sys.exit("predict_step0: no GPU")
    if not KP.__file__.startswith(os.path.abspath(src)):
        sys.exit(f"predict_step0: repro_torch came from {KP.__file__}")
    print(f"[gpu] {cs.gpu_line()}", flush=True)
    # the throw-away build: phase 1 packs no word of x
    csrc = pathlib.Path(src) / "repro_torch" / "csrc"
    hdr = (csrc / "predict_margins.cuh").read_text()
    total = "const int total = T * p.w;"
    if total not in hdr:
        sys.exit("predict_step0: SRC's predict_margins.cuh has no packing "
                 "loop to take out")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "nopack_margins.cuh").write_text(
        hdr.replace(total, "const int total = 0 * T * p.w;"))
    (OUT / "nopack.cu").write_text(
        (csrc / "predict_group_margins.cu").read_text().replace(
            '#include "predict_margins.cuh"', '#include "nopack_margins.cuh"'))
    KB.build(["predict_counts", "predict_group_margins",
              "predict_chunk_group_margins"])
    out = subprocess.run(["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o",
                          str(OUT / "nopack.so"), str(OUT / "nopack.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"predict_step0: nvcc failed for nopack:\n{out.stdout}"
                 f"{out.stderr}")
    nopack = ctypes.CDLL(str(OUT / "nopack.so"))
    for fn, argtypes in KB.SIGNATURES["predict_group_margins"].items():
        getattr(nopack, fn).argtypes = argtypes
        getattr(nopack, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    d, k, g = cs.D, cs.K, cs.G
    w = d // 32
    gen = torch.Generator(device=dev).manual_seed(0)
    pw = P.pack_signs(torch.randn((k, d), generator=gen, device=dev))
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def flush():
        flush_buf.zero_()

    for b in (1, 4, 16, 64, 256):
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        px = P.pack_signs(x)
        if not torch.equal(KP.predict_counts(pw, px),
                           ref.predict_counts_ref(pw, px)):
            sys.exit(f"predict_step0: predict_counts is wrong at B={b}")
        t = cs.cuda_ms(lambda: KP.predict_counts(pw, px), iters=50,
                       flush=flush)
        n_bytes = k * w * 4 + b * w * 4 + b * k * 4
        t_b = n_bytes / cs.HBM_BYTES_PER_S * 1e3
        t_tc = b * k * w * 32 / cs.B1_MACS_PER_S * 1e3
        t_cc = b * k * w / cs.POPC_PER_S * 1e3
        print(f"[step0] predict_counts B={b}: {t:.4f} ms; bytes {t_b:.4f} "
              f"ms (share {t_b / t:.3f}), b1 tensor cores {t_tc:.4f} ms, "
              f"CUDA-core popcounts {t_cc:.4f} ms (share {t_cc / t:.3f})",
              flush=True)

    b = cs.MAIN_BATCH
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    alpha = torch.ones(b, device=dev)
    lib = KB.load("predict_group_margins")
    pl = KP._plan_for(lib, "predict_group_margins", dev, 1, b, w, k, g)
    gm = torch.empty((b, k // g), dtype=torch.float32, device=dev)
    cnt = torch.zeros((b,), dtype=torch.int32, device=dev)

    def kernel(lb):
        rc = lb.predict_group_margins(
            x.data_ptr(), 1, pw.data_ptr(), alpha.data_ptr(), gm.data_ptr(),
            cnt.data_ptr(), b, w, k, g, float(d), pl.tile, pl.cluster,
            pl.unit_rows, pl.ctas, pl.rstride, pl.smem, stream)
        if rc:
            sys.exit(f"predict_step0: predict_group_margins failed ({rc})")

    line = {
        "launcher": cs.cuda_ms(lambda: KP.predict_group_margins(
            pw, x, alpha, d_valid=d, group_size=g), iters=50, flush=flush),
        "kernel alone": cs.cuda_ms(lambda: kernel(lib), iters=50,
                                   flush=flush),
        "nopack kernel": cs.cuda_ms(lambda: kernel(nopack), iters=50,
                                    flush=flush),
        "torch.zeros of cnt alone": cs.cuda_ms(lambda: torch.zeros(
            (b,), dtype=torch.int32, device=dev), iters=50, flush=flush)}
    print(f"[step0] predict_group_margins B={b}, ms: " + "; ".join(
        f"{n} {t:.4f}" for n, t in line.items()), flush=True)
    s = cs.MAIN_CHUNK
    x = torch.randn((s, d), generator=gen, device=dev).to(torch.bfloat16)
    alpha = torch.ones(s, device=dev)
    t = cs.cuda_ms(lambda: KP.predict_chunk_group_margins(
        pw, x, alpha, d_valid=d, group_size=g), iters=50, flush=flush)
    print(f"[step0] predict_chunk_group_margins S={s} launcher: {t:.4f} ms",
          flush=True)
    print(f"[gpu] {cs.gpu_line()}", flush=True)


def counts_ctas() -> None:
    """The ``--counts-ctas`` part: see the module docstring."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.core import predictor as P
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import predict as KP
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        sys.exit("predict_step0: no GPU")
    print(f"[gpu] {cs.gpu_line()}", flush=True)
    lib = KB.load("predict_counts")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    pw = P.pack_signs(torch.randn((cs.K, cs.D), generator=gen, device=dev))
    k, w = pw.shape
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def flush():
        flush_buf.zero_()

    for b in (1, 4, 16, 64, 128, 256):
        px = P.pack_signs(torch.randn((b, cs.D), generator=gen, device=dev))
        want = ref.predict_counts_ref(pw, px)
        out = torch.empty((b, k), dtype=torch.int32, device=dev)
        line = []
        for n in (132, 264, 396, 528, 688, 1376, 2752):
            pl = KP.margins_plan(b, w, k, 1, lambda c, smem: n, counts=True)

            def run():
                rc = lib.predict_counts(
                    pw.data_ptr(), px.data_ptr(), out.data_ptr(), b, w, k,
                    pl.tile, pl.cluster, pl.unit_rows, pl.ctas, pl.rstride,
                    pl.smem, stream)
                if rc:
                    sys.exit(f"predict_step0: predict_counts failed ({rc})")
            out.fill_(-1)
            run()
            if not torch.equal(out, want):
                sys.exit(f"predict_step0: predict_counts is wrong at B={b} "
                         f"on {pl.ctas} CTAs a tile")
            fit = lib.predict_counts_max_clusters(w, pl.smem)
            line.append(f"{pl.ctas} x {pl.token_tiles} CTAs of {pl.rows_max} "
                        f"rows ({fit} at once) "
                        f"{cs.cuda_ms(run, iters=50, flush=flush):.4f}")
        print(f"[ctas] predict_counts B={b}, ms: {'; '.join(line)}",
              flush=True)
    print(f"[gpu] {cs.gpu_line()}", flush=True)


def main() -> None:
    if sys.argv[1:] == ["--counts-ctas"]:
        return counts_ctas()
    if len(sys.argv) == 3 and sys.argv[1] == "--counts":
        return counts_step0(os.path.abspath(sys.argv[2]))
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import predictor as P
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        sys.exit("predict_step0: no GPU")
    print(f"[gpu] {cs.gpu_line()}", flush=True)
    libs = build(sys.argv[1])
    dev = torch.device("cuda")
    d, k, g = cs.D, cs.K, cs.G
    gen = torch.Generator(device=dev).manual_seed(0)
    pw = P.pack_signs(torch.randn((k, d), generator=gen, device=dev))
    w = pw.shape[1]
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def flush():
        flush_buf.zero_()

    def old_kernel(name, x_arg, x_dtype, s, alpha):
        fn = getattr(libs[name], name)
        fn.argtypes, fn.restype = P_ARGS, ctypes.c_int
        gm = torch.empty((s, k // g), dtype=torch.float32, device=dev)
        cnt = torch.zeros((s,), dtype=torch.int32, device=dev)

        def run():
            cnt.zero_()
            rc = fn(x_arg.data_ptr(), x_dtype, pw.data_ptr(),
                    alpha.data_ptr(), gm.data_ptr(), cnt.data_ptr(), s, w,
                    k, g, float(d), stream)
            if rc:
                sys.exit(f"predict_step0: {name} launch failed ({rc})")
        return run, gm, cnt

    # ---- the old kernel's scaling line (the cnt zeroing is in the time)
    for xdt, rows in ((torch.bfloat16, (1, 4, 16, 32, 64, 128, 256)),
                      (torch.float32, (4, 64))):
        xb = 2 if xdt == torch.bfloat16 else 4
        for s in rows:
            x = torch.randn((s, d), generator=gen, device=dev).to(xdt)
            alpha = torch.ones(s, device=dev)
            run, gm, cnt = old_kernel("old", x, int(xdt == torch.bfloat16),
                                      s, alpha)
            run()
            gm_r, cnt_r = ref.predict_group_margins_ref(pw, x, d, alpha, g)
            if not (torch.equal(gm, gm_r) and torch.equal(cnt, cnt_r)):
                sys.exit(f"predict_step0: the old kernel is wrong at S={s}")
            t = cs.cuda_ms(run, iters=30, flush=flush)
            n_bytes = k * w * 4 + s * d * xb + s * 8 + s * (k // g) * 4
            print(f"[step0] old kernel S={s} x={str(xdt)[6:]}: {t:.4f} ms; "
                  f"byte bound {n_bytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms, "
                  f"{s * k * w / 1e6:.2f} M popcounts", flush=True)

    # ---- the throw-away builds beside it, the same launch shape
    for s in (4, 16, 64):
        x = torch.randn((s, d), generator=gen, device=dev).to(torch.bfloat16)
        alpha = torch.ones(s, device=dev)
        px = P.pack_signs(x)
        gm_r, _ = ref.predict_group_margins_ref(pw, x, d, alpha, g)
        line = []
        for name, xa in (("old", x), ("prepacked", px), ("notree", x),
                         ("old", x)):
            run, gm, _ = old_kernel(name, xa, 1, s, alpha)
            run()
            right = torch.equal(gm, gm_r)
            if right == (name == "notree"):
                sys.exit(f"predict_step0: {name} at S={s} is "
                         f"{'right' if right else 'wrong'}")
            line.append(f"{name} {cs.cuda_ms(run, iters=30, flush=flush):.4f}")
        print(f"[step0] S={s} bf16, ms: {'; '.join(line)}", flush=True)

    # ---- rates
    ub = libs["ubench"]
    inp = torch.randint(-2 ** 31, 2 ** 31 - 1, (256,), dtype=torch.int32,
                        device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ub.run_popc.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2
    ghz = []
    for blocks_per_sm, block in ((8, 256), (4, 512)):
        grid, iters = sms * blocks_per_sm, 4096
        out = torch.empty(grid * block, dtype=torch.int32, device=dev)
        clk = torch.zeros(2, dtype=torch.int64, device=dev)
        t = cs.cuda_ms(lambda: ub.run_popc(
            inp.data_ptr(), out.data_ptr(), grid, block, iters,
            clk.data_ptr(), stream), iters=10)
        cycles, ns = clk.tolist()
        ghz.append(cycles / ns)
        rate = grid * block * iters * 8 / (t * 1e-3)
        print(f"[rate] __popc, {grid} x {block} threads: {rate / 1e12:.3f} "
              f"T/s at {ghz[-1]:.3f} GHz (block 0's clock64 over "
              f"globaltimer) = {rate / sms / (ghz[-1] * 1e9):.2f} a clock "
              "per SM", flush=True)
    clock = sum(ghz) / len(ghz) * 1e9
    for label, fn, macs in (
            ("b1 m16n8k256 .and.popc", "run_mma_b1", 16 * 8 * 256),
            ("b1 m16n8k256 .xor.popc", "run_mma_xor", 16 * 8 * 256),
            ("s8 m16n8k32", "run_mma_s8", 16 * 8 * 32)):
        f = getattr(ub, fn)
        f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        for blocks_per_sm, block in ((4, 256), (8, 256)):
            grid, iters = sms * blocks_per_sm, 1024
            out = torch.empty(grid * block, dtype=torch.int32, device=dev)
            t = cs.cuda_ms(lambda: f(inp.data_ptr(), out.data_ptr(), grid,
                                     block, iters, stream), iters=10)
            rate = grid * block // 32 * iters * 4 / (t * 1e-3)
            print(f"[rate] mma.sync {label}, {grid} x {block} threads: "
                  f"{rate / 1e9:.1f} G MMA/s = {rate * macs / 1e12:.0f} T "
                  f"multiply-adds/s = {rate / sms / clock:.3f} MMAs a clock "
                  "per SM", flush=True)

    # ---- the b1 fragment layout csrc/predict_margins.cuh assumes
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.integers(0, 2 ** 32, (16, 8), dtype=np.int64)
                         .astype(np.uint32).view(np.int32)).to(dev)
    B = torch.from_numpy(rng.integers(0, 2 ** 32, (8, 8), dtype=np.int64)
                         .astype(np.uint32).view(np.int32)).to(dev)
    D = torch.zeros((16, 8), dtype=torch.int32, device=dev)
    pa = torch.zeros((128, 16, 8), dtype=torch.int32, device=dev)
    pb = torch.zeros((64, 16, 8), dtype=torch.int32, device=dev)
    ub.run_layout.argtypes = [ctypes.c_void_p] * 6
    ub.run_layout(A.data_ptr(), B.data_ptr(), D.data_ptr(), pa.data_ptr(),
                  pb.data_ptr(), stream)
    torch.cuda.synchronize()
    a = A.cpu().numpy().view(np.uint32)
    b = B.cpu().numpy().view(np.uint32)
    want = np.array([[sum(bin(int(a[m, j] & b[n, j])).count("1")
                          for j in range(8)) for n in range(8)]
                     for m in range(16)])
    bad = int((D.cpu().numpy() != want).sum())
    pa, pb = pa.cpu().numpy(), pb.cpu().numpy()
    for p in range(128):          # A: lane L, register R -> its row
        lane, reg = p >> 2, p & 3
        exp = np.zeros((16, 8), dtype=np.int64)
        exp[(lane >> 2) + 8 * (reg & 1), :] = 1
        bad += int((pa[p] != exp).any())
    for p in range(64):           # B: lane L, register R -> its column
        exp = np.zeros((16, 8), dtype=np.int64)
        exp[:, (p >> 1) >> 2] = 1
        bad += int((pb[p] != exp).any())
    print(f"[layout] b1 m16n8k256: random A & B and 192 one-bit probes, "
          f"{bad} differ from the assumed layout", flush=True)
    print(f"[gpu] {cs.gpu_line()}", flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
