#!/usr/bin/env python3
"""Step 0 of the float32 decode MLP's redesign, on the card:

    python3 tools/decode_step0.py OLD_SRC

OLD_SRC is the ``src`` directory of a checkout whose
``repro_torch/csrc/fused_sparse_mlp.cuh`` holds the kernel before the
redesign (one warp per selected row, x restaged in shared memory in column
chunks, down in (slice, 128-column tile) items), say the parent commit's
unpacked by ``git archive``.  It builds, under ``build/decode_step0/``:

* that kernel as it is, and two throw-away builds of it: one that stamps
  %globaltimer at its phase boundaries ("traced": gate/up, barrier 1, down,
  barrier 2, the slice sum), and one whose gate/up loop is unrolled 4
  times, so that each lane keeps 4 16-byte loads a matrix in flight
  ("deep");
* a read micro-benchmark: the 3 count*G selected rows of Wg, Wu and Wd cut
  into equal ranges a block (2 blocks of 256 threads a SM), read by 16-byte
  register loads with U of them in flight a thread, and by a ring of S
  16-KB ``cp.async`` stages a block: which route keeps enough bytes in
  flight to stream at the card's rate.

Then it prints, on prosparse-llama2-7b's widths (d=4096, k=11008, G=8,
C=288) with bf16 x: the old kernel at B in {1, 4, 8, 16} x (full, a third
of the selection) and at count 0 (B=4), its traced phases at each point,
the deep build at B in {4, 16}, the old kernel at counts 132, 264 and 288
(1056, 2112 and 2304 rows against 2112 warps: the wave tail), the
launcher's per-call ``torch.zeros``, a contiguous ``torch.sum`` of the same
bytes, the gathered-rows 3-matmul at each B, and the read routes.  Each is
timed with ``chip_smoke.cuda_ms`` (CUDA events, the L2 flushed before each
launch)."""
import ctypes
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "build" / "decode_step0"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PLAN_ARGS = [_I, _I, _I, _I, _P]
MLP_ARGS = [_P, _I, *[_P] * 11, *[_I] * 6, _F, *[_I] * 5, _P]
TRACE_POINTS = 6
STUB = """#include "{hdr}"
MLP_EXPORTS(fused_sparse_mlp, 16)
extern "C" int step0_trace(void* dst, int n) {{
#ifdef STEP0_TRACED
  return (int)cudaMemcpyFromSymbol(dst, mlp::g_trace, (size_t)n * 8, 0,
                                   cudaMemcpyDeviceToDevice);
#else
  return (int)cudaErrorInvalidValue;
#endif
}}
"""
UBENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// The 3n selected rows (n rows of each of wg, wu, wd, picked by rows[])
// in equal contiguous ranges a block; each block sums what it reads.
__device__ __forceinline__ const float4* row_of(const float* wg,
    const float* wu, const float* wd, const int* rows, int n, int d, int r) {
  const float* m = r < n ? wg : r < 2 * n ? wu : wd;
  return reinterpret_cast<const float4*>(m + (size_t)rows[r % n] * d);
}
constexpr int d4 = 1024;   // d = 4096
template <int U>
__global__ void __launch_bounds__(256, 2)
reg_read(const float* wg, const float* wu, const float* wd, const int* rows,
         int n, int d, float* out) {
  const int total = 3 * n;
  const int r0 = (int)((long long)total * blockIdx.x / gridDim.x);
  const int r1 = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  const int items = (r1 - r0) * d4;
  float acc = 0.f;
  for (int f = threadIdx.x; f < items; f += 256 * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int g = f + u * 256;
      v[u] = g < items ? __ldg(row_of(wg, wu, wd, rows, n, d, r0 + g / d4) +
                               g % d4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  if (acc == 1.2345f) out[blockIdx.x] = acc;
}
template <int S>
__global__ void __launch_bounds__(256, 2)
ring_read(const float* wg, const float* wu, const float* wd, const int* rows,
          int n, int d, float* out) {
  extern __shared__ float4 sm[];
  const int total = 3 * n;
  const int r0 = (int)((long long)total * blockIdx.x / gridDim.x);
  const int steps =
      (int)((long long)total * (blockIdx.x + 1) / gridDim.x) - r0;
  auto issue = [&](int s) {
    const float4* src = row_of(wg, wu, wd, rows, n, d, r0 + s);
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(sm + (size_t)(s % S) * d4));
    for (int i = threadIdx.x; i < d4; i += 256)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + i * 16), "l"(src + i));
  };
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) issue(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();
    if (s + S - 1 < steps) issue(s + S - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float4* st = sm + (size_t)(s % S) * d4;
    for (int i = threadIdx.x; i < d4; i += 256)
      acc += (st[i].x + st[i].y) + (st[i].z + st[i].w);
  }
  if (acc == 1.2345f) out[blockIdx.x] = acc;
}
typedef void (*Fn)(const float*, const float*, const float*, const int*,
                   int, int, float*);
extern "C" int read_rows(int route, int depth, const void* wg, const void* wu,
                         const void* wd, const void* rows, int n, int d,
                         void* out, int grid, void* stream) {
  Fn fn = nullptr;
  int smem = 0;
  if (route == 0) {
    fn = depth == 1 ? reg_read<1> : depth == 4 ? reg_read<4>
         : depth == 8 ? reg_read<8> : nullptr;
  } else {
    fn = depth == 2 ? ring_read<2> : depth == 4 ? ring_read<4>
         : depth == 6 ? ring_read<6> : nullptr;
    smem = depth * d * 4;
    if (fn) cudaFuncSetAttribute((const void*)fn,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (fn == nullptr || d != 4 * d4) return (int)cudaErrorInvalidValue;
  fn<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<const float*>(wd), static_cast<const int*>(rows), n, d,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
"""


def variants(old: str) -> dict[str, str]:
    """The old header and its two throw-away builds, by name."""
    edits = [
        ("namespace mlp {\n",
         "namespace mlp {\n__device__ unsigned long long g_trace[4096 * 6];\n"
         "__device__ __forceinline__ void smark(int p) {\n"
         "  if (threadIdx.x == 0) {\n    unsigned long long ns;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(ns));\n"
         "    g_trace[blockIdx.x * 6 + p] = ns;\n  }\n}\n"),
        ("  for (int t = threadIdx.x; t < kMaxB * 3; t += kThreads) "
         "tel_s[t] = 0;\n",
         "  smark(0);\n  for (int t = threadIdx.x; t < kMaxB * 3; "
         "t += kThreads) tel_s[t] = 0;\n"),
        ("  grid_barrier(bar, 1);\n",
         "  smark(1);\n  grid_barrier(bar, 1);\n  smark(2);\n"),
        ("  grid_barrier(bar, 2);\n",
         "  smark(3);\n  grid_barrier(bar, 2);\n  smark(4);\n"),
        ("    y[e] = v;\n  }\n}\n", "    y[e] = v;\n  }\n  smark(5);\n}\n")]
    traced = "#define STEP0_TRACED\n" + old
    for a, b in edits:
        if traced.count(a) != 1:
            sys.exit("decode_step0: OLD_SRC's fused_sparse_mlp.cuh is not "
                     f"the kernel before the redesign (no {a!r})")
        traced = traced.replace(a, b)
    loop = "      for (int i4 = lane; i4 < len / 4; i4 += 32) {\n"
    if old.count(loop) != 1:
        sys.exit("decode_step0: no gate/up loop in OLD_SRC's header")
    deep = old.replace(loop, "#pragma unroll 4\n" + loop)
    return {"old": old, "traced": traced, "deep": deep}


def build(old_src: str) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    hdr = pathlib.Path(old_src) / "repro_torch" / "csrc" / \
        "fused_sparse_mlp.cuh"
    if not hdr.exists():
        sys.exit(f"decode_step0: no {hdr}")
    sources = {}
    for name, text in variants(hdr.read_text()).items():
        (OUT / f"{name}_mlp.cuh").write_text(text)
        (OUT / f"{name}.cu").write_text(STUB.format(hdr=f"{name}_mlp.cuh"))
        sources[name] = OUT / f"{name}.cu"
    (OUT / "ubench.cu").write_text(UBENCH)
    sources["ubench"] = OUT / "ubench.cu"
    procs = {name: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-o",
         str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"decode_step0: nvcc failed for {name}:\n{log}")
        regs = sorted({line.split("Used")[1].strip()
                       for line in log.splitlines() if "Used" in line})
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    for name in ("old", "traced", "deep"):
        lib = libs[name]
        lib.fused_sparse_mlp_plan.argtypes = PLAN_ARGS
        lib.fused_sparse_mlp.argtypes = MLP_ARGS
        lib.step0_trace.argtypes = [_P, _I]
    libs["ubench"].read_rows.argtypes = [_I, _I, *[_P] * 4, _I, _I, _P, _I,
                                         _P]
    return libs


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.core import predictor as P
    from repro_torch.core import selection as S
    from repro_torch.core.sparse_mlp import SparseInferConfig
    from repro_torch.kernels import predict as KP

    if not torch.cuda.is_available():
        sys.exit("decode_step0: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[gpu] {cs.gpu_line()}", flush=True)
    libs = build(sys.argv[1])
    dev = torch.device("cuda")
    d, k, g = cs.D, cs.K, cs.G
    gen = torch.Generator(device=dev).manual_seed(10)
    wg = torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
    wu = torch.randn((k, d), generator=gen, device=dev) * d ** -0.5
    wd = torch.randn((k, d), generator=gen, device=dev) * k ** -0.5
    cap = SparseInferConfig().capacity(k)
    x0 = torch.randn((cs.MAIN_BATCH, d), generator=gen, device=dev)
    gm, _ = KP.predict_group_margins(
        P.pack_signs(wg), x0, torch.ones(cs.MAIN_BATCH, device=dev),
        d_valid=d, group_size=g)
    sel = S.capacity_select(S.union_margin(gm), cap)
    full = int(sel.count)
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def flush():
        flush_buf.zero_()

    def old_kernel(name, x, count):
        """A launch of an old build, as the old launcher made it."""
        lib = libs[name]
        b = x.shape[0]
        out = (ctypes.c_int * 5)()
        rc = lib.fused_sparse_mlp_plan(1, b, d, cap * g, out)
        if rc:
            sys.exit(f"decode_step0: {name} plan failed ({rc})")
        grid, dc, n_slices, rps, smem = tuple(out)
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        hbuf = torch.empty((cap * g * b,), device=dev)
        part = torch.empty((n_slices * b * d,), device=dev)
        y = torch.empty((b, d), device=dev)

        def run():
            ws = torch.zeros((1 + 3 * b,), dtype=torch.int32, device=dev)
            rc = lib.fused_sparse_mlp(
                x.data_ptr(), 1, wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                sel.indices.data_ptr(), cnt.data_ptr(), None, y.data_ptr(),
                None, hbuf.data_ptr(), part.data_ptr(), ws.data_ptr(), b, d,
                k, cap, g, 0, 0.0, grid, dc, n_slices, rps, smem, stream)
            if rc:
                sys.exit(f"decode_step0: {name} launch failed ({rc})")
        return run, grid, y

    def phases(x, count):
        run, grid, _ = old_kernel("traced", x, count)
        tr = torch.zeros((grid, TRACE_POINTS), dtype=torch.int64, device=dev)
        flush()
        run()
        libs["traced"].step0_trace(tr.data_ptr(), grid * TRACE_POINTS)
        t = tr.double().cpu()
        last = t.max(0).values
        start = t[:, 0].min()
        names = ("gate_up", "barrier_1", "down", "barrier_2", "slice_sum")
        out = {n: float(last[i + 1] - (last[i] if i else start)) / 1e6
               for i, n in enumerate(names)}
        out["total"] = float(last[5] - start) / 1e6
        return " ".join(f"{n} {v:.4f}" for n, v in out.items())

    # ---- the old kernel's scaling line, its phases, the deep build
    for b in cs.DECODE_BATCHES:
        x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
        xf = x.float()
        for count in (full, full // 3, 0):
            if count == 0 and b != cs.MAIN_BATCH:
                continue
            run, grid, _ = old_kernel("old", x, count)
            t = cs.cuda_ms(run, iters=30, flush=flush)
            n_bytes, flops = cs.chunk_mlp_work(b, count, cap, 2)
            bd = cs.bound_ms(n_bytes, flops)
            deep = ""
            if b in (4, 16) and count == full:
                t_deep = cs.cuda_ms(old_kernel("deep", x, count)[0],
                                    iters=30, flush=flush)
                deep = f" deep build {t_deep:.4f} ms;"
            lib = cs._gathered_mlp(wg, wu, wd, sel.indices[:count].long())
            t_lib = cs.cuda_ms(lambda: lib(xf), flush=flush)
            print(f"[step0] old B={b} count={count}/{cap} grid {grid}: "
                  f"{t:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}; share "
                  f"{bd[0] / t:.3f});{deep} gathered-rows 3-matmul "
                  f"{t_lib:.4f} ms; traced phases, ms: {phases(x, count)}",
                  flush=True)
    # ---- the wave tail: rows against the 2112 warps of the grid
    x = torch.randn((cs.MAIN_BATCH, d), generator=gen, device=dev).to(
        torch.bfloat16)
    for count in (132, 264, 288):
        run, grid, _ = old_kernel("old", x, count)
        print(f"[step0] wave tail B={cs.MAIN_BATCH} count={count} "
              f"({count * g} rows, {grid * 8} warps): "
              f"{cs.cuda_ms(run, iters=30, flush=flush):.4f} ms; phases, "
              f"ms: {phases(x, count)}", flush=True)
    # ---- the launcher's per-call zeroing, and a plain read of the bytes
    t = cs.cuda_ms(lambda: torch.zeros((13,), dtype=torch.int32, device=dev))
    print(f"[step0] torch.zeros of the barrier and telemetry (13 int32): "
          f"{t:.4f} ms", flush=True)
    mb = 3 * full * g * d * 4
    flat = torch.ones(mb // 4, device=dev)
    t = cs.cuda_ms(lambda: flat.sum(), flush=flush)
    print(f"[step0] a contiguous read of {mb / 1e6:.1f} MB (torch.sum): "
          f"{t:.4f} ms, {mb / t / 1e9:.3f} TB/s (bound "
          f"{mb / cs.HBM_BYTES_PER_S * 1e3:.4f} ms)", flush=True)
    del flat
    # ---- the read routes on the selected rows (3 x count*G rows of d)
    rows = (sel.indices[:full].long()[:, None] * g
            + torch.arange(g, device=dev)[None, :]).reshape(-1).to(
                torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros((4 * sms,), device=dev)
    ub = libs["ubench"]
    for route, depths, what in ((0, (1, 4, 8), "16-byte loads in flight a "
                                 "thread"),
                                (1, (2, 4, 6), "16-KB cp.async stages a "
                                 "block")):
        for depth in depths:
            def run(route=route, depth=depth):
                rc = ub.read_rows(route, depth, wg.data_ptr(), wu.data_ptr(),
                                  wd.data_ptr(), rows.data_ptr(),
                                  rows.numel(), d, out.data_ptr(), 2 * sms,
                                  stream)
                if rc:
                    sys.exit(f"decode_step0: read route {route} depth "
                             f"{depth} failed ({rc})")
            t = cs.cuda_ms(run, iters=30, flush=flush)
            print(f"[step0] read route {'registers' if route == 0 else 'ring'}"
                  f" {depth} {what}, 2 blocks of 256 a SM: {t:.4f} ms, "
                  f"{mb / t / 1e9:.3f} TB/s", flush=True)


if __name__ == "__main__":
    main()
