"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source has a plain C interface and compiles, on its own
``nvcc`` process (all started together), into a shared library under
``build/repro_torch_kernels/`` at the repository root.  A library's file
name carries a hash of its source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import: the first kernel call builds, and the CPU tests
never get there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PREDICT = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_MLP_PLAN = [_I, _I, _I, _I, _P]
_MLP = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P]
_L = ctypes.c_longlong
# C signatures of the exported functions, per source
SIGNATURES = {
    "predict_group_margins": {"predict_group_margins": _PREDICT},
    "predict_chunk_group_margins": {"predict_chunk_group_margins": _PREDICT},
    **{name: {f"{name}_plan": _MLP_PLAN, name: _MLP}
       for name in ("fused_sparse_mlp", "fused_sparse_mlp_q")},
    "fused_sparse_mlp_chunk": {
        "fused_sparse_mlp_chunk_occupancy": [_I, _I, _I, _P],
        "fused_sparse_mlp_chunk": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _I, _I, _I, _I, _P]},
    "fused_sparse_mlp_chunk_q": {
        "fused_sparse_mlp_chunk_q_occupancy": [_I, _I, _I, _P],
        "fused_sparse_mlp_chunk_q": [_P, _I, *[_P] * 16, _L, *[_I] * 7, _F,
                                     *[_I] * 7, _P]},
    "paged_attention": {
        "paged_attention": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _I, _I, _I, _I, _P],
        "paged_attention_max_clusters": [_I] * 11},
    "paged_kv_write": {"paged_kv_write": [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _P]},
    "sign_pack": {"sign_pack": [_P, _I, _P, _I, _I, _P]},
    "predict_counts": {"predict_counts": [_P, _P, _P, _I, _I, _I, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # ptxas register/shared-memory report


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine that has the GPU")
    return path


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers are part of every source's content
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None) -> float:
    """Compile every kernel source that has no up-to-date library (one
    ``nvcc`` per source, run in parallel).  Returns the seconds it took."""
    names = list(names or SIGNATURES)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [_I], ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def n_loaded() -> int:
    """Kernel libraries built or loaded so far in this process."""
    return len(_LIBS)


def check(name: str, rc: int) -> None:
    """Raise if a C launcher returned a CUDA error."""
    if rc:
        msg = getattr(_LIBS[name], f"{name}_error_string")(rc)
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg.decode()}")
