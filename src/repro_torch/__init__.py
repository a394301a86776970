"""SparseInfer on PyTorch + CUDA (one NVIDIA H100).

A module-for-module counterpart of the JAX package ``repro``: the same
configs, the same sign-bit predictor, the same batch-union capacity
selection and the same two-kernel sparse MLP, with each Pallas TPU kernel
replaced by a hand-written CUDA kernel (``csrc/``) built with ``nvcc`` at
first use.  Nothing here imports JAX or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
