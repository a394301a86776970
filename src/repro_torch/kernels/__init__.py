"""CUDA kernels of the SparseInfer hot path (predictor + sparse MLP).

Each kernel: ``csrc/<name>.cu`` (built by ``build.py``), its launcher
``<name>.py``, and its plain PyTorch version in ``ref.py``; ``ops.py``
dispatches on the tensor's device and counts launches.
"""
