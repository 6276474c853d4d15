"""PyTorch/CUDA port of the Lewellen (2015) Fama-MacBeth replication.

A package beside ``fm_returnprediction_tpu`` with the same module paths.
It imports torch, numpy and pandas only. Every public entry point takes
``device=None``, meaning the GPU; the CPU runs only when asked for.
Hand-written CUDA kernels live in ``csrc/`` and are built on first use
(``cuda_build``); on CPU tensors each kernel's plain PyTorch version runs.
"""
