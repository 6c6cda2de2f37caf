"""PyTorch/CUDA port of ``novel_vqa_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``core/ ops/ data/
models/vqa/ parallel/ train/``) so each counterpart is found by path.  It
imports torch, numpy and the standard library only: it keeps its own copy of
every helper it needs, never imports the JAX package, and reads and writes
its h5 files itself (``core/h5.py``).

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first launch (``kernels/build.py``); on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.
"""
