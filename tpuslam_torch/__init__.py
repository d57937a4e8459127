"""PyTorch + CUDA port of tpuslam's Karto per-scan SLAM path.

The JAX package ``tpuslam`` is the reference; this package mirrors its
layout and names (``core``, ``ops``, ``match``, ``graph``, ``models``) so
each counterpart is easy to find.  It never imports jax.  Hand-written
Hopper kernels live in ``csrc/`` and are built on first use by
``ops/_build.py``; every kernel wrapper falls back to its plain PyTorch
version only for tensors that lie on the CPU.
"""
