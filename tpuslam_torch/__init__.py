"""PyTorch + CUDA port of tpuslam, the six-lesson 2D laser SLAM stack.

The JAX package ``tpuslam`` is the reference; this package mirrors its
layout and names (``core``, ``ops``, ``match``, ``graph``, ``models``,
``io``, ``utils``, ``checkpoint``, ``cli``) so each counterpart is easy
to find; ``python -m tpuslam_torch.cli`` runs its workloads.  It never imports jax.  Hand-written
Hopper kernels live in ``csrc/`` and are built on first use by
``ops/_build.py``; a kernel wrapper takes its plain PyTorch version only
for tensors that lie on the CPU.  The entry points place their state on
the card (``device="cuda"``) unless the caller asks for the CPU.  The
package imports nothing of JAX or of the JAX package ``tpuslam``: what
it needs from there it keeps as its own copy.
"""
