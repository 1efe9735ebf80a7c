"""PyTorch + CUDA port of the AutoFocusFormer / Mask2Former inference path
and training step.

Mirrors the layout of ``autofocusformermod_tpu`` (``ops/``, ``geometry/``,
``models/``, ``losses/``, ``engine/``) and keeps its function and class names, so each
counterpart is easy to find.  The JAX package is the reference this port is
tested against; this package imports ``torch`` only.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` on
first use (``ops/build.py``).  Every kernel wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor.
"""
