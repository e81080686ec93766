"""bigdl_tpu_torch — the PyTorch / CUDA port of bigdl_tpu for NVIDIA Hopper.

A second package beside the JAX package ``bigdl_tpu``, which stays the
reference each part of the port is checked against. The port imports
``torch`` and numpy, never JAX and nothing of ``bigdl_tpu``. Its entry
points run on the card (``device=None`` means ``"cuda"``) unless the
caller asks for the CPU; the TPU kernels of the JAX package become CUDA
kernels written for Hopper under ``csrc/``, each with a plain PyTorch
version beside it.

Ported so far: the paged greedy generation engine serving a decoder-only
``Transformer`` (``serving.GenerationEngine``, ``serving.static_generate``)
with kernels B2 (flash-attention forward) and B3 (paged decode attention).
"""

__version__ = "0.1.0"
