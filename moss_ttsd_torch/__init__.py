"""moss_ttsd_torch — the PyTorch / CUDA (NVIDIA H100) port of moss_ttsd_tpu.

The JAX package ``moss_ttsd_tpu`` is the reference; this package imports
nothing of it (nor of JAX). Layout mirrors it: ``core/``, ``ops/``,
``models/``, ``models/codec/``, ``decode/``, ``pipeline/``, ``utils/``,
``cli/``, plus ``csrc/`` with the hand-written Hopper kernels that replace
the TPU's Pallas kernels.
"""

__version__ = "0.1.0"
