"""PyTorch port of StreamMOS-TPU for NVIDIA Hopper.

The streaming TTA eval of `StreamMOSNet` (folded test-time augmentation,
fused header, short-term memory carried from frame to frame), the
streaming training of both stages, and the host side that feeds them from
a SemanticKITTI tree (`data/`, the C++ loader in `native/`, `metrics.py`,
the CLIs in `tools/`), in PyTorch, with each TPU kernel as a hand-written
CUDA kernel (`csrc/`). The JAX package `streammos_tpu` is the reference
this package is tested against; nothing here imports it or jax.
"""

__version__ = "0.1.0"
