"""PyTorch port of StreamMOS-TPU for NVIDIA Hopper.

The streaming TTA eval of `StreamMOSNet` (folded test-time augmentation,
fused header, short-term memory carried from frame to frame) in PyTorch,
with the fused TTA header as a hand-written CUDA kernel (`csrc/`). The JAX
package `streammos_tpu` is the reference this package is tested against;
nothing here imports it or jax.
"""

__version__ = "0.1.0"
