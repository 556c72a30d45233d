"""DeepSTAPLE in PyTorch, for CUDA on an NVIDIA H100.

The port of `deep_staple_tpu` (JAX on a TPU), slice by slice. This package
imports `torch` and never JAX or the JAX package; it keeps its own copies of
the numpy-only modules it needs. Public functions keep the JAX layout:
images are (B, D, H, W), logits (B, D, H, W, num_classes), channels last.

The entry points run on `cuda` unless the caller passes `device="cpu"`
(`core/device.py`). On the card every TPU kernel of the path is a kernel
written by hand for Hopper (`csrc/`); on the CPU a wrapper takes its kernel's
plain PyTorch version.
"""
