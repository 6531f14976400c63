"""PyTorch/CUDA port of the hierarchical skeleton-aware motion VAE.

Mirrors the module layout of :mod:`hm_vae_tpu` (the JAX reference) so each
port module sits at the same path as its counterpart.  Imports ``torch``,
``numpy`` and the standard library only.  Hand-written CUDA kernels live in
``csrc/`` and are built on first use (:mod:`hm_vae_torch.ops._build`).
"""

__version__ = "0.1.0"
