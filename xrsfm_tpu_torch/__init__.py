"""PyTorch/CUDA port of xrsfm_tpu.

Mirrors the layout of the JAX package ``xrsfm_tpu`` module by module; the
JAX package is the reference each ported function is tested against.  The
port imports ``torch`` and never ``jax`` or ``xrsfm_tpu``.

Ported so far: the matching stage (images -> SIFT -> pairwise descriptor
matching on the hand-written CUDA kernel ``csrc/topstats.cu`` -> LO-RANSAC
F-verification -> ``ftr.bin`` / ``fp.bin``), entered through
``pipelines.run_matching.main`` or ``python -m xrsfm_tpu_torch.cli
run_matching``.
"""
