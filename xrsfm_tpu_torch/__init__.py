"""PyTorch/CUDA port of xrsfm_tpu.

Mirrors the layout of the JAX package ``xrsfm_tpu`` module by module; the
JAX package is the reference each ported function is tested against.  The
port imports ``torch`` and never ``jax`` or ``xrsfm_tpu``.

Ported so far: the main path, images to a COLMAP model.  The matching
stage (images -> SIFT -> pairwise descriptor matching on the hand-written
CUDA kernel ``csrc/topstats.cu`` -> LO-RANSAC F-verification -> ``ftr.bin``
/ ``fp.bin``), entered through ``pipelines.run_matching.main`` or ``python
-m xrsfm_tpu_torch.cli run_matching``; and the reconstruction stage in the
JAX package's default configuration (5-point initialization, batched P3P
registration, triangulation, Schur-complement LM bundle adjustment ->
``cameras.bin`` / ``images.bin`` / ``points3D.bin``), entered through
``pipelines.run_reconstruction.main`` or ``python -m xrsfm_tpu_torch.cli
run_reconstruction``.  Every other module of the JAX package has its twin
too, ``parallel`` (several devices and processes) among them.
"""
