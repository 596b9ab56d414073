"""Scale-out of the port over several devices and processes: the device
mesh, determinism checksums, sharded matching and observation-sharded
bundle adjustment (port of xrsfm_tpu/parallel)."""
