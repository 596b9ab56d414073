"""Device ops of the port: matcher statistics and the CUDA kernel wrapper,
SIFT, epipolar F and E solvers, the 5-point and P3P/EPnP/IPPE minimal
solvers, triangulation, polynomial roots, LO-RANSAC, guarded
decompositions, and the host-side Umeyama alignment."""
