"""Device ops of the port: matcher statistics and the CUDA kernel wrapper,
SIFT, epipolar F solvers, polynomial roots and LO-RANSAC."""
