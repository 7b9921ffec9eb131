"""Flow primitives of the port: coordinate grids, padding, sampling,
correlation and convex upsampling. ``ops.kernels`` holds the wrappers of
the hand-written CUDA kernels."""
