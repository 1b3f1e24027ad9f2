"""Device ops of the port: geometry, rasterization, preprocessing and the
hand-written CUDA kernels (``kernels``)."""
