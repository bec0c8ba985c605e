"""Hand-written CUDA kernels of the port: build and load (see _build.py)."""
