"""Hand-written CUDA kernels (csrc/), their nvcc build (build.py) and their
wrappers (warp.py)."""
