"""Hand-written CUDA kernels (csrc/*.cu) and their torch wrappers, each with
its plain PyTorch version and a launch counter."""
