# Hand-written CUDA kernels for Hopper: each kernel's ``csrc/*.cu`` source,
# its wrapper (``ops.py``) and its plain PyTorch version (``ref.py``).
