"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel,
each with its wrapper, its plain PyTorch version and its launch count.
Sources live in csrc/ and are built at first use (build.py)."""
