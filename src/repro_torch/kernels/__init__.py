"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``) and their
wrappers.  Each wrapper launches its kernel on a CUDA tensor, takes its
plain PyTorch version on a CPU tensor, and raises on anything else."""
